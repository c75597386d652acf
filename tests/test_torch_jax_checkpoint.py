"""Reading the JAX package's checkpoints in the port.

A `step-*.ckpt` written by `signerf_tpu.engine.checkpoints.save_checkpoint`
(flax msgpack of {step, params, opt_state}) for each encoding backend is
read by `load_jax_checkpoint` and must equal the JAX package's own
`load_params` leaf for leaf; the pure-Python decoder must agree with
`flax.serialization.msgpack_restore` on every dtype and shape of those
files and of a tree that covers msgpack's other encodings and flax's
chunked arrays; the CLIs take a directory of `.ckpt` through `--load-dir`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from signerf_tpu.engine import checkpoints as jck
from signerf_tpu.engine import optimizers as jopt
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.engine import checkpoints as tck
from tests.test_nerfacto_core import tiny_config
from tests.test_pipeline_e2e import N_CAMS, write_tiny_dataset

torch.set_num_threads(2)

STEP = 1234
PROPOSALS = json.dumps([
    {"hidden_dim": 8, "num_levels": 2, "max_res": 32, "log2_hashmap_size": 6},
    {"hidden_dim": 8, "num_levels": 2, "max_res": 64, "log2_hashmap_size": 6},
])
# tiny_config's knobs as CLI flags (the factor grid keeps the fields' level
# counts, so only the widths and sample counts matter to it)
TINY_FLAGS = [
    "--num-levels", "4", "--log2-hashmap-size", "8", "--max-res", "64", "--hidden-dim", "16",
    "--hidden-dim-color", "16", "--appearance-embed-dim", "4", "--num-proposal-samples-per-ray", "[8, 6]",
    "--num-nerf-samples-per-ray", "4", "--proposal-net-args-list", PROPOSALS,
]


def model_flags(prefix: str, backend: str):
    return [f"--{prefix}{a[2:]}" if a.startswith("--") else a
            for a in ["--encoding-backend", backend, *TINY_FLAGS]]


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """A JAX checkpoint (params and Adam state) of tiny_config for each
    backend, in a directory of its own."""
    out = {}
    for backend in ("factor", "hash"):
        jmodel = JModel(dataclasses.replace(tiny_config(), encoding_backend=backend), num_train_images=N_CAMS)
        params = jmodel.init(jax.random.PRNGKey(3))
        opt = jopt.make_optimizer(jopt.OptimizersConfig(), params)
        directory = tmp_path_factory.mktemp(f"jax_{backend}")
        path = jck.save_checkpoint(directory, STEP, params, opt.init(params))
        out[backend] = (path, params)
    return out


def assert_same_tree(ours, theirs, where="root"):
    """Our decoded tree against flax's: the same keys, and each array the
    same dtype, shape and bytes (numpy scalars as 0-d tensors)."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(theirs), where
        for k in theirs:
            assert_same_tree(ours[k], theirs[k], f"{where}.{k}")
    elif isinstance(theirs, (np.ndarray, np.generic)):
        arr = np.asarray(theirs)
        assert isinstance(ours, torch.Tensor), where
        assert tuple(ours.shape) == arr.shape, where
        if arr.dtype.name == "bfloat16":
            assert ours.dtype == torch.bfloat16, where
            np.testing.assert_array_equal(ours.view(torch.int16).numpy(), arr.view(np.int16), err_msg=where)
        else:
            assert ours.numpy().dtype == arr.dtype, where
            np.testing.assert_array_equal(ours.numpy(), arr, err_msg=where)
    else:
        assert type(ours) is type(theirs) and ours == theirs, where


@pytest.mark.parametrize("backend", ["factor", "hash"])
def test_jax_checkpoint_loads_leaf_for_leaf(jax_checkpoints, backend):
    path, params = jax_checkpoints[backend]
    state_dict, step = tck.load_jax_checkpoint(path)
    assert step == STEP
    want, want_step = jck.load_params(path, params)
    assert want_step == STEP
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(state_dict) == sorted(want)
    for k, v in want.items():
        assert state_dict[k].dtype == torch.float32, k
        torch.testing.assert_close(state_dict[k], v, rtol=0, atol=0, msg=k)
    tables = [k for k in state_dict if k.endswith(".table")]
    assert (len(tables) == 3) is (backend == "hash")
    # the whole file, optimizer state included, as flax decodes it
    assert_same_tree(tck.msgpack_restore(path.read_bytes()), serialization.msgpack_restore(path.read_bytes()))


def test_decoder_matches_flax_on_every_encoding(monkeypatch):
    """Every array dtype flax writes (bfloat16 included) at 0 to 3
    dimensions, numpy scalars, ints and floats of every msgpack width,
    strings, bins, lists and maps of every length class, nil and bools,
    and arrays over flax's chunk size (lowered here to 64 bytes)."""
    rng = np.random.default_rng(0)
    dtypes = ["float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
              "uint64", "bool"]
    arrays = {}
    for i, name in enumerate(dtypes):
        for shape in [(), (0,), (5,), (2, 3), (2, 3, 4)]:
            arrays[f"{name}_{len(shape)}_{i}_{sum(shape)}"] = (rng.normal(size=shape) * 50).astype(name)
    tree = {
        "arrays": arrays,
        "bf16": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7), "u8": np.uint8(200), "bool": np.bool_(True)},
        "py": {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -128, -129,
                        -32768, -32769, -2**31, -2**31 - 1, -2**63],
               "floats": [0.0, -1.5, 1e300], "none": None, "t": True, "f": False,
               "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, "e" * 70000],
               "bins": [b"", b"x" * 300, b"y" * 70000],
               "lists": [list(range(15)), list(range(16)), list(range(70000))]},
        "maps": {"m15": {str(i): i for i in range(15)}, "m16": {str(i): i for i in range(16)},
                 "m70000": {str(i): i for i in range(70000)}},
        "big": rng.normal(size=(7, 9)).astype(np.float32),
        "big_bf16": jnp.asarray(rng.normal(size=(40,)), jnp.bfloat16),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert_same_tree(tck.msgpack_restore(data), serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="truncated"):
        tck.msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        tck.msgpack_restore(data + b"\x00")


def test_latest_checkpoint_takes_ckpt_when_no_pt(jax_checkpoints, tmp_path):
    path, _ = jax_checkpoints["hash"]
    assert tck.latest_checkpoint(path.parent) == path
    loaded = tck.load_checkpoint(path)
    assert loaded["step"] == STEP and loaded["optimizer"] is None
    # a port checkpoint in the same directory wins
    d = tmp_path / "mixed"
    d.mkdir()
    (d / path.name).write_bytes(path.read_bytes())
    tck.save_checkpoint(d, 5, {"w": torch.zeros(2)})
    assert tck.latest_checkpoint(d).name == "step-000000005.pt"


@pytest.mark.parametrize("backend", ["factor", "hash"])
def test_clis_load_a_jax_checkpoint_dir(jax_checkpoints, backend, tmp_path, capsys):
    """`--load-dir` of a `.ckpt` directory: the render CLI renders from it
    (the restore surgery keeps the seeded appearance codes, takes every
    other tensor from the JAX file) and says in one line that Adam starts
    fresh; the train CLI starts from it (its step-0 checkpoint holds the
    JAX params)."""
    from signerf_tpu_torch import render as render_cli
    from signerf_tpu_torch import train as train_cli

    path, _ = jax_checkpoints[backend]
    want, _ = tck.load_jax_checkpoint(path)
    data = write_tiny_dataset(tmp_path / "data")
    assert render_cli.main(["--data", str(data), "--output", str(tmp_path / "r"), "--load-dir", str(path.parent),
                            "--device", "cpu", "--depth", "false", *model_flags("model.", backend)]) == 0
    assert len(list((tmp_path / "r").glob("rgb_*.png"))) == N_CAMS
    said = capsys.readouterr().out
    assert said.count("optimizer state not carried (Adam starts fresh)") == 1 and f"loaded {path}" in said
    out = tmp_path / "out"
    assert train_cli.main(["signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cpu",
                           "--load-dir", str(path.parent), "--max-num-iterations", "0", "--output-dir", str(out),
                           *model_flags("pipeline.model.", backend)]) == 0
    started = tck.load_checkpoint(out / "experiment" / "signerf_nerfacto" / "checkpoints" / "step-000000000.pt")
    assert sorted(started["params"]) == sorted(want)
    for k, v in want.items():
        if k.startswith("field.appearance."):
            continue
        torch.testing.assert_close(started["params"][k], v, rtol=0, atol=0, msg=k)
