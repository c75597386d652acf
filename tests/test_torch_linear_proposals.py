"""Linear proposal networks (`ProposalNetArgs.use_linear`, nerfstudio's)
and the `use_fused_density` switch in the port against the JAX package:
the params tree's names (`FactorGridEncoding_0` / `HashGridEncoding_0` and
`Dense_0` under `proposal_i`), the model's forward in both backends, four
train steps against `make_train_step`, the CLI and YAML overrides of
`proposal_net_args_list`, a CPU run of the train CLI with them, and the
factor model's unfused density.

The models are tests/test_nerfacto_core.py's `tiny_config` with the knobs
set on both sides; the same numpy inputs go to both. On the CPU the JAX
package runs the XLA encode, so the port's factor fields are compared on
that contract (`_encode_reference` and `density_mlp_reference` in place of
the kernels' twins), as tests/test_torch_train.py does.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu import config as jcfglib
from signerf_tpu.method_configs import signerf_nerfacto_method as jax_nerfacto_method
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.engine.optimizers import group_of
from signerf_tpu_torch.method_configs import signerf_nerfacto_method
from signerf_tpu_torch.models import fields as tfields
from signerf_tpu_torch.models.nerfacto import NerfactoModel
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc
from tests.test_nerfacto_core import tiny_config
from tests.test_pipeline_e2e import write_tiny_dataset
from tests.test_torch_train import (
    GATE,
    NUM_CAMS,
    _model_flags,
    assert_runs_agree,
    faint_proposals,
    linear_proposals,
    port_tiny_config,
    run_both,
    scene,
)

torch.set_num_threads(2)

BACKENDS = ("factor", "hash")
KEYS = ("rgb", "accumulation", "depth", "expected_depth")


def xla_encode(cfg, lines, x01):
    """The JAX package's XLA encode under autograd (its CPU path)."""
    return tfg._encode_reference(cfg, lines, x01)


def on_the_xla_contract(mp):
    mp.setattr(tfields, "encode_fused", xla_encode)
    mp.setattr(tfields, "fused_density_mlp", tfg.density_mlp_reference)


def jax_config(backend, **kw):
    cfg = linear_proposals(tiny_config())
    if backend == "hash":
        cfg = dataclasses.replace(cfg, encoding_backend="hash")
    return dataclasses.replace(cfg, **GATE, **kw)


def port_config(jcfg):
    t = port_tiny_config(jcfg, **GATE, encoding_backend=jcfg.encoding_backend,
                         use_fused_density=jcfg.use_fused_density)
    if jcfg.encoding_backend == "hash":
        hash_knobs = dict(num_levels=jcfg.num_levels, log2_hashmap_size=jcfg.log2_hashmap_size)
        args = tuple(dataclasses.replace(a, log2_hashmap_size=j.log2_hashmap_size)
                     for a, j in zip(t.proposal_net_args_list, jcfg.proposal_net_args_list))
        t = dataclasses.replace(t, proposal_net_args_list=args, **hash_knobs)
    return t


@pytest.fixture(scope="module")
def both_models():
    """For each backend: the JAX model's train and eval outputs and
    first-step gradients (op by op, without `jax.jit`), and the port's
    model on the same params."""
    jcams, tcams, images, idx = scene()
    target = images[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.float32) / 255.0
    jrays, trays = jcams.generate_rays_at(jnp.asarray(idx)), tcams.generate_rays_at(torch.from_numpy(idx))
    out = {}
    for backend in BACKENDS:
        jcfg = jax_config(backend)
        jmodel = JModel(jcfg, NUM_CAMS)
        params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        faint_proposals(params)

        def run(p, train, jmodel=jmodel):
            o = jmodel.apply(p, jrays, rng=None, train=train, anneal=1.0)
            return {k: o[k] for k in KEYS}, jmodel.loss_dict(o, {"image": jnp.asarray(target)})

        def total(p):
            return sum(jax.tree_util.tree_leaves(run(p, True)[1]))

        model = NerfactoModel(port_config(jcfg), NUM_CAMS)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        out[backend] = dict(
            params=params, model=model,
            j_train=jax.tree_util.tree_map(np.asarray, run(params, True)[0]),
            j_eval=jax.tree_util.tree_map(np.asarray, run(params, False)[0]),
            j_grads=state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(total)(params))),
        )
    return out, trays, target


@pytest.mark.parametrize("backend", BACKENDS)
def test_params_tree_names(both_models, backend):
    """JAX's init tree: `proposal_i.{FactorGridEncoding_0,HashGridEncoding_0}`
    and `proposal_i.Dense_0.{kernel [D, 1], bias [1]}`, no `MLP_0`; the
    seeded init has the same names; the proposal networks' optimizer group."""
    models, _, _ = both_models
    m = models[backend]
    sd, jsd = m["model"].state_dict(), state_dict_from_jax(m["params"])
    assert sorted(sd) == sorted(jsd)
    for k in jsd:
        assert tuple(sd[k].shape) == tuple(jsd[k].shape), k
    enc = "FactorGridEncoding_0" if backend == "factor" else "HashGridEncoding_0"
    for i in range(2):
        names = {k.split(".")[1] for k in jsd if k.startswith(f"proposal_{i}.")}
        assert names == {enc, "Dense_0"}
        d = m["model"].get_submodule(f"proposal_{i}").encoding.out_dim
        assert tuple(sd[f"proposal_{i}.Dense_0.kernel"].shape) == (d, 1)
        assert group_of(f"proposal_{i}.Dense_0.kernel") == "proposal_networks"
    fresh = NerfactoModel(port_config(jax_config(backend)), NUM_CAMS)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert sorted(fresh.state_dict()) == sorted(jsd)
    assert float(fresh.proposal_0.Dense_0.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_model_forward_matches_jax(both_models, backend, train, monkeypatch):
    """rgb, accumulation and both depths within the fields' 1e-4
    (tests/test_torch_hashgrid.py's bound), against JAX op by op: under
    `jax.jit` XLA keeps the bf16 intermediates of the linear proposals'
    encode and Dense in f32 where the port and JAX op by op round them.
    Eval runs under `torch.inference_mode()`."""
    on_the_xla_contract(monkeypatch)
    models, trays, _ = both_models
    m = models[backend]
    if train:
        out = m["model"](trays, None, train=True, anneal=1.0)
    else:
        with torch.inference_mode():
            out = m["model"](trays)
    want = m["j_train" if train else "j_eval"]
    for key in KEYS:
        got = out[key].detach().numpy()
        assert bool(np.isfinite(got).all()), key
        np.testing.assert_allclose(got, want[key], rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("backend", BACKENDS)
def test_first_step_grads_match_jax(both_models, backend, monkeypatch):
    """Every leaf's first-step gradient per leaf by norm-relative error
    within 0.05 (the bound of tests/test_torch_hashgrid.py and
    tests/test_torch_train.py; measured at most 0.012), the linear
    Dense_0 included."""
    from tests.test_torch_train import rel

    on_the_xla_contract(monkeypatch)
    models, trays, target = both_models
    m = models[backend]
    model = m["model"]
    out = model(trays, None, train=True, anneal=1.0)
    terms = model.loss_dict(out, {"image": torch.from_numpy(target)})
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(sum(terms.values()), ps, allow_unused=True)))
    assert sorted(grads) == sorted(m["j_grads"])
    for k, jg in m["j_grads"].items():
        if float(jg.abs().max()) == 0.0:
            assert grads[k] is None or float(grads[k].abs().max()) == 0.0, k
        else:
            # the proposals' output biases are one element each, a sum over
            # every sample of bf16-rounded cotangents taken in another order
            # (tests/test_torch_hashgrid.py's 0.15; measured 0.095)
            bound = 0.15 if k.endswith("Dense_0.bias") else 0.05
            assert rel(grads[k], jg) < bound, (k, rel(grads[k], jg))
    assert float(m["j_grads"]["proposal_0.Dense_0.kernel"].abs().max()) > 0


def test_linear_proposal_train_steps_match_jax(monkeypatch):
    """Four steps of `make_train_step` with linear proposals (factor
    backend, a gated proposal step) against the port's, under
    tests/test_torch_train.py's bounds."""
    monkeypatch.setattr(tfields, "encode_fused", xla_encode)
    assert_runs_agree(*run_both(monkeypatch, linear=True))


def test_linear_proposals_take_the_encode_not_the_fused_density(monkeypatch):
    """With linear proposals on the CPU, one train step calls K1's and K2's
    twins for the base field only and K3's and K4's tables half for the two
    proposal fields (the launches phase 21(a) of chip_smoke.py expects on
    the card: K1 1, K2 tables 1, K3 2, K4 tables 2 a step)."""
    calls = {"density": 0, "density_bwd": 0, "encode": 0, "encode_bwd": 0}
    density, density_bwd = ffc.density_mlp_plain, ffc.density_mlp_bwd_plain
    encode, encode_bwd = ffc.encode_plain, ffc.encode_bwd_plain

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(ffc, "density_mlp_plain", counted("density", density))
    monkeypatch.setattr(ffc, "density_mlp_bwd_plain", counted("density_bwd", density_bwd))
    monkeypatch.setattr(ffc, "encode_bwd_plain", counted("encode_bwd", encode_bwd))
    # K1's twin calls K3's internally: count the encode only from the fields
    monkeypatch.setattr(tfg, "_kernel", lambda name, device: (
        counted("encode", encode) if name == "encode" else getattr(ffc, f"{name}_plain")))
    _, tcams, images, idx = scene()
    model = NerfactoModel(port_config(jax_config("factor")), NUM_CAMS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    out = model(tcams.generate_rays_at(torch.from_numpy(idx)), None, train=True, anneal=1.0)
    target = torch.from_numpy(images[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.float32) / 255.0)
    sum(model.loss_dict(out, {"image": target}).values()).backward()
    assert calls == {"density": 1, "density_bwd": 1, "encode": 2, "encode_bwd": 2}


def test_proposal_args_from_the_cli_and_yaml(tmp_path):
    """`--pipeline.model.proposal-net-args-list` takes a JSON list of the
    args with `use_linear`; a YAML written by either package carries it and
    `use_fused_density` into the other."""
    value = json.dumps([{"hidden_dim": 16, "num_levels": 5, "max_res": 128, "use_linear": True},
                        {"max_res": 256, "use_linear": True}])
    cfg = cfglib.apply_overrides(signerf_nerfacto_method(), cfglib.parse_cli_overrides(
        ["--pipeline.model.proposal-net-args-list", value, "--pipeline.model.use-fused-density", "False"]))
    args = cfg.pipeline.model.proposal_net_args_list
    assert [a.use_linear for a in args] == [True, True] and [a.max_res for a in args] == [128, 256]
    assert cfg.pipeline.model.use_fused_density is False
    cfglib.save_yaml(cfg, tmp_path / "t.yml")
    back = cfglib.load_yaml(type(cfg), tmp_path / "t.yml")
    assert back.pipeline.model.proposal_net_args_list == args and back.pipeline.model.use_fused_density is False
    j = jcfglib.load_yaml(type(jax_nerfacto_method()), tmp_path / "t.yml")
    assert [a.use_linear for a in j.pipeline.model.proposal_net_args_list] == [True, True]
    jm = jax_nerfacto_method()
    jm.pipeline.model.proposal_net_args_list = linear_proposals(jm.pipeline.model).proposal_net_args_list
    jm.pipeline.model.use_fused_density = False
    jcfglib.save_yaml(jm, tmp_path / "j.yml")
    t = cfglib.load_yaml(type(cfg), tmp_path / "j.yml")
    assert [a.use_linear for a in t.pipeline.model.proposal_net_args_list] == [True, True]
    assert t.pipeline.model.use_fused_density is False


def test_train_cli_with_linear_proposals(tmp_path):
    """The train CLI at `--device cpu` with linear proposal networks given
    on its command line: it trains, and its checkpoint holds `Dense_0`."""
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.engine import checkpoints as tck

    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    value = json.dumps([{"max_res": 32, "use_linear": True}, {"max_res": 32, "use_linear": True}])
    rc = train_cli.main(
        ["signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cpu",
         "--max-num-iterations", "3", "--steps-per-call", "1", "--steps-per-save", "3", "--output-dir", str(out),
         "--pipeline.datamanager.train-num-rays-per-batch", "64", *_model_flags("pipeline.model."),
         "--pipeline.model.proposal-net-args-list", value]
    )
    assert rc == 0
    ckpt = tck.load_checkpoint(out / "experiment" / "signerf_nerfacto" / "checkpoints" / "step-000000003.pt")
    assert tuple(ckpt["params"]["proposal_1.Dense_0.kernel"].shape) == (40, 1)
    assert not any(".MLP_0." in k for k in ckpt["params"])


def test_unfused_density_matches_jax_and_skips_k1(monkeypatch):
    """`use_fused_density=False`: the factor fields run the encoding module
    and then the MLP (K1's and K2's twins are never called) and match JAX's
    model with the same switch, and the fused default within bf16 noise."""
    jcams, tcams, images, idx = scene()
    jcfg = dataclasses.replace(tiny_config(), use_fused_density=False, **GATE)
    jmodel = JModel(jcfg, NUM_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    want = jmodel.apply(params, jcams.generate_rays_at(jnp.asarray(idx)), rng=None, train=True, anneal=1.0)
    trays = tcams.generate_rays_at(torch.from_numpy(idx))
    models = {}
    for fused in (True, False):
        models[fused] = NerfactoModel(port_config(dataclasses.replace(jcfg, use_fused_density=fused)), NUM_CAMS)
        models[fused].load_state_dict(state_dict_from_jax(params), strict=True)
    fused_out = models[True](trays, None, train=True, anneal=1.0)
    monkeypatch.setattr(ffc, "density_mlp_plain", lambda *a, **k: pytest.fail("K1's twin called"))
    monkeypatch.setattr(ffc, "density_mlp_bwd_plain", lambda *a, **k: pytest.fail("K2's twin called"))
    out = models[False](trays, None, train=True, anneal=1.0)
    out["rgb"].sum().backward()
    for key in KEYS:
        # K3's f32 taps against K1's bf16-rounded features
        np.testing.assert_allclose(out[key].detach().numpy(), fused_out[key].detach().numpy(),
                                   rtol=0.02, atol=0.02, err_msg=key)
    monkeypatch.setattr(tfields, "encode_fused", xla_encode)
    out = models[False](trays, None, train=True, anneal=1.0)
    for key in KEYS:
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
