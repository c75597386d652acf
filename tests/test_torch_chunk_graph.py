"""The eval render's chunks (`signerf_tpu_torch/engine/chunk_graph.py`,
`engine/train_step.make_eval_render`) on the CPU: the render stays eager
and counts its chunks, the frame buffers hold the eager chunks bit for bit,
the counters' names and a capture's tally of its own thread, the graph key against what a capture
depends on, and the hash encode's constants made once. The CUDA graph
itself is held against the eager chunks on the card
(`tests/test_torch_cuda.py`).
"""

import threading

import pytest
import torch

from signerf_tpu_torch.cameras.cameras import RayBundle
from signerf_tpu_torch.engine import chunk_graph
from signerf_tpu_torch.engine.train_step import EVAL_OUTPUTS, make_eval_render
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from signerf_tpu_torch.ops import factor_grid, flash_attention, hashgrid
from signerf_tpu_torch.ops import fused_factor_cuda as ffc
from signerf_tpu_torch.utils import tracing

SMALL = dict(max_res=32, hidden_dim=8, hidden_dim_color=8, num_proposal_samples_per_ray=(8, 6),
             num_nerf_samples_per_ray=4)
RENDER_COUNTERS = {"render.chunks", "render.graph_replays", "render.graph_captures"}


def small_model(backend="factor"):
    model = NerfactoModel(NerfactoModelConfig(encoding_backend=backend, **SMALL), num_train_images=3)
    return model.reset_parameters(torch.Generator().manual_seed(0)).eval()


def rays(n, seed=1, nears=True):
    g = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    return RayBundle(
        origins=-2.0 * d, directions=d, pixel_area=torch.ones(n, 1),
        camera_indices=torch.randint(0, 3, (n, 1), generator=g, dtype=torch.int32),
        nears=torch.full((n, 1), 0.05) if nears else None, fars=torch.full((n, 1), 4.0) if nears else None,
    )


def eager_frame(model, bundle, chunk, appearance_mode=None):
    """The render's padding rule and chunk order, each chunk a plain model
    call, concatenated."""
    n = bundle.origins.shape[0]
    pad = -n % chunk
    padded = bundle.map(lambda x: torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]))
    with torch.inference_mode():
        outs = [model(padded.map(lambda x: x[c : c + chunk]), appearance_mode=appearance_mode)
                for c in range(0, n + pad, chunk)]
    return {k: torch.cat([o[k] for o in outs])[:n] for k in EVAL_OUTPUTS}


def test_counters_name_the_render_counters(monkeypatch):
    monkeypatch.setattr(chunk_graph, "chunks", 11)
    monkeypatch.setattr(chunk_graph, "graph_replays", 7)
    monkeypatch.setattr(chunk_graph, "graph_captures", 2)
    c = tracing.counters()
    assert RENDER_COUNTERS <= set(c)
    assert (c["render.chunks"], c["render.graph_replays"], c["render.graph_captures"]) == (11, 7, 2)


def grown_since(before):
    return {k: v - before[k] for k, v in tracing.counters().items() if v != before[k]}


def test_a_capture_tallies_its_own_thread_and_replays_add_the_tally(monkeypatch):
    """Inside `capturing` the sites' counts go to the tally, not to the
    counters; another thread counts as it goes; `add` adds a tally."""
    for name in ffc.COUNTERS:
        monkeypatch.setattr(ffc, name, 0)
    monkeypatch.setattr(flash_attention, "launches", 0)
    monkeypatch.setattr(factor_grid, "table_pack_bytes", 100)
    lines = [[torch.ones(4, 2)] * 3] * 2
    before = tracing.counters()
    with tracing.capturing() as tally:
        factor_grid.pack_tables(lines)
        ffc.launches += tracing.count("fused_factor_cuda.launches")
        ffc.launches += tracing.count("fused_factor_cuda.launches")
        other = threading.Thread(target=factor_grid.pack_tables, args=(lines,))
        other.start()
        other.join()
        with pytest.raises(RuntimeError, match="capturing"):
            with tracing.capturing():
                pass
    assert tally == {"factor_grid.table_pack_bytes": 96, "fused_factor_cuda.launches": 2}
    assert grown_since(before) == {"factor_grid.table_pack_bytes": 96}  # the other thread's pack
    tracing.add(tally)
    tracing.add(tally)  # two replays
    assert ffc.launches == 4 and factor_grid.table_pack_bytes == 100 + 96 * 3
    assert tracing.count("fused_factor_cuda.launches", 5) == 5  # outside a capture


@pytest.mark.parametrize("n,chunk", [(96, 32), (100, 32), (5, 64)])
def test_a_cpu_frame_renders_eagerly_and_counts_its_chunks(n, chunk):
    model = small_model()
    before = tracing.counters()
    out = make_eval_render(model, chunk_size=chunk)(rays(n))
    grown = grown_since(before)
    assert grown.get("render.chunks") == -(-n // chunk)
    assert "render.graph_replays" not in grown and "render.graph_captures" not in grown
    assert model not in chunk_graph._models  # no graph is kept for a CPU model
    assert {k: tuple(v.shape) for k, v in out.items()} == {"rgb": (n, 3), "depth": (n, 1),
                                                           "expected_depth": (n, 1), "accumulation": (n, 1)}


@pytest.mark.parametrize("backend", ["factor", "hash"])
@pytest.mark.parametrize("n,chunk,mode", [(96, 32, None), (100, 32, "index"), (77, 128, "zero")])
def test_the_frame_buffers_hold_the_eager_chunks_bit_for_bit(backend, n, chunk, mode):
    model = small_model(backend)
    bundle = rays(n, seed=n)
    got = make_eval_render(model, chunk_size=chunk)(bundle, appearance_mode=mode)
    want = eager_frame(model, bundle, chunk, mode)
    assert list(got) == list(EVAL_OUTPUTS)
    for k in EVAL_OUTPUTS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_the_graph_key_follows_what_a_capture_depends_on():
    model = small_model()
    bundle = rays(64)
    key = chunk_graph._key(model, bundle, 32, None)
    assert chunk_graph._key(model, bundle, 32, None) == key
    shapes, weights = key
    assert chunk_graph._key(model, bundle, 16, None)[0] != shapes
    assert chunk_graph._key(model, bundle, 32, "zero")[0] != shapes
    assert chunk_graph._key(model, rays(64, nears=False), 32, None)[0] != shapes
    assert chunk_graph._key(model, bundle.map(lambda x: x.double() if x.is_floating_point() else x), 32,
                            None)[0] != shapes
    precision = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium" if precision == "highest" else "highest")
        assert chunk_graph._key(model, bundle, 32, None)[0] != shapes
    finally:
        torch.set_float32_matmul_precision(precision)
    # In-place updates keep the weights where the graph reads them ...
    with torch.no_grad():
        params = list(model.parameters())
        torch._foreach_add_(params, [torch.ones_like(p) for p in params])
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()})
    assert chunk_graph._key(model, bundle, 32, None) == key
    # ... a replaced or moved tensor does not.
    head = model.field.mlp_head.dense_0
    head.bias = torch.nn.Parameter(head.bias.detach().clone())
    moved = chunk_graph._key(model, bundle, 32, None)
    assert moved[0] == shapes and moved[1] != weights
    model.double()
    assert chunk_graph._key(model, bundle, 32, None)[1] != moved[1]


def test_the_hash_encode_copies_nothing_from_the_host_after_its_first_call(monkeypatch):
    """A CUDA graph cannot capture a host-to-device copy: the encode's
    per-level constants are made at the first call. Made under inference
    mode (an eval render first), they still serve a training backward."""
    res, t = (4, 9, 41), 512  # constants no other test makes
    table = torch.randn(3, t, 2, generator=torch.Generator().manual_seed(3))
    pos = torch.rand(50, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = hashgrid.hashgrid_encode(table, pos, res)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.tensor called after the first encode")

    monkeypatch.setattr(torch, "tensor", refuse)
    with torch.inference_mode():
        assert torch.equal(hashgrid.hashgrid_encode(table, pos, res), want)
    trained = table.clone().requires_grad_(True)
    x = pos.clone().requires_grad_(True)
    out = hashgrid.hashgrid_encode(trained, x, res)
    assert torch.equal(out.detach(), want)
    out.square().sum().backward()
    assert trained.grad.abs().sum() > 0 and torch.isfinite(x.grad).all()
