"""The port's LPIPS against the JAX package's, on the CPU: alex and vgg on
32x32 patches from the same parameters (JAX `init_lpips`, moved over by
`convert.lpips_from_jax`), the `.npz` loaders, the gradient, and the rule
that LPIPS stays out of the model's state_dict and the optimizer.

Inputs are made with numpy from a seed and handed to both frameworks. Both
sides compute the convolutions in f32 on the CPU (XLA's and oneDNN's
algorithms sum in other orders), so values agree to f32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.ops import lpips as jlp
from signerf_tpu_torch.convert import lpips_from_jax
from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer
from signerf_tpu_torch.models.nerfacto import ProposalNetArgs
from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig
from signerf_tpu_torch.ops import lpips as tlp

torch.set_num_threads(2)


def patches(seed, n=3):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 32, 32, 3)) * 2 - 1).astype(np.float32)
    y = np.clip(x + rng.standard_normal(x.shape) * 0.3, -1, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net):
    jparams = jlp.init_lpips(jax.random.PRNGKey(0), net)
    tparams = lpips_from_jax(jparams)
    assert tparams.convs[0]["kernel"].shape == tuple(np.asarray(jparams.convs[0]["kernel"]).transpose(3, 2, 0, 1).shape)
    x, y = patches(1)
    want, jgrad = jax.value_and_grad(lambda a: jnp.sum(jlp.lpips(jparams, a, jnp.asarray(y))))(jnp.asarray(x))
    want_each = np.asarray(jlp.lpips(jparams, jnp.asarray(x), jnp.asarray(y)))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tlp.lpips(tparams, tx, torch.from_numpy(y))
    got.sum().backward()
    assert got.shape == (3,) and float(got.detach().min()) > 0
    # f32 convolutions summed in another order: measured 2.7e-7 (alex) and
    # 4.3e-7 (vgg) relative.
    np.testing.assert_allclose(got.detach().numpy(), want_each, rtol=1e-5)
    g, jg = tx.grad.numpy().astype(np.float64), np.asarray(jgrad, np.float64)
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 1e-4  # measured 2.1e-6 (alex), 1.6e-6 (vgg)
    same = tlp.lpips(tparams, torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_npz_is_read_by_both_loaders(tmp_path):
    """An `.npz` in the export format (HWIO conv kernels, biases, linear
    heads) gives the same distance through either package's loader."""
    jparams = jlp.init_lpips(jax.random.PRNGKey(3), "alex")
    rng = np.random.default_rng(4)
    arrays = {}
    for i, c in enumerate(jparams.convs):
        arrays[f"conv{i}_kernel"] = np.asarray(c["kernel"])
        arrays[f"conv{i}_bias"] = rng.standard_normal(np.asarray(c["bias"]).shape).astype(np.float32) * 0.1
    for i, w in enumerate(jparams.lins):
        arrays[f"lin{i}"] = rng.random(np.asarray(w).shape).astype(np.float32) - 0.2  # some < 0: clamped
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **arrays)
    jl = jlp.load_weights(path, "alex")
    tl = tlp.load_weights(path, "alex")
    assert len(tl.convs) == 5 and len(tl.lins) == 5
    x, y = patches(5, n=2)
    want = np.asarray(jlp.lpips(jl, jnp.asarray(x), jnp.asarray(y)))
    got = tlp.lpips(tl, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)  # as above


def tiny_signerf(**kw):
    cfg = SIGNeRFModelConfig(
        max_res=32, hidden_dim=8, hidden_dim_color=8, appearance_embed_dim=4,
        num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4, predict_normals=True,
        proposal_net_args_list=(ProposalNetArgs(num_levels=2, max_res=16, hidden_dim=8),
                                ProposalNetArgs(num_levels=2, max_res=32, hidden_dim=8)),
        **kw,
    )
    return SIGNeRFModel(cfg, num_train_images=2)


def test_lpips_params_are_frozen_and_kept_out_of_checkpoints_and_the_optimizer():
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        model = tiny_signerf()
    lp = model.lpips_params
    assert lp is not None and lp.net == "alex"
    frozen = [t for c in lp.convs for t in c.values()] + list(lp.lins)
    assert not any(t.requires_grad for t in frozen)
    assert not any("lpips" in k or "conv" in k for k in model.state_dict())
    assert len(model.state_dict()) == len(list(model.parameters()))
    opt = make_optimizer(OptimizersConfig(), model)
    in_opt = {id(p) for ps in opt.params.values() for p in ps}
    assert not any(id(t) in in_opt for t in frozen)
    assert sum(len(ps) for ps in opt.params.values()) == len(list(model.parameters()))
    assert any(n.startswith("field.mlp_pred_normals.") for n in opt.names["fields"])
    # `.to()` moves (and here converts) them with the model
    model.double()
    assert all(t.dtype == torch.float64 for t in [*model.lpips_params.convs[0].values(), *model.lpips_params.lins])
    assert tiny_signerf(use_lpips=False).lpips_params is None


def test_lpips_loss_is_over_clamped_patches():
    """The loss term: patches of patch_size^2 rays, mapped to [-1, 1] and
    clamped, LPIPS averaged over the patches and scaled by its mult."""
    model = tiny_signerf(patch_size=16, lpips_loss_mult=0.5)
    rng = np.random.default_rng(6)
    pred = torch.from_numpy(rng.random((512, 3)).astype(np.float32) * 1.2 - 0.1)  # some outside [0, 1]
    target = torch.from_numpy(rng.random((512, 3)).astype(np.float32))
    ld = model.loss_dict({"rgb": pred}, {"image": target}, train=False)
    assert sorted(ld) == ["lpips_loss", "rgb_loss"]
    p = (pred.reshape(2, 16, 16, 3) * 2 - 1).clamp(-1, 1)
    t = (target.reshape(2, 16, 16, 3) * 2 - 1).clamp(-1, 1)
    torch.testing.assert_close(ld["lpips_loss"], 0.5 * tlp.lpips(model.lpips_params, p, t).mean())
    torch.testing.assert_close(ld["rgb_loss"], (pred - target).abs().mean())
    mse = dataclasses.replace(model.config, use_l1=False, use_lpips=False)
    ld = SIGNeRFModel(mse, 2).loss_dict({"rgb": pred}, {"image": target}, train=False)
    assert sorted(ld) == ["rgb_loss"]
    torch.testing.assert_close(ld["rgb_loss"], ((pred - target) ** 2).mean())
