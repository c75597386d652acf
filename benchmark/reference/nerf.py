"""Plain PyTorch reference of the configurations' NeRF: rays, the factor-grid
fields, proposal sampling, volume rendering, the losses (L1 or MSE, LPIPS
on patches, interlevel, distortion, orientation and predicted normals), and
grouped Adam.

It imports nothing of the program. It is written from the configuration
files' sizes and nerfacto's equations as the repository defines them (the
factor grid in place of the hash grid: per level, each axis' line table
linearly interpolated, the three axes multiplied), in float32 throughout,
with no kernels, and with the density's spatial gradient (the gradient
normals) taken by autograd with its graph kept, where the program computes
it in closed form. Where nerfacto's sampler draws random numbers, this code
draws them from a generator in the state the benchmark hands it, with the
same calls in the same order as the program's sampler, so both sides sample
the same pixels and the same jitter.

`Precision` rounds values as a lower precision would: `FULL` is float32;
`CONTROL` rounds what the configurations state in bfloat16 (every Dense
layer's operands and the factor grid's tables) to float8 (e4m3), and every
other value it passes to bfloat16 (they state float32), with the gradient
passed straight through.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

B1, B2 = 0.9, 0.999


def _round_st(x: torch.Tensor, dtype) -> torch.Tensor:
    return x + (x.to(dtype).float() - x).detach()


@dataclasses.dataclass(frozen=True)
class Precision:
    matmul: Optional[torch.dtype] = None
    values: Optional[torch.dtype] = None
    tables: Optional[torch.dtype] = None

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.matmul is not None:
            x, w = _round_st(x, self.matmul), _round_st(w, self.matmul)
        return x @ w

    def v(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.values is None else _round_st(x, self.values)

    def t(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tables is None else _round_st(x, self.tables)


FULL = Precision()
CONTROL = Precision(matmul=torch.float8_e4m3fn, values=torch.bfloat16, tables=torch.float8_e4m3fn)
# what the configurations state in bfloat16 rounded so: a look at how far
# that rounding alone moves each number, not a side of the comparison
CONFIGURED = Precision(matmul=torch.bfloat16, tables=torch.bfloat16)


def resolutions(num_levels: int, base_res: int, max_res: int):
    if num_levels == 1:
        return (base_res,)
    g = math.exp((math.log(max_res) - math.log(base_res)) / (num_levels - 1))
    return tuple(int(round(base_res * g**lvl)) for lvl in range(num_levels))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _mlp_shapes(prefix: str, dims: Sequence[int]) -> Dict[str, tuple]:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}.dense_{i}.kernel"] = (a, b)
        out[f"{prefix}.dense_{i}.bias"] = (b,)
    return out


def param_shapes(model: Dict, num_images: int) -> Dict[str, tuple]:
    """Every trained tensor of a configuration's NeRF, by the dotted names
    of the repository's parameter tree."""
    m, f = model, model["field"]
    shapes: Dict[str, tuple] = {}
    res = resolutions(f["factor_num_levels"], m["base_res"], m["max_res"])
    for lvl, r in enumerate(res):
        for ax in range(3):
            shapes[f"field.encoding.line_{lvl}_{ax}"] = (r, f["factor_features_per_level"])
    d = len(res) * f["factor_features_per_level"]
    geo, sh = f["geo_feat_dim"], f["sh_levels"] ** 2
    shapes.update(_mlp_shapes("field.mlp_base", [d, m["hidden_dim"], 1 + geo]))
    head_in = sh + geo
    if m["use_appearance_embedding"]:
        head_in += m["appearance_embed_dim"]
        shapes["field.appearance.embedding"] = (num_images, m["appearance_embed_dim"])
    shapes.update(_mlp_shapes("field.mlp_head", [head_in] + [m["hidden_dim_color"]] * (f["num_layers_color"] - 1) + [3]))
    if m["predict_normals"]:
        hp = f["pred_normals_hidden"]
        shapes.update(_mlp_shapes("field.mlp_pred_normals", [geo + sh, hp, hp, 3]))
    pf = m["proposal_factor_features_per_level"]
    for i, args in enumerate(m["proposal_net_args_list"][: m["num_proposal_iterations"]]):
        pres = resolutions(args["num_levels"], m["proposal_base_res"], args["max_res"])
        for lvl, r in enumerate(pres):
            for ax in range(3):
                shapes[f"proposal_{i}.FactorGridEncoding_0.line_{lvl}_{ax}"] = (r, pf)
        shapes.update(_mlp_shapes(f"proposal_{i}.MLP_0", [len(pres) * pf, args["hidden_dim"], 1]))
    return shapes


def init_params(shapes: Dict[str, tuple], generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded weights in one draw: line tables N(0, 0.2^2), Dense kernels
    normal with variance 1 / fan_in cut at two deviations, biases zero,
    appearance codes N(0, 0.01^2)."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    out, off = {}, 0
    for name, size in zip(names, sizes):
        t = z[off : off + size].view(shapes[name])
        off += size
        if ".line_" in name:
            t = t * 0.2
        elif name.endswith(".kernel"):
            t = t.clamp(-2.0, 2.0) * (math.sqrt(1.0 / shapes[name][0]) / 0.87962566103423978)
        elif name.endswith(".bias"):
            t = torch.zeros_like(t)
        else:  # appearance codes
            t = t * 0.01
        out[name] = t.contiguous()
    return out


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------


def rays_at(poses: torch.Tensor, focal: float, size: int, idx: torch.Tensor):
    """Rays through pixel centres (camera, y, x) of square cameras."""
    cam = idx[:, 0].long()
    px = idx[:, 2].float() + 0.5
    py = idx[:, 1].float() + 0.5
    d_cam = torch.stack([(px - size / 2) / focal, -(py - size / 2) / focal, -torch.ones_like(px)], -1)
    rot = poses[cam][:, :, :3]
    d = (rot @ d_cam[:, :, None])[..., 0]
    d = d / d.norm(dim=-1, keepdim=True)
    return poses[cam][:, :, 3], d, cam


def aabb_near_far(o: torch.Tensor, d: torch.Tensor, lo: float, hi: float):
    inv = 1.0 / (d + 1e-6)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near = torch.minimum(t0, t1).amax(-1, keepdim=True).clamp_min(0.0)
    far = torch.maximum(t0, t1).amin(-1, keepdim=True)
    return near, torch.maximum(far, near + 1e-6)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.exp(x.clamp(-15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def contract_to_unit(x: torch.Tensor) -> torch.Tensor:
    """mipnerf360's contraction under the L-inf norm, shifted into [0, 1]^3."""
    mag = x.abs().amax(-1, keepdim=True)
    ms = mag.clamp_min(1.0)
    s = torch.where(mag <= 1.0, torch.ones_like(ms), (2.0 - 1.0 / ms) / ms)
    return (x * s + 2.0) / 4.0


def encode(params, prefix: str, num_levels: int, x01: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[N, 3] in [0, 1] -> [N, L F]: per level the product over the axes of
    each axis' line table linearly interpolated at u (R - 1)."""
    feats = []
    for lvl in range(num_levels):
        prod = None
        for ax in range(3):
            t = prec.t(params[f"{prefix}.line_{lvl}_{ax}"])
            r = t.shape[0]
            u = x01[:, ax].clamp(0.0, 1.0) * (r - 1)
            i0 = u.detach().floor().clamp(0, r - 2).long()
            w = (u - i0)[:, None]
            # embedding's backward sums rows by sorting, not by atomics into
            # a few hot rows (the coarse levels have 16 to 256)
            v = F.embedding(i0, t) * (1.0 - w) + F.embedding(i0 + 1, t) * w
            prod = v if prod is None else prod * v
        feats.append(prod)
    return prec.v(torch.cat(feats, dim=-1))


def mlp(params, prefix: str, x: torch.Tensor, prec: Precision, out_act: Optional[str] = None) -> torch.Tensor:
    n = 0
    while f"{prefix}.dense_{n}.kernel" in params:
        n += 1
    for i in range(n):
        x = prec.mm(x, params[f"{prefix}.dense_{i}.kernel"]) + params[f"{prefix}.dense_{i}.bias"]
        if i < n - 1:
            x = torch.relu(x)
    x = prec.v(x)
    return torch.sigmoid(x) if out_act == "sigmoid" else x


def proposal_density(params, i: int, model: Dict, positions: torch.Tensor, prec: Precision) -> torch.Tensor:
    args = model["proposal_net_args_list"][i]
    x = contract_to_unit(positions.reshape(-1, 3))
    h = mlp(params, f"proposal_{i}.MLP_0", encode(params, f"proposal_{i}.FactorGridEncoding_0", args["num_levels"], x, prec), prec)
    return _TruncExp.apply(h[:, 0] - 1.0).reshape(positions.shape[:-1])


def base_density(params, model: Dict, positions: torch.Tensor, prec: Precision, with_grad: bool):
    """(density [...], geo [..., G], d density / d x or None). With
    `with_grad` the spatial gradient keeps its graph, so a loss on it
    trains the field (second order)."""
    x = positions.reshape(-1, 3)
    if with_grad:
        x = x.detach().requires_grad_(True)
    with torch.enable_grad() if with_grad else contextlib.nullcontext():
        h = mlp(params, "field.mlp_base",
                encode(params, "field.encoding", model["field"]["factor_num_levels"], contract_to_unit(x), prec), prec)
        raw = h[:, 0] - 1.0
        grad = None
        if with_grad:
            clamped = model["average_init_density"] * torch.exp(raw.clamp(-15.0, 15.0))
            (grad,) = torch.autograd.grad(clamped.sum(), x, create_graph=True)
            grad = grad.reshape(*positions.shape)
    density = model["average_init_density"] * _TruncExp.apply(raw)
    return prec.v(density).reshape(positions.shape[:-1]), h[:, 1:].reshape(*positions.shape[:-1], -1), grad


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree < 4 (16 values) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x,
        1.0925484305920792 * x * y, 1.0925484305920792 * y * z, 0.9461746957575601 * zz - 0.31539156525252005,
        1.0925484305920792 * x * z, 0.5462742152960396 * (xx - yy),
        0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * x * y * z,
        0.4570457994644658 * y * (5.0 * zz - 1.0), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.4570457994644658 * x * (5.0 * zz - 1.0), 1.445305721320277 * z * (xx - yy),
        0.5900435899266435 * x * (xx - 3.0 * yy),
    ], dim=-1)


def heads(params, model: Dict, geo, directions, cam, train: bool, prec: Precision):
    r, s = geo.shape[:2]
    d_enc = sh_encode(directions)[:, None, :].expand(r, s, -1)
    head_in = [d_enc, geo]
    if model["use_appearance_embedding"]:
        codes = params["field.appearance.embedding"]
        embed = codes[cam][:, None, :] if train else codes.mean(0)
        head_in.append(embed.expand(r, s, codes.shape[-1]))
    rgb = mlp(params, "field.mlp_head", torch.cat(head_in, dim=-1), prec, "sigmoid")
    pred = None
    if model["predict_normals"]:
        pn = mlp(params, "field.mlp_pred_normals", torch.cat([geo, d_enc], dim=-1), prec)
        pred = pn / pn.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return rgb, pred


# ---------------------------------------------------------------------------
# sampling and rendering
# ---------------------------------------------------------------------------


def _piecewise(x):
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x.clamp_min(1e-12)))


def _piecewise_inv(x):
    return torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x).clamp_min(1e-12))


def _pdf_bins(bins, weights, num_samples, jitter):
    """Inverse-CDF resampling of s-space edges [R, S+1] by weights [R, S]."""
    weights = weights + 0.01
    wsum = weights.sum(-1, keepdim=True)
    pad = (1e-7 - wsum).clamp_min(0.0)
    weights = weights + pad / weights.shape[-1]
    pdf = weights / (wsum + pad)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), pdf.cumsum(-1)], -1).clamp_max(1.0).contiguous()
    s = num_samples + 1
    base = torch.linspace(0.0, 1.0 - 1.0 / s, s, device=bins.device)[None, :]
    u = (base + jitter / s) if jitter is not None else (base + 0.5 / s).expand(bins.shape[0], s)
    u = u.contiguous()
    last = cdf.shape[-1] - 1
    below = torch.searchsorted(cdf, u, right=True) - 1
    above = torch.searchsorted(cdf, u, right=False)
    cb = torch.where(below >= 0, cdf.gather(-1, below.clamp(0, last)), cdf[:, :1])
    bb = torch.where(below >= 0, bins.gather(-1, below.clamp(0, last)), bins[:, :1])
    ca = torch.where(above <= last, cdf.gather(-1, above.clamp(0, last)), cdf[:, -1:])
    ba = torch.where(above <= last, bins.gather(-1, above.clamp(0, last)), bins[:, -1:])
    diff = ca - cb
    t = ((u - cb) / torch.where(diff < 1e-10, torch.ones_like(diff), diff)).clamp(0.0, 1.0)
    return torch.cummax(bb + t * (ba - bb), dim=-1).values


def render_weights(density, deltas):
    dd = deltas * density
    excl = torch.cat([torch.zeros_like(dd[:, :1]), dd[:, :-1].cumsum(-1)], -1)
    return (1.0 - torch.exp(-dd)) * torch.exp(-excl)


def forward(params, model: Dict, origins, directions, cam, near, far, jitters: Optional[List[torch.Tensor]],
            anneal: float, train: bool, prec: Precision) -> Dict:
    """nerfacto over a flat ray batch. `jitters`: the sampler's uniform
    draws ([R, 1] each: the uniform bins', then each proposal level's), or
    None for the deterministic eval sampling."""
    r = origins.shape[0]
    near = near.clamp_min(model["near_plane"])
    far = far.clamp_max(model["far_plane"])
    s_near, s_far = _piecewise(near), _piecewise(far)

    def samples(bins):
        t = _piecewise_inv(bins * s_far + (1.0 - bins) * s_near)
        starts, ends = t[:, :-1], t[:, 1:]
        pos = origins[:, None, :] + directions[:, None, :] * (0.5 * (starts + ends))[..., None]
        return prec.v(pos), starts, ends

    n0 = model["num_proposal_samples_per_ray"][0]
    bins = torch.linspace(0.0, 1.0, n0 + 1, device=origins.device).expand(r, n0 + 1)
    if jitters is not None:
        bins = (bins + (jitters[0] - 0.5) * (1.0 / n0)).clamp(0.0, 1.0)
    w_list, bins_list = [], []
    n_iter = model["num_proposal_iterations"]
    for i in range(n_iter):
        pos, starts, ends = samples(bins)
        w = prec.v(render_weights(proposal_density(params, i, model, pos, prec), ends - starts))
        annealed = torch.where(w < 1e-7, torch.zeros_like(w), w.clamp_min(1e-7).pow(anneal))
        w_list.append(annealed)
        bins_list.append(bins)
        n_next = (model["num_proposal_samples_per_ray"][i + 1] if i + 1 < n_iter else model["num_nerf_samples_per_ray"])
        bins = _pdf_bins(bins, annealed.detach(), n_next, None if jitters is None else jitters[i + 1])
    pos, starts, ends = samples(bins)
    grad_normals = model["predict_normals"] and model["use_gradient_normals"]
    density, geo, grad = base_density(params, model, pos, prec, with_grad=grad_normals and train)
    rgb, pred = heads(params, model, geo, directions, cam, train, prec)
    weights = prec.v(render_weights(density, ends - starts))
    acc = weights.sum(-1, keepdim=True)
    comp = (weights[..., None] * rgb).sum(-2)
    if model["background_color"] != "last_sample":
        raise ValueError("the reference composites over the last sample's colour only")
    out = {"rgb": prec.v((comp + rgb[:, -1, :] * (1.0 - acc)).clamp(0.0, 1.0)), "accumulation": acc,
           "weights": weights, "bins": bins, "weights_list": w_list, "bins_list": bins_list,
           "directions": directions, "pred_normals": pred}
    mids = 0.5 * (starts + ends)
    depth = (weights * mids).sum(-1, keepdim=True) / acc.clamp_min(1e-10)
    out["expected_depth"] = torch.minimum(torch.maximum(depth, mids[:, :1]), mids[:, -1:])
    if grad is not None:
        out["normals"] = -grad / torch.sqrt((grad * grad).sum(-1, keepdim=True) + 1e-12)
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _outer(t0s, t0e, t1s, t1e, y1):
    cy1 = torch.cat([torch.zeros_like(y1[:, :1]), y1.cumsum(-1)], -1)
    inf = torch.tensor(float("inf"), device=y1.device)
    lo = torch.where(t1s[:, None, :] <= t0s[:, :, None], cy1[:, None, :-1], -inf).amax(-1)
    hi = torch.where(t1e[:, None, :] >= t0e[:, :, None], cy1[:, None, 1:], inf).amin(-1)
    lo = torch.where(torch.isfinite(lo), lo, cy1[:, :1])
    hi = torch.where(torch.isfinite(hi), hi, cy1[:, -1:])
    return hi - lo


def losses(out: Dict, target: torch.Tensor, model: Dict, lpips_params: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """The configuration's train losses, each a mean over this batch's rays
    (LPIPS: over its patches)."""
    pred = out["rgb"]
    ld = {"rgb_loss": (pred - target).abs().mean() if model["use_l1"] else ((pred - target) ** 2).mean()}
    c, w = out["bins"].detach(), out["weights"].detach()
    inter = 0.0
    for w_env, t_env in zip(out["weights_list"], out["bins_list"]):
        w_outer = _outer(c[:, :-1], c[:, 1:], t_env[:, :-1], t_env[:, 1:], w_env)
        inter = inter + ((w - w_outer).clamp_min(0.0) ** 2 / (w + 1e-7)).sum(-1).mean()
    ld["interlevel_loss"] = model["interlevel_loss_mult"] * inter
    t, wt = out["bins"], out["weights"]
    ut = 0.5 * (t[:, 1:] + t[:, :-1])
    dut = (ut[:, :, None] - ut[:, None, :]).abs()
    dist = (wt * (wt[:, None, :] * dut).sum(-1)).sum(-1) + (wt**2 * (t[:, 1:] - t[:, :-1])).sum(-1) / 3.0
    ld["distortion_loss"] = model["distortion_loss_mult"] * dist.mean()
    if model["predict_normals"] and "normals" in out:
        n_dot_v = (out["normals"] * -out["directions"][:, None, :]).sum(-1)
        ld["orientation_loss"] = model["orientation_loss_mult"] * (w * n_dot_v.clamp_max(0.0) ** 2).sum(-1).mean()
        cos = (out["normals"].detach() * out["pred_normals"]).sum(-1)
        ld["pred_normal_loss"] = model["pred_normal_loss_mult"] * (w * (1.0 - cos)).sum(-1).mean()
    if model.get("use_lpips", False):
        ps = model["patch_size"]
        a = (pred.reshape(-1, ps, ps, 3) * 2.0 - 1.0).clamp(-1.0, 1.0)
        b = (target.reshape(-1, ps, ps, 3) * 2.0 - 1.0).clamp(-1.0, 1.0)
        ld["lpips_loss"] = model["lpips_loss_mult"] * lpips(lpips_params, a, b).mean()
    return ld


# ---------------------------------------------------------------------------
# LPIPS (AlexNet stages, random backbone from the seed)
# ---------------------------------------------------------------------------

ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]


def init_lpips(generator: torch.Generator, device) -> Dict:
    """He-initialised AlexNet backbone (one draw) and unit heads 1 / C."""
    shapes, cin = [], 3
    for out, k, _, _ in ALEX:
        shapes.append((out, cin, k, k))
        cin = out
    z = torch.randn(sum(math.prod(s) for s in shapes), generator=generator, device=device)
    convs, off = [], 0
    for s in shapes:
        n = math.prod(s)
        convs.append({"kernel": (z[off : off + n].view(s) * (2.0 / (s[1] * s[2] * s[3])) ** 0.5).contiguous(),
                      "bias": torch.zeros(s[0], device=device)})
        off += n
    return {"convs": convs, "lins": [torch.ones(s[0], device=device) / s[0] for s in shapes]}


def lpips(params: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per pair of [N, H, W, 3] images in [-1, 1]."""
    shift = x.new_tensor((-0.030, -0.088, -0.188))
    scale = x.new_tensor((0.458, 0.448, 0.450))

    def feats(z):
        z = ((z - shift) / scale).permute(0, 3, 1, 2)
        out = []
        for i, ((_, _, stride, pad), conv) in enumerate(zip(ALEX, params["convs"])):
            z = torch.relu(F.conv2d(z, conv["kernel"], conv["bias"], stride=stride, padding=pad))
            out.append(z)
            if i in (0, 1) and z.shape[2] >= 3:
                z = F.max_pool2d(z, 3, 2)
        return out

    total = x.new_zeros(x.shape[0])
    for f1, f2, w in zip(feats(x), feats(y), params["lins"]):
        n1 = f1 / f1.norm(dim=1, keepdim=True).clamp_min(1e-10)
        n2 = f2 / f2.norm(dim=1, keepdim=True).clamp_min(1e-10)
        total = total + (((n1 - n2) ** 2) * w.clamp_min(0.0)[:, None, None]).sum(1).mean((1, 2))
    return total


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def group_of(name: str) -> str:
    parts = name.split(".")
    if "appearance" in parts:
        return "appearance"
    if parts[0].startswith("proposal"):
        return "proposal_networks"
    if parts[0] == "camera_opt":
        return "camera_opt"
    return "fields"


def learning_rate(group_cfg: Dict, count: int) -> float:
    lr, final = group_cfg["lr"], group_cfg.get("lr_final")
    if final is None:
        return lr
    value = lr * (final / lr) ** (count / group_cfg["max_steps"])
    return max(value, final) if final < lr else min(value, final)


class Adam:
    """Adam per optimizer group (AdamW with decoupled decay for the
    appearance codes), the learning rate read at the count before the step."""

    def __init__(self, optim_cfg: Dict, params: Dict[str, torch.Tensor]):
        self.cfg = optim_cfg
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        groups: Dict[str, List[str]] = {}
        for n in params:
            groups.setdefault(group_of(n), []).append(n)
        for g, names in groups.items():
            gcfg = self.cfg["fields" if g == "appearance" else g]
            c0 = self.count.get(g, 0)
            lr = learning_rate(gcfg, c0)
            c = self.count[g] = c0 + 1
            for n in names:
                grad = grads[n]
                self.m[n].mul_(B1).add_(grad * (1.0 - B1))
                self.v[n].mul_(B2).add_(grad * grad * (1.0 - B2))
                u = (self.m[n] / (1.0 - B1**c)) / ((self.v[n] / (1.0 - B2**c)).sqrt() + gcfg["eps"])
                if g == "appearance":
                    u = u + self.cfg["appearance_weight_decay"] * params[n]
                params[n].sub_(lr * u)


def anneal(model: Dict, step: int) -> float:
    x = (torch.tensor(float(step)) / model["proposal_weights_anneal_max_num_iters"]).clamp(0.0, 1.0)
    b = model["proposal_weights_anneal_slope"]
    return float(b * x / ((b - 1.0) * x + 1.0))
