"""Camera pose optimizer (SO3xR3 exponential-map refinement).

Port of `signerf_tpu/cameras/camera_opt.py`. The SIGNeRF configs freeze it
(lr 1e-15) and checkpoint surgery drops it on load, as the reference does;
with `use_camera_opt=True` the training rays carry a per-camera pose
correction, which makes the loss depend on the sample positions, so the
density kernels' coordinate gradient (K2's coords half) runs.
"""

from __future__ import annotations

import torch


def init_camera_opt(num_cameras: int) -> torch.Tensor:
    """[N, 6] zeros: (so3 log-rotation, translation)."""
    return torch.zeros(num_cameras, 6)


def exp_map_so3xr3(tangent: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 4] rigid transforms (Rodrigues for the rotation)."""
    log_rot = tangent[..., :3]
    t = tangent[..., 3:]
    theta = torch.linalg.vector_norm(log_rot, dim=-1, keepdim=True).clamp_min(1e-12)
    axis = log_rot / theta
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(kx)
    k_mat = torch.stack(
        [
            torch.stack([zero, -kz, ky], -1),
            torch.stack([kz, zero, -kx], -1),
            torch.stack([-ky, kx, zero], -1),
        ],
        dim=-2,
    )  # [..., 3, 3]
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(k_mat.shape)
    rot = eye + st * k_mat + (1.0 - ct) * (k_mat @ k_mat)
    # Small-angle fallback: identity rotation.
    rot = torch.where((theta < 1e-8)[..., None], eye, rot)
    return torch.cat([rot, t[..., :, None]], dim=-1)


def apply_camera_opt(
    tangent: torch.Tensor,  # [N_cams, 6]
    origins: torch.Tensor,  # [R, 3]
    directions: torch.Tensor,  # [R, 3]
    camera_indices: torch.Tensor,  # [R] int
):
    """Apply the per-camera pose correction to rays."""
    adj = exp_map_so3xr3(tangent[camera_indices.long()])  # [R, 3, 4]
    new_o = origins + adj[..., 3]
    new_d = (adj[..., :3] * directions[..., None, :]).sum(-1)
    return new_o, new_d
