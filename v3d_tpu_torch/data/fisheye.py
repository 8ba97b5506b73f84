"""Fisheye624 (FisheyeRadTanThinPrism) camera model in PyTorch — a port of
the JAX package's ``data/fisheye.py`` (itself of sgm/data/cam_utils.py
:1036-1248).

Radial (6-term odd polynomial in theta), tangential (p0, p1) and thin-prism
(s0..s3) distortion.  ``params`` rows are either

    [f_u f_v c_u c_v k_0..k_5 p_0 p_1 s_0..s_3]   (16 values, fx != fy)
    [f   c_u c_v     k_0..k_5 p_0 p_1 s_0..s_3]   (15 values)

Unprojection has no closed form: both Newton solves (xr_yr, then theta) run
a fixed iteration count, as in the JAX functions.  Everything is
differentiable tensor math on the inputs' device; on the optical axis the
gradient is finite (the JAX functions' is NaN there, their values equal).
"""

from __future__ import annotations

import torch


def _split_params(params):
    n = params.shape[-1]
    if n not in (15, 16):
        raise ValueError(f"fisheye624 takes 15 or 16 parameters, got {tuple(params.shape)}")
    if n == 15:
        f = params[..., 0:1][..., None, :]          # (B, 1, 1)
        c = params[..., 1:3][..., None, :]          # (B, 1, 2)
    else:
        f = params[..., 0:2][..., None, :]          # (B, 1, 2)
        c = params[..., 2:4][..., None, :]
    k = params[..., -12:-6]                          # (B, 6)
    p = params[..., -6:-4]                           # (B, 2)
    s = params[..., -4:]                             # (B, 4)
    return f, c, k, p, s


def _distort(xr_yr, p, s):
    """xr_yr (B, N, 2) -> distorted uv (B, N, 2) (tangential + thin prism)."""
    p0, p1 = p[..., 0:1], p[..., 1:2]                # (B, 1)
    xr, yr = xr_yr[..., 0], xr_yr[..., 1]
    xr_sq, yr_sq = xr * xr, yr * yr
    rd_sq = xr_sq + yr_sq
    rd_4 = rd_sq * rd_sq
    u = xr + (2.0 * xr_sq + rd_sq) * p0 + 2.0 * xr * yr * p1 \
        + s[..., 0:1] * rd_sq + s[..., 1:2] * rd_4
    v = yr + (2.0 * yr_sq + rd_sq) * p1 + 2.0 * xr * yr * p0 \
        + s[..., 2:3] * rd_sq + s[..., 3:4] * rd_4
    return torch.stack([u, v], dim=-1)


def fisheye624_project(xyz: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3), params (B, 15|16) -> uv (B, N, 2)
    (cam_utils.fisheye624_project)."""
    eps = 1e-9
    f, c, k, p, s = _split_params(params)
    z = xyz[..., 2:3]
    z = torch.where(z.abs() < eps, eps * torch.sign(z), z)
    ab = xyz[..., :2] / z
    r = torch.linalg.vector_norm(ab, dim=-1, keepdim=True)
    th = torch.atan(r)
    # the inner where keeps the gradient at r = 0 finite (values as the JAX
    # function's, whose gradient there is NaN)
    th_divr = torch.where(r < eps, torch.ones_like(ab), ab / torch.where(r < eps, 1.0, r))
    th_k = th
    for i in range(6):
        th_k = th_k + k[..., i][..., None, None] * th ** (3 + i * 2)
    xr_yr = th_k * th_divr
    uv_dist = _distort(xr_yr, p, s)
    return uv_dist * f + c


def fisheye624_unproject_helper(uv: torch.Tensor, params: torch.Tensor,
                                max_iters: int = 5) -> torch.Tensor:
    """uv (B, N, 2) -> rays (B, N, 3) with z = 1 (Newton inverse of project,
    cam_utils.fisheye624_unproject_helper)."""
    eps = 1e-6
    f, c, k, p, s = _split_params(params)
    p0, p1 = p[..., 0:1], p[..., 1:2]
    uv_dist = (uv - c) / f

    # Newton solve for xr_yr (distortion inverse)
    xr_yr = uv_dist
    for _ in range(max_iters):
        est = _distort(xr_yr, p, s)
        xr, yr = xr_yr[..., 0], xr_yr[..., 1]
        sq_norm = xr * xr + yr * yr
        # Jacobian d(est)/d(xr_yr)
        j00 = 1.0 + 6.0 * xr * p0 + 2.0 * yr * p1
        off = 2.0 * (xr * p1 + yr * p0)
        j11 = 1.0 + 6.0 * yr * p1 + 2.0 * xr * p0
        t1 = 2.0 * (s[..., 0:1] + 2.0 * s[..., 1:2] * sq_norm)
        j00 = j00 + xr * t1
        j01 = off + yr * t1
        t2 = 2.0 * (s[..., 2:3] + 2.0 * s[..., 3:4] * sq_norm)
        j10 = off + xr * t2
        j11 = j11 + yr * t2
        det = j00 * j11 - j01 * j10
        diff = uv_dist - est
        e, g = diff[..., 0], diff[..., 1]
        step = torch.stack([(j11 * e - j01 * g) / det,
                            (-j10 * e + j00 * g) / det], dim=-1)
        xr_yr = xr_yr + step

    # Newton solve for theta (radial inverse)
    xr_yr_norm = torch.linalg.vector_norm(xr_yr, dim=-1, keepdim=True)
    th = xr_yr_norm
    for _ in range(max_iters):
        th_radial = torch.ones_like(th)
        dthd_th = torch.ones_like(th)
        for i in range(6):
            r_k = k[..., i][..., None, None]
            th_radial = th_radial + r_k * th ** (2 + i * 2)
            dthd_th = dthd_th + (3.0 + 2.0 * i) * r_k * th ** (2 + i * 2)
        th_radial = th_radial * th
        step = (xr_yr_norm - th_radial) / dthd_th
        step = torch.where(dthd_th.abs() > eps, step, torch.sign(step) * eps * 10.0)
        th = th + step

    close = (th.abs() < eps) & (xr_yr_norm.abs() < eps)
    ray_dir = torch.where(close, xr_yr,
                          torch.tan(th) / torch.where(close, 1.0, xr_yr_norm) * xr_yr)
    return torch.cat([ray_dir, torch.ones_like(ray_dir[..., :1])], dim=-1)


def fisheye624_unproject(coords: torch.Tensor,
                         distortion_params: torch.Tensor) -> torch.Tensor:
    """(N, 2) pixel coords + (N, 15|16) params -> (1, N, 3) rays in the
    OpenGL-style camera space (y, z flipped) — cam_utils.fisheye624_unproject."""
    dirs = fisheye624_unproject_helper(coords[None], distortion_params[0][None])
    return dirs * torch.tensor([1.0, -1.0, -1.0], dtype=dirs.dtype, device=dirs.device)
