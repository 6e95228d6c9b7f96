"""Environment-map emitter: lat-long eval, importance sampling, pdf,
counterpart of the JAX package's `render/envmap.py`.

An EXR in lat-long parameterization with a to_world rotation and a scalar
intensity scale. Directions map to texture coordinates in env-local space
with Y up: u = (1 + atan2(x, -z)/pi)/2, v = acos(clamp(y))/pi (Mitsuba's
convention). Importance sampling uses the 2D warp (one parameter slice)
over the luminance * sin(theta) grid.

`sample_env`, `eval_env` and `pdf_env` launch one kernel of
`ops/warp2d.py` for CUDA tensors and run their plain versions (`*_plain`)
for CPU ones; each adds the rows it computes to the counter
`rows.warp_env` while spans record.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.marginal2d import Warp2D, build_warp2d, warp_eval, warp_sample
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.native.exr import read_exr
from bsdf_diffusion_sampling_tpu_torch.ops import warp2d


class EnvMap(NamedTuple):
    data: torch.Tensor  # (H, W, 3) radiance (already scaled)
    warp: Warp2D  # sampling distribution over (u, v)
    to_world: torch.Tensor  # (3, 3) rotation env->world
    to_local: torch.Tensor  # (3, 3) world->env

    def to(self, device) -> "EnvMap":
        return EnvMap(self.data.to(device), self.warp.to(device), self.to_world.to(device),
                      self.to_local.to(device))


def envmap_from_image(img: np.ndarray, to_world: np.ndarray | None = None) -> EnvMap:
    h, w, _ = img.shape
    lum = np.maximum(0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2], 1e-8)
    theta = (np.arange(h) + 0.5) / h * np.pi
    warp = build_warp2d((lum * np.sin(theta)[:, None])[None], np.array([0.0]))
    r = np.eye(3, dtype=np.float32) if to_world is None else to_world[:3, :3]
    return EnvMap(
        data=torch.from_numpy(np.array(img, np.float32)),
        warp=warp,
        to_world=torch.from_numpy(np.asarray(r, np.float32)),
        to_local=torch.from_numpy(np.asarray(np.linalg.inv(r), np.float32)),
    )


def load_envmap(path: str, to_world: np.ndarray | None = None, scale: float = 1.0) -> EnvMap:
    return envmap_from_image(read_exr(path) * scale, to_world)


def black_envmap() -> EnvMap:
    """Zero-radiance placeholder for scenes lit only by point lights."""
    return envmap_from_image(np.zeros((2, 4, 3), np.float32))


def _dir_to_uv(d_local: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x, y, z = d_local[..., 0], d_local[..., 1], d_local[..., 2]
    u = (1.0 + torch.atan2(x, -z) / math.pi) * 0.5
    v = torch.arccos(torch.clamp(y, -1.0, 1.0)) / math.pi
    return u, v


def _uv_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    phi = (2.0 * u - 1.0) * math.pi
    theta = v * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], dim=-1)


def eval_env(env: EnvMap, d_world: torch.Tensor) -> torch.Tensor:
    """(N, 3) radiance arriving from direction d (pointing away from the
    shading point, world space); bilinear over texels, rows blended last."""
    trace.count("rows.warp_env", d_world.numel() // 3)
    if d_world.device.type == "cuda":
        return warp2d.eval_env(env, d_world)
    return eval_env_plain(env, d_world)


def eval_env_plain(env: EnvMap, d_world: torch.Tensor) -> torch.Tensor:
    u, v = _dir_to_uv(d_world @ env.to_local.T)
    h, w, _ = env.data.shape
    x = torch.clamp(u * w - 0.5, 0.0, w - 1 - 1e-3)
    y = torch.clamp(v * h - 0.5, 0.0, h - 1 - 1e-3)
    x0, y0 = x.to(torch.int64), y.to(torch.int64)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    row_lo = env.data[y0, x0] * (1 - fx) + env.data[y0, x1] * fx
    row_hi = env.data[y1, x0] * (1 - fx) + env.data[y1, x1] * fx
    return row_lo * (1 - fy) + row_hi * fy


def _uv_pdf_to_solid_angle(pdf_uv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    sin_theta = torch.clamp(torch.sin(v * math.pi), min=1e-6)
    return pdf_uv / (2.0 * math.pi * math.pi * sin_theta)


def sample_env(env: EnvMap, u2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u2 (N, 2) uniforms -> (d_world, radiance, pdf_solid_angle)."""
    trace.count("rows.warp_env", u2.numel() // 2)
    if u2.device.type == "cuda":
        return warp2d.sample_env(env, u2)
    return sample_env_plain(env, u2)


def sample_env_plain(env: EnvMap, u2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pos, pdf_uv = warp_sample(env.warp, u2, torch.zeros(u2.shape[:-1], device=u2.device))
    d_world = _uv_to_dir(pos[..., 0], pos[..., 1]) @ env.to_world.T
    return d_world, eval_env_plain(env, d_world), _uv_pdf_to_solid_angle(pdf_uv, pos[..., 1])


def pdf_env(env: EnvMap, d_world: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf that sample_env draws direction d."""
    trace.count("rows.warp_env", d_world.numel() // 3)
    if d_world.device.type == "cuda":
        return warp2d.pdf_env(env, d_world)
    return pdf_env_plain(env, d_world)


def pdf_env_plain(env: EnvMap, d_world: torch.Tensor) -> torch.Tensor:
    u, v = _dir_to_uv(d_world @ env.to_local.T)
    pdf_uv = warp_eval(env.warp, torch.stack([u, v], dim=-1), torch.zeros_like(u))
    return _uv_pdf_to_solid_angle(pdf_uv, v)
