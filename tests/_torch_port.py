"""Shared set-up of the PyTorch port's parity tests.

One set of full-width disk weights, made with the JAX package's own
initialisers from a fixed key (velocity weights scaled by 0.5 so that the
Euler map stays invertible, as tests/test_fused_sample_pdf.py does), and
inputs drawn with numpy. Both go to both packages: to JAX as arrays, to
the port through `params_from_jax` as float32 CPU tensors.
"""

from types import SimpleNamespace

import jax
import numpy as np
import torch

from bsdf_diffusion_sampling_tpu.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu.models import get_base, velocity_init
from bsdf_diffusion_sampling_tpu.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition as t_encode_condition

T = 4


def tt(a) -> torch.Tensor:
    """A float32 CPU tensor holding a copy of `a` (numpy or JAX)."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def disk_setup(n: int = 256, seed: int = 0) -> SimpleNamespace:
    cfg = ModelConfig(domain="disk")
    k1, k2 = jax.random.split(jax.random.key(seed))
    v = jax.tree.map(lambda w: w * 0.5, velocity_init(k1, cfg))
    b = get_base("disk").init(k2)
    rng = np.random.default_rng(seed)
    omega = rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32)
    return SimpleNamespace(
        cfg=cfg, v=v, b=b, tv=params_from_jax(v, "cpu"), tb=params_from_jax(b, "cpu"),
        omega=omega, cond=encode_condition(omega, cfg), t_omega=tt(omega),
        t_cond=t_encode_condition(tt(omega), cfg), rng=rng, n=n)


def hemisphere(rng: np.random.Generator, n: int) -> np.ndarray:
    """Local directions with cos(theta) in [0.1, 0.95]."""
    u = rng.random((n, 2), dtype=np.float32)
    ct = 0.1 + 0.85 * u[:, 0]
    st = np.sqrt(1.0 - ct * ct)
    phi = 2.0 * np.pi * u[:, 1]
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1).astype(np.float32)
