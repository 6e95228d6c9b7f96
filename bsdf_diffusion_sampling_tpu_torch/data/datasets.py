"""Banded MCMC training data and its `.npy` cache (counterpart of the JAX
package's `data/datasets.py`).

omega_i space is cut into `piecewise` radial (disk) or theta (spherical)
bands. Each band's ensemble starts from stratified proposals, the
highest-density ones, and runs burn_in + nsteps sweeps; the bands' chains
concatenate into (piecewise * nsteps * nwalkers, 4) rows of (omega_i,
omega_o) distributed as BSDF x domain Jacobian. All bands run as one
batched ensemble (`data/mcmc.py`), and the chain stays on the device; it is
copied to the host only to write the cache.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core import prng
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.data.mcmc import ensemble_mcmc, make_domain_log_prob
from bsdf_diffusion_sampling_tpu_torch.geometry.sampling import stratified_disk, stratified_hemisphere_angles


def _init_walkers(gen: torch.Generator, pdf_fn, domain: str, r_min: float, r_max: float, nwalkers: int,
                  theta_max: float) -> torch.Tensor:
    """Positive-density (omega_i, omega_o) starting points within the band,
    (nwalkers, 4) on the generator's device."""
    n_prop = max(nwalkers * 64, 4096)
    if domain == "disk":
        wi = stratified_disk(gen, n_prop)
        # map radii into the band (keeps the stratification, stays in support)
        r = torch.linalg.vector_norm(wi, dim=-1)
        r_band = r_min + (r_max - r_min) * torch.clamp(r, 1e-3, 1.0)
        wi = wi * (r_band / torch.clamp(r, min=1e-6))[:, None]
        wo = stratified_disk(gen, n_prop) * 0.999
    else:
        wi = stratified_hemisphere_angles(gen, n_prop, theta_max)
        wi[:, 0] = r_min + (r_max - r_min) * torch.clamp(wi[:, 0] / theta_max, 1e-3, 1.0 - 1e-3)
        wo = stratified_hemisphere_angles(gen, n_prop, theta_max)
    f = pdf_fn(wi, wo)
    idx = torch.argsort(-f)[: nwalkers * 4]  # the densest, so the walkers start in support
    idx = idx[torch.randperm(idx.shape[0], generator=gen, device=gen.device)][:nwalkers]
    return torch.cat([wi[idx], wo[idx]], dim=-1)


def generate_brdf_dataset(
    seed: int,
    pdf_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    domain: str = "disk",
    nsteps: int = 40_000,
    nwalkers: int = 50,
    piecewise: int = 10,
    burn_in: int = 10_000,
    cache_path: Optional[str] = None,
    device="cuda",
) -> torch.Tensor:
    """(piecewise * nsteps * nwalkers, 4) float32 samples on `device`, band
    by band, each band's sweeps in order. An odd walker count is rounded up
    (the red-black ensemble needs an even one); the reference's 49 walkers
    become 50. A cache file that exists is read instead."""
    device = resolve_device(device)
    if cache_path is not None and os.path.exists(cache_path):
        return torch.from_numpy(np.load(cache_path)).to(device)
    theta_max = math.pi if domain == "sphere_full" else math.pi / 2
    nwalkers += nwalkers % 2

    band_edge = (1.0 if domain == "disk" else theta_max) / piecewise
    r_min = [band * band_edge for band in range(piecewise)]
    r_max = [(band + 1) * band_edge for band in range(piecewise)]
    init_seed = prng.fold_in(seed, "mcmc/init")
    x0 = torch.stack([_init_walkers(prng.iter_generator(init_seed, band, device), pdf_fn, domain, r_min[band],
                                    r_max[band], nwalkers, theta_max) for band in range(piecewise)])
    bounds = tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (r_min, r_max))
    chain, _ = ensemble_mcmc(prng.stage_generator(seed, "mcmc/run", device), make_domain_log_prob(pdf_fn, domain),
                             x0, nsteps, burn_in=burn_in, log_prob_args=bounds)
    samples = chain.transpose(0, 1).reshape(-1, 4)  # band, sweep, walker
    if cache_path is not None:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.save(cache_path, samples.cpu().numpy())
    return samples
