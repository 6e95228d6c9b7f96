"""The port's banded MCMC dataset (`data/datasets.py`) against the JAX
package's contract (tests/test_mcmc.py:28-77): shape, support, the sign of
the omega_i . omega_o correlation of a specular lobe, and the `.npy` cache
round trip; at 4 bands x 50 walkers x 400 sweeps."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.analytic import ggx_shading_disk, ggx_shading_spherical
from bsdf_diffusion_sampling_tpu_torch.data import datasets as td

STEPS, WALKERS, BANDS, BURN = 400, 50, 4, 200


def _disk(wi, wo):
    return ggx_shading_disk(wi, wo, roughness=0.4)


def _spherical(wi, wo):  # the sin(theta_o) area Jacobian included
    return ggx_shading_spherical(wi, wo, roughness=0.5) * torch.sin(wo[:, 0])


def test_disk_dataset_and_cache(tmp_path):
    cache = str(tmp_path / "ggx.npy")
    s = td.generate_brdf_dataset(0, _disk, domain="disk", nsteps=STEPS, nwalkers=WALKERS, piecewise=BANDS,
                                 burn_in=BURN, cache_path=cache, device="cpu")
    assert s.shape == (BANDS * STEPS * WALKERS, 4) and s.dtype == torch.float32
    s = s.numpy()
    wi, wo = s[:, :2], s[:, 2:]
    assert np.isfinite(s).all()
    assert (np.sum(wo**2, -1) <= 1.0 + 1e-5).all() and (np.sum(wi**2, -1) <= 1.0 + 1e-5).all()
    # band by band: each block of STEPS * WALKERS rows lies in its radial band
    r = np.sqrt(np.sum(wi**2, -1)).reshape(BANDS, -1)
    for b in range(BANDS):
        assert (r[b] > b / BANDS - 1e-6).all() and (r[b] <= (b + 1) / BANDS + 1e-6).all()
    assert np.mean(wi * wo) < 0.0  # wo mirrors wi about the normal
    cached = td.generate_brdf_dataset(0, _disk, domain="disk", nsteps=STEPS, nwalkers=WALKERS, piecewise=BANDS,
                                      burn_in=BURN, cache_path=cache, device="cpu")
    np.testing.assert_array_equal(cached.numpy(), s)
    np.testing.assert_array_equal(np.load(cache), s)


@pytest.mark.parametrize("domain", ["spherical", "sphere_full"])
def test_spherical_dataset_support(domain):
    s = td.generate_brdf_dataset(1, _spherical, domain=domain, nsteps=300, nwalkers=WALKERS, piecewise=3,
                                 burn_in=150, device="cpu").numpy()
    assert s.shape == (3 * 300 * WALKERS, 4)
    wi, wo = s[:, :2], s[:, 2:]
    top = math.pi / 2 if domain == "spherical" else math.pi
    assert ((wo[:, 0] > 0) & (wo[:, 0] < top)).all()
    assert ((wi[:, 0] > 0) & (wi[:, 0] < top)).all()
    assert (np.abs(wo[:, 1]) < math.pi).all() and (np.abs(wi[:, 1]) < math.pi).all()
    # the specular lobe: phi_o sits opposite phi_i, cos(phi_o - phi_i) < 0 on average
    assert np.mean(np.cos(wo[:, 1] - wi[:, 1])) < 0.0


def test_odd_walker_count_rounds_up():
    s = td.generate_brdf_dataset(2, _disk, domain="disk", nsteps=20, nwalkers=7, piecewise=2, burn_in=5,
                                 device="cpu")
    assert s.shape == (2 * 20 * 8, 4)
