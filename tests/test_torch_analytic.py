"""The port's GGX shading densities against the JAX package's
(`bsdf/analytic.py`), on the same directions, to 1e-5 relative: the same
float32 arithmetic in other libraries' sin, cos and sqrt."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import jax.numpy as jnp
import numpy as np
import pytest

from bsdf_diffusion_sampling_tpu.bsdf import analytic as ja
from bsdf_diffusion_sampling_tpu_torch.bsdf import analytic as ta

from _torch_port import tt


def _inputs(domain: str, n: int = 1024):
    rng = np.random.default_rng(7)
    if domain == "disk":
        r, p = np.sqrt(rng.uniform(0, 0.9, (2, n))), rng.uniform(-math.pi, math.pi, (2, n))
        pts = np.stack([r * np.cos(p), r * np.sin(p)], -1)  # (2, n, 2)
    else:
        pts = np.stack([rng.uniform(0.05, 1.5, (2, n)), rng.uniform(-math.pi, math.pi, (2, n))], -1)
    return pts[0].astype(np.float32), pts[1].astype(np.float32)


@pytest.mark.parametrize("domain", ["disk", "spherical"])
@pytest.mark.parametrize("diffuse_prob", [0.0, 0.3])
def test_ggx_density_matches_jax(domain, diffuse_prob):
    wi, wo = _inputs(domain)
    t_fn, j_fn = {"disk": (ta.ggx_shading_disk, ja.ggx_shading_disk),
                  "spherical": (ta.ggx_shading_spherical, ja.ggx_shading_spherical)}[domain]
    got = t_fn(tt(wi), tt(wo), roughness=0.5, diffuse_prob=diffuse_prob).numpy()
    want = np.asarray(j_fn(jnp.asarray(wi), jnp.asarray(wo), roughness=0.5, diffuse_prob=diffuse_prob))
    assert np.isfinite(want).all() and (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
