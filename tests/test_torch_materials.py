"""The port's analytic BSDFs against the JAX package: every entry of the
26-entry material table (`eval_material`: 23 principled, 3 Beckmann bk7
rough dielectrics) on both hemispheres, the rough conductors, and the
microfacet building blocks, on the same directions.

Tolerances: float32 on both sides in other orders; f * cos to 1e-5
relative with 1e-6 absolute (values range over ~1e-4..1e2 near specular
peaks).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax.numpy as jnp
import numpy as np
import pytest

from bsdf_diffusion_sampling_tpu.bsdf import materials as jmat
from bsdf_diffusion_sampling_tpu.bsdf import microfacet as jmf
from bsdf_diffusion_sampling_tpu.bsdf import rough as jrough
from bsdf_diffusion_sampling_tpu_torch.bsdf import materials as tmat
from bsdf_diffusion_sampling_tpu_torch.bsdf import microfacet as tmf
from bsdf_diffusion_sampling_tpu_torch.bsdf import rough as trough

from _torch_port import hemisphere, tt

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _pairs(seed: int):
    """wi and wo on both hemispheres: upper/upper, upper/lower,
    lower/upper, lower/lower, N/4 of each."""
    rng = np.random.default_rng(seed)
    wi, wo = hemisphere(rng, N), hemisphere(rng, N)
    q = N // 4
    wo[q:2 * q, 2] *= -1.0
    wi[2 * q:3 * q, 2] *= -1.0
    wi[3 * q:, 2] *= -1.0
    wo[3 * q:, 2] *= -1.0
    return wi, wo


def test_table_matches_jax():
    assert len(tmat.BSDF_MATERIALS) == len(jmat.BSDF_MATERIALS) == 26
    for t, j in zip(tmat.BSDF_MATERIALS, jmat.BSDF_MATERIALS):
        assert type(t).__name__ == type(j).__name__ and vars(t) == vars(j)
        assert t.eta == j.eta
    assert tmat.BSDF_MATERIALS[3].metallic == 0.2  # the dict4 quirk: the second definition wins


@pytest.mark.parametrize("idx", range(26))
def test_eval_material_matches_jax(idx):
    wi, wo = _pairs(idx)
    want = np.asarray(jmat.eval_material(jmat.BSDF_MATERIALS[idx], jnp.asarray(wi), jnp.asarray(wo)))
    got = tmat.eval_material(tmat.BSDF_MATERIALS[idx], tt(wi), tt(wo)).numpy()
    assert got.shape == want.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (want[: N // 4] > 0).any()  # reflection is never all zero


@pytest.mark.parametrize("metal", ["Cu", "Au", "Al", "Ag"])
@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
def test_roughconductor_matches_jax(metal, dist):
    wi, wo = _pairs(40)
    jp = jrough.RoughConductorParams(material=metal, alpha_u=0.2, alpha_v=0.35, distribution=dist)
    tp = trough.RoughConductorParams(material=metal, alpha_u=0.2, alpha_v=0.35, distribution=dist)
    want = np.asarray(jrough.eval_roughconductor(jp, jnp.asarray(wi), jnp.asarray(wo)))
    got = trough.eval_roughconductor(tp, tt(wi), tt(wo)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ggx_d", "beckmann_d", "ggx_smith_g1", "beckmann_smith_g1", "gtr1_d",
                                  "fresnel_dielectric", "fresnel_conductor", "schlick_weight"])
def test_microfacet_matches_jax(name):
    wi, wo = _pairs(41)
    wh = wi + wo
    wh = (wh / np.linalg.norm(wh, axis=-1, keepdims=True) * np.sign(wh[:, 2:3])).astype(np.float32)
    cos = wi[:, 2]
    args = {"ggx_d": (wh, 0.3, 0.15), "beckmann_d": (wh, 0.3, 0.15), "ggx_smith_g1": (wi, wh, 0.3, 0.15),
            "beckmann_smith_g1": (wi, wh, 0.3, 0.15), "gtr1_d": (wh, 0.05), "fresnel_dielectric": (cos, 1.5046),
            "schlick_weight": (np.abs(cos),)}.get(name)
    if name == "fresnel_conductor":
        eta, k = jmf.CONDUCTOR_IOR["Au"]
        want = jmf.fresnel_conductor(jnp.asarray(cos), eta, k)
        got = tmf.fresnel_conductor(tt(cos), *(tt(np.asarray(v)) for v in tmf.CONDUCTOR_IOR["Au"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        return
    wrap = [tt(a) if isinstance(a, np.ndarray) else a for a in args]
    want = getattr(jmf, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = getattr(tmf, name)(*wrap)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
