"""The port's anisotropic measured BRDFs against the JAX package's: the 2D
warp conditioned on (phi_i, theta_i) (`bsdf/marginal2d.py`:
`build_warp2d_aniso`, `warp_sample` / `warp_invert` / `warp_eval` with
`phi`) and the measured BRDF on 4 x 8 slices (`bsdf/measured.py`: eval,
pdf, eval_pdf, sample, eval_lum), on the port's synthetic tensors
(`synthetic_measured_tensors(n_phi=4)`) given to both packages'
`measured_from_tensors`. The JAX package's own anisotropic tests read a
reference file this repository does not ship, so the fixture is synthetic.

Tolerances, as tests/test_torch_measured.py holds the isotropic stack: the
tables are built in float64 on both sides and must match bit for bit. The
JAX package blends the 4 slices as an einsum and searches cells by counting
(its TPU row path); the port bisects over gathered scalars. So each query
is held to 1e-4 relative (1e-6 absolute) on at least 99.5% of rows, and
every row to 2e-2 absolute in positions and directions. The JAX package's
own tests/test_measured_aniso.py gates (identical slices reduce to
isotropic at rtol 2e-4, the sampled pdf's p99 relative error under 2e-4 and
its max under 0.05; varying slices self-consistent to a median of 2e-3 and
responding to phi_i) are held by the port here.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.bsdf import marginal2d as jm2
from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu_torch.bsdf import marginal2d as tm2
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.render.procedural import synthetic_measured_tensors

from _torch_port import assert_mostly_close, hemisphere, tt

N = 2048
PP = 4


@pytest.fixture(scope="module")
def tensors():
    return synthetic_measured_tensors(seed=2, vndf_res=(32, 48), lum_res=(16, 24), sigma_w=32, n_phi=PP)


def _aniso_grids(seed, Pp=3, Pt=4, H=17, W=21):
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    return np.stack([[np.exp(-((x - 0.2 - 0.15 * t - 0.1 * p) ** 2 + (y - 0.3 - 0.12 * p) ** 2) / 0.03) + 0.05
                      + 0.02 * rng.random((H, W)) for t in range(Pt)] for p in range(Pp)])


def test_build_warp2d_aniso_tables_match_jax():
    grids = _aniso_grids(0)
    theta, phi = np.linspace(0.0, 1.2, 4), np.linspace(-np.pi, np.pi, 3)
    jw, tw = jm2.build_warp2d_aniso(grids, theta, phi), tm2.build_warp2d_aniso(grids, theta, phi)
    for name in ("density", "cond_cdf", "marg_cdf", "params", "params_phi"):
        np.testing.assert_array_equal(getattr(tw, name).numpy(), np.asarray(getattr(jw, name)))
    assert tw.density.shape == (12, 17, 21)
    iso = tm2.build_warp2d(grids[0], theta)
    assert iso.params_phi is None and iso.to("cpu").params_phi is None


@pytest.mark.parametrize("phi_mode", ["given", "none"])
def test_aniso_warp_matches_jax(phi_mode):
    grids = _aniso_grids(1)
    theta_g, phi_g = np.linspace(0.0, 1.2, 4), np.linspace(-np.pi, np.pi, 3)
    jw, tw = jm2.build_warp2d_aniso(grids, theta_g, phi_g), tm2.build_warp2d_aniso(grids, theta_g, phi_g)
    rng = np.random.default_rng(2)
    u = rng.uniform(1e-4, 1 - 1e-4, (N, 2)).astype(np.float32)
    theta = (rng.random(N) * 1.4 - 0.1).astype(np.float32)
    # past both ends of the phi grid too: the bracket is end-clamped, not periodic
    phi = (rng.random(N) * 7.0 - 3.5).astype(np.float32) if phi_mode == "given" else None
    jphi = None if phi is None else jnp.asarray(phi)
    tphi = None if phi is None else tt(phi)
    jpos, jpdf = jm2.warp_sample(jw, jnp.asarray(u), jnp.asarray(theta), jphi)
    pos, pdf = tm2.warp_sample(tw, tt(u), tt(theta), tphi)
    assert_mostly_close(pos.numpy(), jpos)
    assert_mostly_close(pdf.numpy(), jpdf, all_atol=None)
    ju, jpi = jm2.warp_invert(jw, jpos, jnp.asarray(theta), jphi)
    uu, pi = tm2.warp_invert(tw, tt(jpos), tt(theta), tphi)
    assert_mostly_close(uu.numpy(), ju)
    assert_mostly_close(pi.numpy(), jpi, all_atol=None)
    assert_mostly_close(tm2.warp_eval(tw, tt(jpos), tt(theta), tphi).numpy(),
                        jm2.warp_eval(jw, jpos, jnp.asarray(theta), jphi), all_atol=None)
    # the port's own laws: invert(sample(u)) == u and eval == sample's pdf
    np.testing.assert_allclose(tm2.warp_invert(tw, pos, tt(theta), tphi)[0].numpy(), u, atol=2e-5)
    np.testing.assert_allclose(tm2.warp_eval(tw, pos, tt(theta), tphi).numpy(), pdf.numpy(), rtol=2e-4)
    if phi is None:  # phi None means phi 0
        np.testing.assert_array_equal(tm2.warp_sample(tw, tt(u), tt(theta), torch.zeros(N))[0].numpy(),
                                      pos.numpy())


def test_slice_weights_order_and_clamp():
    """JAX `_slice_weights`' order: for each theta slice, phi low then phi
    high; the phi bracket clamps at both ends of its grid."""
    theta_g, phi_g = torch.tensor([0.0, 1.0]), torch.tensor([-1.0, 0.0, 1.0])
    sl = tm2.slice_weights(theta_g, phi_g, torch.tensor([0.25, 0.5]), torch.tensor([-0.5, 5.0]))
    assert [i.tolist() for i, _ in sl] == [[0, 2], [2, 4], [1, 3], [3, 5]]  # pf * Pt + tf
    w = torch.stack([w for _, w in sl])
    torch.testing.assert_close(w[:, 0], torch.tensor([0.375, 0.375, 0.125, 0.125]))
    torch.testing.assert_close(w[:, 1], torch.tensor([0.0, 0.5, 0.0, 0.5]))
    assert len(tm2.slice_weights(theta_g, None, torch.tensor([0.25]))) == 2


@pytest.fixture(scope="module")
def brdfs(tensors):
    return jme.measured_from_tensors(tensors, name="aniso"), tme.measured_from_tensors(tensors, "aniso", device="cpu")


def _dirs(seed):
    rng = np.random.default_rng(seed)
    wi, wo = hemisphere(rng, N), hemisphere(rng, N)
    wo[:16, 2] *= -1.0  # downward wo: zero on both sides
    return wi, wo


def test_aniso_tables_and_grid(brdfs, tensors):
    jb, tb = brdfs
    np.testing.assert_array_equal(tb.phi_i_grid.numpy(), tensors["phi_i"])
    np.testing.assert_array_equal(tb.rgb.numpy(), np.asarray(jb.rgb))
    assert tb.rgb.shape == (PP * 8, 3, 16, 24)
    for w in ("vndf", "luminance"):
        for name in ("density", "cond_cdf", "marg_cdf", "params_phi"):
            np.testing.assert_array_equal(getattr(getattr(tb, w), name).numpy(),
                                          np.asarray(getattr(getattr(jb, w), name)))


def test_aniso_eval_pdf_match_jax(brdfs):
    jb, tb = brdfs
    wi, wo = _dirs(3)
    jf, jp = jme.eval_pdf_brdf(jb, jnp.asarray(wi), jnp.asarray(wo))
    f, p = tme.eval_pdf_brdf(tb, tt(wi), tt(wo))
    assert_mostly_close(f.numpy(), jf, all_atol=None)
    assert_mostly_close(p.numpy(), jp, all_atol=None)
    assert not f[:16].any() and not p[:16].any() and (p[16:] > 0).all()
    np.testing.assert_array_equal(tme.eval_brdf(tb, tt(wi), tt(wo)).numpy(), f.numpy())
    np.testing.assert_array_equal(tme.pdf_brdf(tb, tt(wi), tt(wo)).numpy(), p.numpy())
    assert_mostly_close(tme.eval_lum(tb, tt(wi), tt(wo)).numpy(),
                        jme.eval_lum(jb, jnp.asarray(wi), jnp.asarray(wo)), all_atol=None)


def test_aniso_sample_matches_jax_and_its_own_pdf(brdfs):
    jb, tb = brdfs
    wi, _ = _dirs(4)
    u = np.random.default_rng(5).uniform(1e-6, 1 - 1e-6, (N, 2)).astype(np.float32)
    jwo, jpdf = jme.sample_brdf(jb, jnp.asarray(u), jnp.asarray(wi))
    wo, pdf = tme.sample_brdf(tb, tt(u), tt(wi))
    assert_mostly_close(wo.numpy(), jwo)
    assert_mostly_close(pdf.numpy(), jpdf, all_atol=None)
    ok = pdf > 1e-5
    assert ok.float().mean() > 0.5
    q = tme.pdf_brdf(tb, tt(wi), wo)
    assert float((q[ok] / pdf[ok] - 1).abs().median()) < 2e-3
    f = tme.eval_brdf(tb, tt(wi), wo)
    assert bool(torch.isfinite(f).all()) and bool((f >= 0).all())


def _repeat_phi(tf, pp):
    """An anisotropic dict whose pp phi_i slices are copies of the isotropic one."""
    out = dict(tf, phi_i=np.linspace(-np.pi, np.pi, pp).astype(np.float32))
    for k in ("vndf", "luminance", "rgb"):
        out[k] = np.repeat(tf[k], pp, axis=0)
    return out


def test_identical_slices_reduce_to_isotropic():
    """JAX tests/test_measured_aniso.py::test_identical_slices_reduce_to_isotropic,
    on the port."""
    iso_tf = synthetic_measured_tensors(seed=3, vndf_res=(32, 48), lum_res=(16, 24), sigma_w=32)
    iso = tme.measured_from_tensors(iso_tf, device="cpu")
    ani = tme.measured_from_tensors(_repeat_phi(iso_tf, 3), device="cpu")
    assert iso.phi_i_grid is None and ani.phi_i_grid.shape == (3,)
    wi, wo = _dirs(6)
    wi, wo = tt(wi), tt(wo)
    np.testing.assert_allclose(tme.eval_brdf(ani, wi, wo).numpy(), tme.eval_brdf(iso, wi, wo).numpy(),
                               rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(tme.pdf_brdf(ani, wi, wo).numpy(), tme.pdf_brdf(iso, wi, wo).numpy(),
                               rtol=2e-4, atol=1e-8)
    u = tt(np.random.default_rng(7).uniform(1e-4, 1 - 1e-4, (N, 2)))
    wo_a, pdf_a = tme.sample_brdf(ani, u, wi)
    wo_i, pdf_i = tme.sample_brdf(iso, u, wi)
    # the 4-slice blend reassociates the float sums of the 2-slice one, which
    # can move a boundary draw to the next cell: directions in shares too
    assert_mostly_close(wo_a.numpy(), wo_i.numpy())
    valid = pdf_i > 0
    assert torch.equal(pdf_a > 0, valid)
    rel = (pdf_a[valid] / pdf_i[valid] - 1).abs()
    assert float(rel.quantile(0.99)) < 2e-4 and float(rel.max()) < 0.05


def test_varying_slices_respond_to_phi(brdfs, tensors):
    """Rotating wi and wo together in azimuth changes eval when the slices
    differ, and not when they are identical (JAX
    tests/test_measured_aniso.py::test_varying_slices_respond_to_phi). wo
    sits 2.8 rad from wi in azimuth, near the mirror direction, where this
    glossy fixture's eval is large."""
    _, tb = brdfs
    iso_like = tme.measured_from_tensors(_repeat_phi({k: v[:1] if k in ("vndf", "luminance", "rgb") else v
                                                      for k, v in tensors.items()}, PP), device="cpu")
    n = 512
    ct = torch.full((n,), 0.7)
    st = torch.sqrt(1 - ct ** 2)

    def at(phi):
        return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)

    phi1, phi2 = torch.zeros(n), torch.full((n,), 2.0)
    e1 = tme.eval_brdf(tb, at(phi1), at(phi1 + 2.8))
    e2 = tme.eval_brdf(tb, at(phi2), at(phi2 + 2.8))
    assert float((e1 - e2).abs().max()) > 1e-4 and float(((e1 - e2).abs() / e1).max()) > 1e-2
    i1 = tme.eval_brdf(iso_like, at(phi1), at(phi1 + 2.8))
    i2 = tme.eval_brdf(iso_like, at(phi2), at(phi2 + 2.8))
    np.testing.assert_allclose(i1.numpy(), i2.numpy(), rtol=2e-4, atol=1e-8)


def test_isotropic_fixture_is_unchanged():
    """`synthetic_measured_tensors()` at its defaults, the measured scene's
    `.bsdf`, returns the arrays it returned before it learned n_phi (sha256
    over the sorted keys and their bytes)."""
    tf = synthetic_measured_tensors()
    h = hashlib.sha256()
    for k in sorted(tf):
        h.update(k.encode())
        h.update(np.ascontiguousarray(tf[k]).tobytes())
    assert h.hexdigest() == "91a9248b8924136ca3f1719edcfdfc09bc64716e0e088d588836aba832fae69c"
    assert tf["phi_i"].tolist() == [0.0] and tf["vndf"].shape == (1, 8, 64, 64)
    aniso = synthetic_measured_tensors(n_phi=4)
    assert aniso["vndf"].shape == (4, 8, 64, 64) and aniso["rgb"].shape == (4, 8, 3, 32, 32)
    np.testing.assert_allclose(aniso["phi_i"], np.linspace(-np.pi, np.pi, 4), rtol=1e-6)
