"""The port's measured-BSDF stack against the JAX package: the RGL tensor
file (a round trip through the port's writer), the 2D warp
(`bsdf/marginal2d.py`: build, sample, invert, eval) and the isotropic
measured BRDF (`bsdf/measured.py`: eval, pdf, eval_pdf, sample), on
synthesized tensors with the same numpy inputs on both sides.

Tolerances: the warp tables are built in float64 on both sides and must
match bit for bit. Queries run in float32 in other orders (the JAX package
takes its TPU row-gather path), and a bisection or inverse-CDF step can
move a sample across a cell boundary on a 1-ulp difference. So each query
is held to 1e-4 relative (1e-6 absolute) on at least 99.5% of rows, and
every row to 2e-2 absolute in positions and directions.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax.numpy as jnp
import numpy as np
import pytest

from bsdf_diffusion_sampling_tpu.bsdf import marginal2d as jm2
from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu.bsdf.tensorfile import read_tensor_file as jread
from bsdf_diffusion_sampling_tpu_torch.bsdf import marginal2d as tm2
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.bsdf.tensorfile import read_tensor_file, write_tensor_file

from _torch_port import assert_mostly_close, hemisphere, tt, write_synthetic_bsdf

N = 4096


@pytest.fixture(scope="module")
def tensors(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bsdf") / "synth_rgb.bsdf")
    tf = write_synthetic_bsdf(path, seed=1, vndf_res=(32, 48), lum_res=(16, 24), sigma_w=32)
    return path, tf


def test_tensor_file_round_trip(tensors, tmp_path):
    path, tf = tensors
    mine, theirs = read_tensor_file(path), jread(path)
    assert sorted(mine.fields) == sorted(theirs.fields) == sorted(tf)
    for k, v in tf.items():
        np.testing.assert_array_equal(mine[k], v)
        np.testing.assert_array_equal(theirs[k], v)
        assert mine[k].dtype == theirs[k].dtype == v.dtype
    odd = {"a": np.arange(7, dtype=np.int16), "b": np.ones((2, 3), np.float64), "c": np.array(5, np.uint8)}
    write_tensor_file(str(tmp_path / "odd.bsdf"), odd)
    back = jread(str(tmp_path / "odd.bsdf"))
    for k, v in odd.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    (tmp_path / "bad.bsdf").write_bytes(b"not_a_tensor")
    with pytest.raises(ValueError, match="bad magic"):
        read_tensor_file(str(tmp_path / "bad.bsdf"))


def _grids(shape, seed):
    rng = np.random.default_rng(seed)
    P, H, W = shape
    y, x = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    return np.stack([np.exp(-((x - 0.2 - 0.6 * p / max(P - 1, 1)) ** 2 + (y - 0.5) ** 2) / 0.03) + 0.05
                     + 0.02 * rng.random((H, W)) for p in range(P)])


@pytest.mark.parametrize("shape", [(3, 33, 33), (1, 16, 200)], ids=["sliced", "wide_one_slice"])
def test_warp2d_matches_jax(shape):
    grids = _grids(shape, 0)
    params = np.linspace(0.0, 1.0, shape[0]) if shape[0] > 1 else np.array([0.0])
    jw, tw = jm2.build_warp2d(grids, params), tm2.build_warp2d(grids, params)
    for name in ("density", "cond_cdf", "marg_cdf", "params"):
        np.testing.assert_array_equal(getattr(tw, name).numpy(), np.asarray(getattr(jw, name)))
    rng = np.random.default_rng(1)
    u = rng.uniform(1e-4, 1 - 1e-4, (N, 2)).astype(np.float32)
    theta = (rng.random(N) * 1.2 - 0.1).astype(np.float32) if shape[0] > 1 else np.zeros(N, np.float32)
    jpos, jpdf = jm2.warp_sample(jw, jnp.asarray(u), jnp.asarray(theta))
    pos, pdf = tm2.warp_sample(tw, tt(u), tt(theta))
    assert_mostly_close(pos.numpy(), jpos)
    assert_mostly_close(pdf.numpy(), jpdf, all_atol=None)
    ju, jpi = jm2.warp_invert(jw, jpos, jnp.asarray(theta))
    uu, pi = tm2.warp_invert(tw, tt(jpos), tt(theta))
    assert_mostly_close(uu.numpy(), ju)
    assert_mostly_close(pi.numpy(), jpi, all_atol=None)
    assert_mostly_close(tm2.warp_eval(tw, tt(jpos), tt(theta)).numpy(),
                        jm2.warp_eval(jw, jpos, jnp.asarray(theta)), all_atol=None)
    # the port's own laws: invert(sample(u)) == u and eval == sample's pdf
    np.testing.assert_allclose(tm2.warp_invert(tw, pos, tt(theta))[0].numpy(), u, atol=2e-5)
    np.testing.assert_allclose(tm2.warp_eval(tw, pos, tt(theta)).numpy(), pdf.numpy(), rtol=2e-4)


@pytest.fixture(scope="module")
def brdfs(tensors):
    path, tf = tensors
    return jme.measured_from_tensors(tf, name="synth"), tme.load_measured(path, device="cpu")


def _dirs(seed):
    rng = np.random.default_rng(seed)
    wi, wo = hemisphere(rng, N), hemisphere(rng, N)
    wo[:16, 2] *= -1.0  # downward wo: zero on both sides
    return wi, wo


def test_load_measured(brdfs, tmp_path):
    jb, tb = brdfs
    assert tb.name == "synth_rgb"
    assert tb.phi_i_grid is None and tb.vndf.params_phi is None
    np.testing.assert_array_equal(tb.rgb.numpy(), np.asarray(jb.rgb))
    np.testing.assert_array_equal(tb.vndf.cond_cdf.numpy(), np.asarray(jb.vndf.cond_cdf))
    # an anisotropic file loads, with the file's phi_i grid
    path = str(tmp_path / "aniso.bsdf")
    tf = write_synthetic_bsdf(path, seed=1, vndf_res=(16, 16), lum_res=(8, 8), sigma_w=16, n_phi=3)
    ab = tme.load_measured(path, device="cpu")
    assert isinstance(ab, tme.MeasuredBRDF) and ab.name == "aniso"
    np.testing.assert_array_equal(ab.phi_i_grid.numpy(), tf["phi_i"])
    np.testing.assert_array_equal(ab.vndf.params_phi.numpy(), tf["phi_i"])
    assert ab.rgb.shape == (3 * 8, 3, 8, 8)


def test_eval_pdf_match_jax(brdfs):
    jb, tb = brdfs
    wi, wo = _dirs(2)
    jf, jp = jme.eval_pdf_brdf(jb, jnp.asarray(wi), jnp.asarray(wo))
    f, p = tme.eval_pdf_brdf(tb, tt(wi), tt(wo))
    assert_mostly_close(f.numpy(), jf, all_atol=None)
    assert_mostly_close(p.numpy(), jp, all_atol=None)
    assert not f[:16].any() and not p[:16].any() and (p[16:] > 0).all()
    np.testing.assert_array_equal(tme.eval_brdf(tb, tt(wi), tt(wo)).numpy(), f.numpy())
    np.testing.assert_array_equal(tme.pdf_brdf(tb, tt(wi), tt(wo)).numpy(), p.numpy())
    assert_mostly_close(tme.eval_lum(tb, tt(wi), tt(wo)).numpy(),
                        jme.eval_lum(jb, jnp.asarray(wi), jnp.asarray(wo)), all_atol=None)


def test_sample_matches_jax_and_its_own_pdf(brdfs):
    jb, tb = brdfs
    wi, _ = _dirs(3)
    u = np.random.default_rng(4).uniform(1e-6, 1 - 1e-6, (N, 2)).astype(np.float32)
    jwo, jpdf = jme.sample_brdf(jb, jnp.asarray(u), jnp.asarray(wi))
    wo, pdf = tme.sample_brdf(tb, tt(u), tt(wi))
    assert_mostly_close(wo.numpy(), jwo)
    assert_mostly_close(pdf.numpy(), jpdf, all_atol=None)
    ok = pdf > 0
    assert ok.float().mean() > 0.5
    q = tme.pdf_brdf(tb, tt(wi), wo)
    assert float((q[ok] / pdf[ok] - 1).abs().median()) < 1e-3
