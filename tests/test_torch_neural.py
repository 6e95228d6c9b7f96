"""The slice as a whole: the port's disk `neural_sample` / `neural_pdf`
against the JAX package's, through its Pallas kernels in interpret mode
(fused=True, tile=8) and through its XLA path (fused=False), from the same
eps. Also checkpoints in both directions between the two packages.

Tolerances: float32 on both sides in other orders; directions to 1e-5
absolute, solid-angle pdfs to 1e-4 relative.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.ops.fused_ode as jfused
from bsdf_diffusion_sampling_tpu.core.config import SamplerConfig as JSamplerConfig
from bsdf_diffusion_sampling_tpu.models import get_base, velocity_init
from bsdf_diffusion_sampling_tpu.render import neural as jneural
from bsdf_diffusion_sampling_tpu.train import checkpoint as jckpt
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.render import neural as tneural
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint as tckpt

from _torch_port import disk_setup, hemisphere, tt

jfused._INTERPRET = jax.default_backend() == "cpu"

X_ATOL = 1e-5
PDF_RTOL = 1e-4
N = 256


@pytest.fixture(scope="module")
def setup():
    s = disk_setup(n=N, seed=4)
    s.wi = hemisphere(s.rng, N)
    s.wi[:8, 2] *= -1.0  # a few downward wi: pdf 0 on both sides
    s.key = jax.random.key(21)
    s.eps = tt(jax.random.normal(s.key, (N, 2)))  # what both JAX paths draw from the key
    s.nb = tneural.make_neural_bsdf("disk", ModelConfig(), s.tv, s.tb, device="cpu")
    return s


def _jax_nb(s, fused, exact=True):
    return jneural.make_neural_bsdf("disk", s.cfg, s.v, s.b, None,
                                    sampler_cfg=JSamplerConfig(pdf_exact=exact), fused=fused, tile=8)


@pytest.mark.parametrize("fused", [True, False], ids=["pallas_interpret", "xla"])
def test_neural_sample_and_pdf_match_jax(setup, fused):
    s = setup
    jnb = _jax_nb(s, fused)
    wi = jnp.asarray(s.wi)
    jwo, jpdf = jneural.neural_sample(jnb, s.key, wi)
    jpdf_q = jneural.neural_pdf(jnb, wi, jwo)
    wo, pdf = tneural.neural_sample(s.nb, s.eps, tt(s.wi))
    np.testing.assert_allclose(wo.numpy(), np.asarray(jwo), atol=X_ATOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=PDF_RTOL)
    pdf_q = tneural.neural_pdf(s.nb, tt(s.wi), tt(jwo))
    np.testing.assert_allclose(pdf_q.numpy(), np.asarray(jpdf_q), rtol=PDF_RTOL, atol=1e-7)
    assert torch.all(pdf[:8] == 0) and torch.all(pdf_q[:8] == 0)
    assert 0 < int((pdf > 0).sum()) < N  # some draws leave the valid disk


def test_neural_pdf_reverse_euler_matches_jax(setup):
    s = setup
    jnb = _jax_nb(s, fused=False, exact=False)
    nb = tneural.make_neural_bsdf("disk", ModelConfig(), s.tv, s.tb,
                                  sampler_cfg=SamplerConfig(pdf_exact=False), device="cpu")
    wo, _ = tneural.neural_sample(nb, s.eps, tt(s.wi))
    want = jneural.neural_pdf(jnb, jnp.asarray(s.wi), jnp.asarray(wo.numpy()))
    np.testing.assert_allclose(tneural.neural_pdf(nb, tt(s.wi), wo).numpy(), np.asarray(want),
                               rtol=PDF_RTOL, atol=1e-7)


def test_sample_pdf_contract_through_neural_path(setup):
    """pdf(sample()) gives back the draw's own pdf, median rel < 1e-3, with
    draws from a torch.Generator (the production seed path)."""
    s = setup
    wi = tt(hemisphere(np.random.default_rng(5), 1024))
    wo, pdf = tneural.neural_sample(s.nb, torch.Generator().manual_seed(3), wi)
    pdf_q = tneural.neural_pdf(s.nb, wi, wo)
    ok = pdf > 1e-6
    assert int(ok.sum()) > 100
    assert float((pdf_q[ok] / pdf[ok] - 1).abs().median()) < 1e-3


def test_firefly_filter_matches_jax(setup):
    s = setup
    rgb = s.rng.uniform(0, 60, (N, 3)).astype(np.float32)
    want = jneural.firefly_filter(_jax_nb(s, fused=False), jnp.asarray(rgb))
    np.testing.assert_array_equal(tneural.firefly_filter(s.nb, tt(rgb)).numpy(), np.asarray(want))


def test_make_neural_bsdf_rejects_other_domains(setup):
    with pytest.raises(ValueError, match="unknown domain"):
        tneural.make_neural_bsdf("cube", ModelConfig(domain="cube"), setup.tv, setup.tb, device="cpu")
    with pytest.raises(ValueError, match="spherical velocity net"):  # disk weights for a spherical sampler
        tneural.make_neural_bsdf("spherical", ModelConfig(domain="spherical"), setup.tv, setup.tb, device="cpu")


def _template():
    cfg = ModelConfig()
    return {"base": get_base("disk").init(jax.random.key(1)),
            "rectified": velocity_init(jax.random.key(2), cfg)}


def test_jax_checkpoint_reads_into_port(tmp_path, setup):
    s = setup
    tree = {"base": s.b, "rectified": s.v}
    path = str(tmp_path / "jax.npz")
    jckpt.save_pytree(path, tree, step=7)
    back, step = tckpt.load_pytree(path)
    assert step == 7
    assert sorted(back) == ["base", "rectified"]
    nb = tneural.make_neural_bsdf("disk", ModelConfig(), back["rectified"], back["base"], device="cpu")
    v, b = nb.v_params, nb.base_params
    assert b["pe_bands"] == 3
    for lt, lj in zip(v, s.v):
        np.testing.assert_array_equal(lt["w"].numpy(), np.asarray(lj["w"]))
    for lt, lj in zip(b["net"], s.b["net"]):
        np.testing.assert_array_equal(lt["w"].numpy(), np.asarray(lj["w"]))
        np.testing.assert_array_equal(lt["b"].numpy(), np.asarray(lj["b"]))


def test_port_checkpoint_reads_into_jax(tmp_path, setup):
    s = setup
    path = str(tmp_path / "port.npz")
    tckpt.save_pytree(path, {"base": s.tb, "rectified": s.tv}, step=3)
    tree, step = jckpt.load_pytree(path, _template())
    assert step == 3
    for lj, lt in zip(tree["rectified"], s.tv):
        np.testing.assert_array_equal(np.asarray(lj["w"]), lt["w"].numpy())
    np.testing.assert_array_equal(np.asarray(tree["base"]["net"][1]["b"]), s.tb["net"][1]["b"].numpy())
    assert tree["base"]["pe_bands"].value == 3  # structure from the template


def test_checkpoint_reader_rejects_unknown_keys(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, __step__=np.asarray(0), **{"base.net.0.w": np.zeros(2)})
    with pytest.raises(ValueError):
        tckpt.load_pytree(path)
