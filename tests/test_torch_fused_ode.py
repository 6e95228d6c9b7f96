"""The plain versions of the port's fused kernels, K1 (disk sample+pdf) and
K2 (disk pdf query), against the JAX package's Pallas kernels run in
interpret mode as tests/test_fused_sample_pdf.py runs them (tile=8, eps=).
Also: on CPU tensors the wrappers take the plain versions and launch
nothing, and on any other non-CUDA device they raise.

Tolerances: the interpret-mode kernels and the plain versions both run
float32 on the CPU, in other orders and with the TPU kernel's carried
tangents against per-step dets; x is held to 1e-5 absolute, pdfs to 1e-4
relative (the JAX tests hold kernel against XLA to 3e-5..5e-4).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.ops.fused_ode as jfused
import bsdf_diffusion_sampling_tpu_torch.ops.fused_ode as tfused

from _torch_port import T, disk_setup, tt

jfused._INTERPRET = jax.default_backend() == "cpu"

X_ATOL = 1e-5
PDF_RTOL = 1e-4
N = 256


@pytest.fixture(scope="module")
def setup():
    s = disk_setup(n=N, seed=3)
    s.w = tfused.prepack_disk(s.tv, s.tb)
    s.eps = s.rng.standard_normal((N, 2)).astype(np.float32)
    s.jx, s.jpdf, s.jx0 = jfused.fused_sample_pdf_disk(s.v, s.b, s.cond, 0, T, tile=8,
                                                       eps=jnp.asarray(s.eps))
    return s


def test_plain_k1_matches_jax_kernel(setup):
    s = setup
    x, pdf, x0 = tfused.sample_pdf_disk_plain(s.w, s.t_cond, T, eps=tt(s.eps))
    np.testing.assert_allclose(x0.numpy(), np.asarray(s.jx0), atol=X_ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(s.jx), atol=X_ATOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(s.jpdf), rtol=PDF_RTOL)
    # from the kernel's own x0 the plain version gives the same draw
    x2, pdf2, _ = tfused.sample_pdf_disk_plain(s.w, s.t_cond, T, x0=tt(s.jx0))
    np.testing.assert_allclose(x2.numpy(), np.asarray(s.jx), atol=X_ATOL)
    np.testing.assert_allclose(pdf2.numpy(), np.asarray(s.jpdf), rtol=PDF_RTOL)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "reverse"])
def test_plain_k2_matches_jax_kernel(setup, exact):
    s = setup
    jpdf, jx0 = jfused.fused_pdf_disk(s.v, s.b, s.jx, s.cond, T, tile=8, exact=exact, newton_iters=2)
    pdf, x0 = tfused.pdf_disk_plain(s.w, tt(s.jx), s.t_cond, T, exact=exact, newton_iters=2)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=X_ATOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=PDF_RTOL)


def test_plain_k2_gives_back_the_draw_bit_for_bit(setup):
    """The exact query's Newton solve lands on each forward step's float
    preimage, where the step's residual is exactly 0, so at most valid
    draws it gives back the sampler's x0 and pdf to the bit. That is why the
    median sample<->pdf gap reads exactly 0."""
    s = setup
    x, pdf, x0 = tfused.sample_pdf_disk_plain(s.w, s.t_cond, T, eps=tt(s.eps))
    pdf_q, x0_q = tfused.pdf_disk_plain(s.w, x, s.t_cond, T, exact=True, newton_iters=2)
    valid = (x * x).sum(-1) <= 0.995
    assert int(valid.sum()) >= 20
    assert float((x0_q[valid] == x0[valid]).all(-1).float().mean()) >= 0.9
    assert float((pdf_q[valid] == pdf[valid]).float().mean()) >= 0.9


def test_cpu_wrappers_take_the_plain_versions(setup):
    s = setup
    tfused.reset_launches()
    eps = tt(s.eps)
    got = tfused.fused_sample_pdf_disk(s.w, s.t_cond, T, eps=eps)
    want = tfused.sample_pdf_disk_plain(s.w, s.t_cond, T, eps=eps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for exact in (True, False):
        got2 = tfused.fused_pdf_disk(s.w, want[0], s.t_cond, T, exact=exact)
        want2 = tfused.pdf_disk_plain(s.w, want[0], s.t_cond, T, exact=exact)
        for g, w in zip(got2, want2):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # a seed draws the kernel's own Philox normals
    x, pdf, x0 = tfused.fused_sample_pdf_disk(s.w, s.t_cond, T, seed=99)
    want = tfused.sample_pdf_disk_plain(s.w, s.t_cond, T, eps=tfused.philox_normals(99, N))
    torch.testing.assert_close(x0, want[2], rtol=0, atol=0)
    assert not any(tfused.launches.values())
    with pytest.raises(ValueError):
        tfused.fused_sample_pdf_disk(s.w, s.t_cond, T)


def test_non_cuda_device_raises_instead_of_falling_back(setup):
    s = setup
    meta = s.t_cond.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_sample_pdf_disk(s.w, meta, T, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_pdf_disk(s.w, torch.empty((N, 2), device="meta"), meta, T)
    assert not any(tfused.launches.values())


def test_prepack_layout(setup):
    """The flat kernel weights: velocity (in, out) matrices, then the base
    heads' W0, b0, W1, b1 — 2,912 + 308 floats at full width."""
    s = setup
    assert (s.w.hidden, s.w.layers) == (32, 3)
    assert s.w.flat.numel() == 25 * 32 + 2 * 32 * 32 + 32 * 2 + 14 * 16 + 16 + 16 * 4 + 4
    assert torch.equal(s.w.flat[:25 * 32].reshape(25, 32), s.tv[0]["w"])
    assert torch.equal(s.w.flat[-4:], s.tb["net"][1]["b"])


def test_philox_known_answer():
    """Philox4x32-10 with key 0 on counter 0 gives the published first block
    (Salmon et al., SC'11; the Random123 known-answer vectors)."""
    words = tfused._philox4x32_10(np.zeros(1, np.uint64), np.zeros(1, np.uint64), 0, 0)
    assert [int(w[0]) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_normals_are_standard_normal():
    e = tfused.philox_normals(12345, 1 << 16).numpy()
    assert e.shape == (1 << 16, 2) and e.dtype == np.float32
    tol = 5.0 / np.sqrt(e.shape[0])  # 5 standard errors
    assert np.all(np.abs(e.mean(0)) < tol) and np.all(np.abs(e.std(0) - 1.0) < tol)
    assert abs(np.corrcoef(e[:, 0], e[:, 1])[0, 1]) < tol
    assert np.array_equal(e[:100], tfused.philox_normals(12345, 100).numpy())
    assert not np.array_equal(e[:100], tfused.philox_normals(12346, 100).numpy())
