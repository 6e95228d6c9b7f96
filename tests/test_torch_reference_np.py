"""The port's numpy oracles (`utils/reference_np.py`), its own copy of the
JAX package's: the same statements (docstrings aside) and the same outputs
to the bit on the same inputs, the Metropolis chain included; then the
port's PyTorch densities held against them at the JAX package's own
tolerances (tests/test_reference_np.py: rtol 1e-4 / atol 1e-6 for GGX
shading and Fresnel, 2e-4 for the anisotropic GGX pieces).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import ast
import inspect

import jax
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.utils import reference_np as jref
from bsdf_diffusion_sampling_tpu_torch.bsdf.analytic import ggx_shading_disk, ggx_shading_spherical
from bsdf_diffusion_sampling_tpu_torch.bsdf.microfacet import fresnel_conductor, ggx_d, ggx_smith_g1
from bsdf_diffusion_sampling_tpu_torch.geometry.coords import disk_to_cart, spher_to_cart
from bsdf_diffusion_sampling_tpu_torch.utils import reference_np as ref


def _code(module):
    """The module's AST with every docstring taken out."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_copy_is_the_jax_package_code():
    assert _code(ref) == _code(jref)
    imports = {a.name for n in ast.walk(ast.parse(inspect.getsource(ref))) if isinstance(n, ast.Import)
               for a in n.names}
    assert imports == {"numpy"}  # pure numpy


def _disk_dirs(rng, n):
    u = rng.uniform(-0.75, 0.75, (n, 2))
    return u[(u ** 2).sum(-1) < 0.95]


def test_outputs_equal_the_jax_package_copy():
    rng = np.random.default_rng(0)
    wi, wo = _disk_dirs(rng, 300), _disk_dirs(rng, 300)
    m = min(len(wi), len(wo))
    li, lo = ref.disk_to_cart_np(wi[:m]), ref.disk_to_cart_np(wo[:m])
    np.testing.assert_array_equal(ref.ggx_shading_np(li, lo, 0.4, diffuse_prob=0.3),
                                  jref.ggx_shading_np(li, lo, 0.4, diffuse_prob=0.3))
    np.testing.assert_array_equal(ref.ggx_pdf_grid_np(np.array([0.3, 0.1]), 0.4, res=32),
                                  jref.ggx_pdf_grid_np(np.array([0.3, 0.1]), 0.4, res=32))
    np.testing.assert_array_equal(ref.eval_roughconductor_np(li, lo, 0.2, 0.5, 0.2, 3.9),
                                  jref.eval_roughconductor_np(li, lo, 0.2, 0.5, 0.2, 3.9))
    a, acc_a = ref.metropolis_ggx_disk_np(np.random.default_rng(1), np.array([0.35, 0.0]), 0.4, 300, 16, 100)
    b, acc_b = jref.metropolis_ggx_disk_np(np.random.default_rng(1), np.array([0.35, 0.0]), 0.4, 300, 16, 100)
    np.testing.assert_array_equal(a, b)
    assert acc_a == acc_b and a.shape == (16 * 200, 2)


def _jax_disk_dirs(key, n):
    """tests/test_reference_np.py's inputs, drawn from the same keys."""
    u = np.asarray(jax.random.uniform(key, (n, 2), minval=-0.75, maxval=0.75))
    return u[(u ** 2).sum(-1) < 0.95]


def test_port_densities_cross_check():
    """On the very inputs of the JAX package's own cross-checks, at their
    tolerances: near-specular float32 GGX loses ~1e-4 to cancellation, so
    other inputs can sit at the tolerance's edge in either package."""
    k1, k2 = jax.random.split(jax.random.key(0))
    wi, wo = _jax_disk_dirs(k1, 600), _jax_disk_dirs(k2, 600)
    m = min(len(wi), len(wo))
    wi, wo = wi[:m], wo[:m]
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    np.testing.assert_allclose(disk_to_cart(twi).numpy(), ref.disk_to_cart_np(wi), rtol=1e-6, atol=1e-6)
    for rough in (0.1, 0.4, 0.8):
        ours = ggx_shading_disk(twi, two, rough, f0=0.04, diffuse_prob=0.3)
        theirs = ref.ggx_shading_np(ref.disk_to_cart_np(wi), ref.disk_to_cart_np(wo), rough, f0=0.04,
                                    diffuse_prob=0.3)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-6)
    n = 400
    ti_ = np.asarray(jax.random.uniform(k1, (n,), minval=0.05, maxval=1.4))
    pi_ = np.asarray(jax.random.uniform(k1, (n,), minval=-3.1, maxval=3.1))
    to_ = np.asarray(jax.random.uniform(k2, (n,), minval=0.05, maxval=1.4))
    po_ = np.asarray(jax.random.uniform(k2, (n,), minval=-3.1, maxval=3.1))
    np.testing.assert_allclose(spher_to_cart(torch.from_numpy(ti_), torch.from_numpy(pi_)).numpy(),
                               ref.spher_to_cart_np(ti_, pi_), rtol=1e-6, atol=1e-6)
    ours = ggx_shading_spherical(torch.from_numpy(np.stack([ti_, pi_], -1)),
                                 torch.from_numpy(np.stack([to_, po_], -1)), 0.3)
    theirs = ref.ggx_shading_np(ref.spher_to_cart_np(ti_, pi_), ref.spher_to_cart_np(to_, po_), 0.3)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-6)


def test_port_anisotropic_ggx_pieces_cross_check():
    n = 300
    wh = ref.spher_to_cart_np(np.random.RandomState(0).uniform(0.05, 1.5, n),
                              np.random.RandomState(1).uniform(-3.1, 3.1, n)).astype(np.float32)
    w = ref.spher_to_cart_np(np.random.RandomState(2).uniform(0.05, 1.5, n),
                             np.random.RandomState(3).uniform(-3.1, 3.1, n)).astype(np.float32)
    au, av = 0.2, 0.5
    np.testing.assert_allclose(ggx_d(torch.from_numpy(wh), au, av).numpy(), ref.ggx_d_np(wh, au, av), rtol=2e-4)
    np.testing.assert_allclose(ggx_smith_g1(torch.from_numpy(w), torch.from_numpy(wh), au, av).numpy(),
                               ref.ggx_smith_g1_np(w, wh, au, av), rtol=2e-4, atol=1e-6)
    cos_i = np.linspace(0.02, 1.0, 128, dtype=np.float32)
    ours = fresnel_conductor(torch.from_numpy(cos_i), 0.2, 3.9).numpy().reshape(-1)
    np.testing.assert_allclose(ours, ref.fresnel_conductor_np(cos_i, 0.2, 3.9), rtol=1e-4)


@pytest.mark.parametrize("res", [32, 96])
def test_ggx_pdf_grid_normalizes(res):
    g = ref.ggx_pdf_grid_np(np.asarray([0.3, 0.1], np.float32), 0.4, res=res)
    assert np.isclose(g.sum() * (2.0 / res) ** 2, 1.0, atol=1e-6) and np.all(g >= 0)
