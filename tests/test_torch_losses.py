"""The port's training losses and their gradients (`train/losses.py`)
against the JAX package's under `jax.value_and_grad`, on the same params
and batches: the disk domain and the spherical ones, with phi across
+-pi. Tolerance 1e-5 relative (float32 sums in other orders); a
gradient is held leaf by leaf, relative to the leaf's largest entry."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsdf_diffusion_sampling_tpu.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu.models import get_base as j_get_base
from bsdf_diffusion_sampling_tpu.models.velocity import encode_condition as j_encode, velocity_init
from bsdf_diffusion_sampling_tpu.train import losses as jl
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models import get_base as t_get_base
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition as t_encode
from bsdf_diffusion_sampling_tpu_torch.train import losses as tl
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import _flatten, tree_leaves, tree_map

from _torch_port import tt

RTOL = 1e-5
N = 512


def _pairs(domain, rng, n=N):
    """(omega_i, x0, x1): disk points, or (theta, phi) with phi spread over
    [-pi, pi) and pairs straddling the +-pi seam."""
    if domain == "disk":
        return [rng.uniform(-0.7, 0.7, (n, 2)).astype(np.float32) for _ in range(3)]
    top = math.pi / 2 if domain == "spherical" else math.pi
    out = [np.stack([rng.uniform(0.05, top - 0.05, n), rng.uniform(-math.pi, math.pi, n)], -1).astype(np.float32)
           for _ in range(3)]
    out[1][: n // 4, 1] = rng.uniform(2.9, math.pi - 1e-3, n // 4)  # x0 just below +pi ...
    out[2][: n // 4, 1] = rng.uniform(-math.pi, -2.9, n // 4)  # ... x1 just above -pi
    return out


def _grad_close(got_tree, want_tree):
    """Leaf by leaf, matched by key path."""
    got = dict(_flatten(tree_map(lambda t: t.grad, got_tree)))
    want = {jax.tree_util.keystr(p): np.asarray(w) for p, w in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()), err_msg=k)



def _requires_grad(tree):
    for t in tree_leaves(tree):
        t.requires_grad_(True)
    return tree


@pytest.mark.parametrize("domain", ["disk", "spherical", "sphere_full"])
def test_pretrain_nll_and_grad_match_jax(domain):
    rng = np.random.default_rng(0)
    wi, wo, _ = _pairs(domain, rng)
    batch = np.concatenate([wi, wo], -1)
    jp = j_get_base(domain).init(jax.random.key(1))
    jv, jg = jax.value_and_grad(lambda p: jl.pretrain_nll(j_get_base(domain), p, jnp.asarray(batch)))(jp)
    tp = _requires_grad(params_from_jax(jp, "cpu"))
    tv = tl.pretrain_nll(t_get_base(domain), tp, tt(batch))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    _grad_close(tp, jg)


@pytest.mark.parametrize("domain", ["disk", "spherical", "sphere_full"])
def test_flow_matching_targets_match_jax(domain):
    rng = np.random.default_rng(1)
    _, x0, x1 = _pairs(domain, rng)
    alpha = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    got = tl.flow_matching_targets(domain, tt(x0), tt(x1), tt(alpha))
    want = jl.flow_matching_targets(domain, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(alpha))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-6)
    if domain != "disk":  # the phi target is the short way round the seam
        assert (np.abs(got[1][:, 1].numpy()) <= math.pi + 1e-6).all()
        assert (got[1][: N // 4, 1].numpy() > 0).all()


@pytest.mark.parametrize("domain", ["disk", "spherical", "sphere_full"])
def test_flow_matching_mse_and_grad_match_jax(domain):
    rng = np.random.default_rng(2)
    wi, x0, x1 = _pairs(domain, rng)
    cfg = ModelConfig(domain=domain) if domain == "disk" else ModelConfig(domain=domain, velocity_layers=4)
    alpha = np.linspace(0, 1, N, dtype=np.float32).reshape(-1, 1)
    jp = velocity_init(jax.random.key(2), cfg)
    cond = j_encode(jnp.asarray(wi), cfg)
    jv, jg = jax.value_and_grad(lambda p: jl.flow_matching_mse(domain, p, jnp.asarray(x0), jnp.asarray(x1),
                                                               jnp.asarray(alpha), cond))(jp)
    tp = _requires_grad(params_from_jax(jp, "cpu"))
    tv = tl.flow_matching_mse(domain, tp, tt(x0), tt(x1), tt(alpha), t_encode(tt(wi), cfg))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    _grad_close(tp, jg)


@pytest.mark.parametrize("n", [1, 2, 1000])
def test_linspace_alpha_matches_jax(n):
    got = tl.linspace_alpha(n, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jl.linspace_alpha(n)), atol=1e-7)
    assert got.shape == (n, 1)
