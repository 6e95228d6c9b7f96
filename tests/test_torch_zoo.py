"""The port's model zoo (`models/zoo.py`) against the JAX package's
`models/zoo.py`: the same JAX parameter trees through `params_from_jax`,
the same numpy inputs.

Tolerances: the regressors, `velocity_pe_x_apply` and the mixture
log-densities rtol 1e-5, atol 1e-5; the U-Net's output and the gradient of
a scalar loss 1e-4 of each array's largest magnitude. The samplers are held
by distribution, as tests/test_zoo.py:46-111 holds JAX's: the grid integral
of exp(log_prob) within 0.02 of 1, the histogram KL under 0.1 (GMM) and
0.05 (the spherical mixture's phi marginal).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.models import zoo as jzoo
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models import zoo as tzoo

from _torch_port import tt


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("sigmoid_head", [False, True])
def test_regressor_matches_jax(sigmoid_head):
    params, japply = jzoo.make_regressor(jax.random.key(0), in_dim=5, out_dim=2, hidden=32, n_hidden=2,
                                         sigmoid_head=sigmoid_head)
    _, tapply = tzoo.make_regressor(torch.Generator().manual_seed(0), 5, 2, hidden=32, n_hidden=2,
                                    sigmoid_head=sigmoid_head)
    rng = np.random.default_rng(0)
    x, alpha, cond = (rng.standard_normal((17, k)).astype(np.float32) for k in (2, 1, 2))
    want = japply(params, jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(cond))
    got = tapply(params_from_jax(params, "cpu"), tt(x), tt(alpha), tt(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_regressor_init_shapes():
    params, _ = tzoo.make_regressor(torch.Generator().manual_seed(0), 5, 2, hidden=32, n_hidden=2)
    jparams, _ = jzoo.make_regressor(jax.random.key(0), 5, 2, hidden=32, n_hidden=2)
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in params] == \
        [{k: tuple(v.shape) for k, v in layer.items()} for layer in jparams]


def test_velocity_pe_x_matches_jax():
    params = jzoo.velocity_pe_x_init(jax.random.key(1), x_dim=2, cond_dim=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((33, 2)).astype(np.float32)
    cond = 0.1 * x
    for alpha in (0.5, np.full((33, 1), 0.25, np.float32)):
        want = jzoo.velocity_pe_x_apply(params, jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(cond))
        got = tzoo.velocity_pe_x_apply(params_from_jax(params, "cpu"), tt(x),
                                       alpha if isinstance(alpha, float) else tt(alpha), tt(cond))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tparams = tzoo.velocity_pe_x_init(torch.Generator().manual_seed(0), 2, 2)
    assert [tuple(layer["w"].shape) for layer in tparams] == [tuple(layer["w"].shape) for layer in params]


BASES = {"gmm_disk": (jzoo.gmm_disk_base, tzoo.gmm_disk_base, 3),
         "mixture_spherical": (jzoo.mixture_spherical_base, tzoo.mixture_spherical_base, 2)}


@pytest.mark.parametrize("which", list(BASES))
def test_mixture_log_prob_matches_jax(which):
    jmake, tmake, k = BASES[which]
    jbase, tbase = jmake(n_modes=k), tmake(n_modes=k)
    params = jbase.init(jax.random.key(2))
    rng = np.random.default_rng(2)
    n = 512
    omega = rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32)
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    want = jbase.log_prob(params, jnp.asarray(x), jnp.asarray(omega))
    got = tbase.log_prob(params_from_jax(params, "cpu"), tt(x), tt(omega))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tparams = tbase.init(torch.Generator().manual_seed(0))
    assert tparams["pe_bands"] == 5 and tparams["n_modes"] == k
    assert [tuple(layer["w"].shape) for layer in tparams["net"]] == \
        [tuple(layer["w"].shape) for layer in params["net"]]


def test_gmm_disk_normalization_and_sampling():
    base = tzoo.gmm_disk_base(n_modes=3)
    gen = torch.Generator().manual_seed(0)
    params = base.init(gen)
    n = 1 << 14
    lim, res = 6.0, 160
    centers = (np.arange(res) + 0.5) / res * 2 * lim - lim
    gx, gy = np.meshgrid(centers, centers, indexing="ij")
    grid = tt(np.stack([gx.ravel(), gy.ravel()], -1))
    wi = torch.tensor([[0.2, -0.3]]).expand(grid.shape[0], 2)
    with torch.no_grad():
        integral = float(torch.exp(base.log_prob(params, grid, wi)).sum()) * (2 * lim / res) ** 2
        assert abs(integral - 1.0) < 0.02, integral
        x = base.sample(params, torch.tensor([[0.2, -0.3]]).expand(n, 2), gen).numpy()
    assert x.shape == (n, 2)
    hist, ex, ey = np.histogram2d(x[:, 0], x[:, 1], bins=24, range=[[-lim, lim], [-lim, lim]])
    q = hist / hist.sum()
    cx, cy = (ex[:-1] + ex[1:]) / 2, (ey[:-1] + ey[1:]) / 2
    gx2, gy2 = np.meshgrid(cx, cy, indexing="ij")
    g2 = tt(np.stack([gx2.ravel(), gy2.ravel()], -1))
    with torch.no_grad():
        p2 = torch.exp(base.log_prob(params, g2, torch.tensor([[0.2, -0.3]]).expand(g2.shape[0], 2)))
    p2 = p2.numpy().reshape(24, 24)
    p2 = p2 / p2.sum()
    mask = p2 > p2.max() * 1e-3
    kl = float(np.sum(p2[mask] * np.log((p2[mask] + 1e-9) / (q[mask] + 1e-9))))
    assert kl < 0.1, kl


def test_mixture_spherical_normalization_and_sampling():
    base = tzoo.mixture_spherical_base(n_modes=2)
    gen = torch.Generator().manual_seed(1)
    params = base.init(gen)
    n = 1 << 14
    res_t, res_p = 200, 64
    t = (np.arange(res_t) + 0.5) / res_t * 16.0 - 8.0
    ph = (np.arange(res_p) + 0.5) / res_p * 2 * np.pi - np.pi
    gt, gp = np.meshgrid(t, ph, indexing="ij")
    grid = tt(np.stack([gt.ravel(), gp.ravel()], -1))
    with torch.no_grad():
        p = torch.exp(base.log_prob(params, grid, torch.tensor([[0.4, 0.1]]).expand(grid.shape[0], 2))).numpy()
        x = base.sample(params, torch.tensor([[0.4, 0.1]]).expand(n, 2), gen).numpy()
    integral = float(p.sum()) * (16.0 / res_t) * (2 * np.pi / res_p)
    assert abs(integral - 1.0) < 0.02, integral
    assert x.shape == (n, 2) and np.all(np.isfinite(x)) and np.all(np.abs(x[:, 1]) <= np.pi + 1e-5)
    hist, _ = np.histogram(x[:, 1], bins=res_p, range=[-np.pi, np.pi])
    q = hist / hist.sum()
    p_phi = p.reshape(res_t, res_p).sum(0)
    p_phi = p_phi / p_phi.sum()
    kl = float(np.sum(p_phi * np.log((p_phi + 1e-9) / (q + 1e-9))))
    assert kl < 0.05, kl


def test_explicit_draws_pick_the_mode_of_their_cdf_interval():
    """A mode uniform in a mode's CDF interval picks that mode: with eps = 0
    the GMM's draw is that mode's loc."""
    base = tzoo.gmm_disk_base(n_modes=3)
    params = base.init(torch.Generator().manual_seed(3))
    omega = torch.tensor([[0.1, 0.2]])
    with torch.no_grad():
        out = tzoo.mlp_apply(params["net"], tzoo.positional_encoding(omega, 5))[0]
        w = out[12:15].abs() + 1e-10
        cdf = torch.cumsum(w / w.sum(), 0)
        locs = out[:6].reshape(3, 2)
        for mode in range(3):
            lo = 0.0 if mode == 0 else float(cdf[mode - 1])
            u = torch.tensor([(lo + float(cdf[mode])) / 2])
            x = base.sample(params, omega, (u, torch.zeros(1, 2)))
            torch.testing.assert_close(x[0], locs[mode])


def test_unet_forward_and_gradient_match_jax():
    """The whole U-Net (stride-2 "SAME" convolutions, transposed
    convolutions, the residual adds) and the gradient of a scalar loss on
    it, for every weight and the input."""
    params = jzoo.unet_init(jax.random.key(4))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    alpha = np.array([0.2, 0.7], np.float32)

    def jloss(p, xx):
        return jnp.mean((jzoo.unet_apply(p, xx, jnp.asarray(alpha)) - xx) ** 2)

    want_y = np.asarray(jzoo.unet_apply(params, jnp.asarray(x), jnp.asarray(alpha)))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = params_from_jax(params, "cpu")
    leaves = [(name, k, tp[name][k].requires_grad_()) for name in tp for k in ("w", "b")]
    tx = tt(x).requires_grad_()
    y = tzoo.unet_apply(tp, tx, tt(alpha))
    assert tuple(y.shape) == (2, 32, 32, 1)
    assert _max_rel(y.detach().numpy(), want_y) < 1e-4
    grads = torch.autograd.grad(((y - tx) ** 2).mean(), [t for _, _, t in leaves] + [tx])
    for (name, k, _), g in zip(leaves, grads[:-1]):
        assert _max_rel(g.numpy(), np.asarray(want_gp[name][k])) < 1e-4, (name, k)
    assert _max_rel(grads[-1].numpy(), np.asarray(want_gx)) < 1e-4


@pytest.mark.parametrize("hw", [(32, 32), (7, 10)])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_and_conv_transpose_match_lax(hw, stride):
    """One convolution and one transposed convolution against
    `lax.conv_general_dilated` / `lax.conv_transpose` with "SAME": the
    stride-2 convolution pads 0 before and 1 after on even sizes, and the
    transposed one correlates the dilated input with the unflipped kernel."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    p = {"w": tt(w), "b": tt(b)}
    nchw = tt(x).permute(0, 3, 1, 2)
    dn = ("NHWC", "HWIO", "NHWC")
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                        dimension_numbers=dn) + b
    got = tzoo._conv(nchw, p, stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want_t = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                    dimension_numbers=dn) + b
    got_t = tzoo._conv_t(nchw, p, stride).permute(0, 2, 3, 1)
    assert got_t.shape == want_t.shape
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-5)


def test_unet_training_step_reduces_the_loss():
    gen = torch.Generator().manual_seed(6)
    params = tzoo.unet_init(gen)
    leaves = [t.requires_grad_() for layer in params.values() for t in layer.values()]
    x = torch.randn((4, 32, 32, 1), generator=gen)
    alpha = torch.tensor([0.1, 0.4, 0.7, 0.9])

    def loss():
        return ((tzoo.unet_apply(params, x, alpha) - x) ** 2).mean()

    l0 = loss()
    grads = torch.autograd.grad(l0, leaves)
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            t -= 0.05 * g
    assert float(loss().detach()) < float(l0.detach())
