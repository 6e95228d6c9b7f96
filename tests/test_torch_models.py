"""The port's model layer against the JAX package: encoding, MLP, velocity,
disk base density and coordinate maps, on the same inputs.

Tolerances: both sides run the same float32 arithmetic on the CPU, in other
orders, so they differ by a few ulps: 1e-6 absolute for O(1) values, 1e-5
relative where exp() or a product of several terms follows.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.geometry import coords as jc
from bsdf_diffusion_sampling_tpu.models import base_density as jbd
from bsdf_diffusion_sampling_tpu.models.encoding import positional_encoding as j_pe
from bsdf_diffusion_sampling_tpu.models.mlp import init_mlp, mlp_apply as j_mlp_apply
from bsdf_diffusion_sampling_tpu.models.velocity import velocity_apply as j_velocity_apply
from bsdf_diffusion_sampling_tpu_torch.geometry import coords as tc
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models import base_density as tbd
from bsdf_diffusion_sampling_tpu_torch.models.encoding import encoded_dim, positional_encoding as t_pe
from bsdf_diffusion_sampling_tpu_torch.models.mlp import mlp_apply as t_mlp_apply, mlp_dims
from bsdf_diffusion_sampling_tpu_torch.models.velocity import velocity_apply as t_velocity_apply

from _torch_port import disk_setup, hemisphere, tt

ATOL = 1e-6
RTOL = 1e-5


@pytest.mark.parametrize("bands", [0, 3, 5])
def test_positional_encoding_matches_jax(bands):
    x = np.random.default_rng(1).uniform(-1, 1, (64, 2)).astype(np.float32)
    got = t_pe(tt(x), bands).numpy()
    np.testing.assert_allclose(got, np.asarray(j_pe(jnp.asarray(x), bands)), atol=ATOL)
    assert got.shape[1] == encoded_dim(2, bands)


def test_base_pe_is_prefix_of_velocity_pe():
    """The fused kernels read the base heads' input from cond_enc[:, :14]:
    PE(x, 3 bands) must equal the first 14 columns of PE(x, 5 bands)."""
    x = tt(np.random.default_rng(2).uniform(-1, 1, (64, 2)))
    assert torch.equal(t_pe(x, 5)[:, :14], t_pe(x, 3))
    xj = jnp.asarray(x.numpy())
    np.testing.assert_array_equal(np.asarray(j_pe(xj, 5)[:, :14]), np.asarray(j_pe(xj, 3)))


@pytest.mark.parametrize("dims,bias", [([14, 16, 4], True), ([25, 32, 32, 32, 2], False)])
def test_mlp_matches_jax(dims, bias):
    params = init_mlp(jax.random.key(3), dims, bias=bias)
    x = np.random.default_rng(3).standard_normal((128, dims[0])).astype(np.float32)
    tp = params_from_jax(params, "cpu")
    assert tp[0]["w"].shape == (dims[0], dims[1])  # the (in, out) layout, no transpose
    assert mlp_dims(tp) == dims
    np.testing.assert_allclose(t_mlp_apply(tp, tt(x)).numpy(),
                               np.asarray(j_mlp_apply(params, jnp.asarray(x))), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("alpha_kind", ["float", "column"])
def test_velocity_apply_matches_jax(alpha_kind):
    s = disk_setup(n=128)
    x = s.rng.uniform(-0.8, 0.8, (s.n, 2)).astype(np.float32)
    alpha = 0.25 if alpha_kind == "float" else s.rng.random((s.n, 1), dtype=np.float32)
    t_alpha = alpha if alpha_kind == "float" else tt(alpha)
    np.testing.assert_allclose(np.asarray(s.t_cond), np.asarray(s.cond), atol=ATOL)
    got = t_velocity_apply(s.tv, tt(x), t_alpha, s.t_cond).numpy()
    want = j_velocity_apply(s.v, jnp.asarray(x), jnp.asarray(alpha), s.cond)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_disk_heads_match_jax():
    s = disk_setup(n=128)
    loc, ls = tbd._disk_heads(s.tb, s.t_omega)
    jloc, jls = jbd._disk_heads(s.b, jnp.asarray(s.omega))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), atol=ATOL)
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls), atol=ATOL)
    # heads from the velocity condition's 14-column prefix are the same heads
    loc2, ls2 = tbd.disk_heads_from_enc(s.tb, s.t_cond[:, :14])
    np.testing.assert_allclose(loc2.numpy(), loc.numpy(), atol=ATOL)
    np.testing.assert_allclose(ls2.numpy(), ls.numpy(), atol=ATOL)


def test_disk_base_sample_from_eps_matches_jax():
    """JAX draws eps = normal(key, (n, 2)); the port takes the same eps."""
    s = disk_setup(n=128)
    key = jax.random.key(5)
    want = jbd.disk_base_sample(s.b, jnp.asarray(s.omega), key)
    eps = tt(jax.random.normal(key, (s.n, 2)))
    got = tbd.disk_base_sample(s.tb, s.t_omega, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # a torch.Generator draws its own normals: reproducible per seed
    g = tbd.disk_base_sample(s.tb, s.t_omega, torch.Generator().manual_seed(1))
    assert torch.equal(g, tbd.disk_base_sample(s.tb, s.t_omega, torch.Generator().manual_seed(1)))


def test_disk_base_log_prob_matches_jax():
    s = disk_setup(n=128)
    x = s.rng.uniform(-1, 1, (s.n, 2)).astype(np.float32)
    got = tbd.disk_base_log_prob(s.tb, tt(x), s.t_omega).numpy()
    want = jbd.disk_base_log_prob(s.b, jnp.asarray(x), jnp.asarray(s.omega))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=RTOL)


def test_get_base():
    assert tbd.get_base("disk").domain == "disk"
    assert tbd.get_base("spherical").domain == tbd.get_base("sphere_full").domain == "spherical"
    with pytest.raises(ValueError):
        tbd.get_base("cube")


def _dirs():
    return hemisphere(np.random.default_rng(6), 128)


@pytest.mark.parametrize("name", ["disk_to_cart", "cart_to_disk", "spher_to_cart", "cart_to_spher",
                                  "encode_spherical_x"])
def test_coords_match_jax(name):
    rng = np.random.default_rng(7)
    if name == "disk_to_cart":
        args = (rng.uniform(-0.8, 0.8, (128, 2)).astype(np.float32),)
    elif name in ("cart_to_disk", "cart_to_spher"):
        args = (_dirs(),)
    elif name == "spher_to_cart":
        args = (rng.uniform(0, 1.5, 128).astype(np.float32), rng.uniform(-3, 3, 128).astype(np.float32))
    else:
        args = (np.stack([rng.uniform(0, 1.5, 128), rng.uniform(-3, 3, 128)], -1).astype(np.float32),)
    got = getattr(tc, name)(*map(tt, args)).numpy()
    want = np.asarray(getattr(jc, name)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_disk_round_trip():
    w = tt(_dirs())
    torch.testing.assert_close(tc.disk_to_cart(tc.cart_to_disk(w)), w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("domain, hidden, layers", [("disk", 32, 3), ("spherical", 32, 4), ("sphere_full", 64, 6)])
def test_initialisers_match_jax_layout(domain, hidden, layers):
    """velocity_init and the base's init draw torch's stream, not
    jax.random's: they are held to JAX's shapes and Kaiming-uniform bounds,
    and to the same tree as `params_from_jax` makes of JAX's."""
    from bsdf_diffusion_sampling_tpu.core.config import ModelConfig as JCfg
    from bsdf_diffusion_sampling_tpu.models.velocity import velocity_init as j_velocity_init
    from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig as TCfg
    from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
    from bsdf_diffusion_sampling_tpu_torch.models.velocity import velocity_init as t_velocity_init

    kw = dict(domain=domain, velocity_hidden=hidden, velocity_layers=layers)
    jv = params_from_jax(j_velocity_init(jax.random.key(0), JCfg(**kw)), "cpu")
    tv = t_velocity_init(root_generator(0, "cpu"), TCfg(**kw))
    jb = params_from_jax(jbd.get_base(domain).init(jax.random.key(1)), "cpu")
    tb = tbd.get_base(domain).init(root_generator(1, "cpu"))
    assert tb["pe_bands"] == jb["pe_bands"] == 3
    for t_tree, j_tree in ((tv, jv), (tb["net"], jb["net"])):
        assert [sorted(l) for l in t_tree] == [sorted(l) for l in j_tree]
        for tl, jl in zip(t_tree, j_tree):
            bound = 1.0 / np.sqrt(tl["w"].shape[0])
            for k in tl:
                assert tl[k].shape == jl[k].shape and tl[k].dtype == torch.float32
                assert float(tl[k].abs().max()) <= bound and float(tl[k].abs().max()) > 0.5 * bound
    # the same generator state gives the same weights
    assert torch.equal(t_velocity_init(root_generator(0, "cpu"), TCfg(**kw))[0]["w"], tv[0]["w"])
