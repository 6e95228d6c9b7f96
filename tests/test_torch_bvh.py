"""The port's binary BVH (`render/bvh.py`) against the JAX package's
`render/bvh.py` and the port's own 8-wide walker, and a scene built with
`wide=False` through the renderer.

Tolerances: the node table is built from the same native tree on both
sides and must match bit for bit. The walks round Moller-Trumbore in their
own orders (XLA contracts some products into FMAs), so t is held to the
8-wide tests' T_RTOL (1e-5 relative) where both hit; hit masks and
occlusion flags must be equal. The renders with either accel trace the
same triangles: their images agree to 1e-3 relative on the mean.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.render import bvh as jbvh
from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured
from bsdf_diffusion_sampling_tpu_torch.render import bvh as tbvh
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render import traverse8 as t8
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import BVH8, build_bvh8
from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene

from _torch_port import random_meshes, soups, sphere_on_plane, tt

T_RTOL = 1e-5
N = 2048


@pytest.fixture(scope="module", params=["sphere_on_plane", "random"])
def scene(request):
    meshes, mids = sphere_on_plane() if request.param == "sphere_on_plane" else random_meshes(
        np.random.default_rng(3))
    js, ts = soups(meshes, mids)
    return request.param, ts, jbvh.build_bvh(js), tbvh.build_bvh(ts), build_bvh8(ts)


def _rays(rng, soup, n):
    """Rays from a shell around the soup's centre towards it, jittered."""
    center = soup.v0.mean(axis=0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = center + d * 4.0
    rd = -d + rng.normal(0, 0.25, (n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def test_table_matches_jax_bit_for_bit(scene):
    _, _, jb, tb, _ = scene
    for name in ("bb_min", "bb_max", "left", "count", "packed"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    a = tb.attr_rows.numpy()
    for col, name in ((0, "n0"), (3, "n1"), (6, "n2"), (9, "uv0"), (11, "uv1"), (13, "uv2")):
        w = np.asarray(getattr(jb, name)).shape[-1]
        np.testing.assert_array_equal(a[:, col:col + w], np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(a[:, 15].astype(np.int32), np.asarray(jb.material_id))
    assert tb.max_depth + 1 <= tbvh.STACK_DEPTH and tb.device == torch.device("cpu")


def test_closest_hit_matches_jax_and_the_8_wide_walker(scene):
    name, ts, jb, tb, b8 = scene
    ro, rd = _rays(np.random.default_rng(1), ts, N)
    h = tbvh.intersect(tb, tt(ro), tt(rd))
    jh = jbvh.intersect(jb, jnp.asarray(ro), jnp.asarray(rd))
    h8 = t8.intersect8(b8, tt(ro), tt(rd))
    t, jt, t8_ = h.t.numpy(), np.asarray(jh.t), h8.t.numpy()
    hit = t < 1e29
    assert 0.2 < hit.mean() < 1.0, name
    np.testing.assert_array_equal(hit, jt < 1e29)
    np.testing.assert_array_equal(hit, t8_ < 1e29)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL)
    np.testing.assert_allclose(t[hit], t8_[hit], rtol=T_RTOL)
    same_prim = h.prim.numpy() == np.asarray(jh.prim)
    assert same_prim[hit].mean() > 0.99  # a shared edge may go to either triangle
    np.testing.assert_allclose(h.u.numpy()[hit & same_prim], np.asarray(jh.u)[hit & same_prim], atol=1e-4)
    # the material seen through the hit agrees with the 8-wide walker's
    np.testing.assert_array_equal(tb.attr_rows[h.prim, 15].numpy()[hit], b8.attr_rows[h8.prim, 15].numpy()[hit])
    assert not h.u.numpy()[~hit].any() and not bool(h.truncated) and not bool(jh.truncated)


def test_occlusion_and_active_mask_match_jax(scene):
    _, ts, jb, tb, b8 = scene
    rng = np.random.default_rng(2)
    ro, rd = _rays(rng, ts, N)
    t_max = rng.uniform(0.5, 6.0, N).astype(np.float32)
    act = rng.random(N) < 0.7
    occ = tbvh.occluded(tb, tt(ro), tt(rd), tt(t_max), active=torch.from_numpy(act))
    jocc = jbvh.occluded(jb, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_max), active=jnp.asarray(act))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), t8.occluded8(b8, tt(ro), tt(rd), tt(t_max),
                                                            active=torch.from_numpy(act)).numpy())
    assert not occ.numpy()[~act].any() and 0.1 < occ.numpy()[act].mean() < 0.9
    h = tbvh.intersect(tb, tt(ro), tt(rd), tt(t_max), active=torch.from_numpy(act))
    np.testing.assert_array_equal(h.t.numpy()[~act], t_max[~act])


def test_truncation_is_flagged(scene, monkeypatch):
    _, ts, _, tb, _ = scene
    ro, rd = _rays(np.random.default_rng(4), ts, 64)
    monkeypatch.setattr(tbvh, "MAX_ITERS", 2)
    assert bool(tbvh.intersect(tb, tt(ro), tt(rd)).truncated)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bvh_render"))
    path = procedural.write_scene(d, n_lat=16, n_lon=24, plane_g=3, env_res=(32, 64), width=32, height=24,
                                  lights=[(2.0, 4.0, 3.0, 10.0, 9.0, 8.0)])
    return d, path


def test_binary_scene_renders_like_the_wide_one(world, monkeypatch):
    """The integrator picks the walk by the accel's type: a binary scene's
    render never reaches the 8-wide walker."""
    d, path = world
    binary = load_scene(path, device="cpu", wide=False)
    wide = load_scene(path, device="cpu")
    assert isinstance(binary.accel, tbvh.BVH) and isinstance(wide.accel, BVH8)
    assert binary.to("cpu").device == torch.device("cpu")
    mb = ti.measured_matball(load_measured(os.path.join(d, "synthetic_rgb.bsdf"), device="cpu"))
    kw = dict(seed=0, spp=4, spp_chunk=4, max_depth=2, device="cpu")
    img_w = ti.render(wide, mb, **kw)

    def no_wide_walk(*args, **kwargs):
        raise AssertionError("the 8-wide walker ran on a binary scene")

    monkeypatch.setattr(ti, "intersect8", no_wide_walk)
    img_b = ti.render(binary, mb, **kw)
    assert img_b.shape == (24, 32, 3) and np.isfinite(img_b).all() and img_b.max() > 0
    assert abs(img_b.mean() / img_w.mean() - 1) < 1e-3
    assert np.mean(np.isclose(img_b, img_w, rtol=1e-3, atol=1e-5)) > 0.99
