"""The port's scene geometry and traversal against the JAX package: the
SAH builder copy, the 8-wide table, and K5's plain walker (`render/
traverse8.py`) against JAX `render/bvh.py::intersect` / `occluded`, against
brute-force Moller-Trumbore, and in one small case against the JAX packet
kernel `intersect8` in Pallas interpret mode.

Tolerances: the builder and the table must match bit for bit. Traversal
t to 1e-5 relative where both hit, hit/miss and occlusion agreeing on
every ray (the scenes hold no grazing ties). The two BVHs number prims
differently, so hits are compared by t, hit point and the attributes they
look up, not by prim id.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.native import bvhlib as jbvhlib
from bsdf_diffusion_sampling_tpu.render import bvh as jbvh
from bsdf_diffusion_sampling_tpu.render import bvh8 as jbvh8
from bsdf_diffusion_sampling_tpu.render import traverse8 as jt8
from bsdf_diffusion_sampling_tpu_torch.native import bvhlib
from bsdf_diffusion_sampling_tpu_torch.render import traverse8 as t8
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import build_bvh8

from _torch_port import random_meshes, soups, sphere_on_plane, tt

T_RTOL = 1e-5


@pytest.fixture(scope="module", params=["sphere_on_plane", "random"])
def scene(request):
    meshes, mids = sphere_on_plane() if request.param == "sphere_on_plane" else random_meshes(
        np.random.default_rng(3))
    js, ts = soups(meshes, mids)
    return request.param, js, ts, jbvh.build_bvh(js), build_bvh8(ts)


def _rays(rng, soup, n):
    """Rays from a shell around the soup's centre towards it, jittered."""
    center = soup.v0.mean(axis=0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = center + d * 4.0
    rd = -d + rng.normal(0, 0.25, (n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _brute(soup, ro, rd):
    """Nearest Moller-Trumbore hit over every triangle, float64."""
    v0, e1, e2 = (np.asarray(x, np.float64)[None] for x in (soup.v0, soup.e1, soup.e2))
    o, d = ro[:, None].astype(np.float64), rd[:, None].astype(np.float64)
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    return np.where(ok, t, 1e30).min(-1)


def test_builder_copy_matches_jax(scene):
    _, js, ts, _, _ = scene
    lo = np.minimum(np.minimum(ts.v0, ts.v0 + ts.e1), ts.v0 + ts.e2)
    hi = np.maximum(np.maximum(ts.v0, ts.v0 + ts.e1), ts.v0 + ts.e2)
    for a, b in zip(bvhlib.build_bvh_native(lo, hi, 2), jbvhlib.build_bvh_native(lo, hi, 2)):
        np.testing.assert_array_equal(a, b)


def test_table_matches_jax_bit_for_bit(scene):
    _, js, ts, _, b8 = scene
    jb8 = jbvh8.build_bvh8(js)
    jtab = np.asarray(jb8.table)
    assert b8.table.shape == (jtab.shape[0], 16) and b8.n_rows == jb8.n_rows
    np.testing.assert_array_equal(b8.table.numpy().view(np.uint32), jtab[:, :16].view(np.uint32))
    assert not jtab[:, 16:].any()
    assert (b8.root_meta, b8.tri0, b8.max_depth) == (jb8.root_meta, jb8.tri0, jb8.max_depth)
    np.testing.assert_array_equal(b8.attr_rows.numpy(), np.asarray(jb8.attr_rows))


def test_closest_hit_matches_jax_binary_and_brute_force(scene):
    name, js, ts, jb, b8 = scene
    ro, rd = _rays(np.random.default_rng(1), ts, 2048)
    h = t8.intersect8(b8, tt(ro), tt(rd))
    jh = jbvh.intersect(jb, jnp.asarray(ro), jnp.asarray(rd))
    t, jt = h.t.numpy(), np.asarray(jh.t)
    hit, jhit = t < 1e29, jt < 1e29
    assert 0.2 < hit.mean() < 1.0, name
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL)
    brute = _brute(ts, ro, rd)
    np.testing.assert_array_equal(hit, brute < 1e29)
    np.testing.assert_allclose(t[hit], brute[hit], rtol=T_RTOL)
    # the hit point and the attributes it looks up agree with JAX's
    a = b8.attr_rows.numpy()[h.prim.numpy()]
    ja_mid = np.asarray(jb.material_id)[np.asarray(jh.prim)]
    np.testing.assert_array_equal(a[hit, 15].astype(np.int32), ja_mid[hit])
    if name == "sphere_on_plane":
        w0 = 1 - h.u.numpy() - h.v.numpy()
        n_sh = w0[:, None] * a[:, 0:3] + h.u.numpy()[:, None] * a[:, 3:6] + h.v.numpy()[:, None] * a[:, 6:9]
        jp = np.asarray(jh.prim)
        jw0 = 1 - np.asarray(jh.u) - np.asarray(jh.v)
        jn = (jw0[:, None] * np.asarray(jb.n0)[jp] + np.asarray(jh.u)[:, None] * np.asarray(jb.n1)[jp]
              + np.asarray(jh.v)[:, None] * np.asarray(jb.n2)[jp])
        np.testing.assert_allclose(n_sh[hit], jn[hit], atol=1e-4)
    assert not bool(h.truncated) and not bool(jh.truncated)


def test_occlusion_and_active_mask_match_jax(scene):
    _, js, ts, jb, b8 = scene
    rng = np.random.default_rng(2)
    ro, rd = _rays(rng, ts, 2048)
    t_max = rng.uniform(0.5, 6.0, 2048).astype(np.float32)
    act = rng.random(2048) < 0.7
    occ = t8.occluded8(b8, tt(ro), tt(rd), tt(t_max), active=torch.from_numpy(act))
    jocc = jbvh.occluded(jb, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_max), active=jnp.asarray(act))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert not occ.numpy()[~act].any() and 0.1 < occ.numpy()[act].mean() < 0.9
    # closest hit under the mask: inactive rays keep t_max, u = v = 0, prim 0
    h = t8.intersect8(b8, tt(ro), tt(rd), tt(t_max), active=torch.from_numpy(act))
    np.testing.assert_array_equal(h.t.numpy()[~act], t_max[~act])
    miss = ~act | (h.t.numpy() >= t_max)
    assert (h.prim.numpy() >= 0).all() and not h.u.numpy()[miss].any() and not h.v.numpy()[miss].any()


def test_any_hit_does_not_stop_in_the_last_ten_thousandth():
    """A hit in [0.9999 t_max, t_max) is no occlusion and must not end the
    walk (`traverse8.py:165`); one below 0.9999 t_max is."""
    from bsdf_diffusion_sampling_tpu_torch.render.mesh import Mesh, build_soup

    pos = np.array([[-1, -1, 1], [1, -1, 1], [0, 1, 1], [-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    b8 = build_bvh8(build_soup([Mesh(pos, None, None, np.array([[0, 1, 2], [3, 4, 5]], np.int32))], [0]))
    ro, rd = torch.zeros(3, 3), torch.tensor([[0.0, 0.0, 1.0]] * 3)
    t_max = torch.tensor([1.00005, 1.5, 0.9])
    np.testing.assert_array_equal(t8.occluded8(b8, ro, rd, t_max).numpy(), [False, True, False])
    h = t8.intersect8(b8, ro, rd, t_max, any_hit=True)
    np.testing.assert_allclose(h.t.numpy(), [1.0, 1.0, 0.9], rtol=1e-6)


def test_truncation_is_flagged(scene, monkeypatch):
    _, _, ts, _, b8 = scene
    ro, rd = _rays(np.random.default_rng(4), ts, 256)
    assert not bool(t8.intersect8(b8, tt(ro), tt(rd)).truncated)
    monkeypatch.setattr(t8, "MAX_VISITS", 2)
    assert bool(t8.intersect8(b8, tt(ro), tt(rd)).truncated)


def test_walk_stats_count_the_work(scene):
    _, _, ts, _, b8 = scene
    ro, rd = _rays(np.random.default_rng(5), ts, 512)
    rs, ird = t8.safe_dir(tt(rd))
    out = t8.traverse8_plain(b8, tt(ro), rs, ird, torch.full((512,), 1e30),
                             torch.ones(512, dtype=torch.bool), False, stats=True)
    st = out[-1]
    assert st.inner_visits >= 512 and st.leaf_visits > 0
    assert st.inner_visits <= st.box_tests <= 8 * st.inner_visits
    assert st.leaf_visits <= st.tri_tests <= 8 * st.leaf_visits


def test_cuda_wrapper_rejects_other_devices(scene):
    _, _, ts, _, b8 = scene
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        t8.traverse8(b8, x, x, x, torch.zeros(4, device="meta"), torch.ones(4, dtype=torch.bool, device="meta"),
                     False)


def test_plain_walker_matches_jax_packet_kernel(monkeypatch):
    """One small case against JAX's intersect8/occluded8 in interpret mode."""
    monkeypatch.setattr(jt8, "_INTERPRET", True)
    meshes, mids = sphere_on_plane()
    js, ts = soups(meshes, mids)
    jb8, b8 = jbvh8.build_bvh8(js), build_bvh8(ts)
    ro, rd = _rays(np.random.default_rng(6), ts, 256)
    t_max = np.full(256, 3.5, np.float32)
    jh = jt8.intersect8(jb8, jnp.asarray(ro), jnp.asarray(rd), S=1, G=1)
    h = t8.intersect8(b8, tt(ro), tt(rd))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=T_RTOL)  # XLA rounds MT in its own order
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jh.prim))
    jocc = jt8.occluded8(jb8, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_max), S=1, G=1)
    np.testing.assert_array_equal(t8.occluded8(b8, tt(ro), tt(rd), tt(t_max)).numpy(), np.asarray(jocc))
