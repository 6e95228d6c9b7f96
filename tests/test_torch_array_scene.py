"""The array-scene dialect (version 0.5.0: camelCase names, an inline
`mybsdf` hook in each ball's shape, a point light or an envmap) through
both packages, on scenes `render/procedural.py::write_array_scene` writes:

- the 12-ball arrays of both kinds (measured, table) parse in the port as
  in the JAX package's `render/scene.py::parse_scene_xml`: matballs,
  lights, envmap, material ids and transforms equal, the camera to 1e-6;
- one bounce (`_bounce_body`) of a three-ball scene (one measured ball,
  two table entries) under the envmap and under a point light, fed the
  random numbers JAX draws from its keys, at the tolerance of
  tests/test_torch_integrator.py::test_bounce_matches_jax: alive flags
  differ on at most 0.1% of rays, ro, rd, L, beta and prev_pdf agree to
  1e-3 relative (1e-5 absolute) on 99.5% of the rays whose flags agree;
- whole renders of the three-ball point-light scene at 32 x 24, 16 spp,
  depth 2: relMSE(port, JAX seed 0) within 2x relMSE(JAX seed k, JAX seed
  0), the Monte Carlo noise between two JAX runs, as medians over five
  seeds a side. At 768 pixels one firefly (a glossy table ball lit by the
  point light) can be 90% of one image's relMSE, in either package; the
  median keeps one such image from deciding the comparison.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.bsdf import materials as jmat
from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu.render import integrator as ji
from bsdf_diffusion_sampling_tpu.render import scene as jscene
from bsdf_diffusion_sampling_tpu_torch.bsdf import materials as tmat
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render import scene as tscene
from bsdf_diffusion_sampling_tpu_torch.utils import relative_mse

from _torch_port import tt

W, H = 32, 24
SMALL = dict(n_lat=12, n_lon=16, plane_g=3, env_res=(32, 64), width=W, height=H)
THREE = ("synthetic_00_rgb", (20, (0.4, 0.8, 0.4)), (5, (0.8, 0.4, 0.3)))
MAX_DISCRETE = 1e-3
MIN_CONTINUOUS = 0.995


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("array"))
    paths = {kind: procedural.write_array_scene(os.path.join(d, kind), kind=kind, **SMALL)
             for kind in ("measured", "table")}
    paths["three envmap"] = procedural.write_array_scene(os.path.join(d, "env"), kind="three", balls=THREE, **SMALL)
    paths["three point"] = procedural.write_array_scene(os.path.join(d, "point"), kind="three", balls=THREE,
                                                        point_light=procedural.ARRAY_LIGHT, **SMALL)
    return paths


def _matballs(path, desc):
    """Both packages' matballs of a scene, in its slot order: a measured
    ball samples itself, a table ball is `principled_matball`."""
    jm, tm = [], []
    for b in desc.matballs:
        if b["idx"] < 0:
            f = os.path.join(os.path.dirname(path), b["filename"] + ".bsdf")
            jm.append(ji.measured_matball(jme.load_measured(f)))
            tm.append(ti.measured_matball(tme.load_measured(f, device="cpu")))
        else:
            jm.append(ji.principled_matball(jmat.BSDF_MATERIALS[b["idx"]], b["albedo"]))
            tm.append(ti.principled_matball(tmat.BSDF_MATERIALS[b["idx"]], b["albedo"], device="cpu"))
    return tuple(jm), tuple(tm)


@pytest.mark.parametrize("kind", ["measured", "table"])
def test_array_scene_parses_as_in_jax(world, kind):
    path = world[kind]
    j, t = jscene.parse_scene_xml(path), tscene.parse_scene_xml(path)
    assert len(t.matballs) == 12 and t.matballs == j.matballs
    if kind == "measured":
        assert [b["filename"] for b in t.matballs] == list(procedural.ARRAY_MATERIALS)
        assert all(b["idx"] < 0 for b in t.matballs) and t.envmap_path == j.envmap_path != ""
        d = os.path.dirname(path)
        assert all(os.path.exists(os.path.join(d, f"{n}.bsdf")) for n in procedural.ARRAY_MATERIALS)
    else:
        assert [(b["idx"], b["albedo"]) for b in t.matballs] == [(i, tuple(map(float, a)))
                                                                for i, a in procedural.ARRAY_TABLE]
        assert not any(b["filename"] for b in t.matballs)
    # the plane, then one shape a ball, each its own slot
    assert [s["material"] for s in t.shapes] == [s["material"] for s in j.shapes] == (
        [tscene.MAT_PLANE] + list(range(tscene.MAT_BALL, tscene.MAT_BALL + 12)))
    for a, b in zip(t.shapes, j.shapes):
        assert (a["filename"], a["shape_index"]) == (b["filename"], b["shape_index"])
        np.testing.assert_array_equal(a["to_world"], b["to_world"])
    np.testing.assert_array_equal(t.point_lights, j.point_lights)
    np.testing.assert_array_equal(t.envmap_to_world, j.envmap_to_world)
    assert (t.width, t.height, t.spp, t.max_depth, t.envmap_scale) == (j.width, j.height, j.spp, j.max_depth,
                                                                      j.envmap_scale) == (W, H, 16, 12, 1.0)
    np.testing.assert_allclose(t.camera.vectors.numpy(), np.asarray(j.camera.vectors), rtol=1e-6, atol=1e-6)


def test_point_light_array_parses_as_in_jax(world):
    j, t = (m.parse_scene_xml(world["three point"]) for m in (jscene, tscene))
    np.testing.assert_array_equal(t.point_lights, [procedural.ARRAY_LIGHT])
    np.testing.assert_array_equal(t.point_lights, j.point_lights)
    assert t.envmap_path == j.envmap_path == "" and t.matballs == j.matballs and len(t.matballs) == 3


def _jax_randoms(k_path, depth, n, desc):
    """What `_bounce_body` draws from its key at this depth, ball by ball
    (`integrator.py:260-263`): a measured ball's uniforms (`:727`), a table
    ball's cosine and side draws (`:790-796`)."""
    k_nee, k_bsdf, k_rr = jax.random.split(jax.random.fold_in(k_path, depth), 3)
    keys = jax.random.split(k_bsdf, 1 + len(desc.matballs))
    balls = []
    for i, b in enumerate(desc.matballs):
        if b["idx"] < 0:
            balls.append(tt(jax.random.uniform(keys[1 + i], (n, 2), minval=1e-6, maxval=1.0 - 1e-6)))
        else:
            k1, k2 = jax.random.split(keys[1 + i])
            balls.append((tt(jax.random.uniform(k1, (n, 2))), tt(jax.random.uniform(k2, (n,)))))
    return ti.BounceRandoms(tt(jax.random.uniform(k_nee, (n, 2))), tt(jax.random.uniform(keys[0], (n, 2))),
                            tuple(balls), tt(jax.random.uniform(k_rr, (n,))))


@pytest.mark.parametrize("light", ["envmap", "point"])
def test_three_ball_bounce_matches_jax(world, light):
    path = world[f"three {light}"]
    js = jscene.load_scene(path, width=W, height=H, wide=False)
    ts = tscene.load_scene(path, device="cpu", width=W, height=H)
    jmb, tmb = _matballs(path, ts.desc)
    state, k_path = ji._init_wavefront(js.camera.vectors, jax.random.key(2), 0, width=W, height=H, spp_chunk=4,
                                       rows=H)
    n = state[0].shape[0]
    flips, bad, rows_seen, on_ball = 0, np.zeros(7), np.zeros(7), set()
    for depth in range(3):
        jout = ji._bounce_program(js.bvh, js.envmap, js.lights, state, k_path, depth, matball=jmb)
        tstate = tuple(torch.from_numpy(np.array(x)) for x in state)
        tout, truncated = ti._bounce_body(ts.accel, ts.envmap, ts.lights, tstate,
                                          _jax_randoms(k_path, depth, n, ts.desc), depth, matball=tmb)
        assert not bool(truncated)
        if depth == 0:  # every ball is seen by some camera ray
            h = ti._isect(ts.accel, tstate[0], tstate[1], tstate[5])
            mats = ts.accel.attr_rows[h.prim[h.t < 1e29], 15].to(torch.int64)
            on_ball = set(mats.tolist())
        ja, ta = np.asarray(jout[5]), tout[5].numpy()
        flips += int((ja != ta).sum())
        for i in (0, 1, 3, 4, 6):  # ro, rd, L, beta, prev_pdf
            a, b = tout[i].numpy().reshape(n, -1), np.asarray(jout[i]).reshape(n, -1)
            rows = (ja == ta) & (ja if i != 3 else True)  # L counts on every ray
            bad[i] += (rows & ~np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)).sum()
            rows_seen[i] += rows.sum()
        state = jout
    assert {tscene.MAT_BALL + i for i in range(3)} <= on_ball
    assert flips <= MAX_DISCRETE * 3 * n
    assert (bad <= (1.0 - MIN_CONTINUOUS) * rows_seen).all(), (bad, rows_seen)
    assert rows_seen[0] > n // 4


def test_three_ball_render_matches_jax_within_noise(world):
    path = world["three point"]
    js = jscene.load_scene(path, width=W, height=H, wide=False)
    ts = tscene.load_scene(path, device="cpu", width=W, height=H)
    jmb, tmb = _matballs(path, ts.desc)
    kw = dict(spp=16, spp_chunk=4, max_depth=2)
    j0, *jax_seeds = (ji.render(js, jmb, seed=s, **kw) for s in range(6))
    port = [ti.render(ts, tmb, seed=s, device="cpu", **kw) for s in range(5)]
    assert all(img.shape == (H, W, 3) and np.isfinite(img).all() and img.max() > 0 for img in port)
    got = [relative_mse(img, j0) for img in port]
    floor = [relative_mse(img, j0) for img in jax_seeds]
    assert np.median(got) <= 2.0 * np.median(floor), (got, floor)
