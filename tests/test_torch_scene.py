"""The port's scene inputs against the JAX package: `.serialized` meshes
(written by the port, read by both), the Mitsuba-XML subset, EXR IO both
ways, the envmap (eval / sample / pdf with shared uniforms), the camera
(rays from JAX's own filter draws) and the Lambert helpers.

Tolerances: file contents, parsed scene descriptions and tables match
exactly; camera rays, shading frames and envmap radiance to 1e-6 absolute
(float32 in other orders); envmap sampling, whose inverse-CDF step can move
a sample across a cell on a 1-ulp difference, to 1e-4 relative on at
least 99.5% of rows.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsdf_diffusion_sampling_tpu.native import exr as jexr
from bsdf_diffusion_sampling_tpu.render import camera as jcam
from bsdf_diffusion_sampling_tpu.render import envmap as jenv
from bsdf_diffusion_sampling_tpu.render import lambert as jlam
from bsdf_diffusion_sampling_tpu.render import mesh as jmesh
from bsdf_diffusion_sampling_tpu.render import scene as jscene
from bsdf_diffusion_sampling_tpu_torch.native import exr
from bsdf_diffusion_sampling_tpu_torch.render import camera, envmap, lambert, mesh, procedural, scene

from _torch_port import tt

ATOL = 1e-6


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    path = procedural.write_scene(str(d), n_lat=12, n_lon=16, plane_g=3, env_res=(16, 32), width=40, height=30,
                                  spp=8, max_depth=5, lights=[(2.0, 4.0, 3.0, 10.0, 9.0, 8.0)])
    return d, path


def test_serialized_meshes_read_alike(scene_dir):
    d, _ = scene_dir
    f = str(d / "scene.serialized")
    for i in (0, 1):
        a, b = mesh.load_serialized(f, i), jmesh.load_serialized(f, i)
        for name in ("positions", "normals", "uvs", "faces"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        tf = np.array([[0.5, 0, 0, 1], [0, 2, 0, -1], [0, 0, 1, 0.5], [0, 0, 0, 1]])
        ta, tb = mesh.transform_mesh(a, tf), jmesh.transform_mesh(b, tf)
        np.testing.assert_array_equal(ta.positions, tb.positions)
        np.testing.assert_array_equal(ta.normals, tb.normals)
    assert len(mesh.load_serialized(f, 1).faces) == 2 * 16 * 11
    with pytest.raises(IndexError):
        mesh.load_serialized(f, 2)


def test_full_size_scene_has_the_matpreview_triangle_count():
    assert 2 * 200 * 149 + 2 * 32 * 32 == 61_648  # write_scene's defaults: sphere + plane
    assert len(procedural.uv_sphere(150, 200).faces) + len(procedural.plane_grid(32, 6.0).faces) == 61_648


def test_scene_xml_parses_alike(scene_dir):
    _, path = scene_dir
    a, b = scene.parse_scene_xml(path, width=40, height=30), jscene.parse_scene_xml(path, width=40, height=30)
    assert (a.width, a.height, a.spp, a.max_depth) == (b.width, b.height, b.spp, b.max_depth) == (40, 30, 8, 5)
    for name in ("origin", "right", "up", "forward"):
        np.testing.assert_array_equal(getattr(a.camera, name).numpy(), np.asarray(getattr(b.camera, name)))
    assert a.envmap_path == b.envmap_path and a.envmap_scale == b.envmap_scale
    np.testing.assert_array_equal(a.envmap_to_world, b.envmap_to_world)
    assert a.matballs == b.matballs == [{"filename": "synthetic_rgb", "idx": -1, "albedo": (1.0, 1.0, 1.0)}]
    np.testing.assert_array_equal(a.point_lights, b.point_lights)
    assert [(s["filename"], s["shape_index"], s["material"]) for s in a.shapes] == [
        (s["filename"], s["shape_index"], s["material"]) for s in b.shapes]
    for sa, sb in zip(a.shapes, b.shapes):
        np.testing.assert_array_equal(sa["to_world"], sb["to_world"])
    sc = scene.load_scene(path, device="cpu")
    assert sc.device.type == "cpu" and sc.lights.shape == (1, 6) and sc.envmap.data.shape == (16, 32, 3)


def test_exr_round_trips_both_ways(tmp_path):
    img = np.random.default_rng(0).uniform(0, 40, (37, 53, 3)).astype(np.float32)
    half = img.astype(np.float16).astype(np.float32)
    exr.write_exr(str(tmp_path / "port.exr"), img)
    np.testing.assert_array_equal(jexr.read_exr(str(tmp_path / "port.exr")), half)
    np.testing.assert_array_equal(exr.read_exr(str(tmp_path / "port.exr")), half)
    jexr.write_exr(str(tmp_path / "jax.exr"), img)
    np.testing.assert_array_equal(exr.read_exr(str(tmp_path / "jax.exr")), half)
    raw = bytearray((tmp_path / "jax.exr").read_bytes())
    at = raw.index(b"compression\0compression\0") + len(b"compression\0compression\0") + 4
    assert raw[at] == 4  # the JAX package's writer uses PIZ
    raw[at] = 1  # RLE: not read by the port
    (tmp_path / "rle.exr").write_bytes(bytes(raw))
    with pytest.raises(NotImplementedError):
        exr.read_exr(str(tmp_path / "rle.exr"))
    flat = np.ones((20, 9, 3), np.float32)  # compresses well: ZIP blocks
    exr.write_exr(str(tmp_path / "flat.exr"), flat)
    np.testing.assert_array_equal(jexr.read_exr(str(tmp_path / "flat.exr")), flat)


def _piz_image(kind):
    if kind == "smooth":  # an envmap: few values, short codes, 14-bit wavelet
        return procedural.sky_envmap(70, 140)
    yy, xx = np.mgrid[0:40, 0:2048]
    if kind == "wide_range":  # > 2^14 values in a chunk: the 16-bit wavelet; codes > 16 bits
        r = np.minimum(xx * 7 + yy, 0x7BFF).astype(np.uint16)
        bits = np.stack([r, (0x3C00 + xx // 64 + yy).astype(np.uint16), r | 0x8000], -1)
        return bits.view(np.float16).astype(np.float32)[:, :1999]
    return (((xx // 8 + yy // 8) % 2)[..., None] * np.float32([1, 2, 3]))[:, :77]  # runs: the run-length code


@pytest.mark.parametrize("kind", ["smooth", "wide_range", "runs"])
def test_exr_reads_jax_piz_exactly(tmp_path, monkeypatch, kind):
    """Files the JAX package's OpenEXR writer compresses with PIZ read back
    bit for bit through the port's Python PIZ decoder."""
    img = _piz_image(kind)
    path = str(tmp_path / f"{kind}.exr")
    jexr.write_exr(path, img)
    decoded, real = [], exr._piz_decode
    monkeypatch.setattr(exr, "_piz_decode", lambda *a: decoded.append(1) or real(*a))
    got = exr.read_exr(path)
    assert decoded  # at least one chunk was PIZ-compressed, not stored raw
    np.testing.assert_array_equal(got, img.astype(np.float16).astype(np.float32))


@pytest.fixture(scope="module")
def envs():
    img = procedural.sky_envmap(24, 48)
    rot = np.array([[0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    return jenv.envmap_from_image(img, rot), envmap.envmap_from_image(img, rot)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_envmap_eval_sample_pdf_match_jax(envs):
    je, te = envs
    np.testing.assert_array_equal(te.warp.cond_cdf.numpy(), np.asarray(je.warp.cond_cdf))
    d = _unit(np.random.default_rng(1), 2048)
    np.testing.assert_allclose(envmap.eval_env(te, tt(d)).numpy(), jenv.eval_env(je, jnp.asarray(d)),
                               rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(envmap.pdf_env(te, tt(d)).numpy(), jenv.pdf_env(je, jnp.asarray(d)), rtol=1e-4)
    u = np.random.default_rng(2).random((2048, 2), dtype=np.float32)
    jd, jl, jp = jenv.sample_env(je, jnp.asarray(u))
    td, tl, tp = envmap.sample_env(te, tt(u))
    for a, b in ((td, jd), (tl, jl), (tp, jp)):
        b = np.asarray(b, np.float64)
        close = np.abs(a.numpy() - b) <= 1e-5 + 1e-4 * np.abs(b)
        assert close.reshape(2048, -1).all(-1).mean() >= 0.995
    # the sun is sampled far more often than its solid angle
    assert (tl.numpy().max(-1) > 10).mean() > 0.05


def test_camera_rays_match_jax():
    jc = jcam.make_camera([0, 2.2, 6.2], [0, 0.85, 0], [0, 1, 0], 30.0, 20, 14)
    tc = camera.make_camera([0, 2.2, 6.2], [0, 0.85, 0], [0, 1, 0], 30.0, 20, 14)
    np.testing.assert_array_equal(tc.vectors.numpy(), np.asarray(jc.vectors))
    key = jax.random.key(3)
    n = 20 * 6 * 3
    u = jax.random.uniform(key, (n, 2), minval=1e-7, maxval=1.0)  # JAX's own filter draw
    jro, jrd, jpx = jcam.generate_rays(jc.vectors, 20, 14, key, 3, row0=4, rows=6)
    ro, rd, px = camera.generate_rays(tc.vectors, 20, 14, tt(u), 3, row0=4, rows=6)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_allclose(ro.numpy(), jro, atol=ATOL)
    np.testing.assert_allclose(rd.numpy(), jrd, atol=ATOL)


def test_lambert_helpers_match_jax():
    rng = np.random.default_rng(4)
    n = _unit(rng, 512)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1e-9, -1]]
    w = _unit(rng, 512)
    jt, jbt = jlam.make_frame(jnp.asarray(n))
    t, bt = lambert.make_frame(tt(n))
    np.testing.assert_allclose(t.numpy(), jt, atol=ATOL)
    np.testing.assert_allclose(bt.numpy(), jbt, atol=ATOL)
    wl = lambert.to_local(tt(n), t, bt, tt(w))
    np.testing.assert_allclose(wl.numpy(), jlam.to_local(jnp.asarray(n), jt, jbt, jnp.asarray(w)), atol=ATOL)
    np.testing.assert_allclose(lambert.to_world(tt(n), t, bt, wl).numpy(), w, atol=1e-5)
    key = jax.random.key(5)
    jwo, jpdf = jlam.cosine_sample(key, (512,))
    wo, pdf = lambert.cosine_sample(tt(jax.random.uniform(key, (512, 2))))
    np.testing.assert_allclose(wo.numpy(), jwo, atol=ATOL)
    np.testing.assert_allclose(pdf.numpy(), jpdf, atol=ATOL)
    alb = rng.random((512, 3), dtype=np.float32)
    np.testing.assert_allclose(lambert.diffuse_eval(tt(alb), wl).numpy(),
                               jlam.diffuse_eval(jnp.asarray(alb), jnp.asarray(wl.numpy())), atol=ATOL)
    np.testing.assert_allclose(lambert.diffuse_pdf(wl).numpy(), jlam.diffuse_pdf(jnp.asarray(wl.numpy())),
                               atol=ATOL)
    uv = rng.uniform(-1, 2, (512, 2)).astype(np.float32)
    np.testing.assert_array_equal(lambert.checkerboard(tt(uv)).numpy(), jlam.checkerboard(jnp.asarray(uv)))
