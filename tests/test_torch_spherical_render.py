"""The port's path tracer with the slice's matballs against the JAX
package, on the procedural matpreview-style scene (a point light
included) and its table-material twin (a scene_bsdf-style hook: table
entry 20, albedo (0.4, 0.8, 0.4), a transmissive principled material):

- one bounce (`_bounce_body`) at several depths, fed the very random
  numbers JAX draws from its keys inside `_bounce_program`, in modes
  neural-spherical (the spherical sampler on the measured ball), table gt
  (`principled_matball`) and neural-sphere (`neural_matball_sphere`, whose
  MIS pdf is the neural pdf, exact and reverse-Euler);
- whole tiny table-scene renders of both packages in gt mode, within
  Monte Carlo noise of JAX (means of three renders, see the test);
- the render CLI's new modes on the CPU.

Tolerances for the bounce, as test_torch_integrator.py holds them, pooled
over the bounces: the alive flags differ on at most 0.1% of rays; ro, rd,
L, beta and prev_pdf agree to 1e-3 relative (1e-5 absolute) on at least
99.5% of the rays whose flags agree.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os

import jax
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.bsdf import materials as jmat
from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu.core.config import SamplerConfig as JSamplerConfig
from bsdf_diffusion_sampling_tpu.render import integrator as ji
from bsdf_diffusion_sampling_tpu.render import neural as jneural
from bsdf_diffusion_sampling_tpu.render import scene as jscene
from bsdf_diffusion_sampling_tpu_torch.bsdf import materials as tmat
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.cli import render as cli
from bsdf_diffusion_sampling_tpu_torch.core.config import SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.native.exr import read_exr
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import neural as tneural
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render import scene as tscene
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import save_pytree

from _torch_port import sph_setup, tt

W, H = 24, 16
MAX_DISCRETE = 1e-3
MIN_CONTINUOUS = 0.995
IDX, ALBEDO = procedural.TABLE


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("render_sph"))
    kw = dict(n_lat=16, n_lon=24, plane_g=3, env_res=(32, 64), width=W, height=H,
              lights=[(2.0, 4.0, 3.0, 10.0, 9.0, 8.0)])
    paths = {"measured": procedural.write_scene(d, **kw), "table": procedural.write_scene(d, table=procedural.TABLE,
                                                                                          **kw)}
    bsdf = os.path.join(d, "synthetic_rgb.bsdf")
    s = sph_setup(n=8, seed=9, domain="sphere_full")
    save_pytree(os.path.join(d, "sph.npz"), {"base": s.tb, "rectified": s.tv}, step=1)
    return dict(dir=d, paths=paths, s=s, jb=jme.load_measured(bsdf), tb=tme.load_measured(bsdf, device="cpu"),
                js={k: jscene.load_scene(p, width=W, height=H, wide=False) for k, p in paths.items()},
                ts={k: tscene.load_scene(p, device="cpu", width=W, height=H) for k, p in paths.items()})


def _matballs(w, mode):
    """(scene, JAX matball, port matball) of a mode."""
    s = w["s"]
    if mode == "gt":
        return ("table", ji.principled_matball(jmat.BSDF_MATERIALS[IDX], ALBEDO),
                ti.principled_matball(tmat.BSDF_MATERIALS[IDX], ALBEDO, device="cpu"))
    domain = "spherical" if mode == "neural-spherical" else "sphere_full"
    exact = mode != "neural-sphere-reverse"
    jnb = jneural.make_neural_bsdf(domain, s.cfg, s.v, s.b, w["jb"], sampler_cfg=JSamplerConfig(pdf_exact=exact),
                                   fused=False)
    tnb = tneural.make_neural_bsdf(domain, s.cfg, s.tv, s.tb, w["tb"], sampler_cfg=SamplerConfig(pdf_exact=exact),
                                   device="cpu")
    if mode == "neural-spherical":
        return "measured", ji.neural_matball(jnb), ti.neural_matball(tnb)
    return ("table", ji.neural_matball_sphere(jnb, jmat.BSDF_MATERIALS[IDX], ALBEDO),
            ti.neural_matball_sphere(tnb, tmat.BSDF_MATERIALS[IDX], ALBEDO))


def _jax_randoms(k_path, depth, n, mode):
    """What `_bounce_body` draws from its key at this depth
    (`integrator.py:316,365,403,436`); the ball's draw from keys[1]: the
    principled sampler's split into a cosine draw and a side draw
    (`:790-796`), the spherical base density's split into a Gaussian and
    the von Mises uniforms (`base_density.py:92-98`)."""
    k_nee, k_bsdf, k_rr = jax.random.split(jax.random.fold_in(k_path, depth), 3)
    keys = jax.random.split(k_bsdf, 2)
    k1, k2 = jax.random.split(keys[1])
    if mode == "gt":
        ball = (tt(jax.random.uniform(k1, (n, 2))), tt(jax.random.uniform(k2, (n,))))
    else:
        ball = (tt(jax.random.normal(k1, (n,))), tt(jax.random.uniform(k2, (16, 3, n), minval=1e-7,
                                                                        maxval=1.0 - 1e-7)))
    return ti.BounceRandoms(tt(jax.random.uniform(k_nee, (n, 2))), tt(jax.random.uniform(keys[0], (n, 2))),
                            (ball,), tt(jax.random.uniform(k_rr, (n,))))


@pytest.mark.parametrize("mode", ["neural-spherical", "gt", "neural-sphere", "neural-sphere-reverse"])
def test_bounce_matches_jax(world, mode):
    scene, jmb, tmb = _matballs(world, mode)
    js, ts = world["js"][scene], world["ts"][scene]
    assert tmb.transmissive == jmb.transmissive == (scene == "table")
    state, k_path = ji._init_wavefront(js.camera.vectors, jax.random.key(1), 0, width=W, height=H, spp_chunk=4,
                                       rows=H)
    n = state[0].shape[0]
    flips, bad, rows_seen = 0, np.zeros(7), np.zeros(7)
    for depth in range(3):  # camera rays, then MIS on env hits
        jout = ji._bounce_program(js.bvh, js.envmap, js.lights, state, k_path, depth, matball=(jmb,))
        tout, truncated = ti._bounce_body(ts.accel, ts.envmap, ts.lights,
                                          tuple(torch.from_numpy(np.array(x)) for x in state),
                                          _jax_randoms(k_path, depth, n, mode), depth, matball=(tmb,))
        assert not bool(truncated)
        ja, ta = np.asarray(jout[5]), tout[5].numpy()
        flips += int((ja != ta).sum())
        for i in (0, 1, 3, 4, 6):  # ro, rd, L, beta, prev_pdf
            a, b = tout[i].numpy().reshape(n, -1), np.asarray(jout[i]).reshape(n, -1)
            rows = (ja == ta) & (ja if i != 3 else True)  # L counts on every ray
            bad[i] += (rows & ~np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)).sum()
            rows_seen[i] += rows.sum()
        state = jout
    assert flips <= MAX_DISCRETE * 3 * n
    assert (bad <= (1.0 - MIN_CONTINUOUS) * rows_seen).all(), (bad, rows_seen)
    assert rows_seen[0] > n // 4


def _rel_mse(a, ref):
    return float(np.mean((a - ref) ** 2 / (ref ** 2 + 1e-2)))


def test_table_render_matches_jax_within_noise(world):
    """The transmissive material's clamped fireflies make the relMSE of one
    seed pair heavy-tailed (it varies several-fold between pairs of JAX
    seeds), so the images compared are means of three renders:
    relMSE(port mean, JAX mean A) within 2.5x relMSE(JAX mean B, JAX mean A),
    both ways round."""
    _, jmb, tmb = _matballs(world, "gt")
    kw = dict(spp=16, spp_chunk=4, max_depth=4)
    jr = [ji.render(world["js"]["table"], jmb, seed=s, **kw) for s in range(6)]
    img = np.mean([ti.render(world["ts"]["table"], tmb, seed=s, device="cpu", **kw) for s in range(3)], 0)
    ja, jb = np.mean(jr[:3], 0), np.mean(jr[3:], 0)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert _rel_mse(img, ja) <= 2.5 * _rel_mse(jb, ja)
    assert _rel_mse(img, jb) <= 2.5 * _rel_mse(ja, jb)
    assert abs(img.mean() / np.mean(jr) - 1) < 0.03
    ball = img[H // 2 - 2:H // 2 + 2, W // 2 - 2:W // 2 + 2]
    assert ball[..., 1].mean() > ball[..., 0].mean()  # the albedo tint: greener than red


@pytest.mark.parametrize("scene,mode", [("measured", "neural-spherical"), ("table", "gt"),
                                        ("table", "neural-sphere")])
def test_cli_new_modes_on_the_cpu(world, tmp_path, scene, mode):
    out = str(tmp_path / mode)
    img, _ = cli.main(["--scene", world["paths"][scene], "--bsdf-dir", world["dir"], "--material", "synthetic_rgb",
                       "--mode", mode,
                       "--checkpoint", os.path.join(world["dir"], "sph.npz"), "--spp", "4", "--width", "16",
                       "--height", "12", "--max-depth", "3", "--device", "cpu", "--out", out])
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.max() > 0
    np.testing.assert_array_equal(read_exr(out + ".exr"), img.astype(np.float16).astype(np.float32))
    assert os.path.getsize(out + ".png") > 0


def test_cli_refuses_a_mode_for_the_other_kind_of_matball(world, tmp_path):
    for scene, mode in (("table", "neural-spherical"), ("measured", "neural-sphere")):
        with pytest.raises(ValueError, match="matball"):
            cli.main(["--scene", world["paths"][scene], "--bsdf-dir", world["dir"], "--mode", mode,
                      "--checkpoint", os.path.join(world["dir"], "sph.npz"), "--spp", "4", "--width", "8",
                      "--height", "8", "--device", "cpu", "--out", str(tmp_path / "x")])
