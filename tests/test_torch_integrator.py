"""The port's path tracer against the JAX package on a procedural
matpreview-style scene (a measured-BRDF ball on a checkered plane, a sky
envmap and a point light):

- one bounce (`_bounce_body`) at several depths, fed the very random
  numbers JAX draws from its keys inside `_bounce_program`, in both matball
  modes (measured ground truth; the neural disk sampler, whose CPU path
  draws eps = normal(key));
- a whole tiny render of both packages: relMSE(port, JAX) must stay within
  2x relMSE(JAX seed 1, JAX seed 0), Monte Carlo noise between two JAX runs;
- the render CLI on the CPU, writing EXR and PNG, in both modes.

Tolerances for the bounce, as shares pooled over four bounces: the alive
flags (the discrete state) differ on at most 0.1% of rays; ro, rd, L, beta
and prev_pdf agree to 1e-3 relative (1e-5 absolute) on at least 99.5% of
the rays whose flags agree, the share test_torch_measured.py holds the
measured BRDF to: its inverse CDF can cross a cell on a 1-ulp difference. The two packages also trace different
BVHs (binary in JAX, 8-wide in the port).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu.render import integrator as ji
from bsdf_diffusion_sampling_tpu.render import neural as jneural
from bsdf_diffusion_sampling_tpu.render import scene as jscene
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.cli import render as cli
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.native.exr import read_exr
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import neural as tneural
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render import scene as tscene
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import save_pytree

from _torch_port import disk_setup, tt

W, H = 32, 24
MAX_DISCRETE = 1e-3
MIN_CONTINUOUS = 0.995
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("render"))
    path = procedural.write_scene(d, n_lat=16, n_lon=24, plane_g=3, env_res=(32, 64), width=W, height=H,
                                  lights=[(2.0, 4.0, 3.0, 10.0, 9.0, 8.0)])
    bsdf = os.path.join(d, "synthetic_rgb.bsdf")
    s = disk_setup(n=8, seed=4)
    save_pytree(os.path.join(d, "disk.npz"), {"base": s.tb, "rectified": s.tv}, step=1)
    return dict(dir=d, path=path, js=jscene.load_scene(path, width=W, height=H, wide=False),
                ts=tscene.load_scene(path, device="cpu", width=W, height=H), jb=jme.load_measured(bsdf),
                tb=tme.load_measured(bsdf, device="cpu"), s=s)


def _matballs(w, mode):
    if mode == "gt":
        return ji.measured_matball(w["jb"]), ti.measured_matball(w["tb"])
    s = w["s"]
    jnb = jneural.make_neural_bsdf("disk", s.cfg, s.v, s.b, w["jb"], fused=False)
    tnb = tneural.make_neural_bsdf("disk", ModelConfig(), s.tv, s.tb, w["tb"], device="cpu")
    return ji.neural_matball(jnb), ti.neural_matball(tnb)


def _jax_randoms(k_path, depth, n, mode):
    """What `_bounce_body` draws from its key at this depth
    (`integrator.py:316,365,403,436`; the ball's draw at `:727` for the
    measured ball, the base density's normal(key) for the neural one)."""
    k_nee, k_bsdf, k_rr = jax.random.split(jax.random.fold_in(k_path, depth), 3)
    keys = jax.random.split(k_bsdf, 2)
    ball = (jax.random.uniform(keys[1], (n, 2), minval=1e-6, maxval=1.0 - 1e-6) if mode == "gt"
            else jax.random.normal(keys[1], (n, 2)))
    return ti.BounceRandoms(tt(jax.random.uniform(k_nee, (n, 2))), tt(jax.random.uniform(keys[0], (n, 2))),
                            (tt(ball),), tt(jax.random.uniform(k_rr, (n,))))


@pytest.mark.parametrize("mode", ["gt", "neural-disk"])
def test_bounce_matches_jax(world, mode):
    js, ts = world["js"], world["ts"]
    jmb, tmb = _matballs(world, mode)
    state, k_path = ji._init_wavefront(js.camera.vectors, jax.random.key(0), 0, width=W, height=H, spp_chunk=4,
                                       rows=H)
    n = state[0].shape[0]
    alive_seen, flips, bad, rows_seen = [], 0, np.zeros(7), np.zeros(7)
    for depth in range(4):  # camera rays, MIS on env hits from depth 1, Russian roulette at 3
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
            close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)
            bad[i] += (rows & ~close).sum()
            rows_seen[i] += rows.sum()
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        alive_seen.append(int(ja.sum()))
        state = jout
    # shares pooled over the bounces
    assert flips <= MAX_DISCRETE * 4 * n
    assert (bad <= (1.0 - MIN_CONTINUOUS) * rows_seen).all(), (bad, rows_seen)
    assert alive_seen[0] > n // 3 and alive_seen[1] > 0


def _rel_mse(a, ref):
    return float(np.mean((a - ref) ** 2 / (ref ** 2 + 1e-2)))


def test_whole_render_matches_jax_within_noise(world):
    jmb, tmb = _matballs(world, "gt")
    kw = dict(spp=32, spp_chunk=4, max_depth=4)
    j0, j1 = (ji.render(world["js"], jmb, seed=s, **kw) for s in (0, 1))
    img = ti.render(world["ts"], tmb, seed=0, device="cpu", **kw)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert _rel_mse(img, j0) <= 2.0 * _rel_mse(j1, j0)
    assert abs(img.mean() / j0.mean() - 1) < 0.02


def test_render_defaults_to_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.render(world["ts"], _matballs(world, "gt")[1], spp=4)


def _read_png(path):
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    p, idat = 8, b""
    while p < len(raw):
        (length,) = struct.unpack(">I", raw[p:p + 4])
        tag, data = raw[p + 4:p + 8], raw[p + 8:p + 8 + length]
        assert zlib.crc32(tag + data) == struct.unpack(">I", raw[p + 8 + length:p + 12 + length])[0]
        idat += data if tag == b"IDAT" else b""
        p += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()  # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def test_cli_renders_on_the_cpu(world, tmp_path):
    out = str(tmp_path / "gt")
    img, _ = cli.main(["--scene", world["path"], "--bsdf-dir", world["dir"], "--material", "synthetic_rgb",
                       "--mode", "gt", "--spp", "4", "--width", "16", "--height", "12", "--max-depth", "3",
                       "--device", "cpu", "--out", out])
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.max() > 0
    np.testing.assert_array_equal(read_exr(out + ".exr"), img.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(_read_png(out + ".png"), (cli.tonemap_srgb(img) * 255).astype(np.uint8))
    # the neural-disk mode through `python -m`, from a checkpoint on disk
    nn = str(tmp_path / "nn")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-m", "bsdf_diffusion_sampling_tpu_torch.cli.render", "--scene", world["path"],
                    "--bsdf-dir", world["dir"], "--material", "synthetic_rgb", "--mode", "neural-disk",
                    "--checkpoint", os.path.join(world["dir"], "disk.npz"), "--spp", "4", "--width", "16",
                    "--height", "12", "--max-depth", "3", "--device", "cpu", "--out", nn],
                   cwd=REPO, env=env, check=True, capture_output=True, timeout=120)
    img_nn = read_exr(nn + ".exr")
    assert img_nn.shape == (12, 16, 3) and np.isfinite(img_nn).all() and img_nn.max() > 0
    assert _read_png(nn + ".png").shape == (12, 16, 3)
