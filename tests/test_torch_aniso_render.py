"""The anisotropic measured material through the port's renderer, against
the JAX package: the procedural scene with `synthetic_aniso_rgb.bsdf` (4
phi_i x 8 theta_i slices) on its matball.

- one bounce (`_bounce_body`) in gt mode at depths 0 and 1, fed the random
  numbers JAX draws from its keys inside `_bounce_program` (the pattern of
  tests/test_torch_integrator.py), held to that file's shares: the alive
  flags differ on at most 0.1% of rays, and ro, rd, L, beta and prev_pdf
  agree to 1e-3 relative (1e-5 absolute) on at least 99.5% of the rays whose
  flags agree (the 4-slice blend, like the 2-slice one, can move an inverse
  CDF across a cell on a 1-ulp difference);
- `cli/render.py --material synthetic_aniso_rgb` on the CPU at 64 x 48: a
  finite, non-black image, written as EXR and PNG;
- `cli/train.py`'s target density on the anisotropic material.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os

import jax
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu.render import integrator as ji
from bsdf_diffusion_sampling_tpu.render import scene as jscene
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.cli import render as cli
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render import scene as tscene

from _torch_port import tt

W, H = 32, 24
MAX_DISCRETE = 1e-3
MIN_CONTINUOUS = 0.995


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aniso_render"))
    path = procedural.write_scene(d, n_lat=16, n_lon=24, plane_g=3, env_res=(32, 64), width=W, height=H,
                                  lights=[(2.0, 4.0, 3.0, 10.0, 9.0, 8.0)], anisotropic=True)
    bsdf = os.path.join(d, procedural.ANISO_MATERIAL + ".bsdf")
    return dict(dir=d, path=path, js=jscene.load_scene(path, width=W, height=H, wide=False),
                ts=tscene.load_scene(path, device="cpu", width=W, height=H), jb=jme.load_measured(bsdf),
                tb=tme.load_measured(bsdf, device="cpu"))


def _jax_randoms(k_path, depth, n):
    """What the JAX `_bounce_body` draws from its key at this depth for a
    measured ball (tests/test_torch_integrator.py::_jax_randoms, gt)."""
    k_nee, k_bsdf, k_rr = jax.random.split(jax.random.fold_in(k_path, depth), 3)
    keys = jax.random.split(k_bsdf, 2)
    ball = jax.random.uniform(keys[1], (n, 2), minval=1e-6, maxval=1.0 - 1e-6)
    return ti.BounceRandoms(tt(jax.random.uniform(k_nee, (n, 2))), tt(jax.random.uniform(keys[0], (n, 2))),
                            (tt(ball),), tt(jax.random.uniform(k_rr, (n,))))


def test_aniso_bounce_matches_jax(world):
    js, ts = world["js"], world["ts"]
    assert world["tb"].phi_i_grid.shape == (procedural.ANISO_PHI,) and world["jb"].phi_i_grid is not None
    jmb, tmb = ji.measured_matball(world["jb"]), ti.measured_matball(world["tb"])
    state, k_path = ji._init_wavefront(js.camera.vectors, jax.random.key(0), 0, width=W, height=H, spp_chunk=4,
                                       rows=H)
    n = state[0].shape[0]
    flips, bad, rows_seen, alive = 0, np.zeros(7), np.zeros(7), []
    for depth in range(2):
        jout = ji._bounce_program(js.bvh, js.envmap, js.lights, state, k_path, depth, matball=(jmb,))
        tout, truncated = ti._bounce_body(ts.accel, ts.envmap, ts.lights,
                                          tuple(torch.from_numpy(np.array(x)) for x in state),
                                          _jax_randoms(k_path, depth, n), depth, matball=(tmb,))
        assert not bool(truncated)
        ja, ta = np.asarray(jout[5]), tout[5].numpy()
        flips += int((ja != ta).sum())
        for i in (0, 1, 3, 4, 6):  # ro, rd, L, beta, prev_pdf
            a, b = tout[i].numpy().reshape(n, -1), np.asarray(jout[i]).reshape(n, -1)
            rows = (ja == ta) & (ja if i != 3 else True)
            bad[i] += (rows & ~np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)).sum()
            rows_seen[i] += rows.sum()
        alive.append(int(ja.sum()))
        state = jout
    assert flips <= MAX_DISCRETE * 2 * n
    assert (bad <= (1.0 - MIN_CONTINUOUS) * rows_seen).all(), (bad, rows_seen)
    assert alive[0] > n // 3 and alive[1] > 0


def test_cli_renders_the_aniso_material_on_the_cpu(world, tmp_path):
    out = str(tmp_path / procedural.ANISO_MATERIAL)
    img, _ = cli.main(["--scene", world["path"], "--bsdf-dir", world["dir"], "--material", procedural.ANISO_MATERIAL,
                       "--mode", "gt", "--spp", "4", "--width", "64", "--height", "48", "--max-depth", "2",
                       "--device", "cpu", "--out", out])
    assert img.shape == (48, 64, 3) and np.isfinite(img).all() and img.max() > 0
    assert os.path.getsize(out + ".exr") > 0 and os.path.getsize(out + ".png") > 0


def test_training_target_reads_the_aniso_material(world):
    """`cli/train.py --material synthetic_aniso_rgb --bsdf-dir <dir>`'s
    target density: finite, nonnegative, and positive over the disk."""
    from bsdf_diffusion_sampling_tpu_torch.cli import train as train_cli

    args = train_cli.build_parser().parse_args(["--domain", "disk", "--material", procedural.ANISO_MATERIAL,
                                                "--bsdf-dir", world["dir"], "--device", "cpu"])
    f = train_cli.make_target_pdf(args, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    wi = (torch.rand((512, 2), generator=g) - 0.5) * 1.2
    wo = (torch.rand((512, 2), generator=g) - 0.5) * 1.2
    v = f(wi, wo)
    assert v.shape == (512,) and bool(torch.isfinite(v).all()) and bool((v >= 0).all()) and float(v.mean()) > 0
