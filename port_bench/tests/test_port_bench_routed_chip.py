"""On the card: the routed K4 draw (`sph_draw_routed_kernel`) and K2s query
(`sph_query_routed_kernel`) held to K4's and K2s's gates, on every routed
row:

- the rows of the 12-ball table array's first bounce at 512 x 512 x 8
  (2^21 camera rays, routed by the ball each hits, as the integrator
  routes them), and a routing of empty and one-row segments beside full
  ones;
- the draw: x0 bit-equal to K4 launched over the whole wavefront with the
  ball's seed on at least 99.9% of the ball's rows; x and pdf against the
  plain transport from the kernel's own x0 (x 2e-5 absolute, pdf 2e-4
  relative);
- the query, at the draws' end points: x0 and pdf against the plain
  Newton inverse (2e-5, 2e-4);
- the build: no spill stores or loads, registers and blocks an SM as K4's
  and K2s's, and each kernel's HMMA count as theirs.

`python -m pytest port_bench/tests -q -m chip`; skips without a card.
"""

import os
import re
import shutil
import subprocess
import tempfile

import pytest
import torch

TOL_X, TOL_PDF, MIN_BIT_EQUAL = 2e-5, 2e-4, 0.999

pytestmark = pytest.mark.chip


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _nets(seed, device):
    from port_bench.harness import weights
    from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo

    w = weights.make(seed, {"base": ("base", None), "v": ("velocity", weights.velocity_dims(32, 4, 3))}, device)
    return fo.prepack_spherical(w["v"], {"net": w["base"]})


def _array_routing(device):
    """(ball of each of 2^21 camera rays or -1, their local incident
    directions) at the array's first bounce."""
    from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
    from bsdf_diffusion_sampling_tpu_torch.render import procedural
    from bsdf_diffusion_sampling_tpu_torch.render.lambert import make_frame, to_local
    from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene

    d = tempfile.mkdtemp()
    try:
        path = procedural.write_array_scene(d, kind="table", point_light=procedural.ARRAY_LIGHT)
        sc = load_scene(path, device=device, width=512, height=512)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gen = torch.Generator(device=device).manual_seed(3)
    n = 512 * 512 * 8
    ro, rd, *_ = ti._init_wavefront(sc.camera.vectors.to(device), ti._uniform(gen, (n, 2), 1e-7, 1.0), width=512,
                                    height=512, spp_chunk=8)
    hit = ti._isect(sc.accel, ro, rd, torch.ones(n, dtype=torch.bool, device=device))
    a = sc.accel.attr_rows[hit.prim]
    u, v = hit.u[:, None], hit.v[:, None]
    nrm = torch.nn.functional.normalize((1 - u - v) * a[:, 0:3] + u * a[:, 3:6] + v * a[:, 6:9], dim=-1)
    t, bt = make_frame(nrm)
    wi = to_local(nrm, t, bt, -rd)
    ball = torch.where((hit.t < 1e29) & (wi[:, 2] > 0), a[:, 15].long() - ti.MAT_BALL, -1)
    return torch.where(ball >= 0, ball, -1), wi


def _check(group, wi, packs, device, label) -> dict:
    """The worst gaps of the routed draw and query over every routed row
    (`x`, `pdf`: the draw; `qx0`, `qpdf`: the query), held to the gates;
    `bit_equal` the least share of a ball's draws equal to K4's."""
    from bsdf_diffusion_sampling_tpu_torch.geometry.coords import cart_to_spher
    from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
    from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
    from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo
    from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti

    cond = encode_condition(cart_to_spher(wi), ModelConfig(domain="sphere_full", velocity_hidden=32,
                                                           velocity_layers=4)).contiguous()
    rt = ti.route_rows(group, len(packs))
    sw = fo.stack_packed(packs)
    seeds = torch.randint(0, 2 ** 62, (len(packs),), dtype=torch.int64, device=device)
    row0 = 2 ** 20 + 37
    cs = rt.gather(cond)
    x, pdf, x0 = fo.fused_sample_pdf_spherical_routed(sw, cs, rt.slot_row + row0, rt.tile_ball, seeds, 8)
    qpdf, qx0 = fo.fused_pdf_spherical_routed(sw, x, cs, rt.tile_ball, 8, newton_iters=2)
    worst = {"x": 0.0, "pdf": 0.0, "qx0": 0.0, "qpdf": 0.0, "bit_equal": 1.0, "rows": 0}
    for b, p in enumerate(packs):
        rows = torch.nonzero(group == b)[:, 0]
        if rows.numel() == 0:
            continue
        s = rt.dest[rows]
        whole = fo.fused_sample_pdf_spherical(p, cond, 8, seed=seeds[b:b + 1], row0=row0)
        eq = (x0[s] == whole[2][rows]).all(-1).float().mean().item()
        xp, pdfp, _ = fo.sample_pdf_spherical_plain(p, cond[rows], 8, x0=x0[s])
        qp, qx0p = fo.pdf_spherical_plain(p, x[s], cond[rows], 8, newton_iters=2)
        rel = lambda a, w: ((a - w).abs() / w.abs().clamp(min=1e-30)).max().item()  # noqa: E731
        worst = {"x": max(worst["x"], (x[s] - xp).abs().max().item()), "pdf": max(worst["pdf"], rel(pdf[s], pdfp)),
                 "qx0": max(worst["qx0"], (qx0[s] - qx0p).abs().max().item()),
                 "qpdf": max(worst["qpdf"], rel(qpdf[s], qp)), "bit_equal": min(worst["bit_equal"], eq),
                 "rows": worst["rows"] + rows.numel()}
    print(f"{label}: {worst}")
    assert worst["rows"] == int((group >= 0).sum())
    assert worst["x"] <= TOL_X and worst["qx0"] <= TOL_X
    assert worst["pdf"] <= TOL_PDF and worst["qpdf"] <= TOL_PDF
    assert worst["bit_equal"] >= MIN_BIT_EQUAL
    for t in (x, pdf, qpdf):
        assert bool(torch.isfinite(t[rt.dest[group >= 0]]).all())
    return worst


def test_routed_kernels_on_the_array_routing():
    dev = _card()
    group, wi = _array_routing(dev)
    counts = torch.bincount(group[group >= 0], minlength=12).tolist()
    print(f"rows a ball: {counts} of {group.numel()}")
    assert min(counts) > 1000
    _check(group, wi, [_nets(500 + b, dev) for b in range(12)], dev, "array routing")


def test_routed_kernels_on_empty_and_one_row_segments():
    dev = _card()
    sizes = [0, 1, 127, 128, 129, 0, 1, 5000, 0]
    group = torch.cat([torch.full((k,), b) for b, k in enumerate(sizes)] + [torch.full((999,), -1)]).to(dev)
    group = group[torch.randperm(group.numel(), device=dev)]
    wi = torch.nn.functional.normalize(torch.randn(group.numel(), 3, device=dev), dim=-1)
    wi[:, 2] = wi[:, 2].abs() + 0.05
    _check(group, torch.nn.functional.normalize(wi, dim=-1), [_nets(700 + b, dev) for b in range(len(sizes))],
           dev, "segments")


def test_routed_kernels_build_like_k4_and_k2s():
    _card()
    from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build
    from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo

    res = fo.kernel_resources()
    for routed, plain in (("K4 routed", "K4 philox"), ("K2s routed", "K2s")):
        print(f"{routed}: {res[routed]}; {plain}: {res[plain]}")
        assert res[routed]["blocks_per_sm"] == res[plain]["blocks_per_sm"]
        assert res[routed]["registers"] <= res[plain]["registers"] + 8
    lib = cuda_build.build(["fused_sph.cu"])["fused_sph.cu"]
    log = lib.with_suffix(".log").read_text()
    spills = dict(re.findall(r"Function properties for (\S+)\n.*?(\d+) bytes spill stores", log))
    for fn, stores in spills.items():
        assert int(stores) == 0, (fn, stores)
    sass = subprocess.run([os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            hmma[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", line):
            hmma[fn] += 1
    of = lambda frag: [v for k, v in hmma.items() if frag in k]  # noqa: E731
    print({k: v for k, v in hmma.items()})
    assert of("sph_draw_routed_kernel") == [of("sample_pdf_sph_kernelILb1E")[0]]
    assert of("sph_query_routed_kernel") == of("14pdf_sph_kernel")
