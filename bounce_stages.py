#!/usr/bin/env python3
"""Stage times of one render bounce of the neural-sphere matball with K3's
reverse-Euler pdf, for the port in the working directory.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 bounce_stages.py
    cd OTHER_CHECKOUT && python3 /path/to/bounce_stages.py

It imports the working directory's `chip_smoke.py` and package, not its own
directory's, and calls that checkout's `bounce_breakdown` on the table
scene at the render's 2^20-ray wavefront (depth 1, CUDA events, median of
7), with the weights `chip_smoke.py` makes from its seed. So two versions of
the port can be timed on this stage breakdown in one session, the older
one having no such phase of its own.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("bounce_stages: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = cs.init_weights(cs.SEED + 100, cs.SPH_CFG, cs.TEACHER_CFG)
    with tempfile.TemporaryDirectory() as d:
        xml = cs.write_scene(d, width=cs.RENDER_RES, height=cs.RENDER_RES, spp=cs.TABLE_SPP,
                             max_depth=cs.RENDER_DEPTH, table=cs.TABLE)
        scene = cs.load_scene(xml, device=device)
        nb = cs.make_neural_bsdf("sphere_full", cs.SPH_CFG, tree["rectified"], tree["base"],
                                 sampler_cfg=cs.SamplerConfig(pdf_exact=False), device=device)
        mb = cs.neural_matball_sphere(nb, cs.BSDF_MATERIALS[cs.TABLE[0]], cs.TABLE[1])
        (_, counts) = cs.counted(lambda: cs.bounce_breakdown("neural-sphere K3", scene, mb, device))
    print(f"launches: {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
