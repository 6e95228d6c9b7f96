"""Render CLI, counterpart of the JAX package's `cli/render.py`.

Loads a matpreview-style scene, installs the matball material (ground-truth
measured sampling, or a neural disk sampler from a checkpoint), renders spp
samples in accumulation passes on the card (or the CPU with
`--device cpu`), writes EXR + PNG and prints the wall-clock time.

  python -m bsdf_diffusion_sampling_tpu_torch.cli.render \\
      --scene scene_measured.xml --bsdf-dir bsdfs --material chm_mint_rgb --mode gt --out out/gt
  python -m bsdf_diffusion_sampling_tpu_torch.cli.render \\
      --scene scene_measured.xml --bsdf-dir bsdfs --material chm_mint_rgb --mode neural-disk \\
      --checkpoint checkpoints/chm_mint_disk/final.npz --out out/nn

The spherical modes, `--weights reference` and `--allow-substitute` of the
JAX CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import struct
import time
import zlib

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", required=True, help="a matpreview-style scene XML")
    p.add_argument("--material", default="chm_mint_rgb", help="the matball's <material>.bsdf file")
    p.add_argument("--bsdf-dir", required=True, help="the directory of the .bsdf files")
    p.add_argument("--mode", choices=["gt", "neural-disk"], default="gt",
                   help="gt: measured sampling; neural-disk: the trained disk sampler")
    p.add_argument("--checkpoint", default="", help="an .npz checkpoint (neural-disk)")
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--spp-chunk", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out/render")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def tonemap_srgb(img: np.ndarray) -> np.ndarray:
    lo = img <= 0.0031308
    srgb = np.where(lo, img * 12.92, 1.055 * np.power(np.clip(img, 1e-8, None), 1 / 2.4) - 0.055)
    return np.clip(srgb, 0.0, 1.0)


def write_png(path: str, rgb8: np.ndarray) -> None:
    """An 8-bit RGB PNG with zlib and struct alone."""
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(rgb8, np.uint8).reshape(h, 3 * w)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def build_matball(ball: dict, args, device):
    """One MatballFns for the scene's measured mybsdf hook."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured
    from bsdf_diffusion_sampling_tpu_torch.render.integrator import measured_matball, neural_matball

    if ball["idx"] >= 0:
        raise NotImplementedError("material-table (principled) matballs are not ported yet")
    brdf = load_measured(os.path.join(args.bsdf_dir, ball["filename"] + ".bsdf"), device=device)
    if args.mode == "gt":
        return measured_matball(brdf)

    from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
    from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf
    from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import load_pytree

    if not args.checkpoint:
        raise ValueError("--mode neural-disk needs --checkpoint")
    params, _ = load_pytree(args.checkpoint)
    nb = make_neural_bsdf("disk", ModelConfig(domain="disk"), params["rectified"], params["base"], brdf,
                          device=device)
    return neural_matball(nb)


def main(argv=None):
    """Render and write `<out>.exr` and `<out>.png`. Returns (image, the
    render's wall-clock seconds)."""
    args = build_parser().parse_args(argv)
    from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
    from bsdf_diffusion_sampling_tpu_torch.native.exr import write_exr
    from bsdf_diffusion_sampling_tpu_torch.render.integrator import render
    from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene

    device = resolve_device(args.device)
    scene = load_scene(args.scene, device=device, width=args.width, height=args.height)
    balls = [dict(b) for b in scene.desc.matballs]
    if len(balls) == 1 and balls[0]["idx"] < 0:
        # single-measured-ball scenes render whatever --material says
        balls[0]["filename"] = args.material
    mb = tuple(build_matball(b, args, device) for b in balls)

    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    img = render(scene, mb, seed=args.seed, spp=args.spp, spp_chunk=args.spp_chunk, max_depth=args.max_depth,
                 device=device)
    dt = time.perf_counter() - t0
    n_rays = args.width * args.height * args.spp
    print(f"rendering time: {dt:.2f} s  ({n_rays / dt / 1e6:.3f} Mray-samples/s)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_exr(args.out + ".exr", img)
    write_png(args.out + ".png", (tonemap_srgb(img) * 255).astype(np.uint8))
    print(f"wrote {args.out}.exr / .png")
    return img, dt


if __name__ == "__main__":
    main()
