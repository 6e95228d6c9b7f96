"""Assemble a render-ready final.npz from `cli/train.py`'s stage files
(counterpart of the JAX package's `cli/assemble_checkpoint.py`).

`cli/train.py` writes final.npz only when every stage completes; the stage
files (pretrain.npz, diffusion_simpler.npz, [diffusion_complex.npz],
rectify.npz) are whole training states saved every --save-every
iterations, by either package. This tool takes their params into the
{base, diffusion, teacher, rectified} tree `cli/render.py` reads: the way
back from a run killed mid-stage. Without rectify.npz the diffusion net
stands in as the sampler; without diffusion_complex.npz (disk) the student
is its own teacher.

  python -m bsdf_diffusion_sampling_tpu_torch.cli.assemble_checkpoint \\
      --dir checkpoints/chm_mint_disk [--domain disk] [--out final.npz]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--domain", default="disk", choices=["disk", "spherical", "sphere_full"])
    p.add_argument("--out", default="final.npz")
    args = p.parse_args(argv)

    from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
    from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import load_pytree, save_pytree

    want_in = ModelConfig(domain=args.domain).velocity_in_dim

    def load_params(name, velocity=True):
        tree, step = load_pytree(os.path.join(args.dir, name))
        params = tree["params"]
        if velocity and params[0]["w"].shape[0] != want_in:
            raise ValueError(f"{name}: a velocity net over {params[0]['w'].shape[0]} inputs, "
                             f"expected {want_in} for the {args.domain} domain")
        print(f"[{name}] step {step}")
        return params

    base_p = load_params("pretrain.npz", velocity=False)
    diff_p = load_params("diffusion_simpler.npz")
    teach_p = (load_params("diffusion_complex.npz") if os.path.exists(os.path.join(args.dir, "diffusion_complex.npz"))
               else diff_p)
    if os.path.exists(os.path.join(args.dir, "rectify.npz")):
        rect_p = load_params("rectify.npz")
    else:
        print("[rectify.npz] missing: the diffusion net stands in as the sampler")
        rect_p = diff_p
    out = os.path.join(args.dir, args.out)
    save_pytree(out, {"base": base_p, "diffusion": diff_p, "teacher": teach_p, "rectified": rect_p}, step=0)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
