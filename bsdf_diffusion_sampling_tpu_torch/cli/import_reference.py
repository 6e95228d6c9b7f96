"""Convert the reference implementation's `.pth` checkpoints into this
package's `.npz` format (counterpart of the JAX package's
`cli/import_reference.py`).

  python -m bsdf_diffusion_sampling_tpu_torch.cli.import_reference \\
      --checkpoints-root checkpoints_new --material chm_mint_rgb --domain disk \\
      --out checkpoints/chm_mint_disk/final.npz

The output is what `cli/train.py` writes as `final.npz` (step 0), so
`cli/render.py --mode neural-disk --checkpoint <out>` renders with the
reference's trained weights, and the JAX package's `load_pytree` reads it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--material", required=True, help="material name (the bare table index for sphere_full)")
    p.add_argument("--domain", choices=["disk", "spherical", "sphere_full"], required=True)
    p.add_argument("--checkpoints-root", required=True,
                   help="the directory that holds the <material>_<domain>/ checkpoint directories")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from bsdf_diffusion_sampling_tpu_torch.interop import import_reference_material
    from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import save_pytree

    tree = import_reference_material(args.checkpoints_root, args.material, args.domain, device=args.device)
    save_pytree(args.out, tree, step=0)
    print(f"imported {args.material} ({args.domain}) -> {args.out}")
    return tree


if __name__ == "__main__":
    main()
