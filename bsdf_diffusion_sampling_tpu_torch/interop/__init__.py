"""Weight carry-over: from the JAX package's parameter trees
(`jax_params`) and from the reference implementation's `.pth` checkpoints
(`torch_checkpoints`)."""

from bsdf_diffusion_sampling_tpu_torch.interop.torch_checkpoints import (  # noqa: F401
    base_from_state_dict,
    import_reference_material,
    load_state_dict,
    mlp_from_state_dict,
)
