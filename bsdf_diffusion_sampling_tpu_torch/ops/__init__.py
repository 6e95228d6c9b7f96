"""The fused CUDA kernels, their plain versions, and their build."""

from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import fused_ode_transport  # noqa: F401
