from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base  # noqa: F401
from bsdf_diffusion_sampling_tpu_torch.models.velocity import (  # noqa: F401
    encode_condition,
    velocity_apply,
)
