from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base  # noqa: F401
from bsdf_diffusion_sampling_tpu_torch.models.velocity import (  # noqa: F401
    encode_condition,
    velocity_apply,
)
from bsdf_diffusion_sampling_tpu_torch.models.zoo import (  # noqa: F401
    gmm_disk_base,
    make_regressor,
    mixture_spherical_base,
    unet_apply,
    unet_init,
    velocity_pe_x_apply,
    velocity_pe_x_init,
)
