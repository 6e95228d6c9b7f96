from bsdf_diffusion_sampling_tpu_torch.models.base_density import (  # noqa: F401
    DISK_BASE,
    SPHERICAL_BASE,
    get_base,
)
from bsdf_diffusion_sampling_tpu_torch.models.encoding import positional_encoding  # noqa: F401
from bsdf_diffusion_sampling_tpu_torch.models.mlp import init_mlp, mlp_apply  # noqa: F401
from bsdf_diffusion_sampling_tpu_torch.models.velocity import (  # noqa: F401
    encode_condition,
    velocity_apply,
    velocity_init,
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
