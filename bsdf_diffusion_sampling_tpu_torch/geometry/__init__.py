"""Maps between the sampling domains and cartesian directions."""

from bsdf_diffusion_sampling_tpu_torch.geometry.coords import (  # noqa: F401
    cart_to_disk,
    cart_to_spher,
    disk_to_cart,
    spher_to_cart,
    wrap_angle,
)
from bsdf_diffusion_sampling_tpu_torch.geometry.sampling import (  # noqa: F401
    concentric_square_to_disk,
    stratified_disk,
    stratified_sampling_2d,
)
