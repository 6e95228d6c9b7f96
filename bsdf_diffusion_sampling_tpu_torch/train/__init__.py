"""Training: the losses, the three stages and their stage files, in the JAX
package's .npz format."""

from bsdf_diffusion_sampling_tpu_torch.train.losses import (  # noqa: F401
    flow_matching_mse,
    flow_matching_targets,
    linspace_alpha,
    pretrain_nll,
)
from bsdf_diffusion_sampling_tpu_torch.train.stages import (  # noqa: F401
    TrainState,
    init_state,
    make_diffusion_step,
    make_pretrain_step,
    make_rectify_pairgen,
    make_rectify_step,
    run_stage,
    train_material,
)
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint  # noqa: F401
