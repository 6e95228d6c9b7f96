"""Multi-process execution on `torch.distributed`: the data mesh, its
collectives and the process group's wiring."""

from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicate,
    replicated_sharding,
    shard_batch,
)
from bsdf_diffusion_sampling_tpu_torch.parallel.distributed import (  # noqa: F401
    global_batch_slice,
    host_fold,
    init_distributed,
)
