"""The parallel layer on torch.distributed: one process per device."""

from .mesh import (  # noqa: F401
    all_reduce, data_parallel, gather_rows, initialize_distributed, make_mesh,
    reduce_gradients, reduce_values, shard, shard_rows,
)
from .sharded_ops import (  # noqa: F401
    make_sharded_ssw, make_sharded_transport, sharded_refine_poses,
)
from .dist_sort import (  # noqa: F401
    make_points_mesh, dist_sort, dist_cumsum, dist_emd1d,
    dist_emd1d_circle, make_dist_ssw,
)
from .scaling import ScalingPoint, measure_scaling  # noqa: F401
