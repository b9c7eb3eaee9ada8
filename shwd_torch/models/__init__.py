"""Registration models: PointNet encoder + iterative PCRNet."""

from .pointnet import PointNet, max_pool  # noqa: F401
from .pcrnet import PCRNet, PCRNetOutput  # noqa: F401
