"""Transport distances and the SHWD criterion."""

from .shwd import SHWDConfig, SHWDLoss, SHWDState, sphere_regularizer  # noqa: F401
from .transport import TransportConfig, make_transport  # noqa: F401
