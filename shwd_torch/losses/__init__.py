"""Transport distances, the SHWD criterion and its pseudo and max-SSW
variants, and the baseline criteria."""

from .baselines import chamfer_criterion, make_sinkhorn_criterion  # noqa: F401
from .pseudo import PseudoSHWDConfig, PseudoSHWDLoss, PseudoSHWDState  # noqa: F401
from .shwd import SHWDConfig, SHWDLoss, SHWDState, sphere_regularizer  # noqa: F401
from .ssw_loss import MaxSSWConfig, MaxSSWLoss, MaxSSWState  # noqa: F401
from .transport import TransportConfig, make_transport  # noqa: F401
