"""Entry points: the Wasserstein gradient flow and the registration trainer."""

from .config import TrainConfig, config_from_dict  # noqa: F401
from .flow_driver import FlowConfig, FlowResult, run_flow  # noqa: F401
from .trainer import Trainer, TrainState, build_criterion  # noqa: F401
