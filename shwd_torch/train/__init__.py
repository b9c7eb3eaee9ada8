"""Drivers: the Wasserstein gradient flow."""

from .flow_driver import FlowConfig, FlowResult, run_flow  # noqa: F401
