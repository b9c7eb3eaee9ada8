"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. The CPU is used only when asked for by name;
    asking for CUDA on a machine without it raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        disable_tf32()
    return dev


def disable_tf32() -> None:
    """Full-f32 products on the card: TF32 keeps ~3 digits, and the flow
    resolves cost differences of ~1e-6."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
