"""Optimizer builders.

``torch.optim.Adam(weight_decay=wd)`` folds the L2 penalty into the gradient
BEFORE the adaptive rescaling (coupled L2). That is the rule the JAX
package reproduces with ``add_decayed_weights`` + ``scale_by_adam``; the
decoupled AdamW form shrinks phi too aggressively once gradients are small.

On the card the optimizers are capturable: the step count lives on the
device and the bias corrections are computed there, so a step can be
recorded into a CUDA graph (``utils.graphs.StepGraph``) and replayed.
"""

from __future__ import annotations

import torch


def torch_adam(params, lr: float | torch.Tensor, weight_decay: float = 0.0,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               capturable: bool | None = None) -> torch.optim.Adam:
    """Adam with coupled L2: grad += wd * w, then Adam scaling.

    ``capturable`` None means: capturable exactly when the parameters are
    CUDA tensors (PyTorch refuses it on the CPU). ``lr`` may be a 0-dim
    tensor on the parameters' device when capturable, so that a scheduler
    can change it between graph replays."""
    params = list(params)
    if capturable is None:
        capturable = bool(params) and all(
            (p["params"][0] if isinstance(p, dict) else p).is_cuda for p in params)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay, capturable=capturable)


def init_adam_state(opt: torch.optim.Adam) -> torch.optim.Adam:
    """Create the state Adam makes lazily at its first step (step 0, zero
    moments), for every parameter that has none: the values are the lazy
    ones, but they exist before a step is captured, so a graph records
    updates of them and not their creation. The step count sits on the
    parameter's device when the group is capturable, on the CPU
    otherwise, as in ``torch.optim.Adam``."""
    for group in opt.param_groups:
        on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            state = opt.state[p]
            if len(state) == 0:
                state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                                 if on_device else torch.tensor(0.0, dtype=torch.float32))
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                if group["amsgrad"]:
                    state["max_exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
    return opt
