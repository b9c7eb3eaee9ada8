"""Checkpointing: the whole train state in one file, written atomically.

Counterpart of ``shwd_tpu/utils/checkpoint.py``. A checkpoint holds the
model, its Adam state, the criterion state and the epoch. A criterion
state is a dataclass (``SHWDState``, ``PseudoSHWDState``, ``MaxSSWState``);
each field is saved by its kind: a module (phi, the pseudo flows, the
chart, with their spectral-norm buffers) and an optimizer by their state
dicts, a ``torch.Generator`` by its state (so a resumed run draws the
frames and refreshes an uninterrupted one would), a tensor (SHWD's 0-dim
lam) as a copy, numbers as they are. The JAX package's states carry their
key the same way. Loading writes into the state's tensors in place (a
module's parameters, lam) or replaces an optimizer's state through
``load_state_dict``, which puts a capturable Adam's step count on the
parameters' device; a CUDA graph captured before a load is stale, so the
trainer captures its steps after it. The port's modules
and optimizers are updated in place, so a "best so far" snapshot must be a
copy: ``state_payload`` clones every tensor on its device, and the trainer
writes such payloads later. Files are written to a temporary name and
moved onto the target with ``os.replace``, so a killed run never leaves
half a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Tuple

import torch
from torch import nn


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _crit_payload(crit: Any) -> dict:
    out = {"kind": type(crit).__name__}
    for f in dataclasses.fields(crit):
        v = getattr(crit, f.name)
        if isinstance(v, (nn.Module, torch.optim.Optimizer)):
            v = _clone(v.state_dict())
        elif isinstance(v, torch.Generator):
            v = v.get_state()
        elif isinstance(v, torch.Tensor):   # lam, updated in place
            v = v.detach().clone()
        out[f.name] = v
    return out


def _load_crit(crit: Any, saved: dict) -> None:
    kind = saved.get("kind", "SHWDState")   # files written before the kind
    if kind != type(crit).__name__:
        raise ValueError(f"checkpoint holds a {kind}, the state is a "
                         f"{type(crit).__name__} (another criterion?)")
    for f in dataclasses.fields(crit):
        if f.name not in saved:     # e.g. no generator in an older file
            continue
        v, cur = saved[f.name], getattr(crit, f.name)
        if isinstance(cur, (nn.Module, torch.optim.Optimizer)):
            cur.load_state_dict(v)
        elif isinstance(cur, torch.Generator):
            cur.set_state(v)
        elif isinstance(cur, torch.Tensor):     # lam (a number in older files)
            with torch.no_grad():
                cur.copy_(torch.as_tensor(v, dtype=cur.dtype))
        elif not isinstance(v, torch.Tensor):   # strikes
            setattr(crit, f.name, v)


def state_payload(state: Any) -> dict:
    """A copy of everything ``state`` (a ``TrainState``) carries, as plain
    dictionaries of cloned tensors on their device."""
    crit = state.crit_state
    return {"model": _clone(state.model.state_dict()),
            "opt": _clone(state.opt.state_dict()),
            "crit": None if crit is None else _crit_payload(crit)}


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def save_checkpoint(path: str | Path, state: Any, epoch: int) -> None:
    """Write ``<path>.pt`` (the payload) and ``<path>.json`` (the epoch).
    ``state`` is a ``TrainState`` or a payload from ``state_payload``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = state if isinstance(state, dict) else state_payload(state)
    payload = {**_to_cpu(payload), "epoch": int(epoch)}
    _atomic_write(Path(str(path) + ".pt"), lambda p: torch.save(payload, p))
    _atomic_write(Path(str(path) + ".json"),
                  lambda p: p.write_text(json.dumps({"epoch": int(epoch)})))


def load_checkpoint(path: str | Path, state: Any) -> Tuple[Any, int]:
    """Restore a checkpoint into ``state`` in place (same structure);
    returns (state, epoch)."""
    path = str(path)
    if path.endswith(".pt"):
        path = path[:-3]
    payload = torch.load(path + ".pt", map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.opt.load_state_dict(payload["opt"])
    crit = state.crit_state
    if (crit is None) != (payload["crit"] is None):
        raise ValueError("checkpoint and state disagree on the criterion "
                         "state (another criterion?)")
    if crit is not None:
        _load_crit(crit, payload["crit"])
    state.epoch = int(payload["epoch"])
    return state, state.epoch
