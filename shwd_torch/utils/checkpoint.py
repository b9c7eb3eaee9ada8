"""Checkpointing: the whole train state in one file, written atomically.

Counterpart of ``shwd_tpu/utils/checkpoint.py``. A checkpoint holds the
model, its Adam state, and the criterion state (phi with its spectral-norm
buffers, phi's Adam state, lam, strikes) plus the epoch. The port's modules
and optimizers are updated in place, so a "best so far" snapshot must be a
copy: ``state_payload`` clones every tensor on its device, and the trainer
writes such payloads later. Files are written to a temporary name and
moved onto the target with ``os.replace``, so a killed run never leaves
half a checkpoint.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Tuple

import torch


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


def state_payload(state: Any) -> dict:
    """A copy of everything ``state`` (a ``TrainState``) carries, as plain
    dictionaries of cloned tensors on their device."""
    payload = {"model": _clone(state.model.state_dict()),
               "opt": _clone(state.opt.state_dict()),
               "crit": None}
    crit = state.crit_state
    if crit is not None:
        payload["crit"] = {"phi": _clone(crit.phi.state_dict()),
                           "opt": _clone(crit.opt.state_dict()),
                           "lam": float(crit.lam),
                           "strikes": int(crit.strikes)}
    return payload


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
        crit.phi.load_state_dict(payload["crit"]["phi"])
        crit.opt.load_state_dict(payload["crit"]["opt"])
        crit.lam = payload["crit"]["lam"]
        crit.strikes = payload["crit"]["strikes"]
    state.epoch = int(payload["epoch"])
    return state, state.epoch
