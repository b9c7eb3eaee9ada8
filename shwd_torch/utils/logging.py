"""Run logging: jsonl metrics + a text log + cloud snapshots.

Counterpart of ``shwd_tpu/utils/logging.py``: a machine-readable
``metrics.jsonl`` is the source of truth; ``run.log`` keeps a
human-readable line per epoch; snapshots are .npz.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch


class RunLogger:
    def __init__(self, log_dir: str | Path):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self._text = open(self.dir / "run.log", "a")

    def log(self, row: Mapping[str, Any]) -> None:
        payload = {"time": time.time(), **row}
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()
        self._text.write(", ".join(f"{k}={v}" for k, v in row.items()) + "\n")
        self._text.flush()

    def cprint(self, text: str) -> None:
        print(text)
        self._text.write(text + "\n")
        self._text.flush()

    def save_clouds(self, name: str, **clouds) -> None:
        """Qualitative snapshot: stores the given clouds (e.g.
        initial/target/transformed) in one npz."""
        def to_np(v):
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
        np.savez_compressed(self.dir / f"{name}.npz",
                            **{k: to_np(v) for k, v in clouds.items()})

    def close(self) -> None:
        self._jsonl.close()
        self._text.close()
