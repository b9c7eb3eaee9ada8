"""Typed experiment configuration.

Counterpart of ``shwd_tpu/train/config.py``: one dataclass with the same
fields and defaults, serialized as JSON next to every checkpoint. A
``config.json`` written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from ..data.dataset import DatasetConfig
from ..data.transforms import TransformConfig
from ..losses.shwd import SHWDConfig
from ..losses.ssw_loss import MaxSSWConfig
from ..losses.transport import TransportConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # experiment identity
    experiment: str = "experiment"
    log_dir: str = "log"

    # criterion: 'w_cos' (flagship SHWD) | 'cd' (chamfer) | 'pseudo_w_cos'
    #            | 'w1_cos' (p=1) | 'sinkhorn' | 'max_ssw'
    criterion: str = "w_cos"

    # data
    dataset: DatasetConfig = DatasetConfig()

    # optimization
    num_epochs: int = 200
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1.4096013153858628e-08

    # model
    pcr_iteration_num: int = 3

    # Best-checkpoint snapshots are copies kept on the device and written
    # to disk every this-many epochs, on any exit from the epoch loop
    # (incl. exceptions/KeyboardInterrupt via try/finally), and always at
    # the end of fit. 0 = end-of-fit only.
    checkpoint_flush_every: int = 50

    # Optional 4th best-checkpoint family: min over epochs of
    # (rot_error + w * trans_error) on the val pass. 0 disables; 100 weighs
    # 0.01 translation error as 1 degree.
    checkpoint_combined_weight: float = 0.0

    # phi / SHWD
    shwd: SHWDConfig = SHWDConfig(
        transport=TransportConfig(cost="lp", p=2.0, solver="sinkhorn"),
        max_iter=1,
        lam=1.3111961119405346e-05,
        phi_lr=9.213233310357477e-05,
        phi_weight_decay=1.4096013153858628e-08,
    )
    flow_name: str = "Residual"
    phi_num_flow_layer: int = 3
    pseudo_phi_num: int = 2
    pseudo_combine: str = "max"

    # max_ssw criterion; the chart is 'mlp' | 'encoder_flow'
    max_ssw: MaxSSWConfig = MaxSSWConfig(
        num_projections=100, max_iter=1, phi_lr=9.213233310357477e-05)
    max_ssw_chart: str = "mlp"

    # sinkhorn baseline knobs
    sinkhorn_eps: float = 0.01
    sinkhorn_iter: int = 100

    seed: int = 1234
    load_model: Optional[str] = None

    # NaN forensics: on a non-finite train loss, dump the offending batch +
    # the pre-step train state to <log_dir>/<experiment>/nan_dump/ and
    # raise. Reads the loss on the host every step.
    nan_guard: bool = False

    # Fused execution. The JAX package runs an epoch as one jitted scan; the
    # port captures one train step and one eval step per batch shape as CUDA
    # graphs and replays them per batch (on the CPU the same static-buffer
    # path runs without capture). Off, or with nan_guard, the exact solver,
    # SHWD's refresh or a mesh, every step is dispatched op by op
    # (Trainer.execution_path).
    fused_epoch: bool = True

    # parallel: data-parallel ranks over mesh_data, replicas over
    # mesh_slices (parallel.mesh); None and 1 are the single-device default
    mesh_data: Optional[int] = None
    mesh_slices: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: str | Path) -> "TrainConfig":
        raw = json.loads(Path(path).read_text())
        return config_from_dict(raw)


_NESTED = {"dataset": DatasetConfig, "transform": TransformConfig,
           "shwd": SHWDConfig, "transport": TransportConfig,
           "max_ssw": MaxSSWConfig}


def _build(cls, raw: dict) -> Any:
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in raw.items():
        if k not in fields:
            continue
        if isinstance(v, dict):
            sub = _NESTED.get(k)
            kwargs[k] = _build(sub, v) if sub else v
        elif isinstance(v, list) and isinstance(fields[k].default, tuple):
            kwargs[k] = tuple(v)   # json round-trips tuples as lists
        else:
            kwargs[k] = v
    return cls(**kwargs)


def config_from_dict(raw: dict) -> TrainConfig:
    return _build(TrainConfig, raw)
