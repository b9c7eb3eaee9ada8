"""Scaling-efficiency harness: clouds/s at 1 / 2 / ... / D ranks.

Counterpart of ``shwd_tpu/parallel/scaling.py``. It runs the full W_COS
training step (PCRNet + adversarial SHWD criterion on the ``ssw`` solver +
the Adam update, with the gradients averaged over the ranks) over meshes of
growing size with the per-rank batch held constant (weak scaling: more
devices, more clouds), and reports

    efficiency(D) = (clouds/s at D ranks) / (D * clouds/s at 1 rank)

Every rank of the world calls ``measure_scaling``; a mesh of D ranks takes
the first D, and the others wait. On CPU processes that share cores the
ranks slow each other down, so only the structure is meaningful there; run
it with one process per card (``torchrun --nproc-per-node <cards> -m
shwd_torch.parallel.scaling``) for real numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from . import mesh as _mesh


@dataclasses.dataclass
class ScalingPoint:
    devices: int
    clouds_per_second: float
    step_seconds: float
    efficiency: float
    # clouds/s at D ranks over clouds/s at 1: the weak-scaling speedup
    # (ideal = D on separate cards; about 1.0 for CPU processes that share
    # the same cores)
    throughput_ratio: float = 1.0


def _wcos_step(mesh, per_device_batch: int, n_points: int,
               num_projections: int, device):
    """(step(), global batch size) for the W_COS train step on ``mesh``."""
    from ..data.dataset import DatasetConfig
    from ..data.transforms import RegistrationBatch
    from ..losses import SHWDConfig, TransportConfig
    from ..train import TrainConfig, Trainer

    batch = per_device_batch * _mesh.axis_size(mesh, "data")
    cfg = TrainConfig(
        criterion="w_cos",
        dataset=DatasetConfig(source_point_num=n_points,
                              target_point_num=n_points),
        batch_size=batch, pcr_iteration_num=2,
        shwd=SHWDConfig(
            transport=TransportConfig(cost="geodesic", p=2.0, solver="ssw",
                                      num_projections=num_projections),
            max_iter=1, lam=1e-4, phi_lr=1e-4),
        phi_num_flow_layer=1)
    trainer = Trainer(cfg, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    to = (lambda a: torch.as_tensor(a.astype(np.float32), device=device))
    raw = RegistrationBatch(
        target=to(rng.normal(size=(batch, n_points, 3))),
        source=to(rng.normal(size=(batch, n_points, 3))),
        igt_rotation=to(np.broadcast_to(np.eye(3), (batch, 3, 3))),
        igt_translation=to(np.zeros((batch, 3))))
    rows = trainer._rows(raw)

    def step():
        with _mesh.data_parallel(trainer._data_group):
            return trainer._train_step(state, rows)

    return step, batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(device_counts: Optional[Sequence[int]] = None,
                    per_device_batch: int = 8, n_points: int = 64,
                    num_projections: int = 32, steps: int = 5,
                    verbose: bool = True,
                    device: str | torch.device | None = None) -> list[ScalingPoint]:
    """Weak-scaling sweep over mesh sizes (all ranks on ``data``). Runs on
    the card unless ``device`` names the CPU; every rank returns the same
    points."""
    dev = resolve_device(device)
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= _mesh.world_size()]
    points: list[ScalingPoint] = []
    base_rate = None
    for d in device_counts:
        mesh = _mesh.make_mesh(data=d, slices=1, device=dev, ranks=range(d))
        timing = None
        if mesh is not None:
            step, total_batch = _wcos_step(mesh, per_device_batch, n_points,
                                           num_projections, dev)
            step()                                  # warm-up: builds, loads
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = step()
            float(loss)
            _sync(dev)
            timing = [(time.perf_counter() - t0) / steps, total_batch]
        if dist.get_world_size() > 1:               # rank 0's clock for all
            box = [timing]
            dist.broadcast_object_list(box, src=0)
            timing = box[0]
        dt, total_batch = timing
        rate = total_batch / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d / device_counts[0])
        points.append(ScalingPoint(d, rate, dt, eff, rate / base_rate))
        if verbose and dist.get_rank() == 0:
            print(f"devices={d:3d}  batch={total_batch:4d}  "
                  f"{rate:10.1f} clouds/s  step={dt*1e3:7.2f} ms  "
                  f"efficiency={eff:.2%}  throughput x{rate/base_rate:.2f}")
    return points


if __name__ == "__main__":
    import json

    _mesh.initialize_distributed()
    pts = measure_scaling()
    if dist.get_rank() == 0:
        print(json.dumps([dataclasses.asdict(p) for p in pts]))
    dist.destroy_process_group()
