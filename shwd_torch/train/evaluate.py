"""Evaluation harness: pose errors and success-ratio curves on a split.

Counterpart of ``shwd_tpu/train/evaluate.py``: load a trained PCRNet, run
the test split, report the mean rotation and translation errors and the
success ratio against every threshold, and save snapshot clouds.

The per-sample errors do not depend on the threshold, so ONE pass over
the split collects them and each curve is a broadcast comparison against
its threshold grid (0..180 deg in steps of 1, 0..1.00 in steps of 0.01):
the same curve as one full pass per threshold (181 + 101 passes), which
``success_curves`` is checked against.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.dataset import RegistrationDataset
from ..data.transforms import RegistrationBatch
from ..models import PCRNet
from ..ops.quaternion import rotation_error_deg, translation_error
from ..utils.checkpoint import load_checkpoint
from ..utils.logging import RunLogger
from .config import TrainConfig
from .trainer import Trainer, _mean_subtract

ROT_THRESHOLDS = np.arange(0, 181, 1, dtype=np.float64)      # deg
TRANS_THRESHOLDS = np.arange(0, 1.01, 0.01)


@dataclasses.dataclass
class EvalResult:
    mean_rot_error: float
    mean_trans_error: float
    rot_thresholds: np.ndarray       # 0..180 deg
    rot_success_ratio: np.ndarray
    trans_thresholds: np.ndarray     # 0..1
    trans_success_ratio: np.ndarray
    per_sample_rot: np.ndarray
    per_sample_trans: np.ndarray


@torch.no_grad()
def errors_step(model: PCRNet, batch: RegistrationBatch, pcr_iteration_num: int):
    """Per-sample rotation error (deg), translation error and the
    transformed source of one batch, on the batch's device."""
    source, target, translation = _mean_subtract(batch)
    out = model(target, source, pcr_iteration_num)
    rot = rotation_error_deg(batch.igt_rotation, out.est_R)
    trans = translation_error(batch.igt_rotation, translation, out.est_t[:, 0, :])
    return rot, trans, out.transformed_source


def success_curves(errors: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Share of samples with error <= each threshold."""
    return (errors[None, :] <= thresholds[:, None]).mean(1)


def evaluate(cfg: TrainConfig, state=None, checkpoint: Optional[str] = None,
             split: str = "test", batch_size: Optional[int] = None,
             save_clouds_to: Optional[str] = None,
             device: str | torch.device | None = None) -> EvalResult:
    """The full evaluation of a ``TrainState`` or of a checkpoint written
    by the trainer, on the card unless ``device`` names the CPU. Batches
    are never dropped (a split smaller than the batch still evaluates);
    poses and noise are drawn from a generator seeded ``cfg.seed + 999``."""
    # one process evaluates the whole split, whatever mesh the run trained on
    trainer = Trainer(dataclasses.replace(cfg, mesh_data=None, mesh_slices=1),
                      device=device)
    dev = trainer.device
    if state is None:
        if not checkpoint:
            raise ValueError("evaluate needs a state or a checkpoint")
        state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
        state, _ = load_checkpoint(checkpoint, state)

    ds = RegistrationDataset(cfg.dataset, split, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 999)
    rots, transs, last = [], [], None
    for batch in ds.batches(gen, np.arange(len(ds)), batch_size or cfg.batch_size,
                            shuffle=False, drop_remainder=False):
        r, t, transformed = errors_step(state.model, batch, cfg.pcr_iteration_num)
        rots.append(r)
        transs.append(t)
        last = (batch, transformed)
    if last is None:
        raise ValueError(f"the {split!r} split is empty")
    # one copy to the host, after the whole pass
    rot = torch.cat(rots).cpu().numpy()
    trans = torch.cat(transs).cpu().numpy()

    result = EvalResult(
        mean_rot_error=float(rot.mean()),
        mean_trans_error=float(trans.mean()),
        rot_thresholds=ROT_THRESHOLDS,
        rot_success_ratio=success_curves(rot, ROT_THRESHOLDS),
        trans_thresholds=TRANS_THRESHOLDS,
        trans_success_ratio=success_curves(trans, TRANS_THRESHOLDS),
        per_sample_rot=rot,
        per_sample_trans=trans)

    if save_clouds_to:
        batch, transformed = last
        logger = RunLogger(save_clouds_to)
        try:
            logger.save_clouds("qualitative", initial_source=batch.source[0],
                               target=batch.target[0],
                               transformed_source=transformed[0])
        finally:
            logger.close()
        np.savez_compressed(
            Path(save_clouds_to) / "success_curves.npz",
            rot_thresholds=result.rot_thresholds,
            rot_success=result.rot_success_ratio,
            trans_thresholds=result.trans_thresholds,
            trans_success=result.trans_success_ratio)
    return result
