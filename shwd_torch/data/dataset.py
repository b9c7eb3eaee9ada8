"""Registration dataset: iteration, split, batching on the device.

Counterpart of ``shwd_tpu/data/dataset.py``. The cloud banks are loaded
with numpy and moved to the device once; each batch is gathered and
transformed there (``transforms.make_registration_batch``). Independent
source/target samplings (possibly different point counts) load two banks.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from .modelnet import load_dataset
from .transforms import RegistrationBatch, TransformConfig, make_registration_batch


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    source_point_num: int = 128
    target_point_num: int = 128
    transform: TransformConfig = TransformConfig()
    modelnet_root: Optional[str] = None
    cache_dir: str = "modelnet_cache"
    num_synthetic: int = 512
    # shape classes for the synthetic ModelNet stand-in. 'composite' =
    # chiral three-lobe objects; registration benchmarks need these, since
    # the symmetric primitives make ground-truth pose unrecoverable (a box
    # flipped 180 deg is the same cloud: the loss has two equal minima)
    synthetic_kinds: tuple = ("box", "ellipsoid", "cylinder", "cone")
    val_split: float = 0.2
    seed: int = 0


class RegistrationDataset:
    """Holds (M, N, 3) source and (M, M_pts, 3) target cloud banks on
    ``device`` (the card unless the caller names the CPU); yields
    transformed batches made there."""

    def __init__(self, cfg: DatasetConfig, split: str = "train",
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.split = split
        self.device = resolve_device(device)
        sources = load_dataset(cfg.source_point_num, split,
                               cfg.modelnet_root, cfg.cache_dir,
                               cfg.num_synthetic, cfg.seed,
                               cfg.synthetic_kinds)
        self.sources = torch.as_tensor(
            np.ascontiguousarray(sources), dtype=torch.float32).to(self.device)
        if cfg.target_point_num == cfg.source_point_num:
            self.targets = self.sources
        else:
            targets = load_dataset(cfg.target_point_num, split,
                                   cfg.modelnet_root, cfg.cache_dir,
                                   cfg.num_synthetic, cfg.seed,
                                   cfg.synthetic_kinds)
            self.targets = torch.as_tensor(
                np.ascontiguousarray(targets), dtype=torch.float32).to(self.device)
        if len(self.sources) != len(self.targets):
            raise ValueError(f"{len(self.sources)} source clouds but "
                             f"{len(self.targets)} target clouds")

    def __len__(self):
        return len(self.sources)

    def train_val_indices(self, rng: np.random.Generator):
        """80/20 random split."""
        m = len(self)
        perm = rng.permutation(m)
        n_val = int(m * self.cfg.val_split)
        return perm[n_val:], perm[:n_val]

    def batches(self, generator: torch.Generator, indices: np.ndarray,
                batch_size: int, shuffle: bool = True,
                rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = True) -> Iterator[RegistrationBatch]:
        """Yield a RegistrationBatch per step; poses and noise are drawn
        from ``generator`` (on the banks' device), so every epoch
        re-randomizes them. The index order is shuffled on the host."""
        idx = np.array(indices)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        n_batches = len(idx) // batch_size if drop_remainder else \
            -(-len(idx) // batch_size)
        idx_dev = torch.as_tensor(idx, dtype=torch.long).to(self.device)
        for b in range(n_batches):
            sel = idx_dev[b * batch_size:(b + 1) * batch_size]
            yield make_registration_batch(generator, self.targets[sel],
                                          self.sources[sel], self.cfg.transform)
