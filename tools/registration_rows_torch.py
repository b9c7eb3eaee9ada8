#!/usr/bin/env python3
"""The registration accuracy rows of the JAX package, trained by the port.

Each row is one ``TrainConfig`` of the JAX package's recorded accuracy
rows (``benchmarks/registration_tpu.json``, held-out results in
``benchmarks/eval_bench_*.json``), rebuilt here field by field with the
values of the script that made it:

  - ``w_cos``, ``sinkhorn``, ``w1_cos``, ``pseudo_w_cos``, ``cd``:
    ``benchmarks/train_bench.py`` (2048 procedural ``composite`` shapes,
    B=128, N=M=128, noise 0.02, 3 pose iterations, TrainConfig's SHWD);
  - ``w_cos_128_hybrid``: the same with the ``hybrid`` solver, then
    ``--resume 2500`` from its ``best_rot_error_snap``, as
    ``benchmarks/resume_hybrid.py`` did;
  - ``w_cos_meshbank_128``: ``benchmarks/meshbank_bench.py`` (the OFF
    meshes of ``mesh_bank/`` through ``preprocess_modelnet``, seed 7, lr
    1e-3, 6000 epochs);
  - ``max_ssw``: variant P of ``benchmarks/final_max_ssw.py`` (mlp chart,
    512 projections, p = 1) with ``checkpoint_combined_weight=100`` as
    ``benchmarks/resume_max_ssw.py`` set it, 900 epochs in one run;
  - ``max_ssw_resume``: the same on the JAX row's schedule, 506 epochs,
    then ``--resume 900`` from its ``best_rot_error_snap``, as
    ``benchmarks/resume_max_ssw.py`` did; the combined snapshot is held to
    that script's target (held-out rotation <= 5 deg and translation <=
    0.02 from one checkpoint);
  - ``robust_noise_0.00`` ... ``robust_noise_0.10``,
    ``robust_outliers_10``: ``benchmarks/robustness_bench.py`` (``w_cos``
    with TrainConfig's SHWD, 2048 shapes, 100 epochs; the JAX rows,
    ``benchmarks/robustness_tpu.json``, hold the best validation rotation
    error only);
  - ``w_cos_1024_ssw``, ``w_cos_1024_sinkhorn_div``: ``train_bench.py
    w_cos <epochs> ... 1024 <solver>`` (N=M=1024; the ``ssw`` solver on
    the geodesic cost, the Sinkhorn divergence on the Lp cost);
  - ``w_cos_meshbank_1024``: ``meshbank_bench.py 1024 2000 ssw`` (the OFF
    bank at 1024 points, seed 1234, lr 1e-3).

A run is ``Trainer.fit`` (fused, on the card unless ``--device cpu``) and
then ``evaluate`` on the test split at the row's snapshot
(``best_rot_error_snap``; ``best_combined_snap`` for ``max_ssw*``). The JAX
rows ran with ``nan_guard=True`` (``hybrid`` without): here every row runs
without it, on the fused path, and a non-finite epoch metric fails the run.
One JSON row per (row, seed, epochs, init) is written into ``--out``
(replacing the earlier one), with the curves, the held-out errors, the
bar the row is held to and the JAX row beside it. Checkpoints go under
``--log-dir``.

A fit starts from the port's own draw at its seed (``--init torch``, the
default: a ``torch.Generator`` seeded on the fit's device, so the CPU and
the card start apart), or with ``--init jax`` from the state the JAX
package's fit of the row draws at that seed, read from
``tools/init_states_jax.npz`` (written by ``python
tests/write_init_states.py``, which imports JAX; it holds seed 1234):
PCRNet, the criterion's flows or chart and lam, with both Adam states
zero at count 0. That state is written as a port checkpoint at epoch 0
and the fit loads it through ``cfg.load_model``.

    python3 tools/registration_rows_torch.py --rows w_cos --seeds 1234
    python3 tools/registration_rows_torch.py --rows w_cos --seeds 1234 --init jax
    python3 tools/registration_rows_torch.py --rows w_cos_128_hybrid --resume 2500

``--init-file`` names another file of that layout (``python
tests/write_init_states.py --seeds 0 1 2 --out log/init_states/jax_s{seed}.npz``
writes one per seed, git-ignored).

``--epochs`` cuts a row's length for a short run. A snapshot takes ~50 MB
and a run keeps 3-4: keep ``--log-dir`` out of any directory whose size is
limited.

A fit can be recorded (``FitRecorder``) into ``--record-dir``, one
directory per (row, seed, init), for a replay in both packages
(``tests/replay_fit.py``) or in the port alone (``replay_port``):

  - ``--record-start``: the state the fit's first step sees (after
    ``load_model`` or a resume), ``state_<E>.npz`` in ``export_state``'s
    layout;
  - ``--record-state-at E``: the full state at the start of epoch E;
  - ``--record-epochs A:B``: every batch of epochs A <= e < B, train and
    val, as the dataset made it (the bank rows' indices, the transformed
    source, the pose), and every draw the criterion made in them (SSW
    frames, max-SSW subsets), ``draws.npz``;
  - always ``history.json`` (the fit's per-epoch history) and
    ``meta.json``.

Recording draws or states runs the per-step path (``fused_epoch=False``,
bit for bit the fused one on the card); a record of the history alone
keeps the row's path. A record at B=128, N=M=128 takes ~3 MB an epoch, a
state ~17 MB with Adam at zero and ~51 MB with its moments.

    python3 tools/registration_rows_torch.py --rows robust_noise_0.04 --seeds 1 \
        --epochs 10 --record-dir log/replay --record-start --record-epochs 0:10
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the reader of tools/init_states_jax.npz and of recorded states
from shwd_torch.utils.convert import stored_tree  # noqa: E402

# the HPO winner's knobs, as the JAX scripts spell them
LAM = 1.3111961119405346e-05
PHI_LR = 9.213233310357477e-05
PHI_WD = 1.4096013153858628e-08

# benchmarks/robustness_bench.py::SETTINGS -> the JAX row's best val rotation
ROBUST = {"noise_0.00": (0.0, 0, 4.025010181231138),
          "noise_0.02": (0.02, 0, 5.6268083320561715),
          "noise_0.04": (0.04, 0, 4.4612664232044175),
          "noise_0.10": (0.1, 0, 8.995007029955428),
          "outliers_10": (0.02, 10, 13.716274235825667)}

# row -> (epochs, the JAX row's seed, its held-out file, best and held-out
# rotation bars in deg: 1.5x the JAX row, None where that error is not held)
ROWS = {
    "w_cos": (2000, 1234, "eval_bench_w_cos.json", 2.5, 2.6),
    "w_cos_128_hybrid": (2000, 1234, "eval_bench_w_cos_128_hybrid.json", 2.25, 2.35),
    "w_cos_meshbank_128": (6000, 7, None, None, 11.3),
    "sinkhorn": (300, 1234, "eval_bench_sinkhorn.json", None, 1.5 * 2.480177879333496),
    "w1_cos": (200, 1234, "eval_bench_w1_cos.json", None, 1.5 * 2.609142541885376),
    "pseudo_w_cos": (150, 1234, "eval_bench_pseudo_w_cos.json", None,
                     1.5 * 2.8614706993103027),
    "cd": (300, 1234, "eval_bench_cd.json", None, 1.5 * 4.56306791305542),
    "max_ssw": (900, 1234, "eval_bench_max_ssw.json", None, 1.5 * 3.096400499343872),
    "max_ssw_resume": (506, 1234, "eval_bench_max_ssw.json", None,
                       1.5 * 3.096400499343872),
    **{f"robust_{name}": (100, 1234, None, 1.5 * best, None)
       for name, (_, _, best) in ROBUST.items()},
    "w_cos_1024_ssw": (160, 1234, "eval_bench_w_cos_1024_ssw.json",
                       1.5 * 1.634549958490218, 1.5 * 1.7178146839141846),
    "w_cos_meshbank_1024": (2000, 1234, None, None, 1.5 * 6.76185417175293),
    "w_cos_1024_sinkhorn_div": (96, 1234, None, 1.5 * 5.5309271812438965, None),
}
# benchmarks/resume_max_ssw.py:5-7: held-out rotation and translation of
# the combined snapshot after the resume, from one checkpoint
RESUME_TARGETS = {"max_ssw_resume": {"test_mean_rot_error": 5.0,
                                     "test_mean_trans_error": 0.02}}
SUCCESS_DEG = 5.0
METRICS = ("train_loss", "val_loss", "rot_error", "trans_error")
INIT_FILE = ROOT / "tools" / "init_states_jax.npz"


def row_config(row: str, seed: int | None = None, log_dir: str = "log",
               epochs: int | None = None):
    """The port's ``TrainConfig`` of ``row``: the JAX script's values, but
    ``nan_guard=False``; ``seed`` None is the JAX row's seed."""
    from shwd_torch.data import DatasetConfig, TransformConfig
    from shwd_torch.losses import MaxSSWConfig, SHWDConfig, TransportConfig
    from shwd_torch.train import TrainConfig
    length, jax_seed, *_ = ROWS[row]
    seed = jax_seed if seed is None else seed
    bank = DatasetConfig(
        source_point_num=128, target_point_num=128, num_synthetic=2048,
        synthetic_kinds=("composite",), cache_dir="modelnet_cache",
        transform=TransformConfig(noise_sigma=0.02))
    common = dict(log_dir=log_dir, num_epochs=epochs or length, seed=seed,
                  batch_size=128, pcr_iteration_num=3, nan_guard=False)

    def shwd(solver):
        # train_bench.py and meshbank_bench.py: the geodesic cost on ssw
        cost = "geodesic" if solver == "ssw" else "lp"
        return SHWDConfig(transport=TransportConfig(cost=cost, p=2.0, solver=solver),
                          max_iter=1, lam=LAM, phi_lr=PHI_LR, phi_weight_decay=PHI_WD)

    if row.startswith("w_cos_meshbank_"):
        n = int(row.rsplit("_", 1)[1])
        return TrainConfig(
            experiment=f"meshbank_w_cos_{n}", criterion="w_cos",
            shwd=shwd("ssw" if n >= 512 else "sinkhorn"),
            dataset=DatasetConfig(source_point_num=n, target_point_num=n,
                                  modelnet_root="mesh_bank", cache_dir="meshbank_cache",
                                  transform=TransformConfig(noise_sigma=0.02)),
            lr=1e-3, weight_decay=PHI_WD, **common)
    if row.startswith("robust_"):
        name = row[len("robust_"):]
        noise, outliers, _ = ROBUST[name]
        return TrainConfig(
            experiment=row, criterion="w_cos",
            dataset=dataclasses.replace(bank, transform=TransformConfig(
                noise_sigma=noise, outlier_num=outliers, outlier_sigma=1.0)),
            **common)
    if row.startswith("w_cos_1024_"):
        solver = row[len("w_cos_1024_"):]
        return TrainConfig(
            experiment=f"bench_{row}", criterion="w_cos", shwd=shwd(solver),
            dataset=dataclasses.replace(bank, source_point_num=1024, target_point_num=1024),
            max_ssw=MaxSSWConfig(num_projections=100, max_iter=1, phi_lr=9.2e-5),
            **common)
    if row in ("max_ssw", "max_ssw_resume"):
        return TrainConfig(
            experiment="bench_max_ssw", criterion="max_ssw", max_ssw_chart="mlp",
            max_ssw=MaxSSWConfig(num_projections=512, max_iter=1, phi_lr=PHI_LR, p=1.0),
            dataset=bank, checkpoint_combined_weight=100.0, **common)
    criterion = "w_cos" if row == "w_cos_128_hybrid" else row
    extra = {"shwd": shwd("hybrid")} if row == "w_cos_128_hybrid" else {}
    return TrainConfig(
        experiment=f"bench_{row}", criterion=criterion, dataset=bank,
        max_ssw=MaxSSWConfig(num_projections=100, max_iter=1, phi_lr=9.2e-5),
        **extra, **common)


def jax_init_state(trainer, row: str, seed: int, init_file=None):
    """The state the JAX package's fit of ``row`` at ``seed`` starts from,
    on ``trainer``'s device: a fresh state of ``trainer.init_state`` (the
    criterion's generator seeded with ``seed``, as ``Trainer.fit`` seeds
    it) with PCRNet, the criterion's flows or chart and lam read from
    ``init_file`` (default ``INIT_FILE``); both Adam states are fresh
    (zero at count 0)."""
    from shwd_torch.utils.convert import load_chart, load_pcrnet, load_phi, load_pseudo_phis
    path = Path(init_file or INIT_FILE)
    data = np.load(path)
    names = [str(r) for r in data["rows"]]
    if row not in names or seed != int(data["seed"]):
        raise ValueError(f"{path.name} holds no JAX initial state of row {row!r} at "
                         f"seed {seed} (rows {names} at seed {int(data['seed'])}; "
                         "python tests/write_init_states.py writes it)")
    state = trainer.init_state(torch.Generator(device=trainer.device).manual_seed(seed))
    load_pcrnet(state.model, stored_tree(data, "pcrnet"))
    entry = f"state/{data['row_state'][names.index(row)]}"
    params = stored_tree(data, f"{entry}/phi_params")
    fstate = stored_tree(data, f"{entry}/phi_state")
    crit = state.crit_state
    if trainer.cfg.criterion == "pseudo_w_cos":
        load_pseudo_phis(crit.phis, params, fstate)
    elif trainer.cfg.criterion == "max_ssw":
        load_chart(crit.phi, params, fstate)
    else:
        load_phi(crit.phi, params, fstate)
        with torch.no_grad():
            crit.lam.copy_(torch.from_numpy(data[f"{entry}/lam"]))
    return state


def jax_init_config(cfg, row: str, device=None, init_file=None):
    """``cfg`` fitted from the JAX package's initial state of ``row``: the
    state written as a port checkpoint at epoch 0,
    ``<log_dir>/<experiment>/models/jax_init``, which the returned
    config's ``load_model`` names."""
    from shwd_torch.train import Trainer
    from shwd_torch.utils.checkpoint import save_checkpoint
    state = jax_init_state(Trainer(cfg, device=device), row, cfg.seed, init_file)
    path = Path(cfg.log_dir) / cfg.experiment / "models" / "jax_init"
    save_checkpoint(path, state, 0)
    return dataclasses.replace(cfg, load_model=str(path))


@torch.no_grad()
def jax_init_check(device=None) -> list:
    """PCRNet's pose and each criterion's test-mode value on the check
    batch of ``INIT_FILE``, from the states it holds, loaded by
    ``jax_init_state``: [(name, the port's value, the JAX package's), ...]
    as numpy arrays. Criteria that draw frames in test mode get the JAX
    call's frames. On a CUDA device a ``sinkhorn`` transport takes the
    fused kernel (K3), held to the JAX value through its fused kernel in
    interpret mode (``value_kernel``); elsewhere the plain route's."""
    from shwd_torch.device import resolve_device
    from shwd_torch.train import Trainer
    data = np.load(INIT_FILE)
    seed, dev = int(data["seed"]), resolve_device(device)
    source, target = (torch.from_numpy(data[f"check/{k}"]).to(dev) for k in ("source", "target"))
    out, done = [], set()
    for row, name in zip(map(str, data["rows"]), map(str, data["row_check"])):
        if name in done:
            continue
        done.add(name)
        cfg = row_config(row, seed)
        trainer = Trainer(cfg, device=dev)
        state = jax_init_state(trainer, row, seed)
        if not out:
            pose = state.model(target, source, cfg.pcr_iteration_num)
            out += [("est_R", pose.est_R, data["check/est_R"]),
                    ("est_t", pose.est_t, data["check/est_t"])]
        crit = trainer.crit_apply.__self__
        if f"check/{name}/frames" in data.files:
            frames = torch.from_numpy(data[f"check/{name}/frames"]).to(dev)
            if cfg.criterion == "max_ssw":
                crit.draw = lambda minibatch, frames=frames: (frames, None)
            else:
                crit.transport = functools.partial(crit.transport, frames=frames)
        (value, _, _), _ = trainer.crit_apply(state.crit_state, target, source, False)
        key = f"check/{name}/value_kernel"
        if dev.type != "cuda" or key not in data.files:
            key = f"check/{name}/value"
        out.append((name, value, data[key]))
    return [(name, port.cpu().numpy(), want) for name, port, want in out]


def resume_config(cfg, total: int):
    """``cfg`` continued from its ``best_rot_error_snap`` to ``total``
    epochs, as ``benchmarks/resume_hybrid.py`` continues its row."""
    snap = Path(cfg.log_dir) / cfg.experiment / "models" / "best_rot_error_snap"
    return dataclasses.replace(cfg, num_epochs=total, load_model=str(snap))


# -- recording a fit, and replaying it in the port -----------------------------

DRAWS = "draws.npz"


def criterion_object(trainer):
    """The criterion object behind ``trainer.crit_apply`` (None for the
    stateless ``cd`` and ``sinkhorn`` criteria)."""
    return getattr(trainer.crit_apply, "__self__", None)


def _draw_site(trainer) -> str | None:
    """Where the trainer's criterion draws: "transport" (SHWD on ``ssw``),
    "max_ssw", or None (no draw). Raises for a criterion whose draws a
    record cannot hold."""
    from shwd_torch.losses import MaxSSWLoss, SHWDLoss
    cfg, crit = trainer.cfg, criterion_object(trainer)
    if isinstance(crit, MaxSSWLoss):
        return "max_ssw"
    ssw = cfg.shwd.transport.solver == "ssw"
    if isinstance(crit, SHWDLoss):
        if cfg.shwd.refresh:
            raise NotImplementedError("a record cannot hold refresh's new phi every call")
        return "transport" if ssw else None
    if crit is not None and ssw:
        raise NotImplementedError(f"a record cannot hold {cfg.criterion}'s ssw frames")
    return None


def _wrap_draws(trainer, sink) -> None:
    """Make the criterion's draws go through ``sink``: ``sink(draw)``
    gets (frames, indices or None) as drawn and returns what the step
    uses. The draws are the criterion's own, made as it makes them."""
    from shwd_torch.ops.spherical import stiefel_frames
    crit, site = criterion_object(trainer), _draw_site(trainer)
    if site == "transport":
        inner, n = crit.transport, trainer.cfg.shwd.transport.num_projections

        def transport(x, y, generator=None, frames=None):
            if frames is None:
                if generator is None:       # as the transport does without one
                    generator = torch.Generator(device=x.device).manual_seed(0)
                frames = stiefel_frames(generator, n, x.shape[-1], device=x.device)
            return inner(x, y, frames=sink((frames, None))[0])
        crit.transport = transport
    elif site == "max_ssw":
        draw = crit._draw
        crit._draw = lambda state, x, minibatch: sink(draw(state, x, minibatch))


class FitRecorder:
    """Records a port fit into ``root`` (see the module docstring):
    ``states`` the epochs at whose start the state is written (``start``
    adds the fit's first), ``epochs`` (A, B) the epochs whose batches and
    criterion draws are kept. ``attach(trainer)`` before ``fit``,
    ``finish(history, meta)`` after it (``meta.json`` gets ``meta``, the
    fit's config, path and device, and what was written)."""

    def __init__(self, root, epochs=None, states=(), start=False):
        self.root = Path(root)
        self.epochs, self.states, self.start = epochs, set(states), start
        self.arrays: dict = {}
        self.current = None         # the key of the batch being stepped
        self.written: list = []
        self.first_epoch = None

    @property
    def per_step(self) -> bool:
        """Whether the fit must run the per-step path (draws or states)."""
        return bool(self.epochs or self.states or self.start)

    def _recording(self, epoch: int) -> bool:
        return self.epochs is not None and self.epochs[0] <= epoch < self.epochs[1]

    def _sink(self, draw):
        if self.current is not None:
            j = self.drawn
            frames, idx = draw
            self.arrays[f"{self.current}/draw/{j}/frames"] = frames.detach().cpu().numpy()
            if idx is not None:
                self.arrays[f"{self.current}/draw/{j}/index"] = idx.cpu().numpy()
            self.drawn += 1
        return draw

    def _save_state(self, trainer, state) -> None:
        from shwd_torch.utils.convert import export_state
        self.root.mkdir(parents=True, exist_ok=True)
        path = self.root / f"state_{state.epoch}.npz"
        np.savez_compressed(path, **export_state(trainer, state))
        self.written.append(path.name)

    def _batches(self, dataset, epoch: int, phase: str):
        recorder = self

        class Recording:
            """``dataset`` whose batches are kept as they are made."""

            def __len__(self):
                return len(dataset)

            def batches(self, generator, indices, batch_size, shuffle=True, rng=None,
                        drop_remainder=True):
                # the order the dataset makes: its shuffle replayed on a copy
                # of the rng's state
                idx = np.array(indices)
                if shuffle:
                    probe = np.random.default_rng()
                    probe.bit_generator.state = rng.bit_generator.state
                    probe.shuffle(idx)
                made = dataset.batches(generator, indices, batch_size, shuffle, rng,
                                       drop_remainder)
                for k, batch in enumerate(made):
                    sel = idx[k * batch_size:(k + 1) * batch_size]
                    if not torch.equal(batch.target, dataset.targets[
                            torch.as_tensor(sel, device=dataset.targets.device)]):
                        raise RuntimeError(f"epoch {epoch} {phase} batch {k}: the target "
                                           "is not the bank's rows")
                    key = f"e{epoch}/{phase}/{k}"
                    recorder.arrays[f"{key}/index"] = sel.astype(np.int32)
                    for name in ("source", "igt_rotation", "igt_translation"):
                        recorder.arrays[f"{key}/{name}"] = getattr(batch, name).cpu().numpy()
                    recorder.current, recorder.drawn = key, 0
                    yield batch
                recorder.current = None
        return Recording()

    def attach(self, trainer) -> None:
        if self.per_step and trainer.execution_path() == "fused":
            raise ValueError("recording draws or states needs fused_epoch=False")
        if trainer.cfg.criterion in ("w_cos", "w1_cos") and trainer._early_stop_enabled:
            raise NotImplementedError("a replay does not count early-stop strikes")
        self.trainer = trainer
        train, evaluate = trainer.train_one_epoch, trainer.eval_one_epoch
        _wrap_draws(trainer, self._sink)

        def train_one_epoch(state, dataset, indices, generator, rng):
            if self.first_epoch is None:
                self.first_epoch = state.epoch
                if self.start:
                    self._save_state(trainer, state)
            if state.epoch in self.states and f"state_{state.epoch}.npz" not in self.written:
                self._save_state(trainer, state)
            if self._recording(state.epoch):
                dataset = self._batches(dataset, state.epoch, "train")
            return train(state, dataset, indices, generator, rng)

        def eval_one_epoch(state, dataset, indices, generator):
            epoch = state.epoch
            if self._recording(epoch):
                dataset = self._batches(dataset, epoch, "val")
            out = evaluate(state, dataset, indices, generator)
            if self._recording(epoch) and epoch == self.epochs[1] - 1:
                self._write_draws()
            return out

        trainer.train_one_epoch, trainer.eval_one_epoch = train_one_epoch, eval_one_epoch

    def _write_draws(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(self.root / DRAWS, **self.arrays)
        self.written.append(DRAWS)
        self.arrays = {}

    def finish(self, history: list, meta: dict) -> None:
        if self.arrays:                 # the fit ended inside the range
            self._write_draws()
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "history.json").write_text(json.dumps(history, indent=1) + "\n")
        meta = dict(meta, config=json.loads(self.trainer.cfg.to_json()),
                    path=self.trainer.execution_path(), device=str(self.trainer.device),
                    first_epoch=self.first_epoch,
                    epochs=list(self.epochs) if self.epochs else None,
                    states=sorted(int(f[len("state_"):-len(".npz")])
                                  for f in self.written if f.startswith("state_")),
                    files=sorted(set(self.written)) + ["history.json", "meta.json"])
        (self.root / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")


class Record:
    """A recorded fit, read back: ``meta``, ``history``, ``state(E)`` and
    the batches and draws of its recorded epochs."""

    def __init__(self, root):
        self.root = Path(root)
        self.meta = json.loads((self.root / "meta.json").read_text())
        self.history = json.loads((self.root / "history.json").read_text())
        self.draws = np.load(self.root / DRAWS) if (self.root / DRAWS).exists() else None
        self._keys = set(self.draws.files) if self.draws is not None else set()

    def config(self, **overrides):
        """The fit's ``TrainConfig`` (the port's), with ``overrides``."""
        from shwd_torch.train.config import config_from_dict
        return dataclasses.replace(config_from_dict(self.meta["config"]), **overrides)

    def state(self, epoch: int):
        return np.load(self.root / f"state_{epoch}.npz")

    def batch_keys(self, epoch: int, phase: str) -> list:
        keys, k = [], 0
        while f"e{epoch}/{phase}/{k}/index" in self._keys:
            keys.append(f"e{epoch}/{phase}/{k}")
            k += 1
        if not keys:
            raise KeyError(f"the record holds no {phase} batch of epoch {epoch}")
        return keys

    def batch(self, key: str) -> dict:
        """index, source, igt_rotation, igt_translation as numpy."""
        return {k: self.draws[f"{key}/{k}"]
                for k in ("index", "source", "igt_rotation", "igt_translation")}

    def batch_draws(self, key: str) -> list:
        """[(frames, indices or None), ...] in the order the step drew them."""
        out, j = [], 0
        while f"{key}/draw/{j}/frames" in self._keys:
            idx = f"{key}/draw/{j}/index"
            out.append((self.draws[f"{key}/draw/{j}/frames"],
                        self.draws[idx] if idx in self._keys else None))
            j += 1
        return out


class Replayed:
    """The recorded batches of one epoch and phase, as a dataset the
    port's epoch loop takes (its arguments are ignored: the record fixes
    the order); each batch's recorded draws are queued in ``queue`` for
    the criterion's hooks (``hand_in``)."""

    def __init__(self, record: Record, epoch: int, phase: str, targets, queue: list):
        self.record, self.keys = record, record.batch_keys(epoch, phase)
        self.targets, self.queue = targets, queue

    def batches(self, *args, **kwargs):
        from shwd_torch.data import RegistrationBatch
        dev = self.targets.device
        for key in self.keys:
            b = self.record.batch(key)
            if self.queue:
                raise RuntimeError(f"{len(self.queue)} recorded draws were not used")
            self.queue[:] = [tuple(None if a is None else torch.from_numpy(a).to(dev)
                                   for a in d) for d in self.record.batch_draws(key)]
            sel = torch.as_tensor(b["index"].astype(np.int64), device=dev)
            yield RegistrationBatch(self.targets[sel], *(
                torch.from_numpy(b[k]).to(dev)
                for k in ("source", "igt_rotation", "igt_translation")))
        if self.queue:
            raise RuntimeError(f"{len(self.queue)} recorded draws were not used")


def hand_in(trainer, queue: list) -> None:
    """The criterion of ``trainer`` takes its draws from ``queue`` (filled
    per batch by ``Replayed``) in the order it makes them."""
    def sink(_drawn):
        if not queue:
            raise RuntimeError("the step drew more than the record holds")
        return queue.pop(0)
    _wrap_draws(trainer, sink)


def replay_port(record: Record, device=None, epochs=None, on_step=None):
    """The port's per-step fit of the record's config from its state at
    the start of ``epochs[0]`` (default: the earliest stored) through
    ``epochs[1]`` (default: the end of the recorded range), each batch and
    draw handed in from the record. ``on_step(state, k, batch, draws,
    step)`` takes train step k of ``state.epoch`` in place of the trainer
    and must return ``step(state, batch)``; ``draws`` are the step's
    recorded draws. Returns (history rows with the fit's keys, the
    trainer, the final state)."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    from shwd_torch.utils.convert import load_state
    cfg = record.config(fused_epoch=False, load_model=None)
    trainer = Trainer(cfg, device=device)
    start = epochs[0] if epochs else min(record.meta["states"])
    stop = epochs[1] if epochs else record.meta["epochs"][1]
    state = trainer.init_state(torch.Generator(device=trainer.device).manual_seed(cfg.seed))
    load_state(trainer, state, record.state(start))
    targets = RegistrationDataset(cfg.dataset, "train", device=trainer.device).targets
    queue: list = []
    hand_in(trainer, queue)
    count = {"k": 0}
    if on_step is not None:
        step = trainer._train_step

        def train_step(st, batch):
            count["k"] += 1
            return on_step(st, count["k"] - 1, batch, list(queue), step)
        trainer._train_step = train_step
    history = []
    for epoch in range(start, stop):
        state.epoch, count["k"] = epoch, 0
        t0 = time.perf_counter()
        _, train_loss = trainer.train_one_epoch(
            state, Replayed(record, epoch, "train", targets, queue), None, None, None)
        val_loss, rot, trans = trainer.eval_one_epoch(
            state, Replayed(record, epoch, "val", targets, queue), None, None)
        state.epoch = epoch + 1
        history.append(dict(epoch=epoch + 1, train_loss=train_loss, val_loss=val_loss,
                            rot_error=rot, trans_error=trans,
                            seconds=time.perf_counter() - t0))
    return history, trainer, state


def snapshot_name(row: str) -> str:
    return "best_combined_snap" if row.startswith("max_ssw") else "best_rot_error_snap"


def card_line() -> str | None:
    """``name, power.limit`` of the card as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def source_digest() -> str:
    """sha256 (16 hex) of the port's sources and this script: which code
    made a row, where no git history is at hand."""
    h = hashlib.sha256()
    files = sorted((ROOT / "shwd_torch").rglob("*.py")) + sorted(
        (ROOT / "shwd_torch" / "csrc").glob("*.cu")) + [Path(__file__).resolve()]
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def jax_row(row: str) -> dict:
    """The JAX row's recorded numbers (TPU times left out)."""
    _, _, eval_file, _, _ = ROWS[row]
    if row.startswith("robust_"):
        rows = json.loads((ROOT / "benchmarks" / "robustness_tpu.json").read_text())
        rec = next(r for r in rows if r["setting"] == row[len("robust_"):])
    else:
        rows = json.loads((ROOT / "benchmarks" / "registration_tpu.json").read_text())
        name = "max_ssw" if row == "max_ssw_resume" else row
        rec = next(r for r in rows if r["criterion"] == name)
    out = {k: rec[k] for k in ("epochs", "best_rot_error", "best_trans_error",
                               "final_rot_error", "test_mean_rot_error",
                               "test_mean_trans_error", "resumed_to_epoch",
                               "held_out_after_resume_rot", "combined_snap_held_out_rot",
                               "combined_snap_held_out_trans", "rot_curve_every10")
           if k in rec}
    if eval_file:
        ev = json.loads((ROOT / "benchmarks" / eval_file).read_text())
        out["test_mean_rot_error"] = ev["mean_rot_error_deg"]
        out["test_mean_trans_error"] = ev["mean_trans_error"]
        i = ev["rot_thresholds_deg"].index(SUCCESS_DEG)
        out["rot_success_ratio_5deg"] = ev["rot_success_ratio"][i]
    return out


def fit_and_evaluate(cfg, row: str, device, resume: bool = False,
                     recorder: FitRecorder | None = None, meta: dict | None = None) -> dict:
    """``Trainer.fit`` then ``evaluate`` on the test split at the row's
    snapshot: the JAX rows' keys, times, peak memory and the final lam.
    The fit's initial state is evaluated first: its own draw, or the
    checkpoint ``cfg.load_model`` names; a ``resume`` evaluates none.
    ``recorder`` records the fit (``meta`` goes into its ``meta.json``)."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    from shwd_torch.train.evaluate import evaluate
    trainer = Trainer(cfg, device=device)
    if recorder is not None:
        recorder.attach(trainer)
    dev = trainer.device
    ds = RegistrationDataset(cfg.dataset, "train", device=dev)
    init_ev = None
    if cfg.load_model and not resume:
        init_ev = evaluate(cfg, checkpoint=cfg.load_model, split="test", device=dev)
    elif not resume:
        # where the fit starts: its initial state (the first draws of the
        # generator fit seeds with cfg.seed) on the test split
        init_ev = evaluate(cfg, state=trainer.init_state(
            torch.Generator(device=dev).manual_seed(cfg.seed)), split="test", device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = trainer.fit(ds, verbose=False)
    total = time.perf_counter() - t0
    h = res["history"]
    if recorder is not None:
        recorder.finish(h, meta or {})
    bad = [r["epoch"] for r in h if not all(math.isfinite(r[k]) for k in METRICS)]
    snap = Path(cfg.log_dir) / cfg.experiment / "models" / snapshot_name(row)
    ev = evaluate(cfg, checkpoint=str(snap), split="test", device=dev)
    i = int(np.searchsorted(ev.rot_thresholds, SUCCESS_DEG))
    steps = [r["train_seconds"] / r["train_steps"] * 1e3 for r in h[1:]] or [
        h[0]["train_seconds"] / h[0]["train_steps"] * 1e3]
    crit = res["state"].crit_state
    out = {
        "epochs_run": len(h), "first_epoch": h[0]["epoch"],
        "train_shapes": len(ds), "train_steps_per_epoch": h[0]["train_steps"],
        "init_test_rot_error": init_ev and init_ev.mean_rot_error,
        "first_rot_error": h[0]["rot_error"],
        "best_rot_error": float(res["best"]["rot"]),
        "best_rot_epoch": h[int(np.argmin([r["rot_error"] for r in h]))]["epoch"],
        "best_combined_epoch": h[int(np.argmin(
            [r["rot_error"] + 100.0 * r["trans_error"] for r in h]))]["epoch"],
        "best_trans_error": float(res["best"]["trans"]),
        "final_rot_error": h[-1]["rot_error"], "final_trans_error": h[-1]["trans_error"],
        "rot_curve_every10": [r["rot_error"] for r in h[::10]],
        "trans_curve_every10": [r["trans_error"] for r in h[::10]],
        "evaluated_snapshot": snap.name,
        "evaluated_snapshot_epoch": int(torch.load(str(snap) + ".pt", map_location="cpu",
                                                   weights_only=True)["epoch"]),
        "test_mean_rot_error": ev.mean_rot_error,
        "test_mean_trans_error": ev.mean_trans_error,
        "test_samples": int(ev.per_sample_rot.shape[0]),
        "rot_success_ratio_5deg": float(ev.rot_success_ratio[i]),
        "total_s": total, "s_per_epoch": total / len(h),
        # the epochs after the first, which captures the step graphs
        "s_per_epoch_median": float(np.median([r["seconds"] for r in h[1:]] or
                                              [h[0]["seconds"]])),
        "first_epoch_s": h[0]["seconds"],
        "ms_per_train_step": float(np.mean(steps)),
        "ms_per_train_step_median": float(np.median(steps)),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "path": res["path"], "nonfinite_epochs": bad,
    }
    if cfg.criterion in ("w_cos", "w1_cos"):
        calls = sum(r["train_steps"] for r in h)
        out["lam_final"] = float(crit.lam)
        # the JAX rule: lam <- lam * lam_decay after every train call, in f32
        out["lam_expected"] = float(np.float32(cfg.shwd.lam)
                                    * np.float32(cfg.shwd.lam_decay) ** calls)
    opt = res["state"].opt
    out["adam_step"] = int(opt.state[next(iter(res["state"].model.parameters()))]["step"])
    return out


def run(row: str, seed: int, args) -> dict:
    """One (row, seed): a fit from scratch, or with ``--resume`` a fit
    from the row's ``best_rot_error_snap`` to that many epochs, merged into
    the row already in ``--out``."""
    tag = "_jax" if args.init == "jax" else ""
    cfg = row_config(row, seed, str(Path(args.log_dir) / f"{row}_s{seed}{tag}"), args.epochs)
    head = {"row": row, "criterion": row, "seed": cfg.seed, "init": args.init,
            "card": card_line(), "commit": args.commit,
            "source_sha256_16": source_digest(), "torch": torch.__version__,
            # what earlier fits of this process left allocated on the card
            "allocated_before_bytes": (torch.cuda.memory_allocated()
                                       if args.device is None else None)}
    bar = {"best_rot_error": ROWS[row][3], "test_mean_rot_error": ROWS[row][4]}
    recorder = None
    if args.record_dir is not None:
        recorder = FitRecorder(Path(args.record_dir) / f"{row}_s{seed}{tag}",
                               args.record_epochs, args.record_state_at, args.record_start)
        if recorder.per_step:
            cfg = dataclasses.replace(cfg, fused_epoch=False)
    meta = {k: head[k] for k in ("row", "seed", "init", "card", "commit",
                                 "source_sha256_16", "torch")}
    if args.resume is None:
        if args.init == "jax":
            init_file = args.init_file and args.init_file.format(seed=seed)
            cfg = jax_init_config(cfg, row, args.device, init_file)
        out = {**head, "epochs": cfg.num_epochs, "row_epochs": ROWS[row][0],
               "nan_guard": cfg.nan_guard, "bar": bar,
               **fit_and_evaluate(cfg, row, args.device, recorder=recorder, meta=meta),
               "jax_row": jax_row(row)}
        return judge(out)
    cfg = resume_config(cfg, args.resume)
    part = fit_and_evaluate(cfg, row, args.device, resume=True, recorder=recorder,
                            meta=dict(meta, resumed_to_epoch=args.resume))
    part.update(card=head["card"], source_sha256_16=head["source_sha256_16"],
                resumed_from_epoch=part["first_epoch"] - 1, resumed_to_epoch=args.resume,
                bar=bar)
    judge(part)
    if row in RESUME_TARGETS:
        target = RESUME_TARGETS[row]
        part["target"] = target
        part["meets_target"] = all(part[k] <= v for k, v in target.items())
    first = ROWS[row][0] if args.epochs is None else args.epochs
    out = next((r for r in load_rows(args.out)
                if ident(r) == (row, cfg.seed, first, args.init)), dict(head, epochs=first))
    out["resume"] = part
    return out


def judge(out: dict) -> dict:
    """``meets_bar``: every error the row holds (a bar not None) is at or
    under its bar; ``verdict`` says "met" or "MISSED"."""
    out["meets_bar"] = all(out[k] <= v for k, v in out["bar"].items() if v is not None)
    out["verdict"] = "met" if out["meets_bar"] else "MISSED"
    return out


def load_rows(path) -> list:
    p = Path(path)
    return json.loads(p.read_text()) if p.exists() else []


def ident(row: dict) -> tuple:
    """A stored row's key: (row, seed, epochs of its first run, init);
    rows stored before ``init`` existed started from the port's draw."""
    return row["row"], row["seed"], row["epochs"], row.get("init", "torch")


def store(path, row: dict) -> None:
    rows = [r for r in load_rows(path) if ident(r) != ident(row)]
    rows.append(row)
    rows.sort(key=lambda r: (list(ROWS).index(r["row"]), *ident(r)[1:]))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(rows, indent=1) + "\n")


def summary(row: dict) -> dict:
    keys = ("row", "seed", "init", "best_rot_error", "test_mean_rot_error",
            "test_mean_trans_error", "rot_success_ratio_5deg", "s_per_epoch",
            "s_per_epoch_median", "ms_per_train_step", "peak_mem_bytes",
            "allocated_before_bytes", "meets_bar", "verdict", "meets_target",
            "nonfinite_epochs")
    out = {k: row[k] for k in keys if k in row}
    if "resume" in row:
        out["resume"] = {k: row["resume"][k] for k in keys if k in row["resume"]}
    return out


def epoch_range(text: str) -> tuple:
    """"A:B" -> (A, B), 0 <= A < B."""
    a, b = (int(x) for x in text.split(":"))
    if not 0 <= a < b:
        raise argparse.ArgumentTypeError(f"{text!r} is not an epoch range A:B with A < B")
    return a, b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="+", choices=list(ROWS), default=["w_cos"])
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: each row's JAX seed")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut each row to this many epochs")
    ap.add_argument("--resume", type=int, default=None, metavar="TOTAL",
                    help="continue from best_rot_error_snap to TOTAL epochs")
    ap.add_argument("--init", choices=("torch", "jax"), default="torch",
                    help="start from the port's draw at the seed, or from the JAX "
                         "package's (tools/init_states_jax.npz)")
    ap.add_argument("--init-file", default=None,
                    help="the JAX initial states of --init jax ({seed} is replaced "
                         "by the seed; default tools/init_states_jax.npz)")
    ap.add_argument("--record-dir", default=None,
                    help="record each fit into <dir>/<row>_s<seed>[_jax]")
    ap.add_argument("--record-start", action="store_true",
                    help="record the state the fit's first step sees")
    ap.add_argument("--record-epochs", type=epoch_range, default=None, metavar="A:B",
                    help="record the batches and criterion draws of epochs A <= e < B")
    ap.add_argument("--record-state-at", type=int, nargs="+", default=(), metavar="E",
                    help="record the state at the start of epoch E")
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="the card unless cpu (for tests)")
    ap.add_argument("--log-dir", default="log/registration_rows")
    ap.add_argument("--out", default=str(ROOT / "tools" / "registration_rows_h100.json"))
    ap.add_argument("--commit", default=None,
                    help="the commit the tree was taken from, recorded as given")
    args = ap.parse_args(argv)
    if args.record_dir is None and (args.record_start or args.record_epochs
                                    or args.record_state_at):
        ap.error("--record-start, --record-epochs and --record-state-at need --record-dir")
    failed = False
    for row in args.rows:
        for seed in args.seeds or [ROWS[row][1]]:
            out = run(row, seed, args)
            store(args.out, out)
            print(json.dumps(summary(out)), flush=True)
            part = out.get("resume", out) if args.resume else out
            failed |= bool(part["nonfinite_epochs"])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
