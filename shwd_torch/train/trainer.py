"""Registration trainers: W_COS (flagship), CD, Pseudo_W_COS, W1_COS,
Sinkhorn, max-SSW.

Counterpart of ``shwd_tpu/train/trainer.py``: per epoch a train pass and a
validation pass, three best-checkpoint families (val loss / rotation error /
translation error) plus the optional combined one, metrics logged per
epoch, full resume.

How the port differs from the JAX package's functional trainer:
- the model, phi and both optimizers are modules updated in place, so the
  ``TrainState`` is one mutable object and a best-so-far snapshot is a
  copy (``utils.checkpoint.state_payload``) taken at the improving epoch;
- the model's gradient is taken with respect to the PCRNet parameters only
  (``torch.autograd.grad``); phi's ``.grad`` is filled by the inner ascent
  objective alone;
- a train step makes no host sync: the epoch's loss is accumulated on the
  device and read once per epoch (every step only under ``nan_guard``);
- ``fused_epoch`` (the default, as in the JAX package) runs each train
  step and each validation batch as a captured CUDA graph, replayed per
  batch (``utils.graphs.StepGraph``): the JAX package's ``_epoch_scan``
  and ``_eval_epoch_scan`` compile a whole epoch into one program, here
  one step is captured and the batch, drawn eagerly from the trainer's
  generator as in the per-step loop, is copied into the graph's static
  inputs, so both paths see the same random stream. The validation pass
  has a graph per batch shape (the full batch and the tail). The rule is
  the JAX package's ``fused_epoch and not nan_guard``, less what a graph
  cannot hold: the ``exact`` solver (host network simplex) and SHWD's
  ``refresh`` (a new phi every call) take the per-step loop
  (``execution_path`` says which, and every history row records it). On
  the CPU the fused path calls the same step function on the same static
  buffers, without capture;
- data parallel (``mesh_data``/``mesh_slices``) runs one process per
  device, each on the same seed: every rank makes the same global batch and
  takes its rows, and the model's gradients are averaged over the ``data``
  group before the Adam step (no DDP wrapper: the step keeps
  ``torch.autograd.grad``). Where the single-device value is batch-wide
  (Sinkhorn's eps0, the auction's cost range, phi's inner gradients, the
  max-SSW minibatch, the epoch's metrics), the collective is explicit: the
  fit makes the data group active (``parallel.mesh.data_parallel``) and
  those ops reduce over it. The ``slices`` axis holds replicas, as in the
  JAX trainer. Only rank 0 writes files; every rank returns the same
  history. Under a mesh the fused path holds the rank's rows as its static
  inputs and records the step's collectives (the criterion's on the data
  group, the gradient bucket's all-reduce) into the graph; the warm-up
  runs each of them once first, so NCCL's communicators exist before the
  capture. The epoch's loss and the validation sums are reduced over the
  group outside the graphs, once per pass, as on the per-step path;
- the fused train pass is the span ``train.pass`` (``utils.profiling``),
  with its steps and the host seconds spent drawing batches and calling the
  graph; the validation pass is ``train.eval_pass``. Inside the captured
  steps PCRNet's forward, the model's backward and its Adam step are the
  device marks ``pcrnet_forward``, ``backward`` and ``adam``; the graphs'
  marks are collected after each pass's host read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..data.dataset import RegistrationDataset
from ..data.transforms import RegistrationBatch
from ..device import resolve_device
from ..flows import EncoderFlowChart, SphereChartMLP, make_flow
from ..losses import (MaxSSWLoss, PseudoSHWDConfig, PseudoSHWDLoss, SHWDLoss,
                      chamfer_criterion, make_sinkhorn_criterion)
from ..losses.shwd import inner_gate
from ..models import PCRNet
from ..ops.quaternion import rotation_error_deg, translation_error
from ..parallel import mesh as pmesh
from ..utils import profiling
from ..utils.checkpoint import load_checkpoint, save_checkpoint, state_payload
from ..utils.graphs import StepGraph, preserved, step_generators
from ..utils.logging import RunLogger
from ..utils.optim import init_adam_state, torch_adam
from .config import TrainConfig


@dataclasses.dataclass
class TrainState:
    model: PCRNet
    opt: torch.optim.Adam
    crit_state: Any             # SHWDState, PseudoSHWDState, MaxSSWState,
                                # or None for stateless criteria
    epoch: int = 0


def _mean_subtract(batch: RegistrationBatch):
    """Both clouds centered; the translation ground truth is shifted by the
    source mean (used in eval)."""
    src_mean = torch.mean(batch.source, dim=1, keepdim=True)
    tgt_mean = torch.mean(batch.target, dim=1, keepdim=True)
    source = batch.source - src_mean
    target = batch.target - tgt_mean
    translation = batch.igt_translation - src_mean[:, 0, :]
    return source, target, translation


def build_criterion(cfg: TrainConfig):
    """Returns (init_state(generator), criterion(crit_state, x, y, train) ->
    ((loss, sx, sy), crit_state))."""
    name = cfg.criterion
    if name in ("w_cos", "w1_cos"):
        shwd_cfg = cfg.shwd
        if name == "w1_cos":
            shwd_cfg = dataclasses.replace(
                shwd_cfg, transport=dataclasses.replace(shwd_cfg.transport, p=1.0))
        crit = SHWDLoss(
            lambda g: make_flow(cfg.flow_name, cfg.phi_num_flow_layer, generator=g),
            shwd_cfg)
        return crit.init, crit.apply
    if name == "pseudo_w_cos":
        crit = PseudoSHWDLoss(
            lambda g: make_flow(cfg.flow_name, cfg.phi_num_flow_layer, generator=g),
            PseudoSHWDConfig(transport=cfg.shwd.transport, phi_num=cfg.pseudo_phi_num,
                             combine=cfg.pseudo_combine))
        return crit.init, crit.apply
    if name == "max_ssw":
        chart = (EncoderFlowChart if cfg.max_ssw_chart == "encoder_flow"
                 else SphereChartMLP)
        crit = MaxSSWLoss(lambda g: chart(generator=g), cfg.max_ssw)
        return crit.init, crit.apply
    if name == "cd":
        def apply(state, x, y, train=True):
            return chamfer_criterion(x, y), state
        return (lambda generator: None), apply
    if name == "sinkhorn":
        base = make_sinkhorn_criterion(cfg.sinkhorn_eps, cfg.sinkhorn_iter)

        def apply(state, x, y, train=True):
            return base(x, y), state
        return (lambda generator: None), apply
    raise ValueError(f"unknown criterion {name!r}")


class Trainer:
    """``Trainer(cfg).fit(dataset)`` runs on the card unless ``device``
    names the CPU."""

    def __init__(self, cfg: TrainConfig,
                 device: str | torch.device | None = None, mesh=None):
        """``mesh`` (a ``parallel.mesh.make_mesh`` mesh) replaces the one
        that ``cfg.mesh_data``/``cfg.mesh_slices`` would build."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.crit_init, self.crit_apply = build_criterion(cfg)
        # the criterion object behind ``crit_apply`` (None for a function)
        self._criterion = getattr(self.crit_apply, "__self__", None)
        self._early_stop_enabled = (cfg.criterion in ("w_cos", "w1_cos")
                                    and cfg.shwd.early_stop_strikes > 0)
        # max-SSW's loss is a sum over the batch: ranks add up, not average
        self._reduce = "sum" if cfg.criterion == "max_ssw" else "mean"
        self.mesh, self._data_group = mesh, None
        if mesh is None and (cfg.mesh_data is not None or cfg.mesh_slices > 1):
            self.mesh = pmesh.make_mesh(cfg.mesh_data, cfg.mesh_slices, self.device)
        self._n_data = pmesh.axis_size(self.mesh, "data")
        self._r_data = pmesh.axis_rank(self.mesh, "data")
        if self.mesh is not None:
            self._data_group = self.mesh.get_group("data")
            if cfg.batch_size % self._n_data != 0:
                raise ValueError(
                    f"batch_size={cfg.batch_size} must divide evenly over the "
                    f"mesh 'data' axis ({self._n_data}); a training batch that "
                    "falls back to replication would silently lose all data "
                    "parallelism (the fallback exists only for eval's "
                    "drop_remainder=False tail)")
            if (cfg.criterion in ("w_cos", "w1_cos")
                    and cfg.shwd.transport.reduce != "mean"):
                raise ValueError("data-parallel w_cos needs the transport's "
                                 "batch mean (reduce='mean')")
        self._writer = self.mesh is None or torch.distributed.get_rank() == 0
        self._fused: dict = {}      # the step graphs of the state being fitted

    def execution_path(self) -> str:
        """'fused' (captured steps replayed on the card, the same static
        path called directly on the CPU), or 'per_step: <reason>'."""
        cfg = self.cfg
        if not cfg.fused_epoch:
            return "per_step: fused_epoch=False"
        if cfg.nan_guard:
            return "per_step: nan_guard reads every loss on the host"
        if (cfg.criterion in ("w_cos", "w1_cos", "pseudo_w_cos")
                and cfg.shwd.transport.solver == "exact"):
            return "per_step: the exact solver runs on the host"
        if cfg.criterion in ("w_cos", "w1_cos") and cfg.shwd.refresh:
            return "per_step: refresh makes a new phi every call"
        return "fused"

    def _rows(self, batch: RegistrationBatch) -> RegistrationBatch:
        """This rank's rows of a global batch (the batch itself without a
        mesh)."""
        if self.mesh is None:
            return batch
        return RegistrationBatch(*(pmesh.shard(t, self._n_data, self._r_data)
                                   for t in batch))

    # -- steps ---------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh state drawn from ``generator`` (on the trainer's device)."""
        model = PCRNet(generator=generator)
        # coupled-L2 Adam, as torch.optim.Adam(lr, weight_decay)
        opt = torch_adam(model.parameters(), self.cfg.lr, self.cfg.weight_decay)
        return TrainState(model, opt, self.crit_init(generator), 0)

    def _train_step(self, state: TrainState, batch: RegistrationBatch
                    ) -> torch.Tensor:
        """PCRNet forward, the criterion (with phi's inner ascent step) and
        the model's Adam step, in place. Returns the detached loss."""
        source, target, _ = _mean_subtract(batch)
        with profiling.device_span("pcrnet_forward"):
            out = state.model(target, source, self.cfg.pcr_iteration_num)
        (loss, _, _), state.crit_state = self.crit_apply(
            state.crit_state, target, out.transformed_source, True)
        params = list(state.model.parameters())
        # the PCRNet parameters only: phi is a constant of this forward
        with profiling.device_span("backward"):
            grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        # the mean (or sum) over the active data group; nothing without one
        pmesh.reduce_gradients(params, self._reduce)
        with profiling.device_span("adam"):
            state.opt.step()
        return loss.detach()

    @torch.no_grad()
    def _eval_step(self, state: TrainState, batch: RegistrationBatch):
        """Validation pass of one batch: loss in test mode + pose errors."""
        source, target, translation = _mean_subtract(batch)
        with profiling.device_span("pcrnet_forward"):
            out = state.model(target, source, self.cfg.pcr_iteration_num)
        (loss, _, _), _ = self.crit_apply(
            state.crit_state, target, out.transformed_source, False)
        rot_err = rotation_error_deg(batch.igt_rotation, out.est_R)
        trans_err = translation_error(batch.igt_rotation, translation,
                                      out.est_t[:, 0, :])
        return torch.stack([loss, torch.mean(rot_err), torch.mean(trans_err)])

    # -- fused execution -------------------------------------------------------

    def _graphs_for(self, state: TrainState) -> dict:
        """The step graphs and static accumulators of ``state`` (made anew
        for another state object)."""
        if self._fused.get("state") is not state:
            self._fused = {"state": state, "graphs": {}, "solves": {},
                           "loss_sum": torch.zeros((), device=self.device),
                           "val_sums": torch.zeros(3, device=self.device),
                           "val_split": torch.zeros(3, device=self.device)}
            if self.device.type == "cuda":
                # Adam's lazily made state must exist before a capture
                for opt in (state.opt, getattr(state.crit_state, "opt", None)):
                    if opt is not None:
                        init_adam_state(opt)
        return self._fused

    def _step_graph(self, state: TrainState, key: tuple, fn, batch) -> StepGraph:
        """The graph of ``fn`` under ``key``, made at its first use: its
        warm-up runs the step once on the real state and puts every tensor
        and generator back."""
        fused = self._graphs_for(state)
        graph = fused["graphs"].get(key)
        if graph is None:
            acc = (fused["loss_sum"], fused["val_sums"], fused["val_split"])

            def warmup(*inputs):
                with preserved(state, acc):
                    fn(*inputs)

            solver = (f"/{self.cfg.shwd.transport.solver}"
                      if self.cfg.criterion in ("w_cos", "w1_cos", "pseudo_w_cos") else "")
            name = f"{key[0]} step of {self.cfg.criterion}{solver} at {tuple(batch[1].shape)}"
            graph = StepGraph(name, fn, batch, device=self.device, warmup=warmup,
                              generators=step_generators(state.crit_state))
            fused["graphs"][key] = graph
        return graph

    def _train_one_epoch_fused(self, state, dataset, indices, generator, rng):
        """The per-step loop's batches (the same shuffle and draws), this
        rank's rows of each through the captured train step, which adds its
        loss to a static device scalar, reduced over the data group and read
        once at the end."""
        fused = self._graphs_for(state)
        loss_sum = fused["loss_sum"]
        loss_sum.zero_()
        # SHWD's inner steps run or not by the strike count, which moves
        # only between epochs: a graph for each
        gate = (self.cfg.criterion not in ("w_cos", "w1_cos")
                or inner_gate(self.cfg.shwd, state.crit_state.strikes))

        key = ("train", gate)
        solves = fused["solves"]

        def step(*inputs):
            loss_sum.add_(self._train_step(state, RegistrationBatch(*inputs)))
            # the solves this graph's replays rewrite (on the CPU, this call's)
            solves[key] = getattr(self._criterion, "train_solves", None)

        count = 0
        batch_s = launch_s = 0.0
        with profiling.span("train.pass") as rec:
            # host seconds from asking the iterator for a batch to holding
            # this rank's rows, and inside the graph's call (the copies into
            # its static inputs and the replay); the first capture counts
            # in neither
            clock = time.perf_counter()
            for batch in dataset.batches(generator, indices, self.cfg.batch_size,
                                         shuffle=True, rng=rng):
                rows = self._rows(batch)
                batch_s += time.perf_counter() - clock
                graph = self._step_graph(state, key, step, rows)
                graph.capture()
                launch = time.perf_counter()
                graph(*rows)
                clock = time.perf_counter()
                launch_s += clock - launch
                count += 1
            loss = float(pmesh.reduce_values(loss_sum, self._reduce)) / max(count, 1)
            fused["last_train"] = key
            self._collect()
            rec.attrs.update(steps=count, batch_s=batch_s, launch_s=launch_s)
        return state, loss

    # -- epochs ----------------------------------------------------------------

    def train_one_epoch(self, state, dataset, indices, generator, rng):
        if self.execution_path() == "fused":
            return self._train_one_epoch_fused(state, dataset, indices, generator, rng)
        total = torch.zeros((), device=self.device)
        count = 0
        for batch in dataset.batches(generator, indices, self.cfg.batch_size,
                                     shuffle=True, rng=rng):
            pre = state_payload(state) if self.cfg.nan_guard else None
            loss = self._train_step(state, self._rows(batch))
            if self.cfg.nan_guard:
                value = float(pmesh.reduce_values(loss, self._reduce))
                if not np.isfinite(value):
                    self._dump_nan_forensics(pre, state.epoch, batch, value)
            total = total + loss
            count += 1
        return state, float(pmesh.reduce_values(total, self._reduce)) / max(count, 1)

    def _dump_nan_forensics(self, pre_state: dict, epoch: int, batch, loss):
        """Persist the offending inputs and the pre-step train state (incl.
        phi and its optimizer), then raise."""
        dump_dir = Path(self.cfg.log_dir) / self.cfg.experiment / "nan_dump"
        if self._writer:
            dump_dir.mkdir(parents=True, exist_ok=True)
            np.savez(dump_dir / "batch.npz",
                     **{k: v.detach().cpu().numpy() for k, v in batch._asdict().items()})
            save_checkpoint(dump_dir / "state_pre_step", pre_state, epoch)
        raise FloatingPointError(
            f"non-finite train loss ({loss}); batch and pre-step state "
            f"dumped to {dump_dir}")

    def eval_one_epoch(self, state, dataset, indices, generator):
        """Sample-weighted validation means over ALL val items.

        Uses drop_remainder=False so a val split smaller than batch_size
        still evaluates; raises rather than silently returning 0.0 when
        there is nothing to evaluate. Under a mesh, a batch that divides over
        ``data`` is split and reduced at the end of the pass; one that does
        not is computed whole on every rank (the JAX package's replicated
        fallback). On the fused path each batch shape has its captured eval
        step (the whole batch's captured with no data group active), adding
        into static device vectors. The pass is the span
        ``train.eval_pass``.
        """
        with profiling.span("train.eval_pass"):
            return self._eval_pass(state, dataset, indices, generator)

    def _eval_pass(self, state, dataset, indices, generator):
        fused = self.execution_path() == "fused"
        if fused:
            acc = self._graphs_for(state)
            sums, split = acc["val_sums"].zero_(), acc["val_split"].zero_()
        else:
            sums, split = (torch.zeros(3, device=self.device) for _ in range(2))
        n_items = 0
        for batch in dataset.batches(generator, indices, self.cfg.batch_size,
                                     shuffle=False, drop_remainder=False):
            b = batch.source.shape[0]
            divides = self.mesh is not None and b % self._n_data == 0
            rows, into = (self._rows(batch), split) if divides else (batch, sums)

            def step(*inputs, b=b, into=into):
                into.add_(self._eval_step(state, RegistrationBatch(*inputs)) * b)

            with contextlib.nullcontext() if divides else pmesh.data_parallel(None):
                if fused:
                    self._step_graph(state, ("eval", b), step, rows)(*rows)
                else:
                    step(*rows)
            n_items += b
        if n_items == 0:
            raise ValueError(
                "validation set produced no batches: check val_split / "
                "batch_size (eval never drops remainders, so this means the "
                "val index set itself is empty)")
        if self.mesh is not None:
            split = pmesh.reduce_values(split, "mean", self._data_group)
            if self._reduce == "sum":       # a summed loss adds up over ranks
                split[0] *= self._n_data
            sums = sums + split
        loss, rot, trans = (sums / n_items).tolist()
        if fused:
            self._collect()
        return loss, rot, trans

    def _collect(self) -> None:
        """The device marks of every graph replayed since its last collect
        (``StepGraph.collect``); call after a host sync."""
        for graph in self._fused.get("graphs", {}).values():
            graph.collect()

    def last_solves(self) -> list[dict] | None:
        """The exact-EMD solves of the last train step on the ``hybrid``
        solver, in order (phi's inner ones, then the final one), as copies:
        each a dict of ``assign`` (the permutation the loss was gathered
        at, (B, N) int32; a sweep-cap straggler takes its row's argmin),
        ``sweeps`` (B,), ``prices`` (B, N), ``stragglers`` (B,), the
        persons the sweep cap left unassigned, and ``x`` and ``y`` (B, N,
        3), phi's images of the two clouds, from which the solve's cost was
        built. None for another criterion or solver, or before a train
        step. On the fused path the tensors are the captured step's own, so
        the read adds nothing to the step; the copies are ordered after its
        last replay on the stream."""
        fused = self._fused.get("solves", {}).get(self._fused.get("last_train"))
        solves = fused if self.execution_path() == "fused" else getattr(
            self._criterion, "train_solves", None)
        if not solves:
            return None
        return [{**{k: s[k].clone() for k in ("assign", "sweeps", "prices", "x", "y")},
                 "stragglers": (s["unassigned"] < 0).sum(-1)} for s in solves]

    def graph_stats(self) -> list[dict]:
        """``StepGraph.stats()`` of each step graph of the state being
        fitted (the train step per gate, the eval step per batch shape)."""
        return [g.stats() for g in self._fused.get("graphs", {}).values()]

    # -- full run ----------------------------------------------------------------

    def fit(self, train_ds: RegistrationDataset,
            val_ds: Optional[RegistrationDataset] = None,
            verbose: bool = True) -> dict:
        cfg = self.cfg
        log_dir = Path(cfg.log_dir) / cfg.experiment
        models_dir = log_dir / "models"
        logger = None
        if self._writer:
            models_dir.mkdir(parents=True, exist_ok=True)
            cfg.save(log_dir / "config.json")
            logger = RunLogger(log_dir)
        verbose = verbose and self._writer

        path = self.execution_path()
        self._fused, graph_stats = {}, []
        rng = np.random.default_rng(cfg.seed)
        gen_init = torch.Generator(device=self.device).manual_seed(cfg.seed)
        gen_data = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        state = self.init_state(gen_init)

        if cfg.load_model and cfg.load_model != "None":
            state, start_epoch = load_checkpoint(cfg.load_model, state)
        else:
            start_epoch = 0

        if val_ds is None:
            train_idx, val_idx = train_ds.train_val_indices(rng)
            val_src = train_ds
        else:
            train_idx = np.arange(len(train_ds))
            val_idx = np.arange(len(val_ds))
            val_src = val_ds

        best = {"loss": np.inf, "rot": np.inf, "trans": np.inf,
                "combined": np.inf}
        # Best-state snapshots are copies on the device, taken at the
        # improving epoch (the live state keeps changing in place); disk
        # flushes happen every cfg.checkpoint_flush_every epochs and at the
        # end of fit.
        snap_files = {"loss": "best_model_snap", "rot": "best_rot_error_snap",
                      "trans": "best_trans_error_snap",
                      "combined": "best_combined_snap"}
        pending_snaps: dict = {}

        def flush_snaps():
            for fam, (payload, ep) in pending_snaps.items():
                save_checkpoint(models_dir / snap_files[fam], payload, ep)
            pending_snaps.clear()

        history = []
        # exception/^C-safe flush: a SIGTERM-killed or crashed run still
        # writes every best state tracked so far; only SIGKILL can lose
        # improvements since the last periodic flush. SIGTERM does not
        # unwind Python frames by default, so it becomes KeyboardInterrupt
        # for the duration of the fit.
        def _term(signum, frame):
            raise KeyboardInterrupt("SIGTERM")

        try:
            old_term = signal.signal(signal.SIGTERM, _term)
            term_installed = True
        except ValueError:          # not the main thread
            old_term, term_installed = None, False
        # the ops' batch-wide reductions see the data group for the whole fit
        group_scope = pmesh.data_parallel(self._data_group)
        group_scope.__enter__()
        try:
            for epoch in range(start_epoch, cfg.num_epochs):
                t0 = time.perf_counter()
                state.epoch = epoch
                state, train_loss = self.train_one_epoch(
                    state, train_ds, train_idx, gen_data, rng)
                # the epoch's loss was read on the host: the card is idle
                train_dt = time.perf_counter() - t0
                val_loss, rot_err, trans_err = self.eval_one_epoch(
                    state, val_src, val_idx, gen_data)
                dt = time.perf_counter() - t0
                state.epoch = epoch + 1

                improved = val_loss < best["loss"]
                if not improved and self._early_stop_enabled:
                    # a non-improving epoch counts a strike; past the limit
                    # the SHWD inner adversarial loop is skipped
                    state.crit_state.strikes += 1
                marks = {"loss": val_loss, "rot": rot_err, "trans": trans_err}
                if cfg.checkpoint_combined_weight > 0:
                    marks["combined"] = (
                        rot_err + cfg.checkpoint_combined_weight * trans_err)
                payload = None
                for fam, value in marks.items():
                    if value < best[fam]:
                        best[fam] = value
                        if not self._writer:
                            continue
                        if payload is None:
                            payload = state_payload(state)
                        pending_snaps[fam] = (payload, epoch + 1)
                if (cfg.checkpoint_flush_every
                        and (epoch + 1) % cfg.checkpoint_flush_every == 0):
                    flush_snaps()

                row = dict(epoch=epoch + 1, train_loss=train_loss,
                           val_loss=val_loss, best_loss=best["loss"],
                           rot_error=rot_err, best_rot_error=best["rot"],
                           trans_error=trans_err,
                           best_trans_error=best["trans"], seconds=dt,
                           train_seconds=train_dt,
                           train_steps=len(train_idx) // cfg.batch_size, path=path)
                history.append(row)
                if logger is not None:
                    logger.log(row)
                if verbose:
                    print(f"EPOCH:: {epoch+1}, Training Loss: "
                          f"{train_loss*100:.4f}, Val Loss: {val_loss*100:.4f},"
                          f" Rot error: {rot_err:.3f},"
                          f" Trans error: {trans_err:.4f}, Time: {dt:.2f}s")
        finally:
            group_scope.__exit__(None, None, None)
            # the graphs and their memory pools go with the fit
            graph_stats = self.graph_stats()
            self._fused = {}
            flush_snaps()
            if logger is not None:
                logger.close()
            if term_installed:
                # restore keyed on "we installed", not "old was non-None"
                # (signal.signal returns None when the previous disposition
                # was set outside Python)
                signal.signal(signal.SIGTERM,
                              old_term if old_term is not None
                              else signal.SIG_DFL)
        return {"best": best, "history": history, "state": state, "path": path,
                "graphs": graph_stats}
