#!/usr/bin/env python3
"""Replay a recorded port fit in both packages on the CPU: from the
record's state, with the record's batches and criterion draws.

A record (``tools/registration_rows_torch.py --record-dir ...``, on the
card or the CPU) holds the port's state at the start of an epoch in the
JAX layout (``shwd_torch.utils.convert.export_state``), every batch of
the recorded epochs as the port's data pipeline made it (the bank rows,
the transformed source, the pose) and every draw its criterion made (the
SSW frames of SHWD on ``ssw`` and of max-SSW; max-SSW's subsets). Both
packages run the recorded epochs on their per-step paths from that state:

  - the port through ``replay_port`` (its ``Trainer.train_one_epoch`` and
    ``eval_one_epoch``, the recorded batches for the dataset's, the
    recorded draws for the criterion's);
  - the JAX package through its own ``Trainer.train_one_epoch`` and
    ``eval_one_epoch`` (``fused_epoch=False``), the recorded batches for
    the dataset's (``make_registration_batch``'s output, in the record's
    order), and ``Trainer._step`` / ``_eval`` jitted with the batch's frames
    as arguments: while the step is traced, ``stiefel_frames`` of
    ``shwd_tpu.losses.transport`` and ``shwd_tpu.losses.ssw_loss`` returns
    the handed-in frames in the order the step draws them, in place of a
    draw from the state's key (names patched here at run time only; every
    row runs one inner step, so each draw site is traced once).

It prints, per train step, each side's loss and mean rotation error of
the step's pose against the recorded ground truth, and per epoch each
side's validation rotation and translation errors beside the history the
fit recorded. It ends with one JSON line: the first step where the two
packages part by more than the step tests' tolerances
(``tests/test_torch_trainer_criteria.py``: the loss at rtol 1e-3; phi or
the chart after the step at rtol 1e-4 / atol 2e-5), the largest per-epoch
validation difference between them, and how far the port's CPU replay
lies from the recorded history (the card's, where it was recorded there:
K3 there, the plain route here). Past the first steps the two packages
run from states that rounding has already moved apart, so a parting there
is not yet a fault: ``--sync`` also gives, before every port step, one
JAX train call from the port's own state (exported and read into the JAX
state), held to the step tests' tolerances all along the port's
trajectory: the loss at rtol 1e-3, PCRNet's gradients within 1e-3 of the
largest (and the share of entries past the per-entry rule of
``test_torch_trainer._compare_model``), phi or the chart at rtol 1e-4 /
atol 2e-5; beside them, as a control, how far the JAX gradients move from
the same state with PCRNet's weights moved by one ulp.

    python tests/replay_fit.py log/replay/robust_noise_0.04_s1234 [--epochs 0:3]
    python tests/replay_fit.py log/replay/<record> --side port --sync --epochs 508:509

Not collected by pytest. The JAX side compiles a train and an eval step
per batch shape (~30 s); at B=128, N=M=128 an epoch takes ~1 min a side.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from shwd_torch.ops.quaternion import rotation_error_deg  # noqa: E402
from shwd_torch.utils.convert import chart_tree, phi_tree  # noqa: E402
from shwd_tpu import data as jd  # noqa: E402
from shwd_tpu import train as jt  # noqa: E402
from shwd_tpu.losses import ssw_loss as j_ssw_loss  # noqa: E402
from shwd_tpu.losses import transport as j_transport  # noqa: E402
from shwd_tpu.ops.quaternion import rotation_error_deg as j_rotation_error_deg  # noqa: E402
from shwd_tpu.train.config import config_from_dict  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "registration_rows_torch", ROOT / "tools" / "registration_rows_torch.py")
harness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(harness)

LOSS_RTOL = 1e-3
PHI_RTOL, PHI_ATOL = 1e-4, 2e-5
HISTORY_KEYS = ("train_loss", "val_loss", "rot_error", "trans_error")


def _path_key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def fill(template, data, prefix: str):
    """``template`` (a JAX tree) with each leaf read from ``data`` at
    ``prefix/<path>`` (``export_state``'s layout), in the leaf's dtype."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in leaves:
        key = "/".join(p for p in (prefix, _path_key(path)) if p)
        arr = np.asarray(data[key])
        if arr.shape != np.shape(leaf):
            raise ValueError(f"{key}: shape {arr.shape} != {np.shape(leaf)}")
        out.append(jnp.asarray(arr, dtype=jnp.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _with_adam(chain, data, prefix: str):
    """An optax chain state with its ``ScaleByAdamState`` read from
    ``prefix/{count,mu,nu}``."""
    out = []
    for s in chain:
        if isinstance(s, optax.ScaleByAdamState):
            s = optax.ScaleByAdamState(
                count=jnp.asarray(data[f"{prefix}/count"], jnp.int32),
                mu=fill(s.mu, data, f"{prefix}/mu"), nu=fill(s.nu, data, f"{prefix}/nu"))
        out.append(s)
    return type(chain)(out)


def jax_state(jtr, data, template=None):
    """The JAX ``TrainState`` of an ``export_state`` record (the key of
    the criterion state is a placeholder: the draws are handed in);
    ``template`` is a state of ``jtr`` to fill (default: a fresh one)."""
    if template is None:
        template = jtr.init_state(jax.random.PRNGKey(0))
    crit = template.crit_state
    if crit != ():
        fields = dict(phi_params=fill(crit.phi_params, data, "crit/phi_params"),
                      phi_state=fill(crit.phi_state, data, "crit/phi_state"))
        if hasattr(crit, "opt_state"):
            fields["opt_state"] = _with_adam(crit.opt_state, data, "crit/adam")
        if hasattr(crit, "lam"):
            fields["lam"] = jnp.asarray(data["crit/lam"], jnp.float32)
            fields["strikes"] = jnp.asarray(data["crit/strikes"], jnp.int32)
        crit = crit._replace(**fields)
    return jt.TrainState(fill(template.params, data, "pcrnet"),
                         _with_adam(template.opt_state, data, "pcrnet_adam"), crit,
                         jnp.asarray(data["epoch"], jnp.int32))


@contextlib.contextmanager
def handed_frames(frames):
    """While a step is traced, ``stiefel_frames`` returns ``frames`` in
    order; every one must be taken."""
    queue = list(frames)
    plain = j_transport.stiefel_frames, j_ssw_loss.stiefel_frames

    def take(key, num_projections, d=3, batch_shape=()):
        if not queue:
            raise RuntimeError("the JAX step drew more frames than the record holds")
        f = queue.pop(0)
        if f.shape != (*batch_shape, num_projections, d, 2):
            raise ValueError(f"recorded frames {f.shape}, the step draws "
                             f"{(*batch_shape, num_projections, d, 2)}")
        return f
    j_transport.stiefel_frames = j_ssw_loss.stiefel_frames = take
    try:
        yield
        if queue:
            raise RuntimeError(f"the JAX step left {len(queue)} recorded frames")
    finally:
        j_transport.stiefel_frames, j_ssw_loss.stiefel_frames = plain


class _Batches:
    """The record's batches of one epoch and phase as the JAX package's
    ``make_registration_batch`` would return them (arguments ignored: the
    record fixes the order); ``sink`` gets each batch's frames."""

    def __init__(self, record, epoch, phase, targets, sink):
        self.record, self.keys = record, record.batch_keys(epoch, phase)
        self.targets, self.sink = targets, sink

    def batches(self, *args, **kwargs):
        for key in self.keys:
            b = self.record.batch(key)
            draws = self.record.batch_draws(key)
            if any(idx is not None for _, idx in draws):
                raise NotImplementedError("max-SSW subsets are not handed to the JAX side")
            self.sink[:] = [jnp.asarray(f) for f, _ in draws]
            yield jd.RegistrationBatch(jnp.asarray(self.targets[b["index"]]),
                                       *(jnp.asarray(b[k]) for k in
                                         ("source", "igt_rotation", "igt_translation")))


class JaxSide:
    """The JAX package's trainer for a record's config, with its train
    and eval steps jitted with the batch's frames as an argument, its
    gradient of the train loss, and the mean rotation error of a pose."""

    def __init__(self, record):
        cfg = record.config(fused_epoch=False, load_model=None)
        jcfg = config_from_dict(json.loads(cfg.to_json()))
        self.jtr = jtr = jt.Trainer(jcfg)
        inner = {"w_cos": jcfg.shwd.max_iter, "w1_cos": jcfg.shwd.max_iter,
                 "max_ssw": jcfg.max_ssw.max_iter}.get(jcfg.criterion, 1)
        if inner != 1:
            raise NotImplementedError(f"max_iter={inner}: one inner step is replayed")
        self.targets = np.asarray(harness_targets(cfg))
        self.template = jtr.init_state(jax.random.PRNGKey(0))

        def loss_fn(params, crit_state, batch):
            source, target, _ = jt.trainer._mean_subtract(batch)
            out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
            (loss, _, _), _ = jtr.crit_apply(crit_state, target, out.transformed_source, True)
            return loss

        def train(state, batch, frames):
            with handed_frames(frames):
                return jtr._step(state, batch, train=True)

        def evaluate(state, batch, frames):
            with handed_frames(frames):
                return jtr._eval(state, batch)

        def value_and_grad(state, batch, frames):
            with handed_frames(frames):
                return jax.value_and_grad(loss_fn)(state.params, state.crit_state, batch)

        def pose_error(params, batch):
            source, target, _ = jt.trainer._mean_subtract(batch)
            out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
            return jnp.mean(j_rotation_error_deg(batch.igt_rotation, out.est_R))

        self.train, self.evaluate = jax.jit(train), jax.jit(evaluate)
        self.value_and_grad, self.pose_error = jax.jit(value_and_grad), jax.jit(pose_error)

    def state(self, data):
        return jax_state(self.jtr, data, self.template)


def replay_jax(record, epochs, on_step=None):
    """The JAX package's per-step fit of the record's config over
    ``epochs`` from the record's state at ``epochs[0]``, every batch and
    draw handed in. ``on_step(epoch, k, loss, rot_error, state)`` after
    each train step (``rot_error``: the mean over the batch of the pose
    the step's forward gives). Returns the history rows."""
    side = JaxSide(record)
    jtr = side.jtr
    state = side.state(record.state(epochs[0]))
    frames: list = []
    count = {"k": 0}

    def train_step(state, batch):
        rot = float(side.pose_error(state.params, batch)) if on_step else None
        new, loss = side.train(state, batch, tuple(frames))
        if on_step is not None:
            on_step(int(state.epoch), count["k"], float(loss), rot, new)
        count["k"] += 1
        return new, loss

    jtr._train_step = lambda state, batch, train=True: train_step(state, batch)
    jtr._eval_step = lambda state, batch: side.evaluate(state, batch, tuple(frames))
    history = []
    for epoch in range(*epochs):
        t0 = time.perf_counter()
        count["k"] = 0
        state = state._replace(epoch=jnp.asarray(epoch, jnp.int32))
        state, train_loss = jtr.train_one_epoch(
            state, _Batches(record, epoch, "train", side.targets, frames), None, None, None)
        val_loss, rot, trans = jtr.eval_one_epoch(
            state, _Batches(record, epoch, "val", side.targets, frames), None, None)
        history.append(dict(epoch=epoch + 1, train_loss=train_loss, val_loss=val_loss,
                            rot_error=rot, trans_error=trans,
                            seconds=time.perf_counter() - t0))
    return history


def harness_targets(cfg):
    """The bank's target clouds (numpy, the port's pipeline; the JAX
    package's bank is the same bit for bit, ``test_torch_registration_rows``)."""
    from shwd_torch.data import RegistrationDataset
    return RegistrationDataset(cfg.dataset, "train", device="cpu").targets.numpy()


def criterion_params(criterion: str, crit) -> list | None:
    """phi's or the chart's parameters as flat numpy leaves, port or JAX."""
    if criterion in ("w_cos", "w1_cos", "max_ssw"):
        if hasattr(crit, "phi_params"):         # the JAX state
            tree = crit.phi_params
        else:
            tree = phi_tree(crit.phi)[0] if criterion != "max_ssw" else chart_tree(crit.phi)
        return [np.array(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(tree)]
    return None


def _excess_over(got, want, rtol, atol) -> float:
    """max |got - want| - (atol + rtol |want|) over two lists of arrays:
    > 0 is past the tolerance."""
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                            - (atol + rtol * np.abs(np.asarray(b, np.float64)))))
               for a, b in zip(got, want, strict=True))


def _grad_checks(port: list, ref: list) -> dict:
    """PCRNet's gradients: the largest difference over the largest JAX
    gradient (the measure of ``tests/compare_train_step.py``, held to
    1e-3), and the share of entries past ``_compare_model``'s per-entry
    rule (rtol 1e-3 over a floor of 1e-5 of the largest)."""
    gmax = max(float(np.abs(g).max()) for g in ref)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(port, ref, strict=True))
    past = sum(int(np.sum(np.abs(a - b) > LOSS_RTOL * (np.abs(b) + 1e-2 * gmax)))
               for a, b in zip(port, ref))
    return {"grad_rel_to_max": diff / gmax,
            "grad_share_past_per_entry": past / sum(b.size for b in ref)}


def one_ulp(data: dict, seed: int = 0) -> dict:
    """An ``export_state`` dict with every PCRNet weight moved by one ulp,
    up or down at random."""
    rng = np.random.default_rng(seed)
    return {k: (np.where(rng.random(v.shape) < 0.5, np.nextafter(v, np.inf),
                         np.nextafter(v, -np.inf)).astype(v.dtype)
                if k.startswith("pcrnet/") else v) for k, v in data.items()}


def _port_grads(model) -> list:
    from shwd_torch.utils.convert import pcrnet_tree
    tree = {g: [{k: getattr(layer, k).grad.detach().numpy() for k in ("w", "b")}
                for layer in layers]
            for g, layers in (("feature", model.feature_model.layers), ("head", model.head))}
    assert pcrnet_tree(model).keys() == tree.keys()
    return jax.tree_util.tree_leaves(tree)


def one_step_checks(side, trainer, state, batch, draws):
    """The JAX package's train call from the port's state before a step
    (``export_state`` -> ``jax_state``), on the step's batch and draws:
    returns check(port state after the step, port loss) -> the step
    tests' comparisons (loss rel; PCRNet's gradients, ``_grad_checks``;
    phi or the chart past rtol 1e-4 / atol 2e-5) and, as a control, the
    JAX gradients from the state moved by one ulp (``one_ulp``) against
    the JAX gradients from the state: how far rounding alone moves them."""
    from shwd_torch.utils.convert import export_state
    data = export_state(trainer, state)
    jstate = side.state(data)
    jbatch = jd.RegistrationBatch(*(jnp.asarray(t.detach().cpu().numpy()) for t in batch))
    frames = tuple(jnp.asarray(f.cpu().numpy()) for f, _ in draws)
    jloss, jgrads = side.value_and_grad(jstate, jbatch, frames)
    jnew, _ = side.train(jstate, jbatch, frames)
    jg = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(jgrads)]
    # the control: JAX against itself from the state moved by one ulp
    _, moved = side.value_and_grad(side.state(one_ulp(data)), jbatch, frames)
    control = _grad_checks([np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(moved)],
                           jg)

    def check(state_after, loss):
        crit = trainer.cfg.criterion
        port_crit = criterion_params(crit, state_after.crit_state)
        return {"loss_rel": abs(loss - float(jloss)) / max(abs(float(jloss)), 1e-30),
                **_grad_checks([np.asarray(g, np.float64) for g in
                                _port_grads(state_after.model)], jg),
                **{f"jax_one_ulp_{k}": v for k, v in control.items()},
                "crit_excess": (None if port_crit is None else _excess_over(
                    port_crit, criterion_params(crit, jnew.crit_state), PHI_RTOL, PHI_ATOL))}
    return check


def compare(record, epochs, sides=("port", "jax"), sync=False) -> dict:
    """Replay ``epochs`` on ``sides`` and compare; returns the summary.
    ``sync``: before every port step the JAX package also takes one train
    call from the port's state (``one_step_checks``), which holds the two
    to the step tests' tolerances along the port's own trajectory."""
    crit_name = record.meta["config"]["criterion"]
    steps = {side: [] for side in sides}
    seconds, hist, synced = {}, {}, []
    side_jax = JaxSide(record) if sync else None
    holder = types.SimpleNamespace(cfg=record.config())    # what export_state reads
    seen = {}

    def port_step(state, k, batch, draws, step):
        if "hook" not in seen:
            seen["hook"] = state.model.register_forward_hook(
                lambda m, i, out: seen.update(est_R=out.est_R.detach()))
        check = (one_step_checks(side_jax, holder, state, batch, draws)
                 if sync else None)
        out = step(state, batch)
        loss = float(out)
        rot = float(torch.mean(rotation_error_deg(batch.igt_rotation, seen["est_R"])))
        steps["port"].append((state.epoch, k, loss, rot,
                              criterion_params(crit_name, state.crit_state)))
        line = f"port  epoch {state.epoch} step {k}: loss {loss:.9g} rot {rot:.4f}"
        if check is not None:
            synced.append(dict(epoch=state.epoch, step=k, **check(state, loss)))
            line += "  one JAX step: " + json.dumps(synced[-1])
        print(line, flush=True)
        return out

    def jax_step(epoch, k, loss, rot, new):
        steps["jax"].append((epoch, k, loss, rot,
                             criterion_params(crit_name, new.crit_state)))
        print(f"jax   epoch {epoch} step {k}: loss {loss:.9g} rot {rot:.4f}", flush=True)

    for side in sides:
        t0 = time.perf_counter()
        if side == "port":
            hist["port"], _, _ = harness.replay_port(record, "cpu", epochs, port_step)
        else:
            hist["jax"] = replay_jax(record, epochs, jax_step)
        seconds[side] = time.perf_counter() - t0
    card = {r["epoch"]: r for r in record.history}
    for i, epoch in enumerate(range(epochs[0] + 1, epochs[1] + 1)):
        rec = card.get(epoch, {})
        cols = "  ".join(f"{side} {hist[side][i]['rot_error']:.4f} / "
                         f"{hist[side][i]['trans_error']:.5f}" for side in sides)
        print(f"epoch {epoch} val rot / trans: recorded {rec.get('rot_error', float('nan')):.4f}"
              f" / {rec.get('trans_error', float('nan')):.5f}  {cols}", flush=True)
    out = {"record": str(record.root), "row": record.meta.get("row"),
           "seed": record.meta.get("seed"), "init": record.meta.get("init"),
           "recorded_on": record.meta.get("device"), "epochs": list(epochs),
           "seconds": seconds,
           "history": {side: [{k: r[k] for k in ("epoch", *HISTORY_KEYS)} for r in hist[side]]
                       for side in sides},
           "recorded_history": [{k: card[e][k] for k in ("epoch", *HISTORY_KEYS)}
                                for e in range(epochs[0] + 1, epochs[1] + 1) if e in card]}
    for side in sides:
        got = {r["epoch"]: r for r in hist[side]}
        out[f"{side}_vs_recorded"] = {
            k: max((abs(got[e][k] - card[e][k]) for e in got if e in card), default=None)
            for k in HISTORY_KEYS}
    if set(sides) == {"port", "jax"}:
        out["step_tolerances"] = {"loss_rtol": LOSS_RTOL, "phi_rtol": PHI_RTOL,
                                  "phi_atol": PHI_ATOL}
        first = None
        for (e, k, tl, tr, tp), (_, _, jl, jr, jp) in zip(steps["port"], steps["jax"]):
            rel = abs(tl - jl) / max(abs(jl), 1e-30)
            excess = _excess_over(tp, jp, PHI_RTOL, PHI_ATOL) if tp is not None else None
            if first is None and (rel > LOSS_RTOL or (excess is not None and excess > 0)):
                first = {"epoch": e, "step": k, "loss_port": tl, "loss_jax": jl,
                         "loss_rel": rel, "params_excess_over_tol": excess,
                         "rot_port": tr, "rot_jax": jr}
        out["steps_compared"] = min(len(steps["port"]), len(steps["jax"]))
        out["first_parting_step"] = first
        out["step_loss_rel"] = [abs(a[2] - b[2]) / max(abs(b[2]), 1e-30)
                                for a, b in zip(steps["port"], steps["jax"])]
        out["step_rot"] = [[a[3], b[3]] for a, b in zip(steps["port"], steps["jax"])]
        out["largest_val_diff"] = {
            k: max(abs(a[k] - b[k]) for a, b in zip(hist["port"], hist["jax"]))
            for k in ("val_loss", "rot_error", "trans_error")}
    if sync:
        past = [c for c in synced if c["loss_rel"] > LOSS_RTOL
                or c["grad_rel_to_max"] > LOSS_RTOL
                or (c["crit_excess"] is not None and c["crit_excess"] > 0)]
        out["one_step"] = {
            "steps": len(synced), "first_past_tolerance": past[0] if past else None,
            "steps_past_tolerance": len(past),
            **{f"worst_{k}": max((c[k] for c in synced if c[k] is not None), default=None)
               for k in ("loss_rel", "grad_rel_to_max", "grad_share_past_per_entry",
                         "crit_excess", "jax_one_ulp_grad_rel_to_max",
                         "jax_one_ulp_grad_share_past_per_entry")},
            "per_step": synced}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("record", help="a record directory (meta.json, state_<E>.npz, draws.npz)")
    ap.add_argument("--epochs", type=harness.epoch_range, default=None, metavar="A:B",
                    help="default: from the earliest stored state to the recorded end")
    ap.add_argument("--side", choices=("both", "port", "jax"), default="both")
    ap.add_argument("--sync", action="store_true",
                    help="before every port step, one JAX train call from the port's state")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    record = harness.Record(args.record)
    epochs = args.epochs or (min(record.meta["states"]), record.meta["epochs"][1])
    sides = ("port", "jax") if args.side == "both" else (args.side,)
    out = compare(record, epochs, sides, args.sync)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    brief = {k: v for k, v in out.items()
             if k not in ("history", "recorded_history", "step_loss_rel", "step_rot")}
    if "one_step" in brief:
        brief["one_step"] = {k: v for k, v in brief["one_step"].items() if k != "per_step"}
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
