#!/usr/bin/env python3
"""One registration train call of a row, the JAX package beside the port,
on the CPU, from one state and one batch.

Both packages take the same state: the JAX package's seed-1234 initial
state of the row (``tools/init_states_jax.npz``, the default; the JAX
side draws it itself, the port loads it through the row harness), or
with ``--checkpoint`` a port checkpoint of a ``max_ssw`` row (a snapshot
brought back from the card: PCRNet, the chart and the chart's Adam
moments and count; PCRNet's Adam starts at zero on both sides). Both get
the same batch (the first ``batch_size`` clouds of the row's bank at its
width, through the port's data pipeline with a generator seeded 0,
handed over as numpy) and the frames
the JAX call draws. One JSON line gives, as the largest difference over
the largest JAX magnitude: the loss, the pose before the step, PCRNet's
gradients and its parameters after the Adam step, and the criterion
state after the call (phi or the chart and their Adam moments, lam).

    python tests/compare_train_step.py --row w_cos
    python tests/compare_train_step.py --row max_ssw_resume \\
        --checkpoint snapshots/max_ssw_resume_best_rot.pt

Not collected by pytest. A minute or two at the row's width (B=128,
N=M=128): the JAX side compiles its train step.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from shwd_torch.data import RegistrationBatch, RegistrationDataset  # noqa: E402
from shwd_torch.train import Trainer  # noqa: E402
from shwd_torch.utils.convert import (chart_tree, max_ssw_adam_tree, pcrnet_tree,  # noqa: E402
                                      phi_tree)
from shwd_tpu import data as jd  # noqa: E402
from shwd_tpu import train as jt  # noqa: E402
from shwd_tpu.ops.spherical import stiefel_frames  # noqa: E402
from shwd_tpu.train.config import config_from_dict  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "registration_rows_torch", ROOT / "tools" / "registration_rows_torch.py")
harness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(harness)


def _flat(got, want):
    g = [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    return np.concatenate(g), np.concatenate(w)


def rel(got, want) -> float:
    """max |got - want| / max |want| over the leaves of two trees."""
    g, w = _flat(got, want)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def frames_of(cfg, key):
    """(inner-step frames, final frames) that the JAX train call draws from
    the criterion's ``key``; None where it draws none."""
    if cfg.criterion == "max_ssw":
        n = cfg.max_ssw.num_projections
        keys = jax.random.split(key, cfg.max_ssw.max_iter + 1)
        inner = jax.random.split(keys[0])[0]
    elif cfg.criterion == "w_cos" and cfg.shwd.transport.solver == "ssw":
        n = cfg.shwd.transport.num_projections
        keys = jax.random.split(key, cfg.shwd.max_iter + 1)
        inner = keys[0]
    else:
        return None
    final = jax.random.split(keys[-1])[0]
    return [torch.from_numpy(np.array(stiefel_frames(k, n, 3))) for k in (inner, final)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--row", required=True, help="a row of tools/init_states_jax.npz")
    ap.add_argument("--checkpoint", default=None,
                    help="a port checkpoint of a max_ssw row (model, crit)")
    args = ap.parse_args()
    torch.set_num_threads(4)
    seed = int(np.load(harness.INIT_FILE)["seed"])
    cfg = harness.row_config(args.row, seed, "/nonexistent")
    jcfg = config_from_dict(json.loads(cfg.to_json()))

    ds = RegistrationDataset(cfg.dataset, "train", device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = next(ds.batches(gen, np.arange(cfg.batch_size), cfg.batch_size, shuffle=False))
    arrays = [t.numpy().copy() for t in batch]

    trainer = Trainer(cfg, device="cpu")
    jtr = jt.Trainer(jcfg)
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    jstate = jtr.init_state(k_init)
    if args.checkpoint is None:
        tstate = harness.jax_init_state(trainer, args.row, seed)
    else:
        if cfg.criterion != "max_ssw":
            ap.error("--checkpoint takes a max_ssw row")
        tstate = trainer.init_state(torch.Generator().manual_seed(0))
        payload = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        tstate.model.load_state_dict(payload["model"])
        crit = tstate.crit_state
        crit.phi.load_state_dict(payload["crit"]["phi"])
        crit.opt.load_state_dict(payload["crit"]["opt"])
        for group in crit.opt.param_groups:    # a card's capturable Adam, on the CPU
            group["capturable"] = False
        for st in crit.opt.state.values():
            st["step"] = st["step"].cpu()
        count = int(next(iter(crit.opt.state.values()))["step"])
        adam, *rest = jstate.crit_state.opt_state
        mu, nu = (jax.tree_util.tree_map(jnp.asarray, m)
                  for m in max_ssw_adam_tree(crit.opt, crit.phi)[:2])
        adam = adam._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
        jstate = jstate._replace(
            params=jax.tree_util.tree_map(jnp.asarray, pcrnet_tree(tstate.model)),
            crit_state=jstate.crit_state._replace(
                phi_params=jax.tree_util.tree_map(jnp.asarray, chart_tree(crit.phi)),
                opt_state=(adam, *rest)))

    # the JAX call: loss, pose, gradients, then the step
    jbatch = jd.RegistrationBatch(*(jnp.asarray(a) for a in arrays))

    def loss_fn(params, crit_state):
        source, target, _ = jt.trainer._mean_subtract(jbatch)
        out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
        (loss, _, _), _ = jtr.crit_apply(crit_state, target, out.transformed_source, True)
        return loss, (out.est_R, out.est_t)

    (jloss, jpose), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate.crit_state)
    jnew, _ = jtr._train_step(jstate, jbatch, train=True)

    # the port's call on the same state, batch and frames
    crit_obj = trainer.crit_apply.__self__
    frames = frames_of(jcfg, jstate.crit_state.key)
    if frames is not None:
        it = iter(frames)
        if cfg.criterion == "max_ssw":
            crit_obj.draw = lambda minibatch: (next(it), None)
        else:
            inner = crit_obj.transport
            crit_obj.transport = lambda sx, sy, *_: inner(sx, sy, frames=next(it))
    tbatch = RegistrationBatch(*(torch.from_numpy(a) for a in arrays))
    with torch.no_grad():
        src = tbatch.source - tbatch.source.mean(1, keepdim=True)
        tgt = tbatch.target - tbatch.target.mean(1, keepdim=True)
        tout = tstate.model(tgt, src, cfg.pcr_iteration_num)
    tloss = trainer._train_step(tstate, tbatch)
    tgrads = {g: [{k: getattr(layer, k).grad.numpy() for k in ("w", "b")} for layer in layers]
              for g, layers in (("feature", tstate.model.feature_model.layers),
                                ("head", tstate.model.head))}
    out = {"row": args.row, "checkpoint": args.checkpoint, "batch": list(arrays[0].shape),
           "loss_port": float(tloss), "loss_jax": float(jloss),
           "loss": abs(float(tloss) - float(jloss)) / abs(float(jloss)),
           "est_R": rel(tout.est_R.numpy(), jpose[0]), "est_t": rel(tout.est_t.numpy(), jpose[1]),
           "grads": {g: rel(tgrads[g], jax.tree_util.tree_map(np.asarray, jgrads[g]))
                     for g in ("feature", "head")},
           "params_after": rel(pcrnet_tree(tstate.model),
                               jax.tree_util.tree_map(np.asarray, jnew.params)),
           # PCRNet's Adam starts at zero on both sides: its first step moves
           # each weight by about +-lr, so rounding-noise gradients part by 2 lr
           "params_after_max_abs": float(np.max(np.abs(np.subtract(*_flat(
               pcrnet_tree(tstate.model), jax.tree_util.tree_map(np.asarray, jnew.params)))))),
           "lr": cfg.lr}
    jc, tc = jnew.crit_state, tstate.crit_state
    if cfg.criterion == "max_ssw":
        out["chart_after"] = rel(chart_tree(tc.phi), jax.tree_util.tree_map(np.asarray,
                                                                          jc.phi_params))
        adam = jc.opt_state[0]
        mu, nu, _ = max_ssw_adam_tree(tc.opt, tc.phi)
        out["chart_adam_mu"] = rel(mu, adam.mu)
        out["chart_adam_nu"] = rel(nu, adam.nu)
    elif cfg.criterion == "w_cos":
        out["phi_after"] = rel(phi_tree(tc.phi)[0], jax.tree_util.tree_map(np.asarray,
                                                                          jc.phi_params))
        out["lam_port"], out["lam_jax"] = float(tc.lam), float(jc.lam)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
