#!/usr/bin/env python3
"""First epochs of the W_COS registration trainer, JAX package beside the
PyTorch port, on the CPU.

Both trainers get the registration config of ``chip_smoke.py`` (B=128,
N=M=128, full-width PCRNet, 3 Residual layers, the procedural shape bank
with 256 shapes, solver "sinkhorn") and their own random streams, so the
curves are two samples of one process, not one trajectory. The script
prints, per epoch and side, the train loss and the validation rotation and
translation errors, then one JSON line with the first and last rows. It
answers whether a movement of the validation errors over the first epochs
is the method's or the port's.

    python tests/compare_registration_curves.py [--epochs 40] [--side both]
        [--seeds 0 1 2] [--device cpu|cuda] [--plain-route]
        [--row w_cos --seed 1234 [--init jax]]

``--row`` takes instead the config of one row of
``tools/registration_rows_torch.py`` (its bank, ``modelnet_root`` and exact
knobs; ``--solver`` is ignored then), both sides from the same config,
with ``--seed`` (default: the row's) for its seed; on the 2048-shape bank
an epoch takes about 60 s per side on the CPU.

``--init jax`` (with ``--row``) starts both sides from the JAX package's
initial state of the row, ``tools/init_states_jax.npz`` (seed 1234 only):
the JAX fit at that seed draws exactly that state, and the port loads it
as an epoch-0 checkpoint (``--init jax`` of the row harness). The two
curves then differ only by the per-batch transform draws (and, where the
criterion draws them, the SSW frames).

``--side torch --device cuda`` runs the port alone on a card (no JAX is
imported then); there ``--plain-route`` sends the transport through
``cost_matrix`` + ``emd2_approx`` instead of the fused CUDA kernel, which
is the route both packages take on the CPU.

Not collected by pytest. About 10 s per epoch and side on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KEYS = ("train_loss", "val_loss", "rot_error", "trans_error")


def config(pkg_data, pkg_losses, pkg_train, log_dir, epochs, solver):
    return pkg_train.TrainConfig(
        experiment=f"curve_{solver}", log_dir=log_dir, criterion="w_cos",
        batch_size=128, num_epochs=epochs,
        dataset=pkg_data.DatasetConfig(
            source_point_num=128, target_point_num=128, num_synthetic=256,
            synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=pkg_data.TransformConfig(noise_sigma=0.02)),
        pcr_iteration_num=3,
        shwd=pkg_losses.SHWDConfig(
            transport=pkg_losses.TransportConfig(
                cost="lp", p=2.0, solver=solver, eps=5e-3, num_iters=50,
                num_scales=4),
            max_iter=1, lam=1.3e-5, phi_lr=9.2e-5),
        phi_num_flow_layer=3)


def harness():
    """tools/registration_rows_torch.py, the row harness."""
    spec = importlib.util.spec_from_file_location(
        "registration_rows_torch", ROOT / "tools" / "registration_rows_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def row_config(args, log_dir, seed):
    """The port's config of ``args.row`` from the row harness."""
    return harness().row_config(args.row, seed, log_dir, args.epochs)


def run_jax(log_dir, args, seed):
    from shwd_tpu import data, losses, train
    if args.row:
        from shwd_tpu.train.config import config_from_dict
        cfg = config_from_dict(json.loads(row_config(args, log_dir + "/jax", seed).to_json()))
        if args.init == "jax":
            # Trainer.fit draws the file's state at its seed: held bit for bit
            # by tests/test_torch_init_states.py
            stored = int(np.load(harness().INIT_FILE)["seed"])
            if cfg.seed != stored:
                raise ValueError(f"--init jax: the file holds seed {stored}, not {cfg.seed}")
    else:
        cfg = config(data, losses, train, log_dir + "/jax", args.epochs, args.solver)
        cfg = dataclasses.replace(cfg, seed=seed)
    ds = data.RegistrationDataset(cfg.dataset, "train")
    return train.Trainer(cfg).fit(ds, verbose=False)["history"]


def run_torch(log_dir, args, seed):
    from shwd_torch import data, losses, train
    from shwd_torch.losses import transport
    if args.row:
        cfg = row_config(args, log_dir + "/torch", seed)
        if args.init == "jax":
            cfg = harness().jax_init_config(cfg, args.row, args.device)
    else:
        cfg = config(data, losses, train, log_dir + "/torch", args.epochs, args.solver)
        cfg = dataclasses.replace(cfg, seed=seed)
    ds = data.RegistrationDataset(cfg.dataset, "train", device=args.device)
    if args.plain_route:
        transport.emd2_points = functools.partial(transport.emd2_points,
                                                  use_kernel=False)
    return train.Trainer(cfg, device=args.device).fit(ds, verbose=False)["history"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--solver", default="sinkhorn")
    ap.add_argument("--side", choices=("both", "jax", "torch"), default="both")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: 1234, or the row's seed with --row")
    ap.add_argument("--seed", type=int, default=None, help="one seed (adds to --seeds)")
    ap.add_argument("--row", default=None,
                    help="a row of tools/registration_rows_torch.py")
    ap.add_argument("--init", choices=("torch", "jax"), default="torch",
                    help="with --row: start from each package's own draw, or both "
                         "from the JAX package's (tools/init_states_jax.npz)")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--plain-route", action="store_true")
    args = ap.parse_args()
    if args.init == "jax" and not args.row:
        ap.error("--init jax needs --row")
    seeds = (args.seeds or []) + ([args.seed] if args.seed is not None else [])
    args.seeds = seeds or [None if args.row else 1234]
    out = {}
    runs = [(side, run, seed)
            for side, run in (("jax", run_jax), ("torch", run_torch))
            if args.side in ("both", side) for seed in args.seeds]
    with tempfile.TemporaryDirectory() as log_dir:
        for side, run, seed in runs:
            hist = run(log_dir, args, seed)
            for row in hist:
                print(side, seed, row["epoch"],
                      " ".join(f"{k}={row[k]:.4f}" for k in KEYS), flush=True)
            q = max(len(hist) // 4, 1)
            out[f"{side}_seed{seed}"] = {
                "first": {k: hist[0][k] for k in KEYS},
                "last": {k: hist[-1][k] for k in KEYS},
                "train_loss_first_quarter": sum(r["train_loss"] for r in hist[:q]) / q,
                "train_loss_last_quarter": sum(r["train_loss"] for r in hist[-q:]) / q,
                "rot_error_max": max(r["rot_error"] for r in hist),
                "rot_error_min": min(r["rot_error"] for r in hist)}
    print(json.dumps({"epochs": args.epochs, "row": args.row, "init": args.init,
                      "solver": None if args.row else args.solver,
                      "device": args.device, "plain_route": args.plain_route,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
