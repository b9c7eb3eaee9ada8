"""Wasserstein gradient flow on the cube, in the PyTorch port.

Deforms a uniformly-sampled cube-surface cloud into a biased one by gradient
descent on a chosen distance (the reference's ``Wasserstein_flow_problem/
Flow_cube.ipynb``; the method list mirrors its cell 7) and prints the
exact-W2 convergence curve. Same arguments as ``examples/flow_cube.py``,
plus ``--device`` (default: the card).

    python examples/flow_cube_torch.py --method SHWD --iters 400
    python examples/flow_cube_torch.py --method SWD CD SSWD --device cpu
"""

import argparse
# package import: works installed or straight from a repo checkout
try:
    import shwd_torch  # noqa: F401
except ModuleNotFoundError:
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import json

import numpy as np

from shwd_torch.ops.sphere_sampling import sample_cube_surface
from shwd_torch.train.flow_driver import FlowConfig, run_flow


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", nargs="+", default=["SHWD"],
                    help="any of: SHWD SWD MSWD SSWD SSWD_W1 ASWD DSWD CD W2 "
                         "GSWD_POLY GSWD_POLY3 MGSWD_POLY GSWD_CIRC "
                         "MGSWD_CIRC GSW_NN MGSW_NN")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--points", type=int, default=1200)
    ap.add_argument("--eval-interval", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="json output path")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the card)")
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    source = sample_cube_surface(rng, args.points).numpy()
    target = sample_cube_surface(rng, args.points, biased=True).numpy()

    results = {}
    for method in args.method:
        cfg = FlowConfig(method=method, num_iterations=args.iters,
                         eval_interval=args.eval_interval, seed=args.seed,
                         # notebook cell 6 SHWD hyperparameters
                         shwd_layers=5, shwd_lam=0.1, shwd_max_iter=1,
                         shwd_phi_lr=0.001, shwd_phi_wd=0.1)
        res = run_flow(source, target, cfg, verbose=True, device=args.device)
        results[method] = {
            "final_w2": float(res.eval_values[-1]),
            "best_w2": float(res.eval_values.min()),
            "steps_per_second": res.steps_per_second,
            "curve": res.eval_values.tolist(),
        }
        print(f"{method}: final W2 = {results[method]['final_w2']:.2e}  "
              f"({res.steps_per_second:.0f} steps/s)")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
