"""WD-vs-CD metric sensitivity sweeps in the PyTorch port (the reference's
Comparison suite).

Reproduces ``Comparison_Wasserstein_with_Chamfer_distance/main_rotation.py``
and ``main_translation.py`` (Chamfer / Sinkhorn / near-exact WD means as a
rigid transform grows) plus the closed-form Gaussian KL-vs-W2 study of
``Comparison_Wasserstein_with_KL/WD_vs_KL_graph.ipynb``. Same arguments as
``examples/metric_sweep.py``, plus ``--device`` (default: the card).

    python examples/metric_sweep_torch.py --mode rotation --out rot.json
    python examples/metric_sweep_torch.py --mode translation --device cpu
    python examples/metric_sweep_torch.py --mode kl

Trained registration models are evaluated with
``python -m shwd_torch.train.runner eval <experiment> --log-dir log``.
"""

import argparse
# package import: works installed or straight from a repo checkout
try:
    import shwd_torch  # noqa: F401
except ModuleNotFoundError:
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dataclasses
import json

import numpy as np

from shwd_torch.data.synthetic import shape_bank
from shwd_torch.train.comparison import (
    gaussian_kl_vs_w2, rotation_sweep, translation_sweep,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="rotation",
                    choices=["rotation", "translation", "kl"])
    ap.add_argument("--num-clouds", type=int, default=64)
    ap.add_argument("--points", type=int, default=128)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the card)")
    args = ap.parse_args()

    if args.mode == "kl":
        # anisotropic Gaussian, translations along x: KL grows quadratically
        # where W2 grows linearly
        sigma = np.array([1.0, 0.5, 0.25])
        mags = np.linspace(0.0, 2.0, 41)
        t = np.stack([mags, np.zeros_like(mags), np.zeros_like(mags)], -1)
        kl, w2 = gaussian_kl_vs_w2(sigma, t)
        result = {"translations": mags.tolist(), "kl": kl.tolist(),
                  "w2": w2.tolist()}
    else:
        # composite (chiral) shapes: symmetric primitives would alias large
        # rotations back onto themselves and invert the curves
        clouds = shape_bank(args.num_clouds, args.points, seed=0,
                            kinds=("composite",))
        if args.mode == "rotation":
            # 0 -> 90 (the committed reference figure) and 90 -> 180 (the
            # current main_rotation.py) in one artifact
            res = rotation_sweep(clouds, np.arange(0.0, 180.1, 1.0),
                                 device=args.device)
        else:
            res = translation_sweep(clouds, np.arange(0.0, 1.01, 0.01),
                                    device=args.device)
        result = {k: (np.asarray(v).tolist() if not np.isscalar(v) else v)
                  for k, v in dataclasses.asdict(res).items()}

    print(json.dumps({k: (v[:5] if isinstance(v, list) else v)
                      for k, v in result.items()}, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
