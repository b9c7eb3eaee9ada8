"""Write tools/flow_clouds_jax.npz: the clouds of the JAX package's
ellipsoid flow rows, for the port's flow harness (which runs no JAX).

``benchmarks/flow_parity.py`` draws them from ``jax.random.PRNGKey(0)``
split in two: the source ``sample_ellipsoid_surface(k1, 1000)``, the
target ``sample_ellipsoid_surface(k2, 1000, biased_scale=s)`` with s 0.25
(``ellipsoid``) or 0.1 (``ellipsoid_2``). Drawn here with JAX on the CPU;
``tests/test_torch_flow_rows.py`` redraws them and holds the file to them
bit for bit.

    python tests/write_flow_clouds.py
"""

import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

jax.config.update("jax_platforms", "cpu")

from shwd_tpu.ops.sphere_sampling import sample_ellipsoid_surface  # noqa: E402

OUT = ROOT / "tools" / "flow_clouds_jax.npz"
SCALES = {"ellipsoid": 0.25, "ellipsoid_2": 0.1}
N = 1000


def draw() -> dict:
    """{experiment_source, experiment_target}: (1000, 3) f32 each."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    out = {}
    for name, scale in SCALES.items():
        out[f"{name}_source"] = np.asarray(sample_ellipsoid_surface(k1, N), np.float32)
        out[f"{name}_target"] = np.asarray(
            sample_ellipsoid_surface(k2, N, biased_scale=scale), np.float32)
    return out


if __name__ == "__main__":
    np.savez(OUT, **draw())
    print(f"wrote {OUT}")
