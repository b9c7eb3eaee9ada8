"""Write tools/init_states_jax.npz: the states the JAX package's registration
rows start from at seed 1234, for the port's row harness (which runs no
JAX); or, with ``--seeds``/``--rows``/``--out``, the same for other seeds
and rows into files of their own.

``shwd_tpu.train.Trainer.fit`` draws its state as
``Trainer(cfg).init_state(jax.random.split(jax.random.PRNGKey(seed))[0])``;
``init_state`` splits that key into PCRNet's key and the criterion's. Each
row's ``cfg`` is the JAX row's own (``tools/registration_rows_torch.py::
row_config``, which ``tests/test_torch_registration_rows.py`` holds to the
JAX scripts field by field). The Adam states are zero at count 0 (optax's
``init``) and are not stored. Keys of the file:

  - ``seed``; ``rows``, ``row_state`` and ``row_check``: each row, the entry
    its criterion state is stored under and the name of its check value;
  - ``pcrnet/<path>``: PCRNet's parameters (drawn from the model key alone,
    the same for every row of one seed), in the JAX tree's layout;
  - ``state/<entry>/phi_params/<path>``, ``.../phi_state/<path>`` and, for
    SHWD, ``.../lam``: one entry per distinct criterion state (SHWD's phi,
    the pseudo criterion's stacked frozen flows, max-SSW's chart);
  - ``check/source``, ``check/target``: one batch (numpy ``default_rng(0)``,
    B=4, N=M=128, centred), ``check/est_R``, ``check/est_t``: PCRNet's pose
    on it (3 iterations, ``model.apply(params, target, source)``);
  - ``check/<name>/value``: the criterion's test-mode value on (target,
    source) on the CPU route (the XLA fallback of ``emd2_points``), one per
    distinct criterion; ``.../value_kernel``: the same through the fused
    Sinkhorn kernel in interpret mode (the route the port's K3 mirrors on
    the card); ``.../frames``: the frames the criterion draws in test mode
    (the ``ssw`` solver, max-SSW), which the port is handed.

A path is the tree's keys and indices joined by ``/``. Drawn here with JAX
on the CPU; ``tests/test_torch_init_states.py`` redraws the states and
holds the file to them bit for bit.

    python tests/write_init_states.py
    python tests/write_init_states.py --seeds 0 1 2 --rows robust_noise_0.04 \
        w_cos_1024_ssw --out log/init_states/jax_s{seed}.npz --no-kernel-values

A seed's file is ~17 MB (PCRNet's 4.22 M f32 do not compress): keep files
beyond the committed one under a git-ignored directory (``log/``). The row
harness reads one with ``--init jax --init-file FILE``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from shwd_tpu import train as jt  # noqa: E402
from shwd_tpu.ops.spherical import stiefel_frames  # noqa: E402
from shwd_tpu.train.config import config_from_dict  # noqa: E402

OUT = ROOT / "tools" / "init_states_jax.npz"
SEED = 1234
# the JAX rows at seed 1234 that the port misses or flips on
ROWS = ("w_cos", "robust_noise_0.00", "robust_noise_0.02", "robust_noise_0.04",
        "robust_noise_0.10", "robust_outliers_10", "pseudo_w_cos", "max_ssw",
        "max_ssw_resume", "w_cos_1024_ssw")
CHECK_B, CHECK_N = 4, 128

_spec = importlib.util.spec_from_file_location(
    "registration_rows_torch", ROOT / "tools" / "registration_rows_torch.py")
harness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(harness)


def jax_config(row: str, seed: int = SEED):
    """The JAX ``TrainConfig`` of ``row`` at ``seed``."""
    return config_from_dict(json.loads(harness.row_config(row, seed).to_json()))


def init_keys(seed: int):
    """(k_init, k_model, k_crit): ``fit``'s split of ``PRNGKey(seed)`` and
    ``init_state``'s split of its first half."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return (k_init, *jax.random.split(k_init))


def flatten(tree, prefix: str) -> dict:
    """{prefix/path: numpy leaf}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                 for k in path]
        out["/".join([prefix, *parts])] = np.asarray(leaf)
    return out


def crit_leaves(crit) -> dict:
    """A criterion state's stored leaves, keyed below its entry."""
    out = {**flatten(crit.phi_params, "phi_params"), **flatten(crit.phi_state, "phi_state")}
    if hasattr(crit, "lam"):
        out["lam"] = np.asarray(crit.lam)
    return out


def crit_signature(cfg) -> str:
    """The config fields that decide a criterion's value on a batch,
    besides its state."""
    fields = {"w_cos": ("shwd", "flow_name", "phi_num_flow_layer"),
              "pseudo_w_cos": ("shwd", "pseudo_phi_num", "pseudo_combine", "flow_name",
                               "phi_num_flow_layer"),
              "max_ssw": ("max_ssw", "max_ssw_chart")}[cfg.criterion]
    raw = json.loads(cfg.to_json())
    return json.dumps({"criterion": cfg.criterion, **{k: raw[k] for k in fields}},
                      sort_keys=True)


def check_batch() -> tuple[np.ndarray, np.ndarray]:
    """(source, target): (B, N, 3) f32 each, centred per cloud."""
    rng = np.random.default_rng(0)
    clouds = rng.uniform(-1.0, 1.0, size=(2, CHECK_B, CHECK_N, 3)).astype(np.float32)
    clouds -= clouds.mean(axis=2, keepdims=True)
    return clouds[0], clouds[1]


def eval_frames(cfg, crit) -> np.ndarray | None:
    """The frames a test-mode call draws: ``stiefel_frames`` of the first
    half of the state's key (SHWD on ``ssw``, max-SSW); None otherwise."""
    if cfg.criterion == "max_ssw":
        n = cfg.max_ssw.num_projections
    elif cfg.criterion in ("w_cos", "w1_cos") and cfg.shwd.transport.solver == "ssw":
        n = cfg.shwd.transport.num_projections
    else:
        return None
    return np.asarray(stiefel_frames(jax.random.split(crit.key)[0], n, 3))


@contextlib.contextmanager
def kernel_route():
    """``emd2_points`` through the fused Sinkhorn kernel in interpret mode."""
    from shwd_tpu.losses import transport
    plain = transport.emd2_points
    transport.emd2_points = functools.partial(plain, use_pallas=True, interpret=True)
    try:
        yield
    finally:
        transport.emd2_points = plain


def criterion_value(trainer, crit, source, target) -> np.ndarray:
    (val, _, _), _ = trainer.crit_apply(crit, jnp.asarray(target), jnp.asarray(source), False)
    return np.asarray(val)


def draw_states(seed: int = SEED, rows=ROWS) -> tuple[dict, list, list, dict]:
    """(the state keys of the file, each row's entry, for each row the
    (cfg, trainer, criterion state) of the first row with its criterion
    config, PCRNet's JAX tree). PCRNet is drawn once, through
    ``init_state``; the criterion
    state once per distinct criterion config, from ``init_state``'s
    criterion key. Rows whose states are equal leaf for leaf share one
    entry."""
    k_init, _, k_crit = init_keys(seed)
    out, entries, groups, row_state, row_group = {}, {}, {}, [], []
    for row in rows:
        cfg = jax_config(row, seed)
        sig = crit_signature(cfg)
        if sig not in groups:
            trainer = jt.Trainer(cfg)
            if not out:
                state = trainer.init_state(k_init)
                for leaf in jax.tree_util.tree_leaves(state.opt_state):
                    assert not np.any(np.asarray(leaf)), "PCRNet's Adam state not zero"
                params = state.params
                out.update(flatten(params, "pcrnet"))
                crit = state.crit_state
            else:
                crit = trainer.crit_init(k_crit)
            for leaf in jax.tree_util.tree_leaves(getattr(crit, "opt_state", ())):
                assert not np.any(np.asarray(leaf)), f"{row}: phi's Adam state not zero"
            leaves = crit_leaves(crit)
            entry = next((name for name, have in entries.items()
                          if have.keys() == leaves.keys()
                          and all(np.array_equal(have[k], v) and have[k].dtype == v.dtype
                                  for k, v in leaves.items())), row)
            if entry == row:
                entries[row] = leaves
                out.update({f"state/{row}/{k}": v for k, v in leaves.items()})
            groups[sig] = (entry, (cfg, trainer, crit))
        entry, first = groups[sig]
        row_state.append(entry)
        row_group.append(first)
    return out, row_state, row_group, params


def draw_checks(row_group: list, params, kernel_values: bool = True, rows=ROWS) -> dict:
    """The check batch, PCRNet's pose on it and each criterion's value
    (and frames), with each row's check name; ``kernel_values`` False
    leaves out the interpret-mode values (the slow part)."""
    source, target = check_batch()
    cfg, trainer, _ = row_group[0]
    pose = trainer.model.apply(params, jnp.asarray(target), jnp.asarray(source),
                               cfg.pcr_iteration_num)
    out = {"check/source": source, "check/target": target,
           "check/est_R": np.asarray(pose.est_R), "check/est_t": np.asarray(pose.est_t)}
    names, row_check = {}, []
    for row, (cfg, trainer, crit) in zip(rows, row_group):
        if id(crit) not in names:
            names[id(crit)] = name = row
            frames = eval_frames(cfg, crit)
            if frames is not None:
                out[f"check/{name}/frames"] = frames
            out[f"check/{name}/value"] = criterion_value(trainer, crit, source, target)
            if kernel_values and cfg.shwd.transport.solver == "sinkhorn" and frames is None:
                with kernel_route():
                    out[f"check/{name}/value_kernel"] = criterion_value(
                        trainer, crit, source, target)
        row_check.append(names[id(crit)])
    out["row_check"] = np.asarray(row_check)
    return out


def draw(seed: int = SEED, rows=ROWS, kernel_values: bool = True) -> dict:
    """Every key of the file."""
    states, row_state, row_group, params = draw_states(seed, rows)
    return {"seed": np.asarray(seed), "rows": np.asarray(rows),
            "row_state": np.asarray(row_state), **states,
            **draw_checks(row_group, params, kernel_values, rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[SEED])
    ap.add_argument("--rows", nargs="+", choices=list(harness.ROWS), default=list(ROWS))
    ap.add_argument("--out", default=str(OUT),
                    help="the file; {seed} in it is replaced by each seed")
    ap.add_argument("--no-kernel-values", action="store_true",
                    help="leave out the fused kernel's interpret-mode check values")
    args = ap.parse_args(argv)
    if len(args.seeds) > 1 and "{seed}" not in args.out:
        ap.error("--out needs {seed} for more than one seed")
    for seed in args.seeds:
        out = Path(args.out.format(seed=seed))
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, **draw(seed, tuple(args.rows), not args.no_kernel_values))
        print(f"wrote {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
