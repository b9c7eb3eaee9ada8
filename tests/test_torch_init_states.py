"""The JAX package's seed-1234 initial states in ``tools/init_states_jax.npz``
and the row harness's ``--init jax`` start (tools/registration_rows_torch.py).

The file is held to the JAX package's draws bit for bit (JAX redraws them
here, ``tests/write_init_states.py``); the port's state loaded from it
gives the JAX package's PCRNet pose and criterion values on the file's
check batch on the CPU; the epoch-0 checkpoint that ``--init jax`` writes
is where ``Trainer.fit`` starts; and a JAX-start row is stored apart from
a torch-start row.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from shwd_torch.data import RegistrationDataset
from shwd_torch.train import Trainer
from shwd_torch.train.evaluate import evaluate
from shwd_torch.utils.checkpoint import load_checkpoint
from shwd_torch.utils.convert import pcrnet_tree, phi_tree

import write_init_states as writer

rows = writer.harness
DATA = np.load(rows.INIT_FILE)
# the port against the JAX package on the CPU: the pose's entries near 0
# need an absolute floor
POSE_TOL = dict(rtol=1e-5, atol=1e-6)
VALUE_TOL = dict(rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def drawn():
    """JAX's states as ``write_init_states`` draws them: ~20 s (PCRNet's
    4.2 M parameters and three criterion states, drawn op by op)."""
    return writer.draw_states()


@pytest.fixture(scope="module")
def jax_checks(drawn):
    """The JAX pose and plain-route values on the file's check batch,
    recomputed: ~15 s (one compile per criterion)."""
    _, _, row_group, params = drawn
    return writer.draw_checks(row_group, params, kernel_values=False)


@pytest.fixture(scope="module")
def port_checks():
    """The port's pose and values from the file's states, on the CPU (~6 s)."""
    return {name: (port, want) for name, port, want in rows.jax_init_check("cpu")}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_file_holds_the_jax_initial_states_bit_for_bit(drawn):
    """Every state key of the file equals JAX's draw (values and dtype), and
    each row names the entry its state is stored under (~20 s, the
    fixture)."""
    states, row_state, _, _ = drawn
    assert int(DATA["seed"]) == writer.SEED
    assert [str(r) for r in DATA["rows"]] == list(writer.ROWS)
    assert [str(e) for e in DATA["row_state"]] == row_state
    stored = {k for k in DATA.files if k.startswith(("pcrnet/", "state/"))}
    assert stored == set(states)
    for key, want in states.items():
        assert DATA[key].dtype == want.dtype, key
        np.testing.assert_array_equal(DATA[key], want, err_msg=key)
    assert sum(DATA[k].size for k in DATA.files if k.startswith("pcrnet/")) == 4217351


@pytest.mark.parametrize("name", ["pose", "w_cos", "pseudo_w_cos", "max_ssw",
                                  "w_cos_1024_ssw"])
def test_port_from_the_file_gives_the_jax_values_on_the_check_batch(
        jax_checks, port_checks, name):
    """The file's check values are the JAX package's (recomputed on the
    plain route, rtol 1e-6), and the port's state loaded through
    ``jax_init_state`` gives them on the CPU: the pose within rtol 1e-5 /
    atol 1e-6, each criterion value within rtol 1e-5."""
    keys = ["est_R", "est_t"] if name == "pose" else [name]
    for key in keys:
        file_key = f"check/{key}" if name == "pose" else f"check/{key}/value"
        np.testing.assert_allclose(DATA[file_key], jax_checks[file_key], rtol=1e-6,
                                   atol=1e-7)
        port, want = port_checks[key]
        np.testing.assert_array_equal(want, DATA[file_key])
        tol = POSE_TOL if name == "pose" else VALUE_TOL
        np.testing.assert_allclose(port.reshape(want.shape), want, **tol, err_msg=key)


def test_every_row_names_its_check_and_the_kernel_values_sit_beside_them():
    """Each row of the file has a check value; the ``sinkhorn`` criteria
    also have the fused kernel's (interpret mode), within 1e-3 of the plain
    route's (its per-item eps0 against one for the batch)."""
    for name in map(str, DATA["row_check"]):
        assert f"check/{name}/value" in DATA.files
    for name in ("w_cos", "pseudo_w_cos"):
        np.testing.assert_allclose(DATA[f"check/{name}/value_kernel"],
                                   DATA[f"check/{name}/value"], rtol=1e-3)
    for name in ("max_ssw", "w_cos_1024_ssw"):
        assert f"check/{name}/value_kernel" not in DATA.files
        assert f"check/{name}/frames" in DATA.files


def _tiny(cfg, tmp_path):
    """16 shapes of 32 points, batch 4: 3 train steps and one val batch."""
    return dataclasses.replace(cfg, batch_size=4, dataset=dataclasses.replace(
        cfg.dataset, num_synthetic=16, source_point_num=32, target_point_num=32,
        cache_dir=str(tmp_path / "cache")))


def _assert_jax_state(model, phi, lam):
    """PCRNet's tree, phi's (params, state) trees and lam equal the file's
    ``w_cos`` entry bit for bit."""
    for got, want in zip(_leaves(model),
                         _leaves(rows.stored_tree(DATA, "pcrnet"))):
        np.testing.assert_array_equal(got, want)
    entry = "state/w_cos"
    want = (rows.stored_tree(DATA, f"{entry}/phi_params"),
            rows.stored_tree(DATA, f"{entry}/phi_state"))
    for got, ref in zip(_leaves(phi), _leaves(want)):
        np.testing.assert_array_equal(got, ref)
    assert np.float32(lam) == DATA[f"{entry}/lam"]


def test_jax_start_checkpoint_loads_at_epoch_0_and_fit_starts_from_it(tmp_path):
    """``jax_init_config`` writes the file's ``w_cos`` state as an epoch-0
    checkpoint: it loads at epoch 0 with no Adam moments yet (zero at count
    0), and ``Trainer.fit`` from it (1 epoch, 16 shapes) takes its first
    train step from the file's weights. ~5 s."""
    cfg = _tiny(rows.row_config("w_cos", 1234, str(tmp_path), 1), tmp_path)
    cfg = rows.jax_init_config(cfg, "w_cos", "cpu")
    trainer = Trainer(cfg, device="cpu")
    fresh = trainer.init_state(torch.Generator().manual_seed(0))
    fresh, epoch = load_checkpoint(cfg.load_model, fresh)
    assert epoch == 0 and not fresh.opt.state and not fresh.crit_state.opt.state
    _assert_jax_state(pcrnet_tree(fresh.model), phi_tree(fresh.crit_state.phi),
                      fresh.crit_state.lam)

    seen = []
    step = trainer._train_step

    def first_step(state, batch):
        if not seen:    # copies: on the CPU the trees share the parameters' memory
            seen.append(jax.tree_util.tree_map(np.copy, (
                pcrnet_tree(state.model), phi_tree(state.crit_state.phi),
                float(state.crit_state.lam))))
        return step(state, batch)

    trainer._train_step = first_step
    res = trainer.fit(RegistrationDataset(cfg.dataset, "train", device="cpu"),
                      verbose=False)
    assert [r["epoch"] for r in res["history"]] == [1] and res["history"][0]["train_steps"] == 3
    _assert_jax_state(*seen[0])


def test_harness_jax_start_row_is_stored_with_its_init(tmp_path):
    """``--init jax --device cpu`` end to end (1 epoch of ``w_cos`` at the
    tiny size): the row says ``"init": "jax"``, its initial-state
    evaluation is the loaded state's, and its checkpoints sit in a log
    directory of their own. ~6 s."""
    full = rows.row_config
    out, log = tmp_path / "rows.json", tmp_path / "log"
    try:
        rows.row_config = lambda *a, **k: _tiny(full(*a, **k), tmp_path)
        argv = ["--rows", "w_cos", "--seeds", "1234", "--epochs", "1", "--device", "cpu",
                "--log-dir", str(log), "--out", str(out)]
        assert rows.main(argv + ["--init", "jax"]) == 0
    finally:
        rows.row_config = full
    (row,) = json.loads(out.read_text())
    assert row["init"] == "jax" and row["epochs_run"] == 1 and row["first_epoch"] == 1
    cfg = _tiny(full("w_cos", 1234, str(tmp_path / "ref"), 1), tmp_path)
    state = rows.jax_init_state(Trainer(cfg, device="cpu"), "w_cos", 1234)
    want = evaluate(cfg, state=state, split="test", device="cpu").mean_rot_error
    assert np.isfinite(want) and row["init_test_rot_error"] == want
    assert (log / "w_cos_s1234_jax" / "bench_w_cos" / "models" / "jax_init.pt").exists()


def test_ident_keeps_jax_and_torch_starts_apart(tmp_path):
    """A JAX-start row and a torch-start row of one (row, seed, epochs) are
    stored side by side; a row stored before ``init`` existed reads as a
    torch start and is replaced by one."""
    out = tmp_path / "rows.json"
    base = {"row": "w_cos", "seed": 1234, "epochs": 2000}
    rows.store(out, dict(base, best_rot_error=1.0))
    assert rows.ident(rows.load_rows(out)[0]) == ("w_cos", 1234, 2000, "torch")
    rows.store(out, dict(base, init="jax", best_rot_error=2.0))
    rows.store(out, dict(base, init="torch", best_rot_error=3.0))
    assert [(r["init"], r["best_rot_error"]) for r in rows.load_rows(out)] == [
        ("jax", 2.0), ("torch", 3.0)]


@pytest.mark.parametrize("row, seed", [("sinkhorn", 1234), ("w_cos", 0)])
def test_jax_start_fails_for_a_row_or_seed_the_file_lacks(row, seed, tmp_path):
    """``--init jax`` for a (row, seed) the file does not hold raises with
    the file's rows and seed."""
    trainer = Trainer(rows.row_config(row, seed, str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="holds no JAX initial state"):
        rows.jax_init_state(trainer, row, seed)
