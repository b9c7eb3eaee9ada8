"""Driver of the registration-training cell on the exact-EMD (``hybrid``)
solver.

Set-up, window and counts are ``train_cell``'s: the bank and the weights
from the seed, the program's ``Trainer`` with that state, one validation
pass and the first train steps through the window's own calls, then whole
epochs back to back to the first epoch end past ``--seconds``. What it adds:

- set-up needs the program's read of a train step's solves,
  ``Trainer.last_solves``; a program without it stops there
  (``harness.MissingReading``: no result line);
- after each check step it keeps that step's solves: phi's inner solve,
  cold, and the final one, warm, each a (B, N) assignment with its sweeps,
  prices and stragglers.

Check: the plain reference (``reference/pcrnet_wcos_hybrid.py``) follows the
same steps at the program's own assignments. Numbers compared:

- ``non_permutations``: the (solve, item) pairs whose assignment is not a
  permutation (a solve of the wrong shape counts each of its items). Limit
  0: the exact EMD's plan is a permutation.
- ``assignment_gap``: the largest, over the solves and items, of the mean
  cost of the program's assignment less scipy's optimum, both on the
  float64 cost of the clouds that solve was given (phi's images, which the
  program hands back with its solves): exactness on the program's own
  terms. The auction promises at most its ``eps_final`` (1e-7) on its own
  float32 cost; the rest is that cost's rounding. On the reference's cost
  the gap would also hold the drift of the two states, which Adam's steps
  on rounding-level gradients open from the second step on (reported as
  ``ref_gap``).
- ``train_cell``'s six gaps, with the reference's train steps taken at the
  program's assignments, so that a tie among optimal plans, which moves the
  envelope gradient, cannot fail them; the validation pass at the
  reference's own (an optimal value does not depend on the tie).

Reported on standard error and not compared: each solve's permutations,
sweeps, stragglers, largest price, gap and flips on its own cost, its gap
and flips against the reference's own scipy assignment on the reference's
cost, ``assignment_flips`` (the total of those flips), and the six gaps
with the reference at its own scipy assignments.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import sys
import time

import numpy as np
import torch

from . import traffic, yardstick_hybrid
from .compare import leaf_norms
from .harness import Check, Run, mark, peak_bytes, reference, require, sync
from .reference.common import exact_assignment, sq_cost
from .reference.pcrnet_wcos_hybrid import is_permutation, solve_record
from .tracing import DeviceTrace, Spans
from .train_cell import (_adam_first_grad, _named, _train_config, as_readings, diagnose,
                         draw_weights, fed_dataset, gaps, plan_rows, reference_config,
                         reference_phi)

SOLVES = ("inner", "final")


def run_cell(run: Run, measure) -> None:
    from shwd_torch.train import Trainer

    require(getattr(Trainer, "last_solves", None), "Trainer.last_solves")
    cfg = _train_config(run)
    arch = run.config["architecture"]
    dev = run.device
    b = cfg.batch_size
    n_shapes, n_points = run.config["bank_shapes"], run.config["points"]

    mark(run, "imported")
    bank = torch.as_tensor(traffic.composite_bank(run.seed, n_shapes, n_points), device=dev)
    mark(run, "bank")
    ds = fed_dataset(cfg.dataset, bank, dev)
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    mark(run, "trainer")
    weights, phi_raw = draw_weights(run.seed, arch, dev)
    state.model.load_state_dict(weights)
    phi = state.crit_state.phi
    phi.load_state_dict(phi_raw)
    for m in phi.modules():
        if hasattr(m, "power_iter"):
            m.power_iter(arch["phi_init_power_iterations"])

    mark(run, "state")
    train_idx, val_idx, step_rows = plan_rows(run, n_shapes)
    feed_seed = int(traffic.seed_rng(run.seed, 4).integers(0, 2 ** 62))
    gen = torch.Generator(device=dev).manual_seed(feed_seed)
    rng = traffic.seed_rng(run.seed, 6)

    val = trainer.eval_one_epoch(state, ds, val_idx, gen)
    mark(run, "val_pass")
    model_p, phi_p = _named(state.model), _named(phi)
    p0 = {**{f"model.{k}": v.detach().clone() for k, v in model_p.items()},
          **{f"phi.{k}": v.detach().clone() for k, v in phi_p.items()}}
    plan = {"generator_seed": feed_seed, "steps": [],
            "val": [val_idx[i:i + b] for i in range(0, len(val_idx), b)]}
    losses, first, solves = [], None, []
    for rows in step_rows:
        order = np.array(rows)
        copy.deepcopy(rng).shuffle(order)
        plan["steps"].append(order)
        state, loss = trainer.train_one_epoch(state, ds, rows, gen, rng)
        losses.append(loss)
        solves.append(trainer.last_solves())
        if first is None:
            first = {**{f"model.{k}": v for k, v in
                        _adam_first_grad(state.opt, model_p).items()},
                     **{f"phi.{k}": v for k, v in
                        _adam_first_grad(state.crit_state.opt, phi_p).items()}}
    change = {**{f"model.{k}": v.detach() - p0[f"model.{k}"] for k, v in model_p.items()},
              **{f"phi.{k}": v.detach() - p0[f"phi.{k}"] for k, v in phi_p.items()}}
    mark(run, "train_steps")
    readings = {"losses": losses, "first_grad": leaf_norms(first),
                "change": leaf_norms(change), "val": list(val)}
    del first, change, p0

    steps_per_epoch = len(train_idx) // b
    val_sizes = [len(r) for r in plan["val"]]
    kw = dict(pose_iterations=cfg.pcr_iteration_num, blocks=arch["phi_blocks"],
              warmup_iterations=run.config["flops"]["warmup_iterations"])
    step_flops = yardstick_hybrid.hybrid_train_step_flops(b, n_points,
                                                          inner_steps=cfg.shwd.max_iter, **kw)
    epoch_flops = steps_per_epoch * step_flops + sum(
        yardstick_hybrid.hybrid_val_batch_flops(v, n_points, **kw) for v in val_sizes)

    spans = Spans()

    def epoch():
        nonlocal state
        state, loss = trainer.train_one_epoch(state, ds, train_idx, gen, rng)
        with spans("eval_one_epoch"):
            vals = trainer.eval_one_epoch(state, ds, val_idx, gen)
        return all(np.isfinite([loss, *vals]))

    sync(dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    epochs = bad = 0
    while True:
        bad += not epoch()
        epochs += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.memory_peak_bytes = peak_bytes(dev)
    run.attempted, run.failed = epochs, bad
    run.counts = {"epochs": epochs, "train_steps": epochs * steps_per_epoch,
                  "train_clouds": epochs * steps_per_epoch * b,
                  "val_batches": epochs * len(val_sizes)}
    run.spans = dict(spans.total)
    run.model_flops = epochs * epoch_flops

    if run.trace:
        _trace(run, trainer, epoch)
    measure()
    del trainer, state, ds, phi, model_p, phi_p, epoch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    assignments, non_permutations = program_assignments(solves, b, n_points)
    run.check_inputs = {"weights": weights, "phi": reference_phi(phi_raw, arch),
                        "bank": bank, "plan": plan, "cfg": reference_config(run.config, cfg),
                        "assignments": assignments}
    run.program_readings = {**readings, "non_permutations": non_permutations,
                            "solves": [[solve_numbers(s) for s in step or []]
                                       for step in solves]}
    follow = reference(run.config).follow
    ref = follow(**run.check_inputs)
    values = check_values(run.program_readings, ref)
    run.checks = [Check(k, values[k], run.workload["limits"][k]) for k in values]
    own = follow(**{**run.check_inputs, "assignments": None})
    report(run.program_readings, ref, gaps(readings, as_readings(own)))


def _trace(run: Run, trainer, epoch) -> None:
    """``trace_epochs`` more epochs under the device trace, and the graphs'
    counts; a traced run that finds no train step graph fails."""
    trace = DeviceTrace()
    trace.start()
    for _ in range(run.workload["trace_epochs"]):
        epoch()
    trace.stop()
    run.trace_summary = trace.summary()
    run.graphs = trainer.graph_stats()
    require([g for g in run.graphs if g and g["name"].startswith("train step")
             and g["kernel_nodes"]], "train step graph with kernel nodes")


def program_assignments(solves: list, b: int, n: int):
    """(per check step, the (inner, final) assignments the reference is to
    follow, None for a step whose solves are missing or of another shape;
    the count of (solve, item) pairs without a permutation, such a step
    counting every item of its solves)."""
    out, bad = [], 0
    for step in solves:
        step = list(step or [])
        if len(step) != len(SOLVES) or any(tuple(s["assign"].shape) != (b, n) for s in step):
            bad += b * len(SOLVES)
            out.append([None] * len(SOLVES))
            continue
        bad += sum(int((~is_permutation(s["assign"])).sum()) for s in step)
        out.append([s["assign"] for s in step])
    return out, bad


def solve_numbers(s: dict) -> dict:
    """What a program's solve shows on its own terms: its permutations,
    sweeps, stragglers and largest price, and, on the float64 cost of the
    clouds it was given (phi's images, the program's own), the largest gap
    of an item's mean cost above scipy's optimum (``gap``) and the items
    whose assignment is not scipy's (``flips``)."""
    c64 = sq_cost(s["x"].double(), s["y"].double())
    exact = solve_record(c64, s["assign"], exact_assignment(c64))
    return {"permutations": int(is_permutation(s["assign"]).sum()),
            "items": int(s["assign"].shape[0]),
            "sweeps_max": int(s["sweeps"].max()), "sweeps_sum": int(s["sweeps"].sum()),
            "stragglers": int(s["stragglers"].sum()),
            "price_max": float(s["prices"].abs().max()),
            "gap": exact["gap"], "flips": exact["flips"]}


def check_values(program: dict, ref: dict) -> dict:
    """The numbers compared (see the module docstring): ``program`` holds
    the readings and each solve's numbers, ``ref`` the reference's output
    at the program's assignments."""
    gap = max((s["gap"] for step in program["solves"] for s in step), default=float("nan"))
    return {"non_permutations": float(program["non_permutations"]),
            "assignment_gap": gap, **gaps(program, as_readings(ref))}


def report(program: dict, ref: dict, own_gaps: dict) -> None:
    """Each check solve's numbers, with its gap and flips against the
    reference's scipy assignment on the reference's cost (``ref_gap``,
    ``ref_flips``), and the gaps at the reference's own assignments, on
    standard error."""
    flips = 0
    for k, (mine, theirs) in enumerate(zip(program["solves"], ref["solves"])):
        for name, p, r in zip(SOLVES, mine, theirs):
            flips += r["flips"]
            print(f"solve step={k} {name} " + " ".join(f"{x}={v!r}" for x, v in p.items())
                  + f" ref_gap={r['gap']!r} ref_flips={r['flips']}", file=sys.stderr)
    print(f"reading assignment_flips {flips}", file=sys.stderr)
    for name, v in own_gaps.items():
        print(f"reading {name}.own_assignment {v!r}", file=sys.stderr)


# -- readings of the limits ----------------------------------------------------

@contextlib.contextmanager
def _patched(module, name, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def _solver(**changes):
    """The program's hybrid solver with ``changes`` to its arguments."""
    import shwd_torch.losses.shwd as shwd

    def make(solve):
        return lambda *a, **k: solve(*a, **{**k, **changes})
    return _patched(shwd, "hybrid_assignment_warm", make)


def _swapped_final():
    """The final (warm) solve's assignment with persons 0 and 1's objects
    swapped in every item, before the gather."""
    import shwd_torch.losses.shwd as shwd

    def make(solve):
        def swapped(*a, use_warm, **k):
            out = solve(*a, use_warm=use_warm, **k)
            if not use_warm:
                return out
            v = out[0]
            return (torch.cat([v[:, 1:2], v[:, :1], v[:, 2:]], dim=1),) + tuple(out[1:])
        return swapped
    return _patched(shwd, "hybrid_assignment_warm", make)


def _half_batch():
    """Each train step on the first half of its batch."""
    from shwd_torch.data.transforms import RegistrationBatch
    from shwd_torch.train.trainer import Trainer

    def make(step):
        return lambda self, state, batch: step(
            self, state, RegistrationBatch(*(t[:t.shape[0] // 2] for t in batch)))
    return _patched(Trainer, "_train_step", make)


def _state_unchanged():
    """Adam leaves every parameter where it is."""
    return _patched(torch.optim.Adam, "step", lambda step: lambda self, closure=None: None)


FAULTS = {"eps_final_1e-3": lambda: _solver(eps_final=1e-3),
          "final_swapped": _swapped_final,
          "max_sweeps_1": lambda: _solver(max_sweeps=1),
          "half_batch": _half_batch,
          "state_unchanged": _state_unchanged}


def faulty_run(run: Run, fault: str) -> Run:
    """The cell's set-up and check (a one-epoch window) with ``fault``
    planted in the program."""
    out = Run(cell=run.cell, seed=run.seed, seconds=0.0, trace=False, config=run.config,
              workload=run.workload, device=run.device, t_start=time.perf_counter())
    with FAULTS[fault]():
        run_cell(out, lambda: None)
    return out


def extra_readings(run: Run, controls: bool, full_control: bool = False) -> dict:
    """For ``portbench.readings``: where the gaps come from, and with
    ``controls`` the control (the reference with TF32 products, in the
    program's place: its own assignments, held against the float32
    reference at those) and each planted fault's numbers."""
    follow = reference(run.config).follow
    ref = follow(**run.check_inputs)
    out = {"where": diagnose(run.program_readings, as_readings(ref)),
           "solves": run.program_readings["solves"]}
    if controls:
        control = follow(**{**run.check_inputs, "assignments": None}, tf32=True)
        at_control = follow(**{**run.check_inputs, "assignments": control["assignments"]})
        own = {**as_readings(control), "solves": control["solves"], "non_permutations": sum(
            s["non_permutations"] for step in control["solves"] for s in step)}
        out["control"] = check_values(own, at_control)
        for fault in FAULTS:
            out[fault] = {c.name: c.value for c in faulty_run(run, fault).checks}
    return out
