"""Driver of the registration-training cells.

Set-up: the shape bank and the initial weights from the seed (the weights
drawn on the card in one call for PCRNet and one for phi), the program's
``Trainer`` with that state, then one validation pass and the first train
steps through the window's own calls (``Trainer.eval_one_epoch``, which
captures the validation graphs; ``Trainer.train_one_epoch`` on the fused
path, one batch of distinct rows per call, the first call capturing the
train step's graph). The readings of those calls are kept for the check.

Window: whole epochs back to back, as ``Trainer.fit`` runs them (the
fused train pass, then the validation pass; no snapshots, no files),
ending at the first epoch end past ``--seconds``. With ``--trace 1`` a
few more epochs run under the device trace after the window.

Check: after the window and with the program's state freed, the plain
reference follows the same steps from the same inputs; the gaps of the
losses, of each leaf's first gradient and change, and of the validation
pass are held to the cell's limits.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import numpy as np
import torch

from . import compare, kernels, traffic, yardstick
from .harness import Check, Run, mark, peak_bytes, reference, require, sync
from .tracing import DeviceTrace, Spans


def _uniform_leaves(generator, shapes: dict, bounds: dict, device) -> dict:
    """U(-bound, bound) leaves of ``shapes``, drawn in one call."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        out[name] = (part * bounds[name]).reshape(shape).clone()
    return out


def draw_weights(seed: int, arch: dict, device):
    """PCRNet's initial weights and phi's raw initial tensors (u and v
    before their power iterations), in the program's state-dict names:
    weights and biases uniform in +-1/sqrt(fan_in), the last layer of each
    phi block scaled by 1/1000, beta 0.5, u and v normal and normalised."""
    gen = torch.Generator(device=device).manual_seed(
        int(traffic.seed_rng(seed, 5).integers(0, 2 ** 62)))
    shapes, bounds = {}, {}

    def dense(prefix, widths):
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            shapes[f"{prefix}.{i}.w"], shapes[f"{prefix}.{i}.b"] = (b, a), (b,)
            bounds[f"{prefix}.{i}.w"] = bounds[f"{prefix}.{i}.b"] = 1.0 / math.sqrt(a)

    dense("feature_model.layers", arch["pointnet_widths"])
    dense("head", arch["head_widths"])
    model = _uniform_leaves(gen, shapes, bounds, device)

    channels = [3] + [arch["phi_hidden"]] * (arch["phi_layers"] - 1) + [3]
    shapes, bounds = {}, {}
    for k in range(arch["phi_blocks"]):
        dense(f"flows.{k}.net.layers", channels)
    phi = _uniform_leaves(gen, shapes, bounds, device)
    last = arch["phi_layers"] - 1
    per_block = sum(channels[1:]) + sum(channels[:-1])
    normal = torch.randn(arch["phi_blocks"] * per_block, generator=gen, device=device)
    offset = 0
    for k in range(arch["phi_blocks"]):
        phi[f"flows.{k}.net.layers.{last}.w"] /= 1000.0
        for i in range(arch["phi_layers"]):
            name = f"flows.{k}.net.layers.{i}"
            phi[f"{name}.beta"] = torch.full((1,), 0.5, device=device)
            for key, size in (("u", channels[i + 1]), ("v", channels[i])):
                part = normal[offset:offset + size]
                offset += size
                phi[f"{name}.{key}"] = part / torch.clamp_min(torch.linalg.vector_norm(part),
                                                              1e-12)
    return model, phi


def fed_dataset(cfg, bank: torch.Tensor, device):
    """The program's ``RegistrationDataset`` over the benchmark's bank; it
    remembers the last training batch it fed (``.last``)."""
    from shwd_torch.data.dataset import RegistrationDataset

    class Fed(RegistrationDataset):
        def __init__(self):
            self.cfg, self.split, self.device = cfg, "train", device
            self.sources = self.targets = bank
            self.last = None

        def batches(self, *args, shuffle=True, **kwargs):
            for batch in super().batches(*args, shuffle=shuffle, **kwargs):
                if shuffle:
                    self.last = batch
                yield batch

    return Fed()


def _train_config(run: Run):
    from shwd_torch.train.config import config_from_dict
    raw = copy.deepcopy(run.config["train_config"])
    raw["batch_size"] = run.workload["batch_size"]
    return config_from_dict(raw)


def _named(module) -> dict:
    return dict(module.named_parameters())


def _adam_first_grad(opt, params: dict) -> dict:
    """The gradient Adam received at its first step: exp_avg / (1 - b1)
    (zero for a parameter whose state Adam never made)."""
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in params.items():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p) if m is None else (m / (1.0 - b1)).detach().clone()
    return out


def plan_rows(run: Run, n_shapes: int):
    """(train rows, validation rows, the rows of each check step)."""
    perm = traffic.seed_rng(run.seed, 3).permutation(n_shapes)
    n_val = int(n_shapes * run.config["val_split"])
    val, train = perm[:n_val], perm[n_val:]
    b = run.workload["batch_size"]
    steps = [train[k * b:(k + 1) * b] for k in range(run.workload["check_steps"])]
    return train, val, steps


def run_cell(run: Run, measure) -> None:
    from shwd_torch.train import Trainer

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
    losses, first = [], None
    for rows in step_rows:
        order = np.array(rows)
        copy.deepcopy(rng).shuffle(order)
        plan["steps"].append(order)
        state, loss = trainer.train_one_epoch(state, ds, rows, gen, rng)
        losses.append(loss)
        if first is None:
            first = {**{f"model.{k}": v for k, v in
                        _adam_first_grad(state.opt, model_p).items()},
                     **{f"phi.{k}": v for k, v in
                        _adam_first_grad(state.crit_state.opt, phi_p).items()}}
    change = {**{f"model.{k}": v.detach() - p0[f"model.{k}"] for k, v in model_p.items()},
              **{f"phi.{k}": v.detach() - p0[f"phi.{k}"] for k, v in phi_p.items()}}
    mark(run, "train_steps")
    readings = {"losses": losses, "first_grad": compare.leaf_norms(first),
                "change": compare.leaf_norms(change), "val": list(val)}
    del first, change, p0

    steps_per_epoch = len(train_idx) // b
    val_sizes = [len(r) for r in plan["val"]]
    fl = run.config["flops"]
    step_flops = yardstick.wcos_train_step_flops(
        b, n_points, pose_iterations=cfg.pcr_iteration_num, blocks=arch["phi_blocks"],
        sinkhorn_iterations=fl["sinkhorn_iterations"], inner_steps=cfg.shwd.max_iter)
    epoch_flops = steps_per_epoch * step_flops + sum(
        yardstick.wcos_val_batch_flops(v, n_points, pose_iterations=cfg.pcr_iteration_num,
                                       blocks=arch["phi_blocks"],
                                       sinkhorn_iterations=fl["sinkhorn_iterations"])
        for v in val_sizes)

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
        _trace(run, trainer, ds, epoch)
    measure()
    run.kernels = {}
    del trainer, state, ds, phi, model_p, phi_p, epoch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run.check_inputs = {"weights": weights, "phi": reference_phi(phi_raw, arch),
                        "bank": bank, "plan": plan, "cfg": reference_config(run.config, cfg)}
    run.program_readings = readings
    ref = reference(run.config).follow(**run.check_inputs)
    run.checks = checks(readings, as_readings(ref), run.workload["limits"])


def _trace(run: Run, trainer, ds, epoch) -> None:
    """``trace_epochs`` more epochs under the device trace; the graphs'
    counts; K3's probe on the last batch's centred clouds. The program
    keeps its captured graphs in ``Trainer._fused["graphs"]``: a traced
    run that finds no train step graph there fails."""
    trace = DeviceTrace()
    trace.start()
    for _ in range(run.workload["trace_epochs"]):
        epoch()
    trace.stop()
    run.trace_summary = trace.summary()
    run.graphs = [g.stats() for g in trainer._fused["graphs"].values()]
    require([g for g in run.graphs if g and g["name"].startswith("train step")
             and g["kernel_nodes"]], "train step graph with kernel nodes")
    last = ds.last
    x = last.target - last.target.mean(1, keepdim=True)
    y = last.source - last.source.mean(1, keepdim=True)
    transport = run.config["train_config"]["shwd"]["transport"]
    run.kernels = {"k3": kernels.k3_probe(x, y, transport)}


def reference_phi(phi_raw: dict, arch: dict) -> dict:
    from .reference.common import power_iterations
    phi = {k: v.clone() for k, v in phi_raw.items()}
    power_iterations(phi, arch["phi_blocks"], arch["phi_layers"],
                     arch["phi_init_power_iterations"])
    return phi


def reference_config(config: dict, cfg) -> dict:
    """What the reference needs of the configuration."""
    tc = config["train_config"]
    arch = config["architecture"]
    return {"phi_blocks": arch["phi_blocks"], "phi_layers": arch["phi_layers"],
            "lipschitz_coeff": arch["lipschitz_coeff"],
            "phi_lr": cfg.shwd.phi_lr, "phi_wd": cfg.shwd.phi_weight_decay,
            "lam": cfg.shwd.lam, "transport": tc["shwd"]["transport"],
            "lr": cfg.lr, "weight_decay": cfg.weight_decay,
            "pose_iterations": cfg.pcr_iteration_num,
            "transform": tc["dataset"]["transform"]}


def as_readings(ref: dict) -> dict:
    """A reference's output in the form of the program's readings (leaf
    norms in place of leaves)."""
    return {"losses": ref["losses"], "first_grad": compare.leaf_norms(ref["first_grad"]),
            "change": compare.leaf_norms(ref["change"]), "val": ref["val"]}


def gaps(program: dict, ref: dict) -> dict:
    """The numbers compared: the largest gap of a step's loss; PCRNet's
    worst leaf's gap of first-gradient norms and of change norms, each
    over the larger of the reference leaf's norm and PCRNet's median
    leaf's; phi's median leaf's gap of first-gradient norms and of change
    norms; the largest gap of the validation loss and pose errors. The
    changes are compared over the leaves whose first reference gradient is
    at least a thousandth of the median leaf's (``compare.moved_leaves``).

    phi's worst leaf is not compared: the worst are its last layers'
    biases, which shift both mapped clouds alike and leave every cost
    unchanged. The transport's part of their gradient is nought but for
    rounding (1e-9 on a gradient of 4e-7 to 9e-6, the rest of which is the
    regularizer's), and that rounding flips some of Adam's steps there: a
    gap of up to 2e-2 in their change on one seed in fifteen, as large as
    the control's."""
    model = {k for k in ref["first_grad"] if k.startswith("model.")}
    phi = {k for k in ref["first_grad"] if k.startswith("phi.")}
    moved = compare.moved_leaves(ref["first_grad"])
    return {"loss_gap": max(compare.rel_gap(p, r)
                            for p, r in zip(program["losses"], ref["losses"])),
            "grad_gap": compare.worst_leaf_gap(program["first_grad"], ref["first_grad"],
                                               model)[0],
            "phi_grad_gap": compare.median_leaf_gap(program["first_grad"],
                                                    ref["first_grad"], phi),
            "change_gap": compare.worst_leaf_gap(program["change"], ref["change"],
                                                 moved & model)[0],
            "phi_change_gap": compare.median_leaf_gap(program["change"], ref["change"],
                                                      moved & phi),
            "val_gap": max(compare.rel_gap(p, r) for p, r in zip(program["val"], ref["val"]))}


def diagnose(program: dict, ref: dict) -> dict:
    """Where the gaps come from: each step's loss gap; the three worst
    leaves of the first gradient and of the change (program, reference);
    and the same gaps taken over PCRNet's leaves and over phi's alone, and
    over the median leaf; the leaves that the rule on the first gradient
    leaves out of the change."""
    moved = compare.moved_leaves(ref["first_grad"])

    def worst(kind, keep):
        names = [k for k in ref[kind] if k in keep]
        med = sorted(ref[kind][k] for k in names)[len(names) // 2]
        gap = {k: abs(program[kind][k] - ref[kind][k]) / max(ref[kind][k], med, 1e-30)
               for k in names}
        rank = sorted(names, key=lambda k: -gap[k])
        return {"top": [[k, gap[k], program[kind][k], ref[kind][k]] for k in rank[:3]],
                "median_leaf": gap[rank[len(rank) // 2]]}

    out = {"loss_gaps": [compare.rel_gap(p, r) for p, r in zip(program["losses"],
                                                                  ref["losses"])],
           "val": [program["val"], ref["val"]],
           "not_moved": sorted(set(ref["first_grad"]) - moved)}
    for kind, keep in (("first_grad", set(ref["first_grad"])), ("change", moved)):
        for group in ("", "model.", "phi."):
            out[f"{kind}:{group or 'all'}"] = worst(kind, {k for k in keep
                                                         if k.startswith(group)})
    return out


def checks(program: dict, ref: dict, limits: dict) -> list[Check]:
    values = gaps(program, ref)
    return [Check(k, values[k], limits[k]) for k in values]


def extra_readings(run: Run, controls: bool, full_control: bool = False) -> dict:
    """For ``portbench.readings``: where the gaps come from, and with
    ``controls`` the numbers of the control (the reference with TF32
    products) and of half of each batch left out, each against the
    reference."""
    follow = reference(run.config).follow
    ref = as_readings(follow(**run.check_inputs))
    out = {"where": diagnose(run.program_readings, ref)}
    if controls:
        control = as_readings(follow(**run.check_inputs, tf32=True))
        out.update(control=gaps(control, ref), control_where=diagnose(control, ref),
                   half_batch=gaps(as_readings(follow(**run.check_inputs, half=True)), ref))
    return out
