"""Multi-rank runs of the port on the CPU, for the parallel-layer tests.

``spawn(worker, world, tmp_path, *args)`` starts ``world`` gloo processes
(``torch.multiprocessing.spawn``), joined through a file store under
``tmp_path`` so that no TCP port is shared between concurrent test workers;
each runs ``worker(rank, world, *args)`` with one intra-op thread, and the
parent gets the list of what each rank returned. A spawn costs about 3-4 s
(every process imports torch and the port).

This module and its workers import neither JAX nor the JAX package: the
spawned processes load it by name, and the test files compute the JAX side
in the parent.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, worker, world, store, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = worker(rank, world, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(worker, world: int, tmp_path, *args) -> list:
    out_dir = Path(tmp_path) / f"ranks_{worker.__name__}_{world}"
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    mp.spawn(_entry, args=(worker, world, str(store), str(out_dir), args),
             nprocs=world, join=True)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _global_grad(g: torch.Tensor) -> np.ndarray:
    """The mean over the world of each rank's gradient of a tensor every
    rank holds: the global gradient (``parallel.mesh``'s convention)."""
    g = g.clone()
    dist.all_reduce(g)
    return (g / dist.get_world_size()).numpy()


# -- workers ---------------------------------------------------------------------

def one_process_mesh(rank, world):
    """make_mesh with no process group: a wrong size raises before a group
    is made; the default makes the one-process group itself."""
    from shwd_torch.parallel import make_mesh
    dist.destroy_process_group()
    try:
        make_mesh(data=2, device="cpu")
    except ValueError as e:
        msg = str(e)
    no_group = not dist.is_initialized()
    shape = tuple(make_mesh(device="cpu").shape)
    return shape, no_group, msg


def sharded_losses(rank, world, data, slices, x, y, frames, tx, ty):
    """make_sharded_ssw's value and global gradient, and
    make_sharded_transport's value, on a (data, slices) mesh."""
    from shwd_torch.parallel import (make_mesh, make_sharded_ssw,
                                     make_sharded_transport)
    mesh = make_mesh(data=data, slices=slices, device="cpu")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    xt = _t(x).requires_grad_(True)
    ssw = make_sharded_ssw(mesh, p=2)(xt, _t(y), _t(frames))
    (grad,) = torch.autograd.grad(ssw, xt)
    transport = make_sharded_transport(mesh, cost="lp", p=2.0)(_t(tx), _t(ty))
    return {"shape": shape, "ssw": float(ssw), "grad": _global_grad(grad),
            "transport": float(transport)}


def dist_sort_ops(rank, world, x, keys, payload, w, u, v, cu, cv):
    """dist_sort (with and without a payload), dist_cumsum, dist_emd1d and
    dist_emd1d_circle on this rank's blocks; the gathered results."""
    from shwd_torch.parallel import (dist_cumsum, dist_emd1d, dist_emd1d_circle,
                                     dist_sort)

    def block(a):
        n = a.shape[-1] // world
        return _t(a[..., rank * n:(rank + 1) * n])

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=-1).numpy()

    ks, ps = dist_sort(block(keys), world, payload=block(payload))
    return {"sort": gather(dist_sort(block(x), world)),
            "keys": gather(ks), "payload": gather(ps),
            "cumsum": gather(dist_cumsum(block(w), world)),
            "emd1d": dist_emd1d(block(u), block(v), world, p=2).numpy(),
            "circle": dist_emd1d_circle(block(cu), block(cv), world).numpy()}


def dist_ssw(rank, world, points, x, y, frames):
    """make_dist_ssw's value and global gradient on a (data, points)
    mesh."""
    from shwd_torch.parallel import make_dist_ssw, make_points_mesh
    mesh = make_points_mesh(points=points, data=world // points, device="cpu")
    xt = _t(x).requires_grad_(True)
    val = make_dist_ssw(mesh)(xt, _t(y), _t(frames))
    (grad,) = torch.autograd.grad(val, xt)
    return {"value": float(val), "grad": _global_grad(grad)}


def fit(rank, world, cfg_json, mesh_data, mesh_slices):
    """Trainer.fit on the mesh; the history, and whether this rank wrote the
    run's files."""
    import json
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer, config_from_dict
    cfg = dataclasses.replace(config_from_dict(json.loads(cfg_json)),
                              mesh_data=mesh_data, mesh_slices=mesh_slices,
                              experiment=f"rank{rank}")
    trainer = Trainer(cfg, device="cpu")
    ds = RegistrationDataset(cfg.dataset, "train", device="cpu")
    hist = trainer.fit(ds, verbose=False)["history"]
    wrote = (Path(cfg.log_dir) / cfg.experiment / "config.json").exists()
    return {"history": hist, "wrote": wrote}


def fit_both_paths(rank, world, cfg_jsons):
    """Each config fitted on a ``data`` mesh of the world, with fused_epoch
    True and then False: per config and path, the path the trainer took,
    the history, the collectives issued through ``parallel.mesh`` and the
    final model parameters."""
    import json
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.parallel import mesh as pmesh
    from shwd_torch.train import Trainer, config_from_dict
    out = []
    for cfg_json in cfg_jsons:
        runs = {}
        for fused in (True, False):
            cfg = dataclasses.replace(config_from_dict(json.loads(cfg_json)),
                                      mesh_data=world, fused_epoch=fused,
                                      experiment=f"rank{rank}_{fused}")
            trainer = Trainer(cfg, device="cpu")
            ds = RegistrationDataset(cfg.dataset, "train", device="cpu")
            pmesh.collective_calls = 0
            res = trainer.fit(ds, verbose=False)
            runs[fused] = {"path": trainer.execution_path(), "history": res["history"],
                           "collectives": pmesh.collective_calls,
                           "graphs": res["graphs"],
                           "params": [p.detach().clone()
                                      for p in res["state"].model.parameters()]}
        out.append(runs)
    return out


def fits(rank, world, cfg_jsons, mesh_data, mesh_slices):
    """``fit`` of each config in turn."""
    return [fit(rank, world, c, mesh_data, mesh_slices) for c in cfg_jsons]


def fit_raises(rank, world, cfg_json, mesh_data):
    from shwd_torch.train import Trainer, config_from_dict
    import json
    cfg = dataclasses.replace(config_from_dict(json.loads(cfg_json)),
                              mesh_data=mesh_data)
    try:
        Trainer(cfg, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def refine(rank, world, src, tgt, loss, num_steps, lr):
    """sharded_refine_poses over the world's data axis."""
    from shwd_torch.parallel import make_mesh, sharded_refine_poses
    from shwd_torch.train.pose_refine import PoseRefineConfig
    mesh = make_mesh(device="cpu")
    res = sharded_refine_poses(mesh, _t(src), _t(tgt),
                               PoseRefineConfig(loss=loss, num_steps=num_steps, lr=lr))
    return {k: getattr(res, k).numpy() for k in res._fields}


def scaling(rank, world):
    from shwd_torch.parallel import measure_scaling
    pts = measure_scaling([1, 2], per_device_batch=2, n_points=16,
                          num_projections=4, steps=1, verbose=False, device="cpu")
    return [dataclasses.asdict(p) for p in pts]


def sites(cost, x, y):
    """The values of the ops whose single-device result is batch-wide, each
    on this rank's rows under the active data group (the whole batch with
    no group): emd2_approx's values (eps0 = max |C|), the hybrid auction's
    eps0 (the cost range), one SHWD train call (phi's inner Adam step on the
    batch mean), one max-SSW train call (a minibatch of 3 of the batch, the
    phi step on the sum) and the pseudo-SHWD value (the max over flows of
    the batch means)."""
    from shwd_torch.flows import SphereChartMLP, make_flow
    from shwd_torch.losses import (MaxSSWConfig, MaxSSWLoss, PseudoSHWDConfig,
                                   PseudoSHWDLoss, SHWDConfig, SHWDLoss,
                                   TransportConfig)
    from shwd_torch.ops.auction import _hybrid_eps0
    from shwd_torch.ops.sinkhorn import emd2_approx
    from shwd_torch.parallel.mesh import gather_rows, reduce_values, shard_rows
    cost, x, y = shard_rows(_t(cost)), shard_rows(_t(x)), shard_rows(_t(y))
    flat = (lambda m: torch.cat([p.detach().reshape(-1) for p in m.parameters()]).numpy())
    tp = TransportConfig(solver="sinkhorn", eps=0.05, num_iters=10, num_scales=3)
    out = {"emd2": gather_rows(emd2_approx(cost, eps=0.05, num_iters=10,
                                           num_scales=3)).numpy(),
           "eps0": float(_hybrid_eps0(cost, 1e-7))}
    shwd = SHWDLoss(lambda g: make_flow("Residual", 1, generator=g),
                    SHWDConfig(transport=tp, lam=1e-3, phi_lr=1e-2))
    state = shwd.init(torch.Generator().manual_seed(0))
    (loss, _, _), state = shwd.apply(state, x, y, True)
    out["shwd_loss"], out["shwd_phi"] = float(reduce_values(loss.detach())), flat(state.phi)
    ssw = MaxSSWLoss(lambda g: SphereChartMLP(generator=g),
                     MaxSSWConfig(num_projections=8, p=1.0, max_iter=2, phi_lr=1e-2,
                                  minibatch=3))
    state = ssw.init(torch.Generator().manual_seed(1))
    (value, _, _), state = ssw.apply(state, x, y, True)
    out["ssw_value"] = float(reduce_values(value.detach(), "sum"))
    out["ssw_phi"] = flat(state.phi)
    pseudo = PseudoSHWDLoss(lambda g: make_flow("Residual", 1, generator=g),
                            PseudoSHWDConfig(transport=tp, phi_num=3, combine="max"))
    (value, _, _), _ = pseudo.apply(pseudo.init(torch.Generator().manual_seed(2)), x, y)
    out["pseudo"] = float(value)
    return out


def collective_sites(rank, world, cost, x, y):
    from shwd_torch.parallel import data_parallel
    with data_parallel(dist.group.WORLD):
        return sites(cost, x, y)


def train_step(rank, world, cfg_json, params, phi_params, phi_state, arrays):
    """One data-parallel train step of the port from the given JAX weights
    on this rank's rows of ``arrays``: the global loss, the model's
    parameters and averaged gradients after the step, phi's state dict."""
    import json
    from shwd_torch.data import RegistrationBatch
    from shwd_torch.parallel import data_parallel, reduce_values
    from shwd_torch.train import Trainer, config_from_dict
    from shwd_torch.utils.convert import load_pcrnet, load_phi
    cfg = dataclasses.replace(config_from_dict(json.loads(cfg_json)), mesh_data=world)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    load_pcrnet(state.model, params)
    load_phi(state.crit_state.phi, phi_params, phi_state)
    batch = trainer._rows(RegistrationBatch(*(_t(a) for a in arrays)))
    with data_parallel(trainer._data_group):
        loss = reduce_values(trainer._train_step(state, batch))
    return {"loss": float(loss), "model": state.model.state_dict(),
            "grads": [p.grad for p in state.model.parameters()],
            "phi": state.crit_state.phi.state_dict()}
