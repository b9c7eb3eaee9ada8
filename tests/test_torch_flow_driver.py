"""The slice as a whole: SHWD gradient-flow steps of shwd_torch vs shwd_tpu.

Both packages start from the same numpy clouds and the same phi (the JAX
criterion state, converted); the port's steps run on the CPU.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from shwd_torch.flows import make_flow as t_make_flow
from shwd_torch.ops.sphere_sampling import sample_cube_surface
from shwd_torch.train import flow_driver as tf
from shwd_torch.utils.convert import load_phi
from shwd_tpu.train import flow_driver as jf

CFG = dict(method="SHWD", num_iterations=5, eval_interval=5, shwd_layers=3,
           shwd_lam=0.1, shwd_max_iter=1, shwd_phi_lr=0.001, shwd_phi_wd=0.1,
           shwd_solver="hybrid", seed=0)


def _clouds(n, seed=0, jitter=0.0):
    rng = np.random.default_rng(seed)
    src = sample_cube_surface(rng, n).numpy()
    tgt = sample_cube_surface(rng, n, biased=True).numpy()
    return (src + jitter * rng.normal(size=src.shape).astype(np.float32),
            tgt + jitter * rng.normal(size=tgt.shape).astype(np.float32))


def test_five_flow_steps_match_jax():
    """N=96, 3 layers, hybrid: the clouds after each of 5 steps within
    atol 1e-5 and the losses within rtol 1e-5 (the exact permutations
    agree, so only f32 rounding differs).

    The clouds are jittered off the cube's faces: a source and a target
    point on one face share a coordinate exactly, its gradient is rounding
    noise (~1e-10), and Adam's first steps turn that noise into +-lr moves
    whose sign differs between any two implementations."""
    src, tgt = _clouds(96, jitter=0.01)
    jcfg = jf.FlowConfig(**CFG)
    jinit, jstep = jf._make_loss_step(jcfg)
    jstate = jinit(jax.random.PRNGKey(0))
    jstate["opt"] = jf._make_point_opt(jcfg).init(jax.numpy.asarray(src))
    jstep = jax.jit(jstep)
    crit = jstate["crit"]
    phi = load_phi(t_make_flow("Residual", 3),
                   jax.tree_util.tree_map(np.asarray, crit.phi_params),
                   jax.tree_util.tree_map(np.asarray, crit.phi_state))

    tcfg = tf.FlowConfig(**CFG)
    dev = torch.device("cpu")
    tinit, tstep = tf._make_loss_step(tcfg, dev)
    tstate = tinit(torch.Generator().manual_seed(0), phi=phi)
    points = torch.from_numpy(src.copy()).requires_grad_(True)
    tstate["opt"], tstate["sched"] = tf._make_point_opt(tcfg, points)
    target = torch.from_numpy(tgt)

    jpts = jax.numpy.asarray(src)
    key = jax.random.PRNGKey(1)
    for _ in range(5):
        jpts, jstate, jloss = jstep(jpts, jax.numpy.asarray(tgt), jstate, key)
        tloss = tstep(points, target, tstate)
        np.testing.assert_allclose(points.detach().numpy(), np.asarray(jpts),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(np.abs(points.detach().numpy() - src).max()) > 0.03


def test_run_flow_on_cpu_returns_a_flow_result():
    """A short run_flow on the CPU: well-formed result, W2 goes down."""
    src, tgt = _clouds(48, seed=1)
    cfg = tf.FlowConfig(**{**CFG, "num_iterations": 6, "eval_interval": 3,
                           "shwd_layers": 2})
    res = tf.run_flow(src, tgt, cfg, device="cpu")
    assert res.clouds.shape == (48, 3) and np.isfinite(res.clouds).all()
    np.testing.assert_array_equal(res.eval_iters, [0, 3, 6])
    assert res.eval_values.shape == (3,) and res.interval_seconds.shape == (2,)
    assert res.eval_values[-1] < res.eval_values[0]
    assert res.steps_per_second > 0


def test_run_flow_cd_eval_metric_matches_jax_chamfer():
    """eval_metric="cd" records the Chamfer distance of the evolving cloud:
    the first value against the JAX package's dense chamfer on the same
    clouds, the last against it on the returned cloud (rtol 1e-5: the
    tiled minima of direct differences against the dense x2+y2-2xy)."""
    from shwd_tpu.ops.chamfer import chamfer as j_chamfer
    src, tgt = _clouds(48, seed=2)
    cfg = tf.FlowConfig(**{**CFG, "num_iterations": 4, "eval_interval": 2,
                           "shwd_layers": 2, "eval_metric": "cd"})
    res = tf.run_flow(src, tgt, cfg, device="cpu")
    assert res.eval_values.shape == (3,)
    want0 = float(j_chamfer(jax.numpy.asarray(src)[None], jax.numpy.asarray(tgt)[None]))
    want2 = float(j_chamfer(jax.numpy.asarray(res.clouds)[None],
                            jax.numpy.asarray(tgt)[None]))
    np.testing.assert_allclose(res.eval_values[0], want0, rtol=1e-5)
    np.testing.assert_allclose(res.eval_values[-1], want2, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown eval metric"):
        tf.run_flow(src, tgt, dataclasses.replace(cfg, eval_metric="emd"),
                    device="cpu")


def test_run_flow_lr_decay_matches_optax_schedule():
    """lr_decay_alpha < 1 follows optax.cosine_decay_schedule."""
    import optax
    cfg = tf.FlowConfig(**{**CFG, "num_iterations": 10, "lr_decay_alpha": 0.1})
    points = torch.zeros(4, 3, requires_grad=True)
    opt, sched = tf._make_point_opt(cfg, points)
    want = optax.cosine_decay_schedule(cfg.lr, 10, alpha=0.1)
    for t in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(t)),
                                   rtol=1e-6)
        opt.step()
        sched.step()


def test_run_flow_needs_cuda_unless_asked_for_cpu():
    """The card is the default device; without CUDA that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    src, tgt = _clouds(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.run_flow(src, tgt, tf.FlowConfig(**CFG))


@pytest.mark.parametrize("method", ["SHWD", "DSWD", "SWD"])
def test_run_flow_warm_up_leaves_the_trajectory_as_it_was(method):
    """run_flow's warm-up step (on copies of the points, the state and the
    optimiser, the generator restored) changes nothing: the clouds equal,
    bit for bit, those of the same steps taken by hand from the same seed.
    SHWD draws phi from the generator; DSWD also redraws its directions
    every step and keeps a learned net; SWD draws its directions."""
    src, tgt = _clouds(40, seed=3)
    cfg = tf.FlowConfig(**{**CFG, "method": method, "num_iterations": 4,
                           "eval_interval": 2, "shwd_layers": 2,
                           "num_projections": 16})
    res = tf.run_flow(src, tgt, cfg, device="cpu")
    init_state, step = tf._make_loss_step(cfg, torch.device("cpu"))
    state = init_state(torch.Generator().manual_seed(cfg.seed))
    points = torch.from_numpy(src.copy()).requires_grad_(True)
    state["opt"], state["sched"] = tf._make_point_opt(cfg, points)
    target = torch.from_numpy(tgt)
    for _ in range(cfg.num_iterations):
        step(points, target, state)
    np.testing.assert_array_equal(res.clouds, points.detach().numpy())
    assert float(np.abs(res.clouds - src).max()) > 0.01


def test_flops_per_step_is_counted_on_the_warm_up_step():
    """flops_per_step: finite and positive for SHWD (phi's products, with
    their backward), equal to counting one step by hand."""
    from shwd_torch.utils.profiling import counted_flops
    src, tgt = _clouds(32, seed=4)
    cfg = tf.FlowConfig(**{**CFG, "num_iterations": 2, "eval_interval": 2,
                           "shwd_layers": 2})
    res = tf.run_flow(src, tgt, cfg, device="cpu")
    assert np.isfinite(res.flops_per_step) and res.flops_per_step > 0
    init_state, step = tf._make_loss_step(cfg, torch.device("cpu"))
    state = init_state(torch.Generator().manual_seed(cfg.seed))
    points = torch.from_numpy(src.copy()).requires_grad_(True)
    state["opt"], state["sched"] = tf._make_point_opt(cfg, points)
    assert counted_flops(step, points, torch.from_numpy(tgt), state) == res.flops_per_step


def test_path_kernels():
    """The kernel sources run_flow loads before its window, by path."""
    cfg = tf.FlowConfig(**CFG)
    assert tf.path_kernels(cfg) == ("emd2_warmup", "auction")
    assert tf.path_kernels(dataclasses.replace(cfg, eval_metric="cd")) == (
        "emd2_warmup", "auction", "chamfer")
    assert tf.path_kernels(dataclasses.replace(cfg, shwd_solver="sinkhorn")) == (
        "sinkhorn_points",)
    assert tf.path_kernels(dataclasses.replace(cfg, method="SWD")) == ()
