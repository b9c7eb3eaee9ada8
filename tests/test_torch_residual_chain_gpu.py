"""phi's residual-chain kernels (``csrc/residual_chain.cu``) against the
module path, on the card.

Marked ``gpu``; each test skips without a card. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_residual_chain_gpu.py

Tolerances: the kernels and the modules compute the same f32 formulas in
other orders (FMA chains against cuBLAS products; the parameters'
gradients summed in f64 against cuBLAS's f32 reductions), so values agree
to rounding: rtol 1e-5 on points and dL/dx through 3-5 blocks of 7 layers;
rtol 1e-4 with an absolute floor of 1e-6 of the largest entry over all
leaves on the parameters' gradients, whose sums run over 2,400 to 32,768
points; u and v after 200 power-iteration rounds, where rounding moves a
slowly converging pair, to 1e-4.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import numpy as np
import pytest
import torch

from shwd_torch.flows import SpectralLinear, make_flow
from shwd_torch.flows.residual import kernel_layers
from shwd_torch.ops import residual_chain as rc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _chain(blocks, dev, seed=0, scale=1.0):
    """A phi drawn on ``dev``, its last layers' /1000 undone (so the blocks'
    nonlinear parts show) and every w scaled by ``scale`` (4: sigma / coeff
    above 1 in every layer; 0.25: below)."""
    chain = make_flow("Residual", blocks, generator=torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        for f in chain.flows:
            f.net.layers[-1].w.mul_(1000.0)
            for m in f.net.layers:
                m.w.mul_(scale)
    return chain


def _module_forward(chain, x):
    for f in chain.flows:
        x = f(x)
    return x


def _params(chain):
    return [getattr(m, f) for fl in chain.flows for m in fl.net.layers
            for f in ("w", "b", "beta")]


def _close_leaves(got, want):
    """rtol 1e-4 with a floor of 1e-6 of the largest entry over all leaves:
    a leaf whose gradient nearly cancels (a beta summed over thousands of
    points) carries the rounding of its terms, which are of phi's scale,
    not of its own."""
    floor = 1e-6 * max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=floor)


SHAPES = [((2400, 3), 5), ((128, 256, 3), 3), ((32, 256, 3), 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,blocks", SHAPES)
def test_forward_matches_the_modules(cuda, shape, blocks):
    chain = _chain(blocks, cuda)
    x = torch.randn(*shape, device=cuda)
    n = rc.chain_forward.launches
    y = chain(x)
    assert rc.chain_forward.launches == n + 1
    torch.testing.assert_close(y, _module_forward(chain, x), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [4.0, 0.25])
@pytest.mark.parametrize("shape,blocks", SHAPES)
def test_gradients_match_autograd(cuda, shape, blocks, scale):
    """dL/dx and dL/d(w, b, beta) of L = sum(phi(x) * r), kernels against
    the modules' autograd, with sigma / coeff above and below 1."""
    chain = _chain(blocks, cuda, scale=scale)
    x0 = torch.randn(*shape, device=cuda)
    r = torch.randn(*shape, device=cuda)
    out = {}
    for name, fn in (("kernel", chain), ("module", lambda h: _module_forward(chain, h))):
        x = x0.clone().requires_grad_(True)
        chain.zero_grad(set_to_none=True)
        torch.sum(fn(x) * r).backward()
        out[name] = (x.grad, [p.grad.clone() for p in _params(chain)])
    torch.testing.assert_close(out["kernel"][0], out["module"][0], rtol=1e-5, atol=1e-6)
    _close_leaves(out["kernel"][1], out["module"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("n_iter", [1, 200])
def test_power_iteration_matches_the_modules(cuda, n_iter):
    chain = _chain(5, cuda, scale=1.5)
    twin = _chain(5, cuda, scale=1.5)
    n = rc.chain_power_iteration.launches
    chain.update_state(n_iter)
    assert rc.chain_power_iteration.launches == n + 1
    for f in twin.flows:
        f.update_state(n_iter)
    for (k, a), b in zip(chain.state_dict().items(), twin.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.gpu
def test_two_launches_give_the_same_bits(cuda):
    chain = _chain(5, cuda, scale=4.0)
    layers = kernel_layers(chain)
    x = torch.randn(2400, 3, device=cuda)
    gy = torch.randn(2400, 3, device=cuda)
    runs = []
    for _ in range(2):
        y, saved = rc.chain_forward(x, layers, save=True)
        gx, partials = rc.chain_backward(saved, gy, layers)
        grads = rc.chain_grad_reduce(partials, layers)
        runs.append((y, gx, partials, grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    twins = [_chain(5, cuda, scale=4.0) for _ in range(2)]
    for t in twins:
        t.update_state(3)
    for a, b in zip(twins[0].state_dict().values(), twins[1].state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_power_iteration_between_forward_and_backward_raises(cuda):
    """The kernel's in-place u and v count as writes: a backward through a
    forward that saved them raises, as on the module path."""
    chain = _chain(3, cuda)
    x = torch.randn(64, 3, device=cuda)
    for fn in (chain, lambda h: _module_forward(chain, h)):
        loss = fn(x).sum()
        chain.update_state(1)
        with pytest.raises(RuntimeError, match="modified by an inplace operation"):
            loss.backward()


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["f64", "not_contiguous", "wrong_width", "cpu_params"])
def test_bad_input_raises(cuda, bad):
    chain = _chain(3, cuda)
    layers = kernel_layers(chain)
    x = torch.randn(100, 3, device=cuda)
    if bad == "f64":
        x = x.double()
    elif bad == "not_contiguous":
        x = torch.randn(100, 6, device=cuda)[:, ::2]
    elif bad == "wrong_width":
        layers[8] = layers[8]._replace(w=torch.zeros(8, 16, device=cuda))
    else:
        layers[0] = layers[0]._replace(b=layers[0].b.cpu())
    with pytest.raises(ValueError):
        rc.chain_forward(x, layers)
    if bad in ("wrong_width", "cpu_params"):
        with pytest.raises(ValueError):
            rc.chain_power_iteration(layers, 1)


@pytest.fixture
def module_calls(monkeypatch):
    """Counts the calls of the module path's forward and power iteration."""
    calls = {"forward": 0, "power_iter": 0}
    forward, power_iter = SpectralLinear.forward, SpectralLinear.power_iter

    def counted_forward(self, x):
        calls["forward"] += 1
        return forward(self, x)

    def counted_power_iter(self, n_iter=1):
        calls["power_iter"] += 1
        return power_iter(self, n_iter)

    monkeypatch.setattr(SpectralLinear, "forward", counted_forward)
    monkeypatch.setattr(SpectralLinear, "power_iter", counted_power_iter)
    return calls


PHI_NODES = {"residual_chain_forward": 2, "residual_chain_backward": 2,
             "residual_chain_grad_reduce": 1, "residual_chain_power_iteration": 1}


@pytest.mark.gpu
def test_captured_train_step_runs_phi_as_kernels(cuda, tmp_path, module_calls):
    """A w_cos fit on K3 (one epoch, B=128): the train step graph holds phi
    as 6 kernel nodes (the inner pass forward, backward with the
    parameters' partials and their reduction, the power iteration; the
    final pass forward and its dL/dx), an eval graph 1 (the forward), and
    no phi pass runs on the module path, phi's construction included."""
    from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
    from shwd_torch.losses import SHWDConfig, TransportConfig
    from shwd_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        experiment="phi_kernels", log_dir=str(tmp_path), criterion="w_cos", batch_size=128,
        num_epochs=1, seed=0, checkpoint_flush_every=0,
        dataset=DatasetConfig(source_point_num=128, target_point_num=128, num_synthetic=640,
                              synthetic_kinds=("composite",), val_split=0.3,
                              cache_dir=str(tmp_path / "mc"),
                              transform=TransformConfig(noise_sigma=0.02)),
        shwd=SHWDConfig(transport=TransportConfig(cost="lp", p=2.0, solver="sinkhorn",
                                                  eps=5e-3, num_iters=50, num_scales=4),
                        max_iter=1, lam=1.3e-5, phi_lr=9.2e-5))
    trainer = Trainer(cfg)
    res = trainer.fit(RegistrationDataset(cfg.dataset, "train"), verbose=False)
    assert res["path"] == "fused"
    train = [s for s in res["graphs"] if s["name"].startswith("train")]
    evals = [s for s in res["graphs"] if s["name"].startswith("eval")]
    assert len(train) == 1 and evals
    assert train[0]["nodes_by_kernel"] == {"sinkhorn_points": 2, **PHI_NODES}, train[0]
    for s in evals:
        assert s["nodes_by_kernel"] == {"sinkhorn_points": 1, "residual_chain_forward": 1}, s
    assert module_calls == {"forward": 0, "power_iter": 0}
    assert np.isfinite(res["history"][-1]["train_loss"])


@pytest.mark.gpu
def test_captured_flow_step_runs_phi_as_kernels(cuda, module_calls):
    """The Flow_cube SHWD/hybrid step (1200 points, 5 blocks): the graph
    holds K1, K2 twice and phi's 6 kernel nodes, and no phi pass runs on
    the module path."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 1200).numpy()
    tgt = sample_cube_surface(rng, 1200, biased=True).numpy()
    res = fd.run_flow(src, tgt, fd.FlowConfig(num_iterations=10, eval_interval=5,
                                              shwd_solver="hybrid"))
    assert res.path == "fused"
    assert res.graph["nodes_by_kernel"] == {"emd2_warmup": 1, "auction_assignment": 2,
                                            **PHI_NODES}, res.graph
    assert module_calls == {"forward": 0, "power_iter": 0}
    assert np.isfinite(res.clouds).all()
