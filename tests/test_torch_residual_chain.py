"""phi's residual chain on the CPU: the rule that routes a chain to the CUDA
kernels, the deferred construction rounds, and the kernels' plain versions
(``ops/residual_chain.py``) against the module path and its autograd.

The plain versions repeat the kernels' arithmetic (the explicit backward,
the partial sums in f64, the chain rules through w / max(1, sigma / coeff)
and softplus), so these tests hold the kernels' formulas; the card tests
(``test_torch_residual_chain_gpu.py``) hold the kernels to them.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import pytest
import torch

from shwd_torch.flows import (EncoderFlowChart, FlowChain, LipschitzMLP, ResidualFlow,
                              make_flow)
from shwd_torch.flows.residual import kernel_layers, kernel_route
from shwd_torch.ops import residual_chain as rc

CHANNELS = [3, 8, 8, 8, 8, 8, 8, 3]


def _chain(blocks, seed=0, **kw):
    return make_flow("Residual", blocks, generator=torch.Generator().manual_seed(seed), **kw)


def _lively(chain, scale):
    """Undo the last layers' /1000 init (so each block's nonlinear part
    shows) and scale every w by ``scale`` (sigma / coeff above 1 for 4,
    below for 0.25)."""
    with torch.no_grad():
        for f in chain.flows:
            f.net.layers[-1].w.mul_(1000.0)
            for m in f.net.layers:
                m.w.mul_(scale)
    return chain


def _module_forward(chain, x):
    """The module path, flow by flow (ResidualFlow never takes the kernels)."""
    for f in chain.flows:
        x = f(x)
    return x


def _points(n, seed=1):
    return torch.randn(n, 3, generator=torch.Generator().manual_seed(seed))


# -- the route ---------------------------------------------------------------------

@pytest.mark.parametrize("name,build,takes", [
    ("residual_3", lambda: _chain(3), True),
    ("residual_5", lambda: _chain(5), True),
    ("residual_1", lambda: _chain(1), True),
    ("residual_9", lambda: _chain(9), True),           # two segments of the kernels
    ("planar", lambda: make_flow("Planar", 3), False),
    ("hidden_16", lambda: _chain(3, hidden_units=16), False),
    ("hidden_layers_4", lambda: _chain(3, hidden_layers=4), False),
    ("dim_2", lambda: _chain(3, dim=2), False),
    ("chart_flow", lambda: EncoderFlowChart(generator=torch.Generator().manual_seed(0)).flow,
     False),
    ("mixed", lambda: FlowChain([*_chain(2).flows, *make_flow("Planar", 1).flows]), False),
    ("bare_mlp_block", lambda: FlowChain([ResidualFlow(LipschitzMLP(CHANNELS))]), True),
])
def test_kernel_route_is_decided_from_structure(name, build, takes):
    """Which chains take the kernels on a CUDA f32 tensor; a CPU tensor,
    f64, the log-det and every other structure keep the module path."""
    chain = build()
    layers = kernel_route(chain, "cuda", torch.float32)
    assert (layers is not None) == takes
    if takes:
        assert len(layers) == 7 * len(chain.flows)
        assert layers[0].w is chain.flows[0].net.layers[0].w
    assert kernel_route(chain, "cpu", torch.float32) is None
    assert kernel_route(chain, torch.device("cuda", 0), torch.float64) is None
    assert kernel_route(chain, "cuda", torch.float32, logdet=True) is None


def test_cpu_chain_runs_the_modules(monkeypatch):
    """On the CPU a supported chain never reaches the kernels' entry
    points, in the forward nor in update_state."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(rc, "residual_chain", refuse)
    monkeypatch.setattr(rc, "power_iteration", refuse)
    chain = _chain(3)
    y, ld = chain.forward_logdet(_points(20), logdet=True)
    assert y.shape == (20, 3) and ld.shape == (20,)
    assert chain(_points(20)).shape == (20, 3)
    chain.update_state(2)


@pytest.mark.parametrize("blocks", [3, 5])
def test_deferred_construction_rounds_give_the_same_chain(blocks):
    """make_residual_chain draws every layer, then runs the 200 rounds for
    the whole chain: w, b, beta, u and v equal bit for bit those of blocks
    whose layers ran their rounds as they were drawn."""
    new = _chain(blocks, seed=7)
    g = torch.Generator().manual_seed(7)
    old = FlowChain([ResidualFlow(LipschitzMLP(CHANNELS, 0.95, init_zeros=True, generator=g))
                     for _ in range(blocks)])
    a, b = new.state_dict(), old.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the plain versions against the modules --------------------------------------------

@pytest.mark.parametrize("scale", [4.0, 0.25])
@pytest.mark.parametrize("blocks", [3, 5])
def test_reference_forward_matches_the_modules(blocks, scale):
    chain = _lively(_chain(blocks), scale)
    x = _points(64)
    y, saved = rc.chain_forward(x, kernel_layers(chain), save=True)
    want = _module_forward(chain, x).detach()
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert saved.shape == (blocks, 64, 3) and torch.equal(saved[0], x)


def _grads(chain, x, weights, fn):
    """dL/dx and dL/d(w, b, beta) of L = sum(fn(x) * weights)."""
    x = x.clone().requires_grad_(True)
    chain.zero_grad(set_to_none=True)
    torch.sum(fn(x) * weights).backward()
    params = [getattr(m, f) for fl in chain.flows for m in fl.net.layers
              for f in ("w", "b", "beta")]
    return x.grad, [p.grad for p in params]


@pytest.mark.parametrize("scale", [4.0, 0.25])
@pytest.mark.parametrize("blocks", [3, 5])
def test_reference_backward_matches_autograd(blocks, scale):
    """The Function's backward (the plain versions here) gives autograd's
    gradients of the module path, to x and to every w, b and beta, with
    sigma / coeff above 1 (the clamp's branch) and below."""
    chain = _lively(_chain(blocks), scale)
    x = _points(96)
    weights = torch.randn(96, 3, generator=torch.Generator().manual_seed(3))
    gx, gp = _grads(chain, x, weights, lambda h: rc.residual_chain(h, kernel_layers(chain)))
    wx, wp = _grads(chain, x, weights, lambda h: _module_forward(chain, h))
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-6)
    for got, want in zip(gp, wp):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    # every gradient is a view of one buffer: no copy reached .grad
    assert len({g.untyped_storage().data_ptr() for g in gp}) == 1


def test_clamp_tie_passes_the_gradient():
    """sigma / coeff exactly 1: torch.clamp_min's backward passes the
    gradient to sigma, and so does the reduction's chain rule."""
    chain = _lively(_chain(1), 1.0)
    layer = chain.flows[0].net.layers[2]
    with torch.no_grad():
        layer.coeff = float(layer.u @ (layer.w @ layer.v))
    assert float((layer.u @ (layer.w @ layer.v)) / layer.coeff) == 1.0
    x = _points(32)
    weights = torch.randn(32, 3, generator=torch.Generator().manual_seed(4))
    _, gp = _grads(chain, x, weights, lambda h: rc.residual_chain(h, kernel_layers(chain)))
    _, wp = _grads(chain, x, weights, lambda h: _module_forward(chain, h))
    for got, want in zip(gp, wp):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)


def test_segments_of_a_long_chain():
    """A chain of more than MAX_BLOCKS blocks runs as segments; forward and
    gradients match the modules."""
    blocks = rc.MAX_BLOCKS + 2
    chain = _lively(_chain(blocks), 4.0)
    x = _points(40)
    torch.testing.assert_close(rc.residual_chain(x, kernel_layers(chain)),
                               _module_forward(chain, x).detach(), rtol=1e-5, atol=1e-6)
    weights = torch.randn(40, 3, generator=torch.Generator().manual_seed(5))
    gx, gp = _grads(chain, x, weights, lambda h: rc.residual_chain(h, kernel_layers(chain)))
    wx, wp = _grads(chain, x, weights, lambda h: _module_forward(chain, h))
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-6)
    for got, want in zip(gp, wp):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_iter", [1, 200])
def test_reference_power_iteration_is_the_modules(n_iter):
    chain, twin = _chain(3, seed=2), _chain(3, seed=2)
    with torch.no_grad():
        for c in (chain, twin):
            for f in c.flows:
                for m in f.net.layers:
                    m.w.mul_(1.5)
    rc.chain_power_iteration(kernel_layers(chain), n_iter)
    for f in twin.flows:
        f.update_state(n_iter)
    for k, v in chain.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k


def test_backward_skips_what_the_pass_does_not_ask_for(monkeypatch):
    """torch.autograd.grad for x alone, or backward(inputs=[x]), runs no
    reduction of the parameters' gradients; the inner ascent's backward
    (x detached) runs no dL/dx."""
    calls = []
    real_backward, real_reduce = rc.chain_backward, rc.chain_grad_reduce

    def backward(saved, gy, layers, want_x=True, want_params=True):
        calls.append(("backward", want_x, want_params))
        return real_backward(saved, gy, layers, want_x, want_params)

    def reduce(partials, layers):
        calls.append(("reduce",))
        return real_reduce(partials, layers)

    monkeypatch.setattr(rc, "chain_backward", backward)
    monkeypatch.setattr(rc, "chain_grad_reduce", reduce)
    chain = _chain(3)
    layers = kernel_layers(chain)
    x = _points(16).requires_grad_(True)
    torch.autograd.grad(rc.residual_chain(x, layers).sum(), [x])
    rc.residual_chain(x, layers).sum().backward(inputs=[x])
    assert calls == [("backward", True, False)] * 2
    calls.clear()
    rc.residual_chain(x.detach(), layers).sum().backward()
    assert calls == [("backward", False, True), ("reduce",)]
    assert x.grad is not None and chain.flows[0].net.layers[0].w.grad is not None


@pytest.mark.parametrize("bad", ["f64", "not_contiguous", "wrong_width", "no_points"])
def test_entry_points_raise_on_what_the_kernels_do_not_take(bad):
    chain = _chain(3)
    layers = kernel_layers(chain)
    x = _points(10)
    if bad == "f64":
        x = x.double()
    elif bad == "not_contiguous":
        x = torch.randn(10, 6)[:, ::2]
    elif bad == "no_points":
        x = x[:0]
    else:
        layers = kernel_layers(_chain(3))
        layers[3] = layers[3]._replace(w=torch.zeros(8, 16))
    with pytest.raises(ValueError):
        rc.chain_forward(x, layers)
    if bad == "wrong_width":
        with pytest.raises(ValueError):
            rc.chain_power_iteration(layers, 1)
