"""phi's residual chain of Lipschitz blocks as hand-written CUDA kernels.

No TPU kernel of the JAX package has this place: ``shwd_tpu/flows/
lipschitz.py`` and ``residual.py`` are plain ``jnp``, which XLA fuses.
Op by op the port launched about a dozen kernels a layer a pass; here
``csrc/residual_chain.cu`` runs a chain of up to ``MAX_BLOCKS`` blocks in
one launch a pass (the source's head note says why and how). A longer
chain is cut into segments of ``MAX_BLOCKS`` blocks, one launch each.

A chain is given as its layers, block after block: ``Layer(w, b, beta, u,
v, coeff)`` with the tensors of one ``flows.lipschitz.SpectralLinear``
(w (out, in), b (out,), beta (1,), the power-iteration buffers u (out,)
and v (in,)), ``LAYERS`` a block with the widths ``CHANNELS``. The
kernels read the tensors themselves, so in-place updates (Adam,
``load_state_dict``, the power iteration) are always seen.

Entry points; each launches its kernel for CUDA tensors (or raises on what
the kernel does not take) and runs its plain PyTorch version, the
``*_reference`` beside it, for CPU tensors; each counts its kernel
launches in ``.launches``:

- ``chain_forward(x, layers, save)``: (P, 3) -> (y, the blocks' inputs);
- ``chain_backward(saved, gy, layers, want_x, want_params)``: dL/dx and
  the per-CTA partial sums of the layers' gradients;
- ``chain_grad_reduce(partials, layers)``: the partials summed, then the
  chain rules through w / max(1, sigma / coeff) and softplus, into one flat
  buffer of (dL/dw, dL/db, dL/dbeta) a layer;
- ``chain_power_iteration(layers, n_iter)``: u and v in place.

``residual_chain(x, layers)`` is the differentiable chain (an
``autograd.Function`` whose backward is the kernels, first order only);
the parameters' gradients are views of the flat buffer, so they reach
``.grad`` without a copy. ``power_iteration(layers, n_iter)`` runs the
rounds for every layer. ``flows.base.FlowChain`` takes this route for the
chains and tensors that ``flows.residual.kernel_route`` admits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from .. import _kernels

CHANNELS = (3, 8, 8, 8, 8, 8, 8, 3)
LAYERS = len(CHANNELS) - 1
MAX_BLOCKS = 8                     # blocks a launch takes (its parameter block)


class Layer(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor
    beta: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    coeff: float


def _sizes(li: int) -> tuple[int, int]:
    return CHANNELS[li + 1], CHANNELS[li]


# the flat gradient of a block: per layer w (out x in), b (out), beta (1)
_VALUES = [o * i + o + 1 for o, i in map(_sizes, range(LAYERS))]
_OFFSETS = [sum(_VALUES[:li]) for li in range(LAYERS)]
VALUES_PER_BLOCK = sum(_VALUES)    # 426


def _grad_views(flat: torch.Tensor, layers: Sequence[Layer]):
    """Per layer, its (w, b, beta) slices of a flat (blocks x 426) buffer of
    gradients or partial sums, as views shaped as the parameters."""
    for n in range(len(layers)):
        li = n % LAYERS
        out, inp = _sizes(li)
        off = (n // LAYERS) * VALUES_PER_BLOCK + _OFFSETS[li]
        yield (flat[off:off + out * inp].view(out, inp),
               flat[off + out * inp:off + out * inp + out],
               flat[off + out * inp + out:off + _VALUES[li]])


def _blocks(layers: Sequence[Layer]) -> int:
    if not layers or len(layers) % LAYERS:
        raise ValueError(f"a residual chain has {LAYERS} layers a block, got {len(layers)}")
    return len(layers) // LAYERS


def _check_layers(layers: Sequence[Layer], device: torch.device) -> int:
    """The number of blocks; raises unless every tensor is f32, contiguous,
    of its layer's shape and on ``device``."""
    blocks = _blocks(layers)
    for n, layer in enumerate(layers):
        out, inp = _sizes(n % LAYERS)
        for name, t, shape in (("w", layer.w, (out, inp)), ("b", layer.b, (out,)),
                               ("beta", layer.beta, (1,)), ("u", layer.u, (out,)),
                               ("v", layer.v, (inp,))):
            if (t.dtype != torch.float32 or t.device != device or tuple(t.shape) != shape
                    or not t.is_contiguous()):
                raise ValueError(f"residual chain: layer {n}'s {name} must be a contiguous "
                                 f"f32 {shape} on {device}, got {tuple(t.shape)} {t.dtype} "
                                 f"on {t.device}")
    return blocks


def _check_points(x: torch.Tensor, name: str = "x") -> None:
    if (x.ndim != 2 or x.shape[1] != 3 or x.shape[0] < 1 or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"residual chain: {name} must be contiguous f32 points (P, 3), "
                         f"P >= 1, got {tuple(x.shape)} {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (not contiguous)'}")


# -- plain PyTorch versions (the kernels' arithmetic, on any device) ----------------

def _w_hat(layer: Layer):
    """(w / max(sigma / coeff, 1), sigma / coeff), sigma = u . (W v)."""
    ratio = (layer.u @ (layer.w @ layer.v)) / layer.coeff
    return layer.w / torch.clamp_min(ratio, 1.0), ratio


def _block_forward(layers: Sequence[Layer], x: torch.Tensor):
    """One block on points (P, 3): (x + g(x), each layer's swish input)."""
    h, zs = x, []
    for layer in layers:
        w_hat, _ = _w_hat(layer)
        zs.append(h)
        a = (h * torch.sigmoid(h * F.softplus(layer.beta))) / 1.1
        h = a @ w_hat.T + layer.b
    return x + h, zs


@torch.no_grad()
def chain_forward_reference(x: torch.Tensor, layers: Sequence[Layer], save: bool = False):
    """Plain version of ``chain_forward``: (y (P, 3), saved (blocks, P, 3)
    or None)."""
    _check_points(x)
    saved = []
    for k in range(_check_layers(layers, x.device)):
        saved.append(x)
        x, _ = _block_forward(layers[k * LAYERS:(k + 1) * LAYERS], x)
    return x, (torch.stack(saved) if save else None)


@torch.no_grad()
def chain_backward_reference(saved: torch.Tensor, gy: torch.Tensor, layers: Sequence[Layer],
                             want_x: bool = True, want_params: bool = True):
    """Plain version of ``chain_backward``: (dL/dx (P, 3) or None, the
    sums over all points of (dL/dw_hat, dL/db, dL/dsoftplus(beta)) a layer
    as one partial row (1, blocks x 426) f64, or None)."""
    blocks = _check_layers(layers, gy.device)
    _check_points(gy, "gy")
    partial = torch.zeros(1, blocks * VALUES_PER_BLOCK, dtype=torch.float64,
                          device=gy.device) if want_params else None
    views = list(_grad_views(partial[0], layers)) if want_params else None
    g = gy
    for k in reversed(range(blocks)):
        block = layers[k * LAYERS:(k + 1) * LAYERS]
        _, zs = _block_forward(block, saved[k])
        g_out = g
        for li in reversed(range(LAYERS)):
            layer, z = block[li], zs[li]
            w_hat, _ = _w_hat(layer)
            sp = F.softplus(layer.beta)
            s = torch.sigmoid(z * sp)
            a = (z * s) / 1.1
            gn = (g_out @ w_hat) / 1.1
            gt = gn * z * (1.0 - s) * s
            if want_params:
                pw, pb, pbeta = views[k * LAYERS + li]
                pw.copy_(torch.sum(g_out[:, :, None] * a[:, None, :], 0, dtype=torch.float64))
                pb.copy_(torch.sum(g_out, 0, dtype=torch.float64))
                pbeta.copy_(torch.sum(gt * z, dtype=torch.float64))
            g_out = gn * s + gt * sp
        g = g + g_out
    return (g if want_x else None), partial


@torch.no_grad()
def chain_grad_reduce_reference(partials: torch.Tensor, layers: Sequence[Layer]) -> torch.Tensor:
    """Plain version of ``chain_grad_reduce``: (blocks x 426,) f32."""
    _check_layers(layers, partials.device)
    total = partials.sum(0).float()
    grads = torch.empty_like(total)
    for layer, (g_hat, g_b, g_sp), (gw, gb, gbeta) in zip(
            layers, _grad_views(total, layers), _grad_views(grads, layers)):
        _, ratio = _w_hat(layer)
        den = torch.clamp_min(ratio, 1.0)
        gw.copy_(g_hat / den)
        if bool(ratio >= 1.0):          # clamp_min's backward passes the tie
            corr = torch.sum((-g_hat * layer.w) / (den * den), dtype=torch.float64).float()
            gw.add_((layer.u * (corr / layer.coeff))[:, None] * layer.v[None, :])
        gb.copy_(g_b)
        e = torch.exp(layer.beta)
        gbeta.copy_(torch.where(layer.beta > 20.0, g_sp, g_sp * e / (e + 1.0)))
    return grads


@torch.no_grad()
def chain_power_iteration_reference(layers: Sequence[Layer], n_iter: int = 1) -> None:
    """Plain version of ``chain_power_iteration``: the module's rounds
    (``SpectralLinear.power_iter``) on every layer, in place."""
    _check_layers(layers, layers[0].w.device if layers else torch.device("cpu"))
    for layer in layers:
        w, u, v = layer.w.detach(), layer.u, layer.v
        for _ in range(n_iter):
            u = w @ v
            u = u / torch.clamp_min(torch.linalg.vector_norm(u), 1e-12)
            v = w.T @ u
            v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-12)
        layer.u.copy_(u)
        layer.v.copy_(v)


# -- the kernels ------------------------------------------------------------------

class _CLayer(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p), ("beta", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p), ("coeff", ctypes.c_float)]


def _lib():
    lib = _kernels.load("residual_chain")
    if lib.shwd_residual_chain_forward.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lp = ctypes.POINTER(_CLayer)
        lib.shwd_residual_chain_forward.argtypes = [lp, ci, vp, vp, vp, ll, vp]
        lib.shwd_residual_chain_backward.argtypes = [lp, ci, vp, vp, vp, vp, ci, ll, vp]
        lib.shwd_residual_chain_grad_reduce.argtypes = [lp, ci, vp, ci, vp, vp]
        lib.shwd_residual_chain_power_iter.argtypes = [lp, ci, ci, vp]
        lib.shwd_residual_chain_backward_grid.argtypes = [ll]
        lib.shwd_residual_chain_empty.argtypes = [ll, vp]
        for fn in (lib.shwd_residual_chain_forward, lib.shwd_residual_chain_backward,
                   lib.shwd_residual_chain_grad_reduce, lib.shwd_residual_chain_power_iter,
                   lib.shwd_residual_chain_backward_grid, lib.shwd_residual_chain_max_blocks,
                   lib.shwd_residual_chain_values_per_block, lib.shwd_residual_chain_empty):
            fn.restype = ci
        if (lib.shwd_residual_chain_max_blocks() != MAX_BLOCKS
                or lib.shwd_residual_chain_values_per_block() != VALUES_PER_BLOCK):
            raise RuntimeError("residual_chain.cu and ops/residual_chain.py disagree on the layout")
    return lib


def _c_layers(layers: Sequence[Layer], device: torch.device):
    """(the layers as the C interface's array, blocks); raises on tensors
    the kernels do not take and on more than MAX_BLOCKS blocks."""
    blocks = _check_layers(layers, device)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"residual chain: a launch takes at most {MAX_BLOCKS} blocks, "
                         f"got {blocks}")
    arr = (_CLayer * len(layers))(*[
        _CLayer(l.w.data_ptr(), l.b.data_ptr(), l.beta.data_ptr(), l.u.data_ptr(),
                l.v.data_ptr(), float(l.coeff)) for l in layers])
    return arr, blocks


def chain_forward(x: torch.Tensor, layers: Sequence[Layer], save: bool = False):
    """The chain on points x (P, 3) f32: (y (P, 3), and with ``save`` each
    block's input (blocks, P, 3), else None). One launch."""
    if not x.is_cuda:
        return chain_forward_reference(x, layers, save)
    _check_points(x)
    c_layers, blocks = _c_layers(layers, x.device)
    n = x.shape[0]
    y = torch.empty_like(x)
    saved = torch.empty(blocks, n, 3, dtype=torch.float32, device=x.device) if save else None
    with torch.cuda.device(x.device):
        rc = _lib().shwd_residual_chain_forward(
            c_layers, blocks, x.data_ptr(), y.data_ptr(),
            None if saved is None else saved.data_ptr(), n, _kernels.stream_ptr(x))
    _kernels.check(rc, "residual_chain_forward")
    chain_forward.launches += 1
    return y, saved


chain_forward.launches = 0


def chain_backward(saved: torch.Tensor, gy: torch.Tensor, layers: Sequence[Layer],
                   want_x: bool = True, want_params: bool = True):
    """From the forward's ``saved`` (blocks, P, 3) and gy = dL/dy (P, 3):
    (dL/dx (P, 3) if ``want_x`` else None, the CTAs' partial sums of the
    layers' gradients (CTAs, blocks x 426) f64 if ``want_params`` else
    None). One launch."""
    if not (want_x or want_params):
        raise ValueError("chain_backward: nothing asked for")
    if not gy.is_cuda:
        return chain_backward_reference(saved, gy, layers, want_x, want_params)
    _check_points(gy, "gy")
    c_layers, blocks = _c_layers(layers, gy.device)
    n = gy.shape[0]
    if (saved.dtype != torch.float32 or saved.device != gy.device
            or tuple(saved.shape) != (blocks, n, 3) or not saved.is_contiguous()):
        raise ValueError(f"residual chain: saved must be contiguous f32 {(blocks, n, 3)}, got "
                         f"{tuple(saved.shape)} {saved.dtype}")
    lib = _lib()
    with torch.cuda.device(gy.device):
        gx = torch.empty_like(gy) if want_x else None
        grid, partials = 0, None
        if want_params:
            grid = lib.shwd_residual_chain_backward_grid(n)
            if grid < 1:
                raise RuntimeError(f"residual_chain_backward: no grid for {n} points")
            partials = torch.empty(grid, blocks * VALUES_PER_BLOCK, dtype=torch.float64,
                                   device=gy.device)
        rc = lib.shwd_residual_chain_backward(
            c_layers, blocks, saved.data_ptr(), gy.data_ptr(),
            None if gx is None else gx.data_ptr(),
            None if partials is None else partials.data_ptr(), grid, n,
            _kernels.stream_ptr(gy))
    _kernels.check(rc, "residual_chain_backward")
    chain_backward.launches += 1
    return gx, partials


chain_backward.launches = 0


def chain_grad_reduce(partials: torch.Tensor, layers: Sequence[Layer]) -> torch.Tensor:
    """The partial rows (R, blocks x 426) f64 summed in a fixed order and
    carried through the chain rules: (blocks x 426,) f32, per layer dL/dw
    (out x in, row-major), dL/db (out), dL/dbeta (1). One launch."""
    if not partials.is_cuda:
        return chain_grad_reduce_reference(partials, layers)
    c_layers, blocks = _c_layers(layers, partials.device)
    if (partials.dtype != torch.float64 or partials.ndim != 2 or partials.shape[0] < 1
            or partials.shape[1] != blocks * VALUES_PER_BLOCK or not partials.is_contiguous()):
        raise ValueError(f"residual chain: partials must be contiguous f64 (R, "
                         f"{blocks * VALUES_PER_BLOCK}), got {tuple(partials.shape)} "
                         f"{partials.dtype}")
    grads = torch.empty(blocks * VALUES_PER_BLOCK, dtype=torch.float32, device=partials.device)
    with torch.cuda.device(partials.device):
        rc = _lib().shwd_residual_chain_grad_reduce(
            c_layers, blocks, partials.data_ptr(), partials.shape[0], grads.data_ptr(),
            _kernels.stream_ptr(partials))
    _kernels.check(rc, "residual_chain_grad_reduce")
    chain_grad_reduce.launches += 1
    return grads


chain_grad_reduce.launches = 0


@torch.no_grad()
def chain_power_iteration(layers: Sequence[Layer], n_iter: int = 1) -> None:
    """``n_iter`` >= 1 rounds of power iteration on every layer's u and v,
    in place, from the layer's current w. One launch."""
    if n_iter < 1:
        raise ValueError(f"chain_power_iteration: n_iter must be >= 1, got {n_iter}")
    device = layers[0].w.device if layers else torch.device("cpu")
    if device.type != "cuda":
        return chain_power_iteration_reference(layers, n_iter)
    c_layers, blocks = _c_layers(layers, device)
    with torch.cuda.device(device):
        rc = _lib().shwd_residual_chain_power_iter(c_layers, blocks, n_iter,
                                                   _kernels.stream_ptr(layers[0].w))
    _kernels.check(rc, "residual_chain_power_iteration")
    chain_power_iteration.launches += 1
    # the kernel wrote u and v behind autograd's back: count the writes, so
    # that a backward which saved them raises, as after the module's copy_
    for layer in layers:
        torch.autograd.graph.increment_version(layer.u)
        torch.autograd.graph.increment_version(layer.v)


chain_power_iteration.launches = 0


def chain_launch_floor(x: torch.Tensor) -> None:
    """For measurements: the forward's launch on points x (P, 3) (its grid
    and block) with an empty body. Counts no launch."""
    with torch.cuda.device(x.device):
        rc = _lib().shwd_residual_chain_empty(x.shape[0], _kernels.stream_ptr(x))
    _kernels.check(rc, "residual_chain_launch_floor")


# -- the differentiable chain ------------------------------------------------------------

def _engine_wants(node) -> bool:
    """Whether the running backward pass uses the gradient that flows into
    ``node``: a ``torch.autograd.grad`` for other inputs, or ``backward(
    inputs=...)``, leaves the chain's parameters out, and then no kernel
    computes their gradients (as autograd prunes the module path's)."""
    if node is None:
        return False
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:
        # a leaf that the running torch.autograd.grad returns a gradient for
        return True


class _Segment(torch.autograd.Function):
    """Up to MAX_BLOCKS blocks: forward one launch, backward one launch for
    dL/dx and the partials and one to reduce them."""

    @staticmethod
    def forward(ctx, x, coeffs, *tensors):
        layers = [Layer(*tensors[5 * n:5 * n + 5], c) for n, c in enumerate(coeffs)]
        y, saved = chain_forward(x, layers, save=True)
        ctx.coeffs = coeffs
        ctx.save_for_backward(saved, *tensors)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        saved, *tensors = ctx.saved_tensors
        layers = [Layer(*tensors[5 * n:5 * n + 5], c) for n, c in enumerate(ctx.coeffs)]
        # next_functions: x, then the tensors (coeffs is no tensor)
        nodes = [node for node, _ in ctx.next_functions]
        want_x = ctx.needs_input_grad[0] and _engine_wants(nodes[0])
        want = [ctx.needs_input_grad[2 + i] and _engine_wants(nodes[1 + i])
                for i in range(len(tensors))]
        grads = [None] * len(tensors)
        if not (want_x or any(want)):
            return (None, None, *grads)
        gx, partials = chain_backward(saved, gy.contiguous(), layers, want_x, any(want))
        if partials is not None:
            views = _grad_views(chain_grad_reduce(partials, layers), layers)
            for n, layer_grads in enumerate(views):
                for f, view in enumerate(layer_grads):
                    if want[5 * n + f]:
                        grads[5 * n + f] = view
        return (gx, None, *grads)


def residual_chain(x: torch.Tensor, layers: Sequence[Layer]) -> torch.Tensor:
    """The chain on points x (..., 3) f32, differentiable in x and in the
    layers' w, b and beta (first order; u and v are constants). One launch
    a segment of MAX_BLOCKS blocks forward; backward one for dL/dx and two
    where the parameters' gradients are wanted."""
    shape = x.shape
    h = x.reshape(-1, 3).contiguous()
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for l in layers for t in (l.w, l.b, l.beta)))
    step = MAX_BLOCKS * LAYERS
    for start in range(0, _blocks(layers) * LAYERS, step):
        seg = layers[start:start + step]
        if grad:
            h = _Segment.apply(h, tuple(float(l.coeff) for l in seg),
                               *[t for l in seg for t in l[:5]])
        else:
            h, _ = chain_forward(h, seg)
    return h.reshape(shape)


@torch.no_grad()
def power_iteration(layers: Sequence[Layer], n_iter: int = 1) -> None:
    """``n_iter`` rounds on every layer; one launch a segment of MAX_BLOCKS
    blocks. Nothing for n_iter 0."""
    if n_iter < 1:
        return
    step = MAX_BLOCKS * LAYERS
    for start in range(0, _blocks(layers) * LAYERS, step):
        chain_power_iteration(layers[start:start + step], n_iter)
