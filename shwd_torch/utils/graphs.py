"""One step captured as a CUDA graph and replayed: the port's fused execution.

Counterpart of what ``jax.jit`` plus ``lax.scan`` give the JAX package
(``Trainer._epoch_scan``, ``run_flow``'s scanned interval): the host issues a
step's hundreds to thousands of launches once, at capture, and afterwards
one replay per step. ``StepGraph`` holds:

- static inputs: buffers the caller fills before each call (``__call__``
  copies its arguments into them);
- a warm-up on a side stream before the capture (libraries load, lazy
  state is made; the caller's warm-up leaves the state as it found it, see
  ``preserved``); every graph of a device uses the same side stream
  (``capture_stream``);
- the capture, on that stream, with the step's ``torch.Generator``s
  registered so that every replay draws what the eager step would;
- ``replay()`` per call, adding each kernel wrapper's nodes to its launch
  count and the step's collectives to ``parallel.mesh.collective_calls``
  (a replay calls no Python wrapper);
- device marks (``utils.profiling.device_span``): the capture records the
  step's marks, and the whole step as ``graph``, as timing-event nodes;
  ``collect()``, called after a host sync, notes the last replay's
  milliseconds by label in the profiling store, and its device counters
  (``utils.profiling.device_count``) by label;
- on the CPU, a direct call of the same function on the same static
  buffers: the same path without capture.

There is no fallback: a capture that fails (a host sync inside the step, an
allocation the graph cannot hold) raises with the step's name.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Callable, Sequence

import torch
from torch import nn

from ..parallel import mesh as pmesh
from . import profiling

_KERNEL_NODE = 0          # CUgraphNodeType: CU_GRAPH_NODE_TYPE_KERNEL
# one side stream per device for every warm-up and capture: cuBLAS gets a
# workspace (32 MiB, twice with cuBLASLt's) for each stream it runs on, and
# PyTorch keeps it for the life of the process, so a new stream per
# capture left ~100 MiB allocated behind every fit
_CAPTURE_STREAMS: dict = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every ``StepGraph`` on ``device`` warms up and
    captures on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def kernel_wrappers() -> dict:
    """The port's CUDA kernel wrappers by name; each counts its launches in
    ``.launches``."""
    from ..ops import auction, residual_chain, sinkhorn_fused, sinkhorn_kernels
    from ..ops.chamfer import chamfer_tiled
    return {"emd2_warmup": sinkhorn_kernels.emd2_warmup,
            "auction_assignment": auction.auction_assignment,
            "sinkhorn_points": sinkhorn_fused.sinkhorn_points,
            "chamfer_tiled": chamfer_tiled,
            "residual_chain_forward": residual_chain.chain_forward,
            "residual_chain_backward": residual_chain.chain_backward,
            "residual_chain_grad_reduce": residual_chain.chain_grad_reduce,
            "residual_chain_power_iteration": residual_chain.chain_power_iteration,
            "sinkhorn_warm": sinkhorn_kernels.sinkhorn_warm}


def _collect(obj, tensors: list, generators: list, seen: set) -> None:
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
    elif isinstance(obj, torch.Generator):
        generators.append(obj)
    elif isinstance(obj, nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            _collect(t, tensors, generators, seen)
    elif isinstance(obj, torch.optim.Optimizer):
        for state in obj.state.values():
            _collect(state, tensors, generators, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _collect(getattr(obj, f.name), tensors, generators, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect(v, tensors, generators, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect(v, tensors, generators, seen)


def step_generators(*objs) -> list[torch.Generator]:
    """The ``torch.Generator``s reachable from ``objs`` (dataclasses,
    dicts, lists, modules, optimizers)."""
    tensors, generators = [], []
    _collect(objs, tensors, generators, set())
    return generators


@contextlib.contextmanager
def preserved(*objs):
    """Every tensor reachable from ``objs`` (module parameters and buffers,
    optimizer states, tensors in dataclasses, dicts and lists) and every
    generator's state are put back, in place, when the block ends: a
    warm-up step on the real state leaves no trace. Optimizer state made
    inside the block is not removed (``init_adam_state`` makes it before)."""
    tensors, generators = [], []
    _collect(objs, tensors, generators, set())
    saved = [t.detach().clone() for t in tensors]
    gen_states = [g.get_state() for g in generators]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        for g, s in zip(generators, gen_states):
            g.set_state(s)


def graph_node_types(graph: "torch.cuda.CUDAGraph") -> list[int] | None:
    """The node types (CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, ...)
    of a captured graph kept with ``keep_graph=True``, read with the
    driver's ``cuGraphGetNodes``; None where the graph is not kept."""
    try:
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
    except (AttributeError, RuntimeError):
        return None
    driver = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        return None
    nodes = (ctypes.c_void_p * count.value)()
    if driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        return None
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            return None
        kinds.append(kind.value)
    return kinds


class StepGraph:
    """``fn(*inputs)`` captured once and replayed per call on the card;
    called directly on the CPU.

    ``examples`` give the static inputs' shapes, types and device; each
    call copies its arguments into them. ``fn`` must update its state in
    place and return tensors (the static outputs, overwritten by every
    replay) or None. ``warmup(*inputs)`` runs once on the capture's stream
    before the capture and must leave the state as it found it (wrap the
    step in ``preserved``); None runs no warm-up. ``generators`` are the
    ``torch.Generator``s the step draws from, registered with the graph.
    """

    def __init__(self, name: str, fn: Callable, examples: Sequence[torch.Tensor],
                 *, device: torch.device, warmup: Callable | None = None,
                 generators: Sequence[torch.Generator] = ()):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.inputs = [torch.empty_like(t, device=self.device) for t in examples]
        self.warmup = warmup
        self.generators = list(generators)
        self.graph = None
        self.outputs = None
        self.replays = 0
        self.kernel_nodes: int | None = None
        self.nodes_by_kernel: dict[str, int] = {}
        self.collectives = 0
        self.capture_seconds = 0.0
        self._launches: list = []          # (kernel wrapper, its nodes)
        self._marks: profiling.DeviceMarks | None = None
        self._counters: profiling.DeviceCounters | None = None
        self._collected = 0                # replays at the last collect

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self) -> None:
        """Warm up and capture now (the first call does it otherwise);
        nothing on the CPU or once captured."""
        if self.device.type != "cuda" or self.graph is not None:
            return
        with profiling.span("graph.capture", graph=self.name):
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        if self.warmup is not None:
            with torch.cuda.stream(stream):
                self.warmup(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generators and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(f"step {self.name!r} draws from a generator and this "
                               "PyTorch cannot register one with a CUDA graph")
        for g in self.generators:
            graph.register_generator_state(g)
        wrappers = kernel_wrappers()
        before = {k: w.launches for k, w in wrappers.items()}
        collectives = pmesh.collective_calls
        marks = profiling.DeviceMarks(stream)
        counters = profiling.DeviceCounters()
        try:
            with (torch.cuda.graph(graph, stream=stream), profiling.capturing(marks),
                  profiling.counting(counters), profiling.device_span("graph")):
                outputs = self.fn(*self.inputs)
        except Exception as err:
            raise RuntimeError(f"capturing step {self.name!r} as a CUDA graph "
                               f"failed: {err}") from err
        finally:
            # the capture recorded the wrappers' kernels and the collectives
            # and launched none
            for k, w in wrappers.items():
                self.nodes_by_kernel[k] = w.launches - before[k]
                w.launches = before[k]
            self.collectives = pmesh.collective_calls - collectives
            pmesh.collective_calls = collectives
        self.nodes_by_kernel = {k: v for k, v in self.nodes_by_kernel.items() if v}
        self._launches = [(wrappers[k], n) for k, n in self.nodes_by_kernel.items()]
        kinds = graph_node_types(graph)
        self.kernel_nodes = None if kinds is None else kinds.count(_KERNEL_NODE)
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        self.graph, self.outputs = graph, outputs
        self._marks = marks if marks.spans else None
        self._counters = counters if counters.parts else None
        self.capture_seconds = time.perf_counter() - t0

    def __call__(self, *values: torch.Tensor):
        for buf, v in zip(self.inputs, values):
            buf.copy_(v)
        if self.device.type != "cuda":
            self.replays += 1
            return self.fn(*self.inputs)
        self.capture()
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self._launches:
            wrapper.launches += n
        pmesh.collective_calls += self.collectives
        return self.outputs

    def collect(self) -> dict | None:
        """Call after a host sync that follows the replays: notes in the
        profiling store (``graph.collect``) the graph's name, the replays
        since the last collect and the last replay's device milliseconds,
        the whole step's (``graph_ms``) and each mark's (``ms``), and,
        where the step keeps device counters, the last replay's counts by
        label (``counts``); returns that record's attributes. None on the
        CPU, before a replay and when nothing was replayed since the last
        collect."""
        fresh = self.replays - self._collected
        if self._marks is None or fresh <= 0:
            return None
        self._collected = self.replays
        ms = self._marks.elapsed_ms()
        graph_ms = ms.pop("graph")
        counts = {} if self._counters is None else {"counts": self._counters.read()}
        return profiling.note("graph.collect", graph=self.name, replays=fresh,
                              graph_ms=graph_ms, ms=ms, **counts).attrs

    def stats(self) -> dict:
        """Name, replays (calls on the CPU), the graph's kernel nodes, each
        kernel wrapper's nodes and the collectives per replay, and the
        seconds the warm-up and capture took."""
        return {"name": self.name, "captured": self.captured, "replays": self.replays,
                "kernel_nodes": self.kernel_nodes, "nodes_by_kernel": self.nodes_by_kernel,
                "collectives": self.collectives, "capture_seconds": self.capture_seconds}
