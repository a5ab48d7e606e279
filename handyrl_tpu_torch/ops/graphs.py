"""CUDA graphs of whole programs and the host's one read a dispatch.

:class:`CountedGraph` captures a function as one CUDA graph with its
kernels' launches a replay (the wrappers count during a capture, not on a
replay) and the generators of its draws registered; the port's graphs are
all built on it (``ops/train_step.GraphedUpdateStep`` after its warm-up
steps, :class:`CapturedCall` after a first eager call). :class:`CapturedCall`
runs a function that updates static tensors in place as one such graph. :class:`PackedFetch`
copies one packed device tensor a dispatch to pinned host memory without
blocking and hands it to the host one dispatch late. The device-resident
loop (``device_generation``, ``ops/fused_pipeline.py``) and the replay
update step (``ops/train_step.ReplayUpdateStep``) are built on them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import launches

Tensor = torch.Tensor


class CountedGraph:
    """``fn()`` captured as one CUDA graph on ``stream``, and its kernels'
    launches a replay. The kernel wrappers count their launches during the
    capture, never on a replay: the counts the capture took on the calling
    thread's launch path are taken back and kept as :attr:`per_replay`,
    which :meth:`replay` adds to the replaying thread's path, so
    ``kernel_launches()`` stays a count of kernels run. ``generators`` are
    registered with the graph, so each replay draws new numbers from them
    (an unregistered generator would repeat the capture's draws).
    ``warmup`` (eager calls that load the kernels and create the libraries'
    handles before the capture) and the capture run under
    ``launches.capture_lock``, which every forward on the card outside a
    graph holds too, so no other thread launches or synchronises while
    the capture runs. :attr:`out` holds the tensors the capture returned,
    rewritten by each replay."""

    def __init__(self, fn: Callable[[], Any], stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = (),
                 warmup: Optional[Callable[[], None]] = None):
        with launches.capture_lock:
            if warmup is not None:
                warmup()
            stream.wait_stream(torch.cuda.current_stream(stream.device))
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                self.graph.register_generator_state(gen)
            path = launches.current_path()
            before = launches.totals(path)
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = fn()
            self.per_replay: Dict[str, int] = {
                k: n - before[k] for k, n in launches.totals(path).items()}
            launches.add({k: -n for k, n in self.per_replay.items()})

    def replay(self):
        self.graph.replay()
        launches.add(self.per_replay)
        return self.out


class CapturedCall:
    """``fn()`` on a CUDA device as one CUDA graph: its first call runs
    eagerly (real work, counted by the wrappers as it launches; it loads the
    kernels and creates the libraries' handles on the capture's stream), its
    second captures a :class:`CountedGraph` (``generators`` registered) and
    replays it, and every later call replays it. ``fn`` reads and writes
    static tensors in place and returns its outputs; a graph's outputs are
    the tensors its capture returned, rewritten by each replay. On the CPU
    ``fn`` runs eagerly on every call."""

    def __init__(self, fn: Callable[[], Any], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.calls = 0
        self.graph: Optional[CountedGraph] = None
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == 'cuda' else None)

    @property
    def _out(self):
        return self.graph.out

    def __call__(self):
        self.calls += 1
        if self.device.type != 'cuda':
            return self.fn()
        if self.calls == 1:
            cur = torch.cuda.current_stream(self.device)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = self.fn()
            cur.wait_stream(self._side)
            return out
        if self.graph is None:
            self.graph = CountedGraph(self.fn, self._side, self.generators)
        return self.graph.replay()


class PackedFetch:
    """The host's one read a dispatch: a packed float32 device tensor
    copied without blocking into one of two pinned buffers, with an event;
    :meth:`get` waits for that event only (one dispatch late, the copy of
    the next dispatch goes to the other buffer). On the CPU a copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._bufs: List[Tensor] = []
        self._next = 0

    def put(self, packed: Tensor):
        if self.device.type != 'cuda':
            return packed.detach().clone(), None
        if not self._bufs or self._bufs[0].shape != packed.shape:
            self._bufs = [torch.empty(packed.shape, dtype=packed.dtype,
                                      pin_memory=True) for _ in range(2)]
        buf = self._bufs[self._next]
        self._next = 1 - self._next
        buf.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return buf, event

    @staticmethod
    def get(handle) -> np.ndarray:
        buf, event = handle
        if event is not None:
            event.synchronize()
        return buf.numpy().copy()
