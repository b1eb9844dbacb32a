"""Captured decode steps: CUDA graphs over the arena-backed step.

Stands in for the reference's counted jit (``count_compile`` /
``_LazyJit`` in ``runtime/residency.py``): where the reference compiles
the decode step once and dispatches the executable, the port captures
the step once as a CUDA graph and replays it. A capture is the port's
compile, and ``CAPTURE_CALLS`` counts them.

* A captured step owns its static input tensors; the caller ``copy_``s
  its inputs into them before a replay and reads the static outputs
  after it. The arena and the state buffer are allocated before the
  capture and never move, so the graph bakes their addresses in.
* :class:`CapturedStep` runs the step once on its pool's side stream
  (the warm-up ``torch.cuda.graph`` asks for: library handles and
  ``flash_decode``'s counts for that stream are made there, outside any
  graph's memory), then captures it on the same stream. Nothing falls
  back: a step that cannot be captured raises.
* One :class:`GraphPool` is shared by an engine's graphs: their
  allocations (the custom ops' outputs and scratch, the boundary
  outputs, the sampler's temporaries) come from one private pool. The
  graphs are replayed one at a time on one stream, which is what
  sharing a pool requires.
* Each graph records how many launches of each hand-written kernel it
  captured; the wrappers' ``LAUNCHES`` are left as they were before the
  capture (a capture launches nothing), and every replay adds the
  graph's captured launches to ``REPLAYED_LAUNCHES``.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.kernels import flash_decode, ssd_chunk

# CUDA graph captures this process (the reference's COMPILE_CALLS)
CAPTURE_CALLS = 0
# kernel -> (its wrapper's module, the module's count of its launches)
_COUNTS = {"flash_decode": (flash_decode, "LAUNCHES"),
           "flash_decode_paged": (flash_decode, "PAGED_LAUNCHES"),
           "ssd_chunk": (ssd_chunk, "LAUNCHES"),
           "ssd_chunk_bwd": (ssd_chunk, "BWD_LAUNCHES")}
# kernel -> its launches made by replays of captured graphs
REPLAYED_LAUNCHES: dict[str, int] = {k: 0 for k in _COUNTS}


def wrapper_launches() -> dict[str, int]:
    """The launches each kernel's wrapper made itself (eager calls)."""
    return {k: getattr(m, attr) for k, (m, attr) in _COUNTS.items()}


def _set_wrapper_launches(counts: dict[str, int]) -> None:
    for k, (m, attr) in _COUNTS.items():
        setattr(m, attr, counts[k])


def kernel_launches() -> dict[str, int]:
    """Every launch of each hand-written kernel: by its wrapper (eager)
    plus by replays of the graphs that captured it."""
    return {k: n + REPLAYED_LAUNCHES[k] for k, n in wrapper_launches().items()}


def reset_kernel_launches() -> None:
    _set_wrapper_launches({k: 0 for k in _COUNTS})
    for k in REPLAYED_LAUNCHES:
        REPLAYED_LAUNCHES[k] = 0


class GraphPool:
    """One private memory pool and one capture stream on ``device``,
    shared by the graphs of one engine."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)

    def reserved_bytes(self) -> int:
        """Bytes of the device segments the pool holds (the graphs' memory
        beyond what was allocated before them)."""
        return sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(self.handle)
        )


class CapturedStep:
    """``fn`` captured once as a CUDA graph, replayed by :meth:`replay`.

    ``fn`` takes no arguments: it reads the static inputs it closes over
    and returns its outputs, which become the static outputs. It must
    leave every tensor it was given as it found it when run on the
    inputs present at construction (the engine captures with every slot
    inactive), because the warm-up runs it once for real."""

    def __init__(self, fn: Callable[[], Any], pool: GraphPool, *, name: str):
        global CAPTURE_CALLS
        self.name = name
        dev = pool.device
        side = pool.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()  # warm-up: real launches, counted by the wrappers
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = wrapper_launches()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool.handle, stream=side):
            self.outputs = fn()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        # the peak of the caching allocator during the capture, above what
        # was allocated before it: what the graph needs from its pool
        self.capture_peak_bytes = torch.cuda.max_memory_allocated(dev) - base
        # what the graph holds per replay; the wrappers launched nothing
        self.launches = {k: n - before[k] for k, n in wrapper_launches().items()}
        _set_wrapper_launches(before)
        self.replays = 0
        CAPTURE_CALLS += 1

    def replay(self) -> Any:
        self.graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            REPLAYED_LAUNCHES[k] += n
        return self.outputs
