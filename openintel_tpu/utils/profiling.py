"""Profiling and tracing.

The reference ships no tracing at all — its diagnostics are stderr warnings
plus a machine-readable ``notes`` channel threaded through reports
(reference: src/domain/engine/speculation_engine.rs:45,
src/application/analyze.rs:23-45; SURVEY.md §5). The rebuild keeps the notes
channel (see domain/engine.py) and adds what a device framework needs:

- :func:`profile_trace` — capture a ``jax.profiler`` trace (TensorBoard /
  Perfetto readable) around a code block;
- :func:`trace_annotation` — name a region so device ops group under it in
  the trace viewer;
- :class:`DeviceTimer` — wall-clock device timing with a real host sync per
  sample: the timer forces a device->host transfer of one scalar, a fence
  that holds on every backend.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace for the enclosed block into ``log_dir``."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Annotate the enclosed block in profiler traces (no-op overhead-wise)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def _sync(out) -> None:
    """Force completion: pull one scalar of the output tree to the host."""
    import jax

    leaves = jax.tree_util.tree_leaves(out)
    if leaves:
        np.asarray(jax.numpy.ravel(leaves[0])[0])


@dataclass
class DeviceTimer:
    """Best-of-N wall timing for device callables with forced host syncs.

    >>> t = DeviceTimer()
    >>> ms = t.timeit(lambda: jitted_fn(x))  # warmup + reps, returns best ms
    """

    reps: int = 5
    warmup: int = 1
    samples_ms: list[float] = field(default_factory=list)

    def timeit(self, fn: Callable[[], object]) -> float:
        for _ in range(self.warmup):
            _sync(fn())
        self.samples_ms.clear()
        for _ in range(self.reps):
            t0 = time.perf_counter()
            _sync(fn())
            self.samples_ms.append((time.perf_counter() - t0) * 1e3)
        return min(self.samples_ms)

    @property
    def best_ms(self) -> float:
        return min(self.samples_ms) if self.samples_ms else float("nan")

    @property
    def median_ms(self) -> float:
        return float(np.median(self.samples_ms)) if self.samples_ms else float("nan")
