"""Tracing / profiling utilities.

The reference's only observability is a mutex-serialized tile-progress
callback (ref: include/PathTrace/worker.h:74-79, src/worker.cpp:354-360) and
external google-benchmark counters. The equivalents here:

  * `trace_annotation` / `profile_to` — `jax.profiler` integration: XLA
    device traces viewable in TensorBoard/XProf.
  * `RayCounter` — per-phase ray/sample throughput accounting, the analog of
    benchmark::SetItemsProcessed (ref: benchmark/main.cpp:30).
  * `progress_printer` — a console progress bar callback compatible with
    `render(progress_callback=...)` (ref: demo/main.cpp:211-226).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import jax


@contextlib.contextmanager
def trace_annotation(name: str):
    """Annotate a host-side region in the device trace."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a jax.profiler device trace for the enclosed region."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class RayCounter:
    """Accumulates primary-sample counts and wall time per phase."""

    samples: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, samples: int):
        if self._t0 is None:
            raise RuntimeError("RayCounter.stop without start")
        self.seconds += time.perf_counter() - self._t0
        self.samples += samples
        self._t0 = None
        return self

    @property
    def mrays_per_s(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds > 0 else 0.0

    def report(self, name: str = "render") -> str:
        return (
            f"{name}: {self.samples} samples in {self.seconds:.2f}s "
            f"({self.mrays_per_s:.2f} Mrays/s)"
        )


def progress_printer(stream=sys.stderr, width: int = 50):
    """Returns a `(done, total) -> None` console progress bar callback."""

    def cb(done, total):
        frac = done / max(total, 1)
        bar = "#" * int(frac * width)
        print(f"\r[{bar:<{width}}] {done}/{total}", end="", file=stream, flush=True)
        if done >= total:
            print(file=stream)

    return cb
