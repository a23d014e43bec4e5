"""Profiling instrumentation.

The reference has no tracing (performance was measured with notebook
%%time cells — SURVEY.md section 5.1); here a thin harness exposes:

* ``trace(logdir)`` — context manager around ``jax.profiler`` for
  device traces viewable in TensorBoard/Perfetto.
* ``timed(label)`` — lightweight wall-clock section timer.
"""

from __future__ import annotations

import contextlib
import time as _time

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/triceratops_tpu_trace"):
    """jax.profiler trace around a block of device work."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str = "section", printer=print):
    t0 = _time.perf_counter()
    yield
    printer(f"[{label}] {_time.perf_counter() - t0:.3f}s")
