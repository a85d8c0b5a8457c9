"""Profiling / timing hooks.

Counterpart of the reference's ``lib/predictors/profiling_predictor.py``
(wall-clock per-step timing via Lightning hooks) plus the JAX-native
additions promised in SURVEY.md §5.1: ``jax.profiler`` trace capture and
edges/s / samples/s throughput counters. In JAX the forward+backward+
update are one fused program, so the reference's separate
``backward_time`` becomes the single fused step time.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import jax

from sgp.utils.logging import logger


class StepTimer:
    """Accumulates wall-clock stats per named phase.

    Usage::

        timer = StepTimer()
        with timer.time("train_step"):
            params, opt_state, loss = step(...)
        timer.summary()  # {'train_step': {'mean_s': ..., 'count': ...}}
    """

    def __init__(self):
        self._times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync: bool = False, result=None):
        t0 = time.perf_counter()
        yield
        if sync and result is not None:
            jax.block_until_ready(result)
        self._times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._times.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._times.items():
            out[name] = {"mean_s": sum(vals) / len(vals),
                         "total_s": sum(vals), "count": len(vals)}
        return out

    def log_summary(self):
        for name, s in self.summary().items():
            logger.info(f"{name}: {s['mean_s']*1e3:.2f} ms/call "
                        f"x {s['count']}")


class Throughput:
    """Edges/s / samples/s counters (the kernel-level numbers the
    reference never published, BASELINE.md 'Gaps')."""

    def __init__(self):
        self._start: Optional[float] = None
        self._units = 0.0

    def start(self):
        self._start = time.perf_counter()
        self._units = 0.0

    def add(self, units: float):
        self._units += units

    def rate(self) -> float:
        if self._start is None:
            return 0.0
        return self._units / max(time.perf_counter() - self._start, 1e-12)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> float:
    """Mean wall-clock seconds per call of a jitted fn (blocks on the
    final output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``jax.profiler`` device trace viewable in TensorBoard /
    Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
