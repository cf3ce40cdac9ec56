"""Lightweight timing/observability harness.

The reference has no tracing beyond ad-hoc `Instant` prints in examples
(SURVEY.md §5). This provides: a timer whose spans end at
`jax.block_until_ready`, a bootstraps/sec counter, and a jax.profiler trace
context.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax
import numpy as np


def force(x) -> None:
    """Wait until every array in the pytree x has been computed."""
    jax.block_until_ready(x)


@dataclass
class Timer:
    """Accumulates named wall-clock spans with device synchronization."""

    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            force(sync_on)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.spans.items():
            lines.append(
                f"{name}: n={len(ts)} total={sum(ts):.3f}s "
                f"mean={np.mean(ts) * 1e3:.1f}ms min={min(ts) * 1e3:.1f}ms"
            )
        return "\n".join(lines)


def gate_throughput(gate_fn, a, b, ck, iters: int = 3) -> float:
    """Bootstrapped gates/sec: chained iterations (output feeds back as
    input), one barrier at the end."""
    out = gate_fn(a, b, ck)
    force(out)
    t0 = time.perf_counter()
    cur = a
    for _ in range(iters):
        cur = gate_fn(cur, b, ck)
    force(cur)
    per_iter = (time.perf_counter() - t0) / iters
    return a.shape[0] / per_iter


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace of the enclosed block into logdir (view with
    TensorBoard or Perfetto). Profiler errors propagate."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
