"""Profiling helpers: phase timers and JAX profiler traces.

The reference's only profiling story is `time` + debug prints
(README.md:25,31); here we provide structured phase timing plus optional
JAX profiler traces for per-kernel roofline analysis."""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"  {k:<24s} {v:8.3f}s ({100*v/max(total,1e-9):5.1f}%)"
                 for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1])]
        lines.append(f"  {'total':<24s} {total:8.3f}s")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.phases)


@contextlib.contextmanager
def jax_trace(dirname: Optional[str]):
    """Capture a jax profiler trace (view with tensorboard / xprof)."""
    if not dirname:
        yield
        return
    import jax

    jax.profiler.start_trace(dirname)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
