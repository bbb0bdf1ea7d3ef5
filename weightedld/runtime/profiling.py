"""Tracing & per-stage timing.

The reference's observability is wall-clock spans per stage plus a final
pairs/s line (``main.rs:128-210``).  Here: a `StageTimer` collecting named
spans (logged and queryable), plus an optional ``jax.profiler`` trace
context producing TensorBoard-loadable device profiles.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger("weightedld")


@dataclass
class StageTimer:
    spans: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            log.info("stage %-20s %8.3fs", name, dt)

    def report(self) -> str:
        total = sum(self.spans.values())
        denom = total or 1.0  # all-zero spans (coarse clocks) must not crash
        lines = [f"{k:<20} {v:8.3f}s ({v / denom:5.1%})"
                 for k, v in self.spans.items()]
        lines.append(f"{'total':<20} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """jax.profiler trace wrapper (no-op when log_dir is None)."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
