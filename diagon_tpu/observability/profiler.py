"""Query profiler (reference ``util/QueryProfiler.h:16-50`` +
``SearchProfiler.h`` RAII ProfileScope).

Thread-local phase timers: name -> {total, count, min, max} nanoseconds.
Enabled explicitly (the reference gates on -DDIAGON_PROFILING; we gate at
runtime). Integrates with ``jax.profiler`` for device traces:
``QueryProfiler.trace(dir)`` wraps a block in a jax profiler session.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict


@dataclass
class PhaseStats:
    total_ns: int = 0
    count: int = 0
    min_ns: int = 2**63 - 1
    max_ns: int = 0

    def record(self, ns: int) -> None:
        self.total_ns += ns
        self.count += 1
        self.min_ns = min(self.min_ns, ns)
        self.max_ns = max(self.max_ns, ns)


class QueryProfiler:
    _tls = threading.local()

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases: Dict[str, PhaseStats] = {}
        self._starts: Dict[str, int] = {}

    @classmethod
    def current(cls) -> "QueryProfiler":
        p = getattr(cls._tls, "profiler", None)
        if p is None:
            p = QueryProfiler(enabled=False)
            cls._tls.profiler = p
        return p

    @classmethod
    def enable(cls) -> "QueryProfiler":
        p = QueryProfiler(enabled=True)
        cls._tls.profiler = p
        return p

    def begin_phase(self, name: str) -> None:
        if self.enabled:
            self._starts[name] = time.perf_counter_ns()

    def end_phase(self, name: str) -> None:
        if not self.enabled:
            return
        t0 = self._starts.pop(name, None)
        if t0 is None:
            return
        self.phases.setdefault(name, PhaseStats()).record(
            time.perf_counter_ns() - t0
        )

    def report(self) -> Dict[str, dict]:
        return {
            name: {
                "total_us": s.total_ns / 1e3,
                "count": s.count,
                "min_us": s.min_ns / 1e3 if s.count else 0,
                "max_us": s.max_ns / 1e3,
            }
            for name, s in self.phases.items()
        }

    @staticmethod
    @contextlib.contextmanager
    def trace(log_dir: str):
        """Device-level trace via jax.profiler (device timeline)."""
        import jax

        jax.profiler.start_trace(log_dir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()


class ProfileScope:
    """RAII phase scope (reference SearchProfiler.h ProfileScope)."""

    def __init__(self, name: str, profiler: QueryProfiler = None):
        self.name = name
        self.profiler = profiler or QueryProfiler.current()

    def __enter__(self):
        self.profiler.begin_phase(self.name)
        return self

    def __exit__(self, *exc):
        self.profiler.end_phase(self.name)
