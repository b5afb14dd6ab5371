"""Flight recorder: spans over the host's monotonic clock.

The part of the JAX reference's ``repro.runtime.telemetry`` that the
in-process executors use: a :class:`Tracer` records one span per executed
task (``LocalExecutor``) or per batched group call (``WaveExecutor``), tagged
with its node and a per-thread lane.  On a CUDA device a span times the
host-side enqueue of the task's kernels, not their run on the card: the
executors do not synchronise per task.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer"]


# -- spans --------------------------------------------------------------------
class Span:
    """One timed region: ``[t0, t0 + dur)`` on ``node``/``lane``.

    ``cat`` is the span's category (EXEC here), the join key for every
    consumer; ``name`` is the display label; ``args`` carries the
    category-specific payload (task id, wave, group size).  Timestamps
    are seconds on the process's monotonic clock.
    """

    __slots__ = ("name", "cat", "node", "lane", "t0", "dur", "args")

    def __init__(self, name: str, cat: str, node: int, lane: int,
                 t0: float, dur: float, args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.node = node
        self.lane = lane
        self.t0 = t0
        self.dur = dur
        self.args = args or {}

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"Span({self.cat} {self.name!r} node={self.node} "
                f"lane={self.lane} t0={self.t0:.6f} dur={self.dur:.6f})")


class _SpanCtx:
    """Context manager recording one span on ``__exit__`` (kept as a
    tiny slotted class instead of ``contextlib`` to stay off the hot
    path's allocation budget)."""

    __slots__ = ("tr", "name", "cat", "args", "t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self.tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = self.tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tr
        t1 = tr.clock()
        sp = Span(self.name, self.cat, tr.node, tr.lane(),
                  self.t0, t1 - self.t0, self.args)
        with tr._lock:
            tr._spans.append(sp)
        return False


class Tracer:
    """Per-process span buffer over a monotonic clock.

    Thread-safe: worker pool threads record concurrently; ``drain``
    hands the buffered spans to the executor's ``spans``.  Every span is
    on node 0: the executors run in one process.
    """

    def __init__(self):
        self.node = 0
        self.clock = time.perf_counter
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._lanes: Dict[int, int] = {}

    # -- recording ----------------------------------------------------------
    def lane(self) -> int:
        """Small stable lane id for the calling thread (worker slot)."""
        ident = threading.get_ident()
        lane = self._lanes.get(ident)
        if lane is None:
            with self._lock:
                lane = self._lanes.setdefault(ident, len(self._lanes))
        return lane

    def span(self, name: str, cat: Optional[str] = None, **args):
        """``with tracer.span("EXEC", tid=7): ...`` — records on exit."""
        return _SpanCtx(self, name, cat or name, args)

    # -- transport ----------------------------------------------------------
    def drain(self) -> List[Span]:
        """Take and clear the buffered spans."""
        if not self._spans:
            return []
        with self._lock:
            out, self._spans = self._spans, []
        return out

