"""Engine step-timeline profiler (the port's own copy of the reference's
``server/profiler.py``).

Splits the engine thread's timeline into dispatch wall
(``tpu:dispatch_wall_seconds{phase}``), host-sync gaps between dispatches
while work was pending, and idle gaps that contained a wait for work
(``tpu:dispatch_gap_seconds{kind}``).  On the port a dispatch wall ends
at the one host sync per dispatch, so it covers the device time of the
fused block plus the eager Python loop that enqueued it.
"""

from __future__ import annotations

import threading
import time

from llm_instance_gateway_tpu_torch.tracing import Histogram, render_histogram

DISPATCH_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                    5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 1.0)

GAP_HOST = "host"
GAP_IDLE = "idle"


class StepProfiler:
    """Per-dispatch timeline recorder for one engine: mutators run on the
    engine thread, ``hist_state()`` copies out under the lock."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._last_end: float | None = None
        self._idle_pending = False
        # Prefill walls are time.time-stamped and cannot anchor the
        # perf_counter gap chain; they are subtracted from the next gap.
        self._foreign_wall = 0.0
        self.dispatch_seconds: dict[str, float] = {}
        self.dispatches: dict[str, int] = {}
        self.gap_seconds: dict[str, float] = {GAP_HOST: 0.0, GAP_IDLE: 0.0}
        self.padding_tokens = 0
        self.wall_hist: dict[str, Histogram] = {}
        self.gap_hist: dict[str, Histogram] = {
            GAP_HOST: Histogram(DISPATCH_BUCKETS),
            GAP_IDLE: Histogram(DISPATCH_BUCKETS),
        }

    def note_idle(self) -> None:
        self._idle_pending = True

    def note_padding(self, pad_tokens: int) -> None:
        if pad_tokens > 0:
            with self._lock:
                self.padding_tokens += pad_tokens

    def note_dispatch(self, phase: str, t0: float | None,
                      wall_s: float) -> None:
        """Record one dispatch; ``t0`` None = wall measured on another
        clock (prefill), excluded from the gap chain."""
        wall_s = max(0.0, wall_s)
        with self._lock:
            self.dispatch_seconds[phase] = (
                self.dispatch_seconds.get(phase, 0.0) + wall_s)
            self.dispatches[phase] = self.dispatches.get(phase, 0) + 1
            hist = self.wall_hist.get(phase)
            if hist is None:
                hist = self.wall_hist[phase] = Histogram(DISPATCH_BUCKETS)
            hist.observe(wall_s)
            if t0 is None:
                self._foreign_wall += wall_s
                return
            if self._last_end is not None and t0 > self._last_end:
                gap = max(0.0, t0 - self._last_end - self._foreign_wall)
                kind = GAP_IDLE if self._idle_pending else GAP_HOST
                self.gap_seconds[kind] += gap
                self.gap_hist[kind].observe(gap)
            self._foreign_wall = 0.0
            self._idle_pending = False
            self._last_end = t0 + wall_s

    def hist_state(self) -> dict:
        """The copy-out ``Engine.metrics_snapshot()`` embeds."""
        with self._lock:
            return {
                "wall": {p: h.state()
                         for p, h in sorted(self.wall_hist.items())},
                "gap": {k: h.state()
                        for k, h in sorted(self.gap_hist.items())},
            }


def render_profile(hist: dict) -> list[str]:
    """Exposition lines for one ``StepProfiler.hist_state()`` payload."""
    lines: list[str] = []
    first = True
    for phase, state in (hist.get("wall") or {}).items():
        lines += render_histogram("tpu:dispatch_wall_seconds", state,
                                  {"phase": phase}, type_line=first)
        first = False
    first = True
    for kind, state in (hist.get("gap") or {}).items():
        lines += render_histogram("tpu:dispatch_gap_seconds", state,
                                  {"kind": kind}, type_line=first)
        first = False
    return lines
