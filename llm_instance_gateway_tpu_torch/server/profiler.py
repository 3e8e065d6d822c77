"""Engine step-timeline profiler (the port's own copy of the reference's
``server/profiler.py``).

Splits the engine thread's timeline into dispatch wall
(``tpu:dispatch_wall_seconds{phase}``), host-sync gaps between dispatches
while work was pending, and idle gaps that contained a wait for work
(``tpu:dispatch_gap_seconds{kind}``); ``attribution()`` gives the three
buckets' shares (summing to exactly 1.0) and ``snapshot()`` is the
``/debug/profile`` payload, with the newest per-dispatch records (wall,
gap, batch occupancy, step count, net slot churn) from a ring of
``LIG_PROFILE_CAPACITY`` (default 2048).

On the port a sync dispatch's wall ends at the one host sync per dispatch,
so it covers the device time of the fused block plus the eager Python
loop that enqueued it.  A pipelined block's wall runs from its dispatch
to its processing and overlaps the next block's, so its host-sync gaps
clamp to ~0: there "dispatch" is the engine thread's time from a block's
enqueue to its readback, not device time.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from llm_instance_gateway_tpu_torch.tracing import Histogram, render_histogram

DISPATCH_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                    5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 1.0)

GAP_HOST = "host"
GAP_IDLE = "idle"

# How many per-dispatch records /debug/profile ships.
SNAPSHOT_RECORDS = 256


class StepProfiler:
    """Per-dispatch timeline recorder for one engine: mutators run on the
    engine thread, ``snapshot()`` / ``hist_state()`` copy out under the
    lock."""

    def __init__(self, capacity: int | None = None, clock=time.perf_counter):
        if capacity is None:
            capacity = int(os.environ.get("LIG_PROFILE_CAPACITY", "2048"))
        self.capacity = max(1, capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._seq = 0
        self._last_end: float | None = None
        self._idle_pending = False
        # Prefill walls are time.time-stamped and cannot anchor the
        # perf_counter gap chain; they are subtracted from the next gap.
        self._foreign_wall = 0.0
        self._prev_active = 0
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

    def note_dispatch(self, phase: str, t0: float | None, wall_s: float,
                      active: int = 0, total_slots: int = 0,
                      n_steps: int = 1) -> None:
        """Record one dispatch; ``t0`` None = wall measured on another
        clock (prefill), excluded from the gap chain."""
        wall_s = max(0.0, wall_s)
        gap = 0.0
        gap_kind = ""
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
            else:
                if self._last_end is not None and t0 > self._last_end:
                    gap = max(0.0, t0 - self._last_end - self._foreign_wall)
                    gap_kind = GAP_IDLE if self._idle_pending else GAP_HOST
                    self.gap_seconds[gap_kind] += gap
                    self.gap_hist[gap_kind].observe(gap)
                self._foreign_wall = 0.0
                self._idle_pending = False
                self._last_end = t0 + wall_s
            self._seq += 1
            churn = active - self._prev_active
            self._prev_active = active
            self._ring.append((self._seq, phase, round(wall_s, 9),
                               round(gap, 9), gap_kind, active, total_slots,
                               n_steps, churn))

    def attribution(self) -> dict:
        """Seconds per bucket and shares of the tracked total; the largest
        share absorbs the rounding remainder, so the three sum to 1.0."""
        with self._lock:
            dispatch = sum(self.dispatch_seconds.values())
            host = self.gap_seconds[GAP_HOST]
            idle = self.gap_seconds[GAP_IDLE]
            by_phase = dict(self.dispatch_seconds)
            n = sum(self.dispatches.values())
        total = dispatch + host + idle
        if total > 0:
            shares = {"dispatch": round(dispatch / total, 6),
                      "host_sync": round(host / total, 6),
                      "idle": round(idle / total, 6)}
            largest = max(shares, key=lambda k: shares[k])
            shares[largest] = round(
                1.0 - sum(v for k, v in shares.items() if k != largest), 6)
        else:
            shares = {"dispatch": 0.0, "host_sync": 0.0, "idle": 0.0}
        return {
            "dispatches": n,
            "dispatch_seconds": round(dispatch, 6),
            "host_sync_seconds": round(host, 6),
            "idle_seconds": round(idle, 6),
            "tracked_seconds": round(total, 6),
            "dispatch_seconds_by_phase": {
                k: round(v, 6) for k, v in sorted(by_phase.items())},
            "shares": shares,
        }

    def hist_state(self) -> dict:
        """The copy-out ``Engine.metrics_snapshot()`` embeds."""
        with self._lock:
            return {
                "wall": {p: h.state()
                         for p, h in sorted(self.wall_hist.items())},
                "gap": {k: h.state()
                        for k, h in sorted(self.gap_hist.items())},
            }

    def snapshot(self) -> dict:
        """The ``/debug/profile`` payload: attribution, histogram states
        and the newest per-dispatch records."""
        with self._lock:
            records = list(self._ring)[-SNAPSHOT_RECORDS:]
            padding = self.padding_tokens
        return {
            "capacity": self.capacity,
            "seq": self._seq,
            "padding_tokens": padding,
            "attribution": self.attribution(),
            "hist": self.hist_state(),
            "records": [
                {"seq": seq, "phase": phase, "wall_s": wall, "gap_s": gap,
                 **({"gap_kind": kind} if kind else {}),
                 "active": active, "slots": slots, "n_steps": n_steps,
                 "slot_churn": churn}
                for (seq, phase, wall, gap, kind, active, slots, n_steps,
                     churn) in records],
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
