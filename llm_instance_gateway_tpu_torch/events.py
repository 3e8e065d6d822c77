"""Flight recorder: a bounded structured event journal (the port's own copy
of the reference's ``events.py``).

The model server keeps one ``EventJournal``: a bounded ring of events
(admission rejections, drain, abandoned handoff KV released, prefix blocks
evicted) carrying trace ids, so an event row correlates with the request
timeline that produced it.  The ring holds ``LIG_EVENTS_CAPACITY``
(default 2048) events; per-kind counters are cumulative and exported as
``tpu:events_total{kind}``.  ``/debug/events?since=<seq>`` serves
incremental reads, ``?kind=`` filters.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from llm_instance_gateway_tpu_torch.tracing import render_counter

# Event kinds of the model server (the reference's namespace, which the
# gateway shares; tools/blackbox_report.py narrates them).
ADMISSION_REJECT = "admission_reject"   # 429/503/422 before admission
ROLE_CHANGE = "role_change"             # replica role/drain state change
KV_RELEASE = "kv_release"               # abandoned handoff KV released
KV_EVICT = "kv_evict"                   # cached prefix blocks evicted LRU


class EventJournal:
    """Bounded, thread-safe structured event ring with cumulative counters."""

    def __init__(self, capacity: int | None = None, clock=time.time):
        if capacity is None:
            capacity = int(os.environ.get("LIG_EVENTS_CAPACITY", "2048"))
        self.capacity = max(1, capacity)
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        # kind -> cumulative count (survives ring rotation).
        self.counts: dict[str, int] = {}

    def emit(self, kind: str, trace_id: str = "", **attrs) -> int:
        """Record one event; returns its sequence number."""
        event = {"seq": 0, "ts": round(self._clock(), 6), "kind": kind}
        if trace_id:
            event["trace_id"] = trace_id
        if attrs:
            event["attrs"] = attrs
        # Seq and append under one lock: emitters run on HTTP threads and
        # the engine thread, and an out-of-order append would make a
        # since-cursor poller skip the late event forever.
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self._ring.append(event)
        return event["seq"]

    @property
    def seq(self) -> int:
        return self._seq

    def events(self, since: int = 0, limit: int = 256,
               kind: str | None = None) -> list[dict]:
        """The oldest ``limit`` events with seq > ``since``, oldest first
        (a burst larger than ``limit`` is paged through, never skipped)."""
        rows = [e for e in list(self._ring) if e["seq"] > since
                and (kind is None or e["kind"] == kind)]
        return rows[:max(0, limit)]

    def render_prom(self, family: str) -> list[str]:
        """Cumulative per-kind counters as one Prometheus counter family
        (``family{kind="..."}``; an unlabeled 0 line when nothing was
        emitted)."""
        with self._lock:
            counts = dict(self.counts)
        return render_counter(family, counts, "kind")


def debug_events_payload(journal: EventJournal, query) -> dict:
    """The ``/debug/events`` body: ``?since=<seq>`` cursor, ``?kind=``
    filter, ``?limit=`` page size (1..2048, default 256).  Poll with
    ``since=next_since`` until ``next_since == seq``."""
    try:
        since = max(0, int(query.get("since", "0")))
    except ValueError:
        since = 0
    try:
        limit = max(1, min(int(query.get("limit", "256")), 2048))
    except ValueError:
        limit = 256
    kind = query.get("kind") or None
    rows = journal.events(since=since, limit=limit, kind=kind)
    return {"seq": journal.seq,
            "next_since": rows[-1]["seq"] if rows else journal.seq,
            "events": rows}
