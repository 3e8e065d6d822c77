"""Request tracing and the shared histogram exposition (the port's own copy
of the reference's ``tracing.py``).

- **Trace propagation**: every inference request adopts the
  ``x-lig-trace-id`` header (or mints an id) and echoes it on every
  response, error bodies included, so the gateway stitches one timeline
  across the proxy, the prefill hop and the decode hop.
- **Span recorder** (``Tracer``): named wall-clock spans (epoch seconds,
  ``time.time()``, so processes on one host line up) in a bounded ring,
  served by ``/debug/traces``; the server also returns a request's spans in
  the compact ``x-lig-spans`` header for the gateway to merge.
- **Histogram + exposition helpers**: the fixed-bucket ``Histogram`` and
  the Prometheus lines of the reference, so the families a torch pod
  exports parse exactly like a JAX pod's.

Sampling is deterministic on the trace id (``LIG_TRACE_SAMPLE``; one
blake2b over the id), so a trace is recorded by every process on its path
or by none.  ``LIG_TRACE=0`` turns recording off, ``LIG_TRACE_CAPACITY``
bounds the ring (in traces).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import random

# Header names (lowercase; transports look them up case-insensitively).
TRACE_HEADER = "x-lig-trace-id"
SPANS_HEADER = "x-lig-spans"

# Second-scale phase latencies (TTFT, prefill, e2e).
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
PICK_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                0.05, 0.1, 0.25, 0.5, 1.0)

# Ids need uniqueness, not cryptographic strength: a urandom-seeded PRNG
# mints one in ~1 µs; children of a fork reseed so they never replay the
# parent's sequence.
_rng = random.Random(int.from_bytes(os.urandom(8), "big"))


def _reseed() -> None:
    global _rng
    _rng = random.Random(int.from_bytes(os.urandom(8), "big") ^ os.getpid())


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed)


def new_trace_id() -> str:
    return f"{_rng.getrandbits(64):016x}"


def header_trace_id(headers) -> str | None:
    """Case-insensitive ``x-lig-trace-id`` lookup over any mapping."""
    get = getattr(headers, "get", None)
    if get is not None:
        v = get(TRACE_HEADER) or get(TRACE_HEADER.title())
        if v:
            return str(v)
    for k in headers:
        if str(k).lower() == TRACE_HEADER:
            return str(headers[k])
    return None


def escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


class Histogram:
    """Fixed-bucket latency histogram; ``state()`` is the export form."""

    __slots__ = ("buckets", "counts", "total", "n")

    def __init__(self, buckets: tuple[float, ...] = PICK_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.total += v
        self.n += 1

    def state(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.total, "count": self.n}


def _fmt(v: float) -> str:
    return format(v, "g")


def render_counter(name: str, table: dict, label: str) -> list[str]:
    """One labeled counter family: ``# TYPE`` line, a ``None`` key (or an
    empty table) as the unlabeled line, the other keys sorted and
    escaped."""
    lines = [f"# TYPE {name} counter"]
    if not table:
        lines.append(f"{name} 0")
    for key in sorted(table, key=lambda k: (k is not None, k or "")):
        if key is None:
            lines.append(f"{name} {table[key]}")
        else:
            lines.append(
                f'{name}{{{label}="{escape_label(key)}"}} {table[key]}')
    return lines


def render_histogram(name: str, hist, labels: dict[str, str] | None = None,
                     type_line: bool = True) -> list[str]:
    """Prometheus histogram exposition lines for one series (``hist`` is a
    ``Histogram`` or its ``state()`` dict; labels are escaped here)."""
    if isinstance(hist, Histogram):
        hist = hist.state()
    base = "".join(
        f'{k}="{escape_label(v)}",' for k, v in (labels or {}).items())
    plain = "{" + base.rstrip(",") + "}" if base else ""
    lines = [f"# TYPE {name} histogram"] if type_line else []
    cum = 0
    for b, c in zip(hist["buckets"], hist["counts"]):
        cum += c
        lines.append(f'{name}_bucket{{{base}le="{_fmt(b)}"}} {cum}')
    cum += hist["counts"][len(hist["buckets"])]
    lines.append(f'{name}_bucket{{{base}le="+Inf"}} {cum}')
    lines.append(f"{name}_sum{plain} {hist['sum']}")
    lines.append(f"{name}_count{plain} {hist['count']}")
    return lines


# ---------------------------------------------------------------------------
# Span recorder
# ---------------------------------------------------------------------------


def wire_spans(spans) -> str:
    """Compact JSON for the ``x-lig-spans`` response header:
    ``[[name, start, end], ...]`` (epoch seconds, µs precision)."""
    return json.dumps(
        [[n, round(float(s), 6), round(float(e), 6)] for n, s, e in spans],
        separators=(",", ":"))


# Marker in the flat ring: record[2] is a span name, or this sentinel for
# (model, path, status) trace metadata.
_META = None


class Tracer:
    """Bounded per-process trace recorder.

    Recording is one ``deque.append`` of a tuple onto a flat ring of
    ``capacity * 16`` records (old traces age out); grouping into per-trace
    JSON happens at export.  Every record carries a sequence number, so
    ``/debug/traces?since=<seq>`` serves incremental reads.
    """

    def __init__(self, capacity: int | None = None,
                 sample: float | None = None, enabled: bool | None = None):
        if capacity is None:
            capacity = int(os.environ.get("LIG_TRACE_CAPACITY", "256"))
        if sample is None:
            sample = float(os.environ.get("LIG_TRACE_SAMPLE", "1.0"))
        if enabled is None:
            enabled = os.environ.get("LIG_TRACE", "1") not in ("0", "false")
        self.capacity = max(1, capacity)
        self.sample = sample
        self.enabled = enabled
        self._seq = 0
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity * 16)

    @property
    def seq(self) -> int:
        """Head sequence number (the newest record's)."""
        return self._seq

    def sampled(self, trace_id: str) -> bool:
        if not self.enabled:
            return False
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = hashlib.blake2b(trace_id.encode(), digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64 < self.sample

    def record(self, trace_id: str, name: str, start: float, end: float,
               **attrs) -> None:
        if not trace_id or not self.sampled(trace_id):
            return
        self._seq = seq = self._seq + 1
        self._ring.append(
            (seq, trace_id, name, float(start), float(end), attrs or None))

    def annotate(self, trace_id: str, model: str | None = None,
                 path: str | None = None, status: str | None = None) -> None:
        if not trace_id or not self.sampled(trace_id):
            return
        self._seq = seq = self._seq + 1
        self._ring.append((seq, trace_id, _META, model, path, status))

    # -- export (the /debug/traces JSON shape) ------------------------------

    def _collect(self, since: int = 0) -> "collections.OrderedDict[str, dict]":
        """Group the ring into trace dicts ordered by last activity,
        skipping records with seq <= ``since``."""
        traces: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        for rec in list(self._ring):  # snapshot: appends may race the walk
            seq, tid = rec[0], rec[1]
            if seq <= since:
                continue
            t = traces.get(tid)
            if t is None:
                t = traces[tid] = {"trace_id": tid, "model": "", "path": "",
                                   "status": "", "seq": seq, "_min_seq": seq,
                                   "spans": []}
            else:
                traces.move_to_end(tid)
            t["seq"] = max(t["seq"], seq)
            t["_min_seq"] = min(t["_min_seq"], seq)
            if rec[2] is _META:
                _, _, _, model, path, status = rec
                if model is not None:
                    t["model"] = model
                if path is not None:
                    t["path"] = path
                if status is not None:
                    t["status"] = str(status)
            else:
                _, _, name, s, e, attrs = rec
                t["spans"].append(
                    {"name": name, "start": round(s, 6), "end": round(e, 6),
                     **({"attrs": attrs} if attrs else {})})
        return traces

    @staticmethod
    def _export(t: dict) -> dict:
        spans = sorted(t["spans"], key=lambda x: (x["start"], x["end"]))
        t_created = spans[0]["start"] if spans else 0.0
        t = {k: v for k, v in t.items() if k != "_min_seq"}
        return {**t, "t_created": t_created, "spans": spans}

    def get(self, trace_id: str) -> dict | None:
        t = self._collect().get(trace_id)
        return self._export(t) if t is not None else None

    def recent(self, limit: int = 64) -> list[dict]:
        """Most-recently-active-first trace dicts."""
        traces = self._collect()
        out = [self._export(t) for t in
               list(traces.values())[-max(0, limit):]]
        out.reverse()
        return out

    def since(self, since: int, limit: int = 1024) -> tuple[list[dict], int]:
        """(partial traces holding only records with seq > ``since``,
        next cursor).  The page is the ``limit`` traces whose oldest new
        record is earliest; on truncation the cursor retreats to just
        before the first excluded trace's oldest record, so a poller may
        see a record twice but never skips one."""
        traces = sorted(self._collect(since).values(),
                        key=lambda t: t["_min_seq"])
        limit = max(0, limit)
        page, excluded = traces[:limit], traces[limit:]
        if excluded:
            next_since = min(t["_min_seq"] for t in excluded) - 1
        else:
            next_since = max((t["seq"] for t in page), default=self._seq)
        return [self._export(t) for t in page], next_since


def debug_traces_payload(tracer: Tracer, query) -> dict:
    """The ``/debug/traces`` body: ``?trace_id=`` exact filter, ``?limit=``
    (1..1024, default 64), and the incremental cursor ``?since=<seq>``
    (poll with ``since=next_since`` until ``next_since == seq``)."""
    trace_id = query.get("trace_id")
    if trace_id:
        t = tracer.get(trace_id)
        return {"traces": [t] if t else [], "seq": tracer.seq}
    try:
        limit = max(1, min(int(query.get("limit", "64")), 1024))
    except ValueError:
        limit = 64
    raw_since = query.get("since")
    if raw_since is not None:
        try:
            since = max(0, int(raw_since))
        except ValueError:
            since = 0
        rows, next_since = tracer.since(since, limit)
        return {"traces": rows, "seq": tracer.seq,
                "next_since": next_since}
    return {"traces": tracer.recent(limit), "seq": tracer.seq}
