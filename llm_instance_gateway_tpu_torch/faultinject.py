"""Deterministic fault injection for the model server (port of the server
half of ``gateway/faultinject.py``).

The fleet's chaos stack arms the real server binary through the
``LIG_FAULTS`` env var, which names a JSON schedule; the server reads and
arms it once at start (``server/api_http.make_handler``) and consults it
before routing every ``/v1/*`` request.  Schedules are plain data —
``{"seed": 0, "faults": [{"kind", "pod", "start_s", "duration_s",
"params"}]}`` — and ``arm()`` pins the schedule's t0, so a given schedule
replays identically.

Fault kinds (``FaultSpec.kind``) and what a server does under each:

====================  ====================================================
``blackhole``         sleep ``min(30, remaining + 1)`` s, then answer 503
``brownout``          sleep ``delay_s`` (default 1), then serve
``error``             answer ``status`` (default 500) at once
``handoff_failure``   ``/v1/prefill`` / ``/v1/attach`` answer ``status``,
                      or with ``mode: disconnect`` close the socket
``midstream_disconnect``  close the connection ``after_s`` (default 0.2)
                      into the request while the handler runs
``scrape_flap``       the gateway's scrape plane only (its
                      ``ChaosProvider``); a server never applies it
====================  ====================================================

Each kind scopes itself to paths (``params["paths"]``, by default the two
completion routes, or the two hop routes for ``handoff_failure``); paths
outside ``/v1/`` are never touched.  Every applied fault is journaled as a
``fault_inject`` event with the reference's fields.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from dataclasses import dataclass, field

BLACKHOLE = "blackhole"
BROWNOUT = "brownout"
ERROR = "error"
MIDSTREAM_DISCONNECT = "midstream_disconnect"
SCRAPE_FLAP = "scrape_flap"
HANDOFF_FAILURE = "handoff_failure"
FAULT_KINDS = (BLACKHOLE, BROWNOUT, ERROR, MIDSTREAM_DISCONNECT,
               SCRAPE_FLAP, HANDOFF_FAILURE)

# Default path scope per kind (overridable via params["paths"]).
_COMPLETION_PATHS = ("/v1/completions", "/v1/chat/completions")
_KIND_PATHS = {
    HANDOFF_FAILURE: ("/v1/prefill", "/v1/attach"),
}
# How long a blackholed request hangs before giving up with a 503: long
# enough that every sane TTFT timeout fires first, short enough that a
# harness teardown never waits minutes on stragglers.
_BLACKHOLE_HANG_S = 30.0


@dataclass(frozen=True)
class FaultSpec:
    """One fault window.  ``pod=""`` matches every pod; times are seconds
    relative to ``FaultSchedule.arm()``."""

    kind: str
    pod: str = ""
    start_s: float = 0.0
    duration_s: float = 1e9
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")

    def paths(self) -> tuple:
        return tuple(self.params.get(
            "paths", _KIND_PATHS.get(self.kind, _COMPLETION_PATHS)))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "pod": self.pod, "start_s": self.start_s,
                "duration_s": self.duration_s, "params": dict(self.params)}


class FaultSchedule:
    """A set of fault windows on one clock.  ``arm()`` pins t0 (idempotent:
    the first arm wins, so the server and a harness share one origin)."""

    def __init__(self, faults: list[FaultSpec], seed: int = 0,
                 clock=time.time):
        self.faults = list(faults)
        self.seed = seed
        self._clock = clock
        self._t0: float | None = None

    @classmethod
    def from_dict(cls, d: dict, clock=time.time) -> "FaultSchedule":
        faults = [FaultSpec(kind=f["kind"], pod=f.get("pod", ""),
                            start_s=float(f.get("start_s", 0.0)),
                            duration_s=float(f.get("duration_s", 1e9)),
                            params=dict(f.get("params", {})))
                  for f in d.get("faults", [])]
        return cls(faults, seed=int(d.get("seed", 0)), clock=clock)

    @classmethod
    def from_file(cls, path: str) -> "FaultSchedule":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "faults": [f.to_dict() for f in self.faults]}

    def arm(self, now: float | None = None) -> None:
        if self._t0 is None:
            self._t0 = self._clock() if now is None else now

    def elapsed(self, now: float | None = None) -> float:
        if self._t0 is None:
            self.arm(now)
        return (self._clock() if now is None else now) - self._t0

    def active(self, pod: str = "", path: str | None = None,
               kind: str | None = None,
               now: float | None = None) -> FaultSpec | None:
        """The first fault window covering (pod, path, kind) right now."""
        t = self.elapsed(now)
        for f in self.faults:
            if kind is not None and f.kind != kind:
                continue
            if f.pod and pod and f.pod != pod:
                continue
            if path is not None and path not in f.paths():
                continue
            if f.start_s <= t < f.start_s + f.duration_s:
                return f
        return None

    def inject_now(self, kind: str, pod: str = "", duration_s: float = 1e9,
                   **params) -> FaultSpec:
        """Append a fault window opening at the current schedule time."""
        spec = FaultSpec(kind, pod=pod, start_s=self.elapsed(),
                         duration_s=duration_s, params=params)
        self.faults.append(spec)
        return spec

    def remaining(self, spec: FaultSpec, now: float | None = None) -> float:
        return max(0.0, spec.start_s + spec.duration_s - self.elapsed(now))

    def describe(self) -> str:
        return "; ".join(
            f"{f.kind}(pod={f.pod or '*'}, t=[{f.start_s:g},"
            f"{f.start_s + min(f.duration_s, 9e8):g}))"
            for f in self.faults) or "empty"


class Injected(Exception):
    """A fault that answers instead of the handler: ``status`` and
    ``text``, or (``status`` None) a connection closed with no answer."""

    def __init__(self, status: int | None, text: str = ""):
        super().__init__(text or "injected disconnect")
        self.status = status
        self.text = text


def cut(sock) -> None:
    """Close a client's connection under its handler: both directions shut
    down, so the client reads end of file and the handler's next write
    fails (the handler runs on, as the reference's middleware lets it)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def apply(schedule: FaultSchedule, path: str, sock, journal=None,
          sleep=time.sleep) -> None:
    """Apply the schedule's fault for one request on a ``ThreadingHTTPServer``
    handler thread, before routing: return to serve the request (no
    fault, a brownout after its delay, a mid-stream disconnect armed on
    ``sock``), or raise ``Injected`` for the handler to answer with.  The
    reference's ``aiohttp_middleware`` and ``_apply_http_fault``, journal
    rows included."""
    if not path.startswith("/v1/"):
        return
    spec = schedule.active(path=path)
    if spec is None:
        return
    if spec.kind == MIDSTREAM_DISCONNECT:
        timer = threading.Timer(float(spec.params.get("after_s", 0.2)),
                                cut, (sock,))
        timer.daemon = True
        timer.start()
        if journal is not None:
            journal.emit("fault_inject", fault=spec.kind, path=path)
        return
    if journal is not None:
        journal.emit("fault_inject", fault=spec.kind, path=path,
                     pod=spec.pod)
    if spec.kind == BLACKHOLE:
        sleep(min(_BLACKHOLE_HANG_S, schedule.remaining(spec) + 1.0))
        raise Injected(503, "blackhole fault elapsed")
    if spec.kind == BROWNOUT:
        sleep(float(spec.params.get("delay_s", 1.0)))
        return
    if spec.kind == ERROR:
        raise Injected(int(spec.params.get("status", 500)), "injected fault")
    if spec.kind == HANDOFF_FAILURE:
        if spec.params.get("mode", "error") == "disconnect":
            raise Injected(None)
        raise Injected(int(spec.params.get("status", 500)),
                       "injected handoff fault")
