"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, reduced to kernel intervals on the host clock.

Only device activity is traced (kernels, copies, fills): tracing the host's
operators costs tens of seconds of processing per eager step.  The slice is
the window's last ``TRACE_S`` seconds (the whole window where it is
shorter): a replayed decode step launches thousands of kernels, a whole
window's trace would take minutes to read, and stopping the profiler
holds the process for seconds, which at the window's end disturbs no
step inside it.  The raw kineto events are
read directly (no ``key_averages``); their timestamps are nanoseconds on
the host's wall clock, the clock the requests are stamped on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

TRACE_S = 4.0
TOP = 10


@dataclass
class Trace:
    a: float                      # slice start, host seconds
    b: float                      # slice end
    kernels: list = field(default_factory=list)  # (name, start_s, dur_s)
    read_s: float = 0.0

    @property
    def window_s(self) -> float:
        return self.b - self.a

    def busy_s(self) -> float:
        """Seconds of the slice in which some device operation ran (the
        union of the intervals)."""
        busy, end = 0.0, self.a
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            s0, s1 = max(s, end), min(s + d, self.b)
            if s1 > s0:
                busy += s1 - s0
                end = s1
        return busy

    def device_seconds(self, match) -> float:
        """Device seconds, clipped to the slice, of the operations whose
        name ``match(name)`` accepts."""
        return sum(max(0.0, min(s + d, self.b) - max(s, self.a))
                   for n, s, d in self.kernels if match(n))

    def breakdown(self) -> dict:
        """The operations that took most device time, and the longest
        idle gaps, each named by the operation that ran before it."""
        by_name: dict = {}
        for n, s, d in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, end, prev = [], self.a, "slice start"
        for n, s, d in sorted(self.kernels, key=lambda k: k[1]):
            if s > end:
                gaps.append((f"after {short(prev)}", s - end))
            if s + d > end:
                end, prev = s + d, n
        if self.b > end:
            gaps.append((f"after {short(prev)}", self.b - end))
        gaps = sorted(gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[short(n), v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def _events(prof) -> list:
    """(name, start_s, dur_s) of every device event in the profile."""
    import torch
    out = []
    results = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    for e in results.events():
        if e.device_type() != cuda:
            continue
        out.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
    return out


def init() -> None:
    """Start and stop the profiler once, so the window's start does not
    pay the tracer's first initialisation; call it on the thread that
    will record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()


class Recorder:
    """The device traced from host time ``a`` until ``stop()``; create,
    stop and read it on the thread that called ``init``.  Without a device
    (a CPU rehearsal) the trace is empty and the device metrics read
    nothing."""

    def __init__(self, a: float):
        import torch
        from torch.profiler import ProfilerActivity, profile
        time.sleep(max(0.0, a - time.time()))
        self.prof = None
        if torch.cuda.is_available():
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        self.trace = Trace(time.time(), 0.0)

    def stop(self) -> None:
        self.trace.b = time.time()
        if self.prof is not None:
            self.prof.stop()

    def read(self) -> Trace:
        if self.prof is not None:
            t0 = time.time()
            self.trace.kernels = _events(self.prof)
            self.trace.read_s = time.time() - t0
            self.prof = None
        return self.trace
