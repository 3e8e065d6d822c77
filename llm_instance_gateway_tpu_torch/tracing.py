"""Histogram + Prometheus exposition helpers (the port's own copy).

The same fixed-bucket ``Histogram`` and exposition lines as the
reference's ``tracing.py``, so the families a torch pod exports parse
exactly like a JAX pod's.  The span recorder is not ported yet.
"""

from __future__ import annotations

# Second-scale phase latencies (TTFT, prefill, e2e).
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
PICK_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                0.05, 0.1, 0.25, 0.5, 1.0)


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
