"""What one run's window saw, as the metric readers get it.

A reader (``benchmark/metrics/<name>.py``) is ``read(w: Window)`` and
returns a number, or None where the window holds nothing to read.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from benchmark import roofline


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank over every value: the
    smallest value with at least a share q of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


@dataclass
class Window:
    t0: float                   # window start, host seconds
    seconds: float
    records: list               # client.Record, every request of the run
    m: dict                     # weights.dims of the configuration
    loop: str                   # "open" or "closed"
    deadline: float             # when the run stopped waiting
    setup_s: float = 0.0
    snap0: dict = field(default_factory=dict)   # metrics_snapshot at t0
    snap1: dict = field(default_factory=dict)   # ... at t1
    dispatches: list = field(default_factory=list)  # profiler records
    trace: object = None        # trace.Trace of a traced run

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds

    def due(self) -> list:
        """The requests due inside the window (every one sent)."""
        return [r for r in self.records if self.t0 <= r.due < self.t1]

    def ttft_s(self, r) -> float:
        """First token after the request was due; one that never came
        counts as the time the run waited for it."""
        if r.t_first_token and not r.error:
            return r.t_first_token - r.due
        return self.deadline - r.due

    def decode_tokens(self, a: float, b: float):
        """(context, emit time) of every decoded token emitted in [a, b):
        served token j >= 1 of a prompt of n came from a step over n + j
        positions (token 0 comes from the prefill)."""
        for r in self.records:
            n = len(r.prompt)
            for j in range(1, len(r.emit)):
                if a <= r.emit[j] < b:
                    yield n + j, r.emit[j]

    def prefills(self, a: float, b: float) -> list:
        """Requests whose first token came in [a, b)."""
        return [r for r in self.records
                if r.t_first_token and a <= r.t_first_token < b]

    def reused(self, recs: list) -> dict:
        """Prompt tokens each of ``recs`` took from the prefix cache: the
        engine's counter over the window spread over the requests whose
        prefix an earlier request of the run already sent with the same
        adapter, in proportion to that prefix's whole blocks."""
        block = 64
        total = max(0, self.snap1.get("prefix_reused_tokens", 0)
                    - self.snap0.get("prefix_reused_tokens", 0))
        seen, share = set(), {}
        for r in sorted(self.records, key=lambda r: r.t_prefill_start or 1e30):
            key = (r.prefix, r.adapter)
            if r.prefix >= 0 and key in seen:
                share[id(r)] = r.shared // block * block
            seen.add(key)
        mine = sum(share.get(id(r), 0) for r in recs)
        if not mine:
            return {}
        scale = min(1.0, total / mine)
        return {id(r): int(share.get(id(r), 0) * scale) for r in recs}

    def model_flops(self, a: float, b: float) -> float:
        """Operations the traffic needed in [a, b): every prefill whose
        first token came then, less its reused prefix, and every decoded
        token emitted then."""
        pre = self.prefills(a, b)
        reuse = self.reused(pre)
        flops = sum(roofline.prefill_flops(self.m, reuse.get(id(r), 0),
                                           len(r.prompt)) for r in pre)
        flops += sum(roofline.decode_flops(self.m, ctx)
                     for ctx, _ in self.decode_tokens(a, b))
        return flops

    def decode_blocks(self) -> list:
        """The engine profiler's decode dispatches inside the window:
        (wall seconds, active rows, steps)."""
        return [(d[2], d[5], d[7]) for d in self.dispatches
                if d[1] == "decode"]

    def decode_rows_mean(self):
        """Rows active per decode step, weighted by the blocks' steps."""
        blocks = self.decode_blocks()
        steps = sum(n for _, _, n in blocks)
        return sum(a * n for _, a, n in blocks) / steps if steps else None

    def output_tok_per_s(self) -> float:
        """Every output token emitted inside the window (first tokens
        included), over the window's seconds."""
        n = sum(1 for r in self.records for t in r.emit
                if self.t0 <= t < self.t1)
        return n / self.seconds

    def mfu_pct(self):
        """``model_flops`` over the window, against the bf16 peak."""
        flops = self.model_flops(self.t0, self.t1)
        return (flops / (self.seconds * roofline.BF16_FLOPS) * 100.0
                if flops else None)

    def decode_attn_roofline_pct(self):
        """K/V bytes the slice's decoded tokens needed at the HBM peak,
        over the paged decode kernels' (split and combine) device time."""
        t = self.trace
        if t is None:
            return None
        dev = t.device_seconds(lambda name: "decode_tile" in name and (
            "split_kernel" in name or "combine_kernel" in name))
        need = sum(roofline.kv_bytes(self.m, ctx)
                   for ctx, _ in self.decode_tokens(t.a, t.b))
        if not dev or not need:
            return None
        return need / roofline.HBM_BYTES_PER_S / dev * 100.0

    def decode_step_ms(self):
        """Sum of decode block walls over the sum of their steps."""
        blocks = self.decode_blocks()
        steps = sum(n for _, _, n in blocks)
        return sum(w for w, _, _ in blocks) / steps * 1e3 if steps else None

    def device_idle_pct(self):
        """Share of the traced slice with no device operation running."""
        t = self.trace
        if t is None or not t.kernels:
            return None
        return (t.window_s - t.busy_s()) / t.window_s * 100.0
