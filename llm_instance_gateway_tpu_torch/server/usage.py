"""Per-adapter capacity attribution (the port's own copy of the reference's
``server/usage.py``).

Every decode dispatch's wall is split evenly across the slots active in
it, each prefill's wall is charged whole to its owner, and KV holdings are
integrated over time — the ``tpu:adapter_*_total`` families plus the
pool-waste observables (batch occupancy, idle slot-seconds, prefill
padding), charged at the same engine call sites as in the reference.
"""

from __future__ import annotations

import threading
import time

from llm_instance_gateway_tpu_torch.tracing import (
    Histogram,
    escape_label,
    render_histogram,
)

# Attribution key for requests with no LoRA adapter (base-model rows).
BASE = "base"

# Decode-batch occupancy fractions (active/total slots).
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"


def owner_key(adapter: str | None) -> str:
    return adapter if adapter else BASE


class UsageTracker:
    """Accumulates per-adapter consumption; snapshot() is the export seam."""

    def __init__(self, decode_slots: int, kv_block: int = 1,
                 clock=time.monotonic):
        self.decode_slots = max(1, decode_slots)
        self.kv_block = max(1, kv_block)
        self._clock = clock
        self._lock = threading.Lock()
        self.step_seconds: dict[tuple[str, str], float] = {}
        self.tokens: dict[tuple[str, str], int] = {}
        self.kv_block_seconds: dict[str, float] = {}
        self.engine_step_seconds: dict[str, float] = {}
        self.idle_slot_seconds = 0.0
        self.padding_tokens = 0
        self.occupancy = Histogram(OCCUPANCY_BUCKETS)
        self._kv_holdings: tuple[tuple[str, float], ...] = ()
        self._kv_t: float | None = None

    def charge_step(self, phase: str, wall_s: float,
                    owners: list[str | None],
                    tokens: dict[str, int] | None = None) -> None:
        """Split ``wall_s`` evenly across ``owners`` (None = base)."""
        if not owners or wall_s <= 0.0:
            return
        share = wall_s / len(owners)
        with self._lock:
            self.engine_step_seconds[phase] = (
                self.engine_step_seconds.get(phase, 0.0) + wall_s)
            for owner in owners:
                key = (owner_key(owner), phase)
                self.step_seconds[key] = self.step_seconds.get(key, 0.0) + share
            for owner, n in (tokens or {}).items():
                if n:
                    key = (owner, phase)
                    self.tokens[key] = self.tokens.get(key, 0) + n

    def charge_decode(self, wall_s: float, owners: list[str | None],
                      tokens: dict[str, int] | None = None) -> None:
        active = len(owners)
        with self._lock:
            self.occupancy.observe(active / self.decode_slots)
            if wall_s > 0.0:
                self.idle_slot_seconds += wall_s * (self.decode_slots - active)
        self.charge_step(PHASE_DECODE, wall_s, owners, tokens)

    def charge_padding(self, pad_tokens: int) -> None:
        if pad_tokens > 0:
            with self._lock:
                self.padding_tokens += pad_tokens

    def sync_kv(self, holdings: list[tuple[str | None, int]] | None,
                now: float | None = None) -> None:
        """Charge the PREVIOUS holdings for the elapsed interval, then (if
        ``holdings`` is not None) replace them."""
        now = self._clock() if now is None else now
        with self._lock:
            if self._kv_t is not None:
                dt = now - self._kv_t
                if dt > 0.0:
                    for owner, blocks in self._kv_holdings:
                        self.kv_block_seconds[owner] = (
                            self.kv_block_seconds.get(owner, 0.0)
                            + blocks * dt)
            self._kv_t = now
            if holdings is not None:
                self._kv_holdings = tuple(
                    (owner_key(a), -(-t // self.kv_block))
                    for a, t in holdings if t > 0)

    def snapshot(self) -> dict:
        self.sync_kv(None)
        with self._lock:
            return {
                "step_seconds": dict(self.step_seconds),
                "tokens": dict(self.tokens),
                "kv_block_seconds": dict(self.kv_block_seconds),
                "engine_step_seconds": dict(self.engine_step_seconds),
                "idle_slot_seconds": self.idle_slot_seconds,
                "padding_tokens": self.padding_tokens,
                "occupancy": self.occupancy.state(),
                "kv_block_tokens": self.kv_block,
            }


def render_usage(usage: dict, model: str) -> list[str]:
    """Exposition lines for one ``UsageTracker.snapshot()`` payload."""
    lines = []
    m = escape_label(model)
    step = usage.get("step_seconds") or {}
    if step:
        lines.append("# TYPE tpu:adapter_step_seconds_total counter")
        for (adapter, phase) in sorted(step):
            lines.append(
                'tpu:adapter_step_seconds_total{model="%s",adapter="%s",'
                'phase="%s"} %.6f'
                % (m, escape_label(adapter), escape_label(phase),
                   step[(adapter, phase)]))
    toks = usage.get("tokens") or {}
    if toks:
        lines.append("# TYPE tpu:adapter_tokens_total counter")
        for (adapter, phase) in sorted(toks):
            lines.append(
                'tpu:adapter_tokens_total{model="%s",adapter="%s",'
                'phase="%s"} %d'
                % (m, escape_label(adapter), escape_label(phase),
                   toks[(adapter, phase)]))
    kv = usage.get("kv_block_seconds") or {}
    if kv:
        lines.append("# TYPE tpu:adapter_kv_block_seconds_total counter")
        for adapter in sorted(kv):
            lines.append(
                'tpu:adapter_kv_block_seconds_total{model="%s",'
                'adapter="%s"} %.6f' % (m, escape_label(adapter), kv[adapter]))
    engine_s = usage.get("engine_step_seconds") or {}
    if engine_s:
        lines.append("# TYPE tpu:step_seconds_total counter")
        for phase in sorted(engine_s):
            lines.append('tpu:step_seconds_total{phase="%s"} %.6f'
                         % (escape_label(phase), engine_s[phase]))
    lines.append("# TYPE tpu:idle_slot_seconds_total counter")
    lines.append("tpu:idle_slot_seconds_total %.6f"
                 % usage.get("idle_slot_seconds", 0.0))
    lines.append("# TYPE tpu:prefill_padding_tokens_total counter")
    lines.append("tpu:prefill_padding_tokens_total %d"
                 % usage.get("padding_tokens", 0))
    occ = usage.get("occupancy")
    if occ:
        lines += render_histogram("tpu:decode_batch_occupancy", occ)
    return lines
