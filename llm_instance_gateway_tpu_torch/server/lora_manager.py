"""LoRA adapter registry bound to the engine's slot buffers (port of the
slot tier of ``server/lora_manager.py``).

Adapters on disk are ``.npz`` files (Orbax is a JAX library) holding the
reference checkpoint's tree flattened: ``alpha``, ``rank`` and one
``<target>.a`` / ``<target>.b`` array per target (``save_adapter``).
Loading writes the slot in place (``models.lora.write_adapter``), so the
buffers keep the addresses the engine's CUDA graph of the decode block
reads.  No live row reads the slot while it is written: a load takes a free
slot and publishes the adapter only afterwards, and an unload is refused
while a request holds it.  On the card the write is queued on the default
stream, where the engine runs, behind any decode block in flight.  The host-RAM and disk tiers of the residency ladder are not ported
yet (ROADMAP Queue 1, LoRA residency ladder); the residency snapshot
reports them empty.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib

logger = logging.getLogger(__name__)

TIER_SLOT = "slot"
TIER_HOST = "host"
TIER_DISK = "disk"


class AdapterError(Exception):
    pass


class AdapterBusyError(AdapterError):
    """Adapter has in-flight requests pinned to its slot (HTTP 409)."""


@dataclass
class AdapterInfo:
    name: str
    slot: int
    rank: int
    alpha: float
    source: str  # checkpoint path or "inline"


def save_adapter(path: str, weights: dict, alpha: float, rank: int) -> None:
    """Write an adapter as ``.npz`` (``{target: {"a", "b"}}`` + alpha, rank)."""
    arrays = {f"{t}.{k}": np.asarray(v, np.float32)
              for t, tv in weights.items() for k, v in tv.items()}
    with open(path, "wb") as f:
        np.savez(f, alpha=np.float32(alpha), rank=np.int32(rank), **arrays)


def load_adapter_checkpoint(path: str) -> tuple[dict, float, int]:
    with np.load(path) as data:
        weights: dict = {}
        for key in data.files:
            if "." in key:
                t, ab = key.split(".", 1)
                weights.setdefault(t, {})[ab] = data[key]
        return weights, float(data["alpha"]), int(data["rank"])


class LoRAManager:
    """Thread-safe adapter registry (vLLM ``lora_requests_info`` semantics:
    ``running_adapters`` is the set the gateway's affinity filter matches,
    ``max_slots`` is max_lora)."""

    def __init__(self, cfg, dtype=torch.bfloat16, device="cuda",
                 clock=time.perf_counter):
        self.cfg = cfg
        self._lock = threading.Lock()
        # Serializes whole load/unload read-modify-writes of the buffers.
        self._mutate_lock = threading.Lock()
        self._adapters: dict[str, AdapterInfo] = {}
        self._active: dict[str, int] = {}
        self._free_slots = list(range(cfg.max_lora_slots))
        self._clock = clock
        self.tier_transitions: dict[tuple[str, str], int] = {}
        self.load_seconds: dict[str, list] = {
            t: [0.0, 0] for t in (TIER_HOST, TIER_DISK)}
        self.buffers = lora_lib.init_lora_buffers(cfg, dtype=dtype,
                                                  device=device)

    # -- queries -----------------------------------------------------------
    def running_adapters(self) -> list[str]:
        with self._lock:
            return sorted(self._adapters)

    def adapter_ranks(self) -> dict[str, int]:
        with self._lock:
            return {name: info.rank for name, info in self._adapters.items()}

    def residency_snapshot(self) -> dict[str, list[str]]:
        with self._lock:
            return {TIER_SLOT: sorted(self._adapters), TIER_HOST: []}

    def residency_counters(self) -> tuple[dict, dict]:
        with self._lock:
            return (dict(self.tier_transitions),
                    {t: list(sc) for t, sc in self.load_seconds.items()})

    @property
    def max_slots(self) -> int:
        return self.cfg.max_lora_slots

    def slot_for(self, adapter_name: str | None) -> int:
        """Slot id for a request (-1 = base model). Raises if not resident."""
        if adapter_name is None:
            return -1
        with self._lock:
            info = self._adapters.get(adapter_name)
        if info is None:
            raise AdapterError(f"adapter {adapter_name!r} is not loaded")
        return info.slot

    def acquire(self, adapter_name: str | None) -> int:
        """Resolve AND pin the slot until the matching ``release``."""
        if adapter_name is None:
            return -1
        with self._lock:
            info = self._adapters.get(adapter_name)
            if info is None:
                raise AdapterError(f"adapter {adapter_name!r} is not loaded")
            self._active[adapter_name] = self._active.get(adapter_name, 0) + 1
            return info.slot

    def release(self, adapter_name: str | None) -> None:
        if adapter_name is None:
            return
        with self._lock:
            n = self._active.get(adapter_name, 0)
            if n <= 1:
                self._active.pop(adapter_name, None)
            else:
                self._active[adapter_name] = n - 1

    # -- mutations ---------------------------------------------------------
    def load(self, name: str, weights: dict | None = None, alpha: float = 16.0,
             rank: int = 8, checkpoint_path: str | None = None) -> AdapterInfo:
        """Load an adapter into a free slot (idempotent per name)."""
        if not name or not all(c.isalnum() or c in "._-" for c in name):
            raise AdapterError(
                f"invalid adapter name {name!r}: use [A-Za-z0-9._-] "
                "(names flow into Prometheus labels and routing configs)")
        with self._mutate_lock:
            with self._lock:
                if name in self._adapters:
                    return self._adapters[name]
                if not self._free_slots:
                    raise AdapterError(
                        f"no free adapter slots (max {self.cfg.max_lora_slots})")
                slot = self._free_slots.pop(0)
            t0 = self._clock()
            try:
                if checkpoint_path is not None:
                    weights, alpha, rank = load_adapter_checkpoint(
                        checkpoint_path)
                if weights is None:
                    raise AdapterError(
                        "either weights or checkpoint_path required")
                lora_lib.write_adapter(self.buffers, self.cfg, slot,
                                       weights, alpha, rank)
            except Exception:
                with self._lock:
                    self._free_slots.insert(0, slot)
                raise
            info = AdapterInfo(name=name, slot=slot, rank=rank, alpha=alpha,
                               source=checkpoint_path or "inline")
            with self._lock:
                if checkpoint_path is not None:
                    sc = self.load_seconds[TIER_DISK]
                    sc[0] += self._clock() - t0
                    sc[1] += 1
                self._adapters[name] = info
                key = (TIER_DISK, TIER_SLOT)
                self.tier_transitions[key] = self.tier_transitions.get(key, 0) + 1
        logger.info("loaded adapter %s into slot %d (rank %d)", name, slot, rank)
        return info

    def unload(self, name: str) -> bool:
        with self._mutate_lock:
            with self._lock:
                active = self._active.get(name, 0)
                if active:
                    raise AdapterBusyError(
                        f"adapter {name!r} has {active} in-flight request(s); "
                        "retry after they drain")
                info = self._adapters.pop(name, None)
                if info is None:
                    return False
            lora_lib.clear_adapter(self.buffers, self.cfg, info.slot)
            with self._lock:
                self._free_slots.append(info.slot)
                key = (TIER_SLOT, TIER_DISK)
                self.tier_transitions[key] = self.tier_transitions.get(key, 0) + 1
        logger.info("unloaded adapter %s from slot %d", name, info.slot)
        return True
