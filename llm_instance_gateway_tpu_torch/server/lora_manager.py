"""LoRA adapter registry and residency ladder bound to the engine's slot
buffers (port of ``server/lora_manager.py``).

Adapters on disk take two forms, and ``load_adapter_checkpoint`` reads
both: the port's ``.npz`` file, holding the reference checkpoint's tree
flattened (``alpha``, ``rank`` and one ``<target>.a`` / ``<target>.b``
array per target; ``save_adapter`` writes it), and the JAX package's
Orbax directory (``{"meta": {alpha, rank}, "weights": {target: {a, b}}}``,
read through ``models/orbax_tree.py``, which needs ``tensorstore``), so
the body the fleet's sidecar posts to a JAX pod loads on a torch pod too.

Residency ladder: ``slot`` = the device buffers, decodable now; ``host`` =
the weights held in host RAM as CPU tensors (pinned when the buffers live
on the card), so promotion is one host-to-device write and no file read;
``disk`` = the file only.  An adapter is in exactly one tier at a
time.  ``demote`` moves slot -> host, ``prefetch`` disk -> host without a
slot, ``evict_host`` host -> disk, and ``load`` promotes a host copy
before it reads a file; the host tier holds ``host_cache_slots`` adapters
and spills its least recently used one to disk.

Loading and promotion write the slot in place
(``models.lora.write_adapter``), and unload and demotion clear it in place,
so the buffers keep the addresses the engine's CUDA graph of the decode
block reads.  No live row reads the slot while it is written: a load or
promotion takes a free slot and publishes the adapter only afterwards, and
an unload or demotion is refused while a request holds it.  On the card
the write is queued on the default stream, where the engine runs, behind
any decode block in flight.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models import orbax_tree

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
    # Host copy of the weights (CPU tensors): what demotion moves into the
    # host tier, so slot -> host is a reference move, not a device read.
    weights: dict | None = None

    def __repr__(self):  # keep logs weight-free
        return (f"AdapterInfo(name={self.name!r}, slot={self.slot}, "
                f"rank={self.rank}, alpha={self.alpha}, "
                f"source={self.source!r})")


def save_adapter(path: str, weights: dict, alpha: float, rank: int) -> None:
    """Write an adapter as ``.npz`` (``{target: {"a", "b"}}`` + alpha, rank)."""
    arrays = {f"{t}.{k}": np.asarray(v, np.float32)
              for t, tv in weights.items() for k, v in tv.items()}
    with open(path, "wb") as f:
        np.savez(f, alpha=np.float32(alpha), rank=np.int32(rank), **arrays)


def load_adapter_checkpoint(path: str) -> tuple[dict, float, int]:
    """(weights ``{target: {"a", "b"}}`` as f32 arrays, alpha, rank) from
    an ``.npz`` file or an Orbax adapter directory."""
    if os.path.isdir(path):
        tree = orbax_tree.read_tree(path)
        weights = {t: {k: v.float().numpy() for k, v in tv.items()}
                   for t, tv in tree["weights"].items()}
        meta = tree["meta"]
        return weights, float(meta["alpha"]), int(meta["rank"])
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
    ``max_slots`` is max_lora) with the slot -> host -> disk ladder."""

    def __init__(self, cfg, dtype=torch.bfloat16, device="cuda",
                 host_cache_slots: int = 8, clock=time.perf_counter):
        self.cfg = cfg
        self._lock = threading.Lock()
        # Serializes whole mutations (load, unload, demote, prefetch).
        self._mutate_lock = threading.Lock()
        self._adapters: dict[str, AdapterInfo] = {}
        self._active: dict[str, int] = {}
        self._free_slots = list(range(cfg.max_lora_slots))
        # Host tier: name -> (weights, alpha, rank, source), LRU-bounded.
        self.host_cache_slots = max(0, host_cache_slots)
        self._host: "OrderedDict[str, tuple]" = OrderedDict()
        self._pin = torch.device(device).type == "cuda"
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
        """Adapter name -> rank, host-tier adapters included (a planner
        prices a promotion's rank before it happens)."""
        with self._lock:
            ranks = {name: info.rank for name, info in self._adapters.items()}
            for name, (_w, _a, rank, _src) in self._host.items():
                ranks.setdefault(name, rank)
            return ranks

    def adapter_tiers(self) -> dict[str, str]:
        """Adapter name -> tier for every adapter held in RAM (slot or
        host); absence means disk."""
        with self._lock:
            tiers = {name: TIER_SLOT for name in self._adapters}
            for name in self._host:
                tiers[name] = TIER_HOST
            return tiers

    def residency_snapshot(self) -> dict[str, list[str]]:
        """Tier -> sorted adapter names (tpu:adapter_residency_info)."""
        with self._lock:
            return {TIER_SLOT: sorted(self._adapters),
                    TIER_HOST: sorted(self._host)}

    def residency_counters(self) -> tuple[dict, dict]:
        """(tier transitions {(from, to): n}, load latency per tier
        {tier: [sum_s, count]})."""
        with self._lock:
            return (dict(self.tier_transitions),
                    {t: list(sc) for t, sc in self.load_seconds.items()})

    def _note_transition(self, frm: str, to: str) -> None:
        """Caller holds self._lock."""
        key = (frm, to)
        self.tier_transitions[key] = self.tier_transitions.get(key, 0) + 1

    def _note_load(self, tier: str, seconds: float) -> None:
        with self._lock:
            sc = self.load_seconds.setdefault(tier, [0.0, 0])
            sc[0] += seconds
            sc[1] += 1

    def _host_copy(self, weights: dict) -> dict:
        """The weights as f32 CPU tensors, pinned when the slots live on
        the card (their host-to-device write then needs no staging)."""
        out = {}
        for t, tv in weights.items():
            out[t] = {}
            for k, v in tv.items():
                src = torch.as_tensor(np.asarray(v, np.float32))
                dst = torch.empty(src.shape, dtype=torch.float32,
                                  pin_memory=self._pin)
                out[t][k] = dst.copy_(src)
        return out

    def _host_put(self, name: str, weights: dict, alpha: float, rank: int,
                  source: str) -> None:
        """Insert into the bounded host tier (caller holds self._lock); the
        least recently used copy beyond the bound falls to disk."""
        self._host[name] = (weights, alpha, rank, source)
        self._host.move_to_end(name)
        while len(self._host) > self.host_cache_slots:
            evicted, _ = self._host.popitem(last=False)
            self._note_transition(TIER_HOST, TIER_DISK)
            logger.info("host cache full: adapter %s fell to disk", evicted)

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
        """Load an adapter into a free slot (idempotent per name): a host
        copy is promoted without a file read, unless the caller brings new
        weights or another checkpoint path (a new version: the stale copy
        is discarded)."""
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
                # Popped, not copied: the name is never in two tiers.
                cached = self._host.pop(name, None)
                if cached is not None and (
                        weights is not None
                        or (checkpoint_path is not None
                            and checkpoint_path != cached[3])):
                    self._note_transition(TIER_HOST, TIER_DISK)
                    logger.info("discarding stale host copy of %s (source "
                                "%s; caller supplied a new source)", name,
                                cached[3])
                    cached = None
            source = checkpoint_path or "inline"
            from_tier, timed_tier = TIER_DISK, None
            t0 = self._clock()
            try:
                if cached is not None:
                    weights, alpha, rank, source = cached
                    from_tier = timed_tier = TIER_HOST
                else:
                    if checkpoint_path is not None:
                        weights, alpha, rank = load_adapter_checkpoint(
                            checkpoint_path)
                        timed_tier = TIER_DISK
                    if weights is None:
                        raise AdapterError(
                            "either weights or checkpoint_path required")
                    weights = self._host_copy(weights)
                lora_lib.write_adapter(self.buffers, self.cfg, slot,
                                       weights, alpha, rank)
            except Exception:
                with self._lock:
                    self._free_slots.insert(0, slot)
                    if cached is not None:  # promotion failed: keep the copy
                        self._host[name] = cached
                raise
            if timed_tier is not None:
                self._note_load(timed_tier, self._clock() - t0)
            info = AdapterInfo(name=name, slot=slot, rank=rank, alpha=alpha,
                               source=source, weights=weights)
            with self._lock:
                self._adapters[name] = info
                self._note_transition(from_tier, TIER_SLOT)
        logger.info("loaded adapter %s into slot %d (rank %d, from %s)",
                    name, slot, rank, from_tier)
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
                    # A host-tier unload needs no buffer work.
                    if self._host.pop(name, None) is not None:
                        self._note_transition(TIER_HOST, TIER_DISK)
                        logger.info("unloaded host-cached adapter %s", name)
                        return True
                    return False
            lora_lib.clear_adapter(self.buffers, self.cfg, info.slot)
            with self._lock:
                self._free_slots.append(info.slot)
                self._note_transition(TIER_SLOT, TIER_DISK)
        logger.info("unloaded adapter %s from slot %d", name, info.slot)
        return True

    def demote(self, name: str) -> bool:
        """Slot -> host RAM: free the slot and keep the weights, so a later
        ``load`` promotes without a file read.  Refused
        (``AdapterBusyError``) while a request holds the slot, and refused
        outright when the host tier is disabled (the weights would be lost
        while the answer claimed tier=host)."""
        if self.host_cache_slots <= 0:
            raise AdapterError(
                "cannot demote: host cache disabled (host_cache_slots=0); "
                "use unload if the checkpoint store is the backstop")
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
                if info.weights is None:
                    self._adapters[name] = info
                    raise AdapterError(
                        f"adapter {name!r} has no host-side weights to "
                        "demote (reload it from a checkpoint first)")
            lora_lib.clear_adapter(self.buffers, self.cfg, info.slot)
            with self._lock:
                self._free_slots.append(info.slot)
                self._host_put(name, info.weights, info.alpha, info.rank,
                               info.source)
                self._note_transition(TIER_SLOT, TIER_HOST)
        logger.info("demoted adapter %s: slot %d -> host RAM", name,
                    info.slot)
        return True

    def prefetch(self, name: str, checkpoint_path: str) -> bool:
        """Disk -> host RAM without taking a slot; False for a name already
        in RAM (slot or host)."""
        if not name or not all(c.isalnum() or c in "._-" for c in name):
            raise AdapterError(
                f"invalid adapter name {name!r}: use [A-Za-z0-9._-]")
        if self.host_cache_slots <= 0:
            raise AdapterError("host cache disabled (host_cache_slots=0)")
        with self._mutate_lock:
            with self._lock:
                if name in self._adapters or name in self._host:
                    return False
            t0 = self._clock()
            weights, alpha, rank = load_adapter_checkpoint(checkpoint_path)
            weights = self._host_copy(weights)
            self._note_load(TIER_DISK, self._clock() - t0)
            with self._lock:
                self._host_put(name, weights, alpha, rank, checkpoint_path)
                self._note_transition(TIER_DISK, TIER_HOST)
        logger.info("prefetched adapter %s into host RAM (rank %d)",
                    name, rank)
        return True

    def evict_host(self, name: str) -> bool:
        """Host RAM -> disk: drop the host copy (the checkpoint remains).
        A slot-resident adapter is untouched: demote it first."""
        with self._mutate_lock, self._lock:
            if self._host.pop(name, None) is None:
                return False
            self._note_transition(TIER_HOST, TIER_DISK)
        logger.info("evicted adapter %s from host RAM", name)
        return True
