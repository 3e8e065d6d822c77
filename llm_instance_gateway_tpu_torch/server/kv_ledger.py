"""Block-lifecycle ledger for the paged KV pool (the port's own copy of
the reference's ``server/kv_ledger.py``).

- **Per-state block accounting** whose states tile the block budget:
  ``free`` (allocator free list), ``active`` (distinct physical blocks
  referenced by live row tables — a shared prefix block mapped into five
  rows is one block), ``prefix_resident`` (zero-ref cached blocks in the
  evictable LRU) and ``parked`` (block-equivalents of ``decode_wait`` KV,
  held outside the pool).  The three pool states are recounted from the
  allocator's ground truth on every sync, so a leaked or double-allocated
  block breaks the conservation sum instead of hiding in a residual.
- **Per-prefix reuse table** behind a bounded LRU: hits, tokens saved,
  resident chain depth and last-touch age per content-addressed prefix id
  (the hex of the deepest chained block hash, the same id on every
  replica).
- **Fragmentation + headroom histograms** (free-run lengths, parked share)
  and a bounded lifecycle event ring for ``/debug/kv``.

Same snapshot payload and ``tpu:kv_*`` exposition as the reference, so the
gateway's KV observatory reads a torch pod like a JAX pod.  A plain
``threading.Lock`` guards the ledger (the reference's lock witness belongs
to the JAX package).
"""

from __future__ import annotations

import collections
import threading
import time

from llm_instance_gateway_tpu_torch.tracing import (
    Histogram,
    escape_label,
    render_histogram,
)

# Free-run lengths in BLOCKS (power-of-two buckets: the question is "can a
# max_blocks_per_seq growth burst find room", not a latency tail).
FREE_RUN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# Parked share of the total block budget (same even bins as the decode
# occupancy histogram).
PARKED_SHARE_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

# Lifecycle event kinds (the ``kind`` label of
# ``tpu:kv_block_events_total`` and the ring's ``kind`` field).
EVENT_KINDS = ("alloc", "evict", "reuse_hit", "reuse_unwind", "register",
               "release", "cache_park", "park", "unpark", "sweep")

# States of the block-budget accounting (the ``state`` label of
# ``tpu:kv_blocks``; the order is the exposition order).
STATES = ("free", "active", "prefix_resident", "parked")


def free_run_lengths(free_blocks) -> list[int]:
    """Lengths of maximal runs of consecutive physical block ids in the
    free list (order-insensitive: the allocator pops/pushes LIFO)."""
    if not free_blocks:
        return []
    ids = sorted(free_blocks)
    runs = []
    run = 1
    for prev, cur in zip(ids, ids[1:]):
        if cur == prev + 1:
            run += 1
        else:
            runs.append(run)
            run = 1
    runs.append(run)
    return runs


class KvLedger:
    """Accumulates the pool's block economy; ``snapshot()`` is the export
    seam (``metrics_snapshot``'s ``kv_ledger`` key -> ``render_kv`` ->
    the ``tpu:kv_*`` families + ``/debug/kv``)."""

    def __init__(self, n_blocks: int, block_tokens: int,
                 prefix_table_cap: int = 512, ring_cap: int = 256,
                 top_prefixes: int = 32, clock=time.monotonic):
        self.n_blocks = max(1, n_blocks)
        self.block_tokens = max(1, block_tokens)
        self.prefix_table_cap = max(1, prefix_table_cap)
        self.top_prefixes = max(1, top_prefixes)
        self._clock = clock
        self._lock = threading.Lock()
        # Cumulative lifecycle counters by kind (tpu:kv_block_events_total).
        self.events: dict[str, int] = {}
        # prefix id -> {hits, tokens_saved, blocks, last_touch}; bounded
        # LRU on touch order (register/hit), evictions counted so a
        # heatmap over a hostile prefix flood stays honest about loss.
        self.prefixes: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        self.prefix_table_evictions = 0
        # Last-synced state counts (recounted from allocator ground truth
        # each sync; the conservation test reads these through render_kv).
        self._states = {s: 0 for s in STATES}
        self._parked_tokens = 0
        self._free_view: tuple[int, ...] = ()
        self._syncs = 0
        self.parked_share = Histogram(PARKED_SHARE_BUCKETS)
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, ring_cap))

    # -- charging (engine thread) -----------------------------------------
    def _note(self, kind: str, **attrs) -> None:
        with self._lock:
            self.events[kind] = self.events.get(kind, 0) + attrs.pop("n", 1)
            self._ring.append({"t": round(self._clock(), 4), "kind": kind,
                               **attrs})

    def note_alloc(self, n: int = 1) -> None:
        self._note("alloc", n=n)

    def note_evict(self, prefix: str) -> None:
        """A cached block was evicted LRU to satisfy an allocation.  The
        prefix entry (if the evicted block was a chain terminus) loses one
        resident block; intermediate blocks of a longer chain decrement
        nothing here — the chain's entry decays as ITS terminus goes."""
        with self._lock:
            self.events["evict"] = self.events.get("evict", 0) + 1
            entry = self.prefixes.get(prefix)
            if entry is not None and entry["blocks"] > 0:
                entry["blocks"] -= 1
            self._ring.append({"t": round(self._clock(), 4),
                               "kind": "evict", "prefix": prefix})

    def note_reuse_hit(self, prefix: str, blocks: int, tokens: int) -> None:
        with self._lock:
            self.events["reuse_hit"] = self.events.get("reuse_hit", 0) + 1
            entry = self._touch(prefix)
            entry["hits"] += 1
            entry["tokens_saved"] += tokens
            entry["blocks"] = max(entry["blocks"], blocks)
            self._ring.append({"t": round(self._clock(), 4),
                               "kind": "reuse_hit", "prefix": prefix,
                               "blocks": blocks, "tokens": tokens})

    def note_reuse_unwind(self, prefix: str, blocks: int, tokens: int) -> None:
        """Mirror of the engine's reuse unwind (prefix-bucket admission
        that mapped a prefix, then failed to grow the suffix): the hit is
        cancelled exactly where ``prefix_reused_tokens`` is decremented, so
        ledger tokens-saved stays equal to the engine counter."""
        with self._lock:
            self.events["reuse_unwind"] = (
                self.events.get("reuse_unwind", 0) + 1)
            entry = self.prefixes.get(prefix)
            if entry is not None:
                entry["hits"] = max(0, entry["hits"] - 1)
                entry["tokens_saved"] = max(0, entry["tokens_saved"] - tokens)
            self._ring.append({"t": round(self._clock(), 4),
                               "kind": "reuse_unwind", "prefix": prefix,
                               "blocks": blocks, "tokens": tokens})

    def note_register(self, prefix: str, blocks: int) -> None:
        with self._lock:
            self.events["register"] = self.events.get("register", 0) + 1
            entry = self._touch(prefix)
            entry["blocks"] = max(entry["blocks"], blocks)
            self._ring.append({"t": round(self._clock(), 4),
                               "kind": "register", "prefix": prefix,
                               "blocks": blocks})

    def note_release(self, freed: int, cached: int) -> None:
        """A row's table cleared: ``freed`` uncached blocks returned to
        the free list, ``cached`` dropped to zero refs and parked in the
        evictable LRU (content kept — the prefix-resident state)."""
        with self._lock:
            self.events["release"] = self.events.get("release", 0) + 1
            if cached:
                self.events["cache_park"] = (
                    self.events.get("cache_park", 0) + cached)
            self._ring.append({"t": round(self._clock(), 4),
                               "kind": "release", "freed": freed,
                               "cached": cached})

    def note_park(self, tokens: int, source: str) -> None:
        self._note("park", tokens=tokens, source=source)

    def note_unpark(self, tokens: int) -> None:
        self._note("unpark", tokens=tokens)

    def note_sweep(self, tokens: int, reason: str) -> None:
        self._note("sweep", tokens=tokens, reason=reason)

    def _touch(self, prefix: str) -> dict:
        """Entry for ``prefix``, moved to the LRU's MRU end (lock held)."""
        entry = self.prefixes.get(prefix)
        if entry is None:
            entry = {"hits": 0, "tokens_saved": 0, "blocks": 0,
                     "last_touch": self._clock()}
            self.prefixes[prefix] = entry
            while len(self.prefixes) > self.prefix_table_cap:
                self.prefixes.popitem(last=False)
                self.prefix_table_evictions += 1
        else:
            entry["last_touch"] = self._clock()
            self.prefixes.move_to_end(prefix)
        return entry

    def sync_states(self, free_blocks, active_blocks: int,
                    prefix_resident: int, parked_tokens: int) -> None:
        """Engine-thread state recount (rides the per-dispatch KV sync):
        the three pool states from allocator ground truth, the parked
        block-equivalents, a swap-published free-list view for the
        fragmentation histogram, and one parked-share sample."""
        parked_blocks = -(-max(0, parked_tokens) // self.block_tokens)
        with self._lock:
            self._states = {
                "free": len(free_blocks),
                "active": active_blocks,
                "prefix_resident": prefix_resident,
                "parked": parked_blocks,
            }
            self._parked_tokens = max(0, parked_tokens)
            self._free_view = tuple(free_blocks)
            self._syncs += 1
            self.parked_share.observe(
                parked_blocks / (self.n_blocks + parked_blocks)
                if parked_blocks else 0.0)

    # -- export (any thread) ----------------------------------------------
    def snapshot(self) -> dict:
        """Copy-out for ``metrics_snapshot()`` / ``/debug/kv``.  The
        free-run histogram is computed HERE (scrape rate) from the
        swap-published free view, not on the dispatch path."""
        with self._lock:
            states = dict(self._states)
            parked_tokens = self._parked_tokens
            free_view = self._free_view
            events = dict(self.events)
            now = self._clock()
            prefixes = [
                {"prefix": p, "hits": e["hits"],
                 "tokens_saved": e["tokens_saved"], "blocks": e["blocks"],
                 "age_s": round(max(0.0, now - e["last_touch"]), 3)}
                for p, e in self.prefixes.items()]
            table_size = len(self.prefixes)
            table_evictions = self.prefix_table_evictions
            parked_share = self.parked_share.state()
            ring = list(self._ring)
            syncs = self._syncs
        prefixes.sort(key=lambda e: (-e["hits"], -e["tokens_saved"],
                                     e["prefix"]))
        free_runs = Histogram(FREE_RUN_BUCKETS)
        for run in free_run_lengths(free_view):
            free_runs.observe(float(run))
        return {
            "blocks_total": self.n_blocks + states["parked"],
            "pool_blocks": self.n_blocks,
            "block_tokens": self.block_tokens,
            "states": states,
            "parked_tokens": parked_tokens,
            "events": events,
            "prefixes": prefixes[: self.top_prefixes],
            "prefix_table_size": table_size,
            "prefix_table_evictions": table_evictions,
            "free_runs": free_runs.state(),
            "parked_share": parked_share,
            "ring": ring,
            "syncs": syncs,
        }


def render_kv(kv: dict) -> list[str]:
    """Exposition lines for one ``KvLedger.snapshot()`` payload (the
    ``server/metrics.py`` render seam).  Prefix ids are hex but escape
    anyway — one hostile label must not poison the scrape."""
    lines = [
        "# TYPE tpu:kv_blocks_total gauge",
        "tpu:kv_blocks_total %d" % kv.get("blocks_total", 0),
        "# TYPE tpu:kv_block_tokens gauge",
        "tpu:kv_block_tokens %d" % kv.get("block_tokens", 1),
        "# TYPE tpu:kv_blocks gauge",
    ]
    states = kv.get("states") or {}
    for state in STATES:
        lines.append('tpu:kv_blocks{state="%s"} %d'
                     % (escape_label(state), states.get(state, 0)))
    events = kv.get("events") or {}
    lines.append("# TYPE tpu:kv_block_events_total counter")
    if events:
        for kind in sorted(events):
            lines.append('tpu:kv_block_events_total{kind="%s"} %d'
                         % (escape_label(kind), events[kind]))
    else:
        lines.append("tpu:kv_block_events_total 0")
    prefixes = kv.get("prefixes") or []
    if prefixes:
        lines.append("# TYPE tpu:kv_prefix_hits_total counter")
        for e in prefixes:
            lines.append('tpu:kv_prefix_hits_total{prefix="%s"} %d'
                         % (escape_label(e["prefix"]), e["hits"]))
        lines.append("# TYPE tpu:kv_prefix_tokens_saved_total counter")
        for e in prefixes:
            lines.append('tpu:kv_prefix_tokens_saved_total{prefix="%s"} %d'
                         % (escape_label(e["prefix"]), e["tokens_saved"]))
        lines.append("# TYPE tpu:kv_prefix_resident_blocks gauge")
        for e in prefixes:
            lines.append('tpu:kv_prefix_resident_blocks{prefix="%s"} %d'
                         % (escape_label(e["prefix"]), e["blocks"]))
    if kv.get("free_runs"):
        lines += render_histogram("tpu:kv_free_run_blocks", kv["free_runs"])
    if kv.get("parked_share"):
        lines += render_histogram("tpu:kv_parked_share", kv["parked_share"])
    return lines
