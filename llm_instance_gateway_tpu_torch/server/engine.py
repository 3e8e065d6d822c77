"""Continuous-batching serving engine (port of ``server/engine.py``: the
synchronous loop and the pipelined one).

- **Prefill** pads a prompt to a prefill bucket and samples the first
  token.  With ``prefill_batch`` P > 1, up to P queued prompts of one
  bucket prefill as one ``[P, bucket]`` program (``_prefill_many_impl``,
  per-row true lengths, adapters and sampling) — except on a paged engine
  with the prefix cache, whose prompts stay per request.
- **Insert** writes the prompt KV into a free decode row: a contiguous
  cache lane ``[n_layers, decode_slots, max_seq_len, n_kv, hd]``, or — with
  ``paged_kv_block`` — pool blocks the host allocator hands the row
  (``models/paged.py``; block 0 is the trash block).  With every slot busy
  the prompt prefills AHEAD and parks in ``decode_wait`` (KV held
  off-cache) until a slot (and, paged, its blocks) frees, FIFO.
- **Prefix cache** (paged): full prompt blocks are content-addressed by a
  chained SHA-256 seeded with the adapter identity, refcounted, and kept
  in an LRU once unreferenced; a later prompt maps the cached blocks and
  prefills only its suffix in one chunk program.
- **Chunk streams**: a prompt longer than the largest bucket streams into
  a RESERVED row one chunk per engine cycle (up to ``stream_lanes`` at
  once, round-robin), so decode keeps stepping between chunks.
- **Generate** advances all active slots ``n_steps`` tokens per dispatch
  (``_plan_steps``, the adaptive planner) with the device-side freeze: a
  row whose budget runs out, or which emits EOS or completes a stop
  sequence, stops advancing mid-block.  The block (``_decode_block``) runs
  n steps of decode_step + sample on device buffers of fixed address —
  the carry (tokens, positions, budgets, stop history) and the per-row
  parameters — and returns one output pack.  On the card it is a CUDA
  graph captured once per ``(n_steps, seeded)`` and replayed
  (``decode_graphs.py``, the counterpart of the reference's ``jit``); on
  the CPU, or on the card with ``cuda_graphs=False``, it runs eagerly.
- **Pipelined dispatch** (``pipeline_decode``): block N+1 is dispatched
  from the device-resident carry before block N's tokens are read back,
  so the readback and the host's bookkeeping overlap the device; first
  tokens are scattered into the carry on the device and reach the request
  (TTFT) when its first block is processed.

- **int8 KV** (``kv_cache_quant="int8"``): lanes or pool store K/V int8
  with one f32 scale per (position, KV head); prompt KV is quantized where
  it lands, and decode runs the int8 kernels.
- **Disaggregation** (``server/kv_transfer.py``): ``prefill_only`` runs a
  prompt's prefill with no slot and no cache write and returns its KV as a
  ``PrefillHandoff``; ``attach_prefilled`` parks a handoff's KV in
  ``decode_wait`` (first token emitted at once), from where the drain
  inserts it like a prefill-ahead, mapping cached prefix blocks first.
  Handoff imports parked past ``handoff_ttl_s`` are swept (across
  processes on the first process's clock, its verdicts broadcast).
- **Penalties** (OpenAI presence / frequency over generated tokens): a
  [B, V_padded] int32 count buffer, allocated at the first penalized
  request, is one more fixed-address buffer of the decode block, whose
  penalized variant subtracts before the argmax, the draw and the logprobs
  and counts what it emits.  Penalty-free serving never allocates it.
- **Speculative decoding** (``speculative_k`` K with ``draft_params`` /
  ``draft_cfg``): a draft model with lanes of its own proposes K greedy
  tokens per cycle and the target scores [cur, d_1..d_K] in one
  ``extend_step`` (``extend_step_paged`` on the pool); greedy rows accept
  the longest matching prefix plus the target's own next token, exact
  greedy parity.  ``_spec_block`` fuses the cycles of a dispatch, in both
  loops; on the card it is a CUDA graph per ``(n_cycles, k, seeded)``.
  Sampled rows, stop-sequence rows and chunk-streamed rows do not
  speculate; penalties and ``logit_bias`` are refused on such an engine.

- **Meshes** (``mesh=``, ``parallel/``): over ``tensor`` and ``expert``
  the params, the cache (lanes or pool, int8 scales included) and the
  LoRA slots become per-shard trees (``parallel/sharding.py``'s grid:
  heads and ffn columns over ``tensor``, Mixtral's experts over
  ``expert``), and every forward runs its layers once per shard with two
  reductions a layer.  Every head layout serves on every ``tensor``: one
  the reference's kernels split group-aligned as a contiguous split, any
  other through the head plan's replicated KV heads and zero-padded
  query heads (``ops/sharded_attention.head_plan``; Qwen2.5-7B at
  tensor=8 is 4:1 a shard), every shard's kernel call group-aligned.
  ``data`` (lanes only) gives each data group a
  whole grid and its contiguous block of ``decode_slots / data`` rows:
  row i belongs to group ``i // (decode_slots / data)`` (``_slot_group``),
  whose grid runs a bucketed or ring prefill admitted into it, its chunks
  and its rows of every decode, verify and extend step (a grouped prefill
  whose rows span groups runs one program per group; a prefill that parks
  runs on group 0 and its KV moves to its row's group at insert).
  ``fsdp`` splits every weight on its non-tensor axis, gathered a layer
  at a time on the devices that compute.  A ``sequence`` axis replicates
  them and serves ring-attention prefill (``parallel/long_context.py``):
  a prompt beyond the largest bucket runs as ONE program over the ring
  (``_ring_prefill``, padded to ``_ring_pad``) instead of
  chunk-streaming, while decode,
  bucketed prefill and chunks run on sequence group 0.  One engine thread
  drives every shard (a single controller, as the reference's GSPMD
  engine): admission, the allocator, the prefix cache, graphs,
  speculation (the draft unsharded on the first shard's device) and hops
  (a prefill's KV comes back whole, so the wire is unchanged) stay one
  copy.  Shards on one card share one CUDA graph per block; shards on
  distinct cards (their partials summed by single-process NCCL) are
  served eagerly, ``cuda_graphs=False``, as graphs across cards are
  queued.  A mesh across processes (``parallel/mesh.initialize_
  distributed``) runs one engine per process in lockstep, as the
  reference's multi-controller engine does: each holds its own shards
  and issues the same collectives in the same order, so every request is
  submitted to every process before ``start()``, sampling is greedy or
  seeded alike, and either loop (the adaptive planner and the handoff
  TTL included) runs eagerly; ``tensor``, ``expert``, ``fsdp`` and
  ``sequence`` may span processes (over ``sequence`` each process runs
  the ring on its blocks, inserts the whole prompt's K/V, exchanged,
  into its own cache and decodes on that replica), and every process
  reads back the same tokens (``parallel/multihost_check.py``).  Every
  host decision reads only state lockstep keeps the same, except the
  TTL sweep's clock: the mesh's first process decides which parked
  handoffs expire, and its verdicts reach the others by broadcast.

Same ``EngineConfig`` fields and defaults, ``SamplingParams``, ``Request``
and ``metrics_snapshot()`` keys as the reference.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import queue as queue_mod
import threading
import time
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from llm_instance_gateway_tpu_torch.models import paged as paged_lib
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.parallel import collectives, sharding
from llm_instance_gateway_tpu_torch.parallel.mesh import AXES
from llm_instance_gateway_tpu_torch.server import kv_transfer
from llm_instance_gateway_tpu_torch.server.decode_graphs import DecodeGraphs
from llm_instance_gateway_tpu_torch.server.kv_ledger import KvLedger
from llm_instance_gateway_tpu_torch.server.profiler import StepProfiler
from llm_instance_gateway_tpu_torch.server.sampling import (
    LOGPROB_TOPK,
    STOP_LEN,
    STOP_SEQS,
    encode_stop_rows,
    logprob_info,
    sample,
    stop_hist_update,
    stop_suffix_hit,
)
from llm_instance_gateway_tpu_torch.server.usage import UsageTracker, owner_key
from llm_instance_gateway_tpu_torch.tracing import LATENCY_BUCKETS, Histogram

logger = logging.getLogger(__name__)

MAX_LOGIT_BIAS = 32  # per-request logit_bias entries (static lanes)
STEP_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# The decode block's device buffers, each mirroring ``Engine._slot_<name>``:
# the carry the block advances, and the per-row parameters it reads (the
# penalty coefficients only when a row carries one).
_CARRY = ("tokens", "positions", "remaining", "stop_hist")
_SLOT_PARAMS = ("lora", "temp", "topk", "topp", "seed", "bias_ids",
                "bias_vals", "stop_ids", "stop_lens")
_PENALTY_PARAMS = ("presence", "frequency")
# The spec block's own: the draft's catch-up triple (the token and position
# the draft has not ingested after a fully accepted cycle), carried like
# the tokens, and the rows that may speculate.
_SPEC_CARRY = ("extra_tok", "extra_pos", "has_extra")
_SPEC_PARAMS = ("spec_ok",)


class EngineDraining(RuntimeError):
    """submit() refused because the engine is in graceful termination."""


@dataclass
class EngineConfig:
    decode_slots: int = 8
    max_seq_len: int = 1024
    prefill_buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024)
    max_queue: int = 256
    decode_steps_per_sync: int = 1
    adaptive_steps: int = 0
    adaptive_stream_cap: int = 1
    device_stops: bool = True
    stream_lanes: int = 1
    pipeline_decode: bool = False
    tps_ema_alpha: float = 0.2
    decode_wait_cap: int | None = None
    prefill_batch: int = 1
    handoff_ttl_s: float = 0.0
    paged_kv_block: int | None = None
    paged_kv_blocks: int | None = None
    speculative_k: int = 0
    kv_cache_quant: str | None = None
    role: str = "collocated"
    usage_attribution: bool = True
    step_profile: bool = True
    kv_ledger: bool = True
    prefix_cache: bool = False


@dataclass
class SamplingParams:
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: dict[int, float] | None = None


def _bias_arrays(sp: SamplingParams):
    ids = np.full((MAX_LOGIT_BIAS,), -1, np.int64)
    vals = np.zeros((MAX_LOGIT_BIAS,), np.float32)
    if sp.logit_bias:
        for j, (tid, bv) in enumerate(sorted(sp.logit_bias.items())):
            ids[j] = tid
            vals[j] = bv
    return ids, vals


def _seed_i32(seed: int | None) -> int:
    return -1 if seed is None else (int(seed) & 0x7FFFFFFF)


def _pack(tok, valid, lp, top_v, top_i) -> torch.Tensor:
    """One step's output rows [B, 3 + 2*LOGPROB_TOPK]: token, valid,
    logprob, top-K logprobs, top-K ids (f64 holds every id exactly)."""
    return torch.cat([tok[:, None].double(), valid[:, None].double(),
                      lp[:, None].double(), top_v.double(), top_i.double()],
                     dim=1)


def _greedy_pick(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Argmax over the real vocabulary (the padded columns masked)."""
    v = logits.shape[-1]
    if vocab < v:
        logits = torch.where(torch.arange(v, device=logits.device) < vocab,
                             logits, float("-inf"))
    return logits.argmax(dim=-1)


@dataclass
class Request:
    prompt_tokens: list[int]
    max_new_tokens: int = 64
    sampling: SamplingParams = field(default_factory=SamplingParams)
    adapter: str | None = None
    stop_token_ids: tuple[int, ...] = ()
    stop_sequences: tuple[tuple[int, ...], ...] = ()
    streaming: bool = False
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    logprobs: int | None = None
    # prefill_only() deposits the request's PrefillHandoff here
    # (finish_reason "handoff").
    handoff: object = None
    output_tokens: list[int] = field(default_factory=list)
    output_logprobs: list[float] = field(default_factory=list)
    output_top_logprobs: list[dict[int, float]] = field(default_factory=list)
    finish_reason: str | None = None
    error: str | None = None
    t_submit: float = 0.0
    t_prefill_start: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    done: threading.Event = field(default_factory=threading.Event)
    stream_event: threading.Event = field(default_factory=threading.Event)
    cancelled: threading.Event = field(default_factory=threading.Event)

    @property
    def ttft_s(self) -> float:
        return (self.t_first_token - self.t_submit) if self.t_first_token else 0.0


class PagedPoolExhausted(Exception):
    """The paged pool has no free (or evictable) block left."""


@dataclass
class _Slot:
    request: Request
    lora_slot: int
    position: int  # position of the NEXT token to generate
    # Pipelined mode: (first token, lp info) of the prefill, materialized
    # when this slot's first decode block is processed.
    pending_first: object = None


class _HostBatch:
    """One device-to-host transfer for a set of device tensors: on the card
    each is copied into pinned memory without waiting, behind one event
    on their card's stream (not the thread's current card: an engine on
    cuda:1 runs in a thread whose current card is cuda:0), and the first
    ``host()`` waits for that event alone — not for work queued after
    it, such as the next decode block."""

    __slots__ = ("_host", "_event", "_np")

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors[0].is_cuda:
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self._host = list(tensors)
        self._np = None

    def host(self) -> tuple:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = tuple(h.numpy() for h in self._host)
        return self._np


class _Row:
    """Row ``i`` of array ``a`` in a ``_HostBatch``: a numpy-protocol view
    whose first host access materializes the whole batch.  ``dev`` keeps
    the device slice for the carry scatter, which must not wait for the
    host (the pipelined loop's no-round-trip contract)."""

    __slots__ = ("_batch", "_a", "_i", "dev")

    def __init__(self, batch: _HostBatch, a: int, i: int, dev=None):
        self._batch, self._a, self._i, self.dev = batch, a, i, dev

    def _value(self):
        return self._batch.host()[self._a][self._i]

    def __array__(self, dtype=None, copy=None):
        v = np.asarray(self._value())
        return v.astype(dtype) if dtype is not None else v

    def __int__(self):
        return int(self._value())


def _host(x) -> np.ndarray:
    """A device tensor, ``_Row`` or array as a host array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class _WaitingPrefill:
    """A prefilled request parked in ``decode_wait`` (KV held off-cache)."""

    request: Request
    first_token: object  # device scalar or _Row (sync mode: emitted already)
    k: torch.Tensor  # [L, 1, bucket, K, hd]
    v: torch.Tensor
    n: int
    lora_slot: int
    first_token_host: int | None = None  # sync mode: the emitted token
    lp_info: object = None  # first token's (lp, top_v, top_i)
    # Attach: the first token already reached the request at admission, so
    # the pipelined insert must not materialize it again.
    first_emitted: bool = False
    # Imported by attach_prefilled: the insert maps cached prefix blocks
    # instead of writing them, and the TTL sweep may release it.
    from_handoff: bool = False
    t_parked: float = 0.0  # wall clock at park time (handoff imports)


@dataclass
class _ChunkStream:
    """A long prompt streaming into a RESERVED row one chunk per engine
    cycle, so active decode slots keep stepping between chunks."""

    request: Request
    slot_idx: int
    lora_slot: int
    next_start: int = 0
    last_logits: torch.Tensor | None = None


class Engine:
    def __init__(self, model_cfg: ModelConfig, params, engine_cfg=None,
                 lora_manager=None, eos_id: int | None = None,
                 dtype=torch.bfloat16, seed: int = 0, device="cuda",
                 draft_params=None, draft_cfg: ModelConfig | None = None,
                 mesh=None, cuda_graphs: bool = True):
        self.model_cfg = model_cfg
        self.cfg = engine_cfg or EngineConfig()
        self._spec = self.cfg.speculative_k > 0
        if self._spec:
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "speculative_k > 0 requires draft_params and draft_cfg")
            if draft_cfg.vocab_size != model_cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share the token space "
                    f"({draft_cfg.vocab_size} != {model_cfg.vocab_size})")
            transformer.check_supported(draft_cfg)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        if self.cfg.kv_cache_quant not in (None, "int8"):
            raise ValueError(
                f"kv_cache_quant={self.cfg.kv_cache_quant!r}: only 'int8' "
                "(or None) is supported")
        kv_quant = self.cfg.kv_cache_quant is not None
        transformer.check_supported(model_cfg)
        self.paged = self.cfg.paged_kv_block is not None
        # The shard grid (``parallel/``): params, caches and the LoRA
        # buffers become per-shard trees; one engine thread drives every
        # shard, and the host logic below stays one copy.
        self.mesh = mesh
        self.tp = self._tensor_parallel(model_cfg, mesh, cuda_graphs)
        # Every process of a mesh across processes: the TTL verdicts'
        # broadcast (``_ttl_expired``); None inside one process.
        self._lockstep = mesh.group(*AXES) if mesh is not None else None
        if self.tp is not None:
            device = self.tp.device(0)
            params = self._own_shards(params)
            if lora_manager is not None:
                lora_manager.place(self.tp)
        self.params = params
        self.lora = lora_manager
        self.eos_id = eos_id
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # Ring-attention prefill (``parallel/long_context.py``): with a
        # sequence axis, prompts beyond the largest bucket run as ONE
        # program over the ring instead of chunk-streaming, on lanes and
        # the pool alike (the insert writes the cache of group 0).
        self._ring = None
        if mesh is not None and mesh.shape.get("sequence", 1) > 1:
            from llm_instance_gateway_tpu_torch.parallel import long_context

            self._ring = long_context.make_sharded_prefill(model_cfg, mesh)
            # Pad ring prompts to this multiple (a bounded set of shapes,
            # like buckets), aligned to 8 * sequence; rounded up to a
            # multiple of sequence (the reference's value whenever
            # sequence divides it, which its ring requires).
            n_seq = mesh.shape["sequence"]
            pad = max(8 * n_seq, max(self.cfg.prefill_buckets))
            self._ring_pad = -(-pad // n_seq) * n_seq

        b = self.cfg.decode_slots
        self.prefix_reused_tokens = 0
        if self.paged:
            self._block = self.cfg.paged_kv_block
            self._max_blocks_per_seq = -(-self.cfg.max_seq_len // self._block)
            self._n_blocks = (self.cfg.paged_kv_blocks
                              if self.cfg.paged_kv_blocks is not None
                              else b * self._max_blocks_per_seq)
            self.cache = self._make_cache(
                lambda cfg, dev, rows=b: paged_lib.init_paged_cache(
                    cfg, rows, self.cfg.max_seq_len, self._n_blocks,
                    self._block, dtype=dtype, device=dev,
                    quantized=kv_quant))
            self._max_len = self._max_blocks_per_seq * self._block
            # Host-side allocator: physical blocks 1..n are allocatable;
            # block 0 is the trash block (paged_lib.TRASH_BLOCK).
            self._free_blocks: list[int] = list(range(1, self._n_blocks + 1))
            self._row_blocks: list[list[int]] = [[] for _ in range(b)]
            self._tables_host = np.zeros((b, self._max_blocks_per_seq),
                                         np.int32)
            self._tables_dirty = False
            # Prefix cache: chain hash -> block, block -> (hash, refs), and
            # an LRU of zero-ref cached blocks (evicted on demand).
            self._prefix_enabled = self.cfg.prefix_cache
            self._prefix_table: dict[bytes, int] = {}
            self._block_hash: dict[int, bytes] = {}
            self._block_refs: dict[int, int] = {}
            self._evictable: collections.OrderedDict[int, bytes] = (
                collections.OrderedDict())
            self._step_fn = paged_lib.decode_step_paged
            self._chunk_fn = paged_lib.prefill_with_cache_paged
        else:
            self._prefix_enabled = False
            self.cache = self._make_cache(
                lambda cfg, dev, rows=b: transformer.init_decode_cache(
                    cfg, rows, self.cfg.max_seq_len, dtype=dtype, device=dev,
                    quantized=kv_quant))
            self._max_len = self.cfg.max_seq_len
            self._step_fn = transformer.decode_step
            self._chunk_fn = transformer.prefill_with_cache
        self.slots: list[_Slot | None] = [None] * b
        self._slot_tokens = np.zeros((b,), np.int64)
        self._slot_positions = np.zeros((b,), np.int64)
        self._slot_lora = np.full((b,), -1, np.int64)
        self._slot_temp = np.zeros((b,), np.float32)
        self._slot_topk = np.zeros((b,), np.int64)
        self._slot_topp = np.ones((b,), np.float32)
        self._slot_seed = np.full((b,), -1, np.int64)
        self._slot_presence = np.zeros((b,), np.float32)
        self._slot_frequency = np.zeros((b,), np.float32)
        self._slot_bias_ids = np.full((b, MAX_LOGIT_BIAS), -1, np.int64)
        self._slot_bias_vals = np.zeros((b, MAX_LOGIT_BIAS), np.float32)
        self._slot_remaining = np.zeros((b,), np.int64)
        self._slot_stop_ids = np.full((b, STOP_SEQS, STOP_LEN), -1, np.int64)
        self._slot_stop_lens = np.zeros((b, STOP_SEQS), np.int64)
        self._slot_stop_hist = np.full((b, STOP_LEN), -1, np.int64)
        self._stops_active = 0
        names = _CARRY + _SLOT_PARAMS + _PENALTY_PARAMS
        if self._spec:
            # The draft's own lanes (never int8), written by its prefill at
            # admission and by the spec block; the host mirrors of its
            # catch-up triple serve the sync loop.
            self.draft_cache = transformer.init_decode_cache(
                draft_cfg, b, self.cfg.max_seq_len, dtype=dtype,
                device=self.device)
            self._slot_spec_ok = np.zeros((b,), bool)
            self._slot_extra_tok = np.zeros((b,), np.int64)
            self._slot_extra_pos = np.zeros((b,), np.int64)
            self._slot_has_extra = np.zeros((b,), bool)
            self.spec_cycles = 0
            self.spec_emitted = 0
            names += _SPEC_CARRY + _SPEC_PARAMS
        # The blocks' device buffers, at fixed addresses for their CUDA
        # graphs: the sync loop copies the host carry in before each
        # block, the pipelined loop keeps the carry on the device (rows
        # scattered in at activation); the per-row parameters are copied
        # in before every block.  ``counts`` joins them at the first
        # penalized request (``_counts``).
        self._dev = {name: torch.from_numpy(
            getattr(self, f"_slot_{name}").copy()).to(self.device)
            for name in names}
        # Pipelined loop: rows whose device budget must be zeroed before
        # the next dispatch (freed for host-side reasons), and the steps of
        # the block in flight (the host record lags it).
        self._pending_budget_zero: list[int] = []
        self._prev_dispatch_steps = 0
        self._graphs: DecodeGraphs | None = (
            DecodeGraphs(self._gen, self.device)
            if self.device.type == "cuda" and cuda_graphs else None)

        self.prefill_queue: queue_mod.Queue[Request] = queue_mod.Queue(
            maxsize=self.cfg.max_queue)
        self.decode_wait: collections.deque[_WaitingPrefill] = collections.deque()
        self._parked_kv_tokens = 0
        self._pending: Request | None = None
        self._streams: list[_ChunkStream] = []
        self._stream_rr = 0  # round-robin cursor over self._streams
        self._reserved_slots: set[int] = set()
        self._work = threading.Condition()
        self._running = False
        self._draining = False
        # Flight-recorder seam (events.py): the HTTP layer installs
        # ``EventJournal.emit`` here, signature ``(kind, **attrs)``.
        self.event_sink = None
        self._admitting = 0
        self._live: dict[str, Request] = {}
        self._thread: threading.Thread | None = None

        self._lock = threading.Lock()
        self.total_generated = 0
        self.total_requests = 0
        self.decode_tps_ema = 0.0
        self.phase_hist: dict[str, Histogram] = {
            "prefill": Histogram(LATENCY_BUCKETS),
            "handoff": Histogram(LATENCY_BUCKETS),
            "decode_step": Histogram(LATENCY_BUCKETS),
        }
        self.dispatch_steps_hist = Histogram(STEP_BUCKETS)
        self.usage: UsageTracker | None = (
            UsageTracker(b, kv_block=self._block if self.paged else 1)
            if self.cfg.usage_attribution else None)
        self.profiler: StepProfiler | None = (
            StepProfiler() if self.cfg.step_profile else None)
        # KV economy ledger (paged pool only): charged at the allocator,
        # prefix and park sites, recounted on every KV sync.
        self.kv_ledger: KvLedger | None = (
            KvLedger(self._n_blocks, self._block)
            if self.paged and self.cfg.kv_ledger else None)
        # LRU evictions since the last KV sync (journaled as one kv_evict).
        self._kv_evicts_pending = 0

    def _tensor_parallel(self, model_cfg: ModelConfig, mesh,
                         cuda_graphs: bool):
        """The engine's shard grid, a ``TensorParallel`` (None without a
        mesh), with the reference's serving rules for a mesh
        (``server/engine.py``): ``data`` (on lanes), ``fsdp``, ``tensor``,
        ``expert`` and ``sequence`` are served, ``pipe``, paged KV with
        ``data > 1`` and a ``decode_slots`` that ``data`` does not divide
        refused by name as the reference refuses them (its cache's batch
        axis is placed over ``data``, and ``jax.device_put`` raises for a
        batch it does not divide).  Every head layout is served on
        ``tensor`` (``sharding.TensorParallel``'s head plan; where the
        reference's kernels cannot split the heads group-aligned, it runs
        XLA attention and the port its kernels over padded and replicated
        heads).  A model without experts on ``expert > 1`` serves
        replicated over that axis, as GSPMD would (computed once, on
        expert 0's shards).  Shards on distinct cards are served eagerly
        only."""
        if mesh is None:
            return None
        shape = mesh.shape
        if shape.get("pipe", 1) > 1:
            raise ValueError("serving meshes must have pipe=1; fold those "
                             "devices into tensor/data instead")
        if self.paged and shape.get("data", 1) > 1:
            raise ValueError(
                "paged KV on a mesh requires data=1 (the pool replicates "
                "over fsdp/sequence and shards kv-heads over tensor): "
                "scale data-parallel replicas as separate engine processes "
                "behind the gateway")
        data = shape.get("data", 1)
        if self.cfg.decode_slots % data:
            raise ValueError(
                f"decode_slots={self.cfg.decode_slots} is not divisible by "
                f"data={data}: each data group holds an equal block of the "
                "decode rows (the reference's cache places its batch axis "
                "over data, and cannot place such a batch either)")
        if mesh.spans_processes:
            self._lockstep_rules(shape, cuda_graphs and any(
                d.type == "cuda" for d in mesh.devices))
        tp = sharding.TensorParallel(model_cfg, mesh)
        if not tp.plan.contiguous:
            logger.info("mesh %s: serving %s", dict(shape), tp.layout)
        if (cuda_graphs and not tp.one_device
                and any(d.type == "cuda" for d in tp.devices)):
            raise ValueError(
                "mesh shards on distinct cards: CUDA graphs across "
                "cards (the decode and spec blocks) are queued in "
                "ROADMAP.md; place every shard on one card, or serve "
                "eagerly (cuda_graphs=False, --no-cuda-graphs)")
        return tp

    def _own_shards(self, params):
        """``params`` cut for this engine's grid: a whole tree through
        ``sharding.shard_params``, or a ``Shards`` another engine on the
        same mesh holds, taken as it is (two engines share one copy)."""
        if not isinstance(params, sharding.Shards):
            return sharding.shard_params(params, self.tp)
        if params.tp.mesh != self.mesh or params.tp.full_cfg != self.model_cfg:
            raise ValueError("params were sharded for another mesh or "
                             "model; pass the whole tree")
        return params

    def _lockstep_rules(self, shape: dict, cuda_graphs: bool) -> None:
        """The serving rules of a mesh across processes, each refused by
        name: ``data`` (a value the host reads must be fully replicated,
        the reference's rule, and a data group's rows live on one
        process) and CUDA graphs (queued as speed work, as across cards).
        The lockstep contract stands beside them: every request submitted
        to every process before ``start()``, greedy or alike-seeded
        sampling, either loop, eager.  Both loops and the adaptive
        planner decide from the queue, the parked list, the streams and
        the slots, which that contract keeps the same on every process;
        the handoff TTL sweep reads the clock, so its verdicts come from
        the mesh's first process (``_ttl_expired``)."""
        if shape.get("data", 1) > 1:
            raise ValueError(
                f"data={shape['data']} on a mesh across processes: every "
                "value the host reads must be fully replicated, and a data "
                "group's rows would live on one process; run data-parallel "
                "replicas as separate engines")
        if cuda_graphs:
            raise ValueError(
                "CUDA graphs across processes are queued in ROADMAP.md's "
                "speed list (as across cards); serve eagerly "
                "(cuda_graphs=False, --no-cuda-graphs)")

    def _make_cache(self, make):
        """``make(cfg, device, rows)``'s cache, per shard under a mesh (a
        data group's rows under ``data``)."""
        b = self.cfg.decode_slots
        if self.tp is None:
            return make(self.model_cfg, self.device, b)
        return sharding.shard_cache(make, self.tp, rows=b)

    def _slot_group(self, slot_idx) -> int:
        """The data group of decode row ``slot_idx`` (0 without one, and
        for a prefill with no row yet)."""
        if self.tp is None or slot_idx is None:
            return 0
        return int(slot_idx) // (self.cfg.decode_slots // self.tp.d)

    # ------------------------------------------------------------------
    # device compute
    # ------------------------------------------------------------------

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return transformer.to_device(torch.as_tensor(arr, dtype=dtype),
                                     self.device)

    def _h2d(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into ``dst`` in place, queued on the stream
        without waiting for the work ahead of it (pinned memory)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _push(self, names) -> None:
        """Copy ``_slot_<name>`` into the block's device buffer, per name."""
        for name in names:
            self._h2d(self._dev[name], getattr(self, f"_slot_{name}"))

    def _prefill_impl(self, tokens, positions, true_len: int, lora_slot: int,
                      sp: SamplingParams, group: int = 0):
        """Prefill one padded prompt (on data group ``group``, its row's);
        sample the first new token."""
        logits, k, v = transformer.prefill(
            self.model_cfg, self.params, self._tensor(tokens),
            self._tensor(positions), lora_bufs=self._lora_buffers(),
            slot_ids=self._tensor([lora_slot]), data_group=group)
        logits = logits.to(self.device)
        first, lp_info = self._sample_first(logits[0, true_len - 1], sp,
                                            true_len - 1)
        return first, k, v, lp_info

    def _prefill_many_impl(self, tokens, positions, true_lens, lora_slots,
                           sps: list[SamplingParams], groups=None):
        """Prefill P padded same-bucket prompts as one program; sample each
        row's first token (the [P, bucket] form of ``_prefill_impl``, with
        per-row lengths, adapters and sampling parameters).  ``groups``
        (each row's data group) splits the rows into one program per
        group, the rows kept in order.
        Returns (first tokens [P], k, v, (lp [P], top_v, top_i))."""
        cfg = self.model_cfg
        groups = np.zeros(len(sps), np.int64) if groups is None else groups
        ids = sorted(set(groups.tolist()))
        rows = [np.nonzero(groups == g)[0] for g in ids]
        outs = [transformer.prefill(
            cfg, self.params, self._tensor(tokens[r]),
            self._tensor(positions[r]), lora_bufs=self._lora_buffers(),
            slot_ids=self._tensor(lora_slots[r]), data_group=g)
            for g, r in zip(ids, rows)]
        if len(outs) == 1:
            logits, k, v = outs[0]
        else:  # back in row order, on the engine's device
            order = self._tensor(np.argsort(np.concatenate(rows)))
            logits, k, v = (
                torch.cat([o[i].to(self.device) for o in outs], dim=min(i, 1))
                .index_select(min(i, 1), order) for i in range(3))
        logits = logits.to(self.device)
        last_pos = self._tensor(np.asarray(true_lens) - 1)
        last = logits[torch.arange(len(sps), device=self.device), last_pos]
        seeds = np.array([_seed_i32(sp.seed) for sp in sps], np.int64)
        bias_ids, bias_vals = (np.stack(a) for a in
                               zip(*(_bias_arrays(sp) for sp in sps)))
        first = sample(
            last, self._gen,
            self._tensor([sp.temperature for sp in sps], torch.float32),
            self._tensor([sp.top_k for sp in sps]),
            self._tensor([sp.top_p for sp in sps], torch.float32),
            valid_vocab=cfg.vocab_size,
            seeds=self._tensor(seeds) if (seeds >= 0).any() else None,
            positions=last_pos, bias_ids=self._tensor(bias_ids),
            bias_vals=self._tensor(bias_vals))
        return first, k, v, logprob_info(last, first, cfg.vocab_size)

    def _sample_first(self, last: torch.Tensor, sp: SamplingParams,
                      position: int):
        """Sample a prompt's first new token from its last logits [V].
        Returns (token device scalar, (logprob, top-K values, top-K ids))."""
        last = last[None]
        seed = _seed_i32(sp.seed)
        bias_ids, bias_vals = _bias_arrays(sp)
        first = sample(
            last, self._gen, self._tensor([sp.temperature], torch.float32),
            self._tensor([sp.top_k]), self._tensor([sp.top_p], torch.float32),
            valid_vocab=self.model_cfg.vocab_size,
            seeds=self._tensor([seed]) if seed >= 0 else None,
            positions=self._tensor([position]),
            bias_ids=self._tensor(bias_ids[None]),
            bias_vals=self._tensor(bias_vals[None]))
        lp, top_v, top_i = logprob_info(last, first, self.model_cfg.vocab_size)
        return first[0], (lp[0], top_v[0], top_i[0])

    @staticmethod
    def _host_rows(first_token: torch.Tensor, lp_info):
        """A single prefill's first token and lp info as ``_Row`` views of
        one transfer started now (pipelined mode: no wait here)."""
        hb = _HostBatch(first_token[None], *(x[None] for x in lp_info))
        return (_Row(hb, 0, 0, dev=first_token),
                tuple(_Row(hb, a, 0) for a in (1, 2, 3)))

    def _decode_block(self, n_steps: int, seeded: bool,
                      penalized: bool = False) -> torch.Tensor:
        """``n_steps`` fused decode+sample steps with the device-side freeze,
        on the block's device buffers (``self._dev``): it reads the carry
        and the per-row parameters there and writes the advanced carry
        back in place, so a CUDA graph of it replays on whatever the
        buffers hold.  ``seeded`` adds the per-row seeded noise;
        ``penalized`` subtracts the presence and frequency penalties from
        the logits (before the argmax, the draw and the logprobs) and
        counts every emitted token into ``counts``, in place.

        Each row carries a ``remaining`` budget; a row is frozen once it
        reaches 0 (budget spent, EOS, or a completed stop suffix): frozen
        rows write no KV, keep their position and emit ``valid=False``
        steps.  Returns the output pack [n_steps, B, 3 + 2*LOGPROB_TOPK]
        (token, valid, logprob, top-K values, top-K ids) on the device."""
        cfg = self.model_cfg
        d = self._dev
        max_len = self._max_len
        tokens, positions = d["tokens"], d["positions"]
        remaining, hist = d["remaining"], d["stop_hist"]
        seeds = d["seed"] if seeded else None
        eos = -1 if self.eos_id is None else self.eos_id
        lora_bufs = self._lora_buffers()
        counts = d["counts"] if penalized else None
        steps = []
        for _ in range(n_steps):
            active = remaining > 0
            safe_pos = positions.clamp(max=max_len - 1)
            logits, self.cache = self._step_fn(
                cfg, self.params, self.cache, tokens, safe_pos,
                lora_bufs=lora_bufs, slot_ids=d["lora"], active=active)
            if penalized:
                logits = logits - (d["presence"][:, None] * (counts > 0)
                                   + d["frequency"][:, None] * counts)
            sampled = sample(logits, self._gen, d["temp"], d["topk"],
                             d["topp"], valid_vocab=cfg.vocab_size,
                             seeds=seeds, positions=safe_pos,
                             bias_ids=d["bias_ids"],
                             bias_vals=d["bias_vals"]).long()
            lp, top_v, top_i = logprob_info(logits, sampled, cfg.vocab_size)
            valid = active
            hit_eos = valid & (sampled == eos)
            hist = stop_hist_update(hist, sampled, valid)
            hit_stop = valid & stop_suffix_hit(hist, d["stop_ids"],
                                               d["stop_lens"])
            remaining = torch.where(valid, remaining - 1, remaining)
            remaining = torch.where(hit_eos | hit_stop, 0, remaining)
            tokens = torch.where(active, sampled, tokens)
            positions = positions + active.long()
            if penalized:
                counts.scatter_add_(1, sampled[:, None],
                                    valid[:, None].to(counts.dtype))
            steps.append(_pack(sampled, valid, lp, top_v, top_i))
        for name, value in zip(_CARRY, (tokens, positions, remaining, hist)):
            d[name].copy_(value)
        return torch.stack(steps)

    def _run_block(self, n_steps: int) -> torch.Tensor:
        """Copy the per-row parameters in and run one block: a graph
        replay on the card (its output valid until the next replay), else
        the eager block.  The penalized variant runs while some
        row carries a penalty."""
        seeded = bool((self._slot_seed >= 0).any())
        penalized = bool(self._slot_presence.any()
                         or self._slot_frequency.any())
        self._push(_SLOT_PARAMS + (_PENALTY_PARAMS if penalized else ()))
        if penalized:
            self._counts()
        if self._graphs is not None:
            return self._graphs.run(self._decode_block, n_steps, seeded,
                                    penalized)
        return self._decode_block(n_steps, seeded, penalized)

    def _counts(self) -> torch.Tensor:
        """[B, V_padded] int32 generated-token counts, made on first need
        (penalty-free serving never holds them) and kept at one address."""
        if "counts" not in self._dev:
            params = sharding.parts(self.params)[0]  # whole embed, head
            if self.model_cfg.tie_embeddings:
                v = params["embed"].shape[0]
            else:
                head = params["lm_head"]
                if isinstance(head, dict):  # an int8 {"q", "s"} leaf
                    head = head["q"]
                v = head.shape[-1]
            self._dev["counts"] = torch.zeros(
                (self.cfg.decode_slots, int(v)), dtype=torch.int32,
                device=self.device)
        return self._dev["counts"]

    def _count_first_token(self, slot_idx: int, tok) -> None:
        """A penalized row counts its prefill-sampled first token too
        (penalties apply from the first decode step).  ``tok`` is a host
        int or a device scalar (never read back here)."""
        if not (self._slot_presence[slot_idx]
                or self._slot_frequency[slot_idx]):
            return
        row = self._counts()[slot_idx]
        if isinstance(tok, torch.Tensor):
            row.index_add_(0, tok.reshape(1).long(),
                           torch.ones(1, dtype=row.dtype, device=row.device))
        else:
            row[int(tok)] += 1

    # -- speculative decoding (the draft proposes, the target verifies) --

    def _spec_block(self, n_cycles: int, k_steps: int,
                    seeded: bool) -> torch.Tensor:
        """``n_cycles`` fused speculative cycles on the device buffers
        (``self._dev``, the draft's catch-up triple included), both caches
        updated in place, the carry written back: a CUDA graph of it
        replays like the decode block's.

        Each cycle: the draft ingests the <= 2 context tokens it has not
        seen (``extend_step``), proposes ``k_steps`` greedy tokens (the
        first from that step, the rest by ``decode_step``), and the target
        scores [cur, d_1..d_K] in one ``extend_step`` (``extend_step_paged``
        on the pool), writing only for active rows.  Greedy rows accept the
        longest matching prefix plus the target's next token; sampled and
        non-speculating rows emit one token drawn from the first position's
        logits.  Budget and EOS truncation are mask arithmetic.  The draft
        runs without LoRA.  The draft's and the verify's ops run inside
        profiler ranges (``spec_draft``, ``spec_verify``), so a trace of the
        eager block splits a cycle's device time between them.

        Stale KV: a cycle writes positions p..p+K, past the accepted
        prefix too; the next cycle's writes start at the corrected position
        and cover that range, for the draft's lanes, the target's lanes
        and the pool alike (the engine allocates the whole span a dispatch
        can write first, ``_spec_row_steps``).

        Returns the output pack [n_cycles * (K+1), B, 3 + 2*LOGPROB_TOPK],
        cycle-major, the decode block's layout."""
        cfg, dcfg = self.model_cfg, self.draft_cfg
        d = self._dev
        s_max = self._max_len
        target_extend = (paged_lib.extend_step_paged if self.paged
                         else transformer.extend_step)
        kp1 = k_steps + 1
        tokens, positions = d["tokens"], d["positions"]
        remaining = d["remaining"]
        extra_tok, extra_pos = d["extra_tok"], d["extra_pos"]
        has_extra = d["has_extra"]
        temp = d["temp"]
        seeds = d["seed"] if seeded else None
        eos = -1 if self.eos_id is None else self.eos_id
        lora_bufs = self._lora_buffers()
        b = tokens.shape[0]
        rows = torch.arange(b, device=tokens.device)
        ahead = torch.arange(kp1, device=tokens.device)[None]
        greedy_row = d["spec_ok"] & (temp <= 0.0)
        cycles = []
        for _ in range(n_cycles):
            active = remaining > 0
            safe_pos = positions.clamp(max=s_max - 1)
            # -- the draft catches up and proposes --
            with record_function("spec_draft"):
                ctx_tokens = torch.stack(
                    [torch.where(has_extra, extra_tok, tokens), tokens], dim=1)
                ctx_positions = torch.stack(
                    [torch.where(has_extra, extra_pos.clamp(max=s_max - 1),
                                 safe_pos),
                     torch.where(has_extra, safe_pos,
                                 (positions + 1).clamp(max=s_max - 1))],
                    dim=1)
                last_idx = has_extra.long()  # the last real context column
                logits2, _ = transformer.extend_step(
                    dcfg, self.draft_params, self.draft_cache, ctx_tokens,
                    ctx_positions)
                tok = _greedy_pick(logits2[rows, last_idx], dcfg.vocab_size)
                pos = (ctx_positions[rows, last_idx] + 1).clamp(max=s_max - 1)
                proposals = [tok]
                for _ in range(k_steps - 1):
                    lg, _ = transformer.decode_step(
                        dcfg, self.draft_params, self.draft_cache, tok, pos)
                    tok = _greedy_pick(lg, dcfg.vocab_size)
                    proposals.append(tok)
                    pos = (pos + 1).clamp(max=s_max - 1)
                draft = torch.stack(proposals, dim=1)  # [B, K]
            # -- the target verifies [cur, d_1..d_K] in one forward --
            with record_function("spec_verify"):
                vtokens = torch.cat([tokens[:, None], draft], dim=1)
                vpos = (positions[:, None] + ahead).clamp(max=s_max - 1)
                logits, self.cache = target_extend(
                    cfg, self.params, self.cache, vtokens, vpos,
                    lora_bufs=lora_bufs, slot_ids=d["lora"], active=active)
            greedy = _greedy_pick(logits, cfg.vocab_size)  # [B, K+1]
            first_sampled = sample(
                logits[:, 0], self._gen, temp, d["topk"], d["topp"],
                valid_vocab=cfg.vocab_size, seeds=seeds,
                positions=safe_pos).long()
            e0 = torch.where(greedy_row, greedy[:, 0], first_sampled)
            match = (draft == greedy[:, :-1]) & greedy_row[:, None]
            m = torch.cumprod(match.long(), dim=1).sum(dim=1)
            count = torch.where(greedy_row, m + 1, 1)
            emitted = torch.cat([e0[:, None], greedy[:, 1:]], dim=1)
            lp, top_v, top_i = logprob_info(logits, emitted, cfg.vocab_size)
            # -- truncation: frozen rows, budget, EOS --
            count = torch.where(active, torch.minimum(count, remaining), 0)
            iseos = (emitted == eos).long()
            before_eos = torch.cumsum(iseos, dim=1) - iseos
            valid = (ahead < count[:, None]) & (before_eos == 0)
            eff = valid.sum(dim=1)
            hit_eos = (valid & (iseos > 0)).any(dim=1)
            # -- the carry --
            new_tok = torch.where(
                eff > 0, emitted[rows, (eff - 1).clamp(min=0)], tokens)
            # A fully accepted cycle leaves d_K's KV out of the draft's
            # lane: the next cycle's catch-up ingests it.
            full = greedy_row & active & (eff == kp1) & ~hit_eos
            extra_tok = torch.where(full, draft[:, k_steps - 1], extra_tok)
            extra_pos = torch.where(full, positions + k_steps, extra_pos)
            has_extra = full
            remaining = torch.where(hit_eos, 0, remaining - eff)
            positions = positions + eff
            tokens = new_tok
            cycles.append(torch.stack(
                [_pack(emitted[:, j], valid[:, j], lp[:, j], top_v[:, j],
                       top_i[:, j]) for j in range(kp1)]))
        for name, value in zip(
                ("tokens", "positions", "remaining") + _SPEC_CARRY,
                (tokens, positions, remaining, extra_tok, extra_pos,
                 has_extra)):
            d[name].copy_(value)
        return torch.cat(cycles)

    def _run_spec_block(self, n_cycles: int) -> torch.Tensor:
        """``_run_block`` for the spec block: parameters in, then a graph
        replay on the card or else the eager block."""
        k = self.cfg.speculative_k
        seeded = bool((self._slot_seed >= 0).any())
        self._push(_SLOT_PARAMS + _SPEC_PARAMS)
        if self._graphs is not None:
            return self._graphs.run(self._spec_block, n_cycles, k, seeded,
                                    kind="spec")
        return self._spec_block(n_cycles, k, seeded)

    def _spec_dispatch_ok(self) -> bool:
        """A spec block serves the batch when no row runs the stop automata
        (only plain blocks evaluate them) and some row may accept
        proposals; otherwise speculation would only add the draft and the
        verify to every token."""
        return self._spec and not self._stops_active and any(
            s is not None and self._slot_spec_ok[i]
            and self._slot_temp[i] <= 0.0
            for i, s in enumerate(self.slots))

    def _draft_admit(self, slot_idx: int, prompt_tokens: list[int]) -> None:
        """Mirror a freshly admitted prompt into the draft's lane so the
        row can speculate.  Sampled rows, stop-sequence rows and prompts
        beyond the largest bucket (chunk-streamed) do not."""
        if not self._spec:
            return
        n = len(prompt_tokens)
        slot = self.slots[slot_idx]
        if (n > self._max_bucket() or self._slot_temp[slot_idx] > 0.0
                or (slot is not None and slot.request.stop_sequences)):
            self._slot_spec_ok[slot_idx] = False
            return
        try:
            bucket = self._bucket(n)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = prompt_tokens
            positions = np.zeros((1, bucket), np.int64)
            positions[0, :n] = np.arange(n)
            _, k, v = transformer.prefill(
                self.draft_cfg, self.draft_params, self._tensor(tokens),
                self._tensor(positions))
            transformer.insert_prefill(self.draft_cache, k, v, slot_idx, n)
            self._slot_spec_ok[slot_idx] = True
            self._slot_has_extra[slot_idx] = False
            if self.cfg.pipeline_decode:
                self._dev["has_extra"][slot_idx] = False
        except Exception:
            logger.exception("draft admit failed; slot %d decodes "
                             "non-speculatively", slot_idx)
            self._slot_spec_ok[slot_idx] = False

    def _spec_cycles_per_sync(self) -> int:
        """Cycles per spec dispatch: ceil(steps / (K+1)) when every row
        speculates (the token cadence of ``steps`` plain steps), ``steps``
        when some row emits one token a cycle (sampled or not
        speculating), so it keeps its cadence while greedy rows run ahead
        (budgets cap them).  ``steps`` is the planner's choice."""
        steps = self._plan_steps()
        mixed = any(
            s is not None
            and not (self._slot_spec_ok[i] and self._slot_temp[i] <= 0.0)
            for i, s in enumerate(self.slots))
        if mixed:
            return steps
        return max(1, -(-steps // (self.cfg.speculative_k + 1)))

    def _spec_row_steps(self, n_cycles: int, k: int) -> list[int]:
        """Per-row pool write frontier of one spec block: K+1 a cycle for
        a speculating row; one a cycle for the others, whose verify still
        writes a K-token tail."""
        return [n_cycles * (k + 1)
                if self._slot_spec_ok[i] and self._slot_temp[i] <= 0.0
                else n_cycles + k + 1
                for i in range(self.cfg.decode_slots)]

    def _decode_impl(self, n_steps: int) -> np.ndarray:
        """The sync loop's block: the host carry in, one block, the output
        pack back to the host — the dispatch's one device-to-host read."""
        self._sync_stop_hist()
        self._push(_CARRY)
        return self._run_block(n_steps).cpu().numpy()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Start the engine thread: the pipelined loop with
        ``pipeline_decode``, else the sync one.  On the card the thread
        first warms the decode block up (and the spec block, on a
        speculative engine) with every row inactive, and this returns once
        it has, or raises what it raised."""
        self._running = True
        target = (self._loop_pipelined if self.cfg.pipeline_decode
                  else self._loop)
        ready = threading.Event()
        failed: list[BaseException] = []

        def run():
            with torch.no_grad():
                try:
                    if self._graphs is not None:
                        self._graphs.warm_up(self._decode_block)
                        if self._spec:
                            self._graphs.warm_up(
                                self._spec_block, 1,
                                self.cfg.speculative_k, True)
                except BaseException as e:
                    failed.append(e)
                    return
                finally:
                    ready.set()
                target()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        ready.wait()
        if failed:
            self._running = False
            raise RuntimeError("decode block warm-up failed") from failed[0]

    def stop(self) -> None:
        self._running = False
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                logger.error("engine loop thread still alive after 30s join")
                return
        stragglers: list[Request] = []
        if self._pending is not None:
            stragglers.append(self._pending)
            self._pending = None
        while True:
            try:
                stragglers.append(self.prefill_queue.get_nowait())
            except queue_mod.Empty:
                break
        while self.decode_wait:
            w = self.decode_wait.popleft()
            self._parked_kv_tokens -= w.k.shape[2]
            stragglers.append(w.request)
        while self._streams:
            stragglers.append(self._streams.pop().request)
        stragglers += [s.request for s in self.slots if s is not None]
        for req in stragglers:
            if not req.done.is_set():
                req.error = req.error or "engine stopped"
                self._finish(req, "error")

    def _plan_steps(self) -> int:
        """Fused decode steps for the next dispatch (the adaptive planner):
        static ``decode_steps_per_sync`` when ``adaptive_steps`` <= 0, else
        1 under admission pressure (queued prompts, a parked insert with a
        free slot, an in-flight chunk stream), capped by the minimum remaining
        budget (pipelined: less the block in flight, which the host record
        lags) and by ``adaptive_stream_cap`` for SSE rows, rounded down to a
        power of two: one graph per power of two."""
        ceiling = self.cfg.adaptive_steps
        if ceiling <= 0:
            return max(1, self.cfg.decode_steps_per_sync)
        if (self._streams or self._pending is not None
                or not self.prefill_queue.empty()
                or (self.decode_wait
                    and self._free_slot_index() is not None)):
            return 1
        n = max(1, ceiling)
        inflight = (self._prev_dispatch_steps if self.cfg.pipeline_decode
                    else 0)
        for s in self.slots:
            if s is None:
                continue
            req = s.request
            if req.streaming:
                n = min(n, max(1, self.cfg.adaptive_stream_cap))
            rem = req.max_new_tokens - len(req.output_tokens) - inflight
            n = min(n, max(1, rem))
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _sync_stop_hist(self) -> np.ndarray:
        """Each stop-lane row's last STOP_LEN emitted tokens (right-aligned,
        -1 padded), rebuilt from the host record per dispatch."""
        hist = self._slot_stop_hist
        if not self._stops_active:
            return hist
        hist[:] = -1
        for i, s in enumerate(self.slots):
            if s is None or not self._slot_stop_lens[i].any():
                continue
            tail = s.request.output_tokens[-STOP_LEN:]
            if tail:
                hist[i, STOP_LEN - len(tail):] = tail
        return hist

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting; wait until every request reached a terminal state."""
        self._draining = True
        if self.event_sink is not None:
            try:
                # The replica is leaving the routable set.
                self.event_sink("role_change", role=self.cfg.role,
                                draining=True)
            except Exception:
                logger.exception("event sink failed on drain")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            snap = self.metrics_snapshot()
            if (snap["num_requests_running"] == 0
                    and snap["num_requests_waiting"] == 0):
                return True
            time.sleep(0.02)
        return False

    @property
    def draining(self) -> bool:
        return self._draining

    def _validate(self, request: Request) -> None:
        sp = request.sampling
        if self._spec and (sp.presence_penalty or sp.frequency_penalty
                           or sp.logit_bias):
            raise ValueError(
                "presence/frequency penalties and logit_bias are not "
                "supported on a speculative engine (the verify block's "
                "greedy pick bypasses the sampling seam); disable "
                "speculative_k or the parameter")
        if sp.logit_bias:
            if len(sp.logit_bias) > MAX_LOGIT_BIAS:
                raise ValueError(
                    f"logit_bias supports at most {MAX_LOGIT_BIAS} entries")
            for tid in sp.logit_bias:
                if not 0 <= tid < self.model_cfg.vocab_size:
                    raise ValueError(
                        f"logit_bias token id {tid} is outside the "
                        f"vocabulary [0, {self.model_cfg.vocab_size})")
        for seq in request.stop_sequences:
            if not seq:
                raise ValueError("stop_sequences entries must be non-empty")
            for tid in seq:
                if not 0 <= int(tid) < self.model_cfg.vocab_size:
                    raise ValueError(
                        f"stop sequence token id {tid} is outside the "
                        f"vocabulary [0, {self.model_cfg.vocab_size})")
        n = len(request.prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.cfg.max_seq_len:
            raise ValueError(f"prompt length {n} exceeds max_seq_len "
                             f"{self.cfg.max_seq_len}")
        if self.paged and self._paged_needed(n + 1) > self._n_blocks:
            # Larger than the ENTIRE pool: admission could never succeed
            # and the request would head-of-line block the engine forever.
            raise ValueError(
                f"prompt needs {self._paged_needed(n + 1)} KV blocks but the "
                f"pool has {self._n_blocks}")
        if self._max_bucket() <= 0:
            raise ValueError(
                f"no usable prefill bucket <= max_seq_len "
                f"{self.cfg.max_seq_len}: {self.cfg.prefill_buckets}")

    def submit(self, request: Request) -> Request:
        """Enqueue; raises queue.Full when saturated."""
        if self._draining:
            raise EngineDraining("engine is draining (graceful termination)")
        self._validate(request)
        request.t_submit = time.time()
        if request.adapter is not None and self.lora is not None:
            self.lora.acquire(request.adapter)
        try:
            self.prefill_queue.put_nowait(request)
        except queue_mod.Full:
            if request.adapter is not None and self.lora is not None:
                self.lora.release(request.adapter)
            raise
        with self._lock:
            self.total_requests += 1
            self._live[request.request_id] = request
        with self._work:
            self._work.notify()
        return request

    def generate(self, request: Request, timeout_s: float = 600.0) -> Request:
        """Submit and block until completion."""
        self.submit(request)
        if not request.done.wait(timeout_s):
            request.error = "generation timed out"
            request.cancelled.set()
        return request

    def release_request(self, request_id: str) -> bool:
        """Best-effort cancel of a live request by id."""
        with self._lock:
            req = self._live.get(request_id)
        if req is None or req.done.is_set():
            return False
        req.cancelled.set()
        if self.event_sink is not None:
            self.event_sink("kv_release", request_id=request_id)
        with self._work:
            self._work.notify()
        return True

    # -- disaggregation (server/kv_transfer.py) --

    def prefill_only(self, request: Request, timeout_s: float = 600.0,
                     quantize: str | None = None):
        """Run ONLY the prefill and return a ``PrefillHandoff`` (hop 1 of
        disaggregated serving).  No decode slot, no cache lane, no pool
        block is touched: a prefill-role replica serves these whatever its
        decode occupancy.  The wire lane defaults to int8 on an int8-KV
        engine (the decode side re-quantizes to the identical values) and
        to the raw compute dtype otherwise.  Prompts beyond the largest
        bucket are refused: the chunk stream writes into THIS engine's
        cache, which is what a handoff exists to avoid."""
        n = len(request.prompt_tokens)
        if self._max_bucket() <= 0 or n > self._max_bucket():
            raise ValueError(
                f"prefill_only supports prompts within the largest bucket "
                f"({self._max_bucket()}); got {n} tokens")
        request._handoff_only = True
        request._handoff_quantize = (
            quantize if quantize is not None else self.cfg.kv_cache_quant)
        self.submit(request)
        if not request.done.wait(timeout_s):
            request.error = "prefill timed out"
            request.cancelled.set()
        if request.error:
            raise RuntimeError(request.error)
        return request.handoff

    def attach_prefilled(self, handoff) -> Request:
        """Admit a ``PrefillHandoff`` into decode (hop 2): its KV imports
        into this engine's cache and the request decodes from its carried
        first token, with no prefill.  Returns the live ``Request`` (already
        submitted); callers wait on ``done`` / ``stream_event`` as after
        ``submit``.  A handoff that does not fit this engine fails here,
        visible to the caller, not inside the engine loop."""
        request = kv_transfer.make_request(handoff)
        if handoff.n != len(request.prompt_tokens) or handoff.n <= 0:
            raise ValueError("handoff length/prompt mismatch")
        cfg = self.model_cfg
        expect = (cfg.n_layers, handoff.n, cfg.n_kv_heads,
                  cfg.resolved_head_dim)
        if (tuple(handoff.k.shape) != expect
                or tuple(handoff.v.shape) != expect):
            raise ValueError(
                f"handoff KV shape {tuple(handoff.k.shape)} does not match "
                f"this engine's cache layout {expect}")
        if handoff.kv_format == "int8":
            for s in (handoff.k_scale, handoff.v_scale):
                if s is None or tuple(s.shape) != expect[:-1]:
                    raise ValueError("int8 handoff lacks scales of shape "
                                     f"{expect[:-1]}")
        elif handoff.kv_format != "raw":
            raise ValueError(f"unknown handoff kv_format "
                             f"{handoff.kv_format!r}")
        request._attach_handoff = handoff
        return self.submit(request)  # draining, validation, adapter pin

    def observe_handoff(self, seconds: float) -> None:
        """Record one handoff-plane operation (serialize on the prefill
        side; deserialize + attach admission on the decode side) into
        ``tpu:handoff_seconds``.  Called from the HTTP layer."""
        with self._lock:
            self.phase_hist["handoff"].observe(max(0.0, seconds))

    # ------------------------------------------------------------------
    # metrics snapshot (the scrape contract)
    # ------------------------------------------------------------------

    def _adapter_activity(self) -> tuple[list[str], list[str]]:
        running: set[str] = set()
        waiting: set[str] = set()
        for s in self.slots:
            if s is not None and s.request.adapter:
                running.add(s.request.adapter)
        for stream in list(self._streams):
            if stream.request.adapter:
                running.add(stream.request.adapter)
        try:
            for w in list(self.decode_wait):
                if w.request.adapter:
                    waiting.add(w.request.adapter)
        except RuntimeError:  # deque mutated during the scrape-side walk
            pass
        pending = self._pending
        if pending is not None and pending.adapter:
            waiting.add(pending.adapter)
        return sorted(running), sorted(waiting)

    def metrics_snapshot(self) -> dict:
        active = sum(1 for s in self.slots if s is not None)
        if self.paged:
            # vLLM gpu_cache_usage_perc: allocated / total blocks.  Zero-ref
            # cached prefix blocks are reclaimable on demand, so they count
            # as free for routing pressure.
            capacity = self._n_blocks * self._block
            used_tokens = (self._n_blocks - len(self._free_blocks)
                           - len(self._evictable)) * self._block
        else:
            used_tokens = sum(
                s.position for s in self.slots if s is not None) + sum(
                st.next_start for st in list(self._streams))
            capacity = self.cfg.decode_slots * self.cfg.max_seq_len
        parked = self._parked_kv_tokens
        used_tokens += parked
        with self._lock:
            tps = self.decode_tps_ema
            phase_hist = {k: h.state() for k, h in self.phase_hist.items()}
            steps_hist = self.dispatch_steps_hist.state()
        running_adapters, waiting_adapters = self._adapter_activity()
        # In-flight chunk streams count as prefilling.
        prefill_depth = (self.prefill_queue.qsize()
                         + (1 if self._pending is not None else 0)
                         + len(self._streams) + self._admitting)
        decode_depth = len(self.decode_wait)
        residency = {}
        if self.lora is not None:
            transitions, load_seconds = self.lora.residency_counters()
            residency = {"residency": self.lora.residency_snapshot(),
                         "tier_transitions": transitions,
                         "adapter_load_seconds": load_seconds}
        return {
            "pool_role": self.cfg.role,
            "prefill_queue_size": prefill_depth,
            "decode_queue_size": decode_depth,
            "num_requests_running": active,
            "num_requests_waiting": prefill_depth + decode_depth,
            "kv_cache_usage_perc": used_tokens / capacity if capacity else 0.0,
            "kv_tokens_capacity": capacity,
            "kv_tokens_free": max(0, capacity - used_tokens),
            "kv_parked_tokens": parked,
            "decode_tokens_per_sec": tps,
            "running_lora_adapters": running_adapters,
            "waiting_lora_adapters": waiting_adapters,
            "max_lora": self.lora.max_slots if self.lora else 0,
            "adapter_ranks": self.lora.adapter_ranks() if self.lora else {},
            **residency,
            "dispatch_steps_hist": steps_hist,
            "stream_lanes": max(1, self.cfg.stream_lanes),
            "stream_lanes_active": len(self._streams),
            "phase_hist": phase_hist,
            **({"usage": self.usage.snapshot()}
               if self.usage is not None else {}),
            **({"profile": self.profiler.hist_state()}
               if self.profiler is not None else {}),
            **({"kv_ledger": self._kv_ledger_synced_snapshot()}
               if self.kv_ledger is not None else {}),
            **({"prefix_reused_tokens": self.prefix_reused_tokens}
               if self._prefix_enabled else {}),
            **({
                "spec_cycles": self.spec_cycles,
                # Accepted tokens per verify cycle against the K+1
                # ceiling: the draft's quality.
                "spec_tokens_per_cycle": round(
                    self.spec_emitted / self.spec_cycles, 3)
                if self.spec_cycles else 0.0,
            } if self._spec else {}),
        }

    def _kv_ledger_synced_snapshot(self) -> dict:
        """The ledger's payload, recounted first so a scrape between
        dispatches sees current block states."""
        self._kv_ledger_sync()
        return self.kv_ledger.snapshot()

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------

    def _free_slot_index(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None and i not in self._reserved_slots:
                return i
        return None

    def _clear_slot(self, i: int) -> None:
        """Release a decode row (and, when paged, its pool blocks)."""
        self.slots[i] = None
        if self._spec:
            self._slot_spec_ok[i] = False
            self._slot_has_extra[i] = False
        self._slot_lora[i] = -1
        self._slot_remaining[i] = 0
        if self._slot_stop_lens[i].any():
            self._slot_stop_ids[i] = -1
            self._slot_stop_lens[i] = 0
            self._slot_stop_hist[i] = -1
            self._stops_active = int(
                (self._slot_stop_lens.sum(axis=1) > 0).sum())
        self._slot_seed[i] = -1
        self._slot_presence[i] = 0.0
        self._slot_frequency[i] = 0.0
        self._slot_bias_ids[i] = -1
        self._slot_bias_vals[i] = 0.0
        if self.paged:
            self._paged_free_row(i)

    # -- paged-pool allocator (host side; the device sees table contents) --

    def _paged_needed(self, upto_len: int) -> int:
        return min(-(-upto_len // self._block), self._max_blocks_per_seq)

    def _paged_can_admit(self, n_prompt: int,
                         prompt: list[int] | None = None,
                         adapter: str | None = None,
                         hashes: list[bytes] | None = None) -> bool:
        """Capacity gate.  With ``prompt`` given, cached-prefix blocks that
        would map at zero cost come off the need — but a matched block
        sitting zero-ref in the evictable LRU gets PINNED by the map, so it
        cannot count toward the available blocks too."""
        if not self.paged:
            return True
        avail = len(self._free_blocks) + (
            len(self._evictable) if self._prefix_enabled else 0)
        needed = self._paged_needed(n_prompt + 1)
        if needed <= avail:
            return True
        if prompt is None:
            return False
        matched = self._prefix_match_blocks(prompt, adapter, hashes)
        reuse_needed = needed - min(len(matched), needed)
        reuse_avail = avail - sum(1 for b in matched if b in self._evictable)
        return reuse_needed <= reuse_avail

    def _paged_alloc_block(self) -> int:
        """One free physical block, evicting the LRU zero-ref cached block
        when the free list is dry.  Raises ``PagedPoolExhausted``."""
        if self._free_blocks:
            blk = self._free_blocks.pop()
            if self.kv_ledger is not None:
                self.kv_ledger.note_alloc()
            return blk
        if self._prefix_enabled and self._evictable:
            blk, h = self._evictable.popitem(last=False)  # LRU
            self._prefix_table.pop(h, None)
            self._block_hash.pop(blk, None)
            self._block_refs.pop(blk, None)
            if self.kv_ledger is not None:
                self.kv_ledger.note_evict(h.hex()[:16])
                self.kv_ledger.note_alloc()
                self._kv_evicts_pending += 1
            return blk
        raise PagedPoolExhausted(
            f"kv pool exhausted: {self._n_blocks} blocks of {self._block} "
            "tokens all allocated")

    def _paged_ensure(self, row: int, upto_len: int) -> None:
        """Grow ``row``'s table to cover positions < upto_len.  Raises
        ``PagedPoolExhausted``, leaving the row's blocks intact."""
        blocks = self._row_blocks[row]
        needed = self._paged_needed(upto_len)
        while len(blocks) < needed:
            blk = self._paged_alloc_block()
            blocks.append(blk)
            self._tables_host[row, len(blocks) - 1] = blk
            self._tables_dirty = True

    def _paged_free_row(self, row: int) -> None:
        blocks = self._row_blocks[row]
        if not blocks:
            return
        freed = cached = 0
        for blk in blocks:
            h = self._block_hash.get(blk)
            if h is None:
                self._free_blocks.append(blk)
                freed += 1
            else:
                # Cached prefix block: drop this row's reference; at zero
                # it parks in the evictable LRU (content kept).
                self._block_refs[blk] -= 1
                if self._block_refs[blk] == 0:
                    self._evictable[blk] = h  # fresh key -> MRU end
                    cached += 1
        if self.kv_ledger is not None:
            self.kv_ledger.note_release(freed, cached)
        self._row_blocks[row] = []
        self._tables_host[row, :] = paged_lib.TRASH_BLOCK
        self._tables_dirty = True

    # -- prefix cache (content-addressed full prompt blocks) --

    def _prefix_hashes(self, prompt: list[int], max_blocks: int,
                       adapter: str | None) -> list[bytes]:
        """Chained SHA-256 digests of the first ``max_blocks`` full prompt
        blocks, seeded with the adapter identity (KV depends on the
        adapter's k/v deltas).  Cryptographic, not ``hash()``: a collision
        would map another prompt's KV into this request."""
        bs = self._block
        h = hashlib.sha256(repr(adapter).encode()).digest()
        out = []
        for i in range(max_blocks):
            h = hashlib.sha256(
                h + np.asarray(prompt[i * bs:(i + 1) * bs], np.int64).tobytes()
            ).digest()
            out.append(h)
        return out

    def _prefix_hashes_for(self, req: Request) -> list[bytes]:
        """The request's hash chain, memoized: backpressured admission
        re-checks the same pending request every engine cycle."""
        memo = getattr(req, "_prefix_hash_memo", None)
        if memo is None:
            memo = self._prefix_hashes(
                req.prompt_tokens,
                (len(req.prompt_tokens) - 1) // self._block, req.adapter)
            req._prefix_hash_memo = memo
        return memo

    def _prefix_match_blocks(self, prompt: list[int], adapter: str | None,
                             hashes: list[bytes] | None = None) -> list[int]:
        """Dry run of the hash walk: the blocks that would map (no incref)."""
        if not self._prefix_enabled:
            return []
        if hashes is None:
            hashes = self._prefix_hashes(
                prompt, (len(prompt) - 1) // self._block, adapter)
        out = []
        for h in hashes:
            blk = self._prefix_table.get(h)
            if blk is None:
                break
            out.append(blk)
        return out

    def _prefix_match_and_map(self, row: int, prompt: list[int],
                              adapter: str | None,
                              hashes: list[bytes] | None = None) -> int:
        """Map the longest cached prefix into ``row``'s table (increfs).
        Returns the reused TOKENS (a multiple of the block size); the
        prompt's last token always recomputes, for fresh logits."""
        if not self._prefix_enabled:
            return 0
        blocks = self._row_blocks[row]
        assert not blocks, "prefix map must precede suffix allocation"
        if hashes is None:
            hashes = self._prefix_hashes(
                prompt, (len(prompt) - 1) // self._block, adapter)
        for h in hashes:
            blk = self._prefix_table.get(h)
            if blk is None:
                break
            self._block_refs[blk] += 1
            self._evictable.pop(blk, None)  # in use again
            blocks.append(blk)
            self._tables_host[row, len(blocks) - 1] = blk
            self._tables_dirty = True
        reused = len(blocks) * self._block
        self.prefix_reused_tokens += reused
        if reused and self.kv_ledger is not None:
            # Prefix id: hex of the DEEPEST matched chain hash (the same on
            # every replica for the same adapter and tokens).
            self.kv_ledger.note_reuse_hit(
                hashes[len(blocks) - 1].hex()[:16], len(blocks), reused)
        return reused

    def _prefix_register_row(self, row: int, prompt: list[int],
                             adapter: str | None,
                             hashes: list[bytes] | None = None) -> None:
        """Once a prompt is wholly in the row's blocks, publish its full
        blocks so later prompts can share them."""
        if not self._prefix_enabled:
            return
        blocks = self._row_blocks[row]
        if hashes is None:
            hashes = self._prefix_hashes(
                prompt, (len(prompt) - 1) // self._block, adapter)
        for i, h in enumerate(hashes):
            blk = blocks[i]
            if self._block_hash.get(blk) is not None:
                continue  # already a cached block (mapped via reuse)
            if h in self._prefix_table:
                continue  # another live block already serves this content
            self._block_hash[blk] = h
            self._prefix_table[h] = blk
            self._block_refs[blk] = 1
        if hashes and self.kv_ledger is not None:
            self.kv_ledger.note_register(hashes[-1].hex()[:16], len(hashes))

    def _kv_note_reuse_unwind(self, req: Request, reused: int) -> None:
        """Ledger mirror of a reuse unwind, where ``prefix_reused_tokens``
        is decremented."""
        if self.kv_ledger is None or not reused:
            return
        blocks = reused // self._block
        hashes = self._prefix_hashes_for(req)
        self.kv_ledger.note_reuse_unwind(
            hashes[blocks - 1].hex()[:16], blocks, reused)

    def _sync_tables(self) -> None:
        """Push host-side table changes into the cache's device tables, in
        place (the decode block's graph reads them by address), queued
        behind any block in flight.  A copy of the values, never an alias:
        the cache's own table writes (``insert_prefill_paged``) must not
        reach the allocator's host table."""
        if self.paged and self._tables_dirty:
            # Shards on one device share one tables tensor.
            for tables in sharding.distinct(
                    [c["tables"] for c in sharding.parts(self.cache)]):
                self._h2d(tables, self._tables_host)
            self._tables_dirty = False

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b and b <= self.cfg.max_seq_len:
                return b
        raise ValueError(f"prompt length {n} exceeds largest prefill bucket")

    def _max_bucket(self) -> int:
        return max((b for b in self.cfg.prefill_buckets
                    if b <= self.cfg.max_seq_len), default=0)

    def _lora_buffers(self):
        return self.lora.buffers if self.lora is not None else None

    def _loop(self) -> None:
        while self._running:
            did_work = self._admit_and_insert(pipelined=False)
            # One chunk of ONE in-flight long-prompt stream (round-robin
            # across lanes); decode blocks run between chunks.
            if self._streams:
                self._stream_step()
                did_work = True
            if any(s is not None for s in self.slots):
                try:
                    if self._spec_dispatch_ok():
                        self._do_spec_step()
                    else:
                        self._do_decode_step()
                except Exception as e:  # engine must survive; fail batch
                    logger.exception("decode step failed")
                    self._fail_all_slots(e)
                did_work = True
            if not did_work:
                if self.profiler is not None:
                    self.profiler.note_idle()
                with self._work:
                    self._work.wait(timeout=0.05)

    def _admit_and_insert(self, pipelined: bool) -> bool:
        """Admission for both loops: drain decode_wait into freed slots,
        direct-prefill into free slots, prefill AHEAD when slots are full
        (grouped by bucket with ``prefill_batch`` > 1).  FIFO: decode_wait
        drains before the raw queue, and a direct prefill only happens when
        nothing is parked — whether the head waits on a slot or on pool
        blocks.  Prompts beyond the largest bucket stream into a reserved
        row, so with no lane free they head-of-line block as
        ``_pending``."""
        did = self._drain_decode_wait(pipelined)
        cap = (self.cfg.decode_wait_cap if self.cfg.decode_wait_cap is not None
               else self.cfg.decode_slots)
        while True:
            if self._pending is None:
                try:
                    self._pending = self.prefill_queue.get_nowait()
                except queue_mod.Empty:
                    break
            req = self._pending
            if req.cancelled.is_set():
                self._pending = None
                self._finish(req, "cancelled")
                did = True
                continue
            if getattr(req, "_handoff_only", False):
                # Hop 1: prefill with no slot and no cache write (the KV
                # leaves as a handoff), so it admits with every slot busy.
                self._pending = None
                self._admitting += 1
                try:
                    self._do_prefill_handoff(req)
                finally:
                    self._admitting -= 1
                did = True
                continue
            if getattr(req, "_attach_handoff", None) is not None:
                # Hop 2: the KV is computed already; it parks in
                # decode_wait, under the cap that bounds prefill-ahead KV,
                # and the drain admits it into a slot.
                if len(self.decode_wait) >= cap:
                    break
                self._pending = None
                self._admitting += 1
                try:
                    self._do_attach(req)
                finally:
                    self._admitting -= 1
                self._drain_decode_wait(pipelined)
                did = True
                continue
            n_req = len(req.prompt_tokens)
            if self._free_slot_index() is not None:
                if self.decode_wait:
                    break  # the parked head waits on blocks: strict FIFO
                # A prompt the ring takes never maps cached prefix blocks
                # (the ring computes the whole prompt into FRESH blocks),
                # so its gate must not count on reuse.
                takes_ring = (n_req > self._max_bucket()
                              and self._ring_usable(n_req))
                if not self._paged_can_admit(
                        n_req, req.prompt_tokens, req.adapter,
                        hashes=(self._prefix_hashes_for(req)
                                if self._prefix_enabled and not takes_ring
                                else None)):
                    break  # pool backpressure: wait for block frees
                if n_req > self._max_bucket() and not takes_ring:
                    if not self._lane_available(n_req):
                        break  # no lane (count or KV pressure); head waits
                    self._pending = None
                    self._admitting += 1
                    try:
                        if not self._start_stream(req):
                            break  # reparked for backpressure
                    finally:
                        self._admitting -= 1
                    did = True
                    continue
                self._pending = None
                self._admitting += 1
                try:
                    if (self.cfg.prefill_batch > 1
                            and n_req <= self._max_bucket()
                            and not self._prefix_enabled):
                        # Prefix-cache engines stay per request: the grouped
                        # program computes full-prompt KV, so a cached-prefix
                        # row would pay the compute reuse exists to skip.
                        self._do_prefill_group(
                            self._collect_prefill_group(req), pipelined)
                    elif pipelined:
                        self._do_prefill_pipelined(req)
                    else:
                        self._do_prefill(req)
                finally:
                    self._admitting -= 1
                did = True
                continue
            if n_req <= self._max_bucket() and len(self.decode_wait) < cap:
                self._pending = None
                self._admitting += 1
                try:
                    if self.cfg.prefill_batch > 1:
                        # Paged included: prefill-ahead KV parks OFF the
                        # pool; the drain gates each row on its blocks.
                        self._do_prefill_ahead_group(
                            self._collect_ahead_group(req, cap), pipelined)
                    else:
                        self._do_prefill_ahead(req, pipelined)
                finally:
                    self._admitting -= 1
                did = True
                continue
            break
        return did

    def _sweep_decode_wait(self) -> bool:
        """Drop cancelled entries ANYWHERE in decode_wait, freeing their
        parked KV even while older work blocks the front, and handoff
        imports parked longer than ``handoff_ttl_s``: abandoned work whose
        gateway rerouted (its release message is the fast path, this the
        backstop).  A parked prefill-ahead is never swept by age: its
        caller still waits on it."""
        now = time.time()
        ttl = self.cfg.handoff_ttl_s
        keep = collections.deque()
        swept = False
        for w, expired in zip(self.decode_wait, self._ttl_expired(now)):
            cancelled = w.request.cancelled.is_set()
            if cancelled or expired:
                self._parked_kv_tokens -= w.k.shape[2]
                if self.kv_ledger is not None:
                    self.kv_ledger.note_sweep(
                        int(w.k.shape[2]),
                        "cancelled" if cancelled else "ttl")
                if not cancelled:
                    logger.warning(
                        "handoff %s parked %.1fs > ttl %.1fs; releasing",
                        w.request.request_id, now - w.t_parked, ttl)
                    if self.event_sink is not None:
                        self.event_sink("kv_release",
                                        request_id=w.request.request_id,
                                        reason="ttl")
                self._finish(w.request, "cancelled")
                swept = True
            else:
                keep.append(w)
        if swept:
            self.decode_wait = keep
            self._usage_sync_kv()
        return swept

    def _ttl_expired(self, now: float) -> list[bool]:
        """Per ``decode_wait`` entry, whether it is a handoff import parked
        longer than ``handoff_ttl_s``.  Across processes the clocks
        differ, and a handoff one process releases while another inserts
        it hangs both inside a collective: the mesh's first process
        decides for every parked handoff and broadcasts its verdicts over
        all the mesh's processes.  Only with a TTL set and a handoff
        parked, which lockstep keeps the same everywhere, so an idle loop
        issues no collective."""
        ttl = self.cfg.handoff_ttl_s
        mine = [bool(ttl > 0 and w.from_handoff and w.t_parked
                     and now - w.t_parked > ttl) for w in self.decode_wait]
        parked = [i for i, w in enumerate(self.decode_wait)
                  if w.from_handoff]
        if ttl <= 0 or self._lockstep is None or not parked:
            return mine
        verdict = collectives.broadcast(
            torch.tensor([mine[i] for i in parked], dtype=torch.uint8,
                         device=self.device), 0, self._lockstep)
        for i, v in zip(parked, verdict.tolist()):
            mine[i] = bool(v)
        return mine

    def _drain_decode_wait(self, pipelined: bool) -> bool:
        did = self._sweep_decode_wait()
        while self.decode_wait:
            slot_idx = self._free_slot_index()
            if slot_idx is None:
                break
            w = self.decode_wait[0]
            if not self._paged_can_admit(w.n):
                break  # pool backpressure: KV stays parked off-cache
            self.decode_wait.popleft()
            self._parked_kv_tokens -= w.k.shape[2]
            if self.kv_ledger is not None:
                self.kv_ledger.note_unpark(int(w.k.shape[2]))
            self._admitting += 1
            try:
                self._insert_waiting(slot_idx, w, pipelined)
            finally:
                self._admitting -= 1
            did = True
        return did

    def _bucket_prefill(self, req: Request, n: int, lora_slot: int,
                        group: int = 0):
        """Pad a bucketable prompt and prefill it (on data group
        ``group``).  Returns (first_token device scalar, k, v, lp_info)."""
        bucket = self._bucket(n)
        self._note_padding(bucket - n)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = req.prompt_tokens
        positions = np.zeros((1, bucket), np.int64)
        positions[0, :n] = np.arange(n)
        return self._prefill_impl(tokens, positions, n, lora_slot,
                                  req.sampling, group)

    def _bucket_prefill_many(self, reqs, ns, lora_slots, groups=None):
        """One [P, bucket] prefill over same-bucket prompts (one program
        per data group of ``groups``).
        Returns (first tokens [P] device, k [L, P, S, ...], v, lp infos)."""
        bucket = self._bucket(max(ns))
        p = len(reqs)
        self._note_padding(sum(bucket - n for n in ns))
        tokens = np.zeros((p, bucket), np.int64)
        positions = np.zeros((p, bucket), np.int64)
        for i, (req, n) in enumerate(zip(reqs, ns)):
            tokens[i, :n] = req.prompt_tokens
            positions[i, :n] = np.arange(n)
        return self._prefill_many_impl(
            tokens, positions, np.asarray(ns, np.int64),
            np.asarray(lora_slots, np.int64), [r.sampling for r in reqs],
            groups)

    def _collect_followers(self, first_req, limit: int) -> list:
        """Pull same-bucket followers of ``first_req`` for one grouped
        prefill, up to ``limit`` in all.  The first pull that does not fit
        parks as ``_pending``, so FIFO order holds.  A hop request (a
        handoff-only prefill or an attach) never joins a group: it parks
        too, and admission's own branch serves it next cycle."""
        group = [first_req]
        bucket = self._bucket(len(first_req.prompt_tokens))
        while len(group) < limit and self._pending is None:
            try:
                nxt = self.prefill_queue.get_nowait()
            except queue_mod.Empty:
                break
            if nxt.cancelled.is_set():
                self._finish(nxt, "cancelled")
                continue
            n = len(nxt.prompt_tokens)
            if (getattr(nxt, "_handoff_only", False)
                    or getattr(nxt, "_attach_handoff", None) is not None):
                self._pending = nxt
            elif n <= self._max_bucket() and self._bucket(n) == bucket:
                group.append(nxt)
            else:
                self._pending = nxt  # another bucket or a stream: next cycle
        return group

    def _collect_prefill_group(self, first_req) -> list:
        """Direct-admission grouping, bounded by the free unreserved slots
        (only the direct branch calls this: nothing parked, a free slot for
        the head), so every row admits under the checks a single would."""
        return self._collect_followers(first_req, min(
            self.cfg.prefill_batch,
            sum(1 for i, s in enumerate(self.slots)
                if s is None and i not in self._reserved_slots)))

    def _collect_ahead_group(self, first_req, cap: int) -> list:
        """Prefill-ahead grouping, bounded by decode_wait's headroom."""
        return self._collect_followers(first_req, min(
            self.cfg.prefill_batch, max(1, cap - len(self.decode_wait))))

    def _grouped_batch(self, reqs, pipelined: bool, single_fn,
                       direct: bool = False):
        """The grouped prefills' shared preamble: drop cancelled rows and
        rows whose adapter is gone (each fails alone), hand a group of one
        to ``single_fn``, run ONE batched prefill (its failure fails the
        group; under ``data`` a ``direct`` group's rows run one program
        per data group of the rows they will take).  Returns None when the
        caller has nothing left to do, else
        ``(live, ns, lora_slots, k, v, tok_rows, lp_rows)``: in sync mode
        the first tokens and lp infos come to the host in one transfer per
        array; in pipelined mode as ``_Row`` views of one transfer started
        now, each keeping its device slice for the carry scatter."""
        live, ns, lora_slots = [], [], []
        for req in reqs:
            if req.cancelled.is_set():
                self._finish(req, "cancelled")
                continue
            try:
                lora_slots.append(self.lora.slot_for(req.adapter)
                                  if self.lora is not None else -1)
            except Exception as e:  # unknown adapter fails only this row
                req.error = str(e)
                self._finish(req, "error")
                continue
            live.append(req)
            ns.append(len(req.prompt_tokens))
        if not live:
            return None
        if len(live) == 1:
            single_fn(live[0])
            return None
        self._stamp_prefill_start(*live)
        groups = None
        if direct and self.tp is not None and self.tp.d > 1:
            free = [i for i, s in enumerate(self.slots)
                    if s is None and i not in self._reserved_slots]
            groups = np.array([self._slot_group(i) for i in free[:len(live)]]
                              + [0] * (len(live) - len(free)), np.int64)
        try:
            first_tokens, k, v, (lps, top_vs, top_is) = (
                self._bucket_prefill_many(live, ns, lora_slots, groups))
            p = len(live)
            if pipelined:
                hb = _HostBatch(first_tokens, lps, top_vs, top_is)
                tok_rows = [_Row(hb, 0, i, dev=first_tokens[i])
                            for i in range(p)]
                lp_rows = [tuple(_Row(hb, a, i) for a in (1, 2, 3))
                           for i in range(p)]
            else:
                toks, lps_h, top_vs_h, top_is_h = (
                    _host(x) for x in (first_tokens, lps, top_vs, top_is))
                tok_rows = [int(t) for t in toks]
                lp_rows = [(lps_h[i], top_vs_h[i], top_is_h[i])
                           for i in range(p)]
        except Exception as e:
            logger.exception("grouped prefill failed (%d reqs)", len(live))
            for req in live:
                req.error = str(e)
                self._finish(req, "error")
            return None
        return live, ns, lora_slots, k, v, tok_rows, lp_rows

    def _do_prefill_group(self, reqs, pipelined: bool) -> None:
        """Grouped admission: one prefill program fills len(reqs) slots.
        Each row then goes as ``_do_prefill`` / ``_do_prefill_pipelined``
        would take it; a row that fails after the batched call fails
        alone, and a row the pool cannot hold parks (with every later row,
        for FIFO) like a prefill-ahead."""
        batch = self._grouped_batch(
            reqs, pipelined,
            self._do_prefill_pipelined if pipelined else self._do_prefill,
            direct=True)
        if batch is None:
            return
        live, ns, lora_slots, k, v, tok_rows, lp_rows = batch
        pool_starved = False
        for i, req in enumerate(live):
            row_kv = (k[:, i:i + 1], v[:, i:i + 1])
            try:
                slot_idx = None if pool_starved else self._free_slot_index()
                if slot_idx is None:
                    # Defensive (the group is bounded by the free slots and
                    # the loop is single-threaded): a computed prefill is
                    # never dropped.
                    self._park_waiting(req, tok_rows[i], lp_rows[i], *row_kv,
                                       ns[i], lora_slots[i], pipelined)
                    continue
                try:
                    self._insert_prompt_kv(*row_kv, slot_idx, ns[i])
                except PagedPoolExhausted:
                    # The group outran the pool (_insert_prompt_kv freed
                    # the partial row): park off-cache until blocks free.
                    pool_starved = True
                    self._park_waiting(req, tok_rows[i], lp_rows[i], *row_kv,
                                       ns[i], lora_slots[i], pipelined)
                    continue
                if pipelined:
                    self._activate_slot_pipelined(
                        slot_idx, req, lora_slots[i], ns[i], tok_rows[i],
                        lp_rows[i])
                    continue
                if self._emit_first_token(req, tok_rows[i], lp_rows[i]):
                    if self.paged:  # finished at prefill: free its blocks
                        self._paged_free_row(slot_idx)
                    continue
                self._register_slot(slot_idx, _Slot(
                    request=req, lora_slot=lora_slots[i], position=ns[i]))
                self._slot_tokens[slot_idx] = tok_rows[i]
                self._slot_positions[slot_idx] = ns[i]
                self._count_first_token(slot_idx, tok_rows[i])
                self._draft_admit(slot_idx, req.prompt_tokens)
            except Exception as e:
                logger.exception("grouped admission failed for %s",
                                 req.request_id)
                req.error = str(e)
                self._finish(req, "error")

    def _do_prefill_ahead_group(self, reqs, pipelined: bool) -> None:
        """Grouped prefill-ahead: one program, every row parks in
        decode_wait (each as ``_do_prefill_ahead`` parks it)."""
        batch = self._grouped_batch(
            reqs, pipelined, lambda req: self._do_prefill_ahead(req, pipelined))
        if batch is None:
            return
        live, ns, lora_slots, k, v, tok_rows, lp_rows = batch
        for i, req in enumerate(live):
            try:
                self._park_waiting(req, tok_rows[i], lp_rows[i],
                                   k[:, i:i + 1], v[:, i:i + 1], ns[i],
                                   lora_slots[i], pipelined)
            except Exception as e:
                logger.exception("grouped parking failed for %s",
                                 req.request_id)
                req.error = str(e)
                self._finish(req, "error")

    def _park_waiting(self, req, first_token, lp_info, k, v, n: int,
                      lora_slot: int, pipelined: bool) -> None:
        """Park one prefilled row in decode_wait.  Sync mode emits its
        first token now (TTFT is prefill-bound, not slot-bound); pipelined
        mode keeps it for the row's first block."""
        w = _WaitingPrefill(request=req, first_token=first_token, k=k, v=v,
                            n=n, lora_slot=lora_slot, lp_info=lp_info)
        if not pipelined:
            w.first_token_host = int(first_token)
            if self._emit_first_token(req, w.first_token_host, lp_info):
                return  # finished at prefill; never needed a slot
        self.decode_wait.append(w)
        self._parked_kv_tokens += k.shape[2]
        if self.kv_ledger is not None:
            self.kv_ledger.note_park(int(k.shape[2]), "prefill_ahead")
        self._usage_sync_kv()

    def _prefill_common(self, req: Request):
        """Admission into a free row: a prefix-cache hit prefills only the
        suffix (``_prefix_bucket_prefill``), a prompt beyond the largest
        bucket runs the ring (``_ring_prefill``; it reaches here only when
        ``_ring_usable``, else admission streams it in chunks), anything
        else runs the bucketed program; then the KV is inserted.  Ring
        rows register no prefix blocks, as in the reference.
        Returns (slot_idx, first_token, n, lora_slot, lp_info)."""
        self._stamp_prefill_start(req)
        slot_idx = self._free_slot_index()
        n = len(req.prompt_tokens)
        lora_slot = (self.lora.slot_for(req.adapter)
                     if self.lora is not None else -1)
        bucketed = n <= self._max_bucket()
        if self._prefix_enabled and bucketed:
            res = self._prefix_bucket_prefill(req, slot_idx, n, lora_slot)
            if res is not None:
                return res
        group = self._slot_group(slot_idx)
        if bucketed:
            first_token, k, v, lp_info = self._bucket_prefill(req, n,
                                                              lora_slot, group)
        else:
            first_token, k, v, lp_info = self._ring_prefill(req, n,
                                                            lora_slot, group)
        self._insert_prompt_kv(k, v, slot_idx, n)
        if bucketed:
            self._prefix_register_row(slot_idx, req.prompt_tokens,
                                      req.adapter)
        return slot_idx, first_token, n, lora_slot, lp_info

    def _ring_usable(self, n: int) -> bool:
        """True when the ring prefill can take an ``n``-token prompt: a
        sequence mesh, and the padded length within ``max_seq_len``."""
        if self._ring is None:
            return False
        padded = -(-n // self._ring_pad) * self._ring_pad
        return padded <= self.cfg.max_seq_len

    def _ring_prefill(self, req: Request, n: int, lora_slot: int,
                      group: int = 0):
        """One sequence-parallel prefill program over the ring, inside data
        group ``group`` (its row's): the prompt
        pads right to a multiple of ``_ring_pad`` at positions
        ``arange(padded)`` (causal ring attention keeps the real positions
        exact; the insert trims the tail at ``n``), and the first token is
        sampled from the last real position (across processes, its row
        broadcast from the process whose block holds it).
        Returns (first_token device scalar, k, v, lp_info)."""
        from llm_instance_gateway_tpu_torch.parallel import long_context

        padded = -(-n // self._ring_pad) * self._ring_pad
        self._note_padding(padded - n)
        tokens = np.zeros((1, padded), np.int64)
        tokens[0, :n] = req.prompt_tokens
        positions = np.arange(padded, dtype=np.int64)[None]
        tok, pos = long_context.shard_inputs(
            self.mesh, self._tensor(tokens), self._tensor(positions), group)
        logits, k, v = self._ring(
            self.params, tok, pos, lora_bufs=self._lora_buffers(),
            slot_ids=self._tensor([lora_slot]), data_group=group)
        row = long_context.logits_row(
            sharding.in_group(self.params, group), logits, n - 1)
        first_token, lp_info = self._sample_first(row[0].to(self.device),
                                                  req.sampling, n - 1)
        return first_token, k, v, lp_info

    def _prefix_bucket_prefill(self, req: Request, slot_idx: int, n: int,
                               lora_slot: int):
        """Map the cached prefix blocks into the row (zero compute), then
        run ONE chunk program over the suffix, padded to the suffix's own
        bucket and attending the mapped prefix through the row's table.
        Returns the ``_prefill_common`` tuple, or None when nothing cached
        matched (the caller runs the plain bucketed program)."""
        reused = self._prefix_match_and_map(
            slot_idx, req.prompt_tokens, req.adapter,
            hashes=self._prefix_hashes_for(req))
        if reused == 0:
            return None
        try:
            self._paged_ensure(slot_idx, n)
        except PagedPoolExhausted:
            # The gate may have admitted on the plain path's feasibility:
            # unwind the map (the blocks return to the LRU) and fall back to
            # the full-prompt program, which can evict them.
            self._paged_free_row(slot_idx)
            self.prefix_reused_tokens -= reused
            self._kv_note_reuse_unwind(req, reused)
            return None
        try:
            self._sync_tables()
            c = n - reused
            bucket = self._bucket(c)
            self._note_padding(bucket - c)
            tokens = np.zeros((bucket,), np.int64)
            tokens[:c] = req.prompt_tokens[reused:]
            positions = reused + np.arange(bucket, dtype=np.int64)
            last_logits, self.cache = self._chunk_fn(
                self.model_cfg, self.params, self.cache, tokens, positions,
                slot_idx, n, c - 1, lora_bufs=self._lora_buffers(),
                lora_slot=lora_slot)
            self._prefix_register_row(slot_idx, req.prompt_tokens,
                                      req.adapter,
                                      hashes=self._prefix_hashes_for(req))
            first_token, lp_info = self._sample_first(last_logits,
                                                      req.sampling, n - 1)
        except BaseException:
            # Never strand the mapped prefix refs or fresh suffix blocks.
            self._paged_free_row(slot_idx)
            self.prefix_reused_tokens -= reused
            self._kv_note_reuse_unwind(req, reused)
            raise
        return slot_idx, first_token, n, lora_slot, lp_info

    def _insert_prompt_kv(self, k, v, slot_idx: int, n: int,
                          skip_leading_blocks: int = 0) -> None:
        """Write a bucketed prefill's KV into the cache (lane or pool).
        ``skip_leading_blocks`` (pool only) routes that many leading
        blocks' positions to the trash block: an attach's prefix blocks,
        mapped from the cache, are never re-scattered."""
        if not self.paged:
            self.cache = transformer.insert_prefill(self.cache, k, v,
                                                    slot_idx, n)
            return
        try:
            self._paged_ensure(slot_idx, n)
        except PagedPoolExhausted:
            self._paged_free_row(slot_idx)
            raise
        nb_bucket = -(-k.shape[2] // self._block)
        row_bl = self._row_blocks[slot_idx]
        # Wholly-padding bucket blocks write the trash block.
        phys = row_bl + [paged_lib.TRASH_BLOCK] * (nb_bucket - len(row_bl))
        if skip_leading_blocks:
            phys = ([paged_lib.TRASH_BLOCK] * skip_leading_blocks
                    + phys[skip_leading_blocks:])
        self._sync_tables()
        self.cache = paged_lib.insert_prefill_paged(
            self.cache, k, v, slot_idx, phys, self._tables_host[slot_idx], n)

    def _do_prefill(self, req: Request) -> None:
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        slot_idx = None
        registered = False
        try:
            slot_idx, first_token, n, lora_slot, lp_info = (
                self._prefill_common(req))
            tok = int(first_token)
            if self._emit_first_token(req, tok, lp_info):
                return  # finished at prefill; the finally frees its blocks
            self._register_slot(slot_idx, _Slot(request=req,
                                                lora_slot=lora_slot,
                                                position=n))
            registered = True
            self._slot_tokens[slot_idx] = tok
            self._slot_positions[slot_idx] = n
            self._count_first_token(slot_idx, tok)
            self._draft_admit(slot_idx, req.prompt_tokens)
        except Exception as e:  # engine must survive a poison request
            logger.exception("prefill failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")
        finally:
            if self.paged and slot_idx is not None and not registered:
                # A slot-less row would strand its blocks forever.
                self._paged_free_row(slot_idx)

    def _do_prefill_ahead(self, req: Request, pipelined: bool) -> None:
        """Prefill with NO slot: the prompt KV parks in decode_wait (off the
        cache and the pool) — its first token emitted now in sync mode,
        at its first block in pipelined mode."""
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        try:
            self._stamp_prefill_start(req)
            n = len(req.prompt_tokens)
            lora_slot = (self.lora.slot_for(req.adapter)
                         if self.lora is not None else -1)
            first_token, k, v, lp_info = self._bucket_prefill(req, n, lora_slot)
            if pipelined:
                first_token, lp_info = self._host_rows(first_token, lp_info)
            self._park_waiting(req, first_token, lp_info, k, v, n, lora_slot,
                               pipelined)
        except Exception as e:
            logger.exception("prefill-ahead failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")

    def _do_prefill_handoff(self, req: Request) -> None:
        """Prefill with no slot and no cache write: the prompt KV leaves
        the engine as a ``PrefillHandoff``.  TTFT here is the prefill alone;
        the decode engine emits the token."""
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        try:
            self._stamp_prefill_start(req)
            n = len(req.prompt_tokens)
            lora_slot = (self.lora.slot_for(req.adapter)
                         if self.lora is not None else -1)
            first_token, k, v, lp_info = self._bucket_prefill(req, n,
                                                              lora_slot)
            req.handoff = kv_transfer.export_handoff(
                req, k, v, n, int(first_token),
                lp_info=tuple(_host(a) for a in lp_info),
                quantize=getattr(req, "_handoff_quantize", None))
            req.t_first_token = time.time()
            self._record_ttft(req)
            self._finish(req, "handoff")
        except Exception as e:  # engine must survive a poison request
            logger.exception("handoff prefill failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")

    def _handoff_device_kv(self, handoff):
        """A handoff's KV as device tensors shaped like a bucketed
        prefill's output (``[L, 1, pad_to, Kh, hd]``), so the insert seams
        (lane slice, pool scatter, quantizing on an int8 cache) take it
        unchanged.  An int8 wire stays f32 here: the insert re-quantizes
        it to the identical values, where a cast to the compute dtype
        first would not round-trip."""
        k, v = handoff.kv_arrays(self.device)
        n = handoff.n
        if n <= self._max_bucket():
            pad_to = self._bucket(n)
        else:
            step = max(self._max_bucket(), 1)
            pad_to = min(-(-n // step) * step, self.cfg.max_seq_len)
        lyr, _, kh, hd = k.shape
        out = []
        for x in (k, v):
            p = torch.zeros((lyr, 1, pad_to, kh, hd), dtype=x.dtype,
                            device=self.device)
            p[:, 0, :n].copy_(x)
            out.append(p)
        return tuple(out)

    def _do_attach(self, req: Request) -> None:
        """Import a handoff's KV and park it in ``decode_wait``; the drain
        inserts it into a freed slot (mapping cached prefix blocks,
        registering the rest) and decode starts at the carried position.
        The first token is emitted HERE, as a sync prefill-ahead park does:
        TTFT on this engine is attach latency, and a one-token request
        finishes without taking a slot."""
        handoff = req._attach_handoff
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        try:
            lora_slot = (self.lora.slot_for(req.adapter)
                         if self.lora is not None else -1)
            k, v = self._handoff_device_kv(handoff)
            if self._emit_first_token(req, handoff.first_token,
                                      handoff.first_lp_info()):
                return  # finished at attach; never needed a slot
            w = _WaitingPrefill(
                request=req, first_token=handoff.first_token, k=k, v=v,
                n=handoff.n, lora_slot=lora_slot,
                first_token_host=handoff.first_token, first_emitted=True,
                from_handoff=True, t_parked=time.time())
            self.decode_wait.append(w)
            self._parked_kv_tokens += k.shape[2]
            if self.kv_ledger is not None:
                self.kv_ledger.note_park(int(k.shape[2]), "handoff")
            self._usage_sync_kv()
        except Exception as e:  # engine must survive a poison handoff
            logger.exception("attach failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")

    def _activate_slot_pipelined(self, slot_idx: int, req: Request,
                                 lora_slot: int, n: int, first_token,
                                 lp_info) -> None:
        """Pipelined slot activation: scatter the first token (a device
        value, never read back here), position and budget into the
        device carry, re-seed the row's stop history there, and register
        the slot with its pending first token, materialized when its first
        block is processed.  Shared by every admission path."""
        self._pending_budget_zero = [i for i in self._pending_budget_zero
                                     if i != slot_idx]
        tok_dev = (first_token.dev if isinstance(first_token, _Row)
                   and first_token.dev is not None else first_token)
        d = self._dev
        d["tokens"][slot_idx] = tok_dev
        d["positions"][slot_idx] = n
        d["remaining"][slot_idx] = max(0, req.max_new_tokens - 1)
        slot = _Slot(request=req, lora_slot=lora_slot, position=n)
        slot.pending_first = (first_token, lp_info)
        self._register_slot(slot_idx, slot)
        if self._slot_stop_lens[slot_idx].any():
            d["stop_hist"][slot_idx] = -1
            d["stop_hist"][slot_idx, STOP_LEN - 1] = tok_dev
        self._count_first_token(slot_idx, tok_dev)
        if self._spec:
            # _register_slot set the sampling parameters _draft_admit reads;
            # the new occupant starts with no catch-up token.
            d["has_extra"][slot_idx] = False
            self._draft_admit(slot_idx, req.prompt_tokens)

    def _insert_waiting(self, slot_idx: int, w: _WaitingPrefill,
                        pipelined: bool) -> None:
        req = w.request
        try:
            skip_blocks = 0
            if w.from_handoff and self._prefix_enabled:
                # Whole blocks this engine caches for the prompt's prefix
                # MAP into the row (refcounted, no writes): a repeated
                # attach writes only its suffix, and a shared live block
                # another row may be reading is never re-scattered.
                reused = self._prefix_match_and_map(
                    slot_idx, req.prompt_tokens, req.adapter,
                    hashes=self._prefix_hashes_for(req))
                skip_blocks = reused // self._block
            self._insert_prompt_kv(w.k, w.v, slot_idx, w.n,
                                   skip_leading_blocks=skip_blocks)
            self._prefix_register_row(
                slot_idx, req.prompt_tokens, req.adapter,
                hashes=(self._prefix_hashes_for(req)
                        if self._prefix_enabled else None))
            if pipelined:
                self._activate_slot_pipelined(slot_idx, req, w.lora_slot,
                                              w.n, w.first_token, w.lp_info)
                if w.first_emitted:
                    # Attach: the token reached the request at admission;
                    # the carry scatter above still decodes from it.
                    self.slots[slot_idx].pending_first = None
            else:
                self._register_slot(slot_idx, _Slot(
                    request=req, lora_slot=w.lora_slot, position=w.n))
                self._slot_tokens[slot_idx] = w.first_token_host
                self._slot_positions[slot_idx] = w.n
                self._count_first_token(slot_idx, w.first_token_host)
                self._draft_admit(slot_idx, req.prompt_tokens)
        except Exception as e:
            logger.exception("decode-wait insert failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")
            if self.paged:
                # No slot was registered, so no _clear_slot frees the row.
                self._paged_free_row(slot_idx)

    # ------------------------------------------------------------------
    # interleaved long-prompt streaming (one chunk per engine cycle)
    # ------------------------------------------------------------------

    def _lane_available(self, n_prompt: int) -> bool:
        """May a new chunk stream take a reserved row now?  Bounded by
        ``stream_lanes``; lanes beyond the first also require the paged
        pool to keep a growth block per active decode row after the
        stream's whole-prompt allocation."""
        if len(self._streams) >= max(1, self.cfg.stream_lanes):
            return False
        if not self._streams or not self.paged:
            return True
        active = sum(1 for s in self.slots if s is not None)
        avail = len(self._free_blocks) + (
            len(self._evictable) if self._prefix_enabled else 0)
        return avail - self._paged_needed(n_prompt + 1) >= active

    def _start_stream(self, req: Request) -> bool:
        """Reserve a free row and begin streaming a long prompt into it.
        The row is held out of ``_free_slot_index`` (not a live slot, so
        decode skips it).  Paged: cached prefix blocks map first, then the
        WHOLE prompt's blocks are allocated at once, so admissions and
        decode growth between chunks cannot drain the pool under the
        stream.  Returns False only when the request was reparked for
        backpressure."""
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return True
        self._stamp_prefill_start(req)
        try:
            slot_idx = self._free_slot_index()
            lora_slot = (self.lora.slot_for(req.adapter)
                         if self.lora is not None else -1)
        except Exception as e:
            logger.exception("stream admission failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")
            return True
        self._reserved_slots.add(slot_idx)
        reused = 0
        if self.paged:
            try:
                reused = self._prefix_match_and_map(
                    slot_idx, req.prompt_tokens, req.adapter)
                self._paged_ensure(slot_idx, len(req.prompt_tokens))
                self._sync_tables()
            except PagedPoolExhausted:
                # Defensive (the gate should prevent this): repark as the
                # head-of-line request and retry when blocks free.
                self._paged_free_row(slot_idx)
                self._reserved_slots.discard(slot_idx)
                self.prefix_reused_tokens -= reused
                self._kv_note_reuse_unwind(req, reused)
                self._pending = req
                return False
        self._streams.append(_ChunkStream(request=req, slot_idx=slot_idx,
                                          lora_slot=lora_slot,
                                          next_start=reused))
        return True

    def _abort_stream(self, st: _ChunkStream, reason: str) -> None:
        if st in self._streams:
            self._streams.remove(st)
        self._reserved_slots.discard(st.slot_idx)
        if self.paged:
            self._paged_free_row(st.slot_idx)
        self._finish(st.request, reason)

    def _stream_step(self, pipelined: bool = False) -> None:
        """Run ONE chunk of ONE in-flight stream (the cursor rotates across
        lanes).  On a stream's final chunk, sample the first token and turn
        its row into a live decode slot (pipelined: with the token kept on
        the device, as every pipelined admission)."""
        if not self._streams:
            return
        self._stream_rr %= len(self._streams)
        st = self._streams[self._stream_rr]
        self._stream_rr += 1
        req = st.request
        if req.cancelled.is_set():
            self._abort_stream(st, "cancelled")
            return
        chunk = self._max_bucket()
        prompt = req.prompt_tokens
        n = len(prompt)
        start = st.next_start
        piece = prompt[start:start + chunk]
        c = len(piece)
        tokens = np.zeros((chunk,), np.int64)
        tokens[:c] = piece
        positions = start + np.arange(chunk, dtype=np.int64)
        try:
            if self.paged:
                self._paged_ensure(st.slot_idx, start + c)
                self._sync_tables()
            st.last_logits, self.cache = self._chunk_fn(
                self.model_cfg, self.params, self.cache, tokens, positions,
                st.slot_idx, start + c, c - 1,
                lora_bufs=self._lora_buffers(), lora_slot=st.lora_slot)
        except Exception as e:  # engine must survive a poison request
            logger.exception("chunk stream failed for %s", req.request_id)
            req.error = str(e)
            self._abort_stream(st, "error")
            return
        st.next_start = start + c
        if st.next_start < n:
            return  # more chunks; the loop decodes before the next one
        # Final chunk: publish the prompt's full blocks for prefix reuse,
        # sample the first token, then activate the row as a live slot.
        if self.paged:
            self._prefix_register_row(st.slot_idx, prompt, req.adapter)
        self._streams.remove(st)
        self._reserved_slots.discard(st.slot_idx)
        slot_idx = st.slot_idx
        try:
            first_token, lp_info = self._sample_first(st.last_logits,
                                                      req.sampling, n - 1)
            if pipelined:
                first_token, lp_info = self._host_rows(first_token, lp_info)
                self._activate_slot_pipelined(slot_idx, req, st.lora_slot, n,
                                              first_token, lp_info)
                return
            tok = int(first_token)
            if self._emit_first_token(req, tok, lp_info):
                if self.paged:  # finished at prefill; free the row's blocks
                    self._paged_free_row(slot_idx)
                return
            self._register_slot(slot_idx, _Slot(
                request=req, lora_slot=st.lora_slot, position=n))
            self._slot_tokens[slot_idx] = tok
            self._slot_positions[slot_idx] = n
            self._count_first_token(slot_idx, tok)
        except Exception as e:
            logger.exception("stream activation failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")
            if self.paged and self.slots[slot_idx] is None:
                self._paged_free_row(slot_idx)

    def _register_slot(self, slot_idx: int, slot: _Slot) -> None:
        sp = slot.request.sampling
        self.slots[slot_idx] = slot
        self._slot_lora[slot_idx] = slot.lora_slot
        self._slot_temp[slot_idx] = sp.temperature
        self._slot_topk[slot_idx] = sp.top_k
        self._slot_topp[slot_idx] = sp.top_p
        self._slot_seed[slot_idx] = _seed_i32(sp.seed)
        self._slot_presence[slot_idx] = sp.presence_penalty
        self._slot_frequency[slot_idx] = sp.frequency_penalty
        (self._slot_bias_ids[slot_idx],
         self._slot_bias_vals[slot_idx]) = _bias_arrays(sp)
        if sp.presence_penalty or sp.frequency_penalty:
            # Fresh counts for the row; the first token follows through
            # _count_first_token once it is known.
            self._counts()[slot_idx].zero_()
        # The prefill already produced token 1.
        self._slot_remaining[slot_idx] = max(0, slot.request.max_new_tokens - 1)
        self._program_stop_lanes(slot_idx, slot.request)
        self._usage_sync_kv()

    def _program_stop_lanes(self, slot_idx: int, req: Request) -> None:
        """Stop suffixes (and single-token stop ids as length-1 sequences)
        into the row's device automaton; anything that does not fit leaves
        the lanes empty — the host oracle stays authoritative either way.
        A speculative engine keeps single-token stop ids on the host (an
        automaton row would stop speculation for no freeze the spec block
        needs: it trims on the host); stop sequences still program, and
        exclude speculation."""
        self._slot_stop_ids[slot_idx] = -1
        self._slot_stop_lens[slot_idx] = 0
        self._slot_stop_hist[slot_idx] = -1
        fold_ids = not self._spec
        if self.cfg.device_stops and (req.stop_sequences
                                      or (fold_ids and req.stop_token_ids)):
            enc = encode_stop_rows(
                [tuple(s) for s in req.stop_sequences]
                + ([(int(t),) for t in req.stop_token_ids]
                   if fold_ids else []))
            if enc is not None:
                self._slot_stop_ids[slot_idx] = enc[0]
                self._slot_stop_lens[slot_idx] = enc[1]
        self._stops_active = int((self._slot_stop_lens.sum(axis=1) > 0).sum())

    def _record_ttft(self, req: Request) -> None:
        if not (req.t_prefill_start and req.t_first_token):
            return
        wall = max(0.0, req.t_first_token - req.t_prefill_start)
        with self._lock:
            self.phase_hist["prefill"].observe(wall)
        if self.usage is not None:
            self.usage.charge_step(
                "prefill", wall, [req.adapter],
                tokens={owner_key(req.adapter): len(req.prompt_tokens)})
        if self.profiler is not None:
            self.profiler.note_dispatch(
                "prefill", None, wall, active=1,
                total_slots=self.cfg.decode_slots,
                n_steps=len(req.prompt_tokens))

    def _note_padding(self, pad_tokens: int) -> None:
        if self.usage is not None:
            self.usage.charge_padding(pad_tokens)
        if self.profiler is not None:
            self.profiler.note_padding(pad_tokens)

    def _kv_ledger_sync(self) -> None:
        """Recount the KV ledger's block states from the allocator's ground
        truth: the free list, DISTINCT blocks across row tables (a shared
        prefix block mapped into several rows is one block) and the
        evictable LRU."""
        if self.kv_ledger is None:
            return
        distinct: set[int] = set()
        for blocks in self._row_blocks:
            distinct.update(blocks)
        self.kv_ledger.sync_states(self._free_blocks, len(distinct),
                                   len(self._evictable),
                                   self._parked_kv_tokens)
        if self._kv_evicts_pending:
            # One aggregated event per sync: an eviction storm must not
            # flood the flight recorder's bounded ring.
            n, self._kv_evicts_pending = self._kv_evicts_pending, 0
            if self.event_sink is not None:
                self.event_sink("kv_evict", n=n)

    def _usage_sync_kv(self) -> None:
        """Refresh the KV-holdings integral (active rows at their position,
        parked KV at its padded size, streams at their filled prefix); the
        KV ledger's recount rides the same call sites."""
        self._kv_ledger_sync()
        if self.usage is None:
            return
        holdings = [(s.request.adapter, s.position)
                    for s in self.slots if s is not None]
        holdings += [(w.request.adapter, w.k.shape[2])
                     for w in self.decode_wait]
        holdings += [(st.request.adapter, st.next_start)
                     for st in self._streams if st.next_start > 0]
        self.usage.sync_kv(holdings)

    @staticmethod
    def _stamp_prefill_start(*reqs: Request) -> None:
        now = time.time()
        for req in reqs:
            if not req.t_prefill_start:
                req.t_prefill_start = now

    @staticmethod
    def _store_logprobs(req: Request, lp, top_v, top_i) -> None:
        if req.logprobs is None:
            return
        req.output_logprobs.append(float(lp))
        if req.logprobs > 0:
            kk = min(req.logprobs, len(top_i))
            req.output_top_logprobs.append(
                {int(top_i[j]): float(top_v[j]) for j in range(kk)})

    def _emit_first_token(self, req: Request, tok: int, lp_info=None) -> bool:
        """Record the prefill's first token; True if it finishes the request."""
        req.t_first_token = time.time()
        req.output_tokens.append(tok)
        if lp_info is not None and req.logprobs is not None:
            self._store_logprobs(req, *(_host(x) for x in lp_info))
        req.stream_event.set()
        with self._lock:
            self.total_generated += 1
        self._record_ttft(req)
        if self._is_finished(req, tok):
            self._finish(req, "stop" if self._is_stop(req, tok) else "length")
            return True
        return False

    def _paged_ensure_decode(self, n_steps: int, pipelined: bool = False,
                             per_row_steps: list[int] | None = None) -> None:
        """Pre-dispatch block growth for every active row; a row the
        exhausted pool cannot grow fails with "kv pool exhausted" without
        touching the batch.  Pipelined, the host's positions lag the device
        by the block in flight, so the reservation adds that block's steps
        (a spec block's writes, rejected tails included, so a plain block
        after a larger spec block still covers it; over-reservation returns
        at free).  ``per_row_steps`` narrows a spec block's reservation per
        row (``_spec_row_steps``)."""
        prev = self._prev_dispatch_steps if pipelined else 0
        if pipelined:
            # Recorded on lanes too: _plan_steps subtracts it.
            self._prev_dispatch_steps = n_steps
        if not self.paged:
            return
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            row_steps = (per_row_steps[i] if per_row_steps is not None
                         else n_steps)
            target = min(slot.position + row_steps + prev + 1,
                         self.cfg.max_seq_len)
            try:
                self._paged_ensure(i, target)
            except PagedPoolExhausted as e:
                req = slot.request
                logger.warning("kv pool exhausted; failing %s", req.request_id)
                req.error = str(e)
                self._finish(req, "error")
                self._clear_slot(i)
                if pipelined:
                    self._pending_budget_zero.append(i)
        self._sync_tables()

    def _do_decode_step(self) -> None:
        n_steps = self._plan_steps()
        self._paged_ensure_decode(n_steps)
        t0 = time.perf_counter()
        out = self._decode_impl(n_steps)  # [n_steps, B, 3 + 2K], host
        step_s = time.perf_counter() - t0
        n_tokens, owners, tok_by_owner, _ = self._walk_sync(out)
        self._account("decode", t0, step_s, owners, tok_by_owner, n_tokens,
                      step_s / n_steps, n_steps, n_steps)

    def _do_spec_step(self) -> None:
        """The sync loop's speculative dispatch: the host carry and the
        draft's catch-up triple in, one spec block, the output pack and
        the triple back in one transfer, walked as a plain block."""
        k = self.cfg.speculative_k
        n_cycles = self._spec_cycles_per_sync()
        # Every position a cycle can write, accepted or not, needs a block.
        self._paged_ensure_decode(
            n_cycles * (k + 1),
            per_row_steps=self._spec_row_steps(n_cycles, k))
        t0 = time.perf_counter()
        self._push(("tokens", "positions", "remaining") + _SPEC_CARRY)
        d = self._dev
        out, etok, epos, ehas = _HostBatch(
            self._run_spec_block(n_cycles), *(d[n] for n in _SPEC_CARRY)
        ).host()
        step_s = time.perf_counter() - t0
        self.spec_cycles += n_cycles
        n_tokens, owners, tok_by_owner, live = self._walk_sync(out)
        for i in live:
            # The draft's catch-up state from the device carry (a row
            # cleared in the walk resets at its next admission).
            self._slot_extra_tok[i] = etok[i]
            self._slot_extra_pos[i] = epos[i]
            self._slot_has_extra[i] = bool(ehas[i])
        self.spec_emitted += n_tokens
        # Per cycle (each emits >= 1 token a row).
        self._account("spec", t0, step_s, owners, tok_by_owner, n_tokens,
                      step_s / max(1, n_cycles), out.shape[0])

    def _walk_sync(self, out: np.ndarray):
        """Walk one block's output pack [T, B, 3 + 2K] (a plain block's
        steps, or a spec block's cycles x (K+1)) into the requests: every
        valid entry is a token, a row ends at its stop condition (later
        tokens are trimmed) and its slot is cleared.  Returns (tokens,
        the owners resident for the block, tokens by owner, the rows still
        live)."""
        k = LOGPROB_TOPK
        n_tokens = 0
        owners = [s.request.adapter for s in self.slots if s is not None]
        tok_by_owner: dict[str, int] = {}
        live = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            req = slot.request
            if req.cancelled.is_set():
                self._finish(req, "cancelled")
                self._clear_slot(i)
                continue
            finished = False
            slot_tokens = 0
            for row in out[:, i]:
                if not row[1]:
                    continue  # frozen (budget/EOS/stop), rejected, past EOS
                tok = int(row[0])
                req.output_tokens.append(tok)
                self._store_logprobs(req, row[2], row[3:3 + k],
                                     row[3 + k:3 + 2 * k])
                req.stream_event.set()
                n_tokens += 1
                slot_tokens += 1
                slot.position += 1
                self._slot_tokens[i] = tok
                self._slot_remaining[i] = max(0, self._slot_remaining[i] - 1)
                if (self._is_finished(req, tok)
                        or slot.position >= self.cfg.max_seq_len - 1):
                    self._finish(req, "stop" if self._is_stop(req, tok)
                                 else "length")
                    self._clear_slot(i)
                    finished = True
                    break  # tokens past the stop condition are trimmed
            if slot_tokens:
                key = owner_key(req.adapter)
                tok_by_owner[key] = tok_by_owner.get(key, 0) + slot_tokens
            req.stream_event.set()
            if not finished:
                self._slot_positions[i] = slot.position
                live.append(i)
        return n_tokens, owners, tok_by_owner, live

    def _account(self, phase: str, t0: float, step_s: float, owners,
                 tok_by_owner: dict, n_tokens: int, per_step_s: float,
                 n_steps: int, planned: int | None = None) -> None:
        """A processed block's books: usage, the profiler's ``phase``
        ("decode" or "spec") over ``n_steps`` token rows, tokens, the
        decode-rate EMA, the per-step wall, and ``planned`` steps (the
        planner's choice; None for a spec block, whose token rows are not
        one)."""
        if self.usage is not None:
            self.usage.charge_decode(step_s, owners, tok_by_owner)
            self._usage_sync_kv()
        if self.profiler is not None:
            self.profiler.note_dispatch(
                phase, t0, step_s, active=len(owners),
                total_slots=self.cfg.decode_slots, n_steps=n_steps)
        with self._lock:
            self.total_generated += n_tokens
            inst = n_tokens / step_s if step_s > 0 else 0.0
            a = self.cfg.tps_ema_alpha
            self.decode_tps_ema = (1 - a) * self.decode_tps_ema + a * inst
            self.phase_hist["decode_step"].observe(per_step_s)
            if planned is not None:
                self.dispatch_steps_hist.observe(planned)

    # ------------------------------------------------------------------
    # pipelined decode: overlap the readback with the next device block
    # ------------------------------------------------------------------

    def _loop_pipelined(self) -> None:
        """Two-deep pipeline: dispatch block N+1 from the device-resident
        carry BEFORE reading back block N's tokens, so the readback and the
        host's bookkeeping overlap the device.  Stop detection is on the
        device (budget, EOS and stop strings freeze rows); rows freed for
        host-only reasons get their device budget zeroed before the next
        dispatch; first tokens stay on the device and materialize when
        their slot's first block is processed."""
        inflight: dict | None = None
        while self._running:
            did_work = self._admit_and_insert(pipelined=True)
            if self._streams:
                self._stream_step(pipelined=True)
                did_work = True
            block = None
            if any(s is not None for s in self.slots):
                try:
                    block = self._dispatch_block()
                except Exception as e:
                    logger.exception("pipelined decode dispatch failed")
                    self._fail_all_slots(e)
                did_work = True
            if inflight is not None:
                try:
                    self._process_block(inflight, current=block)
                except Exception as e:
                    logger.exception("pipelined block materialization failed")
                    self._fail_all_slots(e)
                    block = None
                did_work = True
            inflight = block
            if not did_work:
                if self.profiler is not None:
                    self.profiler.note_idle()
                with self._work:
                    self._work.wait(timeout=0.05)
        if inflight is not None:
            try:
                self._process_block(inflight, current=None)
            except Exception as e:
                logger.exception("final block materialization failed")
                self._fail_all_slots(e)

    def _do_prefill_pipelined(self, req: Request) -> None:
        """Prefill + insert with no readback: the first token is scattered
        into the device carry and copied back behind an event."""
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        slot_idx = None
        registered = False
        try:
            slot_idx, first_token, n, lora_slot, lp_info = (
                self._prefill_common(req))
            # TTFT is stamped when the token materializes in _process_block.
            first_token, lp_info = self._host_rows(first_token, lp_info)
            self._activate_slot_pipelined(slot_idx, req, lora_slot, n,
                                          first_token, lp_info)
            registered = True
        except Exception as e:
            logger.exception("pipelined prefill failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")
        finally:
            if self.paged and slot_idx is not None and not registered:
                self._paged_free_row(slot_idx)

    def _dispatch_block(self) -> dict:
        """Queue one block on the device carry and its readback; returns
        the block's record for ``_process_block``.  A spec block when
        ``_spec_dispatch_ok`` (its outputs have the plain block's layout,
        so processing is shared)."""
        spec = self._spec_dispatch_ok()
        if spec:
            k = self.cfg.speculative_k
            n_cycles = self._spec_cycles_per_sync()
            n_steps = n_cycles * (k + 1)
            self._paged_ensure_decode(
                n_steps, pipelined=True,
                per_row_steps=self._spec_row_steps(n_cycles, k))
        else:
            n_steps = self._plan_steps()
            self._paged_ensure_decode(n_steps, pipelined=True)
        remaining = self._dev["remaining"]
        for i in self._pending_budget_zero:
            remaining[i] = 0
        self._pending_budget_zero.clear()
        if spec:
            self.spec_cycles += n_cycles
            out = _HostBatch(self._run_spec_block(n_cycles))
        else:
            out = _HostBatch(self._run_block(n_steps))
        return {"out": out, "rows": list(self.slots), "n_steps": n_steps,
                "t0": time.perf_counter(), "spec": spec}

    def _process_block(self, blk: dict, current: dict | None) -> None:
        """Read block ``blk`` back (it overlaps ``current`` on the device)
        and walk its tokens per row, as ``_do_decode_step`` does; a row
        that finishes here is dropped from ``current``, whose lane for it
        is garbage."""
        out = blk["out"].host()[0]  # [n_steps, B, 3 + 2K]
        k = LOGPROB_TOPK
        n_tokens = 0
        n_pending = 0  # prefill first tokens materialized here
        owners = [s.request.adapter for s in blk["rows"] if s is not None]
        tok_by_owner: dict[str, int] = {}

        def drop(i, slot):
            if self.slots[i] is slot:
                self._clear_slot(i)
                # Host-side reasons leave a positive device budget.
                self._pending_budget_zero.append(i)
            if current is not None and current["rows"][i] is slot:
                current["rows"][i] = None

        for i, slot in enumerate(blk["rows"]):
            if slot is None:
                continue
            req = slot.request
            if req.done.is_set():
                continue
            if req.cancelled.is_set():
                self._finish(req, "cancelled")
                drop(i, slot)
                continue
            finished = False
            if slot.pending_first is not None:
                tok0, lp0 = slot.pending_first
                tok0 = int(np.asarray(tok0))
                slot.pending_first = None
                req.t_first_token = time.time()
                req.output_tokens.append(tok0)
                if lp0 is not None:
                    self._store_logprobs(req, *(np.asarray(x) for x in lp0))
                n_tokens += 1
                n_pending += 1
                self._record_ttft(req)
                finished = self._is_finished(req, tok0)
            if not finished:
                row_tokens = 0
                for step in range(blk["n_steps"]):
                    row = out[step, i]
                    if not row[1]:
                        continue  # device froze this row (budget/EOS/stop)
                    tok = int(row[0])
                    req.output_tokens.append(tok)
                    self._store_logprobs(req, row[2], row[3:3 + k],
                                         row[3 + k:3 + 2 * k])
                    req.stream_event.set()
                    n_tokens += 1
                    row_tokens += 1
                    slot.position += 1
                    if (self._is_finished(req, tok)
                            or slot.position >= self.cfg.max_seq_len - 1):
                        finished = True
                        break
                if row_tokens:
                    key = owner_key(req.adapter)
                    tok_by_owner[key] = tok_by_owner.get(key, 0) + row_tokens
            req.stream_event.set()
            if finished:
                self._finish(req, "stop" if self._is_stop(
                    req, req.output_tokens[-1]) else "length")
                drop(i, slot)
        # The block's wall runs from its dispatch to its processing: blocks
        # overlap, so this is the per-step cadence the gateway compares.
        step_s = time.perf_counter() - blk["t0"]
        if blk["spec"]:
            self.spec_emitted += n_tokens - n_pending  # first tokens: prefill
        self._account("spec" if blk["spec"] else "decode", blk["t0"], step_s,
                      owners, tok_by_owner, n_tokens,
                      step_s / max(1, blk["n_steps"]), blk["n_steps"],
                      None if blk["spec"] else blk["n_steps"])

    def _fail_all_slots(self, e: Exception) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None:
                slot.request.error = str(e)
                self._finish(slot.request, "error")
                self._clear_slot(i)

    def _is_stop(self, req: Request, tok: int) -> bool:
        """Host stop oracle: EOS / stop ids / stop sequences on the tail."""
        if tok == self.eos_id or tok in req.stop_token_ids:
            return True
        out = req.output_tokens
        for seq in req.stop_sequences:
            n = len(seq)
            if n and len(out) >= n and tuple(out[-n:]) == tuple(seq):
                return True
        return False

    def _is_finished(self, req: Request, tok: int) -> bool:
        return (self._is_stop(req, tok)
                or len(req.output_tokens) >= req.max_new_tokens)

    def _finish(self, req: Request, reason: str) -> None:
        if req.done.is_set():
            return
        req.finish_reason = reason
        req.t_done = time.time()
        with self._lock:
            self._live.pop(req.request_id, None)
        if req.adapter is not None and self.lora is not None:
            self.lora.release(req.adapter)
        req.done.set()  # before the wake-up, so a waiter woken reads it
        req.stream_event.set()
