"""Continuous-batching serving engine (port of ``server/engine.py``, the
synchronous loop over contiguous cache lanes).

- **Prefill** runs one prompt at a time, padded to a prefill bucket, and
  samples the first token.
- **Insert** writes the prompt KV into a free row of the decode cache
  ``[n_layers, decode_slots, max_seq_len, n_kv, hd]``; with every slot busy
  the prompt prefills AHEAD and parks in ``decode_wait`` (KV held
  off-cache) until a slot frees, FIFO.
- **Generate** advances all active slots ``n_steps`` tokens per dispatch
  (``_plan_steps``, the adaptive planner) with the device-side freeze: a
  row whose budget runs out, or which emits EOS or completes a stop
  sequence, stops advancing mid-block.  The block is an eager Python loop
  of decode_step + sample whose freeze arithmetic stays in tensors; the
  host reads the block's tokens back once per dispatch.

Same ``EngineConfig`` fields and defaults, ``SamplingParams``, ``Request``
and ``metrics_snapshot()`` keys as the reference.  Config the port does not
serve yet raises at construction instead of being ignored: the paged pool,
speculative decoding, int8 KV, grouped prefill, pipelined decode, prefix
caching and concurrent chunk-stream lanes; so does a prompt longer than the
largest bucket (chunk streaming) at submit.
"""

from __future__ import annotations

import collections
import logging
import queue as queue_mod
import threading
import time
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
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


# Fields the reference serves and this slice does not: (field, value the
# port accepts, ROADMAP Queue 1 item that ports it).
_UNSERVED = (
    ("paged_kv_block", None, "9 (paged pool)"),
    ("paged_kv_blocks", None, "9 (paged pool)"),
    ("prefix_cache", False, "9 (prefix cache)"),
    ("speculative_k", 0, "12 (speculative decoding)"),
    ("kv_cache_quant", None, "10 (int8 KV)"),
    ("prefill_batch", 1, "7 (grouped prefill)"),
    ("pipeline_decode", False, "7 (pipelined decode)"),
    ("stream_lanes", 1, "8 (chunk-stream lanes)"),
)


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


@dataclass
class _Slot:
    request: Request
    lora_slot: int
    position: int  # position of the NEXT token to generate


@dataclass
class _WaitingPrefill:
    """A prefilled request parked in ``decode_wait`` (KV held off-cache)."""

    request: Request
    first_token: int
    k: torch.Tensor  # [L, 1, bucket, K, hd]
    v: torch.Tensor
    n: int
    lora_slot: int


class Engine:
    def __init__(self, model_cfg: ModelConfig, params, engine_cfg=None,
                 lora_manager=None, eos_id: int | None = None,
                 dtype=torch.bfloat16, seed: int = 0, device="cuda"):
        self.model_cfg = model_cfg
        self.cfg = engine_cfg or EngineConfig()
        for name, ok, item in _UNSERVED:
            if getattr(self.cfg, name) != ok:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self.cfg, name)!r} is not "
                    f"served by the torch port yet (ROADMAP Queue 1 item {item})")
        transformer.check_supported(model_cfg)
        self.params = params
        self.lora = lora_manager
        self.eos_id = eos_id
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        b = self.cfg.decode_slots
        self.cache = transformer.init_decode_cache(
            model_cfg, b, self.cfg.max_seq_len, dtype=dtype, device=self.device)
        self.slots: list[_Slot | None] = [None] * b
        self._slot_tokens = np.zeros((b,), np.int64)
        self._slot_positions = np.zeros((b,), np.int64)
        self._slot_lora = np.full((b,), -1, np.int64)
        self._slot_temp = np.zeros((b,), np.float32)
        self._slot_topk = np.zeros((b,), np.int64)
        self._slot_topp = np.ones((b,), np.float32)
        self._slot_seed = np.full((b,), -1, np.int64)
        self._slot_bias_ids = np.full((b, MAX_LOGIT_BIAS), -1, np.int64)
        self._slot_bias_vals = np.zeros((b, MAX_LOGIT_BIAS), np.float32)
        self._slot_remaining = np.zeros((b,), np.int64)
        self._slot_stop_ids = np.full((b, STOP_SEQS, STOP_LEN), -1, np.int64)
        self._slot_stop_lens = np.zeros((b, STOP_SEQS), np.int64)
        self._slot_stop_hist = np.full((b, STOP_LEN), -1, np.int64)
        self._stops_active = 0

        self.prefill_queue: queue_mod.Queue[Request] = queue_mod.Queue(
            maxsize=self.cfg.max_queue)
        self.decode_wait: collections.deque[_WaitingPrefill] = collections.deque()
        self._parked_kv_tokens = 0
        self._pending: Request | None = None
        self._work = threading.Condition()
        self._running = False
        self._draining = False
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
            UsageTracker(b) if self.cfg.usage_attribution else None)
        self.profiler: StepProfiler | None = (
            StepProfiler() if self.cfg.step_profile else None)

    # ------------------------------------------------------------------
    # device compute
    # ------------------------------------------------------------------

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=dtype).to(self.device)

    def _prefill_impl(self, tokens, positions, true_len: int, lora_slot: int,
                      sp: SamplingParams):
        """Prefill one padded prompt; sample the first new token."""
        logits, k, v = transformer.prefill(
            self.model_cfg, self.params, self._tensor(tokens),
            self._tensor(positions), lora_bufs=self._lora_buffers(),
            slot_ids=self._tensor([lora_slot]))
        last = logits[:, true_len - 1]  # [1, V]
        seed = _seed_i32(sp.seed)
        bias_ids, bias_vals = _bias_arrays(sp)
        first = sample(
            last, self._gen, self._tensor([sp.temperature], torch.float32),
            self._tensor([sp.top_k]), self._tensor([sp.top_p], torch.float32),
            valid_vocab=self.model_cfg.vocab_size,
            seeds=self._tensor([seed]) if seed >= 0 else None,
            positions=self._tensor([true_len - 1]),
            bias_ids=self._tensor(bias_ids[None]),
            bias_vals=self._tensor(bias_vals[None]))
        lp, top_v, top_i = logprob_info(last, first, self.model_cfg.vocab_size)
        return first[0], k, v, (lp[0], top_v[0], top_i[0])

    def _decode_impl(self, n_steps: int):
        """``n_steps`` fused decode+sample steps with the device-side freeze.

        Each row carries a ``remaining`` budget; a row is frozen once it
        reaches 0 (budget spent, EOS, or a completed stop suffix): frozen
        rows write no KV, keep their position and emit ``valid=False``
        steps.  Returns a host array [n_steps, B, 3 + 2*LOGPROB_TOPK]
        (token, valid, logprob, top-K values, top-K ids) — the dispatch's
        one device-to-host read."""
        cfg = self.model_cfg
        t = self._tensor
        max_len = self.cache["k"].shape[2]
        tokens = t(self._slot_tokens)
        positions = t(self._slot_positions)
        remaining = t(self._slot_remaining)
        hist = t(self._sync_stop_hist())
        slot_ids = t(self._slot_lora)
        temp = t(self._slot_temp)
        topk = t(self._slot_topk)
        topp = t(self._slot_topp)
        seeds = t(self._slot_seed) if (self._slot_seed >= 0).any() else None
        bias_ids = t(self._slot_bias_ids)
        bias_vals = t(self._slot_bias_vals)
        stop_ids = t(self._slot_stop_ids)
        stop_lens = t(self._slot_stop_lens)
        eos = -1 if self.eos_id is None else self.eos_id
        lora_bufs = self._lora_buffers()
        steps = []
        for _ in range(n_steps):
            active = remaining > 0
            safe_pos = positions.clamp(max=max_len - 1)
            logits, self.cache = transformer.decode_step(
                cfg, self.params, self.cache, tokens, safe_pos,
                lora_bufs=lora_bufs, slot_ids=slot_ids, active=active)
            sampled = sample(logits, self._gen, temp, topk, topp,
                             valid_vocab=cfg.vocab_size, seeds=seeds,
                             positions=safe_pos, bias_ids=bias_ids,
                             bias_vals=bias_vals).long()
            lp, top_v, top_i = logprob_info(logits, sampled, cfg.vocab_size)
            valid = active
            hit_eos = valid & (sampled == eos)
            hist = stop_hist_update(hist, sampled, valid)
            hit_stop = valid & stop_suffix_hit(hist, stop_ids, stop_lens)
            remaining = torch.where(valid, remaining - 1, remaining)
            remaining = torch.where(hit_eos | hit_stop, 0, remaining)
            tokens = torch.where(active, sampled, tokens)
            positions = positions + active.long()
            steps.append(torch.cat(
                [sampled[:, None].double(), valid[:, None].double(),
                 lp[:, None].double(), top_v.double(), top_i.double()], dim=1))
        return torch.stack(steps).cpu().numpy()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

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
        stragglers += [s.request for s in self.slots if s is not None]
        for req in stragglers:
            if not req.done.is_set():
                req.error = req.error or "engine stopped"
                self._finish(req, "error")

    def _plan_steps(self) -> int:
        """Fused decode steps for the next dispatch (the adaptive planner):
        static ``decode_steps_per_sync`` when ``adaptive_steps`` <= 0, else
        1 under admission pressure, capped by the minimum remaining budget
        and by ``adaptive_stream_cap`` for SSE rows, rounded down to a
        power of two."""
        ceiling = self.cfg.adaptive_steps
        if ceiling <= 0:
            return max(1, self.cfg.decode_steps_per_sync)
        if (self._pending is not None or not self.prefill_queue.empty()
                or (self.decode_wait
                    and self._free_slot_index() is not None)):
            return 1
        n = max(1, ceiling)
        for s in self.slots:
            if s is None:
                continue
            req = s.request
            if req.streaming:
                n = min(n, max(1, self.cfg.adaptive_stream_cap))
            n = min(n, max(1, req.max_new_tokens - len(req.output_tokens)))
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
        if sp.presence_penalty or sp.frequency_penalty:
            raise ValueError("presence/frequency penalties are not served by "
                             "the torch port yet (ROADMAP Queue 1 item 12)")
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
        if n > self._max_bucket():
            raise ValueError(
                f"prompt length {n} exceeds the largest prefill bucket "
                f"{self._max_bucket()}; chunk-stream prefill is not served by "
                "the torch port yet (ROADMAP Queue 1 item 8)")

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
        with self._work:
            self._work.notify()
        return True

    # ------------------------------------------------------------------
    # metrics snapshot (the scrape contract)
    # ------------------------------------------------------------------

    def _adapter_activity(self) -> tuple[list[str], list[str]]:
        running: set[str] = set()
        waiting: set[str] = set()
        for s in self.slots:
            if s is not None and s.request.adapter:
                running.add(s.request.adapter)
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
        used_tokens = sum(s.position for s in self.slots if s is not None)
        capacity = self.cfg.decode_slots * self.cfg.max_seq_len
        parked = self._parked_kv_tokens
        used_tokens += parked
        with self._lock:
            tps = self.decode_tps_ema
            phase_hist = {k: h.state() for k, h in self.phase_hist.items()}
            steps_hist = self.dispatch_steps_hist.state()
        running_adapters, waiting_adapters = self._adapter_activity()
        prefill_depth = (self.prefill_queue.qsize()
                         + (1 if self._pending is not None else 0)
                         + self._admitting)
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
            "stream_lanes_active": 0,
            "phase_hist": phase_hist,
            **({"usage": self.usage.snapshot()}
               if self.usage is not None else {}),
            **({"profile": self.profiler.hist_state()}
               if self.profiler is not None else {}),
        }

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------

    def _free_slot_index(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _clear_slot(self, i: int) -> None:
        self.slots[i] = None
        self._slot_lora[i] = -1
        self._slot_remaining[i] = 0
        if self._slot_stop_lens[i].any():
            self._slot_stop_ids[i] = -1
            self._slot_stop_lens[i] = 0
            self._slot_stop_hist[i] = -1
            self._stops_active = int(
                (self._slot_stop_lens.sum(axis=1) > 0).sum())
        self._slot_seed[i] = -1
        self._slot_bias_ids[i] = -1
        self._slot_bias_vals[i] = 0.0

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
        with torch.no_grad():
            while self._running:
                did_work = self._admit_and_insert()
                if any(s is not None for s in self.slots):
                    try:
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

    def _admit_and_insert(self) -> bool:
        """Drain decode_wait into freed slots, direct-prefill into free
        slots, prefill AHEAD when slots are full.  FIFO: decode_wait drains
        before the raw queue, and a direct prefill only happens when nothing
        is parked."""
        did = self._drain_decode_wait()
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
            if self._free_slot_index() is not None:
                if self.decode_wait:
                    break
                self._pending = None
                self._admitting += 1
                try:
                    self._do_prefill(req)
                finally:
                    self._admitting -= 1
                did = True
                continue
            if len(self.decode_wait) < cap:
                self._pending = None
                self._admitting += 1
                try:
                    self._do_prefill_ahead(req)
                finally:
                    self._admitting -= 1
                did = True
                continue
            break
        return did

    def _drain_decode_wait(self) -> bool:
        did = False
        keep = collections.deque()
        for w in self.decode_wait:  # cancelled entries anywhere free their KV
            if w.request.cancelled.is_set():
                self._parked_kv_tokens -= w.k.shape[2]
                self._finish(w.request, "cancelled")
                did = True
            else:
                keep.append(w)
        self.decode_wait = keep
        while self.decode_wait:
            slot_idx = self._free_slot_index()
            if slot_idx is None:
                break
            w = self.decode_wait.popleft()
            self._parked_kv_tokens -= w.k.shape[2]
            self._admitting += 1
            try:
                self._insert_waiting(slot_idx, w)
            finally:
                self._admitting -= 1
            did = True
        return did

    def _bucket_prefill(self, req: Request, n: int, lora_slot: int):
        """Pad a bucketable prompt and prefill it.
        Returns (first_token device scalar, k, v, lp_info)."""
        bucket = self._bucket(n)
        self._note_padding(bucket - n)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = req.prompt_tokens
        positions = np.zeros((1, bucket), np.int64)
        positions[0, :n] = np.arange(n)
        return self._prefill_impl(tokens, positions, n, lora_slot,
                                  req.sampling)

    def _do_prefill(self, req: Request) -> None:
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        try:
            self._stamp_prefill_start(req)
            slot_idx = self._free_slot_index()
            n = len(req.prompt_tokens)
            lora_slot = (self.lora.slot_for(req.adapter)
                         if self.lora is not None else -1)
            first_token, k, v, lp_info = self._bucket_prefill(req, n, lora_slot)
            self.cache = transformer.insert_prefill(self.cache, k, v,
                                                    slot_idx, n)
            tok = int(first_token)
            if self._emit_first_token(req, tok, lp_info):
                return
            self._register_slot(slot_idx, _Slot(request=req,
                                                lora_slot=lora_slot,
                                                position=n))
            self._slot_tokens[slot_idx] = tok
            self._slot_positions[slot_idx] = n
        except Exception as e:  # engine must survive a poison request
            logger.exception("prefill failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")

    def _do_prefill_ahead(self, req: Request) -> None:
        """Prefill with NO slot: the prompt KV parks in decode_wait and the
        first token is emitted now (TTFT is prefill-bound, not slot-bound)."""
        if req.cancelled.is_set():
            self._finish(req, "cancelled")
            return
        try:
            self._stamp_prefill_start(req)
            n = len(req.prompt_tokens)
            lora_slot = (self.lora.slot_for(req.adapter)
                         if self.lora is not None else -1)
            first_token, k, v, lp_info = self._bucket_prefill(req, n, lora_slot)
            tok = int(first_token)
            if self._emit_first_token(req, tok, lp_info):
                return
            self.decode_wait.append(_WaitingPrefill(
                request=req, first_token=tok, k=k, v=v, n=n,
                lora_slot=lora_slot))
            self._parked_kv_tokens += k.shape[2]
            self._usage_sync_kv()
        except Exception as e:
            logger.exception("prefill-ahead failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")

    def _insert_waiting(self, slot_idx: int, w: _WaitingPrefill) -> None:
        req = w.request
        try:
            self.cache = transformer.insert_prefill(self.cache, w.k, w.v,
                                                    slot_idx, w.n)
            self._register_slot(slot_idx, _Slot(
                request=req, lora_slot=w.lora_slot, position=w.n))
            self._slot_tokens[slot_idx] = w.first_token
            self._slot_positions[slot_idx] = w.n
        except Exception as e:
            logger.exception("decode-wait insert failed for %s", req.request_id)
            req.error = str(e)
            self._finish(req, "error")

    def _register_slot(self, slot_idx: int, slot: _Slot) -> None:
        sp = slot.request.sampling
        self.slots[slot_idx] = slot
        self._slot_lora[slot_idx] = slot.lora_slot
        self._slot_temp[slot_idx] = sp.temperature
        self._slot_topk[slot_idx] = sp.top_k
        self._slot_topp[slot_idx] = sp.top_p
        self._slot_seed[slot_idx] = _seed_i32(sp.seed)
        (self._slot_bias_ids[slot_idx],
         self._slot_bias_vals[slot_idx]) = _bias_arrays(sp)
        # The prefill already produced token 1.
        self._slot_remaining[slot_idx] = max(0, slot.request.max_new_tokens - 1)
        self._program_stop_lanes(slot_idx, slot.request)
        self._usage_sync_kv()

    def _program_stop_lanes(self, slot_idx: int, req: Request) -> None:
        """Stop suffixes (and single-token stop ids as length-1 sequences)
        into the row's device automaton; anything that does not fit leaves
        the lanes empty — the host oracle stays authoritative either way."""
        self._slot_stop_ids[slot_idx] = -1
        self._slot_stop_lens[slot_idx] = 0
        self._slot_stop_hist[slot_idx] = -1
        if self.cfg.device_stops and (req.stop_sequences or req.stop_token_ids):
            enc = encode_stop_rows(
                [tuple(s) for s in req.stop_sequences]
                + [(int(t),) for t in req.stop_token_ids])
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
            self.profiler.note_dispatch("prefill", None, wall)

    def _note_padding(self, pad_tokens: int) -> None:
        if self.usage is not None:
            self.usage.charge_padding(pad_tokens)
        if self.profiler is not None:
            self.profiler.note_padding(pad_tokens)

    def _usage_sync_kv(self) -> None:
        if self.usage is None:
            return
        holdings = [(s.request.adapter, s.position)
                    for s in self.slots if s is not None]
        holdings += [(w.request.adapter, w.k.shape[2])
                     for w in self.decode_wait]
        self.usage.sync_kv(holdings)

    @staticmethod
    def _stamp_prefill_start(req: Request) -> None:
        if not req.t_prefill_start:
            req.t_prefill_start = time.time()

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
            lp, top_v, top_i = (x.cpu().numpy() for x in lp_info)
            self._store_logprobs(req, lp, top_v, top_i)
        req.stream_event.set()
        with self._lock:
            self.total_generated += 1
        self._record_ttft(req)
        if self._is_finished(req, tok):
            self._finish(req, "stop" if self._is_stop(req, tok) else "length")
            return True
        return False

    def _do_decode_step(self) -> None:
        n_steps = self._plan_steps()
        t0 = time.perf_counter()
        out = self._decode_impl(n_steps)  # [n_steps, B, 3 + 2K], host
        step_s = time.perf_counter() - t0
        k = LOGPROB_TOPK
        n_tokens = 0
        owners = [s.request.adapter for s in self.slots if s is not None]
        tok_by_owner: dict[str, int] = {}
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
            for step in range(n_steps):
                row = out[step, i]
                if not row[1]:
                    continue  # device froze this row (budget/EOS/stop)
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
        if self.usage is not None:
            self.usage.charge_decode(step_s, owners, tok_by_owner)
            self._usage_sync_kv()
        if self.profiler is not None:
            self.profiler.note_dispatch("decode", t0, step_s)
        with self._lock:
            self.total_generated += n_tokens
            inst = n_tokens / step_s if step_s > 0 else 0.0
            a = self.cfg.tps_ema_alpha
            self.decode_tps_ema = (1 - a) * self.decode_tps_ema + a * inst
            self.phase_hist["decode_step"].observe(step_s / n_steps)
            self.dispatch_steps_hist.observe(n_steps)

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
        req.stream_event.set()
        req.done.set()
