#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises (exit code != 0):

1. device  — requires CUDA, prints the card's name and power limit
   (nvidia-smi) and the TF32 switches;
2. build   — builds every kernel in llm_instance_gateway_tpu_torch/ops/csrc
   with nvcc for sm_90a (one process per source, all at once), and reads
   the flash, chunk and flash backward libraries' SASS (cuobjdump): their
   bf16 kernels must run HGMMA (wgmma on the tensor cores), their f32
   kernels none, and the backward's none HMMA (mma.sync);
3. kernels — calls each kernel's wrapper at the serving paths' shapes,
   holds it against its plain PyTorch version (each output vector's error
   within 2^-6 of its largest value, SCALED_TOL, and every error within
   2e-2, ABS_TOL; the plain version with a
   skipped K/V tile, a dropped split or a misread pool block must fail
   that check), and times kernel, plain version and one PyTorch library
   call (a yardstick only): flash prefill (B=1; B=4 at bucket 128, a
   grouped prefill), lane decode (B=8 over S_max 1024, the target's
   lanes, and over S_max 8192, the draft's lanes of the paged spec
   server), chunk attention (C=1024 at start
   0/2048/5120 of an 8192-position lane, C=64 at start 640), paged
   decode (B=8, 64-token blocks, 128-block tables, shuffled, lengths
   0 .. 8192), and the int8 lane and paged decode kernels at the same
   shapes (int8 K/V with one f32 scale per position and KV head; the
   plain version fed one KV head's scales in place of another's must fail
   the check); flash and chunk rows add their rate (tflops, the live
   operations over the time), bound_frac (bound_ms / ms); every row
   host_us (host time per call: flash and chunk encode three TMA tensor
   maps per call) beside host_us_argtypes_per_call (the same wrapper with
   its ctypes restype/argtypes set again per call, as before
   ``_build.load`` set them once); the lane and paged decode
   rows, bf16 and int8 (split-S: a split kernel and a combine kernel per
   call) add the plan's split length and count, host_us, the profiler's
   device time per call (split + combine: at the lane shape a call costs
   the device less than the host spends issuing it, so CUDA events over
   back-to-back calls time the host) with its bound fraction, and the
   event and device times at other split lengths (split_sweep_ms,
   split_sweep_device_ms);
4. reference — the card's path (kernels) against the CPU path (plain
   versions) on a small f32 model with Llama-3-8B's head layout: prefill
   logits within a stated tolerance and identical greedy token streams,
   on a lane engine and on a paged engine with prefix cache and two
   stream lanes (a shared-prefix pair, prompts beyond the largest bucket),
   each also with an int8 KV cache, and on a lane engine with int8
   weights; then a pipelined lane engine with prefill_batch=4 and a
   pipelined paged engine (prefix cache, stream lanes) — graph replays of
   the decode block — against the CPU's sync engine; then speculative
   engines (K=3, lanes and paged, sync and pipelined — spec block graph
   replays — with a seeded one-layer draft and with the perfect draft)
   against the same engines on the CPU and the card's plain engine
   (tokens, spec_cycles and spec_emitted exact), and penalized and
   biased rows beside plain ones, sync and pipelined, card against CPU;
   the lane (f32, int8 KV, int8 weights), paged, pipelined and spec
   engines record top-5 logprobs, held to the CPU's within 5e-3 (LP_TOL:
   the 2e-3 on logits plus the log-sum-exp), top-5 ids equal wherever
   ranks lie apart;
5. serve   — starts the port's HTTP server at Llama-3-8B width and depth
   (random weights), loads a seeded LoRA adapter from .npz, answers six
   concurrent greedy completions (base and adapter rows, one streamed)
   and checks the launch counts over that window (flash at 32 per
   request, lane decode at 32 per decode step — graph replays counted —
   chunk and paged none); then profiles one 8B decode step and one
   1024-token prefill (torch.profiler: host wall, device time, device idle
   share, top kernels), each eager and as replays of a CUDA graph of the
   same call;
6. paged serve — the same weights behind ``--max-seq-len 8192
   --paged-kv-block 64 --paged-kv-blocks 768 --prefix-cache
   --stream-lanes 2``: five requests sharing a ~600-token system prompt
   and two concurrent long prompts (~3000 and ~6000 tokens), half on the
   adapter; checks prefix reuse, the paged kernel at 32 launches per decode
   step, the lane kernel at none, the chunk kernel at 32 per chunk
   program, the flash kernel at 32 per bucketed prefill (the cold
   misses), and KV usage back at its floor after the last request; then
   profiles one paged decode step over 8 long rows and one 1024-token
   chunk at start 5120;
7. int8 serve — phase 5 again behind ``--quantize int8 --kv-quantize
   int8`` (the int8 lane kernel at 32 per decode step, every other decode
   kernel at none), profiling one int8-weight decode step;
8. int8 paged serve — phase 6 again behind ``--quantize int8
   --kv-quantize int8`` with 1536 blocks (about the bytes of the bf16
   pool's 768): the int8 paged kernel at 32 per decode step, the chunk
   kernel at 32 per chunk program over dequantized lanes, flash at 32 per
   cold prefill; profiles one int8 paged decode step and one chunk, and
   prints the int8 profiles beside the bf16 ones;

9. dispatch — ``bench.py``'s device traffic on Llama-3-8B's widths at
   ``DISPATCH_LAYERS`` of its 32 layers (int8 weights, four rank-8
   adapters, 48 requests of 100 + 64 tokens at once — 100 + 16 on the A
   side, ``DISPATCH_A_NEW`` — 16 slots, buckets 128/256, 32 steps per
   dispatch) in turns A B B A: A the sync
   loop with the eager block and prefill_batch=1, B the pipelined loop
   replaying the block's graph with prefill_batch=4; decode tokens/s,
   TPOT and TTFT p50/p95, exact launch counts per run, and the greedy
   tokens where B differs from A (over A's tokens);
10. disagg — disaggregated serving at 8B: a ``--role prefill`` server
   (lanes) hands each prompt's KV over ``/v1/prefill`` -> ``/v1/attach`` to
   a ``--role decode`` server (paged pool, prefix cache, pipelined graph
   replays), beside a collocated server with the decode server's flags:
   greedy tokens equal bitwise, exact launch counts (flash 32 per hop on
   the prefill server only, the paged kernel 32 per decode step on the
   decode server only), the same graph keys, prefix reuse on repeated
   prompts, the longest prompt's pool rows equal bitwise, a release
   mid-stream, KV back at its floor, one chat request with ``logprobs:
   true, top_logprobs: 3`` over the hops equal to C's answer bitwise
   (envelope, tokens, logprob records); wire bytes, hop walls, serialize /
   deserialize / attach ms and TTFTs per request; then all of it again
   with ``--kv-quantize int8`` (the int8 wire and pools);
11. spec — speculative decoding and penalties at 8B (``phase_spec``): a
   lane server and a paged pipelined server with ``--speculative 4`` and
   the perfect draft (the target's own params), then a plain lane server
   with penalized and biased rows; exact launch counts (flash 32 per
   target prefill and per draft admission, the lane kernel 32 x (K-1) per
   spec cycle), the spec families on /metrics, graph keys, prefix reuse,
   KV at its floor, a penalty refused by the speculative server; prints
   tokens per cycle (base and adapter rows), agreement with the serve
   phase's plain answers, one replayed spec cycle's device ms and the
   engine's eager block split by its profiler ranges into the draft's
   and the verify's device ms, the paged verify at 8 long rows, decode
   tokens/s spec against plain, and capture seconds per graph key;
12. surface — the rest of the OpenAI surface, tracing, the flight
   recorder and the LoRA residency ladder at 8B (``phase_surface``): a
   lane server with ``--prefill-batch 4 --pipeline-decode``; chat against
   the same transcript on completions, ``logprobs: 5``, ``n: 3`` seeded
   (one grouped prefill, exact launches, each choice equal to a single
   request with seed s+i), ``best_of: 4, n: 2``, echo, a traced request,
   demote / promote / evict / prefetch with the adapter row's tokens
   bitwise the serve phase's, drain in the flight recorder; prints the
   profiler's shares (pipelined beside the serve phase's sync loop),
   promotion against disk load ms and the phase's wall;
13. families — the other model families (``phase_families``), the 8B
   tree freed first: each family's head layout at narrow width, f32, card
   against CPU (prefill logits, greedy streams and top-5 logprobs on a
   lane engine and on a paged engine with prefix cache and stream lanes):
   Qwen 28:4 at hd 128 with seeded non-zero q/k/v biases, Gemma-2B 8:1 at
   hd 256 (the Gemma flags, tied embeddings), Gemma-7B 16:16 at hd 256,
   Mixtral 32:8 at hd 128 with 8 experts, top-2 (also int8 weights, and a
   16-slot pipelined engine whose replayed decode block runs the grouped
   dispatch, then again with a zero router so every block overflows onto
   the dense result); flash (B=1, S 16 and 1024) and the lane kernel
   (int8 for Mixtral; the server's slots, 1024-token lanes) in bf16 at
   each full-width server's layout against their plain versions, with
   phase 3's limits; then ``--model qwen2.5-7b`` (seeded biases passed
   in as params), ``--model gemma-2b``, ``--model gemma-7b`` and
   ``--model mixtral-8x7b --quantize int8 --kv-quantize int8
   --decode-slots 16 --pipeline-decode`` (its int8 tree built a layer at
   a time) at full width and depth, one at a time, through the serve
   phase's own window (``phase_serve``): an adapter loaded, six
   completions with exact launch counts, KV back at its floor, one
   decode step and one 1024-token prefill profiled; for Mixtral a
   gate/up/down-only adapter answering as the base model and the
   replayed step in drop mode; prints init seconds, decode tokens/s,
   TTFT and peak memory per server;
14. checkpoint — trained-weight loading at Llama-3-8B width and depth
   (``phase_checkpoint``, run after phase 12 while the serve phase's bf16
   tree exists, everything it loads freed before phase 13): the tree
   written by ``save_hf_checkpoint`` as an HF directory (four <= 5 GB
   shards and an index, in a temporary directory removed at the end;
   refused, saying what is free, on a disk too small), then a lane
   server started with ``--checkpoint DIR`` and no params (the loaded
   tree equal to the written one leaf for leaf on the card, LLAMA3_8B's
   architecture, the serve phase's window with its .npz adapter giving
   the serve phase's answers token for token, exact launches), then
   ``--speculative 4 --draft-model llama3-8b --checkpoint DIR
   --draft-checkpoint DIR`` (the perfect draft from disk) on phase 11's
   lane wave: its answers and per-row tokens per cycle equal phase 11's
   in-memory perfect draft's, exact launches; prints the write's GB,
   seconds and GB/s (returned and synced), and each load's seconds, GB/s
   and peak device memory;

15. train — training at Llama-3-8B width and depth (``phase_train``, run
   after phase 14 while the serve phase's bf16 tree exists, before phase
   13): the flash backward kernel (``csrc/flash_backward.cu``) against
   its plain version (``check_grad``: phase 3's scaled rule, floored for
   gradients that cancel) at the training shape B=2 S=1023 H=32 K=8
   hd=128 in bf16 and f32, at Gemma's layouts (8:1, 16:16 at hd 256) and
   at S 1, 16, 127, 129, two runs bitwise equal, bf16 as training runs it
   (the training forward's lse handed over; the call without it must give
   the same bits), its route and group split recorded, timed beside its
   plain version, its bound and the SDPA backward (a yardstick), at
   S = 1023 also at every split the group allows and with the training
   forward beside the serving one; at S = 1023
   the plain gradients with one 64-row tile zeroed (dq's query tile 5,
   dk's ragged last key tile, dv's key tile 1) must fail the check; a
   narrow f32 model's loss, every gradient leaf and two AdamW steps,
   full and LoRA,
   card against CPU (wq/wk/wv and their LoRA leaves non-zero); ten LoRA
   steps on the frozen 8B tree (slot 0 at rank 8, a seeded, b zero: the
   first step moves b only; two seeded 1024-token rows) with the loss
   falling and exact launches (flash and backward 32 a step, nothing
   else), step walls, the profiled step's device ms, idle share and the
   backward kernels' share, peak memory; then the trained slot saved as
   .npz, loaded over ``/v1/load_lora_adapter`` on a lane server, whose
   greedy answers equal an in-process engine's holding the trained
   buffers and differ from the base model's;
16. mesh — tensor parallelism (``phase_mesh``): ``--mesh tensor=2``, both
   shards on cuda:0, at 8B through the serve phase's window, its logits
   against tensor=1 with planted faults, the narrow f32 model's tokens,
   Gemma-2B at tensor=2, the calibration fit;
17. sequence and expert — the two other mesh axes, every shard a view on
   cuda:0.  ``phase_sequence`` (after phase 16): ``--mesh sequence=2`` at
   8B behind the paged serve's window, the 3001- and 6001-token prompts
   one ring program each (no chunk stream, no flash on the ring, exact
   launches), again with ``--kv-quantize int8``; one ring prefill of the
   6001-token prompt profiled beside sequence=1's chunk stream of it; the
   ring's last-position logits against sequence=1's prefill within the
   mesh phase's 1/16 rule, with a skipped below-diagonal block and
   misplaced K/V blocks planted (each must fail it); the narrow f32
   model at sequence=2 and tensor=2,sequence=2, bf16-width and int8 KV,
   its tokens equal to sequence=1's.  ``phase_expert`` (inside phase 13,
   on its Mixtral-8x7B int8 tree): the logits at expert=2 against
   expert=1 under the same rule, with one shard's experts zeroed and the
   shards' experts swapped planted; the narrow Mixtral at expert=2
   replaying a 16-slot grouped decode, a zero router forcing the exact
   fallback (the dense result, the CPU's tokens); ``--mesh expert=2``
   served through the serve phase's window, its replayed decode step and
   peak memory beside expert=1's;
18. data, fsdp and pipe — the last three mesh axes, every shard a view on
   cuda:0 (``phase_axes`` after phase 17's sequence half, ``phase_pipe``
   once the 8B tree is freed): ``--mesh data=2`` at 8B through the serve
   phase's window (exact launches: the lane kernel once per data group),
   a decode step's logits of rows in both groups against data=1 within
   the mesh phase's 1/16 rule, with each group reading the other's lanes
   and a prompt's KV in the wrong group planted (each must fail it), the
   narrow f32 model's tokens equal to data=1's; ``--mesh fsdp=2`` through
   the same window on lanes (the replayed step profiled beside the serve
   phase's, the gathers' device ms alone) and on a 64-token-block pool,
   a 700-token prefill and eight greedy steps bitwise fsdp=1's on lanes
   and on the pool; the pipelined full-parameter train step at
   Llama-3-8B's widths and 8 layers (pipe=2, two microbatches of one
   1024-token row): two steps with flash and the backward at exactly 8
   x 2 launches each, the first step's loss and update against the
   unpipelined step's, walls and peak memory;
19. processes — the port across two processes on cuda:0, gloo between
   them (``phase_processes``, after phase 18's pipe half), the 8B's
   widths at ``PROC_LAYERS`` (8) of its 32 layers: ``--mesh
   tensor=2`` served in lockstep (the sync loop, then the pipelined
   loop with the adaptive planner token for token the same, then a
   handoff parked past its TTL with rank 1's clock frozen, released on
   both ranks: the ``lockstep`` line of ``[walls]``) and its decode
   logits against one process's with planted faults, the 8B LoRA step
   at tensor=2 and
   data=2; ``--mesh sequence=2`` (each process a whole 8B tree and its
   own lane cache): the 6001-token prompt in one ring program a process,
   its K/V exchanged, tokens equal across the ranks, the ring's last
   logits against one process's ring with a dropped block and reversed
   blocks planted; two 8B LoRA steps at sequence=2 (the ring, no kernel
   launched) and two at expert=2 on Mixtral-8x7B's widths at 4 layers,
   each against the one-process step;
20. pipe processes — the pipelined full-parameter step with a stage a
   process (``phase_pipe_processes``, after phase 19): two processes on
   cuda:0 over gloo, phase 18's 8-layer tree and batch, the activations
   and their gradients sent point to point; four steps with flash and
   the backward at exactly 4 x 2 launches each in each process, the
   first loss and update against phase 18's one-process pipelined step,
   microbatches swapped at the boundary planted (it must fail), step
   walls, the boundary's host ms and bytes and peak memory per process;
21. layouts — a head layout the reference's kernels do not split
   (``phase_layouts``, inside phase 13 after its Qwen2.5-7B server, on
   that tree): Qwen2.5-7B at ``--mesh tensor=8`` on cuda:0 through the
   head plan (4:1 a shard, each KV head on two shards, each group of 7
   padded with a zero head), its logits against tensor=1 with planted
   faults, the lane window and an int8 KV pool window, exact launches
   per shard, the plan's bytes;
22. layouts train — training on that layout (``phase_layouts_train``,
   the end of phase 21, on its tree): two rank-8 LoRA steps at full width
   and depth at tensor=8 and at tensor=1 (two 1024-token rows), the first
   loss and the update gated, the zero heads' ``o_a`` rows exactly 0 and
   the KV replicas bitwise equal, exact launches per shard; two
   full-parameter steps at Qwen2.5-7B's widths cut to 2 layers gated the
   same way, and again with the zero heads' gradients left in and with
   the KV replicas each left with its own shard's gradient planted (each
   must fail the gate);
   the flash backward at the shard layout against its plain version;

each phase's end is logged as seconds since start (``[walls]``); then
prints one JSON line with every kernel's numbers (launches over the
serve phases, the dispatch phase's B runs, the disagg phase's hops, the
spec phase's servers, the surface phase's, the checkpoint phase's, the
families', the train phase's and the mesh axes' phases),
the nvidia-smi line, and last the device JSON line.  Imports nothing of
JAX.

    python3 chip_smoke.py --ab DIR

compares another checkout of the repo (DIR, e.g. the parent commit
unpacked with ``git archive``) with this one on the same card: the lane
serve phase (its decode step's eager and replayed profile) and the
dispatch phase of each tree, every run a process of its own, in the
order DIR, this, this, DIR; one ``[ab]`` JSON line per run, then the
runs side by side.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bound_ms = max(bytes/BW, flops/peak).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Kernel vs plain version, per output vector (hd values): max |got - want|
# over max |want| of that vector.  The limit scales with the output: a
# query over n keys with N(0, 1) logits gives outputs of about
# sqrt(e / n) (~0.02 at n = 6000), where a flat absolute limit would pass
# a skipped K/V tile.  Rounding the bf16 output makes up to one ulp of it
# (2^-7 of the vector's largest value); the limit is 4 ulps at 2^-8.
# The flat absolute limit stays as a ceiling for large outputs.
SCALED_TOL = 2.0 ** -6
ABS_TOL = 2e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def scaled_err(got, want) -> float:
    """Largest error of an output vector (the last dim) over that vector's
    largest |value| in the plain version."""
    g, w = got.float(), want.float()
    num = (g - w).abs().amax(-1)
    return (num / w.abs().amax(-1).clamp_min(1e-30)).max().item()


def check_kernel(name: str, got, want) -> dict:
    """Hold a kernel's output to its plain version's: the scaled error
    within SCALED_TOL and the absolute one within ABS_TOL.  Returns both
    error measures."""
    err = (got.float() - want.float()).abs().max().item()
    scaled = scaled_err(got, want)
    if not (math.isfinite(err) and math.isfinite(scaled)) \
            or scaled > SCALED_TOL or err > ABS_TOL:
        raise AssertionError(f"{name}: scaled error {scaled} (limit "
                             f"{SCALED_TOL}), max_abs_err {err} (limit "
                             f"{ABS_TOL})")
    return dict(max_abs_err=err, scaled_err=scaled)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call, cycling through ``arg_sets`` (copies of the
    inputs that together exceed the 50 MB L2, so each call reads cold)."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, args, iters: int = 50) -> float:
    """Host microseconds per call (wrapper checks, the launch and,
    for flash and chunk, encoding three TMA tensor maps): host clock over
    ``iters`` calls that are not synchronized."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e6


def host_us_pair(torch, lib: str, fn, args) -> dict:
    """``host_us`` of the wrapper as it is (``_build.load`` typed the
    launch function once) and with the launch function's ``restype`` and
    ``argtypes`` set again before every call, as the wrappers did before:
    the host cost of that per-call setting, in the same run."""
    import ctypes

    from llm_instance_gateway_tpu_torch.ops import _build

    launch = getattr(_build.load(lib), f"{lib}_launch")

    def per_call(*a):
        launch.restype = ctypes.c_int
        launch.argtypes = list(_build.SIGNATURES[lib])
        return fn(*a)

    return dict(host_us=host_us(torch, fn, args),
                host_us_argtypes_per_call=host_us(torch, per_call, args))


def device_ms(torch, fn, arg_sets, calls: int = 20) -> dict:
    """Device time per call from torch.profiler: every CUDA kernel the
    calls ran (split-S decode: split + combine), summed, over ``calls``
    calls cycling through ``arg_sets`` — where a call costs the device less
    than the host spends issuing it, CUDA events over back-to-back calls
    time the host."""
    from torch.profiler import ProfilerActivity, profile

    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ("combine" if "combine_kernel" in ev.key else "split"
                    if "split_kernel" in ev.key else ev.key[:60])
            kernels[name] = kernels.get(name, 0.0) + us / calls / 1e3
    total = sum(kernels.values())
    return {"device_ms": total if total else "not measured",
            "device_kernels_ms": kernels}


def split_sweep(torch, fn, arg_sets, split_lens) -> dict:
    """A split-S decode kernel at other split lengths than the plan's, on
    the same inputs: CUDA-event ms per call (``split_sweep_ms``) and the
    profiler's device ms per call (``split_sweep_device_ms``), which alone
    ranks the split lengths where the host paces the events."""
    fns = {n: (lambda *a, n=n: fn(*a, split_len=n)) for n in split_lens}
    return dict(
        split_sweep_ms={str(n): time_ms(torch, f, arg_sets)
                        for n, f in fns.items()},
        split_sweep_device_ms={str(n): device_ms(torch, f, arg_sets)[
            "device_ms"] for n, f in fns.items()})


def copies_for(nbytes: int) -> int:
    return max(1, min(16, math.ceil(128e6 / max(nbytes, 1))))


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke test needs a CUDA GPU")
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    from llm_instance_gateway_tpu_torch.ops import _build

    t0 = time.time()
    paths = _build.build_all(verbose=True)
    secs = time.time() - t0
    for name, log_text in _build.build_all.last_log.items():
        for line in log_text.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "warning" in line):
                log("build", f"{name}: {line.strip()}")
    log("build", f"built {sorted(paths)} in {secs:.2f} s")
    for name in ("flash_prefill", "chunk_attention"):
        check_tensor_cores(name, paths[name])
    check_backward_sass(paths["flash_backward"])


def sass_kernels(path: str) -> list:
    """(mangled name, SASS) of each kernel in the library (cuobjdump)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)", sass,
                      re.S)


def check_tensor_cores(name: str, path: str) -> None:
    """The library's SASS, one count per kernel: each bf16 (tensor-core)
    kernel of flash_tile_sm90.cuh must contain HGMMA, each f32 (FMA)
    kernel of flash_tile.cuh none."""
    import re

    counts = {"bf16": {}, "f32": {}}
    for fn, body in sass_kernels(path):
        kind = "bf16" if "flash_tile_sm90" in fn else "f32"
        hd = int(re.search(r"flash_kernelILi(\d+)E", fn).group(1))
        counts[kind][hd] = n = body.count("HGMMA")
        if (n > 0) != (kind == "bf16"):
            raise AssertionError(f"{name}: {fn} has {n} HGMMA instructions")
    if sorted(counts["bf16"]) != [64, 128, 256] \
            or sorted(counts["f32"]) != [64, 128, 256]:
        raise AssertionError(f"{name}: expected bf16 and f32 kernels at hd "
                             f"64/128/256, found {counts}")
    log("build", f"{name} SASS: HGMMA instructions per kernel by head dim "
        f"{json.dumps(counts)}")


def check_backward_sass(path: str) -> None:
    """The flash backward library's SASS: its bf16 kernels (the training
    forward, dK/dV, dQ) at each head dim must run HGMMA (wgmma), its f32
    kernels (stats, dK/dV, dQ) none, and no kernel HMMA (mma.sync): no
    mma.sync or FMA route is left for bf16."""
    import re

    counts: dict = {}
    for fn, body in sass_kernels(path):
        kind = next((k for k in ("flash_kernel", "dkdv_kernel", "dq_kernel",
                                 "stats_kernel", "dkdv_f32_kernel",
                                 "dq_f32_kernel", "delta_kernel",
                                 "reduce_kernel") if k in fn), fn)
        hd = re.search(r"kernelILi(\d+)E", fn)
        n, mma = body.count("HGMMA"), body.count("HMMA")
        counts.setdefault(kind, {})[hd.group(1) if hd else "-"] = n
        wgmma = kind in ("flash_kernel", "dkdv_kernel", "dq_kernel")
        if mma or (n > 0) != wgmma:
            raise AssertionError(f"flash_backward: {fn} has {n} HGMMA and "
                                 f"{mma} HMMA instructions")
    for kind in ("flash_kernel", "dkdv_kernel", "dq_kernel", "stats_kernel",
                 "dkdv_f32_kernel", "dq_f32_kernel", "delta_kernel"):
        if sorted(counts.get(kind, {})) != ["128", "256", "64"]:
            raise AssertionError(f"flash_backward: expected {kind} at hd "
                                 f"64/128/256, found {counts}")
    log("build", "flash_backward SASS: HGMMA instructions per kernel by "
        f"head dim (no HMMA anywhere) {json.dumps(counts)}")


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version at the serving path's shapes."""
    from llm_instance_gateway_tpu_torch.ops import flash_attention as fl
    import torch.nn.functional as F

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    H, K, HD = 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # -- flash prefill: B=1 at buckets 16, 128, 1024; B=4 at 128 (a
    # grouped prefill, prefill_batch=4, of the dispatch phase's bucket) --
    flash_rows = []
    for b, s in ((1, 16), (1, 128), (4, 128), (1, 1024)):
        q = torch.randn(b, s, H, HD, device=dev, generator=gen).to(bf16)
        k = torch.randn(b, s, K, HD, device=dev, generator=gen).to(bf16)
        v = torch.randn(b, s, K, HD, device=dev, generator=gen).to(bf16)
        got = fl.flash_attention(q, k, v)
        want = fl.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        errs = check_kernel(f"flash B={b} S={s}", got, want)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        sets = [(q.clone(), k.clone(), v.clone())
                for _ in range(copies_for(nbytes))]
        ms = time_ms(torch, fl.flash_attention, sets)
        plain_ms = time_ms(torch, fl.flash_attention_reference, sets[:2],
                           iters=5)
        bsets = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
                  c.transpose(1, 2).contiguous()) for a, b, c in sets]
        lib_ms = time_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), bsets)
        ops = 2 * b * H * s * (s + 1) * HD
        row = dict(shape=f"B={b} S={s} H={H} K={K} hd={HD} bf16",
                   **errs, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, **_bound(nbytes, ops),
                   **host_us_pair(torch, "flash_prefill", fl.flash_attention,
                                  sets[0]))
        row.update(_rate(ops, row))
        flash_rows.append(row)
        log("kernels", "flash_prefill " + json.dumps(row))
    results["flash_prefill"] = flash_rows

    # -- lane decode: the target's lanes (S_max=1024) and the draft's
    # lanes of the paged spec server (S_max=8192, 16 splits of 512) --
    results["decode_attention"] = [
        _decode_row(torch, gen, 1024, [0, 1, 777, 1024, 5, 300, 512, 1000],
                    (64, 128, 256, 512, 1024)),
        _decode_row(torch, gen, 8192, [0, 1, 650, 8192, 5, 700, 1000, 6000],
                    (128, 256, 512, 1024, 2048))]
    results["chunk_attention"] = _chunk_rows(torch, gen)
    results["paged_decode_attention"] = _paged_rows(torch, gen)
    results["decode_attention_quant"] = _decode_quant_rows(torch, gen)
    results["paged_decode_attention_quant"] = _paged_quant_rows(torch, gen)
    return results


def _decode_row(torch, gen, s_max: int, lens: list, sweep: tuple) -> dict:
    """Lane decode at B=8 over an ``s_max`` lane with ragged ``lens``
    (0 and 1 among them), against its plain version.  Yardstick: masked
    SDPA."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    import torch.nn.functional as F

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    H, K, HD, B = 32, 8, 128, len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(B, H, HD, device=dev, generator=gen).to(bf16)
    kc = torch.randn(B, s_max, K, HD, device=dev, generator=gen).to(bf16)
    vc = torch.randn(B, s_max, K, HD, device=dev, generator=gen).to(bf16)
    got = dec.decode_attention(q, kc, vc, lengths)
    want = dec.decode_attention_reference(q, kc, vc, lengths)
    torch.cuda.synchronize()
    errs = check_kernel(f"decode S_max={s_max}", got, want)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("decode: a length-0 row must give zeros")
    split_len, n_split = dec.split_plan(B, K, s_max,
                                        dec.tile_positions(HD, bf16),
                                        dec.sm_count(dev))
    if n_split > 1:
        # The check's reach: the plain version with the longest row's
        # second split left out (a kernel that dropped it) must fail it.
        i, cut = lens.index(max(lens)), slice(split_len, 2 * split_len)
        keep = torch.ones(s_max, dtype=torch.bool, device=dev)
        keep[cut] = False
        short = lengths.clone()
        short[i] -= split_len
        dropped = dec.decode_attention_reference(
            q, kc[:, keep], vc[:, keep], short)
        errs["dropped_split_scaled_err"] = scaled_err(dropped[i], want[i])
        if errs["dropped_split_scaled_err"] <= SCALED_TOL:
            raise AssertionError(f"decode S_max={s_max}: a dropped split "
                                 f"passes the check: {errs}")
        del dropped
    del want
    total_len = int(lengths.sum().item())
    kv_bytes = 2 * total_len * K * HD * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + B * 4
    sets = [(q.clone(), kc.clone(), vc.clone(), lengths.clone())
            for _ in range(copies_for(kc.numel() * 4))]
    ms = time_ms(torch, dec.decode_attention, sets)
    plain_ms = time_ms(torch, dec.decode_attention_reference, sets)
    mask = (torch.arange(s_max, device=dev)[None] < lengths[:, None])
    bsets = [(a[:, :, None], b.transpose(1, 2).contiguous(),
              c.transpose(1, 2).contiguous(), mask[:, None, None])
             for a, b, c, _ in sets]
    lib_ms = time_ms(torch, lambda a, b, c, m: F.scaled_dot_product_attention(
        a, b, c, attn_mask=m, enable_gqa=True), bsets)
    del bsets
    row = dict(shape=f"B={B} S_max={s_max} H={H} K={K} hd={HD} bf16 "
               f"lengths={lens}",
               **errs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **_bound(nbytes, 2 * 2 * total_len * H * HD),
               **host_us_pair(torch, "decode_attention", dec.decode_attention,
                              sets[0]),
               split_len=split_len, n_split=n_split,
               **device_ms(torch, dec.decode_attention, sets),
               **split_sweep(torch, dec.decode_attention_split, sets, sweep))
    row.update(_split_fracs(row))
    log("kernels", "decode_attention " + json.dumps(row))
    return row


def _int8_kv(torch, gen, shape):
    """Random K or V quantized as the serving path does: (int8, f32
    scales)."""
    from llm_instance_gateway_tpu_torch.models.transformer import _kv_quantize

    return _kv_quantize(torch.randn(*shape, device="cuda", generator=gen))


def _swapped_scales_err(plain, want, args, scale_idx) -> float:
    """The check's reach on int8: the plain version fed KV head 0's scales
    in place of head 1's (a kernel that misindexed its scales) must fail
    it."""
    wrong = list(args)
    for i in scale_idx:
        wrong[i] = wrong[i].clone()
        wrong[i][..., 1] = wrong[i][..., 0]
    err = scaled_err(plain(*wrong), want)
    if err <= SCALED_TOL:
        raise AssertionError(f"swapped head scales pass the check: {err}")
    return err


def _decode_quant_rows(torch, gen) -> list:
    """int8 lane decode at the lane path's shape (B=8, S_max=1024, the bf16
    row's lengths).  Yardstick: dequantize + masked SDPA, timed as a
    pair."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    import torch.nn.functional as F

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    H, K, HD, B, S_MAX = 32, 8, 128, 8, 1024
    lengths = torch.tensor([0, 1, 777, 1024, 5, 300, 512, 1000],
                           dtype=torch.int32, device=dev)
    q = torch.randn(B, H, HD, device=dev, generator=gen).to(bf16)
    kq, ks = _int8_kv(torch, gen, (B, S_MAX, K, HD))
    vq, vs = _int8_kv(torch, gen, (B, S_MAX, K, HD))
    args = (q, kq, vq, ks, vs, lengths)

    def kernel(q, kq, vq, ks, vs, lengths):
        return dec.decode_attention(q, kq, vq, lengths, ks, vs)

    got = kernel(*args)
    want = dec.decode_attention_quant_reference(*args)
    torch.cuda.synchronize()
    errs = check_kernel("decode int8", got, want)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("decode int8: a length-0 row must give zeros")
    errs["swapped_scales_scaled_err"] = _swapped_scales_err(
        dec.decode_attention_quant_reference, want, args, (3, 4))
    total_len = int(lengths.sum().item())
    sets = [tuple(a.clone() for a in args)
            for _ in range(copies_for(2 * kq.numel() + 2 * ks.numel() * 4))]
    ms = time_ms(torch, kernel, sets)
    plain_ms = time_ms(torch, dec.decode_attention_quant_reference, sets)
    mask = (torch.arange(S_MAX, device=dev)[None] < lengths[:, None])

    def deq_sdpa(q, kq, vq, ks, vs, _lengths):
        k = dec.dequantize_kv(kq, ks, bf16).transpose(1, 2)
        v = dec.dequantize_kv(vq, vs, bf16).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask[:, None, None],
            enable_gqa=True)

    lib_ms = time_ms(torch, deq_sdpa, sets)
    nbytes = (2 * total_len * K * (HD + 4) + 2 * q.numel() * 2 + B * 4)
    split_len, n_split = dec.split_plan(B, K, S_MAX,
                                        dec.tile_positions(HD, bf16),
                                        dec.sm_count(dev))

    def split(q, kq, vq, ks, vs, lengths, split_len):
        return dec.decode_attention_split(q, kq, vq, lengths, split_len, ks,
                                          vs)

    row = dict(shape=f"B={B} S_max={S_MAX} H={H} K={K} hd={HD} q bf16, "
               f"k/v int8 + f32 scales, lengths={lengths.tolist()}",
               **errs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library="dequantize + masked SDPA, timed as a pair",
               **_bound(nbytes, 2 * 2 * total_len * H * HD),
               **host_us_pair(torch, "decode_attention_quant", kernel,
                              sets[0]),
               split_len=split_len, n_split=n_split,
               **device_ms(torch, kernel, sets),
               **split_sweep(torch, split, sets,
                             (64, 128, 256, 512, 1024)))
    row.update(_split_fracs(row))
    log("kernels", "decode_attention_quant " + json.dumps(row))
    return [row]


def _paged_quant_rows(torch, gen) -> list:
    """int8 paged decode at the paged path's shape (B=8, 64-token blocks,
    128-block tables, shuffled, the bf16 row's lengths).  Yardstick:
    gather + dequantize + masked SDPA, timed as a pair."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    from llm_instance_gateway_tpu_torch.ops import paged_decode_attention as pd
    from llm_instance_gateway_tpu_torch.ops.attention import gather_pool_rows
    import torch.nn.functional as F

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    H, K, HD, B, PAGE, M = 32, 8, 128, 8, 64, 128
    n_blocks = B * M
    lengths = torch.tensor([0, 1, 100, 6000, 3000, 640, 4096, 8192],
                           dtype=torch.int32, device=dev)
    q = torch.randn(B, H, HD, device=dev, generator=gen).to(bf16)
    kq, ks = _int8_kv(torch, gen, (n_blocks + 1, PAGE, K, HD))
    vq, vs = _int8_kv(torch, gen, (n_blocks + 1, PAGE, K, HD))
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(6))
    tables = (perm + 1).reshape(B, M).to(torch.int32).to(dev)
    tables[0] = 0  # the length-0 row maps only the trash block
    args = (q, kq, vq, tables, lengths, ks, vs)
    got = pd.paged_decode_attention(*args)
    want = pd.paged_decode_attention_quant_reference(*args)
    torch.cuda.synchronize()
    errs = check_kernel("paged decode int8", got, want)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("paged decode int8: a length-0 row must give "
                             "zeros")
    errs["swapped_scales_scaled_err"] = _swapped_scales_err(
        pd.paged_decode_attention_quant_reference, want, args, (5, 6))
    sets = [args, tuple(a.clone() for a in args)]  # the pools exceed L2
    ms = time_ms(torch, pd.paged_decode_attention, sets)
    plain_ms = time_ms(torch, pd.paged_decode_attention_quant_reference,
                       sets, iters=5)
    mask = (torch.arange(M * PAGE, device=dev)[None] < lengths[:, None])

    def gather_deq_sdpa(q, kq, vq, tables, _lengths, ks, vs):
        k = dec.dequantize_kv(gather_pool_rows(kq, tables),
                              gather_pool_rows(ks, tables), bf16)
        v = dec.dequantize_kv(gather_pool_rows(vq, tables),
                              gather_pool_rows(vs, tables), bf16)
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None], enable_gqa=True)

    lib_ms = time_ms(torch, gather_deq_sdpa, sets)
    total_len = int(lengths.sum().item())
    nbytes = (2 * total_len * K * (HD + 4) + 2 * q.numel() * 2 + B * 4
              + total_len // PAGE * 4)
    split_len, n_split = dec.split_plan(B, K, M * PAGE,
                                        dec.tile_positions(HD, bf16),
                                        dec.sm_count(dev), PAGE)

    def split(q, kq, vq, tables, lengths, ks, vs, split_len):
        return pd.paged_decode_attention_split(q, kq, vq, tables, lengths,
                                               split_len, ks, vs)

    row = dict(shape=f"B={B} P={PAGE} M={M} H={H} K={K} hd={HD} q bf16, "
               f"int8 pools + f32 scale pools, lengths={lengths.tolist()}",
               **errs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library="gather_pool_rows + dequantize + masked SDPA, timed "
               "as a pair",
               **_bound(nbytes, 2 * 2 * total_len * H * HD),
               **host_us_pair(torch, "paged_decode_attention_quant",
                              pd.paged_decode_attention, sets[0]),
               split_len=split_len, n_split=n_split,
               **device_ms(torch, pd.paged_decode_attention, sets),
               **split_sweep(torch, split, sets,
                             (128, 256, 512, 1024, 2048)))
    row.update(_split_fracs(row))
    log("kernels", "paged_decode_attention_quant " + json.dumps(row))
    return [row]


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _rate(ops: float, row: dict) -> dict:
    """The live operations per second the kernel reached, and its share of
    the bound."""
    return dict(tflops=ops / row["ms"] / 1e9,
                bound_frac=row["bound_ms"] / row["ms"])


def _split_fracs(row: dict) -> dict:
    """A split-S decode row's share of its bound, by event time and by the
    profiler's device time."""
    out = {"bound_frac": row["bound_ms"] / row["ms"]}
    if isinstance(row["device_ms"], float):
        out["device_bound_frac"] = row["bound_ms"] / row["device_ms"]
    return out


def _chunk_rows(torch, gen) -> list:
    """Chunk attention at the chunk paths' shapes: 1024-token stream chunks
    at start 0 / 2048 / 5120 of an 8192-position lane, and a 64-token
    prefix-hit suffix at start 640.  Yardstick: SDPA over the first
    start + C positions with an explicit boolean mask."""
    from llm_instance_gateway_tpu_torch.ops import chunk_attention as ch
    import torch.nn.functional as F

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    H, K, HD, S_MAX = 32, 8, 128, 8192
    rows = []
    for c, start in ((64, 640), (1024, 0), (1024, 2048), (1024, 5120)):
        q = torch.randn(1, c, H, HD, device=dev, generator=gen).to(bf16)
        k = torch.randn(1, S_MAX, K, HD, device=dev, generator=gen).to(bf16)
        v = torch.randn(1, S_MAX, K, HD, device=dev, generator=gen).to(bf16)
        got = ch.chunk_attention(q, k, v, start)
        want = ch.chunk_attention_reference(q, k, v, start)
        torch.cuda.synchronize()
        errs = check_kernel(f"chunk C={c} start={start}", got, want)
        if start:
            # The check's reach: the plain version with one 64-key tile
            # left out (a kernel that skipped it) must fail it.
            t0 = start // 128 * 64
            cut = [torch.cat([x[:, :t0], x[:, t0 + 64:]], 1) for x in (k, v)]
            skipped = ch.chunk_attention_reference(q, *cut, start - 64)
            errs["skipped_tile_scaled_err"] = scaled_err(skipped, want)
            if errs["skipped_tile_scaled_err"] <= SCALED_TOL:
                raise AssertionError(f"chunk C={c} start={start}: a skipped "
                                     f"tile passes the check: {errs}")
            del cut, skipped
        del want
        reach = min(start + c, S_MAX)  # key positions the chunk can see
        sets = [(q.clone(), k.clone(), v.clone(), start)
                for _ in range(copies_for((q.numel() + 2 * k.numel()) * 2))]
        ms = time_ms(torch, ch.chunk_attention, sets)
        plain_ms = time_ms(torch, ch.chunk_attention_reference, sets[:1],
                           iters=3, warmup=1)
        mask = (torch.arange(reach, device=dev)[None]
                <= start + torch.arange(c, device=dev)[:, None])
        bsets = [(a.transpose(1, 2).contiguous(),
                  b[:, :reach].transpose(1, 2).contiguous(),
                  d[:, :reach].transpose(1, 2).contiguous(), mask)
                 for a, b, d, _ in sets]
        lib_ms = time_ms(torch, lambda a, b, d, m: F.scaled_dot_product_attention(
            a, b, d, attn_mask=m, enable_gqa=True), bsets)
        ops = 4 * H * HD * c * (start + (c + 1) / 2)
        nbytes = (2 * q.numel() + 2 * reach * K * HD) * 2
        row = dict(shape=f"B=1 C={c} start={start} S_max={S_MAX} H={H} K={K} "
                   f"hd={HD} bf16", **errs, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library="SDPA, boolean mask over the "
                   "first start+C positions", **_bound(nbytes, ops),
                   **host_us_pair(torch, "chunk_attention",
                                  ch.chunk_attention, sets[0]))
        row.update(_rate(ops, row))
        rows.append(row)
        log("kernels", "chunk_attention " + json.dumps(row))
        del sets, bsets
    return rows


def _paged_rows(torch, gen) -> list:
    """Paged decode at the paged engine's shapes: B=8 rows, 64-token
    blocks, 128-block tables (8192 positions), shuffled physical blocks,
    lengths 0 / 1 / a mid-block end / ~6000.  Yardstick: gather_pool_rows
    then masked SDPA, timed as a pair."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    from llm_instance_gateway_tpu_torch.ops import paged_decode_attention as pd
    from llm_instance_gateway_tpu_torch.ops.attention import gather_pool_rows
    import torch.nn.functional as F

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    H, K, HD, B, PAGE, M = 32, 8, 128, 8, 64, 128
    n_blocks = B * M
    lengths = torch.tensor([0, 1, 100, 6000, 3000, 640, 4096, 8192],
                           dtype=torch.int32, device=dev)
    q = torch.randn(B, H, HD, device=dev, generator=gen).to(bf16)
    kp = torch.randn(n_blocks + 1, PAGE, K, HD, device=dev,
                     generator=gen).to(bf16)
    vp = torch.randn(n_blocks + 1, PAGE, K, HD, device=dev,
                     generator=gen).to(bf16)
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(5))
    tables = (perm + 1).reshape(B, M).to(torch.int32).to(dev)
    tables[0] = 0  # the length-0 row maps only the trash block
    got = pd.paged_decode_attention(q, kp, vp, tables, lengths)
    want = pd.paged_decode_attention_reference(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    errs = check_kernel("paged decode", got, want)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("paged decode: a length-0 row must give zeros")
    # The check's reach: the plain version reading one wrong physical block
    # of the 6000-token row (a kernel that misread its table) must fail it.
    wrong = tables.clone()
    wrong[3, 40] = tables[3, 100]  # a block past that row's length
    misread = pd.paged_decode_attention_reference(q, kp, vp, wrong, lengths)
    errs["wrong_block_scaled_err"] = scaled_err(misread, want)
    if errs["wrong_block_scaled_err"] <= SCALED_TOL:
        raise AssertionError(f"paged decode: a misread block passes the "
                             f"check: {errs}")
    sets = [(q, kp, vp, tables, lengths)]  # the pools alone exceed L2
    ms = time_ms(torch, pd.paged_decode_attention, sets)
    plain_ms = time_ms(torch, pd.paged_decode_attention_reference, sets,
                       iters=5)
    mask = (torch.arange(M * PAGE, device=dev)[None] < lengths[:, None])

    def gather_sdpa(q, kp, vp, tables, _lengths):
        k = gather_pool_rows(kp, tables).transpose(1, 2)
        v = gather_pool_rows(vp, tables).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask[:, None, None],
            enable_gqa=True)

    lib_ms = time_ms(torch, gather_sdpa, sets)
    total_len = int(lengths.sum().item())
    nbytes = (2 * total_len * K * HD * 2 + 2 * q.numel() * 2
              + B * 4 + total_len // PAGE * 4)
    split_len, n_split = dec.split_plan(B, K, M * PAGE,
                                        dec.tile_positions(HD, bf16),
                                        dec.sm_count(dev), PAGE)
    row = dict(shape=f"B={B} P={PAGE} M={M} H={H} K={K} hd={HD} bf16 "
               f"lengths={lengths.tolist()}", **errs, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library="gather_pool_rows + masked SDPA, timed as a pair",
               **_bound(nbytes, 2 * 2 * total_len * H * HD),
               **host_us_pair(torch, "paged_decode_attention",
                              pd.paged_decode_attention, sets[0]),
               split_len=split_len, n_split=n_split,
               **device_ms(torch, pd.paged_decode_attention, sets),
               **split_sweep(
                   torch, pd.paged_decode_attention_split, sets,
                   (128, 256, 512, 1024, 2048)))
    row.update(_split_fracs(row))
    log("kernels", "paged_decode_attention " + json.dumps(row))
    return [row]


# Card-vs-CPU logprob tolerance: the reference phase's 2e-3 on logits plus
# the log-sum-exp over the vocabulary.
LP_TOL = 5e-3
LP_ERRS: dict = {}  # engine -> max logprob error, card against CPU


def _check_logprobs(what: str, want: list, got: list) -> float:
    """Requests recorded with ``logprobs=5``, the card's (``got``) against
    the CPU's (``want``): every sampled logprob and every top-5 value
    within LP_TOL (tops compared rank by rank), the top-5 ids equal at
    every rank whose neighbours in the CPU's list lie more than LP_TOL away
    (the last rank's lower neighbour is not recorded, so it is held by
    value only).  Returns the largest error and keeps it in LP_ERRS."""
    err = 0.0
    for w, g in zip(want, got, strict=True):
        n = len(g.output_tokens)
        if not (len(w.output_logprobs) == len(g.output_logprobs) == n
                == len(w.output_top_logprobs) == len(g.output_top_logprobs)):
            raise AssertionError(f"{what}: logprob records misaligned")
        for lw, lg, tw, tg in zip(w.output_logprobs, g.output_logprobs,
                                  w.output_top_logprobs,
                                  g.output_top_logprobs):
            err = max(err, abs(lw - lg))
            rw = sorted(tw.items(), key=lambda kv: -kv[1])
            rg = sorted(tg.items(), key=lambda kv: -kv[1])
            if len(rw) != len(rg) or len(rw) != 5:
                raise AssertionError(f"{what}: top lists {rw} / {rg}")
            vals = [v for _, v in rw]
            for j, ((iw, vw), (ig, vg)) in enumerate(zip(rw, rg)):
                err = max(err, abs(vw - vg))
                apart = ((j == 0 or vals[j - 1] - vals[j] > LP_TOL)
                         and j + 1 < len(vals)
                         and vals[j] - vals[j + 1] > LP_TOL)
                if apart and iw != ig:
                    raise AssertionError(f"{what}: top-5 rank {j}: card "
                                         f"{rg} cpu {rw}")
    if not math.isfinite(err) or err > LP_TOL:
        raise AssertionError(f"{what}: logprob error {err} > {LP_TOL}")
    LP_ERRS[what] = err
    return err


# Card-vs-CPU logit tolerance of the small f32 models (TF32 off:
# summation order only).
REF_TOL = 2e-3


def _to_card(tree):
    """A params tree (int8 {"q", "s"} leaves included) on the card."""
    return {k: _to_card(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


def _prefill_err(torch, what: str, cfg, cpu_p, gpu_p) -> float:
    """One 64-token prefill's logits, card against CPU, within REF_TOL;
    returns the largest error."""
    from llm_instance_gateway_tpu_torch.models import transformer

    tokens = torch.randint(0, 256, (1, 64), generator=torch.Generator()
                           .manual_seed(3))
    positions = torch.arange(64)[None]
    want, _, _ = transformer.prefill(cfg, cpu_p, tokens, positions)
    got, _, _ = transformer.prefill(cfg, gpu_p, tokens.cuda(),
                                    positions.cuda())
    err = (got.cpu() - want).abs().max().item()
    if not math.isfinite(err) or err > REF_TOL:
        raise AssertionError(f"{what}: prefill logits err {err} > {REF_TOL}")
    return err


def phase_reference(torch) -> None:
    """The card's path (kernels, f32) against the CPU path (plain versions)
    on one small model with Llama-3-8B's head layout: prefill logits within
    REF_TOL, and identical greedy token streams through the Engine — with
    f32 weights and KV, with an int8 KV cache, and with int8
    weights (``quantize_params``, what ``--quantize int8`` runs)."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_params

    cfg = dataclasses.replace(LLAMA3_8B, name="llama3-8b-narrow", d_model=512,
                              n_layers=2, n_heads=8, n_kv_heads=2,
                              head_dim=128, d_ff=1024, vocab_size=320)
    cpu_params = transformer.init_params(cfg, seed=7, dtype=torch.float32,
                                         device="cpu")
    cpu_q = quantize_params(cpu_params)  # what --quantize int8 runs
    gpu_params, gpu_q = _to_card(cpu_params), _to_card(cpu_q)
    errs = {name: _prefill_err(torch, f"reference ({name})", cfg, cpu_p,
                               gpu_p)
            for name, cpu_p, gpu_p in (("f32", cpu_params, gpu_params),
                                       ("int8 weights", cpu_q, gpu_q))}

    for name, params_by_dev, kv_quant in (
            ("f32 weights and KV", (cpu_params, gpu_params), None),
            ("int8 KV", (cpu_params, gpu_params), "int8"),
            ("int8 weights", (cpu_q, gpu_q), None)):
        _lane_reference(torch, "reference", f"lane, {name}", cfg,
                        params_by_dev, kv_quant)
    log("reference", f"prefill logits max_abs_err {json.dumps(errs)} <= "
        f"{REF_TOL}")
    _pipelined_reference(torch, cfg, cpu_params, gpu_params)
    for kv_quant in (None, "int8"):
        _paged_reference(torch, cfg, cpu_params, gpu_params, kv_quant)
    draft_cfg = dataclasses.replace(cfg, name="narrow-draft", d_model=256,
                                    n_layers=1, n_heads=4, n_kv_heads=1,
                                    head_dim=64, d_ff=512)
    cpu_draft = transformer.init_params(draft_cfg, seed=9,
                                        dtype=torch.float32, device="cpu")
    _spec_reference(torch, cfg, (cpu_params, gpu_params), draft_cfg,
                    (cpu_draft, _to_card(cpu_draft)))
    _penalty_reference(torch, cfg, cpu_params, gpu_params)
    log("reference", f"logprobs (top-5) card against cpu, max error per "
        f"engine (limit {LP_TOL}): {json.dumps(LP_ERRS)}")


def _run_engine(eng, prompts, max_new: int = 12) -> list:
    """Start ``eng``, submit ``prompts`` at once (greedy, top-5 logprobs
    recorded), return the finished requests."""
    from llm_instance_gateway_tpu_torch.server.engine import Request

    eng.start()
    try:
        reqs = [eng.submit(Request(prompt_tokens=p, max_new_tokens=max_new,
                                   logprobs=5))
                for p in prompts]
        for r in reqs:
            if not r.done.wait(300) or r.error:
                raise AssertionError(f"engine on {eng.device}: {r.error}")
        return reqs
    finally:
        eng.stop()


def _streams(reqs) -> list:
    return [r.output_tokens for r in reqs]


def _pipelined_reference(torch, cfg, cpu_params, gpu_params) -> None:
    """A pipelined lane engine with grouped prefill (prefill_batch=4) on
    the card — graph replays of the decode block, first tokens scattered
    on the device, [P, bucket] flash prefills — against the CPU's sync
    engine: identical greedy streams.  Three of the six prompts share the
    16-token bucket, two the 64-token one."""
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig)

    prompts = [[256] + list(range(65, 65 + n))
               for n in (5, 9, 12, 40, 50, 100)]
    base = dict(max_seq_len=256, prefill_buckets=(16, 64, 128),
                adaptive_steps=8)
    want_reqs = _run_engine(Engine(cfg, cpu_params, EngineConfig(**base),
                                   eos_id=257, dtype=torch.float32,
                                   device="cpu"), prompts)
    want = _streams(want_reqs)
    eng = Engine(cfg, gpu_params, EngineConfig(
        pipeline_decode=True, prefill_batch=4, **base), eos_id=257,
        dtype=torch.float32, device="cuda")
    grouped = []
    many = eng._prefill_many_impl

    def counted(*args, **kwargs):
        grouped.append(len(args[0]))
        return many(*args, **kwargs)

    eng._prefill_many_impl = counted
    got_reqs = _run_engine(eng, prompts)
    got = _streams(got_reqs)
    if got != want:
        raise AssertionError(f"pipelined reference: greedy streams differ: "
                             f"cuda {got} cpu {want}")
    _check_logprobs("pipelined lane (graph replays)", want_reqs, got_reqs)
    if not grouped or eng._graphs.replays <= 0:
        raise AssertionError(f"pipelined reference: grouped prefills "
                             f"{grouped}, replays {eng._graphs.replays}")
    log("reference", f"pipelined lane engine, prefill_batch=4 (f32): greedy "
        f"streams identical on cuda and cpu ({sum(map(len, got))} tokens), "
        f"grouped prefills of {grouped} rows, {eng._graphs.replays} graph "
        f"replays of shapes {eng._graphs.shapes}")


def _paged_reference(torch, cfg, cpu_params, gpu_params, kv_quant,
                     tag: str = "") -> None:
    """The same model on a paged engine with prefix cache and two stream
    lanes: a shared-prefix pair (the second maps the first's blocks and
    prefills only its suffix through the chunk kernel) and two prompts
    beyond the largest bucket (streamed in 128-token chunks) must give
    identical greedy streams on the card and on the CPU; ``kv_quant``
    int8 runs the int8 pool (the int8 paged kernel on the card).  ``tag``
    prefixes what the checks and logs call the engines (a family's
    layout in phase 13)."""
    from llm_instance_gateway_tpu_torch.ops import chunk_attention as ch
    from llm_instance_gateway_tpu_torch.ops import paged_decode_attention as pd
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request)

    counter = "quant_launches" if kv_quant else "launches"
    prefix = [256] + [65 + (7 * i) % 50 for i in range(80)]
    prompts = [prefix + [90, 91, 92], prefix + [100, 101],
               [256] + [70 + (3 * i) % 40 for i in range(299)],
               [256] + [66 + (5 * i) % 45 for i in range(199)]]
    streams, reused, launches, by_dev = {}, {}, {}, {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        ch.launches = pd.launches = pd.quant_launches = 0
        eng = Engine(cfg, params, EngineConfig(
            decode_slots=4, max_seq_len=512, prefill_buckets=(16, 64, 128),
            adaptive_steps=8, paged_kv_block=16, prefix_cache=True,
            stream_lanes=2, kv_cache_quant=kv_quant), eos_id=257,
            dtype=torch.float32, device=dev)
        eng.start()
        reqs = [eng.submit(Request(prompt_tokens=p, max_new_tokens=12,
                                   logprobs=5))
                for p in prompts]
        for r in reqs:
            if not r.done.wait(300) or r.error:
                raise AssertionError(f"paged reference on {dev}: {r.error}")
        eng.stop()
        streams[dev] = [r.output_tokens for r in reqs]
        by_dev[dev] = reqs
        reused[dev] = eng.prefix_reused_tokens
        launches[dev] = (ch.launches, getattr(pd, counter))
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"paged reference ({kv_quant}): greedy streams "
                             f"differ: {streams}")
    if not reused["cpu"] == reused["cuda"] > 0:
        raise AssertionError(f"paged reference: prefix reuse {reused}")
    if launches["cpu"] != (0, 0) or min(launches["cuda"]) <= 0:
        raise AssertionError(f"paged reference: launches {launches}")
    _check_logprobs(f"{tag}paged, prefix cache, stream lanes, KV "
                    f"{kv_quant or 'f32'}", by_dev["cpu"], by_dev["cuda"])
    log("reference", f"{tag}paged engine (16-token blocks, prefix cache, 2 stream "
        f"lanes, f32, KV {kv_quant or 'f32'}): greedy streams identical on "
        f"cuda and cpu ({sum(map(len, streams['cuda']))} tokens), "
        f"{reused['cuda']} prefix tokens reused, chunk/paged launches on the "
        f"card {launches['cuda']}")
    if kv_quant is None:
        # The same traffic on a pipelined paged engine (its streams' last
        # chunks and prefix-hit suffixes activate rows on the device).
        eng = Engine(cfg, gpu_params, EngineConfig(
            decode_slots=4, max_seq_len=512, prefill_buckets=(16, 64, 128),
            adaptive_steps=8, paged_kv_block=16, prefix_cache=True,
            stream_lanes=2, pipeline_decode=True, prefill_batch=4),
            eos_id=257, dtype=torch.float32, device="cuda")
        got_reqs = _run_engine(eng, prompts)
        got = _streams(got_reqs)
        if got != streams["cpu"] or eng.prefix_reused_tokens != reused["cpu"]:
            raise AssertionError(f"pipelined paged reference: {got} "
                                 f"{eng.prefix_reused_tokens} against "
                                 f"{streams['cpu']} {reused['cpu']}")
        _check_logprobs(f"{tag}pipelined paged (graph replays)",
                        by_dev["cpu"], got_reqs)
        log("reference", f"{tag}pipelined paged engine (prefix cache, 2 stream "
            f"lanes, f32): greedy streams identical on cuda and cpu, "
            f"{eng._graphs.replays} graph replays")


def _serve_all(eng, reqs) -> list:
    """Submit every request, then start ``eng`` (one admission for all, so
    two engines dispatch alike); returns the streams."""
    for r in reqs:
        eng.submit(r)
    eng.start()
    try:
        for r in reqs:
            if not r.done.wait(300) or r.error:
                raise AssertionError(f"engine on {eng.device}: {r.error}")
        return [list(r.output_tokens) for r in reqs]
    finally:
        eng.stop()


def _spec_reference(torch, cfg, params, draft_cfg, draft_params) -> None:
    """Speculative engines (K=3, a static 4 steps a dispatch, greedy) on
    the card against the same engines on the CPU and against the card's
    plain engine: identical tokens, and spec_cycles / spec_emitted equal
    the CPU's — on lanes and on a paged engine with prefix cache and two
    stream lanes (a shared-prefix pair, two prompts beyond the largest
    bucket, which do not speculate), sync and pipelined (the spec block's
    graph replays), with a seeded one-layer draft and with the perfect
    draft (the target's own params)."""
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request)

    lanes = dict(max_seq_len=256, prefill_buckets=(16, 64, 128),
                 adaptive_steps=0, decode_steps_per_sync=4)
    paged = dict(lanes, decode_slots=4, max_seq_len=512, paged_kv_block=16,
                 prefix_cache=True, stream_lanes=2)
    prefix = [256] + [65 + (7 * i) % 50 for i in range(80)]
    prompts = {
        "lanes": [[256] + list(range(65, 65 + n)) for n in (5, 9, 40, 100)],
        "paged": [prefix + [90, 91, 92], prefix + [100, 101],
                  [256] + [70 + (3 * i) % 40 for i in range(299)],
                  [256] + [66 + (5 * i) % 45 for i in range(199)],
                  [256] + list(range(80, 92))]}
    for layout, base in (("lanes", lanes), ("paged", paged)):
        for pipelined in (False, True):
            ecfg = dict(base, pipeline_decode=pipelined)
            plain = _serve_all(
                Engine(cfg, params[1], EngineConfig(**ecfg), eos_id=257,
                       dtype=torch.float32, device="cuda"),
                [Request(prompt_tokens=p, max_new_tokens=12)
                 for p in prompts[layout]])
            for draft in ("small", "perfect"):
                got, recorded = {}, {}
                for i, dev in enumerate(("cpu", "cuda")):
                    dp, dc = ((params[i], cfg) if draft == "perfect"
                              else (draft_params[i], draft_cfg))
                    eng = Engine(cfg, params[i], EngineConfig(
                        speculative_k=3, **ecfg), eos_id=257,
                        dtype=torch.float32, device=dev, draft_params=dp,
                        draft_cfg=dc)
                    recorded[dev] = [
                        Request(prompt_tokens=p, max_new_tokens=12,
                                logprobs=5) for p in prompts[layout]]
                    toks = _serve_all(eng, recorded[dev])
                    got[dev] = (toks, eng.spec_cycles, eng.spec_emitted)
                    if dev == "cuda":
                        keys = eng._graphs.spec_shapes
                what = (f"spec reference ({layout}, "
                        f"{'pipelined' if pipelined else 'sync'}, {draft} "
                        f"draft)")
                if got["cuda"] != got["cpu"] or got["cuda"][0] != plain:
                    raise AssertionError(f"{what}: card {got['cuda']} cpu "
                                         f"{got['cpu']} plain {plain}")
                if got["cuda"][1] <= 0 or not keys:
                    raise AssertionError(f"{what}: no spec cycle ({keys})")
                _check_logprobs(what, recorded["cpu"], recorded["cuda"])
                log("reference", f"{what}: tokens equal on cuda, cpu and the "
                    f"card's plain engine ({sum(map(len, plain))} tokens); "
                    f"spec_cycles {got['cuda'][1]}, spec_emitted "
                    f"{got['cuda'][2]} equal the cpu's; spec graph keys "
                    f"{keys}")


def _penalty_reference(torch, cfg, cpu_params, gpu_params) -> None:
    """Presence 1.5 and frequency 0.7, one forced (+100) and one banned
    (-100) logit_bias token, beside unpenalized rows, sync and pipelined
    (the penalized decode block's graph): the card's tokens equal the
    CPU's."""
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request, SamplingParams)

    sps = [SamplingParams(presence_penalty=1.5, frequency_penalty=0.7),
           SamplingParams(),
           SamplingParams(logit_bias={77: 100.0, 66: -100.0}),
           SamplingParams(presence_penalty=1.5, frequency_penalty=0.7,
                          logit_bias={66: -100.0}),
           SamplingParams()]
    prompts = [[256] + list(range(65, 65 + n)) for n in (5, 9, 12, 40, 100)]
    for pipelined in (False, True):
        got = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            eng = Engine(cfg, params, EngineConfig(
                max_seq_len=256, prefill_buckets=(16, 64, 128),
                adaptive_steps=0, decode_steps_per_sync=4,
                pipeline_decode=pipelined), eos_id=257, dtype=torch.float32,
                device=dev)
            got[dev] = _serve_all(eng, [
                Request(prompt_tokens=p, max_new_tokens=16, sampling=sp)
                for p, sp in zip(prompts, sps)])
            if dev == "cuda":
                keys = eng._graphs.shapes
        what = f"penalty reference ({'pipelined' if pipelined else 'sync'})"
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"{what}: card {got['cuda']} cpu "
                                 f"{got['cpu']}")
        if set(got["cuda"][2]) != {77} or 66 in got["cuda"][3]:
            raise AssertionError(f"{what}: logit_bias not applied: "
                                 f"{got['cuda']}")
        if not any(penalized for _, _, penalized in keys):
            raise AssertionError(f"{what}: no penalized graph key: {keys}")
        log("reference", f"{what}: tokens equal on cuda and cpu (f32), the "
            f"forced token at every step, graph keys {keys}")


def _post(url: str, body: dict, timeout: float = 600.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as f:
            return f.status, f.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _counters():
    """Kernel name -> (module, counter attribute) for every kernel: the
    port's own map (the one the decode graphs keep their launches by)."""
    from llm_instance_gateway_tpu_torch.server.decode_graphs import _COUNTERS

    return _COUNTERS


def reset_launches() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def check_only(launches: dict, expected: dict, what: str) -> None:
    """Every kernel's count equals ``expected`` (a missing name: 0)."""
    for name, got in launches.items():
        want = expected.get(name, 0)
        if got != want or (name in expected and want <= 0):
            raise AssertionError(f"{what}: {name} launched {got} times, "
                                 f"expected {want}: {launches}")


INT8_FLAGS = ["--quantize", "int8", "--kv-quantize", "int8"]
# The lane serve's traffic: (prompt characters, adapter, streamed); with the
# BOS, buckets 16, 64, 128, 512, 1024, 1024 — the longest leaves room for
# max_tokens under --max-seq-len 1024.
SERVE_JOBS = [(12, None, False), (50, "smoke-r8", False), (120, None, True),
              (400, "smoke-r8", False), (700, None, False),
              (900, "smoke-r8", False)]
SERVE_TEXT = "the quick brown fox jumps over the lazy dog " * 40


def _serve_body(n_chars: int, model, stream: bool, max_tokens: int) -> dict:
    body = {"prompt": SERVE_TEXT[:n_chars], "max_tokens": max_tokens,
            "temperature": 0.0, "stream": stream}
    if model:
        body["model"] = model
    return body


def _save_adapter(cfg, path: str, targets, seed: int) -> None:
    """A seeded rank-8 adapter on ``targets``, saved as .npz."""
    import numpy as np

    from llm_instance_gateway_tpu_torch.models import lora
    from llm_instance_gateway_tpu_torch.server.lora_manager import save_adapter

    rng = np.random.default_rng(seed)
    rank = 8
    weights = {
        t: {"a": (rng.standard_normal((cfg.n_layers, d_in, rank))
                  / math.sqrt(d_in)).astype(np.float32),
            "b": (rng.standard_normal((cfg.n_layers, rank, d_out))
                  * 0.05).astype(np.float32)}
        for t, (d_in, d_out) in lora.target_dims(cfg).items()
        if t in targets}
    save_adapter(path, weights, alpha=16.0, rank=rank)


def phase_serve(torch, params=None, adapter_path=None, quant=False,
                model: str = "llama3-8b", flags=(), tag=None, after=None,
                profile: bool = True, mesh_devices=None):
    """A server at full width and depth (Llama-3-8B, or the preset
    ``model``), six concurrent greedy completions (base and adapter rows,
    one streamed) through the flash and lane decode kernels, with exact
    launch counts over the window and KV back at its floor after it; then
    one decode step and one 1024-token prefill profiled.  ``quant`` adds
    ``--quantize int8 --kv-quantize int8`` (the lane kernel is then the
    int8 one, and the prefill goes unprofiled) and ``flags`` more of the
    server's flags; ``params`` is served as given (quantized under int8
    flags), else the server draws random seeded weights; ``after(engine,
    url, stats)`` runs last, on the live server, ``profile=False``
    skips the profiles and ``profile="replay"`` profiles the decode step's
    graph replays alone (an eager step over many shards is seconds of
    host time, and its tens of thousands of kernel events as many of
    processing).  ``flags`` with ``--mesh tensor=N`` serves the
    model sharded over ``mesh_devices``; every kernel then launches once
    per shard.  Returns (stats, the params served, or the caller's under
    ``quant`` or a mesh; the adapter path) so later phases serve the same
    weights.  ``--mesh data=N`` decodes once per data group; ``flags``
    with ``--paged-kv-block`` serve the window on the pool (the paged
    kernel counted in the lane kernel's place; pass ``profile=False``)."""
    import threading
    import urllib.request

    from llm_instance_gateway_tpu_torch.models import lora
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS
    from llm_instance_gateway_tpu_torch.server import api_http

    cfg = CONFIGS[model]
    argv = (["--model", model, "--max-seq-len", "1024", "--decode-slots",
             "8", "--device", "cuda", "--host", "127.0.0.1", "--port", "0"]
            + (INT8_FLAGS if quant else []) + list(flags))
    tag = tag or ("serve-int8" if quant else "serve")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    httpd, engine, _ = api_http.make_server(argv, params=params,
                                            mesh_devices=mesh_devices)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    params = params if quant or engine.tp is not None else engine.params
    shards = engine.tp.t if engine.tp is not None else 1
    groups = engine.tp.d if engine.tp is not None else 1
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        if adapter_path is None:
            # Seeded rank-8 adapter on every target, saved as .npz and
            # loaded through the admin endpoint.
            os.makedirs(os.path.join(REPO, "build", "smoke"), exist_ok=True)
            adapter_path = os.path.join(REPO, "build", "smoke",
                                        f"{model}-r8.npz")
            _save_adapter(cfg, adapter_path, lora.target_dims(cfg), 11)
        status, text = _post(url + "/v1/load_lora_adapter",
                             {"lora_name": "smoke-r8",
                              "lora_path": adapter_path})
        if status != 200:
            raise AssertionError(f"adapter load: {status} {text}")

        jobs = SERVE_JOBS
        max_tokens = 32
        submitted: list = []
        _record(engine, "submit", submitted)
        snap0 = engine.metrics_snapshot()
        rate0 = _rate_snap(engine)
        reset_launches()
        results = [None] * len(jobs)

        def run(i, n_chars, adapter, stream):
            t = time.time()
            results[i] = _post(url + "/v1/completions", _serve_body(
                n_chars, adapter, stream, max_tokens)) + (time.time() - t,)

        t_serve = time.time()
        threads = [threading.Thread(target=run, args=(i, *job))
                   for i, job in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        serve_s = time.time() - t_serve
        wait_blocks_processed(engine)
        launches = read_launches()
        snap1 = engine.metrics_snapshot()

        n_layers = cfg.n_layers
        for i, ((n_chars, adapter, stream), res) in enumerate(zip(jobs, results)):
            if res is None:
                raise AssertionError(f"{tag}: request {i} did not return")
            status, text, secs = res
            if status != 200:
                raise AssertionError(f"{tag}: request {i}: {status} "
                                     f"{text[:300]}")
            if stream:
                chunks = [json.loads(line[6:]) for line in text.splitlines()
                          if line.startswith("data: {")]
                usage = chunks[-1]["usage"]
                if text.rstrip().splitlines()[-1] != "data: [DONE]":
                    raise AssertionError("stream did not end with [DONE]")
            else:
                usage = json.loads(text)["usage"]
            if usage["completion_tokens"] != max_tokens:
                raise AssertionError(f"{tag}: request {i}: {usage} != "
                                     f"{max_tokens} tokens")
            log(tag, f"request {i}: {n_chars + 1} prompt tokens, "
                f"adapter={adapter}, stream={stream}, "
                f"{usage['completion_tokens']} tokens in {secs:.2f} s")
        decode_steps = int(snap1["dispatch_steps_hist"]["sum"]
                           - snap0["dispatch_steps_hist"]["sum"])
        if decode_steps <= 0:
            raise AssertionError(f"{tag}: no decode steps")
        # One bucketed prefill program per request (no prefix cache here),
        # one lane decode launch per layer and decode step (replays
        # counted), each once per tensor shard, decode once per data group
        # too (a prefill runs on its row's group), nothing else.
        lane_kernel = ("decode_attention_quant" if "--kv-quantize" in argv
                       else "decode_attention")
        if "--paged-kv-block" in argv:
            lane_kernel = "paged_" + lane_kernel
        check_only(launches, {
            "flash_prefill": len(jobs) * n_layers * shards,
            lane_kernel: decode_steps * n_layers * shards * groups}, tag)
        _kv_floor(tag, engine)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
            metrics_text = f.read().decode()
        for family in ("tpu:num_requests_running", "tpu:num_requests_waiting",
                       "tpu:kv_cache_usage_perc", "tpu:lora_requests_info",
                       "tpu:prefill_queue_size", "tpu:decode_step_seconds"):
            if family not in metrics_text:
                raise AssertionError(f"/metrics lacks {family}")
        ph = snap1["phase_hist"]
        ttft = sorted(r.ttft_s * 1e3 for r in submitted)
        stats = {
            "model": model, "flags": argv[argv.index("--port") + 2:],
            "shards": shards,
            "n_layers": n_layers, "init_s": init_s, "serve_s": serve_s,
            "decode_steps": decode_steps,
            "decode_tokens_per_s": _block_rate(rate0, _rate_snap(engine),
                                               len(jobs)),
            "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
            # The sync loop's step-profiler attribution over the window,
            # beside the pipelined server's in the surface phase.
            "profile_shares": engine.profiler.attribution()["shares"],
            "decode_step_ms_mean": 1e3 * (
                (ph["decode_step"]["sum"] - snap0["phase_hist"]["decode_step"]["sum"])
                / max(1, ph["decode_step"]["count"]
                      - snap0["phase_hist"]["decode_step"]["count"])),
            "prefill_ms_mean": 1e3 * (
                (ph["prefill"]["sum"] - snap0["phase_hist"]["prefill"]["sum"])
                / max(1, ph["prefill"]["count"]
                      - snap0["phase_hist"]["prefill"]["count"])),
            "tokens": len(jobs) * max_tokens,
            "allocated_gb_after_serve": (torch.cuda.memory_allocated()
                                         - mem0) / 1e9,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "graph_shapes": engine._graphs.shapes,
            "graph_capture_s": engine._graphs.capture_s,
            "launches": launches,
        }
        source = ("checkpoint" if "--checkpoint" in argv else "random")
        log(tag, f"{model} ({n_layers} layers, {source} weights, flags "
            f"{stats['flags']}): " + json.dumps(stats))
        # The greedy token ids per (prompt, adapter): the spec phase's
        # plain reference (the byte tokenizer drops ids >= 256 from text).
        stats["answers"] = {(tuple(r.prompt_tokens), r.adapter):
                            list(r.output_tokens) for r in submitted}
        # After the counted window: these launches are not the serve's.
        if profile:
            t_prof = time.time()
            stats["profile"] = phase_profile(
                torch, engine, prefill=not quant and profile != "replay",
                eager=profile != "replay")
            stats["profile_s"] = time.time() - t_prof
        if after is not None:
            after(engine, url, stats)
        stats["peak_mem_gb_with_profile"] = (
            torch.cuda.max_memory_allocated() / 1e9)
        return stats, params, adapter_path
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def phase_paged_serve(torch, params, adapter_path: str,
                      quant: bool = False, flags=(), tag=None,
                      mesh_devices=None, profile: bool = True,
                      after=None) -> dict:
    """The same 8B weights behind the paged pool, prefix cache and two
    stream lanes, at Llama-3-8B's published 8192-token context: five
    requests sharing a ~600-token system prompt, and two concurrent long
    prompts (~3000 and ~6000 tokens) that stream in 1024-token chunks.
    ``quant`` adds ``--quantize int8 --kv-quantize int8`` and doubles the
    pool to 1536 blocks, about the bytes of the bf16 pool's 768 (64 KiB
    plus 2 KiB of scales per token against 128 KiB).  ``flags`` adds
    server flags: with ``--mesh sequence=N`` (over ``mesh_devices``) the
    long prompts run one ring program each instead of streaming, counted
    exactly; ``after(engine, url, stats)`` runs last on the live server,
    and ``profile=False`` skips the profiles."""
    import threading
    import urllib.request

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B as cfg
    from llm_instance_gateway_tpu_torch.parallel import sharding
    from llm_instance_gateway_tpu_torch.server import api_http

    tag = tag or ("paged-int8" if quant else "paged")
    n_pool = 1536 if quant else 768
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    httpd, engine, _ = api_http.make_server([
        "--model", "llama3-8b", "--max-seq-len", "8192", "--decode-slots", "8",
        "--paged-kv-block", "64", "--paged-kv-blocks", str(n_pool),
        "--prefix-cache", "--stream-lanes", "2", "--device", "cuda",
        "--host", "127.0.0.1", "--port", "0"]
        + (INT8_FLAGS if quant else []) + list(flags), params=params,
        mesh_devices=mesh_devices)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    shards = engine.tp.t if engine.tp is not None else 1
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        status, text = _post(url + "/v1/load_lora_adapter",
                             {"lora_name": "smoke-r8",
                              "lora_path": adapter_path})
        if status != 200:
            raise AssertionError(f"adapter load: {status} {text}")
        system = ("You are a careful assistant for a travel company. "
                  * 12)[:600]
        questions = ["Where can I fly?", "What does a refund cost me now?",
                     "Which hotels near the old harbour allow pets inside?",
                     "Can I move my booking from May to June without fees??",
                     "Is breakfast included?"]
        jobs = [(system + q, m) for q, m in zip(
            questions, [None, "smoke-r8", None, "smoke-r8", None])]
        long_text = "the quick brown fox jumps over the lazy dog "
        jobs += [(("A long report: " + long_text * 80)[:3000], "smoke-r8"),
                 (("Another long report: " + long_text * 160)[:6000], None)]
        max_tokens = 32
        # Count the programs each kernel's launches follow: chunk programs
        # (stream chunks, prefix-hit suffixes) and bucketed prefills (the
        # cold misses); and the long prompts' routes, chunk streams or
        # ring programs.
        programs = {"chunk": 0, "prefill": 0, "stream": 0, "ring": 0}
        wrapped = {"chunk": "_chunk_fn", "prefill": "_prefill_impl",
                   "stream": "_start_stream", "ring": "_ring"}
        real = {kind: getattr(engine, name) for kind, name in wrapped.items()}

        def counted(kind, fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                # A stream reparked for backpressure starts again later.
                programs[kind] += kind != "stream" or bool(out)
                return out
            return call

        for kind, name in wrapped.items():
            if real[kind] is not None:
                setattr(engine, name, counted(kind, real[kind]))
        submitted: list = []
        _record(engine, "submit", submitted)
        snap0 = engine.metrics_snapshot()
        reset_launches()
        results = [None] * len(jobs)

        def run(i, prompt, model):
            body = {"prompt": prompt, "max_tokens": max_tokens,
                    "temperature": 0.0}
            if model:
                body["model"] = model
            t = time.time()
            results[i] = _post(url + "/v1/completions", body) + (time.time() - t,)

        t_serve = time.time()
        threads = [threading.Thread(target=run, args=(i, *job))
                   for i, job in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        serve_s = time.time() - t_serve
        launches = read_launches()
        for kind, name in wrapped.items():
            setattr(engine, name, real[kind])
        snap1 = engine.metrics_snapshot()

        for i, ((prompt, adapter), res) in enumerate(zip(jobs, results)):
            if res is None:
                raise AssertionError(f"{tag} request {i} did not return")
            status, text, secs = res
            if status != 200:
                raise AssertionError(f"{tag} request {i}: {status} "
                                     f"{text[:300]}")
            usage = json.loads(text)["usage"]
            if usage["completion_tokens"] != max_tokens:
                raise AssertionError(f"{tag} request {i}: {usage}")
            log(tag, f"request {i}: {usage['prompt_tokens']} prompt "
                f"tokens, adapter={adapter}, {max_tokens} tokens in "
                f"{secs:.2f} s")
        n_layers = cfg.n_layers
        decode_steps = int(snap1["dispatch_steps_hist"]["sum"]
                           - snap0["dispatch_steps_hist"]["sum"])
        reused = (snap1["prefix_reused_tokens"]
                  - snap0["prefix_reused_tokens"])
        if reused <= 0:
            raise AssertionError(f"{tag}: no prefix tokens reused")
        if decode_steps <= 0 or min(programs["chunk"],
                                    programs["prefill"]) <= 0:
            raise AssertionError(f"{tag}: {decode_steps} decode steps, "
                                 f"programs {programs}")
        # The two long prompts: two chunk streams, or on a sequence mesh
        # two ring programs and no stream.
        routes = ({"ring": 2, "stream": 0} if real["ring"] is not None
                  else {"ring": 0, "stream": 2})
        if {k: programs[k] for k in routes} != routes:
            raise AssertionError(f"{tag}: long prompts took {programs}, "
                                 f"want {routes}")
        paged_kernel = ("paged_decode_attention_quant" if "--kv-quantize"
                        in flags or quant else "paged_decode_attention")
        # Each kernel once per tensor shard; the ring launches none.
        check_only(launches, {
            paged_kernel: decode_steps * n_layers * shards,
            "chunk_attention": programs["chunk"] * n_layers * shards,
            "flash_prefill": programs["prefill"] * n_layers * shards}, tag)
        # Every request finished: allocated blocks drain back to the floor
        # (zero-ref cached prefix blocks count as free).
        deadline = time.time() + 30
        while (engine.metrics_snapshot()["kv_cache_usage_perc"] > 0
               and time.time() < deadline):
            time.sleep(0.05)
        snap2 = engine.metrics_snapshot()
        states = snap2["kv_ledger"]["states"]
        if snap2["kv_cache_usage_perc"] != 0.0 or states["active"] != 0:
            raise AssertionError(f"{tag}: KV usage "
                                 f"{snap2['kv_cache_usage_perc']} / ledger "
                                 f"{states} after the last request")
        if sum(states.values()) != snap2["kv_ledger"]["blocks_total"]:
            raise AssertionError(f"{tag}: ledger not conserved {states}")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
            metrics_text = f.read().decode()
        for family in ("tpu:kv_blocks", "tpu:prefix_reused_tokens",
                       "tpu:kv_prefix_hits_total", "tpu:stream_lanes_active"):
            if family not in metrics_text:
                raise AssertionError(f"/metrics lacks {family}")
        with urllib.request.urlopen(url + "/debug/kv", timeout=60) as f:
            if f.status != 200:
                raise AssertionError(f"/debug/kv answered {f.status}")
        ph0, ph1 = snap0["phase_hist"], snap1["phase_hist"]
        pool_bytes = sum(c[n].numel() * c[n].element_size()
                         for c in sharding.distinct(sharding.parts(
                             engine.cache))
                         for n in ("k", "v", "k_scale", "v_scale") if n in c)
        stats = {
            "init_s": init_s, "serve_s": serve_s,
            "decode_steps": decode_steps, "chunk_programs": programs["chunk"],
            "prefill_programs": programs["prefill"],
            "ring_programs": programs["ring"],
            "chunk_streams": programs["stream"],
            "prefix_reused_tokens": reused,
            "decode_step_ms_mean": 1e3 * (
                (ph1["decode_step"]["sum"] - ph0["decode_step"]["sum"])
                / max(1, ph1["decode_step"]["count"]
                      - ph0["decode_step"]["count"])),
            "prefill_ms_mean": 1e3 * (
                (ph1["prefill"]["sum"] - ph0["prefill"]["sum"])
                / max(1, ph1["prefill"]["count"] - ph0["prefill"]["count"])),
            "tokens": len(jobs) * max_tokens,
            "kv_usage_after": snap2["kv_cache_usage_perc"],
            "kv_states_after": states,
            "pool_gib": pool_bytes / 2 ** 30,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "graph_shapes": engine._graphs.shapes,
            "graph_capture_s": engine._graphs.capture_s,
            "launches": launches,
        }
        log(tag, f"llama3-8b paged (64-token blocks x {n_pool}, prefix cache, "
            "2 stream lanes"
            + (", --quantize int8 --kv-quantize int8" if quant else "")
            + "".join(f" {f}" for f in flags) + "): " + json.dumps(stats))
        stats["answers"] = {(tuple(r.prompt_tokens), r.adapter):
                            list(r.output_tokens) for r in submitted}
        # After the counted window: these launches are not the serve's.
        if profile:
            stats["profile"] = phase_paged_profile(torch, engine)
        if after is not None:
            after(engine, url, stats)
        return stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def _profile(torch, name: str, fn, reps: int, host: bool = False) -> dict:
    """Host wall per call, device kernel time, device idle share and top
    kernels of ``fn`` under torch.profiler, tracing the device only
    unless ``host``: the host's per-op events of an eager 8B step (tens
    of thousands over a few calls) cost the smoke ~10-30 s of processing
    each, and the host wall comes from the clock.  A graph replay (a few
    host events) traces both: traced alone, the device's replays read
    ~1.7x the wall of a replay traced with the host (one card, one run)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    device_us = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # A range on the device's timeline (the optimizer's step, a
        # record_function) spans kernels counted on their own.
        if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            device_us += us
            rows.append((us / reps / 1e3, ev.count // reps, ev.key[:60]))
    rows.sort(reverse=True)
    device_ms = device_us / reps / 1e3
    out = {
        "wall_ms": wall_ms,
        "device_ms": device_ms if device_us else "not measured",
        "device_idle_share": (1 - device_ms / wall_ms) if device_us
        else "not measured",
        "top_kernels": [{"name": k, "ms": ms, "calls": n}
                        for ms, n, k in rows[:8]],
        # The port's own kernels, in the top 8 or not (split-S decode:
        # split and combine).
        "port_kernels": [{"name": k, "ms": ms, "calls": n}
                         for ms, n, k in rows
                         if "decode_tile" in k or "flash_tile" in k
                         or "flash_backward" in k],
    }
    log("profile", f"{name}: " + json.dumps(out))
    return out


def _graph_profile(torch, name: str, fn, reps: int):
    """``fn`` captured once as a CUDA graph (after a warm-up call on the
    capture stream) and profiled as replays, beside its eager profile:
    the host's share that a graph removes, from the same run."""
    import gc

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    gc.disable()  # as in decode_graphs: nothing freed mid-capture
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            fn()
    finally:
        gc.enable()
    return _profile(torch, f"{name} (graph replay)", graph.replay, reps,
                    host=True)


def _with_graph(torch, name: str, fn, reps: int, why_not: str | None = None,
                eager: bool = True):
    """Eager profile of ``fn`` (unless not ``eager``) and, beside it, its
    graph replays — or ``why_not``, the reason there is none."""
    out = _profile(torch, name, fn, reps) if eager else {}
    if why_not:
        out["graph_replay"] = f"not captured: {why_not}"
        return out
    try:
        out["graph_replay"] = _graph_profile(torch, name, fn, reps)
    except RuntimeError as e:  # a probe beside the engine's path
        out["graph_replay"] = f"capture failed: {str(e)[:200]}"
        log("profile", f"{name}: {out['graph_replay']}")
    return out


def phase_paged_profile(torch, engine) -> dict:
    """One paged decode step over 8 long rows (mixed adapters) and one
    1024-token chunk at start 5120, on the paged engine's pools (the
    server is idle; the rows' tables are built here) — bf16 or int8, as
    the engine serves."""
    from llm_instance_gateway_tpu_torch.models import paged
    from llm_instance_gateway_tpu_torch.server.sampling import sample

    cfg, params = engine.model_cfg, engine.params
    dev = torch.device("cuda")
    lora_bufs = engine.lora.buffers
    b, block = engine.cfg.decode_slots, engine._block
    m = engine.cache["tables"].shape[1]
    lengths = [4000 + 250 * i for i in range(b)]  # 8 long rows
    tables = torch.zeros(b, m, dtype=torch.int32)
    nxt = 1
    for i, n in enumerate(lengths):
        need = -(-(n + 1) // block)
        tables[i, :need] = torch.arange(nxt, nxt + need)
        nxt += need
    if nxt - 1 > engine._n_blocks:
        raise AssertionError("paged profile: rows exceed the pool")
    cache = dict(engine.cache, tables=tables.to(dev))
    tokens = torch.arange(b, device=dev) + 65
    positions = torch.tensor(lengths, device=dev)
    slots = torch.tensor([-1, 0] * (b // 2), device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    ones = torch.ones(b, device=dev)
    zeros_i = torch.zeros(b, dtype=torch.int64, device=dev)
    chunk_tokens = torch.randint(0, 256, (1024,)).numpy()
    chunk_pos = (5120 + torch.arange(1024)).numpy()

    def decode():
        logits, _ = paged.decode_step_paged(
            cfg, params, cache, tokens, positions, lora_bufs=lora_bufs,
            slot_ids=slots, active=active)
        return sample(logits, None, 0 * ones, zeros_i, ones,
                      valid_vocab=cfg.vocab_size)

    def chunk():
        return paged.prefill_with_cache_paged(
            cfg, params, cache, chunk_tokens, chunk_pos, 7, 6144, 1023,
            lora_bufs=lora_bufs, lora_slot=0)[0]

    return {"paged_decode_step": _with_graph(torch, "paged_decode_step",
                                             decode, 3),
            "chunk_1024_at_5120": _with_graph(
                torch, "chunk_1024_at_5120", chunk, 2,
                why_not="the chunk program copies host positions to the "
                        "card per call")}


def phase_profile(torch, engine, prefill: bool = True, cfg=None,
                  eager: bool = True) -> dict:
    """Where one 8B decode step (8 rows, mixed adapters, ragged lengths)
    and one 1024-token prefill spend their time: host wall per call, device
    kernel time, device idle share, top kernels (torch.profiler).  On the
    int8 engine the decode step alone (``prefill`` False): int8 weights
    widened per call, int8 KV.  Rows past the eighth repeat the first
    eight's positions (a 16-slot engine's lanes hold 1024); an MoE
    prefill is profiled eager only (it reads the exact fallback's
    overflow flag on the host, once a layer).  ``cfg`` overrides the
    engine's config (an MoE model in drop mode, the exact fallback's
    cost); ``eager=False`` profiles the graph replays alone."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.server.sampling import sample

    cfg, params = cfg or engine.model_cfg, engine.params
    dev = torch.device("cuda")
    lora_bufs = engine.lora.buffers
    b = engine.cfg.decode_slots
    tokens = torch.arange(b, device=dev) + 65
    positions = torch.tensor([100 * (i % 8 + 1) for i in range(b)],
                             device=dev)
    slots = torch.tensor([-1, 0] * (b // 2), device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    ones = torch.ones(b, device=dev)
    zeros_i = torch.zeros(b, dtype=torch.int64, device=dev)
    prompt = torch.randint(0, 256, (1, 1024), device=dev)
    prompt_pos = torch.arange(1024, device=dev)[None]

    def decode():
        logits, _ = transformer.decode_step(
            cfg, params, engine.cache, tokens, positions, lora_bufs=lora_bufs,
            slot_ids=slots, active=active)
        return sample(logits, None, 0 * ones, zeros_i, ones,
                      valid_vocab=cfg.vocab_size)

    def run_prefill():
        return transformer.prefill(cfg, params, prompt, prompt_pos,
                                   lora_bufs=lora_bufs,
                                   slot_ids=slots[1:2])[0]

    out = {"decode_step": _with_graph(torch, "decode_step", decode, 3,
                                      eager=eager)}
    if prefill:
        out["prefill_1024"] = _with_graph(
            torch, "prefill_1024", run_prefill, 2,
            why_not=("the MoE prefill reads its overflow flag on the host"
                     if cfg.n_experts else None))
    return out


def wait_blocks_processed(eng) -> None:
    """The pipelined loop still holds the block dispatched beside the last
    one read back: wait until every replayed block is processed (and in the
    steps histogram a launch check counts from)."""
    if eng._graphs is None or not eng.cfg.pipeline_decode:
        return
    deadline = time.time() + 60
    while time.time() < deadline:  # every block is a replay
        done = eng.metrics_snapshot()["dispatch_steps_hist"]["count"]
        if done == eng._graphs.replays:
            return
        time.sleep(0.01)
    raise AssertionError("a dispatched decode block was never processed")


# New tokens per request of the dispatch phase's A runs (B: bench.py's 64).
DISPATCH_A_NEW = 16
# The dispatch phase's depth: the serve phase's first 8 of Llama-3-8B's
# 32 layers (the whole smoke past ~1000 s of its 1200 once phase 21 came:
# at full depth the phase took 139 s of a 1047 s run on one H100, at 16
# layers 73 s of a 1036 s run).
DISPATCH_LAYERS = 8


def phase_dispatch(torch, bf16_params) -> dict:
    """``bench.py``'s device traffic on Llama-3-8B (full width, the first
    ``DISPATCH_LAYERS`` layers of the serve phase's tree, int8 weights,
    four rank-8 adapters on q/k/v/o): 48 requests arriving
    at once, 100-token prompts, 64 new tokens (``DISPATCH_A_NEW`` on the
    A side, whose eager runs took most of the phase's wall), 16 slots,
    buckets (128, 256), decode_steps_per_sync=32.  Two engines over the
    same weights and adapters serve it in turns, A B B A: A the sync loop
    with the eager
    decode block and prefill_batch=1, B the pipelined loop replaying the
    block's CUDA graph with prefill_batch=4.  Each run prints decode
    tokens/s, TPOT and TTFT percentiles and its exact launch counts; the
    count of greedy tokens where B differs from A closes the phase."""
    import dataclasses

    import numpy as np

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.models.lora import target_dims
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_params
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request)
    from llm_instance_gateway_tpu_torch.server.lora_manager import LoRAManager

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=DISPATCH_LAYERS,
                              max_lora_slots=4, max_lora_rank=8)
    params = quantize_params(dict(bf16_params, layers={
        name: leaf[:DISPATCH_LAYERS]
        for name, leaf in bf16_params["layers"].items()}))
    lora = LoRAManager(cfg, dtype=torch.bfloat16, device="cuda")
    names = []
    for i in range(4):  # bench.make_adapter_weights(cfg, rank=8, seed=i)
        rng = np.random.RandomState(i)
        dims = target_dims(cfg)
        lora.load(f"bench-adapter-{i}", weights={
            t: {"a": rng.randn(cfg.n_layers, dims[t][0], 8) * 0.01,
                "b": rng.randn(cfg.n_layers, 8, dims[t][1]) * 0.01}
            for t in ("q", "k", "v", "o")}, alpha=16.0, rank=8)
        names.append(f"bench-adapter-{i}")
    rng = np.random.RandomState(0)  # bench.run_phase(seed=0)
    prompts = [list(rng.randint(1, 250, size=100)) for _ in range(48)]
    base = dict(decode_slots=16, max_seq_len=512, prefill_buckets=(128, 256),
                decode_steps_per_sync=32)
    engines = {  # A runs the eager block, B replays its graphs
        "A": Engine(cfg, params, EngineConfig(**base), lora_manager=lora,
                    eos_id=None, dtype=torch.bfloat16, device="cuda",
                    cuda_graphs=False),
        "B": Engine(cfg, params, EngineConfig(
            pipeline_decode=True, prefill_batch=4, **base), lora_manager=lora,
            eos_id=None, dtype=torch.bfloat16, device="cuda"),
    }
    # A (eager, host-paced: most of the phase's wall) decodes half B's
    # tokens per request; the A/B comparisons run over A's tokens.
    new_tokens = {"A": DISPATCH_A_NEW, "B": 64}
    programs = {}
    for name, eng in engines.items():
        programs[name] = {"prefill": 0, "prefill_many": 0}
        for attr, kind in (("_prefill_impl", "prefill"),
                           ("_prefill_many_impl", "prefill_many")):
            def counted(*a, _fn=getattr(eng, attr), _k=kind, _n=name, **kw):
                programs[_n][_k] += 1
                return _fn(*a, **kw)
            setattr(eng, attr, counted)
        eng.start()

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def run(name):
        eng = engines[name]
        snap0 = eng.metrics_snapshot()
        progs0 = dict(programs[name])
        reset_launches()
        reqs = [Request(prompt_tokens=p, max_new_tokens=new_tokens[name],
                        adapter=names[i % len(names)])
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        for r in reqs:
            if not r.done.wait(900) or r.error:
                raise AssertionError(f"dispatch {name}: {r.error}")
        wall = time.perf_counter() - t0
        wait_blocks_processed(eng)
        torch.cuda.synchronize()
        launches = read_launches()
        snap1 = eng.metrics_snapshot()
        steps = int(snap1["dispatch_steps_hist"]["sum"]
                    - snap0["dispatch_steps_hist"]["sum"])
        progs = {k: programs[name][k] - progs0[k] for k in progs0}
        check_only(launches, {
            "flash_prefill": (progs["prefill"] + progs["prefill_many"])
            * cfg.n_layers,
            "decode_attention": steps * cfg.n_layers}, f"dispatch {name}")
        tokens = sum(len(r.output_tokens) for r in reqs)
        if tokens != 48 * new_tokens[name]:
            raise AssertionError(f"dispatch {name}: {tokens} tokens")
        ttft = [r.ttft_s * 1e3 for r in reqs]
        tpot = [(r.t_done - r.t_first_token) * 1e3
                / (len(r.output_tokens) - 1) for r in reqs]
        ph0, ph1 = (sn["phase_hist"]["decode_step"] for sn in (snap0, snap1))
        stats = {
            "engine": ("sync loop, eager block, prefill_batch=1" if name == "A"
                       else "pipelined loop, graph replays, prefill_batch=4"),
            "wall_s": wall, "decode_tokens_per_s": tokens / wall,
            # tpu:decode_step_seconds: a block's wall over its steps (B:
            # dispatch to read-back, overlapping the next block).
            "decode_step_ms_mean": 1e3 * (ph1["sum"] - ph0["sum"])
            / max(1, ph1["count"] - ph0["count"]),
            "tpot_ms_p50": pct(tpot, 0.5), "tpot_ms_p95": pct(tpot, 0.95),
            "ttft_ms_p50": pct(ttft, 0.5), "ttft_ms_p95": pct(ttft, 0.95),
            "decode_steps": steps, "prefill_programs": progs,
            "launches": launches,
        }
        log("dispatch", f"{name}: " + json.dumps(stats))
        return stats, [r.output_tokens for r in reqs]

    runs = []
    try:
        # bench.run_phase's warm-up: 2 requests of 4 tokens per engine,
        # which captures B's 32-step graph before the timed runs.
        for name, eng in engines.items():
            for r in [eng.submit(Request(prompt_tokens=p, max_new_tokens=4))
                      for p in prompts[:2]]:
                if not r.done.wait(900) or r.error:
                    raise AssertionError(f"dispatch warm-up {name}: "
                                         f"{r.error}")
            wait_blocks_processed(eng)
        log("dispatch", "warm-up done; B captured "
            f"{engines['B']._graphs.shapes} in "
            f"{engines['B']._graphs.capture_s:.2f} s")
        for name in ("A", "B", "B", "A"):
            runs.append((name,) + run(name))
    finally:
        for eng in engines.values():
            eng.stop()
    def differing(xs, ys):
        return sum(x != y for rx, ry in zip(xs, ys) for x, y in zip(rx, ry))

    a1, b1, b2, a2 = (t for _, _, t in runs)
    # Where B's streams leave A's: at the first token (the prefill, [4,
    # 128] against [1, 128] in bf16) or later (the decode block).
    first = [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y),
                  None) for ra, rb in zip(a1, b1)]
    out = {"runs": [dict(run=n, **st) for n, st, _ in runs],
           "differing_greedy_tokens_a_vs_b": differing(a1, b1),
           "tokens_compared": sum(map(len, a1)),
           "differing_a_vs_a": differing(a1, a2),
           "differing_b_vs_b": differing(b1, b2),
           "requests_identical_a_vs_b": first.count(None),
           "requests_first_token_differs": first.count(0),
           "first_divergence_positions": sorted(
               i for i in first if i is not None),
           "b_graph_shapes": engines["B"]._graphs.shapes,
           "b_graph_replays": engines["B"]._graphs.replays}
    for name in ("A", "B"):
        sts = [st for n, st, _ in runs if n == name]
        out[name] = {k: [st[k] for st in sts] for k in (
            "decode_tokens_per_s", "decode_step_ms_mean", "tpot_ms_p50",
            "tpot_ms_p95",
            "ttft_ms_p50", "ttft_ms_p95")}
    log("dispatch", f"llama3-8b at {DISPATCH_LAYERS} layers, int8 weights, "
        "4 rank-8 adapters, 48 x "
        f"(100 prompt + 64 new; A {DISPATCH_A_NEW}) tokens, 16 slots, 32 "
        "steps per dispatch: "
        + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    # The kernels line counts the B runs' launches (the graph replays).
    out["launches"] = {k: sum(st["launches"][k] for n, st, _ in runs
                              if n == "B") for k in runs[0][1]["launches"]}
    return out


def _http(url: str, data: bytes, ctype: str = "application/json",
          timeout: float = 600.0):
    """POST ``data``; returns (status, body bytes, headers)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as f:
            return f.status, f.read(), f.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


# The servers the smoke starts after the serve phase: Llama-3-8B on the card.
SERVER_ARGV = ["--model", "llama3-8b", "--max-seq-len", "1024",
               "--decode-slots", "8", "--device", "cuda", "--host",
               "127.0.0.1", "--port", "0"]


def _start_server(argv, params, adapter_path: str, draft_params=None):
    """An 8B server over ``params`` (and ``draft_params`` for its draft)
    with the smoke's adapter loaded, its HTTP loop on a thread; returns
    (httpd, engine, url)."""
    import threading

    from llm_instance_gateway_tpu_torch.server import api_http

    httpd, engine, _ = api_http.make_server(
        SERVER_ARGV + argv, params=params, draft_params=draft_params)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    status, text = _post(url + "/v1/load_lora_adapter",
                         {"lora_name": "smoke-r8", "lora_path": adapter_path})
    if status != 200:
        raise AssertionError(f"adapter load: {status} {text}")
    return httpd, engine, url


def _record(engine, method: str, store: list) -> None:
    """Wrap ``engine.<method>`` to keep every Request it admits."""
    fn = getattr(engine, method)

    def call(*args, **kwargs):
        req = fn(*args, **kwargs)
        store.append(req)
        return req

    setattr(engine, method, call)


def _count_programs(engine, programs: dict) -> None:
    """Count the engine's bucketed prefills and chunk programs (the flash
    and chunk kernels' launches follow them)."""
    for attr, kind in (("_prefill_impl", "prefill"), ("_chunk_fn", "chunk")):
        def call(*args, _fn=getattr(engine, attr), _k=kind, **kwargs):
            programs[_k] += 1
            return _fn(*args, **kwargs)
        setattr(engine, attr, call)


def _stamp_decode(engine, store: dict) -> None:
    """Keep, per request id, the time and token count at which the
    pipelined loop finished reading the request's first decode block back:
    the start of its decode window, after its wait for a slot and after
    the block's graph capture (a first-use capture runs at dispatch,
    before the readback)."""
    process = engine._process_block

    def call(blk, current):
        process(blk, current)
        now = time.time()
        for slot in blk["rows"]:
            if slot is not None and len(slot.request.output_tokens) > 1:
                store.setdefault(slot.request.request_id,
                                 (now, len(slot.request.output_tokens)))

    engine._process_block = call


def _decode_rate(req, stamps: dict):
    """Tokens a second over the request's decode window (``_stamp_decode``:
    from its first decode block's readback to its last token); None when
    it finished within that first block."""
    if req.request_id not in stamps:
        return None
    t0, n0 = stamps[req.request_id]
    n = len(req.output_tokens) - n0
    return n / (req.t_done - t0) if n > 0 else None


def _snapshot_row_kv(torch, engine, prompt: list, n_valid: int,
                     store: dict) -> None:
    """When the row holding ``prompt`` is released, keep its first
    ``n_valid`` positions of every pool (K, V and, int8, their scales),
    read through the row's block table: the prompt and the decoded
    tokens' KV, written in full by then."""
    clear = engine._clear_slot

    def call(i):
        slot = engine.slots[i]
        if (slot is not None and "kv" not in store
                and slot.request.prompt_tokens == prompt):
            idx = torch.tensor(engine._row_blocks[i], device=engine.device)
            store["kv"] = {
                name: engine.cache[name][:, idx].flatten(1, 2)[:, :n_valid]
                .clone() for name in ("k", "v", "k_scale", "v_scale")
                if name in engine.cache}
        clear(i)

    engine._clear_slot = call


def _chat_over_hops(tag: str, content: str, max_tokens: int, urls,
                    c_reqs: list, d_reqs: list) -> dict:
    """One chat request with ``logprobs: true, top_logprobs: 3``: on C
    collocated, then over P's ``/v1/prefill`` and D's ``/v1/attach``.
    Each server runs it alone (its decode batch holds that row only), and
    the two answers — envelope, text, logprobs — and the requests' tokens
    and logprob records must be equal bitwise."""
    p_url, d_url, c_url = urls
    chat = {"messages": [{"role": "system", "content": "answer briefly"},
                         {"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0.0, "logprobs": True,
            "top_logprobs": 3}
    st_c, c_text = _post(c_url + "/v1/chat/completions", chat)
    st_p, wire, _ = _http(p_url + "/v1/prefill", json.dumps(chat).encode())
    st_d, d_text, _ = _http(d_url + "/v1/attach", wire,
                            "application/octet-stream")
    if (st_c, st_p, st_d) != (200, 200, 200):
        raise AssertionError(f"{tag} chat over the hops: {st_c} {st_p} "
                             f"{st_d} {c_text[:200]} {d_text[:200]}")
    c_ans, d_ans = json.loads(c_text), json.loads(d_text)
    c_req, d_req = c_reqs[-1], d_reqs[-1]

    def records(r):
        return (r.output_tokens, r.output_logprobs, r.output_top_logprobs)

    if (d_ans["object"] != "chat.completion"
            or d_ans["choices"] != c_ans["choices"]
            or d_ans["usage"] != c_ans["usage"]
            or records(d_req) != records(c_req)
            or len(d_req.output_top_logprobs) != max_tokens):
        raise AssertionError(f"{tag} chat over the hops differs from C: "
                             f"{records(d_req)} {records(c_req)}")
    entries = d_ans["choices"][0]["logprobs"]["content"]
    return {"tokens": len(d_req.output_tokens), "entries": len(entries),
            "top_logprobs": max((len(e["top_logprobs"]) for e in entries),
                                default=0),
            "equal_bitwise": True}


def phase_disagg(torch, params, adapter_path: str,
                 quant: bool = False) -> dict:
    """Disaggregated serving at Llama-3-8B width and depth: a prefill-role
    server P (lanes), a decode-role server D (paged pool, 64-token blocks
    x 768, prefix cache, pipelined dispatch replaying the decode block's
    graph) and a collocated server C with D's flags, every one over the
    same weights with the smoke's adapter, all at prefill_batch=1 (P and C
    run the same bucketed prefill program) and a static 8 steps per
    dispatch (the graph keys do not depend on arrival timing).  ``quant``
    adds ``--kv-quantize int8`` to all three, and P's handoffs take the
    int8 wire.

    C serves the traffic first, cold: six prompts of 13-901 tokens (three
    on the adapter, one streamed, no shared prefix), 32 new greedy tokens,
    then two of them again and a ``max_tokens: 1`` request.  Then the
    smoke acts as the gateway and sends the same traffic in two hops:
    ``/v1/prefill`` on P, the handoff bytes to ``/v1/attach`` on D; then a
    streamed attach released mid-flight through ``/v1/prefill/release``
    and the release of an unknown id.  Checks: every two-hop answer's
    tokens equal C's cold answer for that prompt, bitwise; P launched
    flash 32 times per hop and no decode kernel; D no flash and no chunk,
    and its paged kernel 32 times per decode step (replays counted); D's
    graph keys equal C's; D's prefix reuse climbs by the repeats' full
    blocks; the KV pools of D's and C's rows for the longest prompt are
    equal bitwise; KV usage returns to its floor on D and C.

    Printed per request: wire bytes, P's hop wall and TTFT, the serialize,
    deserialize and attach walls, D's and C's TTFT, and D's and C's decode
    rate.  A decode rate counts the tokens after the request's first
    decode block over the time from that block's readback to the last
    token (``_decode_rate``), so it leaves out the wait for a slot and the
    first-use graph capture, which the TTFTs carry."""
    import threading
    import urllib.request

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B as cfg

    tag = "disagg-int8" if quant else "disagg"
    kvq = ["--kv-quantize", "int8"] if quant else []
    pool = ["--paged-kv-block", "64", "--paged-kv-blocks", "768",
            "--prefix-cache", "--pipeline-decode", "--adaptive-steps", "0",
            "--decode-steps", "8"] + kvq
    letters = "the quick brown fox jumps over the lazy dog "
    max_tokens = 32
    # prompt characters (+ BOS) as in the serve phase: buckets 16 .. 1024;
    # a distinct head per prompt, so no two share a prefix block
    jobs = [(f"[{i}] " + letters * 40)[:n]
            for i, n in enumerate((12, 50, 120, 400, 700, 900))]
    adapters = [None, "smoke-r8", None, "smoke-r8", None, "smoke-r8"]
    streamed = 2
    repeats = (3, 5)
    wave2 = [(jobs[i], adapters[i], max_tokens) for i in repeats] + [
        (jobs[0], None, 1)]
    wave1 = [(jobs[i], adapters[i], max_tokens) for i in range(len(jobs))]
    n_layers = cfg.n_layers
    paged_kernel = ("paged_decode_attention_quant" if quant
                    else "paged_decode_attention")

    def body(prompt, adapter, max_new, stream=False):
        b = {"prompt": prompt, "max_tokens": max_new, "temperature": 0.0,
             "stream": stream}
        if adapter:
            b["model"] = adapter
        return b

    def concurrently(fn, items):
        out = [None] * len(items)

        def run(i):
            out[i] = fn(i, *items[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(items))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        if any(o is None for o in out):
            raise AssertionError(f"{tag}: a request did not return")
        return out

    servers = []
    try:
        t0 = time.time()
        pre = _start_server(["--role", "prefill"] + kvq, params, adapter_path)
        servers.append(pre)
        dec = _start_server(["--role", "decode"] + pool, params, adapter_path)
        servers.append(dec)
        col = _start_server(["--role", "collocated"] + pool, params,
                            adapter_path)
        servers.append(col)
        init_s = time.time() - t0
        (_, p_eng, p_url), (_, d_eng, d_url), (_, c_eng, c_url) = servers
        longest = [256] + list(jobs[-1].encode())
        n_valid = len(longest) + max_tokens - 1
        rows = {"C": {}, "D": {}}
        _snapshot_row_kv(torch, c_eng, longest, n_valid, rows["C"])
        _snapshot_row_kv(torch, d_eng, longest, n_valid, rows["D"])
        c_reqs, d_reqs = [], []
        _record(c_eng, "submit", c_reqs)
        _record(d_eng, "attach_prefilled", d_reqs)
        programs = {name: {"prefill": 0, "chunk": 0} for name in "PDC"}
        for name, eng in (("P", p_eng), ("D", d_eng), ("C", c_eng)):
            _count_programs(eng, programs[name])
        stamps = {"D": {}, "C": {}}
        _stamp_decode(d_eng, stamps["D"])
        _stamp_decode(c_eng, stamps["C"])

        # -- C: the collocated baseline, cold --
        def collocated(i, prompt, adapter, max_new):
            st, text = _post(c_url + "/v1/completions",
                             body(prompt, adapter, max_new, i == streamed))
            if st != 200:
                raise AssertionError(f"{tag} C: {st} {text[:300]}")
            return text

        c_snap0 = c_eng.metrics_snapshot()
        reset_launches()
        concurrently(collocated, wave1)
        concurrently(lambda i, *job: collocated(len(jobs) + i, *job), wave2)
        for r in c_reqs:
            if not r.done.wait(300) or r.error:
                raise AssertionError(f"{tag} C: {r.error}")
        wait_blocks_processed(c_eng)
        torch.cuda.synchronize()
        c_launches = read_launches()
        c_snap1 = c_eng.metrics_snapshot()
        c_steps = int(c_snap1["dispatch_steps_hist"]["sum"]
                      - c_snap0["dispatch_steps_hist"]["sum"])
        check_only(c_launches, {
            "flash_prefill": programs["C"]["prefill"] * n_layers,
            "chunk_attention": programs["C"]["chunk"] * n_layers,
            paged_kernel: c_steps * n_layers}, f"{tag} C")
        cold = {(tuple(r.prompt_tokens), r.adapter, r.max_new_tokens):
                r for r in reversed(c_reqs)}  # the first of each wins

        # -- the same traffic in two hops, P then D --
        def two_hop(i, prompt, adapter, max_new, stream=False):
            t0 = time.time()
            st, wire, hdr = _http(
                p_url + "/v1/prefill",
                json.dumps(body(prompt, adapter, max_new, stream)).encode())
            t1 = time.time()
            if st != 200:
                raise AssertionError(f"{tag} P: {st} {wire[:300]}")
            st, text, hdr2 = _http(d_url + "/v1/attach", wire,
                                   "application/octet-stream")
            t2 = time.time()
            if st != 200:
                raise AssertionError(f"{tag} D: {st} {text[:300]}")
            return dict(
                request_id=hdr["x-request-id"], wire_bytes=len(wire),
                prefill_hop_ms=(t1 - t0) * 1e3,
                prefill_ttft_ms=float(hdr["x-prefill-ttft-ms"]),
                serialize_ms=float(hdr["x-handoff-serialize-ms"]),
                deserialize_ms=float(hdr2["x-handoff-deserialize-ms"]),
                attach_ms=float(hdr2["x-handoff-attach-ms"]),
                attach_hop_ms=(t2 - t1) * 1e3, stream=stream,
                text=text.decode())

        d_snap0 = d_eng.metrics_snapshot()
        reset_launches()
        hops = concurrently(
            lambda i, *job: two_hop(i, *job, stream=i == streamed), wave1)
        hops += concurrently(two_hop, wave2)

        # An attach released while it decodes, then an unknown id.
        t_rel = time.time()
        st, wire, hdr = _http(p_url + "/v1/prefill", json.dumps(
            body(jobs[1], None, 512)).encode())
        if st != 200:
            raise AssertionError(f"{tag} P (release): {st}")
        rid = hdr["x-request-id"]
        live = {}
        attach = threading.Thread(target=lambda: live.update(resp=_http(
            d_url + "/v1/attach", wire, "application/octet-stream")))
        attach.start()
        deadline = time.time() + 120
        while not any(r.request_id == rid and len(r.output_tokens) >= 2
                      for r in d_reqs):  # decoding on D
            if time.time() > deadline:
                raise AssertionError(f"{tag}: the attach never decoded")
            time.sleep(0.005)
        st, text, _ = _http(d_url + "/v1/prefill/release",
                            json.dumps({"request_id": rid}).encode())
        released = json.loads(text)
        attach.join(600)
        st2, text2, _ = _http(d_url + "/v1/prefill/release",
                              json.dumps({"request_id": "no-such"}).encode())
        unknown = json.loads(text2)
        answer = json.loads(live["resp"][1])["choices"][0]
        if (st, released.get("released"), st2, unknown.get("released"),
                answer["finish_reason"]) != (200, True, 200, False,
                                             "cancelled"):
            raise AssertionError(f"{tag} release: {released} {unknown} "
                                 f"{answer}")
        release_s = time.time() - t_rel
        n_hops = len(hops) + 1
        for r in d_reqs:
            if not r.done.wait(300):
                raise AssertionError(f"{tag} D: a request never finished")
        wait_blocks_processed(d_eng)
        torch.cuda.synchronize()
        launches = read_launches()
        d_snap1 = d_eng.metrics_snapshot()
        d_steps = int(d_snap1["dispatch_steps_hist"]["sum"]
                      - d_snap0["dispatch_steps_hist"]["sum"])
        if programs["P"] != {"prefill": n_hops, "chunk": 0} or programs[
                "D"] != {"prefill": 0, "chunk": 0}:
            raise AssertionError(f"{tag}: programs {programs}")
        # Flash is P's alone (D ran no prefill program) and the paged
        # kernel D's alone (P holds lanes); the lane kernels stay at 0.
        check_only(launches, {"flash_prefill": n_hops * n_layers,
                              paged_kernel: d_steps * n_layers}, tag)

        # -- checks --
        by_id = {r.request_id: r for r in d_reqs}
        per_request = []
        for hop, (prompt, adapter, max_new) in zip(hops, wave1 + wave2):
            d = by_id[hop.pop("request_id")]
            tokens = [256] + list(prompt.encode())
            c = cold[(tuple(tokens), adapter, max_new)]
            if d.error or d.output_tokens != c.output_tokens:
                raise AssertionError(
                    f"{tag}: {len(tokens)}-token prompt, two hops "
                    f"{d.output_tokens[:8]}... ({d.error}) != collocated "
                    f"{c.output_tokens[:8]}...")
            per_token = (n_layers * cfg.n_kv_heads
                         * (cfg.resolved_head_dim + 4 if quant
                            else 2 * cfg.resolved_head_dim) * 2)
            if hop["wire_bytes"] < len(tokens) * per_token:
                raise AssertionError(f"{tag}: {hop['wire_bytes']} wire bytes "
                                     f"for {len(tokens)} tokens")
            text = hop.pop("text")
            if not hop["stream"] and json.loads(text)["usage"][
                    "completion_tokens"] != max_new:
                raise AssertionError(f"{tag}: {text[:200]}")
            row = dict(prompt_tokens=len(tokens), adapter=adapter,
                       max_tokens=max_new, **hop,
                       d_ttft_ms=d.ttft_s * 1e3,
                       d_decode_tokens_per_s=_decode_rate(d, stamps["D"]),
                       c_ttft_ms=c.ttft_s * 1e3,
                       c_decode_tokens_per_s=_decode_rate(c, stamps["C"]))
            per_request.append(row)
            log(tag, "request " + json.dumps(row))
        c_repeats_equal = [
            r.output_tokens == cold[(tuple(r.prompt_tokens), r.adapter,
                                     r.max_new_tokens)].output_tokens
            for r in c_reqs[len(jobs):]]
        reused = (d_snap1["prefix_reused_tokens"]
                  - d_snap0["prefix_reused_tokens"])
        want_reused = sum((len(jobs[i]) + 1 - 1) // 64 * 64 for i in repeats)
        if reused != want_reused:
            raise AssertionError(f"{tag}: D reused {reused} prefix tokens, "
                                 f"expected {want_reused}")
        if d_eng._graphs.shapes != c_eng._graphs.shapes:
            raise AssertionError(f"{tag}: D's graphs {d_eng._graphs.shapes} "
                                 f"!= C's {c_eng._graphs.shapes}")
        for name in ("k", "v", "k_scale", "v_scale"):
            if name not in rows["C"]["kv"]:
                continue
            a, b = rows["D"]["kv"][name], rows["C"]["kv"][name]
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{tag}: D's and C's {name} pool rows "
                                     "differ")
        floor = {}
        for name, eng in (("D", d_eng), ("C", c_eng)):
            deadline = time.time() + 30
            while (eng.metrics_snapshot()["kv_cache_usage_perc"] > 0
                   and time.time() < deadline):
                time.sleep(0.05)
            snap = eng.metrics_snapshot()
            floor[name] = (snap["kv_cache_usage_perc"],
                           snap["kv_parked_tokens"])
            if floor[name] != (0.0, 0):
                raise AssertionError(f"{tag}: {name} KV usage/parked "
                                     f"{floor[name]} after the last request")
        chat = _chat_over_hops(tag, jobs[2], max_tokens, (p_url, d_url,
                                                          c_url),
                               c_reqs, d_reqs)
        with urllib.request.urlopen(d_url + "/metrics", timeout=60) as f:
            metrics_text = f.read().decode()
        for family in ('tpu:pool_role{role="decode"} 1',
                       "tpu:handoff_seconds_count", "tpu:prefix_reused_tokens"):
            if family not in metrics_text:
                raise AssertionError(f"{tag}: D's /metrics lacks {family}")
        stats = {
            "init_s": init_s, "release_s": release_s, "hops": n_hops,
            "d_decode_steps": d_steps, "c_decode_steps": c_steps,
            "c_programs": programs["C"], "d_prefix_reused_tokens": reused,
            "c_repeats_equal_c_cold": c_repeats_equal,
            "graph_shapes": d_eng._graphs.shapes,
            "pool_rows_compared": {k: list(v.shape) for k, v in
                                   rows["D"]["kv"].items()},
            "launches": launches, "c_launches": c_launches,
            "chat_over_hops": chat, "per_request": per_request,
        }
        log(tag, "llama3-8b P (lanes) -> D (paged 64 x 768, prefix cache, "
            "pipelined graphs) vs C" + (", --kv-quantize int8" if quant
                                        else "") + ": "
            + json.dumps({k: v for k, v in stats.items()
                          if k != "per_request"}))
        return stats
    finally:
        for httpd, engine, _ in servers:
            httpd.shutdown()
            httpd.server_close()
            engine.stop()


KERNEL_SOURCES = {
    "flash_prefill": (
        "llm_instance_gateway_tpu_torch/ops/csrc/flash_prefill.cu",
        "llm_instance_gateway_tpu/ops/pallas_attention.py:120"),
    "decode_attention": (
        "llm_instance_gateway_tpu_torch/ops/csrc/decode_attention.cu",
        "llm_instance_gateway_tpu/ops/pallas_decode_attention.py:176"),
    "chunk_attention": (
        "llm_instance_gateway_tpu_torch/ops/csrc/chunk_attention.cu",
        "llm_instance_gateway_tpu/ops/pallas_attention.py:227"),
    "paged_decode_attention": (
        "llm_instance_gateway_tpu_torch/ops/csrc/paged_decode_attention.cu",
        "llm_instance_gateway_tpu/ops/pallas_decode_attention.py:227"),
    "decode_attention_quant": (
        "llm_instance_gateway_tpu_torch/ops/csrc/decode_attention_quant.cu",
        "llm_instance_gateway_tpu/ops/pallas_decode_attention.py:188"),
    "paged_decode_attention_quant": (
        "llm_instance_gateway_tpu_torch/ops/csrc/"
        "paged_decode_attention_quant.cu",
        "llm_instance_gateway_tpu/ops/pallas_decode_attention.py:227"),
    # No pallas_call: the gradient of flash_attention (the entry whose
    # gradient JAX takes through XLA's prefill_attention).
    "flash_backward": (
        "llm_instance_gateway_tpu_torch/ops/csrc/flash_backward.cu",
        "llm_instance_gateway_tpu/ops/pallas_attention.py:306"),
}


SPEC_K = 4
SPEC_FLAGS = ["--speculative", str(SPEC_K), "--draft-model", "llama3-8b"]


def _wave(url: str, bodies: list) -> list:
    """POST every body to /v1/completions at once; returns (status, text,
    seconds) per body."""
    import threading

    results = [None] * len(bodies)

    def run(i):
        t = time.time()
        results[i] = _post(url + "/v1/completions", bodies[i]) + (
            time.time() - t,)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"request {i}: {res and res[:2]}")
    return results


def _count_spec_programs(engine) -> dict:
    """Count bucketed prefills and chunk programs (``_count_programs``) and
    the draft's admissions that prefilled it (flash launches follow each),
    keeping every admitted row's speculation flag."""
    programs = {"prefill": 0, "chunk": 0, "draft_admit": 0, "rows": []}
    _count_programs(engine, programs)
    admit = engine._draft_admit

    def call(slot_idx, prompt):
        admit(slot_idx, prompt)
        ok = bool(engine._slot_spec_ok[slot_idx])
        programs["draft_admit"] += ok
        programs["rows"].append((len(prompt), ok))

    engine._draft_admit = call
    return programs


def _check_admits(tag: str, programs: dict, n_short: int) -> None:
    """Every greedy prompt within the largest bucket was mirrored into the
    draft's lanes: a failed draft admission downgrades its row silently
    (the reference's behaviour) and would shrink the expected flash count
    with it."""
    short = [ok for length, ok in programs["rows"] if length <= 1024]
    if len(short) != n_short or not all(short):
        raise AssertionError(f"{tag}: draft admissions {programs['rows']}, "
                             f"want {n_short} speculating rows")


def _spec_row_tokens(engine, store: dict) -> None:
    """Per spec block (sync loop), the tokens each row emitted per cycle it
    took part in, summed by base and adapter rows."""
    run = engine._run_spec_block
    k1 = engine.cfg.speculative_k + 1

    def call(n_cycles):
        out = run(n_cycles)
        valid = out[:, :, 1].reshape(n_cycles, k1, -1).sum(1).cpu()
        for i, slot in enumerate(engine.slots):
            if slot is not None:
                row = valid[:, i]
                acc = store["adapter" if slot.request.adapter else "base"]
                acc[0] += int(row.sum())
                acc[1] += int((row > 0).sum())
        return out

    engine._run_spec_block = call


def _wait_processed(eng) -> None:
    """Pipelined: wait until every replayed block (spec or plain) is
    processed, so the steps histogram and the spec counters are final."""
    deadline = time.time() + 60
    while time.time() < deadline:
        done = sum(eng.profiler.dispatches.get(p, 0)
                   for p in ("spec", "decode"))
        if done == eng._graphs.replays:
            return
        time.sleep(0.01)
    raise AssertionError("a dispatched block was never processed")


def _kv_floor(tag: str, engine) -> None:
    deadline = time.time() + 30
    while (engine.metrics_snapshot()["kv_cache_usage_perc"] > 0
           and time.time() < deadline):
        time.sleep(0.05)
    snap = engine.metrics_snapshot()
    if snap["kv_cache_usage_perc"] != 0.0 or (
            "kv_ledger" in snap
            and snap["kv_ledger"]["states"]["active"] != 0):
        raise AssertionError(f"{tag}: KV not back at its floor: "
                             f"{snap['kv_cache_usage_perc']}")


def _block_rate(snap0: dict, snap1: dict, n_requests: int) -> float:
    """Decode tokens per second of decode-block wall between two
    snapshots: tokens emitted by decode and spec blocks (every request's
    first token comes from its prefill) over the blocks' walls."""
    tokens = snap1["total_generated"] - snap0["total_generated"] - n_requests
    wall = sum(snap1["block_s"].get(p, 0.0) - snap0["block_s"].get(p, 0.0)
               for p in ("spec", "decode"))
    return tokens / wall if wall > 0 else float("nan")


def _rate_snap(eng) -> dict:
    return {"total_generated": eng.total_generated,
            "block_s": dict(eng.profiler.dispatch_seconds)}


def _first_difference(a: list, b: list):
    """The first position where two token lists differ, None if equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _spec_checks(tag: str, engine, launches: dict, programs: dict,
                 snap0: dict, snap1: dict, url: str, paged: bool) -> dict:
    """Exact launch counts of a speculative server's window: flash 32 per
    bucketed prefill and per draft admission, the lane kernel 32 x (K-1)
    per spec cycle (the draft's decode steps) and the target's decode
    kernel 32 per plain step, chunk 32 per chunk program; and the
    /metrics families."""
    import urllib.request

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B as cfg

    n = cfg.n_layers
    cycles = snap1["spec_cycles"] - snap0["spec_cycles"]
    plain = int(snap1["dispatch_steps_hist"]["sum"]
                - snap0["dispatch_steps_hist"]["sum"])
    if cycles <= 0:
        raise AssertionError(f"{tag}: no spec cycle")
    target_kernel = "paged_decode_attention" if paged else "decode_attention"
    want = {"flash_prefill": n * (programs["prefill"]
                                  + programs["draft_admit"]),
            "decode_attention": n * (SPEC_K - 1) * cycles}
    if plain:
        want[target_kernel] = want.get(target_kernel, 0) + n * plain
    if programs["chunk"]:
        want["chunk_attention"] = n * programs["chunk"]
    check_only(launches, want, tag)
    with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
        text = f.read().decode()
    spec_lines = [ln for ln in text.splitlines()
                  if ln.startswith(("tpu:spec_cycles ",
                                    "tpu:spec_tokens_per_cycle "))]
    if len(spec_lines) != 2:
        raise AssertionError(f"{tag}: /metrics spec families {spec_lines}")
    return {"spec_cycles": cycles, "plain_steps": plain,
            "programs": {k: v for k, v in programs.items() if k != "rows"},
            "metrics": spec_lines, "launches": launches,
            "spec_graph_keys": engine._graphs.spec_shapes,
            "decode_graph_keys": engine._graphs.shapes,
            "capture_s_by_key": {
                f"{key[0]}{tuple(key[1:])}": round(v, 3)
                for key, v in engine._graphs.capture_s_by_key.items()}}


def _spec_cycle_profile(torch, engine) -> dict:
    """One spec cycle at 8 rows of 100-800 tokens (mixed adapters): the
    engine's graph replay (device ms, idle share), and the engine's eager
    block under torch.profiler split by its own ranges into the draft's
    part (catch-up and K-1 decode steps) and the target's verify, the
    rest being acceptance, sampling and logprobs.  The server is idle; the
    rows are set up here."""
    from torch.profiler import ProfilerActivity, profile

    d, b = engine._dev, engine.cfg.decode_slots
    dev = torch.device("cuda")
    lengths = torch.tensor([100 * (i + 1) for i in range(b)], device=dev)
    d["tokens"].copy_(torch.arange(b, device=dev) + 65)
    d["positions"].copy_(lengths)
    d["remaining"].fill_(10 ** 6)
    d["has_extra"].fill_(False)
    d["spec_ok"].fill_(True)
    d["temp"].fill_(0.0)
    d["lora"].copy_(torch.tensor([-1, 0] * (b // 2), device=dev))
    graphs = engine._graphs
    cycle = _profile(torch, "spec cycle (the engine's graph replay)",
                     lambda: graphs.run(engine._spec_block, 1, SPEC_K, False,
                                        kind="spec"), 3, host=True)
    reps = 1  # the host's per-op events are what the split reads
    engine._spec_block(1, SPEC_K, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine._spec_block(1, SPEC_K, False)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    parts = {"spec_draft": 0.0, "spec_verify": 0.0}
    total_us = 0.0
    for ev in prof.events():
        if ev.device_type == cpu and ev.name in parts:
            parts[ev.name] += ev.device_time_total / reps / 1e3
        elif ev.device_type != cpu and not getattr(ev, "is_user_annotation",
                                                   False):
            total_us += ev.device_time_total
    eager_ms = total_us / reps / 1e3
    split = {"eager_device_ms": eager_ms or "not measured",
             "draft_ms": parts["spec_draft"] or "not measured",
             "verify_ms": parts["spec_verify"] or "not measured",
             "rest_ms": (eager_ms - sum(parts.values())) if eager_ms
             else "not measured"}
    log("profile", "spec cycle, eager block split by its ranges: "
        + json.dumps(split))
    return {"cycle": cycle, "split": split}


def _paged_verify_profile(torch, engine) -> dict:
    """The paged verify (``extend_step_paged``, K+1 tokens) over 8 rows of
    4000-5750 tokens: the gathered full view of every row, per layer."""
    from llm_instance_gateway_tpu_torch.models import paged

    dev = torch.device("cuda")
    b, block = engine.cfg.decode_slots, engine._block
    m = engine.cache["tables"].shape[1]
    lengths = [4000 + 250 * i for i in range(b)]
    tables = torch.zeros(b, m, dtype=torch.int32)
    nxt = 1
    for i, n in enumerate(lengths):
        need = -(-(n + SPEC_K + 1) // block)
        tables[i, :need] = torch.arange(nxt, nxt + need)
        nxt += need
    cache = dict(engine.cache, tables=tables.to(dev))
    pos = torch.tensor(lengths, device=dev)
    vpos = pos[:, None] + torch.arange(SPEC_K + 1, device=dev)[None]
    vtokens = (vpos % 200 + 65).long()
    slots = torch.tensor([-1, 0] * (b // 2), device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)

    def verify():
        lg, _ = paged.extend_step_paged(
            engine.model_cfg, engine.params, cache, vtokens, vpos,
            lora_bufs=engine.lora.buffers, slot_ids=slots, active=active)
        return lg.argmax(-1)

    return _graph_profile(torch, "paged verify over 8 rows of 4000-5750",
                          verify, 2)


def phase_spec(torch, params, adapter_path: str, plain_answers: dict) -> dict:
    """Speculative decoding and penalties at Llama-3-8B width and depth
    (bf16, the serve phase's weights and adapter), one server at a time:

    (a) the lane server with ``--speculative 4`` and the perfect draft (the
    target's own params): the serve phase's six prompts (three on the
    adapter, one streamed), 32 greedy tokens, twice (the second wave with
    every graph captured, timed); exact launches, the spec families on
    /metrics, the graph keys, KV at its floor, a penalty answered 400 in
    the reference's words; printed: tokens per cycle for base and adapter
    rows (the draft has no LoRA), each answer's first difference from the
    serve phase's plain answer (bf16: the verify's einsum and the decode
    kernel round otherwise, so near-ties may split), one replayed cycle's
    device ms with its draft and verify parts;
    (b) paged and pipelined (64-token blocks x 768, prefix cache,
    ``--max-seq-len 8192``, a static 4 steps a dispatch) with the perfect
    draft: the paged serve's five shared-prefix prompts and one ~3000-token
    prompt that streams in chunks and never speculates; the checks of (a)
    and prefix reuse; the paged verify's device ms at 8 long rows;
    (c) the lane server without speculation: the six prompts twice (the
    plain decode rate beside (a)'s), then presence 2.0 and frequency 2.0
    rows and a row with a +100 logit_bias beside plain rows: the biased
    row emits its token at every step, the penalized graph key appears,
    the launches are the serve phase's."""
    import gc

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B as cfg

    n = cfg.n_layers
    out = {}
    bodies = [_serve_body(c, m, st, 32) for c, m, st in SERVE_JOBS]
    by_path = {}

    def add(launches):
        for k, v in launches.items():
            by_path[k] = by_path.get(k, 0) + v

    def stop(httpd, engine):
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        gc.collect()
        torch.cuda.empty_cache()

    # -- (a) lanes, sync loop, perfect draft --
    tag = "spec-lanes"
    t0 = time.time()
    httpd, eng, url = _start_server(SPEC_FLAGS, params, adapter_path,
                                    draft_params=params)
    try:
        reqs: list = []
        _record(eng, "submit", reqs)
        programs = _count_spec_programs(eng)
        per_row = {"base": [0, 0], "adapter": [0, 0]}
        _spec_row_tokens(eng, per_row)
        snap0 = eng.metrics_snapshot()
        reset_launches()
        _wave(url, bodies)
        launches = read_launches()
        snap1 = eng.metrics_snapshot()
        _check_admits(tag, programs, len(bodies))
        stats = _spec_checks(tag, eng, launches, programs, snap0, snap1, url,
                             paged=False)
        add(launches)
        for r in reqs:
            if not (len(r.output_tokens) == 32 or r.finish_reason == "stop"):
                raise AssertionError(f"{tag}: {r.finish_reason} after "
                                     f"{len(r.output_tokens)} tokens")
        _kv_floor(tag, eng)
        stats["agreement_first_difference"] = [
            _first_difference(r.output_tokens, plain_answers[
                (tuple(r.prompt_tokens), r.adapter)]) for r in reqs]
        # The checkpoint phase's spec server is held to these.
        stats["answers"] = {(tuple(r.prompt_tokens), r.adapter):
                            list(r.output_tokens) for r in reqs}
        stats["tokens_per_cycle"] = {
            k: (v[0] / v[1] if v[1] else None) for k, v in per_row.items()}
        # The second wave: every graph captured; the decode rate.
        r0 = _rate_snap(eng)
        t_wave = time.time()
        _wave(url, bodies)
        stats["wave2_s"] = time.time() - t_wave
        stats["decode_tokens_per_s"] = _block_rate(r0, _rate_snap(eng),
                                                   len(bodies))
        status, text = _post(url + "/v1/completions", {
            "prompt": "penalized", "max_tokens": 4, "presence_penalty": 1.0})
        refusal = ("presence/frequency penalties and logit_bias are not "
                   "supported on a speculative engine")
        if status != 400 or refusal not in text:
            raise AssertionError(f"{tag}: a penalty answered {status} {text}")
        stats["phase_s"] = time.time() - t0
        log(tag, json.dumps({k: v for k, v in stats.items()
                             if k not in ("launches", "answers")}))
        stats["profile"] = _spec_cycle_profile(torch, eng)
        out["lanes"] = stats
    finally:
        stop(httpd, eng)

    # -- (b) paged pool, pipelined loop, perfect draft --
    tag = "spec-paged"
    t0 = time.time()
    httpd, eng, url = _start_server(
        ["--max-seq-len", "8192", "--paged-kv-block", "64",
         "--paged-kv-blocks", "768", "--prefix-cache", "--pipeline-decode",
         "--adaptive-steps", "0", "--decode-steps", "4"] + SPEC_FLAGS,
        params, adapter_path, draft_params=params)
    try:
        programs = _count_spec_programs(eng)
        system = ("You are a careful assistant for a travel company. "
                  * 12)[:600]
        questions = ["Where can I fly?", "What does a refund cost me now?",
                     "Which hotels near the old harbour allow pets inside?",
                     "Can I move my booking from May to June without fees??",
                     "Is breakfast included?"]
        pbodies = [{"prompt": system + q, "max_tokens": 32,
                    "temperature": 0.0, **({"model": "smoke-r8"} if i % 2
                                           else {})}
                   for i, q in enumerate(questions)]
        long_prompt = ("A long report: " + SERVE_TEXT * 2)[:3000]
        pbodies.append({"prompt": long_prompt, "max_tokens": 32,
                        "temperature": 0.0})
        snap0 = eng.metrics_snapshot()
        reset_launches()
        _wave(url, pbodies)
        _wait_processed(eng)
        launches = read_launches()
        snap1 = eng.metrics_snapshot()
        _check_admits(tag, programs, len(questions))
        stats = _spec_checks(tag, eng, launches, programs, snap0, snap1, url,
                             paged=True)
        add(launches)
        long_rows = [ok for length, ok in programs["rows"] if length > 1024]
        if long_rows != [False] or programs["chunk"] < 3:
            raise AssertionError(f"{tag}: the long prompt's rows "
                                 f"{long_rows}, chunks {programs['chunk']}")
        reused = snap1["prefix_reused_tokens"] - snap0["prefix_reused_tokens"]
        if reused <= 0:
            raise AssertionError(f"{tag}: no prefix reuse")
        _kv_floor(tag, eng)
        stats["prefix_reused_tokens"] = reused
        stats["phase_s"] = time.time() - t0
        log(tag, json.dumps({k: v for k, v in stats.items()
                             if k != "launches"}))
        stats["profile"] = _paged_verify_profile(torch, eng)
        out["paged"] = stats
    finally:
        stop(httpd, eng)

    # -- (c) lanes without speculation: the plain rate, then penalties --
    tag = "penalties"
    t0 = time.time()
    httpd, eng, url = _start_server([], params, adapter_path)
    try:
        _wave(url, bodies)  # captures the plain graphs
        r0 = _rate_snap(eng)
        _wave(url, bodies)
        plain_rate = _block_rate(r0, _rate_snap(eng), len(bodies))
        reqs = []
        _record(eng, "submit", reqs)
        forced = 4242
        pen = [{"presence_penalty": 2.0, "frequency_penalty": 2.0},
               {"presence_penalty": 2.0, "frequency_penalty": 2.0,
                "model": "smoke-r8"},
               {"logit_bias": {str(forced): 100}}, {}, {}]
        snap0 = eng.metrics_snapshot()
        reset_launches()
        _wave(url, [dict(_serve_body(c, m, False, 32), **extra)
                    for (c, m, _), extra in zip(SERVE_JOBS, pen)])
        launches = read_launches()
        snap1 = eng.metrics_snapshot()
        add(launches)
        steps = int(snap1["dispatch_steps_hist"]["sum"]
                    - snap0["dispatch_steps_hist"]["sum"])
        check_only(launches, {"flash_prefill": len(pen) * n,
                              "decode_attention": steps * n}, tag)
        biased = [r for r in reqs if r.sampling.logit_bias]
        if len(biased) != 1 or set(biased[0].output_tokens) != {forced}:
            raise AssertionError(f"{tag}: biased row "
                                 f"{[r.output_tokens for r in biased]}")
        keys = eng._graphs.shapes
        if not any(p for _, _, p in keys):
            raise AssertionError(f"{tag}: no penalized graph key: {keys}")
        _kv_floor(tag, eng)
        penalized = [r for r in reqs if r.sampling.presence_penalty]
        stats = {"plain_decode_tokens_per_s": plain_rate,
                 "spec_decode_tokens_per_s":
                 out["lanes"]["decode_tokens_per_s"],
                 "graph_keys": keys, "steps": steps, "launches": launches,
                 "penalized_first_difference": [
                     _first_difference(r.output_tokens, plain_answers[
                         (tuple(r.prompt_tokens), r.adapter)])
                     for r in penalized],
                 "penalized_distinct_tokens": [len(set(r.output_tokens))
                                               for r in penalized],
                 "capture_s_by_key": {
                     f"{key[0]}{tuple(key[1:])}": round(v, 3)
                     for key, v in eng._graphs.capture_s_by_key.items()},
                 "phase_s": time.time() - t0}
        log(tag, json.dumps({k: v for k, v in stats.items()
                             if k != "launches"}))
        out["penalties"] = stats
    finally:
        stop(httpd, eng)
    out["launches"] = by_path
    return out


SURFACE_FLAGS = ["--prefill-batch", "4", "--pipeline-decode"]
ADAPTER = "smoke-r8"


def _get(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as f:
        return f.read().decode()


def _sse_chunks(text: str) -> list:
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    if not lines or lines[-1] != "[DONE]":
        raise AssertionError(f"stream did not end with [DONE]: {text[-200:]}")
    return [json.loads(ln) for ln in lines[:-1]]


def phase_surface(torch, params, adapter_path: str, plain_answers: dict,
                  sync_shares: dict) -> dict:
    """The rest of the OpenAI surface, tracing, the flight recorder and the
    residency ladder at Llama-3-8B width and depth, on the serve phase's
    weights and adapter: one lane server with ``--prefill-batch 4
    --pipeline-decode``, one request (or fan-out) at a time.

    - chat, JSON and streamed: the tokens equal a /v1/completions of the
      same role transcript, bitwise;
    - a greedy completion with ``logprobs: 5``: each sampled logprob equals
      its top-1 value, the top lists are sorted, Σ exp over the top-5 is
      at most 1 + 1e-5, and the tokens equal the serve phase's answer;
    - ``n: 3`` seeded at temperature 0.8: three distinct choices, admitted
      in one grouped prefill (exact launches: flash 32 per prefill
      program, the lane kernel 32 per decode step, replays counted), each
      bitwise equal to a single request with seed ``s+i`` (the three
      singles submitted at once, so they share a grouped prefill of the
      same shape: bf16 rows of a [3, bucket] program may round otherwise
      than a [1, bucket] one's);
    - ``best_of: 4, n: 2``: the candidates equal ``n: 4``'s with the same
      seed, and the answer keeps the two best by mean logprob;
    - ``echo``, JSON and streamed (the prompt leads, as its own chunk);
    - a traced request: the id is echoed, the spans lie inside the
      request's wall time, the ``engine.prefill`` span lies within 5 ms of
      the reported TTFT;
    - the ladder on the loaded adapter: demote refused (409) while a
      request pins it, demote, promote from the host tier, demote, evict,
      prefetch, promote; the adapter row's greedy tokens equal the serve
      phase's adapter answer bitwise at the start and after each
      promotion;
    - drain: ``/debug/events`` holds ``role_change`` and
      ``tpu:events_total`` counts it.

    Prints the step profiler's attribution shares (pipelined, beside the
    serve phase's sync loop), host-tier promotion ms against disk load ms,
    and the phase's wall time."""
    import threading
    import urllib.request

    from llm_instance_gateway_tpu_torch.server.engine import (
        Request, SamplingParams)
    from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer

    tag = "surface"
    t_phase = time.time()
    httpd, engine, url = _start_server(SURFACE_FLAGS, params, adapter_path)
    n_layers = engine.model_cfg.n_layers
    subs: list = []
    _record(engine, "submit", subs)
    programs = {"prefill": 0, "chunk": 0}
    _count_programs(engine, programs)
    grouped: list = []
    many = engine._prefill_many_impl

    def counted(*args, **kwargs):
        grouped.append(len(args[0]))
        return many(*args, **kwargs)

    engine._prefill_many_impl = counted
    total = {name: 0 for name in _counters()}
    out: dict = {}

    def window() -> dict:
        """The launches since the last window, added to the phase's."""
        w = read_launches()
        reset_launches()
        for k, v in w.items():
            total[k] += v
        return w

    def call(path: str, body: dict, headers=None):
        req = urllib.request.Request(url + path,
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json",
                                              **(headers or {})})
        with urllib.request.urlopen(req, timeout=600) as f:
            text, hdr = f.read().decode(), f.headers
        return (_sse_chunks(text) if body.get("stream")
                else json.loads(text)), hdr

    def tokens(n: int) -> list:
        return [list(r.output_tokens) for r in subs[-n:]]

    try:
        reset_launches()
        # -- chat against the same transcript on /v1/completions --
        content = SERVE_TEXT[:120]
        chat = {"messages": [{"role": "user", "content": content}],
                "max_tokens": 24, "temperature": 0.0}
        answer, _ = call("/v1/chat/completions", chat)
        chunks, _ = call("/v1/chat/completions", dict(chat, stream=True))
        plain, _ = call("/v1/completions", {
            "prompt": f"user: {content}\nassistant:", "max_tokens": 24,
            "temperature": 0.0})
        a, b, c = subs[-3:]
        if not (a.prompt_tokens == b.prompt_tokens == c.prompt_tokens
                and a.output_tokens == b.output_tokens == c.output_tokens):
            raise AssertionError(f"{tag} chat: {tokens(3)}")
        if (answer["object"], chunks[0]["object"]) != (
                "chat.completion", "chat.completion.chunk") or \
                chunks[-1]["usage"] != answer["usage"] or \
                answer["choices"][0]["message"]["content"] != \
                plain["choices"][0]["text"]:
            raise AssertionError(f"{tag} chat envelope: {answer} "
                                 f"{chunks[-1]}")
        out["chat"] = {"prompt_tokens": len(a.prompt_tokens),
                       "tokens": len(a.output_tokens), "chunks": len(chunks)}

        # -- logprobs: 5 on a greedy completion --
        answer, _ = call("/v1/completions", {
            "prompt": SERVE_TEXT[:120], "max_tokens": 32,
            "temperature": 0.0, "logprobs": 5})
        r = subs[-1]
        if r.output_tokens != plain_answers[(tuple(r.prompt_tokens), None)]:
            raise AssertionError(f"{tag} logprobs: tokens differ from the "
                                 f"serve phase's answer")
        mass = 0.0
        for lp, top in zip(r.output_logprobs, r.output_top_logprobs,
                           strict=True):
            vals = list(top.values())
            mass = max(mass, sum(math.exp(v) for v in vals))
            if (len(vals) != 5 or lp != vals[0]
                    or vals != sorted(vals, reverse=True)
                    or mass > 1 + 1e-5):
                raise AssertionError(f"{tag} logprobs: {lp} {top}")
        lp_json = answer["choices"][0]["logprobs"]
        if any(lp != max(t.values()) for lp, t in zip(
                lp_json["token_logprobs"], lp_json["top_logprobs"])):
            raise AssertionError(f"{tag} logprobs envelope: {lp_json}")
        out["logprobs"] = {"tokens": len(r.output_tokens),
                           "max_top5_mass": mass}

        # -- n: 3, seeded, in one grouped prefill --
        seeded = {"prompt": SERVE_TEXT[:200], "max_tokens": 16,
                  "temperature": 0.8, "seed": 1234}
        # The block the pipelined loop held past the last request is
        # processed (and in the steps histogram) before the window opens.
        wait_blocks_processed(engine)
        torch.cuda.synchronize()
        window()
        grouped.clear()
        progs0 = dict(programs)
        snap0 = engine.metrics_snapshot()
        answer, _ = call("/v1/completions", dict(seeded, n=3))
        wait_blocks_processed(engine)
        torch.cuda.synchronize()
        launches = window()
        steps = int(engine.metrics_snapshot()["dispatch_steps_hist"]["sum"]
                    - snap0["dispatch_steps_hist"]["sum"])
        if grouped != [3] or programs != progs0:
            raise AssertionError(f"{tag} n=3: grouped prefills {grouped}, "
                                 f"programs {programs} (was {progs0})")
        check_only(launches, {"flash_prefill": n_layers,
                              "decode_attention": steps * n_layers},
                   f"{tag} n=3")
        fan = tokens(3)
        if len({tuple(t) for t in fan}) != 3:
            raise AssertionError(f"{tag} n=3: choices not distinct {fan}")
        singles = [Request(prompt_tokens=list(subs[-1].prompt_tokens),
                           max_new_tokens=16, sampling=SamplingParams(
                               temperature=0.8, seed=1234 + i))
                   for i in range(3)]
        with engine._work:  # one admission pass sees all three
            for q in singles:
                engine.submit(q)
        for q in singles:
            if not q.done.wait(300) or q.error:
                raise AssertionError(f"{tag} single: {q.error}")
        if grouped != [3, 3] or [q.output_tokens for q in singles] != fan:
            raise AssertionError(f"{tag} n=3 vs seeds s+i: {grouped} "
                                 f"{[q.output_tokens for q in singles]} "
                                 f"{fan}")
        out["n3"] = {"decode_steps": steps, "launches": launches,
                     "usage": answer["usage"]}

        # -- best_of: 4, n: 2 against n: 4 with the same seed --
        # (ranked in process: at 8B most ids are not bytes, so the
        # envelope's text and its logprob walk are mostly empty)
        four, _ = call("/v1/completions", dict(seeded, n=4, logprobs=0))
        fours = subs[-4:]
        best, _ = call("/v1/completions", dict(seeded, n=2, best_of=4))
        if [(r.output_tokens, r.output_logprobs) for r in subs[-4:]] != [
                (r.output_tokens, r.output_logprobs) for r in fours]:
            raise AssertionError(f"{tag} best_of: candidates differ from "
                                 f"n=4's")
        ranked = sorted(fours, key=lambda r: -sum(r.output_logprobs)
                        / len(r.output_logprobs))
        decode = ByteTokenizer().decode
        if ([ch["text"] for ch in best["choices"]]
                != [decode(r.output_tokens) for r in ranked[:2]]
                or best["usage"] != four["usage"]):
            raise AssertionError(f"{tag} best_of: {best} against {four}")
        out["best_of"] = {"usage": best["usage"], "grouped": grouped[-2:]}

        # -- echo, JSON and streamed --
        echo = {"prompt": "echo this prompt", "max_tokens": 8,
                "temperature": 0.0, "echo": True}
        answer, _ = call("/v1/completions", echo)
        chunks, _ = call("/v1/completions", dict(echo, stream=True))
        streamed = "".join(ch["choices"][0]["text"] for ch in chunks)
        if (chunks[0]["choices"][0]["text"] != echo["prompt"]
                or not answer["choices"][0]["text"].startswith(echo["prompt"])
                or streamed != answer["choices"][0]["text"]
                or subs[-1].output_tokens != subs[-2].output_tokens):
            raise AssertionError(f"{tag} echo: {answer} {streamed!r}")

        # -- a traced request, on an engine with no block in flight (else
        # its admission waits for that block: queue time, not TTFT's) --
        wait_blocks_processed(engine)
        tid = "5eed00000000abcd"
        t0 = time.time()
        answer, hdr = call("/v1/completions", {
            "prompt": SERVE_TEXT[:60], "max_tokens": 16,
            "temperature": 0.0}, {"x-lig-trace-id": tid})
        t1 = time.time()
        spans = json.loads(hdr["x-lig-spans"])
        ttft = answer["ttft_ms"] / 1e3
        named = {sp[0]: sp for sp in spans}
        prefill, queue = named["engine.prefill"], named["engine.queue_wait"]
        if hdr["x-lig-trace-id"] != tid or not all(
                t0 - 1e-3 <= s0 <= s1 <= t1 + 1e-3 for _, s0, s1 in spans) \
                or abs((prefill[2] - queue[1]) - ttft) > 1e-3 \
                or abs((prefill[2] - prefill[1]) - ttft) > 5e-3:
            raise AssertionError(f"{tag} trace: {spans} ttft {ttft} "
                                 f"[{t0}, {t1}]")
        trace = json.loads(_get(url + f"/debug/traces?trace_id={tid}"))
        if [sp["name"] for sp in trace["traces"][0]["spans"]] != [
                sp[0] for sp in spans]:
            raise AssertionError(f"{tag} /debug/traces: {trace}")
        out["trace"] = {"spans": [sp[0] for sp in spans],
                        "ttft_ms": ttft * 1e3,
                        "prefill_span_ms": (prefill[2] - prefill[1]) * 1e3,
                        "wall_ms": (t1 - t0) * 1e3}

        # -- the residency ladder on the loaded adapter --
        ad_body = {"prompt": SERVE_TEXT[:50], "max_tokens": 32,
                   "temperature": 0.0, "model": ADAPTER}
        load = {"lora_name": ADAPTER, "lora_path": adapter_path}

        def adapter_tokens(step: str) -> None:
            call("/v1/completions", ad_body)
            r = subs[-1]
            if r.output_tokens != plain_answers[(tuple(r.prompt_tokens),
                                                 ADAPTER)]:
                raise AssertionError(f"{tag} ladder, {step}: the adapter "
                                     f"row's tokens differ")

        def admin(path: str, body: dict, want: int):
            st, text = _post(url + path, body)
            if st != want:
                raise AssertionError(f"{tag} {path}: {st} {text[:300]}")
            return json.loads(text)

        adapter_tokens("slot-resident")
        pinned = {}
        pin = threading.Thread(target=lambda: pinned.update(res=_post(
            url + "/v1/completions", dict(ad_body, max_tokens=200,
                                          stream=True))))
        n_subs = len(subs)
        pin.start()
        deadline = time.time() + 120
        while not (len(subs) > n_subs
                   and len(subs[-1].output_tokens) >= 2):
            if time.time() > deadline:
                raise AssertionError(f"{tag}: the pinning request never "
                                     f"decoded")
            time.sleep(0.005)
        busy = admin("/v1/demote_lora_adapter", {"lora_name": ADAPTER}, 409)
        pin.join(600)
        if not pinned or pinned["res"][0] != 200:
            raise AssertionError(f"{tag}: pinning request {pinned}")
        ladder, call_ms = [], []
        for step, path, body in (
                ("demote", "/v1/demote_lora_adapter", {"lora_name": ADAPTER}),
                ("promote", "/v1/load_lora_adapter", load),
                ("demote", "/v1/demote_lora_adapter", {"lora_name": ADAPTER}),
                ("evict", "/v1/evict_lora_adapter", {"lora_name": ADAPTER}),
                ("prefetch", "/v1/prefetch_lora_adapter", load),
                ("promote", "/v1/load_lora_adapter", load)):
            t = time.perf_counter()
            admin(path, body, 200)
            torch.cuda.synchronize()  # the slot writes are queued
            call_ms.append((step, (time.perf_counter() - t) * 1e3))
            ladder.append((step, engine.lora.adapter_tiers().get(ADAPTER,
                                                                 "disk")))
            if step == "promote":
                adapter_tokens(f"promotion {len(ladder)}")
        if ladder != [("demote", "host"), ("promote", "slot"),
                      ("demote", "host"), ("evict", "disk"),
                      ("prefetch", "host"), ("promote", "slot")]:
            raise AssertionError(f"{tag} ladder: {ladder}")
        transitions, load_s = engine.lora.residency_counters()
        if load_s["host"][1] != 2 or load_s["disk"][1] != 2:
            raise AssertionError(f"{tag} ladder loads: {load_s}")
        metrics = _get(url + "/metrics")
        for family in ('tpu:adapter_load_seconds_total{tier="host"}',
                       'tpu:adapter_loads_total{tier="host"} 2',
                       'tpu:adapter_tier_transitions_total{from="slot",'
                       'to="host"} 2'):
            if family not in metrics:
                raise AssertionError(f"{tag}: /metrics lacks {family}")
        usage = json.loads(_get(url + "/debug/usage"))
        if usage["residency"] != {"slot": [ADAPTER], "host": []}:
            raise AssertionError(f"{tag} /debug/usage: {usage['residency']}")
        out["ladder"] = {
            "busy_demote": busy["error"]["message"],
            "host_promotion_ms": 1e3 * load_s["host"][0] / load_s["host"][1],
            # the first disk load is this server's start-up load
            "disk_load_ms": 1e3 * load_s["disk"][0] / load_s["disk"][1],
            # each admin call's wall, HTTP round trip and device sync
            "call_ms": call_ms,
            "transitions": {f"{a}->{b}": n
                            for (a, b), n in sorted(transitions.items())}}

        window()
        profile = json.loads(_get(url + "/debug/profile"))
        shares = profile["attribution"]["shares"]
        if abs(sum(shares.values()) - 1.0) > 1e-6:
            raise AssertionError(f"{tag} profile: {profile['attribution']}")
        out["profile_shares"] = {"pipelined": shares,
                                 "sync (serve phase)": sync_shares}

        # -- drain: the flight recorder and tpu:events_total --
        if not engine.drain(timeout_s=60):
            raise AssertionError(f"{tag}: drain timed out")
        events = json.loads(_get(url + "/debug/events?kind=role_change"))
        if [e["attrs"] for e in events["events"]] != [
                {"role": "collocated", "draining": True}] or \
                'tpu:events_total{kind="role_change"} 1' not in _get(
                    url + "/metrics"):
            raise AssertionError(f"{tag} drain events: {events}")
        out["launches"] = total
        out["graph_shapes"] = getattr(engine._graphs, "shapes", None)
        out["wall_s"] = time.time() - t_phase
        log(tag, "llama3-8b lane server, --prefill-batch 4 "
            "--pipeline-decode: " + json.dumps(out))
        return out
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


# ---------------------------------------------------------------------------
# Phase 13: the other model families
# ---------------------------------------------------------------------------

# Each family's head layout at the reference phase's narrow width (d 512,
# 2 layers, d_ff 1024, f32): (preset, query heads, KV heads, head_dim).
CKPT_SHARD_BYTES = 5 * 10**9  # Meta ships Llama-3-8B as four such shards


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _check_same_tree(tag: str, got, want, prefix=()) -> None:
    """Every leaf of ``got`` equals ``want``'s bit for bit (on the card)."""
    import torch

    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{tag}: keys {sorted(got)} at {prefix}, "
                                 f"want {sorted(want)}")
        for k in want:
            _check_same_tree(tag, got[k], want[k], prefix + (k,))
        return
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{tag}: leaf {prefix} differs from the tree "
                             "that was written")


def phase_checkpoint(torch, params, adapter_path: str, serve_stats: dict,
                     spec_lanes: dict) -> dict:
    """14. checkpoint — trained-weight loading at Llama-3-8B width and
    depth, from the serve phase's bf16 ``params``:

    (1) write them with ``save_hf_checkpoint`` as four <= 5 GB shards and
    an index into a temporary directory (refused, saying what is free,
    when the disk cannot hold them);
    (2) ``--checkpoint DIR`` with no ``params=``: the loaded tree equals
    the written one leaf for leaf on the card, the cfg is LLAMA3_8B's
    architecture, and the serve phase's window (its adapter loaded from
    the .npz) gives the serve phase's answers token for token;
    (3) ``--speculative 4 --draft-model llama3-8b --checkpoint DIR
    --draft-checkpoint DIR``: the perfect draft from disk, phase 11's
    lane wave, whose answers and per-row tokens per cycle equal phase
    11's in-memory perfect draft's; exact launches as phase 11 counts
    them.
    Prints the write's and each load's GB, seconds and GB/s and the
    load's peak device memory; frees all it loaded and removes the
    directory."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B as cfg
    from llm_instance_gateway_tpu_torch.models.convert import (
        save_hf_checkpoint,
    )
    from llm_instance_gateway_tpu_torch.server import api_http

    t_phase = time.time()
    out: dict = {"launches": {}}
    root = tempfile.mkdtemp(prefix="smoke-checkpoint-")
    load = api_http.load_serving_checkpoint
    loads: list = []

    def timed_load(*args, **kwargs):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got_cfg, tree = load(*args, **kwargs)
        torch.cuda.synchronize()
        secs = time.time() - t0
        gb = _tree_bytes(tree) / 1e9
        loads.append({"s": secs, "gb": gb, "gb_per_s": gb / secs,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_above_start_gb": (torch.cuda.max_memory_allocated()
                                              - mem0) / 1e9})
        log("checkpoint", "load " + json.dumps(loads[-1]))
        return got_cfg, tree

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    api_http.load_serving_checkpoint = timed_load
    try:
        # -- (1) write --
        need = _tree_bytes(params) + 10**9
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(
                f"checkpoint: {free / 1e9:.1f} GB free in {root}, the 8B "
                f"checkpoint needs {need / 1e9:.1f} GB")
        path = os.path.join(root, "llama3-8b-hf")
        torch.cuda.synchronize()
        t0 = time.time()
        nbytes = save_hf_checkpoint(cfg, params, path,
                                    shard_bytes=CKPT_SHARD_BYTES)
        write_s = time.time() - t0
        os.sync()
        synced_s = time.time() - t0
        shards = sorted(f for f in os.listdir(path)
                        if f.endswith(".safetensors"))
        if len(shards) != 4 or "model.safetensors.index.json" not in \
                os.listdir(path):
            raise AssertionError(f"checkpoint: files {os.listdir(path)}")
        out["write"] = {
            "gb": nbytes / 1e9, "s": write_s, "gb_per_s": nbytes / 1e9 / write_s,
            "s_with_sync": synced_s,
            "gb_per_s_with_sync": nbytes / 1e9 / synced_s,
            "shards_gb": [os.path.getsize(os.path.join(path, f)) / 1e9
                          for f in shards], "free_gb": free / 1e9}
        log("checkpoint", "write " + json.dumps(out["write"]))

        # -- (2) the lane serve from disk --
        def check_loaded(engine, url, stats):
            _check_same_tree("ckpt-serve", engine.params, params)
            # config.json states head_dim, which the preset leaves at 0.
            served = dataclasses.replace(engine.model_cfg, name=cfg.name)
            if served != dataclasses.replace(
                    cfg, head_dim=cfg.resolved_head_dim):
                raise AssertionError(f"ckpt-serve: cfg {engine.model_cfg}")

        stats, _, _ = phase_serve(torch, None, adapter_path,
                                  flags=["--checkpoint", path],
                                  tag="ckpt-serve", after=check_loaded,
                                  profile=False)
        add(stats["launches"])
        if stats["answers"] != serve_stats["answers"]:
            raise AssertionError("ckpt-serve: answers differ from the "
                                 "serve phase's: " + json.dumps([
                                     _first_difference(v, serve_stats[
                                         "answers"].get(k, []))
                                     for k, v in stats["answers"].items()]))
        out["serve"] = {k: stats[k] for k in (
            "init_s", "serve_s", "decode_steps", "decode_tokens_per_s",
            "ttft_ms_p50", "peak_mem_gb")}
        out["serve"]["load"] = loads[-1]
        del stats
        gc.collect()
        torch.cuda.empty_cache()

        # -- (3) the perfect draft from disk --
        def spec_from_disk() -> dict:
            """(3), in a function of its own: the spec server's engine and
            trees are unreferenced when it returns."""
            tag = "ckpt-spec"
            bodies = [_serve_body(c, m, st, 32) for c, m, st in SERVE_JOBS]
            httpd, eng, url = _start_server(
                SPEC_FLAGS + ["--checkpoint", path,
                              "--draft-checkpoint", path],
                None, adapter_path)
            try:
                _check_same_tree(tag, eng.params, params)
                _check_same_tree(tag, eng.draft_params, params)
                reqs: list = []
                _record(eng, "submit", reqs)
                programs = _count_spec_programs(eng)
                per_row = {"base": [0, 0], "adapter": [0, 0]}
                _spec_row_tokens(eng, per_row)
                snap0 = eng.metrics_snapshot()
                reset_launches()
                _wave(url, bodies)
                launches = read_launches()
                snap1 = eng.metrics_snapshot()
                _check_admits(tag, programs, len(bodies))
                stats = _spec_checks(tag, eng, launches, programs, snap0,
                                     snap1, url, paged=False)
                add(launches)
                _kv_floor(tag, eng)
                answers = {(tuple(r.prompt_tokens), r.adapter):
                           list(r.output_tokens) for r in reqs}
                if answers != spec_lanes["answers"]:
                    raise AssertionError(f"{tag}: answers differ from phase "
                                         "11's: " + json.dumps([
                                             _first_difference(v, spec_lanes[
                                                 "answers"].get(k, []))
                                             for k, v in answers.items()]))
                per_cycle = {k: (v[0] / v[1] if v[1] else None)
                             for k, v in per_row.items()}
                if per_cycle != spec_lanes["tokens_per_cycle"]:
                    raise AssertionError(
                        f"{tag}: tokens per cycle {per_cycle}, phase 11's "
                        f"{spec_lanes['tokens_per_cycle']}")
                result = {
                    "tokens_per_cycle": per_cycle,
                    "metrics": stats["metrics"],
                    "phase11_metrics": spec_lanes["metrics"],
                    "spec_cycles": stats["spec_cycles"],
                    "phase11_spec_cycles": spec_lanes["spec_cycles"],
                    "plain_first_difference": [
                        _first_difference(v, serve_stats["answers"][k])
                        for k, v in answers.items()],
                    "loads": loads[-2:]}
                log(tag, json.dumps(result))
                return result
            finally:
                httpd.shutdown()
                httpd.server_close()
                eng.stop()

        out["spec"] = spec_from_disk()
    finally:
        api_http.load_serving_checkpoint = load
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t_phase
    log("checkpoint", "phase wall " + json.dumps(
        {"wall_s": out["wall_s"],
         "allocated_gb_after": torch.cuda.memory_allocated() / 1e9}))
    return out


FAMILY_LAYOUTS = {
    "qwen (28:4, hd 128, q/k/v biases)": ("qwen2.5-7b", 28, 4, 128),
    "gemma-2b (8:1, hd 256, tied)": ("gemma-2b", 8, 1, 256),
    "gemma-7b (16:16, hd 256)": ("gemma-7b", 16, 16, 256),
    "mixtral (32:8, hd 128, 8 experts, top-2)": ("mixtral-8x7b", 32, 8, 128),
}
# The full-width servers: (--model, extra flags).
FAMILY_SERVERS = [
    ("qwen2.5-7b", []),
    ("gemma-2b", []),
    ("gemma-7b", []),
    ("mixtral-8x7b", INT8_FLAGS + ["--decode-slots", "16",
                                   "--pipeline-decode"]),
]


def _seed_biases(torch, params, seed: int, scale: float) -> None:
    """Non-zero seeded q/k/v biases in place (zero ones would test
    nothing)."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)
    for name in ("wq_b", "wk_b", "wv_b"):
        leaf = params["layers"][name]
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=leaf.device)
                   * scale)


def _lane_reference(torch, phase: str, tag: str, cfg, params_by_dev,
                    kv_quant=None, decode_slots: int = 8,
                    pipelined: bool = False, prompts=None,
                    mesh_axes=None) -> list:
    """A lane engine on the CPU (sync) and on the card (sync, or
    ``pipelined`` with graph replays; over the mesh of ``mesh_axes`` on
    cuda:0, every shard a view): identical greedy streams, top-5
    logprobs within LP_TOL, the lane kernel (int8 with ``kv_quant``)
    launched on the card only; logged under ``phase``.  Returns the CPU's
    requests."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    from llm_instance_gateway_tpu_torch.parallel import mesh
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig)

    prompts = prompts or [[256] + list(range(65, 65 + n)) for n in (5, 40, 100)]
    counter = "quant_launches" if kv_quant else "launches"
    base = dict(decode_slots=decode_slots, max_seq_len=256,
                prefill_buckets=(16, 64, 128), adaptive_steps=8,
                kv_cache_quant=kv_quant)
    by_dev, launches, engines = {}, {}, {}
    for dev, params in zip(("cpu", "cuda"), params_by_dev):
        dec.launches = dec.quant_launches = 0
        grid = None
        if mesh_axes and dev == "cuda":
            m = mesh.MeshConfig(**mesh_axes)
            grid = mesh.make_mesh(m, ["cuda:0"] * m.total)
        eng = Engine(cfg, params, EngineConfig(
            pipeline_decode=pipelined and dev == "cuda", **base),
            eos_id=257, dtype=torch.float32, device=dev, mesh=grid)
        by_dev[dev] = _run_engine(eng, prompts)
        launches[dev] = getattr(dec, counter)
        engines[dev] = eng
    want, got = _streams(by_dev["cpu"]), _streams(by_dev["cuda"])
    if want != got:
        raise AssertionError(f"{tag}: greedy streams differ: cuda {got} "
                             f"cpu {want}")
    err = _check_logprobs(tag, by_dev["cpu"], by_dev["cuda"])
    if launches["cpu"] != 0 or launches["cuda"] <= 0:
        raise AssertionError(f"{tag}: lane decode launches {launches}")
    replays = engines["cuda"]._graphs.replays
    if pipelined and replays <= 0:
        raise AssertionError(f"{tag}: no graph replays")
    log(phase, f"{tag}: greedy streams identical on cuda and cpu "
        f"({sum(map(len, got))} tokens), logprob err {err:.3g}, "
        f"{launches['cuda']} lane kernel launches, {replays} graph replays")
    return by_dev["cpu"]


def _moe_replay_reference(torch, tag: str, cfg, cpu_params, gpu_params,
                          mesh_axes=None, phase: str = "families"):
    """A 16-slot pipelined lane engine on the card — its decode block, a
    replayed graph, runs the grouped dispatch (t=16, cap 8) with the exact
    fallback selected on the device — against the CPU's sync engine; then
    again with a zero router, so every token's logits tie and every token
    picks experts 0 and 1 (the lower indices): each replayed block
    overflows, must give the dense result and the CPU's tokens, and a
    drop-mode CPU engine (overflow dropped) must answer otherwise.  With
    ``mesh_axes`` the card's engine serves over that mesh on cuda:0 (the
    expert shards' grouped tiles, the flag from every expert's counts)."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig)

    prompts = [[256] + list(range(65 + i, 65 + i + n))
               for i, n in enumerate((5, 9, 12, 40, 50, 100))]
    real = transformer._moe_grouped
    for router in ("seeded", "zero"):
        cpu_p, gpu_p = cpu_params, gpu_params
        if router == "zero":
            cpu_p = dict(cpu_p, layers=dict(
                cpu_p["layers"],
                router=torch.zeros_like(cpu_p["layers"]["router"])))
            gpu_p = dict(gpu_p, layers=dict(
                gpu_p["layers"],
                router=torch.zeros_like(gpu_p["layers"]["router"])))
        calls = []

        def counted(cfg_, lp, x, host_flag=False):
            if x.is_cuda:
                calls.append((math.prod(x.shape[:-1]), host_flag))
            return real(cfg_, lp, x, host_flag)

        transformer._moe_grouped = counted
        try:
            want = _lane_reference(
                torch, phase, f"{tag}, 16-slot pipelined, {router} "
                "router", cfg,
                (cpu_p, gpu_p), decode_slots=16, pipelined=True,
                prompts=prompts, mesh_axes=mesh_axes)
        finally:
            transformer._moe_grouped = real
        if (16, False) not in calls:
            raise AssertionError(f"{tag}: the replayed block did not run "
                                 f"the grouped dispatch: {calls[:8]}")
        if router == "zero":
            drop_cfg = dataclasses.replace(cfg, moe_exact_fallback=False)
            drop = _run_engine(Engine(drop_cfg, cpu_p, EngineConfig(
                decode_slots=16, max_seq_len=256,
                prefill_buckets=(16, 64, 128), adaptive_steps=8),
                eos_id=257, dtype=torch.float32, device="cpu"), prompts)
            lp_gap = max(abs(a - b) for w, d in zip(want, drop)
                         for a, b in zip(w.output_logprobs,
                                         d.output_logprobs))
            if _streams(drop) == _streams(want) and lp_gap <= LP_TOL:
                raise AssertionError(f"{tag}: drop mode answers as the "
                                     "exact fallback: no overflow seen")
            log(phase, f"{tag}, zero router: every replayed block "
                f"overflowed to the dense result (the CPU's tokens); drop "
                f"mode departs by {lp_gap:.3g} in logprob")


def _family_reference(torch) -> None:
    """Each family's head layout, narrow and f32, card path against CPU
    path: prefill logits within REF_TOL, greedy streams and top-5 logprobs
    on a lane engine and on a paged engine with prefix cache and stream
    lanes (then pipelined); Mixtral also with int8 weights and through
    ``_moe_replay_reference``."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_params

    for tag, (preset, h, k, hd) in FAMILY_LAYOUTS.items():
        cfg = dataclasses.replace(
            CONFIGS[preset], name=f"{preset}-narrow", d_model=512,
            n_layers=2, n_heads=h, n_kv_heads=k, head_dim=hd, d_ff=1024,
            vocab_size=320)
        cpu_params = transformer.init_params(cfg, seed=7, dtype=torch.float32,
                                             device="cpu")
        if cfg.attention_bias:
            _seed_biases(torch, cpu_params, 8, 0.5)
        gpu_params = _to_card(cpu_params)
        trees = [("f32", cpu_params, gpu_params)]
        if cfg.n_experts:
            cpu_q = quantize_params(cpu_params)
            trees.append(("int8 weights", cpu_q, _to_card(cpu_q)))
        for name, cpu_p, gpu_p in trees:
            err = _prefill_err(torch, f"{tag} ({name})", cfg, cpu_p, gpu_p)
            log("families", f"{tag} ({name}): prefill logits max_abs_err "
                f"{err:.3g} <= {REF_TOL}")
            _lane_reference(torch, "families", f"{tag}, lane, {name}", cfg,
                            (cpu_p, gpu_p))
        _paged_reference(torch, cfg, cpu_params, gpu_params, None,
                         tag=f"{tag}: ")
        if cfg.n_experts:
            _moe_replay_reference(torch, tag, cfg, cpu_params, gpu_params)


def _moe_extras(torch, tag: str, cfg):
    """``phase_serve``'s ``after`` for an MoE server: an adapter on
    gate/up/down only beside a base row and the full adapter on one prompt
    (the same tokens as base: LoRA skips the expert weights), KV back at
    its floor; then the replayed decode step profiled in drop mode, the
    exact fallback's cost inside a graph."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.server.engine import Request

    def after(engine, url, stats):
        path = os.path.join(REPO, "build", "smoke", f"{cfg.name}-mlp.npz")
        _save_adapter(cfg, path, ("gate", "up", "down"), 12)
        status, text = _post(url + "/v1/load_lora_adapter",
                             {"lora_name": "smoke-mlp", "lora_path": path})
        if status != 200:
            raise AssertionError(f"{tag}: adapter load: {status} {text}")
        prompt = [256] + [65 + i % 26 for i in range(40)]
        trio = [Request(prompt_tokens=list(prompt), max_new_tokens=16,
                        adapter=a) for a in (None, "smoke-mlp", "smoke-r8")]
        with engine._work:  # admitted in one pass: rows of one batch
            for r in trio:
                engine.submit(r)
        for r in trio:
            if not r.done.wait(300) or r.error:
                raise AssertionError(f"{tag}: adapter trio: {r.error}")
        base, mlp, full = (list(r.output_tokens) for r in trio)
        if mlp != base:
            raise AssertionError(f"{tag}: a gate/up/down adapter changed "
                                 f"the tokens: {mlp} vs {base}")
        stats["mlp_adapter_equals_base"] = True
        stats["attention_adapter_changes_tokens"] = full != base
        _kv_floor(tag, engine)
        drop = phase_profile(torch, engine, prefill=False,
                             cfg=dataclasses.replace(
                                 cfg, moe_exact_fallback=False))
        exact_ms = stats["profile"]["decode_step"]["graph_replay"][
            "device_ms"]
        drop_ms = drop["decode_step"]["graph_replay"]["device_ms"]
        stats["exact_fallback_ms_per_step"] = exact_ms - drop_ms
        log(tag, f"replayed decode step: exact {exact_ms:.2f} device ms, "
            f"drop mode {drop_ms:.2f}: the exact fallback costs "
            f"{exact_ms - drop_ms:.2f} ms a step")
        if cfg.name == "mixtral-8x7b":
            # Phase 17's expert half, over this server's tree.
            stats["expert"] = phase_expert(torch, engine, stats)

    return after


def _family_kernel_rows(torch) -> dict:
    """Flash and the lane kernel (int8 under ``--kv-quantize int8``), in
    bf16, at each full-width server's layout and shapes, against their
    plain versions (``_kernel_rows_at``).  Rows of the kernels line
    (errors only)."""
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS

    layouts = []
    for model, flags in FAMILY_SERVERS:
        cfg = CONFIGS[model]
        slots = (int(flags[flags.index("--decode-slots") + 1])
                 if "--decode-slots" in flags else 8)
        layouts.append((model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, slots,
                        "--kv-quantize" in flags))
    return _kernel_rows_at(torch, layouts, "families", 4321)


def _kernel_rows_at(torch, layouts, tag: str, seed: int) -> dict:
    """Flash and the lane kernel in bf16 at each ``(label, H, K, hd,
    slots, int8 KV)`` layout against their plain versions
    (``check_kernel``'s limits): flash at B=1 over the buckets 16 and
    1024, lane decode over ``slots`` rows with ragged lengths in
    1024-token lanes.  Rows of the kernels line (errors only)."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    from llm_instance_gateway_tpu_torch.ops import flash_attention as fl

    dev, bf16, s_max = torch.device("cuda"), torch.bfloat16, 1024
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = [0, 1, 777, 1024, 5, 300, 512, 1000,
            2, 64, 1023, 256, 900, 33, 700, 129]
    rows: dict = {}
    for label, h, k, hd, slots, quant in layouts:
        layout = f"{label}: H={h} K={k} hd={hd} bf16"
        for s in (16, 1024):
            q, kk, v = (torch.randn(1, s, n, hd, device=dev,
                                    generator=gen).to(bf16)
                        for n in (h, k, k))
            row = dict(shape=f"{layout}, B=1 S={s}", **check_kernel(
                f"flash {layout} S={s}", fl.flash_attention(q, kk, v),
                fl.flash_attention_reference(q, kk, v)))
            rows.setdefault("flash_prefill", []).append(row)
            log(tag, "flash_prefill " + json.dumps(row))
        lengths = torch.tensor(lens[:slots], dtype=torch.int32, device=dev)
        q = torch.randn(slots, h, hd, device=dev, generator=gen).to(bf16)
        shape = (slots, s_max, k, hd)
        if quant:
            name = "decode_attention_quant"
            kq, ks = _int8_kv(torch, gen, shape)
            vq, vs = _int8_kv(torch, gen, shape)
            got = dec.decode_attention(q, kq, vq, lengths, ks, vs)
            want = dec.decode_attention_quant_reference(q, kq, vq, ks, vs,
                                                        lengths)
        else:
            name = "decode_attention"
            kc, vc = (torch.randn(*shape, device=dev, generator=gen).to(bf16)
                      for _ in range(2))
            got = dec.decode_attention(q, kc, vc, lengths)
            want = dec.decode_attention_reference(q, kc, vc, lengths)
        row = dict(shape=f"{layout}, B={slots} S_max={s_max} lengths="
                   f"{lens[:slots]}" + (", k/v int8" if "quant" in name
                                        else ""),
                   **check_kernel(f"{name} {layout}", got, want))
        if got[0].abs().max().item() != 0.0:
            raise AssertionError(f"{name} {layout}: a length-0 row must "
                                 "give zeros")
        rows.setdefault(name, []).append(row)
        log(tag, f"{name} " + json.dumps(row))
    return rows


def phase_families(torch, then=None) -> dict:
    """Phase 13: every family's head layout card against CPU; flash and
    the lane kernels in bf16 at each full-width server's layout against
    their plain versions; then the Qwen2.5-7B (seeded q/k/v biases),
    Gemma-2B, Gemma-7B and Mixtral-8x7B (int8 weights and KV, 16 slots,
    pipelined) servers through ``phase_serve``, at full width and depth,
    one at a time, each freed before the next is built.  ``then[model]
    (params, stats, adapter_path)`` runs after that model's server, on
    its tree (phase 21 on Qwen's); its result is ``out["then"][model]``.
    Returns the servers' launches summed, their stats and the kernel
    rows."""
    import gc

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS

    t0 = time.time()
    _family_reference(torch)
    ref_s = time.time() - t0
    kernel_rows = _family_kernel_rows(torch)
    servers, launches, after = {}, {}, {}
    for model, flags in FAMILY_SERVERS:
        gc.collect()
        torch.cuda.empty_cache()
        log("families", f"before {model}: {torch.cuda.memory_allocated() / 1e9:.2f} "
            f"GB allocated")
        cfg = CONFIGS[model]
        tag = f"families {model}"
        params = None
        if cfg.attention_bias:
            params = transformer.init_params(cfg, seed=0,
                                             dtype=torch.bfloat16,
                                             device="cuda")
            _seed_biases(torch, params, 13, 0.5)
        servers[model], served, adapter_path = phase_serve(
            torch, params, model=model, flags=flags, tag=tag,
            after=_moe_extras(torch, tag, cfg) if cfg.n_experts else None)
        if model in (then or {}):
            after[model] = then[model](served, servers[model], adapter_path)
        del params, served
        servers[model].pop("answers")
        for name, n in servers[model]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out = {"reference_s": ref_s, "wall_s": time.time() - t0,
           "launches": launches, "servers": servers,
           "kernel_rows": kernel_rows, "then": after}
    log("families", "phase wall " + json.dumps(
        {"reference_s": ref_s, "wall_s": out["wall_s"]}))
    return out


# -- phase 15: training ------------------------------------------------------

# Card-vs-CPU tolerances of the small f32 model's training (TF32 off, so
# summation order only: its gradients agree to ~3e-6 of each leaf's
# largest |value|): the loss, each gradient leaf over its largest |value|,
# and AdamW's update over lr where the CPU's |grad| cleared 1e-3 of its
# leaf's largest at every step (Adam turns a gradient at rounding noise
# into a step of about +-lr whatever its size; there only the bound
# |update| <= 2 lr holds).
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_UPDATE_TOL = 1e-3
TRAIN_NOISE_FLOOR = 1e-3
TRAIN_LR = 1e-3
# The 8B LoRA run: one fixed batch of two seeded 1024-token rows, slot 0 at
# rank 8 (a seeded, b zero), AdamW at this lr.
TRAIN_STEPS = 10
TRAIN_8B_LR = 1e-3


def check_grad(name: str, got, want) -> dict:
    """``check_kernel``'s scaled rule for a gradient: each vector's error
    over the larger of its own largest |value| and 1/16 of the tensor's
    (or of 1, the inputs' scale) — a vector that cancels to ~0 in exact
    arithmetic (dq of query 0, whose one probability is 1; all of dq at
    S = 1) comes out at rounding size on both sides — within SCALED_TOL,
    and the flat ABS_TOL scaled by the tensor's largest |value| (gradients
    are not bounded by max |v| as attention outputs are)."""
    g, w = got.float(), want.float()
    num = (g - w).abs().amax(-1)
    top = max(w.abs().max().item(), 1.0)
    scaled = (num / w.abs().amax(-1).clamp_min(top / 16)).max().item()
    err = num.max().item()
    if not (math.isfinite(err) and math.isfinite(scaled)) \
            or scaled > SCALED_TOL or err > ABS_TOL * top:
        raise GradCheckError(f"{name}: scaled error {scaled} (limit "
                             f"{SCALED_TOL}), max_abs_err {err} (limit "
                             f"{ABS_TOL * top})", scaled)
    return dict(max_abs_err=err, scaled_err=scaled)


class GradCheckError(AssertionError):
    def __init__(self, msg: str, scaled: float):
        super().__init__(msg)
        self.scaled = scaled


def _grad_check_reach(want, s: int) -> dict:
    """``check_grad``'s reach: the plain gradients with one tile of 64
    zeroed (a pass that skipped it) must fail; returns each one's scaled
    error."""
    out = {}
    for name, i, sl in (("dq, query tile 5", 0, slice(320, 384)),
                        ("dk, the ragged last key tile", 1,
                         slice((s - 1) // 64 * 64, None)),
                        ("dv, key tile 1", 2, slice(64, 128))):
        bad = want[i].clone()
        bad[:, sl] = 0
        try:
            check_grad(name, bad, want[i])
        except GradCheckError as e:
            out[name] = e.scaled
        else:
            raise AssertionError(f"check_grad passes a skipped tile: {name}")
    return out


def _bwd_row(torch, gen, b: int, s: int, h: int, k: int, hd: int,
             dtype) -> dict:
    """The backward kernel against its plain version on one shape (long
    rows: with the check's reach, ``_grad_check_reach``), two runs bitwise
    equal, and its ms beside the plain version's, the bound and, as a
    yardstick only, the backward of one causal GQA SDPA call.  bf16 runs as
    training does: the training forward's lse handed to the backward
    (whose launches, delta, dK/dV, the split's reduction and dQ, are
    timed; the no-lse call must give the same bits), its route and group
    split recorded, and at S >= 512 every split the group allows timed
    beside the plan's (``split_sweep_ms``) and the training forward beside
    the serving one."""
    import torch.nn.functional as F

    from llm_instance_gateway_tpu_torch.ops import flash_attention as fl

    def draw(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, kk, v, dout = draw(b, s, h, hd), draw(b, s, k, hd), draw(b, s, k, hd), \
        draw(b, s, h, hd)
    bf16 = dtype == torch.bfloat16
    with torch.no_grad():
        out, lse = (fl.flash_forward_lse(q, kk, v) if bf16 else
                    (fl.flash_attention(q, kk, v), None))
    args = (q, kk, v, out, dout)
    got = fl.flash_attention_backward(*args, lse=lse)
    want = fl.flash_attention_backward_reference(*args)
    torch.cuda.synchronize()
    shape = (f"B={b} S={s} H={h} K={k} hd={hd} "
             f"{str(dtype).replace('torch.', '')}")
    errs = [check_grad(f"flash_backward {shape} d{n}", g, w)
            for n, g, w in zip("qkv", got, want)]
    splits = (fl.split_plan(b, s, h, k, hd, fl._sm_count(q.device))
              if bf16 else 1)
    row = dict(shape=shape, route="wgmma (TMA ring)" if bf16 else
               "CUDA-core FMA", splits=splits,
               max_abs_err=max(e["max_abs_err"] for e in errs),
               scaled_err=max(e["scaled_err"] for e in errs))
    if s >= 512:
        row["check_reach_scaled_err"] = _grad_check_reach(want, s)
    again = fl.flash_attention_backward(*args, lse=lse)
    row["bitwise_reproducible"] = all(torch.equal(x, y)
                                      for x, y in zip(got, again))
    if not row["bitwise_reproducible"]:
        raise AssertionError(f"flash_backward {shape}: two runs differ")
    if bf16:
        own = fl.flash_attention_backward(*args)
        if not all(torch.equal(x, y) for x, y in zip(got, own)):
            raise AssertionError(f"flash_backward {shape}: the call without "
                                 "the forward's lse differs")
    elt = q.element_size()
    # q, out, dout, dq and k, v, dk, dv: each read or written once
    nbytes = elt * (4 * q.numel() + 4 * kk.numel())
    ops = 5 * 2 * b * h * s * (s + 1) // 2 * hd
    sets = [tuple(t.clone() for t in args) + (lse,)
            for _ in range(copies_for(nbytes))]

    def bwd(*a, splits=None):
        return fl.flash_attention_backward(*a[:5], lse=a[5], splits=splits)

    ms = time_ms(torch, bwd, sets)
    plain_ms = time_ms(torch, fl.flash_attention_backward_reference,
                       [t[:5] for t in sets[:2]], iters=3, warmup=1)
    if bf16 and s >= 512:
        row["split_sweep_ms"] = {
            str(d): time_ms(torch, lambda *a, d=d: bwd(*a, splits=d), sets)
            for d in range(1, h // k + 1) if (h // k) % d == 0}
        row.update(device_ms(torch, bwd, sets))  # each launch's share
        fwd_sets = [t[:3] for t in sets]
        row["forward_ms"] = time_ms(torch, fl.flash_prefill_kernel, fwd_sets)
        row["forward_lse_ms"] = time_ms(torch, fl.flash_forward_lse,
                                        fwd_sets)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, kk, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), [()])
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **_bound(nbytes, ops))
    row.update(_rate(ops, row))
    return row


def _train_flat(tree, prefix: str = "") -> dict:
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_train_flat(v, f"{prefix}{key}/"))
        elif v.is_floating_point():
            out[f"{prefix}{key}"] = v
    return out


def _train_grads(torch, fn, tree) -> tuple:
    """(loss, path -> gradient on the CPU) of ``fn(tree)``; the leaves'
    ``requires_grad`` is restored after."""
    leaves = _train_flat(tree)
    was = {p: t.requires_grad for p, t in leaves.items()}
    for t in leaves.values():
        t.requires_grad_(True)
    loss = fn(tree)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for p, t in leaves.items():
        t.requires_grad_(was[p])
    return loss.item(), {p: g.cpu() for p, g in zip(leaves, grads)}


def _train_reference(torch) -> dict:
    """Phase 15 (b): a small f32 model with Llama-3-8B's head layout (phase
    4's), card against CPU: the loss and every gradient leaf, then the
    parameters after each of two AdamW steps (each from the CPU's state),
    for the full step and for the LoRA step (slots 1 and 2 beside a base
    row, seeded a and b).  The attention leaves (wq/wk/wv, q/k/v LoRA)
    must be non-zero on the card: a graph cut at attention would leave
    them zero."""
    import copy
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import lora, transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.ops import flash_attention as fl
    from llm_instance_gateway_tpu_torch.training import train

    cfg = dataclasses.replace(LLAMA3_8B, name="llama3-8b-narrow", d_model=512,
                              n_layers=2, n_heads=8, n_kv_heads=2,
                              head_dim=128, d_ff=1024, vocab_size=320)
    cpu_params = transformer.init_params(cfg, seed=7, dtype=torch.float32,
                                         device="cpu")
    gen = torch.Generator().manual_seed(15)
    # S = 129 after the shift: a ragged last tile; row 1 padded after 77.
    tokens = torch.randint(1, cfg.vocab_size, (3, 130), generator=gen)
    positions = torch.arange(130).repeat(3, 1)
    tokens[1, 77:], positions[1, 77:] = 0, 0
    slots = torch.tensor([1, -1, 2])
    bufs_cpu = lora.init_lora_buffers(cfg, torch.float32, "cpu")
    for t in lora.TARGETS:
        for ab in ("a", "b"):
            bufs_cpu[f"{t}_{ab}"][:, 1:3, ...] = torch.randn(
                bufs_cpu[f"{t}_{ab}"][:, 1:3].shape, generator=gen) * 0.05
    bufs_cpu["scale"][1:3] = 2.0
    out = {}
    for kind in ("full", "lora"):
        trees, steps, opts, sure = {}, {}, {}, {}
        for dev in ("cpu", "cuda"):
            params = (_to_card(cpu_params) if dev == "cuda" else
                      {k: ({n: t.clone() for n, t in v.items()}
                           if isinstance(v, dict) else v.clone())
                       for k, v in cpu_params.items()})
            bufs = {k: v.clone().to(dev) for k, v in bufs_cpu.items()}
            tree = params if kind == "full" else bufs
            opts[dev] = train.make_optimizer(tree, lr=TRAIN_LR,
                                             weight_decay=0.01)
            make = (train.make_full_train_step if kind == "full"
                    else train.make_lora_train_step)
            steps[dev] = make(cfg, opts[dev])
            trees[dev] = (params, bufs)
        errs = {"loss": 0.0, "grad": 0.0, "update": 0.0}
        for i in range(2):
            # Each step starts from the CPU's state: Adam turns gradients at
            # rounding noise into +-lr steps, so two runs left alone drift
            # apart there and the next step would measure the drift.
            pick = 0 if kind == "full" else 1
            src = _train_flat(trees["cpu"][pick])
            with torch.no_grad():
                for p, t in _train_flat(trees["cuda"][pick]).items():
                    t.copy_(src[p])
            opts["cuda"].load_state_dict(
                copy.deepcopy(opts["cpu"].state_dict()))
            grads, before = {}, {}
            for dev in ("cpu", "cuda"):
                params, bufs = trees[dev]
                args = (tokens.to(dev), positions.to(dev))
                if kind == "full":
                    fn = (lambda p, a=args: train.causal_lm_loss(cfg, p, *a))
                    tree = params
                else:
                    fn = (lambda b, p=params, a=args, d=dev:
                          train.causal_lm_loss(cfg, p, *a, lora_bufs=b,
                                               slot_ids=slots.to(d)))
                    tree = bufs
                f0, b0 = fl.launches, fl.backward_launches
                grads[dev] = _train_grads(torch, fn, tree)
                if dev == "cuda" and (fl.launches - f0, fl.backward_launches
                                      - b0) != (cfg.n_layers, cfg.n_layers):
                    raise AssertionError(f"train reference ({kind}): "
                                         "attention did not run both kernels")
                before[dev] = {p: t.detach().cpu().clone()
                               for p, t in _train_flat(tree).items()}
            (want_loss, want), (got_loss, got) = grads["cpu"], grads["cuda"]
            errs["loss"] = max(errs["loss"], abs(got_loss - want_loss))
            if errs["loss"] > TRAIN_LOSS_TOL:
                raise AssertionError(f"train reference ({kind}) step {i}: "
                                     f"loss {got_loss} vs {want_loss}")
            for p, w in want.items():
                err = ((got[p] - w).abs().max()
                       / w.abs().max().clamp_min(1e-6)).item()
                errs["grad"] = max(errs["grad"], err)
                if err > TRAIN_GRAD_TOL:
                    raise AssertionError(f"train reference ({kind}) step "
                                         f"{i}: {p} gradient error {err}")
                g = w.abs()
                sure[p] = sure.get(p, True) & (
                    g > TRAIN_NOISE_FLOOR * g.max().clamp_min(1e-30))
            attn = (("layers/wq", "layers/wk", "layers/wv") if kind == "full"
                    else ("q_a", "q_b", "k_a", "k_b", "v_a", "v_b"))
            for p in attn:
                if not got[p].abs().max() > 0:
                    raise AssertionError(f"train reference ({kind}): {p} "
                                         "has no gradient on the card")
            for dev in ("cpu", "cuda"):
                params, bufs = trees[dev]
                args = (tokens.to(dev), positions.to(dev))
                if kind == "full":
                    steps[dev](params, opts[dev].state, *args)
                else:
                    steps[dev](params, bufs, opts[dev].state, *args,
                               slots.to(dev))
            after = {dev: {p: t.detach().cpu() for p, t in _train_flat(
                trees[dev][0] if kind == "full" else trees[dev][1]).items()}
                for dev in ("cpu", "cuda")}
            for p in want:
                du = {dev: (after[dev][p].double() - before[dev][p].double())
                      / TRAIN_LR for dev in ("cpu", "cuda")}
                diff = (du["cuda"] - du["cpu"]).abs()[sure[p]]
                err = diff.max().item() if diff.numel() else 0.0
                errs["update"] = max(errs["update"], err)
                if err > TRAIN_UPDATE_TOL or du["cuda"].abs().max() > 2.0:
                    raise AssertionError(f"train reference ({kind}) step "
                                         f"{i}: {p} update error {err}")
        out[kind] = errs
    log("train", "reference (card against cpu, f32, two AdamW steps, "
        f"limits loss {TRAIN_LOSS_TOL} grad {TRAIN_GRAD_TOL} update/lr "
        f"{TRAIN_UPDATE_TOL}): " + json.dumps(out))
    return out


def phase_train(torch, params) -> dict:
    """Phase 15 (``phase_train``): training on the card.  (a) the flash
    backward kernel against its plain version (``check_grad``) at the
    training shape in bf16 and f32, at Gemma's layouts and at short S;
    (b) ``_train_reference``; (c) LoRA steps on ``params`` (the serve
    phase's Llama-3-8B tree, frozen) with exact launch counts, the loss
    falling, profiled; (d) the trained slot saved as .npz, loaded over
    ``/v1/load_lora_adapter`` on a lane server, whose greedy answers equal
    an in-process engine's holding the trained buffers."""
    import shutil
    import tempfile
    import threading

    from llm_instance_gateway_tpu_torch.models import lora
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.server import api_http
    from llm_instance_gateway_tpu_torch.server.engine import Request
    from llm_instance_gateway_tpu_torch.training import train

    t_phase = time.time()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16 = torch.bfloat16
    rows = [_bwd_row(torch, gen, 2, s, 32, 8, 128, bf16)
            for s in (1, 16, 127, 129)]
    rows += [_bwd_row(torch, gen, 1, 1023, h, k, 256, bf16)
             for h, k in ((8, 1), (16, 16))]  # Gemma-2B, Gemma-7B
    rows.append(_bwd_row(torch, gen, 2, 1023, 32, 8, 128, torch.float32))
    rows.append(_bwd_row(torch, gen, 2, 1023, 32, 8, 128, bf16))
    for row in rows:
        log("train", "flash_backward " + json.dumps(row))
    walls = {"kernels_s": time.time() - t_phase}
    reference = _train_reference(torch)
    walls["reference_s"] = time.time() - t_phase

    # -- (c) LoRA steps at Llama-3-8B's full width and depth --
    cfg = LLAMA3_8B
    rank, alpha = 8, 16.0
    bufs = lora.init_lora_buffers(cfg, bf16, "cuda")
    for t, (d_in, _d_out) in lora.target_dims(cfg).items():
        bufs[f"{t}_a"][:, 0, :, :rank] = (torch.randn(
            (cfg.n_layers, d_in, rank), device="cuda", generator=gen)
            / math.sqrt(d_in)).to(bf16)
    bufs["scale"][0] = alpha / rank
    opt = train.make_optimizer(bufs, lr=TRAIN_8B_LR, weight_decay=0.0)
    step = train.make_lora_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), device="cuda",
                           generator=gen)
    positions = torch.arange(1024, device="cuda").repeat(2, 1)
    slot_ids = torch.zeros(2, dtype=torch.int32, device="cuda")
    b0 = {t: bufs[f"{t}_b"][:, 0].clone() for t in lora.TARGETS}
    a0 = {t: bufs[f"{t}_a"][:, 0].clone() for t in lora.TARGETS}

    def one_step():
        return step(params, bufs, opt.state, tokens, positions, slot_ids)[2]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_launches()
    losses, walls_ms = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(one_step())
        torch.cuda.synchronize()
        walls_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:  # b zero: the first step moves b only
            if not all(torch.equal(bufs[f"{t}_a"][:, 0], a0[t])
                       and not torch.equal(bufs[f"{t}_b"][:, 0], b0[t])
                       for t in lora.TARGETS):
                raise AssertionError("train 8B: the first step must move "
                                     "every b and no a")
    launches = read_launches()
    check_only(launches, {"flash_prefill": TRAIN_STEPS * cfg.n_layers,
                          "flash_backward": TRAIN_STEPS * cfg.n_layers},
               "train 8B")
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train 8B: the loss did not fall: {losses}")
    for t in lora.TARGETS:
        pad = bufs[f"{t}_a"][:, 0, :, rank:], bufs[f"{t}_b"][:, 0, rank:]
        if any(x.any() for x in pad) or bufs[f"{t}_a"][:, 1:].any():
            raise AssertionError(f"train 8B: {t}'s padded rank lanes or "
                                 "unused slots moved")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(torch, "train 8B LoRA step (B=2, S=1024, rank 8)",
                    one_step, reps=2)
    bwd_ms = sum(r["ms"] for r in prof["port_kernels"]
                 if "flash_backward" in r["name"])
    fwd_ms = sum(r["ms"] for r in prof["port_kernels"]
                 if "flash_tile" in r["name"])
    stats = {
        "steps": TRAIN_STEPS, "lr": TRAIN_8B_LR, "losses": losses,
        "step_wall_ms": walls_ms,
        "step_wall_ms_mean_after_first": sum(walls_ms[1:]) / (TRAIN_STEPS - 1),
        "profile_wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
        "device_idle_share": prof["device_idle_share"],
        "flash_backward_device_ms": bwd_ms,
        "flash_backward_share": (bwd_ms / prof["device_ms"]
                                 if isinstance(prof["device_ms"], float)
                                 else "not measured"),
        "flash_forward_device_ms": fwd_ms,
        "peak_mem_gb": peak_gb,
        "peak_mem_gb_above_start": peak_gb - mem0 / 1e9,
        "launches_per_step": {k: v // TRAIN_STEPS for k, v in
                              launches.items() if v},
    }
    log("train", "Llama-3-8B LoRA steps (bf16 tree frozen, slot 0 rank 8, "
        "two 1024-token rows): " + json.dumps(stats))
    walls["steps_s"] = time.time() - t_phase

    # -- (d) the trained adapter served over HTTP --
    root = tempfile.mkdtemp(prefix="smoke-train-")
    path = os.path.join(root, "trained-r8.npz")
    train.save_trained_adapter(path, cfg, bufs, 0, rank, alpha)
    prompts = [SERVE_TEXT[:n] for n in (12, 50, 120, 400)]
    max_tokens = 16
    answers = {}
    try:
        httpd, engine, _ = api_http.make_server(SERVER_ARGV, params=params)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        try:
            status, text = _post(url + "/v1/load_lora_adapter",
                                 {"lora_name": "trained", "lora_path": path})
            if status != 200:
                raise AssertionError(f"train: adapter load {status} {text}")
            served: list = []
            _record(engine, "submit", served)
            for prompt in prompts:
                status, text = _post(url + "/v1/completions", {
                    "prompt": prompt, "model": "trained",
                    "max_tokens": max_tokens, "temperature": 0.0})
                if status != 200:
                    raise AssertionError(f"train: completion {status} "
                                         f"{text[:300]}")
            answers["http"] = [list(r.output_tokens) for r in served]
            prompt_tokens = [list(r.prompt_tokens) for r in served]
        finally:
            httpd.shutdown()
            httpd.server_close()
            engine.stop()
        del engine, httpd
        httpd, engine, _ = api_http.make_server(SERVER_ARGV, params=params)
        httpd.server_close()  # the engine alone, in process
        try:
            info = engine.lora.load("trained", weights=train.extract_adapter(
                cfg, bufs, 0, rank), alpha=alpha, rank=rank)
            held = engine.lora.buffers
            if not all(torch.equal(held[f"{t}_{ab}"][:, info.slot],
                                   bufs[f"{t}_{ab}"][:, 0])
                       for t in lora.TARGETS for ab in ("a", "b")):
                raise AssertionError("train: the engine's slot is not the "
                                     "trained buffers")
            for key, adapter in (("engine", "trained"), ("base", None)):
                reqs = []
                for toks in prompt_tokens:  # one at a time, as over HTTP
                    req = engine.submit(Request(prompt_tokens=toks,
                                                max_new_tokens=max_tokens,
                                                adapter=adapter))
                    if not req.done.wait(300) or req.error:
                        raise AssertionError(f"train: {key} request "
                                             f"failed: {req.error}")
                    reqs.append(list(req.output_tokens))
                answers[key] = reqs
        finally:
            engine.stop()
        del engine, httpd
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if answers["http"] != answers["engine"]:
        raise AssertionError("train: the served adapter's answers differ "
                             f"from the in-process engine's: {answers}")
    if answers["engine"] == answers["base"]:
        raise AssertionError("train: the trained adapter answers as the "
                             "base model does")
    stats["served_answers_equal_engine"] = True
    stats["answers_differing_from_base"] = sum(
        a != b for a, b in zip(answers["engine"], answers["base"]))
    walls["phase_s"] = time.time() - t_phase
    stats["walls"] = walls
    log("train", "trained adapter over /v1/load_lora_adapter: greedy "
        f"answers equal the in-process engine's on {len(prompts)} prompts, "
        f"{stats['answers_differing_from_base']} differ from the base "
        f"model's; phase walls {json.dumps(walls)}")
    del bufs, opt, step
    return {"kernel_rows": {"flash_backward": rows}, "launches": launches,
            "reference": reference, "stats": stats}


def kernels_line(kernel_rows: dict, by_path: dict) -> dict:
    """One entry per kernel: numbers at its largest main-path shape, the
    errors over all shapes checked, and launches summed over the serving
    paths (``launches_by_path`` splits them: lane, paged, int8 lane, int8
    paged, dispatch, disagg, int8 disagg, spec, surface, checkpoint,
    families, train, mesh, sequence, expert, data, fsdp, pipe,
    processes, pipe_processes, layouts, layouts_train)."""
    out = []
    for name, rows in kernel_rows.items():
        main = rows[-1]
        source, replaces = KERNEL_SOURCES[name]
        counts = {path: launches.get(name, 0)
                  for path, launches in by_path.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "scaled_err": max(r["scaled_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            **{k: main[k] for k in ("tflops", "bound_frac", "device_ms",
                                    "split_len", "n_split") if k in main},
            "shapes": rows,
        })
    return {"kernels": out}


def graph_columns(stats: dict) -> None:
    """Every profiled step's eager and graph-replay columns, side by side:
    host wall, device time and device idle share (same run)."""
    keys = ("wall_ms", "device_ms", "device_idle_share")
    for path, st in stats.items():
        for step, prof in st["profile"].items():
            graph = prof.get("graph_replay")
            log("profile", f"{path} {step}, eager vs graph replay: "
                + json.dumps({
                    "eager": {k: prof[k] for k in keys},
                    "graph": ({k: graph[k] for k in keys}
                              if isinstance(graph, dict) else graph)}))


def compare_profiles(bf16: dict, int8: dict) -> None:
    """The int8 serves' profiles beside the bf16 ones of the same run:
    device ms, idle share and top kernels per step."""
    pairs = (("lane decode step (int8 weights + int8 KV vs bf16)", "lane",
              "decode_step"),
             ("paged decode step over 8 long rows (int8 vs bf16)", "paged",
              "paged_decode_step"),
             ("1024-token chunk at 5120 (int8 pool vs bf16)", "paged",
              "chunk_1024_at_5120"))
    for what, path, key in pairs:
        b, q = bf16[path]["profile"][key], int8[path]["profile"][key]
        log("profile", f"{what}: " + json.dumps({
            "bf16": {k: b[k] for k in ("wall_ms", "device_ms",
                                       "device_idle_share")},
            "int8": {k: q[k] for k in ("wall_ms", "device_ms",
                                       "device_idle_share")},
            "int8_top_kernels": q["top_kernels"][:5]}))


# -- phase 16: tensor parallelism on one card --------------------------------

# The mesh phase's two shards share cuda:0 (the smoke needs one card; the
# cross-card reduction, single-process NCCL, is not run here).
MESH_DEVICES = ["cuda:0", "cuda:0"]
MESH_FLAGS = ["--mesh", "tensor=2"]
# bf16 logits at tensor=2 against tensor=1 on the same weights and input:
# the largest |difference| within this share of the largest |logit|.  The
# shards' row-parallel partials are summed in bf16 (one rounding more per
# reduction than the unsharded product's single rounding of an f32
# accumulation: 64 reductions a step over 32 layers), so the two
# forwards part at bf16's 8 bits and the difference compounds with depth.
# Measured (H100 80GB HBM3, 700 W): 2.1% at the first decode step, 2.2%
# at the prefill's last position.  The check's reach is measured in every
# run (``MESH_FAULTS``): a split gone wrong in one layer of 32 must fail
# it; the weaker planted fault measured 18.7%, and the limit sits between
# the two, about 3x from each.
MESH_LOGIT_TOL = 1.0 / 16
# Faults planted in the sharded 8B tree, in its middle layer, each of
# which the logits check must fail: shard 1's ``wo`` rows zeroed (its
# heads' output dropped), and the two shards' ``wo`` rows swapped (each
# shard's heads projected through the other's rows: misordered heads).
MESH_FAULTS = ("wo_zeroed", "wo_swapped")
# The narrow f32 model served at tensor=1 and tensor=2 on the card: at f32
# the reduction order parts the forwards by ~1e-6, so greedy tokens must
# be identical.
# Timed calls per point of the calibration fits (``calibrate``'s
# default is 10; 4 keep the phase short for the smoke's time limit).
MESH_CALIB_REPEATS = 4
MESH_NARROW = dict(name="llama3-8b-narrow", d_model=512, n_layers=4,
                   n_heads=8, n_kv_heads=2, head_dim=128, d_ff=1024,
                   vocab_size=320, max_lora_slots=2, max_lora_rank=8)


def _mesh_kernel_rows(torch) -> dict:
    """Flash and the lane kernel at the mesh phase's local layouts: one
    shard of Llama-3-8B at tensor=2 (16:4 at hd 128) and of Gemma-2B
    (4:1 at hd 256, its one KV head replicated)."""
    return _kernel_rows_at(torch, [
        ("llama3-8b tensor=2 shard", 16, 4, 128, 8, False),
        ("gemma-2b tensor=2 shard", 4, 1, 256, 8, False)], "mesh", 2468)


def _mesh_logits(torch, params) -> dict:
    """One 8B prefill (700 seeded tokens) and the decode step after it,
    at tensor=1 and at tensor=2 on one card (the same weights, sharded as
    views), eager: the logits of both against each other."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cfg, dev, n = LLAMA3_8B, torch.device("cuda"), 700
    tp = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(tensor=2), MESH_DEVICES))
    gen = torch.Generator(device=dev).manual_seed(77)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                           generator=gen)
    positions = torch.arange(n, device=dev)[None]

    def lane(c, d):
        return transformer.init_decode_cache(c, 1, 1024, device=d)

    sharded = sharding.shard_params(params, tp)
    mid = cfg.n_layers // 2

    def planted(fault: str):
        """``sharded`` with ``fault`` in layer ``mid`` (new ``wo`` leaves;
        the weights served stay as they are)."""
        wo = [tree["layers"]["wo"] for tree in sharded]
        new = [w.clone() for w in wo]
        if fault == "wo_zeroed":
            new[1][mid].zero_()
        else:
            new[0][mid], new[1][mid] = wo[1][mid], wo[0][mid]
        return sharding.Shards(
            [dict(tree, layers=dict(tree["layers"], wo=w))
             for tree, w in zip(sharded, new)], tp)

    out, nxt = {}, None
    runs = [(1, params), (2, sharded)] + [(f, None) for f in MESH_FAULTS]
    with torch.no_grad():
        for t, p in runs:
            p = planted(t) if p is None else p
            cache = lane(cfg, dev) if t == 1 else sharding.shard_cache(
                lane, tp)
            logits, k, v = transformer.prefill(cfg, p, tokens, positions)
            last = logits[0, -1]
            if nxt is None:
                nxt = last[:cfg.vocab_size].argmax().reshape(1)
            transformer.insert_prefill(cache, k, v, 0, n)
            step, _ = transformer.decode_step(
                cfg, p, cache, nxt, torch.tensor([n], device=dev))
            out[t] = (last.float(), step[0].float(), k.float())
            del cache, k, v, p

    def compare(t) -> dict:
        res = {}
        for name, i in (("prefill_last", 0), ("decode_step", 1)):
            a, b = out[t][i][:cfg.vocab_size], out[1][i][:cfg.vocab_size]
            err = (a - b).abs().max().item()
            top = b.abs().max().item()
            res[name] = {"max_abs_err": err, "max_abs_logit": top,
                         "share": err / top,
                         "argmax_equal": bool(a.argmax() == b.argmax())}
        return res

    res = compare(2)
    for name, r in res.items():
        if not math.isfinite(r["share"]) or r["share"] > MESH_LOGIT_TOL:
            raise AssertionError(
                f"mesh logits {name}: max |tensor=2 - tensor=1| "
                f"{r['max_abs_err']} over {MESH_LOGIT_TOL} of the largest "
                f"|logit| {r['max_abs_logit']}")
    kv_err = (out[2][2] - out[1][2]).abs().max().item()
    res["prefill_kv_max_abs_err"] = kv_err
    res["prefill_kv_max_abs"] = out[1][2].abs().max().item()
    # The reach: each planted fault must fail the check it would face.
    res["planted_faults"] = {}
    for fault in MESH_FAULTS:
        r = res["planted_faults"][fault] = compare(fault)
        for name, x in r.items():
            if not x["share"] > MESH_LOGIT_TOL:
                raise AssertionError(
                    f"mesh logits {name}: the planted fault {fault} in layer "
                    f"{mid} moves them by {x['share']} of the largest "
                    f"|logit|, within the tolerance {MESH_LOGIT_TOL}: the "
                    "check cannot see such a fault")
    log("mesh", "logits tensor=2 vs tensor=1 (bf16, tolerance "
        f"{MESH_LOGIT_TOL} of the largest |logit|; planted faults in layer "
        f"{mid}): " + json.dumps(res))
    return res


def _mesh_narrow_f32(torch, axes=None, tag: str = "mesh") -> dict:
    """The narrow f32 model on the card unsharded and over ``axes``
    (default tensor=2; every shard on cuda:0; lanes, graphs): identical
    greedy tokens."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request)

    cfg = dataclasses.replace(LLAMA3_8B, **MESH_NARROW)
    params = transformer.init_params(cfg, seed=5, dtype=torch.float32,
                                     device="cuda")
    prompts = [[256] + [65 + (7 * i + j) % 200 for j in range(n)]
               for i, n in enumerate((5, 40, 12, 60, 3, 100))]
    axes = axes or dict(tensor=2)
    grid = mesh.MeshConfig(**axes)
    streams = {}
    for t in (1, 2):
        eng = Engine(cfg, params, EngineConfig(
            decode_slots=4, max_seq_len=256, prefill_buckets=(16, 64, 128),
            decode_steps_per_sync=4), eos_id=None, dtype=torch.float32,
            device="cuda", mesh=(mesh.make_mesh(grid,
                                                ["cuda:0"] * grid.total)
                                 if t == 2 else None))
        streams[t] = _serve_all(eng, [Request(prompt_tokens=p,
                                              max_new_tokens=24)
                                      for p in prompts])
    if streams[2] != streams[1]:
        raise AssertionError(f"{tag} f32: {axes} tokens {streams[2]} != "
                             f"unsharded {streams[1]}")
    out = {"requests": len(prompts), "tokens": sum(map(len, streams[1])),
           "identical": True}
    log(tag, f"narrow f32 {axes} vs unsharded: " + json.dumps(out))
    return out


# The brownout window's delay, and the share of it a brownout request
# must take beyond the same request's slowest fault-free time (a request
# whose delay was not applied is that much faster).
BROWNOUT_S = 1.0
BROWNOUT_SHARE = 0.75


def _mesh_faults(torch, engine, url0: str, tag: str) -> dict:
    """``LIG_FAULTS`` armed on a second in-process server window over the
    live engine: an ``error`` window (503) and then a ``brownout`` window
    (``BROWNOUT_S``): the statuses, the delay against the same request
    timed twice on the fault-free server at ``url0`` (after one untimed
    run: a first request may capture a graph), and the journal's
    ``fault_inject`` rows."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from llm_instance_gateway_tpu_torch.server import api_http
    from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer

    path = os.path.join(REPO, "build", "smoke", "faults.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    window = 2.0
    with open(path, "w") as f:
        json.dump({"faults": [
            {"kind": "error", "duration_s": window,
             "params": {"status": 503}},
            {"kind": "brownout", "start_s": window,
             "params": {"delay_s": BROWNOUT_S}}]}, f)
    body = _serve_body(12, None, False, 4)
    clean = []
    for _ in range(3):
        t0 = time.time()
        status, text = _post(url0 + "/v1/completions", body)
        clean.append(time.time() - t0)
        if status != 200:
            raise AssertionError(f"{tag}: fault-free request: {status} "
                                 f"{text}")
    clean = clean[1:]
    sink = engine.event_sink
    os.environ["LIG_FAULTS"] = path
    try:
        server = api_http.ModelServer(engine, ByteTokenizer(), "llama3-8b")
        t_arm = time.time()
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    api_http.make_handler(server))
    finally:
        del os.environ["LIG_FAULTS"]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        status, text = _post(url + "/v1/completions", body)
        if (status, text) != (503, "injected fault"):
            raise AssertionError(f"{tag}: error window: {status} {text}")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
            if f.status != 200:
                raise AssertionError(f"{tag}: /metrics {f.status}")
        time.sleep(max(0.0, t_arm + window + 0.05 - time.time()))
        t0 = time.time()
        status, text = _post(url + "/v1/completions", body)
        delay = time.time() - t0
        if status != 200 or (delay - max(clean)
                             < BROWNOUT_SHARE * BROWNOUT_S):
            raise AssertionError(
                f"{tag}: brownout window: {status} after {delay:.3f} s, "
                f"fault-free {clean} s, delay {BROWNOUT_S} s")
        with urllib.request.urlopen(
                url + "/debug/events?kind=fault_inject", timeout=60) as f:
            rows = [(e["kind"], e["attrs"])
                    for e in json.loads(f.read())["events"]]
        want = [("fault_inject", {"fault": kind, "path": "/v1/completions",
                                  "pod": ""})
                for kind in ("error", "brownout")]
        if rows != want:
            raise AssertionError(f"{tag}: journal {rows} != {want}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.event_sink = sink
    out = {"error_status": 503, "brownout_request_s": delay,
           "fault_free_request_s": clean, "brownout_delay_s": BROWNOUT_S,
           "journal_rows": 2}
    log(tag, "LIG_FAULTS window: " + json.dumps(out))
    return out


def _mesh_calibrate(torch, params, mesh=None) -> dict:
    """The capacity twin's fit (``sim/calibrate.py``) timed on an 8B lane
    engine (8 slots, 1024-token lanes, 8 steps a dispatch), at tensor=1 or
    over ``mesh``; the artifact goes under ``build/smoke/``."""
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig)
    from llm_instance_gateway_tpu_torch.sim import calibrate

    eng = Engine(LLAMA3_8B, params, EngineConfig(
        decode_slots=8, max_seq_len=1024,
        prefill_buckets=(64, 128, 256, 384, 1024), decode_steps_per_sync=8),
        eos_id=None, dtype=torch.bfloat16, device="cuda", mesh=mesh)
    t0 = time.time()
    model = calibrate.calibrate_from_engine(eng, repeats=MESH_CALIB_REPEATS)
    wall = time.time() - t0
    name = "llama3-8b" + ("" if mesh is None else "-tensor2")
    art = calibrate.calibration_artifact(
        model, {"windows": 0, "note": "engine-timed fit, no residuals"},
        f"engine:{name}")
    out_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"calibration-{name}.json")
    calibrate.write_calibration(path, art)
    log("mesh", f"calibration {name} ({wall:.1f} s, {path}): "
        + json.dumps(art["model"]))
    del eng
    return {"model": art["model"], "wall_s": wall}


def phase_mesh(torch, params, adapter_path: str, serve_stats: dict) -> dict:
    """Phase 16: tensor parallelism (``--mesh tensor=2``), both shards on
    cuda:0.  Llama-3-8B at full width and depth served through
    ``phase_serve`` (the lane serve's window: exact launches, flash and
    lane decode once per shard; its greedy tokens counted against the
    serve phase's tensor=1 tokens; the replayed decode step profiled;
    ``LIG_FAULTS`` armed on a second window over the live engine); the
    first decode step's logits against tensor=1; the narrow f32 model's
    identical tokens; Gemma-2B at tensor=2 (its one KV head replicated);
    the calibration fit at tensor=1 and tensor=2; the kernels at the
    local layouts."""
    import gc

    from llm_instance_gateway_tpu_torch.parallel import mesh

    t0 = time.time()
    kernel_rows = _mesh_kernel_rows(torch)
    faults = {}
    stats = phase_serve(
        torch, params, adapter_path, flags=MESH_FLAGS, tag="mesh",
        mesh_devices=MESH_DEVICES,
        after=lambda eng, url, st: faults.update(
            _mesh_faults(torch, eng, url, "mesh")))[0]
    answers = stats.pop("answers")
    want = serve_stats["answers"]
    differ = sum(int(a != b) for key, toks in answers.items()
                 for a, b in zip(toks, want[key]))
    log("mesh", f"greedy tokens differing from tensor=1: {differ} of "
        f"{sum(map(len, answers.values()))} (bf16; reported, not gated)")
    gc.collect()
    torch.cuda.empty_cache()
    logits = _mesh_logits(torch, params)
    narrow = _mesh_narrow_f32(torch)
    gc.collect()
    torch.cuda.empty_cache()
    gemma = phase_serve(torch, None, model="gemma-2b", flags=MESH_FLAGS,
                        tag="mesh gemma-2b", mesh_devices=MESH_DEVICES,
                        profile=False)[0]
    gemma.pop("answers")
    gc.collect()
    torch.cuda.empty_cache()
    calib = {"tensor1": _mesh_calibrate(torch, params),
             "tensor2": _mesh_calibrate(torch, params, mesh.make_mesh(
                 mesh.MeshConfig(tensor=2), MESH_DEVICES))}
    launches = dict(stats["launches"])
    for name, n in gemma["launches"].items():
        launches[name] = launches.get(name, 0) + n
    step1 = serve_stats.get("profile", {}).get("decode_step", {})
    step2 = stats.get("profile", {}).get("decode_step", {})
    per_step = {}
    for label, step in (("tensor1", step1), ("tensor2", step2)):
        graph = step.get("graph_replay")
        per_step[label] = {k: (graph or {}).get(k) if isinstance(graph, dict)
                           else graph
                           for k in ("wall_ms", "device_ms",
                                     "device_idle_share")}
    out = {"wall_s": time.time() - t0, "launches": launches,
           "tokens_differing": differ, "logits": logits, "narrow": narrow,
           "faults": faults, "calibration": calib, "per_step": per_step,
           "peak_mem_gb": {"tensor1": serve_stats["peak_mem_gb"],
                           "tensor2": stats["peak_mem_gb"],
                           "gemma-2b tensor2": gemma["peak_mem_gb"]},
           "kernel_rows": kernel_rows}
    log("mesh", "phase " + json.dumps({k: v for k, v in out.items()
                                       if k != "kernel_rows"}))
    return out


# -- phase 17: the sequence and expert axes on one card ----------------------

# Both halves run every shard as a view on cuda:0, as the mesh phase does.
SEQ_DEVICES = ["cuda:0", "cuda:0"]
SEQ_FLAGS = ["--mesh", "sequence=2"]
EXPERT_FLAGS = ["--mesh", "expert=2"]
# Faults planted in the ring, each of which the logits check (the mesh
# phase's MESH_LOGIT_TOL) must fail: block 1 attending without block 0's
# keys (a below-diagonal block skipped), and every block's K/V attended
# as the other's (the blocks at the wrong global positions).
SEQ_FAULTS = ("block_skipped", "kv_misplaced")
# Faults planted in the expert=2 Mixtral tree: expert shard 1's w_down
# scales zeroed in the middle layer (its experts' output dropped), and the
# two shards' expert stacks swapped in every layer (each token's experts
# computed with the other shard's weights).
EXPERT_FAULTS = ("experts_zeroed", "experts_swapped")


def _share(got, want) -> dict:
    """The largest |got - want| over the largest |want| (both [V])."""
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    return {"max_abs_err": err, "max_abs_logit": top, "share": err / top,
            "argmax_equal": bool(got.argmax() == want.argmax())}


def _gate(tag: str, sound: dict, faults: dict) -> None:
    """Every sound share within MESH_LOGIT_TOL, every planted fault's
    beyond it (the check's reach)."""
    for name, r in sound.items():
        if not math.isfinite(r["share"]) or r["share"] > MESH_LOGIT_TOL:
            raise AssertionError(
                f"{tag} logits {name}: {r['max_abs_err']} over "
                f"{MESH_LOGIT_TOL} of the largest |logit| "
                f"{r['max_abs_logit']}")
    for fault, rows in faults.items():
        for name, r in rows.items():
            if not r["share"] > MESH_LOGIT_TOL:
                raise AssertionError(
                    f"{tag} logits {name}: the planted fault {fault} moves "
                    f"them by {r['share']} of the largest |logit|, within "
                    f"the tolerance {MESH_LOGIT_TOL}: the check cannot see "
                    "such a fault")


def _ring_attention_fn(fault=None):
    """``prefill``'s attention seam for the ring, sound or with a planted
    fault (``SEQ_FAULTS``)."""
    from llm_instance_gateway_tpu_torch.parallel.ring_attention import (
        ring_attention_blocks)

    def attend(s, qs, ks, vs):
        if fault == "kv_misplaced":
            return ring_attention_blocks(qs, ks[::-1], vs[::-1])
        outs = ring_attention_blocks(qs, ks, vs)
        if fault == "block_skipped":
            # Block 1's diagonal alone: a one-block ring keeps its mask.
            outs[1] = ring_attention_blocks(qs[1:], ks[1:], vs[1:])[0]
        return outs
    return attend


def _padded_prompt(torch, prompt: list, pad: int):
    dev = torch.device("cuda")
    n = len(prompt)
    padded = -(-n // pad) * pad
    tokens = torch.zeros((1, padded), dtype=torch.long, device=dev)
    tokens[0, :n] = torch.tensor(prompt, device=dev)
    return tokens, torch.arange(padded, device=dev)[None]


def _seq_logits(torch, params, prompt: list) -> dict:
    """The ring prefill (sequence=2 on one card) of ``prompt``, padded to
    the serve's ring multiple (1024), against sequence=1's prefill (flash)
    of the same tokens: the last real position's logits, sound and with
    ``SEQ_FAULTS`` planted; eager, bf16, each prefill timed."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import (
        long_context, mesh, sharding)

    cfg, n = LLAMA3_8B, len(prompt)
    tokens, positions = _padded_prompt(torch, prompt, 1024)
    m = mesh.make_mesh(mesh.MeshConfig(sequence=2), SEQ_DEVICES)
    sp = sharding.shard_params(params, sharding.TensorParallel(cfg, m))
    blocks = long_context.shard_inputs(m, tokens, positions)
    rows, walls = {}, {}
    with torch.no_grad():
        for run in ("sequence=1",) + ("sound",) + SEQ_FAULTS:
            torch.cuda.synchronize()
            t0 = time.time()
            if run == "sequence=1":
                logits = transformer.prefill(cfg, params, tokens,
                                             positions)[0]
            else:
                logits = transformer.prefill(
                    cfg, sp, *blocks, attention_fn=_ring_attention_fn(
                        None if run == "sound" else run))[0]
            rows[run] = logits[0, n - 1, :cfg.vocab_size].float().clone()
            torch.cuda.synchronize()
            walls[run] = time.time() - t0
            del logits
    want = rows.pop("sequence=1")
    res = {"prompt_tokens": n, "padded": tokens.shape[1],
           "prefill_last": _share(rows["sound"], want),
           "wall_s": walls,
           "planted_faults": {f: {"prefill_last": _share(rows[f], want)}
                              for f in SEQ_FAULTS}}
    _gate("seq", {"prefill_last": res["prefill_last"]}, res["planted_faults"])
    log("seq", "ring prefill logits vs sequence=1 (bf16, tolerance "
        f"{MESH_LOGIT_TOL} of the largest |logit|): " + json.dumps(res))
    return res


def _seq_profile(torch, engine, prompt: list) -> dict:
    """On the idle sequence=2 server: one ring prefill of ``prompt``
    (``Engine._ring_prefill``: pad, the ring, the first token sampled)
    beside the chunk stream sequence=1 runs for it (1024-token chunk
    programs through a row's table, on sequence group 0: sequence=1's
    tree and pool), each profiled once after a warm-up call."""
    import numpy as np

    from llm_instance_gateway_tpu_torch.models import paged
    from llm_instance_gateway_tpu_torch.parallel import sharding
    from llm_instance_gateway_tpu_torch.server.engine import Request

    cfg, n, chunk = engine.model_cfg, len(prompt), 1024
    params = sharding.parts(engine.params)[0]
    lora_bufs = sharding.parts(engine.lora.buffers)[0]
    block = engine._block
    need = -(-n // chunk) * chunk // block
    tables = torch.zeros_like(sharding.parts(engine.cache)[0]["tables"])
    tables[7, :need] = torch.arange(1, need + 1)
    cache = dict(sharding.parts(engine.cache)[0], tables=tables)
    req = Request(prompt_tokens=list(prompt), max_new_tokens=1)

    def ring():
        return engine._ring_prefill(req, n, -1)[0]

    def stream():
        out = None
        for start in range(0, n, chunk):
            c = min(chunk, n - start)
            toks = np.zeros((chunk,), np.int64)
            toks[:c] = prompt[start:start + c]
            out = paged.prefill_with_cache_paged(
                cfg, params, cache, toks, start + np.arange(chunk), 7,
                start + c, c - 1, lora_bufs=lora_bufs)[0]
        return out

    with torch.no_grad():
        out = {"ring_prefill": _profile(
            torch, f"ring prefill of {n} tokens (sequence=2, one card)",
            ring, 1),
            "chunk_stream": _profile(
                torch, f"chunk stream of {n} tokens (sequence=1's "
                f"{-(-n // chunk)} chunk programs)", stream, 1)}
    return out


def _seq_narrow_f32(torch) -> dict:
    """The narrow f32 model (the mesh phase's) on the card with a 200-token
    prompt beyond the largest bucket (128): at ``sequence=2`` and at
    ``tensor=2, sequence=2`` (one ring program, graphs replaying the
    decode after it) against sequence=1 with a covering bucket, with a
    bf16-width and an int8 KV cache: identical greedy tokens."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request)

    cfg = dataclasses.replace(LLAMA3_8B, **MESH_NARROW)
    params = transformer.init_params(cfg, seed=5, dtype=torch.float32,
                                     device="cuda")
    prompts = [[256] + [65 + (7 * i + j) % 200 for j in range(n)]
               for i, n in enumerate((5, 40, 12, 60, 3, 100, 199))]
    out = {}
    for kv in (None, "int8"):
        streams, rings = {}, {}
        for name, axes, buckets in (
                ("sequence=1", None, (16, 64, 128, 256)),
                ("sequence=2", dict(sequence=2), (16, 64, 128)),
                ("tensor=2,sequence=2", dict(tensor=2, sequence=2),
                 (16, 64, 128))):
            m = None
            if axes:
                mc = mesh.MeshConfig(**axes)
                m = mesh.make_mesh(mc, ["cuda:0"] * mc.total)
            eng = Engine(cfg, params, EngineConfig(
                decode_slots=4, max_seq_len=256, prefill_buckets=buckets,
                decode_steps_per_sync=4, kv_cache_quant=kv), eos_id=None,
                dtype=torch.float32, device="cuda", mesh=m)
            calls = []
            if eng._ring is not None:
                ring = eng._ring
                eng._ring = lambda *a, ring=ring, **k: (calls.append(1)
                                                        or ring(*a, **k))
            streams[name] = _serve_all(eng, [Request(prompt_tokens=p,
                                                     max_new_tokens=24)
                                             for p in prompts])
            rings[name] = len(calls)
        for name, got in streams.items():
            if got != streams["sequence=1"]:
                raise AssertionError(f"seq f32 (kv {kv}): {name} tokens "
                                     f"{got} != sequence=1 "
                                     f"{streams['sequence=1']}")
        if rings != {"sequence=1": 0, "sequence=2": 1,
                     "tensor=2,sequence=2": 1}:
            raise AssertionError(f"seq f32 (kv {kv}): ring programs {rings}")
        out[kv or "f32"] = {"requests": len(prompts), "identical": True,
                            "tokens": sum(map(len, streams["sequence=1"])),
                            "ring_programs": rings}
    log("seq", "narrow f32 sequence=2 and tensor=2,sequence=2 vs "
        "sequence=1: " + json.dumps(out))
    return out


def _differing(answers: dict, want: dict) -> dict:
    """Greedy tokens of ``answers`` that differ from ``want``'s."""
    return {"differ": sum(int(a != b) for key, toks in answers.items()
                          for a, b in zip(toks, want[key])),
            "of": sum(map(len, answers.values()))}


def phase_sequence(torch, params, adapter_path: str,
                   paged_stats: dict) -> dict:
    """Phase 17, first half: the ``sequence`` axis (``--mesh sequence=2``,
    both shards on cuda:0).  Llama-3-8B at full width and depth behind the
    paged serve's window (``phase_paged_serve``: 8192-token context,
    prefix cache; the 3001- and 6001-token prompts pad to 3072 and 6144
    and run one ring program each, no chunk stream, exact launches: no
    flash on the ring, the paged kernel per tensor shard), its greedy
    tokens counted against the paged serve phase's; one ring prefill and
    sequence=1's chunk stream of the longest prompt profiled; again with
    ``--kv-quantize int8``; the ring's last-position logits against
    sequence=1's prefill with ``SEQ_FAULTS`` planted; the narrow f32
    model's identical tokens."""
    import gc

    t0 = time.time()
    extra: dict = {}

    def after(engine, url, stats):
        prompt = max((list(p) for p, _ in stats["answers"]), key=len)
        extra["prompt"] = prompt
        extra["profile"] = _seq_profile(torch, engine, prompt)

    stats = phase_paged_serve(torch, params, adapter_path, flags=SEQ_FLAGS,
                              tag="seq", mesh_devices=SEQ_DEVICES,
                              profile=False, after=after)
    answers = stats.pop("answers")
    differ = _differing(answers, paged_stats["answers"])
    log("seq", f"greedy tokens differing from the paged serve (sequence=1, "
        f"bf16): {differ['differ']} of {differ['of']} (reported, not gated)")
    gc.collect()
    torch.cuda.empty_cache()
    int8kv = phase_paged_serve(
        torch, params, adapter_path, flags=SEQ_FLAGS + ["--kv-quantize",
                                                        "int8"],
        tag="seq-int8kv", mesh_devices=SEQ_DEVICES, profile=False)
    differ_int8 = _differing(int8kv.pop("answers"), answers)
    log("seq", "greedy tokens with --kv-quantize int8 differing from bf16 "
        f"KV's: {differ_int8['differ']} of {differ_int8['of']} (reported)")
    gc.collect()
    torch.cuda.empty_cache()
    logits = _seq_logits(torch, params, extra["prompt"])
    narrow = _seq_narrow_f32(torch)
    launches = dict(stats["launches"])
    for name, k in int8kv["launches"].items():
        launches[name] = launches.get(name, 0) + k
    out = {"wall_s": time.time() - t0, "launches": launches,
           "tokens_differing": differ, "int8kv_tokens_differing": differ_int8,
           "logits": logits, "narrow": narrow, "profile": extra["profile"],
           "programs": {k: stats[k] for k in ("ring_programs",
                                              "chunk_streams",
                                              "chunk_programs",
                                              "prefill_programs")},
           "peak_mem_gb": {"sequence=1 paged": paged_stats["peak_mem_gb"],
                           "sequence=2 paged": stats["peak_mem_gb"]}}
    log("seq", "phase " + json.dumps(out))
    return out


def _float_leaves(torch, tree, dtype):
    """``tree`` with every floating leaf in ``dtype`` (int8 ``{"q", "s"}``
    leaves kept: ``quant.matmul`` widens them to the activations')."""
    from llm_instance_gateway_tpu_torch.ops.quant import is_quantized

    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _float_leaves(torch, v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _expert_logits(torch, params) -> dict:
    """Mixtral-8x7B (the served int8 tree) at expert=1 and at expert=2 on
    one card (the expert shards views of the same stacks), eager: a
    300-token prefill (the grouped dispatch) and the decode step after it
    (the dense mix), logits against each other.  With f32 activations
    (the int8 weights widened to f32) the two must agree within
    MESH_LOGIT_TOL and each of ``EXPERT_FAULTS`` planted in the sharded
    tree must fail that check; in bf16, as served, the share is reported
    beside its floor: expert=1 against itself with the prefill's grouped
    tiles replaced by the dense mix (the same function, another order of
    sums), since in bf16 a rounding apart flips near-tied top-2 choices
    and each flip moves a token's MLP output whole."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import MIXTRAL_8X7B
    from llm_instance_gateway_tpu_torch.ops.quant import is_quantized
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cfg, dev, n = MIXTRAL_8X7B, torch.device("cuda"), 300
    tp = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(expert=2), SEQ_DEVICES))
    gen = torch.Generator(device=dev).manual_seed(78)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                           generator=gen)
    positions = torch.arange(n, device=dev)[None]
    mid = cfg.n_layers // 2
    # The dense mix for the prefill too (cap >= t): the floor's variant.
    dense_cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)

    def planted(sharded, fault: str):
        trees = [dict(t, layers=dict(t["layers"])) for t in sharded]
        if fault == "experts_zeroed":
            w = trees[1]["layers"]["w_down"]
            if is_quantized(w):
                scale = w["s"].clone()
                scale[mid] = 0
                w = {"q": w["q"], "s": scale}
            else:
                w = w.clone()
                w[mid] = 0
            trees[1]["layers"]["w_down"] = w
        else:
            for name in ("w_gate", "w_up", "w_down"):
                trees[0]["layers"][name] = sharded[1]["layers"][name]
                trees[1]["layers"][name] = sharded[0]["layers"][name]
        return sharding.Shards(trees, tp)

    def forward(p, dtype, run_cfg=cfg):
        """(the prefill's last logits, the next decode step's logits)."""
        def lane(c, d):
            return transformer.init_decode_cache(c, 1, 1024, dtype=dtype,
                                                 device=d)
        cache = (sharding.shard_cache(lane, tp)
                 if isinstance(p, sharding.Shards) else lane(cfg, dev))
        logits, k, v = transformer.prefill(run_cfg, p, tokens, positions)
        last = logits[0, -1, :cfg.vocab_size].float().clone()
        del logits
        transformer.insert_prefill(cache, k, v, 0, n)
        # Every run decodes the first run's argmax.
        nxt = state.setdefault("nxt", last.argmax().reshape(1))
        step, _ = transformer.decode_step(
            run_cfg, p, cache, nxt, torch.tensor([n], device=dev))
        return last, step[0, :cfg.vocab_size].float()

    def compare(got, want):
        return {name: _share(got[i], want[i])
                for name, i in (("prefill_last", 0), ("decode_step", 1))}

    res, state = {}, {}
    with torch.no_grad():
        want = forward(params, torch.bfloat16)
        res["bf16"] = compare(forward(sharding.shard_params(params, tp),
                                      torch.bfloat16), want)
        res["bf16"]["floor"] = compare(
            forward(params, torch.bfloat16, dense_cfg), want)
        p32 = _float_leaves(torch, params, torch.float32)
        sh32 = sharding.shard_params(p32, tp)
        want = forward(p32, torch.float32)
        res["f32"] = compare(forward(sh32, torch.float32), want)
        res["f32"]["planted_faults"] = {
            f: compare(forward(planted(sh32, f), torch.float32), want)
            for f in EXPERT_FAULTS}
        del p32, sh32
    _gate("expert f32", {k: res["f32"][k] for k in ("prefill_last",
                                                    "decode_step")},
          res["f32"]["planted_faults"])
    log("expert", "logits expert=2 vs expert=1 (int8 weights; gated at f32 "
        f"activations, tolerance {MESH_LOGIT_TOL}, experts_zeroed in layer "
        f"{mid}; bf16 reported beside its floor): " + json.dumps(res))
    return res


def phase_expert(torch, engine, stats: dict) -> dict:
    """Phase 17, second half: the ``expert`` axis, run on phase 13's
    Mixtral-8x7B int8 server (``_moe_extras``) over its own tree: the
    logits at expert=2 against expert=1 with ``EXPERT_FAULTS`` planted;
    the narrow Mixtral at expert=2 on the card, 16 slots replaying the
    grouped decode, its exact fallback forced by a zero router (the
    dense result: the CPU's tokens); then ``--mesh expert=2`` served over
    the same tree through the serve phase's window (exact launches), its
    replayed decode step and peak memory beside expert=1's."""
    import dataclasses
    import gc

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS

    t0 = time.time()
    logits = _expert_logits(torch, engine.params)
    preset, h, k, hd = FAMILY_LAYOUTS[
        "mixtral (32:8, hd 128, 8 experts, top-2)"]
    cfg = dataclasses.replace(
        CONFIGS[preset], name=f"{preset}-narrow", d_model=512, n_layers=2,
        n_heads=h, n_kv_heads=k, head_dim=hd, d_ff=1024, vocab_size=320)
    cpu_params = transformer.init_params(cfg, seed=7, dtype=torch.float32,
                                         device="cpu")
    _moe_replay_reference(torch, "mixtral narrow expert=2", cfg, cpu_params,
                          _to_card(cpu_params), mesh_axes=dict(expert=2),
                          phase="expert")
    gc.collect()
    torch.cuda.empty_cache()
    flags = dict(FAMILY_SERVERS)["mixtral-8x7b"] + EXPERT_FLAGS
    served = phase_serve(torch, engine.params, model="mixtral-8x7b",
                         flags=flags, tag="expert",
                         mesh_devices=SEQ_DEVICES)[0]
    differ = _differing(served.pop("answers"), stats["answers"])
    log("expert", f"greedy tokens differing from expert=1: "
        f"{differ['differ']} of {differ['of']} (int8; reported, not gated)")
    steps = {}
    for label, st in (("expert=1", stats), ("expert=2", served)):
        graph = st["profile"]["decode_step"]["graph_replay"]
        steps[label] = {key: graph.get(key) if isinstance(graph, dict)
                        else graph
                        for key in ("wall_ms", "device_ms",
                                    "device_idle_share")}
        steps[label]["peak_mem_gb"] = st["peak_mem_gb"]
    out = {"wall_s": time.time() - t0, "launches": served["launches"],
           "logits": logits, "tokens_differing": differ,
           "replayed_step": steps}
    log("expert", "phase " + json.dumps(out))
    return out


# -- phase 18: the data, fsdp and pipe axes on one card ----------------------

# Every shard a view on cuda:0, as phases 16-17 run theirs.
AXES_DEVICES = ["cuda:0", "cuda:0"]
DATA_FLAGS = ["--mesh", "data=2"]
FSDP_FLAGS = ["--mesh", "fsdp=2"]
# The pool for the fsdp window: 8 rows of 1024 tokens in 64-token blocks.
FSDP_PAGED_FLAGS = FSDP_FLAGS + ["--paged-kv-block", "64",
                                 "--paged-kv-blocks", "128"]
# Faults planted in a data=2 decode step, each of which the logits check
# (MESH_LOGIT_TOL) must fail: each group attending the other group's
# lanes, and a prompt's KV written into a row of the wrong group.
DATA_FAULTS = ("kv_crossed", "slot_misrouted")
# The pipelined train step (run once the serve phases' 8B tree is freed):
# Llama-3-8B's widths at 8 of its 32 layers (16 fit one card, with params,
# gradients, AdamW's two moments and the optimizer's temporaries; 8 keep
# this phase and phase 20 short for the smoke's time limit); pipe=2, M=2 microbatches of one 1024-token row.  Its
# first update is held to the unpipelined step's over the elements either
# step moved in the leaves checked: the microbatches' bf16 GEMMs round
# apart from the batched ones, so an element whose gradient sits within
# rounding of 0 may step the other way (and AdamW's first step is about
# +-lr whatever the gradient's size, so a rounding apart can land one ulp
# apart); at least PIPE_AGREE of them must step the same way, and the
# losses agree within PIPE_LOSS_TOL.
PIPE_LAYERS = 8
PIPE_M = 2
PIPE_S = 1024
PIPE_LR = TRAIN_LR
PIPE_LOSS_TOL = 1e-2  # relative
PIPE_AGREE = 0.95


def _data_logits(torch, params) -> dict:
    """Two 700-token prompts in rows 1 and 2 of a 4-row lane cache (rows
    1 and 2 sit in data groups 0 and 1 at data=2), prefilled, then one
    decode step: data=2's logits of both rows against data=1's, eager,
    within MESH_LOGIT_TOL, and each of ``DATA_FAULTS`` failing that
    check."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cfg, dev, n, rows = LLAMA3_8B, torch.device("cuda"), 700, 4
    tp = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(data=2), AXES_DEVICES))
    sharded = sharding.shard_params(params, tp)
    gen = torch.Generator(device=dev).manual_seed(79)
    prompts = torch.randint(0, cfg.vocab_size, (2, n), device=dev,
                            generator=gen)
    positions = torch.arange(n, device=dev)[None]
    live = (1, 2)

    def lane(c, d, r=rows):
        return transformer.init_decode_cache(c, r, 1024, device=d)

    def run(fault):
        p = params if fault == "data1" else sharded
        cache = (lane(cfg, dev) if fault == "data1"
                 else sharding.shard_cache(lane, tp, rows=rows))
        nxt = torch.zeros(rows, dtype=torch.long, device=dev)
        for i, row in enumerate(live):
            group = 0 if fault == "data1" else row // 2
            logits, k, v = transformer.prefill(
                cfg, p, prompts[i:i + 1], positions, data_group=group)
            nxt[row] = logits[0, -1, :cfg.vocab_size].argmax()
            if fault == "slot_misrouted" and row == 2:
                # Row 2's KV in group 0's first row: the map gone wrong.
                transformer.insert_prefill(cache.data[0], k, v, 0, n)
            else:
                transformer.insert_prefill(cache, k, v, row, n)
            del logits, k, v
        if fault == "kv_crossed":
            cache = sharding.Shards(list(cache.data[1]), tp, None,
                                    [cache.data[1], cache.data[0]])
        active = torch.tensor([r in live for r in range(rows)], device=dev)
        step, _ = transformer.decode_step(
            cfg, p, cache, nxt, torch.full((rows,), n, device=dev),
            active=active)
        return step[list(live), :cfg.vocab_size].float()

    with torch.no_grad():
        out = {f: run(f) for f in ("data1", "data2") + DATA_FAULTS}
    sound = {"decode_step": _share(out["data2"], out["data1"])}
    faults = {f: {"decode_step": _share(out[f], out["data1"])}
              for f in DATA_FAULTS}
    _gate("data logits", sound, faults)
    res = dict(sound, planted_faults=faults)
    log("data", "logits data=2 vs data=1 (bf16, rows 1 and 2 in groups 0 "
        f"and 1, tolerance {MESH_LOGIT_TOL}): " + json.dumps(res))
    return res


def _fsdp_logits(torch, params) -> dict:
    """A 700-token prefill and eight greedy decode steps after it at
    fsdp=1 and fsdp=2 (views on cuda:0), eager, on a lane and on a
    paged pool: every step's logits bitwise equal (the gathered weights
    are the same values in the same shapes), so the tokens too."""
    from llm_instance_gateway_tpu_torch.models import paged, transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cfg, dev, n, steps, block = LLAMA3_8B, torch.device("cuda"), 700, 8, 64
    tp = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(fsdp=2), AXES_DEVICES))
    sharded = sharding.shard_params(params, tp)
    gen = torch.Generator(device=dev).manual_seed(80)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                           generator=gen)
    positions = torch.arange(n, device=dev)[None]
    table = list(range(1, 1024 // block + 1))

    def make(kind):
        if kind == "lanes":
            return lambda c, d: transformer.init_decode_cache(c, 1, 1024,
                                                              device=d)
        return lambda c, d: paged.init_paged_cache(c, 1, 1024, len(table),
                                                   block, device=d)

    def run(p, kind):
        cache = (make(kind)(cfg, dev) if p is params
                 else sharding.shard_cache(make(kind), tp))
        logits, k, v = transformer.prefill(cfg, p, prompt, positions)
        outs = [logits[0, -1, :cfg.vocab_size].clone()]
        if kind == "lanes":
            transformer.insert_prefill(cache, k, v, 0, n)
            fn = transformer.decode_step
        else:
            paged.insert_prefill_paged(cache, k, v, 0,
                                       table[:-(-n // block)], table, n)
            fn = paged.decode_step_paged
        del logits, k, v
        tokens = []
        for i in range(steps):
            tok = outs[-1].argmax().reshape(1)
            tokens.append(int(tok))
            step, _ = fn(cfg, p, cache, tok,
                         torch.tensor([n + i], device=dev))
            outs.append(step[0, :cfg.vocab_size].clone())
        return outs, tokens

    res = {}
    with torch.no_grad():
        for kind in ("lanes", "paged"):
            (want, want_t), (got, got_t) = run(params, kind), run(sharded,
                                                                  kind)
            equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            res[kind] = {"steps": steps, "tokens": got_t,
                         "tokens_equal": got_t == want_t,
                         "logits_bitwise": all(equal),
                         "max_abs_err": max((a.float() - b.float()).abs()
                                            .max().item()
                                            for a, b in zip(got, want))}
            if not all(equal) or got_t != want_t:
                raise AssertionError(f"fsdp {kind}: fsdp=2 is not fsdp=1 "
                                     f"bitwise: {res[kind]}")
    log("fsdp", "fsdp=2 vs fsdp=1, 700-token prefill + 8 greedy steps "
        "(bf16, eager): " + json.dumps(res))
    return res


def _fsdp_gather_ms(torch, engine, reps: int = 5) -> float:
    """Device ms (CUDA events) of one decode step's fsdp gathers alone:
    every split leaf of every layer (LoRA ``o_b`` / ``down_b`` included)
    and ``lm_head``, as the shard loop gathers them."""
    from llm_instance_gateway_tpu_torch.parallel import sharding

    trees = [(t, lr) for t, lr in zip(sharding.parts(engine.params),
                                      sharding.parts(engine.lora.buffers))]
    n_layers = engine.model_cfg.n_layers

    def gather_all():
        for tree, lora in trees:
            for i in range(n_layers):
                for leaf in list(tree["layers"].values()) + list(
                        lora.values()):
                    for x in (leaf.values() if isinstance(leaf, dict)
                              else [leaf]):
                        if isinstance(x, sharding.FsdpLeaf):
                            x[i]
            sharding.whole(tree["lm_head"])

    gather_all()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        gather_all()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _replayed(stats: dict) -> dict:
    graph = stats.get("profile", {}).get("decode_step", {}).get(
        "graph_replay")
    return {k: (graph.get(k) if isinstance(graph, dict) else graph)
            for k in ("wall_ms", "device_ms", "device_idle_share")}


def phase_pipe(torch) -> dict:
    """Phase 18, last part: the pipelined full-parameter train step at
    Llama-3-8B's widths and ``PIPE_LAYERS`` layers (``pipe=2``, both
    stages on cuda:0, M=2 rows of ``PIPE_S`` tokens): four steps (the
    fourth profiled), each launching flash and the backward exactly L x
    M times; the first
    step's loss and update against the unpipelined
    ``make_full_train_step`` from the same seeded weights
    (``PIPE_LOSS_TOL``, ``PIPE_AGREE`` on layer 0's and the last layer's
    ``wq`` / ``wo`` / ``w_down``, ``embed`` and ``lm_head``); step walls
    and peak memory."""
    import dataclasses
    import gc

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh, pipeline
    from llm_instance_gateway_tpu_torch.training import train

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=PIPE_LAYERS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(81)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_M, PIPE_S), device=dev,
                           generator=gen)
    positions = torch.arange(PIPE_S, device=dev)[None].expand(PIPE_M,
                                                               PIPE_S)
    checked = ("wq", "wo", "w_down")

    def picks(tree, staged: bool):
        out = {"embed": tree["embed"], "lm_head": tree["lm_head"]}
        for name in checked:
            leaf = tree["layers"][name]
            out[f"{name}[0]"] = leaf[0, 0] if staged else leaf[0]
            out[f"{name}[{PIPE_LAYERS - 1}]"] = (leaf[-1, -1] if staged
                                                 else leaf[-1])
        return {k: v.detach().clone() for k, v in out.items()}

    runs = {}
    for kind in ("pipe", "plain"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        params = transformer.init_params(cfg, seed=22, device="cuda")
        if kind == "pipe":
            m = mesh.make_mesh(mesh.MeshConfig(pipe=2), AXES_DEVICES)
            tree = pipeline.stage_param_specs(
                cfg, pipeline.stage_params(cfg, params, 2), m)
            opt = train.make_optimizer(tree, lr=PIPE_LR)
            step = pipeline.make_pipeline_train_step(cfg, opt, 2, PIPE_M, m)
        else:
            tree = params
            opt = train.make_optimizer(tree, lr=PIPE_LR)
            step = train.make_full_train_step(cfg, opt)
        before = picks(tree, kind == "pipe")
        losses, walls, launches = [], [], []
        for i in range(2):
            reset_launches()
            t0 = time.time()
            tree, _, loss = step(tree, None, tokens, positions)
            losses.append(loss.item())
            walls.append(time.time() - t0)
            launches.append(read_launches())
            if i == 0:
                after = picks(tree, kind == "pipe")
        # Two more steps: one untimed, one under the profiler.
        reset_launches()
        profiled = _profile(torch, f"{kind} train step", lambda: step(
            tree, None, tokens, positions), 1)
        launches.append(read_launches())
        per = PIPE_M if kind == "pipe" else 1
        for got, steps in zip(launches, (1, 1, 2)):
            check_only(got, {"flash_prefill": PIPE_LAYERS * per * steps,
                             "flash_backward": PIPE_LAYERS * per * steps},
                       f"pipe train ({kind})")
        runs[kind] = {"losses": losses, "step_wall_s": walls,
                      "launches": launches, "profiled_step": profiled,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_above_start_gb": (torch.cuda.max_memory_allocated()
                                              - mem0) / 1e9,
                      "before": before, "after": after}
        del tree, opt, step, params
    pipe, plain = runs["pipe"], runs["plain"]
    loss_err = abs(pipe["losses"][0] - plain["losses"][0]) / abs(
        plain["losses"][0])
    agree = {}
    for name in pipe["after"]:
        if not torch.equal(pipe["before"][name], plain["before"][name]):
            raise AssertionError(f"pipe train: {name} starts apart")
        a, b, b0 = pipe["after"][name], plain["after"][name], \
            plain["before"][name]
        moved = (a != b0) | (b != b0)
        da, db = (a.float() - b0.float()).sign(), (b.float() - b0.float()) \
            .sign()
        agree[name] = {"moved": moved.float().mean().item(),
                       "same_bits_where_moved": (a == b)[moved].float()
                       .mean().item() if moved.any() else float("nan"),
                       "same_sign_where_moved": (da == db)[moved].float()
                       .mean().item() if moved.any() else float("nan")}
    launches = {name: sum(step[name] for step in pipe["launches"])
                for name in pipe["launches"][0]}
    res = {"layers": PIPE_LAYERS, "microbatches": PIPE_M, "tokens": PIPE_S,
           "lr": PIPE_LR, "loss_rel_err": loss_err, "agreement": agree,
           "launches": launches,
           **{k: {x: v for x, v in r.items()
                  if x not in ("before", "after", "launches")}
              for k, r in runs.items()}}
    if not (math.isfinite(loss_err) and loss_err <= PIPE_LOSS_TOL):
        raise AssertionError(f"pipe train: loss {pipe['losses'][0]} against "
                             f"the unpipelined {plain['losses'][0]}")
    for name, a in agree.items():
        if not a["same_sign_where_moved"] >= PIPE_AGREE:
            raise AssertionError(f"pipe train: {name} updated apart from "
                                 f"the unpipelined step: {a}")
    log("pipe", "pipelined full-parameter step (pipe=2, both stages on "
        "cuda:0) against the unpipelined step: " + json.dumps(res))
    # Phase 20's reference: this one-process pipelined step's first loss
    # and picks, on the host.
    res["reference"] = {"loss": pipe["losses"][0],
                        **{k: {n: t.cpu() for n, t in pipe[k].items()}
                           for k in ("before", "after")}}
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_axes(torch, params, adapter_path: str, serve_stats: dict) -> dict:
    """Phase 18: the ``data``, ``fsdp`` and ``pipe`` axes, every shard a
    view on cuda:0.  Llama-3-8B at ``--mesh data=2`` through the serve
    phase's window (exact launches: decode once per data group), its
    logits against data=1 with ``DATA_FAULTS`` planted, the narrow f32
    model's identical tokens; ``--mesh fsdp=2`` through the same window
    on lanes (the replayed step profiled beside fsdp=1's, the gathers'
    device ms) and on the pool, its logits and tokens bitwise fsdp=1's.
    The pipelined train step runs after the 8B tree is freed
    (``phase_pipe``)."""
    import gc

    t0 = time.time()
    data = phase_serve(torch, params, adapter_path, flags=DATA_FLAGS,
                       tag="data", mesh_devices=AXES_DEVICES)[0]
    data_differ = _differing(data.pop("answers"), serve_stats["answers"])
    gc.collect()
    torch.cuda.empty_cache()
    data_logits = _data_logits(torch, params)
    data_narrow = _mesh_narrow_f32(torch, dict(data=2), "data")
    gathers = {}
    fsdp = phase_serve(
        torch, params, adapter_path, flags=FSDP_FLAGS, tag="fsdp",
        mesh_devices=AXES_DEVICES,
        after=lambda eng, url, st: gathers.update(
            gather_ms=_fsdp_gather_ms(torch, eng)))[0]
    fsdp_differ = _differing(fsdp.pop("answers"), serve_stats["answers"])
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_paged = phase_serve(torch, params, adapter_path,
                             flags=FSDP_PAGED_FLAGS, tag="fsdp paged",
                             mesh_devices=AXES_DEVICES, profile=False)[0]
    fsdp_paged.pop("answers")
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_logits = _fsdp_logits(torch, params)
    steps = {"unsharded": _replayed(serve_stats), "data=2": _replayed(data),
             "fsdp=2": _replayed(fsdp)}
    device = steps["fsdp=2"]["device_ms"]
    gathers["share_of_replayed_step"] = (
        gathers["gather_ms"] / device if isinstance(device, float) else
        "not measured")
    fsdp_launches = {name: n + fsdp_paged["launches"].get(name, 0)
                     for name, n in fsdp["launches"].items()}
    out = {"wall_s": time.time() - t0, "launches_data": data["launches"],
           "launches_fsdp": fsdp_launches,
           "data_tokens_differing": data_differ,
           "fsdp_tokens_differing": fsdp_differ,
           "data_logits": data_logits, "data_narrow": data_narrow,
           "fsdp_logits": fsdp_logits, "fsdp_gathers": gathers,
           "replayed_step": steps,
           "peak_mem_gb": {"data=2": data["peak_mem_gb"],
                           "fsdp=2": fsdp["peak_mem_gb"],
                           "fsdp=2 paged": fsdp_paged["peak_mem_gb"]}}
    log("axes", f"greedy tokens differing from the serve phase: data=2 "
        f"{data_differ['differ']} of {data_differ['of']}, fsdp=2 "
        f"{fsdp_differ['differ']} of {fsdp_differ['of']} (bf16, across "
        "servers; reported, not gated)")
    log("axes", "phase " + json.dumps(out))
    return out


# -- phase 19: the port across processes on one card ---------------------

# Two processes share cuda:0 (gloo: NCCL refuses two ranks on one device),
# each holding its shard of Llama-3-8B at full width and depth.
PROC_SEED = 19
# Llama-3-8B's widths at 8 of its 32 layers (the smoke passed 1100 s of
# its 1200 once phase 22 came, 127 s of it this phase at full depth;
# every check here is per layer or against one process's run of the same
# tree).
PROC_LAYERS = 8
PROC_PROMPTS = (12, 120, 700)  # prompt tokens of the lockstep serve
PROC_NEW = 16  # greedy tokens a request
PROC_LOGIT_TOKENS = 700  # the prefill before the compared decode step
PROC_DECODE_REPS = 3  # eager decode steps profiled
PROC_TRAIN_STEPS = 3
# Faults planted in layer n_layers/2 of the two-process forward, each of
# which the logits check (MESH_LOGIT_TOL) must fail: rank 1's wo partial
# dropped (its wo zeroed), and the ranks' wo shards swapped.
PROC_FAULTS = ("partial_dropped", "shards_swapped")
PROC_TIMEOUT_S = 600
# ``--mesh sequence=2`` across the two processes: the lane window at
# phase 17's context, its 6001-token prompt (one ring program, padded to
# 6144: 3072 positions a process) and two bucketed ones.
PROC_SEQ_PROMPTS = (6001, 120, 700)
PROC_SEQ_MAX_LEN = 8192
PROC_SEQ_TRAIN_STEPS = 2  # LoRA steps at sequence=2 (512 positions each)
# Faults planted in the ring across the processes (the last-token logits
# must fail MESH_LOGIT_TOL): block 1 folded without block 0's K/V (a
# dropped block), and the exchanged blocks folded in reverse order.
PROC_SEQ_FAULTS = ("block_dropped", "blocks_reversed")
# ``expert=2`` LoRA steps on Mixtral-8x7B's widths cut to this depth (its
# 32 layers are ~93 GB in bf16; 4 layers are ~12 GB, a process holding
# half the experts, 4 of 8).
PROC_MOE_LAYERS = 4
PROC_MOE_TRAIN_STEPS = 2
# Lockstep beyond the sync loop: PROC_PROMPTS again through the pipelined
# loop with the adaptive planner (blocks of up to PROC_ADAPTIVE steps),
# then a seeded handoff of PROC_HANDOFF_TOKENS parked behind them with
# every slot busy, past a TTL of PROC_TTL_S, rank 1's engine clock frozen:
# the first process's verdict releases it on both.
PROC_ADAPTIVE = 8
PROC_HANDOFF_TOKENS = 32
PROC_TTL_S = 1e-3

# The worker each of the two processes runs (``multihost_check.
# run_two_process``): it imports the port and this script's helpers only.
PROC_WORKER = r"""
import gc, json, math, os, sys, time
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
import torch.distributed as dist
import chip_smoke as s
import dataclasses
from llm_instance_gateway_tpu_torch.models import lora, transformer
from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
from llm_instance_gateway_tpu_torch.models.configs import MIXTRAL_8X7B
from llm_instance_gateway_tpu_torch.parallel import (
    collectives, long_context, multihost_check, sharding)
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, initialize_distributed, make_mesh, world)
from llm_instance_gateway_tpu_torch.parallel.ring_attention import (
    ring_attention_blocks)
from llm_instance_gateway_tpu_torch.server.engine import Engine, EngineConfig
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, size = world()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
t_start = time.time()
out = {"rank": rank, "walls": {}}
cfg = dataclasses.replace(LLAMA3_8B, n_layers=s.PROC_LAYERS)
mid = cfg.n_layers // 2
half = cfg.n_heads * cfg.resolved_head_dim // 2
n_logit = s.PROC_LOGIT_TOKENS
gen = torch.Generator(device=dev).manual_seed(s.PROC_SEED)
prompts = [torch.randint(1, cfg.vocab_size, (n,), device=dev,
                         generator=gen).tolist() for n in s.PROC_PROMPTS]
logit_tokens = torch.randint(0, cfg.vocab_size, (1, n_logit), device=dev,
                             generator=gen)
train_tokens = torch.randint(0, cfg.vocab_size, (2, 1024), device=dev,
                             generator=gen)
train_pos = torch.arange(1024, device=dev).repeat(2, 1)
slot_ids = torch.zeros(2, dtype=torch.int32, device=dev)
seq_prompts = [torch.randint(1, cfg.vocab_size, (n,), device=dev,
                             generator=gen).tolist()
               for n in s.PROC_SEQ_PROMPTS]
moe_cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=s.PROC_MOE_LAYERS)
moe_tokens = torch.randint(0, moe_cfg.vocab_size, (2, 1024), device=dev,
                           generator=gen)


def mark(what):
    out["walls"][what] = round(time.time() - t_start, 1)
    print(f"[processes rank {rank}] {what} at {out['walls'][what]} s",
          flush=True)


def free():
    gc.collect()
    torch.cuda.empty_cache()


def engine_for(params, mesh, max_seq_len=1024, **options):
    # ``params`` whole, or another engine's shard tree on ``mesh``.
    return Engine(cfg, params, EngineConfig(**{
        "decode_slots": 4, "max_seq_len": max_seq_len,
        "prefill_buckets": (16, 64, 128, 512, 1024), **options}),
        eos_id=None, dtype=torch.bfloat16, seed=0, device=dev, mesh=mesh,
        cuda_graphs=False)


def serve(engine, which=None, **options):
    # Every request submitted before start() (multihost_check.serve: both
    # loops see one queue): its result with this run's launches.
    s.reset_launches()
    res = multihost_check.serve(engine, which or prompts, s.PROC_NEW,
                                timeout_s=300, **options)
    res["launches"] = s.read_launches()
    if res["errors"]:
        raise SystemExit(f"rank {rank}: request failed: {res['errors']}")
    return res


def exact(res, what, prefilled=len(prompts)):
    # Flash once a layer a prompt prefilled, the lane kernel once a layer
    # a dispatched step.
    s.check_only(res["launches"], {
        "flash_prefill": prefilled * cfg.n_layers,
        "decode_attention": res["dispatch_steps"] * cfg.n_layers},
        f"processes rank {rank} {what}")


def lane(c, d):
    return transformer.init_decode_cache(c, 1, 1024, device=d)


def decode_logits(params, tp, after=None):
    # One 700-token prefill and the decode step after it: that step's
    # logits [V] (f32, host), and ``after(step)`` of a function that runs
    # the step again.
    with torch.no_grad():
        cache = sharding.shard_cache(lane, tp)
        logits, k, v = transformer.prefill(
            cfg, params, logit_tokens, torch.arange(n_logit, device=dev)[None])
        nxt = logits[0, -1, :cfg.vocab_size].argmax().reshape(1)
        transformer.insert_prefill(cache, k, v, 0, n_logit)
        del logits, k, v
        pos = torch.tensor([n_logit], device=dev)
        step = transformer.decode_step(cfg, params, cache, nxt, pos)[0]
        got = step[0, :cfg.vocab_size].float().cpu()
        res = None if after is None else after(
            lambda: transformer.decode_step(cfg, params, cache, nxt, pos))
    return got, res


def timed_step(step, world):
    # An eager decode step: device ms and idle share under the profiler,
    # the wall over PROC_DECODE_REPS steps started together (a barrier:
    # the ranks' profilers start apart), and across processes the
    # collectives' host ms (each call between two synchronizes, so it
    # holds no device work of its own).
    prof = s._profile(torch, f"rank {rank} eager decode step", step,
                      s.PROC_DECODE_REPS)
    row = {k: prof[k] for k in ("device_ms", "device_idle_share")}
    if world:
        dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(s.PROC_DECODE_REPS):
        step()
    torch.cuda.synchronize()
    row["wall_ms"] = (time.perf_counter() - t0) * 1e3 / s.PROC_DECODE_REPS
    if not world:
        return row
    coll = {"s": 0.0, "calls": 0}
    plain = collectives._all_reduce

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain(x, group)
        torch.cuda.synchronize()
        coll["s"] += time.perf_counter() - t0
        coll["calls"] += 1
        return y

    collectives._all_reduce = timed
    try:
        for _ in range(s.PROC_DECODE_REPS):
            step()
    finally:
        collectives._all_reduce = plain
    row["collectives_host_ms"] = coll["s"] * 1e3 / s.PROC_DECODE_REPS
    row["collective_calls_per_step"] = coll["calls"] / s.PROC_DECODE_REPS
    return row


def lora_full(c=cfg):
    g = torch.Generator(device=dev).manual_seed(s.PROC_SEED + 1)
    bufs = lora.init_lora_buffers(c, torch.bfloat16, "cuda")
    for t, (d_in, _d_out) in lora.target_dims(c).items():
        bufs[f"{t}_a"][:, 0, :, :8] = (torch.randn(
            (c.n_layers, d_in, 8), device=dev, generator=g)
            / math.sqrt(d_in)).to(torch.bfloat16)
    bufs["scale"][0] = 16.0 / 8
    return bufs


def slot0(tree):
    # Slot 0 of LoRA buffers (views), a plain tree or every shard's.
    def one(t):
        return {k: (v[:1] if k == "scale" else v[:, :1]) for k, v in t.items()}
    if isinstance(tree, sharding.Shards):
        return sharding.Shards([one(t) for t in tree], tree.tp)
    return one(tree)


def lora_steps(params, bufs, like, c=cfg, tokens=None,
               steps=s.PROC_TRAIN_STEPS, expected=None):
    # ``steps`` LoRA steps, the launches exactly ``expected`` (default:
    # flash and its backward once a layer a step).
    opt = train.make_optimizer(bufs, lr=s.TRAIN_8B_LR, weight_decay=0.0)
    step = train.make_lora_train_step(c, opt)
    tokens = train_tokens if tokens is None else tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s.reset_launches()
    losses, walls, first = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(params, bufs, opt.state, tokens, train_pos,
                           slot_ids)[2].item())
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            got = slot0(bufs)
            got = (sharding.unshard(got, like)
                   if isinstance(got, sharding.Shards) else
                   {k: v.detach().cpu() for k, v in got.items()})
            first = {k: v.float() for k, v in got.items() if k != "scale"}
    launches = s.read_launches()
    s.check_only(launches, {
        "flash_prefill": steps * c.n_layers,
        "flash_backward": steps * c.n_layers}
        if expected is None else expected,
        f"processes rank {rank} LoRA steps ({c.name})")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"rank {rank}: the loss did not fall: {losses}")
    del opt, step
    return {"losses": losses, "step_wall_ms": walls,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}, first


def ring_row(params, mesh, attention_fn=long_context.ring_attend):
    # The ring prefill of the long prompt (padded to the serve's ring
    # multiple, 1024) over ``mesh``: its last real position's logits [V]
    # (f32, host), the same on every process.
    p = seq_prompts[0]
    padded = -(-len(p) // 1024) * 1024
    tokens = torch.zeros((1, padded), dtype=torch.long, device=dev)
    tokens[0, :len(p)] = torch.tensor(p, device=dev)
    with torch.no_grad():
        logits = transformer.prefill(
            cfg, params, *long_context.shard_inputs(
                mesh, tokens, torch.arange(padded, device=dev)[None]),
            attention_fn=attention_fn)[0]
        row = long_context.logits_row(params, logits, len(p) - 1)
    return row[0, :cfg.vocab_size].float().cpu()


def faulty(fault):
    # The ring's seam with a PROC_SEQ_FAULTS fault planted.
    def attend(_s, qs, ks, vs, first=0):
        if fault == "blocks_reversed":
            return ring_attention_blocks(qs, ks[::-1], vs[::-1], first=first)
        return [ring_attention_blocks([q], ks[first + i:first + i + 1],
                                      vs[first + i:first + i + 1])[0]
                for i, q in enumerate(qs)]
    return attend


def ring_timed(params, mesh, world):
    # The ring prefill's wall, device ms and idle share under the
    # profiler (the ranks started together); then, across processes, one
    # more call with the exchange timed on the host (each gather between
    # two synchronizes) and its gathered bytes counted.  Returns the
    # sound row of that call and the numbers.
    if world:
        dist.barrier()
    prof = s._profile(torch, f"rank {rank} ring prefill of "
                      f"{len(seq_prompts[0])} tokens", lambda: ring_row(
                          params, mesh), 1)
    row = {k: prof[k] for k in ("wall_ms", "device_ms", "device_idle_share")}
    if not world:
        return ring_row(params, mesh), row
    ex = {"s": 0.0, "calls": 0, "bytes": 0}
    plain = collectives._all_gather

    def timed(x, axis, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain(x, axis, group)
        torch.cuda.synchronize()
        ex["s"] += time.perf_counter() - t0
        ex["calls"] += 1
        ex["bytes"] += y.numel() * y.element_size()
        return y

    collectives._all_gather = timed
    try:
        got = ring_row(params, mesh)
    finally:
        collectives._all_gather = plain
    row.update(exchange_host_ms=ex["s"] * 1e3, exchange_calls=ex["calls"],
               exchange_gathered_bytes=ex["bytes"])
    return got, row


def agreement(got, want, before):
    # The pipe phase's rule: where either side moved a value, the share
    # whose move has the same sign.
    rows = {}
    for k, b in want.items():
        a, b0 = got[k], before[k].float()
        moved = (a != b0) | (b != b0)
        same = ((a - b0).sign() == (b - b0).sign())[moved]
        rows[k] = same.float().mean().item() if moved.any() else 1.0
    return min(rows.values()), rows


# -- the one-process references (rank 0, views, while rank 1 waits) --------
mesh = make_mesh(MeshConfig(tensor=2), ["cuda:0"])
tp = sharding.TensorParallel(cfg, mesh)
like = {k: v.cpu() for k, v in slot0(lora_full()).items()}
before = {k: v.float() for k, v in like.items() if k != "scale"}
ref = {}
for r in range(size):
    if r == rank:
        full = transformer.init_params(cfg, seed=s.PROC_SEED, device="cuda")
        if rank == 0:
            views = Mesh(MeshConfig(tensor=2), (dev, dev))
            one = engine_for(full, views)
            res = serve(one)
            ref["tokens"], ref["serve_s"] = res["tokens"], res["wall_s"]
            ref["logits"], ref["step"] = decode_logits(
                one.params, one.tp, lambda step: timed_step(step, False))
            del one
            free()
            bufs = lora_full()
            ref["lora"], ref["first"] = lora_steps(full, bufs, like)
            del bufs
            free()
            views = Mesh(MeshConfig(sequence=2), (dev, dev))
            one = engine_for(full, views, s.PROC_SEQ_MAX_LEN)
            res = serve(one, seq_prompts)
            ref["seq_tokens"], ref["seq_serve_s"] = (res["tokens"],
                                                     res["wall_s"])
            ref["seq_row"], ref["seq_ring"] = ring_timed(one.params, views,
                                                         False)
            del one
            free()
            mark("references")
        engine = engine_for(full, mesh)
        wo = full["layers"]["wo"]
        other_wo = wo[mid, (1 - rank) * half:(2 - rank) * half].clone()
        del full, wo
        free()
        mark("tensor=2 shards")
    dist.barrier()

# -- tensor=2 across the two processes ---------------------------------------
res = serve(engine)
exact(res, "serve")
out["tokens"], out["serve_s"] = res["tokens"], res["wall_s"]
out["serve_launches"], out["decode_steps"] = (res["launches"],
                                              res["dispatch_steps"])
mark("serve")
params = engine.params
del engine
free()

# -- the same prompts through the pipelined loop and the planner, then the
# TTL sweep with rank 1's clock frozen, over the same shard tree ----------
both = dict(pipeline_decode=True, adaptive_steps=s.PROC_ADAPTIVE)
res = serve(engine_for(params, mesh, **both))
exact(res, "pipelined serve")
if res["tokens"] != out["tokens"]:
    raise SystemExit(f"rank {rank}: the pipelined loop read back "
                     f"{res['tokens']}, the sync loop {out['tokens']}")
if sum(1 for n in res["dispatch_counts"] if n) < 2:
    raise SystemExit(f"rank {rank}: one block size only: "
                     f"{res['dispatch_counts']}")
out["pipelined"] = res
mark("pipelined serve")
# The sync loop again, warm, beside the pipelined run (the first serve
# above pays each process's first collectives and allocations).
res = serve(engine_for(params, mesh))
exact(res, "warm sync serve")
if res["tokens"] != out["tokens"]:
    raise SystemExit(f"rank {rank}: the warm sync serve read back "
                     f"{res['tokens']}, the first {out['tokens']}")
out["sync_warm"] = res
mark("warm sync serve")
handoff = multihost_check.seeded_handoff(
    cfg, s.PROC_HANDOFF_TOKENS, s.PROC_SEED, s.PROC_NEW, torch.bfloat16)
res = serve(engine_for(params, mesh, decode_slots=len(prompts),
                       handoff_ttl_s=s.PROC_TTL_S, **both),
            handoff=handoff, freeze_clock=rank == 1)
# The handoff is released before a slot frees: no prefill, no decode row.
exact(res, "TTL serve")
out["ttl"] = res
mark("ttl serve")
free()


def planted(fault):
    tree = params[0]
    new = tree["layers"]["wo"].clone()
    if fault == "partial_dropped":
        if rank == 1:
            new[mid].zero_()
    else:
        new[mid] = other_wo
    return sharding.Shards([dict(tree, layers=dict(tree["layers"], wo=new))],
                           params.tp)


s.reset_launches()
logits, _ = decode_logits(params, tp)
s.check_only(s.read_launches(), {"flash_prefill": cfg.n_layers,
                                 "decode_attention": cfg.n_layers},
             f"processes rank {rank} logits")
fault_logits = {}
for fault in s.PROC_FAULTS:
    fault_logits[fault], _ = decode_logits(planted(fault), tp)
    free()
# The same logits on both ranks (rank 0's sent to rank 1).
theirs = logits.clone()
dist.broadcast(theirs, 0)
out["logits_equal_across_ranks"] = bool(torch.equal(theirs, logits))
_, out["step"] = decode_logits(params, tp,
                               lambda step: timed_step(step, True))
mark("logits")
if rank == 0:
    out["logits"] = {"sound": s._share(logits, ref["logits"]),
                     **{f: s._share(g, ref["logits"])
                        for f, g in fault_logits.items()}}
    out["ref_step"] = ref["step"]
    out["ref_tokens"], out["ref_serve_s"] = ref["tokens"], ref["serve_s"]
    out["ref_lora"] = ref["lora"]

# -- the LoRA step at tensor=2, then at data=2 --------------------------------
out["lora"] = {}
for axes in ("tensor=2", "data=2"):
    if axes == "data=2":
        del params
        free()
        mesh = make_mesh(MeshConfig(data=2), ["cuda:0"])
        tp = sharding.TensorParallel(cfg, mesh)
        for r in range(size):
            if r == rank:
                full = transformer.init_params(cfg, seed=s.PROC_SEED,
                                               device="cuda")
                params = sharding.shard_params(full, tp)
                del full
                free()
            dist.barrier()
    bufs = sharding.shard_lora(lora_full(), tp)
    free()
    res, first = lora_steps(params, bufs, like)
    if rank == 0:
        res["first_loss_rel_err"] = abs(
            res["losses"][0] - ref["lora"]["losses"][0]) / abs(
            ref["lora"]["losses"][0])
        res["first_update_agree"], _ = agreement(first, ref["first"], before)
        res["ref_first_loss"] = ref["lora"]["losses"][0]
    out["lora"][axes] = res
    del bufs
    free()
    mark(f"lora {axes}")

# -- sequence=2 across the two processes: the ring served, then trained -----
seq_mesh = make_mesh(MeshConfig(sequence=2), ["cuda:0"])
for r in range(size):
    if r == rank:  # the data=2 tree is this process's whole tree
        engine = engine_for(params[0], seq_mesh, s.PROC_SEQ_MAX_LEN)
        del params
        free()
    dist.barrier()
res = serve(engine, seq_prompts)
# The ring runs no kernel of the port (its block products are torch ops);
# the two bucketed prompts run flash, decode the lane kernel.
exact(res, "sequence=2 serve", len(seq_prompts) - 1)
if res["paths"]["ring"] != 1:
    raise SystemExit(f"rank {rank}: {res['paths']['ring']} ring programs "
                     "for one long prompt")
out["seq_tokens"], out["seq_serve_s"] = res["tokens"], res["wall_s"]
out["seq_serve_launches"], out["seq_decode_steps"] = (res["launches"],
                                                      res["dispatch_steps"])
out["seq_ring_programs"] = res["paths"]["ring"]
mark("sequence=2 serve")
params, tp = engine.params, engine.tp
del engine
free()
row, out["seq_ring"] = ring_timed(params, seq_mesh, True)
fault_rows = {f: ring_row(params, seq_mesh, faulty(f))
              for f in s.PROC_SEQ_FAULTS}
if rank == 0:
    out["seq_logits"] = {"sound": s._share(row, ref["seq_row"]),
                         **{f: s._share(g, ref["seq_row"])
                            for f, g in fault_rows.items()}}
    out["ref_seq_tokens"], out["ref_seq_ring"] = (ref["seq_tokens"],
                                                  ref["seq_ring"])
    out["ref_seq_serve_s"] = ref["seq_serve_s"]
mark("sequence=2 ring")
bufs = sharding.shard_lora(lora_full(), tp)
free()
# The sequence route's attention is the ring (torch ops): no flash, no
# backward kernel.
res, first = lora_steps(params, bufs, like, steps=s.PROC_SEQ_TRAIN_STEPS,
                        expected={})
if rank == 0:
    res["first_loss_rel_err"] = abs(
        res["losses"][0] - ref["lora"]["losses"][0]) / abs(
        ref["lora"]["losses"][0])
    res["first_update_agree"], _ = agreement(first, ref["first"], before)
    res["ref_first_loss"] = ref["lora"]["losses"][0]
out["lora"]["sequence=2"] = res
del bufs, params
free()
mark("lora sequence=2")

# -- expert=2 across the two processes: LoRA steps at Mixtral's widths ------
moe_mesh = make_mesh(MeshConfig(expert=2), ["cuda:0"])
moe_tp = sharding.TensorParallel(moe_cfg, moe_mesh)
moe_like = {k: v.cpu() for k, v in slot0(lora_full(moe_cfg)).items()}
moe_before = {k: v.float() for k, v in moe_like.items() if k != "scale"}
for r in range(size):
    if r == rank:
        full = transformer.init_params(moe_cfg, seed=s.PROC_SEED + 2,
                                       device="cuda")
        if rank == 0:  # the one-process (unsharded) reference
            bufs = lora_full(moe_cfg)
            ref["moe"], ref["moe_first"] = lora_steps(
                full, bufs, moe_like, moe_cfg, moe_tokens,
                s.PROC_MOE_TRAIN_STEPS)
            del bufs
            free()
        params = sharding.shard_params(full, moe_tp)
        del full
        free()
    dist.barrier()
bufs = sharding.shard_lora(lora_full(moe_cfg), moe_tp)
res, first = lora_steps(params, bufs, moe_like, moe_cfg, moe_tokens,
                        s.PROC_MOE_TRAIN_STEPS)
if rank == 0:
    res["first_loss_rel_err"] = abs(
        res["losses"][0] - ref["moe"]["losses"][0]) / abs(
        ref["moe"]["losses"][0])
    res["first_update_agree"], _ = agreement(first, ref["moe_first"],
                                             moe_before)
    res["ref_first_loss"] = ref["moe"]["losses"][0]
    out["ref_moe_lora"] = ref["moe"]
out["lora"]["expert=2"] = res
del bufs, params
free()
mark("lora expert=2")
print("[processes-result] " + json.dumps(out), flush=True)
"""


def phase_processes(torch) -> dict:
    """Phase 19: the port across two processes on cuda:0
    (``parallel/multihost_check.run_two_process``, gloo between them, each
    holding its shard of Llama-3-8B at full width and ``PROC_LAYERS`` of
    its layers, built one process after the other with the seeded tree
    freed).  ``--mesh
    tensor=2`` served eagerly with every request submitted before
    ``start()``: both processes' greedy tokens identical, counted against
    the one-process tensor=2 engine's (views, reported), exact launches
    per process; the same prompts through the pipelined loop with the
    adaptive planner (PROC_ADAPTIVE) over the same shard tree, token for
    token the sync loop's, launches exact against the dispatched steps,
    more than one block size, then the sync loop again (warm, the wall
    to set beside the pipelined one); a seeded handoff parked behind them with
    every slot busy past PROC_TTL_S, rank 1's engine clock frozen: both
    ranks release it (``kv_release`` says ``ttl``) through the first
    process's broadcast verdict, with the same tokens for the rest, its
    wire bytes the same by hash; the decode step after a 700-token
    prefill, its logits on
    both ranks bitwise equal and within MESH_LOGIT_TOL of one process's,
    with PROC_FAULTS planted each beyond it; an eager decode step's wall,
    device ms and collectives' host ms beside one process's.  The 8B LoRA
    step (rank 8, two 1024-token rows) at tensor=2 and then at data=2:
    PROC_TRAIN_STEPS steps with the loss falling, the first step's loss
    and slot against the one-process (unsharded) step (PIPE_LOSS_TOL,
    PIPE_AGREE), exact flash and backward launches, step walls and peak
    memory per process.  ``--mesh sequence=2`` across the two processes
    (each a whole 8B tree and its own lane cache, 8192-token context):
    the 6001-token prompt in one ring program a process (its K/V
    exchanged over gloo), two bucketed prompts, both ranks' greedy tokens
    identical, counted against the one-process sequence=2 engine's; the
    ring's last-token logits within MESH_LOGIT_TOL of one process's ring,
    PROC_SEQ_FAULTS planted each beyond it; the ring's wall, device ms,
    and the exchange's host ms and bytes per rank beside one process's.
    Two LoRA steps at sequence=2 (512 positions a process; the ring's
    attention launches no kernel, checked exactly) and two at expert=2 on
    Mixtral-8x7B's widths cut to PROC_MOE_LAYERS layers, each against
    the one-process step under the same rules."""
    from llm_instance_gateway_tpu_torch.parallel import multihost_check

    t0 = time.time()
    torch.cuda.empty_cache()
    outs = multihost_check.run_two_process(PROC_WORKER, n_local=1,
                                           timeout_s=PROC_TIMEOUT_S)
    os.makedirs(os.path.join(REPO, "build", "smoke"), exist_ok=True)
    for rank, text in enumerate(outs):
        with open(os.path.join(REPO, "build", "smoke",
                               f"processes_rank{rank}.log"), "w") as f:
            f.write(text)
    res = [json.loads(line.split(" ", 1)[1])
           for line in multihost_check.ok_lines(outs, "[processes-result] ")]
    r0, r1 = res
    if r0["tokens"] != r1["tokens"]:
        raise AssertionError("processes: the ranks read back different "
                             f"tokens: {r0['tokens']} / {r1['tokens']}")
    if not r1["logits_equal_across_ranks"]:
        raise AssertionError("processes: the ranks' logits differ")
    _gate("processes", {"sound": r0["logits"]["sound"]},
          {f: {"decode_step": r0["logits"][f]} for f in PROC_FAULTS})
    differ = sum(int(a != b) for got, want in zip(r0["tokens"],
                                                  r0["ref_tokens"])
                 for a, b in zip(got, want))
    if r0["seq_tokens"] != r1["seq_tokens"]:
        raise AssertionError("processes sequence=2: the ranks read back "
                             f"different tokens: {r0['seq_tokens']} / "
                             f"{r1['seq_tokens']}")
    if [r["seq_ring_programs"] for r in res] != [1, 1]:
        raise AssertionError("processes sequence=2: ring programs per rank "
                             f"{[r['seq_ring_programs'] for r in res]}")
    _gate("processes sequence=2", {"ring_last": r0["seq_logits"]["sound"]},
          {f: {"ring_last": r0["seq_logits"][f]} for f in PROC_SEQ_FAULTS})
    seq_differ = sum(int(a != b) for got, want in zip(r0["seq_tokens"],
                                                      r0["ref_seq_tokens"])
                     for a, b in zip(got, want))
    # Lockstep beyond the sync loop (each worker held its pipelined
    # tokens to its sync ones and its launches to its dispatched steps).
    if r0["pipelined"]["tokens"] != r1["pipelined"]["tokens"]:
        raise AssertionError("processes pipelined: the ranks read back "
                             "different tokens")
    ttl = [r["ttl"] for r in res]
    for key in ("tokens", "finish", "handoff_sha256", "dispatch_steps",
                "broadcasts", "ledger_sweeps"):
        if ttl[0][key] != ttl[1][key]:
            raise AssertionError(f"processes TTL: the ranks' {key} differ: "
                                 f"{ttl[0][key]} / {ttl[1][key]}")
    for rank, t in enumerate(ttl):
        if (t["finish"][-1] != "cancelled" or t["broadcasts"] < 1
                or [e["reason"] for e in t["kv_release"]] != ["ttl"]):
            raise AssertionError(f"processes TTL: rank {rank} did not "
                                 f"release the parked handoff: {t}")
    for axes, row in r0["lora"].items():
        if not row["first_loss_rel_err"] <= PIPE_LOSS_TOL:
            raise AssertionError(f"processes LoRA {axes}: first loss "
                                 f"{row['losses'][0]} against one process's "
                                 f"{row['ref_first_loss']}")
        if not row["first_update_agree"] >= PIPE_AGREE:
            raise AssertionError(f"processes LoRA {axes}: slot updated apart "
                                 f"from one process's: {row}")
    launches: dict = {}
    for r in res:
        for part in ([r["serve_launches"], r["seq_serve_launches"],
                      r["pipelined"]["launches"], r["sync_warm"]["launches"],
                      r["ttl"]["launches"]]
                     + [row["launches"] for row in r["lora"].values()]):
            for name, n in part.items():
                launches[name] = launches.get(name, 0) + n
    out = {"wall_s": time.time() - t0, "tokens_differing": {
        "differ": differ, "of": sum(map(len, r0["tokens"]))},
        "serve_s": [r["serve_s"] for r in res],
        "one_process_serve_s": r0["ref_serve_s"],
        "decode_steps": r0["decode_steps"], "logits": r0["logits"],
        "eager_step": {"one_process": r0["ref_step"],
                       "rank0": r0["step"], "rank1": r1["step"]},
        "lora": {axes: [r["lora"][axes] for r in res]
                 for axes in r0["lora"]},
        "one_process_lora": r0["ref_lora"], "launches": launches,
        "sequence": {
            "tokens_differing": {"differ": seq_differ,
                                 "of": sum(map(len, r0["seq_tokens"]))},
            "serve_s": [r["seq_serve_s"] for r in res],
            "one_process_serve_s": r0["ref_seq_serve_s"],
            "decode_steps": r0["seq_decode_steps"],
            "logits": r0["seq_logits"],
            "ring": {"one_process": r0["ref_seq_ring"],
                     "rank0": r0["seq_ring"], "rank1": r1["seq_ring"]}},
        "one_process_moe_lora": r0["ref_moe_lora"],
        "lockstep": {
            "walls": {"sync_serve_s": [r["serve_s"] for r in res],
                      "pipelined_serve_s": [r["pipelined"]["wall_s"]
                                            for r in res],
                      "warm_sync_serve_s": [r["sync_warm"]["wall_s"]
                                            for r in res],
                      "ttl_serve_s": [t["wall_s"] for t in ttl]},
            "decode_steps": {"sync": r0["decode_steps"],
                             "pipelined": r0["pipelined"]["dispatch_steps"],
                             "warm_sync": r0["sync_warm"]["dispatch_steps"],
                             "ttl": ttl[0]["dispatch_steps"]},
            "dispatch_counts": r0["pipelined"]["dispatch_counts"],
            "launches": {"pipelined": [r["pipelined"]["launches"]
                                       for r in res],
                         "warm_sync": [r["sync_warm"]["launches"]
                                       for r in res],
                         "ttl": [t["launches"] for t in ttl]},
            "ttl": {"finish": ttl[0]["finish"],
                    "broadcasts": ttl[0]["broadcasts"],
                    "ledger_sweeps": ttl[0]["ledger_sweeps"],
                    "handoff_sha256": ttl[0]["handoff_sha256"]}},
        "worker_walls": [r["walls"] for r in res]}
    log("processes", f"greedy tokens differing from one process: {differ} "
        f"of {out['tokens_differing']['of']} (bf16; reported, not gated)")
    log("processes", "sequence=2 greedy tokens differing from one "
        f"process's sequence=2 engine: {seq_differ} of "
        f"{out['sequence']['tokens_differing']['of']} (bf16; reported)")
    log("processes", "phase " + json.dumps(out))
    return out


# -- phase 20: the pipelined trainer with a stage a process ------------------

# Two processes share cuda:0 (gloo), stage i in process i: phase 18's
# seeded 8-layer tree and batch (PIPE_LAYERS, PIPE_M rows of PIPE_S
# tokens), each process building its stage in turn.  Gated against phase
# 18's one-process pipelined step: the first loss (PIPE_LOSS_TOL), the
# first update on phase 18's picks (PIPE_AGREE, its sign rule) and
# exactly PIPE_LAYERS / 2 x PIPE_M launches of flash and of the flash
# backward per step in each process.  The planted fault (the gate must
# fail it): stage 1 takes the microbatches it receives in swapped order.
PIPE_PROC_TIMEOUT_S = 300
PIPE_PROC_FAULT = "microbatches_swapped"

PIPE_PROC_WORKER = r"""
import dataclasses, gc, json, os, sys, time
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
import torch.distributed as dist
import chip_smoke as s
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
from llm_instance_gateway_tpu_torch.parallel import collectives, pipeline
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    MeshConfig, initialize_distributed, make_mesh, world)
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, size = world()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
t_start = time.time()
cfg = dataclasses.replace(LLAMA3_8B, n_layers=s.PIPE_LAYERS)
per_stage = s.PIPE_LAYERS // 2
out = {"rank": rank, "stage": rank, "walls": {}}


def mark(what):
    out["walls"][what] = round(time.time() - t_start, 1)
    print(f"[pipe processes rank {rank}] {what} at {out['walls'][what]} s",
          flush=True)


def free():
    gc.collect()
    torch.cuda.empty_cache()


gen = torch.Generator(device=dev).manual_seed(81)
tokens = torch.randint(0, cfg.vocab_size, (s.PIPE_M, s.PIPE_S), device=dev,
                       generator=gen)
positions = torch.arange(s.PIPE_S, device=dev)[None].expand(s.PIPE_M,
                                                            s.PIPE_S)
mesh = make_mesh(MeshConfig(pipe=2), ["cuda:0"])
for r in range(size):
    if r == rank:
        full = transformer.init_params(cfg, seed=22, device="cuda")
        tree = pipeline.stage_param_specs(
            cfg, pipeline.stage_params(cfg, full, 2), mesh)
        del full
        free()
    dist.barrier()
mark("stage built")
layers = tree["stages"][rank][0]["layers"]


def picks():
    # Phase 18's picks that this stage holds.
    got = {"embed": tree["embed"]} if rank == 0 else {
        "lm_head": tree["lm_head"]}
    at, layer = (0, 0) if rank == 0 else (-1, s.PIPE_LAYERS - 1)
    for name in ("wq", "wo", "w_down"):
        got[f"{name}[{layer}]"] = layers[name][at]
    return {k: v.detach().clone() for k, v in got.items()}


ref = torch.load(os.path.join(s.REPO, "build", "smoke", "pipe_reference.pt"),
                 mmap=True)
mine = sorted(picks())


def gate(loss, before, after):
    # The first loss and update against phase 18's one-process step,
    # counted over row blocks of each pick: a boolean index of a whole
    # lm_head or embed pick builds an 8 GB index tensor, which two stage
    # processes and the smoke's own share of the card may not leave free.
    row = {"loss": loss,
           "loss_rel_err": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "loss_bitwise_equal": loss == ref["loss"], "picks": {}}
    for k in mine:
        n = {"moved": 0, "same_bits": 0, "same_sign": 0}
        rows = max(1, 2 ** 26 // max(1, after[k][0].numel()))
        for i in range(0, after[k].shape[0], rows):
            b0 = ref["before"][k][i:i + rows].to(dev)
            if not torch.equal(before[k][i:i + rows], b0):
                raise SystemExit(f"rank {rank}: {k} starts apart from "
                                 "phase 18")
            a, b = after[k][i:i + rows], ref["after"][k][i:i + rows].to(dev)
            moved = (a != b0) | (b != b0)
            same = ((a.float() - b0.float()).sign()
                    == (b.float() - b0.float()).sign())
            n["moved"] += moved.sum().item()
            n["same_bits"] += ((a == b) & moved).sum().item()
            n["same_sign"] += (same & moved).sum().item()
            del b0, a, b, moved, same
        m = n["moved"] or float("nan")
        row["picks"][k] = {
            "moved": n["moved"] / after[k].numel(),
            "same_bits_where_moved": n["same_bits"] / m,
            "same_sign_where_moved": n["same_sign"] / m}
    row["agree"] = min(r["same_sign_where_moved"]
                       for r in row["picks"].values())
    return row


leaves = train._leaves(tree)
start = [t.detach().clone() for t in leaves]
before = picks()
opt = train.make_optimizer(tree, lr=s.PIPE_LR)
step = pipeline.make_pipeline_train_step(cfg, opt, 2, s.PIPE_M, mesh)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
expected = {"flash_prefill": per_stage * s.PIPE_M,
            "flash_backward": per_stage * s.PIPE_M}
losses, walls, launches = [], [], []
bound = {"send_host_ms": 0.0, "recv_host_ms": 0.0, "bytes_sent": 0,
         "bytes_received": 0, "sends": 0, "receives": 0}
plain_send, plain_recv = collectives.send, collectives.recv


def timed_send(x, peer, group):
    # Each transfer between two synchronizes: the host time of the
    # transfer, not of the compute that made its input.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = plain_send(x, peer, group)
    bound["send_host_ms"] += (time.perf_counter() - t0) * 1e3
    bound["bytes_sent"] += x.numel() * x.element_size()
    bound["sends"] += 1
    return got


def timed_recv(shape, dtype, device, peer, group):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = plain_recv(shape, dtype, device, peer, group)
    torch.cuda.synchronize()
    bound["recv_host_ms"] += (time.perf_counter() - t0) * 1e3
    bound["bytes_received"] += got.numel() * got.element_size()
    bound["receives"] += 1
    return got


for i in range(2):
    if i == 1:  # the boundary timed on the host (its wall reads the syncs)
        collectives.send, collectives.recv = timed_send, timed_recv
    s.reset_launches()
    dist.barrier()
    t0 = time.time()
    loss = step(tree, None, tokens, positions)[2].item()
    walls.append(time.time() - t0)
    collectives.send, collectives.recv = plain_send, plain_recv
    losses.append(loss)
    launches.append(s.read_launches())
    s.check_only(launches[-1], expected, f"pipe processes rank {rank} step")
    if i == 0:
        out["gate"] = gate(loss, before, picks())
        mark("first step")
# Two more steps: one untimed, the fourth under the profiler.
s.reset_launches()
dist.barrier()
out["profiled_step"] = s._profile(torch, f"rank {rank} pipe stage step",
                                  lambda: step(tree, None, tokens,
                                               positions), 1)
launches.append(s.read_launches())
s.check_only(launches[-1], {k: 2 * n for k, n in expected.items()},
             f"pipe processes rank {rank} profiled steps")
out.update(losses=losses, step_wall_s=walls, boundary=bound,
           launches={k: sum(x[k] for x in launches) for k in launches[0]},
           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
mark("sound steps")
# The planted fault, from the same start: stage 1 takes the two
# microbatches it receives in swapped order.
del opt, step
free()
with torch.no_grad():
    for t, x in zip(leaves, start):
        t.copy_(x)
del start
free()
Link = pipeline._Link


class Swapped(Link):
    def recv_act(self, j, shape, dtype, device):
        if j == 0:
            self.held = Link.recv_act(self, 0, shape, dtype, device)
            return Link.recv_act(self, 1, shape, dtype, device)
        return self.held


pipeline._Link = Swapped
opt = train.make_optimizer(tree, lr=s.PIPE_LR)
loss = pipeline.make_pipeline_train_step(cfg, opt, 2, s.PIPE_M, mesh)(
    tree, None, tokens, positions)[2].item()
pipeline._Link = Link
out["fault"] = gate(loss, before, picks())
mark("fault")
print("[pipe-processes-result] " + json.dumps(out), flush=True)
"""


def phase_pipe_processes(torch, reference: dict) -> dict:
    """Phase 20: the pipelined full-parameter step with each stage in a
    process of its own (``parallel/pipeline.py`` across processes: two
    processes on cuda:0 over gloo, the activations and their gradients
    sent point to point), on phase 18's seeded 8-layer Llama-3-8B tree
    and batch.  Four steps (the fourth profiled per process), each
    launching flash and the flash backward exactly PIPE_LAYERS / 2 x
    PIPE_M times in each process; the first loss and update against phase
    18's one-process pipelined step (``reference``: its first loss and
    picks, on the host; PIPE_LOSS_TOL, PIPE_AGREE), and the planted
    PIPE_PROC_FAULT beyond that gate.  Per process: step walls, the
    boundary's send/recv host ms and bytes, peak memory."""
    from llm_instance_gateway_tpu_torch.parallel import multihost_check

    t0 = time.time()
    smoke = os.path.join(REPO, "build", "smoke")
    os.makedirs(smoke, exist_ok=True)
    path = os.path.join(smoke, "pipe_reference.pt")
    torch.save(reference, path)
    torch.cuda.empty_cache()
    log("pipe processes", "this process before the stages: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    try:
        outs = multihost_check.run_two_process(
            PIPE_PROC_WORKER, n_local=1, timeout_s=PIPE_PROC_TIMEOUT_S)
    finally:
        os.remove(path)
    for rank, text in enumerate(outs):
        with open(os.path.join(smoke, f"pipe_processes_rank{rank}.log"),
                  "w") as f:
            f.write(text)
    res = [json.loads(line.split(" ", 1)[1]) for line in
           multihost_check.ok_lines(outs, "[pipe-processes-result] ")]

    def passes(row) -> bool:
        return (math.isfinite(row["loss_rel_err"])
                and row["loss_rel_err"] <= PIPE_LOSS_TOL
                and row["agree"] >= PIPE_AGREE)

    if len({r["gate"]["loss"] for r in res}) != 1:
        raise AssertionError("pipe processes: the stages report different "
                             f"losses: {[r['gate']['loss'] for r in res]}")
    for r in res:
        if not passes(r["gate"]):
            raise AssertionError(f"pipe processes: stage {r['stage']} apart "
                                 f"from phase 18's step: {r['gate']}")
    if all(passes(r["fault"]) for r in res):
        raise AssertionError(f"pipe processes: the planted {PIPE_PROC_FAULT} "
                             "passed the gate: "
                             f"{[r['fault'] for r in res]}")
    launches: dict = {}
    for r in res:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out = {"wall_s": time.time() - t0, "reference_loss": reference["loss"],
           "launches": launches, "fault": PIPE_PROC_FAULT,
           "stages": [{k: r[k] for k in ("stage", "gate", "fault", "losses",
                                         "step_wall_s", "boundary",
                                         "profiled_step", "peak_mem_gb",
                                         "launches", "walls")}
                      for r in res]}
    log("pipe processes", "phase " + json.dumps(out))
    return out


# -- phase 21: head layouts the reference's kernels do not split -------------

# Qwen2.5-7B at tensor=8, every shard on cuda:0: the head plan's 4:1 a
# shard (``ops/sharded_attention.head_plan``: each KV head on two shards,
# each group of 7 query heads padded with a zero head to 8).
LAYOUT_T = 8
LAYOUT_DEVICES = ["cuda:0"] * LAYOUT_T
LAYOUT_FLAGS = ["--mesh", f"tensor={LAYOUT_T}"]
# Faults planted in the tensor=8 tree, each of which the logits check
# (MESH_LOGIT_TOL) must fail: every zero query head's ``wo`` rows set to
# its shard's first real head's rows in every layer (padding that leaks
# into the output), and shard 1's query heads attending KV head 1 instead
# of its group's head 0 (a plan that maps a shard to the wrong KV head).
LAYOUT_FAULTS = ("padded_wo", "wrong_kv")


def _paged_quant_row_at(torch, label: str, h: int, k: int, hd: int,
                        seed: int) -> dict:
    """The int8 paged kernel at one layout (8 rows, 64-token blocks, 16
    of them a row, shuffled tables, ragged lengths up to 1024) against
    its plain version (``check_kernel``'s limits); a length-0 row gives
    zeros.  A row of the kernels line (errors only)."""
    from llm_instance_gateway_tpu_torch.ops import paged_decode_attention as pd

    dev, b, page, m = torch.device("cuda"), 8, 64, 16
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = [0, 1, 777, 1024, 5, 300, 512, 1000]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, hd, device=dev, generator=gen).to(torch.bfloat16)
    kq, ks = _int8_kv(torch, gen, (b * m + 1, page, k, hd))
    vq, vs = _int8_kv(torch, gen, (b * m + 1, page, k, hd))
    perm = torch.randperm(b * m, generator=torch.Generator().manual_seed(seed))
    tables = (perm + 1).reshape(b, m).to(torch.int32).to(dev)
    args = (q, kq, vq, tables, lengths, ks, vs)
    got = pd.paged_decode_attention(*args)
    layout = f"{label}: H={h} K={k} hd={hd}"
    row = dict(shape=f"{layout}, B={b} P={page} M={m}, int8 pools + f32 "
               f"scale pools, lengths={lens}", **check_kernel(
                   f"paged decode int8 {layout}", got,
                   pd.paged_decode_attention_quant_reference(*args)))
    if got[0].abs().max().item() != 0.0:
        raise AssertionError(f"paged decode int8 {layout}: a length-0 row "
                             "must give zeros")
    return row


def _layout_kernel_rows(torch) -> dict:
    """Flash and the bf16 lane kernel (``_kernel_rows_at``) and the int8
    paged kernel at one shard of Qwen2.5-7B at tensor=8 (4:1 at hd 128)."""
    label = f"qwen2.5-7b tensor={LAYOUT_T} shard"
    rows = _kernel_rows_at(torch, [(label, 4, 1, 128, 8, False)], "layouts",
                           2121)
    row = _paged_quant_row_at(torch, label, 4, 1, 128, 2122)
    log("layouts", "paged_decode_attention_quant " + json.dumps(row))
    rows["paged_decode_attention_quant"] = [row]
    return rows


def _layout_tree(torch, params, tp, fault=None):
    """(Qwen2.5-7B's tree at tensor=8, its grid), sound or with ``fault``
    (``LAYOUT_FAULTS``) planted: new ``wo`` leaves for ``padded_wo`` (the
    tree served stays as it is), a grid whose plan gives shard 1 KV head 1
    for ``wrong_kv``."""
    import copy
    import dataclasses

    from llm_instance_gateway_tpu_torch.parallel import sharding

    if fault == "wrong_kv":
        kv = list(tp.plan.kv_heads)
        kv[1] = (kv[1][0] + 1,)
        tp = copy.copy(tp)
        tp.plan = dataclasses.replace(tp.plan, kv_heads=tuple(kv))
    sharded = sharding.shard_params(params, tp)
    if fault != "padded_wo":
        return sharded, tp
    hd, trees = tp.hd, []
    for s, tree in enumerate(sharded):
        heads = tp.plan.q_heads[s]
        if min(heads) >= 0:
            trees.append(tree)
            continue
        wo = tree["layers"]["wo"].clone()
        for j, h in enumerate(heads):
            if h < 0:
                wo[:, j * hd:(j + 1) * hd] = wo[:, :hd]
        trees.append(dict(tree, layers=dict(tree["layers"], wo=wo)))
    return sharding.Shards(trees, tp), tp


def _layout_logits(torch, params) -> dict:
    """One Qwen2.5-7B prefill (700 seeded tokens) and the decode step
    after it at tensor=1 and at tensor=8 on one card, eager: the logits
    of both against each other under MESH_LOGIT_TOL, each planted fault
    (``LAYOUT_FAULTS``) beyond it; the prompt's K/V too (reported)."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import QWEN2_5_7B
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cfg, dev, n = QWEN2_5_7B, torch.device("cuda"), 700
    tp = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(tensor=LAYOUT_T), LAYOUT_DEVICES))
    gen = torch.Generator(device=dev).manual_seed(78)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                           generator=gen)
    positions = torch.arange(n, device=dev)[None]

    def lane(c, d):
        return transformer.init_decode_cache(c, 1, 1024, device=d)

    out, nxt = {}, None
    with torch.no_grad():
        for run in ("tensor1", "sound") + LAYOUT_FAULTS:
            if run == "tensor1":
                p, cache = params, lane(cfg, dev)
            else:
                p, grid = _layout_tree(torch, params, tp,
                                       None if run == "sound" else run)
                cache = sharding.shard_cache(lane, grid)
            logits, k, v = transformer.prefill(cfg, p, tokens, positions)
            last = logits[0, -1, :cfg.vocab_size].float()
            if nxt is None:
                nxt = last.argmax().reshape(1)
            transformer.insert_prefill(cache, k, v, 0, n)
            step, _ = transformer.decode_step(
                cfg, p, cache, nxt, torch.tensor([n], device=dev))
            out[run] = (last, step[0, :cfg.vocab_size].float(), k.float())
            del cache, k, v, p

    def compare(run) -> dict:
        return {name: _share(out[run][i], out["tensor1"][i])
                for name, i in (("prefill_last", 0), ("decode_step", 1))}

    sound = compare("sound")
    faults = {f: compare(f) for f in LAYOUT_FAULTS}
    _gate("layouts", sound, faults)
    res = dict(sound, planted_faults=faults,
               prefill_kv_max_abs_err=(out["sound"][2]
                                       - out["tensor1"][2]).abs().max().item(),
               prefill_kv_max_abs=out["tensor1"][2].abs().max().item(),
               plan=tp.layout)
    log("layouts", f"logits tensor={LAYOUT_T} vs tensor=1 (bf16, tolerance "
        f"{MESH_LOGIT_TOL} of the largest |logit|; planted faults in every "
        "layer): " + json.dumps(res))
    return res


def _layout_bytes(engine, params) -> dict:
    """What the plan costs on the card: the bytes of the sharded weights
    that are copies rather than views of the served tree (each shard with
    a zero head holds its head leaves as a copy), the zero heads' share of
    them, and the KV cache's bytes beside an unsharded cache's (the shards
    of a KV head share one cache on one card)."""
    from llm_instance_gateway_tpu_torch.parallel import sharding

    def tensors(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in tensors(v)]
        return [tree]

    own = {t.untyped_storage().data_ptr() for t in tensors(params)}
    seen, copied = set(), 0
    for tree in sharding.parts(engine.params):
        for t in tensors(tree):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in own and ptr not in seen:
                seen.add(ptr)
                copied += t.untyped_storage().nbytes()
    tp, cfg = engine.tp, engine.model_cfg
    hd, el = tp.hd, params["layers"]["wq"].element_size()
    zero_q = sum(h < 0 for heads in tp.plan.q_heads for h in heads)
    zero_kv = sum(h < 0 for heads in tp.plan.kv_heads for h in heads)
    per_q = cfg.n_layers * hd * (2 * cfg.d_model
                                 + (1 if cfg.attention_bias else 0)) * el
    per_kv = cfg.n_layers * hd * 2 * (cfg.d_model
                                      + (1 if cfg.attention_bias else 0)) * el
    caches = sharding.distinct(sharding.parts(engine.cache))
    cache_bytes = sum(x.untyped_storage().nbytes() for c in caches
                      for name, x in c.items()
                      if name not in ("tables", "length"))
    local_kv = tp.cfg.n_kv_heads
    return {"weights_copied_gb": copied / 1e9,
            "zero_heads_gb": (zero_q * per_q + zero_kv * per_kv) / 1e9,
            "zero_query_heads": zero_q, "zero_kv_heads": zero_kv,
            "kv_cache_gb": cache_bytes / 1e9,
            "kv_cache_unsharded_gb": (cache_bytes * cfg.n_kv_heads
                                      / (len(caches) * local_kv)) / 1e9,
            "distinct_caches": len(caches)}


# -- phase 22: training on that layout -----------------------------------

# Qwen2.5-7B's tree at tensor=8 on cuda:0: LoRA steps at full width and
# depth (phase 15's batch shape: two seeded 1024-token rows, slot 0 at
# rank 8, b zero), and full-parameter steps at its widths cut to 2 layers
# (its AdamW state beside the 7B tree's), each at tensor=8 and at
# tensor=1 on the same weights and batch.
LAYOUT_TRAIN_STEPS = 2
LAYOUT_TRAIN_S = 1024
LAYOUT_TRAIN_RANK = 8
LAYOUT_FULL_LAYERS = 2
LAYOUT_TRAIN_DECAY = 0.1
# Faults planted in the tensor=8 full-parameter steps at 2 layers, each
# of which the gate must fail: the zero heads' gradients left in (their
# ``wo`` rows take the causal mean of V's gradient), and every shard
# holding a copy of its heads of its own, so that nothing sums a KV
# head's replicas (each updated with its own shard's gradient).
LAYOUT_TRAIN_FAULTS = ("unmasked", "unsummed")


def _layout_train_planted(fault):
    """``fault`` (``LAYOUT_TRAIN_FAULTS``, or None) planted: returns the
    function that takes it out again."""
    from llm_instance_gateway_tpu_torch.parallel import sharding
    from llm_instance_gateway_tpu_torch.training import train

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "unmasked":
        patch(train, "_mask_zero_heads", lambda tree: None)
    elif fault == "unsummed":
        patch(sharding._Placer, "heads",
              lambda self, x, axis, heads, hd: sharding._take_heads(
                  x, axis, heads, hd).clone())

    def restore():
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
    return restore


def _layout_train_tree(torch, cfg, kind: str):
    """The trainable tree a run starts from, the same every time: rank-8
    LoRA buffers (slot 0's ``a`` seeded, ``b`` zero) or the 2-layer
    params (seeded, q/k/v biases non-zero), bf16 on the card."""
    from llm_instance_gateway_tpu_torch.models import lora, transformer

    bf16 = torch.bfloat16
    if kind == "full":
        tree = transformer.init_params(cfg, seed=2222, dtype=bf16,
                                       device="cuda")
        _seed_biases(torch, tree, 2223, 0.5)
        return tree
    gen = torch.Generator(device="cuda").manual_seed(2224)
    bufs = lora.init_lora_buffers(cfg, bf16, "cuda")
    r = LAYOUT_TRAIN_RANK
    for t, (d_in, _d_out) in lora.target_dims(cfg).items():
        bufs[f"{t}_a"][:, 0, :, :r] = (torch.randn(
            (cfg.n_layers, d_in, r), device="cuda", generator=gen)
            / math.sqrt(d_in)).to(bf16)
    bufs["scale"][0] = 2.0
    return bufs


def _layout_train_picks(tree, kind: str) -> dict:
    """The leaves whose update the gate reads, cloned: the q/k/v/o LoRA
    ``a`` and ``b`` of slot 0's rank lanes, or the attention's
    projections and its query and value biases."""
    from llm_instance_gateway_tpu_torch.models import lora

    r = LAYOUT_TRAIN_RANK
    if kind == "full":
        # Not ``wk_b``: a key bias shifts every score of a query's row
        # alike, which the softmax ignores, so its gradient is rounding
        # noise and its update Adam's +-lr steps of it.
        return {n: tree["layers"][n].detach().clone()
                for n in ("wq", "wk", "wv", "wo", "wq_b", "wv_b")}
    return {f"{t}_{ab}": (tree[f"{t}_a"][:, 0, :, :r] if ab == "a"
                          else tree[f"{t}_b"][:, 0, :r]).detach().clone()
            for t in lora.TARGETS[:4] for ab in ("a", "b")}


def _layout_train_run(torch, cfg, base, tp, batch, kind: str,
                      fault=None) -> dict:
    """``LAYOUT_TRAIN_STEPS`` steps of ``kind`` ("lora" on the frozen
    ``base`` tree, or "full") over ``tp``'s grid (None: tensor=1), with
    ``fault`` planted: the losses, walls, launches, peak memory, the
    picks before and after (the caller's tree, written back), the zero
    heads' largest |value| and whether every KV replica equals its
    head's first (with the tensors a head has)."""
    import gc

    from llm_instance_gateway_tpu_torch.parallel import sharding
    from llm_instance_gateway_tpu_torch.training import train

    gc.collect()
    torch.cuda.empty_cache()
    restore = _layout_train_planted(fault)
    try:
        whole = _layout_train_tree(torch, cfg, kind)
        before = _layout_train_picks(whole, kind)
        if kind == "full":
            tree = whole if tp is None else sharding.shard_params(whole, tp)
        else:
            tree = whole if tp is None else sharding.shard_lora(whole, tp)
        opt = train.make_optimizer(tree, lr=TRAIN_8B_LR,
                                   weight_decay=LAYOUT_TRAIN_DECAY)
        tokens, positions, slots = batch
        if kind == "full":
            step = train.make_full_train_step(cfg, opt)

            def run():
                return step(tree, None, tokens, positions)[2]
        else:
            step = train.make_lora_train_step(cfg, opt)

            def run():
                return step(base, tree, None, tokens, positions, slots)[2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, walls = [], []
        for _ in range(LAYOUT_TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(run().item())
            walls.append(time.perf_counter() - t0)
        launches = read_launches()
        out = {"losses": losses, "step_wall_s": walls, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "before": before, "after": _layout_train_picks(whole, kind)}
        if tp is not None:
            hd = tp.hd
            out["zero_heads_max"] = max(
                [x.narrow(a, j * hd, hd).abs().max().item()
                 for x, a, js in sharding.zero_heads(tree) for j in js]
                or [0.0])
            heads: dict = {}
            for held in sharding.kv_replicas(tree):
                for x, h in held:
                    if h >= 0:
                        heads.setdefault((id(held), h), []).append(x)
            out["replicas_equal"] = all(
                torch.equal(xs[0], x) for xs in heads.values()
                for x in xs[1:])
            out["kv_tensors_per_head"] = max(map(len, heads.values()))
        del tree, opt, step, whole
    finally:
        restore()
    return out


def _layout_train_gate(torch, tag: str, ref: dict, run: dict) -> dict:
    """The gate's readings for one tensor=8 run against tensor=1's: the
    first loss (``PIPE_LOSS_TOL``, relative), each picked leaf's
    same-sign share where either side moved (``PIPE_AGREE``), the zero
    heads exactly 0, the KV replicas bitwise equal; ``passes`` whether all
    hold."""
    loss_err = abs(run["losses"][0] - ref["losses"][0]) / abs(
        ref["losses"][0])
    agree = {}
    for name, b0 in ref["before"].items():
        if not torch.equal(b0, run["before"][name]):
            raise AssertionError(f"{tag}: {name} starts apart")
        a, b, b0 = run["after"][name].float(), ref["after"][name].float(), \
            b0.float()
        moved = (a != b0) | (b != b0)
        same = ((a - b0).sign() == (b - b0).sign())[moved]
        agree[name] = same.float().mean().item() if moved.any() else 1.0
    res = {"loss": run["losses"], "loss_tensor1": ref["losses"],
           "loss_rel_err": loss_err, "agree_min": min(agree.values()),
           "agree": agree, "zero_heads_max": run["zero_heads_max"],
           "replicas_equal": run["replicas_equal"],
           "kv_tensors_per_head": run["kv_tensors_per_head"]}
    res["passes"] = bool(math.isfinite(loss_err) and loss_err <= PIPE_LOSS_TOL
                         and res["agree_min"] >= PIPE_AGREE
                         and run["zero_heads_max"] == 0.0
                         and run["replicas_equal"])
    return res


def phase_layouts_train(torch, params) -> dict:
    """Phase 22: training on Qwen2.5-7B's tensor=8 head plan on cuda:0
    (``params``: phase 21's tree, bf16, q/k/v biases non-zero).  The flash
    backward at the shard layout (4:1, hd 128, two 1023-token rows)
    against its plain version; ``LAYOUT_TRAIN_STEPS`` rank-8 LoRA steps at
    full width and depth (two seeded 1024-token rows) at tensor=8 (flash
    and its backward exactly steps x 28 layers x 8 shards) and at
    tensor=1, gated (``_layout_train_gate``); full-parameter steps at
    Qwen2.5-7B's widths cut to ``LAYOUT_FULL_LAYERS`` layers at tensor=8
    and tensor=1, gated the same way (the zero heads' ``wo`` rows exactly
    0), and again at tensor=8 with each of ``LAYOUT_TRAIN_FAULTS``
    planted, each of which must fail the gate; walls and peak memory."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models.configs import QWEN2_5_7B
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    t0 = time.time()
    walls = {}

    def mark(part: str) -> None:
        walls[part] = time.time() - t0 - sum(walls.values())

    cfg = QWEN2_5_7B
    tp = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(tensor=LAYOUT_T), LAYOUT_DEVICES))
    gen = torch.Generator(device="cuda").manual_seed(2221)
    bwd = _bwd_row(torch, gen, 2, LAYOUT_TRAIN_S - 1, tp.cfg.n_heads,
                   tp.cfg.n_kv_heads, tp.hd, torch.bfloat16)
    log("layouts train", "flash_backward at the shard layout "
        + json.dumps(bwd))
    mark("kernel_s")
    s = LAYOUT_TRAIN_S
    batch = (torch.randint(0, cfg.vocab_size, (2, s), device="cuda",
                           generator=gen),
             torch.arange(s, device="cuda").repeat(2, 1),
             torch.zeros(2, dtype=torch.int32, device="cuda"))
    sharded = sharding.shard_params(params, tp)
    ref = _layout_train_run(torch, cfg, params, None, batch, "lora")
    mark("lora_tensor1_s")
    sound = _layout_train_run(torch, cfg, sharded, tp, batch, "lora")
    mark("lora_tensor8_s")
    per = LAYOUT_TRAIN_STEPS * cfg.n_layers
    check_only(ref["launches"], {"flash_prefill": per,
                                 "flash_backward": per},
               "layouts train tensor=1")
    check_only(sound["launches"], {"flash_prefill": per * LAYOUT_T,
                                   "flash_backward": per * LAYOUT_T},
               "layouts train tensor=8")
    lora_gate = _layout_train_gate(torch, "layouts train lora", ref, sound)
    del sharded
    full_cfg = dataclasses.replace(cfg, n_layers=LAYOUT_FULL_LAYERS)
    full_tp = sharding.TensorParallel(full_cfg, mesh.make_mesh(
        mesh.MeshConfig(tensor=LAYOUT_T), LAYOUT_DEVICES))
    full_ref = _layout_train_run(torch, full_cfg, None, None, batch, "full")
    full = _layout_train_run(torch, full_cfg, None, full_tp, batch, "full")
    per = LAYOUT_TRAIN_STEPS * LAYOUT_FULL_LAYERS
    check_only(full_ref["launches"], {"flash_prefill": per,
                                      "flash_backward": per},
               "layouts train full tensor=1")
    check_only(full["launches"], {"flash_prefill": per * LAYOUT_T,
                                  "flash_backward": per * LAYOUT_T},
               "layouts train full tensor=8")
    full_gate = _layout_train_gate(torch, "layouts train full", full_ref,
                                   full)
    mark("full_s")
    faults = {}
    for fault in LAYOUT_TRAIN_FAULTS:
        run = _layout_train_run(torch, full_cfg, None, full_tp, batch,
                                "full", fault)
        faults[fault] = _layout_train_gate(torch, f"layouts train {fault}",
                                           full_ref, run)
        log("layouts train", f"planted {fault}: " + json.dumps(
            faults[fault]))
    mark("faults_s")
    out = {"wall_s": time.time() - t0, "walls": walls, "plan": tp.layout,
           "steps": LAYOUT_TRAIN_STEPS, "lr": TRAIN_8B_LR,
           "weight_decay": LAYOUT_TRAIN_DECAY,
           "lora": dict(lora_gate, step_wall_s={
               "tensor1": ref["step_wall_s"],
               f"tensor{LAYOUT_T}": sound["step_wall_s"]},
               peak_mem_gb={"tensor1": ref["peak_mem_gb"],
                            f"tensor{LAYOUT_T}": sound["peak_mem_gb"]}),
           "planted_faults": faults,
           "full": dict(full_gate, layers=LAYOUT_FULL_LAYERS, step_wall_s={
               "tensor1": full_ref["step_wall_s"],
               f"tensor{LAYOUT_T}": full["step_wall_s"]},
               peak_mem_gb={"tensor1": full_ref["peak_mem_gb"],
                            f"tensor{LAYOUT_T}": full["peak_mem_gb"]}),
           "launches": sound["launches"],
           "kernel_rows": {"flash_backward": [bwd]}}
    log("layouts train", "phase " + json.dumps(
        {k: v for k, v in out.items() if k != "kernel_rows"}))
    for what, gate in (("LoRA", lora_gate), ("full-parameter", full_gate)):
        if not gate["passes"]:
            raise AssertionError(f"layouts train {what} at tensor="
                                 f"{LAYOUT_T} against tensor=1: "
                                 + json.dumps(gate))
    for fault, gate in faults.items():
        if gate["passes"]:
            raise AssertionError(f"layouts train: the planted fault {fault} "
                                 "passes the gate, which cannot see such a "
                                 "fault: " + json.dumps(gate))
    return out


def phase_layouts(torch, params, adapter_path: str, t1_stats: dict) -> dict:
    """Phase 21: a head layout the reference's kernels do not split,
    served through the head plan: Qwen2.5-7B (families' seeded tree, q/k/v
    biases non-zero) at ``--mesh tensor=8`` on cuda:0, 4:1 a shard.  Flash,
    the bf16 lane kernel and the int8 paged kernel at the shard layout
    against their plain versions; one prefill's and one decode step's
    logits against tensor=1 under MESH_LOGIT_TOL, both planted faults
    beyond it; the lane serve's window (``phase_serve``, families' adapter
    on three rows, graphs; exact launches, each kernel once per shard; the
    replayed decode step profiled) with its greedy tokens counted against
    the families phase's tensor=1 answers, and the same window on an int8
    KV pool; peak memory and the plan's bytes; the walls of its parts.
    ``t1_stats``: the families phase's tensor=1 Qwen serve."""
    import gc

    t0 = time.time()
    walls = {}

    def mark(part: str) -> None:
        walls[part] = time.time() - t0 - sum(walls.values())

    gc.collect()
    torch.cuda.empty_cache()
    kernel_rows = _layout_kernel_rows(torch)
    mark("kernels_s")
    logits = _layout_logits(torch, params)
    mark("logits_s")
    gc.collect()
    torch.cuda.empty_cache()
    plan_bytes = {}
    lanes = phase_serve(
        torch, params, adapter_path, model="qwen2.5-7b", flags=LAYOUT_FLAGS,
        tag="layouts", mesh_devices=LAYOUT_DEVICES, profile="replay",
        after=lambda eng, url, st: plan_bytes.update(
            _layout_bytes(eng, params)))[0]
    mark("lanes_s")
    gc.collect()
    torch.cuda.empty_cache()
    pool = phase_serve(
        torch, params, adapter_path, model="qwen2.5-7b",
        flags=LAYOUT_FLAGS + ["--paged-kv-block", "64", "--kv-quantize",
                              "int8"],
        tag="layouts paged int8", mesh_devices=LAYOUT_DEVICES,
        profile=False)[0]
    mark("pool_s")
    want = t1_stats["answers"]
    tokens = {}
    for name, st in (("lanes", lanes), ("paged_int8", pool)):
        got = st.pop("answers")
        total = sum(map(len, got.values()))
        equal = sum(int(a == b) for key, toks in got.items()
                    for a, b in zip(toks, want[key]))
        tokens[name] = {"equal": equal, "of": total}
    log("layouts", "greedy tokens equal to tensor=1's bf16 lanes "
        "(reported, not gated): " + json.dumps(tokens))
    launches = dict(lanes["launches"])
    for name, n in pool["launches"].items():
        launches[name] = launches.get(name, 0) + n
    per_step = {}
    for label, st in (("tensor1", t1_stats), (f"tensor{LAYOUT_T}", lanes)):
        graph = st.get("profile", {}).get("decode_step", {}).get(
            "graph_replay")
        per_step[label] = ({k: graph.get(k) for k in
                            ("wall_ms", "device_ms", "device_idle_share")}
                           if isinstance(graph, dict) else graph)
    walls["lanes_profile_s"] = lanes["profile_s"]
    gc.collect()
    torch.cuda.empty_cache()
    trained = phase_layouts_train(torch, params)
    walls["train_s"] = trained["wall_s"]
    for name, rows in trained.pop("kernel_rows").items():
        kernel_rows[name] = rows + kernel_rows.get(name, [])
    out = {"wall_s": time.time() - t0, "walls": walls, "launches": launches,
           "launches_per_shard": {k: v / LAYOUT_T
                                  for k, v in launches.items()},
           "tokens_equal": tokens, "logits": logits, "per_step": per_step,
           "peak_mem_gb": {"tensor1": t1_stats["peak_mem_gb"],
                           f"tensor{LAYOUT_T}": lanes["peak_mem_gb"],
                           f"tensor{LAYOUT_T} paged int8":
                           pool["peak_mem_gb"]},
           "plan_bytes": plan_bytes, "kernel_rows": kernel_rows,
           "train": trained}
    log("layouts", "phase " + json.dumps({k: v for k, v in out.items()
                                          if k not in ("kernel_rows",
                                                       "train")}))
    return out


def main() -> int:
    import gc

    import torch

    t_start = time.time()
    walls: dict = {}

    def done(phase: str) -> None:
        """The seconds since start at each phase's end (the phase walls)."""
        walls[phase] = round(time.time() - t_start, 1)
        log("walls", json.dumps(walls))

    smi = phase_device(torch)
    sys.path.insert(0, REPO)
    phase_build()
    done("build")
    kernel_rows = phase_kernels(torch)
    done("kernels")
    phase_reference(torch)
    done("reference")
    stats, params, adapter_path = phase_serve(torch)
    done("serve")
    paged_stats = phase_paged_serve(torch, params, adapter_path)
    done("paged")
    # The int8 serves quantize the same bf16 weights into trees of their own.
    q_stats = phase_serve(torch, params, adapter_path, quant=True)[0]
    qp_stats = phase_paged_serve(torch, params, adapter_path, quant=True)
    done("int8")
    compare_profiles({"lane": stats, "paged": paged_stats},
                     {"lane": q_stats, "paged": qp_stats})
    graph_columns({"lane": stats, "paged": paged_stats, "lane_int8": q_stats,
                   "paged_int8": qp_stats})
    dispatch = phase_dispatch(torch, params)
    done("dispatch")
    disagg = phase_disagg(torch, params, adapter_path)
    disagg_q = phase_disagg(torch, params, adapter_path, quant=True)
    done("disagg")
    spec = phase_spec(torch, params, adapter_path, stats["answers"])
    done("spec")
    surface = phase_surface(torch, params, adapter_path, stats["answers"],
                            stats["profile_shares"])
    done("surface")
    checkpoint = phase_checkpoint(torch, params, adapter_path, stats,
                                  spec["lanes"])
    done("checkpoint")
    trained = phase_train(torch, params)
    done("train")
    meshed = phase_mesh(torch, params, adapter_path, stats)
    done("mesh")
    sequence = phase_sequence(torch, params, adapter_path, paged_stats)
    done("sequence")
    axes = phase_axes(torch, params, adapter_path, stats)
    done("axes")
    # Phase 13 builds Mixtral-8x7B's ~47 GB int8 tree, and phase 18's
    # pipelined train step its own 8-layer tree and AdamW state: the 8B
    # one goes, with all phase 14 loaded.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pipe = phase_pipe(torch)
    done("pipe")
    processes = phase_processes(torch)
    done("processes")
    log("walls", "phase 19 (lockstep): "
        + json.dumps(processes["lockstep"]["walls"]))
    pipe_processes = phase_pipe_processes(torch, pipe.pop("reference"))
    done("pipe processes")
    log("walls", "phase 18 (data, fsdp and pipe): " + json.dumps(
        {"axes_s": axes["wall_s"], "pipe_s": walls["pipe"] - walls["axes"],
         "total_s": walls["pipe"] - walls["sequence"]}))
    families = phase_families(torch, then={
        "qwen2.5-7b": lambda p, st, adapter: phase_layouts(torch, p, adapter,
                                                           st)})
    done("families")
    layouts = families["then"]["qwen2.5-7b"]
    log("walls", "phases 21 and 22 (layouts, inside families): "
        + json.dumps({"layouts_s": layouts["wall_s"],
                      "layouts_train_s": layouts["train"]["wall_s"]}))
    expert = families["servers"]["mixtral-8x7b"].pop("expert")
    log("walls", "phase 17 (sequence and expert): " + json.dumps(
        {"sequence_s": sequence["wall_s"], "expert_s": expert["wall_s"],
         "total_s": sequence["wall_s"] + expert["wall_s"]}))
    for name, rows in families["kernel_rows"].items():
        kernel_rows[name] = rows + kernel_rows[name]  # the main shape last
    kernel_rows.update(trained["kernel_rows"])
    for part in (meshed, layouts):
        for name, rows in part["kernel_rows"].items():
            kernel_rows[name] = rows + kernel_rows[name]
    by_path = {"lane": stats["launches"], "paged": paged_stats["launches"],
               "lane_int8": q_stats["launches"],
               "paged_int8": qp_stats["launches"],
               "dispatch": dispatch["launches"],
               "disagg": disagg["launches"],
               "disagg_int8": disagg_q["launches"],
               "spec": {name: spec["launches"].get(name, 0)
                        for name in stats["launches"]},
               "surface": surface["launches"],
               "checkpoint": {name: checkpoint["launches"].get(name, 0)
                              for name in stats["launches"]},
               "families": families["launches"],
               "train": trained["launches"],
               "mesh": meshed["launches"],
               "sequence": sequence["launches"],
               "expert": expert["launches"],
               "data": axes["launches_data"],
               "fsdp": axes["launches_fsdp"],
               "pipe": pipe["launches"],
               "processes": processes["launches"],
               "pipe_processes": pipe_processes["launches"],
               "layouts": layouts["launches"],
               "layouts_train": layouts["train"]["launches"]}
    print(json.dumps(kernels_line(kernel_rows, by_path)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# One --ab run: the tree's own smoke module, its serve and dispatch phases.
_AB_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as s
s.phase_device(torch)
s.phase_build()
stats, params, _ = s.phase_serve(torch)
dispatch = s.phase_dispatch(torch, params)
keys = ("wall_ms", "device_ms", "device_idle_share")
step = stats["profile"]["decode_step"]
graph = step.get("graph_replay")
print("[ab] " + json.dumps({
    "tree": sys.argv[2], "serve_s": stats["serve_s"],
    "serve_decode_step_ms_mean": stats["decode_step_ms_mean"],
    "lane_step_eager": {k: step[k] for k in keys},
    "lane_step_graph": ({k: graph[k] for k in keys}
                        if isinstance(graph, dict) else graph),
    "dispatch_A": dispatch["A"], "dispatch_B": dispatch["B"]}), flush=True)
"""


def ab_main(other: str) -> int:
    """``--ab DIR``: DIR's and this tree's serve and dispatch phases,
    alternately (DIR, this, this, DIR), each run in a process of its own
    from its tree's root."""
    import torch

    phase_device(torch)
    runs = []
    for label, tree in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", _AB_RUN, tree, label],
                              cwd=tree, stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise SystemExit(f"--ab: the run of {tree} failed "
                             f"({proc.returncode})")
        runs.append(json.loads(next(
            ln for ln in proc.stdout.splitlines()
            if ln.startswith("[ab] "))[5:]))
    for key in ("serve_s", "serve_decode_step_ms_mean", "lane_step_eager",
                "lane_step_graph", "dispatch_A", "dispatch_B"):
        log("ab", f"{key} (other, this, this, other): " + json.dumps(
            [r[key] for r in runs]))
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(ab_main(sys.argv[2]) if sys.argv[1:2] == ["--ab"] else main())
