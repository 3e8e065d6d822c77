#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises (exit code != 0):

1. device  — requires CUDA, prints the card's name and power limit
   (nvidia-smi) and the TF32 switches;
2. build   — builds every kernel in llm_instance_gateway_tpu_torch/ops/csrc
   with nvcc for sm_90a (one process per source, all at once);
3. kernels — calls each kernel's wrapper at the serving path's shapes,
   holds it against its plain PyTorch version, and times kernel, plain
   version and one PyTorch library call (a yardstick only);
4. reference — the card's path (kernels) against the CPU path (plain
   versions) on a small f32 model with Llama-3-8B's head layout: prefill
   logits within a stated tolerance, identical greedy token streams;
5. serve   — starts the port's HTTP server at Llama-3-8B width and depth
   (random weights), loads a seeded LoRA adapter from .npz, answers six
   concurrent greedy completions (base and adapter rows, one streamed)
   and checks both kernels' launch counts over that window;
6. profile — torch.profiler over one 8B decode step and one 1024-token
   prefill: host wall, device kernel time, device idle share, top kernels;

then prints one JSON line with every kernel's numbers, the nvidia-smi line,
and last the device JSON line.  Imports nothing of JAX.
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

FLASH_TOL = 2e-2   # bf16 output: 1-2 ulps at |x| ~ 1 plus summation order
DECODE_TOL = 2e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
            if "registers" in line or "spill" in line or "smem" in line:
                log("build", f"{name}: {line.strip()}")
    log("build", f"built {sorted(paths)} in {secs:.2f} s")


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version at the serving path's shapes."""
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    from llm_instance_gateway_tpu_torch.ops import flash_attention as fl
    import torch.nn.functional as F

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    H, K, HD = 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # -- flash prefill: B=1 at buckets 16, 128, 1024 --
    flash_rows = []
    for s in (16, 128, 1024):
        q = torch.randn(1, s, H, HD, device=dev, generator=gen).to(bf16)
        k = torch.randn(1, s, K, HD, device=dev, generator=gen).to(bf16)
        v = torch.randn(1, s, K, HD, device=dev, generator=gen).to(bf16)
        got = fl.flash_attention(q, k, v)
        want = fl.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not math.isfinite(err) or err > FLASH_TOL:
            raise AssertionError(f"flash S={s}: max_abs_err {err} > {FLASH_TOL}")
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
        flops = 2 * 1 * H * s * (s + 1) * HD
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / BF16_FLOPS * 1e3
        row = dict(shape=f"B=1 S={s} H={H} K={K} hd={HD} bf16",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_bytes, t_flops),
                   bound_by="bytes" if t_bytes >= t_flops else "operations")
        flash_rows.append(row)
        log("kernels", "flash_prefill " + json.dumps(row))
    results["flash_prefill"] = flash_rows

    # -- lane decode: B=8, S_max=1024, ragged lengths incl. 0, 1, 777, 1024 --
    B, S_MAX = 8, 1024
    lengths = torch.tensor([0, 1, 777, 1024, 5, 300, 512, 1000],
                           dtype=torch.int32, device=dev)
    q = torch.randn(B, H, HD, device=dev, generator=gen).to(bf16)
    kc = torch.randn(B, S_MAX, K, HD, device=dev, generator=gen).to(bf16)
    vc = torch.randn(B, S_MAX, K, HD, device=dev, generator=gen).to(bf16)
    got = dec.decode_attention(q, kc, vc, lengths)
    want = dec.decode_attention_reference(q, kc, vc, lengths)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not math.isfinite(err) or err > DECODE_TOL:
        raise AssertionError(f"decode: max_abs_err {err} > {DECODE_TOL}")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("decode: a length-0 row must give zeros")
    total_len = int(lengths.sum().item())
    kv_bytes = 2 * total_len * K * HD * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + B * 4
    sets = [(q.clone(), kc.clone(), vc.clone(), lengths.clone())
            for _ in range(copies_for(kc.numel() * 4))]
    ms = time_ms(torch, dec.decode_attention, sets)
    plain_ms = time_ms(torch, dec.decode_attention_reference, sets)
    mask = (torch.arange(S_MAX, device=dev)[None] < lengths[:, None])
    bsets = [(a[:, :, None], b.transpose(1, 2).contiguous(),
              c.transpose(1, 2).contiguous(), mask[:, None, None])
             for a, b, c, _ in sets]
    lib_ms = time_ms(torch, lambda a, b, c, m: F.scaled_dot_product_attention(
        a, b, c, attn_mask=m, enable_gqa=True), bsets)
    flops = 2 * 2 * total_len * H * HD
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS * 1e3
    row = dict(shape=f"B={B} S_max={S_MAX} H={H} K={K} hd={HD} bf16 "
               f"lengths={lengths.tolist()}",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_flops),
               bound_by="bytes" if t_bytes >= t_flops else "operations")
    log("kernels", "decode_attention " + json.dumps(row))
    results["decode_attention"] = [row]
    return results


def phase_reference(torch) -> None:
    """The card's path (kernels, f32) against the CPU path (plain versions)
    on one small model with Llama-3-8B's head layout: prefill logits within
    REF_TOL, and identical greedy token streams through the Engine."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine, EngineConfig, Request)

    ref_tol = 2e-3  # f32 with TF32 off: summation order only
    cfg = dataclasses.replace(LLAMA3_8B, name="llama3-8b-narrow", d_model=512,
                              n_layers=2, n_heads=8, n_kv_heads=2,
                              head_dim=128, d_ff=1024, vocab_size=320)
    cpu_params = transformer.init_params(cfg, seed=7, dtype=torch.float32,
                                         device="cpu")
    gpu_params = {
        "embed": cpu_params["embed"].cuda(),
        "final_norm": cpu_params["final_norm"].cuda(),
        "lm_head": cpu_params["lm_head"].cuda(),
        "layers": {k: v.cuda() for k, v in cpu_params["layers"].items()},
    }
    tokens = torch.randint(0, 256, (1, 64), generator=torch.Generator()
                           .manual_seed(3))
    positions = torch.arange(64)[None]
    want, _, _ = transformer.prefill(cfg, cpu_params, tokens, positions)
    got, _, _ = transformer.prefill(cfg, gpu_params, tokens.cuda(),
                                    positions.cuda())
    err = (got.cpu() - want).abs().max().item()
    if not math.isfinite(err) or err > ref_tol:
        raise AssertionError(f"reference: prefill logits err {err} > {ref_tol}")

    prompts = [[256] + list(range(65, 65 + n)) for n in (5, 40, 100)]
    streams = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = Engine(cfg, params, EngineConfig(max_seq_len=256,
                                               prefill_buckets=(16, 64, 128),
                                               adaptive_steps=8),
                     eos_id=257, dtype=torch.float32, device=dev)
        eng.start()
        reqs = [eng.submit(Request(prompt_tokens=p, max_new_tokens=12))
                for p in prompts]
        for r in reqs:
            if not r.done.wait(300) or r.error:
                raise AssertionError(f"reference engine on {dev}: {r.error}")
        eng.stop()
        streams[dev] = [r.output_tokens for r in reqs]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"reference: greedy streams differ: {streams}")
    log("reference", f"narrow Llama-3 layout (d=512, H=8, K=2, hd=128, f32): "
        f"prefill logits max_abs_err {err:.3g} <= {ref_tol}; greedy streams "
        f"identical on cuda and cpu ({sum(map(len, streams['cuda']))} tokens)")


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


def phase_serve(torch) -> dict:
    """The port's server at Llama-3-8B width, six concurrent greedy
    completions (base and adapter rows, one streamed) through both kernels."""
    import threading
    import urllib.request

    import numpy as np

    from llm_instance_gateway_tpu_torch.models import lora
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B as cfg
    from llm_instance_gateway_tpu_torch.ops import decode_attention as dec
    from llm_instance_gateway_tpu_torch.ops import flash_attention as fl
    from llm_instance_gateway_tpu_torch.server import api_http
    from llm_instance_gateway_tpu_torch.server.lora_manager import save_adapter

    t0 = time.time()
    httpd, engine, _ = api_http.make_server([
        "--model", "llama3-8b", "--max-seq-len", "1024", "--decode-slots", "8",
        "--device", "cuda", "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.synchronize()
    init_s = time.time() - t0
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        # Seeded rank-8 adapter on every target, saved as .npz and loaded
        # through the admin endpoint.
        rng = np.random.default_rng(11)
        rank = 8
        weights = {
            t: {"a": (rng.standard_normal((cfg.n_layers, d_in, rank))
                      / math.sqrt(d_in)).astype(np.float32),
                "b": (rng.standard_normal((cfg.n_layers, rank, d_out))
                      * 0.05).astype(np.float32)}
            for t, (d_in, d_out) in lora.target_dims(cfg).items()}
        os.makedirs(os.path.join(REPO, "build", "smoke"), exist_ok=True)
        path = os.path.join(REPO, "build", "smoke", "adapter-r8.npz")
        save_adapter(path, weights, alpha=16.0, rank=rank)
        status, text = _post(url + "/v1/load_lora_adapter",
                             {"lora_name": "smoke-r8", "lora_path": path})
        if status != 200:
            raise AssertionError(f"adapter load: {status} {text}")

        # prompt characters (+ BOS) -> buckets 16, 64, 128, 512, 1024, 1024;
        # the longest leaves room for max_tokens under --max-seq-len
        jobs = [(12, None, False), (50, "smoke-r8", False),
                (120, None, True), (400, "smoke-r8", False),
                (700, None, False), (900, "smoke-r8", False)]
        max_tokens = 32
        letters = "the quick brown fox jumps over the lazy dog "
        snap0 = engine.metrics_snapshot()
        fl.launches = 0
        dec.launches = 0
        results = [None] * len(jobs)

        def run(i, n_chars, model, stream):
            body = {"prompt": (letters * 40)[:n_chars], "max_tokens": max_tokens,
                    "temperature": 0.0, "stream": stream}
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
        launches = {"flash_prefill": fl.launches,
                    "decode_attention": dec.launches}
        snap1 = engine.metrics_snapshot()

        n_layers = cfg.n_layers
        for i, ((n_chars, adapter, stream), res) in enumerate(zip(jobs, results)):
            if res is None:
                raise AssertionError(f"request {i} did not return")
            status, text, secs = res
            if status != 200:
                raise AssertionError(f"request {i}: {status} {text[:300]}")
            if stream:
                chunks = [json.loads(line[6:]) for line in text.splitlines()
                          if line.startswith("data: {")]
                usage = chunks[-1]["usage"]
                if text.rstrip().splitlines()[-1] != "data: [DONE]":
                    raise AssertionError("stream did not end with [DONE]")
            else:
                usage = json.loads(text)["usage"]
            if usage["completion_tokens"] != max_tokens:
                raise AssertionError(f"request {i}: {usage} != {max_tokens} "
                                     "tokens")
            log("serve", f"request {i}: {n_chars + 1} prompt tokens, "
                f"adapter={adapter}, stream={stream}, "
                f"{usage['completion_tokens']} tokens in {secs:.2f} s")
        decode_steps = (snap1["dispatch_steps_hist"]["sum"]
                        - snap0["dispatch_steps_hist"]["sum"])
        if launches["flash_prefill"] < len(jobs) * n_layers:
            raise AssertionError(f"flash launches {launches} < "
                                 f"{len(jobs)} x {n_layers}")
        if launches["decode_attention"] < decode_steps * n_layers:
            raise AssertionError(f"decode launches {launches} < "
                                 f"{decode_steps} x {n_layers}")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
            metrics_text = f.read().decode()
        for family in ("tpu:num_requests_running", "tpu:num_requests_waiting",
                       "tpu:kv_cache_usage_perc", "tpu:lora_requests_info",
                       "tpu:prefill_queue_size", "tpu:decode_step_seconds"):
            if family not in metrics_text:
                raise AssertionError(f"/metrics lacks {family}")
        ph = snap1["phase_hist"]
        stats = {
            "init_s": init_s, "serve_s": serve_s,
            "decode_steps": decode_steps,
            "decode_step_ms_mean": 1e3 * (
                (ph["decode_step"]["sum"] - snap0["phase_hist"]["decode_step"]["sum"])
                / max(1, ph["decode_step"]["count"]
                      - snap0["phase_hist"]["decode_step"]["count"])),
            "prefill_ms_mean": 1e3 * (
                (ph["prefill"]["sum"] - snap0["phase_hist"]["prefill"]["sum"])
                / max(1, ph["prefill"]["count"]
                      - snap0["phase_hist"]["prefill"]["count"])),
            "tokens": len(jobs) * max_tokens,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
        }
        log("serve", "llama3-8b (32 layers, random bf16 weights): "
            + json.dumps(stats))
        # After the counted window: these launches are not the serve's.
        stats["profile"] = phase_profile(torch, engine)
        return stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def phase_profile(torch, engine) -> dict:
    """Where one 8B decode step (8 rows, mixed adapters, ragged lengths)
    and one 1024-token prefill spend their time: host wall per call, device
    kernel time, device idle share, top kernels (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.server.sampling import sample

    cfg, params = engine.model_cfg, engine.params
    dev = torch.device("cuda")
    lora_bufs = engine.lora.buffers
    b = engine.cfg.decode_slots
    tokens = torch.arange(b, device=dev) + 65
    positions = torch.tensor([100 * (i + 1) for i in range(b)], device=dev)
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

    def prefill():
        return transformer.prefill(cfg, params, prompt, prompt_pos,
                                   lora_bufs=lora_bufs,
                                   slot_ids=slots[1:2])[0]

    out = {}
    for name, fn, reps in (("decode_step", decode, 3),
                           ("prefill_1024", prefill, 2)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
            if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                device_us += us
                rows.append((us / reps / 1e3, ev.count // reps, ev.key[:60]))
        rows.sort(reverse=True)
        device_ms = device_us / reps / 1e3
        out[name] = {
            "wall_ms": wall_ms,
            "device_ms": device_ms if device_us else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if device_us
            else "not measured",
            "top_kernels": [{"name": k, "ms": ms, "calls": n}
                            for ms, n, k in rows[:8]],
        }
        log("profile", f"{name}: " + json.dumps(out[name]))
    return out


KERNEL_SOURCES = {
    "flash_prefill": (
        "llm_instance_gateway_tpu_torch/ops/csrc/flash_prefill.cu",
        "llm_instance_gateway_tpu/ops/pallas_attention.py:120"),
    "decode_attention": (
        "llm_instance_gateway_tpu_torch/ops/csrc/decode_attention.cu",
        "llm_instance_gateway_tpu/ops/pallas_decode_attention.py:176"),
}


def kernels_line(kernel_rows: dict, launches: dict) -> dict:
    """One entry per kernel: numbers at its largest main-path shape,
    max_abs_err over all shapes checked, launches from the serve phase."""
    out = []
    for name, rows in kernel_rows.items():
        main = rows[-1]
        source, replaces = KERNEL_SOURCES[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "shapes": rows,
        })
    return {"kernels": out}


def main() -> int:
    import torch

    smi = phase_device(torch)
    sys.path.insert(0, REPO)
    phase_build()
    kernel_rows = phase_kernels(torch)
    phase_reference(torch)
    stats = phase_serve(torch)
    print(json.dumps(kernels_line(kernel_rows, stats["launches"])))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
