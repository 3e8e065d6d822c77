"""One run of one cell:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

1. The configuration's weights and the mix's adapters are drawn on the
   device from ``--seed`` (``benchmark/weights.py``).
2. ``api_http.make_server(<the configuration's server flags>, params=...)``
   builds the engine a deployment runs and starts its loop; the adapters
   are loaded into its slots.
3. Set-up warms the cell's own shapes: a short run of the mix's traffic
   (outputs capped), then every decode graph the adaptive planner can ask
   for, greedy and seeded.
4. The window: ``--seconds`` of the mix's traffic into ``Engine.submit``
   (``benchmark/client.py``); an open loop then waits up to the mix's
   ``drain_s`` for the window's requests.  With ``--trace 1`` the device is
   traced over a slice of the window (``benchmark/trace.py``).
5. The peak memory is read, the engine stopped and freed, and the sample
   of served tokens checked against the plain reference
   (``benchmark/check.py``) by the number the mix names (``compare``)
   under the configuration's limit for it.  With ``--control`` the
   configuration's control (the reference in a lower precision) is put in
   the program's place for that check, so the run comes out not correct.

Standard output's last line is the result; standard error's last lines
name each number compared beside its limit.  Without a CUDA device (or
with fewer than the cell asks for) the run exits 2 and prints no result;
with ``jax``, ``jaxlib``, ``flax`` or the JAX package loaded once the
window has closed, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "llm_instance_gateway_tpu")
IDLE_WAIT_S = 600.0
KV_POLL_S = 0.25


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _caches(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(root, "build", "benchmark_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # Keep every dispatch record of a run (decode_step_ms, decode_rows_mean).
    os.environ["LIG_PROFILE_CAPACITY"] = "1000000"


def _flag(flags: list, name: str, default: str) -> str:
    return flags[flags.index(name) + 1] if name in flags else default


def check_preset(model: dict, preset) -> None:
    """The port's preset must be the configuration the file states."""
    from benchmark.weights import dims
    m = dims(model)
    want = {"d_model": m["d"], "d_ff": m["f"], "n_layers": m["L"],
            "n_heads": m["H"], "n_kv_heads": m["K"], "vocab_size": m["V"],
            "resolved_head_dim": m["hd"], "n_experts": m["E"],
            "attention_bias": m["bias"], "norm_eps": m["eps"],
            "rope_theta": m["theta"]}
    if m["E"]:
        want["n_experts_per_token"] = m["k_experts"]
    got = {k: getattr(preset, k) for k in want}
    if got != want:
        raise SystemExit(f"the port's preset {preset.name} is not the "
                         f"configuration's model: {got} != {want}")


def _idle(engine, timeout: float) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = engine.metrics_snapshot()
        if not s["num_requests_running"] and not s["num_requests_waiting"]:
            return
        time.sleep(0.01)
    raise RuntimeError("engine not idle after set-up traffic")


def _wait(reqs: list, timeout: float) -> None:
    deadline = time.time() + timeout
    for r in reqs:
        if not r.done.wait(max(0.0, deadline - time.time())):
            raise RuntimeError("set-up request did not finish")
        if r.error:
            raise RuntimeError(f"set-up request failed: {r.error}")


def warm_up(engine, cell, seed: int, vocab: int, names: list) -> None:
    """The mix's own shapes, then every decode graph key the planner can
    choose (1, 2, 4 ... up to the ceiling; greedy rows alone and with a
    seeded row), so nothing is captured inside the window."""
    from benchmark import client, generator
    mix = cell.traffic
    reqs = []
    for p in generator.warmup_requests(mix, seed, vocab):
        r = client.make_request(p, names, mix)
        engine.submit(r)
        reqs.append(r)
    _wait(reqs, IDLE_WAIT_S)
    ceiling = max(1, engine.cfg.adaptive_steps
                  or engine.cfg.decode_steps_per_sync)
    want = set()
    # One request alone, budget n + 1: after its prefill the planner (no
    # admission pressure) asks for a block of exactly n steps.
    for n in (1 << k for k in range(ceiling.bit_length())):
        for greedy in (True, False):
            p = generator.Planned(index=0, prefix=-1,
                                  prompt=[(7 * n + j) % vocab
                                          for j in range(40)],
                                  max_new_tokens=n + 1, adapter=-1,
                                  greedy=greedy, sample_seed=n)
            r = client.make_request(p, names, mix)
            engine.submit(r)
            _wait([r], IDLE_WAIT_S)
            want.add((n, not greedy, False))
    _idle(engine, IDLE_WAIT_S)
    graphs = getattr(engine, "_graphs", None)
    missing = sorted(want - set(graphs.shapes)) if graphs is not None else []
    if missing:
        log(f"decode graphs not captured in set-up: {missing}")


def _profiler_state(engine) -> tuple:
    prof = engine.profiler
    with prof._lock:
        return prof._seq, list(prof._ring)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown, compared: dict) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


class Served:
    """A cell's engine, built as a deployment builds it, with the run's
    adapters loaded and its shapes warmed up."""

    def __init__(self, cell, seed: int, root: str):
        import torch
        from benchmark import weights
        from llm_instance_gateway_tpu_torch.models.configs import CONFIGS
        from llm_instance_gateway_tpu_torch.server import api_http
        self.cell, self.seed = cell, seed
        cfg = cell.config
        flags = list(cfg["server"])
        self.model = cfg["model"]
        self.m = weights.dims(self.model)
        check_preset(self.model, CONFIGS[_flag(flags, "--model", "")])
        self.device = _flag(flags, "--device", "cuda")
        self.dtype = (torch.float32
                      if _flag(flags, "--dtype", "bfloat16") == "float32"
                      else torch.bfloat16)
        self.int8 = cfg.get("weights") == "int8"
        self.mix = cell.traffic
        if self.device == "cuda":
            from llm_instance_gateway_tpu_torch.ops import _build
            _build.build_all()
        params = weights.make_params(self.model, seed, self.device,
                                     self.dtype, self.int8)
        self.t_weights = time.time()
        self.httpd, self.engine, _ = api_http.make_server(
            flags + ["--host", "127.0.0.1", "--port", "0",
                     "--seed", str(seed & 0x7FFFFFFF)], params=params)
        del params
        ad = self.mix.get("adapters", {"count": 0})
        self.names, self.adapters = [], {}
        for i in range(ad["count"]):
            w = weights.make_adapter(self.model, seed, i, ad["rank"],
                                     self.device, self.dtype)
            self.names.append(weights.adapter_name(i))
            self.adapters[i] = w
            self.engine.lora.load(self.names[-1], weights=w,
                                  alpha=float(ad["rank"]), rank=ad["rank"])
        warm_up(self.engine, cell, seed, self.m["V"], self.names)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def window(self, planned: list, seconds: float, trace: bool,
               mix: dict | None = None) -> dict:
        """Drive ``planned`` for ``seconds`` from now; returns what the
        window saw (``Window`` fields and the trace)."""
        from benchmark import client
        engine, mix = self.engine, mix or self.mix
        out: dict = {"trace": None}
        t0 = time.time() + 0.05 + float(mix.get("ramp_s", 0))
        out["seq0"], _ = _profiler_state(engine)
        out["snap0"] = engine.metrics_snapshot()
        graphs = getattr(engine, "_graphs", None)
        cap0 = graphs.capture_s if graphs is not None else 0.0
        t1 = t0 + seconds

        def at_close():
            out["snap1"] = engine.metrics_snapshot()
            out["seq1"], out["ring"] = _profiler_state(engine)

        done: dict = {}

        def drive():
            if mix["loop"] == "open":
                drain = float(mix.get("drain_s", 60))
                done["recs"] = client.run_open(engine, planned, t0, seconds,
                                               drain, self.names, mix)
                done["deadline"] = min(time.time(), t1 + drain)
            else:
                done["recs"] = client.run_closed(
                    engine, planned, t0 - float(mix.get("ramp_s", 0)), t1,
                    int(mix["clients"]), self.names, mix)
                done["deadline"] = t1

        driver = threading.Thread(target=drive, daemon=True)
        driver.start()
        # The profiler starts and stops on this (the main) thread, the one
        # its client was registered on.  Stopping it holds the process for
        # seconds, so the slice ends with the window; its events are read
        # once the window's requests are done.
        prof = None
        if trace:
            from benchmark import trace as trace_mod
            span = min(trace_mod.TRACE_S, seconds)
            prof = trace_mod.Recorder(t1 - span)
        # The KV pool's use (allocated blocks, the prefix cache's
        # reclaimable ones free), sampled through the window.
        out["kv_peak"] = 0.0
        while time.time() < t1:
            time.sleep(max(0.0, min(KV_POLL_S, t1 - time.time())))
            if time.time() >= t0:
                out["kv_peak"] = max(out["kv_peak"], engine.metrics_snapshot()
                                     ["kv_cache_usage_perc"])
        at_close()
        if prof is not None:
            prof.stop()
        driver.join()
        recs = done["recs"]
        out["deadline"] = done["deadline"]
        if prof is not None:
            out["trace"] = prof.read()
        out["t0"], out["recs"] = t0, recs
        out["captured_s"] = ((graphs.capture_s - cap0)
                             if graphs is not None else 0.0)
        if out["captured_s"] > 0:
            log(f"decode graphs captured inside the window: "
                f"{out['captured_s']:.3f} s")
        return out

    def close(self) -> None:
        """Stop the engine and free it and everything it holds."""
        import torch
        self.engine.stop()
        self.httpd.server_close()
        self.engine = self.httpd = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def make_window(served: Served, w: dict, seconds: float, setup_s: float):
    from benchmark.window import Window
    win = Window(t0=w["t0"], seconds=seconds, records=w["recs"], m=served.m,
                 loop=(served.mix["loop"]), deadline=w["deadline"],
                 setup_s=setup_s, snap0=w["snap0"],
                 snap1=w.get("snap1", {}), trace=w["trace"])
    seq0, seq1 = w["seq0"], w.get("seq1", w["seq0"])
    win.dispatches = [d for d in w.get("ring", []) if seq0 < d[0] <= seq1]
    return win


def main(argv=None, root: str = spec.ROOT, require_cuda: bool = True) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the configuration's control (the reference "
                         "in a lower precision) in the program's place for "
                         "the check")
    args = ap.parse_args(argv)
    t_start = T_START if argv is None else time.time()
    cell = spec.load_cell(args.workload, root)
    _caches(root)

    import torch
    device = _flag(list(cell.config["server"]), "--device", "cuda")
    if require_cuda:
        if not torch.cuda.is_available():
            log("no CUDA device: torch.cuda.is_available() is False")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA devices, "
                f"{torch.cuda.device_count()} present")
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    from benchmark import check, generator, roofline, weights

    served = Served(cell, args.seed, root)
    planned = generator.requests(served.mix, args.seed, args.seconds,
                                 served.m["V"])
    if args.trace:
        from benchmark import trace
        trace.init()
    w = served.window(planned, args.seconds, bool(args.trace))
    setup_s = w["t0"] - t_start
    recs = w["recs"]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    engine_errors = [r.error for r in recs
                     if r.error and r.req is not None
                     and r.error != "engine stopped"]
    for r in recs:
        r.req = None
    served.close()
    if device == "cuda":
        log(f"peak {peak / 1e9:.2f} GB; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated "
            "once the engine is freed")

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in the run's process: {found}")
        return 3

    window = make_window(served, w, args.seconds, setup_s)
    tr = window.trace
    reported = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for met in reported:
        value = spec.metric_reader(met["name"], root)(window)
        if value is not None:
            metrics[met["name"]] = {"value": value, "unit": met["unit"]}
    if tr is not None:
        first = min((k[1] for k in tr.kernels), default=tr.a) - tr.a
        log(f"trace: slice {tr.window_s:.3f} s, {len(tr.kernels)} device "
            f"events read in {tr.read_s:.1f} s; the first starts {first:.3f}"
            " s after the slice's start")

    # The check, on the program's outputs, after the program is gone.
    chk = cell.config["check"]
    picked = check.sample(recs, args.seed, int(chk["sample"]))
    t_ref = time.time()
    ref_params = weights.make_params(served.model, args.seed, device,
                                     served.dtype, served.int8)
    res = check.gaps(served.model, ref_params, picked,
                     control=chk["control"] if args.control else None,
                     adapters=served.adapters, served_dtype=served.dtype)
    del ref_params
    ref_s = time.time() - t_ref
    number = served.mix.get("compare", "mean_logit_gap")
    limit = float(chk["limits"][number])
    judged = res["control"] if args.control else res["program"]
    value = judged.get(number, float("inf"))
    correct = bool(picked) and value <= limit and not engine_errors
    attempted = len(recs)
    failed = sum(1 for r in recs if r.error or (
        served.mix["loop"] == "open" and not r.finished))
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    compared = {number: {"value": value, "limit": limit},
                "engine_errors": {"value": len(engine_errors), "limit": 0}}
    late = [r.t_submit - r.due for r in recs if r.t_submit]
    log(f"{cell.name} seed {args.seed}: setup {setup_s:.2f} s (weights "
        f"{served.t_weights - t_start:.2f}), {attempted} requests, "
        f"{failed} failed, generator late by at most "
        f"{max(late, default=0) * 1e3:.1f} ms, reference {ref_s:.1f} s over "
        f"{len(picked)} requests, {res['tokens']} served tokens")
    cap = w["snap1"].get("kv_tokens_capacity", 0)
    pool_gb = cap * roofline.kv_bytes(served.m, 1) / 1e9
    log(f"KV pool: peak use in the window {w['kv_peak'] * 100:.2f}% of "
        f"{cap} tokens ({w['kv_peak'] * pool_gb:.2f} of {pool_gb:.2f} GB)")
    log(f"the program's numbers: {json.dumps(res['program'])}")
    if args.control:
        log(f"the control's ({chk['control']}) numbers, judged: "
            f"{json.dumps(res['control'])}")
    log("checked requests: " + json.dumps(res["requests"]))
    if engine_errors:
        log(f"engine errors: {engine_errors[:5]}")
    if not picked:
        log("no greedy request served a token: nothing to check")
    for name, c in compared.items():
        log(f"compared {name} = {c['value']!r} limit {c['limit']!r}")
    print(result_line(correct, attempted, failed, metrics, dev,
                      tr.breakdown() if tr is not None else None, compared),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
