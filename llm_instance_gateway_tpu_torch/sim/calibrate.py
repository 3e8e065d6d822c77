"""Fit the capacity twin's latency model from the port's engine (port of
``calibrate_from_engine`` in ``sim/calibrate.py``).

The gateway's simulator and capacity twin run a ``LatencyModel`` of six
constants; the reference times a JAX engine to fit them.  This module
times the torch engine the same way, so a torch pod's constants come from
the card it serves on:

- prefill: the engine's bucketed prefill (``Engine._prefill_impl``, first
  token sampled) at each bucket length; a line in tokens,
  ``prefill = c0 + c1 * tokens``;
- decode: the n-step decode block (``Engine._run_block``, the CUDA graph
  on the card) with every row live at each cache fill; a line in the KV
  tokens the step reads, ``decode = c3 + c4 * kv_tokens``, whose base
  cost is then split half as a per-step floor and half per sequence (a
  heuristic the fit cannot identify, as in the reference).

Every call is timed as the reference's ``_time_call`` times it: one warm
call (synchronised), then ``n`` dispatches and one synchronisation at the
end, so the host's per-call round trip is amortised.  The fit itself
(``fit``) is a function of the measured points, the reference's
arithmetic exactly (both ``polyfit``s, the clamps, the halving).

``main`` writes the reference's versioned artifact
(``lig-twin-calibration/1``, the same rounding and serialization), which
the gateway's ``load_calibration`` reads unchanged.

Run:  python -m llm_instance_gateway_tpu_torch.sim.calibrate --out FILE
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

# Versioned artifact schema (the reference's; a twin refuses other ones).
CALIBRATION_FORMAT = "lig-twin-calibration/1"

# Constant -> decimal places in the artifact, in the schema's key order.
_MODEL_ROUND = {
    "prefill_min_s": 6,
    "prefill_base_s": 6,
    "prefill_per_token_s": 9,
    "decode_base_s": 6,
    "decode_per_kv_token_s": 12,
    "decode_per_seq_s": 9,
}


def _sync(h) -> None:
    """Wait for the work behind ``h`` (a device tensor): the card's queue
    drains; a CPU tensor is computed already."""
    if isinstance(h, torch.Tensor) and h.is_cuda:
        torch.cuda.synchronize(h.device)


def _time_call(fn, n: int = 5) -> float:
    """Average seconds per call: warm once (synchronised), then ``n``
    dispatches and one synchronisation at the end."""
    _sync(fn())
    t0 = time.perf_counter()
    h = None
    for _ in range(n):
        h = fn()
    _sync(h)
    return (time.perf_counter() - t0) / n


def fit(prefill_points, decode_points, b_slots: int) -> dict:
    """The six ``LatencyModel`` constants from measured points:
    ``prefill_points`` [(tokens, seconds)], ``decode_points``
    [(kv_tokens, seconds per step)], ``b_slots`` the decode rows."""
    xs = [float(x) for x, _ in prefill_points]
    ys = [float(y) for _, y in prefill_points]
    if len(xs) >= 2:
        c1, c0 = np.polyfit(np.asarray(xs, np.float64),
                            np.asarray(ys, np.float64), 1)
        c1 = max(float(c1), 1e-7)
        c0 = max(float(c0), 1e-4)
    else:
        c0, c1 = ys[0], 1e-6
    kv_totals = [float(x) for x, _ in decode_points]
    times = [float(y) for _, y in decode_points]
    if len(kv_totals) >= 2:
        c4, c3 = np.polyfit(np.asarray(kv_totals), np.asarray(times), 1)
        c4 = max(float(c4), 0.0)
        c3 = max(float(c3), 1e-5)
    else:
        c3, c4 = times[0], 0.0
    c_batch = (c3 / 2.0) / b_slots
    c3 = c3 / 2.0
    return {
        "prefill_min_s": min(ys),
        "prefill_base_s": c0,
        "prefill_per_token_s": c1,
        "decode_base_s": c3,
        "decode_per_kv_token_s": c4,
        "decode_per_seq_s": c_batch,
    }


def calibrate_from_engine(
    engine,
    prefill_lengths: tuple[int, ...] = (64, 128, 256, 384),
    decode_fills: tuple[int, ...] = (32, 128, 256, 448),
    repeats: int = 10,
) -> dict:
    """Time ``engine`` (an idle ``server.engine.Engine``, not started or
    with no request in flight) and fit the six constants.  The decode
    rows' carry is restored afterwards, so the engine serves on as it
    was; the rows' cache cells at the timed fills hold garbage that no
    request reads (a row's length masks them)."""
    from llm_instance_gateway_tpu_torch.server.engine import (
        _CARRY,
        SamplingParams,
    )

    usable = [
        b for b in prefill_lengths
        if b in engine.cfg.prefill_buckets and b < engine.cfg.max_seq_len
    ] or [engine.cfg.prefill_buckets[0]]

    prefill_points = []
    with torch.no_grad():
        for bucket in usable:
            tokens = np.zeros((1, bucket), np.int64)
            positions = np.arange(bucket, dtype=np.int64)[None]

            def call(bucket=bucket, tokens=tokens, positions=positions):
                first, _k, _v, _lp = engine._prefill_impl(
                    tokens, positions, bucket, -1, SamplingParams())
                return first

            prefill_points.append((bucket, _time_call(call, repeats)))

        n_steps = max(1, engine.cfg.decode_steps_per_sync)
        b_slots = engine.cfg.decode_slots
        saved = {name: getattr(engine, f"_slot_{name}").copy()
                 for name in _CARRY + ("lora",)}
        decode_points = []
        if engine._graphs is not None and engine._graphs._pool is None:
            # An engine not started yet: the graphs' eager warm-up (every
            # row inactive) that ``Engine.start`` runs.
            engine._graphs.warm_up(engine._decode_block)
        try:
            engine._slot_lora[:] = -1
            for fill in decode_fills:
                if fill >= engine.cfg.max_seq_len:
                    continue

                def call(fill=fill):
                    # The block advances the carry in place: every call
                    # starts from the same fill, every row live.
                    engine._slot_tokens[:] = 0
                    engine._slot_positions[:] = fill
                    engine._slot_remaining[:] = 1 << 20
                    engine._push(_CARRY)
                    return engine._run_block(n_steps)

                decode_points.append(
                    (float(b_slots * fill),
                     _time_call(call, repeats) / n_steps))
        finally:
            for name, value in saved.items():
                getattr(engine, f"_slot_{name}")[:] = value
            engine._push(_CARRY)
    return fit(prefill_points, decode_points, b_slots)


def model_to_dict(model: dict) -> dict:
    """The artifact's ``model`` block: rounded, in the schema's order."""
    return {k: round(float(model[k]), nd) for k, nd in _MODEL_ROUND.items()}


def calibration_artifact(model: dict, residuals: dict, source: str,
                         seed: int | None = None) -> dict:
    art = {
        "format": CALIBRATION_FORMAT,
        "source": source,
        "model": model_to_dict(model),
        "residuals": residuals,
    }
    if seed is not None:
        art["seed"] = seed
    return art


def write_calibration(path: str, artifact: dict) -> None:
    """Stable serialization (sorted keys, indent 1, trailing newline)."""
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")


def bench_model_cfg(device: str):
    """The model the reference's engine fit times: a ~1.1B Llama-3-shaped
    model on the card, a tiny one on the CPU."""
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B

    if device == "cpu":
        return dataclasses.replace(
            LLAMA3_8B, name="bench-cpu", vocab_size=512, d_model=128,
            n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, head_dim=32,
            max_seq_len=512, max_lora_slots=4, max_lora_rank=8)
    return dataclasses.replace(
        LLAMA3_8B, name="bench-llama-1b", vocab_size=32_000, d_model=2048,
        n_layers=16, n_heads=16, n_kv_heads=8, d_ff=8192, head_dim=128,
        max_seq_len=512, max_lora_slots=4, max_lora_rank=8,
        use_flash_attention=True)


def engine_fit(device: str = "cuda") -> tuple[dict, dict, str]:
    """Build the reference's calibration engine (``bench_model_cfg``,
    random weights from seed 0) and fit it.  Returns (constants,
    residuals, model name)."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine,
        EngineConfig,
    )

    on_cpu = device == "cpu"
    cfg = bench_model_cfg(device)
    dtype = torch.float32 if on_cpu else torch.bfloat16
    params = transformer.init_params(cfg, seed=0, dtype=dtype, device=device)
    engine = Engine(
        cfg, params,
        EngineConfig(decode_slots=4 if on_cpu else 16,
                     max_seq_len=cfg.max_seq_len,
                     prefill_buckets=(32, 64, 128) if on_cpu
                     else (64, 128, 256, 384),
                     decode_steps_per_sync=1 if on_cpu else 8),
        dtype=dtype, device=device)
    constants = calibrate_from_engine(engine)
    return (constants, {"windows": 0,
                        "note": "engine-timed fit, no residuals"}, cfg.name)


def main(argv: list | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="time the torch engine, fit the simulator's "
                    "LatencyModel and emit the versioned calibration "
                    "artifact the capacity twin loads")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the card times the reference's ~1.1B "
                             "calibration model; the CPU a tiny one")
    parser.add_argument("--out", default="",
                        help="write the artifact JSON here; default prints "
                             "it to stdout")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    model, residuals, name = engine_fit(args.device)
    artifact = calibration_artifact(model, residuals, f"engine:{name}")
    if args.out:
        write_calibration(args.out, artifact)
        print(f"wrote {args.out} ({artifact['source']}, "
              f"{artifact['residuals'].get('windows', 0)} windows)")
    else:
        print(json.dumps(artifact, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
