"""A benchmark root holding tiny cells (the port's ``qwen-tiny`` and
``mixtral-tiny`` presets, f32 on the CPU), for running the harness here:
``make_root(dir)`` writes ``BENCHMARK.json``, two configurations and two
mixes under ``dir`` and copies the metric readers."""
from __future__ import annotations

import json
import os
import shutil

from benchmark import spec

SERVER = ["--device", "cpu", "--dtype", "float32", "--decode-slots", "8",
          "--max-seq-len", "256", "--prefill-buckets", "16", "32", "64",
          "--paged-kv-block", "16", "--paged-kv-blocks", "96",
          "--prefix-cache", "--stream-lanes", "2", "--prefill-batch", "4",
          "--pipeline-decode", "--adaptive-steps", "8", "--max-loras", "4"]
# f32 on both sides: the gap is rounding, far under this.
LIMIT = 1e-3

QWEN = {"name": "tiny-qwen", "reduced": [], "weights": "f32",
        "model": {"model_type": "qwen2", "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "num_key_value_heads": 1,
                  "vocab_size": 320, "rope_theta": 1000000.0,
                  "rms_norm_eps": 1e-6},
        "server": ["--model", "qwen-tiny"] + SERVER,
        "check": {"sample": 4, "control": "fp8",
                  "limits": {"mean_logit_gap": LIMIT,
                             "mean_logprob_error": LIMIT}}}
MOE = {"name": "tiny-moe", "reduced": [], "weights": "int8",
       "model": {"model_type": "mixtral", "hidden_size": 64,
                 "intermediate_size": 128, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "num_key_value_heads": 1,
                 "num_local_experts": 8, "num_experts_per_tok": 2,
                 "vocab_size": 320, "rope_theta": 1000000.0,
                 "rms_norm_eps": 1e-5},
       "server": ["--model", "mixtral-tiny", "--quantize", "int8"] + SERVER,
       "check": {"sample": 4, "control": "int4",
                 "limits": {"mean_logit_gap": LIMIT}}}
# Prompts past the largest bucket (64) chunk-stream; shared prefixes hit.
CHAT = {"loop": "open", "rate_rps": 6.0,
        "prefixes": {"count": 4, "tokens": 32, "zipf": 1.1},
        "suffix": {"median": 24, "sigma": 0.9, "min": 4, "max": 120},
        "output": {"median": 8, "sigma": 0.8, "min": 2, "max": 24},
        "adapters": {"count": 4, "rank": 4, "per_prefix": 1,
                     "base_share": 0.2},
        "greedy_share": 0.5, "temperature": 0.8, "top_p": 0.95,
        "warmup": {"requests": 4, "max_new_tokens": 4}, "drain_s": 30,
        "compare": "mean_logprob_error", "size_seed": 1}
CLOSED = {"loop": "closed", "clients": 6, "pool": 64,
          "prefixes": {"count": 1, "tokens": 32, "zipf": 0.0},
          "suffix": {"median": 40, "sigma": 0.6, "min": 8, "max": 150},
          "output": {"median": 12, "sigma": 0.7, "min": 2, "max": 40},
          "adapters": {"count": 2, "rank": 4, "base_share": 0.5},
          "greedy_share": 1.0, "warmup": {"requests": 4, "max_new_tokens": 4},
          "size_seed": 2}
CELLS = {"tiny-qwen.chat": ("tiny-qwen", "chat"),
         "tiny-moe.rag": ("tiny-moe", "closed")}
# The real cells' metrics, moved onto the tiny ones.
RENAME = {"qwen2.5-7b.chat": "tiny-qwen.chat",
          "qwen2.5-7b.reasoning": "tiny-moe.rag",
          "mixtral-8x7b-w8.rag": "tiny-moe.rag"}


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(d: str) -> str:
    shutil.copytree(os.path.join(spec.HERE, "metrics"),
                    os.path.join(d, "benchmark", "metrics"))
    for c in (QWEN, MOE):
        write(os.path.join(d, "benchmark", "configs", c["name"] + ".json"), c)
    write(os.path.join(d, "benchmark", "traffic", "chat.json"), CHAT)
    write(os.path.join(d, "benchmark", "traffic", "closed.json"), CLOSED)
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [
        {"name": c["name"], "source": "tiny preset",
         "file": f"benchmark/configs/{c['name']}.json", "reduced": [],
         "why": "CPU rehearsal"} for c in (QWEN, MOE)]
    bench["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1,
         "why": "CPU rehearsal"} for n, (c, t) in CELLS.items()]
    for met in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in met:
            met["workloads"] = sorted({RENAME[w] for w in met["workloads"]})
    write(os.path.join(d, "BENCHMARK.json"), bench)
    return d
