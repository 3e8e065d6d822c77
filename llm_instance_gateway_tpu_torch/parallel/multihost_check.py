"""Two-process checks: the engine serves, and a train step trains, over a
mesh that spans processes (port of ``parallel/multihost_check.py``).

A replica may span hosts: every process holds its shards and the
collectives between them (``parallel/collectives.py``) ride the link
between processes, where NCCL or gloo sits between hosts.  Serving is the
hard half, since the engine is a host-driven loop: every process must
issue the same collectives in the same order (multi-controller SPMD), so

- every request is submitted BEFORE ``start()``, slots >= requests, equal
  budgets, greedy sampling and one engine seed: both loops admit, prefill
  and decode in lockstep, with no branch on timing;
- the logits are whole on every process (the embedding, norms and head
  run everywhere), so each samples the same tokens and reads them back.

``run_two_process`` is the one launch scaffold for every two-process check
(``tests/test_torch_multihost.py``, the smoke's ``processes`` phase): it
sets the env contract the manifests set (``TPU_GATEWAY_COORDINATOR`` /
``_PROCESS_ID`` / ``_NUM_PROCESSES``) and the check's own variables
(``GRAFT_REPO``, ``GRAFT_N_LOCAL``: the positions each process holds, as
the reference's virtual devices per process), and turns a hung pair into
a ``RuntimeError`` at its deadline.  The workers import the port only.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SERVE_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import dataclasses

import torch

from llm_instance_gateway_tpu_torch.parallel import multihost_check
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world,
)

initialize_distributed()
rank, size = world()
assert size == 2, size

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request, SamplingParams,
)

# The reference's check config (its XLA-attention flags aside: the port's
# attention always runs through its kernel wrappers, plain on the CPU).
cfg = dataclasses.replace(
    LLAMA3_8B, name="multihost-serve", vocab_size=256, d_model=64,
    n_layers=2, n_heads=8, n_kv_heads=8, d_ff=128, head_dim=8,
    max_seq_len=64,
)
n_local = int(os.environ["GRAFT_N_LOCAL"])
mesh = make_mesh(parse_axes(os.environ.get("GRAFT_MESH", "tensor=8")),
                 ["cpu"] * n_local)
weights = os.environ.get("GRAFT_WEIGHTS")
params = (multihost_check.load_tree(weights) if weights else
          transformer.init_params(cfg, seed=0, dtype=torch.float32,
                                  device="cpu"))
engine = Engine(
    cfg, params,
    EngineConfig(decode_slots=2, max_seq_len=64, prefill_buckets=(16,)),
    eos_id=None, dtype=torch.float32, seed=0, device="cpu", mesh=mesh,
    cuda_graphs=False,
)
del params
reqs = [
    Request(prompt_tokens=[5, 6, 7], max_new_tokens=6,
            sampling=SamplingParams(temperature=0.0)),
    Request(prompt_tokens=[9, 10, 11, 12], max_new_tokens=6,
            sampling=SamplingParams(temperature=0.0)),
]
# Submit BEFORE start: both processes' loops see the same full queue on
# their first admission pass -- no timing-dependent divergence.
for r in reqs:
    engine.submit(r)
engine.start()
try:
    for r in reqs:
        assert r.done.wait(240), "request hung"
        assert r.error is None, r.error
finally:
    engine.stop()
toks = ";".join(",".join(map(str, r.output_tokens)) for r in reqs)
print(f"MULTIHOST SERVE OK pid={rank} tokens={toks}", flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save_tree(path: str, tree: dict) -> None:
    """A nested dict of tensors or arrays as one ``.npz``, keys joined by
    ``/`` (a bf16 leaf bit-exact as uint16 under a ``:bf16`` suffix)."""
    flat = {}

    def walk(x, prefix):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
            return
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            bf16 = x.dtype == torch.bfloat16
            x = (x.view(torch.int16) if bf16 else x).numpy()
        else:
            x = np.asarray(x)
            bf16 = x.dtype.name == "bfloat16"
        if bf16:
            flat[prefix + ":bf16"] = x.view(np.uint16)
        else:
            flat[prefix] = x

    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path: str, device="cpu") -> dict:
    """``save_tree``'s file as a port tree of tensors on ``device``."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, _, kind = key.partition(":")
            t = torch.from_numpy(z[key].copy())
            if kind == "bf16":
                t = t.view(torch.bfloat16)
            node = out
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.to(device)
    return out


def run_two_process(worker_src: str, n_local: int = 4,
                    timeout_s: float = 300.0,
                    env: dict | None = None) -> list[str]:
    """Launch ``worker_src`` in 2 coordinated processes (``n_local`` mesh
    positions each, ``GRAFT_N_LOCAL``) under the env contract the
    manifests set, plus ``env``.  Returns both processes' combined
    stdout/stderr; raises ``RuntimeError`` on a non-zero exit, and at
    ``timeout_s`` kills a pair that has not ended and raises."""
    return run_processes(worker_src, 2, n_local, timeout_s, env)


def run_processes(worker_src: str, n_processes: int, n_local: int = 4,
                  timeout_s: float = 300.0,
                  env: dict | None = None) -> list[str]:
    """``run_two_process`` over ``n_processes`` processes (one a card on a
    host of several)."""
    port = free_port()
    procs = []
    files = []
    timed_out = False
    try:
        for pid in range(n_processes):
            penv = dict(os.environ)
            penv["PYTHONPATH"] = REPO + os.pathsep + penv.get("PYTHONPATH",
                                                               "")
            penv["GRAFT_REPO"] = REPO
            penv["GRAFT_N_LOCAL"] = str(n_local)
            penv["TPU_GATEWAY_COORDINATOR"] = f"127.0.0.1:{port}"
            penv["TPU_GATEWAY_PROCESS_ID"] = str(pid)
            penv["TPU_GATEWAY_NUM_PROCESSES"] = str(n_processes)
            penv.update(env or {})
            # Temp FILES, not pipes: a worker blocked writing a full 64KiB
            # pipe while its peer waits in a cross-process collective would
            # deadlock the pair (nobody drains until communicate()).
            f = tempfile.TemporaryFile(mode="w+", encoding="utf-8",
                                       errors="replace")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", worker_src], env=penv,
                stdout=f, stderr=subprocess.STDOUT, text=True,
            ))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            remaining = deadline - time.monotonic()
            try:
                p.wait(timeout=max(0.1, remaining))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if timed_out:
        raise RuntimeError(
            f"{n_processes}-process worker timed out:\n"
            + "\n---\n".join(o[-2000:] for o in outs))
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        # Every failed process's tail: the one that failed first is often
        # not the first listed (its peers fail after it, in a collective).
        raise RuntimeError(
            f"{n_processes}-process worker failed:\n" + "\n---\n".join(
                f"[process {i}, exit {procs[i].returncode}]\n"
                f"{outs[i][-3000:]}" for i in failed))
    return outs


def ok_lines(outs: list[str], tag: str) -> list[str]:
    """Each process's first line that starts with ``tag`` (its result);
    raises ``RuntimeError`` where one printed none."""
    got = []
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith(tag)]
        if not lines:
            raise RuntimeError(f"no {tag!r} line:\n{out[-3000:]}")
        got.append(lines[0])
    return got


def run_two_process_serve(timeout_s: float = 300.0, mesh: str = "tensor=8",
                          weights: str | None = None) -> list[str]:
    """Serving check: the per-process token strings (len 2) of
    ``SERVE_WORKER`` over ``mesh`` (4 positions a process), on the port's
    seeded weights or the ``save_tree`` file ``weights``; the caller
    asserts they match.  Raises ``RuntimeError`` on any failure."""
    env = {"GRAFT_MESH": mesh}
    if weights:
        env["GRAFT_WEIGHTS"] = weights
    outs = run_two_process(SERVE_WORKER, timeout_s=timeout_s, env=env)
    return [line.rsplit("tokens=", 1)[1]
            for line in ok_lines(outs, "MULTIHOST SERVE OK")]
