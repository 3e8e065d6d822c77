"""Two-process checks: the engine serves, and a train step trains, over a
mesh that spans processes (port of ``parallel/multihost_check.py``).

A replica may span hosts: every process holds its shards and the
collectives between them (``parallel/collectives.py``) ride the link
between processes, where NCCL or gloo sits between hosts.  Serving is the
hard half, since the engine is a host-driven loop: every process must
issue the same collectives in the same order (multi-controller SPMD), so

- every request is submitted BEFORE ``start()``, with greedy sampling
  (or seeds alike) and one engine seed: every process's loop, the sync
  one or the pipelined one, with or without the adaptive planner, admits,
  prefills and decodes in lockstep, each decision read from the queue,
  the parked list, the streams and the slots; the one that reads the
  clock, the handoff TTL sweep, is the first process's, broadcast;
- the logits are whole on every process (the embedding, norms and head
  run everywhere), so each samples the same tokens and reads them back.

``SERVE_WORKER`` serves the reference's check config in one engine a run
(``serve_run``: the mesh, the ``EngineConfig`` options, the prompts, a
``seeded_handoff`` attached after them, the processes whose engine clock
stands still); ``serve`` is its body, which the one-process references
and the smoke call too.

``run_two_process`` is the one launch scaffold for every two-process check
(``tests/test_torch_multihost.py``, the smoke's ``processes`` phase): it
sets the env contract the manifests set (``TPU_GATEWAY_COORDINATOR`` /
``_PROCESS_ID`` / ``_NUM_PROCESSES``) and the check's own variables
(``GRAFT_REPO``, ``GRAFT_N_LOCAL``: the positions each process holds, as
the reference's virtual devices per process), and turns a hung pair into
a ``RuntimeError`` at its deadline.  The workers import the port only.
"""

from __future__ import annotations

import hashlib
import json
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
import json, os, sys
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
from llm_instance_gateway_tpu_torch.server.engine import Engine, EngineConfig

# The reference's check config (its XLA-attention flags aside: the port's
# attention always runs through its kernel wrappers, plain on the CPU).
cfg = dataclasses.replace(LLAMA3_8B, **multihost_check.SERVE_CFG)
n_local = int(os.environ["GRAFT_N_LOCAL"])
weights = os.environ.get("GRAFT_WEIGHTS")
params = (multihost_check.load_tree(weights) if weights else
          transformer.init_params(cfg, seed=0, dtype=torch.float32,
                                  device="cpu"))
# One engine a run, in the order given (every process the same order:
# each mesh makes its process groups collectively).
for run in json.loads(os.environ["GRAFT_RUNS"]):
    mesh = make_mesh(parse_axes(run["mesh"]), ["cpu"] * n_local)
    engine = Engine(
        cfg, params,
        EngineConfig(**{**multihost_check.SERVE_ENGINE, **run["engine"]}),
        eos_id=None, dtype=torch.float32, seed=0, device="cpu", mesh=mesh,
        cuda_graphs=False,
    )
    handoff = (multihost_check.seeded_handoff(cfg, **run["handoff"])
               if run["handoff"] else None)
    res = multihost_check.serve(
        engine, run["prompts"], run["max_new"], handoff=handoff,
        freeze_clock=rank in run["frozen"], idle_s=run["idle_s"])
    del engine
    print(f"MULTIHOST SERVE OK pid={rank} run={run['name']} "
          + json.dumps(res), flush=True)
"""

# The reference's serving check: its model config, engine config and
# requests (greedy, every request submitted before ``start()``).
SERVE_CFG = dict(name="multihost-serve", vocab_size=256, d_model=64,
                 n_layers=2, n_heads=8, n_kv_heads=8, d_ff=128, head_dim=8,
                 max_seq_len=64)
SERVE_ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(16,))
SERVE_PROMPTS = ([5, 6, 7], [9, 10, 11, 12])


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


class _FrozenClock:
    """The ``time`` module with ``time()`` standing at ``t`` (a check's
    seam: the engine's clock, swapped in by ``serve``)."""

    def __init__(self, t: float):
        self._t = t

    def time(self) -> float:
        return self._t

    def __getattr__(self, name):
        return getattr(time, name)


def seeded_handoff(cfg, n: int, seed: int, max_new: int = 6,
                   dtype: torch.dtype = torch.float32):
    """A ``PrefillHandoff`` of an ``n``-token prompt for ``cfg`` whose
    prompt, KV and first token come from numpy's ``RandomState(seed)``:
    the same wire bytes in every process and on every host."""
    from llm_instance_gateway_tpu_torch.server import kv_transfer
    from llm_instance_gateway_tpu_torch.server.engine import Request

    rng = np.random.RandomState(seed)
    prompt = rng.randint(1, cfg.vocab_size, size=n).tolist()
    shape = (cfg.n_layers, 1, n, cfg.n_kv_heads, cfg.resolved_head_dim)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(2))
    req = Request(prompt_tokens=prompt, max_new_tokens=max_new,
                  request_id=f"handoff-{seed}")
    return kv_transfer.export_handoff(req, k, v, n,
                                      int(rng.randint(1, cfg.vocab_size)))


def serve(engine, prompts, max_new, handoff=None,
          freeze_clock: bool = False, idle_s: float = 0.0,
          timeout_s: float = 240.0) -> dict:
    """Serve ``prompts`` greedily (``max_new`` tokens each, or a budget a
    prompt) and then ``handoff``, every one submitted before ``start()``
    (the lockstep rule), the engine's clock stood still with
    ``freeze_clock`` and the loop left idle for ``idle_s`` first.  Returns each request's tokens
    and finish reason (the handoff's last), the dispatch histogram's
    counts and its steps, the ``collectives.broadcast`` calls, the
    admission paths taken (ring programs, chunk streams, parks), the
    ``kv_release`` events and the KV ledger's sweeps, the handoff's wire
    hash and the wall."""
    from llm_instance_gateway_tpu_torch.parallel import collectives
    from llm_instance_gateway_tpu_torch.server import engine as engine_mod
    from llm_instance_gateway_tpu_torch.server.engine import (
        Request,
        SamplingParams,
    )

    events: list = []
    engine.event_sink = lambda kind, **a: events.append(dict(a, kind=kind))
    budgets = ([max_new] * len(prompts) if isinstance(max_new, int)
               else list(max_new))
    reqs = [engine.submit(Request(
        prompt_tokens=list(p), max_new_tokens=m,
        sampling=SamplingParams(temperature=0.0)))
        for p, m in zip(prompts, budgets)]
    if handoff is not None:
        reqs.append(engine.attach_prefilled(handoff))
    # The admission paths taken: ring programs, chunk streams, parks.
    paths = {"ring": 0, "stream": 0, "park": 0}
    for name, key in (("_ring", "ring"), ("_start_stream", "stream"),
                      ("_park_waiting", "park")):
        fn = getattr(engine, name)
        if fn is not None:
            setattr(engine, name, lambda *a, _fn=fn, _key=key, **kw: (
                paths.__setitem__(_key, paths[_key] + 1) or _fn(*a, **kw)))
    hist = engine.dispatch_steps_hist
    counts0, steps0 = list(hist.state()["counts"]), hist.state()["sum"]
    calls = []
    plain, clock = collectives.broadcast, engine_mod.time
    collectives.broadcast = lambda *a: calls.append(1) or plain(*a)
    if freeze_clock:
        engine_mod.time = _FrozenClock(time.time())
    t0 = time.time()
    engine.start()
    try:
        time.sleep(idle_s)
        for r in reqs:
            if not r.done.wait(timeout_s):
                raise RuntimeError(f"request {r.request_id} hung")
    finally:
        engine.stop()
        collectives.broadcast, engine_mod.time = plain, clock
    state = hist.state()
    ledger = (engine.kv_ledger.snapshot()["ring"]
              if engine.kv_ledger is not None else [])
    return {
        "tokens": [list(map(int, r.output_tokens)) for r in reqs],
        "finish": [r.finish_reason for r in reqs],
        "errors": [r.error for r in reqs if r.error is not None],
        "dispatch_counts": [a - b for a, b in zip(state["counts"], counts0)],
        "dispatch_steps": int(state["sum"] - steps0),
        "broadcasts": len(calls), "paths": paths,
        "kv_release": [e for e in events if e["kind"] == "kv_release"],
        "ledger_sweeps": [e["reason"] for e in ledger
                          if e["kind"] == "sweep"],
        "handoff_sha256": (hashlib.sha256(handoff.to_bytes()).hexdigest()
                           if handoff is not None else None),
        "wall_s": time.time() - t0,
    }


def serve_run(name: str = "serve", mesh: str = "tensor=8",
              engine: dict | None = None, prompts=SERVE_PROMPTS,
              max_new: int = 6, handoff: dict | None = None,
              frozen=(), idle_s: float = 0.0) -> dict:
    """One run of ``SERVE_WORKER``: an engine over ``mesh`` with
    ``SERVE_ENGINE`` updated by ``engine`` (the ``EngineConfig`` fields),
    serving ``prompts`` and then the ``seeded_handoff`` of ``handoff``
    (its keyword arguments), the engine clock frozen in the processes
    ``frozen`` names (``serve``)."""
    return {"name": name, "mesh": mesh, "engine": dict(engine or {}),
            "prompts": [list(p) for p in prompts], "max_new": max_new,
            "handoff": handoff, "frozen": list(frozen), "idle_s": idle_s}


def run_two_process_serves(runs: list, weights: str | None = None,
                           timeout_s: float = 300.0) -> list:
    """``SERVE_WORKER``'s ``runs`` (``serve_run``'s dicts) in one launch of
    two processes (4 positions each), on the port's seeded weights or the
    ``save_tree`` file ``weights``: per process, each run's ``serve``
    result in order.  Raises ``RuntimeError`` on any failure."""
    env = {"GRAFT_RUNS": json.dumps(runs)}
    if weights:
        env["GRAFT_WEIGHTS"] = weights
    outs = run_two_process(SERVE_WORKER, timeout_s=timeout_s, env=env)
    got = []
    for out in outs:
        lines = [line.split(" run=", 1)[1] for line in out.splitlines()
                 if line.startswith("MULTIHOST SERVE OK ")]
        if len(lines) != len(runs):
            raise RuntimeError(f"{len(lines)} of {len(runs)} runs "
                               f"served:\n{out[-3000:]}")
        got.append([json.loads(line.split(" ", 1)[1]) for line in lines])
    return got


def run_two_process_serve(timeout_s: float = 300.0, mesh: str = "tensor=8",
                          weights: str | None = None,
                          **options) -> list[str]:
    """Serving check: the per-process token strings (len 2) of one
    ``SERVE_WORKER`` run over ``mesh`` (4 positions a process), with
    ``serve_run``'s ``options`` (the engine's options, the requests, a
    handoff), on the port's seeded weights or the ``save_tree`` file
    ``weights``, in the reference check's printed form (each request's
    tokens comma-joined, the requests joined by ``;``); the caller
    asserts they match.  Raises ``RuntimeError`` on any failure."""
    res = run_two_process_serves([serve_run(mesh=mesh, **options)],
                                 weights, timeout_s)
    return [";".join(",".join(map(str, t)) for t in r[0]["tokens"])
            for r in res]
