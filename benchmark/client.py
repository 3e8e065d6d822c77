"""The client side of the window: requests into ``Engine.submit`` on a
schedule (open loop) or from a fixed number of clients (closed loop), and
what each request saw, on the host clock (``time.time()``, the clock the
engine stamps ``Request`` with).

Each request's ``output_tokens`` is a list that stamps every append, so
the time each token was emitted is known without changing the engine.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class Stamped(list):
    """An output-token list that records when each token was appended."""

    def __init__(self):
        super().__init__()
        self.times: list = []

    def append(self, tok):
        self.times.append(time.time())
        super().append(tok)


@dataclass
class Record:
    """One request of the window and what it saw."""
    index: int
    prefix: int
    shared: int                 # tokens of its shared prefix
    prompt: list
    adapter: int
    greedy: bool
    max_new_tokens: int
    due: float                  # host time it was due
    req: object = None          # the engine's Request
    error: str | None = None
    tokens: list = field(default_factory=list)
    logprobs: list | None = None  # the engine's, where the request asked
    emit: list = field(default_factory=list)
    finished: bool = False
    t_submit: float = 0.0
    t_prefill_start: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    def settle(self) -> None:
        """Copy what the request holds now."""
        r = self.req
        if r is None:
            return
        # The engine appends a token, then its logprob: read the logprobs
        # first, so a request still running holds no logprob past them.
        if r.logprobs is not None:
            self.logprobs = list(r.output_logprobs)
        self.tokens = list(r.output_tokens)
        self.emit = list(r.output_tokens.times)[:len(self.tokens)]
        self.finished = r.done.is_set() and r.error is None
        if r.error and not self.error:
            self.error = r.error
        self.t_submit = r.t_submit
        self.t_prefill_start = r.t_prefill_start
        self.t_first_token = r.t_first_token
        self.t_done = r.t_done if r.done.is_set() else 0.0


def make_request(p, adapter_names: list, mix: dict):
    """The engine's Request for planned request ``p``; a greedy one asks
    for its tokens' logprobs where the mix's check compares them."""
    from llm_instance_gateway_tpu_torch.server.engine import (
        Request, SamplingParams)
    sp = (SamplingParams() if p.greedy else SamplingParams(
        temperature=mix.get("temperature", 1.0), top_p=mix.get("top_p", 1.0),
        seed=p.sample_seed))
    req = Request(prompt_tokens=list(p.prompt),
                  max_new_tokens=p.max_new_tokens, sampling=sp,
                  adapter=adapter_names[p.adapter] if p.adapter >= 0 else None,
                  logprobs=(0 if p.greedy and mix.get("compare")
                            == "mean_logprob_error" else None))
    req.output_tokens = Stamped()
    return req


def _submit(engine, p, due: float, adapter_names, mix) -> Record:
    shared = mix["prefixes"]["tokens"] if p.prefix >= 0 else 0
    rec = Record(index=p.index, prefix=p.prefix, shared=shared,
                 prompt=p.prompt,
                 adapter=p.adapter, greedy=p.greedy,
                 max_new_tokens=p.max_new_tokens, due=due)
    req = make_request(p, adapter_names, mix)
    try:
        engine.submit(req)
        rec.req = req
    except Exception as e:  # refused: the queue is full, or invalid
        rec.error = f"{type(e).__name__}: {e}"
    return rec


def run_open(engine, planned: list, t0: float, seconds: float,
             drain_s: float, adapter_names: list, mix: dict) -> list:
    """Send each request at ``t0 + due``; then wait for the window's
    requests until ``t0 + seconds + drain_s``."""
    recs = []
    for p in planned:
        due = t0 + p.due
        wait = due - time.time()
        if wait > 0:
            time.sleep(wait)
        recs.append(_submit(engine, p, due, adapter_names, mix))
    deadline = t0 + seconds + drain_s
    for rec in recs:
        if rec.req is not None:
            rec.req.done.wait(max(0.0, deadline - time.time()))
    for rec in recs:
        rec.settle()
    return recs


def run_closed(engine, planned: list, start: float, t1: float,
               clients: int, adapter_names: list, mix: dict) -> list:
    """``clients`` clients from ``start``, each sending the next request
    of ``planned`` as soon as its last one finished, until ``t1``;
    requests in flight then are cut there."""
    lock = threading.Lock()
    queue = iter(planned)
    recs: list = []

    def client():
        while time.time() < t1:
            with lock:
                p = next(queue, None)
            if p is None:
                return
            rec = _submit(engine, p, time.time(), adapter_names, mix)
            with lock:
                recs.append(rec)
            if rec.req is None:
                return
            rec.req.done.wait(max(0.0, t1 - time.time()))

    wait = start - time.time()
    if wait > 0:
        time.sleep(wait)
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rec in recs:
        rec.settle()
    return sorted(recs, key=lambda r: r.index)
