"""What decides ``correct``: the served tokens of a sample of the window's
greedy requests against the plain reference.

The sample is drawn from the run's seed among the greedy requests the
window finished, with the one that served the most tokens always in it
(and one on an adapter and one on the base model, where there are such);
where fewer than the configuration's ``sample`` finished, the greedy
requests the window's close cut short fill it (their tokens served so far
are the program's output too).  The reference runs once over each prompt
and its served tokens.  Two numbers are read over every served token of
the sample; a cell compares the one its mix names (``compare``):

* ``mean_logit_gap``: how far the token's reference logit lies below the
  reference's best at its position.  A greedy program serves the
  reference's best token up to rounding, so only near-ties flip and the
  gap stays near the rounding of the served precision; a wrong token, a
  dropped adapter delta or a coarser precision widens it.  It reads only
  the positions that flip: a request caught in a wide-margin repetition
  (random weights) reads 0 in any precision.
* ``mean_logprob_error``: how far the program's logprob of the token (the
  request asked for it) lies from the reference's best logprob at its
  position.  It reads the program's arithmetic at every position, loops
  included, and a token that is not the reference's best adds its gap.

The widest gap, one near-tie among a few thousand tokens, is logged
beside them.

The control (``control=``, one of ``reference.CONTROLS``) is the reference
in a lower precision put in the program's place: at each position its
first token stands for the served token, and its logprob of that token
(its logits rounded to the served type, as the program's are) for the
program's.  Its numbers go through the same limit.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import reference, weights


def sample(records: list, seed: int, k: int) -> list:
    """Up to ``k`` greedy records with at least one served token: the
    longest finished one, then finished ones drawn from ``seed`` (one on
    an adapter and one on the base model first, where the window has
    them), then the longest of those cut at the close."""
    greedy = [r for r in records if r.greedy and len(r.tokens) >= 1
              and not r.error]
    done = sorted((r for r in greedy if r.finished),
                  key=lambda r: (-len(r.tokens), r.index))
    cut = sorted((r for r in greedy if not r.finished),
                 key=lambda r: (-len(r.tokens), r.index))
    out = done[:1]
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 7])
    rest = [done[1:][int(i)] for i in rng.permutation(len(done) - 1)] \
        if len(done) > 1 else []
    for want in (lambda r: r.adapter >= 0, lambda r: r.adapter < 0):
        if not any(want(r) for r in out):
            first = next((r for r in rest if want(r)), None)
            if first is not None:
                out.append(first)
                rest.remove(first)
    out += rest[:max(0, k - len(out))]
    out += cut[:max(0, k - len(out))]
    return out[:k]




def _read(ref: torch.Tensor, best_lp: torch.Tensor, tokens: list,
          logprobs, finished: bool = True) -> tuple:
    """Per position: the gap of ``tokens`` and, where ``logprobs`` (the
    producer's logprob of each token) are given, their distance from the
    reference's best logprob.  A finished request carries one logprob a
    token; one the window's close cut is read as far as its logprobs go."""
    gap = reference.served_gaps(ref, tokens)
    if logprobs is None:
        return gap, None
    n = len(logprobs)
    if n > len(tokens) or (finished and n != len(tokens)):
        return gap, torch.full_like(gap, float("inf"))
    lp = torch.tensor(logprobs, dtype=torch.float32, device=ref.device)
    return gap, (lp - best_lp[:n]).abs()


def _summary(reads: list) -> dict:
    gaps = [g for g, _ in reads]
    errs = [e for _, e in reads if e is not None and len(e)]
    out = {"mean_logit_gap": float(torch.cat(gaps).mean()) if gaps else 0.0,
           "widest_logit_gap": max((float(g.max()) for g in gaps),
                                   default=0.0)}
    if errs:
        out["mean_logprob_error"] = float(torch.cat(errs).mean())
    return out


def gaps(model_spec: dict, params: dict, picked: list, control=None,
         adapters=None, served_dtype=torch.float32) -> dict:
    """The numbers over ``picked``: ``{"program": {...}, "tokens",
    "requests"}``, and ``"control"`` where ``control`` names one of
    ``reference.CONTROLS``.  ``adapters`` maps an adapter index to the
    weights the run made; ``served_dtype`` is the type the program's
    logits come in."""
    m = weights.dims(model_spec)
    seqs = [list(r.prompt) + list(r.tokens[:-1]) for r in picked]
    rows = [list(range(len(r.prompt) - 1, len(t)))
            for r, t in zip(picked, seqs)]
    ads = [{"w": adapters[r.adapter], "scale": 1.0} if r.adapter >= 0
           else None for r in picked]
    with torch.no_grad():
        ref = reference.Model(m, params).logits(seqs, rows, ads)
        low = (reference.Model(m, params, reference.CONTROLS[control])
               .logits(seqs, rows, ads) if control else None)
    prog, ctl, per = [], [], []
    for j, r in enumerate(picked):
        lg = ref[j]
        best_lp = lg.max(dim=-1).values - torch.logsumexp(lg, dim=-1)
        lps = r.logprobs
        prog.append(_read(lg, best_lp, list(r.tokens), lps, r.finished))
        row = {"request": r.index, "prompt": len(r.prompt),
               "served": len(r.tokens), "adapter": r.adapter,
               **_summary(prog[-1:])}
        if low is not None:
            lc = low[j].to(served_dtype).float()
            tok = lc.argmax(dim=-1)
            lp = (lc.gather(1, tok[:, None])[:, 0]
                  - torch.logsumexp(lc, dim=-1))
            ctl.append(_read(lg, best_lp, tok.tolist(),
                             None if lps is None else lp.tolist()))
            row["control"] = _summary(ctl[-1:])
        per.append(row)
    out = {"program": _summary(prog),
           "tokens": sum(len(r.tokens) for r in picked), "requests": per}
    if low is not None:
        out["control"] = _summary(ctl)
    return out
