"""Token sampling and the device-side stop automaton (port of
``server/sampling.py`` and ``engine._logprob_info``).

Everything is batched tensor math on the logits' device, so a fused decode
block never syncs with the host per token.  Per-row parameters arrive as
tensors; one batch mixes greedy, temperature, top-k and top-p rows.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# Device stop-automaton lanes (the OpenAI surface caps `stop` at 4 strings).
STOP_SEQS = 4
STOP_LEN = 8

# Top-K alternatives computed per step (the OpenAI completions maximum).
LOGPROB_TOPK = 5

_M32 = 0xFFFFFFFF


def encode_stop_rows(sequences):
    """(ids [STOP_SEQS][STOP_LEN] right-aligned -1-padded, lens [STOP_SEQS])
    for one row's stop sequences, or ``None`` when they do not fit."""
    seqs = [tuple(int(t) for t in s) for s in sequences]
    if len(seqs) > STOP_SEQS or any(not s or len(s) > STOP_LEN for s in seqs):
        return None
    ids = [[-1] * STOP_LEN for _ in range(STOP_SEQS)]
    lens = [0] * STOP_SEQS
    for j, s in enumerate(seqs):
        ids[j][STOP_LEN - len(s):] = list(s)
        lens[j] = len(s)
    return ids, lens


def stop_hist_update(hist: torch.Tensor, sampled: torch.Tensor,
                     advance: torch.Tensor) -> torch.Tensor:
    """Shift each advancing row's token history left and append the newly
    sampled token; frozen rows keep theirs."""
    shifted = torch.cat([hist[:, 1:], sampled[:, None].to(hist.dtype)], dim=1)
    return torch.where(advance[:, None], shifted, hist)


def stop_suffix_hit(hist: torch.Tensor, stop_ids: torch.Tensor,
                    stop_lens: torch.Tensor) -> torch.Tensor:
    """[B] bool: some right-aligned stop sequence matches the history tail
    (-1 pads always match; -1 history never equals a real id)."""
    pad = stop_ids < 0
    eq = stop_ids == hist[:, None, :]
    matched = (pad | eq).all(dim=-1)
    return (matched & (stop_lens > 0)).any(dim=-1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash on int64 tensors holding values < 2**32 (both
    multipliers are below 2**31, so no product leaves int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def seeded_uniform(seeds: torch.Tensor, positions: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """[B, V] uniforms in (0, 1) that depend only on (seed, position, id):
    a counter-based hash, the same on every device and in every batch."""
    dev = seeds.device
    row = _mix32(_mix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    idx = torch.arange(vocab, device=dev, dtype=torch.int64)
    x = _mix32(_mix32(row[:, None] ^ idx[None]))
    return ((x >> 8).float() + 0.5) / float(1 << 24)


def filter_logits(logits, temperature, top_k, top_p, valid_vocab=None,
                  bias_ids=None, bias_vals=None):
    """(greedy ids [B], masked logits [B, V]): padded-vocab mask and
    ``logit_bias`` first (greedy argmax included), then temperature, top-k
    and top-p from ONE descending sort; dropped ids sit at ``NEG_INF``."""
    v = logits.shape[1]
    dev = logits.device
    if valid_vocab is not None and valid_vocab < v:
        pad_mask = torch.arange(v, device=dev) < valid_vocab
        logits = torch.where(pad_mask[None, :], logits, NEG_INF)
    if bias_ids is not None:
        add = torch.where(bias_ids >= 0, bias_vals.float(), 0.0)
        logits = logits.scatter_add(1, bias_ids.long().clamp(0, v - 1), add)
    greedy = logits.argmax(dim=-1)

    safe_t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    scaled = logits / safe_t

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, v) - 1).clamp(0, v - 1).long()
    kth = sorted_desc.gather(1, k_idx[:, None])
    masked = torch.where(scaled >= kth, scaled, NEG_INF)

    ranks = torch.arange(v, device=dev)[None, :]
    sorted_masked = torch.where(ranks <= k_idx[:, None], sorted_desc, NEG_INF)
    probs_sorted = torch.softmax(sorted_masked, dim=-1)
    cumulative = torch.cumsum(probs_sorted, dim=-1)
    cutoff = ((cumulative - probs_sorted) < top_p[:, None]) | (ranks == 0)
    threshold = torch.where(cutoff, sorted_masked, float("inf")).amin(dim=-1)
    masked = torch.where(masked >= threshold[:, None], masked, NEG_INF)

    return greedy, masked


def sample(
    logits: torch.Tensor,              # [B, V] f32
    generator: torch.Generator | None,
    temperature: torch.Tensor,         # [B] f32; 0 = greedy
    top_k: torch.Tensor,               # [B] int; 0 = disabled
    top_p: torch.Tensor,               # [B] f32; 1.0 = disabled
    valid_vocab: int | None = None,    # ids >= this are vocab padding
    seeds: torch.Tensor | None = None,      # [B] int; -1 = engine RNG
    positions: torch.Tensor | None = None,  # [B] int — current position
    bias_ids: torch.Tensor | None = None,   # [B, K] int; -1 = unused
    bias_vals: torch.Tensor | None = None,  # [B, K] f32 (OpenAI logit_bias)
) -> torch.Tensor:
    """Returns sampled token ids [B] int32.

    Same masking as the reference: padded-vocab columns, ``logit_bias``
    before everything (greedy argmax included), then temperature, top-k and
    top-p from ONE descending sort, greedy rows chosen at the end.  The draw
    is Gumbel-max (argmax of masked logits + Gumbel noise), which is what
    ``jax.random.categorical`` computes — but from different random bits:
    torch cannot reproduce threefry, so sampled rows match the reference in
    their kept top-k/top-p set, not token for token.

    Seed contract (the OpenAI ``seed``): a row with seed >= 0 takes its
    noise from ``seeded_uniform(seed, position, id)``, so its tokens depend
    only on (seed, position, distribution) — the same across runs,
    restarts, devices and batch mates, within the port.  Rows at -1 draw
    from ``generator`` (the engine RNG).
    """
    b, v = logits.shape
    dev = logits.device
    greedy, masked = filter_logits(logits, temperature, top_k, top_p,
                                   valid_vocab, bias_ids, bias_vals)
    u = torch.rand((b, v), generator=generator, device=dev)
    if seeds is not None:
        u = torch.where(seeds[:, None] >= 0,
                        seeded_uniform(seeds.clamp_min(0), positions, v), u)
    u = u.clamp(1e-20, 1.0 - 1e-7)
    sampled = (masked - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def logprob_info(logits: torch.Tensor, sampled: torch.Tensor,
                 valid_vocab: int):
    """(sampled-token logprob, top-K logprobs, top-K ids) from raw logits:
    model logprobs (pre-temperature), padded-vocab columns masked out."""
    v = logits.shape[-1]
    masked = torch.where(torch.arange(v, device=logits.device) < valid_vocab,
                         logits, float("-inf"))
    logp = torch.log_softmax(masked, dim=-1)
    sampled_lp = logp.gather(-1, sampled.long()[..., None])[..., 0]
    top_v, top_i = torch.topk(logp, LOGPROB_TOPK, dim=-1)
    return sampled_lp, top_v, top_i
