"""Ring attention over the ``sequence`` mesh axis (port of
``parallel/ring_attention.py``: ``_ring_attention_local`` and
``ring_attention``).

A long prompt splits into n sequence blocks, block j holding positions
``[j * S_loc, (j + 1) * S_loc)``.  Each block keeps its queries and passes
K/V blocks around the ring: after ``step`` rotations block j holds the
K/V of block ``src = (j - step) mod n`` and folds it into an online f32
softmax (``m``, ``l``, ``o``), so no block ever holds the full ``[S, S]``
scores.  Causality is global: query ``j * S_loc + i`` sees key
``src * S_loc + i'`` iff the first is not smaller, masked logits at
-1e30, scores scaled by 1/sqrt(hd), query head h reading KV head
``h // (H / K)``, and the output ``o / max(l, 1e-30)`` cast to q's dtype.

Block j folds the sources in the rotation's order (``src = j, j - 1,
...``), each K/V block copied to its device (``.to(device,
non_blocking=True)``, ordered on the streams of both devices; a no-op
where the blocks share a device).  Across processes (``sequence``
spanning them) a process holds the queries of some blocks only and the
K/V of every block, exchanged over the sequence group
(``collectives.exchange``, in ``models/transformer.prefill_layer``); it
folds each of its blocks the same way, so its outputs are bitwise the
one-process ring's for those blocks.  The block products are plain torch
ops, the reference's XLA einsums: there is no Pallas kernel to port
(ROADMAP queues a kernel route as speed work).

Unlike the reference, the loop skips the blocks wholly above the
diagonal (``src > j``) on a causal ring: step 0 is the diagonal, so every
row's max is finite before such a block arrives, and the block would add
exactly zero (``exp(-1e30 - m) == 0``, a correction of exactly 1).
``skip_masked=False`` runs every block, as the reference does; the two
are bitwise equal (``tests/test_torch_ring.py``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

NEG_INF = -1e30


def _fold_step(qg, q_pos, scale, m, l, o, k_cur, v_cur, src: int,
               s_loc: int, causal: bool) -> tuple:
    """One key block ``src`` folded into a query block's online softmax
    (m, l, o): the new (m, l, o)."""
    scores = torch.einsum("bikgh,bjkh->bkgij", qg, k_cur.float()) * scale
    if causal:
        k_pos = src * s_loc + torch.arange(s_loc, device=scores.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    return (m_new, l * corr + p.sum(dim=-1),
            o * corr[..., None] + torch.einsum("bkgij,bjkh->bkgih", p,
                                               v_cur.float()))


def _fold(st: dict, k_cur, v_cur, src: int, s_loc: int,
          causal: bool) -> None:
    """Fold key block ``src`` into a query block's online softmax state
    ``st`` (in place).  Under autograd the step is recomputed in the
    backward (``torch.utils.checkpoint``) rather than holding its
    ``[B, K, G, S_loc, S_loc]`` f32 scores and probabilities a fold: the
    same values, at one fold's memory instead of every layer's."""
    args = (st["qg"], st["q_pos"], st["scale"], st["m"], st["l"], st["o"],
            k_cur, v_cur, src, s_loc, causal)
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in args):
        out = torch.utils.checkpoint.checkpoint(_fold_step, *args,
                                                use_reentrant=False)
    else:
        out = _fold_step(*args)
    st["m"], st["l"], st["o"] = out


def ring_attention_blocks(qs: list, ks: list, vs: list, causal: bool = True,
                          skip_masked: bool = True, first: int = 0) -> list:
    """The attention of every sequence block: ``qs[j]`` ``[B, S_loc, H,
    hd]`` and ``ks[j]`` / ``vs[j]`` ``[B, S_loc, K, hd]``, block j on its
    own device.  Returns each block's output ``[B, S_loc, H, hd]`` on that
    block's device, in q's dtype.  ``qs`` may hold only the blocks
    ``first .. first + len(qs) - 1`` of the ``len(ks)`` (a process's part
    of a ring across processes)."""
    n = len(ks)
    b, s_loc, n_heads, hd = qs[0].shape
    n_kv = ks[0].shape[2]
    g = n_heads // n_kv
    state = []
    for i, q in enumerate(qs):
        dev = q.device
        state.append({
            "qg": q.reshape(b, s_loc, n_kv, g, hd).float(),
            "q_pos": (first + i) * s_loc + torch.arange(s_loc, device=dev),
            "m": torch.full((b, n_kv, g, s_loc), NEG_INF,
                            dtype=torch.float32, device=dev),
            "l": torch.zeros((b, n_kv, g, s_loc), dtype=torch.float32,
                             device=dev),
            "o": torch.zeros((b, n_kv, g, s_loc, hd), dtype=torch.float32,
                             device=dev),
            "scale": 1.0 / torch.full((), hd, dtype=torch.float32,
                                      device=dev).sqrt(),
        })
    for i, (q, st) in enumerate(zip(qs, state)):
        j = first + i
        for step in range(n):
            src = (j - step) % n
            if causal and skip_masked and src > j:
                continue
            _fold(st, ks[src].to(q.device, non_blocking=True),
                  vs[src].to(q.device, non_blocking=True), src, s_loc,
                  causal)
    outs = []
    for q, st in zip(qs, state):
        out = st["o"] / torch.clamp_min(st["l"][..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, s_loc, n_heads, hd)
                    .to(q.dtype))
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   causal: bool = True, axis_name: str = "sequence"):
    """Sequence-parallel attention of ``q`` ``[B, S, H, hd]`` and ``k`` /
    ``v`` ``[B, S, K, hd]`` over ``mesh``'s ``axis_name`` axis (S divisible
    by its size): block j on the mesh's j-th device along that axis, the
    output whole on ``q``'s device."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} is not divisible "
                         f"by {axis_name}={n}")
    stride = 1
    for name, size in reversed(list(mesh.shape.items())):
        if name == axis_name:
            break
        stride *= size
    devices = [mesh.devices[j * stride] for j in range(n)]
    qs, ks, vs = ([blk.to(dev) for blk, dev in zip(x.chunk(n, dim=1),
                                                   devices)]
                  for x in (q, k, v))
    outs = ring_attention_blocks(qs, ks, vs, causal=causal)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
