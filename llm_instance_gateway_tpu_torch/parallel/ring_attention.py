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

In one process the rotation is a copy of each held block to the next
block's device (``.to(device, non_blocking=True)``, ordered on the
streams of both devices), and a no-op where the blocks share a device.
The block products are plain torch ops, the reference's XLA einsums:
there is no Pallas kernel to port (ROADMAP queues a kernel route as
speed work).

Unlike the reference, the loop skips the blocks wholly above the
diagonal (``src > j``) on a causal ring: step 0 is the diagonal, so every
row's max is finite before such a block arrives, and the block would add
exactly zero (``exp(-1e30 - m) == 0``, a correction of exactly 1).
``skip_masked=False`` runs every block, as the reference does; the two
are bitwise equal (``tests/test_torch_ring.py``).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_attention_blocks(qs: list, ks: list, vs: list, causal: bool = True,
                          skip_masked: bool = True) -> list:
    """The attention of every sequence block: ``qs[j]`` ``[B, S_loc, H,
    hd]`` and ``ks[j]`` / ``vs[j]`` ``[B, S_loc, K, hd]``, block j on its
    own device.  Returns each block's output ``[B, S_loc, H, hd]`` on that
    block's device, in q's dtype."""
    n = len(qs)
    b, s_loc, n_heads, hd = qs[0].shape
    n_kv = ks[0].shape[2]
    g = n_heads // n_kv
    state = []
    for j, q in enumerate(qs):
        dev = q.device
        state.append({
            "qg": q.reshape(b, s_loc, n_kv, g, hd).float(),
            "q_pos": j * s_loc + torch.arange(s_loc, device=dev),
            "m": torch.full((b, n_kv, g, s_loc), NEG_INF,
                            dtype=torch.float32, device=dev),
            "l": torch.zeros((b, n_kv, g, s_loc), dtype=torch.float32,
                             device=dev),
            "o": torch.zeros((b, n_kv, g, s_loc, hd), dtype=torch.float32,
                             device=dev),
            "scale": 1.0 / torch.full((), hd, dtype=torch.float32,
                                      device=dev).sqrt(),
        })
    held = list(zip(ks, vs))
    for step in range(n):
        for j, st in enumerate(state):
            src = (j - step) % n
            if causal and skip_masked and src > j:
                continue
            k_cur, v_cur = held[j]
            scores = torch.einsum("bikgh,bjkh->bkgij", st["qg"],
                                  k_cur.float()) * st["scale"]
            if causal:
                k_pos = src * s_loc + torch.arange(s_loc,
                                                   device=scores.device)
                mask = st["q_pos"][:, None] >= k_pos[None, :]
                scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(st["m"], scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(st["m"] - m_new)
            st["l"] = st["l"] * corr + p.sum(dim=-1)
            st["o"] = st["o"] * corr[..., None] + torch.einsum(
                "bkgij,bjkh->bkgih", p, v_cur.float())
            st["m"] = m_new
        if step + 1 < n:
            # Block j passes what it holds to block j + 1.
            held = [tuple(x.to(qs[j].device, non_blocking=True)
                          for x in held[(j - 1) % n]) for j in range(n)]
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
