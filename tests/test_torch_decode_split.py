"""The split-S decode kernels' arithmetic, emulated on the CPU and held
against the JAX package's Pallas kernels and the port's plain versions.

On the card, bf16/f32 lane and paged decode (``ops/csrc/decode_tile.cuh``)
cut each row's positions into splits of ``split_len`` positions, one
thread block each.  A block sweeps its split in tiles of
``tile_positions(hd, dtype)`` positions with the online f32 softmax,
rounding p to the value dtype before PV relative to the split's running
maximum (l from the unrounded p), and writes an unnormalised partial
(m, l, acc); the combine pass merges a row's live splits,
``sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i, 1e-30)``, and writes
zeros for a row with none.  ``emulate`` repeats that arithmetic in plain
torch, so this file pins the combine's algebra and the length-0 zeros on
the CPU, before any card run.  The pool is read through
``gather_pool_rows`` first: a split covers whole pool blocks, so reading
through the table is the lane read of the gathered row.

int8 storage (one f32 scale per position and KV head) runs the same
split and combine over the tile a block holds: the values dequantized to
q's dtype, ``dequantize_kv`` — the Pallas kernel's
``(x.astype(f32) * s).astype(q.dtype)`` — so ``emulate`` takes the
dequantized lanes, and the splits are counted in tiles of q's dtype.

Tolerances: bf16 — each output vector's largest error within 2^-6 of its
largest |value| (the card checks' limit, ``chip_smoke.py``,
``tests/test_torch_cuda.py``); f32 — 1e-5 absolute (summation order).
The Pallas kernels run in interpret mode on the same inputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.ops.pallas_decode_attention import (
    decode_attention_pallas,
    decode_attention_quant_pallas,
    paged_decode_attention_pallas,
)

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import (  # noqa: E402
    paged_decode_attention as tpd,
)
from llm_instance_gateway_tpu_torch.ops.attention import (  # noqa: E402
    gather_pool_rows,
)

SCALED_TOL = 2.0 ** -6
F32_ATOL = 1e-5
NEG_INF = -1e30
H, K, HD, S_MAX = 8, 2, 128, 384
H100_SMS = 132


def emulate(q, k, v, lengths, split_len: int, tile: int):
    """The split + combine kernels' arithmetic: q [B, H, hd] against lanes
    k/v [B, S_max, K, hd] up to ``lengths``; returns q's dtype."""
    b, s_max, n_kv, hd = k.shape
    g = q.shape[1] // n_kv
    qf = q.float().reshape(b, n_kv, g, hd)
    kf, vf = k.float(), v.float()
    lengths = lengths.long()
    n_split = -(-s_max // split_len)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        s0 = s * split_len
        end = lengths.clamp(max=s0 + split_len)  # this split's live end
        m = torch.full((b, n_kv, g), NEG_INF)
        l = torch.zeros(b, n_kv, g)
        acc = torch.zeros(b, n_kv, g, hd)
        for t0 in range(s0, min(s0 + split_len, s_max), tile):
            kt, vt = kf[:, t0:t0 + tile], vf[:, t0:t0 + tile]
            live = (t0 + torch.arange(kt.shape[1]))[None] < end[:, None]
            live = live[:, None, None]
            sc = torch.einsum("bkgh,bskh->bkgs", qf, kt) / math.sqrt(hd)
            sc = torch.where(live, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.where(live, torch.exp(sc - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)  # l from the unrounded p
            pv = p.to(v.dtype).float()  # p.astype(v.dtype), split's max
            acc = acc * corr[..., None] + torch.einsum("bkgs,bskh->bkgh",
                                                       pv, vt)
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)
    live = (torch.arange(n_split)[None] * split_len < lengths[:, None])
    live = live[:, None, None]  # [B, 1, 1, n_split]: the combine's n_live
    top = torch.where(live, m, NEG_INF).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - top), 0.0)
    num = (w[..., None] * acc).sum(-2)
    den = (w * l).sum(-1)
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, n_kv * g, hd).to(q.dtype)


def scaled_err(got, want) -> float:
    """Each output vector's largest error over its largest |value|."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1)
            / w.abs().amax(-1).clamp_min(1e-30)).max().item()


def assert_close(got, want, dtype):
    if dtype == torch.bfloat16:
        assert scaled_err(got, want) <= SCALED_TOL
    else:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=F32_ATOL)


def pair(x: np.ndarray, dtype):
    """The same values for both frameworks (bf16: round to nearest even)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(x).bfloat16(), \
            jnp.asarray(x).astype(jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


def split_len_for(kind: str, tile: int, page: int = 1) -> int:
    """One tile, a few tiles, or one split holding the whole row — or the
    plan the wrappers use on an H100 at this shape."""
    unit = math.lcm(tile, page)
    return {"one_tile": unit, "few_tiles": 3 * unit, "whole_row": S_MAX,
            "plan": tdec.split_plan(6, K, S_MAX, tile, H100_SMS, page)[0]
            }[kind]


def boundary_lengths(split_len: int) -> np.ndarray:
    """0, 1, L-1, L, L+1 and the whole S_max (clipped to S_max)."""
    return np.minimum([0, 1, split_len - 1, split_len, split_len + 1, S_MAX],
                      S_MAX).astype(np.int32)


KINDS = ["one_tile", "few_tiles", "whole_row", "plan"]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_lane_split_matches_pallas_and_plain_version(dtype, kind):
    tile = tdec.tile_positions(HD, dtype)
    split_len = split_len_for(kind, tile)
    lengths = boundary_lengths(split_len)
    b = len(lengths)
    rng = np.random.default_rng(split_len + tile)
    (tq, jq), (tk, jk), (tv, jv) = (
        pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, H, HD), (b, S_MAX, K, HD), (b, S_MAX, K, HD)))
    tl = torch.from_numpy(lengths)
    got = emulate(tq, tk, tv, tl, split_len, tile)
    assert got.dtype == dtype
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths),
                                   interpret=True)
    assert_close(got, to_torch(want), dtype)
    assert_close(got, tdec.decode_attention_reference(tq, tk, tv, tl), dtype)
    assert not got[0].any()  # a length-0 row: exact zeros


def pool_inputs(b, page, seed):
    """Pools with a garbage trash block, shuffled tables whose entries past
    each row's end are the trash block."""
    rng = np.random.default_rng(seed)
    m = S_MAX // page
    n_blocks = b * m
    kp, vp = (rng.standard_normal((n_blocks + 1, page, K, HD))
              .astype(np.float32) for _ in range(2))
    kp[0], vp[0] = 1e3, -1e3  # the trash block
    tables = (rng.permutation(n_blocks) + 1).reshape(b, m).astype(np.int32)
    q = rng.standard_normal((b, H, HD)).astype(np.float32)
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,page", [("one_tile", 16), ("few_tiles", 16),
                                       ("whole_row", 16), ("plan", 16),
                                       ("one_tile", 64), ("plan", 64)])
def test_paged_split_matches_pallas_and_plain_version(dtype, kind, page):
    tile = tdec.tile_positions(HD, dtype)
    split_len = split_len_for(kind, tile, page)
    assert split_len % page == 0  # a split covers whole pool blocks
    lengths = boundary_lengths(split_len)
    b = len(lengths)
    q, kp, vp, tables = pool_inputs(b, page, split_len + page)
    for i, n in enumerate(lengths):
        tables[i, -(-n // page):] = 0  # past the row's end: the trash block
    (tq, jq), (tk, jk), (tv, jv) = (pair(x, dtype) for x in (q, kp, vp))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = emulate(tq, gather_pool_rows(tk, tt), gather_pool_rows(tv, tt), tl,
                  split_len, tile)
    want = paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(tables),
                                         jnp.asarray(lengths), interpret=True)
    assert_close(got, to_torch(want), dtype)
    assert_close(got, tpd.paged_decode_attention_reference(tq, tk, tv, tt, tl),
                 dtype)
    assert not got[0].any()
    assert torch.isfinite(got.float()).all()  # the trash block never counts


@pytest.mark.parametrize("dtype", DTYPES)
def test_splits_are_independent_of_each_other(dtype):
    """A split's partial depends only on its own positions: scaling the
    logits of one split's keys moves that split's m, and the combine
    still agrees with the plain version."""
    tile = tdec.tile_positions(HD, dtype)
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, H, HD), (2, S_MAX, K, HD), (2, S_MAX, K, HD)))
    k[:, tile:2 * tile] *= 4.0  # the second split's logits dominate
    tq, tk, tv = (pair(x, dtype)[0] for x in (q, k, v))
    tl = torch.tensor([S_MAX, 2 * tile + 5], dtype=torch.int32)
    got = emulate(tq, tk, tv, tl, tile, tile)
    assert_close(got, tdec.decode_attention_reference(tq, tk, tv, tl), dtype)


def int8_kv(rng, shape):
    """Seeded int8 values [..., hd] and one f32 scale per (position, KV
    head), about what max-abs quantization of N(0, 1) values gives."""
    x = rng.integers(-127, 128, size=shape, dtype=np.int8)
    scale = (rng.uniform(0.5, 1.5, size=shape[:-1]) / 50).astype(np.float32)
    return x, scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_lane_int8_split_matches_pallas_and_plain_version(dtype, kind):
    tile = tdec.tile_positions(HD, dtype)
    split_len = split_len_for(kind, tile)
    lengths = boundary_lengths(split_len)
    b = len(lengths)
    rng = np.random.default_rng(100 + split_len + tile)
    tq, jq = pair(rng.standard_normal((b, H, HD)).astype(np.float32), dtype)
    kv = [*int8_kv(rng, (b, S_MAX, K, HD)), *int8_kv(rng, (b, S_MAX, K, HD))]
    tk, tks, tv, tvs = map(torch.from_numpy, kv)
    tl = torch.from_numpy(lengths)
    got = emulate(tq, tdec.dequantize_kv(tk, tks, dtype),
                  tdec.dequantize_kv(tv, tvs, dtype), tl, split_len, tile)
    assert got.dtype == dtype
    jk, jks, jv, jvs = map(jnp.asarray, kv)
    want = decode_attention_quant_pallas(jq, jk, jv, jks, jvs,
                                         jnp.asarray(lengths), interpret=True)
    assert_close(got, to_torch(want), dtype)
    assert_close(got, tdec.decode_attention_quant_reference(
        tq, tk, tv, tks, tvs, tl), dtype)
    assert not got[0].any()  # a length-0 row: exact zeros


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,page", [("one_tile", 16), ("few_tiles", 16),
                                       ("whole_row", 16), ("plan", 16),
                                       ("one_tile", 64), ("plan", 64)])
def test_paged_int8_split_matches_pallas_and_plain_version(dtype, kind, page):
    """int8 pools and scale pools read through shuffled tables; the trash
    block's values and scales are garbage and never count."""
    tile = tdec.tile_positions(HD, dtype)
    split_len = split_len_for(kind, tile, page)
    assert split_len % page == 0
    lengths = boundary_lengths(split_len)
    b = len(lengths)
    rng = np.random.default_rng(200 + split_len + page)
    m = S_MAX // page
    pools = [*int8_kv(rng, (b * m + 1, page, K, HD)),
             *int8_kv(rng, (b * m + 1, page, K, HD))]
    pools[0][0], pools[1][0] = 127, 1e3  # the trash block: K and its scales
    pools[2][0], pools[3][0] = -127, 1e3  # V and its scales
    tables = (rng.permutation(b * m) + 1).reshape(b, m).astype(np.int32)
    for i, n in enumerate(lengths):
        tables[i, -(-n // page):] = 0  # past the row's end: the trash block
    tq, jq = pair(rng.standard_normal((b, H, HD)).astype(np.float32), dtype)
    tk, tks, tv, tvs = map(torch.from_numpy, pools)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = emulate(tq, tdec.dequantize_kv(gather_pool_rows(tk, tt),
                                         gather_pool_rows(tks, tt), dtype),
                  tdec.dequantize_kv(gather_pool_rows(tv, tt),
                                     gather_pool_rows(tvs, tt), dtype),
                  tl, split_len, tile)
    jk, jks, jv, jvs = map(jnp.asarray, pools)
    want = paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(tables),
                                         jnp.asarray(lengths), jks, jvs,
                                         interpret=True)
    assert_close(got, to_torch(want), dtype)
    assert_close(got, tpd.paged_decode_attention_quant_reference(
        tq, tk, tv, tt, tl, tks, tvs), dtype)
    assert not got[0].any()
    assert torch.isfinite(got.float()).all()  # the trash block never counts


def test_split_plan_meets_the_targets_on_an_h100():
    """B=8, K=8 (Llama-3-8B at 8 slots): the 8192-long paged row spreads
    over at least 16 blocks per KV head, the 1024-long lane over at least
    8; lengths play no part (the plan takes none)."""
    tile = tdec.tile_positions(128, torch.bfloat16)
    assert tile == 64
    for page in (16, 64):
        split_len, n_split = tdec.split_plan(8, 8, 8192, tile, H100_SMS, page)
        assert n_split >= 16 and split_len % page == 0
    split_len, n_split = tdec.split_plan(8, 8, 1024, tile, H100_SMS)
    assert n_split >= 8 and split_len % tile == 0


@pytest.mark.parametrize("batch,n_kv,s_max,hd,dtype,page", [
    (1, 8, 8192, 128, torch.bfloat16, 64), (8, 8, 300, 128, torch.float32, 1),
    (4, 2, 512, 128, torch.float32, 16), (64, 8, 8192, 64, torch.bfloat16, 16),
    (8, 1, 1000, 256, torch.float32, 1), (3, 4, 4096, 128, torch.bfloat16, 128)])
def test_split_plan_is_aligned_and_covers_s_max(batch, n_kv, s_max, hd, dtype,
                                                page):
    tile = tdec.tile_positions(hd, dtype)
    split_len, n_split = tdec.split_plan(batch, n_kv, s_max, tile, H100_SMS,
                                         page)
    assert split_len % math.lcm(tile, page) == 0
    assert (n_split - 1) * split_len < s_max <= n_split * split_len
    # at most SPLIT_TILES tiles, unless one block of the pool is longer
    assert split_len <= max(tdec.SPLIT_TILES * tile, math.lcm(tile, page))
    assert split_len // page <= tpd.MAX_SPLIT_BLOCKS
