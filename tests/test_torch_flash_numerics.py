"""The bf16 tensor-core flash/chunk kernel's rounding, emulated on the CPU
and held against the JAX package's Pallas kernels.

On the card, bf16 flash prefill and chunk attention run on ``wgmma``
(``ops/csrc/flash_tile_sm90.cuh``).  Their numerics depart from the TPU
kernel (``pallas_attention._softmax_block``, which keeps p in f32 for PV)
in one place: P is rounded to bf16 before the PV product.  ``emulate``
below repeats the card kernel's arithmetic in plain torch — bf16 Q and K,
f32 products summed in f32, the scale on the f32 scores, an online f32
softmax over 128-key tiles (64 at hd 256), P rounded to bf16, f32 PV, l
from the f32 p — so this file shows on the CPU, before any card run, that
the departure fits the limit the card checks use: each output vector's
largest error within 2^-6 of its largest |value| (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  The Pallas kernels run in interpret mode
on the same inputs cast to bf16.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.ops.pallas_attention import (
    chunk_attention_pallas,
    flash_attention_bhsd,
)

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.ops import chunk_attention as tch  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import flash_attention as tflash  # noqa: E402

SCALED_TOL = 2.0 ** -6
NEG_INF = -1e30
TR = (0, 2, 1, 3)  # model layout <-> the Pallas flash kernel's [B, H, S, hd]


def emulate(q, k, v, start: int, round_p: bool = True):
    """The card kernel's arithmetic: q [B, C, H, hd] at positions
    start..start+C-1 against k/v [B, S_kv, K, hd]; returns q's dtype."""
    b, c, h, hd = q.shape
    s_kv, n_kv = k.shape[1], k.shape[2]
    bk = 128 if hd <= 128 else 64
    qf = q.float().reshape(b, c, n_kv, h // n_kv, hd)
    kf, vf = k.float(), v.float()
    pos = start + torch.arange(c)
    m = torch.full((b, n_kv, h // n_kv, c), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, n_kv, h // n_kv, c, hd)
    for k0 in range(0, s_kv, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        s = torch.einsum("bikgh,bjkh->bkgij", qf, kt) / math.sqrt(hd)
        live = (k0 + torch.arange(kt.shape[1]))[None, :] <= pos[:, None]
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)  # l from the f32 p
        pv = p.bfloat16().float() if round_p else p
        acc = acc * corr[..., None] + torch.einsum("bkgij,bjkh->bkgih", pv, vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd).to(q.dtype)


def scaled_err(got, want) -> float:
    """Each output vector's largest error over its largest |value|."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1)
            / w.abs().amax(-1).clamp_min(1e-30)).max().item()


def bf16_pair(x: np.ndarray):
    """The same bf16 values for both frameworks (round to nearest even)."""
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16)


def to_torch(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


def flash_inputs(s, h, k, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, s, h, hd), (1, s, k, hd), (1, s, k, hd))]


def chunk_inputs(c, s_max, h, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, c, h, 128), (1, s_max, k, 128),
                          (1, s_max, k, 128))]


@pytest.mark.parametrize("s,h,k,hd,seed,block", [
    (128, 4, 2, 128, 5, 128),   # tests/test_torch_ops.py's flash inputs
    (128, 4, 1, 128, 11, 128),  # GQA 4:1
    (200, 4, 1, 128, 12, 40),   # ragged S against the card's 128-key tiles
    (128, 2, 1, 256, 13, 128),  # hd 256: 64-key tiles on the card
])
def test_flash_rounding_fits_the_limit(s, h, k, hd, seed, block):
    (tq, jq), (tk, jk), (tv, jv) = map(bf16_pair,
                                       flash_inputs(s, h, k, hd, seed))
    want = flash_attention_bhsd(jq.transpose(TR), jk.transpose(TR),
                                jv.transpose(TR), block_q=block,
                                block_k=block, interpret=True).transpose(TR)
    got = emulate(tq, tk, tv, 0)
    assert got.dtype == torch.bfloat16
    assert scaled_err(got, to_torch(want)) <= SCALED_TOL


@pytest.mark.parametrize("c,s_max,h,k,start,seed", [
    (128, 256, 4, 2, 0, 0),     # tests/test_torch_chunk.py's chunk inputs
    (128, 256, 4, 2, 64, 64),
    (128, 256, 4, 2, 128, 128),
    (128, 256, 4, 2, 200, 200),  # pads: positions 256..327 past S_max
    (128, 384, 4, 1, 77, 9),     # GQA 4:1, start off the tile grid
])
def test_chunk_rounding_fits_the_limit(c, s_max, h, k, start, seed):
    (tq, jq), (tk, jk), (tv, jv) = map(bf16_pair,
                                       chunk_inputs(c, s_max, h, k, seed))
    want = chunk_attention_pallas(jq, jk, jv, jnp.int32(start),
                                  interpret=True)
    got = emulate(tq, tk, tv, start)
    assert scaled_err(got, to_torch(want)) <= SCALED_TOL


@pytest.mark.parametrize("start", [0, 37])
def test_emulation_without_the_rounding_is_the_plain_version(start):
    """At f32 and with P unrounded, the tiled recurrence is the wrappers'
    plain versions (to summation order): the emulation itself is right."""
    q, k, v = (torch.from_numpy(x) for x in chunk_inputs(40, 300, 4, 2, 3))
    got = emulate(q, k, v, start, round_p=False)
    want = tch.chunk_attention_reference(q, k, v, start)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    if start == 0:
        sq, sk, sv = q[:, :40], k[:, :40], v[:, :40]
        np.testing.assert_allclose(
            emulate(sq, sk, sv, 0, round_p=False).numpy(),
            tflash.flash_attention_reference(sq, sk, sv).numpy(), atol=1e-5)
