"""The bf16 flash backward kernel's arithmetic, emulated on the CPU and held
against ``jax.vjp`` of the JAX package's ``prefill_attention``.

On the card, the bf16 gradient of flash attention runs on ``wgmma``
(``ops/csrc/flash_backward.cu``).  ``emulate_backward`` below repeats its
arithmetic in plain torch:

- lse as the training forward stores it: base 2, m + log2(l) of the
  scaled f32 logits (``flash_tile_sm90.cuh``'s epilogue), and P^T =
  exp2(S^T * scale * log2 e - lse2);
- delta = rowsum(dout * out) in f32 over the output it is given;
- P^T and dS^T = P^T (dP^T - delta) rounded to bf16 before their products;
- dK and dV summed in f32 over the kernel's order: the heads of a group
  split, then 64-row query tiles; dQ over 64-row key tiles;
- the group split's f32 partials summed in split order by the reduction,
  dK scaled once after the sum (in the epilogue without a split), each
  cast to bf16 once.

The split is ``flash_attention.split_plan``'s on an H100 (132 SMs).  The
reference differentiates ``prefill_attention`` in f32 on the same
bf16-valued inputs, and the emulation takes that forward's f32 output for
delta, so the comparison measures the kernel's arithmetic.  The output the
card's backward receives is the forward's bf16 one; delta over it moves dq
by up to 0.038 scaled from the vjp's here, for the plain f32 version
exactly as for the kernel, so the card checks hold the kernel to the plain
version on the same bf16 output, and so does the second test below.

The limit is the card checks' scaled rule
(``tests/test_torch_cuda.py::assert_grad_close``, ``chip_smoke.check_grad``):
each gradient vector's largest error over the larger of its own largest
|value| and 1/16 of the tensor's (or of 1), within 2^-6, and every error
within 2e-2 times max(1, the tensor's largest |value|).  Measured worst
cases over the cases below, against 2^-6 (0.0156): 0.0073 against the vjp
(about 0.004 with P and dS left unrounded: the rest is the cast of the
gradients to bf16 and summation order), 0.0078 against the plain version
on the bf16 output, and 0.0056 against the vjp at S = 1023 with
Gemma-2B's 8:1 layout and its eight-way group split.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.ops import attention as jattn

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.ops import flash_attention as fl  # noqa: E402

SCALED_TOL = 2.0 ** -6
ABS_TOL = 2e-2
H100_SMS = 132
TILE = 64  # rows of a streamed tile: queries in dK/dV, keys in dQ
LOG2E = 1.4426950408889634


def emulate_backward(q, k, v, out, dout, splits: int, round_ops=True):
    """The card kernel's arithmetic on q/out/dout [B, S, H, hd], k/v
    [B, S, K, hd]; returns (dq, dk, dv) in q's dtype."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = 1.0 / math.sqrt(hd)
    rnd = (lambda t: t.bfloat16().float()) if round_ops else (lambda t: t)
    qf = q.float().reshape(b, s, n_kv, g, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, s, n_kv, g, hd)
    live = torch.tril(torch.ones((s, s), dtype=torch.bool))
    x = torch.einsum("bikgh,bjkh->bkgij", qf, kf) * (scale * LOG2E)
    x = torch.where(live, x, fl.NEG_INF)
    m = x.amax(-1, keepdim=True)
    lse2 = m + torch.log2(torch.exp2(x - m).sum(-1, keepdim=True))
    p = torch.where(live, torch.exp2(x - lse2), 0.0)
    dp = torch.einsum("bikgh,bjkh->bkgij", dof, vf)
    delta = (dout.float() * out.float()).sum(-1)  # [B, S, H]
    delta = delta.reshape(b, s, n_kv, g).permute(0, 2, 3, 1)[..., None]
    ds = torch.where(live, p * (dp - delta), 0.0)
    pb, dsb = rnd(p), rnd(ds)  # [B, K, G, S_q, S_k]

    # dK/dV: per split, its heads in order, then 64-query tiles in order.
    per = g // splits
    parts_k, parts_v = [], []
    for sp in range(splits):
        acc_k = torch.zeros(b, s, n_kv, hd)
        acc_v = torch.zeros(b, s, n_kv, hd)
        for gi in range(sp * per, (sp + 1) * per):
            for q0 in range(0, s, TILE):
                sl = slice(q0, q0 + TILE)
                acc_v = acc_v + torch.einsum(
                    "bkij,bikh->bjkh", pb[:, :, gi, sl], dof[:, sl, :, gi])
                acc_k = acc_k + torch.einsum(
                    "bkij,bikh->bjkh", dsb[:, :, gi, sl], qf[:, sl, :, gi])
        parts_k.append(acc_k)
        parts_v.append(acc_v)
    if splits == 1:
        dk, dv = parts_k[0] * scale, parts_v[0]
    else:
        dk, dv = torch.zeros_like(parts_k[0]), torch.zeros_like(parts_v[0])
        for pk, pv in zip(parts_k, parts_v):
            dk, dv = dk + pk, dv + pv
        dk = dk * scale

    # dQ: 64-key tiles in order.
    acc_q = torch.zeros(b, s, n_kv, g, hd)
    for k0 in range(0, s, TILE):
        sl = slice(k0, k0 + TILE)
        acc_q = acc_q + torch.einsum("bkgij,bjkh->bikgh", dsb[..., sl],
                                     kf[:, sl])
    dq = (acc_q * scale).reshape(b, s, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def grad_err(got, want) -> float:
    """``assert_grad_close``'s scaled error; asserts its flat ceiling."""
    g, w = got.float(), want.float()
    num = (g - w).abs().amax(-1)
    top = max(w.abs().max().item(), 1.0)
    assert num.max().item() < ABS_TOL * top
    return (num / w.abs().amax(-1).clamp_min(top / 16)).max().item()


def bf16_inputs(b, s, h, n_kv, hd, seed):
    """q, k, v, dout drawn with numpy from ``seed``, rounded to bf16: f32
    arrays for JAX, bf16 tensors for the emulation (the same values)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, hd), (b, s, n_kv, hd), (b, s, n_kv, hd),
                            (b, s, h, hd))]
    tensors = [torch.from_numpy(a).bfloat16() for a in arrays]
    return [t.float().numpy() for t in tensors], tensors


def check_case(b, s, h, n_kv, hd, seed) -> list:
    """The emulation against ``jax.vjp``: each gradient's scaled error."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = bf16_inputs(b, s, h, n_kv, hd,
                                                       seed)
    out, vjp = jax.vjp(jattn.prefill_attention, jnp.asarray(jq),
                       jnp.asarray(jk), jnp.asarray(jv))
    want = vjp(jnp.asarray(jdo))
    tout = torch.from_numpy(np.asarray(out))
    splits = fl.split_plan(b, s, h, n_kv, hd, H100_SMS)
    got = emulate_backward(tq, tk, tv, tout, tdo, splits)
    errs = []
    for gt, w in zip(got, want):
        assert gt.dtype == torch.bfloat16
        errs.append(grad_err(gt, torch.from_numpy(np.asarray(w))))
    return errs


CASES = [(g, hd, s) for g in (1, 4, 8) for hd in (64, 128, 256)
         for s in (1, 17, 127, 128, 129)]


@pytest.mark.parametrize("g,hd,s", CASES)
def test_backward_rounding_fits_the_limit(g, hd, s):
    errs = check_case(2, s, 8, 8 // g, hd, seed=s * 7 + hd + g)
    assert max(errs) < SCALED_TOL, errs


def test_group_split_at_gemma_2b_layout_fits_the_limit():
    """S = 1023 at Gemma-2B's 8:1 layout, hd 256: the plan splits the one
    KV head's group over eight blocks, whose partials the reduction sums."""
    assert fl.split_plan(1, 1023, 8, 1, 256, H100_SMS) == 8
    errs = check_case(1, 1023, 8, 1, 256, seed=2)
    assert max(errs) < SCALED_TOL, errs


@pytest.mark.parametrize("g,hd,s", CASES)
def test_backward_on_the_bf16_output_fits_the_card_check(g, hd, s):
    """What the card checks compare: the kernel and the plain version on
    the same bf16 inputs and the same bf16 forward output."""
    _, (tq, tk, tv, tdo) = bf16_inputs(2, s, 8, 8 // g, hd, s * 5 + hd + g)
    tout = fl.flash_attention_reference(tq.float(), tk.float(),
                                        tv.float()).bfloat16()
    splits = fl.split_plan(2, s, 8, 8 // g, hd, H100_SMS)
    got = emulate_backward(tq, tk, tv, tout, tdo, splits)
    want = fl.flash_attention_backward_reference(tq, tk, tv, tout, tdo)
    errs = [grad_err(gt, w) for gt, w in zip(got, want)]
    assert max(errs) < SCALED_TOL, errs


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_emulation_without_the_rounding_is_the_plain_version(splits):
    """At f32 with P and dS unrounded, the tiled and split sums are the
    wrapper's plain backward (to summation order): the emulation is right."""
    rng = np.random.default_rng(splits)
    b, s, h, n_kv, hd = 1, 150, 8, 2, 64
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, h, hd), (b, s, n_kv, hd),
                                   (b, s, n_kv, hd), (b, s, h, hd)))
    out = fl.flash_attention_reference(q, k, v)
    got = emulate_backward(q, k, v, out, dout, splits, round_ops=False)
    want = fl.flash_attention_backward_reference(q, k, v, out, dout)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("b,s,h,n_kv,hd,want", [
    (2, 1023, 32, 8, 128, 2),   # Llama-3-8B's train step: 128 blocks
    (1, 1023, 8, 1, 256, 8),    # Gemma-2B: 16 blocks, one KV head
    (1, 1023, 16, 16, 256, 1),  # Gemma-7B: 256 blocks, no group to split
    (2, 129, 32, 8, 128, 4),
    (8, 1023, 32, 8, 128, 1),   # 512 blocks: enough without a split
])
def test_split_plan(b, s, h, n_kv, hd, want):
    assert fl.split_plan(b, s, h, n_kv, hd, H100_SMS) == want
