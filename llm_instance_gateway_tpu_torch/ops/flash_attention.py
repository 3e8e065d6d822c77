"""Causal flash attention for prefill: Hopper kernel, plain version, wrapper.

Replaces ``llm_instance_gateway_tpu/ops/pallas_attention.py::
flash_attention_bhsd`` (and its entry ``flash_attention``).  The kernel is
``csrc/flash_prefill.cu`` (CUDA C++ for ``sm_90a``).  bf16 runs on the
tensor cores (``csrc/flash_tile_sm90.cuh``): one block per (128-row query
tile, head, row), a producer warpgroup loading K/V tiles by TMA through a
two-stage shared-memory ring, two consumer warpgroups running QK^T and PV
as ``wgmma`` with the online f32 softmax in registers, tiles above the
diagonal never loaded.  f32 runs on CUDA-core FMAs (``csrc/flash_tile.cuh``),
which keeps the card's f32 checks at summation-order agreement.  Either
way the [S, S] scores never reach device memory.  Its bound on an H100 is
the causal flops ``2*B*H*S*(S+1)*hd`` at 989 TFLOP/s (bf16) or its bytes
at 3.35 TB/s, whichever is larger.  The bf16 kernel rounds P to bf16 before
PV (a relative 2^-9 per probability), its one departure from the TPU
kernel; ``tests/test_torch_flash_numerics.py`` shows it within the card
checks' limit.

``flash_attention`` dispatches on the tensors' device only: a CPU tensor
takes ``flash_attention_reference`` (the plain version, used by the CPU
tests), a CUDA tensor launches the kernel or raises — there is no fallback
to the plain version or to a library kernel on the card.  ``launches``
counts kernel launches, so a run can show the serving path went through
the kernel.

Gradient: with grad mode on and an input that requires grad,
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``).  Its forward on a bf16 CUDA tensor is the
training forward ``flash_forward_lse``: the same kernel, which also writes
each row's base-2 log-sum-exp (``csrc/flash_backward.cu``'s second C
entry); it saves that lse beside q, k, v and out.  Its backward is
``flash_attention_backward``: on a CUDA tensor the hand-written backward
``csrc/flash_backward.cu`` — bf16 at hd 64/128/256 on ``wgmma`` fed by TMA
(delta, dK/dV per key tile with the group split ``split_plan`` chooses for
few blocks, dQ; P and dS rounded to bf16 as the forward rounds P), f32 on
CUDA-core FMAs with its own lse pass; no atomics — on a CPU tensor
``flash_attention_backward_reference``.  The kernel's output has no
``grad_fn``, so the raw forward launch (``flash_prefill_kernel``) refuses
grad-requiring inputs under grad mode rather than cut the graph silently.
Without grad the call takes the serving path unchanged.
``backward_launches`` counts the backward's launches (one per call: its
kernels from one C entry); the training forward counts in ``launches``.
"""

from __future__ import annotations

import math

import torch

from llm_instance_gateway_tpu_torch.ops import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset (plain int, host side).
launches = 0
backward_launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: causal GQA attention,
    q [B, S, H, hd], k/v [B, S, K, hd] -> [B, S, H, hd].  Same numerics as
    the TPU kernel: q * scale in f32, K/V upcast, f32 softmax, f32 PV,
    output cast to q's dtype."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, s, n_kv, h // n_kv, hd) * scale
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, k.float())
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = torch.where(causal, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgij,bjkh->bikgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B,S,H,hd], k/v [B,S,K,hd] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError("flash_attention: q and k/v disagree on B, S or hd")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} heads over {k.shape[2]} "
                         "KV heads")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h // k.shape[2] > 65535 or b > 65535 or h > 65535:
        raise ValueError("flash_attention: grid too large")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype} (float32 or "
                         "bfloat16, all three alike)")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous "
                             "on one device")


def flash_prefill_kernel(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """The raw forward launch on CUDA tensors.  Its output has no
    ``grad_fn``, so it raises on an input that requires grad while grad
    mode is on: such a call goes through ``FlashAttention``."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_prefill_kernel: an input requires grad "
                           "under grad mode; the raw launch would cut the "
                           "autograd graph (call flash_attention)")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    fn = _build.load("flash_prefill").flash_prefill_launch
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_prefill")
    launches += 1
    return out


def _forward(q, k, v):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return flash_prefill_kernel(q, k, v)


def flash_forward_lse(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward on bf16 CUDA tensors: ``(out, lse)``, out
    bitwise ``flash_prefill_kernel``'s and lse [B, H, S] f32 each row's
    log-sum-exp of its masked scaled logits in base 2 (lse / ln 2), for
    ``flash_attention_backward``.  Counts in ``launches``."""
    global launches
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("flash_forward_lse: bf16 CUDA tensors only "
                         f"(got {q.dtype} on {q.device})")
    _check(q, k, v)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_backward").flash_forward_lse_launch
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, k.shape[2], hd, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_prefill")
    launches += 1
    return out, lse


def split_plan(b: int, s: int, h: int, n_kv: int, hd: int, sms: int) -> int:
    """How many blocks share each KV head's group in the bf16 dK/dV pass.

    That pass has one block per (key tile, KV head, row): 128 keys (64 at
    hd 256), so one KV head (Gemma-2B's 8:1) or a short S leaves SMs idle.
    Below two blocks per SM the group's heads are split over the fewest
    blocks (a divisor of H/K) that give every SM one, or over all H/K when
    none does; each split writes f32 partials that a reduction sums in
    split order.  From shapes and the SM count only, never from data."""
    rows = 64 if hd == 256 else 128
    blocks = -(-s // rows) * n_kv * b
    g = h // n_kv
    if blocks >= 2 * sms:
        return 1
    return next((d for d in range(1, g + 1)
                 if g % d == 0 and blocks * d >= sms), g)


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def flash_attention_backward_reference(q, k, v, out, dout):
    """The backward kernel's function in plain PyTorch, explicit f32
    arithmetic: P from the masked f32 logits, dP = dout . v^T,
    delta = rowsum(dout * out), dS = P (dP - delta), dq = scale dS k,
    dk = scale dS^T q and dv = P^T dout summed over each KV head's group;
    each cast to its input's dtype.  Returns (dq, dk, dv)."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, s, n_kv, g, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, s, n_kv, g, hd)
    logits = torch.einsum("bikgh,bjkh->bkgij", qf * scale, kf)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    p = torch.softmax(torch.where(causal, logits, NEG_INF), dim=-1)
    dp = torch.einsum("bikgh,bjkh->bkgij", dof, vf)
    delta = (dof * out.float().reshape(b, s, n_kv, g, hd)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgij,bjkh->bikgh", ds, kf) * scale
    dk = torch.einsum("bkgij,bikgh->bjkh", ds, qf) * scale
    dv = torch.einsum("bkgij,bikgh->bjkh", p, dof)
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_backward(q, k, v, out, dout, lse=None, splits=None):
    """(dq, dk, dv) of causal GQA attention given its output and the
    output's gradient (all contiguous, q's layout for out and dout).

    ``lse``: on bf16 CUDA tensors, the training forward's base-2 lse
    [B, H, S] (``flash_forward_lse``), which saves the backward a QK^T
    pass; without it the backward computes it first.  f32 computes its
    own and takes none; the CPU's plain version needs none.  ``splits``
    overrides ``split_plan`` (bf16; a divisor of H/K).

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernels, or
    ``ValueError`` for a shape they do not take."""
    global backward_launches
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, dout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    for t in (out, dout):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError("flash_attention_backward: out and dout must "
                             "be contiguous, of q's shape, dtype and device")
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if lse is not None and (not bf16 or lse.shape != (b, h, s)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: lse is the bf16 "
                         "training forward's, f32 [B, H, S] on q's device")
    if splits is None:
        splits = split_plan(b, s, h, n_kv, hd, _sm_count(q.device)) \
            if bf16 else 1
    if splits < 1 or (h // n_kv) % splits or (splits > 1 and not bf16):
        raise ValueError(f"flash_attention_backward: {splits} splits of "
                         f"{h // n_kv} heads")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse_buf = lse if lse is not None else torch.empty(
        (b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, splits) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = _build.load("flash_backward").flash_backward_launch
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse_buf.data_ptr(), delta.data_ptr(),
            part.data_ptr() if part is not None else None, b, s, h, n_kv,
            hd, _DTYPES[q.dtype], splits, int(lse is not None),
            1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_backward")
    backward_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: forward the training forward
    on bf16 CUDA tensors (saving its lse), else the kernel or plain
    version; backward ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cuda" and q.dtype == torch.bfloat16:
            out, lse = flash_forward_lse(q, k, v)
        else:
            out, lse = _forward(q, k, v), None
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, out, dout.contiguous(),
                                        lse=lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention in the model layout (right-padded batches).

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernel, or
    ``ValueError`` for a shape it does not take.  Under grad mode with an
    input that requires grad, through ``FlashAttention`` (differentiable,
    the backward kernel on the card)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v)
