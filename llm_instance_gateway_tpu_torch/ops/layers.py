"""Elementwise/normalization building blocks (port of ``ops/layers.py``).

Plain PyTorch ops: RMSNorm and RoPE accumulate in float32 and cast back to
the activation dtype, the reference's mixed-precision discipline.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32.  ``plus_one`` selects the Gemma (1+w) convention."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (normed * w).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, scaling: tuple | None = None,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding, shape [head_dim//2], f32.

    ``scaling`` = (factor, low_freq_factor, high_freq_factor, original_max)
    applies the Llama-3.1 long-context frequency remapping.
    """
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    # A fill, not torch.tensor(theta, device=...): no host-to-device copy,
    # so the decode block's CUDA graph can hold it.
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=device), exponents)
    if scaling is None:
        return freqs
    factor, low_ff, high_ff, original_max = scaling
    wavelen = 2.0 * math.pi / freqs
    low_freq_wavelen = original_max / low_ff
    high_freq_wavelen = original_max / high_ff
    smooth = (original_max / wavelen - low_ff) / (high_ff - low_ff)
    interpolated = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(wavelen > low_freq_wavelen, freqs / factor,
                       torch.where(wavelen < high_freq_wavelen, freqs,
                                   interpolated))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: tuple | None = None) -> torch.Tensor:
    """Rotary position embedding, split-halves convention (pairs (x_i,
    x_{i+d/2})).  x: [..., seq, heads, head_dim]; positions broadcastable to
    [..., seq].  Computed in f32, cast back."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, scaling, device=x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor,
           gelu: bool = False) -> torch.Tensor:
    """Gated MLP activation: SiLU (Llama) or tanh-GeLU (Gemma)."""
    act = F.gelu(gate, approximate="tanh") if gelu else F.silu(gate)
    return act * up
