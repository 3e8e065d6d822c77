"""Bridge from the reference's parameter pytrees (as numpy) to the port's.

The port keeps the JAX package's tree layout, so the bridge is a leaf-wise
conversion: ``params_from_numpy(jax.tree.map(np.asarray, params), ...)``
gives the port the same weights, and ``lora_from_numpy`` does the same for
LoRA slot buffers.  bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy) cross
bit-exactly through a uint16 view.  Every parity test uses these.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(arr, device="cuda", dtype=None) -> torch.Tensor:
    """One array -> tensor on ``device`` (bf16 bits preserved), optionally
    cast to ``dtype``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """Nested dict of arrays -> nested dict of tensors.  ``dtype`` casts the
    floating leaves (integer leaves keep theirs); an int8 weight's
    ``{"q", "s"}`` leaf keeps its scale in float32 whatever ``dtype`` is."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return {"q": tensor_from_numpy(tree["q"], device),
                    "s": tensor_from_numpy(tree["s"], device, torch.float32)}
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)


def lora_from_numpy(bufs: dict, device="cuda", dtype=None) -> dict:
    """LoRA slot buffers (``init_lora_buffers`` layout) -> tensors.  The
    per-slot ``scale`` stays float32 whatever ``dtype`` is."""
    out = params_from_numpy(bufs, device, dtype)
    out["scale"] = tensor_from_numpy(bufs["scale"], device, torch.float32)
    return out
