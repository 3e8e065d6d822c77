"""PyTorch + CUDA port of the model server, for one NVIDIA H100.

The JAX package ``llm_instance_gateway_tpu`` stays the reference; this
package imports ``torch`` and nothing of it (``tests/test_torch_*.py``
enforce both, and hold every module here to its JAX counterpart on the
CPU).  Public functions keep the reference's layouts: layer-stacked
parameter leaves, ``x @ w`` with ``[in, out]`` weights, attention in
``[B, S, H, hd]`` and a decode cache of ``[L, B, S_max, K, hd]``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or ``--device cpu``).  The two attention kernels on the serving path are
hand-written CUDA C++ for ``sm_90a`` (``ops/csrc/``); on a CPU tensor their
wrappers take the plain PyTorch version beside each kernel.
"""
