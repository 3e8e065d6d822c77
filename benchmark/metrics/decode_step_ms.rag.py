"""Decode block under RAG traffic on a mixture of experts (a closed loop):
the engine profiler's decode block walls over their steps, inside the
window."""


def read(w):
    return w.decode_step_ms()
