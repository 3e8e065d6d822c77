"""Decode block under batch traffic (a closed loop that keeps the slots
full): the engine profiler's decode block walls over their steps, inside
the window."""


def read(w):
    return w.decode_step_ms()
