"""Decode block: rows active per decode step inside the window (the
profiler's dispatch records, weighted by their steps)."""


def read(w):
    return w.decode_rows_mean()
