"""Admission: median over the requests due in the window of prefill start
to first token (the engine's ``phase_hist["prefill"]`` per request)."""
from benchmark.window import nearest_rank


def read(w):
    vals = [r.t_first_token - r.t_prefill_start for r in w.due()
            if r.t_first_token and r.t_prefill_start]
    return nearest_rank(vals, 0.5) * 1e3 if vals else None
