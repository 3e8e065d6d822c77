"""Admission: 90th percentile over the requests due in the window of the
wait from due to the engine's prefill start (one never admitted counts as
the time the run waited for it)."""
from benchmark.window import nearest_rank


def read(w):
    due = w.due()
    if not due:
        return None
    vals = [(r.t_prefill_start if r.t_prefill_start else w.deadline) - r.due
            for r in due]
    return nearest_rank(vals, 0.9) * 1e3
