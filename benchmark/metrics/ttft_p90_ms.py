"""90th percentile, over every request due in the window, of its first
token's time after it was due (a request that never answered counts as
the time the run waited for it)."""
from benchmark.window import nearest_rank


def read(w):
    due = w.due()
    if w.loop != "open" or not due:
        return None
    return nearest_rank([w.ttft_s(r) for r in due], 0.9) * 1e3
