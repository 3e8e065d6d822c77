"""90th percentile, over the requests due in the window that finished
with two or more tokens, of (done - first token) / (tokens - 1)."""
from benchmark.window import nearest_rank


def read(w):
    vals = [(r.t_done - r.t_first_token) / (len(r.tokens) - 1)
            for r in w.due()
            if r.finished and r.t_done and len(r.tokens) >= 2]
    if w.loop != "open" or not vals:
        return None
    return nearest_rank(vals, 0.9) * 1e3
