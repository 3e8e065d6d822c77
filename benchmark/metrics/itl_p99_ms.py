"""99th percentile of the gaps between consecutive output tokens, over
every token the requests due in the window emitted (on the host, where a
streaming server would send it): some 24,000 gaps a chat run, so ~240
beyond the percentile.  An eager admission stalls every running row for
its whole program, so the tail is where admissions show."""
from benchmark.window import nearest_rank


def read(w):
    gaps = [b - a for r in w.due() for a, b in zip(r.emit, r.emit[1:])]
    if w.loop != "open" or not gaps:
        return None
    return nearest_rank(gaps, 0.99) * 1e3
