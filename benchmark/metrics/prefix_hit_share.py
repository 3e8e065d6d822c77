"""Prefix cache: prompt tokens the engine took from the cache during the
window (``prefix_reused_tokens``) over the prompt tokens of the requests
admitted in it, in percent."""


def read(w):
    if "prefix_reused_tokens" not in w.snap1:
        return None
    admitted = sum(len(r.prompt) for r in w.records
                   if r.t_prefill_start and w.t0 <= r.t_prefill_start < w.t1)
    if not admitted:
        return None
    reused = (w.snap1["prefix_reused_tokens"]
              - w.snap0["prefix_reused_tokens"])
    return reused / admitted * 100.0
