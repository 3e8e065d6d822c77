"""Device: share of the traced slice with no kernel, copy or fill running
(``torch.profiler``), under RAG traffic on a mixture of experts, in
percent."""


def read(w):
    return w.device_idle_pct()
