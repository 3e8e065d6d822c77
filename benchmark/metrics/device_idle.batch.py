"""Device: share of the traced slice with no kernel, copy or fill running
(``torch.profiler``), under batch traffic, in percent."""


def read(w):
    return w.device_idle_pct()
