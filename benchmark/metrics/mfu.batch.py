"""The model step's share of the card's bf16 peak: the operations the
window's traffic needed (``Window.model_flops``: prefills less their
reused prefix, every decoded token at its context) over the window's
seconds times 989 TFLOP/s, in percent."""


def read(w):
    return w.mfu_pct()
