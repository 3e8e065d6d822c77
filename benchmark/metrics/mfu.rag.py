"""The model step's share of the card's bf16 peak under RAG traffic on a
mixture of experts (two of eight experts a token): the operations the
window's traffic needed over the window's seconds times 989 TFLOP/s, in
percent."""


def read(w):
    return w.mfu_pct()
