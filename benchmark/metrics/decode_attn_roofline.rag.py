"""The paged decode attention kernels under RAG traffic on a mixture of
experts, against their byte bound over the traced slice
(``Window.decode_attn_roofline_pct``), in percent."""


def read(w):
    return w.decode_attn_roofline_pct()
