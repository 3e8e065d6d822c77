"""The paged decode attention kernels (split and combine, ``decode_tile``)
against their byte bound, over the traced slice: the keys and values the
decoded tokens emitted in the slice needed (each row's context, every
layer, each byte once) at 3.35 TB/s, over the kernels' device seconds in
the slice, in percent.  A token is emitted on the host after its step ran,
so the slice's edges shift the count by at most a block each way."""


def read(w):
    return w.decode_attn_roofline_pct()
