"""Every output token emitted inside the window (first tokens included),
over the window's seconds, under RAG traffic on a mixture of experts:
its seeds spread several times wider than the dense model's, so it has a
bound of its own."""


def read(w):
    return w.output_tok_per_s()
