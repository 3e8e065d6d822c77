"""Every output token emitted inside the window (first tokens included),
over the window's seconds."""


def read(w):
    return w.output_tok_per_s()
