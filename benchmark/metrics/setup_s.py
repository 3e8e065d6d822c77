"""Process start to the window's start: weights, the engine, the kernel
builds and the warm-up."""


def read(w):
    return w.setup_s
