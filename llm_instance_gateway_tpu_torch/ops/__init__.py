"""Attention and layer ops, with the hand-written Hopper kernels."""
