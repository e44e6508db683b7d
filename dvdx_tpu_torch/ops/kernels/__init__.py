"""Wrappers of the hand-written CUDA kernels, each beside its plain version."""
