"""Tensor ops of the port: attention dispatch, GroupNorm, noise, scheduler."""
