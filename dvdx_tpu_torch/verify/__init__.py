"""Proof-of-Inference commitments."""
