"""Distributed execution of the port: the strategies of
``dvdx_tpu/parallel`` on ``torch.distributed`` process groups (chunked and
pre-conditioned denoising, FSDP-style parameter sharding, ring and Ulysses
context parallelism), the strategy benchmark and the chunk coordinator."""
