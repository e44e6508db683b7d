"""reveal_ms.audit: the validator's own ``reveal_roundtrip`` plus
``merkle_verify`` (the signed reveal over the mock transport, the miner's
proof store or spool, and the paths checked), per audit."""

from . import mean_timing, window


def read(run, suffix):
    return mean_timing(window(run, suffix), "reveal_roundtrip", "merkle_verify")
