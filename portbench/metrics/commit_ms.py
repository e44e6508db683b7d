"""commit_ms.video: the miner's own ``merkle_commit`` (leaf hashes, tree,
proof store and spool), per request."""

from . import mean_timing, window


def read(run, suffix):
    return mean_timing(window(run, suffix), "merkle_commit")
