"""dispatch_ms.video: the miner's own ``gen_dispatch_loop`` (text, noise, the
denoise loop and the decode handed to the device), per request."""

from . import mean_timing, window


def read(run, suffix):
    return mean_timing(window(run, suffix), "gen_dispatch_loop")
