"""setup_s: seconds from the process's start to the first timed unit
(weights drawn and converted, kernels loaded or built, warm-up)."""


def read(run, suffix):
    return run.setup_s
