"""Process start to the first timed request: imports, the kernel
library, the SM split, weights and images, the schedule, the warm-up
traffic and its lane captures (host clock)."""


def read(run):
    return run.setup_s
