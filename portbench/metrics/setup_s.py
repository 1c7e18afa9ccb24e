"""setup_s: seconds from the run's start to the end of its warm-up (host clock)."""


def read(run):
    return run.setup_s
