"""Process start to the first timed request, seconds (host clock)."""


def read(run):
    return run.setup_s
