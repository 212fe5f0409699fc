"""Samples stepped in the window over the window, host clock: every step's
batch, from the first step's call to the synchronize after the last."""


def read(run):
    if run.kind != "train" or run.window.seconds <= 0:
        return None
    return run.window.items / run.window.seconds
