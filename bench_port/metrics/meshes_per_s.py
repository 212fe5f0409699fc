"""Meshes completed in the window over the window, host clock: every
request's rows, from the first request's send to the last one's answer on
the host."""


def read(run):
    if run.kind != "serve" or run.window.seconds <= 0:
        return None
    return run.window.items / run.window.seconds
