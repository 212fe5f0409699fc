"""The benchmark's host span around each step call, up to the call's
return (before the harness waits for the card), mean over the untraced
window, ms."""


def read(run):
    if run.kind != "train" or not run.window.dispatch:
        return None
    return 1e3 * sum(run.window.dispatch) / len(run.window.dispatch)
