"""The wait of each step of the untraced window for its batch, in the
loader's `next` (the port's data layer: its threads build the batch, copy
it to the card and hand it over), mean over the window, ms."""


def read(run):
    if run.kind != "train" or not run.loader_wait:
        return None
    return 1e3 * sum(run.loader_wait) / len(run.loader_wait)
