"""Kernel launches the port counted over the window's slots (its
wrappers' counts, carried by each replayed graph) per request served in
those slots."""


def read(run):
    if not run.window.served:
        return None
    return run.window.launches / len(run.window.served)
