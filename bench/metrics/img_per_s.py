"""Images of every request served inside the window over the window's
seconds (host clock)."""


def read(run):
    return sum(r.batch for r in run.done) / run.window_s
