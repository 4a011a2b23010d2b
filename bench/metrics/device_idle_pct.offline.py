"""Share of the traced slice in which no operation ran on the card (the
union of every device operation's interval), in percent."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return (1 - s.busy_s / s.window_s) * 100
