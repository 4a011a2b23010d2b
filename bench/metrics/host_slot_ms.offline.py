"""Host milliseconds of the engine's ``advance`` (every group's replay
enqueued, one admission) a slot, over the window (the harness's timer)."""


def read(run):
    if not run.window.slots:
        return None
    return run.window.advance_s / run.window.slots * 1e3
