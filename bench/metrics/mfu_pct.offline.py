"""The model's FLOPs at the window's image rate over the card's
f32-accurate peak, in percent: the whole step's share."""


def read(run):
    if run.peak is None or not run.done:
        return None
    images_s = sum(r.batch for r in run.done) / run.window_s
    per_image = run.flops_per_request / run.cell.traffic["batch"]
    return per_image * images_s / run.peak["flops"] * 100
