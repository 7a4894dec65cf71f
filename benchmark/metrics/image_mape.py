"""Mean, over every job of the window, of the MAPE of its guided image
against the configuration's pinned ground truth."""


def read(run):
    vals = run.extra.get("image_mape")
    return sum(vals) / len(vals) if vals else None
