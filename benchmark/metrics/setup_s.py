"""Seconds from the process's start to the window's first frame: scene,
kernel library (built in the checkout on its first run), warm-up."""


def read(run):
    return run.setup_s
