"""Host milliseconds of a render_default_mega call, call to return (the
scene's packing, the tree's build on a culled scene, the launch), mean
over the traced window."""

from benchmark import readers


def read(run):
    return readers.span_mean_ms(run, "render_default_mega")
