"""Host milliseconds a render_default_mega call spends preparing its
launch (the program's spans ``.pack`` and ``.outputs``), mean over the
traced window."""

from benchmark import recorded


def read(run):
    return recorded.phase_ms(run, "render_default_mega",
                             ("pack", "outputs"))
