"""Host milliseconds a render_sarsa_mega_train call spends preparing its
launch (the program's spans ``.pack``, ``.tables``, ``.check`` and
``.outputs``), less its waits for the card, mean over the traced
window."""

from benchmark import recorded


def read(run):
    return recorded.phase_ms(run, "render_sarsa_mega_train",
                             ("pack", "tables", "check", "outputs"),
                             self_time=True)
