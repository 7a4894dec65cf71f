"""Host milliseconds of a render_sarsa_mega_train or render_guided_mega
call, call to return (packing, the table's check and its wait, the
launch), mean over the traced window."""

from benchmark import readers


def read(run):
    return readers.span_mean_ms(run, "render_sarsa_mega_train",
                                "render_guided_mega")
