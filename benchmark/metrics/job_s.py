"""Window seconds over the learning jobs completed in it."""

from benchmark import readers


def read(run):
    if readers.loop(run) != "learning_jobs" or not run.answers:
        return None
    return run.window_s / run.answers
