"""Process start to the first timed window (loading, building, warm-up)."""


def read(run):
    return run.setup_s
