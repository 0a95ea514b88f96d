"""Raw samples of every read returned in the window, per second from the
window's start to the last return (neutral to read length)."""


def read(run):
    if "samples" not in run.counts:
        return None
    return run.counts["samples"] / run.window_s / 1e6
