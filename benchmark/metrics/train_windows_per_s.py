"""Training windows stepped in the window, per second of the window
(ended by a device synchronise)."""


def read(run):
    if "windows" not in run.counts:
        return None
    return run.counts["windows"] / run.window_s
