"""Images answered in the window, over the window's seconds."""


def read(run):
    n = sum(len(r.images) for r in run.done_in_window())
    return n / run.seconds if n else None
