"""Mean true rows of the engine's decodes that ended in the window."""

from harness.readers import window_decodes


def read(run):
    ds = window_decodes(run)
    return sum(d.rows for d in ds) / len(ds) if ds else None
