"""The batcher's ``decode`` stage (executor hop, the decode, its host
reads and detokenization) over the window, per decoder step of the
decodes that ended in it."""

from harness.readers import delta, window_decodes


def read(run):
    steps = sum(d.steps for d in window_decodes(run))
    return delta(run, "decode_s") / steps * 1e3 if steps else None
