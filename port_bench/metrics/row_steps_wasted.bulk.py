"""1 - tokens emitted through EOS / (bucket rows x steps), over the
decodes that ended in the window: the padding rows and the steps past a
row's EOS that dynamic batching computes for nothing."""

from harness.readers import window_decodes


def read(run):
    ds = window_decodes(run)
    work = sum(d.bucket * d.steps for d in ds)
    return 1.0 - sum(d.tokens for d in ds) / work if work else None
