"""1 - (the union of the device's kernel and copy intervals / the traced
window); left out where the profiler missed launches."""

from harness.readers import idle_share


def read(run):
    return idle_share(run)
