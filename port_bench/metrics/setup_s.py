"""Process start to the window's first request: loading, the kernel
library's build on a checkout's first run, warm-up."""


def read(run):
    return run.setup_s
