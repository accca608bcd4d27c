"""One intra-op CPU thread for PyTorch in the port's tests.

The tier-1 command runs the suite in six pytest workers on one host. With
PyTorch's default of one OpenMP thread a core in every worker, the
workers' thread pools contend for the cores, and the tests' small
operations wait on them: six copies of one continuous-batching test took
252 s each side by side against 57 s with one thread a worker (an 8-core
host). One thread changes no test's inputs, sizes or tolerances.
Imported by every ``tests/test_torch_*.py`` that runs on the CPU.
"""

import torch

torch.set_num_threads(1)
