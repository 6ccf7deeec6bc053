"""One intra-op thread for the port's small CPU tests.

The suite's workers share the machine's cores; on planes of a few
thousand pixels PyTorch's multi-threaded CPU ops then stall for
milliseconds each (a refinement runs thousands of them), while one
thread runs them in microseconds.  The values do not depend on it."""

import contextlib

import torch


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
