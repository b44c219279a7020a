"""Torch's intra-op threads in the test processes.

The suite runs in several xdist workers on one machine, and each worker's
torch would start one intra-op thread per core: on tiny tensors those
threads spend their time spinning against each other and against the
other workers' (a Dreamer-V3 drill that takes 5 s alone took over 120 s
among six workers). Importing this module, which collection does in every
worker, keeps the port's CPU tests on one intra-op thread each; it
changes no result, only how the work is scheduled.
"""

import torch

torch.set_num_threads(1)


def test_port_tests_use_one_intra_op_thread():
    assert torch.get_num_threads() == 1
