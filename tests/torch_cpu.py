"""One intra-op thread for torch in every test process of the port.

The tier-1 command runs the tests in six pytest-xdist workers on one host.
Left alone, torch gives each worker as many OpenMP threads as the host has
cores, and the plain PyTorch twins of the kernels issue thousands of tiny
ops per solve: the workers' spinning threads then take turns on the cores,
and a solve that takes 0.4 s on one thread takes minutes. Every
``tests/test_torch_*.py`` imports this module before anything else.
"""

import torch

torch.set_num_threads(1)
