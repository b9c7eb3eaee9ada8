"""CPU tests of the benchmark. Run from the repository's root:
``python -m pytest portbench/tests -q``. Tests marked ``gpu`` need a CUDA
card and skip without one."""

import torch

torch.set_num_threads(2)
