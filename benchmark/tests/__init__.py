"""CPU tests of the benchmark. The test workers share the machine's cores:
two threads each keep them from starving one another."""

import torch

torch.set_num_threads(2)
