"""One torch thread in each test process.

Tier-1 runs six pytest workers on the host's cores. torch's CPU ops
would each start a thread per core in every worker, and the tiny ops of
the port's tests then spend most of their time waiting on one another's
threads. Importing this module (every ``tests/test_torch_*.py`` does)
keeps each worker's torch ops on one thread.
"""

import torch

torch.set_num_threads(1)
