"""One intra-op thread for torch in every test process.

Every ``tests/test_torch_*.py`` imports this module first. Under
pytest-xdist each worker collects every file, so each worker sets the
pin before any of the port's tests runs. Without it every worker opens
a torch OpenMP pool as wide as the machine, and those pools spin
against each other (and against XLA's) for most of the run's time.
The port's CPU results do not depend on the count: every parity test
holds the same bits with one thread as with many.
"""

import torch

torch.set_num_threads(1)
