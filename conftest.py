"""One torch thread in every test process.

The suite runs as several test processes side by side on one machine, and
the port's tests are mostly many small torch ops. Torch's default pool of
one thread per core in each process then only makes those ops wait on each
other. Pytest loads this file before any test module, so no test file sets
its own thread count. (Spawned ranks load no conftest and set their own.)
"""

import torch

torch.set_num_threads(1)
