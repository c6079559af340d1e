"""A dataset for the DataLoader worker tests (tests/test_torch_io.py):
module-level and numpy-only, so a spawned worker process of either
package unpickles it without importing the test module (a map-style
dataset needs only `__len__` and `__getitem__`)."""
import numpy as np


class Squares:
    """Sample i: (features [3] float32, label int64)."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.arange(3, dtype=np.float32) + i * i,
                np.asarray(i % 5, np.int64))
