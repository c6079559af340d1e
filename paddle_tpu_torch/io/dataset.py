"""Dataset abstractions — paddle.io parity.

Counterpart of paddle_tpu/io/dataset.py (the reference's
fluid/dataloader/dataset.py: Dataset, IterableDataset, TensorDataset,
ComposeDataset, ChainDataset, ConcatDataset, Subset, random_split), the
same code: samples are numpy on the host.  `TensorDataset` also takes
torch tensors (copied to the host once).
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    """Map-style dataset: implement __getitem__ and __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            "'{}' not implement in class {}".format("__getitem__",
                                                    self.__class__.__name__))

    def __len__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format("__len__",
                                                    self.__class__.__name__))


class IterableDataset(Dataset):
    """Stream-style dataset: implement __iter__."""

    def __iter__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format("__iter__",
                                                    self.__class__.__name__))

    def __getitem__(self, idx):
        raise RuntimeError("'{}' should not be called for IterableDataset"
                           .format("__getitem__"))

    def __len__(self):
        raise RuntimeError("'{}' should not be called for IterableDataset"
                           .format("__len__"))


def _host(t):
    """A numpy view of an array-like; a torch tensor is copied to the
    host once (it may live on the card)."""
    if hasattr(t, "detach") and hasattr(t, "cpu"):
        t = t.detach().cpu()
    return np.asarray(t)


class TensorDataset(Dataset):
    """Wrap a list of equal-first-dim arrays; sample i is the tuple of
    slices[i]."""

    def __init__(self, tensors: Sequence):
        arrays = [_host(t) for t in tensors]
        if not arrays:
            raise ValueError("TensorDataset needs at least one tensor")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all tensors must share dim-0 size")
        self.tensors = arrays

    def __getitem__(self, index):
        return tuple(a[index] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Zip several map-style datasets: sample i concatenates each dataset's
    sample i fields."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets must not be empty")
        n = len(self.datasets[0])
        for d in self.datasets:
            if isinstance(d, IterableDataset):
                raise TypeError("ComposeDataset does not support "
                                "IterableDataset")
            if len(d) != n:
                raise ValueError("lengths of datasets differ")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            s = d[idx]
            if not isinstance(s, (tuple, list)):
                s = (s,)
            sample.extend(s)
        return tuple(sample)


class ChainDataset(IterableDataset):
    """Concatenate several stream-style datasets back to back."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            for s in d:
                yield s


class ConcatDataset(Dataset):
    """Concatenate map-style datasets (torch-style; used by random_split)."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[di - 1] if di > 0 else 0
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int],
                 generator=None) -> List[Subset]:
    if sum(lengths) != len(dataset):
        raise ValueError("sum of input lengths does not equal the length of "
                         "the input dataset")
    rng = np.random.default_rng(generator)
    perm = rng.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out
