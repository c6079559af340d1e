"""Samplers and batch samplers — paddle.io parity.

Counterpart of paddle_tpu/io/sampler.py (the reference's
fluid/dataloader/batch_sampler.py and paddle/io: Sampler,
SequenceSampler, RandomSampler, WeightedRandomSampler, BatchSampler,
DistributedBatchSampler, whose rank shards are padded so every rank sees
the same number of batches).  The same code: an unseeded shuffle draws
its epoch seed from the port's core/generator.py (seed, process salt,
draw counter), so after one `paddle_tpu_torch.seed(s)` and the same
number of draws both packages shuffle in the same order.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


def _framework_epoch_seed():
    """Per-iteration shuffle seed derived from the global generator
    (seed + per-process salt + monotone draw counter) instead of raw OS
    entropy: epochs still shuffle differently, and independent UNSEEDED
    launches still differ (the salt is fresh entropy per process), but
    the sequence is reproducible under paddle.seed() (salt pinned to 0)
    and — because counter and salt ride checkpoint RNG state — replays
    identically after a resume (checkpoint bitwise-equivalence covers
    shuffle order, not just dropout)."""
    from ..core.generator import global_seed, next_eager_uid, process_salt
    return (global_seed(), process_salt(), next_eager_uid())


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        if not replacement and num_samples is not None \
                and num_samples > len(data_source):
            raise ValueError("num_samples exceeds dataset size without "
                             "replacement")

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.generator is not None and not isinstance(
                self.generator, (int, np.integer)):
            # user generator: iterable of indices (may run short)
            it = iter(self.generator)
            for _ in range(self.num_samples):
                try:
                    yield next(it)
                except StopIteration:
                    return
            return
        if self.generator is None:
            rng = np.random.default_rng(_framework_epoch_seed())
        else:
            rng = np.random.default_rng(self.generator)
        if self.replacement:
            yield from rng.integers(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement: bool = True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights should be non-negative")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError("num_samples exceeds weight count without "
                             "replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng(_framework_epoch_seed())
        idx = rng.choice(len(self.weights), size=self.num_samples,
                         replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


def _group_batches(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    """Groups sampler indices into batches.

    Accepts either (dataset, shuffle) or an explicit sampler, like the
    the reference's batch_sampler.py BatchSampler.
    """

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        if sampler is None:
            if dataset is None:
                raise ValueError("either dataset or sampler must be given")
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        elif dataset is not None and shuffle:
            raise ValueError("shuffle must be False when sampler is given")
        if batch_size <= 0:
            raise ValueError("batch_size should be a positive integer")
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        yield from _group_batches(self.sampler, self.batch_size,
                                  self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler for data parallelism.

    Each rank iterates a disjoint 1/nranks slice of the (optionally
    shuffled) index list, padded so all ranks see the same number of
    batches (the reference's batch_sampler.py DistributedBatchSampler).
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        if num_replicas is None or rank is None:
            from ..distributed.parallel_env import ParallelEnv
            env = ParallelEnv()
            num_replicas = num_replicas if num_replicas is not None \
                else env.world_size
            rank = rank if rank is not None else env.rank
        if not 0 <= rank < num_replicas:
            raise ValueError("rank out of range")
        if batch_size <= 0:
            raise ValueError("batch_size should be a positive integer")
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        """Reshuffle deterministically per epoch (all ranks must agree)."""
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad (repeating as many times as needed) so every rank gets the
        # same number of samples — a static per-rank step count for XLA
        pad = self.total_size - n
        if pad > 0:
            reps = -(-pad // n)  # ceil
            indices += (indices * reps)[:pad]
        local = indices[self.local_rank:self.total_size:self.nranks]
        yield from _group_batches(local, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
