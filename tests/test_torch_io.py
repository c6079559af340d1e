"""paddle_tpu_torch.io (datasets, samplers, DataLoader) and
paddle_tpu_torch.metric, held against paddle_tpu: for one seed the batch
order and contents are the JAX DataLoader's, with num_workers 0 and 2
and for every sampler (exact: the same numpy arrays); the metrics give
the JAX package's values on the same numpy inputs (exact, and the cases
of tests/test_metric_vision.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.core import generator as jgen

import paddle_tpu_torch.io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.core import generator as tgen
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.dygraph import guard

from torch_io_worker import Squares


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _batches(loader):
    return [[_np(f) for f in b] for b in loader]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


SAMPLERS = {
    "sequence": lambda io, ds: io.BatchSampler(
        sampler=io.SequenceSampler(ds), batch_size=4),
    "random": lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds), batch_size=4, drop_last=True),
    "random_replacement": lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds, replacement=True, num_samples=17),
        batch_size=5),
    "weighted": lambda io, ds: io.BatchSampler(
        sampler=io.WeightedRandomSampler(
            np.linspace(0.1, 1.0, len(ds)), 15), batch_size=4),
    "batch_shuffle": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=6),
    "distributed_r0": lambda io, ds: io.DistributedBatchSampler(
        ds, 4, num_replicas=3, rank=0, shuffle=True),
    "distributed_r2": lambda io, ds: io.DistributedBatchSampler(
        ds, 4, num_replicas=3, rank=2, shuffle=False, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_batches_equal_the_jax_packages(name):
    ds = Squares()
    jgen.seed(7)
    ref = [list(b) for e in range(2)
           for b in SAMPLERS[name](jio, ds)]
    tgen.seed(7)
    got = [list(b) for e in range(2)
           for b in SAMPLERS[name](tio, ds)]
    assert got == ref and len(got) > 0


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_order_and_contents_equal_the_jax_packages(workers):
    ds = Squares()
    kw = dict(batch_size=4, shuffle=True, drop_last=False,
              num_workers=workers)
    jgen.seed(3)
    ref = _batches(jio.DataLoader(ds, **kw)) + \
        _batches(jio.DataLoader(ds, **kw))
    with guard(CPUPlace()):
        tgen.seed(3)
        tl = tio.DataLoader(ds, **kw)
        first = list(tl)
        assert all(isinstance(f, torch.Tensor) for b in first for f in b)
        got = [[_np(f) for f in b] for b in first] + _batches(tl)
    _same(got, ref)
    assert len(tl) == len(ref) // 2


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_batch_sampler_and_collate(workers):
    ds = Squares(11)

    def collate(samples):
        return [np.stack([s[0] for s in samples]) * 2]

    with guard(CPUPlace()):
        bs = tio.DistributedBatchSampler(ds, 3, num_replicas=2, rank=1)
        got = _batches(tio.DataLoader(ds, batch_sampler=bs,
                                      collate_fn=collate,
                                      num_workers=workers))
    ref = _batches(jio.DataLoader(
        ds, batch_sampler=jio.DistributedBatchSampler(
            ds, 3, num_replicas=2, rank=1), collate_fn=collate,
        num_workers=workers))
    _same(got, ref)


def test_dataset_family_equals_the_jax_packages():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)

    def items(io, ds):
        return [tuple(_np(f) for f in (s if isinstance(s, tuple) else (s,)))
                for s in (ds if isinstance(ds, io.IterableDataset)
                          else [ds[i] for i in range(len(ds))])]

    def family(io):
        td = io.TensorDataset([a, b])
        out = [items(io, td),
               items(io, io.ComposeDataset([td, io.TensorDataset([a * 2])])),
               items(io, io.ConcatDataset([td, io.TensorDataset([a, b])])),
               items(io, io.Subset(td, [4, 0, 2]))]
        return out

    ref = family(jio)
    got = family(tio)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for x, y in zip(g, r):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    # torch tensors go to the host once
    td = tio.TensorDataset([torch.from_numpy(a), torch.from_numpy(b)])
    np.testing.assert_array_equal(td[3][0], a[3])
    # random_split with a seeded generator
    rs = [list(s.indices) for s in tio.random_split(range(10), [6, 4],
                                                     generator=5)]
    assert rs == [list(s.indices) for s in jio.random_split(
        range(10), [6, 4], generator=5)]


def test_iterable_dataset_and_chain():
    class Count(tio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            for i in range(self.n):
                yield np.asarray([i, i * i], np.float32)

    with guard(CPUPlace()):
        got = [_np(b) for b in tio.DataLoader(
            tio.ChainDataset([Count(5), Count(3)]), batch_size=3)]
    want = np.asarray([[i, i * i] for i in list(range(5)) + list(range(3))],
                      np.float32)
    assert [b.shape[0] for b in got] == [3, 3, 2]
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert tio.get_worker_info() is None


def test_from_generator_refuses_naming_the_queue():
    with pytest.raises(NotImplementedError, match="Queue 1, The rest"):
        tio.DataLoader.from_generator()


# ---------------------------------------------------------------------------
# metric (tests/test_metric_vision.py's cases, then against the JAX package)
# ---------------------------------------------------------------------------
def test_accuracy_topk():
    m = tmetric.Accuracy(topk=(1, 2))
    pred = np.asarray([[0.1, 0.7, 0.2], [0.6, 0.3, 0.1]], np.float32)
    label = np.asarray([[1], [2]], np.int64)
    m.update(m.compute(torch.from_numpy(pred), torch.from_numpy(label)))
    top1, top2 = m.accumulate()
    assert top1 == pytest.approx(0.5)
    assert top2 == pytest.approx(0.5)
    m.reset()
    assert m.count == 0


def test_precision_recall():
    p, r = tmetric.Precision(), tmetric.Recall()
    preds = np.asarray([0.9, 0.8, 0.2, 0.6], np.float32)
    labels = np.asarray([1, 0, 1, 1], np.int64)
    p.update(preds, labels)
    r.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert p.accumulate() == pytest.approx(2 / 3)
    assert r.accumulate() == pytest.approx(2 / 3)


def test_auc_perfect_and_random():
    auc = tmetric.Auc()
    preds = np.stack([1 - np.linspace(0, 1, 100),
                      np.linspace(0, 1, 100)], axis=1)
    labels = (np.linspace(0, 1, 100) > 0.5).astype(np.int64)
    auc.update(preds, labels)
    assert auc.accumulate() > 0.99
    auc.reset()
    assert auc.accumulate() == 0.0


def test_functional_accuracy():
    pred = np.asarray([[0.9, 0.1], [0.2, 0.8]], np.float32)
    label = np.asarray([[0], [0]], np.int64)
    assert tmetric.accuracy(pred, label) == pytest.approx(0.5)


def test_metrics_equal_the_jax_packages_over_batches():
    rng = np.random.RandomState(0)
    pairs = {"acc": (jmetric.Accuracy(topk=(1, 3)),
                     tmetric.Accuracy(topk=(1, 3))),
             "prec": (jmetric.Precision(), tmetric.Precision()),
             "rec": (jmetric.Recall(), tmetric.Recall()),
             "auc": (jmetric.Auc(num_thresholds=255),
                     tmetric.Auc(num_thresholds=255))}
    for _ in range(4):
        logits = rng.randn(16, 6).astype(np.float32)
        label = rng.randint(0, 6, (16, 1)).astype(np.int64)
        prob = rng.rand(16).astype(np.float32)
        blabel = rng.randint(0, 2, 16).astype(np.int64)
        jm, tm = pairs["acc"]
        jm.update(jm.compute(logits, label))
        tm.update(tm.compute(torch.from_numpy(logits),
                             torch.from_numpy(label)))
        for k in ("prec", "rec"):
            pairs[k][0].update(prob, blabel)
            pairs[k][1].update(torch.from_numpy(prob),
                               torch.from_numpy(blabel))
        two = np.stack([1 - prob, prob], axis=1)
        pairs["auc"][0].update(two, blabel)
        pairs["auc"][1].update(torch.from_numpy(two),
                               torch.from_numpy(blabel))
    for k, (jm, tm) in pairs.items():
        assert tm.accumulate() == jm.accumulate(), k
        assert tm.name() == jm.name(), k
