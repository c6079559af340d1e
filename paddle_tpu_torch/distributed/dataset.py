"""The industrial dataset path: InMemoryDataset / QueueDataset and the
MultiSlot feed.

Counterpart of paddle_tpu/distributed/dataset.py (the reference's
DatasetFactory, InMemoryDataset's load_into_memory / local_shuffle /
global_shuffle, QueueDataset, the MultiSlot text format and the
MultiTrainer hot loop behind Executor.train_from_dataset).

  * The MultiSlot text format is parsed into numpy batches; an integer
    slot is a sparse id slot, padded per batch (to a multiple of 8 when
    ragged) with its lengths fed as `<slot>.lod` where the program
    declares that var; a float slot is dense.
  * The reference's N device workers become one producer thread that
    parses batches into a bounded queue (the standard library's: the JAX
    package prefers its native C++ BlockingQueue, which the port does not
    have), and a second stage (reader/prefetcher.py) that places each
    batch on the executor's device ahead of the step that runs it.
  * global_shuffle hash-partitions the instances over the trainers (each
    keeps the crc32 % N == rank slice of the same filelist) and shuffles
    its own shard with the dataset's seed.
"""
from __future__ import annotations

import glob as _glob
import threading
import zlib
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset",
           "QueueDataset", "MultiSlotDataFeed"]


class MultiSlotDataFeed:
    """Parser for the MultiSlot text format (data_feed.h:302): each line
    holds, per slot in order, `<count> v1 ... v<count>`.  Slot dtype comes
    from the bound use_vars: integer vars are sparse id slots
    (variable-length), float vars are dense slots."""

    def __init__(self, slot_names: List[str], slot_dtypes: List[str]):
        self.slot_names = list(slot_names)
        self.slot_dtypes = list(slot_dtypes)

    def parse_line(self, line: str):
        toks = line.split()
        rec, i = [], 0
        for dt in self.slot_dtypes:
            if i >= len(toks):
                raise ValueError(f"truncated MultiSlot line: {line!r}")
            n = int(toks[i])
            i += 1
            vals = toks[i:i + n]
            if len(vals) != n:
                raise ValueError(f"slot count {n} exceeds line: {line!r}")
            i += n
            if "int" in dt:
                rec.append(np.asarray([int(v) for v in vals], np.int64))
            else:
                rec.append(np.asarray([float(v) for v in vals], np.float32))
        return rec


class DatasetBase:
    """fluid.dataset.DatasetBase parity: configuration + batch assembly."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: List[str] = []
        self.use_vars = []
        self.pipe_command = None
        self.seed = 0
        self._feed: Optional[MultiSlotDataFeed] = None

    # -- reference setters ---------------------------------------------------
    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        # reference: N device workers; here: prefetch producer count
        self.thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist: List[str]):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)
        self._feed = MultiSlotDataFeed(
            [v.name for v in self.use_vars],
            [v.dtype or "float32" for v in self.use_vars])

    def set_pipe_command(self, pipe_command: str):
        # reference pipes each file through a shell command (data_feed
        # pipe reader); zero-egress images rarely allow this — store it and
        # refuse at load time so misuse is loud, not silent
        self.pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):
        raise NotImplementedError(
            "HDFS-backed filelists are not supported; stage files on "
            "local disk (fleet.utils.fs LocalFS)")

    # -- record iteration ----------------------------------------------------
    def _iter_file(self, path: str) -> Iterable[List[np.ndarray]]:
        if self.pipe_command:
            raise NotImplementedError(
                "set_pipe_command preprocessing is not supported on this "
                "runtime; preprocess files ahead of time")
        assert self._feed is not None, "call set_use_var first"
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield self._feed.parse_line(line)

    def _records_to_batch(self, records: List[List[np.ndarray]]):
        """Pad/stack one batch into a feed dict (LoD -> pad + lengths)."""
        feed: Dict[str, np.ndarray] = {}
        for j, v in enumerate(self.use_vars):
            cols = [r[j] for r in records]
            dt = v.dtype or "float32"
            if "int" in dt:
                ls = [c.shape[0] for c in cols]
                if min(ls) == max(ls):
                    padded, lens = _pad_sequences(cols)
                else:
                    # ragged slot: pad to a multiple of 8 (a handful of
                    # batch shapes an epoch, as in the JAX package);
                    # consumers mask padding (id 0) via <slot>.lod
                    padded, lens = _pad_sequences(cols, multiple_of=8)
                feed[v.name] = padded.astype(np.int64)
                feed[v.name + ".lod"] = lens
            else:
                feed[v.name] = np.stack(cols).astype(np.float32)
        return feed

    def _batches(self, records) -> Iterable[Dict[str, np.ndarray]]:
        buf = []
        for r in records:
            buf.append(r)
            if len(buf) == self.batch_size:
                yield self._records_to_batch(buf)
                buf = []
        if buf:
            yield self._records_to_batch(buf)


class InMemoryDataset(DatasetBase):
    """data_set.h:101 InMemoryDataset: load -> shuffle -> train."""

    def __init__(self):
        super().__init__()
        self._records: List[List[np.ndarray]] = []
        self._loaded = False
        self._preload_thread = None

    def load_into_memory(self):
        self._records = []
        for pat in self.filelist:
            for path in sorted(_glob.glob(pat)) or [pat]:
                self._records.extend(self._iter_file(path))
        self._loaded = True

    def preload_into_memory(self, thread_num=None):
        self._preload_thread = threading.Thread(target=self.load_into_memory,
                                                daemon=True)
        self._preload_thread.start()

    def wait_preload_done(self):
        if self._preload_thread is not None:
            self._preload_thread.join()
            self._preload_thread = None

    def local_shuffle(self):
        rng = np.random.RandomState(self.seed)
        rng.shuffle(self._records)
        self.seed += 1

    def global_shuffle(self, fleet=None, thread_num=None):
        """Hash-partition instances across trainers, then shuffle the own
        shard (GlobalShuffle: every instance lands on exactly one trainer).

        CONTRACT (documented divergence from the reference): every trainer
        must have loaded the SAME filelist — partitioning keeps the
        crc32%N==rank slice of the trainer's own memory and does not
        redistribute records between trainers the way the reference's
        PS-routed GlobalShuffle (data_set.h:109) does.  With disjoint
        per-trainer filelists this would silently drop (N-1)/N of the
        data; use local_shuffle() there instead."""
        rank, nranks = 0, 1
        if fleet is not None:
            try:
                rank = fleet.worker_index()
                nranks = fleet.worker_num()
            except Exception:
                pass
        if nranks > 1:
            keep = []
            for i, r in enumerate(self._records):
                key = zlib.crc32(b"|".join(x.tobytes() for x in r))
                if key % nranks == rank:
                    keep.append(r)
            self._records = keep
        self.local_shuffle()

    def release_memory(self):
        self._records = []
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        return len(self._records)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._records)


class QueueDataset(DatasetBase):
    """Streaming dataset: batches parsed lazily per epoch; no in-memory
    shuffle (reference QueueDataset.local_shuffle raises)."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams from files; use InMemoryDataset for "
            "local_shuffle (reference dataset.py QueueDataset)")

    def global_shuffle(self, fleet=None, thread_num=None):
        raise NotImplementedError(
            "QueueDataset does not support global_shuffle; use "
            "InMemoryDataset")

    def _stream_records(self):
        for pat in self.filelist:
            for path in sorted(_glob.glob(pat)) or [pat]:
                yield from self._iter_file(path)


class DatasetFactory:
    """fluid.DatasetFactory().create_dataset("InMemoryDataset")"""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


# ---------------------------------------------------------------------------
# prefetching trainer loop (MultiTrainer/DeviceWorker analog)
# ---------------------------------------------------------------------------
def _pad_sequences(seqs, multiple_of: int = 1):
    """1-D sequences padded with 0 into one [B, L] array, L the longest
    rounded up to `multiple_of`; returns (padded, int32 lengths)."""
    arrs = [np.asarray(s) for s in seqs]
    lens = np.asarray([a.shape[0] for a in arrs], np.int32)
    tgt = int(lens.max(initial=1))
    if multiple_of > 1:
        tgt = -(-tgt // multiple_of) * multiple_of
    out = np.zeros((len(arrs), tgt) + arrs[0].shape[1:], arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out, lens


def _batch_queue(batches: Iterable[Dict[str, np.ndarray]], capacity: int):
    """A producer thread filling a bounded standard-library queue with
    batches; returns (pop, join).  A producer exception is re-raised at
    the consumer, never a hang or a silently short epoch."""
    import queue as _q
    err: List[BaseException] = []
    q: "_q.Queue" = _q.Queue(maxsize=capacity)
    done = object()

    def produce():
        try:
            for b in batches:
                q.put(b)
        except BaseException as e:  # noqa: BLE001 - reraised in consumer
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=produce, daemon=True)
    t.start()

    def pop():
        item = q.get()
        if item is done:
            if err:
                raise RuntimeError(
                    "dataset producer thread failed") from err[0]
            return None
        return item

    return pop, t.join


def run_from_dataset(executor, program, dataset, scope=None,
                     fetch_list=None, fetch_info=None, print_period=100,
                     debug=False, chunk_steps=None):
    """One pass over the dataset, a step per batch: the
    train_from_dataset / infer_from_dataset loop (the reference's
    MultiTrainer RunFromDataset).

    chunk_steps > 1 (or FLAGS_dataset_chunk_steps) stacks consecutive
    same-shape batches into one Executor.run_steps call (one captured
    step replayed on the card); a batch of another shape (the last,
    partial one) flushes the chunk and runs on its own."""
    if isinstance(dataset, InMemoryDataset):
        if not dataset._loaded:
            raise RuntimeError(
                "InMemoryDataset: call load_into_memory() before "
                "train_from_dataset")
        records = dataset._records
    elif isinstance(dataset, QueueDataset):
        records = dataset._stream_records()
    else:
        raise TypeError(f"not a dataset: {dataset!r}")

    from ..core.flags import flag
    if chunk_steps is None:
        chunk_steps = int(flag("dataset_chunk_steps", 1))
    if flag("eager_run", False):
        # the debug mode wants the step run op by op, never captured
        chunk_steps = 1

    # drop feed names the program does not declare (.lod helpers); a
    # CompiledProgram exposes its (rewritten) Program's block, a pipeline
    # or parameter-server program its Program
    if hasattr(program, "_get_program"):
        block = program._get_program().global_block()
    else:
        block = getattr(program, "_program", program).global_block()
    pop, join = _batch_queue(dataset._batches(records),
                             capacity=max(2, 2 * dataset.thread_num))

    def _popped():
        while True:
            b = pop()
            if b is None:
                return
            yield {k: v for k, v in b.items() if block.has_var(k)}

    # second stage: the batch's placement on the executor's device on a
    # worker thread (reader/prefetcher.py), so batch N+1's copy overlaps
    # batch N's step.  The chunked (run_steps) path stacks batches on the
    # host before its one copy, so there the prefetcher only reads ahead
    prefetch_depth = int(flag("dataset_prefetch_depth", 2))
    if prefetch_depth > 0:
        from ..reader.prefetcher import Prefetcher
        place = chunk_steps <= 1 and not flag("eager_run", False)
        batch_iter = Prefetcher(_popped(), depth=prefetch_depth,
                                device=executor.device, place=place)
    else:
        batch_iter = _popped()

    fetch_list = fetch_list or []
    fetch_names = [f.name if hasattr(f, "name") else str(f)
                   for f in fetch_list]
    step = 0
    last = []

    def _report(vals):
        if debug or (fetch_names and step % print_period == 0):
            info = fetch_info or fetch_names
            msg = ", ".join(f"{n}={np.asarray(v).ravel()[:4]}"
                            for n, v in zip(info, vals))
            print(f"[dataset step {step}] {msg}")

    def _sig(feed):
        return tuple(sorted((k, np.shape(v)) for k, v in feed.items()))

    pending = []  # same-shape feeds awaiting one scanned dispatch

    def _flush():
        nonlocal step, last
        if not pending:
            return
        if len(pending) == 1:
            last = executor.run(program, feed=pending[0],
                                fetch_list=fetch_list, scope=scope)
            step += 1
            _report(last)
        else:
            stacked = {k: np.stack([np.asarray(f[k]) for f in pending])
                       for k in pending[0]}
            outs = executor.run_steps(program, feed=stacked,
                                      fetch_list=fetch_list, scope=scope)
            # per-step reporting parity with the unchunked path: the
            # scan returns every step's fetches, not just the last
            for i in range(len(pending)):
                step += 1
                _report([o[i] for o in outs])
            last = [o[-1] for o in outs]
        pending.clear()

    try:
        for feed in batch_iter:
            if chunk_steps <= 1 or not feed:
                # feed-less programs (no declared dataset slots) cannot be
                # stacked — run them per step like the unchunked path
                _flush()
                last = executor.run(program, feed=feed,
                                    fetch_list=fetch_list, scope=scope)
                step += 1
                _report(last)
                continue
            if pending and _sig(feed) != _sig(pending[0]):
                _flush()
            pending.append(feed)
            if len(pending) >= chunk_steps:
                _flush()
        _flush()
    finally:
        close = getattr(batch_iter, "close", None)
        if close is not None:
            close()
    join()
    return last
