"""Host input pipeline (counterpart of segtpu/data/pipeline.py): a thread
pool assembles batches, and :func:`prefetch_to_device` stages them on the
device ahead of the step that uses them.

The reference hides its CPU augmentation cost in DataLoader worker processes
(reference torch_train.py:384-385). Here, as in segtpu, the per-sample work
is NumPy in threads. Under data parallelism each process builds only its
slice of every global batch (``process_index`` / ``process_count``, as
segtpu/data/pipeline.py:45-71,107 does).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
from typing import Iterator, Tuple

import numpy as np
import torch

from segtpu_torch.augment.host import bind_sample_rng
from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.parallel import process_slot


class DataLoader:
    """Map-style dataset -> iterator of stacked numpy ``(x, y)`` NHWC batches.

    The reference loader's semantics: ``shuffle`` for training, ordered for
    validation, ``drop_last`` (torch_train.py:384-385). ``workers`` threads
    make samples up to ``prefetch_batches`` batches ahead of the consumer.
    The shuffled order of epoch ``e`` is
    ``np.random.RandomState(seed + e).permutation(n)``.

    ``sample_seed`` (seeded training) binds the per-sample stream
    ``Random(h(sample_seed, epoch, index))`` around each ``__getitem__``
    (:class:`~segtpu_torch.augment.host.bind_sample_rng`), so host
    augmentation draws do not depend on thread timing or the worker count.
    Index order and arrays are those of segtpu's loader for the same
    arguments.

    Multi-process: every process walks the same seeded global order and
    builds only its contiguous slice of each global batch of
    ``batch_size``: the ``batch_size // process_count`` samples from offset
    ``process_index * batch_size // process_count``. The default is the
    default process group's rank and size, or 0 and 1 without one; a data
    parallel run with a model axis passes its data rank and data size."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                 workers: int = 4, seed: int = 0, prefetch_batches: int = 4,
                 sample_seed: int = None, process_index: int = None,
                 process_count: int = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(1, workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.sample_seed = sample_seed
        self.epoch = 0
        self.process_index, self.process_count, self.local_batch_size = process_slot(
            batch_size, process_index, process_count)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _fetch(self, epoch: int, i: int):
        if self.sample_seed is None:
            return self.dataset[i]
        with bind_sample_rng(self.sample_seed, epoch, i):
            return self.dataset[i]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._index_order()
        epoch = self.epoch
        n_batches = len(self)
        ex = cf.ThreadPoolExecutor(max_workers=self.workers)
        try:
            pending: collections.deque = collections.deque()

            def submit(b):
                start = b * self.batch_size + self.process_index * self.local_batch_size
                idxs = order[start:start + self.local_batch_size]
                pending.append([ex.submit(self._fetch, epoch, int(i)) for i in idxs])

            warm = min(self.prefetch_batches, n_batches)
            for b in range(warm):
                submit(b)
            for b in range(n_batches):
                futs = pending.popleft()
                if b + warm < n_batches:
                    submit(b + warm)
                samples = [f.result() for f in futs]
                yield np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])
        finally:
            ex.shutdown(wait=False, cancel_futures=True)


class Subset:
    """First-``n`` view of a map-style dataset (the harness's ``-s`` cap)."""

    def __init__(self, dataset, n: int):
        self.dataset = dataset
        self.n = min(n, len(dataset))

    def __len__(self):
        return self.n

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __getitem__(self, i):
        return self.dataset[i]


def prefetch_to_device(iterator, device: DeviceLike = None, size: int = 2):
    """Stage ``size`` batches of ``iterator`` ahead on ``device``, as NCHW
    float32 tensors.

    A numpy NHWC batch is copied as it is and viewed as NCHW: on CUDA that
    view is the ``channels_last`` layout the model runs in; on the CPU it is
    made contiguous. On CUDA the copy goes from pinned host memory, without
    blocking, on a side stream, so the copy of batch N+1 overlaps the step of
    batch N; the consumer's stream waits on the copy's event before it uses
    the batch, and ``record_stream`` keeps the tensor's memory from being
    reused until the work queued on that stream has run. Batches that are
    already tensors on ``device`` (``shapes-device``) pass through."""
    dev = resolve_device(device)
    copy_stream = None
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        copy_stream = torch.cuda.Stream(dev)

    def put(batch):
        if all(isinstance(a, torch.Tensor) and a.device == dev for a in batch):
            return tuple(batch), None
        hosts = [torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in batch]
        if copy_stream is None:
            return tuple(h.permute(0, 3, 1, 2).contiguous() for h in hosts), None
        with torch.cuda.stream(copy_stream):
            out = tuple(h.pin_memory().to(dev, non_blocking=True).permute(0, 3, 1, 2)
                        for h in hosts)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def take(staged):
        out, ready = staged
        if ready is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            for t in out:
                t.record_stream(stream)
        return out

    it = iter(iterator)
    queue = collections.deque(put(batch) for batch in itertools.islice(it, size))
    while queue:
        staged = queue.popleft()
        batch = next(it, None)
        if batch is not None:
            queue.append(put(batch))
        yield take(staged)
