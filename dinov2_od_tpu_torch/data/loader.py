"""Threaded, prefetching batch loader (counterpart of
dinov2_od_tpu/data/loader.py).

- Worker threads decode and resize images in parallel (Pillow releases
  the GIL); a packed dataset (data/packed.py) gives a whole batch with one
  gather per field instead.
- Batches are contiguous numpy arrays of static shapes (the padding
  happened per example).
- A bounded queue keeps the next batches ready while the card computes.
- Seeded, epoch-aware shuffling (`set_epoch`, DistributedSampler's
  semantics), with the JAX package's generator calls: one seed gives the
  same order in both packages.

`device_prefetch` moves the batches to the card ahead of the step: pinned
host buffers, copied with `non_blocking=True` on a side stream; the
consumer's stream waits on the copy's event before it reads the batch.

The loader runs in one process; the JAX loader's per-host slices of a
multi-host run are not ported (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def shuffled_order(n: int, seed: int, epoch: int,
                   shuffle: bool = True) -> np.ndarray:
    """The epoch's example order: seeded and epoch-aware."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    return order


def _drain(q: "queue.Queue", thread: threading.Thread) -> None:
    """Empty `q` until `thread`, its producer, has exited."""
    while thread.is_alive():
        try:
            q.get_nowait()
        except queue.Empty:
            thread.join(timeout=0.1)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = shuffled_order(len(self.dataset), self.seed, self.epoch,
                               self.shuffle)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        fast_batch = getattr(self.dataset, "get_batch", None)

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            break
                        if fast_batch is not None:
                            batch = fast_batch(idxs)
                        else:
                            examples = list(
                                pool.map(self.dataset.get_example, idxs))
                            batch = {k: np.stack([e[k] for e in examples])
                                     for k in examples[0]}
                        q.put(("batch", batch))
            except Exception as e:  # surfaced in the consumer
                q.put(("error", e))
                return
            q.put(("end", None))

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "end":
                    break
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()
            _drain(q, producer)


def device_prefetch(iterator, device, size: int = 2, device_keys=None,
                    transform=None):
    """Overlap the host-to-device copy with the card's compute.

    A thread pulls batches from `iterator`, applies `transform` (e.g.
    `pad_batch`) and puts `device_keys` (every key when None) on `device`,
    up to `size` batches ahead; the other keys stay numpy. On a CUDA
    device each array is staged in pinned memory and copied with
    `non_blocking=True` on a side stream; the copy records an event, and
    the consumer's current stream waits on it before the batch is handed
    out (`record_stream` then keeps the allocator from reusing the
    tensors' memory while that stream may still read them). The pinned
    buffer stays referenced until the wait is enqueued.

    Yields dicts of tensors (device_keys) and numpy arrays (the rest).
    """
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def put_on_device(batch):
        out, pinned = {}, []
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            for k, v in batch.items():
                if device_keys is not None and k not in device_keys:
                    out[k] = v
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    t = t.pin_memory()
                    pinned.append(t)
                out[k] = t.to(device, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(side)
        return out, event, pinned

    def produce():
        try:
            for batch in iterator:
                if stop.is_set():
                    break
                if transform is not None:
                    batch = transform(batch)
                q.put(("batch", put_on_device(batch)))
        except Exception as e:  # surfaced in the consumer
            q.put(("error", e))
            return
        q.put(("end", None))

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                break
            if kind == "error":
                raise payload
            out, event, pinned = payload
            if cuda:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for k, v in out.items():
                    if torch.is_tensor(v):
                        v.record_stream(stream)
            del pinned
            yield out
    finally:
        stop.set()
        _drain(q, producer)


def pad_batch(batch: Dict[str, np.ndarray],
              batch_size: int) -> Dict[str, np.ndarray]:
    """Pad a trailing partial batch to the full static batch size with
    zeros (valid=False everywhere, so padded examples add nothing to a
    loss; eval callers slice by the original count)."""
    n = len(next(iter(batch.values())))
    if n == batch_size:
        return batch
    out = {}
    for k, v in batch.items():
        pad_shape = (batch_size - n,) + v.shape[1:]
        out[k] = np.concatenate([v, np.zeros(pad_shape, v.dtype)])
    return out
