"""Host-side batch prefetching and the copy onto the card (the port's
counterpart of videoglamm_tpu/data/prefetch.py).

A worker thread builds the upcoming batches (decode, preprocess, collate)
while the card steps, and stages them on the device ahead of the consumer.
An exception raised in the worker surfaces on the consumer's side.

`to_device` is the copy in PyTorch's idiom: every tensor is pinned and
copied with `non_blocking=True`, the pixel streams are cast to the compute
dtype on the card, and all of it is queued on the consumer's stream, so
the copy and the steps that read it keep their order on one stream (the
caching allocators keep the pinned source and the device tensors alive
until the stream has passed them).
"""
from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import torch

from .collate import PIXEL_KEYS


class PrefetchIterator:
    """Wrap a batch iterator with N background-prefetched slots. `close`
    stops the worker (the wrapped iterator may be endless)."""

    def __init__(self, it: Iterator, prefetch: int = 2,
                 to_device: Optional[Callable] = None):
        self._it = it
        self._to_device = to_device
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for item in self._it:
                if self._to_device is not None:
                    item = self._to_device(item)
                if not self._put(item):
                    return
        except BaseException as e:   # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()


def prefetch_to_device(batches: Iterator, to_device: Callable,
                       prefetch: int = 2) -> PrefetchIterator:
    """Build and device-stage `prefetch` batches ahead of the consumer."""
    return PrefetchIterator(batches, prefetch=prefetch, to_device=to_device)


def to_device(batch: Dict[str, torch.Tensor], device, dtype=None,
              stream=None) -> Dict[str, torch.Tensor]:
    """A collated host batch -> the same batch on `device`, the pixel
    streams (`PIXEL_KEYS`) in `dtype` when given. On a CUDA device each
    tensor is pinned and copied with non_blocking=True on `stream` (the
    calling thread's current stream when None); on the CPU the tensors are
    the batch's own."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: (v.to(dtype) if dtype is not None and k in PIXEL_KEYS
                    else v) for k, v in batch.items()}
    out = {}
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        for k, v in batch.items():
            x = v.pin_memory().to(device, non_blocking=True)
            out[k] = x.to(dtype) if dtype is not None and k in PIXEL_KEYS else x
    return out


def device_copier(device, dtype=None) -> Callable:
    """`to_device` bound to `device`, `dtype` and the calling thread's
    current stream: build it on the consumer's thread and hand it to the
    worker, whose copies then queue on the consumer's stream."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    return functools.partial(to_device, device=device, dtype=dtype,
                             stream=stream)
