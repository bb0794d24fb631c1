"""Device feeds (counterpart of ``poem_v2_tpu/training/prefetch.py``).

:func:`prefetch_to_device` keeps ``size`` batches in flight ahead of the
consumer: each host batch is copied into pinned buffers and then to the card
on a side stream, so batch n + 1 crosses PCIe while the step of batch n runs;
the consumer's stream waits on that copy's event before it reads the tensors.
:func:`cache_on_device` holds a fixed set of batches on the card once, for
protocols that replay the same batches every epoch.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .trainer import BATCH_KEYS

# fixed-set feeds larger than this stay on the streaming prefetch path
FIXED_FEED_CACHE_CAP_BYTES = 4e9


def _host_tensors(batch: Dict[str, Any], keys: Sequence[str], pin: bool):
    out = {}
    for k in keys:
        if k in batch:
            t = torch.as_tensor(np.ascontiguousarray(batch[k]))
            out[k] = t.pin_memory() if pin else t
    return out


def _on_device(batch: Dict[str, Any], keys: Sequence[str], device: torch.device):
    """The batch's ``keys`` if all are tensors on ``device`` already, else None."""
    sel = {k: batch[k] for k in keys if k in batch}
    if all(isinstance(v, torch.Tensor) and v.device == device for v in sel.values()):
        return sel
    return None


def prefetch_to_device(batches: Iterable[Dict[str, Any]], device, size: int = 2,
                       keys: Optional[Sequence[str]] = BATCH_KEYS
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches' ``keys`` (all keys if None) as tensors on ``device``,
    ``size`` batches ahead; on the CPU it only converts. Batches already on
    ``device`` (a cached fixed set) pass through."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    it = iter(batches)
    if device.type != "cuda":
        for batch in it:
            ks = keys or list(batch)
            yield _on_device(batch, ks, device) or _host_tensors(batch, ks, pin=False)
        return
    stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def enqueue() -> None:
        batch = next(it, None)
        if batch is None:
            return
        ready = _on_device(batch, keys or list(batch), device)
        if ready is not None:
            queue.append((ready, None))
            return
        host = _host_tensors(batch, keys or list(batch), pin=True)
        with torch.cuda.stream(stream):
            dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        queue.append((dev, done))

    for _ in range(size):
        enqueue()
    while queue:
        dev, done = queue.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in dev.values():
                t.record_stream(consumer)  # allocated on the side stream, used on this one
        yield dev
        enqueue()


def batch_nbytes(batch: Dict[str, Any]) -> int:
    return sum(np.asarray(v).nbytes for v in batch.values())


def cache_on_device(batches: Iterable[Dict[str, Any]], device,
                    keys: Optional[Sequence[str]] = BATCH_KEYS) -> List[Dict[str, torch.Tensor]]:
    """Every batch of a fixed set on ``device``, once (the train CLI checks the
    set's size against ``FIXED_FEED_CACHE_CAP_BYTES`` first)."""
    cached = list(prefetch_to_device(batches, device, size=2, keys=keys))
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return cached
