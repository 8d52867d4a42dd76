"""Host→device double-buffered prefetch, the counterpart of
``bbbp_tpu/parallel/prefetch.py``.

The reference's DataLoader moves each batch host→GPU synchronously inside the
step loop (reference: ...regression_opt_transformer_cnn_20250113.py:184-186).
Here a producer thread builds the next items (e.g. featurization) and copies
them to the card while the caller computes on the previous one: each tensor
is pinned and copied with ``non_blocking=True`` on a side stream, and an
event records the copy. The consumer's stream waits for that event before
it hands the item out, and every tensor is ``record_stream``-ed on the
consumer's stream, so the caching allocator does not reuse its memory while
the consumer's work is queued. Items keep their order.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

_END = object()


def _map(fn, item):
    """``fn`` over the tensors and numpy arrays of a nested tuple / list /
    dict; other leaves unchanged."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map(fn, v) for v in item)
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(item))
    return item


def prefetch_to_device(iterator: Iterable, depth: int = 2,
                       device: Union[str, torch.device] = "cuda",
                       sharding=None) -> Iterator:
    """Yield the items of ``iterator`` with their tensors and arrays on
    ``device``, keeping up to ``depth`` items in flight. ``sharding``
    (``parallel/mesh.py::batch_sharding`` or ``replicated``) distributes
    each tensor as a DTensor on the consumer's side: a collective, so every
    rank of the mesh feeds the same items, as to ``shard_batch``, and each
    keeps its part. An exception in the producer is raised in the
    consumer."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prefetch_to_device(device='cuda') needs a CUDA device")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    side = torch.cuda.Stream(dev)
                    for item in iterator:
                        with torch.cuda.stream(side):
                            item = _map(lambda t: t.pin_memory().to(
                                dev, non_blocking=True), item)
                            event = torch.cuda.Event()
                            event.record(side)
                        if not put((item, event, None)):
                            return
            else:
                for item in iterator:
                    if not put((_map(lambda t: t.to(dev), item), None, None)):
                        return
            put((_END, None, None))
        except BaseException as e:      # handed to the consumer, which raises
            put((_END, None, e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item, event, error = q.get()
            if error is not None:
                raise error
            if item is _END:
                break
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                _map(lambda t: t.record_stream(stream), item)
            if sharding is not None:
                from torch.distributed.tensor import distribute_tensor

                item = _map(lambda t: distribute_tensor(t, sharding.mesh,
                                                        sharding.placements), item)
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)
