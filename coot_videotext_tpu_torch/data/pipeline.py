"""
Host -> device prefetch pipeline.

Port of coot_videotext_tpu/data/pipeline.py (`split_batch` :24,
`PrefetchIterator` :40, `prefetch_to_device` :84): a background thread
iterates the loader (collation, host frame sampling and noise, all in that
one thread and in the loader's order), and on a CUDA device pins each
batch and copies it non_blocking on a side stream, recording an event.
The consumer's stream waits on that event before the batch is used, and
each tensor is recorded on the consumer's stream so its memory is not
reused while the step still reads it. DEPTH batches wait in the queue
(JAX's default). On the CPU the tensors are the collated arrays
themselves.

The producer stops when the consumer closes the generator (a `break`, or
the generator collected): it puts with a timeout and checks a stop event,
so it never stays blocked on a full queue holding pinned batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.data.retrieval_dataset import HOST_KEYS

THREAD_NAME = "coot-prefetch"
DEPTH = 2

Arrays = Dict[str, np.ndarray]
Host = Dict[str, Any]


def split_batch(batch: Dict[str, Any]) -> Tuple[Arrays, Host]:
    """(device arrays, host fields) of a collated retrieval batch (JAX
    :24)."""
    arrays = {k: v for k, v in batch.items() if k not in HOST_KEYS}
    host = {k: v for k, v in batch.items() if k in HOST_KEYS}
    return arrays, host


def prefetch(loader: Iterable, device: torch.device, *,
             split: Callable[[Any], Tuple[Arrays, Host]] = split_batch
             ) -> Iterator[Tuple[Dict[str, torch.Tensor], Host]]:
    """(tensors on `device`, host part) of each item of `loader`, DEPTH
    items ahead (JAX `PrefetchIterator`). `split` turns a loader item into
    (numpy arrays to ship, host-only part). An exception of the loader is
    raised in the consumer."""
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            if cuda:
                torch.cuda.set_device(device)
            for item in loader:
                if stop.is_set():
                    return
                arrays, host = split(item)
                tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in arrays.items()}
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        tensors = {k: t.pin_memory().to(device,
                                                        non_blocking=True)
                                   for k, t in tensors.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                if not put((tensors, host, event)):
                    return
        except BaseException as e:  # re-raised in the consumer
            put(e)
            return
        put(done)

    thread = threading.Thread(target=producer, name=THREAD_NAME,
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, host, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in tensors.values():
                    t.record_stream(current)
            yield tensors, host
    finally:
        stop.set()
        thread.join()
