"""Batch placement and host prefetch (counterpart of
gennerf_tpu/parallel/mesh.py).

The JAX package shards a batch's axis 0 over a device mesh and runs one
global program. Here each rank holds its rows of the global batch and the
step's reductions make it global (parallel/distributed.py):
- `shard_batch(batch)`: this rank's rows [r*k, (r+1)*k) of every array
  (and tensor) of a global batch, with `sharded` True (in a joined group
  of one rank too: the whole batch); a batch whose axis
  0 the ranks do not divide (a final partial batch) stays whole on every
  rank with `sharded` False (the JAX replicated placement: every rank runs
  it with no reduction), and the first such batch warns;
- `prefetch_shard(loader, device, size)`: a background thread takes the
  next `size` batches from the loader and copies them to the device
  (pinned memory, non_blocking) while the step runs; it yields (raw
  batch, device batch). size 0 is the synchronous path. A loader error is
  raised on the consumer's side; an abandoned generator (an early break)
  releases the thread and drops what it staged, having taken at most
  consumed + size + 1 batches from the loader.

`num_slices` has no mesh here: parallel/platform.py maps it onto nodes.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import distributed

_REPLICATE_WARNED = [False]


def _rows(x) -> Optional[int]:
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
        return int(x.shape[0])
    if isinstance(x, list):
        return len(x)
    return None


def shard_batch(batch: Dict, world: Optional[int] = None,
                rank: Optional[int] = None) -> Tuple[Dict, bool]:
    """(this rank's rows of `batch`, whether it was split); lists (scene
    names) split alike. `world`/`rank` default to the process group's (no
    group: the batch, not split)."""
    if world is None and not torch.distributed.is_initialized():
        return batch, False
    world = distributed.process_count() if world is None else world
    rank = distributed.process_index() if rank is None else rank
    if world == 1:
        return batch, torch.distributed.is_initialized()
    sizes = {n for n in map(_rows, batch.values()) if n is not None}
    if len(sizes) != 1:
        raise ValueError(f"batch arrays disagree on axis 0: {sorted(sizes)}")
    n = sizes.pop()
    if n % world or n == 0:
        if not _REPLICATE_WARNED[0]:
            _REPLICATE_WARNED[0] = True
            warnings.warn(f"batch axis 0 of size {n} is not divisible by the {world} ranks; "
                          "every rank runs it whole (correct but not data-parallel). Expected "
                          "for a final partial batch; if it happens every step, fix "
                          "data.batch_size.", stacklevel=2)
        return batch, False
    rows = distributed.local_batch_slice(n, world, rank)
    return {key: (v[rows] if _rows(v) is not None else v) for key, v in batch.items()}, True


def prefetch_shard(loader, device, size: int = 2,
                   upload: Optional[Callable] = None):
    """Yield (raw batch, device batch) for every batch of `loader`, the
    next `size` batches uploaded on a background thread (module
    docstring). `upload(batch, device)` makes the device batch (default:
    train.step.batch_to_device). Closed after yielding c batches, the
    generator has taken at most c + size + 1 batches from `loader` (at
    most `size` queued and one in hand), and takes none after."""
    if upload is None:
        from ..train.step import batch_to_device as upload
    device = torch.device(device)
    if size <= 0:
        for batch in loader:
            yield batch, upload(batch, device)
        return

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err = []
    stop = threading.Event()  # the consumer abandoned the generator
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so an
        # abandoned generator cannot leave the thread blocked
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        # `stop` is checked before every pull, which is after every put: a
        # put may still land once the consumer has drained the queue, and
        # the check keeps the loop from pulling again, so an abandoned pass
        # takes at most consumed + size + 1 batches (the queue full and one
        # in hand), whatever the threads' timing
        try:
            it = iter(loader)
            while not stop.is_set():
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if stream is None:
                    item = (batch, upload(batch, device), None)
                else:
                    with torch.cuda.stream(stream):
                        staged = upload(batch, device)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    item = (batch, staged, ready)
                if not put(item):
                    return
        except BaseException as e:  # raised again on the consumer's side
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="prefetch_shard")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                t.join()
                if err:
                    raise err[0]
                return
            batch, staged, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for v in staged.values():
                    v.record_stream(current)
            yield batch, staged
    finally:
        # on GeneratorExit too: release the thread (it may be mid-put) and
        # drop what it staged
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)
