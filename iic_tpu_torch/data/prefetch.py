"""Background-thread host prefetch and the host-to-device upload
(``iic_tpu/data/prefetch.py``: ``ThreadedPrefetch``, ``prefetch_epochs``;
``iic_tpu/train/cluster_trainer.py``: ``host_prefetch_iter``).

The train pipelines' ``epoch()`` generators do their host work (crops,
slices) and the upload inside ``next()``. ``ThreadedPrefetch`` runs the
whole generator on a daemon thread with a bounded queue, so the host
work and uploads of the next batches overlap the consumer's steps.

On a CUDA device ``DeviceUpload`` copies each batch from pinned host
memory, ``non_blocking``, on a copy stream of its own, so the copy does
not queue behind the step on the consumer's stream. The consumer's stream
waits on an event recorded after the copy, and each tensor is
``record_stream``-ed to it, so that the caching allocator does not hand
its memory out again before the consumer's work on it is done. The
consumer's stream is the current stream of the thread that iterates the
generator; a ``ThreadedPrefetch`` worker takes the current stream of the
thread that made it.
"""

import queue
import threading

import torch


class DeviceUpload:
    """``upload(*arrays)`` -> a list of tensors on ``device``, one for each
    numpy array. Off CUDA: ``torch.from_numpy(a).to(device)``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, *arrays):
        tensors = [torch.from_numpy(a) for a in arrays]
        if self._stream is None:
            return [t.to(self.device) for t in tensors]
        consumer = torch.cuda.current_stream(self.device)
        pinned = [t.pin_memory() for t in tensors]
        with torch.cuda.stream(self._stream):
            out = [p.to(self.device, non_blocking=True) for p in pinned]
            copied = torch.cuda.Event()
            copied.record(self._stream)
        consumer.wait_event(copied)
        for t in out:
            t.record_stream(consumer)
        return out


class _Done:
    pass


_DONE = _Done()


class ThreadedPrefetch:
    """Iterate ``gen`` on a background thread, keeping up to ``depth``
    items ready. An exception in the generator re-raises in the consumer.

    Use as an iterator; call ``close()`` (or exhaust it) to join the
    thread. ``close()`` stops the worker, drops the queued items and
    closes ``gen``, which runs its ``finally`` blocks; loops that break
    early (the trainers' --test_code) call it."""

    def __init__(self, gen, depth=2):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        # the worker's uploads wait on the stream of the thread that made
        # the prefetch, the thread that consumes it
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_available() and torch.cuda.is_initialized()
                  else None)
        self._thread = threading.Thread(
            target=self._run, args=(gen, stream), daemon=True)
        self._thread.start()

    def _put(self, item):
        """Queue ``item`` unless stopped first; False when stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen, stream):
        try:
            if stream is not None:
                torch.cuda.set_stream(stream)
            for item in gen:
                if not self._put(item):
                    return
            self._put(_DONE)
        except BaseException as e:  # re-raised by the consumer
            self._put(e)
        finally:
            if hasattr(gen, "close"):
                gen.close()  # its finally blocks run now, on close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._done = True
            self._thread.join()
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            self._thread.join()
            raise item
        return item

    def close(self):
        """Stop the worker and drop queued items (early-exit consumers)."""
        self._stop.set()
        self._done = True
        self._drain()  # unblocks a worker waiting on a full queue
        self._thread.join(timeout=5.0)
        self._drain()  # what it queued before it saw the stop

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def prefetch_epochs(pipe, epoch_indices, depth=2, **epoch_kw):
    """Chain several ``pipe.epoch(e_i)`` generators through ONE prefetch
    thread so the boundary between epochs is overlapped too. Yields
    (epoch_idx, batch...) tuples."""

    def chained():
        for e_i in epoch_indices:
            gen = pipe.epoch(e_i, **epoch_kw)
            try:
                for item in gen:
                    yield (e_i,) + tuple(item)
            finally:
                gen.close()

    return ThreadedPrefetch(chained(), depth=depth)


def host_prefetch_iter(gen, config):
    """An epoch generator behind the prefetch thread at
    ``config.prefetch_depth`` (8 by default: a deeper queue rides out the
    spikes of host preparation, for one batch of host memory each), or
    ``gen`` itself under ``--no_host_prefetch`` (a flag the semisup config
    does not have: it always prefetches)."""
    if getattr(config, "no_host_prefetch", False):
        return gen
    return ThreadedPrefetch(gen, depth=config.prefetch_depth)
