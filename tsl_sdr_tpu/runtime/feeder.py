"""Async host->device feeding: overlap IQ upload with device compute.

SURVEY hard-part #4: sustaining hundreds of Msamples/s into the chip means
the host must stage block k+1 while the device crunches block k. JAX
dispatch is already asynchronous, but a naive loop serializes
``device_put`` (host-side copy + transfer) with the host-side work of
producing the next block (file/FIFO reads, widening). This feeder runs the
producer + ``device_put`` in a background thread with a small bounded queue
— the compute loop only ever blocks when the device is genuinely starved.

Usage::

    feeder = AsyncFeeder(block_iter, depth=3)     # any iterator of np arrays
    for dev_block in feeder:                      # device arrays, in order
        state, out = step(state, dev_block)

The queue depth bounds host memory (depth * block bytes) and provides the
reference's bounded-queue backpressure semantics (multifm/demod.c:297's
128-deep work queue): the producer thread stalls when the device falls
behind, rather than buffering without limit.
"""

from __future__ import annotations

import queue
import threading

import jax

_SENTINEL = object()


class AsyncFeeder:
    """Iterate device-resident blocks, staged ahead by a producer thread."""

    def __init__(self, block_iterator, depth: int = 3, device=None,
                 device_put: bool = True):
        """``device_put=False`` stages plain numpy blocks (still overlapping
        the producer's host-side work with compute) — for consumers whose
        step runs host-side stages first (e.g. the packed exact tier's
        native rotator), where an eager upload would only force a bulk
        device->host fetch right back."""
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = device or jax.devices()[0]
        self._err = None

        def run():
            try:
                for blk in block_iterator:
                    if device_put:
                        blk = jax.device_put(blk, self._device)
                    self._q.put(blk)
            except Exception as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        # drain so the producer thread can exit
        while True:
            try:
                if self._q.get_nowait() is _SENTINEL:
                    break
            except queue.Empty:
                break
        self._thread.join(timeout=5)
