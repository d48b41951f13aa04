"""Multi-chip scale-out: device meshes, sharded channelizer, halo exchange.

The reference is a single-host threaded program; its only parallelism is a
per-channel thread fan-out over one shared buffer (``multifm/receiver.c:78-98``).
Here the same signal chain scales over a device mesh via a 2-D
``jax.sharding.Mesh``:

* ``channels`` axis — embarrassingly parallel: each shard owns a slice of the
  channel bank's taps/oscillators; the wideband input is replicated within
  the axis.
* ``time`` axis — the IQ stream splits into contiguous segments; the FIR's
  overlap-save tail and the FM discriminator's one-sample history cross
  segment boundaries via a single ``jax.lax.ppermute`` of input tails between
  neighbors (the "halo exchange").
"""

from tsl_sdr_tpu.parallel.mesh import make_mesh  # noqa: F401
