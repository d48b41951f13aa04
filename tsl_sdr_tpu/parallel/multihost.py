"""Multi-host deployment helpers: fast links within a host, the network between.

The reference is a single-host program (SURVEY §2.2); scale-out here is a
new design obligation. The recipe:

* each host calls :func:`init` (jax.distributed) so every process sees the
  global device set;
* :func:`make_global_mesh` lays the (time, channels) axes out so the
  CHANNEL axis stays *within* each host — the channel bank needs no
  inter-shard traffic at all, and the time axis's two small halo
  ``ppermute``s (window spill + FM look-back, see
  :mod:`tsl_sdr_tpu.parallel.channelizer`) ride the host's device links
  (NVLink on a GPU host); only time-shard boundaries that cross hosts touch
  the inter-host network (DCN below), and those
  move ``(cr_rows + 1) * ROW`` int16 values per block — a few KB;
* each host feeds its own time-contiguous IQ span via
  ``jax.make_array_from_process_local_data``.

EXECUTED on a single box by launching real OS processes over the CPU
backend (gloo collectives): :func:`run_multiprocess_selftest` for the
sharded channelizer, ``_mh_pipeline_worker`` (via :func:`launch_workers`)
for the full fused receive pipeline — see ``tests/test_multihost.py``.
The per-process sharded kernels are additionally exercised on a virtual
8-device mesh (tests/test_parallel.py) and via
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tsl_sdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS


def init(coordinator_address: str | None = None, num_processes: int | None = None,
         process_id: int | None = None):
    """Initialize jax.distributed (no-op when already initialized or
    single-process).

    Must run before any JAX computation touches a backend — so the
    already-initialized check reads the distributed client state directly
    instead of calling ``jax.process_count()`` (which would itself
    initialize the backend and make ``jax.distributed.initialize`` fail).
    On the CPU platform cross-process collectives need an explicit
    implementation; gloo ships in jaxlib and is selected here.
    """
    if coordinator_address is None:
        return  # single host
    from jax._src import distributed as _distributed

    if getattr(_distributed.global_state, "client", None) is not None:
        return  # already initialized
    import os

    if selects_cpu(os.environ.get("JAX_PLATFORMS", ""),
                   jax.config.jax_platforms):
        # CPU cross-process collectives need an explicit implementation
        # (gloo ships in jaxlib)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def selects_cpu(env_platforms: str, config_platforms) -> bool:
    """True when JAX will run on the CPU: the platform list comes from the
    ``JAX_PLATFORMS`` environment variable or from
    ``jax.config.update('jax_platforms', ...)``. With neither set JAX picks
    the accelerator, so nothing here assumes the CPU."""
    plat = (env_platforms or str(config_platforms or "")).lower()
    return plat.startswith("cpu")


def layout_devices(devs, n_local: int, channels_per_host: int):
    """Pure device-layout math behind :func:`make_global_mesh`.

    ``devs``: all devices in jax's global (process-major) order. Returns a
    [time, channels] array where every channel row lives on one host (no
    DCN inside the channel bank) and the time axis walks hosts in process
    order, so each host's IQ span is contiguous in stream time.
    """
    devs = np.asarray(devs, dtype=object)
    if n_local % channels_per_host:
        raise ValueError(
            f"{n_local} local devices not divisible by {channels_per_host}"
        )
    if devs.size % n_local:
        raise ValueError(
            f"{devs.size} devices not divisible by {n_local} per host"
        )
    time_per_host = n_local // channels_per_host
    n_proc = devs.size // n_local
    return devs.reshape(n_proc * time_per_host, channels_per_host)


def make_global_mesh(channels_per_host: int = 1) -> Mesh:
    """(time, channels) mesh over ALL processes' devices.

    Channel shards are constrained to a single host (no DCN inside the
    channel bank); the time axis spans hosts in process order so each
    host's IQ span is contiguous in stream time.
    """
    dev_array = layout_devices(
        jax.devices(), jax.local_device_count(), channels_per_host
    )
    return Mesh(dev_array, (TIME_AXIS, CHANNEL_AXIS))


def distribute_iq(mesh: Mesh, local_vals: np.ndarray):
    """Assemble the global time-sharded IQ array from per-host spans.

    ``local_vals``: this host's contiguous span of flat interleaved int16
    values (hosts in process order = stream order).
    """
    sharding = NamedSharding(mesh, P(TIME_AXIS))
    return jax.make_array_from_process_local_data(sharding, local_vals)


def dcn_halo_bytes(plan, n_processes: int, channels_per_host: int = 1) -> int:
    """Bytes per block that cross the host (DCN) boundary in the sharded
    channelizer's halo exchange.

    Each time-shard boundary moves one look-back row forward and
    ``cr_rows`` window-spill rows backward (see
    :func:`tsl_sdr_tpu.parallel.channelizer._local_packed_fm`); only the
    ``n_processes - 1`` boundaries between hosts ride DCN — the rest stay
    on the host's device links. The IQ rows are sharded over time only, so EVERY channel-mesh
    column runs its own time-axis ppermute across the boundary — the halo
    crosses DCN once per channel shard (XLA does not dedupe distinct
    ppermute pairs).
    """
    return ((n_processes - 1) * (plan.cr_rows + 1) * plan.row * 2
            * channels_per_host)


# ---------------------------------------------------------------------------
# Executed multi-process self-test (CPU backend, one box, real processes).
# Spawns N python processes that each jax.distributed.initialize, build the
# global mesh, feed their own IQ span and run the sharded channelizer; the
# caller then recomputes the same capture single-process and diffs.
# ---------------------------------------------------------------------------

_SELFTEST = dict(fs=64_000, decim=4, taps=17, rows_per_shard=64, seed=7)


def selftest_chain(nr_channels: int = 4):
    """Deterministic tiny flagship chain shared by the worker processes and
    the single-process expected computation."""
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    fs = _SELFTEST["fs"]
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[: _SELFTEST["taps"]]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=nr_channels)
    return MultifmChain(lpf, offsets, fs, _SELFTEST["decim"], exact=False)


def selftest_capture(plan, n_time_shards: int) -> np.ndarray:
    """The full deterministic capture as flat interleaved int16 values."""
    rows_total = _SELFTEST["rows_per_shard"] * n_time_shards
    rng = np.random.default_rng(_SELFTEST["seed"])
    return rng.integers(
        -8000, 8000, size=rows_total * plan.row, dtype=np.int64
    ).astype(np.int16)


def launch_workers(module: str, n_processes: int, n_local: int,
                   timeout: float = 600.0, attempts: int = 3,
                   extra_args: tuple = ()):
    """Generic multi-process launcher: run ``python -m module`` as
    ``n_processes`` real OS processes (each with ``n_local`` virtual CPU
    devices and the standard --pid/--nproc/--n-local/--port/--outdir
    argv, plus ``extra_args``), wait for all, raise on any nonzero exit. Returns
    ``(tempdir, logs)`` — the caller reads the workers' artifacts from
    ``tempdir.name`` and lets it clean up. Retries the whole launch on
    coordinator-port races (the probed free port is TOCTOU)."""
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    last_err = None
    for _attempt in range(attempts):
        td = tempfile.TemporaryDirectory()
        try:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            env = {k: v for k, v in os.environ.items()
                   if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
            procs = [
                subprocess.Popen(
                    [sys.executable, "-m", module,
                     "--pid", str(pid), "--nproc", str(n_processes),
                     "--n-local", str(n_local), "--port", str(port),
                     "--outdir", td.name, *extra_args],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                )
                for pid in range(n_processes)
            ]
            logs = []
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=timeout)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    for q in procs:  # reap — no zombies across retries
                        q.communicate()
                    raise
                logs.append(out.decode(errors="replace"))
            for p, log in zip(procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"worker rc={p.returncode}:\n{log[-4000:]}"
                    )
            return td, logs
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            td.cleanup()
            last_err = e
    raise last_err


def run_multiprocess_selftest(
    n_processes: int,
    n_local: int,
    channels_per_host: int = 2,
    timeout: float = 600.0,
):
    """Launch ``n_processes`` real OS processes (CPU backend, gloo
    collectives), run the time+channel-sharded channelizer across them, and
    verify every process reports the identical global result. Returns
    ``{"pcm": np.ndarray, "dcn_halo_bytes": int, "mesh_shape": (t, c)}``.

    The caller (test / dryrun) is expected to diff ``pcm`` against a
    single-process run of the same capture.
    """
    import socket
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    # the probed port can be grabbed by another process between close and
    # the coordinator's bind (TOCTOU); retry the whole launch on failure
    last_err = None
    for _attempt in range(3):
        try:
            return _run_selftest_once(
                n_processes, n_local, channels_per_host, timeout,
                socket, subprocess, sys, tempfile, Path,
            )
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            last_err = e
    raise last_err


def _run_selftest_once(n_processes, n_local, channels_per_host, timeout,
                       socket, subprocess, sys, tempfile, Path):
    with socket.socket() as s:  # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    with tempfile.TemporaryDirectory() as td:
        procs = []
        for pid in range(n_processes):
            env = {
                k: v
                for k, v in __import__("os").environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
            }
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable,
                        "-m",
                        "tsl_sdr_tpu.parallel._mh_worker",
                        "--pid", str(pid),
                        "--nproc", str(n_processes),
                        "--n-local", str(n_local),
                        "--channels-per-host", str(channels_per_host),
                        "--port", str(port),
                        "--outdir", td,
                    ],
                    env=env,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                )
            )
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            logs.append(out.decode(errors="replace"))
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"multihost worker rc={p.returncode}:\n{log[-4000:]}"
                )
        outs = [
            np.load(Path(td) / f"mh_out_{pid}.npz")
            for pid in range(n_processes)
        ]
        pcm0 = outs[0]["pcm"]
        for pid in range(1, n_processes):
            if not np.array_equal(pcm0, outs[pid]["pcm"]):
                raise AssertionError(
                    f"process {pid} allgathered a different global result"
                )
        n_time = n_processes * (n_local // channels_per_host)
        return {
            "pcm": pcm0,
            "dcn_halo_bytes": int(outs[0]["halo_bytes"]),
            "mesh_shape": (n_time, channels_per_host),
        }
