"""Executed multi-process (DCN-path) tests: real OS processes running
``jax.distributed`` on the CPU backend.

Covers what `tests/test_parallel.py::test_multihost_device_layout` could
not: ``multihost.init`` + ``make_global_mesh`` + ``distribute_iq`` actually
executing across process boundaries, with cross-process collectives (gloo)
carrying the halo exchange, and the global result matching a
single-process run of the identical capture bit-for-bit.

Reference context: the reference is single-host by design
(/root/reference/multifm/multifm.c); SURVEY §2.2 row 5 makes scale-out a
new obligation for this framework.
"""

import numpy as np
import pytest

from tsl_sdr_tpu.parallel import multihost
from tsl_sdr_tpu.parallel.mesh import make_mesh


def _expected_pcm(n_time: int, channels_per_host: int) -> np.ndarray:
    """Single-process run of the self-test capture on an identically-shaped
    mesh (same shard partitioning => bit-identical f32 math)."""
    from tsl_sdr_tpu.parallel.channelizer import make_sharded_multifm

    chain = multihost.selftest_chain(nr_channels=2 * channels_per_host)
    plan = chain.packed_plan
    mesh = make_mesh(time=n_time, channels=channels_per_host)
    fn = make_sharded_multifm(plan, mesh)
    vals = multihost.selftest_capture(plan, n_time)
    return np.asarray(fn(vals))


@pytest.mark.parametrize(
    "n_processes,n_local",
    [(2, 4), (4, 2)],
    ids=["2proc_x4dev", "4proc_x2dev"],
)
def test_multiprocess_channelizer_matches_single_process(n_processes, n_local):
    channels_per_host = 2
    res = multihost.run_multiprocess_selftest(
        n_processes, n_local, channels_per_host
    )
    n_time = n_processes * (n_local // channels_per_host)
    assert res["mesh_shape"] == (n_time, channels_per_host)

    expected = _expected_pcm(n_time, channels_per_host)
    assert res["pcm"].shape == expected.shape
    assert np.array_equal(res["pcm"], expected), (
        np.abs(res["pcm"].astype(np.int32) - expected.astype(np.int32)).max()
    )

    # the DCN halo really is a few KB per block, as multihost.py promises
    chain = multihost.selftest_chain(nr_channels=2 * channels_per_host)
    plan = chain.packed_plan
    assert res["dcn_halo_bytes"] == (
        (n_processes - 1) * (plan.cr_rows + 1) * plan.row * 2
        * channels_per_host  # one time-axis ppermute per channel column
    )
    # tiny test capture; production blocks are MBs so the ratio only shrinks
    block_bytes = multihost.selftest_capture(plan, n_time).nbytes
    assert res["dcn_halo_bytes"] < block_bytes / 20


@pytest.mark.parametrize("mesh_channels,upload_frac", [
    # time-only mesh: each process uploads ONLY its local time span
    # (1/P of every block), not a replicated copy
    (1, 0.5),
    # mixed time x channels mesh: the time span is additionally
    # replicated across the channel axis's local devices (2 shards x 2
    # channel copies = one block's worth per process; per-DEVICE upload
    # is still 1/4 block)
    (2, 1.0),
])
def test_multiprocess_fused_pipeline_decodes_identically(
        mesh_channels, upload_frac):
    """The FULL fused receive pipeline (channelize -> resample -> DC ->
    sign-slice -> bit-pack -> sync prefilters, one dispatch per block)
    executed across 2 REAL OS processes (jax.distributed, gloo): GSPMD
    partitions the program over the process boundary, the gated outputs
    gather back over DCN, and every process decodes exactly the messages
    a single-process (no-mesh) run produces — including identical
    egress-gating fetch counters. Block ingest is time-sharded from each
    process's local span (jax.make_array_from_single_device_arrays), so
    hosts upload a fraction of each block, not a replicated copy."""
    import json
    from pathlib import Path

    from tsl_sdr_tpu.parallel import multihost
    from tsl_sdr_tpu.parallel._mh_pipeline_worker import run_pipeline

    td, _logs = multihost.launch_workers(
        "tsl_sdr_tpu.parallel._mh_pipeline_worker", 2, 4, timeout=900.0,
        extra_args=("--channels", str(mesh_channels)))
    with td:
        outs = [
            json.load(open(Path(td.name) / f"mhp_out_{pid}.json"))
            for pid in range(2)
        ]

    want_msgs, want_stats = run_pipeline(None)  # single-process reference
    want = [[list(m) for m in ch] for ch in want_msgs]
    assert [m[0] for m in want[0]] == [7001, 7002], want
    assert not want[1]  # silent channel gated
    for o in outs:
        assert o["msgs"] == want, o
        assert o["fetched"] == [int(v) for v in want_stats["fetched"]], o
        assert o["blocks"] == int(want_stats["blocks"])
        assert o["upload_elems"] == int(
            want_stats["upload_elems"] * upload_frac), o


def test_pipeline_cli_distributed_two_processes(tmp_path):
    """pipeline-tpu --distributed: the deployment CLI itself runs across
    2 real OS processes (jax.distributed), GSPMD-spanning the default
    time mesh over all global devices; rank 0 emits the JSON messages a
    single-process run produces, other ranks stay silent."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from tsl_sdr_tpu.parallel._mh_pipeline_worker import _capture, run_pipeline
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim, fs, center = 32, 38400 * 32, 929_500_000
    iq = _capture(fs, decim)
    iq_path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(iq_path)
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"protocol": "pocsag", "chanCenterFreq": center + 250_000},
            {"protocol": "pocsag", "chanCenterFreq": center - 250_000},
        ],
    }
    cfg_path = tmp_path / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # the -c wrapper forces the cpu platform BEFORE backend init (an
    # environment may re-force JAX_PLATFORMS, so env alone is not enough)
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import sys; from tsl_sdr_tpu.cli import pipeline; "
            "sys.exit(pipeline.main(sys.argv[1:]))")
    outs = {p: tmp_path / f"out{p}.json" for p in (0, 1)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(cfg_path),
             "--distributed", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(p),
             "-o", str(outs[p]), "--block-size", "393216"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for p in (0, 1)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), logs

    want_msgs, _stats = run_pipeline(None)  # same capture, single process
    want = [(m[0], m[1]) for m in want_msgs[0]]
    assert [w[0] for w in want] == [7001, 7002]
    lines = [json.loads(x) for x in outs[0].read_text().splitlines()]
    assert [(m["capCode"], m["message"]) for m in lines] == [
        (c, t.rstrip("\x00")) for c, t in want], (lines, want)
    assert not outs[1].exists(), "rank 1 must not emit"
