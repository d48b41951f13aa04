"""pipeline-tpu: wideband IQ capture -> decoded messages, one process.

Replaces the reference's full deployment (multifm + per-channel resampler +
decoder processes glued by operator-created FIFOs, SURVEY §3.4) with a
single command. The config extends the multifm vocabulary: each channel may
carry ``"protocol": "pocsag" | "flex" | "ais" | "pcm"`` (default pcm, which
writes demodulated audio to ``outFifo`` like multifm would).

Example config additions::

    "channels": [
      {"chanCenterFreq": 929838000, "protocol": "flex"},
      {"chanCenterFreq": 929612500, "protocol": "pocsag", "dcBlock": true},
      {"chanCenterFreq": 930500000, "outFifo": "audio.pcm"}
    ]

Messages are emitted as JSON lines (the decoder CLI's format) to --output
or stdout, tagged with the channel's center frequency.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np


class _SignalGuard:
    """Route SIGTERM/SIGINT through KeyboardInterrupt, but never inside a
    critical section: while :meth:`defer` is held the signal only sets
    ``pending``. An async raise landing inside push() could strand a block
    between the host buffer and the device state (checkpointed
    consumed_samples would then skip it on resume), or leave donated device
    buffers dead so the checkpoint itself crashes."""

    def __init__(self):
        self.pending = False
        self._defer = False

    def handler(self, signum, frame):
        self.pending = True
        if not self._defer:
            raise KeyboardInterrupt

    @contextlib.contextmanager
    def defer(self):
        self._defer = True
        try:
            yield
        finally:
            self._defer = False


def _check_resume_offset(path, fmt, resume_samples):
    """A rotated/recreated input file shorter than the checkpoint's resume
    offset would seek past EOF and silently decode nothing (exit 0, stale
    checkpoint rewritten); restart from sample 0 instead."""
    import os
    import stat

    from tsl_sdr_tpu.utils.iq import unit_bytes

    try:
        st = os.stat(path)
    except OSError:
        return resume_samples
    if stat.S_ISFIFO(st.st_mode):
        return resume_samples
    if st.st_size < resume_samples * unit_bytes(fmt):
        print(f"pipeline-tpu: {path} is shorter than the checkpoint's "
              f"{resume_samples}-sample resume offset (rotated?); "
              "restarting from the beginning", file=sys.stderr)
        return 0
    return resume_samples



def build_argparser():
    from tsl_sdr_tpu.cli import cli_version

    p = argparse.ArgumentParser(prog="pipeline-tpu", description=__doc__)
    p.add_argument("configs", nargs="+", help="JSON config file(s), merged")
    p.add_argument("--iq-file", default=None)
    p.add_argument("--iq-format", default=None,
                   choices=["cs16", "cs8", "cu8", "rtl_u8"])
    p.add_argument("-o", "--output", default=None, help="messages JSON file")
    p.add_argument("--exact", action="store_true",
                   help="bit-exact integer front-end tier")
    p.add_argument("--follow", action="store_true",
                   help="consume the IQ source LIVE (FIFO, growing file, "
                        "or hardware device): decode as data arrives, "
                        "emit JSON lines immediately, run until EOF / "
                        "Ctrl-C — the reference deployment's run-forever "
                        "shape (multifm.c:163-165) in one process")
    p.add_argument("--block-size", type=int, default=None,
                   help="streaming block length in wideband samples")
    p.add_argument("--inflight-depth", type=int, default=2,
                   help="device blocks kept in flight before the oldest "
                        "is decoded: higher hides device->host latency "
                        "(throughput), lower tightens live decode latency")
    p.add_argument("--no-drain-async", action="store_true",
                   help="keep the drain (device fetch + bit unpack + "
                        "decoder scan) on the dispatch thread instead of "
                        "overlapping it with the next block's upload "
                        "(production tier defaults to overlapped)")
    p.add_argument("--state-file", default=None,
                   help="with --follow: restore streaming state from this "
                        ".npz if it exists (regular-file inputs resume at "
                        "the consumed offset), and write it on exit "
                        "(EOF/idle/Ctrl-C) instead of flushing — a "
                        "kill-and-resume deployment survives restarts")
    p.add_argument("--channel-shards", type=int, default=1,
                   help="GSPMD-partition the fused device program across "
                        "this many devices on a channels mesh (channel "
                        "count must divide evenly; decode is bit-identical "
                        "to single-device)")
    p.add_argument("--time-shards", type=int, default=1,
                   help="additionally split each block's SAMPLES across "
                        "this many devices (time axis of the mesh) — "
                        "single-stream scaling; composes with "
                        "--channel-shards (time*channels devices total)")
    p.add_argument("--distributed", metavar="HOST:PORT", default=None,
                   help="multi-host deployment: initialize jax.distributed "
                        "with this coordinator address and span the "
                        "--time/--channel-shards mesh across ALL processes' "
                        "devices (run the same command on every host with a "
                        "distinct --process-id; every host reads the same "
                        "input stream but uploads only its 1/P time span "
                        "per block). Only process 0 emits output")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for --distributed")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --distributed")
    p.add_argument("--stats", type=float, default=0.0, metavar="SECS",
                   help="print a live stats line to stderr every SECS "
                        "seconds in --follow mode: samples, rate, "
                        "messages, device blocks and egress-gated fetches")
    p.add_argument("--standby", action="store_true",
                   help="hot-standby resume (requires --follow and "
                        "--state-file): warm the device, then WAIT for the "
                        "state file to appear — written by a terminating "
                        "primary — before restoring and attaching to the "
                        "stream. Compilation and device set-up are paid "
                        "while the primary still serves, so failover costs "
                        "seconds. To share one card, start the primary and "
                        "the standby each with "
                        "XLA_PYTHON_CLIENT_MEM_FRACTION=0.45 (README, 'Hot "
                        "standby on one card')")
    p.add_argument("--no-warm", action="store_true",
                   help="skip the device warm block before a --follow "
                        "stream (default: run one throwaway zeros block "
                        "first so compilation and device set-up land "
                        "in startup, not on live traffic)")
    p.add_argument("--idle-exit", type=float, default=1.0,
                   help="with --follow on a regular file: stop after the "
                        "file has not grown for this many seconds "
                        "(default 1.0 — tolerates a writer momentarily "
                        "ahead of the reader; pass 0 to stop at first "
                        "EOF, a large value to follow like tail -f)")
    p.add_argument("--realtime", action="store_true",
                   help="with --follow on a file: pace reads at "
                        "sampleRateHz (the reference file source's "
                        "real-time delivery, file_if.c:160-203) — "
                        "simulates a live capture")
    p.add_argument("--iq-dump", default=None,
                   help="dump ingested wideband IQ (int16 values) to this "
                        "file — the reference's iqDumpFile tap")
    p.add_argument("--nmea", default=None, metavar="FILE",
                   help="emit standard NMEA 0183 !AIVDM sentences for "
                        "every CRC-valid packet on ais channels to FILE "
                        "('-' = stdout) — live AIS aggregator feed")
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {cli_version()}")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from tsl_sdr_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    is_main = True
    if args.distributed is not None:
        if args.num_processes is None or args.process_id is None:
            print("pipeline-tpu: --distributed needs --num-processes and "
                  "--process-id", file=sys.stderr)
            return 2
        if args.state_file is not None:
            print("pipeline-tpu: --state-file is single-process; "
                  "multi-host deployments checkpoint their input feed "
                  "per host", file=sys.stderr)
            return 2
        # must run before anything touches jax devices
        from tsl_sdr_tpu.parallel import multihost

        multihost.init(args.distributed,
                       num_processes=args.num_processes,
                       process_id=args.process_id)
        import jax

        is_main = jax.process_index() == 0
        if args.time_shards == 1 and args.channel_shards == 1:
            # default: split each block's samples across every global
            # device — the single-stream scale-out shape
            args.time_shards = len(jax.devices())

    if args.state_file is not None:
        if not args.follow:
            print("pipeline-tpu: --state-file requires --follow",
                  file=sys.stderr)
            return 2
        if args.exact:
            print("pipeline-tpu: --state-file covers the production "
                  "streaming tier; the bit-exact tier is a parity oracle "
                  "(drop --exact)", file=sys.stderr)
            return 2

    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.utils import iq as iqio
    from tsl_sdr_tpu.utils.config import MultifmConfig, load_config
    from tsl_sdr_tpu.utils.jsonout import message_to_json

    from tsl_sdr_tpu.utils.config import ConfigError

    try:
        raw = load_config(*args.configs)
        cfg = MultifmConfig.from_dict(raw)
    except ConfigError as e:
        print(f"pipeline-tpu: {e}", file=sys.stderr)
        return 2

    iq_path = args.iq_file
    iq_fmt = args.iq_format
    dev_type = cfg.device.type
    if dev_type == "file" and iq_path is None:
        iq_path = cfg.device.params["filename"]
        iq_fmt = iq_fmt or cfg.device.params.get("fileFormat", "cs16")
    hw_source = None
    if iq_path is None and args.follow:
        from tsl_sdr_tpu.cli.multifm import make_hw_source
        from tsl_sdr_tpu.sources.hw import HwLibraryMissing

        try:
            hw_source = make_hw_source(cfg, dev_type)
        except HwLibraryMissing as e:
            print(f"pipeline-tpu: {e}", file=sys.stderr)
            return 2
    if iq_path is None and hw_source is None:
        print("pipeline-tpu: need a file device, --iq-file, or --follow "
              "with a hardware device", file=sys.stderr)
        return 2

    fmt = iq_fmt or "cs16"
    # 8-bit file/FIFO captures ride the wire-format ingest path: raw bytes
    # upload at 2 B/sample and widen in the device program's first stage
    # (hardware sources deliver int16 blocks from the native ingest
    # runtime and stay cs16)
    wire_fmt = fmt if iq_path is not None else "cs16"

    specs = []
    for ch_raw, ch in zip(raw["channels"], cfg.channels):
        specs.append(
            ChannelSpec(
                center_freq_hz=ch.chan_center_freq,
                protocol=str(ch_raw.get("protocol", "pcm")).lower(),
                invert=bool(ch_raw.get("invert", False)),
                dc_block=bool(ch_raw.get("dcBlock", False)),
                dc_block_pole=float(ch_raw.get("dcBlockPole", 0.9999)),
                db_gain=ch_raw.get("dBGain"),
            )
        )

    mesh = None
    if args.channel_shards > 1 or args.time_shards > 1:
        import jax

        from tsl_sdr_tpu.parallel.mesh import make_mesh

        n_dev = len(jax.devices())
        n_need = args.channel_shards * args.time_shards
        if n_dev < n_need:
            print(f"pipeline-tpu: --time-shards {args.time_shards} x "
                  f"--channel-shards {args.channel_shards} needs "
                  f"{n_need} devices, have {n_dev}", file=sys.stderr)
            return 2
        if args.distributed is not None and n_need != n_dev:
            # a partial mesh would leave other ranks' devices outside the
            # computation — ranks would compile divergent programs
            print(f"pipeline-tpu: --distributed meshes must span every "
                  f"global device: time x channels = {n_need} but "
                  f"{n_dev} devices are attached", file=sys.stderr)
            return 2
        if len(specs) % args.channel_shards:
            print(f"pipeline-tpu: {len(specs)} channels not divisible by "
                  f"--channel-shards {args.channel_shards}", file=sys.stderr)
            return 2
        mesh = make_mesh(time=args.time_shards,
                         channels=args.channel_shards,
                         devices=jax.devices()[:n_need])

    nmea_out = None
    ais_hook = None
    if args.nmea is not None:
        if not any(s.protocol == "ais" for s in specs):
            print("pipeline-tpu: --nmea needs at least one ais channel",
                  file=sys.stderr)
            return 2
    if args.nmea is not None and not is_main:
        pass  # SPMD ranks >0 decode identically; only rank 0 feeds NMEA
    elif args.nmea is not None:
        from tsl_sdr_tpu.models.ais import NmeaEmitter, aivdm_channel_for_freq

        nmea_out = (sys.stdout if args.nmea == "-"
                    else open(args.nmea, "w"))
        # channel letter per AIS carrier frequency (161.975=A, 162.025=B)
        ais_hook = NmeaEmitter(nmea_out, channel=aivdm_channel_for_freq)

    pipe = ReceivePipeline(
        cfg.lpf_taps, cfg.center_freq_hz, cfg.sample_rate_hz,
        cfg.decimation_factor, specs,
        exact=args.exact,
        block_size=args.block_size,
        inflight_depth=args.inflight_depth,
        mesh=mesh,
        ais_packet_hook=ais_hook,
        wire_fmt=wire_fmt,
        drain_async=not args.no_drain_async,
    )

    if is_main:
        out = open(args.output, "w", buffering=1) if args.output \
            else sys.stdout
    else:
        # every process decodes identically (SPMD); only rank 0 emits
        import os as _os

        out = open(_os.devnull, "w")
    iq_dump = (open(args.iq_dump, "wb")
               if args.iq_dump and is_main else None)
    n_msgs = 0
    pcm_sinks = {
        i: open(ch.out_fifo, "wb")
        for i, (spec, ch) in enumerate(zip(specs, cfg.channels))
        if spec.protocol == "pcm" and ch.out_fifo and is_main
    }

    def emit(results):
        nonlocal n_msgs
        for i, (spec, res) in enumerate(zip(specs, results)):
            if spec.protocol == "pcm":
                sink = pcm_sinks.get(i)
                if sink is not None:
                    for arr in (res if isinstance(res, list) else [res]):
                        np.asarray(arr, np.int16).tofile(sink)
                continue
            for m in res:
                out.write(
                    message_to_json(m, freq_hz=spec.center_freq_hz) + "\n"
                )
                n_msgs += 1
        out.flush()

    def dump_iq(iq):
        """--iq-dump taps ingested IQ as int16 VALUES (the reference's
        iqDumpFile semantics) regardless of the wire format."""
        if wire_fmt == "cs16":
            np.asarray(iq, np.int16).tofile(iq_dump)
        else:
            iqio.widen_iq_bytes(
                np.ascontiguousarray(iq).reshape(-1).view(np.uint8),
                wire_fmt,
            ).tofile(iq_dump)

    n_samples = 0
    t0 = time.monotonic()
    try:
        if args.follow:
            resume_samples = 0
            guard = _SignalGuard()
            # SIGTERM (service-manager stop) and Ctrl-C both take the
            # clean-shutdown path — drain, flush-or-checkpoint, summary —
            # and only at block boundaries, never mid-push (_SignalGuard)
            import signal as _signal

            try:
                _signal.signal(_signal.SIGTERM, guard.handler)
                _signal.signal(_signal.SIGINT, guard.handler)
            except ValueError:
                pass  # not the main thread: keep default handlers
            if not args.no_warm:
                # before restore: warming needs a pristine stream, and a
                # resume leg benefits most (its compile and set-up would
                # otherwise land on the backlog behind the FIFO)
                try:
                    warm_s = pipe.warm_device()
                except KeyboardInterrupt:
                    # a stop request while warming: nothing streamed yet,
                    # nothing to save
                    print("pipeline-tpu: interrupted during device warm",
                          file=sys.stderr)
                    return 0
                print(f"pipeline-tpu: device warm in {warm_s:.1f}s",
                      file=sys.stderr)
            if args.standby:
                import os as _os

                if args.state_file is None:
                    print("pipeline-tpu: --standby requires --state-file",
                          file=sys.stderr)
                    return 2
                print(f"pipeline-tpu: standby — warmed, waiting for "
                      f"{args.state_file}", file=sys.stderr)
                # the primary writes the state file as its last act; its
                # appearance is the failover trigger (the .npz replace is
                # atomic, so a partially-written file is never observed).
                # A supervisor that saw the primary die WITHOUT a
                # checkpoint (crash before/while streaming) touches
                # <state-file>.takeover instead: take over fresh — the
                # protocols self-synchronize
                takeover = args.state_file + ".takeover"
                try:
                    while not (_os.path.exists(args.state_file)
                               or _os.path.exists(takeover)):
                        if guard.pending:
                            raise KeyboardInterrupt
                        time.sleep(0.1)
                except KeyboardInterrupt:
                    print("pipeline-tpu: standby cancelled",
                          file=sys.stderr)
                    return 0
                if _os.path.exists(takeover):
                    try:
                        _os.unlink(takeover)
                    except OSError:
                        pass
                print("pipeline-tpu: standby taking over", file=sys.stderr)
            if args.state_file is not None:
                import os as _os

                if _os.path.exists(args.state_file):
                    try:
                        user = pipe.restore_stream(args.state_file)
                    except Exception as e:  # noqa: BLE001
                        # an unreadable/incompatible state file must not
                        # crash-loop the service: set it aside and start
                        # fresh (the protocols self-synchronize)
                        bad = args.state_file + ".bad"
                        _os.replace(args.state_file, bad)
                        print(f"pipeline-tpu: state file unusable "
                              f"({type(e).__name__}: {e}); moved to {bad}, "
                              "starting fresh", file=sys.stderr)
                    else:
                        resume_samples = int(
                            user.get("consumed_samples", 0))
                        print(f"pipeline-tpu: resumed from "
                              f"{args.state_file} ({resume_samples} "
                              "samples consumed)", file=sys.stderr)
                        if resume_samples and iq_path is not None:
                            resume_samples = _check_resume_offset(
                                iq_path, fmt, resume_samples
                            )
            if hw_source is not None:
                from tsl_sdr_tpu.cli.multifm import _pairs

                hw_source.open(cfg.sample_rate_hz, cfg.center_freq_hz)
                hw_source.set_mute(False)
                hw_source.start()
                blocks = _pairs(hw_source.blocks())
            else:
                blocks = _follow_blocks(
                    iq_path, fmt, idle_exit=args.idle_exit,
                    skip_samples=resume_samples,
                    pace_sps=cfg.sample_rate_hz if args.realtime else 0,
                    raw_wire=(wire_fmt != "cs16"),
                )
            # startup mute gate for live hardware (receiver.h:98,
            # multifm/multifm.c:158) — drop the tuner-settling head like
            # multifm-tpu does
            mute_left = (
                cfg.sample_rate_hz * cfg.mute_startup_ms // 1000
                if hw_source is not None else 0
            )
            from tsl_sdr_tpu.runtime.stream import StatsTicker, StreamCounters

            counters = StreamCounters()
            ticker = StatsTicker(args.stats, counters, "pipeline-tpu")
            try:
                for iq in blocks:
                    if mute_left > 0:
                        drop = min(mute_left, len(iq))
                        iq = iq[drop:]
                        mute_left -= drop
                        if not len(iq):
                            continue
                    n_samples += len(iq)
                    if iq_dump is not None:
                        dump_iq(iq)
                    with guard.defer():
                        emit(pipe.push(iq))
                    if guard.pending:
                        raise KeyboardInterrupt
                    if args.stats:
                        counters.samples_in = n_samples
                        counters.messages = n_msgs
                        # the device-counter fetch is a critical section
                        # too: a signal raising mid-fetch surfaces as an
                        # "Exception ignored" traceback from jax's array
                        # materialization (seen in soak stderr tails)
                        with guard.defer():
                            st = pipe.stream_stats
                            ticker.tick(
                                f" blocks={st['blocks']} "
                                f"fetched={st['fetched'].tolist()}"
                            )
                        if guard.pending:
                            raise KeyboardInterrupt
            except KeyboardInterrupt:
                pass
            finally:
                if hw_source is not None:
                    hw_source.stop()
            if args.state_file is not None and pipe._stream is not None:
                # a second SIGTERM during the save must not kill it: the
                # whole drain+write is one critical section (the .npz
                # replace itself is atomic, models/pipeline.py)
                with guard.defer():
                    emit(pipe.checkpoint_stream(
                        args.state_file,
                        user_meta={"consumed_samples":
                                   resume_samples + n_samples},
                    ))
                print(f"pipeline-tpu: state saved to {args.state_file}",
                      file=sys.stderr)
            else:
                try:
                    # same protection as the checkpoint branch: a SIGTERM
                    # mid-drain must not abort the final flush uncaught
                    with guard.defer():
                        emit(pipe.flush())
                except ValueError as e:
                    # a follow run stopped before the stream ever primed
                    # (fewer than prefix samples arrived) is a clean stop,
                    # not a crash: report and fall through to the summary
                    print(f"pipeline-tpu: {e}", file=sys.stderr)
        else:
            if wire_fmt == "cs16":
                iq = iqio.read_iq_file(iq_path, fmt)
                n_samples = len(iq)
            else:
                # raw wire bytes straight to the pipeline: the widening
                # runs on device (2 B/sample over the host->device link)
                raw = np.fromfile(iq_path, np.uint8)
                iq = raw[: len(raw) // 2 * 2].reshape(-1, 2)
                n_samples = len(iq)
            if iq_dump is not None:
                dump_iq(iq)
            emit(pipe.process_capture(iq))
    finally:
        if out is not sys.stdout:
            out.close()
        for sink in pcm_sinks.values():
            sink.close()
        if iq_dump is not None:
            iq_dump.close()
        if nmea_out is not None and nmea_out is not sys.stdout:
            nmea_out.close()
    dt = time.monotonic() - t0
    print(
        f"pipeline-tpu: {n_samples} samples, {len(specs)} channels, "
        f"{n_msgs} messages in {dt:.2f}s "
        f"({n_samples / max(dt, 1e-9) / 1e6:.1f} Msps)",
        file=sys.stderr,
    )
    return 0


def _follow_blocks(path, fmt, chunk_bytes: int = 1 << 20,
                   idle_exit: float | None = None,
                   skip_samples: int = 0,
                   pace_sps: float = 0,
                   raw_wire: bool = False):
    """Yield [N, 2] int16 blocks from a FIFO or regular file as data
    arrives. A FIFO ends when every writer has closed; a regular file is
    polled past EOF (it may still be growing — tail -f semantics) until
    Ctrl-C, or until it has not grown for ``idle_exit`` seconds.
    ``pace_sps`` > 0 sleeps so delivery tracks that sample rate (the
    reference file source's real-time pacing, ``file_if.c:160-203``).
    ``raw_wire`` skips host widening: blocks are [N, 2] of the wire view
    dtype and the device program widens (ReceivePipeline wire_fmt)."""
    import os
    import stat

    from tsl_sdr_tpu.utils import iq as iqio
    from tsl_sdr_tpu.utils.iq import WIRE_DTYPES, unit_bytes

    unit = unit_bytes(fmt)
    residue = b""
    t0 = time.monotonic()
    delivered = 0
    with open(path, "rb") as f:
        is_fifo = stat.S_ISFIFO(os.fstat(f.fileno()).st_mode)
        if skip_samples:
            if is_fifo:
                # a FIFO is a live stream: the writer restarted too, so
                # there is nothing to skip
                pass
            else:
                f.seek(skip_samples * unit)
        idle = 0.0
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                if is_fifo:
                    break  # all writers closed
                if idle_exit is not None and idle >= idle_exit:
                    break
                time.sleep(0.05)
                idle += 0.05
                continue
            idle = 0.0
            data = residue + chunk
            usable = len(data) // unit * unit
            residue = data[usable:]
            if not usable:
                continue
            raw = np.frombuffer(data[:usable], np.uint8)
            if raw_wire:
                block = raw.view(WIRE_DTYPES[fmt]).reshape(-1, 2)
            else:
                block = iqio.widen_iq_bytes(raw, fmt).reshape(-1, 2)
            if pace_sps > 0:
                delivered += block.shape[0]
                lag = delivered / pace_sps - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
            yield block


if __name__ == "__main__":
    sys.exit(main())
