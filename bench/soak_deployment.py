#!/usr/bin/env python3
"""Live deployment soak on the GPU.

Proves the run-forever deployment story (the reference's operational shape,
``multifm/multifm.c:163-165`` of pvachon/tsl-sdr) on hardware, not just in
pytest: ``pipeline-tpu --follow`` consumes a named FIFO fed by a paced
writer at the flagship wideband rate (1.2288 Msps, 8 POCSAG channels) for
the requested duration, with ONE kill (SIGTERM -> checkpoint) and resume
(``--state-file``) mid-run.

The writer stamps every burst with a sequence number and records the wall
time each was written; the soak tails the decoder's JSONL output and turns
each decode into an end-to-end latency sample. Reported at the end (one
JSON line):

* offered vs achieved ingest rate (writer side; a slow pipeline would
  backpressure the FIFO and drag the achieved rate below nominal),
* decoded/expected burst counts (pre-kill, post-resume, total),
* end-to-end latency percentiles (write -> decoded-message-on-disk),
* the kill/resume event log.

The primary and its hot standby share one card, so this launcher starts
every leg with ``XLA_PYTHON_CLIENT_MEM_FRACTION=0.45`` (two processes at
JAX's default of three quarters cannot both start), as README's "Hot
standby on one card" says.

Usage:  python bench/soak_deployment.py [--minutes 30] [--kill-at 0.5]
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the pipeline legs run on the card, each with its share of the card's
# memory; this parent process only generates the stream and reads results,
# so it stays off the card (a JAX process reserves its memory share when
# it starts)
CHILD_ENV = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION="0.45")
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

DECIM = 32
CHANNEL_RATE = 38400
FS = CHANNEL_RATE * DECIM          # 1.2288 Msps wideband
CENTER = 929_500_000
OFFSETS = [-450_000, -320_000, -190_000, -60_000,
           60_000, 190_000, 320_000, 450_000]
BAUD = 1200
# live-latency tuning (soak v2): ~1 s blocks, ZERO in-flight depth, and
# the synchronous drain. The device is ~10x faster than the 1.2288 Msps
# stream, so depth/async give no throughput here and each costs a block
# time of decode latency (drained-on-next-push / collected-on-next-push);
# depth 0 + sync drain decodes each block inside its own push.
BLOCK_TARGET = 1_228_800
INFLIGHT_DEPTH = 0
# noise-only stream seconds after the last burst. A leg run with
# --state-file that sees the stream end checkpoints what it has not
# finished (the filter history and the decoder's open message) for its
# successor instead of flushing it, so without a tail the last burst is
# never decoded by anyone.
TAIL_SECONDS = 2


class PacedWriter(threading.Thread):
    """Generates the live IQ stream second-by-second and writes it to the
    FIFO at real-time pace. Each stream-second carries one POCSAG burst on
    channel ``seq % 8`` stamped with ``seq``; write times are recorded for
    latency measurement. Survives reader restarts (reopens the FIFO)."""

    def __init__(self, fifo: str, seconds: float):
        super().__init__(daemon=True)
        self.fifo = fifo
        self.seconds = seconds
        self.write_times = {}          # seq -> wall time fully written
        self.bytes_written = 0
        self.t_start = None
        self.t_end = None
        self.reopens = 0
        self.stop_flag = threading.Event()
        self._rng = np.random.default_rng(42)
        from tsl_sdr_tpu.testing import pocsag_gen

        self._gen = pocsag_gen

    def _second(self, seq: int) -> np.ndarray:
        """One second of wideband IQ: noise + one stamped burst on
        channel seq % 8.

        Capcodes are FRAME-0 aligned (capcode % 8 == 0): a frame-7
        address lands in the batch's last codeword pair, the message
        codewords spill into a SECOND batch, and the burst grows to
        1728 bits = 1.44 s at 1200 baud — longer than this 1 s slot, so
        the generator's slot cut would truncate it mid-message. (That
        truncation, not the kill/resume, was the bulk of the r4 soak's
        12% "lost" bursts: every 8th burst used capcode 100_007 ->
        frame 7; the compiled reference decoder can't decode a
        truncated burst either.) Frame-0 bursts are 1184 bits = 0.99 s
        and fit."""
        n = FS
        ch = seq % len(OFFSETS)
        off = OFFSETS[ch]
        bb = self._gen.generate(
            [self._gen.PocsagBurst(capcode=100_000 + 16 * ch, function=1,
                                   kind="alpha", content=f"SOAK {seq}")],
            baud=BAUD, amplitude=6000, tail_bits=64)
        dev = bb.astype(np.float64) / 16384.0 * (CHANNEL_RATE / 2)
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / FS, DECIM))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 6000
        iq = self._rng.normal(scale=90, size=(n, 2))
        m = min(len(sig), n - 8192)
        iq[4096:4096 + m] += sig[:m]
        return iq.astype(np.int16)

    def _write(self, f, second: int, buf: bytes):
        """Write stream-second ``second`` at real-time pace; returns the
        (possibly reopened) FIFO."""
        delay = self.t_start + second - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        view = memoryview(buf)
        while len(view) and not self.stop_flag.is_set():
            try:
                k = f.write(view)
                view = view[k:]
                self.bytes_written += k
            except BrokenPipeError:
                # reader restarting (kill/resume window): reopen
                # blocks until the resumed process attaches
                f.close()
                self.reopens += 1
                f = open(self.fifo, "wb", buffering=0)
        return f

    def run(self):
        self.t_start = time.monotonic()
        deadline = self.t_start + self.seconds
        seq = 0
        f = open(self.fifo, "wb", buffering=0)
        try:
            while not self.stop_flag.is_set():
                if time.monotonic() >= deadline:
                    break
                f = self._write(f, seq, self._second(seq).tobytes())
                self.write_times[seq] = time.time()
                seq += 1
            for k in range(TAIL_SECONDS):
                if self.stop_flag.is_set():
                    break
                noise = self._rng.normal(scale=90, size=(FS, 2))
                f = self._write(f, seq + k, noise.astype(np.int16).tobytes())
        finally:
            try:
                f.close()
            except BrokenPipeError:
                pass
            self.t_end = time.monotonic()
        self.n_seq = seq


def launch_pipeline(cfg_path, fifo, out_path, state_file, standby=False):
    """One pipeline leg. ``out_path`` must be unique per leg: ``-o`` opens
    with "w" and would truncate the previous leg's messages on resume.
    ``standby=True`` launches a hot-standby resume leg: it warms its
    device session immediately but only attaches to the FIFO once the
    primary's checkpoint file appears (failover in seconds instead of
    paying compilation and device set-up under live traffic). Every leg
    gets 0.45 of the card's memory (``CHILD_ENV``), so a primary and its
    standby fit on one card together."""
    return subprocess.Popen(
        [sys.executable, "-m", "tsl_sdr_tpu.cli.pipeline", str(cfg_path),
         "--iq-file", str(fifo), "--iq-format", "cs16", "--follow",
         "--idle-exit", "30", "--stats", "15",
         "--block-size", str(BLOCK_TARGET),
         "--inflight-depth", str(INFLIGHT_DEPTH), "--no-drain-async",
         "--state-file", str(state_file)]
        + (["--standby"] if standby else [])
        + ["-o", str(out_path)],
        env=CHILD_ENV, stderr=subprocess.PIPE, text=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--kill-at", type=float, default=0.5,
                    help="fraction of the run at which to SIGTERM + resume")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: a new temporary one)")
    args = ap.parse_args()

    from tsl_sdr_tpu.utils.device import card_line

    # the device check runs where the legs run: in a child on the card
    dev = json.loads(subprocess.run(
        [sys.executable, "-c",
         "import json; from tsl_sdr_tpu.utils.device import require_gpu; "
         "print(json.dumps(require_gpu()))"],
        env=CHILD_ENV, check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[-1])
    card = card_line()
    print(f"soak: device {dev}; card {card}", flush=True)
    if args.workdir is None:
        import tempfile

        args.workdir = tempfile.mkdtemp(prefix="soak_deploy_")
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    fifo = wd / "iq.fifo"
    if fifo.exists():
        fifo.unlink()
    os.mkfifo(fifo)
    out_paths = [wd / "messages_0.jsonl"]
    out_paths[0].write_text("")
    state_file = wd / "pipe.state.npz"
    if state_file.exists():
        state_file.unlink()
    tk = Path(str(state_file) + ".takeover")
    if tk.exists():
        tk.unlink()

    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    cfg = {
        "sampleRateHz": FS,
        "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, firdes_low_pass(1.0, FS, 9_600, 7_000))),
        "channels": [
            {"chanCenterFreq": CENTER + o, "protocol": "pocsag"}
            for o in OFFSETS
        ],
    }
    cfg_path = wd / "soak.json"
    cfg_path.write_text(json.dumps(cfg))

    # the library rounds block_size to the pipeline quantum — ask it for
    # the ACTUAL block length so latency-in-block-times is honest
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline

    block_samples = ReceivePipeline(
        np.asarray(cfg["lpfTaps"]), CENTER, FS, DECIM,
        [ChannelSpec(CENTER + o, "pocsag") for o in OFFSETS],
        block_size=BLOCK_TARGET,
    ).block_size
    print(f"soak: block = {block_samples} samples "
          f"({block_samples / FS:.2f} s), inflight depth "
          f"{INFLIGHT_DEPTH}", flush=True)

    # ---- warmup: populate the persistent compile cache BEFORE going live.
    # Without this, a short soak measures the compiler, not
    # the deployment (the kill can even land mid-compile, so the cache
    # never fills and every leg recompiles). Operationally this is the
    # standard "prime the jit cache on rollout" step.
    t_warm0 = time.monotonic()
    warm_file = wd / "warmup.cs16"
    # BURST-BEARING warmup (soak v2): zeros-only warmup left the burst
    # paths (decoder activation, hot<->cold gating transitions) cold, so
    # the first live bursts paid them at stream time. 10 stream-seconds
    # with one stamped burst per channel, then 2 noise-only seconds so
    # the hot->cold edge is exercised too.
    warm_writer = PacedWriter(str(fifo), 0)  # generator only, never started
    with open(warm_file, "wb") as wf:
        for wseq in range(10):
            wf.write(warm_writer._second(wseq).tobytes())
        noise = warm_writer._rng.normal(scale=90, size=(FS, 2))
        for _ in range(2):
            wf.write(noise.astype(np.int16).tobytes())
    warm = subprocess.run(
        [sys.executable, "-m", "tsl_sdr_tpu.cli.pipeline", str(cfg_path),
         "--iq-file", str(warm_file), "--iq-format", "cs16",
         # --follow so the warmup compiles the SAME streaming programs
         # (push + flush) the live legs run, not the capture path — and
         # the SAME block shape (a different block size would compile a
         # different program and the first live block would stall)
         "--follow", "--idle-exit", "2",
         "--block-size", str(BLOCK_TARGET),
         "--inflight-depth", str(INFLIGHT_DEPTH),
         "-o", os.devnull],
        env=CHILD_ENV, capture_output=True, text=True, timeout=1800,
    )
    warm_s = round(time.monotonic() - t_warm0, 1)
    warm_file.unlink()
    print(f"soak: warmup leg rc={warm.returncode} in {warm_s}s",
          flush=True)

    total_s = args.minutes * 60.0
    writer = PacedWriter(str(fifo), total_s)
    events = [("warmup", time.time(), warm.returncode, warm_s)]

    proc = launch_pipeline(cfg_path, fifo, out_paths[-1], state_file)
    stderr_lines = []

    def _drain(p):
        for line in p.stderr:
            stderr_lines.append(line.rstrip())

    drain = threading.Thread(target=_drain, args=(proc,), daemon=True)
    drain.start()
    # hot standby (soak v2): the resume leg starts early and warms its own
    # device session while the primary serves; at kill time it attaches
    # within seconds of the checkpoint appearing. Launch STAGGERED (45 s)
    # so the two fresh sessions don't contend for device startup.
    out_paths.append(wd / "messages_1.jsonl")
    sb = {}

    def _launch_standby():
        sb["proc"] = launch_pipeline(cfg_path, fifo, out_paths[1],
                                     state_file, standby=True)
        sb["drain"] = threading.Thread(
            target=_drain, args=(sb["proc"],), daemon=True)
        sb["drain"].start()

    threading.Timer(45.0, _launch_standby).start()
    writer.start()
    events.append(("start", time.time()))

    decode_times = {}              # seq -> wall time first seen decoded
    seen = set()
    seq_re = re.compile(r"SOAK (\d+)")

    def scan_output():
        lines = []
        for p in out_paths:
            try:
                lines += p.read_text().splitlines()
            except FileNotFoundError:
                pass
        now = time.time()
        for line in lines:
            m = seq_re.search(line)
            if not m:
                continue
            seq = int(m.group(1))
            if seq in seen:
                continue
            seen.add(seq)
            decode_times[seq] = now

    kill_t = time.monotonic() + total_s * args.kill_at
    end_t = time.monotonic() + total_s
    killed = False
    t_sigterm = t_restarted = None
    while time.monotonic() < end_t:
        time.sleep(0.5)  # 0.5 s decode-time resolution for the latency
        scan_output()    # samples and the outage window
        if not killed and time.monotonic() >= kill_t:
            events.append(("sigterm", time.time()))
            t_sigterm = time.time()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=300)
            except subprocess.TimeoutExpired:
                # must not abort the soak: escalate, record, resume anyway
                events.append(("sigterm-timeout-kill", time.time()))
                proc.kill()
                rc = proc.wait(timeout=30)
            events.append(("checkpointed", time.time(), rc,
                           state_file.exists()))
            drain.join(timeout=10)
            scan_output()
            if not state_file.exists():
                # primary died before it could checkpoint: trigger a
                # fresh takeover (the standby's crash-supervision path)
                Path(str(state_file) + ".takeover").touch()
                events.append(("takeover-fresh", time.time()))
            # failover: the pre-warmed standby sees the trigger and takes
            # over on its own — just make it the tracked proc
            while "proc" not in sb:
                time.sleep(0.5)
            proc, drain = sb["proc"], sb["drain"]
            t_restarted = time.time()
            events.append(("resumed", time.time()))
            killed = True
        if proc.poll() is not None and time.monotonic() < end_t - 35:
            events.append(("unexpected-exit", time.time(), proc.returncode))
            break

    # the writer ends by itself after its noise tail and the legs drain
    # what it wrote; scanning goes on at the loop's 0.5 s resolution so the
    # last bursts' latencies measure the pipeline, not this wait
    drain_end = time.monotonic() + TAIL_SECONDS + max(15.0, args.minutes)
    while time.monotonic() < drain_end and (
            writer.is_alive() or not set(writer.write_times) <= seen):
        time.sleep(0.5)
        scan_output()
    writer.stop_flag.set()  # only a dead reader can still hold it up
    writer.join(timeout=30)
    procs = {id(proc): proc}
    if "proc" in sb:
        procs.setdefault(id(sb["proc"]), sb["proc"])
    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
    drain.join(timeout=10)
    if "drain" in sb:
        sb["drain"].join(timeout=10)
    scan_output()

    achieved = writer.bytes_written / 4 / max(
        (writer.t_end or time.monotonic()) - writer.t_start, 1e-9)

    # ---- outage accounting (VERDICT r4 #3): the recovery window is
    # [sigterm, first decode from the resumed leg]; every written burst
    # is classified lost-in-outage / lost-outside / decoded, and the
    # outage is reported as its own first-class number
    outage_end = None
    if t_restarted is not None:
        post = [t for s, t in decode_times.items() if t >= t_restarted]
        outage_end = min(post) if post else None
    outage = (round(outage_end - t_sigterm, 1)
              if (t_sigterm and outage_end) else None)

    def in_window(wt):
        # a burst mid-flight when SIGTERM lands is also outage loss
        # (decoders restart in SEARCH): pad the window 2 s backwards
        return (t_sigterm is not None and outage_end is not None
                and t_sigterm - 2.0 <= wt <= outage_end)

    lost_in = lost_out = dec_in = dec_out = 0
    for seq, wt in writer.write_times.items():
        if seq in seen:
            dec_in, dec_out = (dec_in + 1, dec_out) if in_window(wt) \
                else (dec_in, dec_out + 1)
        else:
            lost_in, lost_out = (lost_in + 1, lost_out) if in_window(wt) \
                else (lost_in, lost_out + 1)

    latencies = [decode_times[s] - writer.write_times[s]
                 for s in decode_times if s in writer.write_times]
    lat = sorted(latencies)

    def pct(p):
        return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) if lat else None

    n_written = len(writer.write_times)
    block_s = block_samples / FS
    result = {
        "device": dev,
        "card": card,
        "mem_fraction_per_leg": CHILD_ENV["XLA_PYTHON_CLIENT_MEM_FRACTION"],
        "minutes": args.minutes,
        "offered_msps": FS / 1e6,
        "achieved_msps": round(achieved / 1e6, 4),
        "bursts_written": n_written,
        "bursts_decoded": len(seen),
        "outage_s": outage,
        "bursts_lost_in_outage": lost_in,
        "bursts_lost_outside": lost_out,
        "lost_seqs": sorted(set(writer.write_times) - seen),
        "tail_s": TAIL_SECONDS,
        "decode_pct_outside_outage": round(
            100.0 * dec_out / max(dec_out + lost_out, 1), 2),
        "fifo_reopens": writer.reopens,
        "block_s": round(block_s, 2),
        "latency_s": {"p50": pct(0.5), "p90": pct(0.9), "max": pct(1.0),
                      "n": len(lat)},
        "latency_block_times": {
            "p50": round(pct(0.5) / block_s, 2) if lat else None,
            "p90": round(pct(0.9) / block_s, 2) if lat else None,
        },
        "events": [e[0] for e in events],
        "warmup_s": warm_s,
        "leg_device_warm_s": [
            float(m.group(1)) for m in
            (re.search(r"device warm in ([0-9.]+)s", ln)
             for ln in stderr_lines) if m],
        "kill_resume_ok": killed and state_file.exists(),
        "takeover_fresh": any(e[0] == "takeover-fresh" for e in events),
        "stats_tail": stderr_lines[-6:],
    }
    print(json.dumps(result))
    (wd / "soak_result.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
