"""The device decision, the compile cache, the peak table, and the removed
backend switches."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from tsl_sdr_tpu.utils import device, roofline


def test_require_gpu_raises_without_gpu():
    """A measurement path that finds no GPU fails; it never falls back."""
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(device.NoAcceleratorError, match="no GPU"):
        device.require_gpu()


def test_device_summary_reports_jax_devices():
    s = device.device_summary()
    assert s == {"platform": jax.devices()[0].platform,
                 "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_enable_compile_cache(env_dir, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set no directory is set in code;
    otherwise the cache goes to the fixed .jax_cache/ at the checkout."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = device.CHECKOUT_ROOT / ".jax_cache"
    else:
        want = tmp_path / env_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(want))
    assert device.enable_compile_cache() == want
    assert device.compile_cache_dir() == want
    if env_dir is None:
        assert updates["jax_compilation_cache_dir"] == str(want)
    else:
        assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.5


def test_default_cache_dir_is_ignored_by_git():
    root = device.CHECKOUT_ROOT
    assert device.DEFAULT_CACHE_DIR == root / ".jax_cache"
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_peak_table_has_the_h100():
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert (p.bf16, p.int8, p.tf32, p.f32, p.hbm_bytes) == (
        989e12, 1979e12, 495e12, 67e12, 3.35e12)
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB",
                                  "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks_for(kind)


def test_channelizer_bound_from_peaks():
    """8ch/128 taps/D40: 102.4 useful MACs and 4.4 bytes per sample; at
    H100 int8 peaks the HBM bound (3.35e12 / 4.4 B) is the limiter."""
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    b = roofline.channelizer(8, 128, 40, p)
    assert b.compute_msps == pytest.approx(1979e12 / 2 / 102.4 / 1e6)
    assert b.hbm_msps == pytest.approx(3.35e12 / 4.4 / 1e6)
    assert b.limiter == "HBM" and b.sol_msps == b.hbm_msps
    r = roofline.resampler(821, 16, 25, p, rate="f32")
    assert r.compute_msps == pytest.approx(67e12 / 2 / (16 / 25 * 52) / 1e6)


def _lpf():
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    return firdes_low_pass(1.0, 128_000, 12_000, 8_000)[:33]


@pytest.mark.parametrize("build", ["multifm", "resampler", "pipeline"])
def test_backend_argument_is_gone(build):
    """One production path per stage: there is no backend to choose."""
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.models.resampler import ResamplerChain

    with pytest.raises(TypeError, match="backend"):
        if build == "multifm":
            MultifmChain(_lpf(), [8_000], 128_000, 4, exact=False,
                         backend="xla")
        elif build == "resampler":
            ResamplerChain(np.ones(33), 16, 25, exact=False, backend="xla")
        else:
            ReceivePipeline(_lpf(), 929_500_000, 153_600, 4,
                            [ChannelSpec(929_500_000, "pocsag")],
                            backend="xla")


@pytest.mark.parametrize("cli", ["pipeline", "multifm"])
def test_backend_option_is_rejected(cli, tmp_path, capsys):
    from tsl_sdr_tpu.cli import multifm, pipeline

    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"sampleRateHz": 1}))
    main = pipeline.main if cli == "pipeline" else multifm.main
    with pytest.raises(SystemExit) as e:
        main([str(cfg), "--backend", "xla"])
    assert e.value.code == 2
    assert "--backend" in capsys.readouterr().err


@pytest.mark.parametrize("env,config,cpu", [
    ("", None, False),        # nothing set: JAX picks the accelerator
    ("cpu", None, True),
    ("", "cpu", True),        # jax.config.update('jax_platforms', 'cpu')
    ("cuda", None, False),
    ("CPU,cuda", None, True),
])
def test_multihost_selects_gloo_only_on_cpu(env, config, cpu):
    from tsl_sdr_tpu.parallel.multihost import selects_cpu

    assert selects_cpu(env, config) is cpu


def test_no_module_picks_interpret_mode_or_old_platform():
    """No kernel decides interpret mode from the device, no code path
    branches on the old accelerator's platform name, and no version shim
    for an uninstalled JAX remains."""
    import re

    pkg = Path(device.__file__).resolve().parents[1]
    # assembled from parts so this file does not match its own search
    old = "t" + "pu"
    bad = re.compile("|".join([
        rf"pallas\.{old}", f"pl{old}", f"_is_{old}",
        rf"platform ?== ?.{old}.", r"interpret ?= ?not",
        r"experimental\.shard_map", "check" + "_rep"]))
    hits = [f"{p.relative_to(pkg)}:{i}"
            for p in sorted(pkg.rglob("*.py"))
            for i, ln in enumerate(p.read_text().splitlines(), 1)
            if bad.search(ln)]
    assert hits == []
