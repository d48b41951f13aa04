"""The checks ``chip_smoke.py`` runs on the card, run here on the CPU at
small lengths: tier-vs-reference numerics at every width, the seeded
captures and what they decode to, and the HLO route reader."""

import numpy as np
import pytest

from tsl_sdr_tpu.testing import numerics, pager_capture


@pytest.mark.parametrize("width", numerics.WIDTHS, ids=lambda w: w.name)
def test_channelizer_tiers_match_references(width):
    r = numerics.check_channelizer(width, 120_000, seed=3)
    assert r["exact_equal"], r
    assert r["production_ok"], r
    assert r["outputs"] >= width.nr_channels * (120_000 // width.decimation
                                               - 64)


def test_resampler_tiers_match_references():
    r = numerics.check_resampler(200_000, seed=3)
    assert r["exact_equal"] and r["production_ok"], r
    assert r["max_lsb"] <= 0.5  # float acc/2^14 vs round-half-up Q.14


def test_lsb_agreement_counts_pi_wrap_as_adjacent():
    got = np.array([[0, 32767, -32768, 5]], np.int16)
    want = np.array([[0, -32768, 32767, 7]], np.int16)
    a = numerics.lsb_agreement(got, want, skip=0)
    assert a == {"n": 4, "max_lsb": 2.0, "within_1": 0.75}
    assert numerics.lsb_ok(a) is False  # 75 % within 1 LSB
    assert numerics.lsb_agreement(got, want, skip=0,
                                  wrap=False)["max_lsb"] == 65535.0


def test_float64_reference_tracks_a_clean_fm_tone():
    """The float64 reference recovers the tone an FM carrier carries."""
    fs, d = 256_000, 16
    t = np.arange(64_000) / fs
    ph = 2 * np.pi * 20_000 * t + (3_000 / 500) * np.sin(2 * np.pi * 500 * t)
    x = (np.stack([np.cos(ph), np.sin(ph)], -1) * 8000).astype(np.int16)
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    pcm = numerics.float64_pcm(x, firdes_low_pass(1.0, fs, 8_000, 4_000),
                               [20_000], fs, d)[0].astype(float)
    f = np.fft.rfftfreq(pcm.size, d / fs)[
        np.abs(np.fft.rfft(pcm - pcm.mean())).argmax()]
    assert abs(f - 500) < 5


def test_pager_capture_is_deterministic():
    a, ea = pager_capture.pager_capture(3.0, seed=11)
    b, eb = pager_capture.pager_capture(3.0, seed=11)
    c, _ = pager_capture.pager_capture(3.0, seed=12)
    assert a.dtype == np.int16 and a.shape == (int(3.0 * 1_228_800), 2)
    assert np.array_equal(a, b) and ea == eb
    assert not np.array_equal(a, c)


def _decode(cfg, iq):
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.utils.jsonout import message_to_json

    specs = [ChannelSpec(c["chanCenterFreq"], c.get("protocol", "pcm"))
             for c in cfg["channels"]]
    pipe = ReceivePipeline(cfg["lpfTaps"], cfg["centerFreqHz"],
                           cfg["sampleRateHz"], cfg["decimationFactor"],
                           specs)
    res = pipe.process_capture(iq)
    lines = [message_to_json(m, freq_hz=s.center_freq_hz)
             for s, r in zip(specs, res) if s.protocol != "pcm" for m in r]
    return pager_capture.messages_from_json(lines), res


def test_pager_capture_decodes_every_message_and_nothing_else():
    """The example pager deployment at its own widths (577 taps, D32)."""
    cfg = pager_capture.load_config()
    iq, expected = pager_capture.pager_capture(8.0, seed=5, cfg=cfg)
    assert {p for p, *_ in expected} == {"flex", "pocsag"}
    got, res = _decode(cfg, iq)
    assert got == expected
    pcm = res[2].astype(float)
    rate = cfg["sampleRateHz"] / cfg["decimationFactor"]
    f = np.fft.rfftfreq(pcm.size, 1 / rate)[
        np.abs(np.fft.rfft(pcm - pcm.mean())).argmax()]
    assert abs(f - 1000) < 5


def test_pocsag_capture_on_the_8ch_plan_decodes():
    cfg = pager_capture.load_config(pager_capture.MULTIFM_8CH_CONFIG)
    for ch in cfg["channels"]:
        ch["protocol"] = "pocsag"
    iq, expected = pager_capture.pocsag_capture(cfg, 6.0, seed=2)
    assert len(expected) == 8
    got, _ = _decode(cfg, iq)
    assert got == expected


def test_fm_tone_capture_channels_carry_their_tones():
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.utils.config import MultifmConfig

    raw = pager_capture.load_config(pager_capture.MULTIFM_8CH_CONFIG)
    iq = pager_capture.fm_tone_capture(raw, 1.0, seed=1)
    cfg = MultifmConfig.from_dict(raw)
    pcm = MultifmChain.from_config(cfg, exact=False).process_array(iq)
    rate = cfg.sample_rate_hz / cfg.decimation_factor
    for i, row in enumerate(pcm):
        row = row[100:].astype(float)
        f = np.fft.rfftfreq(row.size, 1 / rate)[
            np.abs(np.fft.rfft(row - row.mean())).argmax()]
        assert abs(f - (500 + 125 * i)) < 5, (i, f)


def test_dot_routes_reads_an_optimized_module():
    import jax
    import jax.numpy as jnp

    from tsl_sdr_tpu.utils.profiling import dot_routes

    def f(a, b):
        return jnp.dot(a, b, preferred_element_type=jnp.int32)

    hlo = jax.jit(f).lower(jnp.zeros((64, 640), jnp.int16),
                           jnp.zeros((640, 128), jnp.int16)).compile(
    ).as_text()
    routes = dot_routes(hlo)
    assert len(routes) == 1
    assert routes[0]["op"] == "dot"
    assert routes[0]["types"][0] == "s32[64,128]"
    assert len(routes[0]["types"]) == 3


def test_dot_routes_names_each_route():
    from tsl_sdr_tpu.utils.profiling import dot_routes

    hlo = """HloModule m

%wrapped_dot_computation (p0: s32[8,4], p1: s32[4,2]) -> s32[8,2] {
  %p0 = s32[8,4]{1,0} parameter(0)
  %p1 = s32[4,2]{1,0} parameter(1)
  ROOT %dot.1 = s32[8,2]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}
}

%triton_gemm_c (p0: bf16[8,4], p1: bf16[4,2]) -> f32[8,2] {
  %p0 = bf16[8,4]{1,0} parameter(0)
  %p1 = bf16[4,2]{1,0} parameter(1)
  ROOT %dot.2 = f32[8,2]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}
}

%fused_reduce (p0: s32[8,4,2]) -> s32[8,2] {
  %p0 = s32[8,4,2]{2,1,0} parameter(0)
  %c = s32[] constant(0)
  ROOT %reduce.4 = s32[8,2]{1,0} reduce(%p0, %c), dimensions={1}, to_apply=%add, metadata={op_name="jit(f)/dot_general"}
}

ENTRY %main (a: s32[8,4], b: s32[4,2], x: bf16[8,4], y: bf16[4,2], z: f32[8,4], w: f32[4,2], r: s32[8,4,2]) -> s32[8,2] {
  %a = s32[8,4]{1,0} parameter(0)
  %b = s32[4,2]{1,0} parameter(1)
  %x = bf16[8,4]{1,0} parameter(2)
  %y = bf16[4,2]{1,0} parameter(3)
  %z = f32[8,4]{1,0} parameter(4)
  %w = f32[4,2]{1,0} parameter(5)
  %r = s32[8,4,2]{2,1,0} parameter(6)
  %f1 = s32[8,2]{1,0} fusion(%a, %b), kind=kLoop, calls=%wrapped_dot_computation
  %f2 = f32[8,2]{1,0} fusion(%x, %y), kind=kCustom, calls=%triton_gemm_c, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
  %g = (f32[8,2]{1,0}, s8[0]{0}) custom-call(%z, %w), custom_call_target="__cublas$gemm"
  ROOT %f3 = s32[8,2]{1,0} fusion(%r), kind=kInput, calls=%fused_reduce
}
"""
    by_comp = {r["computation"]: r for r in dot_routes(hlo)}
    assert by_comp["wrapped_dot_computation"]["route"] == "kLoop fusion"
    assert by_comp["wrapped_dot_computation"]["types"] == [
        "s32[8,2]", "s32[8,4]", "s32[4,2]"]
    assert by_comp["triton_gemm_c"]["route"] == "Triton GEMM fusion"
    assert by_comp["main"]["route"] == "library call __cublas$gemm"
    assert by_comp["fused_reduce"]["route"] == (
        "multiply+reduce in kInput fusion")
