"""Card-only checks: the smoke's numerics at full widths on the GPU.

Thin wrappers over :mod:`tsl_sdr_tpu.testing.numerics` (the same functions
the CPU tests run at small lengths). Run them on the card with
``TSL_TESTS_ON_GPU=1 python -m pytest -m gpu tests/test_gpu.py``; anywhere
else the ``gpu`` fixture skips them.
"""

import pytest

from tsl_sdr_tpu.testing import numerics

FULL = 4_194_304


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: TSL_TESTS_ON_GPU=1 python -m pytest -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("width", numerics.WIDTHS, ids=lambda w: w.name)
def test_channelizer_tiers_on_card(gpu, width):
    r = numerics.check_channelizer(width, FULL)
    assert r["exact_equal"] and r["production_ok"], r


@pytest.mark.gpu
def test_resampler_tiers_on_card(gpu):
    r = numerics.check_resampler(FULL)
    assert r["exact_equal"] and r["production_ok"], r
