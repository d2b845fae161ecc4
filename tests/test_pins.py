"""Oracle-free regression pins (tools/make_pins.py): the CPU reproduces the
committed flagship-point bitstreams, range-decoder integers and decoded PCM
exactly. These anchor the codec against its own verified CPU output, not
against the ETSI oracle (docs/CONFORMANCE.md decides conformance)."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from tools import make_pins as P


@pytest.fixture(scope="module")
def pins():
    return P.load()


@pytest.fixture(scope="module")
def cpu_run(pins):
    cpu = jax.devices("cpu")[0]
    frames, bfi = pins["bytes"], pins["bfi"]
    return dict(bytes=P.encode(pins["pcm"], cpu),
                clean=P.decode(frames, np.zeros_like(bfi), cpu),
                lossy=P.decode(frames, bfi, cpu))


def test_pin_inputs_regenerate_from_material(pins):
    np.testing.assert_array_equal(
        P.material_pcm(P.LANES, P.FRAMES, P.SEED), pins["pcm"])
    np.testing.assert_array_equal(
        P.loss_pattern(P.FRAMES, P.LANES, P.SEED), pins["bfi"])
    for m in range(len(P.MATERIALS)):   # every material has concealed frames
        assert pins["bfi"][:, m::len(P.MATERIALS)].sum() > 0


@pytest.mark.parametrize("loss", ["clean", "lossy"])
@pytest.mark.parametrize("material", P.MATERIALS)
def test_cpu_reproduces_pins(pins, cpu_run, material, loss):
    lanes = slice(P.MATERIALS.index(material), None, len(P.MATERIALS))
    np.testing.assert_array_equal(cpu_run["bytes"][:, lanes],
                                  pins["bytes"][:, lanes])
    np.testing.assert_array_equal(cpu_run[loss][:, lanes],
                                  pins[loss][:, lanes])


def test_range_decoder_reproduces_pins(pins):
    got = P.range_decode(pins["bytes"], jax.devices("cpu")[0])
    assert sorted(f"ari_{k}" for k in got) == sorted(
        k for k in pins if k.startswith("ari_"))
    for k, v in got.items():
        np.testing.assert_array_equal(v, pins[f"ari_{k}"], err_msg=k)
