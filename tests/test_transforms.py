import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_codec_tpu import tables as T
from audio_codec_tpu.config import Config
from audio_codec_tpu.ops import transforms
from tests import oracle

# DCT-IV accuracy against a float64 product of the same f32 operands, in
# ulp of the largest output. The compensated CPU branch stays within 2 ulp
# (measured 0.4 at N=80..960); the plain f32 product (every other device)
# within 2^-18 of max|ref| (measured 2-6e-7, 2-5 ulp), while TF32 operands
# (10-bit mantissa) land near 2^-11, so the same bound shows that the GPU
# product runs in true f32.
COMP_ULP = 2
PLAIN_TOL = 2.0 ** -18


def _dct_case(n: int, b: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    folded = (rng.standard_normal((b, n)) * 3000.0).astype(np.float32)
    Mt = np.asarray(T.dct4_matrix(n), np.float32).T.copy()
    ref = folded.astype(np.float64) @ Mt.astype(np.float64)
    return folded, Mt, ref


def _on(device, fn, *args):
    return np.asarray(jax.jit(fn)(*(jax.device_put(a, device) for a in args)))


@pytest.mark.parametrize("n", [80, 480, 960])
def test_dct4_cpu_branch_within_few_ulp(n):
    folded, Mt, ref = _dct_case(n)
    cpu = jax.devices("cpu")[0]
    got = _on(cpu, transforms._dct4_apply, folded, Mt)
    # the CPU took the compensated branch ...
    np.testing.assert_array_equal(
        got, _on(cpu, transforms._dct4_compensated, folded, Mt))
    # ... which is within a few ulp of the largest output
    ulp = float(np.spacing(np.float32(np.abs(ref).max())))
    assert np.abs(got - ref).max() <= COMP_ULP * ulp


@pytest.mark.parametrize("n", [80, 480, 960])
def test_dct4_plain_product_within_tolerance(n):
    folded, Mt, ref = _dct_case(n)
    got = _on(jax.devices("cpu")[0], transforms._dct4_plain, folded, Mt)
    assert np.abs(got - ref).max() <= PLAIN_TOL * np.abs(ref).max()


@pytest.mark.gpu
def test_dct4_gpu_takes_plain_f32_branch(gpu_device):
    assert jax.config.jax_default_matmul_precision == "highest"
    folded, Mt, ref = _dct_case(480)
    got = _on(gpu_device, transforms._dct4_apply, folded, Mt)
    np.testing.assert_array_equal(
        got, _on(gpu_device, transforms._dct4_plain, folded, Mt))
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= PLAIN_TOL, f"relative error {err:.2e}: TF32 products?"


@pytest.mark.gpu
def test_gpu_matmul_precision_is_f32(gpu_device):
    """Every dense product of the codec (SNS, analysis, PLC, transforms)
    inherits the package-wide precision: a plain f32 product on the GPU
    holds the f32 bound, not TF32's."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((256, 960)).astype(np.float32)
    b = rng.standard_normal((960, 256)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = _on(gpu_device, jnp.dot, a, b)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= PLAIN_TOL, f"relative error {err:.2e}: TF32 products?"


def test_mdct_matches_oracle_16k():
    cfg = Config(fs_in=16000, bitrate=32000)
    dumps, _ = oracle.enc_dumps("thetest16", 32000)
    x = oracle.frames(dumps, "enc_in", cfg.frame_length)
    gold = oracle.frames(dumps, "enc_mdct", cfg.frame_length)
    n = 50
    mem = jnp.zeros((1, cfg.frame_length - cfg.la_zeroes), jnp.float32)
    for f in range(n):
        d, mem = transforms.mdct(cfg, jnp.asarray(x[f][None]), mem)
        scale = np.abs(gold[f]).max() + 1e-9
        err = np.abs(np.asarray(d[0]) - gold[f]).max() / scale
        assert err < 2e-6, (f, err)
