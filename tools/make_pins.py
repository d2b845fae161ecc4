#!/usr/bin/env python3
"""Oracle-free regression pins at the flagship point (48 kHz, 10 ms, 64 kbps).

Writes tests/data/pins_48k_64k.npz from the committed material
(material/speech48.wav, material/music48.wav), computed on the CPU:

  pcm     [T, B, N] int16  encoder input, lane b reads MATERIALS[b % 2]
                           from its own seeded offset
  bytes   [T, B, nb] uint8 encoder output (ShardedEncoder.encode_block)
  bfi     [T, B] int32     seeded per-lane loss pattern (~10 % lost)
  clean   [T, B, N] int16  decode_block(bytes), no loss
  lossy   [T, B, N] int16  decode_block(bytes, bfi), advanced PLC
  ari_*   [T*B, ...]       range-decoder integer outputs (ari.decode)

These are regression anchors for this codec's own CPU path, not
conformance: the ETSI oracle decides conformance (docs/CONFORMANCE.md).
tests/test_pins.py checks that the CPU reproduces them exactly; chip_smoke.py
holds the GPU to them within stated tolerances.

The helpers below are the one definition of how the pins are made; the
tests and the chip smoke call them.

Usage: JAX_PLATFORMS=cpu python tools/make_pins.py
"""
from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PINS = REPO / "tests/data/pins_48k_64k.npz"
MATERIALS = ("speech", "music")
LANES = 8
FRAMES = 20
SEED = 20260
LOSS_RATE = 0.1


@functools.cache
def cfg():
    """Flagship point; plc_mode=1 puts the advanced PLC (TD-PLC, Phase
    ECU) on the concealed frames. The encoder ignores plc_mode."""
    from audio_codec_tpu.config import Config
    return Config(fs_in=48000, bitrate=64000, plc_mode=1)


@functools.cache
def _material(name: str) -> np.ndarray:
    from audio_codec_tpu.utils import wavio
    pcm, fs = wavio.read_wav(REPO / f"material/{name}48.wav")
    assert fs == 48000 and pcm.shape[1] == 1, (fs, pcm.shape)
    return pcm[:, 0].astype(np.int16)


def material_pcm(n_lanes: int, n_frames: int, seed: int) -> np.ndarray:
    """[T, B, N] int16: lane b reads MATERIALS[b % 2] from a seeded offset."""
    N = cfg().frame_length
    rng = np.random.default_rng(seed)
    out = np.empty((n_frames, n_lanes, N), np.int16)
    span = n_frames * N
    for b in range(n_lanes):
        src = _material(MATERIALS[b % 2])
        off = int(rng.integers(0, len(src) - span))
        out[:, b, :] = src[off:off + span].reshape(n_frames, N)
    return out


def loss_pattern(n_frames: int, n_lanes: int, seed: int,
                 rate: float = LOSS_RATE) -> np.ndarray:
    """[T, B] int32 bfi: 1 where the lane-frame is lost."""
    rng = np.random.default_rng(seed + 1)
    return (rng.random((n_frames, n_lanes)) < rate).astype(np.int32)


def encode(pcm: np.ndarray, device) -> np.ndarray:
    """[T, B, N] PCM -> [T, B, nb] uint8 through the block API on one
    device."""
    import jax
    from audio_codec_tpu.parallel import engine as pe
    from audio_codec_tpu.parallel import mesh as pm
    mesh = pm.stream_mesh([device])
    enc = pe.ShardedEncoder(cfg(), pcm.shape[1], mesh)
    x = jax.device_put(pcm.astype(np.float32), device)
    return np.asarray(enc.encode_block(x))


@functools.cache
def _decode_fn():
    import jax
    from audio_codec_tpu.models import decoder as dec_m
    c = cfg()

    @jax.jit
    def run(st, frames, bfi):
        _, y = dec_m.decode_block(c, st, frames, bfi)
        return dec_m.round_pcm(y)
    return run


def decode(frames: np.ndarray, bfi: np.ndarray, device) -> np.ndarray:
    """[T, B, nb] bytes + [T, B] bfi -> [T, B, N] int16 via decode_block."""
    import jax
    from audio_codec_tpu.models import state as S
    st = jax.device_put(S.dec_state_init(cfg(), frames.shape[1]), device)
    f = jax.device_put(frames.astype(np.int32), device)
    b = jax.device_put(bfi.astype(np.int32), device)
    return np.asarray(_decode_fn()(st, f, b))


@functools.cache
def _entropy_fn():
    import jax
    from audio_codec_tpu.models import decoder as dec_m
    c = cfg()
    return jax.jit(lambda fr: dec_m.decode_entropy(c, fr)[1])


def range_decode(frames: np.ndarray, device) -> dict[str, np.ndarray]:
    """Integer range-decoder outputs over the flattened [T*B] frames."""
    import jax
    T_, B, nb = frames.shape
    f = jax.device_put(frames.reshape(T_ * B, nb).astype(np.int32), device)
    return {k: np.asarray(v) for k, v in _entropy_fn()(f).items()}


def make(device) -> dict[str, np.ndarray]:
    pcm = material_pcm(LANES, FRAMES, SEED)
    bfi = loss_pattern(FRAMES, LANES, SEED)
    frames = encode(pcm, device)
    out = dict(pcm=pcm, bytes=frames, bfi=bfi,
               clean=decode(frames, np.zeros_like(bfi), device),
               lossy=decode(frames, bfi, device))
    out.update({f"ari_{k}": v
                for k, v in range_decode(frames, device).items()})
    return out


def load() -> dict[str, np.ndarray]:
    with np.load(PINS) as z:
        return {k: z[k] for k in z.files}


def main() -> int:
    import jax
    cpu = jax.devices("cpu")[0]
    pins = make(cpu)
    for m, name in enumerate(MATERIALS):
        lost = int(pins["bfi"][:, m::2].sum())
        assert lost > 0, f"{name}: the loss pattern loses no frame"
    PINS.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PINS, **pins)
    print(f"wrote {PINS.relative_to(REPO)} ({PINS.stat().st_size} bytes, "
          f"{int(pins['bfi'].sum())} of {pins['bfi'].size} lane-frames lost)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
