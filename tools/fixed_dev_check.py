#!/usr/bin/env python3
"""Device fixed-decoder equivalence check (runs under jax_enable_x64).

Decodes real fixed-oracle bitstreams with BOTH the host FixedDecoder (the
MD5-gate decoder, verified against testvec/md5_dec.txt) and the batched
DeviceFixedDecoder, and requires bit-identical PCM. Invoked as a
subprocess by tests/test_fixed_dev.py (x64 is process-global, like the
multihost workers).

Usage: python tools/fixed_dev_check.py [n_frames] [point ...]
Prints one line per point: "<wav>@<bitrate> OK|MISMATCH n=<count>".
Exit code 0 iff all points match.
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from audio_codec_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

# the MD5-gate operating points (testvec/Readme.txt:25-36), clean half
POINTS = [("thetest8", 8000, 32000), ("thetest16", 16000, 32000),
          ("thetest24", 24000, 48000), ("thetest32", 32000, 64000),
          ("thetest44", 44100, 64000), ("thetest48", 48000, 64000)]


def main() -> int:
    import oracle
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.fixed_decoder import FixedDecoder
    from audio_codec_tpu.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_tpu.utils import bitstream_io as bio

    nf = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    sel = sys.argv[2:] or [p[0] for p in POINTS]
    rc = 0
    for wav, fs, br in POINTS:
        if wav not in sel:
            continue
        bs = oracle.fx_encode(wav, br)
        _, frames = bio.read_all(bs)
        cfg = Config(fs_in=fs, bitrate=br)
        fr = np.stack([np.frombuffer(f, np.uint8)
                       for f in frames[:nf]])
        pcm_h = FixedDecoder(cfg).decode(fr)
        dev = DeviceFixedDecoder(cfg, B=1)
        pcm_d = dev.decode_block(fr[:, None, :])[:, 0, :]
        if np.array_equal(pcm_h, pcm_d):
            print(f"{wav}@{br} OK ({len(fr)} frames)")
        else:
            n = int(np.sum(pcm_h != pcm_d))
            print(f"{wav}@{br} MISMATCH n={n}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
