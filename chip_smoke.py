#!/usr/bin/env python3
"""Chip smoke: the float LC3plus serving path once on a GPU, checked.

Default run, one GPU, one process holding the card:

  device     nvidia-smi name and power limit; `pytest -m gpu` as a child
             before this process touches JAX; then a GPU must be JAX's
             device, and matmul precision must be "highest" (f32, no TF32)
  served     engine.StreamEncoder/StreamDecoder, 48 kHz / 10 ms / 64 kbps,
             4096 streams x 20 frames of material, two frames lost
  block      parallel.engine.ShardedEncoder.encode_block (T=32, B=4096) on a
             1-device mesh, bytes equal to the served path; decode_block
             with a seeded ~10 % per-lane loss pattern and advanced PLC
  cli        audio_codec_tpu.cli encode + decode of material/speech48.wav
  pins       the GPU against the committed CPU pins (tools/make_pins.py):
             pinned bytes decode to the pinned PCM within 1 LSB on clean
             frames and >= 14 RMS bits (tools/conformance.py rms_metric) on
             all frames, concealed ones included; range-decoder integers
             identical; GPU-encoded bytes decode to >= 14 RMS bits against
             the pinned PCM (byte equality is reported, not required: the
             GPU sums the DCT-IV in another order than the CPU's
             compensated product, which can flip quantizer ties)

Options run only their own path:
  --four       the 4-GPU stream mesh against the 1-GPU engine, bit for bit,
               and a ring migration of stream state over the 4 GPUs
  --fixed-dev  DeviceFixedDecoder (x64) against the host FixedDecoder,
               bit-exact, with its compile time

Timings printed here are smoke readings, not benchmark metrics. The last
line of standard output is one JSON object naming the device; the script
exits non-zero, without that line, when any phase fails or no GPU is found.

Usage: python chip_smoke.py [--four | --fixed-dev]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CH_STREAMS = 4096      # streams per card
SERVED_FRAMES = 20
BLOCK_FRAMES = 32
LOST_FRAMES = (7, 13)  # served path: every lane loses these frames
SEED = 7
RMS_BITS = 14          # conformance criterion (docs/CONFORMANCE.md)
CLEAN_LSB = 1          # max |PCM difference| GPU vs CPU on clean frames
# Waveform SNR of decoded vs input audio only catches output unrelated to
# the input (<= 0 dB): noise filling keeps a perceptual codec's waveform SNR
# low on noisy material (speech48.wav at 64 kbps: 6.3 dB on the CPU).
SNR_DB_MIN = 3.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        say(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            say(f"== {self.name}: ok ({time.perf_counter() - self.t0:.1f} s)")
        return False


# ---------------------------------------------------------------- device

def preflight() -> None:
    """Everything that must happen before this process imports JAX."""
    check((REPO / "audio_codec_tpu").is_dir(),
          f"no audio_codec_tpu/ beside {Path(__file__).name}: run it from "
          "a checkout of the repository")
    plat = os.environ.get("JAX_PLATFORMS", "")
    check(not plat or "cuda" in plat or "gpu" in plat,
          f"no GPU: JAX_PLATFORMS={plat!r} excludes the GPU")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True)
    check(r.returncode == 0 and r.stdout.strip(),
          f"no GPU: nvidia-smi failed: {r.stderr.strip()}")
    for line in r.stdout.strip().splitlines():
        say(f"card: {line}")


def gpu_tests() -> None:
    """The gpu-marked tests, in a child process, while the parent holds no
    JAX backend (one process per card)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu", "tests/",
                        "-q", "-p", "no:cacheprovider"],
                       cwd=REPO, env=env, capture_output=True, text=True)
    tail = "\n".join(r.stdout.strip().splitlines()[-15:])
    say(tail)
    check(r.returncode == 0, f"pytest -m gpu exited {r.returncode}:\n"
          f"{r.stderr[-3000:]}")
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    check(" passed" in last and "skipped" not in last,
          f"pytest -m gpu ran no test on the GPU: {last!r}")


def jax_device(n_cards: int):
    import jax
    from audio_codec_tpu.utils.compile_cache import enable_compile_cache
    say(f"compile cache: {enable_compile_cache()}")
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's device is {devs[0].platform} ({devs[0].device_kind})")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    import audio_codec_tpu  # noqa: F401  (sets the matmul precision)
    prec = jax.config.jax_default_matmul_precision
    say(f"jax_default_matmul_precision = {prec}")
    check(prec == "highest", f"matmul precision {prec!r}, want 'highest'")
    return devs


# ------------------------------------------------------------------ paths

def _snr_db(ref, out, cfg, n_frames):
    """Median over lanes of the decoded SNR against the input, aligned by
    the codec delay, over the first n_frames."""
    import numpy as np
    D = cfg.frame_length - 2 * cfg.la_zeroes
    L = n_frames * cfg.frame_length
    x = ref[:, :L - D].astype(np.float64)
    y = out[:, D:L].astype(np.float64)
    px, pe = np.sum(x * x, 1), np.sum((x - y) ** 2, 1)
    keep = px > 0                    # a silent lane has no SNR
    return float(np.median(10 * np.log10(px[keep] / np.maximum(pe[keep], 1e-9))))


def served_path(dev):
    import numpy as np
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.engine import StreamDecoder, StreamEncoder
    from tools import make_pins as P

    cfg = Config(fs_in=48000, bitrate=64000)
    B, T = CH_STREAMS, SERVED_FRAMES
    pcm = P.material_pcm(B, BLOCK_FRAMES, SEED)
    enc = StreamEncoder(cfg, B)
    dec = StreamDecoder(cfg, B)
    payloads, out, t_enc, t_dec = [], [], [], []
    for f in range(T):
        t0 = time.perf_counter()
        p = enc.encode(pcm[f])
        t_enc.append(time.perf_counter() - t0)
        check(len(p) == B and all(len(b) == cfg.targetBytes for b in p),
              "served encode: wrong payload count or size")
        payloads.append(np.frombuffer(b"".join(p), np.uint8).reshape(B, -1))
        t0 = time.perf_counter()
        y = (dec.decode(b"", bfi=1) if f in LOST_FRAMES
             else dec.decode(b"".join(p)))
        t_dec.append(time.perf_counter() - t0)
        check(y.shape == (B, cfg.frame_length) and y.dtype == np.int16,
              f"served decode: shape {y.shape} dtype {y.dtype}")
        check(np.array_equal(dec.last_bfi != 0, np.full(B, f in LOST_FRAMES)),
              f"served decode: frame {f} concealed on the wrong lanes")
        out.append(y)
    out = np.stack(out)
    ref = pcm[:T].transpose(1, 0, 2).reshape(B, -1)
    got = out.transpose(1, 0, 2).reshape(B, -1)
    snr = _snr_db(ref, got, cfg, min(LOST_FRAMES))
    say(f"served: {B} streams x {T} frames, {len(LOST_FRAMES)} frames lost "
        f"on every lane; median SNR before the first loss {snr:.2f} dB")
    say(f"served (smoke reading): encode first step {t_enc[0]:.2f} s "
        f"(compile), median step {statistics.median(t_enc[1:]) * 1e3:.2f} ms; "
        f"decode first step {t_dec[0]:.2f} s, median step "
        f"{statistics.median(t_dec[1:]) * 1e3:.2f} ms")
    check(snr > SNR_DB_MIN, f"served: median SNR {snr:.2f} dB")
    return pcm, np.stack(payloads), out


def block_path(dev, pcm, served_bytes, served_pcm):
    import jax
    import numpy as np
    from audio_codec_tpu.models import decoder as dec_m
    from audio_codec_tpu.models import state as S
    from audio_codec_tpu.parallel import engine as pe
    from audio_codec_tpu.parallel import mesh as pm
    from tools import make_pins as P

    cfg = P.cfg()   # 48 kHz / 64 kbps with plc_mode=1
    B, T = CH_STREAMS, BLOCK_FRAMES
    enc = pe.ShardedEncoder(cfg, B, pm.stream_mesh([dev]))
    x = jax.device_put(pcm.astype(np.float32), dev)
    t0 = time.perf_counter()
    frames = np.asarray(enc.encode_block(x))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(enc.encode_block(x))
    t_enc = time.perf_counter() - t0
    n = served_bytes.shape[0]
    same = frames[:n] == served_bytes
    eq = float(np.mean(np.all(same, axis=-1)))
    say(f"block: encode_block T={T} B={B}; first {n} frames equal to the "
        f"served path on {eq:.4%} of lane-frames")
    check(eq == 1.0, "block bytes differ from the served path")

    bfi = P.loss_pattern(T, B, SEED)
    st = jax.device_put(S.dec_state_init(cfg, B), dev)
    run = jax.jit(lambda s, f, b: dec_m.round_pcm(dec_m.decode_block(cfg, s, f, b)[1]))
    t0 = time.perf_counter()
    y = np.asarray(run(st, jax.device_put(frames.astype(np.int32), dev),
                       jax.device_put(bfi, dev)))
    t_dfirst = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(run(st, jax.device_put(frames.astype(np.int32), dev),
                   jax.device_put(bfi, dev)))
    t_dec = time.perf_counter() - t0
    check(y.shape == (T, B, cfg.frame_length), f"decode_block shape {y.shape}")
    # before any loss on the lane (its own pattern and the served path's
    # lost frames), block and served decode run the same frames from the
    # same state
    first_loss = np.where(bfi.any(0), bfi.argmax(0), T)
    upto = np.minimum(first_loss, min(LOST_FRAMES))
    mask = np.arange(n)[:, None] < upto[None, :]
    d = np.abs(y[:n].astype(np.int32) - served_pcm.astype(np.int32))
    dmax = int(d[mask].max())
    say(f"block: decode_block T={T} B={B}, {int(bfi.sum())} of {bfi.size} "
        f"lane-frames lost (advanced PLC); before the first loss max |PCM - "
        f"served PCM| = {dmax} LSB over {int(mask.sum())} lane-frames")
    check(dmax <= CLEAN_LSB, f"block decode differs from served by {dmax} LSB")
    say(f"block (smoke reading): encode_block first call {t_first:.2f} s "
        f"(compile), second {t_enc * 1e3:.1f} ms = {t_enc / T * 1e3:.2f} ms/frame; "
        f"decode_block first {t_dfirst:.2f} s, second {t_dec * 1e3:.1f} ms "
        f"= {t_dec / T * 1e3:.2f} ms/frame")


def cli_path():
    import numpy as np
    from audio_codec_tpu import cli
    from audio_codec_tpu.utils import bitstream_io as bio
    from audio_codec_tpu.utils import wavio

    wav = REPO / "material/speech48.wav"
    with tempfile.TemporaryDirectory() as td:
        bin_path, out_wav = Path(td) / "s.bin", Path(td) / "s.wav"
        t0 = time.perf_counter()
        check(cli.main(["-q", "-E", str(wav), str(bin_path), "64000"]) == 0,
              "cli -E failed")
        t_e = time.perf_counter() - t0
        with open(bin_path, "rb") as fh:
            h = bio.read_header(fh)
        check((h.samplerate, h.bitrate, h.channels) == (48000, 64000, 1),
              f"cli header {h}")
        t0 = time.perf_counter()
        check(cli.main(["-q", "-D", str(bin_path), str(out_wav)]) == 0,
              "cli -D failed")
        t_d = time.perf_counter() - t0
        x, _ = wavio.read_wav(wav)
        y, fs = wavio.read_wav(out_wav)
    # the decoder trims the codec delay (-dc 1), so output aligns with input
    # and ends short of it by that delay
    check(fs == 48000 and y.shape[1] == 1 and 0 < len(x) - len(y) < 480,
          f"cli output {y.shape} for input {x.shape}")
    x, y = x[:len(y), 0].astype(np.float64), y[:, 0].astype(np.float64)
    snr = 10 * np.log10(np.sum(x * x) / np.sum((x - y) ** 2))
    say(f"cli: {h.signal_len} samples, header {h.samplerate} Hz "
        f"{h.bitrate} bit/s; decoded SNR {snr:.2f} dB; (smoke reading) "
        f"encode {t_e:.1f} s, decode {t_d:.1f} s, compile included")
    check(snr > SNR_DB_MIN, f"cli SNR {snr:.2f} dB")


def pins_check(dev):
    import numpy as np
    from tools import make_pins as P
    from tools.conformance import rms_metric

    pins = P.load()
    frames, bfi = pins["bytes"], pins["bfi"]
    ari = P.range_decode(frames, dev)
    for k, v in ari.items():
        check(np.array_equal(v, pins[f"ari_{k}"]), f"range decoder {k} differs")
    say(f"pins: range-decoder outputs identical ({len(ari)} arrays)")

    def bits(got, want):
        return min(rms_metric(want[:, b].ravel(), got[:, b].ravel())["bits"]
                   for b in range(got.shape[1]))

    clean = P.decode(frames, np.zeros_like(bfi), dev)
    d = int(np.abs(clean.astype(np.int32) - pins["clean"]).max())
    say(f"pins: clean decode max |GPU - CPU| = {d} LSB (limit {CLEAN_LSB}), "
        f"min RMS bits over lanes {bits(clean, pins['clean'])}")
    check(d <= CLEAN_LSB, f"clean decode differs by {d} LSB")

    lossy = P.decode(frames, bfi, dev)
    dl = np.abs(lossy.astype(np.int32) - pins["lossy"])
    b_lossy = bits(lossy, pins["lossy"])
    say(f"pins: lossy decode ({int(bfi.sum())} lost lane-frames) max |GPU - "
        f"CPU| = {int(dl[bfi == 0].max())} LSB on good frames, "
        f"{int(dl.max())} LSB on all; min RMS bits over lanes {b_lossy} "
        f"(limit {RMS_BITS})")
    check(b_lossy >= RMS_BITS, f"lossy decode reaches {b_lossy} bits")

    enc = P.encode(pins["pcm"], dev)
    share = float(np.mean(np.all(enc == frames, axis=-1)))
    y = P.decode(enc, np.zeros_like(bfi), dev)
    b_enc = bits(y, pins["clean"])
    say(f"pins: GPU encode bytes equal to the pin on {share:.4%} of "
        f"lane-frames; its decode vs the pinned PCM: min RMS bits {b_enc}, "
        f"max |diff| {int(np.abs(y.astype(np.int32) - pins['clean']).max())} LSB")
    check(b_enc >= RMS_BITS, f"GPU-encoded stream reaches {b_enc} bits")


def native_build():
    r = subprocess.run(["bash", str(REPO / "tools/build_native.sh")],
                       capture_output=True, text=True)
    check(r.returncode == 0, f"tools/build_native.sh: {r.stderr.strip()}")
    from audio_codec_tpu.utils import native
    say(f"native host helpers loaded: {native.have_native()}")
    check(native.have_native(), "native host helpers did not load")


# ------------------------------------------------------------- --four

def four_cards(devs):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec
    from audio_codec_tpu.models import state as S
    from audio_codec_tpu.models.decoder import round_pcm
    from audio_codec_tpu.parallel import engine as pe
    from audio_codec_tpu.parallel import mesh as pm
    from tools import make_pins as P

    # the block path's shapes (T=32, 4096 streams per card), so the one-card
    # reference compiles to what the default run compiled
    cfg = P.cfg()
    n, B, T = 4, CH_STREAMS, BLOCK_FRAMES
    mesh = pm.stream_mesh(devs[:n])
    blocks = NamedSharding(mesh, PartitionSpec(None, "streams"))
    pcm = P.material_pcm(n * B, 2 * T, SEED).astype(np.float32)
    enc = pe.ShardedEncoder(cfg, n * B, mesh)
    dec = pe.ShardedDecoder(cfg, n * B, mesh)
    out = enc.encode_block(jax.device_put(pcm[:T], blocks))
    bfi = jax.device_put(np.zeros(n * B, np.int32), pm.shard_streams(mesh))
    pcm_out = [dec.step(out[t].astype(np.int32), bfi) for t in range(T)]

    def owners(arr, axis):
        got = {}
        for s in arr.addressable_shards:
            got[s.index[axis].start or 0] = s.device
        return got

    for name, arr, axis in (("bytes", out, 1), ("pcm", pcm_out[0], 0),
                            ("enc state", enc.state.mdct_mem, 0),
                            ("dec state", dec.state.imdct_mem, 0)):
        own = owners(arr, axis)
        want = {k * B: devs[k] for k in range(n)}
        check(own == want, f"{name}: shards on {own}, want one per card")
    say(f"four: every card holds its own {B}-stream shard")

    out = np.asarray(out)
    pcm_out = np.stack([np.asarray(p) for p in pcm_out])
    # one reference engine per side, its state reset per shard: a new
    # engine object would trace and compile its step again
    ref_mesh = pm.stream_mesh(devs[:1])
    r_enc = pe.ShardedEncoder(cfg, B, ref_mesh)
    r_dec = pe.ShardedDecoder(cfg, B, ref_mesh)
    fdiff = 0.0
    for k in range(n):
        sl = slice(k * B, (k + 1) * B)
        r_enc.state = pm.shard_state(ref_mesh, S.enc_state_init(cfg, B))
        r_dec.state = pm.shard_state(ref_mesh, S.dec_state_init(cfg, B))
        r_out = np.asarray(r_enc.encode_block(jax.device_put(pcm[:T, sl], devs[0])))
        check(np.array_equal(r_out, out[:, sl]), f"shard {k}: bytes differ "
              "from the one-card engine")
        zb = jax.device_put(np.zeros(B, np.int32), devs[0])
        r_pcm = np.stack([np.asarray(r_dec.step(
            jax.device_put(r_out[t].astype(np.int32), devs[0]), zb))
            for t in range(T)])
        fdiff = max(fdiff, float(np.abs(r_pcm - pcm_out[:, sl]).max()))
        # users get int16 PCM; the float synthesis of two compilations
        # (4-device SPMD vs 1 device) may differ in the last ulp
        check(np.array_equal(np.asarray(round_pcm(r_pcm)),
                             np.asarray(round_pcm(pcm_out[:, sl]))),
              f"shard {k}: int16 PCM differs from the one-card engine")
    say(f"four: {n} x {B} streams, {T} frames: bytes and int16 PCM of every "
        f"shard bit-identical to the one-card engine on card 0 (float "
        f"synthesis max |diff| {fdiff:.3g})")

    old = jax.device_get(enc.state)
    ring = [(i, (i + 1) % n) for i in range(n)]
    enc.state = pe.migrate_streams(mesh, enc.state, ring)
    new = jax.device_get(enc.state)
    jax.tree_util.tree_map(lambda a, b: check(
        np.array_equal(np.roll(a, B, axis=0), b), "migration is not a roll"),
        old, new)
    nxt = np.roll(pcm[T:], B, axis=1)     # the next block, lanes rolled
    got = np.asarray(enc.encode_block(jax.device_put(nxt, blocks)))
    for k in range(n):
        src = slice(((k - 1) % n) * B, ((k - 1) % n + 1) * B)
        r_enc.state = jax.device_put(
            jax.tree_util.tree_map(lambda a: a[src], old), devs[0])
        ref = np.asarray(r_enc.encode_block(
            jax.device_put(nxt[:, k * B:(k + 1) * B], devs[0])))
        check(np.array_equal(ref, got[:, k * B:(k + 1) * B]),
              f"shard {k}: bytes after migration differ from the reference")
    say(f"four: ring migration over {n} cards is an exact roll; the next "
        f"{T} frames' bytes equal the one-card engine on the rolled state")


# --------------------------------------------------------- --fixed-dev

def fixed_dev(dev, B: int = 64):
    import numpy as np
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.fixed_decoder import FixedDecoder
    from audio_codec_tpu.fixed_decoder_dev import DeviceFixedDecoder
    from tools import make_pins as P

    # float-encoder bitstreams: the pinned bytes, cut into 2-frame streams
    # (each decoder starts from its init state, so any frame may open one)
    pins = P.load()["bytes"]                       # [20, 8, nb]
    T = 2
    frames = pins.reshape(-1, T, pins.shape[1], pins.shape[2])
    frames = frames.transpose(1, 0, 2, 3).reshape(T, -1, pins.shape[2])[:, :B]
    check(frames.shape[1] == B, f"only {frames.shape[1]} pinned streams")
    cfg = Config(fs_in=48000, bitrate=64000)
    devdec = DeviceFixedDecoder(cfg, B=B)
    say(f"fixed-dev: compiling DeviceFixedDecoder T={T} B={B} ...")
    t0 = time.perf_counter()
    got = devdec.decode_block(frames)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.stack([FixedDecoder(cfg).decode(frames[:, b]) for b in range(B)],
                    axis=1)
    host_s = time.perf_counter() - t0
    same = np.array_equal(got, want)
    say(f"fixed-dev: DeviceFixedDecoder T={T} B={B} on {dev.device_kind}: "
        f"compile_s={compile_s:.1f} (first call, smoke reading); host "
        f"FixedDecoder {host_s:.1f} s; bit-exact: {same}")
    check(same, f"fixed-dev: {int(np.sum(got != want))} samples differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--four", action="store_true",
                   help="4-GPU stream mesh vs the 1-GPU engine, migration")
    g.add_argument("--fixed-dev", action="store_true",
                   help="device bit-exact decoder vs host FixedDecoder (x64)")
    args = ap.parse_args()
    n_cards = 4 if args.four else 1

    with Phase("device"):
        preflight()
        if not (args.four or args.fixed_dev):
            gpu_tests()
        if args.fixed_dev:
            import jax
            jax.config.update("jax_enable_x64", True)
        devs = jax_device(n_cards)
    if args.four:
        with Phase("four"):
            four_cards(devs)
    elif args.fixed_dev:
        with Phase("fixed-dev"):
            fixed_dev(devs[0])
    else:
        with Phase("native"):
            native_build()
        with Phase("served"):
            pcm, served_bytes, served_pcm = served_path(devs[0])
        with Phase("block"):
            block_path(devs[0], pcm, served_bytes, served_pcm)
        with Phase("cli"):
            cli_path()
        with Phase("pins"):
            pins_check(devs[0])
    d = devs[0]
    say(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
