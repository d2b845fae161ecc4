#!/usr/bin/env python3
"""Benchmark: real-time 48 kHz / 10 ms LC3plus encode + decode streams per GPU.

Runs the flagship encoder (48 kHz, 10 ms, 64 kbps) over a stream batch on the
GPU, measures frames/s, and reports how many concurrent real-time streams
(100 frames/s each) one card sustains. The decode path is measured on the
encoder's own bitstream via decoder.decode_block.

Measurement protocol (PERF.md):
  * the state-feedback loop is warmed up with the *stepped* state (not just
    the init state) before timing — the stepped state can carry a different
    jit signature, and timing the resulting recompile once produced a bogus
    decode figure;
  * per-iteration wall times are recorded; the headline uses the pipelined
    mean, and min/median are emitted for variance grounding;
  * device kind, the card's name and power limit, XLA cost-analysis
    FLOPs/frame, achieved FLOP/s and its share of the card's f32 peak are
    emitted so the number can be checked against hardware limits.

Baseline: the reference RTL design targets 8 concurrent 48 kHz channels in
real time on its accelerator (docs/architecture/system_overview.md:139, see
BASELINE.md), so vs_baseline = streams / 8.

A run without a GPU, or on a device missing from the peak table, fails.
Prints the card line, then one JSON line: {"metric", "value", "unit", ...}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Dense float32 peak per device_kind (FLOP/s), from NVIDIA's H100 data sheet
# (non-tensor-core FP32; SXM5 67 TF, NVL 60 TF, PCIe 51 TF). The codec's
# matmuls run at precision "highest", i.e. true f32 without TF32, so this is
# the peak they divide by.
_PEAK_F32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
    "NVIDIA H100 NVL": 60e12,
    "NVIDIA H100 PCIe": 51e12,
}


def peak_f32_flops(device_kind: str) -> float:
    """The card's f32 peak; an unknown device is an error, not a default."""
    try:
        return _PEAK_F32_FLOPS[device_kind]
    except KeyError:
        raise ValueError(f"no f32 peak for device kind {device_kind!r}; "
                         f"known: {sorted(_PEAK_F32_FLOPS)}") from None


def card_line() -> str:
    """nvidia-smi's name and power limit, read by a child that stays off
    JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU: JAX's device is {dev.platform} "
                 f"({dev.device_kind}); the benchmark runs on the GPU only")
    return dev


def _timed_loop(fn, n_iter, *args):
    """Run fn n_iter times with state feedback (like a real serving loop).

    Two measurements:
      * pipelined: all n_iter calls queued, one block at the end — the
        throughput a serving loop sees (dispatch overlaps device compute);
      * per-iteration: block after every call — grounds the variance
        (min/median) and exposes host->device round-trip latency.
    """
    import jax
    carry = args[0]
    rest = args[1:]
    out = None
    t0 = time.perf_counter()
    for _ in range(n_iter):
        carry, out = fn(carry, *rest)
    jax.block_until_ready(out)
    pipelined = (time.perf_counter() - t0) / n_iter

    times = []
    carry = args[0]
    for _ in range(n_iter):
        t0 = time.perf_counter()
        carry, out = fn(carry, *rest)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return pipelined, times, carry, out


def _flops(jitted, *args) -> float | None:
    """XLA's cost-model FLOPs for one call of the compiled function."""
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca["flops"]) if ca and "flops" in ca else None


def main() -> None:
    dev = require_gpu()
    peak = peak_f32_flops(dev.device_kind)
    card = card_line()
    print(f"card: {card}", flush=True)

    import jax
    import jax.numpy as jnp
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.models import decoder, encoder, state as S
    from audio_codec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = Config(fs_in=48000, bitrate=64000)
    # dispatch-amortized defaults (PERF.md: small batches measure dispatch
    # latency, not codec throughput)
    B = int(os.environ.get("BENCH_STREAMS", "2048"))
    T = int(os.environ.get("BENCH_FRAMES", "32"))
    n_iter = int(os.environ.get("BENCH_ITERS", "8"))

    @jax.jit
    def block(st, pcm_block):
        def body(st, pcm):
            st, out, _ = encoder.encode_frame(cfg, st, pcm)
            return st, out
        return jax.lax.scan(body, st, pcm_block)

    rng = np.random.default_rng(0)
    pcm = jnp.asarray(
        (rng.standard_normal((T, B, cfg.frame_length)) * 3000.0).astype(np.float32))
    st = S.enc_state_init(cfg, B)
    st = jax.device_put(st, dev)
    pcm = jax.device_put(pcm, dev)

    # warmup: compile for the init-state signature AND the stepped-state
    # signature (they must match — tests/test_engine_state.py guards this —
    # but if they ever diverge the recompile lands here, not in the timing)
    st_w, out = block(st, pcm)
    st_w2, out = block(st_w, pcm)
    jax.block_until_ready(out)

    enc_pipe, enc_times, _, out = _timed_loop(block, n_iter, st, pcm)
    enc_med = statistics.median(enc_times)
    frames_per_s = T * B / enc_pipe
    streams_realtime = frames_per_s / 100.0  # 100 frames/s per 10 ms stream
    enc_flops_block = _flops(block, st, pcm)
    enc_flops_per_s = enc_flops_block / enc_pipe if enc_flops_block else None

    # ---- decode-side throughput on the encoder's own bitstream ----
    dst = S.dec_state_init(cfg, B)
    dst = jax.device_put(dst, dev)

    @jax.jit
    def dblock(st, frames):
        return decoder.decode_block(cfg, st, frames)

    frames_in = out.astype(jnp.int32)
    dst_w, pcm_out = dblock(dst, frames_in)
    dst_w2, pcm_out = dblock(dst_w, frames_in)   # stepped-state signature
    jax.block_until_ready(pcm_out)

    dec_pipe, dec_times, _, pcm_out = _timed_loop(dblock, n_iter, dst, frames_in)
    dec_med = statistics.median(dec_times)
    dec_streams = T * B / dec_pipe / 100.0
    dec_flops_block = _flops(dblock, dst, frames_in)
    dec_flops_per_s = dec_flops_block / dec_pipe if dec_flops_block else None

    def per_frame(f):
        return round(f / (T * B)) if f else None

    def share(f):
        return round(f / peak, 6) if f else None

    print(json.dumps({
        "metric": "realtime_48k_encode_streams_per_gpu",
        "value": round(streams_realtime, 1),
        "unit": "streams",
        "vs_baseline": round(streams_realtime / 8.0, 2),
        "decode_streams_per_gpu": round(dec_streams, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "batch": [T, B],
        "iters": n_iter,
        "encode_ms_pipelined": round(enc_pipe * 1e3, 3),
        "encode_ms_min": round(min(enc_times) * 1e3, 3),
        "encode_ms_median": round(enc_med * 1e3, 3),
        "decode_ms_pipelined": round(dec_pipe * 1e3, 3),
        "decode_ms_min": round(min(dec_times) * 1e3, 3),
        "decode_ms_median": round(dec_med * 1e3, 3),
        "encode_flops_per_frame": per_frame(enc_flops_block),
        "decode_flops_per_frame": per_frame(dec_flops_block),
        "encode_tflops_per_s": round(enc_flops_per_s / 1e12, 4) if enc_flops_per_s else None,
        "decode_tflops_per_s": round(dec_flops_per_s / 1e12, 4) if dec_flops_per_s else None,
        "encode_share_of_f32_peak": share(enc_flops_per_s),
        "decode_share_of_f32_peak": share(dec_flops_per_s),
    }))


if __name__ == "__main__":
    main()
