"""Encoder front-end analysis ops, batched over streams.

Covers the reference stages (SURVEY.md §2.1):
- 12.8 kHz resampler  (resamp12k8.c:13-84)    → dense matmul + biquad scan
- open-loop pitch     (olpa.c:52-180)         → windowed-gather autocorr
- LTPF parameter coder (ltpf_coder.c:34-263)  → all-lag correlation + masked
  argmax searches (no data-dependent control flow)
- attack detector     (attack_detector.c:13-104)
- per-band energy     (per_band_energy.c:13-30) → single matmul
- bandwidth detector  (detect_cutoff_warped.c:13-83) → masked fixed-trip scans

Shapes: B = n_streams; all functions are shape-static and jit/vmap/shard_map
friendly.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import tables as T
from ..config import Config

F32 = jnp.float32


# ---------------------------------------------------------------------------
# 12.8 kHz resampler
# ---------------------------------------------------------------------------

def resample_12k8(cfg: Config, x, mem_in, mem_50, mem_out):
    """Returns (y [B, len_12k8+1], new_mem_in, new_mem_50, new_mem_out).

    Polyphase resample as one matmul against the precomputed dense operator
    (tables.resampler_matrix), then the 50 Hz highpass biquad as a short
    lax.scan (the only sequential part; 32-128 steps).
    """
    B = x.shape[0]
    n12k8 = cfg.frame_length * 12800 // cfg.fs
    R = jnp.asarray(T.resampler_matrix(cfg.fs_idx, cfg.frame_length), F32)
    buf = jnp.concatenate([mem_in, x], axis=-1)
    new_mem_in = buf[:, cfg.frame_length:]
    down = jnp.dot(buf, R.T, preferred_element_type=F32)  # [B, n12k8]

    b = T.t("highpass50_filt_b")
    a = T.t("highpass50_filt_a")
    b0, b1, b2 = (F32(v) for v in b)
    a1, a2 = F32(a[1]), F32(a[2])

    def hp_step(carry, xt):
        u1, u2 = carry
        y = b0 * xt + u1
        u1n = (b1 * xt + u2) - a1 * y
        u2n = b2 * xt - a2 * y
        return (u1n, u2n), y

    (u1, u2), ys = jax.lax.scan(hp_step, (mem_50[:, 0], mem_50[:, 1]), down.T)
    filt = ys.T  # [B, n12k8]
    new_mem_50 = jnp.stack([u1, u2], axis=-1)

    buf_out = jnp.concatenate([mem_out, filt], axis=-1)  # [B, 24 + n12k8]
    y = buf_out[:, : cfg.len_12k8 + 1]
    new_mem_out = jax.lax.dynamic_slice_in_dim(buf_out, n12k8, 24, axis=1)
    return y, new_mem_in, new_mem_50, new_mem_out


# ---------------------------------------------------------------------------
# open-loop pitch analysis (OLPA)
# ---------------------------------------------------------------------------

def _window_gather(buf, base: int, n_lags: int, n: int):
    """buf[:, base + j - l] for l in [0,n_lags), j in [0,n) → [B, n_lags, n]."""
    idx = base + np.arange(n)[None, :] - np.arange(n_lags)[:, None]
    return buf[:, jnp.asarray(idx)]


def olpa(cfg: Config, s12k8, mem_s12k8, mem_s6k4, mem_pitch):
    """Open-loop pitch search at 6.4 kHz (processOlpa_fl, olpa.c:52-180).

    s12k8: [B, len_12k8+1]; uses first len_12k8 samples.
    Returns (T0 [B] i32 at 12.8k grid, normcorr [B], new mems).
    """
    length = cfg.len_12k8
    len2 = length // 2
    mem_in_len = T.MAX_PITCH_6K4 + (16 if cfg.frame_dms == 25 else 0)
    acflen = len2 + (16 if cfg.frame_dms == 25 else 0)

    # downsample to 6.4k: 5-tap FIR (zero initial state) then decimate
    buf = jnp.concatenate([mem_s12k8, s12k8[:, :length]], axis=-1)  # [B, len+3]
    new_mem_s12k8 = jax.lax.dynamic_slice_in_dim(buf, length, 3, axis=1)
    w = jnp.asarray(T.t("olpa_down2"), F32)  # 5 taps
    padded = jnp.pad(buf, ((0, 0), (4, 0)))
    # filt_out[i] = sum_k w[k] * buf[i-k]  (causal, zeros before start)
    taps = jnp.stack([padded[:, 4 - k: 4 - k + length + 3] for k in range(5)], 0)
    filt = jnp.einsum("k,kbn->bn", w, taps)
    d_wsp = filt[:, 4::2][:, :len2]                                 # [B, len2]

    buf2 = jnp.concatenate([mem_s6k4[:, :mem_in_len], d_wsp], axis=-1)
    new_mem_s6k4 = jax.lax.dynamic_slice_in_dim(buf2, len2, mem_in_len, axis=1)
    if cfg.frame_dms == 25:
        base = mem_in_len - 16
    else:
        base = mem_in_len
    cur = jax.lax.dynamic_slice_in_dim(buf2, base, acflen, axis=1)  # s6k4[0:acflen]

    # autocorrelation for all lags 17..114
    lagged = _window_gather(buf2, base - T.MIN_PITCH_6K4, T.RANGE_PITCH_6K4, acflen)
    R = jnp.einsum("bn,bln->bl", cur, lagged)                       # [B, 98]
    E = jnp.einsum("bln,bln->bl", lagged, lagged)                   # energy per lag
    e0 = jnp.sum(cur * cur, axis=-1)                                # [B]

    acw = jnp.asarray(T.t("olpa_acw"), F32)
    Rw = R * acw
    L = jnp.argmax(Rw, axis=-1)
    T0 = L.astype(jnp.int32) + T.MIN_PITCH_6K4

    def norm_corr_at(lag_idx):
        s0 = jnp.take_along_axis(R, lag_idx[:, None], axis=1)[:, 0]
        s1 = jnp.take_along_axis(E, lag_idx[:, None], axis=1)[:, 0]
        nc = s0 / (jnp.sqrt(s1 * e0) + F32(1e-5))
        return jnp.maximum(nc, 0.0)

    nc1 = norm_corr_at(L)

    # second try near previous pitch
    min_p = jnp.maximum(T.MIN_PITCH_6K4, mem_pitch - 4)
    max_p = jnp.minimum(T.MAX_PITCH_6K4, mem_pitch + 4)
    lags = jnp.arange(T.RANGE_PITCH_6K4)[None, :] + T.MIN_PITCH_6K4
    in_win = (lags >= min_p[:, None]) & (lags <= max_p[:, None])
    Rm = jnp.where(in_win, R, -jnp.inf)
    # C scans forward taking strictly-greater maxima → first argmax
    L2 = jnp.argmax(Rm, axis=-1)
    T02 = L2.astype(jnp.int32) + T.MIN_PITCH_6K4
    nc2 = norm_corr_at(L2)

    take2 = (T02 != T0) & (nc2 > nc1 * F32(0.85))
    T0f = jnp.where(take2, T02, T0)
    ncf = jnp.where(take2, nc2, nc1)
    return 2 * T0f, ncf, T0f, new_mem_s12k8, new_mem_s6k4


# ---------------------------------------------------------------------------
# LTPF encoder
# ---------------------------------------------------------------------------

def _ltpf_interp_matrix() -> np.ndarray:
    """[n_out, 17] matrix for 4x upsampled correlation interpolation.

    cor_int[i] = sum_m cor[m] * inter4_1[4m - i] for 0 <= 4m-i <= 31
    (ltpf_coder.c:125-141 with the sparse upsampling folded in).
    """
    inter = T.t("inter4_1")
    n_out = 4 * 9  # pitch_search_upsamp * (t0_max - t0_min + 1) max
    M = np.zeros((n_out, 17))
    for i in range(n_out):
        for m in range(17):
            k = 4 * m - i
            if 0 <= k < 32:
                M[i, m] = inter[k]
    return M


def ltpf_encode(cfg: Config, s12k8, pitch_ol, nc_ol, mem_in,
                mem_normcorr, mem_mem_normcorr, mem_on, mem_pitch):
    """LTPF pitch refinement + activation (process_ltpf_coder_fl).

    s12k8: [B, len_12k8+1]; pitch_ol: [B] i32 (12.8k grid); nc_ol: [B].
    Returns (param [B,3] i32, bits [B] i32, new mems...).
    """
    B = s12k8.shape[0]
    xlen = cfg.len_12k8 + 1
    N = xlen - 1
    mem_len = cfg.ltpf_mem_in_len
    buf = jnp.concatenate([mem_in, s12k8], axis=-1)  # [B, mem_len + xlen]
    new_mem_in = jax.lax.dynamic_slice_in_dim(buf, N, mem_len, axis=1)

    if cfg.frame_dms == 25:
        acflen, xbase = 2 * N, mem_len - N
    else:
        acflen, xbase = N, mem_len
    x = jax.lax.dynamic_slice_in_dim(buf, xbase, acflen, axis=1)

    # --- cross-correlation over every possible lag 28..232 ---
    n_lags = T.MAX_PITCH_12K8 + 4 - (T.MIN_PITCH_12K8 - 4) + 1  # 205
    lag0 = T.MIN_PITCH_12K8 - 4
    lagged = _window_gather(buf, xbase - lag0, n_lags, acflen)   # [B, 205, n]
    cor_all = jnp.einsum("bn,bln->bl", x, lagged)
    en_all = jnp.einsum("bln,bln->bl", lagged, lagged)
    e_cur = jnp.sum(x * x, axis=-1)
    denom = jnp.sqrt(e_cur[:, None] * en_all) + F32(1e-5)
    nc_all = jnp.maximum(cor_all / denom, 0.0)                   # [B, 205]

    t0_min = jnp.clip(pitch_ol - 4, T.MIN_PITCH_12K8, None)
    t0_max = jnp.clip(pitch_ol + 4, None, T.MAX_PITCH_12K8)
    t_min = t0_min - 4  # cross-corr window start (17 wide)

    win_idx = (t_min - lag0)[:, None] + jnp.arange(17)[None, :]
    cor = jnp.take_along_axis(nc_all, win_idx, axis=1)           # [B, 17]

    # integer lag: argmax of cor[4 .. 4 + (t0_max - t0_min)]
    n_int = t0_max - t0_min + 1
    cand = cor[:, 4:13]
    mask = jnp.arange(9)[None, :] < n_int[:, None]
    t1 = jnp.argmax(jnp.where(mask, cand, -jnp.inf), axis=-1).astype(jnp.int32) + t0_min

    # fractional lag via interpolated correlation
    Mi = jnp.asarray(_ltpf_interp_matrix(), F32)
    cor_int = jnp.dot(cor, Mi.T, preferred_element_type=F32)     # [B, 36]
    step = jnp.where(t1 >= T.RES4_PITCH_12K8, 2, 1)
    midpoint = 4 * (t1 - t0_min) + 1
    delta = 4 - step
    delta_down = jnp.where(t1 == t0_min, 0, delta)
    count = (delta + delta_down) // step + 1
    offs = jnp.arange(7)[None, :]
    cand_idx = midpoint[:, None] - delta_down[:, None] - 1 + offs * step[:, None]
    cmask = offs < count[:, None]
    cvals = jnp.take_along_axis(cor_int, jnp.clip(cand_idx, 0, cor_int.shape[1] - 1), axis=1)
    best = jnp.argmax(jnp.where(cmask, cvals, -jnp.inf), axis=-1).astype(jnp.int32)
    pitch_fr0 = best * step - delta_down
    pitch_int = jnp.where(pitch_fr0 >= 0, t1, t1 - 1)
    pitch_fr = jnp.where(pitch_fr0 >= 0, pitch_fr0, pitch_fr0 + 4)
    # no fractional search above RES2
    no_fr = t1 >= T.RES2_PITCH_12K8
    pitch_int = jnp.where(no_fr, t1, pitch_int)
    pitch_fr = jnp.where(no_fr, 0, pitch_fr)

    # pitch index (ltpf_coder.c:176-184)
    pi = pitch_int
    pf = pitch_fr
    idx_lo = pi * 4 + pf - T.MIN_PITCH_12K8 * 4
    idx_mid = pi * 2 + pf // 2 - T.RES4_PITCH_12K8 * 2 + (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4
    idx_hi = pi - T.RES2_PITCH_12K8 + (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4 \
        + (T.RES2_PITCH_12K8 - T.RES4_PITCH_12K8) * 2
    pitch_index = jnp.where(pi < T.RES4_PITCH_12K8, idx_lo,
                            jnp.where(pi < T.RES2_PITCH_12K8, idx_mid, idx_hi))
    pitch = pi.astype(F32) + pf.astype(F32) / 4.0

    # --- normalized correlation of interpolated signals ---
    ef = jnp.asarray(T.t("enc_inter_filter"), F32)  # [4, 4]
    j = jnp.arange(acflen)[None, :]

    def shifted(k):  # x[n + k] over the acf window
        return jax.lax.dynamic_slice_in_dim(buf, xbase + k, acflen, axis=1)

    cur_f = (shifted(1) * ef[0, 0] + shifted(0) * ef[0, 1] + shifted(-1) * ef[0, 2])
    fsel = ef[pitch_fr]  # [B, 4]
    base_idx = xbase + j - pitch_int[:, None]
    pred_f = (jnp.take_along_axis(buf, base_idx + 1, axis=1) * fsel[:, 0:1]
              + jnp.take_along_axis(buf, base_idx, axis=1) * fsel[:, 1:2]
              + jnp.take_along_axis(buf, base_idx - 1, axis=1) * fsel[:, 2:3]
              + jnp.take_along_axis(buf, base_idx - 2, axis=1) * fsel[:, 3:4])
    s1 = jnp.sum(cur_f * pred_f, axis=-1)
    s2 = jnp.sum(cur_f * cur_f, axis=-1)
    s3 = jnp.sum(pred_f * pred_f, axis=-1)
    nc = s1 / (jnp.sqrt(s2 * s3) + F32(1e-5))
    nc = jnp.clip(nc, -1.0, 1.0)
    nc = jnp.maximum(nc, 0.0)

    # --- activation decision (ltpf_coder.c:227-241) ---
    searched = nc_ol > F32(0.6)
    cond_fresh = (mem_on == 0) & (nc > 0.94) & (mem_normcorr > 0.94) & \
        ((cfg.frame_dms == 100) | (mem_mem_normcorr > 0.94))
    cond_keep = (mem_on == 1) & (nc > 0.9)
    cond_track = (mem_on == 1) & (jnp.abs(pitch - mem_pitch) < 2) & \
        ((nc - mem_normcorr) > -0.1) & (nc > 0.84)
    active = cfg.ltpf_enable & searched & (cond_fresh | cond_keep | cond_track)

    nc_out = jnp.where(searched, nc, nc_ol)
    pitch_out = jnp.where(searched, pitch, 0.0)
    pitch_present = searched.astype(jnp.int32)
    param = jnp.stack([pitch_present,
                       jnp.where(searched, active.astype(jnp.int32), 0),
                       jnp.where(searched, pitch_index, 0)], axis=-1)
    bits = jnp.where(searched, 11, 1).astype(jnp.int32)

    new_mem_mem_normcorr = jnp.where(cfg.frame_dms < 100, mem_normcorr, mem_mem_normcorr)
    new_mem_on = param[:, 1]
    return (param, bits, new_mem_in, nc_out, new_mem_mem_normcorr,
            new_mem_on, pitch_out)


# ---------------------------------------------------------------------------
# attack detector
# ---------------------------------------------------------------------------

def attack_detector(cfg: Config, x, position, acc_energy, filter_mem):
    """attack_detector_fl (attack_detector.c:13-104). Returns
    (attack_flag [B] i32, new_position, new_acc_energy, new_filter_mem)."""
    if not cfg.attack_handling:
        B = x.shape[0]
        return jnp.zeros((B,), jnp.int32), position, acc_energy, filter_mem
    nblocks = 4
    fs = cfg.fs
    frame_16k = nblocks * 40
    mval = F32(1e-5) if fs == 96000 else F32(0.0)
    if fs == 96000:
        d = x.reshape(x.shape[0], -1, 6).sum(-1)
    elif fs == 48000:
        d = x.reshape(x.shape[0], -1, 3).sum(-1)
    elif fs == 32000:
        d = x.reshape(x.shape[0], -1, 2).sum(-1)
    elif fs == 24000:
        xr = x.reshape(x.shape[0], -1, 3)
        d = xr[:, :, 0] + (xr[:, :, 1] + xr[:, :, 2]) / 2.0
    else:
        d = x
    ptr = jnp.concatenate([filter_mem, d], axis=-1)  # [B, 2 + 160]
    new_filter_mem = ptr[:, frame_16k: frame_16k + 2]
    f_sig = ptr[:, 2:] * F32(0.375) + ptr[:, 1:-1] * F32(-0.5) + ptr[:, :-2] * F32(0.125)
    blk = (f_sig * f_sig).reshape(x.shape[0], nblocks, 40).sum(-1)  # [B, 4]

    flag = jnp.zeros(x.shape[0], jnp.bool_)
    attack_pos = jnp.full(x.shape[0], -1, jnp.int32)
    acc = acc_energy
    for i in range(nblocks):
        tmp = blk[:, i] / F32(8.5)
        hit = tmp > jnp.maximum(acc, mval)
        flag = flag | hit
        attack_pos = jnp.where(hit, i + 1, attack_pos)
        acc = jnp.maximum(blk[:, i], F32(0.25) * acc)
    flag = flag | (position > 2)  # hangover (attdec_hangover_thresh = 2)
    return flag.astype(jnp.int32), attack_pos, acc, new_filter_mem


# ---------------------------------------------------------------------------
# per-band energy + bandwidth detector
# ---------------------------------------------------------------------------

def per_band_energy(cfg: Config, d):
    """[B, N] spectrum → [B, bands_number] mean energies (one matmul)."""
    M = jnp.asarray(T.band_energy_matrix(cfg.fs_idx, cfg.frame_dms,
                                         cfg.hrmode, cfg.frame_length), F32)
    return jnp.dot(d * d, M, preferred_element_type=F32)


def detect_cutoff_warped(cfg: Config, ener):
    """Bandwidth index detection (processDetectCutoffWarped_fl). [B] i32."""
    if cfg.fs_idx == 0 or cfg.hrmode:
        return jnp.full(ener.shape[0], cfg.fs_idx, jnp.int32)
    fs_names = {1: "16k", 2: "24k", 3: "32k", 4: "48k"}
    suffix = {100: "", 50: "_5ms", 25: "_2_5ms"}[cfg.frame_dms]
    starts = T.t(f"BW_warp_idx_start_{fs_names[cfg.fs_idx]}{suffix}")
    stops = T.t(f"BW_warp_idx_stop_{fs_names[cfg.fs_idx]}{suffix}")
    thr_quiet = T.t("threshold_quiet")
    thr_brick = T.t("threshold_brickwall")
    bw_dist = T.t("brickwall_dist")

    # quiet-threshold scan: counter descends from fs_idx while mean < thr
    counter = jnp.full(ener.shape[0], cfg.fs_idx, jnp.int32)
    stopped = jnp.zeros(ener.shape[0], jnp.bool_)
    for c in range(cfg.fs_idx, 0, -1):
        lo, hi = int(starts[c - 1]), int(stops[c - 1])
        mean = ener[:, lo: hi + 1].mean(axis=-1)
        quiet = mean < F32(thr_quiet[c - 1])
        # streams still at `c` and quiet decrement
        at_c = (counter == c) & ~stopped
        counter = jnp.where(at_c & quiet, c - 1, counter)
        stopped = stopped | (at_c & ~quiet)
    bw_idx = counter

    # brickwall check (only when bw_idx < fs_idx)
    eps = F32(np.finfo(np.float32).eps)
    log_e = 10.0 * jnp.log10(ener + eps)
    brick = jnp.zeros(ener.shape[0], jnp.bool_)
    for c in range(cfg.fs_idx):  # possible bw_idx values < fs_idx
        sel = bw_idx == c
        stop = int(starts[c])
        dist = int(bw_dist[c])
        thr = F32(thr_brick[c])
        hit = jnp.zeros(ener.shape[0], jnp.bool_)
        for i in range(stop, stop - dist - 1, -1):
            e_diff = log_e[:, i - dist + 1] - log_e[:, i + 1]
            hit = hit | (e_diff > thr)
        brick = jnp.where(sel, hit, brick)
    return jnp.where((bw_idx < cfg.fs_idx) & ~brick, cfg.fs_idx, bw_idx).astype(jnp.int32)


def cutoff_bandwidth(cfg: Config, d):
    """Bandwidth controller (process_cutoff_bandwidth, cutoff_bandwidth.c:
    13-26): taper the four bins straddling the forced cutoff by
    2^-1 .. 2^-4 and zero everything above, up to yLen. The mask is a
    trace-time constant, so this fuses into the preceding shaping multiply."""
    bw_bin = cfg.bw_ctrl_cutoff_bin
    D = d.shape[-1]
    if cfg.yLen <= bw_bin:
        return d
    mask = np.ones((D,), np.float32)
    for i in range(-1, 3):
        if 0 <= bw_bin + i < cfg.yLen:
            mask[bw_bin + i] = 2.0 ** -(i + 2)
    mask[bw_bin + 3: cfg.yLen] = 0.0
    return d * jnp.asarray(mask)
