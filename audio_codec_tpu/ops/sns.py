"""Spectral Noise Shaping (SNS): scale factors, PVQ quantizer, shaping.

Reference stages (SURVEY.md §2.1):
- processSnsComputeScf_fl   (sns_compute_scf.c:13-176)
- process_snsQuantizesScf_Enc / _Dec + MPVQ indexing (sns_quantize_scf.c)
- processSnsInterpolateScf_fl (sns_interpolate_scf.c:13-100)
- processMdctShaping_fl      (mdct_shaping.c:13-22)

All searches are reformulated as masked argmin/argmax over fixed codebooks
(matmuls for the 2x32 stage-1 VQ) and fixed-trip pulse loops for the PVQ
pyramid search — no data-dependent control flow.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import tables as T
from ..config import Config

F32 = jnp.float32
M = T.SNS_M


# ---------------------------------------------------------------------------
# scale factor computation
# ---------------------------------------------------------------------------

def compute_scf(cfg: Config, ener, attack_detected):
    """[B, bands] energies → [B, 16] scale factors (processSnsComputeScf_fl)."""
    B, nb = ener.shape
    x = ener
    if nb < 64:
        d = 64 - nb
        if d < nb:
            # first d bands doubled
            rep = jnp.repeat(x[:, :d], 2, axis=1)
            x = jnp.concatenate([rep, x[:, d:]], axis=-1)
        else:
            ratio = abs(1.0 - 32.0 / nb)
            n4 = round(ratio * nb)
            n2 = nb - n4
            mapping = np.concatenate([np.repeat(np.arange(n4), 4),
                                      np.repeat(np.arange(n4, n4 + n2), 2)])
            x = x[:, jnp.asarray(mapping)]
    # smoothing
    xl = jnp.concatenate([x[:, :1], x[:, :-1]], axis=-1)
    xr = jnp.concatenate([x[:, 1:], x[:, -1:]], axis=-1)
    x = 0.5 * x + 0.25 * xl + 0.25 * xr
    # pre-emphasis
    i = jnp.arange(64, dtype=F32)
    x = x * jnp.power(F32(10.0), i * cfg.tilt / 63.0 / 10.0)
    # noise floor
    mean = jnp.mean(x, axis=-1, keepdims=True)
    nf = jnp.maximum(mean * F32(1e-4), F32(2.0 ** -32))
    x = jnp.maximum(x, nf)
    # log domain
    xlog = jnp.log2(x) / 2.0
    # downsample 64 → 16 with [1,2,3,3,2,1]/12 window and edge padding
    W = np.array([1, 2, 3, 3, 2, 1], dtype=np.float64) / 12.0
    D = np.zeros((64, 16))
    for n in range(16):
        if n == 0:
            idx = [0, 0, 1, 2, 3, 4]
        elif n == 15:
            idx = [59, 60, 61, 62, 63, 63]
        else:
            idx = list(range(4 * n - 1, 4 * n + 5))
        for w, j in zip(W, idx):
            D[j, n] += w
    xl4 = jnp.dot(xlog, jnp.asarray(D, F32), preferred_element_type=F32)
    scf = cfg.sns_damping * (xl4 - jnp.mean(xl4, axis=-1, keepdims=True))

    # attack smoothing (sns_compute_scf.c:141-175)
    if cfg.attack_handling:
        Sm = np.zeros((16, 16))
        Sm[0, :3] = 1 / 3
        Sm[1, :4] = 1 / 4
        for k in range(2, 14):
            Sm[k, k - 2: k + 3] = 1 / 5
        Sm[14, 12:16] = 1 / 4
        Sm[15, 13:16] = 1 / 3
        sm = jnp.dot(scf, jnp.asarray(Sm.T, F32), preferred_element_type=F32)
        sm = F32(0.5) * (sm - jnp.mean(sm, axis=-1, keepdims=True))
        scf = jnp.where((attack_detected == 1)[:, None], sm, scf)
    return scf


# ---------------------------------------------------------------------------
# PVQ pyramid search + MPVQ enumeration
# ---------------------------------------------------------------------------

def _pvq_subpyr_search(x, dim: int, pulses: int):
    """Vectorized pvq_subpyr_search (sns_quantize_scf.c:43-137).

    x: [B, 16] target (only first `dim` used). Returns (y [B,16] i32,
    y_en1_norm [B,16] f32) with entries beyond dim zeroed.
    """
    B = x.shape[0]
    lane = jnp.arange(M) < dim
    xa = jnp.where(lane, jnp.abs(x), 0.0)
    xsign = jnp.where(x >= 0, 1, -1).astype(jnp.int32)
    xsum = jnp.sum(xa, axis=-1)
    eps = F32(2.0 ** -24)

    # projection to a lower sub-pyramid
    proj_fac = (pulses - 1) / xsum[:, None]
    y0 = jnp.where(lane, jnp.floor(xa * proj_fac), 0.0)
    y0 = jnp.where((xsum > eps)[:, None], y0, 0.0)
    pulse_tot = jnp.sum(y0, axis=-1)
    yy = jnp.sum(y0 * y0, axis=-1) * 0.5
    xy = jnp.sum(xa * y0, axis=-1)

    def add_pulse(state, _):
        y, pulse_tot, yy, xy = state
        need = pulse_tot < pulses
        yy1 = yy + 0.5
        xy2 = (xy[:, None] + xa) ** 2
        yyt = yy1[:, None] + y
        # maximize xy2/yyt with the C's strict-inequality first-max scan
        num, den = xy2, yyt
        best = jnp.zeros(B, jnp.int32)
        bn = jnp.full(B, F32(-(2.0 ** 15)))
        bd = jnp.zeros(B, F32)
        for i in range(M):
            if i >= dim:
                break
            better = num[:, i] * bd > den[:, i] * bn
            best = jnp.where(better, i, best)
            bn = jnp.where(better, num[:, i], bn)
            bd = jnp.where(better, den[:, i], bd)
        onehot = jax.nn.one_hot(best, M, dtype=F32)
        xy_n = xy + jnp.take_along_axis(xa, best[:, None], 1)[:, 0]
        yy_n = yy1 + jnp.take_along_axis(y, best[:, None], 1)[:, 0]
        y_n = y + onehot
        upd = need
        return (jnp.where(upd[:, None], y_n, y),
                jnp.where(upd, pulse_tot + 1, pulse_tot),
                jnp.where(upd, yy_n, yy),
                jnp.where(upd, xy_n, xy)), None

    (y, pulse_tot, yy, xy), _ = jax.lax.scan(
        add_pulse, (y0, pulse_tot, yy, xy), None, length=pulses)
    yy = yy * 2.0

    # degenerate all-zero input branch (sns_quantize_scf.c:117-130)
    y_deg = jnp.zeros((B, M), F32)
    y_deg = y_deg.at[:, 0].set(pulses // 2)
    if dim > 1:
        # C writes y[dim] (one past the active range, sns_quantize_scf.c:121)
        y_deg = y_deg.at[:, min(dim, M - 1)].set(-(pulses - pulses // 2))
    yy_deg = jnp.sum(y_deg * y_deg, axis=-1)
    use_deg = (xsum <= eps)[:, None]
    y = jnp.where(use_deg, y_deg, y)
    yy = jnp.where(use_deg[:, 0], yy_deg, yy)

    gain = 1.0 / jnp.sqrt(yy)
    y_signed = (y * xsign).astype(jnp.int32)
    return y_signed, y_signed.astype(F32) * gain[:, None]


def _pvq_enc(pulses, length: int):
    """MPVQ index (pvq_enc, sns_quantize_scf.c:139-163): [B,16] i32 →
    (LS_ind [B], MPVQ_ind [B])."""
    A = jnp.asarray(T.t("pvq_enc_A"), jnp.int32)  # [16, 11]
    B_ = pulses.shape[0]
    ls = jnp.full(B_, -1, jnp.int32)
    mpvq = jnp.zeros(B_, jnp.int32)
    k = jnp.zeros(B_, jnp.int32)
    for pos in range(length - 1, -1, -1):
        p = pulses[:, pos]
        nz = p != 0
        mpvq = jnp.where((ls >= 0) & nz, 2 * mpvq + ls, mpvq)
        ls = jnp.where(p > 0, 0, jnp.where(p < 0, 1, ls))
        mpvq = mpvq + A[length - pos - 1, jnp.clip(k, 0, 10)]
        k = k + jnp.abs(p)
    return ls, mpvq


def _pvq_dec(k: int, m: int, ls_ind, mpvq_ind):
    """MPVQ de-index (pvq_dec, sns_quantize_scf.c:520-560): → pulses [B,16]."""
    A = np.asarray(T.t("pvq_enc_A"), np.int64)  # [16, 11]
    B_ = ls_ind.shape[0]
    leading_sign = 1 - 2 * ls_ind
    pulses = jnp.zeros((B_, M), jnp.int32)
    mpvq = mpvq_ind
    kk = jnp.full(B_, k, jnp.int32)
    done = jnp.zeros(B_, jnp.bool_)
    for pos in range(m):
        row = jnp.asarray(A[m - pos - 1, : k + 1], jnp.int32)  # [k+1]
        # find_last_indice_le: count entries <= mpvq, minus 1 (min 0)
        cnt = jnp.sum((mpvq[:, None] >= row[None, :]).astype(jnp.int32), axis=1)
        idx = jnp.minimum(jnp.maximum(cnt - 1, 0), kk)  # C searches only k+1 entries
        # mpvq == 0 → terminal write of remaining k with leading sign
        terminal = (mpvq == 0) & ~done
        pulses = jnp.where(terminal[:, None] & (jnp.arange(M) == pos)[None, :],
                           leading_sign[:, None] * kk[:, None], pulses)
        done = done | terminal
        live = ~done
        mpvq_n = mpvq - row[jnp.clip(idx, 0, k)]
        k_delta = kk - idx
        has_delta = (k_delta != 0) & live
        pulses = jnp.where(has_delta[:, None] & (jnp.arange(M) == pos)[None, :],
                           leading_sign[:, None] * k_delta[:, None], pulses)
        new_ls = jnp.where(mpvq_n % 2 != 0, -1, 1)
        leading_sign = jnp.where(has_delta, new_ls, leading_sign)
        mpvq_n2 = jnp.where(has_delta, mpvq_n // 2, mpvq_n)
        kk = jnp.where(has_delta, kk - k_delta, kk)
        mpvq = jnp.where(live, mpvq_n2, mpvq)
    return pulses


def quantize_scf_enc(cfg: Config, scf):
    """SNS-VQ encoder (process_snsQuantizesScf_Enc).

    scf: [B, 16]. Returns (scf_idx [B, 7] i32, scf_q [B, 16]).
    """
    B = scf.shape[0]
    C1 = jnp.asarray(T.t("sns_C1"), F32)  # [8, 32]
    C2 = jnp.asarray(T.t("sns_C2"), F32)

    # stage 1: independent 8-dim VQ per half, first-min scan semantics
    def vq_half(target, cb):
        d = jnp.sum((target[:, :, None] - cb[None, :, :]) ** 2, axis=1)  # [B, 32]
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    i0 = vq_half(scf[:, :8], C1)
    i1 = vq_half(scf[:, 8:], C2)
    st1 = jnp.concatenate([C1[:, i0].T, C2[:, i1].T], axis=-1)  # [B, 16]

    target_pre = scf - st1
    D2 = jnp.asarray(T.dct2_matrix(M), F32)
    pvq_target = jnp.dot(target_pre, D2.T, preferred_element_type=F32)

    # regular submodes: split search (10-dim K=10) + (6-dim K=1)
    yA, enA = _pvq_subpyr_search(pvq_target, 10, 10)
    tail = jnp.concatenate([pvq_target[:, 10:], jnp.zeros((B, 10), F32)], axis=-1)
    yB, _ = _pvq_subpyr_search(tail, 6, 1)
    yC = jnp.concatenate([yA[:, :10], yB[:, :6]], axis=-1)
    gain_fac = 1.0 / jnp.sqrt(jnp.sum((yC * yC).astype(F32), axis=-1))
    yC_n = yC.astype(F32) * gain_fac[:, None]

    reg_g = np.concatenate([T.t("sns_vq_reg_adj_gains_fl"),
                            T.t("sns_vq_reg_lf_adj_gains_fl")])
    q_g = T.t("q_g_sns")
    cand = jnp.stack([yC_n * F32(reg_g[0]), yC_n * F32(reg_g[1])]
                     + [jnp.concatenate([enA[:, :10], jnp.zeros((B, 6), F32)], -1)
                        * F32(reg_g[2 + i]) for i in range(4)], axis=1)  # [B, 6, 16]
    errs = jnp.sum((pvq_target[:, None, :] - cand) ** 2, axis=-1)  # [B, 6]
    idx_g = jnp.argmin(errs, axis=-1).astype(jnp.int32)
    min_err_reg = jnp.min(errs, axis=-1)
    glob_gain = jnp.asarray(q_g, F32)[idx_g]
    chosen = jnp.take_along_axis(cand, idx_g[:, None, None], axis=1)[:, 0] / glob_gain[:, None]
    st2_split = jnp.dot(chosen, D2, preferred_element_type=F32)  # idct_II
    err_split = jnp.sum((target_pre - glob_gain[:, None] * st2_split) ** 2, axis=-1)

    # submode selection bookkeeping
    idx2 = jnp.where(idx_g <= 1, 0, 1)
    idx3 = jnp.where(idx_g <= 1, idx_g, idx_g - 2)
    pulses_sel = jnp.where((idx_g <= 1)[:, None], yC, yA)
    st2 = glob_gain[:, None] * st2_split
    best_err = err_split

    # outlier near: 16-dim K=8
    yN, enN = _pvq_subpyr_search(pvq_target, 16, 8)
    st2N = jnp.dot(enN, D2, preferred_element_type=F32)
    near_g = T.t("sns_vq_near_adj_gains_fl")
    errsN = jnp.stack([jnp.sum((target_pre - F32(g) * st2N) ** 2, axis=-1)
                       for g in near_g], axis=1)  # [B, 4]
    iN = jnp.argmin(errsN, axis=-1).astype(jnp.int32)
    eN = jnp.min(errsN, axis=-1)
    gN = jnp.asarray(near_g, F32)[iN]
    useN = eN < best_err
    idx2 = jnp.where(useN, 2, idx2)
    idx3 = jnp.where(useN, iN, idx3)
    pulses_sel = jnp.where(useN[:, None], yN, pulses_sel)
    st2 = jnp.where(useN[:, None], gN[:, None] * st2N, st2)
    best_err = jnp.minimum(best_err, eN)

    # outlier far: 16-dim K=6
    yF, enF = _pvq_subpyr_search(pvq_target, 16, 6)
    st2F = jnp.dot(enF, D2, preferred_element_type=F32)
    far_g = T.t("sns_vq_far_adj_gains_fl")
    errsF = jnp.stack([jnp.sum((target_pre - F32(g) * st2F) ** 2, axis=-1)
                       for g in far_g], axis=1)  # [B, 8]
    iF = jnp.argmin(errsF, axis=-1).astype(jnp.int32)
    eF = jnp.min(errsF, axis=-1)
    gF = jnp.asarray(far_g, F32)[iF]
    useF = eF < best_err
    idx2 = jnp.where(useF, 3, idx2)
    idx3 = jnp.where(useF, iF, idx3)
    pulses_sel = jnp.where(useF[:, None], yF, pulses_sel)
    st2 = jnp.where(useF[:, None], gF[:, None] * st2F, st2)

    # MPVQ indexing (submode-dependent dims)
    ls10, mp10 = _pvq_enc(pulses_sel, 10)
    ls16, mp16 = _pvq_enc(pulses_sel, 16)
    idx4 = jnp.where(idx2 < 2, ls10, ls16)
    idx5 = jnp.where(idx2 < 2, mp10, mp16)
    tail_pulses = jnp.concatenate([pulses_sel[:, 10:], jnp.zeros((B, 10), jnp.int32)], -1)
    lsT, mpT = _pvq_enc(tail_pulses, 6)
    idx6 = jnp.where(idx2 == 0, mpT * 2 + lsT,
                     jnp.where(idx2 == 2, -1, -2))

    scf_idx = jnp.stack([i0, i1, idx2, idx3, idx4, idx5, idx6], axis=-1)
    scf_q = st1 + st2
    return scf_idx, scf_q


def quantize_scf_dec(scf_idx):
    """SNS-VQ decoder (process_snsQuantizesScf_Dec): [B,7] i32 → [B,16]."""
    C1 = jnp.asarray(T.t("sns_C1"), F32)
    C2 = jnp.asarray(T.t("sns_C2"), F32)
    i0, i1, sub, gidx, ls, mpvq, idx6 = [scf_idx[:, k] for k in range(7)]
    st1 = jnp.concatenate([C1[:, i0].T, C2[:, i1].T], axis=-1)

    p_s0 = _pvq_dec(10, 10, ls, mpvq)
    p2 = _pvq_dec(1, 6, idx6 % 2, idx6 // 2)
    p_s0_full = p_s0.at[:, 10:].set(jnp.where((sub == 0)[:, None], p2[:, :6], 0))
    p_s2 = _pvq_dec(8, 16, ls, mpvq)
    p_s3 = _pvq_dec(6, 16, ls, mpvq)
    pulses = jnp.where((sub < 2)[:, None], p_s0_full,
                       jnp.where((sub == 2)[:, None], p_s2, p_s3))
    norm = jnp.sqrt(jnp.sum((pulses * pulses).astype(F32), axis=-1))
    v = pulses.astype(F32) / norm[:, None]
    D2 = jnp.asarray(T.dct2_matrix(M), F32)
    v = jnp.dot(v, D2, preferred_element_type=F32)  # idct_II
    gains = jnp.asarray(T.t("sns_dec_gains"), F32)  # [4, 8]
    g = gains[sub, gidx]
    return st1 + g[:, None] * v


# ---------------------------------------------------------------------------
# interpolation + shaping
# ---------------------------------------------------------------------------

def _interp_matrix(nb: int) -> np.ndarray:
    """[16 → nb] linear interpolation operator (processSnsInterpolateScf_fl)."""
    Mi = np.zeros((64, 16))
    Mi[0, 0] = Mi[1, 0] = 1.0
    for n in range(15):
        for k, w in enumerate([1, 3, 5, 7]):
            Mi[n * 4 + 2 + k, n] = 1 - w / 8.0
            Mi[n * 4 + 2 + k, n + 1] = w / 8.0
    Mi[62, 15], Mi[62, 14] = 1 + 1 / 8.0, -1 / 8.0
    Mi[63, 15], Mi[63, 14] = 1 + 3 / 8.0, -3 / 8.0
    if nb < 64:
        d = 64 - nb
        out = np.zeros((nb, 16))
        if d < 32:
            for i in range(d):
                out[i] = (Mi[2 * i] + Mi[2 * i + 1]) / 2.0
            out[d:] = Mi[2 * d:]
        else:
            ratio = abs(1.0 - 32.0 / nb)
            n4 = round(ratio * nb)
            for i in range(n4):
                out[i] = Mi[4 * i: 4 * i + 4].mean(0)
            for i in range(nb - n4):
                out[n4 + i] = Mi[4 * n4 + 2 * i: 4 * n4 + 2 * i + 2].mean(0)
        return out
    return Mi


def interpolate_scf(cfg: Config, scf_q, encoder_side: bool):
    """[B,16] quantized scf → [B, bands_number] linear-domain gains."""
    Mi = jnp.asarray(_interp_matrix(cfg.bands_number), F32)
    g = jnp.dot(scf_q, Mi.T, preferred_element_type=F32)
    if encoder_side:
        g = -g
    return jnp.exp2(g)


def mdct_shaping(cfg: Config, d, gains):
    """Multiply each bin by its band gain (processMdctShaping_fl).

    Accepts [B, frame_length] or [B, yLen] spectra; bins at or above the
    last band boundary pass through unchanged (mdct_shaping.c only touches
    j < bands_offset[last]).
    """
    n = d.shape[1]
    idx = jnp.asarray(T.band_expand_indices(cfg.fs_idx, cfg.frame_dms,
                                            cfg.hrmode, cfg.frame_length))[:n]
    off = T.bands_offset(cfg.fs_idx, cfg.frame_dms, cfg.hrmode)
    last = int(off[-1])
    shaped = d * gains[:, idx]
    if n > last:
        k = jnp.arange(n)[None, :]
        shaped = jnp.where(k < last, shaped, d)
    return shaped
