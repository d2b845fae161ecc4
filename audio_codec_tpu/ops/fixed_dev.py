"""Batched device port of the bit-exact fixed-point decode chain (jnp, x64).

ops/fixed_dec.py is the host NumPy oracle for this module: every stage here
is the same BASOP arithmetic (dec_lc3.c:156-235 clean-frame chain) expressed
as jit-able jnp over a [B] frame batch — per-frame Python control flow
becomes masks, data-dependent loops become fixed-trip scans, and per-frame
scalars (exponents, gains) become [B] vectors. The radix-FFT / DCT-IV core
is NOT duplicated: ops/fixed_imdct.py's dct_IV/cfft operate on lists of
batch vectors through backend-generic primitives, so the device transform
reuses them verbatim over jnp tracers.

Requires jax_enable_x64 (Word32 x Word32 products need exact i64; the
fixed_dec primitives assert this). Run in a dedicated process — see
tests/test_fixed_dev.py, which subprocesses like tests/test_multihost.py
does, and `chip_smoke.py --fixed-dev`, which enables x64 at start.

Bit-exactness contract: tests/test_fixed_dev.py compares every stage and
the full PCM output against the host FixedDecoder on real testvec frames
(whose output is MD5-verified against testvec/md5_dec.txt).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .. import tables as T
from ..config import Config
from . import fixed_dec as fd
from . import fixed_imdct as fi

I64 = np.int64
MAX32 = (1 << 31) - 1


def _t(name):
    return jnp.asarray(np.asarray(T.t(name)).astype(I64))


def _gat(tab, idx):
    """tab[idx] per-lane gather (1-D table)."""
    return jnp.take(tab, jnp.clip(idx, 0, tab.shape[0] - 1), axis=0)


# ------------------------------------------------------------- stages

def ari_scaling(sq):
    """processAriDecoderScaling_fx — sq [B, N] -> (x32 [B, N], x_e [B])."""
    sq = jnp.asarray(sq, I64)
    mx = jnp.max(jnp.abs(sq), axis=1)
    shift = jnp.where(mx == 0, 15, fd.norm_s(mx))
    return (sq << 16) << shift[:, None], 15 - shift


def residual_decode(x32, x_e, prm, res_bits):
    """processResidualDecoding_fx, batched. prm [B, R] 0/1 bits;
    res_bits [B]."""
    x = jnp.asarray(x32, I64)
    B, N = x.shape
    R = prm.shape[1]
    s = x_e - 1
    fac_m = fd.L_shl(jnp.full((B,), 0x0C000000, I64), -s)[:, None]
    fac_p = fd.L_shl(jnp.full((B,), 0x14000000, I64), -s)[:, None]
    nz = x != 0
    rank = jnp.cumsum(nz, axis=1) - nz  # exclusive rank among nonzeros
    active = nz & (rank < res_bits[:, None]) & (rank < R)
    bit = jnp.take_along_axis(jnp.asarray(prm, I64),
                              jnp.clip(rank, 0, R - 1), axis=1)
    pos = x > 0
    delta = jnp.where(bit == 0,
                      jnp.where(pos, -fac_m, -fac_p),
                      jnp.where(pos, fac_p, fac_m))
    return jnp.where(active, fd.sat32(x + delta), x)


# LCG closed form: seed_{r} = A^r seed_0 + C (A^{r-1}+..+1)  (mod 2^16)
_LCG_A, _LCG_C = 31821, 13849


def _lcg_tables(n):
    ap = np.empty(n + 1, I64)
    cs = np.empty(n + 1, I64)
    a, c = 1, 0
    for r in range(n + 1):
        ap[r] = a
        cs[r] = c
        c = (c + a * _LCG_C) % 65536
        a = (a * _LCG_A) % 65536
    return jnp.asarray(ap), jnp.asarray(cs)


def noise_filling(xq, nfseed, xq_e, fac_ns_idx, bw_idx, frame_dms,
                  fac_ns_pc=None, spec_inv_idx=None):
    """processNoiseFilling_fx, batched (valid while Nbw - nfw > nfs,
    which holds for every supported operating point)."""
    xq = jnp.asarray(xq, I64)
    B, N = xq.shape
    bw_tab = _t("BW_cutoff_bin_all")
    Nbw = _gat(bw_tab, jnp.asarray(bw_idx))
    if frame_dms == 25:
        Nbw, nfw, nfs = Nbw >> 2, 1, 6
    elif frame_dms == 50:
        Nbw, nfw, nfs = Nbw >> 1, 2, 12
    else:
        nfw, nfs = 3, 24
    idx = jnp.arange(N, dtype=I64)[None, :]
    m_nz = xq != 0
    last_nz = jax.lax.cummax(jnp.where(m_nz, idx, -1), axis=1)
    run_end = idx - last_nz              # zeros run length ending at p
    # main window: all of [k-nfw, k+nfw] zero  <=>  run_end[k+nfw] >= 2nfw+1
    re_kn = jnp.concatenate([run_end[:, nfw:],
                             jnp.zeros((B, nfw), I64)], axis=1)
    re_last = jnp.take_along_axis(run_end, (Nbw - 1)[:, None], axis=1)
    cond_main = re_kn >= 2 * nfw + 1
    cond_tail = re_last >= (nfw + Nbw[:, None] - idx)
    in_main = (idx >= nfs) & (idx < Nbw[:, None] - nfw)
    in_tail = (idx >= jnp.maximum(Nbw[:, None] - nfw, nfs)) & \
        (idx < Nbw[:, None])
    sel = (in_main & cond_main) | (in_tail & cond_tail)

    fac_ns = (8 - jnp.asarray(fac_ns_idx, I64)) << 11
    sh = jnp.asarray(xq_e, I64) - 16
    tmp = fd.L_shl(fac_ns, -sh)[:, None]
    if fac_ns_pc is None:
        v = tmp
    else:
        tmp_pc = fd.L_shl(jnp.asarray(fac_ns_pc, I64), -sh)[:, None]
        inv = (jnp.full((B,), 1 << 14, I64) if spec_inv_idx is None
               else jnp.asarray(spec_inv_idx, I64))
        v = jnp.where(idx < inv[:, None], tmp, tmp_pc)
    ap, cs = _lcg_tables(N)
    rank = jnp.cumsum(sel, axis=1)       # 1-based at selected positions
    seed0 = jnp.asarray(nfseed, I64) & 0xFFFF
    seed_u = (ap[rank] * seed0[:, None] + cs[rank]) & 0xFFFF
    pos_seed = seed_u < 0x8000
    out = jnp.where(sel, jnp.where(pos_seed, v, -v), xq)
    n_sel = rank[:, -1]
    seed_fin_u = (_gat(ap, n_sel) * seed0 + _gat(cs, n_sel)) & 0xFFFF
    seed_fin = jnp.where(seed_fin_u >= 0x8000, seed_fin_u - 0x10000,
                         seed_fin_u)
    return out, seed_fin


def inv_log2(x):
    """BASOP_Util_InvLog2, batched over [B]."""
    x = jnp.asarray(x, I64)
    frac = x & 0x3FF
    i3 = (x >> 10) & 0x1F
    i2 = (x >> 15) & 0x1F
    i1 = (x >> 20) & 0x1F
    exp = x >> 25
    exp = jnp.where(x > 0, 31 - exp, -exp)
    e3, e2, e1 = (_t("fx_exp2x_tab_long"), _t("fx_exp2w_tab_long"),
                  _t("fx_exp2_tab_long"))
    lookup3f = _gat(e3, i3) + (fd.mpy_32_16(0x0016302F, frac) >> 1)
    lookup12 = fd.mpy_32_32(_gat(e1, i1), _gat(e2, i2))
    lookup = fd.mpy_32_32(lookup12, lookup3f)
    s = exp - 3
    res = fd.L_shl(lookup, -s)
    res = jnp.where(x < -1040187392, 0, res)
    res = jnp.where((x >= 1040187392) | (x == 0), MAX32, res)
    return res


def apply_global_gain(x32, x_e, gg_idx, gg_off):
    """processApplyGlobalGain_fx, batched."""
    gg_idx = jnp.asarray(gg_idx, I64)
    tmp32 = fd.sat32(((gg_idx + gg_off) * 0x797D) << 7)
    gg_e = (tmp32 >> 25) + 1
    gg = fd.round_fx(inv_log2(tmp32 | -33554432))
    return fd.mpy_32_16(jnp.asarray(x32, I64), gg[:, None]), \
        jnp.asarray(x_e, I64) + gg_e


def _masked_headroom32(x, mask):
    """getScaleFactor32 over masked region per lane: min norm_l over
    nonzero masked entries, 0 if none."""
    nz = mask & (x != 0)
    n = jnp.where(nz, fd.norm_l(jnp.where(nz, x, 1)), 63)
    mn = jnp.min(n, axis=1)
    return jnp.where(nz.any(axis=1), mn, 0)


def tns_decode(rc_idx, x32, x_e, order, bw_idx, frame_dms):
    """processTnsDecoder_fx, batched. rc_idx [B,16], order [B,2]."""
    x = jnp.asarray(x32, I64)
    B, N = x.shape
    pts = _t("fx_tnsQuantPts")
    bw_stop0 = _gat(_t("BW_cutoff_bin_all"), jnp.asarray(bw_idx))
    if frame_dms == 25:
        start0 = 3
        bw_stop = bw_stop0 >> 2
    elif frame_dms == 50:
        start0 = 6
        bw_stop = bw_stop0 >> 1
    else:
        start0 = 12
        bw_stop = bw_stop0
    numf2 = (jnp.asarray(bw_idx) >= 3) & (frame_dms >= 50)
    start1 = bw_stop >> 1
    o0 = jnp.asarray(order, I64)[:, 0]
    o1 = jnp.where(numf2, jnp.asarray(order, I64)[:, 1], 0)
    lane_act = (o0 > 0) | (o1 > 0)

    f = jnp.where(numf2 & (o0 == 0), start1, start0)
    idx = jnp.arange(N, dtype=I64)[None, :]
    s1 = _masked_headroom32(x, idx < f[:, None])
    s2 = _masked_headroom32(x, idx >= f[:, None])
    s = jnp.minimum(s1, s2 - 7)
    x_e = jnp.where(lane_act, jnp.asarray(x_e, I64) - s, jnp.asarray(x_e, I64))

    rc0 = _gat(pts, jnp.clip(jnp.asarray(rc_idx, I64)[:, 0:8], 0,
                             pts.shape[0] - 1))
    rc1 = _gat(pts, jnp.clip(jnp.asarray(rc_idx, I64)[:, 8:16], 0,
                             pts.shape[0] - 1))
    stop1 = jnp.where(numf2, start1, bw_stop)   # filter-0 stop
    # filter-1 region [start1, bw_stop) when o1 > 0

    def body(state, xi_col):
        x_i, i = xi_col
        in_f1 = (i >= start0) & (i < stop1) & (o0 > 0)
        in_f2 = numf2 & (i >= start1) & (i < bw_stop) & (o1 > 0)
        act = (in_f1 | in_f2) & lane_act
        rc = jnp.where(in_f2[:, None], rc1, rc0)
        o = jnp.where(in_f2, o1, o0)
        xi = fd.L_shl(x_i, s)
        om1 = jnp.clip(o - 1, 0, 7)
        st_om1 = jnp.take_along_axis(state, om1[:, None], axis=1)[:, 0]
        rc_om1 = jnp.take_along_axis(rc, om1[:, None], axis=1)[:, 0]
        xi = jnp.where(act, fd.sat32(xi - fd.mpy_32_16(st_om1, rc_om1)), xi)
        new_state = state
        for kk in range(6, -1, -1):
            a_k = act & (kk <= o - 2)
            xi2 = fd.sat32(xi - fd.mpy_32_16(new_state[:, kk], rc[:, kk]))
            xi = jnp.where(a_k, xi2, xi)
            upd = fd.sat32(new_state[:, kk] + fd.mpy_32_16(xi, rc[:, kk]))
            new_state = new_state.at[:, kk + 1].set(
                jnp.where(a_k, upd, new_state[:, kk + 1]))
        new_state = new_state.at[:, 0].set(
            jnp.where(act, xi, new_state[:, 0]))
        new_state = jnp.where(act[:, None], new_state, state)
        return new_state, (xi, act)

    state0 = jnp.zeros((B, 8), I64)
    _, (xi_all, act_all) = jax.lax.scan(
        body, state0, (x.T, jnp.arange(N, dtype=I64)))
    x_filt = xi_all.T
    act_map = act_all.T
    x_shifted = fd.L_shl(x, s[:, None])
    x_out = jnp.where(lane_act[:, None],
                      jnp.where(act_map, x_filt, x_shifted), x)
    return x_out, x_e


def inv_log2_16(x):
    """BASOP_Util_InvLog2_16, batched elementwise."""
    t1 = _t("fx_InvLog2_16_table1")
    t2 = _t("fx_InvLog2_16_table2")
    x = jnp.asarray(x, I64)
    tmp1 = (x & 2047) >> 5
    tmp2 = (x & 31) << 4
    y = fd.mac_r(_gat(t1, tmp1.reshape(-1)).reshape(x.shape),
                 _gat(t2, tmp1.reshape(-1)).reshape(x.shape), tmp2)
    y_e = (x >> 11) + 1
    return y, y_e


def sns_interpolate(scf_q, n_bands):
    """processSnsInterpolateScf_fx, batched. scf_q [B,16]."""
    scf_q = jnp.asarray(scf_q, I64)
    B = scf_q.shape[0]
    cols = [None] * 64
    cols[0] = scf_q[:, 0]
    cols[1] = scf_q[:, 0]
    tmp2 = jnp.zeros((B,), I64)
    for i in range(1, 16):
        d = fd.sat16(scf_q[:, i] - scf_q[:, i - 1])
        tmp2 = fd.mult_r(d, 8192)
        tmp = fd.mult_r(d, 4096)
        cols[i * 4 - 2] = fd.sat16(scf_q[:, i - 1] + tmp)
        cols[i * 4 - 1] = fd.sat16(cols[i * 4 - 2] + tmp2)
        cols[i * 4] = fd.sat16(cols[i * 4 - 1] + tmp2)
        cols[i * 4 + 1] = fd.sat16(cols[i * 4] + tmp2)
    cols[62] = fd.sat16(cols[61] + tmp2)
    cols[63] = fd.sat16(cols[62] + tmp2)
    if n_bands < 32:
        t = 32 - n_bands
        orig = list(cols)
        for i in range(t):
            cols[i] = fd.sat16(
                fd.mac_r(fd.L_mult(orig[4 * i], 8192), orig[4 * i + 1], 8192)
                + fd.mac_r(fd.L_mult(orig[4 * i + 2], 8192),
                           orig[4 * i + 3], 8192))
        for i in range(n_bands - t):
            cols[t + i] = fd.mac_r(fd.L_mult(orig[4 * t + 2 * i], 16384),
                                   orig[4 * t + 2 * i + 1], 16384)
    elif n_bands < 64:
        t = 64 - n_bands
        for i in range(t):
            cols[i] = fd.mac_r(fd.L_mult(cols[2 * i], 16384),
                               cols[2 * i + 1], 16384)
        for i in range(t, n_bands):
            cols[i] = cols[t + i]
    scf_int = jnp.stack(cols[:n_bands], axis=1)
    scf, scf_e = inv_log2_16(scf_int)
    return scf, scf_e


def scf_scaling(scf_exp, x_e):
    m = jnp.max(scf_exp, axis=1)
    return scf_exp - m[:, None], jnp.asarray(x_e, I64) + m


def mdct_shaping(x32, scf, scf_exp, bands_offset, n_bins):
    """processMdctShaping_fx: per-bin gather of the band scf (the band
    map is config-static)."""
    bo = np.asarray(bands_offset, I64)
    band_of_bin = np.zeros(n_bins, I64)
    for i in range(len(bo) - 1):
        band_of_bin[bo[i]: bo[i + 1]] = i
    bmap = jnp.asarray(band_of_bin)
    scf_b = jnp.take(scf, bmap, axis=1)
    exp_b = jnp.take(scf_exp, bmap, axis=1)
    x = jnp.asarray(x32, I64)[:, :n_bins]
    return fd.L_shl(fd.mpy_32_16(x, scf_b), exp_b)


# ------------------------------------------------------ fixed SNS decoder

def shl16v(x, s):
    """Word16 saturating shl, vector (negative s = shr)."""
    x = jnp.asarray(x, I64)
    s = jnp.asarray(s, I64)
    left = fd.sat16(x << jnp.clip(s, 0, 31))
    right = x >> jnp.clip(-s, 0, 31)
    return jnp.where(s >= 0, left, right)


def msu_r(L, a, b):
    return fd.round_fx(fd.sat32(jnp.asarray(L, I64)
                                - fd.sat32((jnp.asarray(a, I64) * b) << 1)))


def isqrt16(mantissa, exponent):
    """ISqrt16, batched over [B]."""
    pre = fd.norm_s(mantissa)
    e = exponent - pre
    m = shl16v(mantissa, pre)
    idx = fd.mac_r(jnp.full_like(m, -32768 - (32 << 16)), m, 1 << 6)
    frac = m & 0x1FF
    m2 = msu_r(_gat(_t("fx_ISqrtTable"), idx),
               _gat(_t("fx_ISqrtDiffTable"), idx), frac)
    m3 = jnp.where((e & 1) == 0, fd.mult_r(m2, 0x5A82), m2)
    return m3, msu_r(jnp.full_like(e, 1 << 15), e, 1 << 14)


def pvq_dec_en1_norm(y, k_val_max):
    """pvq_dec_en1_normQ14_fx, batched. y [B, 16] pulses (padded)."""
    y = jnp.asarray(y, I64)
    L_yy = jnp.sum(y * y, axis=1)
    small = L_yy < 64
    tab = _gat(_t("fx_isqrt_Q16tab"), jnp.clip(L_yy, 0, 63))
    t2, e2 = isqrt16(L_yy & 0xFFFF, jnp.full_like(L_yy, 15))
    big = shl16v(t2, e2 + 1)
    isqrt_q16 = jnp.where(small, tab, big)
    shift_num = fd.norm_s(jnp.full_like(L_yy, k_val_max))
    shift_tot = 13 - shift_num
    L = fd.L_mult(isqrt_q16[:, None], shl16v(y, shift_num[:, None]))
    return fd.round_fx(fd.L_shl(L, shift_tot[:, None]))


def idct16(cols):
    """idct16_fx on a [B,16] batch (same dataflow as the host version)."""
    def m(a, c):
        return fd.mult_r(a, c)

    def ad(a, b):
        return fd.sat16(a + b)

    def sb(a, b):
        return fd.sat16(a - b)

    i = [cols[:, k] for k in range(16)]
    a8 = ad(m(i[1], 1136), m(i[15], -11529))
    a9 = ad(m(i[9], 8956), m(i[7], -7350))
    a10 = ad(m(i[5], 5461), m(i[11], -10217))
    a11 = ad(m(i[13], 11086), m(i[3], -3363))
    a12 = ad(m(i[3], 11086), m(i[13], 3363))
    a13 = ad(m(i[11], 5461), m(i[5], 10217))
    a14 = ad(m(i[7], 8956), m(i[9], 7350))
    a15 = ad(m(i[15], 1136), m(i[1], 11529))
    b4 = ad(m(i[2], 2260), m(i[14], -11363))
    b5 = ad(m(i[10], 9633), m(i[6], -6436))
    b6 = ad(m(i[6], 9633), m(i[10], 6436))
    b7 = ad(m(i[14], 2260), m(i[2], 11363))
    b8 = ad(a9, a8)
    b9 = sb(a8, a9)
    b10 = sb(a11, a10)
    b11 = ad(a10, a11)
    b12 = ad(a13, a12)
    b13 = sb(a12, a13)
    b14 = sb(a15, a14)
    b15 = ad(a14, a15)
    a0 = ad(m(i[0], 8192), m(i[8], 8192))
    a1 = ad(m(i[8], -8192), m(i[0], 8192))
    a2 = ad(m(i[4], 4433), m(i[12], -10703))
    a3 = ad(m(i[12], 4433), m(i[4], 10703))
    a4 = ad(b5, b4)
    a5 = sb(b4, b5)
    a6 = sb(b7, b6)
    a7 = ad(b6, b7)
    a8 = b8
    a9 = ad(m(b9, -30274), m(b14, 12540))
    a10 = ad(m(b10, -12540), m(b13, -30274))
    a11 = b11
    a12 = b12
    a13 = ad(m(b13, 12540), m(b10, -30274))
    a14 = ad(m(b14, 30274), m(b9, 12540))
    a15 = b15
    b0 = ad(a3, a0)
    b1 = ad(a2, a1)
    b2 = sb(a1, a2)
    b3 = sb(a0, a3)
    b4 = a4
    b5 = ad(m(a5, -23170), m(a6, 23170))
    b6 = ad(m(a6, 23170), m(a5, 23170))
    b7 = a7
    b8 = ad(a11, a8)
    b9 = ad(a10, a9)
    b10 = sb(a9, a10)
    b11 = sb(a8, a11)
    b12 = sb(a15, a12)
    b13 = sb(a14, a13)
    b14 = ad(a13, a14)
    b15 = ad(a12, a15)
    a0 = ad(b7, b0)
    a1 = ad(b6, b1)
    a2 = ad(b5, b2)
    a3 = ad(b4, b3)
    a4 = sb(b3, b4)
    a5 = sb(b2, b5)
    a6 = sb(b1, b6)
    a7 = sb(b0, b7)
    a10 = ad(m(b10, -23170), m(b13, 23170))
    a11 = ad(m(b11, -23170), m(b12, 23170))
    a12 = ad(m(b12, 23170), m(b11, 23170))
    a13 = ad(m(b13, 23170), m(b10, 23170))
    return jnp.stack(
        [ad(b15, a0), ad(b14, a1), ad(a13, a2), ad(a12, a3),
         ad(a11, a4), ad(a10, a5), ad(b9, a6), ad(b8, a7),
         sb(a7, b8), sb(a6, b9), sb(a5, a10), sb(a4, a11),
         sb(a3, a12), sb(a2, a13), sb(a1, b14), sb(a0, b15)], axis=1)


def _mpvq_deindex_batch(dim, k_val, kmax, ls_ind, index):
    """mpvq_deindex_fx for a fixed (dim, k_val) over [B] lanes.
    Returns (pulses [B, dim], ber [B])."""
    offs = fd._MPVQ_OFFS if hasattr(fd, "_MPVQ_OFFS") else None
    h0 = list(__import__("audio_codec_tpu.ops.fixed_dec",
                         fromlist=["x"])._MPVQ_OFFS[dim][: k_val + 2])
    if k_val != kmax:
        h0[k_val + 1] >>= 1
    size = 1 + h0[k_val + 1] + (h0[k_val] >> 1)
    index = jnp.asarray(index, I64)
    B = index.shape[0]
    ber = jnp.where((dim != 1) & (index >= size), 1, 0)
    index = jnp.where(ber == 1, 0, index)
    K = k_val + 2
    h = jnp.broadcast_to(jnp.asarray(np.asarray(h0, I64)), (B, K)).copy() \
        if False else jnp.tile(jnp.asarray(np.asarray(h0, I64))[None, :],
                               (B, 1))
    leading_sign = jnp.where(jnp.asarray(ls_ind, I64) != 0, -1, 1)
    k_max = jnp.full((B,), k_val, I64)
    ind = index
    done = jnp.zeros((B,), bool)
    outs = []
    for pos in range(dim):
        active = ~done
        emit0 = active & (ind == 0)
        val0 = jnp.where(leading_sign >= 0, k_max, -k_max)
        # k_acc = largest k <= k_max with h[k] <= ind (h nondecreasing)
        karr = jnp.arange(K, dtype=I64)[None, :]
        le = (karr <= k_max[:, None]) & (h <= ind[:, None])
        k_acc = jnp.sum(le, axis=1) - 1
        k_acc = jnp.clip(k_acc, 0, k_val)
        h_kacc = jnp.take_along_axis(h, k_acc[:, None], axis=1)[:, 0]
        ind2 = ind - h_kacc
        k_delta = k_max - k_acc
        moved = active & ~emit0 & (k_delta != 0)
        val = jnp.where(moved,
                        jnp.where(leading_sign >= 0, k_delta, -k_delta), 0)
        leading_sign = jnp.where(moved,
                                 jnp.where((ind2 & 1) != 0, -1, 1),
                                 leading_sign)
        ind3 = jnp.where(moved, ind2 >> 1, ind2)
        k_max2 = jnp.where(moved, k_acc, k_max)
        # a_bwd update of h over i = 1..k_max2+1 (only for still-active)
        upd_lane = active & ~emit0
        a0 = jnp.zeros((B,), I64)
        hn = h
        for i in range(1, K):
            do = upd_lane & (i <= k_max2 + 1)
            a1 = hn[:, i] - a0 - hn[:, i - 1]
            hn = hn.at[:, i - 1].set(jnp.where(do, a0, hn[:, i - 1]))
            a0 = jnp.where(do, a1, a0)
        # h[k_max2+1] = a0
        onehot = (jnp.arange(K, dtype=I64)[None, :]
                  == (k_max2 + 1)[:, None]) & upd_lane[:, None]
        hn = jnp.where(onehot, a0[:, None], hn)
        h = hn
        outs.append(jnp.where(emit0, val0, jnp.where(moved, val, 0)))
        done = done | emit0
        ind = jnp.where(active, ind3, ind)
        k_max = jnp.where(active, k_max2, k_max)
    return jnp.stack(outs, axis=1), ber


_SNS_KVAL = ((10, 1), (10, 0), (8, 0), (6, 0))
_SNS_GAINS = ("fx_sns_vq_reg_adj_gains", "fx_sns_vq_reg_lf_adj_gains",
              "fx_sns_vq_near_adj_gains", "fx_sns_vq_far_adj_gains")
_TABLED_KMAX = {6: 2, 10: 22, 16: 12}


def sns_decode_scf(scf_idx):
    """processSnsQuantizeScfDecoder_fx, batched. scf_idx [B, 7].
    Returns (scf_q [B, 16], ber [B])."""
    scf_idx = jnp.asarray(scf_idx, I64)
    idx0, idx1, submode, gidx, ls, mpvq, idxB = (scf_idx[:, k]
                                                 for k in range(7))
    lf = _t("fx_st1SCF0_7_base5_32x8_Q14").reshape(32, 8)
    hf = _t("fx_st1SCF8_15_base5_32x8_Q14").reshape(32, 8)
    scf = jnp.concatenate([_gat(lf, idx0), _gat(hf, idx1)], axis=1)
    gvals = jnp.stack([_gat(_t(n), gidx) for n in _SNS_GAINS], axis=1)
    gval = jnp.take_along_axis(gvals, jnp.clip(submode, 0, 3)[:, None],
                               axis=1)[:, 0]
    # run all four submode deindex configurations, select per lane
    p0a, b0a = _mpvq_deindex_batch(10, 10, _TABLED_KMAX[10], ls, mpvq)
    p0b, b0b = _mpvq_deindex_batch(6, 1, _TABLED_KMAX[6], idxB & 1,
                                   idxB >> 1)
    p2, b2 = _mpvq_deindex_batch(16, 8, _TABLED_KMAX[16], ls, mpvq)
    p3, b3 = _mpvq_deindex_batch(16, 6, _TABLED_KMAX[16], ls, mpvq)
    z6 = jnp.zeros((scf.shape[0], 6), I64)
    pul_r0 = jnp.concatenate([p0a, p0b], axis=1)   # submode 0
    pul_r1 = jnp.concatenate([p0a, z6], axis=1)    # submode 1
    sm = submode[:, None]
    pulses = jnp.where(sm == 0, pul_r0,
                       jnp.where(sm == 1, pul_r1,
                                 jnp.where(sm == 2, p2, p3)))
    ber = jnp.where(submode == 0, b0a | b0b,
                    jnp.where(submode == 1, b0a,
                              jnp.where(submode == 2, b2, b3)))
    maxk = jnp.asarray(np.asarray([10, 10, 8, 6], I64))[
        jnp.clip(submode, 0, 3)]
    # pvq_dec_en1_norm with per-lane k_val_max: shift_num = norm_s(maxk)
    y = pulses
    L_yy = jnp.sum(y * y, axis=1)
    small = L_yy < 64
    tab = _gat(_t("fx_isqrt_Q16tab"), jnp.clip(L_yy, 0, 63))
    t2v, e2v = isqrt16(L_yy & 0xFFFF, jnp.full_like(L_yy, 15))
    big = shl16v(t2v, e2v + 1)
    isqrt_q16 = jnp.where(small, tab, big)
    shift_num = fd.norm_s(maxk)
    shift_tot = 13 - shift_num
    L = fd.L_mult(isqrt_q16[:, None], shl16v(y, shift_num[:, None]))
    en1 = fd.round_fx(fd.L_shl(L, shift_tot[:, None]))
    warped = idct16(en1)
    out = fd.sat16(scf + fd.mult_r(gval[:, None], warped))
    return out, ber


# ----------------------------------------------------------- transform

def batch_dct4(y, y_e, N, frame_dms=100):
    """fi.batch_dct4 on device: same flow, jnp arrays, reusing the
    backend-generic dct_IV core."""
    y = jnp.asarray(y, I64)
    B = y.shape[0]
    y_e = jnp.asarray(y_e, I64)
    max_bw = fi.MAX_BW >> {25: 2, 50: 1, 100: 0}[frame_dms]
    if N > max_bw:
        y = y.at[:, max_bw:].set(0)
    nz = y != 0
    n = jnp.where(nz, fd.norm_l(jnp.where(nz, y, 1)), 32)
    y_s = jnp.min(n, axis=1)
    zero = y_s >= 32
    ys_eff = jnp.where(zero, 0, y_s)
    pd = [fd.L_shl(y[:, j], ys_eff) for j in range(N)]
    y_e = y_e - ys_eff
    pd, sc_add = fi.dct_IV(pd, N)
    y_e = y_e + sc_add
    out = jnp.stack(pd, axis=1)           # [B, N]
    nz2 = out != 0
    n2 = jnp.where(nz2, fd.norm_l(jnp.where(nz2, out, 1)), 32)
    y_s2 = jnp.min(n2, axis=1) - 1
    y_e = y_e - (y_s2 + 3)
    if N <= 20:
        y_e += 2
    elif N <= 120:
        y_e += 1
    y_e = jnp.where(zero, 0, y_e)
    return out, y_e, y_s2, zero


def imdct_ola(ytda, y_e, y_s, zero, w, N, wLen, mem, mem_e):
    """fi.imdct_ola batched over [B]: per-frame scalars become [B]
    vectors. Returns (x [B, N], y_e', new_mem, new_mem_e)."""
    z = 2 * N - wLen
    m = N >> 1
    o = m - z
    memLen = wLen - N
    y = jnp.asarray(ytda, I64)
    y_e = jnp.where(zero, 0, jnp.asarray(y_e, I64))
    y_s = jnp.asarray(y_s, I64)
    nz = mem != 0
    nmem = jnp.where(nz, fd.norm_l(jnp.where(nz, mem, 1)) - 16, 16)
    mem_s = jnp.min(nmem, axis=1) if memLen else jnp.full(y_e.shape, 16, I64)
    has_hr = mem_s < 16
    mem_s = jnp.where(has_hr, mem_s - 1, mem_s)
    mem_e = jnp.where(has_hr, mem_e - mem_s, y_e)
    s = mem_e - y_e
    pos = s > 0
    y_s = jnp.where(pos, y_s - s, y_s)
    y_e = jnp.where(pos, y_e + s, y_e)
    mem_s = jnp.where(pos, mem_s, mem_s + s)
    mem_e = jnp.where(pos, mem_e, mem_e - s)
    mem_s = jnp.maximum(mem_s, -31)
    y_s = jnp.maximum(y_s, -31)

    w = jnp.asarray(np.asarray(w, I64))
    ms = mem_s[:, None]
    ys = y_s[:, None]
    i_o = np.arange(o)
    x0 = fd.round_fx(fi.lsub(
        fd.L_shl(mem[:, :o] << 16, ms),
        fd.mpy_32_16(fd.L_shl(y[:, m + i_o + z], ys),
                     w[4 * m - 1 - i_o - z][None, :])))
    i_m = np.arange(m)
    x1 = fd.round_fx(fi.ladd(
        fd.L_shl(mem[:, o: o + m] << 16, ms),
        fd.mpy_32_16(fd.L_shl(y[:, 2 * m - 1 - i_m], ys),
                     w[3 * m - 1 - i_m][None, :])))
    xa = fd.round_fx(fi.lneg(fd.mpy_32_16(fd.L_shl(y[:, i_m], ys),
                                          w[m - 1 - i_m][None, :])))
    xb = fd.round_fx(fi.lneg(fd.mpy_32_16(fd.L_shl(y[:, i_m], ys),
                                          w[m + i_m][None, :])))
    # x[3m-z : 4m-z] = xa ; x[3m-z-1-i] = xb  (i ascending)
    xb_rev = xb[:, ::-1]                  # positions 2m-z .. 3m-z-1
    x = jnp.concatenate([x0, x1, xb_rev, xa], axis=1)  # [B, 4m-z] = wLen
    new_mem = x[:, N: N + memLen]
    return x[:, :N], y_e, new_mem, y_e


def round_pcm16(x, x_e):
    """dec_lc3.c:289-295 batched: (x [B,N] Word16-ish, x_e [B])."""
    s = 15 - jnp.asarray(x_e, I64)
    v = jnp.asarray(x, I64) << 16
    vr = v >> jnp.clip(s, 0, 63)[:, None]
    vl = fd.sat32(v << jnp.clip(-s, 0, 63)[:, None])
    v = jnp.where((s >= 0)[:, None], vr, vl)
    v = fd.sat32(v + 0x8000) >> 16
    return fd.sat16(v).astype(jnp.int16)
