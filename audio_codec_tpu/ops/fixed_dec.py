"""Integer-exact LC3plus decoder stages (ITU-T BASOP semantics).

The testvec conformance gate hashes *fixed-point* decoder output
(testvec/testvecCheck.pl:17-21, md5_dec.txt; "fixed point version only",
testvec/Readme.txt:20-22), so bit-exact decode requires reproducing the
fixed-point arithmetic, not the float math. This module implements the
fixed decoder's spectral chain with exact BASOP semantics
(dec_lc3.c:103-235):

    ari scaling -> residual decode -> noise filling -> global gain ->
    TNS lattice synthesis -> SNS interpolation + shaping

verified bit-exact per stage against the instrumented fixed-point oracle
(tests/test_fixed_dec.py; dumps from tools/instrument_oracle.py). The
Word32 spectrum q_d_fx and its block exponent q_fx_exp are carried
exactly as in the C. The remaining stages toward the full MD5 gate — the
fixed IMDCT (dct4_fx over BASOP_cfft) and the fixed LTPF — are the
ops/fixed_imdct.py, ops/fixed_ltpf.py and the PLC modules complete the chain.

Pure NumPy int64 (values constrained to 16/32-bit ranges): this is the
conformance-mode path, not the serving path; the float chain in
models/decoder.py remains the production decoder.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T

I64 = np.int64
MIN32, MAX32 = -(1 << 31), (1 << 31) - 1
MIN16, MAX16 = -(1 << 15), (1 << 15) - 1


def _t(name):
    return np.asarray(T.t(name)).astype(I64)


# ------------------------------------------------------- BASOP primitives
#
# Backend-generic: the primitives accept NumPy arrays / Python ints (the
# host conformance path) OR jax arrays / tracers (the batched device port,
# ops/fixed_dev.py — which requires jax_enable_x64 so that i64 products of
# Word32 values are exact). The stage functions below this section remain
# host-only; their batched device counterparts live in fixed_dev.py.

def _B(*xs):
    """numpy for host values, jax.numpy for jax arrays/tracers."""
    for x in xs:
        if not isinstance(x, (np.ndarray, np.generic, int, float,
                              list, tuple)):
            import jax
            import jax.numpy as jnp
            assert jax.config.jax_enable_x64, \
                "fixed-point device path needs jax_enable_x64 (i64 exactness)"
            return jnp
    return np


def _as64(xp, v):
    return xp.asarray(v, I64)


def sat32(x):
    xp = _B(x)
    return xp.clip(_as64(xp, x), MIN32, MAX32).astype(I64)


def sat16(x):
    xp = _B(x)
    return xp.clip(_as64(xp, x), MIN16, MAX16).astype(I64)


def bitlen(x):
    """Bit length of non-negative int64 values (exact below 2^53)."""
    xp = _B(x)
    x = _as64(xp, x)
    e = xp.frexp(x.astype(xp.float64))[1]
    return xp.where(x > 0, e, 0).astype(I64)


def norm_s(x):
    """Leading-sign-bit count minus 1 (basop32 norm_s); norm_s(0) = 0."""
    xp = _B(x)
    x = _as64(xp, x)
    mag = xp.where(x < 0, ~x, x)  # ~x = -x-1 for negatives
    return xp.where(x == 0, 0, 15 - bitlen(mag)).astype(I64)


def norm_l(x):
    xp = _B(x)
    x = _as64(xp, x)
    mag = xp.where(x < 0, ~x, x)
    return xp.where(x == 0, 0, 31 - bitlen(mag)).astype(I64)


def L_shl(x, s):
    """Saturating left shift; negative s = arithmetic right shift."""
    xp = _B(x, s)
    x = _as64(xp, x)
    s = _as64(xp, s)
    sl = xp.clip(s, 0, 63)
    left = sat32(xp.where(xp.abs(x) >> xp.maximum(31 - sl, 0) > 0,
                          xp.where(x >= 0, MAX32, MIN32),
                          x << sl))
    right = x >> xp.minimum(-xp.clip(s, -63, 0), 63)
    return xp.where(s >= 0, left, right).astype(I64)


def mpy_32_16(x, y):
    """Mpy_32_16: sat32((x*y) >> 15), floor (enh40.c:126-148; the final
    L_Extract40 saturates, and MIN32*MIN16 is special-cased to MAX32)."""
    xp = _B(x, y)
    return sat32((_as64(xp, x) * _as64(xp, y)) >> 15)


def mpy_32_32(x, y):
    """Mpy_32_32: sat32((x*y) >> 31), floor (enh40.c:204-232) — int64
    products of two 32-bit values fit: |xy| <= 2^62."""
    xp = _B(x, y)
    return sat32((_as64(xp, x) * _as64(xp, y)) >> 31)


def round_fx(L):
    xp = _B(L)
    return sat16((sat32(_as64(xp, L) + 0x8000)) >> 16)


def mult_r(a, b):
    xp = _B(a, b)
    return sat16((_as64(xp, a) * _as64(xp, b) + 0x4000) >> 15)


def mac_r(L, a, b):
    xp = _B(L, a, b)
    return round_fx(sat32(_as64(xp, L) + sat32((_as64(xp, a) * b) << 1)))


def L_mult(a, b):
    xp = _B(a, b)
    return sat32((_as64(xp, a) * _as64(xp, b)) << 1)


# ------------------------------------------------------------- stages

def ari_scaling(sq):
    """processAriDecoderScaling_fx (ari_codec.c): int16 spectrum ->
    normalized Word32 + exponent. sq: [N] ints. Returns (x32, x_e)."""
    sq = np.asarray(sq, I64)
    mx = np.max(np.abs(sq), initial=0)
    shift = 15 if mx == 0 else int(norm_s(mx))
    return (sq << 16) << shift, 15 - shift


def residual_decode(x32, x_e, prm, res_bits):
    """processResidualDecoding_fx (residual_decoding_fx.c:15-80).
    prm: iterable of 0/1 residual bits."""
    x = np.array(x32, I64)
    s = x_e - 1  # L_shr: negative s shifts left (saturating)
    fac_m = int(0x0C000000 >> s) if s >= 0 else int(sat32(0x0C000000 << -s))
    fac_p = int(0x14000000 >> s) if s >= 0 else int(sat32(0x14000000 << -s))
    bits = 0
    for i in range(len(x)):
        if bits >= res_bits:
            break
        if x[i] != 0:
            if prm[bits] == 0:
                x[i] = sat32(x[i] - (fac_m if x[i] > 0 else fac_p))
            else:
                x[i] = sat32(x[i] + (fac_p if x[i] > 0 else fac_m))
            bits += 1
    return x


def noise_filling(xq, nfseed, xq_e, fac_ns_idx, bw_idx, frame_dms,
                  fac_ns_pc=0, spec_inv_idx=1 << 14):
    """processNoiseFilling_fx (noise_filling_fx.c:12-140)."""
    xq = np.array(xq, I64)
    N = int(_t("BW_cutoff_bin_all")[bw_idx])
    if frame_dms == 25:
        N >>= 2
        nfw, nfs = 1, 6
    elif frame_dms == 50:
        N >>= 1
        nfw, nfs = 2, 12
    else:
        nfw, nfs = 3, 24
    nzeros = -2 * nfw - 1
    ind = []
    for k in range(nfs - nfw, nfs + nfw):
        nzeros = -2 * nfw - 1 if xq[k] != 0 else nzeros + 1
    for k in range(nfs, N - nfw):
        nzeros = -2 * nfw - 1 if xq[k + nfw] != 0 else nzeros + 1
        if nzeros >= 0:
            ind.append(k)
    for k in range(N - nfw, N):
        nzeros += 1
        if nzeros >= 0:
            ind.append(k)
    if ind:
        fac_ns = (8 - fac_ns_idx) << 11
        sh = xq_e - 16
        tmp = fac_ns >> sh if sh >= 0 else sat32(fac_ns << -sh)
        tmp_pc = fac_ns_pc >> sh if sh >= 0 else sat32(fac_ns_pc << -sh)
        for k in ind:
            nfseed = ((13849 + nfseed * 31821) & 0xFFFF)
            nfseed = nfseed - 0x10000 if nfseed >= 0x8000 else nfseed
            v = tmp if k < spec_inv_idx else tmp_pc
            xq[k] = v if nfseed >= 0 else -v
    return xq, nfseed


def inv_log2(x):
    """BASOP_Util_InvLog2 (basop_util.c:88-135): 2^(x in Q25) in Q31."""
    x = int(x)
    if x < -1040187392:
        return 0
    if x >= 1040187392 or x == 0:
        return MAX32
    frac = x & 0x3FF
    i3 = (x >> 10) & 0x1F
    i2 = (x >> 15) & 0x1F
    i1 = (x >> 20) & 0x1F
    exp = (x >> 25)  # arithmetic shift of 32-bit value
    if x > 0:
        exp = 31 - exp
    else:
        exp = -exp
    e3 = _t("fx_exp2x_tab_long")
    e2 = _t("fx_exp2w_tab_long")
    e1 = _t("fx_exp2_tab_long")
    lookup3f = int(e3[i3]) + (int(mpy_32_16(0x0016302F, frac)) >> 1)
    lookup12 = int(mpy_32_32(e1[i1], e2[i2]))
    lookup = int(mpy_32_32(lookup12, lookup3f))
    s = exp - 3
    return lookup >> s if s >= 0 else int(sat32(lookup << -s))


def apply_global_gain(x32, x_e, gg_idx, gg_off):
    """processApplyGlobalGain_fx (apply_global_gain_fx.c:12-42)."""
    tmp32 = int(sat32(((gg_idx + gg_off) * 0x797D) << 7))
    gg_e = (tmp32 >> 25) + 1  # extract_l(L_shr_pos(tmp32, 25)) + 1
    gg = int(round_fx(inv_log2(tmp32 | -33554432)))  # | 0xFE000000
    return mpy_32_16(np.asarray(x32, I64), gg), x_e + gg_e


def tns_decode(rc_idx, x32, x_e, order, bw_idx, frame_dms):
    """processTnsDecoder_fx (tns_decoder_fx.c:12-135). rc_idx: [16] ints
    (8 per filter); order: [2]."""
    x = np.array(x32, I64)
    pts = _t("fx_tnsQuantPts")
    N = len(x)
    bw_stop = int(_t("BW_cutoff_bin_all")[bw_idx])
    if frame_dms == 25:
        start = [3]
        bw_stop >>= 2
    elif frame_dms == 50:
        start = [6]
        bw_stop >>= 1
    else:
        start = [12]
    numf = 1
    if bw_idx >= 3 and frame_dms >= 50:
        numf = 2
        start.append(bw_stop >> 1)
    if not (order[0] > 0 or (numf == 2 and order[1] > 0)):
        return x, x_e
    f = start[0] if not (numf == 2 and order[0] == 0) else start[1]
    s1 = _scale_factor32(x[:f])
    s2 = _scale_factor32(x[f:])
    s = min(s1, s2 - 7)
    x_e = x_e - s
    state = np.zeros(8, I64)
    x[:f] = L_shl(x[:f], s)
    stopfreq = 0
    for j in range(numf):
        if order[j] <= 0:
            continue
        rc = pts[np.asarray(rc_idx[j * 8: j * 8 + order[j]], I64)]
        stopfreq = bw_stop if not (numf == 2 and j == 0) else start[1]
        for i in range(start[j], stopfreq):
            xi = int(L_shl(x[i], s))
            o = order[j]
            xi = sat32(xi - int(mpy_32_16(state[o - 1], rc[o - 1])))
            for k in range(o - 2, -1, -1):
                xi = sat32(xi - int(mpy_32_16(state[k], rc[k])))
                state[k + 1] = sat32(state[k] + int(mpy_32_16(xi, rc[k])))
            state[0] = xi
            x[i] = xi
    x[stopfreq:] = L_shl(x[stopfreq:], s)
    return x, x_e


def _scale_factor32(x):
    """getScaleFactor32 (basop_util.c:370-410): headroom, 0 if all zero."""
    x = np.asarray(x, I64)
    if len(x) == 0 or not np.any(x):
        return 0
    return int(np.min(norm_l(x[x != 0])))


def inv_log2_16(x):
    """BASOP_Util_InvLog2_16 (basop_util.c:865-875): x log2 in Q11 ->
    (mantissa Q15, exponent)."""
    t1 = _t("fx_InvLog2_16_table1")
    t2 = _t("fx_InvLog2_16_table2")
    x = np.asarray(x, I64)
    tmp1 = (x & 2047) >> 5
    tmp2 = (x & 31) << 4
    y = mac_r(t1[tmp1], t2[tmp1], tmp2)
    y_e = (x >> 11) + 1
    return y, y_e


def sns_interpolate(scf_q, n_bands):
    """processSnsInterpolateScf_fx (sns_interpolate_scf_fx.c), decoder
    direction. scf_q: [16] Word16 (log2 Q11). Returns (scf, scf_exp)."""
    scf_q = np.asarray(scf_q, I64)
    scf_int = np.zeros(64, I64)
    scf_int[0] = scf_q[0]
    scf_int[1] = scf_q[0]
    tmp2 = 0
    for i in range(1, 16):
        d = sat16(scf_q[i] - scf_q[i - 1])
        tmp2 = int(mult_r(d, 8192))
        tmp = int(mult_r(d, 4096))
        scf_int[i * 4 - 2] = sat16(scf_q[i - 1] + tmp)
        scf_int[i * 4 - 1] = sat16(scf_int[i * 4 - 2] + tmp2)
        scf_int[i * 4] = sat16(scf_int[i * 4 - 1] + tmp2)
        scf_int[i * 4 + 1] = sat16(scf_int[i * 4] + tmp2)
    scf_int[62] = sat16(scf_int[61] + tmp2)
    scf_int[63] = sat16(scf_int[62] + tmp2)
    if n_bands < 32:
        t = 32 - n_bands
        tmp_arr = scf_int.copy()
        for i in range(t):
            scf_int[i] = sat16(
                int(mac_r(L_mult(tmp_arr[4 * i], 8192), tmp_arr[4 * i + 1], 8192))
                + int(mac_r(L_mult(tmp_arr[4 * i + 2], 8192),
                            tmp_arr[4 * i + 3], 8192)))
        for i in range(n_bands - t):
            scf_int[t + i] = mac_r(L_mult(tmp_arr[4 * t + 2 * i], 16384),
                                   tmp_arr[4 * t + 2 * i + 1], 16384)
    elif n_bands < 64:
        t = 64 - n_bands
        for i in range(t):
            scf_int[i] = mac_r(L_mult(scf_int[2 * i], 16384),
                               scf_int[2 * i + 1], 16384)
        for i in range(t, n_bands):
            scf_int[i] = scf_int[t + i]
    scf, scf_e = inv_log2_16(scf_int[:n_bands])
    return scf, scf_e


def scf_scaling(scf_exp, x_e):
    """processScfScaling (mdct_shaping_fx.c:36-60)."""
    scf_exp = np.asarray(scf_exp, I64)
    m = int(scf_exp.max())
    return scf_exp - m, x_e + m


def mdct_shaping(x32, scf, scf_exp, bands_offset):
    """processMdctShaping_fx (mdct_shaping_fx.c:14-30)."""
    x = np.array(x32, I64)
    bo = np.asarray(bands_offset, I64)
    for i in range(len(scf)):
        lo, hi = int(bo[i]), int(bo[i + 1])
        x[lo:hi] = L_shl(mpy_32_16(x[lo:hi], int(scf[i])), int(scf_exp[i]))
    return x


# ------------------------------------------------- fixed SNS decoder
#
# processSnsQuantizeScfDecoder_fx (sns_quantize_scf_fx.c:552): stage-1
# split-VQ codebook lookup + stage-2 MPVQ deindex, energy normalization,
# idct16 warp and gain scaling — all Word16 arithmetic.

def msu_r(L, a, b):
    return round_fx(sat32(np.asarray(L, I64) - sat32((np.asarray(a, I64) * b) << 1)))


def shl16(x, s):
    """Word16 saturating left shift (negative s = right shift)."""
    x = int(x)
    if s >= 0:
        return int(sat16(x << min(s, 31)))
    return x >> min(-s, 31)


def _pascal_A(dim, kmax):
    """MPVQ offset column A(dim, 0..kmax) + top U(dim, kmax+1), exact
    integers (the tabled h_memN{16,10,6}K* vectors, constants.c:2560-2632,
    are this recurrence evaluated at the per-dim worst-case K)."""
    A = [0, 1] + [1] * kmax          # A(1, k)
    for n in range(2, dim + 1):
        row = [0] * (kmax + 2)
        for k in range(1, kmax + 2):
            row[k] = A[k] + A[k - 1] + row[k - 1]
        A = row
    return A[: kmax + 1] + [A[kmax + 1] >> 1]


_TABLED_KMAX = {6: 2, 10: 22, 16: 12}
_MPVQ_OFFS = {d: _pascal_A(d, k) for d, k in _TABLED_KMAX.items()}


def mpvq_deindex(dim, k_val, ls_ind, index):
    """mpvq_deindex_fx (pvq_index_fx.c:313-345) incl. the h_mem setup of
    get_size_mpvq_calc_offset_fx; returns (pulse vector, ber_flag)."""
    kmax = _TABLED_KMAX[dim]
    h = list(_MPVQ_OFFS[dim][: k_val + 2])
    if k_val != kmax:
        h[k_val + 1] >>= 1              # A(K+1) -> U(K+1)
    size = 1 + h[k_val + 1] + (h[k_val] >> 1)
    ber = 0
    if dim != 1 and index >= size:      # pvq_dec_deidx_fx safety check
        ber, index = 1, 0
    vec = [0] * dim
    leading_sign = -1 if ls_ind else 1
    if k_val == 0:
        return vec, ber
    k_max, ind = k_val, int(index)
    for pos in range(dim):
        if ind == 0:
            vec[pos] = k_max if leading_sign >= 0 else -k_max
            break
        k_acc = k_max
        while ind < h[k_acc]:
            k_acc -= 1
        ind -= h[k_acc]
        k_delta = k_max - k_acc
        if k_delta != 0:
            vec[pos] = k_delta if leading_sign >= 0 else -k_delta
            leading_sign = -1 if (ind & 1) else 1
            ind >>= 1
            k_max -= k_delta
        a0 = 0                           # a_bwd_fx over h[0..k_max+1]
        for i in range(1, k_max + 2):
            a1 = h[i] - a0 - h[i - 1]
            h[i - 1] = a0
            a0 = a1
        h[k_max + 1] = a0
    return vec, ber


def isqrt16(mantissa, exponent):
    """ISqrt16 (basop_util.c:212-233): 1/sqrt of a Word16 mantissa."""
    pre = int(norm_s(mantissa))
    e = exponent - pre
    m = shl16(mantissa, pre)
    idx = int(mac_r(-32768 - (32 << 16), m, 1 << 6))
    frac = m & 0x1FF
    m = int(msu_r(_t("fx_ISqrtTable")[idx], int(_t("fx_ISqrtDiffTable")[idx]), frac))
    if (e & 1) == 0:
        m = int(mult_r(m, 0x5A82))
    return m, int(msu_r(1 << 15, e, 1 << 14))


def pvq_dec_en1_norm(y, k_val_max):
    """pvq_dec_en1_normQ14_fx (pvq_dec_fx.c:69-118)."""
    L_yy = int(np.sum(np.asarray(y, I64) ** 2))
    if L_yy < 64:
        isqrt_q16 = int(_t("fx_isqrt_Q16tab")[L_yy])
    else:
        tmp, exp = isqrt16(L_yy & 0xFFFF, 15)
        isqrt_q16 = shl16(tmp, exp + 1)
    shift_num = int(norm_s(k_val_max))
    shift_tot = 13 - shift_num
    xq = []
    for v in y:
        L = int(L_mult(isqrt_q16, shl16(int(v), shift_num)))
        xq.append(int(round_fx(L_shl(L, shift_tot))))
    return xq


def idct16(x):
    """idct16_fx (dct2_fx.c:120-215): Word16 inverse DCT-II butterflies."""
    def m(a, c):
        return int(mult_r(a, c))

    def ad(a, b):
        return int(sat16(a + b))

    def sb(a, b):
        return int(sat16(a - b))

    i = [int(v) for v in x]
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
    return [ad(b15, a0), ad(b14, a1), ad(a13, a2), ad(a12, a3),
            ad(a11, a4), ad(a10, a5), ad(b9, a6), ad(b8, a7),
            sb(a7, b8), sb(a6, b9), sb(a5, a10), sb(a4, a11),
            sb(a3, a12), sb(a2, a13), sb(a1, b14), sb(a0, b15)]


_SNS_GAINS = ("fx_sns_vq_reg_adj_gains", "fx_sns_vq_reg_lf_adj_gains",
              "fx_sns_vq_near_adj_gains", "fx_sns_vq_far_adj_gains")
_SNS_KVAL = ((10, 1), (10, 0), (8, 0), (6, 0))


def sns_decode_scf(scf_idx):
    """processSnsQuantizeScfDecoder_fx (sns_quantize_scf_fx.c:552-574):
    scf_idx = L_scf_idx[7] from the side-info/ari parse -> scf_q[16]
    (Word16). Returns (scf_q, ber_flag)."""
    idx0, idx1, submode, gidx, ls, mpvq, idxB = [int(v) for v in scf_idx]
    lf = _t("fx_st1SCF0_7_base5_32x8_Q14")
    hf = _t("fx_st1SCF8_15_base5_32x8_Q14")
    scf = [int(v) for v in lf[idx0 * 8: idx0 * 8 + 8]] + \
          [int(v) for v in hf[idx1 * 8: idx1 * 8 + 8]]
    gval = int(_t(_SNS_GAINS[submode])[gidx])
    if submode >> 1:                      # outlier near/far: one 16-dim shape
        pulses, ber = mpvq_deindex(16, _SNS_KVAL[submode][0], ls, mpvq)
        maxk = _SNS_KVAL[submode][0]
    else:                                 # regular: set A (10) + set B (6)
        pulses, ber = mpvq_deindex(10, _SNS_KVAL[submode][0], ls, mpvq)
        maxk = _SNS_KVAL[submode][0]
        if (submode & 1) == 0:
            pb, ber2 = mpvq_deindex(6, _SNS_KVAL[submode][1], idxB & 1, idxB >> 1)
            pulses = pulses + pb
            ber |= ber2
        else:
            pulses = pulses + [0] * 6
    en1 = pvq_dec_en1_norm(pulses, maxk)
    warped = idct16(en1)
    out = [int(sat16(scf[i] + int(mult_r(gval, warped[i])))) for i in range(16)]
    return np.asarray(out, I64), ber


def spectral_chain(cfg, sq, side, res_prm, fill_bits, nf_seed, scf_q):
    """Full integer spectral reconstruction for one clean frame
    (dec_lc3.c:156-235): returns (q_d_fx, q_fx_exp) at the IMDCT input.

    sq: int spectrum from the arithmetic decoder; side: dict with gg_idx,
    fac_ns_idx, bw_idx, tns_order [2], tns_idx [16]; res_prm: residual
    bits; scf_q: fixed-point dequantized scale factors (Word16 log2 Q11).
    """
    x, x_e = ari_scaling(sq)
    x = residual_decode(x, x_e, res_prm, fill_bits)
    x, _ = noise_filling(x, nf_seed, x_e, side["fac_ns_idx"],
                         side["bw_idx"], cfg.frame_dms)
    x, x_e = apply_global_gain(x, x_e, side["gg_idx"], cfg.quantizedGainOff)
    x, x_e = tns_decode(side["tns_idx"], x, x_e, side["tns_order"],
                        side["bw_idx"], cfg.frame_dms)
    scf, scf_e = sns_interpolate(scf_q, cfg.bands_number)
    scf_e, x_e = scf_scaling(scf_e, x_e)
    bo = np.asarray(T.bands_offset(cfg.fs_idx, cfg.frame_dms, cfg.hrmode))
    x = mdct_shaping(x, scf, scf_e, bo)
    return x, x_e
