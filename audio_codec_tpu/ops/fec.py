"""LC3plus channel coder (error protection): batched GF(16) Reed-Solomon.

Batched equivalent of the reference's fixed-point channel coder
(fixed_point/al_fec.c:481 fec_encoder, :711 fec_decoder). The reference
processes one slot at a time with scalar table lookups and data-dependent
control flow; here every step is a batched int32 array op over [B, ...]:

- GF(16) arithmetic is a 256-entry gathered mult table (al_fec.c:66-86).
- RS encoding is a GF-linear map: redundancy = XOR-reduce of
  mult(data_i, basis_i) with basis_i = x^(d+i) mod gp precomputed in numpy
  (replaces the LFSR division in rs16_enc, al_fec.c:560-612).
- Syndromes S_k = cw(g^(k+1)) are a gathered multiply + XOR-reduce
  (replaces the unrolled rs16_calculate_*_syndromes, al_fec.c:1465-1790).
- Error-locator factorization is a Chien search over all 15 field points
  evaluated in parallel (replaces the deg2/deg3 zero tables used by
  rs16_factorize_elp, al_fec.c:1981).
- Mode detection / risk analysis (rs16_detect_and_correct, al_fec.c:1014)
  is computed for ALL candidate modes in parallel and the reference's
  sort-and-try-first-decodable loop becomes a lexicographic argmin.
- CRC1/CRC2 (al_fec.c:2185,2257) are GF(2)-linear, so each becomes a
  position-table gather + XOR-reduce instead of a sequential shift loop.

Interleaving, codeword segmentation, CRC sizes and payload split are static
per (slot_bytes, mode) and precomputed in numpy (get_n_codewords /
get_codeword_length / fec_get_data_size / fec_get_n_pc / fec_get_n_pccw,
al_fec.c:200-357).

All spec constants (signaling polynomials, risk table, CRC generator
polynomials, bit-error limits) are from ETSI TS 103 634; generator
polynomials, syndrome tables, ELP zero sets and CRC mask tables are
re-derived programmatically from first principles.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

I32 = jnp.int32

RS16_CW_LEN_MAX = 15
FEC_SLOT_BYTES_MIN = 40
FEC_SLOT_BYTES_MAX = 300

# error report flags (al_fec.c:42-48)
BEC_MASK = 0x0FFF >> 1
EP_OK = tuple((0x1000 << i) >> 1 for i in range(4))
ALL_OK = EP_OK[0] | EP_OK[1] | EP_OK[2] | EP_OK[3]

# ---------------------------------------------------------------------------
# GF(16) tables — generated from the field definition (poly x^4+x+1 = 19,
# unit group generator g = 2; al_fec.c:71-86).
# ---------------------------------------------------------------------------


def _gf_mul_scalar(a: int, b: int) -> int:
    r = 0
    for _ in range(4):
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 16:
            a ^= 0b10011
    return r


_MUL = np.array([[_gf_mul_scalar(a, b) for b in range(16)]
                 for a in range(16)], np.int32)
_MUL_FLAT = jnp.asarray(_MUL.reshape(-1))
G_POW = np.ones(15, np.int32)
for _i in range(1, 15):
    G_POW[_i] = _gf_mul_scalar(int(G_POW[_i - 1]), 2)
G_LOG = np.zeros(16, np.int32)
for _i in range(15):
    G_LOG[G_POW[_i]] = _i
_INV = np.zeros(16, np.int32)
for _a in range(1, 16):
    _INV[_a] = G_POW[(15 - G_LOG[_a]) % 15]
_INV_J = jnp.asarray(_INV)


def gf_mul(a, b):
    """Batched GF(16) multiply via the flat 256-entry table."""
    return jnp.take(_MUL_FLAT, a * 16 + b)


def gf_inv(a):
    return jnp.take(_INV_J, a)


def _xor_reduce(x, axis: int):
    return jax.lax.reduce(x, np.int32(0), jax.lax.bitwise_xor, (axis,))


def _gf_poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + len(b) - 1, np.int32)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] ^= _gf_mul_scalar(int(ai), int(bj))
    return out


def _gp_for_hd(hd: int) -> np.ndarray:
    """RS16 generator polynomial with roots g^1..g^(hd-1), low-to-high coeffs
    (monic; matches rs16_gp_d3/d5/d7, al_fec.c:89-91)."""
    gp = np.array([1], np.int32)
    for j in range(1, hd):
        gp = _gf_poly_mul(gp, np.array([G_POW[j % 15], 1], np.int32))
    return gp


def _rs_basis(hd: int, max_data: int) -> np.ndarray:
    """basis[i, k]: coefficient k of (x^(d+i) mod gp), d = hd-1.

    RS encoding is GF-linear, so the parity of a data word equals
    XOR_i gf_mul(data_i, basis[i]) (systematic form of rs16_enc)."""
    d = hd - 1
    gp = _gp_for_hd(hd)
    basis = np.zeros((max_data, max(d, 1)), np.int32)
    # rem_{i+1} = (rem_i * x) mod gp, starting from x^d mod gp
    rem = np.zeros(d + 1, np.int32)
    rem[d] = 1
    for i in range(max_data):
        # reduce leading term
        lead = rem[d]
        r = rem.copy()
        r[d] = 0
        for k in range(d):
            r[k] ^= _gf_mul_scalar(int(lead), int(gp[k]))
        basis[i] = r[:d] if d else np.zeros(0, np.int32)
        # multiply by x
        rem = np.concatenate([[0], r[:d]])
        rem = np.append(rem, 0)[: d + 1]
    return basis


# syndrome evaluation points: S_k = cw(g^(k+1)), k = 0..5
_SYND_POW = np.array([[G_POW[((k + 1) * i) % 15] for i in range(15)]
                      for k in range(6)], np.int32)

# FEC mode signaling polynomials, coefficients 0..12 (spec constants,
# al_fec.c:97-100; row m-1 is XORed onto the first 13 nibbles of the first
# six codewords in EP mode m; mode 1's polynomial is zero).
_SIG_POLYS = np.zeros((4, 15), np.int32)
_SIG_POLYS[1, :13] = [7, 15, 5, 6, 14, 9, 1, 3, 12, 10, 13, 3, 2]
_SIG_POLYS[2, :13] = [7, 11, 14, 1, 2, 3, 12, 11, 6, 15, 7, 6, 12]
_SIG_POLYS[3, :13] = [6, 15, 12, 2, 9, 15, 2, 8, 12, 3, 10, 5, 4]

# syndromes of the signaling polynomials (derived, = sig_poly_syndr
# al_fec.c:102-105)
_SIG_SYNDR = np.zeros((4, 6), np.int32)
for _m in range(4):
    for _k in range(6):
        acc = 0
        for _i in range(15):
            acc ^= _gf_mul_scalar(int(_SIG_POLYS[_m, _i]),
                                  int(_SYND_POW[_k, _i]))
        _SIG_SYNDR[_m, _k] = acc

# fec config data (al_fec.c:115-134)
_HD_MODE0 = [1, 3, 3, 5, 7]   # first codeword, by external mode
_HD_MODE1 = [1, 1, 3, 5, 7]   # remaining codewords
_CRC1_BYTES_40 = [0, 3, 2, 2, 2]
_CRC1_BYTES = [0, 3, 3, 3, 3]
_CRC2_BYTES = [0, 0, 2, 2, 2]
_LOW_BR_MAX_BIT_ERRORS = [0, 0, 3, 9, 18]

# risk table: simple_float (mantissa, exponent) pairs, rows = internal mode
# (EP m+1), cols = number of corrected symbols (al_fec.c:129-133)
_RISK_M = np.array([[16384, 16384, 16384, 16384],
                    [16384, 26880, 16384, 16384],
                    [16384, 26880, 20475, 16384],
                    [16384, 26880, 20475, 19195]], np.int32)
_RISK_E = np.array([[0, 0, 0, 0],
                    [-8, -1, 0, 0],
                    [-16, -9, -2, 0],
                    [-24, -17, -10, -4]], np.int32)

# mode-detection risk thresholds (al_fec.c:54-57)
_EP_RISK_THRESH_NS = (21990, -23)
_EP_RISK_THRESH_OS = (25166, -10)

# CRC generator polynomials (degree-14/22 with epmr embedding, degree-16),
# spec constants; the 16-entry mask tables in the reference
# (al_fec.c:2177-2254) equal (t << deg) ^ ((t * x^deg) mod P) — the fully
# reducing form — and are re-derived here from the polynomials alone.
_CRC1_POLY = {2: (0x4645, 14), 3: (0x490F29, 22)}
_CRC2_POLY = {2: (0x1A2EB, 16)}


def _clmul(a: int, b: int) -> int:
    r = 0
    while a:
        if a & 1:
            r ^= b
        a >>= 1
        b <<= 1
    return r


def _clmod(a: int, p: int) -> int:
    deg_p = p.bit_length() - 1
    while a.bit_length() - 1 >= deg_p:
        a ^= p << (a.bit_length() - 1 - deg_p)
    return a


def _crc_pos_table(n_nibbles: int, hash_bytes: int, poly: int,
                   shift: int) -> np.ndarray:
    """tab[i, v] = contribution of data nibble v at index i to the final CRC
    remainder. The mask step fully reduces mod P each iteration, so nibble i
    contributes v * x^(4*(i + 2*hash_bytes)) mod P (the data loop runs from
    the last nibble down and 2h trailing steps follow, al_fec.c:2222-2246)."""
    del shift
    tab = np.zeros((max(n_nibbles, 1), 16), np.int64)
    for i in range(n_nibbles):
        sh = 4 * (i + 2 * hash_bytes)
        for v in range(16):
            tab[i, v] = _clmod(v << sh, poly)
    return tab.astype(np.int32)


def _crc1_epmr_table(hash_bytes: int, poly: int, shift: int) -> np.ndarray:
    """Contribution of the epmr injection ((epmr<<2) * x^(4*(2h-1)) mod P)
    plus the raw epmr bits placed above the CRC (al_fec.c:2230-2246)."""
    tab = np.zeros(4, np.int64)
    for e in range(4):
        tab[e] = _clmod((e << 2) << (4 * (2 * hash_bytes - 1)), poly) \
            ^ (e << shift)
    return tab.astype(np.int32)


# ---------------------------------------------------------------------------
# Static slot geometry (get_n_codewords / get_codeword_length /
# fec_get_data_size / fec_get_n_pc / fec_get_n_pccw, al_fec.c:200-357)
# ---------------------------------------------------------------------------


def n_codewords(slot_bytes: int) -> int:
    return (2 * slot_bytes + RS16_CW_LEN_MAX - 1) // RS16_CW_LEN_MAX


def codeword_length(slot_bytes: int, i: int) -> int:
    return (2 * slot_bytes - i - 1) // n_codewords(slot_bytes) + 1


def crc1_bytes(mode: int, slot_bytes: int) -> int:
    return (_CRC1_BYTES_40 if slot_bytes == 40 else _CRC1_BYTES)[mode]


def fec_get_n_pccw(slot_bytes: int, mode: int, ccc_flag: int) -> int:
    if mode == 3:
        n = (2 * 2636 * slot_bytes - 117377 + 0x8000) >> 16
    elif mode == 4:
        n = (2 * 2178 * slot_bytes - 129115 + 0x8000) >> 16
    else:
        n = 0
    if ccc_flag == 1 or slot_bytes < 80:
        n = 0
    return n


def fec_get_n_pc(mode: int, n_pccw: int, slot_bytes: int) -> int:
    ncw = n_codewords(slot_bytes)
    if mode == 1 or slot_bytes < 80:
        return 0
    return -2 * n_pccw * (mode - 1) + sum(
        (2 * slot_bytes + i) // ncw for i in range(n_pccw))


def fec_get_data_size(mode: int, ccc_flag: int, slot_bytes: int) -> int:
    payload = slot_bytes
    if mode > 0:
        payload -= 1 if mode == 1 else n_codewords(slot_bytes) * (mode - 1)
        payload -= crc1_bytes(mode, slot_bytes)
        if ccc_flag == 0 and mode > 2 and slot_bytes >= 80:
            payload -= _CRC2_BYTES[mode]
    return payload


@functools.lru_cache(maxsize=None)
def _slot_plan(slot_bytes: int):
    """Static index maps shared by all modes for one slot size."""
    assert FEC_SLOT_BYTES_MIN <= slot_bytes <= FEC_SLOT_BYTES_MAX
    ncw = n_codewords(slot_bytes)
    n_nib = 2 * slot_bytes
    lens = np.array([codeword_length(slot_bytes, i) for i in range(ncw)],
                    np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    # interleave: codeword i pos j  <->  output nibble n_nib-1-(j*ncw+i)
    il_src = np.zeros(n_nib, np.int32)      # out-nibble -> cw-stream pos
    for i in range(ncw):
        for j in range(lens[i]):
            il_src[n_nib - 1 - (j * ncw + i)] = offs[i] + j
    il_dst = np.argsort(il_src).astype(np.int32)  # cw-stream pos -> out nib
    # cw matrix gather: [ncw, 15] -> cw-stream pos (or n_nib for zero pad)
    cw_gather = np.full((ncw, RS16_CW_LEN_MAX), n_nib, np.int32)
    for i in range(ncw):
        cw_gather[i, :lens[i]] = offs[i] + np.arange(lens[i])
    return dict(ncw=ncw, n_nib=n_nib, lens=lens, offs=offs,
                il_src=il_src, il_dst=il_dst, cw_gather=cw_gather)


@functools.lru_cache(maxsize=None)
def _mode_plan(slot_bytes: int, mode: int, ccc_flag: int):
    """Static per-(slot, external mode) layout: redundancy nibbles per cw,
    dw<->cw maps, CRC tables, bitswap indices."""
    sp = _slot_plan(slot_bytes)
    ncw, n_nib = sp["ncw"], sp["n_nib"]
    hd0, hd1 = _HD_MODE0[mode], _HD_MODE1[mode]
    red = np.array([hd0 - 1] + [hd1 - 1] * (ncw - 1), np.int32)
    data_bytes = fec_get_data_size(mode, ccc_flag, slot_bytes)
    n_crc1 = crc1_bytes(mode, slot_bytes)
    n_pccw = fec_get_n_pccw(slot_bytes, mode, ccc_flag)
    pc_split = fec_get_n_pc(mode, n_pccw, slot_bytes)
    n_crc2 = _CRC2_BYTES[mode] if (pc_split > 0 and mode > 1) else 0
    dw_len = n_nib - int(red.sum())
    assert dw_len == 2 * (data_bytes + n_crc1 + n_crc2)
    # dw index -> cw-stream position
    dw_pos = np.zeros(dw_len, np.int32)
    k = 0
    for i in range(ncw):
        for j in range(red[i], sp["lens"][i]):
            dw_pos[k] = sp["offs"][i] + j
            k += 1
    # per-cw data gather for RS parity: [ncw, 15] -> dw index (pad dw_len);
    # only the first 13 columns are consumed where a basis exists (hd >= 3)
    max_data = RS16_CW_LEN_MAX - (hd1 - 1) if mode != 1 else RS16_CW_LEN_MAX
    data_gather = np.full((ncw, RS16_CW_LEN_MAX), dw_len, np.int32)
    k = 0
    for i in range(ncw):
        nd = sp["lens"][i] - red[i]
        data_gather[i, :nd] = k + np.arange(nd)
        k += nd
    # parity scatter positions: [ncw, 6] -> cw-stream pos (pad n_nib)
    par_pos = np.full((ncw, 6), n_nib, np.int32)
    for i in range(ncw):
        par_pos[i, :red[i]] = sp["offs"][i] + np.arange(red[i])
    # dw0 bitswap indices within the dw stream (dw0_bitswap, al_fec.c:358);
    # dw index ind1 lands at codeword-0 position cw0_len-1 (the EPMR nibble)
    # once the hd0-1 redundancy nibbles are inserted ahead of it
    cw0_len = int(sp["lens"][0])
    ind0 = 2 * n_crc1 - 1
    ind1 = cw0_len - 1 - (hd0 - 1)
    # basis for RS parity
    basis0 = _rs_basis(hd0, 13) if hd0 > 1 else None
    basis1 = _rs_basis(hd1, 13) if hd1 > 1 else None
    # CRC position tables
    crc1_n = 2 * data_bytes - pc_split
    c1_poly, c1_shift = _CRC1_POLY[n_crc1] if n_crc1 else (0, 0)
    crc1_tab = (_crc_pos_table(crc1_n, n_crc1, c1_poly, c1_shift)
                if n_crc1 else None)
    crc1_epmr = _crc1_epmr_table(n_crc1, c1_poly, c1_shift) if n_crc1 else None
    crc2_tab = (_crc_pos_table(pc_split, n_crc2, *_CRC2_POLY[2])
                if n_crc2 else None)
    # partial-concealment nibble counts by codeword count (fec_get_n_pc)
    pc_nib = np.array([fec_get_n_pc(mode, k, slot_bytes)
                       for k in range(n_pccw + 2)], np.int32)
    return dict(sp=sp, mode=mode, red=red, data_bytes=data_bytes,
                n_crc1=n_crc1, n_crc2=n_crc2, n_pccw=n_pccw,
                pc_split=pc_split, dw_len=dw_len, dw_pos=dw_pos,
                data_gather=data_gather, par_pos=par_pos, ind0=ind0,
                ind1=ind1, basis0=basis0, basis1=basis1, crc1_tab=crc1_tab,
                crc1_epmr=crc1_epmr, crc2_tab=crc2_tab, pc_nib=pc_nib,
                max_data=max_data)


# ---------------------------------------------------------------------------
# Batched primitives
# ---------------------------------------------------------------------------


def _bytes_to_dw(data):
    """[B, D] bytes -> [B, 2D] reversed nibble stream (fec_data_preproc,
    al_fec.c:425-433): ascending dw = [hi, lo] of bytes in reverse order."""
    rev = data[:, ::-1]
    return jnp.stack([rev >> 4, rev & 15], axis=-1).reshape(data.shape[0], -1)


def _dw_to_bytes(dw, data_bytes: int):
    """Inverse of _bytes_to_dw over the top 2*data_bytes nibbles
    (fec_data_postproc, al_fec.c:674-678)."""
    top = dw[:, dw.shape[1] - 2 * data_bytes:]
    pairs = top.reshape(dw.shape[0], data_bytes, 2)
    return (pairs[:, ::-1, 0] * 16) | pairs[:, ::-1, 1]


def _crc_eval(tab_np, nibbles):
    """XOR-reduce of per-position contribution gathers. nibbles [B, n]."""
    idx = jnp.arange(tab_np.shape[0])[None, :] * 16 + nibbles
    vals = jnp.take(jnp.asarray(tab_np.reshape(-1)), idx)
    return _xor_reduce(vals, 1)


def _crc1_rem(mp, nibbles, epmr):
    """crc1 remainder incl. epmr embedding (al_fec.c:2185-2251)."""
    rem = _crc_eval(mp["crc1_tab"], nibbles)
    return rem ^ jnp.take(jnp.asarray(mp["crc1_epmr"]), epmr)


def _rem_to_hash(rem, hash_bytes: int):
    """[B] remainder -> [B, 2*hash_bytes] nibble hash (LSB nibble first)."""
    sh = 4 * jnp.arange(2 * hash_bytes, dtype=I32)
    return (rem[:, None] >> sh[None, :]) & 15


def _bitswap(dw, ind0: int, ind1: int):
    """Swap bits 2,3 of dw[ind0] with bits 0,1 of dw[ind1] (dw0_bitswap,
    al_fec.c:358-385). Involution: same op decodes."""
    a, b = dw[:, ind0], dw[:, ind1]
    new_a = (a & 3) | ((b & 3) << 2)
    new_b = (b & 12) | ((a >> 2) & 3)
    return dw.at[:, ind0].set(new_a).at[:, ind1].set(new_b)


def _rs_parity(mp, dw):
    """Per-codeword RS parity nibbles via the linear basis.

    dw: [B, dw_len]. Returns [B, ncw, 6] (only first red[i] cols valid)."""
    sp = mp["sp"]
    ncw = sp["ncw"]
    dwp = jnp.concatenate([dw, jnp.zeros((dw.shape[0], 1), I32)], axis=1)
    cw_data = dwp[:, mp["data_gather"]]           # [B, ncw, 13]
    out = jnp.zeros((dw.shape[0], ncw, 6), I32)
    for which, rows in ((0, [0]), (1, list(range(1, ncw)))):
        basis = mp["basis0"] if which == 0 else mp["basis1"]
        if basis is None or basis.shape[1] == 0:
            continue
        d = basis.shape[1]
        bas = jnp.asarray(basis)                  # [13, d]
        sel = cw_data[:, rows, :13]               # [B, r, 13]
        prod = gf_mul(sel[..., None], bas[None, None, :, :])  # [B,r,13,d]
        par = _xor_reduce(prod, 2)                # [B, r, d]
        pad = jnp.zeros((dw.shape[0], len(rows), 6 - d), I32)
        out = out.at[:, jnp.asarray(rows), :].set(
            jnp.concatenate([par, pad], axis=-1))
    return out


def _syndromes6(cw_mat):
    """All six syndromes for every codeword. cw_mat [B, ncw, 15] -> [B,ncw,6].

    S_k = cw(g^(k+1)); replaces rs16_calculate_*_syndromes."""
    pw = jnp.asarray(_SYND_POW)                   # [6, 15]
    prod = gf_mul(cw_mat[:, :, None, :], pw[None, None, :, :])
    return _xor_reduce(prod, 3)


def _peterson_elp(s, t: int):
    """Error-locator polynomial via Peterson's algorithm, branchless.

    s: [..., 6] syndromes (first 2t used). Returns (elp [..., 4] with
    elp0=1, deg [...]) where deg = t+1 flags failure (rs16_calculate_elp,
    al_fec.c:1794-1976)."""
    z = jnp.zeros(s.shape[:-1], I32)
    s0, s1 = s[..., 0], s[..., 1]
    all_zero = (s0 | s1) == 0
    if t >= 2:
        all_zero &= (s[..., 2] | s[..., 3]) == 0
    if t >= 3:
        all_zero &= (s[..., 4] | s[..., 5]) == 0

    # degree attempts, highest first; once a determinant is nonzero the
    # reference commits to that degree (failure => deg = t+1, no fallback)
    e1_1 = gf_mul(s1, gf_inv(s0))
    lsf1 = jnp.zeros_like(z)
    for k in range(1, 2 * t - 1):
        lsf1 |= gf_mul(e1_1, s[..., k]) ^ s[..., k + 1]
    commit1 = s0 != 0
    ok1 = commit1 & (lsf1 == 0) & (e1_1 != 0)

    # lowest-priority attempt first; later (higher-degree) commits override
    deg = jnp.full_like(z, t + 1)
    elp1, elp2, elp3 = z, z, z
    deg = jnp.where(commit1, jnp.where(ok1, 1, t + 1), deg)
    elp1 = jnp.where(ok1, e1_1, elp1)

    if t >= 2:
        det2 = gf_mul(s0, s[..., 2]) ^ gf_mul(s1, s1)
        di2 = gf_inv(det2)
        e1_2 = gf_mul(gf_mul(s1, s[..., 2]) ^ gf_mul(s0, s[..., 3]), di2)
        e2_2 = gf_mul(gf_mul(s[..., 2], s[..., 2]) ^ gf_mul(s1, s[..., 3]),
                      di2)
        lsf2 = jnp.zeros_like(z)
        for k in range(2, 2 * t - 2):
            lsf2 |= (gf_mul(e2_2, s[..., k]) ^ gf_mul(e1_2, s[..., k + 1])
                     ^ s[..., k + 2])
        commit2 = det2 != 0
        ok2 = commit2 & (lsf2 == 0) & (e2_2 != 0)
        deg = jnp.where(commit2, jnp.where(ok2, 2, t + 1), deg)
        elp1 = jnp.where(commit2, jnp.where(ok2, e1_2, 0), elp1)
        elp2 = jnp.where(commit2, jnp.where(ok2, e2_2, 0), elp2)

    if t >= 3:
        s2, s3, s4, s5 = s[..., 2], s[..., 3], s[..., 4], s[..., 5]
        s22 = gf_mul(s1, s1)
        s33 = gf_mul(s2, s2)
        s44 = gf_mul(s3, s3)
        s13 = gf_mul(s0, s2)
        det3 = (gf_mul(s13, s4) ^ gf_mul(s44, s0)
                ^ gf_mul(s22, s4) ^ gf_mul(s33, s2))
        di3 = gf_inv(det3)
        s14, s15 = gf_mul(s0, s3), gf_mul(s0, s4)
        s23, s24, s25 = gf_mul(s1, s2), gf_mul(s1, s3), gf_mul(s1, s4)
        s34, s35 = gf_mul(s2, s3), gf_mul(s2, s4)
        a = s35 ^ s44
        b = s15 ^ s33
        c = s13 ^ s22
        d = s34 ^ s25
        e = s23 ^ s14
        f = s24 ^ s33
        e3_3 = gf_mul(gf_mul(a, s3) ^ gf_mul(d, s4) ^ gf_mul(f, s5), di3)
        e2_3 = gf_mul(gf_mul(d, s3) ^ gf_mul(b, s4) ^ gf_mul(e, s5), di3)
        e1_3 = gf_mul(gf_mul(f, s3) ^ gf_mul(e, s4) ^ gf_mul(c, s5), di3)
        commit3 = det3 != 0
        ok3 = commit3 & (e3_3 != 0)
        deg = jnp.where(commit3, jnp.where(ok3, 3, t + 1), deg)
        elp1 = jnp.where(commit3, jnp.where(ok3, e1_3, 0), elp1)
        elp2 = jnp.where(commit3, jnp.where(ok3, e2_3, 0), elp2)
        elp3 = jnp.where(commit3, jnp.where(ok3, e3_3, 0), elp3)

    deg = jnp.where(all_zero, 0, deg)
    elp1 = jnp.where(all_zero, 0, elp1)
    elp2 = jnp.where(all_zero, 0, elp2)
    elp3 = jnp.where(all_zero, 0, elp3)
    return jnp.stack([jnp.ones_like(z), elp1, elp2, elp3], axis=-1), deg


def _chien(elp, deg, max_pos):
    """Parallel Chien search (replaces rs16_factorize_elp, al_fec.c:1981).

    elp [..., 4], deg [...], max_pos scalar or [...]. Returns
    (fail [...], err_pos [..., 3] int32, padded 15)."""
    X = jnp.asarray(G_POW)                        # [15]
    X2 = gf_mul(X, X)
    X3 = gf_mul(X2, X)
    # reciprocal poly rp(X) = X^3 + e1 X^2 + e2 X + e3 evaluated at X = g^p;
    # padding zero coefficients only adds X = 0 roots, which g^p never hits.
    val = (X3 ^ gf_mul(elp[..., 1:2], X2) ^ gf_mul(elp[..., 2:3], X)
           ^ elp[..., 3:4])
    is_root = (val == 0) & (deg[..., None] > 0)
    n_roots = is_root.astype(I32).sum(-1)
    pos = jnp.arange(15, dtype=I32)
    pos_or_big = jnp.where(is_root, pos, 15)
    err_pos = jnp.sort(pos_or_big, axis=-1)[..., :3]
    max_pos = jnp.asarray(max_pos)
    in_range = jnp.where(jnp.arange(3) < deg[..., None],
                         err_pos <= max_pos[..., None], True)
    fail = (n_roots != deg) | ~jnp.all(in_range, axis=-1)
    fail &= deg > 0
    return fail, err_pos


def _forney(err_pos, deg, s):
    """Error magnitudes by Cramer's rule on sum_i e_i X_i^(k+1) = S_k
    (replaces rs16_calculate_errors, al_fec.c:2079-2172).

    err_pos [..., 3], deg [...], s [..., 6] -> err_symb [..., 3]."""
    Xp = jnp.take(jnp.asarray(G_POW), err_pos % 15)   # [..., 3]
    X0, X1, X2 = Xp[..., 0], Xp[..., 1], Xp[..., 2]
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    # deg 1
    e0_1 = gf_mul(gf_inv(X0), s0)
    # deg 2: A = [[X0, X1], [X0^2, X1^2]]
    x0q, x1q, x2q = gf_mul(X0, X0), gf_mul(X1, X1), gf_mul(X2, X2)
    det2 = gf_mul(x0q, X1) ^ gf_mul(x1q, X0)
    di2 = gf_inv(det2)
    e0_2 = gf_mul(gf_mul(x1q, s0) ^ gf_mul(X1, s1), di2)
    e1_2 = gf_mul(gf_mul(x0q, s0) ^ gf_mul(X0, s1), di2)
    # deg 3: Cramer via cofactors (matches al_fec.c:2125-2165)
    det3 = gf_mul(gf_mul(X1 ^ X0, X2 ^ X0), X2 ^ X1)
    di3 = gf_inv(det3)

    def _e(xa, xb, xaq, xbq, xo):
        c0 = gf_mul(xa, xbq) ^ gf_mul(xb, xaq)
        c1 = xbq ^ xaq
        c2 = xb ^ xa
        num = gf_mul(c0, s0) ^ gf_mul(c1, s1) ^ gf_mul(c2, s2)
        return gf_mul(gf_mul(num, di3), gf_inv(xo))

    e0_3 = _e(X1, X2, x1q, x2q, X0)
    e1_3 = _e(X0, X2, x0q, x2q, X1)
    e2_3 = _e(X0, X1, x0q, x1q, X2)

    e0 = jnp.where(deg == 1, e0_1, jnp.where(deg == 2, e0_2, e0_3))
    e1 = jnp.where(deg == 2, e1_2, e1_3)
    z = jnp.zeros_like(e0)
    e0 = jnp.where(deg >= 1, e0, z)
    e1 = jnp.where(deg >= 2, e1, z)
    e2 = jnp.where(deg >= 3, e2_3, z)
    return jnp.stack([e0, e1, e2], axis=-1)


_BITCNT = jnp.asarray([0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4],
                      I32)


# simple_float arithmetic (al_fec.c:122-126, 2310-2377): (mantissa, exponent)
# int pairs; mantissa normalized to [16384, 32768).


def _sf_mul(m1, e1, m2, e2):
    aux = (m1 * m2) >> 14
    e = e1 + e2
    hi = (aux & 32768) != 0
    return jnp.where(hi, aux >> 1, aux), jnp.where(hi, e + 1, e)


def _sf_le(m1, e1, m2, e2):
    """op1 <= op2 (simple_float_cmp <= 0)."""
    return (e1 < e2) | ((e1 == e2) & (m1 <= m2))


def _sf_lt(m1, e1, m2, e2):
    return (e1 < e2) | ((e1 == e2) & (m1 < m2))


# ---------------------------------------------------------------------------
# Encoder (fec_encoder, al_fec.c:481-557)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("slot_bytes", "mode",
                                             "ccc_flag"))
def fec_encode(data, epmr, *, slot_bytes: int, mode: int, ccc_flag: int = 0):
    """Batched channel-coder encode.

    data: [B, data_bytes] int32 payload bytes (data_bytes must equal
    fec_get_data_size(mode, ccc_flag, slot_bytes)); epmr: [B] in 0..3.
    Returns [B, slot_bytes] int32 protected frame bytes.
    """
    mp = _mode_plan(slot_bytes, mode, ccc_flag)
    sp = mp["sp"]
    assert data.shape[1] == mp["data_bytes"], (data.shape, mp["data_bytes"])
    B = data.shape[0]
    data = data.astype(I32)
    epmr = jnp.clip(epmr.astype(I32), 0, 3)

    dwd = _bytes_to_dw(data)                       # [B, 2D]
    parts = []
    if mp["n_crc1"]:
        rem1 = _crc1_rem(mp, dwd[:, : dwd.shape[1] - mp["pc_split"]], epmr)
        parts.append(_rem_to_hash(rem1, mp["n_crc1"]))
    if mp["n_crc2"]:
        rem2 = _crc_eval(mp["crc2_tab"], dwd[:, dwd.shape[1] - mp["pc_split"]:])
        parts.append(_rem_to_hash(rem2, mp["n_crc2"]))
    dw = jnp.concatenate(parts + [dwd], axis=1)
    assert dw.shape[1] == mp["dw_len"]

    dw = _bitswap(dw, mp["ind0"], mp["ind1"])
    parity = _rs_parity(mp, dw)                    # [B, ncw, 6]

    # assemble codeword stream (+1 dump slot for padded parity columns)
    cw = jnp.zeros((B, sp["n_nib"] + 1), I32)
    cw = cw.at[:, jnp.asarray(mp["dw_pos"])].set(dw)
    cw = cw.at[:, jnp.asarray(mp["par_pos"]).reshape(-1)].set(
        parity.reshape(B, -1), mode="drop")
    cw = cw[:, : sp["n_nib"]]

    # signaling polynomial on the first six codewords (rs16_enc signal_mode;
    # only applied where the codeword carries redundancy, al_fec.c:598-609)
    sig = np.zeros(sp["n_nib"], np.int64)
    for i in range(min(6, sp["ncw"])):
        if mp["red"][i] > 0:
            sig[sp["offs"][i]: sp["offs"][i] + 13] = _SIG_POLYS[mode - 1, :13]
    cw = cw ^ jnp.asarray(sig.astype(np.int32))

    nib = cw[:, jnp.asarray(sp["il_src"])]         # interleave
    pairs = nib.reshape(B, slot_bytes, 2)
    return pairs[:, :, 0] | (pairs[:, :, 1] << 4)


# ---------------------------------------------------------------------------
# Decoder (fec_decoder, al_fec.c:711-882; rs16_detect_and_correct,
# al_fec.c:1014-1463)
# ---------------------------------------------------------------------------


def _scatter_xor(cw_p, epos, errs):
    """XOR err symbols into cw_p [B, C, 16] at epos [B, C, 3] (col 15 is a
    dump slot for inactive error positions; errs must be pre-masked)."""
    B, C = cw_p.shape[0], cw_p.shape[1]
    b_ix = jnp.arange(B)[:, None]
    c_ix = jnp.arange(C)[None, :]
    for jj in range(3):
        pos = jnp.where(epos[:, :, jj] < 15, epos[:, :, jj], 15)
        cur = cw_p[b_ix, c_ix, pos]
        cw_p = cw_p.at[b_ix, c_ix, pos].set(cur ^ errs[:, :, jj])
    return cw_p


@functools.partial(jax.jit, static_argnames=("slot_bytes", "ccc_flag"))
def fec_decode(frames, *, slot_bytes: int, ccc_flag: int = 0, bfi_in=None):
    """Batched channel-coder decode with mode detection and RS correction.

    frames: [B, slot_bytes] int32 bytes. Returns a dict of per-stream
    arrays: data [B, slot_bytes] (payload left-aligned, zero padded),
    data_bytes, bfi (0/1/2), epmr (0..11), error_report, mode (1..4 or -1),
    n_pccw, n_pc, be_bp_left, be_bp_right.
    """
    sp = _slot_plan(slot_bytes)
    mps = {m: _mode_plan(slot_bytes, m, ccc_flag) for m in (1, 2, 3, 4)}
    ncw, n_nib = sp["ncw"], sp["n_nib"]
    cw0_len = int(sp["lens"][0])
    B = frames.shape[0]
    frames = frames.astype(I32)
    tt = (1, 2, 3)  # correctable symbols per internal mode (EP2, EP3, EP4)

    # unpack + deinterleave (fec_deinterleave_unpack, al_fec.c:884)
    nib = jnp.stack([frames & 15, frames >> 4], -1).reshape(B, n_nib)
    cws = nib[:, jnp.asarray(sp["il_dst"])]
    cw_pad = jnp.concatenate([cws, jnp.zeros((B, 1), I32)], 1)
    cw_mat = cw_pad[:, jnp.asarray(sp["cw_gather"])]        # [B, ncw, 15]
    synd6 = _syndromes6(cw_mat)                             # [B, ncw, 6]
    epmr_raw = cw_mat[:, 0, cw0_len - 1] & 3

    # ---- stage 1: EP1 detection via cw0 syndromes + CRC1 (al_fec.c:1102)
    mp1 = mps[1]
    ep1_syn_ok = (synd6[:, 0, 0] | synd6[:, 0, 1]) == 0
    dw1 = cws[:, jnp.asarray(mp1["dw_pos"])]
    dw1u = _bitswap(dw1, mp1["ind0"], mp1["ind1"])
    rem1 = _crc1_rem(mp1, dw1u[:, 2 * mp1["n_crc1"]:], epmr_raw)
    hash1 = _rem_to_hash(rem1, mp1["n_crc1"])
    ep1_ok = ep1_syn_ok & jnp.all(dw1u[:, :2 * mp1["n_crc1"]] == hash1, 1)

    # ---- stage 2: per-mode syndromes of codewords 0..5 (al_fec.c:1130)
    sig_syndr = jnp.asarray(_SIG_SYNDR[1:4])                # [3, 6]
    synd_m = synd6[:, None, :6, :] ^ sig_syndr[None, :, None, :]

    clean_l, deg_l, epos_l, chfail_l = [], [], [], []
    max_pos6 = jnp.asarray(sp["lens"][:6] - 1)[None, :]
    for m in range(3):
        t = tt[m]
        clean_l.append(jnp.all(synd_m[:, m, :, :2 * t] == 0, axis=(1, 2)))
        elp, deg = _peterson_elp(synd_m[:, m], t)
        fail, epos = _chien(elp, deg, max_pos6)
        deg_l.append(deg)
        epos_l.append(epos)
        chfail_l.append(fail)
    clean = jnp.stack(clean_l, 1)                           # [B, 3]
    deg_det = jnp.stack(deg_l, 1)                           # [B, 3, 6]
    epos_det = jnp.stack(epos_l, 1)                         # [B, 3, 6, 3]
    chfail_det = jnp.stack(chfail_l, 1)                     # [B, 3, 6]
    clean_any = jnp.any(clean, 1)
    clean_m = jnp.argmax(clean, 1)

    # ---- risk analysis + candidate selection (al_fec.c:1190-1290)
    thr_m, thr_e = (_EP_RISK_THRESH_NS if slot_bytes <= 40
                    else _EP_RISK_THRESH_OS)
    sel_m = jnp.full((B,), -1, I32)
    sel_e = jnp.zeros((B,), I32)
    sel_mant = jnp.zeros((B,), I32)
    risk_e_all = []
    for m in range(3):
        t = tt[m]
        blacklist = jnp.any(deg_det[:, m] > t, axis=1)
        dc = jnp.clip(deg_det[:, m], 0, 3)
        rm = jnp.take(jnp.asarray(_RISK_M[m + 1]), dc)      # [B, 6]
        re = jnp.take(jnp.asarray(_RISK_E[m + 1]), dc)
        pm, pe = jnp.full((B,), 16384, I32), jnp.zeros((B,), I32)
        for cw in range(6):
            pm, pe = _sf_mul(pm, pe, rm[:, cw], re[:, cw])
        risk_e_all.append((pm, pe))
        cand = ~blacklist & _sf_le(pm, pe, thr_m, thr_e)
        viable = cand & ~jnp.any(chfail_det[:, m], axis=1)
        better = viable & ((sel_m < 0) | _sf_lt(pm, pe, sel_mant, sel_e))
        sel_m = jnp.where(better, m, sel_m)
        sel_mant = jnp.where(better, pm, sel_mant)
        sel_e = jnp.where(better, pe, sel_e)

    det_m = jnp.where(clean_any, clean_m, sel_m)            # internal, -1=fail
    det_ok = clean_any | (sel_m >= 0)

    # ---- per-mode correction of all codewords + postproc
    lens_j = jnp.asarray(sp["lens"])
    flat_i = np.zeros(n_nib, np.int64)
    flat_j = np.zeros(n_nib, np.int64)
    for i in range(ncw):
        L = int(sp["lens"][i])
        o = int(sp["offs"][i])
        flat_i[o:o + L] = i
        flat_j[o:o + L] = np.arange(L)
    flat_i = jnp.asarray(flat_i.astype(np.int32))
    flat_j = jnp.asarray(flat_j.astype(np.int32))

    n_rem = ncw - 6
    per_mode = []
    for m in range(3):
        t = tt[m]
        mp = mps[m + 2]
        n_pccw0 = mp["n_pccw"]
        # first six codewords: detection-stage ELPs
        deg6 = deg_det[:, m]
        msk6 = (jnp.arange(3)[None, None, :] < deg6[:, :, None]) \
            & ~chfail_det[:, m, :, None] & (deg6 <= t)[:, :, None]
        errs6 = jnp.where(msk6, _forney(epos_det[:, m], deg6, synd_m[:, m]),
                          0)
        bits6 = jnp.take(_BITCNT, errs6).sum((1, 2))
        # remaining codewords: raw syndromes (sig poly only on first six)
        syndr = synd6[:, 6:, :]
        elpr, degr = _peterson_elp(syndr, t)
        failr, eposr = _chien(elpr, degr, (lens_j[6:] - 1)[None, :])
        hardfail = (degr > t) | failr
        mskr = (jnp.arange(3)[None, None, :] < degr[:, :, None]) \
            & ~hardfail[:, :, None]
        errsr = jnp.where(mskr, _forney(eposr, degr, syndr), 0)
        bitsr = jnp.take(_BITCNT, errsr).sum((1, 2))
        is_pc = (jnp.arange(6, ncw) >= ncw - n_pccw0)[None, :]
        bfi1 = jnp.any(hardfail & ~is_pc, 1)
        bfi2 = jnp.any(hardfail & is_pc, 1)
        # trust flags (al_fec.c:1407-1443): per PC codeword, 1 unless failed
        # or per-cw risk exponent > -16
        dcr = jnp.clip(degr, 0, 3)
        rer = jnp.take(jnp.asarray(_RISK_E[m + 1]), dcr)
        trust_cw = ~hardfail & ~(rer + 16 > 0)              # [B, n_rem]
        # mode_broken (al_fec.c:1330-1451): i < internal mode index + 1
        broken = []
        for i in range(4):
            b = jnp.zeros((B,), bool)
            if i < m + 1:
                b |= jnp.any(deg6 > i, 1)
                if n_rem:
                    b |= jnp.any(degr > i, 1)
            if n_rem:
                b |= jnp.any(hardfail, 1)
            broken.append(b)
        broken = jnp.stack(broken, 1)                       # [B, 4]
        # apply corrections + remove signaling polynomial
        cw_p = jnp.concatenate([cw_mat, jnp.zeros((B, ncw, 1), I32)], -1)
        cw_p = cw_p.at[:, :6].set(
            _scatter_xor(cw_p[:, :6], epos_det[:, m], errs6))
        if n_rem:
            cw_p = cw_p.at[:, 6:].set(
                _scatter_xor(cw_p[:, 6:], eposr, errsr))
        sig = jnp.asarray(_SIG_POLYS[m + 1, :15])
        cw_p = cw_p.at[:, :6, :15].set(cw_p[:, :6, :15] ^ sig[None, None, :])
        epmr_pos_val = cw_p[:, 0, cw0_len - 1] & 3
        # flatten and extract data words (fec_data_postproc, al_fec.c:645)
        flat = cw_p[:, flat_i, flat_j]
        dw = flat[:, jnp.asarray(mp["dw_pos"])]
        dw = _bitswap(dw, mp["ind0"], mp["ind1"])
        tmp_epmr = dw[:, 2 * mp["n_crc1"] - 1] >> 2
        c12 = 2 * (mp["n_crc1"] + mp["n_crc2"])
        remc = _crc1_rem(mp, dw[:, c12: c12 + mp["crc1_tab"].shape[0]],
                         tmp_epmr)
        crc1_ok = jnp.all(
            dw[:, :2 * mp["n_crc1"]] == _rem_to_hash(remc, mp["n_crc1"]), 1)
        if mp["n_crc2"]:
            rem2 = _crc_eval(mp["crc2_tab"], dw[:, dw.shape[1] - mp["pc_split"]:])
            crc2_ok = jnp.all(
                dw[:, 2 * mp["n_crc1"]: c12] == _rem_to_hash(rem2, mp["n_crc2"]),
                1)
        else:
            crc2_ok = jnp.ones((B,), bool)
        data = _dw_to_bytes(dw, mp["data_bytes"])
        data = jnp.concatenate(
            [data, jnp.zeros((B, slot_bytes - mp["data_bytes"]), I32)], 1)
        per_mode.append(dict(bits=bits6 + bitsr, bfi1=bfi1, bfi2=bfi2,
                             trust=trust_cw, broken=broken,
                             epmr_det=epmr_pos_val, tmp_epmr=tmp_epmr,
                             crc1_ok=crc1_ok, crc2_ok=crc2_ok, data=data,
                             deg0=jnp.clip(deg_det[:, m, 0], 0, 3)))

    # EP1 data path (stage-1 bitswap already undone on dw1u)
    data1 = _dw_to_bytes(dw1u, mp1["data_bytes"])
    data1 = jnp.concatenate(
        [data1, jnp.zeros((B, slot_bytes - mp1["data_bytes"]), I32)], 1)

    # ---- lane-wise selection over detected mode
    def sel3(key):
        stacked = jnp.stack([pm_[key] for pm_ in per_mode], 1)
        idx = jnp.clip(det_m, 0, 2)
        return jnp.take_along_axis(
            stacked, idx.reshape((B, 1) + (1,) * (stacked.ndim - 2)), axis=1
        )[:, 0]

    bits_sel = sel3("bits")
    bfi1_sel = sel3("bfi1")
    bfi2_sel = sel3("bfi2")
    broken_sel = sel3("broken")
    crc1_ok_sel = sel3("crc1_ok")
    crc2_ok_sel = sel3("crc2_ok")
    tmp_epmr_sel = sel3("tmp_epmr")
    epmr_det_sel = sel3("epmr_det")
    data_sel = sel3("data")
    deg0_sel = sel3("deg0")

    # epmr by path (al_fec.c:1177,1359-1370,1109): clean -> raw cw0 bits;
    # corrected -> corrected cw0 bits + risk increment; postproc may override
    exp0 = jnp.take(jnp.asarray(_RISK_E), (jnp.clip(det_m, 0, 2) + 1) * 4
                    + deg0_sel)
    incr = 8 - 4 * (exp0 <= -8).astype(I32) - 4 * (exp0 <= -16).astype(I32)
    epmr = jnp.where(clean_any, epmr_raw, epmr_det_sel + incr)

    # ---- total-failure EPMR estimate (fec_estimate_epmr_from_cw0,
    # al_fec.c:908-1010): consider internal modes EP3/EP4 on codeword 0 only
    est_exp = jnp.where(
        ep1_syn_ok | ((synd_m[:, 0, 0, 0] | synd_m[:, 0, 0, 1]) == 0),
        -8, 0)
    cand_es, risk_es, fact_es, epmr_es = [], [], [], []
    for m in (1, 2):  # internal EP3, EP4
        d0 = jnp.clip(deg_det[:, m, 0], 0, 3)
        re0 = jnp.take(jnp.asarray(_RISK_E[m + 1]), d0)
        rm0 = jnp.take(jnp.asarray(_RISK_M[m + 1]), d0)
        cand_es.append((deg_det[:, m, 0] <= tt[m]) & (re0 <= -8))
        risk_es.append((rm0, re0))
        fact_es.append(~chfail_det[:, m, 0])
        epmr_es.append(per_mode[m]["epmr_det"])
    r2_lt_r3 = _sf_lt(risk_es[0][0], risk_es[0][1],
                      risk_es[1][0], risk_es[1][1])
    both = cand_es[0] & cand_es[1]
    first_is_2 = jnp.where(both, r2_lt_r3, cand_es[0])
    pick2 = cand_es[0] & fact_es[0]
    pick3 = cand_es[1] & fact_es[1]
    use2 = pick2 & (first_is_2 | ~pick3)
    use3 = pick3 & ~use2
    est_exp = jnp.where(use2, risk_es[0][1],
                        jnp.where(use3, risk_es[1][1], est_exp))
    epmr_base = jnp.where(use2, epmr_es[0],
                          jnp.where(use3, epmr_es[1], epmr_raw))
    epmr_fail = epmr_base + 4 * (est_exp > -16).astype(I32) \
        + 4 * (est_exp > -8).astype(I32)

    # ---- assemble outputs with priority: ep1 > detected > failure
    broken_bits = jnp.zeros((B,), I32)
    for i in range(4):
        broken_bits |= jnp.where(broken_sel[:, i], 0, EP_OK[i])
    er = (bits_sel & BEC_MASK) | broken_bits
    er = jnp.where(bfi1_sel, BEC_MASK, er)
    bfi = jnp.where(bfi1_sel, 1, jnp.where(bfi2_sel, 2, 0))
    mode_ext = det_m + 2

    # low-bitrate error cap (al_fec.c:760-783)
    if slot_bytes == 40:
        lims = jnp.asarray(_LOW_BR_MAX_BIT_ERRORS, I32)
        bits_only = er & BEC_MASK
        over = bits_only > jnp.take(lims, jnp.clip(mode_ext, 0, 4))
        er = jnp.where((bits_only > lims[2]) & ~over, er & ~EP_OK[1], er)
        er = jnp.where((bits_only > lims[3]) & ~over, er & ~EP_OK[2], er)
        er = jnp.where(over, bits_only, er)
        bfi = jnp.where(over, 1, bfi)
        cap_fail = over
    else:
        cap_fail = jnp.zeros((B,), bool)

    # postproc CRC outcomes (skipped for lanes already dead)
    alive = det_ok & ~bfi1_sel & ~cap_fail
    crc1_fail = alive & ~crc1_ok_sel
    epmr = jnp.where(alive & crc1_ok_sel, tmp_epmr_sel, epmr)
    bfi = jnp.where(crc1_fail, 1, bfi)
    crc2_fail = alive & crc1_ok_sel & (bfi != 2) & ~crc2_ok_sel
    bfi = jnp.where(crc2_fail, 2, bfi)

    # ---- partial-concealment byte error positions (al_fec.c:840-870)
    be_left = jnp.full((B,), -1, I32)
    be_right = jnp.full((B,), -1, I32)
    for m in (1, 2):  # internal EP3/EP4 can carry PC codewords
        mp = mps[m + 2]
        n_pccw0 = mp["n_pccw"]
        if n_pccw0 == 0:
            continue
        trust = per_mode[m]["trust"]                        # [B, n_rem]
        # trust index j corresponds to codeword ncw-1-j. Keep the real
        # flags even on CRC2-only failures: the per-codeword risk check
        # (al_fec.c:1441-1444) can clear trust without setting bfi=2, and
        # the reference derives the span from array_of_trust as-is
        # (al_fec.c:840-870); all-trusted lanes fall into the
        # first_bad == n_pccw -> be_bp_left = 0 special case below.
        tr = trust[:, ::-1][:, :n_pccw0]                    # [B, n_pccw0]
        bad = ~tr
        any_bad = jnp.any(bad, 1)
        first_bad = jnp.where(any_bad, jnp.argmax(bad, 1), n_pccw0)
        last_bad = jnp.where(any_bad,
                             n_pccw0 - 1 - jnp.argmax(bad[:, ::-1], 1),
                             n_pccw0 - 1)
        pc_nib = jnp.asarray(mp["pc_nib"])
        left = jnp.where(first_bad == n_pccw0, 0,
                         4 * jnp.take(pc_nib, first_bad))
        right = 4 * jnp.take(pc_nib, last_bad + 1) - 1
        lane = (det_m == m) & (bfi == 2)
        be_left = jnp.where(lane, left, be_left)
        be_right = jnp.where(lane, right, be_right)

    # ---- final lane-priority merge
    data_out = jnp.where(ep1_ok[:, None], data1, data_sel)
    db_np = jnp.asarray([0] + [mps[m]["data_bytes"] for m in (1, 2, 3, 4)],
                        I32)
    pc_np = jnp.asarray([0] + [mps[m]["pc_split"] for m in (1, 2, 3, 4)], I32)
    npccw_np = jnp.asarray([0] + [mps[m]["n_pccw"] for m in (1, 2, 3, 4)],
                           I32)

    mode_f = jnp.where(ep1_ok, 1, jnp.where(det_ok, mode_ext, -1))
    bfi_f = jnp.where(ep1_ok, 0, jnp.where(det_ok, bfi, 1))
    er_f = jnp.where(ep1_ok, ALL_OK, jnp.where(det_ok, er, BEC_MASK))
    epmr_f = jnp.where(ep1_ok, epmr_raw,
                       jnp.where(det_ok, epmr, epmr_fail))
    dead = (bfi_f == 1) | (mode_f < 0)
    mode_f = jnp.where((bfi_f == 1) & ~ep1_ok & cap_fail, -1, mode_f)
    data_bytes = jnp.where(dead, 0, jnp.take(db_np, jnp.clip(mode_f, 0, 4)))
    n_pc = jnp.take(pc_np, jnp.clip(mode_f, 0, 4))
    n_pccw_o = jnp.take(npccw_np, jnp.clip(mode_f, 0, 4))
    data_out = jnp.where(dead[:, None], 0, data_out)
    be_left = jnp.where(bfi_f == 2, be_left, -1)
    be_right = jnp.where(bfi_f == 2, be_right, -1)

    if bfi_in is not None:
        was_bad = bfi_in == 1
        bfi_f = jnp.where(was_bad, 1, bfi_f)
        er_f = jnp.where(was_bad, -1, er_f)
        data_bytes = jnp.where(was_bad, 0, data_bytes)
        mode_f = jnp.where(was_bad, -1, mode_f)

    return dict(data=data_out, data_bytes=data_bytes, bfi=bfi_f,
                epmr=epmr_f, error_report=er_f, mode=mode_f,
                n_pccw=n_pccw_o, n_pc=n_pc, be_bp_left=be_left,
                be_bp_right=be_right)
