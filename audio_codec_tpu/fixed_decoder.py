"""Bit-exact fixed-point LC3plus decoder (conformance mode).

Chains the framework's own bitstream frontend (side-info parse + range
decoder, ops/bits.py + ops/ari.py — byte-exact integer outputs, run
batched over all frames under jit) into the integer-exact BASOP backend
(ops/fixed_dec.py spectral chain + SNS decode, ops/fixed_imdct.py,
ops/fixed_ltpf.py) and the fixed output rounding (dec_lc3.c:283-300).

This is the MD5-gate decoder (testvec/testvecCheck.pl, md5_dec.txt): its
int16 output must match the ETSI fixed-point decoder bit-for-bit.  The
serving path (models/decoder.py) remains the float chain; this
NumPy/host path exists for conformance and as the oracle for the batched
device port (fixed_decoder_dev.py).
"""
from __future__ import annotations

import functools

import numpy as np

from . import tables as T
from .config import Config
from .ops import ari, bits
from .ops import fixed_dec as fd
from .ops import fixed_imdct as fi
from .ops import fixed_ltpf as fl

I64 = np.int64


class _BerError(Exception):
    """Bit-error detected mid-parse (SNS MPVQ index out of range)."""


@functools.cache
def _frontend_jit(cfg: Config):
    import jax

    @jax.jit
    def run(buf, bfi_a, bl, br):
        side = bits.parse_side_info(cfg, buf)
        dec = ari.decode(cfg, buf, side, bfi_in=bfi_a,
                         be_bp_left=bl, be_bp_right=br)
        return side, dec
    return run


def _frontend(cfg: Config, frames_u8: np.ndarray, bfi_in=None,
              be_bp_left=None, be_bp_right=None):
    """Side-info parse + arithmetic decode for [n_frames, nbytes] frames
    (all integer outputs, exact).  bfi_in/be_bp_left/be_bp_right: [n]
    per-frame partial-concealment inputs from the channel decoder
    (bfi==2 lanes abort at the corrupt byte range, ari_codec.c:1824-1921)."""
    import jax

    pc = (None, None, None) if bfi_in is None else tuple(
        np.asarray(a, np.int32) for a in (bfi_in, be_bp_left, be_bp_right))
    side, dec = _frontend_jit(cfg)(frames_u8.astype(np.int32), *pc)
    return jax.tree.map(np.asarray, (side, dec))


def round_pcm16(x, x_e):
    """dec_lc3.c:289-295: round_fx_sat(L_shr_sat(L_deposit_h(x), 15-e))."""
    s = 15 - int(x_e)
    v = np.asarray(x, I64) << 16
    if s >= 0:
        v = v >> s
    else:
        v = fd.sat32(v << min(-s, 63))
    v = fd.sat32(v + 0x8000) >> 16
    return fd.sat16(v).astype(np.int16)


class FixedDecoder:
    """One-stream bit-exact decoder; frame-serial state, batched math."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        N = cfg.frame_length
        self.w = fi.window_table(N)
        self.imdct_st = fi.ImdctState(N, len(self.w))
        self.ltpf_st = fl.LtpfState(cfg.fs)
        self.sfi = fl.scale_fac_idx_for(cfg.total_bits, cfg.fs_idx,
                                        cfg.frame_dms)
        from .ops import pc_fixed as pcx
        from .ops import plc_fixed as pf
        self.plc = pf.PlcState(cfg.fs_idx)
        self.pc = pcx.PcState(cfg.yLen)
        self.bo = np.asarray(T.bands_offset(cfg.fs_idx, cfg.frame_dms,
                                            cfg.hrmode))

    def _frontends(self, frames_u8, good_idx, nbytes, n_pc=None,
                   n_pccw=None, bfi=None, be_bp_left=None,
                   be_bp_right=None):
        """Entropy frontend per frame. With `nbytes` (per-frame payload
        sizes, as produced by the channel decoder under EP mode
        switching, fec_get_data_size) frames are grouped by size and
        each group runs under a Config re-derived for that size — the
        reference re-runs update_enc/dec on every size change
        (lc3_enc_set_ep_mode -> update, setup_dec_lc3.c).  `n_pc` /
        `n_pccw` carry the channel decoder's per-frame partial-
        concealment geometry: for EP modes > 2 the core payload stays in
        the REORDERED layout (processReorderBitstream_fx) and the range
        decoder must read it n_pc-aware (ari_codec.c:1824-1921).
        Returns (side_f, dec_f, qgo_f, sfi_f) maps: frame index ->
        per-frame row dicts / scalars (None for frames not in
        good_idx)."""
        cfg = self.cfg
        n = len(frames_u8)
        side_f = [None] * n
        dec_f = [None] * n
        qgo_f = [cfg.quantizedGainOff] * n
        sfi_f = [self.sfi] * n
        if nbytes is None:
            groups = {None: list(map(int, good_idx))}
        else:
            nbytes = np.asarray(nbytes)
            n_pc = np.zeros(n, np.int64) if n_pc is None else np.asarray(n_pc)
            n_pccw = (np.zeros(n, np.int64) if n_pccw is None
                      else np.asarray(n_pccw))
            groups = {}
            for f in map(int, good_idx):
                key = (int(nbytes[f]), int(n_pc[f]), int(n_pccw[f]))
                groups.setdefault(key, []).append(f)
        for key, idxs in groups.items():
            if not idxs:
                continue
            if key is None:
                gcfg, width = cfg, cfg.targetBytes
            else:
                nb, npc, npccw = key
                width = nb
                if nb == cfg.targetBytes and npc == cfg.n_pc:
                    gcfg = cfg
                else:
                    fps = 10000 // cfg.frame_dms
                    gcfg = Config(fs_in=cfg.fs_in, bitrate=nb * 8 * fps,
                                  frame_dms=cfg.frame_dms, hrmode=cfg.hrmode)
                    assert gcfg.targetBytes == nb, (gcfg.targetBytes, nb)
                    object.__setattr__(gcfg, "n_pc", npc)
                    object.__setattr__(gcfg, "n_pccw", npccw)
            if bfi is not None and any(int(bfi[f]) == 2 for f in idxs):
                side, dec = _frontend(
                    gcfg, frames_u8[idxs][:, :width],
                    bfi_in=[int(bfi[f]) for f in idxs],
                    be_bp_left=[int(be_bp_left[f]) for f in idxs],
                    be_bp_right=[int(be_bp_right[f]) for f in idxs])
            else:
                side, dec = _frontend(gcfg, frames_u8[idxs][:, :width])
            sfi = (self.sfi if gcfg is cfg else
                   fl.scale_fac_idx_for(gcfg.total_bits, gcfg.fs_idx,
                                        gcfg.frame_dms))
            for k, f in enumerate(idxs):
                side_f[f] = {key2: v[k] for key2, v in side.items()}
                dec_f[f] = {key2: v[k] for key2, v in dec.items()}
                qgo_f[f] = gcfg.quantizedGainOff
                sfi_f[f] = sfi
        return side_f, dec_f, qgo_f, sfi_f

    def decode_plc(self, frames_u8: np.ndarray, bfi: np.ndarray,
                   frame_hook=None, nbytes=None, n_pc=None,
                   n_pccw=None, be_bp_left=None,
                   be_bp_right=None) -> np.ndarray:
        """Full decode with frame erasures and partial losses (bfi[f] in
        {0,1,2}): the MD5-gate path (dec_lc3.c:103-300 with advanced PLC
        and partial concealment).  `frame_hook(f, self)` runs after each
        frame (test instrumentation).  `nbytes` gives per-frame payload
        sizes for EP-mode-switching streams (payloads left-aligned in
        frames_u8); `be_bp_left`/`be_bp_right` carry the channel
        decoder's bit-error span for bfi==2 frames."""
        from .ops import pc_fixed as pcx
        from .ops import plc_fixed as pf
        cfg = self.cfg
        N, yLen = cfg.frame_length, cfg.yLen
        n = len(frames_u8)
        bfi = np.asarray(bfi)
        if be_bp_left is None:
            be_bp_left = np.zeros(n, np.int64)
        if be_bp_right is None:
            be_bp_right = np.zeros(n, np.int64)
        good_idx = np.nonzero(bfi != 1)[0]
        side_f, dec_f, qgo_f, sfi_f = self._frontends(
            frames_u8, good_idx, nbytes, n_pc=n_pc, n_pccw=n_pccw,
            bfi=bfi, be_bp_left=be_bp_left, be_bp_right=be_bp_right)
        st, plc, ltpf, pcst = self.imdct_st, self.plc, self.ltpf_st, self.pc
        pcm = np.zeros((n, N), np.int16)
        for f in range(n):
            b = int(bfi[f])
            scf_q = None
            spec_inv = yLen
            if b != 1:
                sf, df = side_f[f], dec_f[f]
                # BER detected by the side parser / range decoder conceals
                # the frame (dec_entropy.c -> bfi, dec_lc3.c:120-160); the
                # PC-aware range decoder reclassifies bfi==2 lanes (clean
                # decode past the corrupt span -> 0, abort -> 2 with
                # spec_inv_idx, protected-region error -> 1)
                if sf["bfi"] or int(df["bfi"]) == 1:
                    b = 1
                else:
                    b = int(df["bfi"])
                    if b == 2:
                        spec_inv = int(df["spec_inv_idx"])
            if b != 1:
                try:
                    scf_q, ber = fd.sns_decode_scf(sf["scf_idx"])
                    if ber:
                        raise _BerError
                except _BerError:
                    scf_q = None
                    b = 1
            # stab fac BEFORE the PC stage (dec_lc3.c:170-176) — the PC
            # classifier consumes the fresh value
            pf.stab_fac_main(plc, scf_q, b)
            if b != 1:
                qgo = qgo_f[f]
                q_res = np.array(df["x"], I64)     # sqQdec, Word16 values
                fac, fac_e = 32767, 0
                if b == 0:
                    x, x_e = fd.ari_scaling(q_res)
                bw_idx_nf = int(sf["bw_idx"])
                # ---- partial concealment (pc_main_fx.c:17-56); the
                # fixed-point reference has no HR mode, and HR residuals
                # exceed Word16 — PC is an EP-stream feature only ----
                if not cfg.hrmode:
                    if b == 2:
                        b = pcx.pc_classify(int(sf["ltpf_param"][0]),
                                            cfg.frame_dms, plc.q_old_d,
                                            pcst.q_old_res, yLen, spec_inv,
                                            plc.stab_fac)
                    if b == 2:
                        x, x_e, fac, fac_e = pcx.pc_apply(
                            pcst, yLen, q_res, plc.q_old_d, spec_inv,
                            int(sf["gg_idx"]), qgo)
                    if b != 1:
                        bw_idx_nf = pcx.pc_update(
                            pcst, b, yLen, q_res, spec_inv,
                            int(sf["gg_idx"]), qgo, 0, bw_idx_nf,
                            int(sf["fac_ns_idx"]), fac, fac_e)
                    if b == 0:
                        pcst.nb_lost = 0
            if b != 1:
                # ---- remaining integer chain (dec_lc3.c:196-235) ----
                x = fd.residual_decode(x, x_e, df["res_bits"],
                                       int(df["n_res"]))
                if not df["zero_frame"]:
                    x, _ = fd.noise_filling(
                        x, int(df["nf_seed"]), x_e,
                        int(sf["fac_ns_idx"]), bw_idx_nf, cfg.frame_dms,
                        fac_ns_pc=pcst.prev_fac_ns,
                        spec_inv_idx=spec_inv)
                x, x_e = fd.apply_global_gain(x, x_e, int(sf["gg_idx"]),
                                              qgo)
                x, x_e = fd.tns_decode(df["tns_idx"].reshape(16), x, x_e,
                                       df["tns_order"],
                                       int(sf["bw_idx"]), cfg.frame_dms)
                scf, scf_e = fd.sns_interpolate(scf_q, cfg.bands_number)
                scf_e, x_e = fd.scf_scaling(scf_e, x_e)
                x = fd.mdct_shaping(x, scf, scf_e, self.bo)
                q_d = np.concatenate([x, np.zeros(N - yLen, I64)])
                q_exp = x_e
                lp = sf["ltpf_param"]
            if b == 1:
                q_d, q_exp = np.zeros(N, I64), 0
                lp = np.zeros(3, np.int64)
                # FFLC increments the PFLC counter (plc_main_fx.c:23-27)
                pcst.nb_lost += 1
            pf.classify(plc, 1, b, ltpf.pitch_int, N, cfg.frame_dms,
                        cfg.fs_idx, self.bo, cfg.bands_number)
            cm = plc.conceal_method
            plc.mid_nb_lost = plc.nb_lost    # pre-update value (dumps)
            if b == 1:
                if cm == 2:
                    x_fx, q_exp = pf.phase_ecu(plc, st, self.w, cfg, ltpf)
                elif cm == 3:
                    x_fx, q_exp = pf.tdc_conceal(plc, st, self.w, cfg, ltpf)
                elif cm == 4:
                    q_exp = plc.q_old_exp
                    q_d = pf.noise_substitution(plc, yLen)
                    q_d = np.concatenate([q_d, np.zeros(N - yLen, I64)])
                else:
                    raise AssertionError(f"method {cm}")
            plc.mid_harm_q = plc.harmonic_q      # pre-update (dump anchor)
            plc.mid_gain_c = plc.tdc_gain_c
            if b == 0:
                pf.update_spec(plc, q_d[:yLen], int(q_exp), yLen)
            if cfg.frame_dms == 100:
                pf.spec2shape(plc, plc.prev_bfi, b, yLen)
            if b != 0:
                damp_scramb = 1 if (cm == 4 or b == 2) else 0
                if b == 1:
                    pf.damping_scrambling(plc, q_d, yLen, plc.nb_lost,
                                          plc.stab_fac, damp_scramb,
                                          ltpf.pitch_int, cfg.frame_dms,
                                          "ns_seed", 0)
                else:
                    # bfi==2: PC counter / seed / pitch-present of the
                    # CURRENT frame, scrambling above spec_inv_idx, then
                    # the damped spectrum becomes the PLC history
                    # (plc_damping_scrambling_fx.c:41-49)
                    pf.damping_scrambling(plc, q_d, yLen, pcst.nb_lost,
                                          plc.stab_fac, damp_scramb,
                                          int(lp[0]), cfg.frame_dms,
                                          "pc_seed", spec_inv)
                    pf.update_spec(plc, q_d[:yLen], int(q_exp), yLen)
            if b != 1 or cm in (0, 4, 5):
                ytda, y_e, y_s, zero = fi.batch_dct4(
                    q_d[None, :], np.asarray([q_exp], I64), N, cfg.frame_dms)
                x_fx, q_exp = fi.imdct_ola(ytda[0], y_e[0], y_s[0], zero[0],
                                           self.w, N, len(self.w), st)
            if getattr(plc, "skip_update", False):
                plc.skip_update = False      # golden-state repair (tests)
            else:
                pf.update_after_imdct(plc, x_fx, int(q_exp), cm, N,
                                      cfg.fs_idx, b,
                                      scf_q if scf_q is not None else [0] * 16)
            y, ye = fl.ltpf_decode(ltpf, x_fx, int(q_exp), cfg.fs_idx, N,
                                   int(lp[0]), int(lp[1]), int(lp[2]),
                                   sfi_f[f], bfi=b, conceal_method=cm,
                                   damping=plc.damping)
            pcm[f] = round_pcm16(y, ye)
            if frame_hook is not None:
                frame_hook(f, self)
        return pcm

    def decode(self, frames_u8: np.ndarray) -> np.ndarray:
        """[n_frames, nbytes] -> [n_frames, frame_length] int16."""
        cfg = self.cfg
        N, yLen = cfg.frame_length, cfg.yLen
        n = len(frames_u8)
        side, dec = _frontend(cfg, frames_u8)
        assert not np.any(side["bfi"]) and not np.any(dec["bfi"]), \
            "bit errors in clean decode"
        bo = np.asarray(T.bands_offset(cfg.fs_idx, cfg.frame_dms, cfg.hrmode))

        shaped = np.zeros((n, N), I64)
        exps = np.zeros(n, I64)
        for f in range(n):
            scf_q, ber = fd.sns_decode_scf(side["scf_idx"][f])
            assert ber == 0
            x, x_e = fd.ari_scaling(dec["x"][f])
            x = fd.residual_decode(x, x_e, dec["res_bits"][f],
                                   int(dec["n_res"][f]))
            if not dec["zero_frame"][f]:
                x, _ = fd.noise_filling(
                    x, int(dec["nf_seed"][f]), x_e,
                    int(side["fac_ns_idx"][f]), int(side["bw_idx"][f]),
                    cfg.frame_dms)
            x, x_e = fd.apply_global_gain(x, x_e, int(side["gg_idx"][f]),
                                          cfg.quantizedGainOff)
            x, x_e = fd.tns_decode(dec["tns_idx"][f].reshape(16), x, x_e,
                                   dec["tns_order"][f],
                                   int(side["bw_idx"][f]), cfg.frame_dms)
            scf, scf_e = fd.sns_interpolate(scf_q, cfg.bands_number)
            scf_e, x_e = fd.scf_scaling(scf_e, x_e)
            shaped[f, :yLen] = fd.mdct_shaping(x, scf, scf_e, bo)
            exps[f] = x_e

        ytda, y_e, y_s, zero = fi.batch_dct4(shaped, exps, N, cfg.frame_dms)
        pcm = np.empty((n, N), np.int16)
        for f in range(n):
            x, xe = fi.imdct_ola(ytda[f], y_e[f], y_s[f], zero[f], self.w,
                                 N, len(self.w), self.imdct_st)
            lp = side["ltpf_param"][f]
            y, ye = fl.ltpf_decode(self.ltpf_st, x, xe, cfg.fs_idx, N,
                                   int(lp[0]), int(lp[1]), int(lp[2]),
                                   self.sfi)
            pcm[f] = round_pcm16(y, ye)
        return pcm
