"""Per-stream codec state as pytrees of [n_streams, ...] arrays.

The reference keeps per-channel state in malloc'd structs
(EncSetup, setup_enc_lc3.h:17-63; DecSetup, setup_dec_lc3.h:17-58).
Here the same state-block contract becomes a flat pytree of batched arrays:
checkpoint/resume and stream migration are plain array slicing (SURVEY.md §5),
and every op consumes/returns state functionally.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from .. import tables as T
from ..config import Config
from ..ops import plc_adv, plc_phecu


def _state_pytree(cls):
    """Frozen dataclass registered as a pytree whose leaves are all of its
    fields, in declaration order; `.replace(**fields)` returns an updated
    copy."""
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


def _adv(cfg: Config, n: int) -> int:
    """Advanced-PLC buffers are zero-width when the mode is off."""
    return n if cfg.plc_mode else 0


def _ph(cfg: Config, n: int) -> int:
    """Phase-ECU buffers exist only in advanced mode at 10 ms frames."""
    return n if (cfg.plc_mode and cfg.frame_dms == 100) else 0


@_state_pytree
class EncState:
    # MDCT overlap memory: raw input tail x[la_zeroes:] (mdct.c:100-111)
    mdct_mem: jnp.ndarray          # [B, frame_length - la_zeroes]
    # 12.8 kHz resampler (resamp12k8.c; setup_enc_lc3.h:23-25)
    r12k8_mem_in: jnp.ndarray      # [B, mem_in_len]
    r12k8_mem_50: jnp.ndarray      # [B, 2] biquad state
    r12k8_mem_out: jnp.ndarray     # [B, 24]
    # open-loop pitch (olpa.c; setup_enc_lc3.h:26-27,46)
    olpa_mem_s12k8: jnp.ndarray    # [B, 3]
    olpa_mem_s6k4: jnp.ndarray     # [B, LEN_6K4 + MAX_PITCH_6K4 + 16]
    olpa_mem_pitch: jnp.ndarray    # [B] int32, init 17
    # LTPF encoder (ltpf_coder.c; setup_enc_lc3.h:18-20,28,37,47)
    ltpf_mem_in: jnp.ndarray       # [B, ltpf_mem_in_len]
    ltpf_mem_normcorr: jnp.ndarray       # [B]
    ltpf_mem_mem_normcorr: jnp.ndarray   # [B]
    ltpf_mem_ltpf_on: jnp.ndarray        # [B] int32
    ltpf_mem_pitch: jnp.ndarray          # [B] float32
    # attack detector (attack_detector.c; setup_enc_lc3.h:21-22,50-52)
    attdec_filter_mem: jnp.ndarray  # [B, 2]
    attdec_acc_energy: jnp.ndarray  # [B]
    attdec_detected: jnp.ndarray    # [B] int32
    attdec_position: jnp.ndarray    # [B] int32
    # global-gain rate loop memory (estimate_global_gain.c:42-50)
    targetBitsOff: jnp.ndarray      # [B] float32
    mem_targetBits: jnp.ndarray     # [B] int32
    mem_specBits: jnp.ndarray       # [B] int32


def enc_state_init(cfg: Config, n_streams: int) -> EncState:
    B = n_streams
    f32, i32 = jnp.float32, jnp.int32
    z = lambda *shape: jnp.zeros((B, *shape), f32)
    zi = lambda *shape: jnp.zeros((B, *shape), i32)
    return EncState(
        mdct_mem=z(cfg.frame_length - cfg.la_zeroes),
        r12k8_mem_in=z(cfg.mem_in_len),
        r12k8_mem_50=z(2),
        r12k8_mem_out=z(24),
        olpa_mem_s12k8=z(3),
        olpa_mem_s6k4=z(T.MAX_PITCH_6K4 + (16 if cfg.frame_dms == 25 else 0)),
        olpa_mem_pitch=jnp.full((B,), 17, i32),
        ltpf_mem_in=z(cfg.ltpf_mem_in_len),
        ltpf_mem_normcorr=z(),
        ltpf_mem_mem_normcorr=z(),
        ltpf_mem_ltpf_on=zi(),
        ltpf_mem_pitch=z(),
        attdec_filter_mem=z(2),
        attdec_acc_energy=z(),
        attdec_detected=zi(),
        attdec_position=zi(),
        targetBitsOff=z(),
        mem_targetBits=zi(),
        mem_specBits=zi(),
    )


def ltpf_dec_lens(cfg: Config) -> tuple[int, int, int, int]:
    """(old_x_len, old_y_len, tilt_len, inter_len_r) per ltpf_decoder.c:88-150."""
    fs = cfg.fs
    if fs in (8000, 16000):
        inter_len_r, tilt_len_r = 4, 3
    elif fs == 24000:
        inter_len_r, tilt_len_r = 6, 5
    elif fs == 32000:
        inter_len_r, tilt_len_r = 8, 7
    else:
        inter_len_r, tilt_len_r = 12, 11
    tilt_len = tilt_len_r - 1
    inter_len = max(fs, 16000) // 8000
    old_x_len = tilt_len
    old_y_len = math.ceil(228 * fs / 12800) + inter_len
    return old_x_len, old_y_len, tilt_len, inter_len_r


@_state_pytree
class DecState:
    # IMDCT overlap-add memory (imdct.c:49-58)
    imdct_mem: jnp.ndarray         # [B, frame_length - la_zeroes]
    # LTPF postfilter history (ltpf_decoder.c; setup_dec_lc3.h:26-31,42-46)
    ltpf_mem_x: jnp.ndarray        # [B, old_x_len]
    ltpf_mem_y: jnp.ndarray        # [B, old_y_len]
    ltpf_mem_pitch_int: jnp.ndarray  # [B] int32
    ltpf_mem_pitch_fr: jnp.ndarray   # [B] int32
    ltpf_mem_gain: jnp.ndarray       # [B] float32
    ltpf_mem_beta_idx: jnp.ndarray   # [B] int32, init -1
    ltpf_param_mem: jnp.ndarray      # [B, 3] int32
    # PLC (plc_main.c, structs.h:70-86)
    plc_q_d_prev: jnp.ndarray      # [B, yLen] previous good spectrum
    plc_nbLostCmpt: jnp.ndarray    # [B] int32
    plc_prevBfi: jnp.ndarray       # [B] int32
    plc_prevprevBfi: jnp.ndarray   # [B] int32
    plc_cum_alpha: jnp.ndarray     # [B] float32, init 1
    plc_seed: jnp.ndarray          # [B] int32, init 24607
    plc_scf_q: jnp.ndarray         # [B, 16] last good scale factors
    plc_old_scf_q: jnp.ndarray     # [B, 16] two-frames-back scale factors
    # advanced PLC (AplcSetup, setup_dec_lc3.c:118-160); zero-width when
    # cfg.plc_mode == 0
    plc_x_old_tot: jnp.ndarray     # [B, max_pitch + frame] PCM history
    plc_meth: jnp.ndarray          # [B] i32 concealMethod for the burst
    plc_tdc_a: jnp.ndarray         # [B, 17] LPC coefficients
    plc_tdc_seed: jnp.ndarray      # [B] i32, init 24607
    plc_tdc_gain_c: jnp.ndarray    # [B]
    plc_tdc_alpha: jnp.ndarray     # [B] damping / gain_p memory
    plc_tdc_fract: jnp.ndarray     # [B] i32 pitch fraction
    plc_harmonic: jnp.ndarray      # [B, max_pitch] repeated pitch cycle
    plc_harmonic_len: jnp.ndarray  # [B] i32
    plc_synth_hist: jnp.ndarray    # [B, 16] LPC synthesis memory
    plc_cum_fflc: jnp.ndarray      # [B] cumulative rapid-fade factor
    plc_cum_slow: jnp.ndarray      # [B]
    plc_cum_fast: jnp.ndarray      # [B]
    plc_ns_seed: jnp.ndarray       # [B] i32, init 24607 (scrambling, bfi=1)
    pc_seed: jnp.ndarray           # [B] i32, init 24607 (scrambling, bfi=2)
    # Phase ECU (method 2; plc_phecu_fec_hq_fx.c state in AplcSetup);
    # zero-width unless plc_mode == 1 and frame_dms == 100
    phecu_X_sav: jnp.ndarray       # [B, Lprot/2+1] c64 prototype spectrum
    phecu_f0est: jnp.ndarray       # [B, search_bins] fractional peak pos, -1
    phecu_num_plocs: jnp.ndarray   # [B] i32
    phecu_mag_chg_1st: jnp.ndarray  # [B, 9] per-band transient attenuation
    phecu_Xavg: jnp.ndarray        # [B, 9] band avg magnitude to fade to
    phecu_beta_mute: jnp.ndarray   # [B] long-term mute factor, init 0.5
    phecu_is_trans: jnp.ndarray    # [B] i32 transient-content flag
    # partial concealment (setup_dec_lc3.h q_old_res/prev_gg/..., DecSetup)
    pc_q_old_res: jnp.ndarray      # [B, yLen] last raw residual spectrum
    pc_prev_gg: jnp.ndarray        # [B] float32
    pc_prev_bw_idx: jnp.ndarray    # [B] int32
    pc_prev_fac_ns: jnp.ndarray    # [B] float32
    pc_nb_lost: jnp.ndarray        # [B] int32 (pc_nbLostFramesInRow)


def dec_state_init(cfg: Config, n_streams: int) -> DecState:
    B = n_streams
    f32, i32 = jnp.float32, jnp.int32
    z = lambda *shape: jnp.zeros((B, *shape), f32)
    zi = lambda *shape: jnp.zeros((B, *shape), i32)
    old_x_len, old_y_len, _, _ = ltpf_dec_lens(cfg)
    return DecState(
        imdct_mem=z(cfg.frame_length - cfg.la_zeroes),
        ltpf_mem_x=z(old_x_len),
        ltpf_mem_y=z(old_y_len),
        ltpf_mem_pitch_int=zi(),
        ltpf_mem_pitch_fr=zi(),
        ltpf_mem_gain=z(),
        ltpf_mem_beta_idx=jnp.full((B,), -1, i32),
        ltpf_param_mem=zi(3),
        plc_q_d_prev=z(cfg.yLen),
        plc_nbLostCmpt=zi(),
        plc_prevBfi=zi(),
        plc_prevprevBfi=zi(),
        plc_cum_alpha=jnp.ones((B,), f32),
        plc_seed=jnp.full((B,), 24607, i32),
        plc_scf_q=z(16),
        plc_old_scf_q=z(16),
        plc_x_old_tot=z(_adv(cfg, plc_adv.pcm_hist_len(cfg))),
        plc_meth=zi(),
        plc_tdc_a=z(_adv(cfg, 17)),
        plc_tdc_seed=jnp.full((B,), 24607, i32),
        plc_tdc_gain_c=z(),
        plc_tdc_alpha=z(),
        plc_tdc_fract=zi(),
        plc_harmonic=z(_adv(cfg, plc_adv.max_pitch(cfg))),
        plc_harmonic_len=jnp.ones((B,), i32),
        plc_synth_hist=z(_adv(cfg, 16)),
        plc_cum_fflc=jnp.ones((B,), f32),
        plc_cum_slow=jnp.ones((B,), f32),
        plc_cum_fast=jnp.ones((B,), f32),
        plc_ns_seed=jnp.full((B,), 24607, i32),
        pc_seed=jnp.full((B,), 24607, i32),
        phecu_X_sav=jnp.zeros((B, _ph(cfg, plc_phecu.nbins(cfg))),
                              jnp.complex64),
        phecu_f0est=jnp.full((B, _ph(cfg, plc_phecu._search_bins(cfg))),
                             -1.0, f32),
        phecu_num_plocs=zi(),
        phecu_mag_chg_1st=jnp.ones((B, _ph(cfg, 9)), f32),
        phecu_Xavg=z(_ph(cfg, 9)),
        phecu_beta_mute=jnp.full((B,), 0.5, f32),
        phecu_is_trans=zi(),
        pc_q_old_res=z(cfg.yLen),
        pc_prev_gg=z(),
        pc_prev_bw_idx=zi(),
        pc_prev_fac_ns=z(),
        pc_nb_lost=zi(),
    )
