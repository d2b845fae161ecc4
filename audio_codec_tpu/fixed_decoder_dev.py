"""Batched DEVICE bit-exact fixed-point decoder (clean-frame chain).

The int32/int64 device port of fixed_decoder.py's clean-decode path: the
jitted frontend (side parse + range decode, ops/bits.py + ops/ari.py)
chains into the batched BASOP backend (ops/fixed_dev.py spectral chain and
SNS decode, the shared ops/fixed_imdct.py DCT-IV core, and
ops/fixed_ltpf_dev.py), all under one jit over a [T, B] frame block —
entropy + spectral + transform run over the flattened T*B batch; only the
stateful OLA/LTPF stage scans over T.

This is the production-shaped counterpart of the reference's fixed decoder
(dec_lc3.c:103-293): B independent streams across lanes, T frames deep.
Requires jax_enable_x64 in a dedicated process (i64 Word32 products);
tests/test_fixed_dev.py subprocess-validates its PCM output bit-for-bit
against the host FixedDecoder on the MD5-gate testvec points, and
`chip_smoke.py --fixed-dev` does the same on the GPU with its compile time.

Frontier (same as the host conformance rig, fixed_imdct.py:17-19): 10 ms
frames at the cfft sizes 40..240; PLC/PC concealment frames stay on the
host path (ops/plc_fixed.py)."""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import tables as T
from .config import Config
from .ops import ari, bits
from .ops import fixed_dev as fv
from .ops import fixed_imdct as fi
from .ops import fixed_ltpf as fl
from .ops import fixed_ltpf_dev as fld

I64 = np.int64


class DeviceFixedDecoder:
    """Decode [T, B, nbytes] frame blocks of B streams, bit-exact."""

    def __init__(self, cfg: Config, B: int):
        assert jax.config.jax_enable_x64
        self.cfg = cfg
        self.B = B
        N = cfg.frame_length
        self.w = np.asarray(fi.window_table(N)).astype(I64)
        self.wLen = len(self.w)
        self.sfi = fl.scale_fac_idx_for(cfg.total_bits, cfg.fs_idx,
                                        cfg.frame_dms)
        lst = fld.LtpfDevState(cfg.fs, B)
        self.x_len, self.y_len = lst.x_len, lst.y_len
        self.state = dict(
            mem=jnp.zeros((B, self.wLen - N), I64),
            mem_e=jnp.zeros((B,), I64),
            ltpf=lst.tree,
        )
        self._step = jax.jit(self._block)

    def _block(self, state, frames):
        cfg = self.cfg
        N, yLen = cfg.frame_length, cfg.yLen
        Tn, B, nb = frames.shape
        flat = frames.reshape(Tn * B, nb).astype(jnp.int32)
        side = bits.parse_side_info(cfg, flat)
        dec = ari.decode(cfg, flat, side)

        scf_q, _ = fv.sns_decode_scf(side["scf_idx"])
        x, x_e = fv.ari_scaling(dec["x"])
        x = fv.residual_decode(x, x_e, dec["res_bits"], dec["n_res"])
        nf, _ = fv.noise_filling(x, dec["nf_seed"], x_e,
                                 side["fac_ns_idx"], side["bw_idx"],
                                 cfg.frame_dms)
        x = jnp.where((dec["zero_frame"] == 0)[:, None], nf, x)
        x, x_e = fv.apply_global_gain(x, x_e, side["gg_idx"],
                                      cfg.quantizedGainOff)
        x, x_e = fv.tns_decode(dec["tns_idx"].reshape(Tn * B, 16), x, x_e,
                               dec["tns_order"], side["bw_idx"],
                               cfg.frame_dms)
        scf, scf_e = fv.sns_interpolate(scf_q, cfg.bands_number)
        scf_e, x_e = fv.scf_scaling(scf_e, x_e)
        bo = np.asarray(T.bands_offset(cfg.fs_idx, cfg.frame_dms,
                                       cfg.hrmode))
        shaped = fv.mdct_shaping(x, scf, scf_e, bo, yLen)
        if N > yLen:
            shaped = jnp.concatenate(
                [shaped, jnp.zeros((Tn * B, N - yLen), I64)], axis=1)
        ytda, y_e, y_s, zero = fv.batch_dct4(shaped, x_e, N, cfg.frame_dms)

        ytda = ytda.reshape(Tn, B, N)
        y_e = y_e.reshape(Tn, B)
        y_s = y_s.reshape(Tn, B)
        zero = zero.reshape(Tn, B)
        lp = side["ltpf_param"].reshape(Tn, B, 3)

        def body(st, inp):
            ytda_f, ye_f, ys_f, zero_f, lp_f = inp
            xf, xe, mem, mem_e = fv.imdct_ola(
                ytda_f, ye_f, ys_f, zero_f, self.w, N, self.wLen,
                st["mem"], st["mem_e"])
            y, ye2, ltpf_new = fld.ltpf_decode(
                st["ltpf"], self.x_len, self.y_len, xf, xe, cfg.fs_idx, N,
                lp_f[:, 0], lp_f[:, 1], lp_f[:, 2], self.sfi)
            pcm = fv.round_pcm16(y, ye2)
            return dict(mem=mem, mem_e=mem_e, ltpf=ltpf_new), pcm

        state, pcm = jax.lax.scan(body, state, (ytda, y_e, y_s, zero, lp))
        return state, pcm

    def decode_block(self, frames: np.ndarray) -> np.ndarray:
        """frames [T, B, nbytes] uint8 -> pcm [T, B, N] int16."""
        self.state, pcm = self._step(self.state,
                                     jnp.asarray(frames.astype(np.int32)))
        return np.asarray(pcm)
