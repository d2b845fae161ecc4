"""Low-delay MDCT / IMDCT as batched dense matmuls.

The reference runs MDCT = fold/window + DCT-IV via a half-length complex FFT
(mdct.c:72-126, dct4.c:51-95) one frame at a time. Here the DCT-IV of a
whole stream batch is a single [B, N] x [N, N] f32 matmul, static-shaped and
fused by XLA with the windowing/fold elementwise ops. Whether an FFT-based
DCT-IV is faster at the larger N (HR, N=960) is not measured yet.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T
from ..config import Config


def _win(cfg: Config) -> np.ndarray:
    return T.mdct_window(cfg.frame_length, cfg.frame_dms, cfg.hrmode)


def _dct4_apply(folded: jnp.ndarray, Mt: jnp.ndarray) -> jnp.ndarray:
    """folded [B, N] @ Mt [N, N] -> [B, N] DCT-IV.

    The branch follows the device that runs the computation
    (`lax.platform_dependent`), not the process's default backend.
    On the CPU (the conformance / CLI path, tools/conformance.py) the
    product+sum runs with Dekker-split exact products and Neumaier
    compensated accumulation: the reference float encoder computes the same
    transform with sequential FFT butterflies, and plain pairwise f32
    accumulation leaves our spectrum ~30 ulp away from the reference's —
    enough to flip quantizer dead-zone ties (xq +-1 on single bins) and cost
    the sqam encode leg a full RMS bit (CONFORMANCE_r04 sqam_thetest24_48000).
    The compensated path is ~3 ulp from the correctly rounded result, which
    is closer to the reference than the reference's own rounding error.
    Every other device takes the plain f32 product (no TF32: the package
    sets matmul precision "highest").
    """
    return jax.lax.platform_dependent(folded, Mt, cpu=_dct4_compensated,
                                      default=_dct4_plain)


def _dct4_plain(folded: jnp.ndarray, Mt: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(folded, Mt, preferred_element_type=jnp.float32)


def _dct4_compensated(folded: jnp.ndarray, Mt: jnp.ndarray) -> jnp.ndarray:
    B = folded.shape[0]

    def split(v):  # Veltkamp split at 2^12+1 for f32
        c = jnp.float32(4097.0) * v
        hi = c - (c - v)
        return hi, v - hi

    def body(carry, inp):
        s, comp = carry
        fk, mrow = inp                      # fk [B], mrow [N_out]
        a = fk[:, None]
        b = mrow[None, :]
        ah, al = split(a)
        bh, bl = split(b)
        p = a * b
        err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
        for y in (p, err):                  # Neumaier two-sum accumulation
            t = s + y
            bv = t - s
            comp = comp + ((s - (t - bv)) + (y - bv))
            s = t
        return (s, comp), None

    (s, comp), _ = jax.lax.scan(
        body, (jnp.zeros((B, Mt.shape[1]), jnp.float32),) * 2,
        (folded.T, Mt))
    return s + comp


def mdct(cfg: Config, x: jnp.ndarray, mem: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Forward low-delay MDCT of one frame per stream.

    x:   [B, N] input PCM frame (scaled float)
    mem: [B, N - la_zeroes] previous-frame tail (raw input)
    returns (d [B, N] spectrum, new_mem)
    Mirrors mdct_apply (mdct.c:100-124): buffer = [mem, x, 0*la], window,
    fold to N, DCT-IV.
    """
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    win = jnp.asarray(_win(cfg), jnp.float32)
    buf = jnp.concatenate([mem, x], axis=-1)            # [B, 2N - la]
    if la:
        buf = jnp.pad(buf, ((0, 0), (0, la)))           # [B, 2N]
    w = buf * win
    # fold (mdct.c:115-119)
    out_lo = -w[:, 3 * h - 1: 2 * h - 1: -1] - w[:, 3 * h: 4 * h]
    out_hi = w[:, 0: h] - w[:, 2 * h - 1: h - 1: -1]
    folded = jnp.concatenate([out_lo, out_hi], axis=-1)  # [B, N]
    M = jnp.asarray(T.dct4_matrix(N), jnp.float32)
    d = _dct4_apply(folded, M.T)
    new_mem = x[:, la:]
    return d, new_mem


def imdct(cfg: Config, y: jnp.ndarray, mem: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse MDCT with overlap-add (ProcessingIMDCT_fl, imdct.c:14-59).

    y:   [B, N] spectrum
    mem: [B, N - la_zeroes] overlap memory
    returns (x [B, N] PCM, new_mem)
    """
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    M = jnp.asarray(T.dct4_matrix(N), jnp.float32)
    x_tda = jnp.dot(y, M.T, preferred_element_type=jnp.float32)  # [B, N]
    # TDA unfold (imdct.c:31-46): x_ov = [t[h:], -rev(t[h:]), -rev(t[:h]), -t[:h]]
    a = x_tda[:, h:]
    b = x_tda[:, :h]
    x_ov = jnp.concatenate([a, -a[:, ::-1], -b[:, ::-1], -b], axis=-1)  # [B, 2N]
    win = jnp.asarray(_win(cfg)[::-1].copy(), jnp.float32)
    x_ov = x_ov * win
    # overlap-add with memory over [la, N)
    ola = x_ov[:, la:N] + mem[:, : N - la]
    x = jnp.concatenate([ola, x_ov[:, N: N + la]], axis=-1)  # [B, N]
    new_mem = x_ov[:, N + la:]
    return x, new_mem
