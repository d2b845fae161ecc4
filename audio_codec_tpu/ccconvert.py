"""Channel coder converter — pack/unpack LC3plus FEC protection.

Batched analog of the reference's standalone ccConvert tool
(fixed_point/ccConvert.c:107-796): converts an unprotected LC3plus
bitstream into a channel-coded one (``pack``) and back (``unpack``)
without re-encoding the audio.

pack  (ccConvert.c channel_coder_pack, :525-626): per channel, the core
frame is re-decoded just far enough to find the partial-concealment
pointer-convergence byte b_left (processAriDecoder mode 1), the most
error-sensitive block is relocated to the front when the slot carries PC
codewords (processReorderBitstream_fx), and the payload is Reed-Solomon
encoded into the gross slot (fec_encoder with the decoder-default
EPMR = LC3_EPMR_ZERO, lc3.c:305).

unpack (ccConvert.c channel_coder_unpack, :628-773): each slot is FEC
decoded, the convergence point is re-discovered on the transmitted
(reordered) stream (processAriDecoder mode 2) and the block swap undone
(processReorderBitstream_dec_fx, :776-796), yielding the original
unprotected core bitstream.

All hot work (FEC, range decode) runs as the same batched jitted kernels
the engine uses; this module only handles framing.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .config import Config
from .engine import _b_left_step, _reorder_payload
from .ops import fec
from .utils import bitstream_io as bio


def _slot_cfg(h: bio.StreamHeader, slot_bytes: int, epmode: int) -> Config:
    """Single-channel Config for a protected slot (targetBytes = data size,
    n_pc/n_pccw derived from the slot), as update_dec_bitrate would build."""
    frame_dms = int(round(h.frame_ms * 10))
    fl = h.samplerate * frame_dms // 10000
    bitrate = slot_bytes * 8 * h.samplerate // fl
    return Config(fs_in=h.samplerate, bitrate=bitrate, frame_dms=frame_dms,
                  channels=1, epmode=epmode, hrmode=bool(h.hrmode))


def pack_frames(h: bio.StreamHeader, frames: list[bytes], gross_bytes: int,
                epmode: int) -> list[bytes]:
    """EP0 frames -> channel-coded frames of ch*gross_bytes each.

    Multichannel frames whose total slot fits 160 bytes use combined channel
    coding (one FEC slot over the concatenated channel payloads): a
    conformant EP decoder engages ccc whenever channels > 1 and the frame is
    <= 160 bytes (dec_lc3.c:343), so emitting per-channel slots in that
    regime would be undecodable. The reference tool sidesteps this by being
    effectively mono-only (ccConvert.c:578 assert)."""
    if not 1 <= epmode <= 4:
        raise ValueError(f"epmode must be 1..4, got {epmode}")
    ch = h.channels
    ccc = ch > 1 and ch * gross_bytes <= 160
    if ccc:
        total_slot = ch * gross_bytes
        data_total = fec.fec_get_data_size(epmode, 1, total_slot)
        out: list[bytes] = []
        for fr in frames:
            raw = np.frombuffer(fr, np.uint8)
            if len(raw) != data_total:
                raise ValueError(
                    f"frame carries {len(raw)} bytes but epmode {epmode} at "
                    f"{total_slot} combined gross bytes protects {data_total}")
            coded = np.asarray(fec.fec_encode(
                jnp.asarray(raw.astype(np.int32)[None]),
                jnp.zeros((1,), jnp.int32), slot_bytes=total_slot,
                mode=epmode, ccc_flag=1)).astype(np.uint8)
            out.append(coded[0].tobytes())
        return out
    data_bytes = fec.fec_get_data_size(epmode, 0, gross_bytes)
    n_pccw = fec.fec_get_n_pccw(gross_bytes, epmode, 0)
    n_pc = fec.fec_get_n_pc(epmode, n_pccw, gross_bytes)
    cfg = None
    out = []
    for fr in frames:
        raw = np.frombuffer(fr, np.uint8)
        coded_ch: list[bytes] = []
        off = 0
        for c in range(ch):
            nb = len(raw) // ch + (c < len(raw) % ch)
            if nb != data_bytes:
                raise ValueError(
                    f"channel {c}: frame carries {nb} bytes but epmode "
                    f"{epmode} at {gross_bytes} gross bytes protects "
                    f"{data_bytes} (ccConvert.c:578)")
            data = raw[off:off + nb].astype(np.int32)
            off += nb
            if cfg is None:
                cfg = _slot_cfg(h, gross_bytes, epmode)
                assert cfg.targetBytes == data_bytes and cfg.n_pc == n_pc
            if n_pc > 0:
                b_left = int(np.asarray(
                    _b_left_step(cfg)(jnp.asarray(data[None])))[0])
                if b_left > 0:
                    data = _reorder_payload(data, b_left, n_pc)
            coded = np.asarray(fec.fec_encode(
                jnp.asarray(data[None]), jnp.zeros((1,), jnp.int32),
                slot_bytes=gross_bytes, mode=epmode,
                ccc_flag=0)).astype(np.uint8)
            coded_ch.append(coded[0].tobytes())
        out.append(b"".join(coded_ch))
    return out


def _unreorder_payload(data: np.ndarray, b_left: int, n_pc: int) -> np.ndarray:
    """processReorderBitstream_dec_fx (ccConvert.c:776-796): inverse of the
    encoder-side block relocation — put the first (n_pc+1)//2 bytes back at
    b_left."""
    blk = (n_pc + 1) >> 1
    return np.concatenate([data[blk:blk + b_left], data[:blk],
                           data[blk + b_left:]])


def unpack_frames(h: bio.StreamHeader, frames: list[bytes]
                  ) -> tuple[list[bytes], int]:
    """Protected frames -> EP0 core frames. Returns (frames, n_bad).

    Mirrors the reference binary-format path (ccConvert.c:195-240): every
    frame is written with whatever the FEC decoder produced — a channel that
    fails FEC decode contributes zero bytes while successfully decoded
    channels are kept; n_bad counts frames with at least one failed channel.
    Combined channel coding (channels > 1, frame <= 160 bytes, dec_lc3.c:343)
    is detected per frame and decoded as one slot."""
    from .ops import ari, bits
    ch = h.channels
    cfg_cache: dict[tuple[int, int], Config] = {}
    out: list[bytes] = []
    n_bad = 0
    for fr in frames:
        raw = np.frombuffer(fr, np.uint8)
        if ch > 1 and len(raw) <= 160:
            # combined channel coding: one FEC slot over all channels; ccc
            # never carries PC codewords (fec_get_n_pccw, al_fec.c:379-390)
            # so no de-reordering is needed
            dec = fec.fec_decode(jnp.asarray(raw.astype(np.int32)[None]),
                                 slot_bytes=len(raw), ccc_flag=1)
            bfi = int(np.asarray(dec["bfi"])[0])
            mode = int(np.asarray(dec["mode"])[0])
            db = int(np.asarray(dec["data_bytes"])[0])
            if bfi == 1 or mode < 1 or db == 0:
                n_bad += 1
                out.append(b"")
            else:
                out.append(np.asarray(dec["data"])[0, :db]
                           .astype(np.uint8).tobytes())
            continue
        parts: list[bytes] = []
        bad = False
        off = 0
        for c in range(ch):
            slot = len(raw) // ch + (c < len(raw) % ch)
            buf = raw[off:off + slot].astype(np.int32)
            off += slot
            dec = fec.fec_decode(jnp.asarray(buf[None]), slot_bytes=slot,
                                 ccc_flag=0)
            bfi = int(np.asarray(dec["bfi"])[0])
            mode = int(np.asarray(dec["mode"])[0])
            db = int(np.asarray(dec["data_bytes"])[0])
            if bfi == 1 or mode < 1 or db == 0:
                bad = True
                continue
            data = np.asarray(dec["data"])[0, :db].astype(np.uint8)
            n_pccw = fec.fec_get_n_pccw(slot, mode, 0)
            n_pc = fec.fec_get_n_pc(mode, n_pccw, slot)
            if n_pccw > 0 and n_pc > 0:
                key = (slot, mode)
                if key not in cfg_cache:
                    cfg_cache[key] = _slot_cfg(h, slot, mode)
                scfg = cfg_cache[key]
                assert scfg.targetBytes == db and scfg.n_pc == n_pc
                jb = jnp.asarray(data[None].astype(np.int32))
                side = bits.parse_side_info(scfg, jb)
                ares = ari.decode(scfg, jb, side)
                b_left = int(np.asarray(ares["b_left"])[0])
                blk = (n_pc + 1) >> 1
                # b_left > db is the no-convergence sentinel (ari.py inits
                # b_left to numbytes + 1): the transmitted frame was never
                # reordered, so there is nothing to undo
                if 0 < b_left <= db:
                    # reference asserts the adjusted offset is non-negative
                    # (processReorderBitstream_dec_fx, ccConvert.c:787);
                    # a convergence point inside the moved block on a frame
                    # that passed FEC is a corrupt frame, not a crash
                    if b_left < blk:
                        bad = True
                        continue
                    data = _unreorder_payload(data, b_left - blk, n_pc)
            parts.append(data.tobytes())
        if bad:
            n_bad += 1
        out.append(b"".join(parts))
    return out, n_bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ccconvert",
        description="Convert between protected and unprotected LC3plus "
                    "bitstreams (ccConvert analog).")
    ap.add_argument("-pack", nargs=2, metavar=("GROSS_BYTES", "EPMODE"),
                    type=int, default=None)
    ap.add_argument("-unpack", action="store_true")
    ap.add_argument("input", type=Path)
    ap.add_argument("output", type=Path)
    args = ap.parse_args(argv)
    if (args.pack is None) == (not args.unpack):
        ap.error("exactly one of -pack / -unpack is required")

    h, frames = bio.read_all(args.input)
    if args.pack is not None:
        gross, epmode = args.pack
        if h.epmode != 0:
            ap.error("pack mode needs an unprotected input bitstream")
        out = pack_frames(h, frames, gross, epmode)
        # ccConvert writes an 18-byte header with the full epmode 0..4
        # (ccConvert.c:353-362); compact keeps tool output byte-identical
        bio.write_all(args.output, bio.StreamHeader(
            samplerate=h.samplerate, bitrate=h.bitrate, channels=h.channels,
            frame_ms=h.frame_ms, epmode=epmode, signal_len=h.signal_len,
            hrmode=h.hrmode), out, compact=not h.hrmode)
        print(f"packed {len(out)} frames -> ep{epmode}, "
              f"{h.channels}x{gross} bytes/frame")
    else:
        if h.epmode == 0:
            ap.error("unpack mode needs a protected input bitstream")
        out, n_bad = unpack_frames(h, frames)
        bio.write_all(args.output, bio.StreamHeader(
            samplerate=h.samplerate, bitrate=h.bitrate, channels=h.channels,
            frame_ms=h.frame_ms, epmode=0, signal_len=h.signal_len,
            hrmode=h.hrmode), out, compact=not h.hrmode)
        print(f"unpacked {len(out)} frames ({n_bad} undecodable)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
