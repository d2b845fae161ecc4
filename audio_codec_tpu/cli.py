"""ETSI-compatible command-line interface for the batched codec.

Drop-in analog of the reference CLI (codec_exe.c:141-520): WAV in/out, the
reference's bitstream container (and G.192), -E/-D/encode+decode modes,
delay-compensation modes, 16/24/32-bit PCM, bitrate/bandwidth/epmode
switching files (binary int64 per frame, codec_exe.c:295-330), error
pattern files for PLC/PC tests (-epf/-ept/-edf) and channel-coder debug
output (-ep_dbg), so the stock conformance harness can drive this build
with only exe paths.

Usage:  python -m audio_codec_tpu.cli [OPTIONS] INPUT OUTPUT BITRATE
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="audio_codec_tpu",
                                description="batched LC3plus codec")
    p.add_argument("-E", action="store_true", help="encode only")
    p.add_argument("-D", action="store_true", help="decode only")
    p.add_argument("-q", action="store_true", help="quiet")
    p.add_argument("-v", action="store_true", help="verbose switching commands")
    p.add_argument("-bps", type=int, default=16,
                   help="output bits per sample (16/24/32)")
    p.add_argument("-swf", type=str, default=None, help="bitrate switching file")
    p.add_argument("-dc", type=int, default=1, choices=(0, 1, 2),
                   help="0: no delay compensation; 1: all in decoder; 2: split")
    p.add_argument("-frame_ms", type=float, default=10.0)
    p.add_argument("-bandwidth", type=str, default=None,
                   help="bandwidth in Hz or bandwidth switching file")
    p.add_argument("-hrmode", action="store_true", help="high resolution mode")
    p.add_argument("-epf", type=str, default=None,
                   help="error pattern file (frame loss)")
    p.add_argument("-ept", action="store_true",
                   help="with -E -epf: emit PLC-trigger frames (special lastnz)")
    p.add_argument("-edf", type=str, default=None,
                   help="write error detection pattern to FILE")
    p.add_argument("-epmode", type=str, default="0",
                   help="error protection mode 0..4 or epmode switching file")
    p.add_argument("-ep_dbg", type=str, default=None,
                   help="save bfi/epmr/error_report to FILE.{bfi,epmr,error_report}")
    p.add_argument("-epmr", type=int, default=0,
                   help="error protection mode request signaled to the decoder")
    p.add_argument("-formatG192", action="store_true")
    p.add_argument("-cfgG192", type=str, default=None,
                   help="configuration file for the G.192 bitstream format")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("bitrate", nargs="?", default="0")
    return p.parse_args(argv)


def _read_error_pattern(path: str) -> np.ndarray:
    """Binary 16-bit pattern file: nonzero = frame lost (codec_exe.c:99-102)."""
    return np.fromfile(path, dtype="<i2") != 0


def _read_switching(path: str) -> np.ndarray:
    """Per-frame int64 switching file (loopy_read64, codec_exe.c:295-330);
    text files with one value per line are accepted too."""
    try:
        return np.loadtxt(path, ndmin=1).astype(np.int64)
    except (ValueError, UnicodeDecodeError):
        return np.fromfile(path, dtype="<i8")


def _loopy(arr: np.ndarray, i: int):
    """Switching/pattern files wrap at EOF (loopy_read*, codec_exe.c:744+)."""
    return arr[i % len(arr)]


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from .config import Config
    from .engine import StreamEncoder, StreamDecoder
    from .utils import bitstream_io as bio
    from .utils import wavio

    encode = not args.D
    decode = not args.E

    ep_numeric = args.epmode.lstrip("-").isdigit()
    epmodes = None if ep_numeric else (_read_switching(args.epmode) // 100)
    epmode0 = int(args.epmode) if ep_numeric else int(epmodes[0])
    bw_numeric = args.bandwidth is None or args.bandwidth.lstrip("-").isdigit()
    bandwidths = None if bw_numeric else _read_switching(args.bandwidth)
    bandwidth0 = (int(args.bandwidth or 0) if bw_numeric else int(bandwidths[0]))
    pattern = _read_error_pattern(args.epf) if args.epf else None

    if encode:
        import wave
        pcm, fs = wavio.read_wav(args.input)
        with wave.open(args.input, "rb") as w:
            bps_in = w.getsampwidth() * 8
        n_samples, channels = pcm.shape
        if args.swf:
            rates = _read_switching(args.swf) * channels
        else:
            rates = np.array([int(args.bitrate)])
        cfg0 = Config(fs_in=fs, bitrate=int(rates[0]),
                      frame_dms=int(args.frame_ms * 10), channels=channels,
                      epmode=epmode0, hrmode=args.hrmode, bps=bps_in,
                      bandwidth=bandwidth0)
        enc = StreamEncoder(cfg0, n_streams=channels)
        enc.epmr = args.epmr
        fl = cfg0.frame_length
        # delay compensation mode 2: the encoder consumes delay/2 leading
        # samples and pads one extra frame at the tail (codec_exe.c:281-357)
        enc_skip = ((fl - 2 * cfg0.la_zeroes) // 2) if args.dc == 2 else 0
        if enc_skip:
            pcm = np.concatenate(
                [pcm[enc_skip:],
                 np.zeros((enc_skip + fl, channels), pcm.dtype)])
        frames_out = []
        # dc==2 needs the decoder to emit n_samples after trimming delay/2
        n_frames = (-(-(n_samples + enc_skip) // fl) if args.dc == 2
                    else n_samples // fl)
        for f in range(n_frames):
            if args.swf:
                r = int(_loopy(rates, f))
                if args.v and r != enc.cfg.bitrate:
                    print(f"Switching rate from {enc.cfg.bitrate} to {r}")
                enc.set_bitrate(r)
            if epmodes is not None:
                ep = int(_loopy(epmodes, f))
                if args.v and ep != enc.cfg.epmode:
                    print(f"Switching epmode from {enc.cfg.epmode} to {ep}")
                enc.set_ep_mode(ep)
            if bandwidths is not None:
                bw = int(_loopy(bandwidths, f))
                if args.v and bw != enc.cfg.bandwidth:
                    print(f"Switching bandwidth from {enc.cfg.bandwidth} to {bw}")
                enc.set_bandwidth(bw)
            if args.ept and pattern is not None and _loopy(pattern, f):
                frames_out.append(b"".join(enc.encode_plc_trigger()))
                continue
            block = np.zeros((fl, channels), pcm.dtype)
            avail = pcm[f * fl: (f + 1) * fl]
            block[:len(avail)] = avail
            payloads = enc.encode(block.T)
            frames_out.append(b"".join(payloads))
        out_path = Path(args.output)
        if not decode:
            h = bio.StreamHeader(samplerate=fs, bitrate=int(rates[0]),
                                 channels=channels, frame_ms=args.frame_ms,
                                 epmode=epmode0, signal_len=n_samples,
                                 hrmode=1 if cfg0.hrmode else 0)
            if args.formatG192:
                with open(out_path, "wb") as fo:
                    for fr in frames_out:
                        bio.write_g192_frame(fo, fr)
                cfgp = Path(args.cfgG192) if args.cfgG192 else \
                    out_path.with_suffix(out_path.suffix + ".cfg")
                with open(cfgp, "wb") as fo:
                    bio.write_header(fo, h)
            else:
                bio.write_all(out_path, h, frames_out)
            if not args.q:
                print(f"encoded {n_frames} frames -> {out_path}")
            return 0

    if decode and not encode:
        if args.formatG192:
            cfgp = Path(args.cfgG192) if args.cfgG192 else Path(args.input + ".cfg")
            if not cfgp.exists():
                cfgp = Path(args.input).with_suffix(".cfg")
            with open(cfgp, "rb") as fh:
                h = bio.read_header(fh)
            frames, bfi_flags = [], []
            with open(args.input, "rb") as fh:
                while True:
                    fr, bf = bio.read_g192_frame(fh)
                    if fr is None:
                        break
                    frames.append(fr)
                    bfi_flags.append(bf)
        else:
            h, frames = bio.read_all(args.input)
            bfi_flags = [0] * len(frames)
        cfg = Config(fs_in=h.samplerate, bitrate=h.bitrate,
                     frame_dms=int(h.frame_ms * 10), channels=h.channels,
                     epmode=4 if h.epmode else 0,  # mode detected per frame
                     hrmode=bool(h.hrmode),        # codec_exe.c:210-222
                     bps=args.bps)
        lost = np.zeros(len(frames), bool)
        if pattern is not None:
            lost = np.array([_loopy(pattern, i) for i in range(len(frames))])
        dec = StreamDecoder(cfg, n_streams=h.channels)
        out, edf_out, dbg = [], [], {"bfi": [], "epmr": [], "error_report": []}
        for i, fr in enumerate(frames):
            bfi = bfi_flags[i]
            if bool(lost[i]) or len(fr) == 0:
                bfi = 1
            pcm = dec.decode(fr, bfi=bfi)
            out.append(pcm.T)
            concealed = int(bfi == 1 or np.any(dec.last_bfi != 0))
            edf_out.append(concealed)
            # .bfi mirrors the exe dump, which writes the per-frame API
            # error (codec_exe.c:470-473): 0 = decoded (incl. partial
            # concealment), LC3_DECODE_ERROR = 2 = frame concealed as
            # lost (lc3.h:106) — NOT the channel-coder bfi value
            lost_frame = bfi == 1 or int(np.max(dec.last_bfi)) == 1
            dbg["bfi"].append(2 if lost_frame else 0)
            dbg["epmr"].append(dec.epmr)
            dbg["error_report"].append(
                int(np.min(dec.error_report)) if np.ndim(dec.error_report) else
                int(dec.error_report))
        pcm = np.concatenate(out, axis=0)
        delay = (cfg.frame_length - 2 * cfg.la_zeroes) // args.dc \
            if args.dc else 0
        pcm = pcm[delay: delay + h.signal_len if h.signal_len else None]
        wavio.write_wav(args.output, pcm, h.samplerate,
                        sampwidth=args.bps // 8)
        if args.edf:
            np.asarray(edf_out, "<i2").tofile(args.edf)
        if args.ep_dbg:
            np.asarray(dbg["bfi"], "<i2").tofile(args.ep_dbg + ".bfi")
            np.asarray(dbg["epmr"], "<i2").tofile(args.ep_dbg + ".epmr")
            np.asarray(dbg["error_report"], "<i2").tofile(
                args.ep_dbg + ".error_report")
        if not args.q:
            print(f"decoded {len(frames)} frames -> {args.output}")
        return 0

    if encode and decode:
        # encdec mode: encode then immediately decode in-process
        cfg = replace(cfg0, bps=args.bps)
        dec = StreamDecoder(cfg, n_streams=channels)
        out = []
        for i, fr in enumerate(frames_out):
            bfi = 1 if (pattern is not None and not args.ept
                        and _loopy(pattern, i)) else 0
            out.append(dec.decode(fr, bfi=bfi).T)
        pcm_out = np.concatenate(out, axis=0)
        delay = (cfg.frame_length - 2 * cfg.la_zeroes) // args.dc \
            if args.dc else 0
        pcm_out = pcm_out[delay: delay + n_samples]
        wavio.write_wav(args.output, pcm_out, fs, sampwidth=args.bps // 8)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
