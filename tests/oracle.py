"""Oracle helpers: run the instrumented ETSI reference and load golden dumps.

The ETSI binaries in .oracle/ are the conformance gold standard (SURVEY.md §4).
`enc_dumps(...)` / `dec_dumps(...)` run the instrumented float codec once per
operating point and cache the per-stage tensors recorded by the lc3_dump hooks
(tools/instrument_oracle.py); tests reshape them into [n_frames, ...] arrays.
"""
from __future__ import annotations

import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ORACLE_FL = REPO / ".oracle/src/floating_point/LC3plus"
ORACLE_FX = REPO / ".oracle/src/fixed_point/LC3plus"
TESTVEC = REPO / ".oracle/testvec/input"
CACHE = REPO / "tests/.cache"

_DTYPES = {"f32": np.float32, "i32": np.int32, "u8": np.uint8, "i16": np.int16}


ORACLE_ABSENT = 3  # tools/build_oracle.sh: no .oracle/ build, no ETSI source


def ensure_oracle() -> None:
    """Build the oracle on first use. Skips the calling test when neither
    the .oracle/ binaries nor the ETSI reference source exist; any other
    build failure fails the test."""
    if ORACLE_FL.exists():
        return
    r = subprocess.run([str(REPO / "tools/build_oracle.sh")],
                       capture_output=True, text=True)
    if r.returncode == ORACLE_ABSENT:
        import pytest
        pytest.skip(f"ETSI oracle absent: {r.stderr.strip()}")
    if r.returncode:
        raise subprocess.CalledProcessError(r.returncode, r.args,
                                            r.stdout, r.stderr)
    subprocess.run(["python", str(REPO / "tools/instrument_oracle.py")], check=True)


def _run(args: list[str], dump_dir: Path | None = None) -> None:
    env = None
    if dump_dir is not None:
        import os
        env = dict(os.environ, LC3_DUMP_DIR=str(dump_dir))
    subprocess.run(args, check=True, capture_output=True, env=env)


def _load_dir(d: Path) -> dict[str, np.ndarray]:
    out = {}
    for f in d.iterdir():
        ext = f.suffix[1:]
        if ext in _DTYPES:
            out[f.stem] = np.fromfile(f, dtype=_DTYPES[ext])
    return out


def enc_dumps(wav: str, bitrate: int, frame_ms: float = 10.0) -> tuple[dict, Path]:
    """Encode testvec `wav` at `bitrate`; return (stage dumps, bitstream path)."""
    ensure_oracle()
    key = f"enc_{wav}_{bitrate}_{frame_ms}"
    d = CACHE / key
    bs = d / "out.bin"
    if not bs.exists():
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        args = [str(ORACLE_FL), "-q", "-E"]
        if frame_ms != 10.0:
            args += ["-frame_ms", str(frame_ms)]
        args += [str(TESTVEC / f"{wav}.wav"), str(bs), str(bitrate)]
        _run(args, dump_dir=d)
    return _load_dir(d), bs


def dec_dumps(bitstream: Path, tag: str) -> tuple[dict, Path]:
    """Decode a bitstream with the oracle; return (stage dumps, wav path)."""
    ensure_oracle()
    h = hashlib.sha256(bitstream.read_bytes()).hexdigest()[:16]
    d = CACHE / f"dec_{tag}_{h}"
    wav = d / "out.wav"
    if not wav.exists():
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        _run([str(ORACLE_FL), "-q", "-D", str(bitstream), str(wav), "0"], dump_dir=d)
    return _load_dir(d), wav


def fx_encode(wav: str, bitrate: int, ep_mode: int = 0) -> Path:
    """Encode testvec `wav` with the fixed-point oracle (the testvec MD5
    gate's encoder half, testvec/testvecCheck.pl); returns bitstream path."""
    ensure_oracle()
    d = CACHE / f"fxenc_{wav}_{bitrate}_ep{ep_mode}"
    bs = d / "out.bin"
    if not bs.exists():
        d.mkdir(parents=True, exist_ok=True)
        args = [str(ORACLE_FX), "-q"]
        if ep_mode:
            args += ["-epmode", str(ep_mode)]
        args += ["-E", str(TESTVEC / f"{wav}.wav"), str(bs), str(bitrate)]
        _run(args)
    return bs


def fx_dec_dumps(bitstream: Path, tag: str, epf: Path | None = None
                 ) -> tuple[dict, Path]:
    """Decode a bitstream with the instrumented fixed-point oracle; return
    (per-stage integer dumps, wav path). `epf` applies a frame-erasure
    pattern (PLC frames are not dumped: hooks gate on bfi == 0)."""
    ensure_oracle()
    h = hashlib.sha256(bitstream.read_bytes()).hexdigest()[:16]
    d = CACHE / f"fxdec_{tag}_{h}{'_epf' if epf else ''}"
    wav = d / "out.wav"
    if not wav.exists():
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        args = [str(ORACLE_FX), "-q"]
        if epf is not None:
            args += ["-epf", str(epf)]
        args += ["-D", str(bitstream), str(wav), "0"]
        _run(args, dump_dir=d)
    return _load_dir(d), wav


def frames(dumps: dict, name: str, width: int) -> np.ndarray:
    """Reshape a flat dump into [n_frames, width]."""
    a = dumps[name]
    assert a.size % width == 0, (name, a.size, width)
    return a.reshape(-1, width)


def read_wav_mono(path: Path) -> tuple[np.ndarray, int]:
    """Minimal 16-bit WAV reader (PCM mono/stereo -> [n, ch] int16)."""
    import wave
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        ch = w.getnchannels()
        data = np.frombuffer(w.readframes(n), dtype=np.int16).reshape(-1, ch)
        return data, w.getframerate()
