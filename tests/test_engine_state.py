"""Engine state contract: checkpoint/resume bit-identity, 24/32-bit PCM
scaling, arbitrary-nbytes resize (SURVEY.md §5: the codec state itself is
the checkpoint; lc3.h user-allocated persistent structs)."""
from __future__ import annotations

import numpy as np
import jax
import pytest

from audio_codec_tpu.config import Config
from audio_codec_tpu.engine import StreamDecoder, StreamEncoder

CFG = Config(fs_in=16000, bitrate=32000)


def _pcm(n_frames, b, n, seed=0, scale=3000.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_frames, b, n)) * scale).astype(np.float32)


def test_encoder_checkpoint_resume_bit_identical():
    pcm = _pcm(7, 1, CFG.frame_length)
    enc = StreamEncoder(CFG, 1)
    for f in range(4):
        enc.encode(pcm[f])
    snapshot = jax.device_get(enc.state)          # checkpoint = the pytree
    ref = [enc.encode(pcm[4 + f]) for f in range(3)]

    enc2 = StreamEncoder(CFG, 1)
    enc2.state = jax.device_put(snapshot)          # resume
    got = [enc2.encode(pcm[4 + f]) for f in range(3)]
    assert got == ref


def test_decoder_checkpoint_resume_bit_identical():
    pcm = _pcm(7, 1, CFG.frame_length)
    enc = StreamEncoder(CFG, 1)
    frames = [b"".join(enc.encode(pcm[f])) for f in range(7)]
    dec = StreamDecoder(CFG, 1)
    for f in range(4):
        dec.decode(frames[f])
    snapshot = jax.device_get(dec.state)
    ref = [dec.decode(frames[4 + f]).copy() for f in range(3)]

    dec2 = StreamDecoder(CFG, 1)
    dec2.state = jax.device_put(snapshot)
    for f in range(3):
        np.testing.assert_array_equal(dec2.decode(frames[4 + f]), ref[f])


def test_bps24_payload_identical_and_output_scaled():
    """lc3_enc24/dec24 (enc_lc3_fl.c:30-42, dec_lc3_fl.c:116-128): 24-bit
    input/256 hits the same codec path; output is the 16-bit signal x256
    up to output rounding."""
    pcm16 = _pcm(3, 1, CFG.frame_length)
    cfg24 = Config(fs_in=16000, bitrate=32000, bps=24)

    e16, e24 = StreamEncoder(CFG, 1), StreamEncoder(cfg24, 1)
    d16, d24 = StreamDecoder(CFG, 1), StreamDecoder(cfg24, 1)
    for f in range(3):
        p16 = e16.encode(pcm16[f])
        p24 = e24.encode(pcm16[f] * 256.0)
        assert p16 == p24
        o16 = d16.decode(b"".join(p16)).astype(np.int64)
        o24 = d24.decode(b"".join(p24)).astype(np.int64)
        sat = (o16 <= -32768) | (o16 >= 32767)
        assert np.abs(o24 - 256 * o16)[~sat].max() <= 256  # rounding only


def test_resize_accepts_padded_nbytes():
    """update_dec_bitrate semantics: any in-range byte count maps to a
    bitrate without state reset (setup_dec_lc3.c:203+); a padded frame
    must not raise."""
    pcm = _pcm(2, 1, CFG.frame_length)
    enc = StreamEncoder(CFG, 1)
    frame = b"".join(enc.encode(pcm[0]))
    dec = StreamDecoder(CFG, 1)
    out = dec.decode(frame + b"\x00")  # 41 bytes: not an exact 10ms bitrate
    assert out.shape == (1, CFG.frame_length)
    assert dec.cfg.targetBytes == len(frame) + 1
    with pytest.raises(ValueError):
        dec.decode(b"\x00" * 8)  # below MIN_NBYTES


def test_plc_trigger_frame_conceals():
    """-ept frames (lastnzTrigger, fixed_point/enc_entropy.c:31,65): the
    decoder's side parse must reject the frame and run concealment."""
    enc = StreamEncoder(CFG, 1)
    trig = b"".join(enc.encode_plc_trigger())
    assert len(trig) == CFG.targetBytes
    dec = StreamDecoder(CFG, 1)
    out = dec.decode(trig)
    assert int(dec.last_bfi[0]) == 1
    assert out.shape == (1, CFG.frame_length)


@pytest.mark.parametrize("fs,bitrate", [(16000, 32000), (48000, 64000)])
def test_state_signature_stable_across_step(fs, bitrate):
    """The stepped enc/dec state must carry the SAME abstract jit signature
    (shape+dtype+weak_type) as the init state: any divergence makes every
    state-feedback loop (serving, bench.py) recompile on its second call —
    round 4's decode bench measured exactly such a 27 s recompile instead
    of throughput (PERF.md)."""
    from audio_codec_tpu.models import decoder, encoder, state as S
    import jax.numpy as jnp

    cfg = Config(fs_in=fs, bitrate=bitrate)
    B = 2
    pcm = jnp.asarray(_pcm(1, B, cfg.frame_length)[0])

    def sig(tree):
        return [(jax.tree_util.keystr(p), jax.api_util.shaped_abstractify(v))
                for p, v in jax.tree_util.tree_leaves_with_path(tree)]

    est = S.enc_state_init(cfg, B)
    est2, out, _ = jax.jit(lambda s, p: encoder.encode_frame(cfg, s, p))(est, pcm)
    assert sig(est) == sig(est2)

    dst = S.dec_state_init(cfg, B)
    dst2, _, _ = jax.jit(lambda s, f: decoder.decode_frame(cfg, s, f))(
        dst, out.astype(jnp.int32))
    assert sig(dst) == sig(dst2)


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_state_pytree_roundtrip_and_replace(kind):
    """EncState/DecState are frozen dataclasses registered as pytrees: every
    field is a leaf, in declaration order; flatten/unflatten is lossless
    and .replace returns an updated copy."""
    import dataclasses
    from audio_codec_tpu.models import state as S

    cfg = Config(fs_in=48000, bitrate=64000, plc_mode=1)
    st = (S.enc_state_init if kind == "enc" else S.dec_state_init)(cfg, 3)
    names = [f.name for f in dataclasses.fields(st)]
    paths, treedef = jax.tree_util.tree_flatten_with_path(st)
    assert [jax.tree_util.keystr(p) for p, _ in paths] == [f".{n}" for n in names]
    back = jax.tree_util.tree_unflatten(treedef, [v for _, v in paths])
    assert type(back) is type(st)
    for n in names:
        assert getattr(back, n) is getattr(st, n)

    first = names[0]
    new_leaf = getattr(st, first) + 1
    st2 = st.replace(**{first: new_leaf})
    assert getattr(st2, first) is new_leaf
    assert all(getattr(st2, n) is getattr(st, n) for n in names[1:])
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(st, first, new_leaf)
