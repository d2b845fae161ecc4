// Native host-side runtime helpers for the batched LC3plus engine.
//
// The accelerator owns the compute path (JAX/XLA); these are the host hot
// loops around it when serving large stream batches — the role the
// reference fills with its C CLI/runtime layer (codec_exe.c bitstream
// framing, tinywave PCM conversion; SURVEY.md §2.4) and the RTL fills with
// its AXI data plane. Python drives them through ctypes
// (audio_codec_tpu/utils/native.py).
//
// Build: tools/build_native.sh  →  native/liblc3tpu_host.so
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// PCM conversion: interleaved int16/24/32 <-> per-stream float frames
// ---------------------------------------------------------------------------

// Deinterleave int16 PCM [n_frames*frame_len, n_streams] into float32
// [n_streams, n_frames, frame_len] (the encoder's batch layout).
void pcm16_deinterleave(const int16_t* pcm, int n_samples, int n_streams,
                        float* out) {
    for (int s = 0; s < n_streams; s++) {
        float* dst = out + (int64_t)s * n_samples;
        const int16_t* src = pcm + s;
        for (int i = 0; i < n_samples; i++) {
            dst[i] = (float)src[(int64_t)i * n_streams];
        }
    }
}

// Interleave float32 [n_streams, n_samples] into int16 with saturation and
// C-style half-away rounding (dec_lc3_fl.c:116-123).
void pcm16_interleave(const float* x, int n_samples, int n_streams,
                      int16_t* out) {
    for (int s = 0; s < n_streams; s++) {
        const float* src = x + (int64_t)s * n_samples;
        int16_t* dst = out + s;
        for (int i = 0; i < n_samples; i++) {
            float v = src[i];
            v = v >= 0.0f ? (float)(int64_t)(v + 0.5f) : -(float)(int64_t)(-v + 0.5f);
            if (v > 32767.f) v = 32767.f;
            if (v < -32768.f) v = -32768.f;
            dst[(int64_t)i * n_streams] = (int16_t)v;
        }
    }
}

// 24-bit packed PCM -> int32 (sign extended), as scale_signal24 consumes it.
void pcm24_unpack(const uint8_t* raw, int n, int32_t* out) {
    for (int i = 0; i < n; i++) {
        int32_t v = (int32_t)raw[3 * i] | ((int32_t)raw[3 * i + 1] << 8) |
                    ((int32_t)raw[3 * i + 2] << 16);
        out[i] = (v << 8) >> 8;
    }
}

// ---------------------------------------------------------------------------
// Bitstream container framing (codec_exe.c:737-766 format)
// ---------------------------------------------------------------------------

// Scan a container body (after the 20-byte header): record each frame's
// (offset, length). Returns the number of frames found, or -1 on a
// truncated record. offsets/lengths must hold max_frames entries.
int bs_scan_frames(const uint8_t* body, int64_t body_len, int64_t* offsets,
                   int32_t* lengths, int max_frames) {
    int64_t off = 0;
    int n = 0;
    while (off + 2 <= body_len && n < max_frames) {
        int len = (int)body[off] | ((int)body[off + 1] << 8);
        if (off + 2 + len > body_len) return -1;
        offsets[n] = off + 2;
        lengths[n] = len;
        off += 2 + len;
        n++;
    }
    return n;
}

// Gather n_frames equal-length payloads into a dense [n_frames, nbytes]
// matrix (the decoder's batch input layout).
void bs_gather_frames(const uint8_t* body, const int64_t* offsets,
                      int n_frames, int nbytes, uint8_t* out) {
    for (int f = 0; f < n_frames; f++) {
        memcpy(out + (int64_t)f * nbytes, body + offsets[f], nbytes);
    }
}

// Emit a container body from a dense [n_frames, nbytes] payload matrix.
// Returns bytes written ( = n_frames * (2 + nbytes) ).
int64_t bs_emit_frames(const uint8_t* payloads, int n_frames, int nbytes,
                       uint8_t* out) {
    int64_t off = 0;
    for (int f = 0; f < n_frames; f++) {
        out[off] = (uint8_t)(nbytes & 0xFF);
        out[off + 1] = (uint8_t)(nbytes >> 8);
        memcpy(out + off + 2, payloads + (int64_t)f * nbytes, nbytes);
        off += 2 + nbytes;
    }
    return off;
}

// ---------------------------------------------------------------------------
// G.192 softbit framing (codec_exe.c:705-735)
// ---------------------------------------------------------------------------

// Encode one payload into G.192 softbits. out must hold 2*(2 + 8*nbytes)
// bytes. Returns number of u16 words written.
int g192_pack(const uint8_t* payload, int nbytes, int good, uint16_t* out) {
    out[0] = good ? 0x6B21 : 0x6B20;
    out[1] = (uint16_t)(nbytes * 8);
    int w = 2;
    for (int i = 0; i < nbytes; i++) {
        for (int b = 0; b < 8; b++) {
            out[w++] = (payload[i] >> b) & 1 ? 0x0081 : 0x007F;
        }
    }
    return w;
}

// Decode one G.192 frame. Returns payload length in bytes, sets *bfi.
// words must contain at least 2 + nbits entries.
int g192_unpack(const uint16_t* words, uint8_t* payload, int* bfi) {
    int nbits = words[1];
    *bfi = (words[0] == 0x6B20) ? 1 : 0;
    int nbytes = nbits / 8;
    for (int i = 0; i < nbytes; i++) {
        uint8_t v = 0;
        for (int b = 0; b < 8; b++) {
            if (words[2 + 8 * i + b] == 0x0081) v |= (1u << b);
        }
        payload[i] = v;
    }
    return nbytes;
}

}  // extern "C"
