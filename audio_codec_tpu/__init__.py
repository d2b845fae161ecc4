"""audio_codec_tpu — a batched LC3plus (ETSI TS 103 634) codec framework.

JAX/XLA reimplementation of the LC3plus encoder/decoder: thousands of
independent streams ride a [n_streams, ...] batch axis, sharded over device
meshes with shard_map; the ETSI reference codec is used only as the
conformance oracle (see SURVEY.md).
"""
import jax as _jax

# The codec's transforms, SNS and PLC analysis run as f32 matmuls. On the GPU
# the default precision lets XLA run them in TF32 (about 3 decimal digits),
# which is not accurate enough for conformance (RMS >= 14 bits against the
# ETSI reference), so true-f32 matmuls are forced package-wide.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import Config

__all__ = ["Config"]
