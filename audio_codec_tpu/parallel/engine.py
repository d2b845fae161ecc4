"""Multi-device stream engine: shard_map'd encode/decode over a device mesh.

The production serving path (SURVEY.md §2.7 / §5):
- streams are sharded over a 1-D ('streams',) mesh spanning the devices;
- per-stream carry state (MDCT/OLA memory, LTPF history, PLC context,
  gain-loop memory — the EncState/DecState pytrees) stays device-local;
- a frame step is one shard_map'd jit call; multiple frames can be fused
  with lax.scan over a [T, B, N] PCM block (frames of one stream are
  sequential by construction, so scan-over-time is the only legal order);
- stream migration for rebalancing moves state slices with ppermute.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Config
from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..models import state as S
from . import mesh as M


class ShardedEncoder:
    """Encoder over n_streams sharded across the mesh's 'streams' axis."""

    def __init__(self, cfg: Config, n_streams: int, mesh: Mesh | None = None):
        self.cfg = cfg
        self.mesh = mesh or M.stream_mesh()
        n_dev = self.mesh.devices.size
        assert n_streams % n_dev == 0, (n_streams, n_dev)
        self.n = n_streams
        self.state = M.shard_state(self.mesh, S.enc_state_init(cfg, n_streams))
        self._step = self._build_step()
        self._scan = {}

    def _build_step(self):
        cfg = self.cfg
        spec = P("streams")

        def local_step(st, pcm):
            st, out, _ = enc_m.encode_frame(cfg, st, pcm)
            return st, out

        fn = jax.shard_map(local_step, mesh=self.mesh,
                           in_specs=(spec, spec), out_specs=(spec, spec),
                           check_vma=False)
        return jax.jit(fn)

    def step(self, pcm):
        """pcm: [B, frame_length] → bytes [B, nbytes] (device arrays)."""
        self.state, out = self._step(self.state, pcm)
        return out

    def _build_scan(self, t: int):
        cfg = self.cfg
        spec = P("streams")

        def local_scan(st, pcm_block):  # pcm_block: [T, b, N] local shard
            def body(st, pcm):
                st, out, _ = enc_m.encode_frame(cfg, st, pcm)
                return st, out
            return jax.lax.scan(body, st, pcm_block)

        fn = jax.shard_map(local_scan, mesh=self.mesh,
                           in_specs=(spec, P(None, "streams")),
                           out_specs=(spec, P(None, "streams")),
                           check_vma=False)
        return jax.jit(fn)

    def encode_block(self, pcm_block):
        """pcm_block: [T, B, frame_length] → [T, B, nbytes]."""
        t = pcm_block.shape[0]
        if t not in self._scan:
            self._scan[t] = self._build_scan(t)
        self.state, out = self._scan[t](self.state, pcm_block)
        return out


class ShardedDecoder:
    def __init__(self, cfg: Config, n_streams: int, mesh: Mesh | None = None):
        self.cfg = cfg
        self.mesh = mesh or M.stream_mesh()
        assert n_streams % self.mesh.devices.size == 0
        self.n = n_streams
        self.state = M.shard_state(self.mesh, S.dec_state_init(cfg, n_streams))
        spec = P("streams")

        def local_step(st, payload, bfi):
            st, pcm, _ = dec_m.decode_frame(cfg, st, payload, bfi)
            return st, pcm

        self._step = jax.jit(jax.shard_map(
            local_step, mesh=self.mesh, in_specs=(spec, spec, spec),
            out_specs=(spec, spec), check_vma=False))

    def step(self, payload, bfi):
        self.state, pcm = self._step(self.state, payload, bfi)
        return pcm


def migrate_streams(mesh: Mesh, tree, perm: list[tuple[int, int]]):
    """Move whole per-device stream blocks along `perm` (src, dst) pairs via
    ppermute — the rebalancing primitive for elastic serving."""
    spec = P("streams")

    def shift(x):
        return jax.lax.ppermute(x, "streams", perm)

    fn = jax.shard_map(lambda t: jax.tree_util.tree_map(shift, t),
                       mesh=mesh, in_specs=(spec,), out_specs=spec,
                       check_vma=False)
    return jax.jit(fn)(tree)
