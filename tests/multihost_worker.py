"""One process of an N-process CPU 'pod' for tests/test_multihost.py.

Each worker owns 4 virtual CPU devices; jax.distributed glues them into one
global mesh (the multi-host 'hosts' axis of SURVEY.md §2.7). The worker
encodes the same deterministic stream set as the single-process reference
and dumps the rows its devices own; the parent test asserts bit-identity —
making topology a pure-throughput variable, the multi-host contract of
SURVEY.md §4."""
import os
import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, outdir, frames = sys.argv[3], sys.argv[4], int(sys.argv[5])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from audio_codec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from audio_codec_tpu.parallel import mesh as pm
    pm.distributed_init(f"localhost:{port}", nproc, pid)

    import numpy as np
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.parallel import engine as pe

    cfg = Config(fs_in=16000, bitrate=32000)
    assert jax.device_count() == 4 * nproc, jax.device_count()
    assert jax.local_device_count() == 4
    mesh = pm.stream_mesh()
    B = jax.device_count()
    enc = pe.ShardedEncoder(cfg, B, mesh)
    rng = np.random.default_rng(0)
    for f in range(frames):
        pcm = (rng.standard_normal((B, cfg.frame_length)) * 3000.0
               ).astype(np.float32)
        out = enc.step(pm.global_streams(mesh, pcm))
        for s in out.addressable_shards:
            i0 = s.index[0].start or 0
            np.save(os.path.join(outdir, f"p{pid}_f{f}_r{i0}.npy"),
                    np.asarray(s.data))
    print(f"WORKER-OK {pid}")


if __name__ == "__main__":
    main()
