"""Round-4 surface walkthrough: sharded non-uniform engine + per-channel
delay on the config surface.

- ``engine_mode="sharded"`` with ``sharded_local="nonuniform"`` runs the
  two-stage Gardner engine over a device mesh — the pod path executes the
  FASTEST single-chip engine, with one nearest-neighbor collective-permute
  + one psum per stage (head every block, tail every R-th block;
  parallel/sharded.py, byte-checked against parallel/COMM_MODEL.md).
- ``EngineConfig.delay``: per-channel integer + fractional (Kaiser-sinc)
  output delay — the BruteFIR library capability (delay.cpp:495-600) the
  reference plugin never exposed. Values change live without a rebuild.

Run:  python examples/pod_and_delay.py            # 8 virtual CPU devices
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # virtual mesh demo; a
                                           # multi-GPU host uses the same
                                           # code path

import numpy as np
from scipy import signal

from bfir_tpu.core.spec import (ChainSpec, DelaySpec, EngineConfig,
                                FilterSpec, ImpulseFileSpec, StreamSpec)
from bfir_tpu.engine.cache import ArtifactCache
from bfir_tpu.engine.session import StreamProcessor
from bfir_tpu.io import wavio
from bfir_tpu.parallel import mesh as M


def main():
    rng = np.random.default_rng(0)
    block = 128
    c = 4
    # reverb-scale filter: two-stage head (16 x 128) + 3 tail partitions
    taps = 16 * block + 3 * 8 * block
    imp = (rng.standard_normal((c, taps)) *
           np.exp(-np.arange(taps) / 1500.0)).astype(np.float64) * 0.05

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ir.wav")
        wavio.write(path, imp.T, 44100, subtype="float64")
        cfg = EngineConfig(
            filter=FilterSpec(block_length=block, n_partitions=1,
                              dtype="float32"),
            stream=StreamSpec(n_channels=c, sample_rate=44100),
            chain=ChainSpec(files=(
                ImpulseFileSpec(enabled=True, filename=path),
                ImpulseFileSpec(), ImpulseFileSpec())),
            engine_mode="sharded",
            sharded_local="nonuniform",
            # 0 / 32 / 64 / 96 samples of per-channel output delay
            delay=DelaySpec(enabled=True, samples=(0, 32, 64, 96)),
        )
        mesh = M.make_mesh(channel_shards=2, partition_shards=4)
        sp = StreamProcessor(cfg, ArtifactCache(os.path.join(td, "prof")),
                             mesh=mesh)
        x = rng.standard_normal((c, 40 * block))
        y = sp.process(x)
        assert sp._impl == "sharded"
        assert sp._sharded.local_impl == "nonuniform"
        print(f"mesh: {dict(mesh.shape)}  engine: sharded/"
              f"{sp._sharded.local_impl}  nuspec: head "
              f"{sp._nuspec.p_head}x{block} + tail "
              f"{sp._nuspec.p_tail}x{sp._nuspec.m}")

        # verify each channel against scipy WITH its configured delay
        delays = (0, 32, 64, 96)
        base = np.stack([signal.fftconvolve(x[ch], imp[ch])[: y.shape[1]]
                         for ch in range(c)])
        worst = np.inf
        for ch, d in enumerate(delays):
            ref = (np.concatenate([np.zeros(d), base[ch][: y.shape[1] - d]])
                   if d else base[ch])
            num = float((ref ** 2).sum())
            den = float(((y[ch] - ref) ** 2).sum())
            worst = min(worst, 10 * np.log10(num / max(den, 1e-300)))
        print(f"worst-channel SNR vs delayed scipy reference: {worst:.1f} dB")
        assert worst > 100

        # live delay change: no rebuild, takes effect at the next block
        import dataclasses

        sp.reconfigure(dataclasses.replace(
            cfg, delay=DelaySpec(enabled=True, samples=(16, 16, 16, 16))))
        y2 = sp.process(rng.standard_normal((c, 8 * block)))
        print(f"live delay change applied; streamed {y2.shape[1]} more "
              "frames without rebuild")


if __name__ == "__main__":
    main()
