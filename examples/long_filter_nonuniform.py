"""Long-filter convolution with the two-stage non-uniform engine.

Demonstrates the long-filter surface on a reverb-scale filter (131072
taps = 3 s at 44.1 kHz):

- ``engine_mode="auto"`` picks the non-uniform (Gardner two-stage) engine
  for long filters on an accelerator — ~4x fewer MAC bytes per block than
  the uniform engine at the same one-block latency (core/nonuniform.py).
- ``nu_tail_store="bfloat16"`` (opt-in) halves the tail stage's memory
  traffic for a documented ~56 dB + tail-energy-deficit precision class.
- The known-answer self-check verdict is cached in the profile dir
  (engine/selfcheck.py), so re-opening the same session skips the 32-block
  verification stream; compiled graphs go to JAX's persistent cache.

Run:  python examples/long_filter_nonuniform.py [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--bf16-tail", action="store_true",
                    help="store the tail stage in bfloat16 (half traffic, "
                         "~56 dB-class tail precision)")
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                    ImpulseFileSpec, StreamSpec)
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor
    from bfir_tpu.io import wavio

    from bfir_tpu.utils import platform

    on_cpu = platform.is_cpu()
    rate = 44100
    taps = 32768 if on_cpu else 131072  # CPU demo keeps the runtime short
    rng = np.random.default_rng(0)

    # synthetic exponentially-decaying stereo "room" impulse
    t = np.arange(taps)
    h = (rng.standard_normal((2, taps)) * np.exp(-t / (taps / 8))) * 0.05
    imp_path = "/tmp/bfir_example_room.wav"
    wavio.write(imp_path, h.T, rate, subtype="float64")

    cfg = EngineConfig(
        filter=FilterSpec(block_length=1024, n_partitions=1, dtype="float32"),
        stream=StreamSpec(n_channels=2, sample_rate=rate),
        chain=ChainSpec(files=(
            ImpulseFileSpec(enabled=True, filename=imp_path),
            ImpulseFileSpec(), ImpulseFileSpec())),
        engine_mode="auto" if not on_cpu else "nonuniform",
        nu_tail_store="bfloat16" if args.bf16_tail else "float32",
    )
    cache = ArtifactCache("/tmp/bfir_example_profile")

    t0 = time.time()
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 64 * 1024)).astype(np.float32)
    y = sp.process(x)  # pipelined per-block dispatch
    print(f"engine: {sp._impl} (geometry {sp._nuspec if sp._impl == 'nonuniform' else sp.n_partitions})")
    print(f"open + 64 blocks: {time.time() - t0:.1f}s; "
          f"latency {sp.block_timer.summary()}")

    # bulk render: one lax.scan dispatch for the whole buffer
    t0 = time.time()
    yb = sp.process_buffer(rng.standard_normal((2, 64 * 1024)).astype(np.float32))
    print(f"bulk 64 blocks (one dispatch): {time.time() - t0:.2f}s")

    from scipy import signal

    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref ** 2).sum())
                        / float(((y - ref) ** 2).sum()))
    print(f"SNR vs scipy float64: {snr:.1f} dB")
    print("re-opening the same config now hits the self-check verdict cache "
          f"({cache.path('selfcheck-cache.json')})")


if __name__ == "__main__":
    main()
