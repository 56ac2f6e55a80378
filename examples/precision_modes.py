"""Worked example: engine precision modes in float32 arithmetic.

The reference plugin computes in C double end to end (REALSIZE=8,
foo_dsp_bfir/common.h:17). With x64 off JAX computes in float32 — this
example shows what that means in practice and how this framework closes
the gap:

1. the default f32 halfcomplex path (fast: the streaming hot path),
2. the same config with float64 requested -> the "extended" df64 engine
   (two-float compensated arithmetic, kernels/extended.py),
3. the residual of each against a float64 scipy oracle.

    python examples/precision_modes.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    if os.environ.get("BFIR_EXAMPLE_GPU") != "1":
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass

    import dataclasses
    import tempfile

    from scipy import signal

    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                    ImpulseFileSpec, StreamSpec)
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor
    from bfir_tpu.io import wavio

    rng = np.random.default_rng(0)
    fs = 48000
    c = 2

    # a long, dense FIR (e.g. a measured room response)
    taps = 32768
    h = (rng.standard_normal((c, taps)) *
         np.exp(-np.arange(taps) / 6000.0)) * 0.05

    # program material
    x = rng.standard_normal((c, fs)).astype(np.float64) * 0.3
    ref = signal.fftconvolve(x, h, axes=1)[:, : x.shape[1]]

    with tempfile.TemporaryDirectory() as td:
        imp = os.path.join(td, "ir.wav")
        wavio.write(imp, h.T, fs, subtype="float64")
        base = EngineConfig(
            filter=FilterSpec(block_length=1024, n_partitions=1, dtype="float32"),
            stream=StreamSpec(n_channels=c, sample_rate=fs),
            chain=ChainSpec(files=(ImpulseFileSpec(enabled=True, filename=imp),
                                   ImpulseFileSpec(), ImpulseFileSpec())),
        )

        for label, cfg in [
            ("f32 halfcomplex (engine_mode='hc')",
             dataclasses.replace(base, engine_mode="hc")),
            ("extended df64 (engine_mode='extended')",
             dataclasses.replace(base, engine_mode="extended")),
        ]:
            sp = StreamProcessor(cfg, ArtifactCache(os.path.join(td, "p")))
            y = np.asarray(sp.process(x), dtype=np.float64)
            n = min(y.shape[1], ref.shape[1])
            err = y[:, :n] - ref[:, :n]
            snr = 10 * np.log10((ref[:, :n] ** 2).sum() / max((err ** 2).sum(), 1e-300))
            print(f"{label:45s} impl={sp._impl:9s} SNR vs f64 oracle: {snr:6.1f} dB")

    print("\nOn an f64-less backend, EngineConfig(filter=FilterSpec(dtype="
          "'float64')) with engine_mode='auto' resolves to 'extended' "
          "automatically — the honest REALSIZE=8 behavior.")


if __name__ == "__main__":
    main()
