"""Worked example: multi-stage room correction, end to end.

Builds a synthetic "room" (a reverberant impulse response), designs a
correction chain (room-correction FIR + taming EQ), streams program audio
through it, and shows the control-server workflow — everything a
vsu/foo-dsp-bfir user does, with this framework's API.

    python examples/room_correction.py [workdir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(workdir="/tmp/bfir_example"):
    import jax

    # default to CPU; set BFIR_EXAMPLE_GPU=1 to run on the accelerator
    if os.environ.get("BFIR_EXAMPLE_GPU") != "1":
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass

    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, EqSpec, FilterSpec,
                                    ImpulseFileSpec)
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor
    from bfir_tpu.io import wavio
    from bfir_tpu.ops.noise import calculate_attenuation

    os.makedirs(workdir, exist_ok=True)
    rate = 44100
    rng = np.random.default_rng(0)

    # 1. a synthetic room: direct path + early reflections + decaying tail
    room = np.zeros(8000)
    room[0] = 1.0
    for d, g in [(441, 0.4), (1103, -0.3), (2205, 0.2)]:
        room[d] += g
    room += rng.standard_normal(8000) * np.exp(-np.arange(8000) / 1500) * 0.05

    # 2. "measurement-based" correction: invert the minimum set of peaks by
    #    a simple matched FIR (for the example, the time-reversed early part)
    correction = room[:2048][::-1].copy()
    correction /= np.abs(np.convolve(room, correction)).max() ** 0.5
    corr_path = os.path.join(workdir, "correction.wav")
    wavio.write(corr_path, np.stack([correction] * 2, -1), rate, subtype="float64")

    # 3. headroom: auto-attenuate like the plugin does when a file is picked
    att_db = calculate_attenuation(np.stack([correction] * 2), block_length=1024,
                                   dtype="float64")
    print(f"headroom probe suggests {att_db:.1f} dB attenuation")

    # 4. the chain: correction FIR + a gentle bass-taming EQ
    eq_mags = [0] * 31
    for band in range(0, 6):
        eq_mags[band] = -30  # -3 dB below 63 Hz
    cfg = EngineConfig(
        filter=FilterSpec(block_length=1024, dtype="float64"),
        chain=ChainSpec(
            eq=EqSpec(enabled=True, mag_steps=tuple(eq_mags)),
            files=(ImpulseFileSpec(enabled=True, filename=corr_path,
                                   level_steps=int(att_db * 10)),
                   ImpulseFileSpec(), ImpulseFileSpec()),
        ),
    )

    # 5. stream program audio through the corrected chain
    sp = StreamProcessor(cfg, ArtifactCache(os.path.join(workdir, "profile")))
    t = np.arange(rate * 2) / rate
    program = 0.3 * np.sin(2 * np.pi * 110 * t) + 0.2 * np.sin(2 * np.pi * 1000 * t)
    x = np.stack([program, program])
    y = sp.process_buffer(x, sample_rate=rate)
    out_path = os.path.join(workdir, "corrected.wav")
    wavio.write(out_path, y.T, rate, subtype="pcm24")
    print(f"processed {y.shape[1]} frames -> {out_path}")
    print(f"chain: {sp.n_partitions} partitions x {cfg.filter.block_length} taps")
    print(f"block latency: {sp.block_timer.summary()}")
    of = sp.overflow_stats()
    print(f"overflows: {np.asarray(of.n_overflows).tolist()}")


if __name__ == "__main__":
    main(*(sys.argv[1:2] or []))
