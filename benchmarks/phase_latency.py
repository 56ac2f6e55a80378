"""Per-phase device latency of the non-uniform engines.

The two-stage schedule's per-block cost is uneven by construction: phase
R-1 of ``step_nu`` runs the whole tail fire. This benchmark measures the
DEVICE time of each distinct phase graph for

  - the standard ``step_nu`` (phases: hold, fire), and
  - the split-tail ``step_nu_split`` (phases: 0 = fwd M-transform + band 0,
    mid = one MAC band, R-1 = last band + inverse),

using phase-PINNED differential scans: a ``lax.scan`` of the static-phase
step is dispatched at two lengths and the wall-time difference divided by
the length delta (the host round-trip is a per-dispatch constant that
cancels; min() statistics because host noise is one-sided). Pinning the phase repeats one phase's exact compute graph
with threaded state; the data it sees differs from a real stream, which
does not affect timing on this hardware (static shapes, no data-dependent
control flow).

Artifact: one JSON line with per-phase ms, the amortized mean, and the
worst/mean ratio for both schedules. The real-time budget context: one
1024-sample block at 44.1 kHz is 23.2 ms.

Run:  python benchmarks/phase_latency.py [--cpu] [--out PHASE_LAT.json]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bfir_tpu.utils import platform  # noqa: E402


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    out_path = None
    if "--out" in argv:
        out_path = argv[argv.index("--out") + 1]
    import jax

    if "--cpu" in argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bfir_tpu.core import nonuniform as NU

    on_cpu = platform.is_cpu()
    channels = 8 if on_cpu else 64
    block = 128 if on_cpu else 1024
    ratio = 2 if on_cpu else 8
    p_tail = 2 if on_cpu else 14
    spec = NU.NuSpec(block_length=block, ratio=ratio, p_head=2 * ratio,
                     p_tail=p_tail)
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((channels, spec.max_taps))
         * np.exp(-np.arange(spec.max_taps) / 20000.0)).astype(np.float32) * 0.05
    co = NU.nu_coeffs(h, spec, channels)

    k1, k2 = (2, 6) if on_cpu else (16, 144)
    n_draws = 3 if on_cpu else 10

    def timed_phase(step_factory, label):
        """Differential scan timing of one pinned-phase step."""
        def mk(kk):
            def scan_fn(st, g, blocks):
                def body(s, blk):
                    return step_factory(s, g, blk)
                return jax.lax.scan(body, st, blocks)
            return jax.jit(scan_fn, donate_argnums=0)

        g1, g2 = mk(k1), mk(k2)
        res = {}
        for fn, kk in ((g1, k1), (g2, k2)):
            st = init()
            pool = [jax.device_put(rng.standard_normal(
                (kk, channels, block)).astype(np.float32)) for _ in range(2)]
            jax.block_until_ready(pool)
            t0 = time.time()
            st, o = fn(st, co, pool[0])
            float(jnp.sum(o))
            ts = []
            for i in range(n_draws):
                t0 = time.time()
                st, o = fn(st, co, pool[i % 2])
                float(jnp.sum(o))
                ts.append(time.time() - t0)
            res[kk] = float(np.min(ts))
        t = max((res[k2] - res[k1]) / (k2 - k1), 1e-9)
        print(f"  {label}: {t*1e3:.4f} ms/block", file=sys.stderr)
        return t

    results = {"backend": platform.backend(), "channels": channels,
               "block": block, "ratio": ratio,
               "budget_ms_per_block": block / 44100.0 * 1e3}

    # --- standard step_nu: hold phase (0) and fire phase (R-1) ------------
    init = lambda: NU.init_nu_state(spec, channels)
    print("standard step_nu:", file=sys.stderr)
    t_hold = timed_phase(
        lambda s, g, b: NU.step_nu(s, g, b, phase=0),
        "hold phase")
    t_fire = timed_phase(
        lambda s, g, b: NU.step_nu(s, g, b, phase=ratio - 1),
        "fire phase (R-1)")
    mean_std = (t_hold * (ratio - 1) + t_fire) / ratio
    results["std"] = {
        "hold_ms": t_hold * 1e3, "fire_ms": t_fire * 1e3,
        "mean_ms": mean_std * 1e3,
        "worst_over_mean": t_fire / mean_std,
    }

    # --- split-tail step_nu_split: every DISTINCT phase graph -------------
    # (0 = fwd + insert + band 0; 1..R-2 = one band; R-1 = band + inverse)
    init = lambda: NU.init_nu_split_state(spec, channels)
    print("split-tail step_nu_split:", file=sys.stderr)

    def split_at(ph):
        return lambda s, g, b: NU._split_phase(s, g, b, ph)

    distinct = sorted({0, min(1, ratio - 1), ratio - 1})
    t_by_phase = {}
    for ph in distinct:
        t_by_phase[ph] = timed_phase(
            split_at(ph), f"phase {ph} (band {ph}"
                          + (", fwd+insert" if ph == 0 else "")
                          + (", inverse" if ph == ratio - 1 else "") + ")")
    # undistinguished mid phases share phase 1's graph (one band)
    mid_ph = min(1, ratio - 1)
    phases = [t_by_phase.get(p, t_by_phase[mid_ph]) for p in range(ratio)]
    mean_split = sum(phases) / ratio
    worst = max(phases)
    results["split"] = {
        "phase_ms": {p: t * 1e3 for p, t in t_by_phase.items()},
        "mean_ms": mean_split * 1e3,
        "worst_over_mean": worst / mean_split,
        "worst_ms": worst * 1e3,
    }
    results["split_smooths_spike"] = bool(
        results["split"]["worst_over_mean"]
        < results["std"]["worst_over_mean"])

    line = json.dumps(results)
    print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
