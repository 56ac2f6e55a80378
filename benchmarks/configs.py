"""BASELINE.json benchmark configs 1-4, runnable on one chip (or CPU).

    python benchmarks/configs.py [--config N] [--cpu]

Each config reports throughput and a scipy SNR check to stdout as one JSON
line per config (bench.py remains the single-line headline harness; this
script evidences the full workload matrix):

1. mono 44.1 kHz, 4096-tap windowed-sinc lowpass, single partition
2. stereo 10-band EQ -> FIR render -> 16384-tap convolution + 16-bit dither
3. low-latency: 8 partitions x 512 taps, stereo, block 512
4. 8-channel room correction, 65536 taps/ch @ 96 kHz, 44.1->96 resample
5. long-filter tier: 64 ch x 640 partitions
   (655360 taps ≈ 15 s reverb @ 44.1 kHz) — differential device floors of
   the two-stage AND three-stage engines at the same geometry, evidencing
   the session auto-mode crossover (nonuniform3 at P >= 640)
(6. pod-scale lives in parallel/ — exercised by dryrun_multichip and
    tests/test_parallel.py on a virtual mesh; real multi-host needs a pod.)
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bfir_tpu.utils import platform  # noqa: E402


def log(m):
    print(m, file=sys.stderr, flush=True)


def snr_db(y, ref):
    err = y - ref
    return 10 * np.log10(float((ref**2).sum()) / max(float((err**2).sum()), 1e-300))


def run_stream(spec, h, x, jax, jnp, dither_fmt=None):
    """Stream x [C, T] through the engine.

    Returns ``(y, dt_wall, floor)``:
    - ``y``: the ENGINE output (pre-quantization; if ``dither_fmt`` is set,
      the dithered/quantized signal is returned as well — callers report
      engine SNR on the raw output so a regression isn't masked by the
      quantizer noise floor),
    - ``dt_wall``: wall seconds per block of one whole-stream scan dispatch
      (secondary; includes one host round-trip),
    - ``floor``: the DIFFERENTIAL device floor (two scan lengths, wall-time
      difference / length delta, min-of-3 interleaved — bench.py's
      protocol; the round-trip constant cancels).
    """
    from bfir_tpu.core import convolver as cv
    from bfir_tpu.ops import dither as dth
    from bfir_tpu.ops import formats as fm

    c, t = x.shape
    n = spec.block_length
    co = cv.coeffs_to_spectra(h, spec)
    dst = dth.init_dither_state(c, dtype=np.float32) if dither_fmt else None
    of = dth.init_overflow_stats(c, dtype=np.float32)
    nblk = t // n
    k1 = max(1, nblk // 4)

    # one lax.scan dispatch for the stream (the session's bulk form): a
    # per-block dispatch loop would time the host round-trip, not the
    # engine — the scan amortizes it
    def scan_fn(st_, co_, blocks):
        return jax.lax.scan(lambda s, blk: cv.step(s, co_, blk), st_, blocks)

    all_blocks = x[:, : nblk * n].reshape(c, nblk, n).transpose(1, 0, 2)
    f = jax.jit(scan_fn, donate_argnums=0)
    pools = {kk: jnp.asarray(all_blocks[:kk]) for kk in (k1, nblk)}
    times = {k1: [], nblk: []}
    y = None
    for kk in (k1, nblk):  # compile + warm both lengths
        st, outs = f(cv.init_state(spec, c), co, pools[kk])
        jax.block_until_ready(outs)
    for _round in range(3):  # min-of-N: host stalls are one-sided
        for kk in (k1, nblk):
            t0 = time.time()
            st, outs = f(cv.init_state(spec, c), co, pools[kk])
            out_np = np.asarray(outs)
            times[kk].append(time.time() - t0)
            if kk == nblk:
                y = out_np
    dt = min(times[nblk]) / nblk
    floor = max((min(times[nblk]) - min(times[k1])) / (nblk - k1), 1e-9)
    y = y.transpose(1, 0, 2).reshape(c, -1)
    yq = None
    if dither_fmt is not None:
        # output stage (dither + quantize) over the whole stream at once
        q, of, dst = fm.output_stage(jnp.asarray(y), dither_fmt, of, dst)
        yq = np.asarray(q) / dither_fmt.full_scale
    return (y, yq, dt, floor) if dither_fmt is not None else (y, dt, floor)


def config1(jax, jnp):
    from bfir_tpu.core.spec import FilterSpec
    from bfir_tpu.ops.firwindow import design_lowpass
    from scipy import signal

    rate = 44100
    h = design_lowpass(4096, 8000 / rate, beta=9.0).astype(np.float32)
    spec = FilterSpec(block_length=4096, n_partitions=1, dtype="float32")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4096 * 16)).astype(np.float32) * 0.5
    y, dt, floor = run_stream(spec, h, x, jax, jnp)
    ref = signal.fftconvolve(x[0].astype(np.float64), h.astype(np.float64))[: y.shape[1]]
    return dict(config=1, desc="mono 4096-tap lowpass, 1 partition",
                floor_ms_per_block=floor * 1e3,
                floor_sps=x.shape[0] * spec.block_length / floor,
                wall_ms_per_block=dt * 1e3,
                snr_engine_db=snr_db(y[0], ref))


def config2(jax, jnp):
    from bfir_tpu.core.spec import FilterSpec, SampleFormat
    from bfir_tpu.ops.equalizer import render_fir
    from scipy import signal

    rate = 44100
    mags = [0.0] * 31
    for b in range(8, 18):
        mags[b] = 4.0
    h1 = np.asarray(render_fir(32768, mags, rate, dtype=jnp.float32))[:16384]
    h = np.stack([h1, h1])
    spec = FilterSpec(block_length=1024, n_partitions=16, dtype="float32")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1024 * 32)).astype(np.float32) * 0.1
    y, yq, dt, floor = run_stream(spec, h, x, jax, jnp,
                                  dither_fmt=SampleFormat.S16_LE)
    ref = signal.fftconvolve(x[0].astype(np.float64), h[0].astype(np.float64))[: y.shape[1]]
    return dict(config=2, desc="stereo EQ->16384-tap conv + s16 dither",
                floor_ms_per_block=floor * 1e3,
                floor_sps=2 * spec.block_length / floor,
                wall_ms_per_block=dt * 1e3,
                snr_engine_db=snr_db(y[0], ref),      # pre-quantizer
                snr_quantized_db=snr_db(yq[0], ref))  # incl. s16 dither


def config3(jax, jnp):
    from bfir_tpu.core.spec import FilterSpec
    from scipy import signal

    spec = FilterSpec(block_length=512, n_partitions=8, dtype="float32")
    rng = np.random.default_rng(2)
    h = (rng.standard_normal((2, 4096)) * np.exp(-np.arange(4096) / 1000)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 512 * 64)).astype(np.float32)
    y, dt, floor = run_stream(spec, h, x, jax, jnp)
    ref = signal.fftconvolve(x[0].astype(np.float64), h[0].astype(np.float64))[: y.shape[1]]
    return dict(config=3, desc="low-latency 8x512-tap partitions, block 512",
                floor_ms_per_block=floor * 1e3,
                floor_sps=2 * spec.block_length / floor,
                wall_ms_per_block=dt * 1e3,
                snr_engine_db=snr_db(y[0], ref), latency_ms=512 / 44.1)


def config4(jax, jnp):
    from bfir_tpu.core.spec import FilterSpec
    from bfir_tpu.ops.resample import resample
    from scipy import signal

    rng = np.random.default_rng(3)
    # impulse authored at 44.1k, resampled to the 96k stream rate
    h441 = (rng.standard_normal((8, 30000)) * np.exp(-np.arange(30000) / 8000)).astype(np.float64) * 0.05
    t0 = time.time()
    h96 = np.asarray(resample(h441, 44100, 96000, dtype=np.float64))[:, :65536].astype(np.float32)
    resample_s = time.time() - t0
    spec = FilterSpec(block_length=1024, n_partitions=64, dtype="float32")
    x = rng.standard_normal((8, 1024 * 16)).astype(np.float32) * 0.2
    y, dt, floor = run_stream(spec, h96, x, jax, jnp)
    ref = signal.fftconvolve(x[0].astype(np.float64), h96[0].astype(np.float64))[: y.shape[1]]
    return dict(config=4, desc="8ch 65536 taps @ 96kHz with 44.1->96 resample",
                floor_ms_per_block=floor * 1e3,
                floor_sps=8 * spec.block_length / floor,
                wall_ms_per_block=dt * 1e3,
                snr_engine_db=snr_db(y[0], ref), resample_s=resample_s)


def _nu_floor(mk_scan, init_state, coeffs, k1, k2, n_draws, c, jax, jnp):
    """Differential device floor of a nu/nu3 scan: seconds per N-block
    (bench.py's protocol: min-of-draws, two interleaved rounds)."""
    import jax as _jax

    times = {k1: [], k2: []}
    scans, pools = {}, {}
    st = init_state()
    rng = np.random.default_rng(9)
    n = 1024
    for kk in (k1, k2):
        scans[kk] = mk_scan()
        pools[kk] = [jax.device_put(rng.standard_normal(
            (kk, c, n)).astype(np.float32)) for _ in range(2)]
        _jax.block_until_ready(pools[kk])
        t0 = time.time()
        st, o = scans[kk](st, coeffs, pools[kk][0])
        float(jnp.sum(o))
        log(f"  floor compile (K={kk}): {time.time()-t0:.1f}s")
    for _round in range(2):
        for kk in (k1, k2):
            for i in range(n_draws):
                t0 = time.time()
                st, o = scans[kk](st, coeffs, pools[kk][i % 2])
                float(jnp.sum(o))
                times[kk].append(time.time() - t0)
    return max((min(times[k2]) - min(times[k1])) / (k2 - k1), 1e-9)


def config5(jax, jnp):
    """Long-filter tier: 64 ch x 655360 taps. Measures the two-stage and
    three-stage engines' device floors at the SAME geometry class the
    session auto-mode decides between (nonuniform3 above 640 partitions;
    crossover measured ~600k taps, CLAUDE.md), each scipy-verified first."""
    from scipy import signal

    from bfir_tpu.core import nonuniform as NU

    on_cpu = platform.is_cpu()
    c = 4 if on_cpu else 64
    n = 1024
    taps = (640 * n) if not on_cpu else (40 * n)
    rng = np.random.default_rng(5)
    h = (rng.standard_normal((c, taps)) *
         np.exp(-np.arange(taps) / 60000.0)).astype(np.float32) * 0.05
    out = dict(config=5, desc=f"long-filter tier: {c}ch x {taps} taps "
               "(nu2 vs nu3 floors)")

    # ---- two-stage at this length
    spec2 = NU.nu_geometry(taps, n, ratio=8)
    co2 = NU.nu_coeffs(h, spec2, c)
    scan2 = lambda: jax.jit(NU.process_blocks_nu_fast, donate_argnums=0)
    ncheck = (spec2.delay_blocks + 2) * spec2.ratio
    st = NU.init_nu_state(spec2, c)
    xs = rng.standard_normal((c, ncheck * n)).astype(np.float32)
    blocks = jnp.asarray(xs.reshape(c, ncheck, n).transpose(1, 0, 2))
    t0 = time.time()
    st, o = scan2()(st, co2, blocks)
    y = np.asarray(o).transpose(1, 0, 2).reshape(c, -1)
    log(f"  nu2 check ({ncheck} blocks) ran in {time.time()-t0:.1f}s")
    ref = signal.fftconvolve(xs.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    snr2 = min(snr_db(y[ch], ref[ch]) for ch in range(c))
    log(f"  nu2 worst-channel SNR: {snr2:.1f} dB")
    out["nu2_snr_db"] = snr2
    if snr2 >= 80:
        r = spec2.ratio
        f2 = _nu_floor(scan2, lambda: NU.init_nu_state(spec2, c), co2,
                       2 * r, (6 if on_cpu else 18) * r,
                       3 if on_cpu else 8, c, jax, jnp)
        out["nu2_floor_ms"] = f2 * 1e3
        out["nu2_sps"] = c * n / f2
        log(f"  nu2 floor: {f2*1e3:.3f} ms/block")

    # ---- three-stage at the same length
    spec3 = NU.nu3_geometry(taps, n, ratio1=8, ratio2=8)
    co3 = NU.nu3_coeffs(h, spec3, c)
    scan3 = lambda: jax.jit(NU.process_blocks_nu3_fast, donate_argnums=0)
    sup = spec3.ratio1 * spec3.inner.ratio
    inner = spec3.inner
    ncheck3 = -(-(((inner.delay_blocks + 2) * inner.ratio
                   + spec3.delay_blocks) * spec3.ratio1) // sup) * sup
    st = NU.init_nu3_state(spec3, c)
    xs = rng.standard_normal((c, ncheck3 * n)).astype(np.float32)
    blocks = jnp.asarray(xs.reshape(c, ncheck3, n).transpose(1, 0, 2))
    t0 = time.time()
    st, o = scan3()(st, co3, blocks)
    y = np.asarray(o).transpose(1, 0, 2).reshape(c, -1)
    log(f"  nu3 check ({ncheck3} blocks) ran in {time.time()-t0:.1f}s")
    ref = signal.fftconvolve(xs.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    snr3 = min(snr_db(y[ch], ref[ch]) for ch in range(c))
    log(f"  nu3 worst-channel SNR: {snr3:.1f} dB")
    out["nu3_snr_db"] = snr3
    if snr3 >= 80:
        f3 = _nu_floor(scan3, lambda: NU.init_nu3_state(spec3, c), co3,
                       sup, (2 if on_cpu else 3) * sup,
                       2 if on_cpu else 6, c, jax, jnp)
        out["nu3_floor_ms"] = f3 * 1e3
        out["nu3_sps"] = c * n / f3
        log(f"  nu3 floor: {f3*1e3:.3f} ms/block")
    if "nu2_floor_ms" in out and "nu3_floor_ms" in out:
        out["auto_pick"] = ("nonuniform3"
                            if out["nu3_floor_ms"] < out["nu2_floor_ms"]
                            else "nonuniform")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    log(f"backend={platform.backend()}")
    runners = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    todo = [args.config] if args.config else sorted(runners)
    for n in todo:
        try:
            res = runners[n](jax, jnp)
            res = {k: (round(v, 2) if isinstance(v, float) else v) for k, v in res.items()}
            print(json.dumps(res), flush=True)
        except Exception as e:
            print(json.dumps({"config": n, "error": f"{type(e).__name__}: {e}"}),
                  flush=True)


if __name__ == "__main__":
    main()
