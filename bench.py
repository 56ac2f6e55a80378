"""Benchmark harness: the BASELINE.json headline workload.

Measures the partitioned convolution engine at 64 channels x 131072 taps
(128 partitions x 1024-sample blocks, float32) on one chip and prints ONE
JSON line. Eight paths are measured:

- streaming: per-block dispatch through the halfcomplex step, both
  sync (p50 latency) and pipelined-with-async-fetch (the session's actual
  dispatch pattern), plus the differential device floor
- nustream: the two-stage non-uniform engine (the auto mode for long
  filters) — f32, shared-filter, int24-tail and split-tail(+int24) floors
- batch: `process_batch` (block-axis FFT over 240 blocks per dispatch)
- bulk: the offline render path (core/bulk.py engines)
- fft: transform microbench with measured-peak rooflines
- phase: per-phase latency of the nu schedules (worst-block evidence)
- socket: loopback TCP through the pipelined audio server (RT factor)
- extended: the df64 precision engine's floor and SNR

"value" is the best path's throughput in audio samples (frames x
channels) per second. The reference publishes no numbers (BASELINE.md), so
"vs_baseline" is the real-time factor: value / (44100 Hz * 64 ch). Output
correctness is spot-checked against scipy each run; a failed check zeroes
the result rather than reporting a wrong-fast number.

Timing notes: inputs are pre-staged on device (a pool of distinct blocks,
cycled) so host->device copies stay out of the device-time numbers;
completion is forced every iteration via a scalar reduction fetch. Extra
diagnostics go to stderr; stdout carries exactly one JSON line. Every
number this prints comes from the device it ran on; nothing here has been
measured on the GPU yet (PERF.md).
"""

import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _platform():
    # imported lazily: the parent process runs every path as a subprocess
    # and never imports JAX itself
    from bfir_tpu.utils import platform

    return platform


CHANNELS = 64
BLOCK = 1024
PARTITIONS = 128  # 131072 taps
GBATCH_G = 8  # M-cycles per batched bulk-scan iteration
              # (sweep: benchmarks/gbatch_probe.py)


def snr_db(y, ref):
    err = y - ref
    return 10 * np.log10(float((ref**2).sum()) / max(float((err**2).sum()), 1e-300))


def worst_channel_snr(y, ref):
    """Minimum per-channel SNR: a shape-dependent miscompile can corrupt a
    single channel, which must not hide behind an aggregate."""
    return min(snr_db(y[c], ref[c]) for c in range(y.shape[0]))


def bench_streaming(spec, h, jnp, jax, n_iters):
    """Streaming path = the uniform halfcomplex engine
    (kernels.spectrum_mac.step_hc, StreamProcessor's "hc" engine)."""
    from bfir_tpu.kernels import spectrum_mac as K

    chc = K.hc_coeffs(h, spec, CHANNELS)
    step = jax.jit(K.step_hc, donate_argnums=0)
    rng = np.random.default_rng(1)
    state = K.init_hc_state(spec, CHANNELS)
    x0 = jnp.asarray(rng.standard_normal((CHANNELS, BLOCK)).astype(np.float32))
    t0 = time.time()
    state, out = step(state, chc, x0)
    float(jnp.sum(out))
    log(f"streaming compile: {time.time()-t0:.1f}s")

    # correctness: short stream vs scipy, worst channel of all 64
    from scipy import signal

    st2 = K.init_hc_state(spec, CHANNELS)
    xs = rng.standard_normal((CHANNELS, BLOCK * 3)).astype(np.float32)
    outs = []
    for b in range(3):
        st2, o = step(st2, chc, jnp.asarray(xs[:, b * BLOCK : (b + 1) * BLOCK]))
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)
    ref = signal.fftconvolve(xs.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    s = worst_channel_snr(y, ref)
    log(f"streaming worst-channel SNR vs scipy: {s:.1f} dB")
    if s < 80:
        return 0.0, float("nan"), float("nan"), s

    # host<->device round-trip of a scalar fetch, for the record: the floor
    # numbers are differential (the round-trip cancels)
    tiny = jnp.zeros((8,), jnp.float32)
    float(jnp.sum(tiny))
    rts = []
    for _ in range(10):
        t0 = time.time()
        float(jnp.sum(tiny))
        rts.append(time.time() - t0)
    rt_ms = min(rts) * 1e3
    log(f"host round-trip: min {rt_ms:.3f} ms")

    pool = [jnp.asarray(rng.standard_normal((CHANNELS, BLOCK)).astype(np.float32))
            for _ in range(16)]
    jax.block_until_ready(pool)
    lats = []
    for i in range(n_iters):
        t0 = time.time()
        state, out = step(state, chc, pool[i % 16])
        float(jnp.sum(out))  # force completion
        lats.append(time.time() - t0)
    p50 = float(np.percentile(lats, 50))
    p99 = float(np.percentile(lats, 99))
    log(f"streaming (sync per block): p50 {p50*1e3:.3f} / p99 {p99*1e3:.3f} "
        f"ms/block -> {BLOCK*CHANNELS/p50/1e6:.0f} M samples/s")

    # pipelined dispatch — what StreamProcessor.process() actually does
    # since r3: block k+1 enqueued before block k's output fetch (NaN guard
    # one block behind) and all pending device->host copies started async
    # before the first blocking read, so the round-trip amortizes across
    # the pipeline depth — the product-surface streaming rate. Total
    # wall time over all blocks with a full drain (no chained-async
    # mismeasurement: every output is host-materialized inside the window).
    depth = 32  # ~ StreamProcessor.MAX_INFLIGHT/2, the session's steady depth
    inflight = []
    t_all0 = time.time()
    for i in range(2 * n_iters):
        state, out = step(state, chc, pool[i % 16])
        out.copy_to_host_async()
        inflight.append(out)
        if len(inflight) >= depth:
            np.asarray(inflight.pop(0))
    for out in inflight:
        np.asarray(out)
    per_block = (time.time() - t_all0) / (2 * n_iters)
    sps = BLOCK * CHANNELS / per_block
    log(f"streaming (pipelined depth-{depth}, async fetch): "
        f"{per_block*1e3:.3f} ms/block -> {sps/1e6:.0f} M samples/s")

    # device floor: K steps chained in one lax.scan dispatch, measured
    # DIFFERENTIALLY (two scan lengths, divide the wall-time difference):
    # the host round-trip is a per-dispatch constant that cancels, so the
    # number is the device-side step (rfft + ring MAC + irfft).
    on_cpu = _platform().is_cpu()
    k1, k2 = (2, 6) if on_cpu else (16, 144)

    def mk_scan(kk):
        def scan_steps(st, g, blocks):
            def body(s, blk):
                return K.step_hc(s, g, blk)
            return jax.lax.scan(body, st, blocks)
        return jax.jit(scan_steps, donate_argnums=0), kk

    floors = {}
    st3 = K.init_hc_state(spec, CHANNELS)
    for fsc, kk in (mk_scan(k1), mk_scan(k2)):
        blocks_pool = [jax.device_put(rng.standard_normal(
            (kk, CHANNELS, BLOCK)).astype(np.float32)) for _ in range(2)]
        jax.block_until_ready(blocks_pool)
        t0 = time.time()
        st3, o = fsc(st3, chc, blocks_pool[0])
        float(jnp.sum(o))
        log(f"stream-floor compile (K={kk}): {time.time()-t0:.1f}s")
        ts = []
        for i in range(max(3, n_iters // 4)):
            t0 = time.time()
            st3, o = fsc(st3, chc, blocks_pool[i % 2])
            float(jnp.sum(o))
            ts.append(time.time() - t0)
        floors[kk] = float(np.min(ts))  # host noise is one-sided
    floor = max((floors[k2] - floors[k1]) / (k2 - k1), 1e-9)
    log(f"streaming device floor: {floor*1e3:.3f} ms/block "
        f"(differential {k1}/{k2} scan)")
    return sps, p50, p99, rt_ms, floor, s


def bench_streaming_nu(h, jnp, jax, n_iters):
    """Streaming through the two-stage non-uniform engine
    (core.nonuniform.step_nu): head at N=1024 x 16 partitions + tail at
    M=8192 x 14 partitions fired every 8th block — ~4x less amortized
    memory traffic than the uniform ring at the same one-block latency. Absolute
    scipy verification first (worst channel, enough blocks that the tail
    stage carries real signal), then the differential device floor."""
    from scipy import signal

    from bfir_tpu.core import nonuniform as NU

    on_cpu = _platform().is_cpu()
    if on_cpu:
        spec = NU.NuSpec(block_length=BLOCK, ratio=2, p_head=4, p_tail=2)
    else:
        spec = NU.nu_geometry(PARTITIONS * BLOCK, BLOCK, ratio=8)
    hh = h[:, : spec.max_taps]
    coeffs = NU.nu_coeffs(hh, spec, CHANNELS)
    rng = np.random.default_rng(3)
    ratio = spec.ratio

    # macro formulation (process_blocks_nu_fast): bench streams are M-cycle
    # aligned, and the per-block cond makes XLA carry the untaken tail
    # branch as a ~60 MB ring copy every block
    scan = jax.jit(NU.process_blocks_nu_fast, donate_argnums=0)

    # correctness: enough blocks that pending tail outputs land (>= (D+1)*R)
    ncheck = (spec.delay_blocks + 2) * ratio
    st = NU.init_nu_state(spec, CHANNELS)
    xs = rng.standard_normal((CHANNELS, ncheck * BLOCK)).astype(np.float32)
    blocks = jnp.asarray(xs.reshape(CHANNELS, ncheck, BLOCK).transpose(1, 0, 2))
    t0 = time.time()
    st, out = scan(st, coeffs, blocks)
    y = np.asarray(out).transpose(1, 0, 2).reshape(CHANNELS, -1)
    log(f"nu check ({ncheck} blocks) ran in {time.time()-t0:.1f}s")
    ref = signal.fftconvolve(xs.astype(np.float64), hh.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    s = worst_channel_snr(y, ref)
    log(f"nu streaming worst-channel SNR vs scipy: {s:.1f} dB")
    if s < 80:
        return 0.0, float("nan"), s

    # device floor, differential scans (multiples of R so every scan carries
    # the same tail-fire density and the difference is exactly (k2-k1)
    # steady-state blocks). The whole (k1, k2) measurement runs in TWO
    # interleaved rounds with min-of-all statistics (a one-sided-noise
    # floor needs more draws, and interleaving decorrelates a slow episode
    # from one k).
    k1, k2 = (2 * ratio, 6 * ratio) if on_cpu else (2 * ratio, 18 * ratio)
    floors = {k1: [], k2: []}
    scans = {}
    pools = {}
    st3 = NU.init_nu_state(spec, CHANNELS)
    for kk in (k1, k2):
        pools[kk] = [jax.device_put(rng.standard_normal(
            (kk, CHANNELS, BLOCK)).astype(np.float32)) for _ in range(2)]
        jax.block_until_ready(pools[kk])
        t0 = time.time()
        st3, o = scan(st3, coeffs, pools[kk][0])
        float(jnp.sum(o))
        log(f"nu-floor compile (K={kk}): {time.time()-t0:.1f}s")
    for _round in range(2):
        for kk in (k1, k2):
            for i in range(max(4, n_iters // 3)):
                t0 = time.time()
                st3, o = scan(st3, coeffs, pools[kk][i % 2])
                float(jnp.sum(o))
                floors[kk].append(time.time() - t0)
    floor = max((min(floors[k2]) - min(floors[k1])) / (k2 - k1), 1e-9)
    sps = BLOCK * CHANNELS / floor
    log(f"nu streaming device floor: {floor*1e3:.3f} ms/block "
        f"(differential {k1}/{k2} scan, 2 rounds x "
        f"{max(4, n_iters // 3)} draws) -> {sps/1e6:.0f} M samples/s "
        "device-side")

    # SHARED-filter workload (one filter for all channels — EQ-only chains):
    # coefficient planes collapse to [P, 2, Hp] and the MAC broadcasts
    # in the MAC, cutting coefficient memory traffic by 1/C. Verified
    # absolutely, then the same differential floor protocol.
    shared_floor = None
    shared_snr = None
    co_sh = None
    try:
        co_sh = NU.nu_coeffs(hh[:1], spec, CHANNELS, shared=True)
        st = NU.init_nu_state(spec, CHANNELS)
        st, out = scan(st, co_sh, blocks)
        y = np.asarray(out).transpose(1, 0, 2).reshape(CHANNELS, -1)
        ref_sh = signal.fftconvolve(
            xs.astype(np.float64),
            np.broadcast_to(hh[:1], hh.shape).astype(np.float64),
            axes=1)[:, : y.shape[1]]
        shared_snr = worst_channel_snr(y, ref_sh)
        log(f"nu SHARED worst-channel SNR vs scipy: {shared_snr:.1f} dB")
        if shared_snr >= 80:
            fl = {k1: [], k2: []}
            st3 = NU.init_nu_state(spec, CHANNELS)
            for kk in (k1, k2):
                t0 = time.time()
                st3, o = scan(st3, co_sh, pools[kk][0])
                float(jnp.sum(o))
                log(f"nu-shared compile (K={kk}): {time.time()-t0:.1f}s")
            for _round in range(2):
                for kk in (k1, k2):
                    for i in range(max(4, n_iters // 3)):
                        t0 = time.time()
                        st3, o = scan(st3, co_sh, pools[kk][i % 2])
                        float(jnp.sum(o))
                        fl[kk].append(time.time() - t0)
            shared_floor = max((min(fl[k2]) - min(fl[k1])) / (k2 - k1), 1e-9)
            log(f"nu SHARED device floor: {shared_floor*1e3:.3f} ms/block -> "
                f"{BLOCK*CHANNELS/shared_floor/1e6:.0f} M samples/s")
    except Exception as e:
        log(f"nu shared measurement failed ({type(e).__name__}: {e})")

    # INT24 block-scaled TAIL storage (r5: benchmarks/storage_snr.py — the
    # cheapest storage tier keeping >=125 dB), tail only: the per-block
    # head ring encode would eat a head saving.
    i24_floor = None
    i24_snr = None
    try:
        spec_i = NU.NuSpec(spec.block_length, spec.ratio, spec.p_head,
                           spec.p_tail, spec.dtype, "int24")
        co_i = NU.nu_coeffs(hh, spec_i, CHANNELS)
        st = NU.init_nu_state(spec_i, CHANNELS)
        st, out = scan(st, co_i, blocks)
        y = np.asarray(out).transpose(1, 0, 2).reshape(CHANNELS, -1)
        i24_snr = worst_channel_snr(y, ref)
        log(f"nu INT24 worst-channel SNR vs scipy: {i24_snr:.1f} dB")
        if i24_snr >= 80:
            fl = {k1: [], k2: []}
            st3 = NU.init_nu_state(spec_i, CHANNELS)
            for kk in (k1, k2):
                t0 = time.time()
                st3, o = scan(st3, co_i, pools[kk][0])
                float(jnp.sum(o))
                log(f"nu-int24 compile (K={kk}): {time.time()-t0:.1f}s")
            for _round in range(2):
                for kk in (k1, k2):
                    for i in range(max(4, n_iters // 3)):
                        t0 = time.time()
                        st3, o = scan(st3, co_i, pools[kk][i % 2])
                        float(jnp.sum(o))
                        fl[kk].append(time.time() - t0)
            i24_floor = max((min(fl[k2]) - min(fl[k1])) / (k2 - k1), 1e-9)
            log(f"nu INT24 device floor: {i24_floor*1e3:.3f} ms/block -> "
                f"{BLOCK*CHANNELS/i24_floor/1e6:.0f} M samples/s")
    except Exception as e:
        log(f"nu int24 measurement failed ({type(e).__name__}: {e})")

    # SPLIT-TAIL schedule with the int24 tail (r5): the session's
    # engine_mode="nonuniform_split" / the bulk renderer's engine — the
    # measured fastest >=125 dB streaming schedule (its phases overlap the
    # tail work with head work better than the monolithic fire, and the
    # per-block latency is near-uniform: PHASE_LAT artifact).
    split_floor = None
    split_snr = None
    try:
        spec_sp = NU.NuSpec(spec.block_length, spec.ratio, spec.p_head,
                            spec.p_tail, spec.dtype,
                            "float32" if on_cpu else "int24")
        co_sp = NU.nu_coeffs(hh, spec_sp, CHANNELS)
        scan_sp = jax.jit(
            lambda st, co_, blocks: NU.process_blocks_nu_split(
                st, co_, blocks),
            donate_argnums=0)
        st = NU.init_nu_split_state(spec_sp, CHANNELS)
        st, out = scan_sp(st, co_sp, blocks)
        y = np.asarray(out).transpose(1, 0, 2).reshape(CHANNELS, -1)
        split_snr = worst_channel_snr(y, ref)
        log(f"nu SPLIT(+int24) worst-channel SNR vs scipy: {split_snr:.1f} dB")
        if split_snr >= 125:
            fl = {k1: [], k2: []}
            st3 = NU.init_nu_split_state(spec_sp, CHANNELS)
            for kk in (k1, k2):
                t0 = time.time()
                st3, o = scan_sp(st3, co_sp, pools[kk][0])
                float(jnp.sum(o))
                log(f"nu-split compile (K={kk}): {time.time()-t0:.1f}s")
            for _round in range(2):
                for kk in (k1, k2):
                    for i in range(max(4, n_iters // 3)):
                        t0 = time.time()
                        st3, o = scan_sp(st3, co_sp, pools[kk][i % 2])
                        float(jnp.sum(o))
                        fl[kk].append(time.time() - t0)
            split_floor = max((min(fl[k2]) - min(fl[k1])) / (k2 - k1), 1e-9)
            log(f"nu SPLIT device floor: {split_floor*1e3:.4f} ms/block -> "
                f"{BLOCK*CHANNELS/split_floor/1e6:.0f} M samples/s")
    except Exception as e:
        log(f"nu split measurement failed ({type(e).__name__}: {e})")

    res = {"sps": sps, "floor": floor, "snr": s,
           "shared_floor": shared_floor, "shared_snr": shared_snr,
           "int24_floor": i24_floor, "int24_snr": i24_snr,
           "split_floor": split_floor, "split_snr": split_snr}

    # G-CYCLE BATCHED bulk scan (r5, core/nubatch.py): each scan iteration
    # consumes G M-cycles and runs every stage as one batched dispatch
    # (batched forwards/inverses; the correlation MAC reads coefficient
    # planes once per iteration instead of once per block/fire); the
    # offline/bulk figure of merit alongside the streaming floors above.
    try:
        from bfir_tpu.core import nubatch as NB

        gg = 2 if on_cpu else GBATCH_G
        scan_gb = jax.jit(
            lambda st, co_, blocks: NB.process_blocks_nu_gbatch(
                st, co_, blocks, cycles_per_step=gg),
            donate_argnums=0)
        ncheck_gb = max(2 * gg, 16 if not on_cpu else 4) * ratio
        xs_gb = rng.standard_normal(
            (CHANNELS, ncheck_gb * BLOCK)).astype(np.float32)
        blocks_gb = jnp.asarray(
            xs_gb.reshape(CHANNELS, ncheck_gb, BLOCK).transpose(1, 0, 2))
        ref_gb = signal.fftconvolve(
            xs_gb.astype(np.float64), hh.astype(np.float64),
            axes=1)[:, : ncheck_gb * BLOCK]
        for label, co_g, rr in (
                ("gbatch", coeffs, ref_gb),
                ("gbatch_shared", co_sh, None)):
            if co_g is None:
                continue
            st = NU.init_nu_state(spec, CHANNELS)
            st, out = scan_gb(st, co_g, blocks_gb)
            y = np.asarray(out).transpose(1, 0, 2).reshape(CHANNELS, -1)
            if rr is None:
                rr = signal.fftconvolve(
                    xs_gb.astype(np.float64),
                    np.broadcast_to(hh[:1], hh.shape).astype(np.float64),
                    axes=1)[:, : y.shape[1]]
            gsnr = worst_channel_snr(y, rr)
            res[f"{label}_snr"] = gsnr
            log(f"nu {label.upper()} worst-channel SNR vs scipy: "
                f"{gsnr:.1f} dB")
            if gsnr < 125:
                continue
            kg1, kg2 = (2 * gg * ratio, 6 * gg * ratio) if on_cpu else (
                gg * ratio, 3 * gg * ratio)
            fl = {kg1: [], kg2: []}
            st3 = NU.init_nu_state(spec, CHANNELS)
            gpools = {}
            for kk in (kg1, kg2):
                gpools[kk] = [jax.device_put(rng.standard_normal(
                    (kk, CHANNELS, BLOCK)).astype(np.float32))
                    for _ in range(2)]
                jax.block_until_ready(gpools[kk])
                t0 = time.time()
                st3, o = scan_gb(st3, co_g, gpools[kk][0])
                float(jnp.sum(o))
                log(f"nu-{label} compile (K={kk}): {time.time()-t0:.1f}s")
            for _round in range(2):
                for kk in (kg1, kg2):
                    for i in range(max(4, n_iters // 3)):
                        t0 = time.time()
                        st3, o = scan_gb(st3, co_g, gpools[kk][i % 2])
                        float(jnp.sum(o))
                        fl[kk].append(time.time() - t0)
            gfloor = max((min(fl[kg2]) - min(fl[kg1])) / (kg2 - kg1), 1e-9)
            res[f"{label}_floor"] = gfloor
            log(f"nu {label.upper()} (G={gg}) device floor: "
                f"{gfloor*1e3:.4f} ms/block -> "
                f"{BLOCK*CHANNELS/gfloor/1e6:.0f} M samples/s")
    except Exception as e:
        log(f"nu gbatch measurement failed ({type(e).__name__}: {e})")
    return res


def bench_bulk(h, jnp, jax, n_iters):
    """Offline/bulk render throughput at the BULK geometry (core/bulk.py):
    the filter re-partitioned at M=8192 x 16 partitions (vs the streaming
    128 x 1024) and run through the same batched block-axis-FFT formulation
    — the render()/render-CLI path. Offline has no latency constraint, so
    this is the fastest way through the chip for whole-file work; it must
    meet or beat the streaming floors. Absolute scipy
    verification first (fresh state, worst channel), then a scan-of-batches
    throughput measurement identical in structure to bench_batch."""
    from bfir_tpu.core import bulk as BK
    from bfir_tpu.core import convolver as cv

    on_cpu = _platform().is_cpu()
    if on_cpu:
        g = BK.BulkSpec(1024, 16, 8)
        scan_batches = 2
    else:
        g = BK.bulk_geometry(h.shape[-1])  # M=8192, P=16, B=30 at flagship
        scan_batches = 8
    fspec = g.filter_spec
    hh = h[:, : fspec.max_taps]
    co = cv.coeffs_to_spectra(hh, fspec)
    hs = cv.prepare_batch_coeffs(co, g.batch_blocks)

    def steps(st, co_, hs_, many):  # many: [NB, B, C, M]
        def body(s, blk):
            return cv.process_batch(s, co_, blk, coeff_batch_fft=hs_)
        return jax.lax.scan(body, st, many)

    f = jax.jit(steps, donate_argnums=0)
    m, b = g.block_length, g.batch_blocks

    # correctness vs scipy on a fresh state at the exact dispatch shape
    from scipy import signal

    rng = np.random.default_rng(12)
    one = jax.jit(lambda st, co_, hs_, blk: cv.process_batch(
        st, co_, blk, coeff_batch_fft=hs_))
    st2 = cv.init_state(fspec, CHANNELS)
    xs = rng.standard_normal((b, CHANNELS, m)).astype(np.float32)
    _, o = one(st2, co, hs, jnp.asarray(xs))
    y = np.asarray(o).transpose(1, 0, 2).reshape(CHANNELS, -1)
    flat = xs.transpose(1, 0, 2).reshape(CHANNELS, -1)
    ref = signal.fftconvolve(flat.astype(np.float64), hh.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    s = worst_channel_snr(y, ref)
    log(f"bulk (M={m}, P={fspec.n_partitions}, B={b}) worst-channel SNR vs "
        f"scipy: {s:.1f} dB")
    if s < 80:
        return 0.0, s

    # DIFFERENTIAL device time (the established protocol): scans of NB1 and
    # NB2 batches per dispatch; the host round-trip is a per-dispatch
    # constant that cancels in the difference
    key = jax.random.PRNGKey(4)
    nb1, nb2 = max(1, scan_batches // 4), scan_batches
    fs = {}
    pools = {}
    times = {nb1: [], nb2: []}
    state = cv.init_state(fspec, CHANNELS)
    for nb in (nb1, nb2):
        fs[nb] = jax.jit(steps, donate_argnums=0)
        make_pool = jax.jit(lambda k, nb=nb: jax.random.normal(
            k, (nb, b, CHANNELS, m), dtype=jnp.float32))
        pools[nb] = [make_pool(k) for k in jax.random.split(
            jax.random.fold_in(key, nb), 2)]
        jax.block_until_ready(pools[nb])
        t0 = time.time()
        state, outs = fs[nb](state, co, hs, pools[nb][0])
        float(jnp.sum(outs))
        log(f"bulk scan compile (NB={nb}): {time.time()-t0:.1f}s")
    for _round in range(2):
        for nb in (nb1, nb2):
            for i in range(n_iters):
                t0 = time.time()
                state, outs = fs[nb](state, co, hs, pools[nb][i % 2])
                float(jnp.sum(outs))
                times[nb].append(time.time() - t0)
    dsamp = (nb2 - nb1) * b * m
    per_samp = max((min(times[nb2]) - min(times[nb1])) / dsamp, 1e-15)
    sps = CHANNELS / per_samp
    log(f"bulk (batched M-form): {per_samp*BLOCK*1e3:.3f} ms/1024-frames-"
        f"equiv (differential NB={nb1}/{nb2}) -> {sps/1e6:.0f} M samples/s")
    if on_cpu:
        return sps, s

    # the RENDER path's engine for long filters (core/bulk.py): the
    # split-tail scan with the int24 tail store — measured r5 the fastest
    # >=125 dB schedule on the chip. Scipy-verified, then the differential
    # floor; bulk_sps reports the best form (what render() actually runs).
    try:
        from bfir_tpu.core import nonuniform as NU

        spec_nu = NU.nu_geometry(h.shape[-1], BLOCK, ratio=8,
                                 tail_store="int24")
        co_nu = NU.nu_coeffs(h, spec_nu, CHANNELS)
        scan = jax.jit(NU.process_blocks_nu_split, donate_argnums=0)
        ncheck = (spec_nu.delay_blocks + 3) * spec_nu.ratio
        xs = np.random.default_rng(14).standard_normal(
            (CHANNELS, ncheck * BLOCK)).astype(np.float32)
        blocks2 = jnp.asarray(
            xs.reshape(CHANNELS, ncheck, BLOCK).transpose(1, 0, 2))
        st = NU.init_nu_split_state(spec_nu, CHANNELS)
        st, out = scan(st, co_nu, blocks2)
        y2 = np.asarray(out).transpose(1, 0, 2).reshape(CHANNELS, -1)
        ref2 = signal.fftconvolve(xs.astype(np.float64),
                                  h.astype(np.float64),
                                  axes=1)[:, : y2.shape[1]]
        s2 = worst_channel_snr(y2, ref2)
        log(f"bulk render engine (split+int24) worst-channel SNR: {s2:.1f} dB")
        if s2 >= 125:
            rng2 = np.random.default_rng(15)
            k1, k2 = 16, 144
            pools = {k: [jax.device_put(rng2.standard_normal(
                (k, CHANNELS, BLOCK)).astype(np.float32)) for _ in range(2)]
                for k in (k1, k2)}
            st3 = NU.init_nu_split_state(spec_nu, CHANNELS)
            fl = {k1: [], k2: []}
            for kk in (k1, k2):
                st3, o = scan(st3, co_nu, pools[kk][0])
                float(jnp.sum(o))
            for _r in range(2):
                for kk in (k1, k2):
                    for i in range(6):
                        t0 = time.time()
                        st3, o = scan(st3, co_nu, pools[kk][i % 2])
                        float(jnp.sum(o))
                        fl[kk].append(time.time() - t0)
            floor = max((min(fl[k2]) - min(fl[k1])) / (k2 - k1), 1e-9)
            sps_nu = BLOCK * CHANNELS / floor
            log(f"bulk render engine floor: {floor*1e3:.4f} ms/block -> "
                f"{sps_nu/1e6:.0f} M samples/s")
            if sps_nu > sps:
                sps, s = sps_nu, min(s, s2)
    except Exception as e:
        log(f"bulk render-engine measurement failed "
            f"({type(e).__name__}: {e})")
    return sps, s


def bench_batch(spec, h, jnp, jax, n_iters, batch_blocks=240, scan_batches=8):
    """Bulk-mode throughput: ``scan_batches`` x ``process_batch`` per
    dispatch (lax.scan), amortizing the host round-trip over NB*B blocks;
    inputs are device-born. B=240 with P=128 shares one 512-point
    block-axis FFT among ~2x the blocks of B=128 (batch_fft_len is 512 for
    both). The scipy check below guards the batch graph."""
    from bfir_tpu.core import convolver as cv

    co = cv.coeffs_to_spectra(h, spec)
    hs = cv.prepare_batch_coeffs(co, batch_blocks)

    def steps(st, co_, hs_, many):  # many: [NB, B, C, N]
        def body(s, blk):
            return cv.process_batch(s, co_, blk, coeff_batch_fft=hs_)
        return jax.lax.scan(body, st, many)  # outputs materialize [NB,B,C,N]

    f = jax.jit(steps, donate_argnums=0)
    state = cv.init_state(spec, CHANNELS)
    key = jax.random.PRNGKey(2)
    make_pool = jax.jit(lambda k: jax.random.normal(
        k, (scan_batches, batch_blocks, CHANNELS, BLOCK), dtype=jnp.float32))
    pool = [make_pool(k) for k in jax.random.split(key, 2)]
    jax.block_until_ready(pool)
    t0 = time.time()
    state, outs = f(state, co, hs, pool[0])
    float(jnp.sum(outs))
    log(f"batch B={batch_blocks} x NB={scan_batches} compile: {time.time()-t0:.1f}s")

    # correctness vs scipy on a fresh state (the same process_batch the
    # scan dispatches, via the jitted single-call path)
    from scipy import signal

    rng = np.random.default_rng(2)
    g = jax.jit(lambda st, co_, hs_, blk: cv.process_batch(st, co_, blk,
                                                           coeff_batch_fft=hs_))
    st2 = cv.init_state(spec, CHANNELS)
    xs = rng.standard_normal((batch_blocks, CHANNELS, BLOCK)).astype(np.float32)
    _, o = g(st2, co, hs, jnp.asarray(xs))
    y = np.asarray(o).transpose(1, 0, 2).reshape(CHANNELS, -1)
    flat = xs.transpose(1, 0, 2).reshape(CHANNELS, -1)
    ref = signal.fftconvolve(flat.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    s = worst_channel_snr(y, ref)
    log(f"batch worst-channel SNR vs scipy: {s:.1f} dB")
    if s < 80:
        return 0.0, s

    nblocks = scan_batches * batch_blocks
    times = []
    for i in range(n_iters):
        t0 = time.time()
        state, outs = f(state, co, hs, pool[i % 2])
        float(jnp.sum(outs))  # force completion via scalar fetch
        times.append((time.time() - t0) / nblocks)
    per_block = float(np.median(times))
    sps = BLOCK * CHANNELS / per_block
    log(f"batch: {per_block*1e3:.3f} ms/block -> {sps/1e6:.0f} M samples/s")
    return sps, s


def bench_extended(spec, h, jnp, jax, n_iters):
    """Extended-precision (df64 two-float) streaming floor: the engine
    the session runs for float64 configs on f64-less
    backends (kernels/extended.py). Absolute scipy verification (worst
    channel, vs the float64 oracle — this mode's SNR should beat f32's
    ~130 dB), then the differential device floor, same protocol as the
    other streaming paths."""
    from scipy import signal

    from bfir_tpu.kernels import extended as E

    on_cpu = _platform().is_cpu()
    espec = spec if not on_cpu else type(spec)(
        block_length=BLOCK, n_partitions=4, dtype="float32")
    hh = h[:, : espec.max_taps]
    co = E.df_coeffs(hh, espec, CHANNELS)
    step = jax.jit(lambda s, ch, cl, blk: E.step_df(s, ch, cl, blk),
                   donate_argnums=0)
    rng = np.random.default_rng(21)
    st = E.init_df_state(espec, CHANNELS)
    xs = rng.standard_normal((CHANNELS, BLOCK * 3)).astype(np.float32)
    outs = []
    t0 = time.time()
    for b in range(3):
        st, o = step(st, co[0], co[1], jnp.asarray(xs[:, b * BLOCK:(b + 1) * BLOCK]))
        outs.append(np.asarray(o))
    log(f"extended check ran in {time.time()-t0:.1f}s")
    y = np.concatenate(outs, axis=1)
    ref = signal.fftconvolve(xs.astype(np.float64), hh.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    s = worst_channel_snr(y, ref)
    log(f"extended (df64) worst-channel SNR vs scipy: {s:.1f} dB")
    if s < 80:
        return 0.0, float("nan"), s

    k1, k2 = (2, 6) if on_cpu else (16, 80)

    def mk_scan(kk):
        def scan_steps(stt, ch, cl, blocks):
            def body(ss, blk):
                return E.step_df(ss, ch, cl, blk)
            return jax.lax.scan(body, stt, blocks)
        return jax.jit(scan_steps, donate_argnums=0), kk

    floors = {}
    st3 = E.init_df_state(espec, CHANNELS)
    for fsc, kk in (mk_scan(k1), mk_scan(k2)):
        pool = [jax.device_put(rng.standard_normal(
            (kk, CHANNELS, BLOCK)).astype(np.float32)) for _ in range(2)]
        jax.block_until_ready(pool)
        t0 = time.time()
        st3, o = fsc(st3, co[0], co[1], pool[0])
        float(jnp.sum(o))
        log(f"extended-floor compile (K={kk}): {time.time()-t0:.1f}s")
        ts = []
        for i in range(max(3, n_iters // 4)):
            t0 = time.time()
            st3, o = fsc(st3, co[0], co[1], pool[i % 2])
            float(jnp.sum(o))
            ts.append(time.time() - t0)
        floors[kk] = float(np.min(ts))
    floor = max((floors[k2] - floors[k1]) / (k2 - k1), 1e-9)
    sps = BLOCK * CHANNELS / floor
    log(f"extended device floor: {floor*1e3:.3f} ms/block -> "
        f"{sps/1e6:.0f} M samples/s")
    return sps, floor, s


def bench_socket(h, jnp, jax, n_frames=128):
    """Socket-path real-time factor: the TCP audio
    server's data plane measured end to end — PCM frames over a loopback
    socket through the pipelined serve loop (decode -> engine -> encode),
    with the client keeping the server's bounded in-flight queue full. The
    number is the PRODUCT surface's streaming rate: wire framing, format
    conversion and dispatch pipelining included. Correctness of the first
    blocks is asserted against scipy before timing."""
    import json as _json
    import socket
    import struct
    import tempfile
    import threading

    from scipy import signal

    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                    ImpulseFileSpec, StreamSpec)
    from bfir_tpu.io import wavio
    from bfir_tpu.ops import formats as fmops
    from bfir_tpu.core.spec import SampleFormat

    on_cpu = _platform().is_cpu()
    taps = 4096 if on_cpu else h.shape[-1]
    hh = h[:, :taps]
    if on_cpu:
        n_frames = 12
    tmp = tempfile.mkdtemp(prefix="bfir_bench_sock_")
    irpath = os.path.join(tmp, "ir.wav")
    wavio.write(irpath, hh.T.astype(np.float64), 44100, subtype="float64")
    files = (ImpulseFileSpec(enabled=True, filename=irpath),
             ImpulseFileSpec(), ImpulseFileSpec())
    cfg = EngineConfig(
        filter=FilterSpec(block_length=BLOCK, n_partitions=1, dtype="float32"),
        stream=StreamSpec(n_channels=CHANNELS, sample_rate=44100),
        chain=ChainSpec(files=files))
    srv = AudioServer(cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        rng = np.random.default_rng(13)
        frame_blocks = 1 if on_cpu else 8  # 8 engine blocks per wire frame
        x = rng.standard_normal(
            (CHANNELS, n_frames * frame_blocks * BLOCK)).astype(np.float32)
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=600)
        s.sendall((_json.dumps({"channels": CHANNELS, "sample_rate": 44100,
                                "in_format": "float_le",
                                "out_format": "float_le"}) + "\n").encode())
        f = s.makefile("rb")
        hdr = _json.loads(f.readline().decode())
        if not hdr.get("ok"):
            log(f"socket bench: server refused header: {hdr}")
            return 0.0, float("nan")
        replies = []

        def read_replies(count):
            for _ in range(count):
                (n,) = struct.unpack("<I", f.read(4))
                replies.append(f.read(n))

        # warm-up (compile) frame, synchronous
        fsz = frame_blocks * BLOCK
        raw0 = fmops.encode_float(x[:, :fsz], SampleFormat.FLOAT_LE)
        t0 = time.time()
        s.sendall(struct.pack("<I", len(raw0)) + raw0)
        read_replies(1)
        log(f"socket warm-up frame (compile): {time.time()-t0:.1f}s")

        # timed: remaining frames, fully pipelined (reader thread drains)
        rest = n_frames - 1
        rt = threading.Thread(target=read_replies, args=(rest,))
        t0 = time.time()
        rt.start()
        for i in range(1, n_frames):
            raw = fmops.encode_float(x[:, i * fsz:(i + 1) * fsz],
                                     SampleFormat.FLOAT_LE)
            s.sendall(struct.pack("<I", len(raw)) + raw)
        rt.join()
        dt = time.time() - t0
        s.sendall(struct.pack("<I", 0))
        struct.unpack("<I", f.read(4))
        s.close()
        y = fmops.decode(b"".join(replies), SampleFormat.FLOAT_LE, CHANNELS)
        ref = signal.fftconvolve(
            x[:, : y.shape[1] + 4 * BLOCK].astype(np.float64),
            hh.astype(np.float64), axes=1)[:, : y.shape[1]]
        snr = worst_channel_snr(y.astype(np.float64), ref)
        log(f"socket-path worst-channel SNR vs scipy: {snr:.1f} dB")
        if snr < 80:
            return 0.0, snr
        sps = rest * fsz * CHANNELS / dt
        rtf = sps / (44100.0 * CHANNELS)
        log(f"socket path ({frame_blocks}-block frames): "
            f"{dt/rest*1e3:.2f} ms/frame -> {sps/1e6:.1f} M "
            f"samples/s = {rtf:.1f}x real-time through the wire")
        return sps, snr
    finally:
        srv.stop()


def bench_fft(spec, jnp, jax, n_iters):
    """FFT-only microbench (BASELINE.md '>=95% of roofline' target).

    Measures the engine's forward transform (ops.fft.rfft_split) at the
    streaming hot-path shape [C, 2N] and at a bulk shape (fat batch), and
    reports:
    - achieved effective GFLOP/s (standard FFT work, 5*M*log2(M) per row)
    - achieved HBM GB/s (minimal traffic: read input + write split output)
    - roofline fraction: t_roofline / t_measured where t_roofline =
      max(min_bytes / peak_BW, ideal_flops / peak_FLOPs) and both peaks are
      measured on-device, so the fraction is honest for this chip, not a
      datasheet number.

    Every timed quantity runs K iterations inside ONE jitted
    lax.scan/fori_loop dispatch and divides by K, so the host round-trip
    does not swamp microsecond-scale ops. The scan carries a data
    dependency, so iterations cannot overlap or be elided.
    """
    from bfir_tpu.ops import fft as F
    from jax import lax

    c, m = CHANNELS, 2 * BLOCK
    f = BLOCK + 1
    rng = np.random.default_rng(7)
    on_cpu = _platform().is_cpu()
    k1, k2 = (2, 6) if on_cpu else (64, 576)

    def timed_scan(fn, init, label):
        """DEVICE time of one fn application, by differential scan timing:
        dispatch k1-long and k2-long chained scans and divide the wall-time
        difference by (k2-k1). The host round-trip is a per-dispatch
        constant that cancels in the difference — dividing a single
        dispatch's wall time by its length would add round_trip/K to every
        number. min() statistics because host noise is one-sided, and
        (k2-k1) is kept large enough that the device-time delta dwarfs the
        residual jitter (measured: medians over a 64-step delta went
        *negative* for ~30 us ops)."""
        def mk(kk):
            return jax.jit(lambda x0: lax.scan(lambda x, _: (fn(x), None),
                                               x0, None, length=kk)[0])
        g1, g2 = mk(k1), mk(k2)
        y = g2(g1(init))
        jax.block_until_ready(y)

        def best(g):
            nonlocal y
            ts = []
            for _ in range(max(3, n_iters // 6)):
                t0 = time.time()
                y = g(y)
                float(jnp.sum(jax.tree_util.tree_leaves(y)[0].ravel()[:1]))
                ts.append(time.time() - t0)
            return float(np.min(ts))

        t = (best(g2) - best(g1)) / (k2 - k1)
        t = max(t, 1e-9)
        log(f"{label}: {t*1e6:.1f} us/iter (differential {k1}/{k2} scan)")
        return t

    # peak HBM bandwidth. Two folding traps, both hit historically
    # (1) an algebraically collapsible body (`a+1.0`)
    # lets the add chain fold across iterations; (2) even a nonlinear but
    # ELEMENTWISE array->array body (`1-abs(a)`) lets the compiler iterate
    # tiles on chip (load tile -> run all K iterations -> store). The probe
    # reduces the 128 MB array
    # to a SCALAR carry each iteration (`sum(abs(big + s))`): every
    # iteration must re-read the whole array (its input s depends on the
    # previous full reduction; no tile can iterate locally), and the array
    # is larger than an on-chip cache. This measures peak READ bandwidth —
    # the denominator for the engine's read-dominated MAC/transform
    # traffic. The array is device-born.
    big = jax.random.normal(jax.random.PRNGKey(11), (8192, 4096),
                            dtype=jnp.float32)
    t_bw = timed_scan(lambda s: jnp.sum(jnp.abs(big + s)) * 1e-12,
                      jnp.float32(0.1),
                      "peak-BW probe (128 MB full-array scalar reduce)")
    bw_peak = big.size * 4 / t_bw
    log(f"measured peak HBM read BW: {bw_peak/1e9:.0f} GB/s")

    # peak matmul FLOP/s (f32 HIGHEST, like the engine's DFT path); the
    # carry is renormalized each step so values stay finite
    mm_n = 2048
    a = jnp.asarray((rng.standard_normal((mm_n, mm_n)) / np.sqrt(mm_n))
                    .astype(np.float32))

    def mm_step(x):
        y = lax.dot(a, x, precision=lax.Precision.HIGHEST)
        return y / jnp.sqrt(jnp.mean(y * y) + 1e-30)

    t_mm = timed_scan(mm_step, a, "peak-matmul probe (2048^3 f32 HIGHEST)")
    flops_peak = 2 * mm_n**3 / t_mm
    log(f"measured peak f32 matmul: {flops_peak/1e12:.2f} TFLOP/s")

    def fft_frac(rows, label):
        x = jnp.asarray(rng.standard_normal((rows, m)).astype(np.float32))
        # correctness vs numpy before timing
        xr, xi = jax.jit(F.rfft_split)(x)
        ref = np.fft.rfft(np.asarray(x[:8]).astype(np.float64), axis=-1)
        err = max(float(np.max(np.abs(np.asarray(xr[:8]) - ref.real))),
                  float(np.max(np.abs(np.asarray(xi[:8]) - ref.imag))))
        scale = float(np.max(np.abs(ref)))
        log(f"fft[{rows},{m}] max abs err: {err:.3e} (scale {scale:.1f})")
        if err > 1e-2 * scale:
            return None

        def step(xx):
            yr, yi = F.rfft_split(xx)
            # fold the spectrum back into a same-shaped real carry (cheap
            # VPU work) so the scan chains without shape change
            return jnp.concatenate([yr[..., :m // 2], yi[..., :m // 2]],
                                   axis=-1) * 0.01 + xx * 0.5

        t_meas = timed_scan(step, x, f"fft {label}")
        ideal_flops = rows * 5.0 * m * np.log2(m)
        min_bytes = rows * (m * 4 + 2 * f * 4)
        t_roof = max(min_bytes / bw_peak, ideal_flops / flops_peak)
        frac = t_roof / t_meas
        # frac measures against the ideal-FFT roofline. frac_mm is only
        # meaningful on the matmul-DFT path (ops.fft.set_mode("matmul")):
        # whether that path's actual matmul work runs at the measured
        # matmul peak.
        # actual matmul FLOPs (r4f four-step on the real-packed half size;
        # 4 real matmuls per complex product, fft.py)
        h = m // 2
        n1 = h // 4
        mm_flops = rows * (4 * 2 * h * n1      # [.., 4, n1] @ [n1, n1]
                           + 4 * 2 * h)        # radix-4 butterflies ~
        t_roof_mm = max(min_bytes / bw_peak, mm_flops / flops_peak)
        frac_mm = t_roof_mm / t_meas
        gflops = ideal_flops / t_meas / 1e9
        gbps = min_bytes / t_meas / 1e9
        log(f"fft [{rows},{m}] f32: {t_meas*1e6:.1f} us -> {gflops:.0f} "
            f"GFLOP/s (effective), {gbps:.0f} GB/s, ideal-roofline frac "
            f"{frac:.2f}, matmul-work roofline frac {frac_mm:.2f}")
        return {"us": t_meas * 1e6, "gflops": gflops, "gbps": gbps,
                "frac": frac, "frac_mm": frac_mm}

    stream_r = fft_frac(c, "streaming shape")
    bulk_r = fft_frac(2048 if not _platform().is_cpu() else 256,
                      "bulk shape")
    res = {"peak_bw_gbps": bw_peak / 1e9,
           "peak_matmul_tflops": flops_peak / 1e12}
    if stream_r:
        res.update({"fft_us": stream_r["us"], "fft_gflops": stream_r["gflops"],
                    "fft_gbps": stream_r["gbps"],
                    "fft_roofline_frac": stream_r["frac"],
                    "fft_mm_roofline_frac": stream_r["frac_mm"]})
    if bulk_r:
        res.update({"fft_bulk_gflops": bulk_r["gflops"],
                    "fft_bulk_roofline_frac": bulk_r["frac"],
                    "fft_bulk_mm_roofline_frac": bulk_r["frac_mm"]})
    return res


def _setup_jax():
    import os

    import jax

    if os.environ.get("BFIR_BENCH_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")
    from bfir_tpu.utils import platform

    platform.enable_compile_cache()
    return jax


def _run_path(which: str):
    """Run one bench path and print its result as JSON on stdout (invoked as
    a subprocess so one hung path cannot hang the whole bench)."""
    jax = _setup_jax()
    import jax.numpy as jnp

    from bfir_tpu.core.spec import FilterSpec

    backend = _platform().backend()
    on_cpu = _platform().is_cpu()
    spec = FilterSpec(block_length=BLOCK, n_partitions=PARTITIONS, dtype="float32")
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((CHANNELS, spec.max_taps)) *
         np.exp(-np.arange(spec.max_taps) / 20000.0)).astype(np.float32) * 0.05
    if which == "batch":
        sps, s = bench_batch(spec, h, jnp, jax, n_iters=2 if on_cpu else 8,
                             batch_blocks=16 if on_cpu else 240,
                             scan_batches=2 if on_cpu else 8)
        print(json.dumps({"sps": sps, "snr": s, "backend": backend}))
    elif which == "bulk":
        sps, s = bench_bulk(h, jnp, jax, n_iters=2 if on_cpu else 8)
        print(json.dumps({"sps": sps, "snr": s, "backend": backend}))
    elif which == "socket":
        sps, s = bench_socket(h, jnp, jax)
        print(json.dumps({"sps": sps, "snr": s, "backend": backend}))
    elif which == "extended":
        sps, floor, s = bench_extended(spec, h, jnp, jax,
                                       n_iters=4 if on_cpu else 20)
        print(json.dumps({"sps": sps, "floor": floor, "snr": s,
                          "backend": backend}))
    elif which == "phase":
        # per-phase device latency of the nu engines (worst-block evidence
        # for the real-time budget claim); prints its
        # own JSON line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from benchmarks.phase_latency import main as phase_main

        phase_main([] if not on_cpu else ["--cpu"])
    elif which == "fft":
        res = bench_fft(spec, jnp, jax, n_iters=5 if on_cpu else 30)
        res["backend"] = backend
        print(json.dumps(res))
    elif which == "nustream":
        res = bench_streaming_nu(h, jnp, jax, n_iters=5 if on_cpu else 40)
        res["backend"] = backend
        print(json.dumps(res))
    else:
        sps, p50, p99, rt_ms, floor, s = bench_streaming(
            spec, h, jnp, jax, n_iters=5 if on_cpu else 50)
        print(json.dumps({"sps": sps, "p50": p50, "p99": p99, "rt_ms": rt_ms,
                          "floor": floor, "snr": s, "backend": backend}))


def main():
    import subprocess

    def sub(which, timeout):
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--path", which],
                capture_output=True, text=True, timeout=timeout)
            sys.stderr.write(r.stderr)
            for line in r.stdout.splitlines():
                line = line.strip()
                if line.startswith("{"):
                    return json.loads(line)
        except subprocess.TimeoutExpired:
            log(f"{which} bench timed out")
        except Exception as e:
            log(f"{which} bench failed: {type(e).__name__}: {e}")
        return {}

    batch = sub("batch", 900)      # headline path first
    # bulk geometry (M=8192): the render()/render-CLI offline path
    bulk = sub("bulk", 900)
    stream = sub("stream", 1800)
    # two-stage non-uniform streaming
    nustream = sub("nustream", 1800)
    # fft compiles 8 differential-scan graphs
    fft = sub("fft", 1500)
    # per-phase latency (5 differential scans over the nu phase graphs)
    phase = sub("phase", 1500)
    # socket data plane: loopback TCP through the pipelined audio server
    sock = sub("socket", 900)
    # extended (df64) precision floor
    ext = sub("extended", 1200)

    uniform_batch_sps = batch.get("sps", 0.0) or 0.0
    bulk_sps = bulk.get("sps", 0.0) or 0.0
    nu_sps_floor = 0.0
    if nustream.get("floor"):
        nu_sps_floor = BLOCK * CHANNELS / nustream["floor"]
    # the bulk/offline figure of merit: the best whole-file path render()
    # can pick — the batched large-M form, the uniform-N form, or (for
    # long filters, core/bulk.py NU_BULK_MIN_TAPS) the nu macro scan,
    # whose device floor the nustream path measures
    batch_sps = max(uniform_batch_sps, bulk_sps, nu_sps_floor)
    stream_sps = stream.get("sps", 0.0) or 0.0
    p50 = stream.get("p50") or float("nan")
    floor = stream.get("floor") or float("nan")
    nu_floor = nustream.get("floor") or float("nan")
    snrs = [v for v in (batch.get("snr"), bulk.get("snr"), stream.get("snr"),
                        nustream.get("snr")) if v is not None]
    backend = batch.get("backend") or stream.get("backend") or "unknown"

    nu_sps = nustream.get("sps", 0.0) or 0.0
    # the int24-tail tier counts when it keeps >=125 dB (the engine
    # self-check enforces that at open); include it in the headline
    nu_i24_sps = 0.0
    if (nustream.get("int24_floor")
            and (nustream.get("int24_snr") or 0.0) >= 125.0):
        nu_i24_sps = BLOCK * CHANNELS / nustream["int24_floor"]
    # the split-tail schedule (session engine_mode="nonuniform_split" /
    # the bulk renderer's engine), gated at >=125 dB like the int24 tier
    nu_split_sps = 0.0
    if (nustream.get("split_floor")
            and (nustream.get("split_snr") or 0.0) >= 125.0):
        nu_split_sps = BLOCK * CHANNELS / nustream["split_floor"]
    # the G-cycle batched bulk scan (core/nubatch.py), gated >=125 dB like
    # every headline candidate
    nu_gb_sps = 0.0
    if (nustream.get("gbatch_floor")
            and (nustream.get("gbatch_snr") or 0.0) >= 125.0):
        nu_gb_sps = BLOCK * CHANNELS / nustream["gbatch_floor"]
    batch_sps = max(batch_sps, nu_gb_sps)
    value = max(stream_sps, batch_sps, nu_sps, nu_i24_sps, nu_split_sps,
                nu_gb_sps)
    mode = {stream_sps: "streaming", uniform_batch_sps: "batch",
            bulk_sps: "bulk-render", nu_sps: "nonuniform-streaming",
            nu_i24_sps: "nonuniform-streaming-int24",
            nu_split_sps: "nonuniform-split-streaming",
            nu_gb_sps: "nonuniform-gbatch-bulk"}[value]
    realtime = 44100.0 * CHANNELS
    print(json.dumps({
        "metric": "audio samples/sec/chip, 64ch x 131072-tap partitioned conv "
                  f"({mode} mode, float32, {backend}; stream p50 "
                  f"{p50*1e3:.2f} ms/block sync, {floor*1e3:.3f} ms/block "
                  f"device floor; SNR {min(snrs) if snrs else float('nan'):.0f} dB; "
                  f"fft {fft.get('fft_gflops', float('nan')):.0f} GFLOP/s = "
                  f"{fft.get('fft_roofline_frac', float('nan')):.2f} of roofline "
                  f"streaming, {fft.get('fft_bulk_roofline_frac', float('nan')):.2f} bulk)",
        "value": round(value, 1),
        "unit": "samples/s",
        "vs_baseline": round(value / realtime, 2),
        "stream_p50_ms": round(p50 * 1e3, 3) if p50 == p50 else None,
        "stream_p99_ms": (round(stream["p99"] * 1e3, 3)
                          if stream.get("p99") is not None else None),
        "stream_floor_ms": round(floor * 1e3, 4) if floor == floor else None,
        "nu_stream_floor_ms": round(nu_floor * 1e3, 4) if nu_floor == nu_floor else None,
        "nu_shared_floor_ms": (round(nustream["shared_floor"] * 1e3, 4)
                               if nustream.get("shared_floor") else None),
        "nu_shared_sps": (round(BLOCK * CHANNELS / nustream["shared_floor"], 1)
                          if nustream.get("shared_floor") else None),
        "nu_shared_snr_db": (round(nustream["shared_snr"], 1)
                             if nustream.get("shared_snr") is not None else None),
        "nu_stream_sps": round(nustream.get("sps", 0.0) or 0.0, 1),
        "extended_floor_ms": (round(ext["floor"] * 1e3, 4)
                              if ext.get("floor") else None),
        "extended_sps": round(ext.get("sps", 0.0) or 0.0, 1),
        "extended_snr_db": (round(ext["snr"], 1)
                            if ext.get("snr") is not None else None),
        "socket_sps": round(sock.get("sps", 0.0) or 0.0, 1),
        "socket_rt_factor": (round((sock.get("sps") or 0.0)
                                   / (44100.0 * CHANNELS), 2)
                             if sock.get("sps") else None),
        "socket_snr_db": (round(sock["snr"], 1)
                          if sock.get("snr") is not None else None),
        "nu_split_floor_ms": (round(nustream["split_floor"] * 1e3, 4)
                              if nustream.get("split_floor") else None),
        "nu_split_sps": (round(BLOCK * CHANNELS / nustream["split_floor"], 1)
                         if nustream.get("split_floor") else None),
        "nu_split_snr_db": (round(nustream["split_snr"], 1)
                            if nustream.get("split_snr") is not None
                            else None),
        "nu_int24_floor_ms": (round(nustream["int24_floor"] * 1e3, 4)
                              if nustream.get("int24_floor") else None),
        "nu_int24_sps": (round(BLOCK * CHANNELS / nustream["int24_floor"], 1)
                         if nustream.get("int24_floor") else None),
        "nu_int24_snr_db": (round(nustream["int24_snr"], 1)
                            if nustream.get("int24_snr") is not None else None),
        "nu_gbatch_floor_ms": (round(nustream["gbatch_floor"] * 1e3, 4)
                               if nustream.get("gbatch_floor") else None),
        "nu_gbatch_sps": (round(BLOCK * CHANNELS / nustream["gbatch_floor"], 1)
                          if nustream.get("gbatch_floor") else None),
        "nu_gbatch_snr_db": (round(nustream["gbatch_snr"], 1)
                             if nustream.get("gbatch_snr") is not None
                             else None),
        "nu_gbatch_shared_floor_ms": (
            round(nustream["gbatch_shared_floor"] * 1e3, 4)
            if nustream.get("gbatch_shared_floor") else None),
        "nu_gbatch_shared_sps": (
            round(BLOCK * CHANNELS / nustream["gbatch_shared_floor"], 1)
            if nustream.get("gbatch_shared_floor") else None),
        "nu_gbatch_shared_snr_db": (
            round(nustream["gbatch_shared_snr"], 1)
            if nustream.get("gbatch_shared_snr") is not None else None),
        "nu_fire_phase_ms": (round(phase["std"]["fire_ms"], 4)
                             if phase.get("std") else None),
        "nu_split_worst_phase_ms": (round(phase["split"]["worst_ms"], 4)
                                    if phase.get("split") else None),
        "nu_split_worst_over_mean": (round(phase["split"]["worst_over_mean"], 3)
                                     if phase.get("split") else None),
        "nu_snr_db": round(nustream["snr"], 1) if nustream.get("snr") is not None else None,
        "batch_sps": round(batch_sps, 1),
        "batch_uniform_sps": round(uniform_batch_sps, 1),
        "bulk_sps": round(bulk_sps, 1),
        "bulk_snr_db": (round(bulk["snr"], 1)
                        if bulk.get("snr") is not None else None),
        "stream_sps": round(stream_sps, 1),
        "snr_db": round(min(snrs), 1) if snrs else None,
        "fft_roofline_frac": round(fft["fft_roofline_frac"], 3) if "fft_roofline_frac" in fft else None,
        "fft_mm_roofline_frac": round(fft["fft_mm_roofline_frac"], 3) if "fft_mm_roofline_frac" in fft else None,
        "fft_bulk_roofline_frac": round(fft["fft_bulk_roofline_frac"], 3) if "fft_bulk_roofline_frac" in fft else None,
        "fft_bulk_mm_roofline_frac": round(fft["fft_bulk_mm_roofline_frac"], 3) if "fft_bulk_mm_roofline_frac" in fft else None,
        "fft_gflops": round(fft["fft_gflops"], 1) if "fft_gflops" in fft else None,
        "fft_bulk_gflops": round(fft["fft_bulk_gflops"], 1) if "fft_bulk_gflops" in fft else None,
        "fft_gbps": round(fft["fft_gbps"], 1) if "fft_gbps" in fft else None,
        "peak_bw_gbps": round(fft["peak_bw_gbps"], 1) if "peak_bw_gbps" in fft else None,
        "peak_matmul_tflops": round(fft["peak_matmul_tflops"], 2) if "peak_matmul_tflops" in fft else None,
    }))


if __name__ == "__main__":
    if "--path" in sys.argv:
        _run_path(sys.argv[sys.argv.index("--path") + 1])
    else:
        main()
