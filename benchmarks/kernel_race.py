"""Device-time races behind the GPU engine choices (utils/platform.py).

Times, at the flagship geometry (64 ch x 131072 taps, N=1024, R=8):

- the FFT provider: matmul-DFT formulations vs jnp.fft (cuFFT) for the
  forward halfcomplex transform at the head (2N = 2048), tail
  (2M = 16384) and bulk (G*R*C and G*C rows) shapes;
- the overlap-save tail: the dense half-DFT basis vs irfft + slice;
- the spectrum MAC at the head and tail planes, with its achieved
  bytes/s (ring + coefficients read once, output written once): the kept
  form (``kernels.spectrum_mac.mac_hc``, P unrolled ring-slot reads)
  beside a gather of the P slots + a sum over the partition axis;
- the tail store: float32 vs int24 planes through the session's own
  jitted programs (a ``StreamProcessor`` per store, its donated state and
  its coefficients passed as arguments): the per-block step ``process``
  runs, over one M-cycle of R blocks, and the M-cycle-aligned scan
  ``process_buffer`` runs, over 24 M-cycles; rounds alternate the order of
  the stores. Plus whether the compiled int24 tail MAC needs plane-sized
  f32 scratch (its temp bytes beside one f32 plane);
- the bulk correlation MAC: the fused XLA form (core.nubatch._corr_mac)
  vs the Triton kernel (kernels.corr_mac), alone and end to end through
  BulkRenderer, beside the split-tail render schedule.

Device time is the kernel time in a ``jax.profiler`` trace of repeated
calls (the summed durations on the GPU's stream lines, per call). Render
times are host wall clock around ``render`` (input staged, output
fetched).

One JSON object per line on stdout, the card's ``nvidia-smi`` name and
power limit first. Needs an accelerator; refuses the CPU.

    python benchmarks/kernel_race.py [--only NAME ...]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bfir_tpu.utils import platform  # noqa: E402

C, N, TAPS, R, G = 64, 1024, 131072, 8, 8


def emit(**kw):
    print(json.dumps(kw), flush=True)


def trace_time(fn, args, n=20):
    """Device kernel time of one ``jit(fn)(*args)`` (see ``trace_run``)."""
    import jax

    f = jax.jit(fn)
    jax.block_until_ready(f(*args))
    return trace_run(lambda: f(*args), n)


def trace_run(run, n=20):
    """Device kernel time of one ``run()`` from a ``jax.profiler`` trace of
    ``n`` calls: the summed durations of the events on the GPU's stream
    lines, over n. ``run`` returns the arrays to wait for. Returns
    (seconds, {kernel name: seconds}) for the three longest kernels."""
    import glob
    import tempfile

    import jax

    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(n):
            out = run()
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        pd = jax.profiler.ProfileData.from_file(
            glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0])
        total = 0
        per = {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    total += ev.duration_ns
                    per[ev.name] = per.get(ev.name, 0) + ev.duration_ns
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:3])
    return total / n * 1e-9, {k[:60]: v / n * 1e-9 for k, v in top.items()}


def race_fft():
    import jax.numpy as jnp

    from bfir_tpu.ops import fft as F

    rng = np.random.default_rng(0)
    for label, rows, n in (("head", C, 2 * N), ("tail", C, 2 * R * N),
                           ("bulk head", G * R * C, 2 * N),
                           ("bulk tail", G * C, 2 * R * N)):
        x = jnp.asarray(rng.standard_normal((rows, n)).astype(np.float32))
        res = {}
        for mode in ("xla", "matmul"):
            F.set_mode(mode)
            try:
                # a fresh function per mode: jit caches by function
                res[mode] = trace_time(lambda a: F.rfft_split_hc(a), (x,))[0]
            finally:
                F.set_mode("auto")
        emit(race="rfft_split_hc", shape=[rows, n],
             label=label, cufft_us=res["xla"] * 1e6,
             matmul_us=res["matmul"] * 1e6)
        hr = jnp.asarray(rng.standard_normal((rows, n // 2)).astype(np.float32))
        hi = jnp.asarray(rng.standard_normal((rows, n // 2)).astype(np.float32))
        res = {}
        for mode in ("xla", "matmul"):
            if mode == "matmul" and n > 4096:
                continue  # a dense [h, h] basis at h = 8192 is 256 MB
            F.set_mode(mode)
            try:
                res[mode] = trace_time(
                    lambda a, b: F.irfft_hc_tail(a, b, n=n), (hr, hi))[0]
            finally:
                F.set_mode("auto")
        emit(race="irfft_hc_tail", shape=[rows, n], label=label,
             irfft_slice_us=res["xla"] * 1e6,
             dense_half_dft_us=(res["matmul"] * 1e6 if "matmul" in res
                                else None))


def _mac_gather_sum(ring, co, pos):
    """The halfcomplex MAC as one gather of the P ring slots and a sum over
    the partition axis (the form ``mac_hc`` replaced)."""
    import jax.numpy as jnp

    p, c2, hp = ring.shape
    c = c2 // 2
    w = jnp.take(ring, jnp.mod(pos - jnp.arange(p), p), axis=0)
    wr, wi, cr, ci = w[:, :c], w[:, c:], co[:, :c], co[:, c:]
    first = jnp.arange(hp) == 0
    a = jnp.where(first, ci, cr)
    b = jnp.where(first, 0.0, ci)
    return (cr * wr - b * wi).sum(0), (a * wi + b * wr).sum(0)


def race_mac():
    import jax.numpy as jnp

    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(1)
    for label, p, hp in (("head", 16, N), ("tail", 14, R * N)):
        ring = jnp.asarray(rng.standard_normal((p, 2 * C, hp)).astype(np.float32))
        co = jnp.asarray(rng.standard_normal((p, 2 * C, hp)).astype(np.float32))
        nbytes = (2 * p * 2 * C * hp + 2 * C * hp) * 4
        ref = K.mac_hc(ring, co, jnp.int32(3))
        for form, fn in (("mac_hc", lambda r, g, q: K.mac_hc(r, g, q)),
                         ("gather + sum", _mac_gather_sum)):
            out = fn(ring, co, jnp.int32(3))
            err = max(float(jnp.max(jnp.abs(o - r)) / jnp.max(jnp.abs(r)))
                      for o, r in zip(out, ref))
            t, top = trace_time(fn, (ring, co, jnp.int32(3)))
            emit(race="mac_hc", form=form, label=label, planes=[p, 2 * C, hp],
                 us=t * 1e6, bytes=nbytes,
                 gbps=nbytes / max(t, 1e-12) / 1e9,
                 share_of_3350_gbps=nbytes / max(t, 1e-12) / 3.35e12,
                 max_rel_err=err, kernels=top)


def race_tail_store():
    import tempfile

    import jax
    import jax.numpy as jnp

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                    ImpulseFileSpec, StreamSpec)
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor
    from bfir_tpu.io import wavio
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(2)
    h = (rng.standard_normal((C, TAPS)) * np.exp(-np.arange(TAPS) / 20000.0)
         * 0.05).astype(np.float32)
    x = rng.standard_normal((C, R * N)).astype(np.float32)
    one_cycle = jnp.asarray(x.reshape(C, R, N).transpose(1, 0, 2))
    scan_blocks = jnp.asarray(np.tile(x, 24).reshape(C, 24 * R, N)
                              .transpose(1, 0, 2))
    with tempfile.TemporaryDirectory() as tmp:
        ir = os.path.join(tmp, "ir.wav")
        wavio.write(ir, h.T, 44100, subtype="float32")
        sessions = {}
        for store in ("float32", "int24"):
            cfg = EngineConfig(
                filter=FilterSpec(block_length=N, n_partitions=1,
                                  dtype="float32"),
                stream=StreamSpec(n_channels=C, sample_rate=44100),
                chain=ChainSpec(files=(ImpulseFileSpec(enabled=True,
                                                       filename=ir),
                                       ImpulseFileSpec(), ImpulseFileSpec())),
                engine_mode="nonuniform", nu_tail_store=store)
            sp = StreamProcessor(cfg, ArtifactCache(os.path.join(tmp, store)))
            sp.process(x)  # builds the engine, compiles the per-block step
            sp.process_buffer(x)  # compiles the aligned scan
            if sp._impl != "nonuniform" or sp._nuspec.tail_store != store:
                raise RuntimeError(f"{store}: session built {sp._impl}")
            sessions[store] = sp

    def per_block(sp):
        def run():
            for b in range(R):
                sp._state, out = sp._step_packed(sp._state, sp._coeffs,
                                                 one_cycle[b])
            return out
        return run

    def scan(sp):
        def run():
            sp._state, out = sp._scan_nu_fast(sp._state, sp._coeffs,
                                              scan_blocks)
            return out
        return run

    for rep_i in range(3):  # three rounds, alternating order: the spread
        order = ("float32", "int24") if rep_i % 2 == 0 else ("int24", "float32")
        for store in order:
            sp = sessions[store]
            for program, mk, cycles in (("step", per_block, 1),
                                        ("scan", scan, 24)):
                run = mk(sp)
                jax.block_until_ready(run())
                t, top = trace_run(run)
                emit(race="tail_store", round=rep_i, store=store,
                     program=program, us_per_mcycle=t * 1e6 / cycles,
                     us_per_block=t * 1e6 / (cycles * R), kernels=top)
    # does XLA materialize f32 planes for the int24 MAC?
    spec = NU.nu_geometry(TAPS, N, ratio=R, tail_store="int24")
    co = NU.nu_coeffs(h, spec, C)
    st = NU.init_nu_state(spec, C)
    comp = jax.jit(lambda r, c: K.mac_hc(r, c, jnp.int32(3))).lower(
        st.tail.ring, co.tail).compile()
    mem = comp.memory_analysis()
    plane_bytes = spec.p_tail * 2 * C * R * N * 4
    emit(race="int24_hlo", temp_bytes=getattr(mem, "temp_size_in_bytes", None),
         f32_plane_bytes=plane_bytes,
         fusions=comp.as_text().count(" fusion("))


def race_corr_mac_and_render():
    import jax.numpy as jnp

    from bfir_tpu.core import bulk as BK
    from bfir_tpu.core import nubatch as NB
    from bfir_tpu.kernels.corr_mac import corr_mac_triton

    rng = np.random.default_rng(3)
    for label, p, hp, nb in (("head", 16, N, G * R), ("tail", 14, R * N, G)):
        hist = jnp.asarray(rng.standard_normal((p - 1 + nb, 2 * C, hp))
                           .astype(np.float32))
        co = jnp.asarray(rng.standard_normal((p, 2 * C, hp)).astype(np.float32))
        nbytes = (hist.size + co.size + 2 * nb * C * hp) * 4
        ref = NB._corr_mac(hist, co, nb)
        variants = [("xla", NB._corr_mac)] + [
            (f"triton b{bb} f{bf} w{w}", functools.partial(
                corr_mac_triton, block_b=bb, block_f=bf, num_warps=w))
            for bb, bf, w in ((8, 512, 4), (4, 512, 4), (16, 512, 4))]
        for route, fn in variants:
            try:
                out = fn(hist, co, nb)
                err = max(float(jnp.max(jnp.abs(o - r)) / jnp.max(jnp.abs(r)))
                          for o, r in zip(out, ref))
                t, top = trace_time(lambda a, b: fn(a, b, nb), (hist, co))
                emit(race="corr_mac", route=route, label=label, us=t * 1e6,
                     max_rel_err_vs_xla=err, min_bytes=nbytes,
                     gbps_at_min_bytes=nbytes / max(t, 1e-12) / 1e9, kernels=top)
            except Exception as e:  # a kernel the compiler refuses
                emit(race="corr_mac", route=route, label=label,
                     error=f"{type(e).__name__}: {e}"[:2000])
    h = (rng.standard_normal((C, TAPS)) * np.exp(-np.arange(TAPS) / 20000.0)
         * 0.05).astype(np.float32)
    x = rng.standard_normal((C, 10 * 44100)).astype(np.float32)
    routes = {"gbatch": ("xla", "triton"), "split": ("xla",)}
    y0 = None
    for eng, rts in routes.items():
        for route in rts:
            # the route is the platform module's answer; pin it for the race
            platform.corr_mac_route = lambda r=route: r
            try:
                br = BK.BulkRenderer(h, C, nu_engine=eng)
                y = br.render(x)  # compile
                y0 = y if y0 is None else y0
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    br.render(x)
                    ts.append(time.perf_counter() - t0)
                t = float(np.median(ts))
                snr = 10 * np.log10(float((y0.astype(np.float64) ** 2).sum())
                                    / max(float(((y - y0).astype(np.float64)
                                                 ** 2).sum()), 1e-300))
                emit(race="bulk_render", engine=eng, corr_mac=route,
                     seconds_of_audio=10.0, wall_s=t,
                     msamples_per_s=C * x.shape[1] / t / 1e6,
                     snr_vs_first_db=snr)
            except Exception as e:
                emit(race="bulk_render", engine=eng, corr_mac=route,
                     error=f"{type(e).__name__}: {e}"[:2000])


RACES = {"fft": race_fft, "mac": race_mac, "tail_store": race_tail_store,
         "corr": race_corr_mac_and_render}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(RACES))
    args = ap.parse_args(argv)
    import jax

    if platform.is_cpu():
        print("kernel_race needs an accelerator", file=sys.stderr)
        return 2
    platform.enable_compile_cache()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = "unknown"
    emit(card=card, device=jax.devices()[0].device_kind)
    for name in args.only or list(RACES):
        t0 = time.perf_counter()
        try:
            RACES[name]()
        except Exception as e:  # report and go on to the next race
            emit(race=name, error=f"{type(e).__name__}: {e}")
        print(f"{name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
