"""Measure the G-cycle batched bulk scan (core.nubatch) at the flagship
geometry: absolute scipy verification first (backend-miscompile defense),
then differential device floors for G in {2, 4, 8}, against the
per-cycle macro scan measured the same way."""

import sys
import time

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--cpu" in argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    from scipy import signal

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.core import nubatch as NB
    from bfir_tpu.utils import platform

    on_cpu = platform.is_cpu()
    C, BLOCK, P = 64, 1024, 128
    if on_cpu:
        spec = NU.NuSpec(block_length=BLOCK, ratio=2, p_head=4, p_tail=2)
    else:
        spec = NU.nu_geometry(P * BLOCK, BLOCK, ratio=8)
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((C, spec.max_taps)) *
         np.exp(-np.arange(spec.max_taps) / 20000.0)).astype(np.float32) * 0.05
    co = NU.nu_coeffs(h, spec, C)
    R = spec.ratio

    def snr(y, ref):
        vals = []
        for c in range(y.shape[0]):
            n = np.sum((y[c] - ref[c]) ** 2)
            vals.append(10 * np.log10(np.sum(ref[c] ** 2) / max(n, 1e-300)))
        return min(vals)

    def scan_for(g):
        if g == 0:
            def f(st, blocks):
                return NU.process_blocks_nu_fast(st, co, blocks)
        else:
            def f(st, blocks):
                return NB.process_blocks_nu_gbatch(
                    st, co, blocks, cycles_per_step=g)
        return jax.jit(f, donate_argnums=0)

    gs = [2, 4] if on_cpu else [2, 4, 8]
    for a in argv:
        if a.startswith("--gs="):
            gs = [int(v) for v in a[5:].split(",")]
    shared = "--shared" in argv
    if shared:
        co = NU.nu_coeffs(h[:1], spec, C, shared=True)
        h = np.broadcast_to(h[:1], h.shape)
    # absolute check at bench scale for each G
    ncheck = max(16, 2 * max(gs)) * R
    xs = rng.standard_normal((C, ncheck * BLOCK)).astype(np.float32)
    blocks = jnp.asarray(xs.reshape(C, ncheck, BLOCK).transpose(1, 0, 2))
    ref = None
    for g in gs:
        st = NU.init_nu_state(spec, C)
        t0 = time.time()
        _, out = scan_for(g)(st, blocks)
        y = np.asarray(out).transpose(1, 0, 2).reshape(C, -1)
        if ref is None:
            ref = signal.fftconvolve(xs.astype(np.float64),
                                     h.astype(np.float64),
                                     axes=1)[:, : y.shape[1]]
        print(f"G={g}: check ran in {time.time()-t0:.1f}s, "
              f"worst-channel SNR {snr(y, ref):.1f} dB")

    # differential floors
    def floor_for(g, k1_cycles=2, k2_cycles=18):
        gg = max(g, 1)
        k1 = (k1_cycles * R // (gg * R) or 1) * gg * R
        k2 = (k2_cycles * R // (gg * R)) * gg * R
        if g >= 8 and not on_cpu:
            k1, k2 = gg * R, 3 * gg * R
        f = scan_for(g)
        st = NU.init_nu_state(spec, C)
        pools = {}
        for kk in (k1, k2):
            pools[kk] = [jax.device_put(rng.standard_normal(
                (kk, C, BLOCK)).astype(np.float32)) for _ in range(2)]
            jax.block_until_ready(pools[kk])
            t0 = time.time()
            st, o = f(st, pools[kk][0])
            float(jnp.sum(o))
            print(f"  G={g} compile K={kk}: {time.time()-t0:.1f}s")
        fl = {k1: [], k2: []}
        for _ in range(2):
            for kk in (k1, k2):
                for i in range(6 if not on_cpu else 2):
                    t0 = time.time()
                    st, o = f(st, pools[kk][i % 2])
                    float(jnp.sum(o))
                    fl[kk].append(time.time() - t0)
        fmin = max((min(fl[k2]) - min(fl[k1])) / (k2 - k1), 1e-9)
        print(f"G={g}: floor {fmin*1e3:.4f} ms/block -> "
              f"{BLOCK*C/fmin/1e6:.0f} M samples/s "
              f"(differential {k1}/{k2})")
        return fmin

    floor_for(0)  # per-cycle macro baseline, same protocol
    for g in gs:
        floor_for(g)


if __name__ == "__main__":
    main()
