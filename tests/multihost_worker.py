"""Subprocess worker for tests/test_multihost.py.

Run as ``python multihost_worker.py <port> <process_id> <num_processes>``
with 2 virtual CPU devices per process: initializes ``jax.distributed``
(Gloo CPU collectives), builds a global mesh spanning both processes, and
runs the sharded ppermute step across the process boundary, asserting
equality with a scipy oracle.

Two mesh shapes are exercised so each mesh axis crosses the process
(== DCN) boundary once:
- (c=2, p=2): the channel axis spans processes (the recommended multi-host
  layout, parallel/COMM_MODEL.md — zero steady-state cross-host traffic),
- (c=1, p=4): the partition axis spans processes, so the per-step ppermute
  and psum themselves cross the boundary.

This is the evidence for ``parallel/mesh.py::init_distributed``: the
reference has no distribution at all (SURVEY.md §2).
"""

import os
import sys


def main() -> None:
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from bfir_tpu.parallel.mesh import init_distributed

    init_distributed(coordinator=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bfir_tpu.core import convolver as cv
    from bfir_tpu.core.spec import FilterSpec
    from bfir_tpu.parallel import mesh as M
    from bfir_tpu.parallel.sharded import ShardedEngine

    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == 2 * nproc and n_local == 2, (n_global, n_local)
    print(f"pid={pid} devices global={n_global} local={n_local}", flush=True)

    rng = np.random.default_rng(0)  # same seed on every process
    spec = FilterSpec(block_length=128, n_partitions=8, dtype="float64")
    c, nb = 4, 6
    h = rng.standard_normal((c, spec.max_taps)) * 0.1
    x = rng.standard_normal((c, nb * spec.block_length))

    # oracle without jax: full linear convolution, truncated to stream length
    from scipy import signal

    ref = np.stack([signal.fftconvolve(x[i], h[i])[: x.shape[1]] for i in range(c)])

    for cs, ps in [(2, 2), (1, 4)]:
        mesh = M.make_mesh(channel_shards=cs, partition_shards=ps)
        eng = ShardedEngine(spec, c, mesh)
        # coeff spectra must be born as a *global* array: compute them inside
        # a jit from the (replicated) numpy impulse
        coeffs = jax.jit(
            lambda hh: cv.coeffs_to_spectra(hh, spec),
            out_shardings=eng._coeff_sharding,
        )(h)
        state = eng.init_state()
        replicate = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))
        outs = []
        n = spec.block_length
        for b in range(nb):
            blk_np = x[:, b * n : (b + 1) * n]
            # every process holds the full block; build the global sharded array
            blk = jax.make_array_from_callback(
                blk_np.shape, eng._block_sharding, lambda idx: blk_np[idx])
            state, out = eng.step(state, coeffs, blk)
            outs.append(np.asarray(replicate(out)))
        y = np.concatenate(outs, axis=1)
        err = float(np.max(np.abs(y - ref)))
        assert err < 1e-9, f"mesh {cs}x{ps}: diverged from scipy by {err}"
        print(f"pid={pid} mesh {cs}x{ps} OK maxerr={err:.3e}", flush=True)

        # hc-local composition across the same process boundary (round 3:
        # the pod path runs the single-chip optimized kernels per shard)
        from bfir_tpu.kernels import spectrum_mac as K
        from bfir_tpu.parallel.sharded import _hc_chunk_reorder

        spec32 = FilterSpec(block_length=spec.block_length,
                            n_partitions=spec.n_partitions, dtype="float32")
        h32 = h.astype(np.float32)
        eng_hc = ShardedEngine(spec32, c, mesh, local_impl="hc")

        def build_hc(hh):
            co = K.hc_coeffs(hh, spec32, c)
            p_, c2, hp = co.shape
            return _hc_chunk_reorder(co.reshape(p_, 2, c2 // 2, hp),
                                     mesh.shape["p"])

        coeffs_hc = jax.jit(build_hc,
                            out_shardings=eng_hc._coeff_sharding)(h32)
        st_hc = eng_hc.init_state()
        rep_hc = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))
        outs_hc = []
        for b in range(nb):
            blk_np = x[:, b * n : (b + 1) * n].astype(np.float32)
            blk = jax.make_array_from_callback(
                blk_np.shape, eng_hc._block_sharding, lambda idx: blk_np[idx])
            st_hc, out = eng_hc.step(st_hc, coeffs_hc, blk)
            outs_hc.append(np.asarray(rep_hc(out)))
        y_hc = np.concatenate(outs_hc, axis=1)
        err_hc = float(np.max(np.abs(y_hc - ref))) / max(1.0, np.abs(ref).max())
        assert err_hc < 1e-5, f"mesh {cs}x{ps} hc: rel err {err_hc}"
        print(f"pid={pid} mesh {cs}x{ps} hc OK relerr={err_hc:.3e}", flush=True)

        # sharded NONUNIFORM local across the same process boundary
        # (the product-default local engine had never
        # crossed a process boundary): two-stage geometry, head collectives
        # every block + tail collectives at the M cadence over DCN
        from bfir_tpu.core import nonuniform as NU

        n_ = spec.block_length
        nuspec = NU.NuSpec(block_length=n_, ratio=2, p_head=4,
                           p_tail=ps, dtype="float32")
        taps_nu = nuspec.max_taps
        spec_nu = FilterSpec(block_length=n_, n_partitions=taps_nu // n_,
                             dtype="float32")
        h_nu = (rng.standard_normal((c, taps_nu)) * 0.1).astype(np.float32)
        x_nu = rng.standard_normal(
            (c, (nuspec.delay_blocks + 2) * nuspec.ratio * n_)).astype(np.float32)
        ref_nu = np.stack([signal.fftconvolve(
            x_nu[i].astype(np.float64), h_nu[i].astype(np.float64))
            [: x_nu.shape[1]] for i in range(c)])
        eng_nu = ShardedEngine(spec_nu, c, mesh, local_impl="nonuniform",
                               nuspec=nuspec)

        def build_nu(hh):
            co = NU.nu_coeffs(hh, eng_nu.nuspec, c)

            def _reorder(plane):
                p_, c2, hp = plane.shape
                return _hc_chunk_reorder(plane.reshape(p_, 2, c2 // 2, hp),
                                         mesh.shape["p"])

            return NU.NuCoeffs(head=_reorder(co.head), tail=_reorder(co.tail))

        coeffs_nu = jax.jit(build_nu,
                            out_shardings=eng_nu._coeff_sharding)(h_nu)
        st_nu = eng_nu.init_state()
        rep_nu = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))
        outs_nu = []
        nb_nu = x_nu.shape[1] // n_
        for b in range(nb_nu):
            blk_np = x_nu[:, b * n_ : (b + 1) * n_]
            blk = jax.make_array_from_callback(
                blk_np.shape, eng_nu._block_sharding, lambda idx: blk_np[idx])
            st_nu, out = eng_nu.step(st_nu, coeffs_nu, blk)
            outs_nu.append(np.asarray(rep_nu(out)))
        y_nu = np.concatenate(outs_nu, axis=1)
        err_nu = (float(np.max(np.abs(y_nu - ref_nu)))
                  / max(1.0, float(np.abs(ref_nu).max())))
        assert err_nu < 1e-5, f"mesh {cs}x{ps} nu: rel err {err_nu}"
        print(f"pid={pid} mesh {cs}x{ps} nu OK relerr={err_nu:.3e}", flush=True)

    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
