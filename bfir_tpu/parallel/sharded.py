"""Sharded engine execution over a device mesh.

The product path is an explicit ``shard_map`` ring schedule
(``make_ppermute_step``): channels sharded over mesh axis "c", the ring of
delayed input spectra and the coefficient partitions over "p". Per step,
each device rotates its oldest ring slot to its "p"-neighbor (one
``collective-permute`` of a [C_local, F] spectrum),
MACs its local partitions, and ``psum``s partials over "p" (one
all-reduce). That is the *entire* per-step communication; the compiled HLO
is asserted in ``tests/test_parallel.py::test_hlo_collectives`` to contain
exactly these collectives and **no all-gather**.

A GSPMD alternative (jit-compiling ``core.convolver.step_rolled`` under
NamedShardings, ``schedule="gspmd"``) is kept as a numerical cross-check;
measured at the compiler level it inserts extra all-gathers around the ring
insert, so it is NOT the flagship path. See ``parallel/COMM_MODEL.md`` for
the bytes-per-step communication model backing the scaling target.

This is the "channels+partitions sharded, spectra exchanged by device
collectives, partials psum'd" design. On a host whose GPUs are joined all
to all by NVLink every device reaches every other at the same rate, so the
ring over "p" follows the algorithm and not a physical topology. The
reference has no counterpart (single-threaded C++, SURVEY.md §2).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.parallel import mesh as M
from bfir_tpu.utils import platform


def _ring_body(mesh: Mesh, block_length: int):
    """The shared per-shard ring schedule: rotate the oldest ring slot to
    the next "p" device, insert the fresh spectrum on device 0, and return
    (new_ring, input spectrum x). Factored out so the plain step and the
    crossfade step use the identical communication schedule."""
    np_shards = mesh.shape["p"]

    def advance(ring_local, prev_local, block_local):
        frame = jnp.concatenate([prev_local, block_local], axis=-1)
        from bfir_tpu.ops import fft as F

        x = F.rfft(frame, axis=-1)  # [C_local, F], identical on every p shard
        oldest = ring_local[-1]
        if np_shards > 1:
            recv = jax.lax.ppermute(
                oldest, "p", [(i, (i + 1) % np_shards) for i in range(np_shards)]
            )
        else:
            recv = oldest
        p_idx = jax.lax.axis_index("p")
        newest = jnp.where(p_idx == 0, x, recv)
        ring_local = jnp.concatenate([newest[None], ring_local[:-1]], axis=0)
        return ring_local

    return advance


def make_ppermute_step(mesh: Mesh, spec: FilterSpec, n_channels: int):
    """Explicit ring-pipeline step via shard_map (SURVEY.md §2: "rotate
    spectrum ring slices while accumulating partial sums").

    State layout equals the *rolled* representation sharded over ("p","c"):
    globally, ring[i] holds the spectrum delayed by i blocks, so the shard
    on partition-device p covers delays [p*K, (p+1)*K). Per step:

    - every device computes the new input spectrum locally (cheap, avoids a
      broadcast),
    - each device ppermutes its *oldest* slot to the next device — the only
      inter-device data motion, one [C_local, F] spectrum to the next "p"
      device,
    - shifts its local ring by one, inserting the received spectrum (device
      0 inserts the fresh one),
    - MACs its local partitions and psums partials over "p".

    Numerically identical to ``core.convolver.step_rolled``; unlike the
    GSPMD-compiled version, the communication schedule is explicit and
    one ring permute plus one all-reduce (verified at the HLO level in
    tests/test_parallel.py::test_hlo_collectives).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.ops import fft as F

    n = spec.block_length
    advance = _ring_body(mesh, n)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("p", "c", None), P("c", None), P(), P("p", "c", None), P("c", None)),
        out_specs=(P("p", "c", None), P("c", None), P(), P("c", None)),
    )
    def body(ring_local, prev_local, counter, coeffs_local, block_local):
        block_local = block_local.astype(prev_local.dtype)
        ring_local = advance(ring_local, prev_local, block_local)
        y = jax.lax.psum(jnp.sum(coeffs_local * ring_local, axis=0), "p")
        out = F.irfft(y, axis=-1)[..., n:]
        return ring_local, block_local, counter + 1, out

    def step(state: cv.ConvolverState, coeffs, block):
        ring, prev, counter, out = body(
            state.spectra_ring, state.prev_block, state.blockcounter, coeffs, block
        )
        return cv.ConvolverState(ring, prev, counter), out

    return step


def make_ppermute_crossfade_step(mesh: Mesh, spec: FilterSpec, n_channels: int):
    """Crossfade variant of the ppermute step: one ring advance, two MACs
    (old and new coefficient sets), linear ramp between the two outputs —
    the sharded form of ``core.convolver.step_crossfade``
    (``convolver_crossfade_inplace``, fftw_convolver.cpp:275-321). Costs one
    extra psum+irfft; the ring schedule (one ppermute) is unchanged."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.ops import fft as F

    n = spec.block_length
    advance = _ring_body(mesh, n)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("p", "c", None), P("c", None), P(),
                  P("p", "c", None), P("p", "c", None), P("c", None)),
        out_specs=(P("p", "c", None), P("c", None), P(), P("c", None)),
    )
    def body(ring_local, prev_local, counter, co_old, co_new, block_local):
        block_local = block_local.astype(prev_local.dtype)
        ring_local = advance(ring_local, prev_local, block_local)
        y_old = jax.lax.psum(jnp.sum(co_old * ring_local, axis=0), "p")
        y_new = jax.lax.psum(jnp.sum(co_new * ring_local, axis=0), "p")
        out_old = F.irfft(y_old, axis=-1)[..., n:]
        out_new = F.irfft(y_new, axis=-1)[..., n:]
        ramp = jnp.arange(n, dtype=out_old.dtype) / (n - 1)
        out = out_old * (1.0 - ramp) + out_new * ramp
        return ring_local, block_local, counter + 1, out

    def step(state: cv.ConvolverState, coeff_old, coeff_new, block):
        ring, prev, counter, out = body(
            state.spectra_ring, state.prev_block, state.blockcounter,
            coeff_old, coeff_new, block,
        )
        return cv.ConvolverState(ring, prev, counter), out

    return step


def _hc_chunk_reorder(coeff, p_shards: int):
    """Reorder each p-shard's coefficient chunk so the single-chip Pallas
    MAC (``kernels.spectrum_mac.mac_hc``, which walks ring slots as
    ``(pos - i) % P``) computes the ROLLED-layout sum ``sum_j coeff[j] *
    ring[j]`` when called with ``pos = 0``: MAC index i reads local ring
    slot ``(P_l - i) % P_l``, so local coeff index i must hold partition
    ``(P_l - i) % P_l`` — i.e. ``[c0, c_{P_l-1}, ..., c1]`` per chunk. A
    one-time build-step permutation; zero runtime cost."""
    p = coeff.shape[0]
    pl_ = p // p_shards
    ch = coeff.reshape(p_shards, pl_, *coeff.shape[1:])
    ch = jnp.concatenate([ch[:, :1], ch[:, 1:][:, ::-1]], axis=1)
    return ch.reshape(p, *coeff.shape[1:])


def make_ppermute_step_hc(mesh: Mesh, spec: FilterSpec, n_channels: int,
                          crossfade: bool = False, shared: bool = False):
    """The ppermute ring schedule with the OPTIMIZED single-chip hc engine
    as the shard-local compute (pod-scale and
    single-chip run the same MAC).

    Identical communication to ``make_ppermute_step`` — one nearest-neighbor
    ``collective-permute`` of the oldest ring slot + one ``psum`` over "p"
    per block (HLO-asserted in tests/test_parallel.py) — but the state is
    the packed halfcomplex representation: ring [P, 2, C, Hp] (re/im planes,
    lane 0 = (DC.re, Nyquist.re), Hp = 128-lane-aligned n_fft/2; 11% less
    MAC traffic than full-width spectra), the shard-local MAC is the exact
    ``mac_hc`` of the single-chip path (coefficients
    pre-reordered per chunk, see ``_hc_chunk_reorder``), and the
    overlap-save tail is the single-matmul half-DFT basis
    (``ops.fft.irfft_hc_tail``)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.kernels import spectrum_mac as K
    from bfir_tpu.ops import fft as F

    n = spec.block_length
    np_shards = mesh.shape["p"]
    from jax.sharding import PartitionSpec as _P

    # shared coefficient planes ([P, 2, 1, Hp]) carry no channel axis:
    # replicated over "c", still sharded over "p"
    Pco = (_P("p", None, None, None) if shared
           else _P("p", None, "c", None))

    def local_mac(ring_l, coeff_l):
        pl_, two, c_l, hp = ring_l.shape
        cs = coeff_l.shape[2]  # 1 when the filter is SHARED across channels
        ring2 = ring_l.reshape(pl_, 2 * c_l, hp)
        coeff2 = coeff_l.reshape(pl_, 2 * cs, hp)
        return K.mac_hc(ring2, coeff2, jnp.zeros((), jnp.int32))

    def advance(ring_l, prev_l, block_l):
        hp = ring_l.shape[-1]
        frame = jnp.concatenate([prev_l, block_l], axis=-1)
        hr, hi = F.rfft_split_hc(frame)
        pad = hp - hr.shape[-1]
        x = jnp.stack([jnp.pad(hr, ((0, 0), (0, pad))),
                       jnp.pad(hi, ((0, 0), (0, pad)))], axis=0)  # [2, C_l, Hp]
        oldest = ring_l[-1]
        if np_shards > 1:
            recv = jax.lax.ppermute(
                oldest, "p", [(i, (i + 1) % np_shards) for i in range(np_shards)])
        else:
            recv = oldest
        p_idx = jax.lax.axis_index("p")
        newest = jnp.where(p_idx == 0, x.astype(ring_l.dtype), recv)
        return jnp.concatenate([newest[None], ring_l[:-1]], axis=0)

    if not crossfade:
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P("p", None, "c", None), P("c", None), P(),
                      Pco, P("c", None)),
            out_specs=(P("p", None, "c", None), P("c", None), P(), P("c", None)),
            check_vma=False,
        )
        def body(ring_l, prev_l, counter, coeff_l, block_l):
            block_l = block_l.astype(prev_l.dtype)
            ring_l = advance(ring_l, prev_l, block_l)
            yr, yi = local_mac(ring_l, coeff_l)
            # one stacked psum -> exactly one all-reduce in the HLO (a
            # tuple psum lowers to one all-reduce per leaf)
            y = jax.lax.psum(jnp.stack([yr, yi]), "p")
            out = F.irfft_hc_tail(y[0], y[1], n=2 * n)
            return ring_l, block_l, counter + 1, out

        def step(state: cv.ConvolverState, coeffs, block):
            ring, prev, counter, out = body(
                state.spectra_ring, state.prev_block, state.blockcounter,
                coeffs, block)
            return cv.ConvolverState(ring, prev, counter), out

        return step

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("p", None, "c", None), P("c", None), P(),
                  Pco, Pco,
                  P("c", None)),
        out_specs=(P("p", None, "c", None), P("c", None), P(), P("c", None)),
        check_vma=False,
    )
    def body_xf(ring_l, prev_l, counter, co_old, co_new, block_l):
        block_l = block_l.astype(prev_l.dtype)
        ring_l = advance(ring_l, prev_l, block_l)
        yro, yio = local_mac(ring_l, co_old)
        yrn, yin = local_mac(ring_l, co_new)
        y = jax.lax.psum(jnp.stack([yro, yio, yrn, yin]), "p")
        out_old = F.irfft_hc_tail(y[0], y[1], n=2 * n)
        out_new = F.irfft_hc_tail(y[2], y[3], n=2 * n)
        ramp = jnp.arange(n, dtype=out_old.dtype) / (n - 1)
        out = out_old * (1.0 - ramp) + out_new * ramp
        return ring_l, block_l, counter + 1, out

    def step_xf(state: cv.ConvolverState, coeff_old, coeff_new, block):
        ring, prev, counter, out = body_xf(
            state.spectra_ring, state.prev_block, state.blockcounter,
            coeff_old, coeff_new, block)
        return cv.ConvolverState(ring, prev, counter), out

    return step_xf


# ---------------------------------------------------------------------------
# Sharded NON-UNIFORM engine: the two-stage Gardner
# schedule — the single-chip long-filter engine (core/nonuniform.py) — run
# over the same ("c", "p") mesh and the same ring-rotate schedule as the hc
# path. Structure:
#
# - HEAD stage: p_head partitions at N, rolled ring [p_head, 2, C, Hp_h]
#   sharded over ("p", -, "c", -). Per block: one nearest-neighbor
#   ``collective-permute`` of the oldest head slot + one ``psum`` of the
#   stacked halfcomplex partials — byte-for-byte the hc engine's schedule,
#   just on the small head ring.
# - TAIL stage: p_tail partitions at M = R*N, same rolled layout over the
#   same axes, but its ring advance + MAC + psum run once every R blocks
#   under ``lax.cond`` (phase R-1) — the M-block cadence of
#   core.nonuniform.step_nu. Collectives inside the cond are safe: the
#   predicate derives from the replicated blockcounter, so every device
#   takes the same branch (tests/test_parallel.py asserts the lowered HLO).
# - inbuf/pending queues are channel-sharded, partition-replicated; the
#   scheduling invariant (pending[0] slice r consumed at phase r) is
#   untouched.
#
# Amortized per-N-block communication: the head pair every block plus the
# tail pair every R blocks — (1 + 1/R) collective-permutes + all-reduces,
# vs the uniform engine's 1 + 1 on a ring R2x the size. The partition MAC
# being sharded is the reference's own hot loop
# (/root/reference/brutefir/brutefir.cpp:279-300).
# ---------------------------------------------------------------------------


def _nu_pad_tail(nuspec, p_shards: int):
    """Pad p_tail up to a multiple of the mesh "p" axis (the extra
    partitions carry zero coefficients — exact output, storage only)."""
    from bfir_tpu.core import nonuniform as NU

    pt = -(-nuspec.p_tail // p_shards) * p_shards
    if pt == nuspec.p_tail:
        return nuspec
    return NU.NuSpec(nuspec.block_length, nuspec.ratio, nuspec.p_head, pt,
                     nuspec.dtype, nuspec.tail_store, nuspec.head_store)


def _make_nu_shard_parts(mesh: Mesh, nuspec, n_channels: int):
    """Shared shard-local building blocks for every sharded-nu step form."""
    from bfir_tpu.kernels import spectrum_mac as K
    from bfir_tpu.ops import fft as F

    np_shards = mesh.shape["p"]

    def advance(ring_l, prev_l, block_l):
        """Rolled ring advance: rfft the overlap-save frame locally, rotate
        the oldest slot to the next "p" device, insert fresh on device 0.
        Identical schedule to make_ppermute_step_hc.advance."""
        hp = ring_l.shape[-1]
        frame = jnp.concatenate([prev_l, block_l], axis=-1)
        hr, hi = F.rfft_split_hc(frame)
        pad = hp - hr.shape[-1]
        x = jnp.stack([jnp.pad(hr, ((0, 0), (0, pad))),
                       jnp.pad(hi, ((0, 0), (0, pad)))], axis=0)
        oldest = ring_l[-1]
        if np_shards > 1:
            recv = jax.lax.ppermute(
                oldest, "p", [(i, (i + 1) % np_shards) for i in range(np_shards)])
        else:
            recv = oldest
        p_idx = jax.lax.axis_index("p")
        newest = jnp.where(p_idx == 0, x.astype(ring_l.dtype), recv)
        return jnp.concatenate([newest[None], ring_l[:-1]], axis=0)

    def local_mac(ring_l, coeff_l, tiled: bool):
        """Shard-local rolled MAC (chunk-reordered coeffs, pos=0): the exact
        single-chip MAC (``mac_hc``) for both stages.
        bf16-stored tail planes accumulate in f32, as single-chip. SHARED
        coefficient planes ([P, 2, 1, Hp]) broadcast across channels
        in the MAC, exactly as single-chip."""
        pl_, two, c_l, hp = ring_l.shape
        cs = coeff_l.shape[2]
        ring2 = ring_l.reshape(pl_, 2 * c_l, hp)
        coeff2 = coeff_l.reshape(pl_, 2 * cs, hp)
        return K.mac_hc(ring2, coeff2, jnp.zeros((), jnp.int32))

    def head_block(ring_l, prev_l, block_l, coeff_l):
        """Head stage: advance + MAC + one stacked psum + direct tail
        render. Returns (new ring, y_head [C_l, N])."""
        n = nuspec.block_length
        ring_l = advance(ring_l, prev_l, block_l)
        yr, yi = local_mac(ring_l, coeff_l, tiled=False)
        y = jax.lax.psum(jnp.stack([yr, yi]), "p")
        return ring_l, F.irfft_hc_tail(y[0], y[1], n=2 * n)

    def tail_fire(ring_l, prev_l, mblock_l, coeff_l):
        """Tail stage fire: advance + tiled MAC + one stacked psum + the
        tail inverse (the same shard-local compute as single-chip,
        core.nonuniform._tail_inverse).
        Returns (new ring, z [C_l, M])."""
        from bfir_tpu.core.nonuniform import _tail_inverse

        m = nuspec.m
        ring_l = advance(ring_l, prev_l, mblock_l)
        zr, zi = local_mac(ring_l, coeff_l, tiled=True)
        z = jax.lax.psum(jnp.stack([zr, zi]), "p")
        return ring_l, _tail_inverse(z[0], z[1], m)

    return advance, local_mac, head_block, tail_fire


def make_ppermute_step_nu(mesh: Mesh, nuspec, n_channels: int,
                          shared: bool = False):
    """Per-block sharded two-stage step: state/coeffs are
    ``core.nonuniform.NuState``/``NuCoeffs`` with ROLLED 4-D rings
    [P, 2, C, Hp] (the sharded layout; single-chip uses pointer layout).
    Outputs match ``core.nonuniform.step_nu`` to fp rounding."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.kernels import spectrum_mac as K

    n = nuspec.block_length
    ratio = nuspec.ratio
    _, _, head_block, tail_fire = _make_nu_shard_parts(
        mesh, nuspec, n_channels)

    P4 = P("p", None, "c", None)
    Pco = P("p", None, None, None) if shared else P4
    Pc = P("c", None)
    Pq = P(None, "c", None)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P4, Pc, P(), P4, Pc, P(), Pc, Pq, Pco, Pco, Pc),
        out_specs=(P4, Pc, P(), P4, Pc, P(), Pc, Pq, Pc),
        check_vma=False,
    )
    def body(h_ring, h_prev, h_cnt, t_ring, t_prev, t_cnt, inbuf, pending,
             h_co, t_co, block_l):
        block_l = block_l.astype(h_prev.dtype)
        c_l = block_l.shape[0]
        r_phase = jnp.mod(h_cnt, ratio)
        h_ring, y_head = head_block(h_ring, h_prev, block_l, h_co)
        zero = jnp.zeros((), dtype=r_phase.dtype)
        inbuf = jax.lax.dynamic_update_slice(
            inbuf, block_l.astype(inbuf.dtype), (zero, r_phase * n))
        tail_slice = jax.lax.dynamic_slice(
            pending[0], (zero, r_phase * n), (c_l, n))

        def fire(args):
            t_ring, t_prev, pending, inbuf = args
            t_ring, z = tail_fire(t_ring, t_prev, inbuf, t_co)
            pending = jnp.concatenate([pending[1:], z[None]], axis=0)
            return t_ring, inbuf, pending

        def hold(args):
            t_ring, t_prev, pending, _ = args
            return t_ring, t_prev, pending

        t_ring, t_prev, pending = jax.lax.cond(
            r_phase == ratio - 1, fire, hold, (t_ring, t_prev, pending, inbuf))
        fired = (r_phase == ratio - 1).astype(t_cnt.dtype)
        out = y_head + tail_slice
        return (h_ring, block_l, h_cnt + 1, t_ring, t_prev, t_cnt + fired,
                inbuf, pending, out)

    def step(state, coeffs, block):
        (h_ring, h_prev, h_cnt, t_ring, t_prev, t_cnt, inbuf, pending,
         out) = body(state.head.ring, state.head.prev_block,
                     state.head.blockcounter, state.tail.ring,
                     state.tail.prev_block, state.tail.blockcounter,
                     state.inbuf, state.pending, coeffs.head, coeffs.tail,
                     block)
        return NU.NuState(K.HcState(h_ring, h_prev, h_cnt),
                          K.HcState(t_ring, t_prev, t_cnt),
                          inbuf, pending), out

    return step


def make_ppermute_macro_nu(mesh: Mesh, nuspec, n_channels: int,
                           shared: bool = False):
    """Cond-free M-cycle macro form (sharded ``step_nu_macro``): R unrolled
    head blocks + one unconditional tail fire. The per-block form's untaken
    cond branch passes the tail ring through — a per-block copy of the
    biggest state tensor under ``lax.scan``; this form avoids it for
    aligned bulk work (same outputs from phase 0)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.kernels import spectrum_mac as K

    n = nuspec.block_length
    ratio = nuspec.ratio
    _, _, head_block, tail_fire = _make_nu_shard_parts(
        mesh, nuspec, n_channels)

    P4 = P("p", None, "c", None)
    Pco = P("p", None, None, None) if shared else P4
    Pc = P("c", None)
    Pq = P(None, "c", None)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P4, Pc, P(), P4, Pc, P(), Pq, Pco, Pco, P(None, "c", None)),
        out_specs=(P4, Pc, P(), P4, Pc, P(), Pc, Pq, P(None, "c", None)),
        check_vma=False,
    )
    def body(h_ring, h_prev, h_cnt, t_ring, t_prev, t_cnt, pending,
             h_co, t_co, mblocks_l):
        c_l = mblocks_l.shape[1]
        outs = []
        for i in range(ratio):  # static unroll, phase is a python int
            blk = mblocks_l[i].astype(h_prev.dtype)
            h_ring, y = head_block(h_ring, h_prev, blk, h_co)
            h_prev = blk
            outs.append(y + pending[0][:, i * n:(i + 1) * n])
        inbuf = jnp.swapaxes(mblocks_l, 0, 1).reshape(c_l, ratio * n).astype(
            h_prev.dtype)
        t_ring, z = tail_fire(t_ring, t_prev, inbuf, t_co)
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return (h_ring, h_prev, h_cnt + ratio, t_ring, inbuf, t_cnt + 1,
                inbuf, pending, jnp.stack(outs))

    def macro(state, coeffs, mblocks):
        (h_ring, h_prev, h_cnt, t_ring, t_prev, t_cnt, inbuf, pending,
         outs) = body(state.head.ring, state.head.prev_block,
                      state.head.blockcounter, state.tail.ring,
                      state.tail.prev_block, state.tail.blockcounter,
                      state.pending, coeffs.head, coeffs.tail, mblocks)
        return NU.NuState(K.HcState(h_ring, h_prev, h_cnt),
                          K.HcState(t_ring, t_prev, t_cnt),
                          inbuf, pending), outs

    return macro


def make_ppermute_step_nu_crossfade(mesh: Mesh, nuspec, n_channels: int,
                                    head_ramp: bool = True,
                                    shared: bool = False):
    """Sharded form of ``core.nonuniform.step_nu_crossfade``: glitch-free
    live filter change on the sharded two-stage engine. head_ramp=True is
    the change block (two head MACs + intra-block ramp); False the hold
    blocks (new head, waiting for the bridging tail fire). The first tail
    fire after the change runs BOTH tail coefficient sets on one ring
    advance and stores a full-M old->new ramp. Communication per block is
    the plain step's (the extra MAC partials ride the same stacked psum)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.kernels import spectrum_mac as K
    from bfir_tpu.ops import fft as F

    n = nuspec.block_length
    m = nuspec.m
    ratio = nuspec.ratio
    advance, local_mac, head_block, _ = _make_nu_shard_parts(
        mesh, nuspec, n_channels)

    P4 = P("p", None, "c", None)
    Pco = P("p", None, None, None) if shared else P4
    Pc = P("c", None)
    Pq = P(None, "c", None)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P4, Pc, P(), P4, Pc, P(), Pc, Pq,
                  Pco, Pco, Pco, Pco, Pc),
        out_specs=(P4, Pc, P(), P4, Pc, P(), Pc, Pq, Pc),
        check_vma=False,
    )
    def body(h_ring, h_prev, h_cnt, t_ring, t_prev, t_cnt, inbuf, pending,
             h_old, h_new, t_old, t_new, block_l):
        block_l = block_l.astype(h_prev.dtype)
        c_l = block_l.shape[0]
        r_phase = jnp.mod(h_cnt, ratio)
        if head_ramp:
            h_ring = advance(h_ring, h_prev, block_l)
            yo = local_mac(h_ring, h_old, tiled=False)
            yn = local_mac(h_ring, h_new, tiled=False)
            y = jax.lax.psum(jnp.stack([yo[0], yo[1], yn[0], yn[1]]), "p")
            out_o = F.irfft_hc_tail(y[0], y[1], n=2 * n)
            out_n = F.irfft_hc_tail(y[2], y[3], n=2 * n)
            ramp = jnp.arange(n, dtype=out_o.dtype) / (n - 1)
            y_head = out_o * (1.0 - ramp) + out_n * ramp
        else:
            h_ring, y_head = head_block(h_ring, h_prev, block_l, h_new)
        zero = jnp.zeros((), dtype=r_phase.dtype)
        inbuf = jax.lax.dynamic_update_slice(
            inbuf, block_l.astype(inbuf.dtype), (zero, r_phase * n))
        tail_slice = jax.lax.dynamic_slice(
            pending[0], (zero, r_phase * n), (c_l, n))

        def fire(args):
            t_ring, t_prev, pending, inbuf = args
            t_ring = advance(t_ring, t_prev, inbuf)
            zo = local_mac(t_ring, t_old, tiled=True)
            zn = local_mac(t_ring, t_new, tiled=True)
            z = jax.lax.psum(jnp.stack([zo[0], zo[1], zn[0], zn[1]]), "p")
            from bfir_tpu.core.nonuniform import _tail_inverse

            z_old = _tail_inverse(z[0], z[1], m)
            z_new = _tail_inverse(z[2], z[3], m)
            ramp_m = jnp.arange(m, dtype=z_old.dtype) / (m - 1)
            zz = z_old * (1.0 - ramp_m) + z_new * ramp_m
            pending = jnp.concatenate([pending[1:], zz[None]], axis=0)
            return t_ring, inbuf, pending

        def hold(args):
            t_ring, t_prev, pending, _ = args
            return t_ring, t_prev, pending

        t_ring, t_prev, pending = jax.lax.cond(
            r_phase == ratio - 1, fire, hold, (t_ring, t_prev, pending, inbuf))
        fired = (r_phase == ratio - 1).astype(t_cnt.dtype)
        out = y_head + tail_slice
        return (h_ring, block_l, h_cnt + 1, t_ring, t_prev, t_cnt + fired,
                inbuf, pending, out)

    def step(state, coeffs_old, coeffs_new, block):
        (h_ring, h_prev, h_cnt, t_ring, t_prev, t_cnt, inbuf, pending,
         out) = body(state.head.ring, state.head.prev_block,
                     state.head.blockcounter, state.tail.ring,
                     state.tail.prev_block, state.tail.blockcounter,
                     state.inbuf, state.pending,
                     coeffs_old.head, coeffs_new.head,
                     coeffs_old.tail, coeffs_new.tail, block)
        return NU.NuState(K.HcState(h_ring, h_prev, h_cnt),
                          K.HcState(t_ring, t_prev, t_cnt),
                          inbuf, pending), out

    return step


# ---------------------------------------------------------------------------
# Sharded THREE-stage engine: core.nonuniform's
# recursive Gardner schedule — the auto pick for very long filters
# (>= 640 partitions, where its nearly flat cost undercuts the two-stage
# one) — run over the same ("c", "p") mesh and ring-rotate schedule.
# Three rolled rings, all sharded over ("p", -, "c", -):
#
# - OUTER head: p_head partitions at N — ppermute + psum every block.
# - INNER head: inner.p_head partitions at M1 = r1*N — its pair every r1
#   blocks (outer fire, under lax.cond on the replicated outer phase).
# - FAR stage: inner.p_tail partitions at M2 = r2*M1 — its pair every
#   r1*r2 blocks (a cond NESTED inside the outer fire on the replicated
#   inner phase; every device takes the same branches, so collectives
#   inside both conds lower correctly — asserted in test_parallel.py).
#
# Amortized per-N-block communication: (1 + 1/r1 + 1/(r1*r2)) cp+ar pairs
# of sizes Hp_N / Hp_M1 / Hp_M2 — see COMM_MODEL.md. The far-stage ring
# sharded over "p" at its M2 cadence is exactly the structure SURVEY §2
# maps onto partition sharding (brutefir.cpp:279-300).
# ---------------------------------------------------------------------------


def _nu3_pad_far(spec3, p_shards: int):
    """Pad the far stage's partition count to a multiple of the mesh "p"
    axis (zero coefficients in the padding — exact output)."""
    from bfir_tpu.core import nonuniform as NU

    inner = _nu_pad_tail(spec3.inner, p_shards)
    if inner is spec3.inner:
        return spec3
    return NU.Nu3Spec(spec3.block_length, spec3.ratio1, spec3.p_head, inner)


def _make_nu3_shard_parts(mesh: Mesh, spec3, n_channels: int):
    """Stage builders for the sharded three-stage engine: the shared
    advance/local_mac of the two-stage path plus per-stage fire functions
    (outer head at N: untiled MAC + direct tail basis; inner head at M1 and
    far at M2: tiled MAC + the size-dispatched tail inverse, exactly the
    single-chip stage compute of core.nonuniform._step_nu_tiled_head)."""
    from bfir_tpu.core.nonuniform import _tail_inverse
    from bfir_tpu.ops import fft as F

    advance, local_mac, head_block, _ = _make_nu_shard_parts(
        mesh, spec3.inner, n_channels)

    def outer_head(ring_l, prev_l, block_l, coeff_l):
        n = spec3.block_length
        ring_l = advance(ring_l, prev_l, block_l)
        yr, yi = local_mac(ring_l, coeff_l, tiled=False)
        y = jax.lax.psum(jnp.stack([yr, yi]), "p")
        return ring_l, F.irfft_hc_tail(y[0], y[1], n=2 * n)

    def stage_fire(ring_l, prev_l, mblock_l, coeff_l, m: int):
        """Inner-head (m=M1) or far (m=M2) fire: advance + tiled MAC + one
        stacked psum + the size-dispatched tail inverse."""
        ring_l = advance(ring_l, prev_l, mblock_l)
        zr, zi = local_mac(ring_l, coeff_l, tiled=True)
        z = jax.lax.psum(jnp.stack([zr, zi]), "p")
        return ring_l, _tail_inverse(z[0], z[1], m)

    return advance, local_mac, outer_head, stage_fire


def make_ppermute_step_nu3(mesh: Mesh, spec3, n_channels: int,
                           shared: bool = False):
    """Per-block sharded three-stage step: state/coeffs are
    ``core.nonuniform.Nu3State``/``Nu3Coeffs`` with ROLLED 4-D rings.
    Outputs match ``core.nonuniform.step_nu3`` to fp rounding."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.kernels import spectrum_mac as K

    n = spec3.block_length
    r1 = spec3.ratio1
    inner = spec3.inner
    m1, r2, m2 = spec3.m1, inner.ratio, inner.m
    _, _, outer_head, stage_fire = _make_nu3_shard_parts(
        mesh, spec3, n_channels)

    P4 = P("p", None, "c", None)
    Pco = P("p", None, None, None) if shared else P4
    Pc = P("c", None)
    Pq = P(None, "c", None)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P4, Pc, P(),          # outer head ring/prev/cnt
                  P4, Pc, P(),          # inner head ring/prev/cnt
                  P4, Pc, P(),          # far ring/prev/cnt
                  Pc, Pq,               # inner inbuf [C,M2] / pending [D2,C,M2]
                  Pc, Pq,               # outer inbuf [C,M1] / pending [D1,C,M1]
                  Pco, Pco, Pco, Pc),   # head/inner-head/far coeffs + block
        out_specs=(P4, Pc, P(), P4, Pc, P(), P4, Pc, P(),
                   Pc, Pq, Pc, Pq, Pc),
        check_vma=False,
    )
    def body(h_ring, h_prev, h_cnt, ih_ring, ih_prev, ih_cnt,
             f_ring, f_prev, f_cnt, i_inbuf, i_pending, o_inbuf, o_pending,
             h_co, ih_co, f_co, block_l):
        block_l = block_l.astype(h_prev.dtype)
        c_l = block_l.shape[0]
        r_phase = jnp.mod(h_cnt, r1)
        h_ring, y_head = outer_head(h_ring, h_prev, block_l, h_co)
        zero = jnp.zeros((), dtype=r_phase.dtype)
        o_inbuf = jax.lax.dynamic_update_slice(
            o_inbuf, block_l.astype(o_inbuf.dtype), (zero, r_phase * n))
        tail_slice = jax.lax.dynamic_slice(
            o_pending[0], (zero, r_phase * n), (c_l, n))

        def outer_fire(args):
            (ih_ring, ih_prev, ih_cnt, f_ring, f_prev, f_cnt,
             i_inbuf, i_pending, o_pending, o_inbuf) = args
            # one step of the sharded inner two-stage engine on the
            # completed M1-block (cf. core.nonuniform._step_nu_tiled_head)
            i_phase = jnp.mod(ih_cnt, r2)
            ih_ring, y_inner = stage_fire(ih_ring, ih_prev, o_inbuf, ih_co, m1)
            izero = jnp.zeros((), dtype=i_phase.dtype)
            i_inbuf = jax.lax.dynamic_update_slice(
                i_inbuf, o_inbuf.astype(i_inbuf.dtype), (izero, i_phase * m1))
            i_slice = jax.lax.dynamic_slice(
                i_pending[0], (izero, i_phase * m1), (c_l, m1))

            def far_fire(fargs):
                f_ring, f_prev, i_pending, i_inbuf = fargs
                f_ring, zf = stage_fire(f_ring, f_prev, i_inbuf, f_co, m2)
                i_pending = jnp.concatenate([i_pending[1:], zf[None]], axis=0)
                return f_ring, i_inbuf, i_pending

            def far_hold(fargs):
                f_ring, f_prev, i_pending, _ = fargs
                return f_ring, f_prev, i_pending

            f_ring, f_prev, i_pending = jax.lax.cond(
                i_phase == r2 - 1, far_fire, far_hold,
                (f_ring, f_prev, i_pending, i_inbuf))
            f_fired = (i_phase == r2 - 1).astype(f_cnt.dtype)
            z = y_inner + i_slice
            o_pending = jnp.concatenate([o_pending[1:], z[None]], axis=0)
            return (ih_ring, o_inbuf, ih_cnt + 1, f_ring, f_prev,
                    f_cnt + f_fired, i_inbuf, i_pending, o_pending)

        def outer_hold(args):
            (ih_ring, ih_prev, ih_cnt, f_ring, f_prev, f_cnt,
             i_inbuf, i_pending, o_pending, _) = args
            return (ih_ring, ih_prev, ih_cnt, f_ring, f_prev, f_cnt,
                    i_inbuf, i_pending, o_pending)

        (ih_ring, ih_prev, ih_cnt, f_ring, f_prev, f_cnt, i_inbuf,
         i_pending, o_pending) = jax.lax.cond(
            r_phase == r1 - 1, outer_fire, outer_hold,
            (ih_ring, ih_prev, ih_cnt, f_ring, f_prev, f_cnt,
             i_inbuf, i_pending, o_pending, o_inbuf))
        out = y_head + tail_slice
        return (h_ring, block_l, h_cnt + 1, ih_ring, ih_prev, ih_cnt,
                f_ring, f_prev, f_cnt, i_inbuf, i_pending, o_inbuf,
                o_pending, out)

    def step(state, coeffs, block):
        (h_ring, h_prev, h_cnt, ih_ring, ih_prev, ih_cnt, f_ring, f_prev,
         f_cnt, i_inbuf, i_pending, o_inbuf, o_pending, out) = body(
            state.head.ring, state.head.prev_block, state.head.blockcounter,
            state.tail.head.ring, state.tail.head.prev_block,
            state.tail.head.blockcounter,
            state.tail.tail.ring, state.tail.tail.prev_block,
            state.tail.tail.blockcounter,
            state.tail.inbuf, state.tail.pending,
            state.inbuf, state.pending,
            coeffs.head, coeffs.tail.head, coeffs.tail.tail, block)
        return NU.Nu3State(
            head=K.HcState(h_ring, h_prev, h_cnt),
            tail=NU.NuState(K.HcState(ih_ring, ih_prev, ih_cnt),
                            K.HcState(f_ring, f_prev, f_cnt),
                            i_inbuf, i_pending),
            inbuf=o_inbuf, pending=o_pending), out

    return step


def make_ppermute_macro_nu3(mesh: Mesh, spec3, n_channels: int,
                            shared: bool = False):
    """Cond-free SUPER-cycle macro form (sharded
    ``process_blocks_nu3_fast`` body): r1*r2 unrolled outer-head blocks with
    every phase static — neither the M1 ring nor the far ring is carried
    through an untaken ``lax.cond`` branch (whose pass-through would copy
    the largest state tensors every block under ``lax.scan``). ``state``
    must be at super-cycle phase 0; same outputs as r1*r2 per-block steps."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bfir_tpu.core import nonuniform as NU
    from bfir_tpu.kernels import spectrum_mac as K

    n = spec3.block_length
    r1 = spec3.ratio1
    inner = spec3.inner
    m1, r2, m2 = spec3.m1, inner.ratio, inner.m
    _, _, outer_head, stage_fire = _make_nu3_shard_parts(
        mesh, spec3, n_channels)

    P4 = P("p", None, "c", None)
    Pco = P("p", None, None, None) if shared else P4
    Pc = P("c", None)
    Pq = P(None, "c", None)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P4, Pc, P(), P4, Pc, P(), P4, Pc, P(),
                  Pq, Pq, Pco, Pco, Pco, P(None, None, "c", None)),
        out_specs=(P4, Pc, P(), P4, Pc, P(), P4, Pc, P(),
                   Pc, Pq, Pc, Pq, P(None, "c", None)),
        check_vma=False,
    )
    def body(h_ring, h_prev, h_cnt, ih_ring, ih_prev, ih_cnt,
             f_ring, f_prev, f_cnt, i_pending, o_pending,
             h_co, ih_co, f_co, sblocks_l):  # sblocks_l [r2, r1, C_l, N]
        c_l = sblocks_l.shape[2]
        outs = []
        for j in range(r2):      # static inner phase
            for i in range(r1):  # static outer phase
                blk = sblocks_l[j, i].astype(h_prev.dtype)
                h_ring, y = outer_head(h_ring, h_prev, blk, h_co)
                h_prev = blk
                outs.append(y + o_pending[0][:, i * n:(i + 1) * n])
            o_inbuf = jnp.swapaxes(sblocks_l[j], 0, 1).reshape(
                c_l, r1 * n).astype(h_prev.dtype)
            ih_ring, y_inner = stage_fire(ih_ring, ih_prev, o_inbuf, ih_co, m1)
            ih_prev = o_inbuf
            z = y_inner + i_pending[0][:, j * m1:(j + 1) * m1]
            if j == r2 - 1:
                i_inbuf = jnp.concatenate(
                    [jnp.swapaxes(sblocks_l[jj], 0, 1).reshape(c_l, r1 * n)
                     for jj in range(r2)], axis=-1).astype(h_prev.dtype)
                f_ring, zf = stage_fire(f_ring, f_prev, i_inbuf, f_co, m2)
                f_prev = i_inbuf
                i_pending = jnp.concatenate([i_pending[1:], zf[None]], axis=0)
            o_pending = jnp.concatenate([o_pending[1:], z[None]], axis=0)
        return (h_ring, h_prev, h_cnt + r1 * r2, ih_ring, ih_prev,
                ih_cnt + r2, f_ring, f_prev, f_cnt + 1, i_inbuf, i_pending,
                o_inbuf, o_pending, jnp.stack(outs))

    def macro(state, coeffs, sblocks):
        (h_ring, h_prev, h_cnt, ih_ring, ih_prev, ih_cnt, f_ring, f_prev,
         f_cnt, i_inbuf, i_pending, o_inbuf, o_pending, outs) = body(
            state.head.ring, state.head.prev_block, state.head.blockcounter,
            state.tail.head.ring, state.tail.head.prev_block,
            state.tail.head.blockcounter,
            state.tail.tail.ring, state.tail.tail.prev_block,
            state.tail.tail.blockcounter,
            state.tail.pending, state.pending,
            coeffs.head, coeffs.tail.head, coeffs.tail.tail, sblocks)
        return NU.Nu3State(
            head=K.HcState(h_ring, h_prev, h_cnt),
            tail=NU.NuState(K.HcState(ih_ring, ih_prev, ih_cnt),
                            K.HcState(f_ring, f_prev, f_cnt),
                            i_inbuf, i_pending),
            inbuf=o_inbuf, pending=o_pending), outs

    return macro


class ShardedEngine:
    """Multi-device partitioned convolver.

    ``schedule="ppermute"`` (default, the product path): explicit shard_map
    ring: one permute of a ring slot + one all-reduce per block.
    ``schedule="gspmd"``: jit of ``core.convolver.step_rolled`` under
    NamedShardings, letting GSPMD choose the collectives — kept as a
    numerical cross-check (it inserts extra all-gathers; see module
    docstring).

    ``local_impl``: the shard-local compute. "nonuniform" (the session's
    default on accelerator meshes when the filter is long enough) runs the two-stage
    Gardner schedule — the fastest single-chip engine — sharded per stage
    (see the sharded-nu section above); "hc" runs the uniform optimized
    path — packed halfcomplex state, the ``mac_hc`` MAC, the halfcomplex
    overlap-save tail; "complex" is the complex-spectra jnp formulation
    (default on CPU meshes, numerically f64-capable). ``None`` picks "hc"
    on an accelerator mesh and "complex" on a CPU mesh."""

    def __init__(self, spec: FilterSpec, n_channels: int, mesh: Mesh,
                 schedule: str = "ppermute", local_impl: Optional[str] = None,
                 nuspec=None, nu_tail_store: str = "float32",
                 shared_coeffs: bool = False):
        if spec.n_partitions % mesh.shape["p"]:
            raise ValueError(
                f"n_partitions {spec.n_partitions} not divisible by mesh p={mesh.shape['p']}")
        if n_channels % mesh.shape["c"]:
            raise ValueError(
                f"n_channels {n_channels} not divisible by mesh c={mesh.shape['c']}")
        if schedule not in ("ppermute", "gspmd"):
            raise ValueError(f"schedule must be ppermute or gspmd, got {schedule!r}")
        if local_impl is None:
            local_impl = "complex" if platform.is_cpu(
                mesh.devices.flat[0]) else "hc"
        if local_impl not in ("hc", "complex", "nonuniform", "nonuniform3"):
            raise ValueError(
                "local_impl must be hc, complex, nonuniform or nonuniform3, "
                f"got {local_impl!r}")
        if local_impl in ("hc", "nonuniform", "nonuniform3") and schedule == "gspmd":
            raise ValueError(f"local_impl={local_impl!r} requires the ppermute schedule")
        self.spec = spec
        self.n_channels = n_channels
        self.mesh = mesh
        self.schedule = schedule
        self.local_impl = local_impl
        self.nuspec = None  # set by the nonuniform branch
        # shared_coeffs: one filter for all channels — coefficient planes
        # [P, 2, 1, Hp] replicated over "c" (1/C the coefficient memory per
        # chip, like single-chip). hc / nonuniform local engines only.
        self.shared_coeffs = bool(shared_coeffs) and local_impl in (
            "hc", "nonuniform", "nonuniform3")
        from jax.sharding import NamedSharding, PartitionSpec as P

        if local_impl == "nonuniform3":
            from bfir_tpu.core import nonuniform as NU
            from bfir_tpu.kernels import spectrum_mac as K

            if nu_tail_store in ("int16", "int24"):
                raise ValueError(
                    "integer tail storage is single-chip only for now "
                    "(sharded engines support float32/bfloat16)")
            p_shards = mesh.shape["p"]
            if nuspec is None:
                nuspec = NU.nu3_geometry(
                    spec.n_partitions * spec.block_length, spec.block_length,
                    ratio1=8, ratio2=8, dtype=spec.dtype,
                    tail_store=nu_tail_store)
            nuspec = _nu3_pad_far(nuspec, p_shards)
            if nuspec.p_head % p_shards or nuspec.inner.p_head % p_shards:
                raise ValueError(
                    f"nu3 head partitions ({nuspec.p_head} outer / "
                    f"{nuspec.inner.p_head} inner) not divisible by "
                    f"mesh p={p_shards}")
            taps = spec.n_partitions * spec.block_length
            if taps <= (nuspec.p_head * spec.block_length
                        + nuspec.inner.p_head * nuspec.m1):
                raise ValueError(
                    f"filter ({taps} taps) too short for the sharded "
                    "three-stage engine (outer+inner heads alone cover it)")
            self.nuspec = nuspec
            n = nuspec.block_length
            inner = nuspec.inner
            hp_n = -(-n // 128) * 128
            hp_m1 = -(-nuspec.m1 // 128) * 128
            hp_m2 = -(-inner.m // 128) * 128
            hc_sh = lambda: K.HcState(
                ring=NamedSharding(mesh, P("p", None, "c", None)),
                prev_block=NamedSharding(mesh, P("c", None)),
                blockcounter=NamedSharding(mesh, P()),
            )
            self._state_shardings = NU.Nu3State(
                head=hc_sh(),
                tail=NU.NuState(
                    head=hc_sh(), tail=hc_sh(),
                    inbuf=NamedSharding(mesh, P("c", None)),
                    pending=NamedSharding(mesh, P(None, "c", None))),
                inbuf=NamedSharding(mesh, P("c", None)),
                pending=NamedSharding(mesh, P(None, "c", None)),
            )
            Pco4 = (P("p", None, None, None) if self.shared_coeffs
                    else P("p", None, "c", None))
            self._coeff_sharding = NU.Nu3Coeffs(
                head=NamedSharding(mesh, Pco4),
                tail=NU.NuCoeffs(head=NamedSharding(mesh, Pco4),
                                 tail=NamedSharding(mesh, Pco4)),
            )
            self._block_sharding = NamedSharding(mesh, P("c", None))
            self._step_fn = make_ppermute_step_nu3(
                mesh, nuspec, n_channels, shared=self.shared_coeffs)
            self._macro_fn = make_ppermute_macro_nu3(
                mesh, nuspec, n_channels, shared=self.shared_coeffs)
            self._scan_macro = None
            self._nu_xfade = None
            dt = jnp.dtype(spec.dtype)
            dt_far = (jnp.bfloat16 if inner.tail_store == "bfloat16" else dt)
            c = n_channels
            m1, m2 = nuspec.m1, inner.m
            d1, d2 = nuspec.delay_blocks, inner.delay_blocks

            def _mk_state3():
                return NU.Nu3State(
                    head=K.HcState(
                        ring=jnp.zeros((nuspec.p_head, 2, c, hp_n), dt),
                        prev_block=jnp.zeros((c, n), dt),
                        blockcounter=jnp.zeros((), jnp.int32)),
                    tail=NU.NuState(
                        head=K.HcState(
                            ring=jnp.zeros((inner.p_head, 2, c, hp_m1), dt),
                            prev_block=jnp.zeros((c, m1), dt),
                            blockcounter=jnp.zeros((), jnp.int32)),
                        tail=K.HcState(
                            ring=jnp.zeros((inner.p_tail, 2, c, hp_m2),
                                           dt_far),
                            prev_block=jnp.zeros((c, m2), dt),
                            blockcounter=jnp.zeros((), jnp.int32)),
                        inbuf=jnp.zeros((c, m2), dt),
                        pending=jnp.zeros((d2, c, m2), dt)),
                    inbuf=jnp.zeros((c, m1), dt),
                    pending=jnp.zeros((d1, c, m1), dt),
                )

            self._init = jax.jit(_mk_state3,
                                 out_shardings=self._state_shardings)
        elif local_impl == "nonuniform":
            from bfir_tpu.core import nonuniform as NU
            from bfir_tpu.kernels import spectrum_mac as K

            p_shards = mesh.shape["p"]
            if nuspec is None:
                nuspec = NU.nu_geometry(
                    spec.n_partitions * spec.block_length, spec.block_length,
                    ratio=8, dtype=spec.dtype, tail_store=nu_tail_store)
            nuspec = _nu_pad_tail(nuspec, p_shards)
            if nuspec.p_head % p_shards:
                raise ValueError(
                    f"nu head partitions ({nuspec.p_head}) not divisible by "
                    f"mesh p={p_shards}")
            taps = spec.n_partitions * spec.block_length
            if taps <= nuspec.p_head * spec.block_length:
                raise ValueError(
                    f"filter ({taps} taps) too short for the sharded "
                    f"non-uniform engine (head alone covers "
                    f"{nuspec.p_head * spec.block_length})")
            self.nuspec = nuspec
            n = nuspec.block_length
            self._hp_h = -(-n // 128) * 128            # round_up(2n/2, 128)
            self._hp_t = -(-nuspec.m // 128) * 128
            hc_sh = lambda: K.HcState(
                ring=NamedSharding(mesh, P("p", None, "c", None)),
                prev_block=NamedSharding(mesh, P("c", None)),
                blockcounter=NamedSharding(mesh, P()),
            )
            self._state_shardings = NU.NuState(
                head=hc_sh(), tail=hc_sh(),
                inbuf=NamedSharding(mesh, P("c", None)),
                pending=NamedSharding(mesh, P(None, "c", None)),
            )
            Pco4 = (P("p", None, None, None) if self.shared_coeffs
                    else P("p", None, "c", None))
            self._coeff_sharding = NU.NuCoeffs(
                head=NamedSharding(mesh, Pco4),
                tail=NamedSharding(mesh, Pco4),
            )
            self._block_sharding = NamedSharding(mesh, P("c", None))
            self._step_fn = make_ppermute_step_nu(
                mesh, nuspec, n_channels, shared=self.shared_coeffs)
            self._macro_fn = make_ppermute_macro_nu(
                mesh, nuspec, n_channels, shared=self.shared_coeffs)
            self._macro = None
            self._scan_macro = None
            self._nu_xfade = None
            dt = jnp.dtype(spec.dtype)
            dt_tail = (jnp.bfloat16 if nuspec.tail_store == "bfloat16" else dt)
            c, m, d = n_channels, nuspec.m, nuspec.delay_blocks

            def _mk_state():
                return NU.NuState(
                    head=K.HcState(
                        ring=jnp.zeros((nuspec.p_head, 2, c, self._hp_h), dt),
                        prev_block=jnp.zeros((c, n), dt),
                        blockcounter=jnp.zeros((), jnp.int32)),
                    tail=K.HcState(
                        ring=jnp.zeros((nuspec.p_tail, 2, c, self._hp_t),
                                       dt_tail),
                        prev_block=jnp.zeros((c, m), dt),
                        blockcounter=jnp.zeros((), jnp.int32)),
                    inbuf=jnp.zeros((c, m), dt),
                    pending=jnp.zeros((d, c, m), dt),
                )

            self._init = jax.jit(_mk_state, out_shardings=self._state_shardings)
        elif local_impl == "hc":
            # packed halfcomplex state: ring [P, 2, C, Hp] over ("p", "c")
            self._hp = -(-spec.n_fft // 2 // 128) * 128
            self._state_shardings = cv.ConvolverState(
                spectra_ring=NamedSharding(mesh, P("p", None, "c", None)),
                prev_block=NamedSharding(mesh, P("c", None)),
                blockcounter=NamedSharding(mesh, P()),
            )
            self._coeff_sharding = NamedSharding(
                mesh, P("p", None, None, None) if self.shared_coeffs
                else P("p", None, "c", None))
            self._block_sharding = NamedSharding(mesh, P("c", None))
            self._step_fn = make_ppermute_step_hc(
                mesh, spec, n_channels, shared=self.shared_coeffs)
        else:
            st_sh = M.state_shardings(mesh)
            self._state_shardings = cv.ConvolverState(
                spectra_ring=st_sh["spectra_ring"],
                prev_block=st_sh["prev_block"],
                blockcounter=st_sh["blockcounter"],
            )
            self._coeff_sharding = M.coeff_sharding(mesh)
            self._block_sharding = M.block_sharding(mesh)
            self._step_fn = (
                make_ppermute_step(mesh, spec, n_channels)
                if schedule == "ppermute" else cv.step_rolled
            )
        self._step = jax.jit(
            self._step_fn,
            in_shardings=(self._state_shardings, self._coeff_sharding,
                          self._block_sharding),
            out_shardings=(self._state_shardings, self._block_sharding),
            donate_argnums=0,
        )
        self._xfade_fn = None
        self._xfade = None
        self._batch = None
        self._scan = None
        # placement helpers that work for complex dtypes on backends where
        # complex host->device transfer is unavailable (see ops.fft)
        self._place_coeffs = jax.jit(lambda x: x, out_shardings=self._coeff_sharding)
        if local_impl == "hc":
            dt = jnp.dtype(spec.dtype)
            self._init = jax.jit(
                lambda: cv.ConvolverState(
                    spectra_ring=jnp.zeros(
                        (spec.n_partitions, 2, n_channels, self._hp), dtype=dt),
                    prev_block=jnp.zeros((n_channels, spec.block_length), dtype=dt),
                    blockcounter=jnp.zeros((), dtype=jnp.int32),
                ),
                out_shardings=self._state_shardings,
            )
        elif local_impl == "complex":
            self._init = jax.jit(
                lambda: cv.init_state(spec, n_channels),
                out_shardings=self._state_shardings,
                static_argnums=(),
            )
        # (nonuniform: self._init built in its branch above)

    def init_state(self) -> cv.ConvolverState:
        return self._init()

    def prepare_coeffs(self, impulse, scale: float = 1.0,
                       precise: bool = False) -> jax.Array:
        if self.local_impl == "nonuniform3":
            from bfir_tpu.core import nonuniform as NU

            co = NU.nu3_coeffs(impulse, self.nuspec, self.n_channels,
                               scale=scale, precise=precise,
                               shared=self.shared_coeffs)
            p_shards = self.mesh.shape["p"]

            def _reorder(plane):  # [P, 2*cs, Hp] -> rolled 4-D shard layout
                p, c2, hp = plane.shape
                plane = plane.reshape(p, 2, c2 // 2, hp)
                return _hc_chunk_reorder(plane, p_shards)

            co = NU.Nu3Coeffs(
                head=_reorder(co.head),
                tail=NU.NuCoeffs(head=_reorder(co.tail.head),
                                 tail=_reorder(co.tail.tail)))
            return self._place_coeffs(co)
        if self.local_impl == "nonuniform":
            from bfir_tpu.core import nonuniform as NU

            co = NU.nu_coeffs(impulse, self.nuspec, self.n_channels,
                              scale=scale, precise=precise,
                              shared=self.shared_coeffs)
            p_shards = self.mesh.shape["p"]

            def _reorder(plane):  # [P, 2*cs, Hp] -> rolled 4-D shard layout
                p, c2, hp = plane.shape
                plane = plane.reshape(p, 2, c2 // 2, hp)
                return _hc_chunk_reorder(plane, p_shards)

            co = NU.NuCoeffs(head=_reorder(co.head), tail=_reorder(co.tail))
            return self._place_coeffs(co)
        if self.local_impl == "hc":
            from bfir_tpu.kernels import spectrum_mac as K

            co = K.hc_coeffs(impulse, self.spec, self.n_channels, scale=scale,
                             precise=precise,
                             shared=self.shared_coeffs)  # [P, 2*cs, Hp]
            p, c2, hp = co.shape
            co = co.reshape(p, 2, c2 // 2, hp)
            co = _hc_chunk_reorder(co, self.mesh.shape["p"])
            return self._place_coeffs(co)
        coeffs = cv.coeffs_to_spectra(impulse, self.spec, scale=scale)
        return self._place_coeffs(coeffs)

    def step(self, state, coeffs, block) -> Tuple[cv.ConvolverState, jax.Array]:
        return self._step(state, coeffs, block)

    def nu_crossfade_steps(self):
        """Lazily jitted (ramp, hold) crossfade steps for the sharded
        non-uniform engine — the same two-phase protocol as single-chip
        ``core.nonuniform.step_nu_crossfade`` (the session drives it)."""
        assert self.local_impl == "nonuniform"
        if self._nu_xfade is None:
            mk = lambda hr: jax.jit(
                make_ppermute_step_nu_crossfade(
                    self.mesh, self.nuspec, self.n_channels, head_ramp=hr,
                    shared=self.shared_coeffs),
                in_shardings=(self._state_shardings, self._coeff_sharding,
                              self._coeff_sharding, self._block_sharding),
                out_shardings=(self._state_shardings, self._block_sharding),
            )
            self._nu_xfade = (mk(True), mk(False))
        return self._nu_xfade

    def step_crossfade(self, state, coeff_old, coeff_new, block):
        """Glitch-free filter swap: one sharded block with old->new ramp.
        (The nonuniform local engine uses the two-phase ``nu_crossfade_steps``
        protocol instead — this one-shot form is for the uniform engines.)"""
        if self.local_impl == "nonuniform3":
            # live crossfade on the sharded three-stage engine is not
            # implemented: the session rebuilds on reconfigure instead
            # (mirroring the single-chip nu3 mid-transition rule; PARITY.md)
            raise NotImplementedError(
                "sharded nonuniform3 reconfigures by rebuild, not crossfade")
        if self.local_impl == "nonuniform":
            ramp, _ = self.nu_crossfade_steps()
            return ramp(state, coeff_old, coeff_new, block)
        if self._xfade is None:
            if self.local_impl == "hc":
                fn = make_ppermute_step_hc(
                    self.mesh, self.spec, self.n_channels,
                    crossfade=True,
                    shared=self.shared_coeffs)
            elif self.schedule == "ppermute":
                fn = make_ppermute_crossfade_step(self.mesh, self.spec,
                                                  self.n_channels)
            else:
                fn = cv.step_crossfade
            self._xfade = jax.jit(
                fn,
                in_shardings=(self._state_shardings, self._coeff_sharding,
                              self._coeff_sharding, self._block_sharding),
                out_shardings=(self._state_shardings, self._block_sharding),
            )
        return self._xfade(state, coeff_old, coeff_new, block)

    def process_blocks(self, state, coeffs, blocks):
        """Streaming-exact scan over [B, C, N] blocks, one sharded dispatch
        (the sharded form of ``core.convolver.process_blocks``). On the
        nonuniform local engine, M-cycle-aligned bulk work takes the
        cond-free macro scan (identical outputs; no per-block tail-ring
        pass-through copy — the same host-side alignment choice as
        ``engine.session._process_buffer_locked``)."""
        if self.local_impl == "nonuniform3":
            import numpy as _np

            r1 = self.nuspec.ratio1
            r2 = self.nuspec.inner.ratio
            sup = r1 * r2
            b = blocks.shape[0]
            aligned = (b % sup == 0 and
                       int(_np.asarray(state.head.blockcounter)) % sup == 0)
            if aligned:
                if self._scan_macro is None:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    macro_fn = self._macro_fn

                    def scan_fn(st, co, cycles):  # [K, r2, r1, C, N]
                        def body(s, sb):
                            st2, ys = macro_fn(s, co, sb)
                            return st2, ys
                        st, ys = jax.lax.scan(body, st, cycles)
                        return st, ys.reshape(-1, *ys.shape[2:])

                    cy_sh = NamedSharding(self.mesh,
                                          P(None, None, None, "c", None))
                    out_sh = NamedSharding(self.mesh, P(None, "c", None))
                    self._scan_macro = jax.jit(
                        scan_fn,
                        in_shardings=(self._state_shardings,
                                      self._coeff_sharding, cy_sh),
                        out_shardings=(self._state_shardings, out_sh),
                        donate_argnums=0,
                    )
                c, n = blocks.shape[1], blocks.shape[2]
                cycles = blocks.reshape(b // sup, r2, r1, c, n)
                return self._scan_macro(state, coeffs, cycles)
        if self.local_impl == "nonuniform":
            import numpy as _np

            ratio = self.nuspec.ratio
            b = blocks.shape[0]
            aligned = (b % ratio == 0 and
                       int(_np.asarray(state.head.blockcounter)) % ratio == 0)
            if aligned:
                if self._scan_macro is None:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    macro_fn = self._macro_fn

                    def scan_fn(st, co, mcycles):
                        def body(s, mb):
                            return macro_fn(s, co, mb)
                        st, ys = jax.lax.scan(body, st, mcycles)
                        return st, ys.reshape(-1, *ys.shape[2:])

                    mc_sh = NamedSharding(self.mesh, P(None, None, "c", None))
                    out_sh = NamedSharding(self.mesh, P(None, "c", None))
                    self._scan_macro = jax.jit(
                        scan_fn,
                        in_shardings=(self._state_shardings,
                                      self._coeff_sharding, mc_sh),
                        out_shardings=(self._state_shardings, out_sh),
                        donate_argnums=0,
                    )
                c, n = blocks.shape[1], blocks.shape[2]
                mcycles = blocks.reshape(b // ratio, ratio, c, n)
                return self._scan_macro(state, coeffs, mcycles)
        if self._scan is None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            step_fn = self._step_fn

            def scan_fn(st, co, blks):
                def body(s, blk):
                    return step_fn(s, co, blk)
                return jax.lax.scan(body, st, blks)

            blocks_sh = NamedSharding(self.mesh, P(None, "c", None))
            self._scan = jax.jit(
                scan_fn,
                in_shardings=(self._state_shardings, self._coeff_sharding, blocks_sh),
                out_shardings=(self._state_shardings, blocks_sh),
                donate_argnums=0,
            )
        return self._scan(state, coeffs, blocks)

    def process_batch(self, state, coeffs, blocks) -> Tuple[cv.ConvolverState, jax.Array]:
        """Sharded bulk mode: B blocks per dispatch (core.convolver.
        process_batch) with channels sharded over "c" and the ring/coeffs
        over ("p", "c"). The block-axis FFT intermediates carry no partition
        axis, so the "p" shards only hold ring/coeff storage while "c"
        parallelizes the compute — the pod-scale layout of BASELINE
        config #5 (channels across hosts, partitions within).

        State representation: this engine's ``step`` keeps the ring in
        *rolled* layout while ``cv.process_batch`` uses the pointer layout;
        the jitted wrapper converts on entry and back on exit, so ``step``
        and ``process_batch`` interoperate freely on the same state.
        """
        if self.local_impl in ("hc", "nonuniform", "nonuniform3"):
            # these states have no pointer-layout complex equivalent; bulk
            # work goes through process_blocks (one scan dispatch)
            return self.process_blocks(state, coeffs, blocks)
        if self._batch is None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            def batch_fn(state, coeffs, blocks):
                st_ptr = cv.state_from_rolled(state)
                st_ptr, outs = cv.process_batch(st_ptr, coeffs, blocks)
                return cv.rolled_from_state(st_ptr), outs

            blocks_sh = NamedSharding(self.mesh, P(None, "c", None))
            self._batch = jax.jit(
                batch_fn,
                in_shardings=(self._state_shardings, self._coeff_sharding, blocks_sh),
                out_shardings=(self._state_shardings, blocks_sh),
                donate_argnums=0,
            )
        return self._batch(state, coeffs, blocks)


def dryrun(n_devices: Optional[int] = None, mesh: Optional[Mesh] = None) -> None:
    """Compile + execute one sharded step on tiny shapes over the given or
    default mesh. Used by __graft_entry__.dryrun_multichip."""
    m = mesh if mesh is not None else M.make_mesh(
        channel_shards=2 if (n_devices or 1) % 2 == 0 and (n_devices or 1) > 1 else 1,
        devices=jax.devices()[: n_devices] if n_devices else None,
    )
    c = 2 * m.shape["c"]
    p = 2 * m.shape["p"]
    spec = FilterSpec(block_length=128, n_partitions=p, dtype="float32")
    eng = ShardedEngine(spec, c, m)
    state = eng.init_state()
    rng = np.random.default_rng(0)
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32) * 0.05
    coeffs = eng.prepare_coeffs(h)
    out_all = []
    x = rng.standard_normal((c, 4 * spec.block_length)).astype(np.float32)
    for b in range(4):
        block = x[:, b * spec.block_length : (b + 1) * spec.block_length]
        state, out = eng.step(state, coeffs, block)
        out_all.append(np.asarray(out))
    y = np.concatenate(out_all, axis=1)
    # cross-check vs the single-device reference path
    st2 = cv.init_state(spec, c)
    co2 = cv.coeffs_to_spectra(h, spec)
    outs2 = []
    for b in range(4):
        st2, o2 = cv.step(st2, co2, x[:, b * spec.block_length : (b + 1) * spec.block_length])
        outs2.append(np.asarray(o2))
    y2 = np.concatenate(outs2, axis=1)
    err = float(np.max(np.abs(y - y2)))
    # tight f32 tolerance: on these tiny shapes any real sharding bug is a
    # gross error; 1e-5 leaves ~30x headroom over observed fp noise
    if err > 1e-5:
        raise AssertionError(f"sharded step diverged from single-device: {err}")
    # and the hc-local composition (the accelerator-default shard compute): same
    # mesh, packed halfcomplex state + Pallas MAC per shard
    eng_hc = ShardedEngine(spec, c, m, local_impl="hc")
    st_hc = eng_hc.init_state()
    co_hc = eng_hc.prepare_coeffs(h)
    outs_hc = []
    for b in range(2):
        block = x[:, b * spec.block_length : (b + 1) * spec.block_length]
        st_hc, o = eng_hc.step(st_hc, co_hc, block)
        outs_hc.append(np.asarray(o))
    err_hc = float(np.max(np.abs(np.concatenate(outs_hc, axis=1)
                                 - y2[:, : 2 * spec.block_length])))
    if err_hc > 1e-5:
        raise AssertionError(f"sharded hc step diverged: {err_hc}")
    # and the nonuniform-local composition (the pod form of the fastest
    # single-chip engine): two-stage geometry, head +
    # cadenced tail collectives, checked against the single-chip step_nu
    from bfir_tpu.core import nonuniform as NU

    n = spec.block_length
    p_shards = m.shape["p"]
    nuspec = NU.NuSpec(block_length=n, ratio=2, p_head=2 * 2 * p_shards,
                       p_tail=p_shards, dtype="float32")
    taps_nu = nuspec.max_taps
    spec_nu = FilterSpec(block_length=n, n_partitions=taps_nu // n,
                         dtype="float32")
    h_nu = rng.standard_normal((c, taps_nu)).astype(np.float32) * 0.05
    eng_nu = ShardedEngine(spec_nu, c, m, local_impl="nonuniform",
                           nuspec=nuspec)
    st_nu = eng_nu.init_state()
    co_nu = eng_nu.prepare_coeffs(h_nu)
    st_ref = NU.init_nu_state(eng_nu.nuspec, c)
    co_ref = NU.nu_coeffs(h_nu, eng_nu.nuspec, c)
    nblocks = 2 * eng_nu.nuspec.ratio + 1
    x_nu = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    err_nu = 0.0
    for b in range(nblocks):
        block = x_nu[:, b * n : (b + 1) * n]
        st_nu, o = eng_nu.step(st_nu, co_nu, block)
        st_ref, o_ref = NU.step_nu(st_ref, co_ref, block)
        err_nu = max(err_nu, float(np.max(np.abs(np.asarray(o)
                                                 - np.asarray(o_ref)))))
    if err_nu > 1e-4:
        raise AssertionError(f"sharded nonuniform step diverged: {err_nu}")
    # and the nonuniform3-local composition (the very-long-filter tier):
    # three stages at their own collective cadences,
    # checked against the single-chip step_nu3
    r1 = r2 = 2
    p_head3 = int(np.lcm(2 * r1, p_shards))
    p_head3i = int(np.lcm(2 * r2, p_shards))
    inner3 = NU.NuSpec(block_length=r1 * n, ratio=r2, p_head=p_head3i,
                       p_tail=p_shards, dtype="float32")
    spec3 = NU.Nu3Spec(block_length=n, ratio1=r1, p_head=p_head3,
                       inner=inner3)
    taps3 = spec3.max_taps
    spec_nu3 = FilterSpec(block_length=n, n_partitions=taps3 // n,
                          dtype="float32")
    h3 = rng.standard_normal((c, taps3)).astype(np.float32) * 0.05
    eng3 = ShardedEngine(spec_nu3, c, m, local_impl="nonuniform3",
                         nuspec=spec3)
    st3 = eng3.init_state()
    co3 = eng3.prepare_coeffs(h3)
    st3_ref = NU.init_nu3_state(eng3.nuspec, c)
    co3_ref = NU.nu3_coeffs(h3, eng3.nuspec, c)
    nblocks3 = 2 * r1 * r2 + 1
    x3 = rng.standard_normal((c, nblocks3 * n)).astype(np.float32)
    err3 = 0.0
    for b in range(nblocks3):
        block = x3[:, b * n : (b + 1) * n]
        st3, o = eng3.step(st3, co3, block)
        st3_ref, o_ref = NU.step_nu3(st3_ref, co3_ref, block)
        err3 = max(err3, float(np.max(np.abs(np.asarray(o)
                                             - np.asarray(o_ref)))))
    if err3 > 1e-4:
        raise AssertionError(f"sharded nonuniform3 step diverged: {err3}")
