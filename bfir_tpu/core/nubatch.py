"""G-cycle batched (bulk/offline) formulation of the two-stage engine.

Reimplements the overlap-save MAC law of the reference's convolver
(/root/reference/brutefir/fftw_convolver.cpp:1429-1525, coeffs2cbuf
partition layout fftw_convolver.cpp:336-466) on the non-uniform schedule of
``core.nonuniform`` — but as a *throughput* schedule: each ``lax.scan``
iteration consumes G whole M-cycles (G*R N-blocks) and runs every stage as
ONE batched dispatch instead of G*R (head) / G (tail) small ones.

In bulk mode every block of a scan iteration is known up front, so:

- all G*R head forward transforms run as one [G*R*C, 2N] ``rfft_split_hc``;
- the head MAC becomes a correlation along the BLOCK axis against an
  ordered spectrum history, with the [p_head, 2C, Hp] coefficient planes
  read once per G*R blocks instead of once per block;
- the tail stage batches the same way across the G M-cycles: one
  [G*C, 2M] forward, a p_tail-tap correlation along the cycle axis (tail
  coefficient planes — 59 MB f32 at the flagship geometry — read once per
  G fires), one batched inverse;
- both inverses run as one batched transform each.

The math is identical to R*G calls of ``step_nu`` from phase 0 (same
spectra, same MAC law incl. the lane-0 halfcomplex fixup, same overlap-save
tails), so outputs match ``process_blocks_nu_fast`` to f32 rounding;
``tests/test_nubatch.py`` asserts it and the scipy oracle. Streaming
latency modes (``step_nu``, the split-tail schedule) are untouched — this
is the offline/bulk path's engine.

State conversion is exact and cheap: ``nu_to_gbatch``/``gbatch_to_nu``
reorder the HcState rings into newest-last histories (a roll) at M-cycle
boundaries, so the bulk scan and the per-block step interchange freely.

Scope: float32/bfloat16 plane storage (integer-quantized rings/coeffs keep
the per-cycle macro path — the batched schedule already cuts more traffic
than the int tiers did, at full f32 SNR).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from bfir_tpu.ops import fft as F
from bfir_tpu.kernels import spectrum_mac as K
from bfir_tpu.utils import platform
from bfir_tpu.core.nonuniform import (
    NuCoeffs,
    NuSpec,
    NuState,
    _tail_inverse,
)


class NuGBatchState(NamedTuple):
    """Bulk-scan carry: ordered (newest-last) spectrum histories instead of
    position-indexed rings."""

    head_hist: jax.Array  # [p_head-1, 2C, Hp]
    prev_block: jax.Array  # [C, N]
    tail_hist: jax.Array  # [p_tail-1, 2C, Hpt]
    prev_mblock: jax.Array  # [C, M]
    pending: jax.Array  # [D-1, C, M] tail outputs awaiting consumption
    counter: jax.Array  # N-blocks processed


def _require_float(coeffs: NuCoeffs, state: NuState):
    for plane in (coeffs.head, coeffs.tail, state.head.ring,
                  state.tail.ring):
        if isinstance(plane, K.IntPlanes):
            raise ValueError(
                "the G-batched bulk scan supports float plane storage only "
                "(int16/int24 tiers keep process_blocks_nu_fast)")


def nu_to_gbatch(state: NuState) -> NuGBatchState:
    """Reorder ring slots (slot = blockcounter mod P) into newest-last
    histories. Valid at any M-cycle boundary; the roll is exact for any
    counter value."""
    h = state.head
    t = state.tail
    p_h = h.ring.shape[0]
    p_t = t.ring.shape[0]
    # ring slot of block g is g mod P; hist[j] must hold block
    # counter-(P-1)+j, whose slot is (counter+1+j) mod P =>
    # hist = roll(ring, -(counter+1))[:P-1] (the dropped last element is
    # the slot of block counter-P, overwritten by the next insert)
    head_hist = jnp.roll(h.ring, -(h.blockcounter + 1), axis=0)[:p_h - 1]
    tail_hist = jnp.roll(t.ring, -(t.blockcounter + 1), axis=0)[:p_t - 1]
    return NuGBatchState(
        head_hist=head_hist,
        prev_block=h.prev_block,
        tail_hist=tail_hist,
        prev_mblock=state.inbuf,
        pending=state.pending,
        counter=h.blockcounter,
    )


def gbatch_to_nu(gb: NuGBatchState) -> NuState:
    """Inverse of ``nu_to_gbatch``: scatter the histories back into
    position-indexed rings (the slot about to be overwritten is zero-filled
    — the per-block step never reads it before inserting)."""
    p_h = gb.head_hist.shape[0] + 1
    p_t = gb.tail_hist.shape[0] + 1
    n = gb.prev_block.shape[-1]
    m = gb.prev_mblock.shape[-1]
    ratio = m // n
    mcounter = gb.counter // ratio
    head_ring = jnp.roll(
        jnp.concatenate([jnp.zeros((1,) + gb.head_hist.shape[1:],
                                   gb.head_hist.dtype), gb.head_hist]),
        gb.counter, axis=0)
    tail_ring = jnp.roll(
        jnp.concatenate([jnp.zeros((1,) + gb.tail_hist.shape[1:],
                                   gb.tail_hist.dtype), gb.tail_hist]),
        mcounter, axis=0)
    return NuState(
        head=K.HcState(head_ring, gb.prev_block, gb.counter),
        tail=K.HcState(tail_ring, gb.prev_mblock, mcounter),
        inbuf=gb.prev_mblock,
        pending=gb.pending,
    )


def _batch_spectrum(blocks, prev, hp):
    """Batched overlap-save forward: blocks [B, C, W] plus the carried
    previous block -> packed halfcomplex spectra [B, 2C, hp]
    (_hc_frame_spectrum semantics, one [B*C, 2W] transform)."""
    b, c, w = blocks.shape
    xprev = jnp.concatenate([prev[None], blocks[:-1]], axis=0)
    frames = jnp.concatenate([xprev, blocks], axis=-1).reshape(b * c, 2 * w)
    hr, hi = F.rfft_split_hc(frames)
    pad = hp - hr.shape[-1]
    if pad:
        hr = jnp.pad(hr, ((0, 0), (0, pad)))
        hi = jnp.pad(hi, ((0, 0), (0, pad)))
    return jnp.concatenate(
        [hr.reshape(b, c, hp), hi.reshape(b, c, hp)], axis=1)


def _corr_mac(hist, coeff, nblocks: int):
    """Correlation MAC along the leading (block) axis: out[b] =
    sum_p coeff[p] (*) hist[P-1+b-p] with the halfcomplex lane-0 fixup of
    ``mac_reference_hc`` (two real products at lane 0: DC.re / Nyquist.re).
    ``hist`` [P-1+nblocks, 2C, Hp] newest-last; coeff [P, 2cs, Hp]
    (cs = C, or 1 for shared filters). XLA fuses the P shifted multiplies
    and the sum into one elementwise pass."""
    p = coeff.shape[0]
    cs = coeff.shape[1] // 2
    c = hist.shape[1] // 2
    acc_dt = hist.dtype if hist.dtype != jnp.bfloat16 else jnp.float32
    ar = jnp.zeros((nblocks, c, hist.shape[2]), acc_dt)
    ai = jnp.zeros_like(ar)
    for q in range(p):
        w = jax.lax.slice_in_dim(hist, p - 1 - q, p - 1 - q + nblocks,
                                 axis=0).astype(acc_dt)
        wr, wi = w[:, :c], w[:, c:]
        cr = coeff[q, :cs].astype(acc_dt)
        ci = coeff[q, cs:].astype(acc_dt)
        p1 = cr * wr
        p2 = ci * wi
        dr = p1 - p2
        di = cr * wi + ci * wr
        # lane 0 carries (DC.re, Nyquist.re): two independent real products
        dr = jnp.concatenate([p1[..., :1], dr[..., 1:]], axis=-1)
        di = jnp.concatenate([p2[..., :1], di[..., 1:]], axis=-1)
        ar = ar + dr
        ai = ai + di
    return ar, ai


def _mac(hist, coeff, nblocks: int):
    """The correlation MAC by the route ``utils.platform.corr_mac_route``
    names: the Triton kernel (``kernels.corr_mac``) or the fused XLA form."""
    if platform.corr_mac_route() == "triton":
        from bfir_tpu.kernels.corr_mac import corr_mac_triton

        return corr_mac_triton(hist, coeff, nblocks)
    return _corr_mac(hist, coeff, nblocks)


def step_nu_gbatch(
    gb: NuGBatchState,
    coeffs: NuCoeffs,
    blocks: jax.Array,
    ratio: int,
) -> Tuple[NuGBatchState, jax.Array]:
    """Process G*R N-blocks ([GR, C, N], M-cycle aligned) in one batched
    pass; returns (state', outputs [GR, C, N])."""
    gr, c, n = blocks.shape
    if gr % ratio:
        raise ValueError(f"block count {gr} not a multiple of R={ratio}")
    g = gr // ratio
    m = gb.prev_mblock.shape[-1]
    hp_h = gb.head_hist.shape[-1]
    hp_t = gb.tail_hist.shape[-1]

    # ---- head: one forward, one correlation MAC, one inverse ----
    xpk = _batch_spectrum(blocks, gb.prev_block, hp_h)
    fh = jnp.concatenate([gb.head_hist.astype(xpk.dtype), xpk], axis=0)
    ar, ai = _mac(fh, coeffs.head, gr)
    y_head = F.irfft_hc_tail(
        ar.reshape(gr * c, hp_h), ai.reshape(gr * c, hp_h),
        n=2 * n).reshape(gr, c, n)

    # ---- tail: the same schedule across the G M-cycles ----
    mblocks = (blocks.reshape(g, ratio, c, n)
               .transpose(0, 2, 1, 3).reshape(g, c, m))
    txpk = _batch_spectrum(mblocks, gb.prev_mblock, hp_t)
    th = jnp.concatenate([gb.tail_hist.astype(txpk.dtype), txpk], axis=0)
    br, bi = _mac(th, coeffs.tail, g)
    z = _tail_inverse(
        br.reshape(g * c, hp_t), bi.reshape(g * c, hp_t), m).reshape(g, c, m)

    # ---- combine: cycle j consumes the tail output queued for it ----
    pend = gb.pending
    feeds = []
    for j in range(g):
        feeds.append(pend[0])
        pend = jnp.concatenate([pend[1:], z[j][None]], axis=0)
    zfeed = jnp.stack(feeds)  # [G, C, M]
    outs = (y_head.reshape(g, ratio, c, n)
            + zfeed.reshape(g, c, ratio, n).transpose(0, 2, 1, 3))

    gb2 = NuGBatchState(
        head_hist=jax.lax.slice_in_dim(
            fh, fh.shape[0] - (gb.head_hist.shape[0]), fh.shape[0],
            axis=0).astype(gb.head_hist.dtype),
        prev_block=blocks[-1].astype(gb.prev_block.dtype),
        tail_hist=jax.lax.slice_in_dim(
            th, th.shape[0] - (gb.tail_hist.shape[0]), th.shape[0],
            axis=0).astype(gb.tail_hist.dtype),
        prev_mblock=mblocks[-1].astype(gb.prev_mblock.dtype),
        pending=pend,
        counter=gb.counter + gr,
    )
    return gb2, outs.reshape(gr, c, n)


def process_blocks_nu_gbatch(
    state: NuState,
    coeffs: NuCoeffs,
    blocks: jax.Array,
    cycles_per_step: int = 4,
) -> Tuple[NuState, jax.Array]:
    """Bulk path: lax.scan of ``step_nu_gbatch`` over super-iterations of
    G = ``cycles_per_step`` M-cycles. ``blocks`` [B, C, N] with B a
    multiple of G*R and ``state`` at an M-cycle boundary (caller-checked
    host-side like ``process_blocks_nu_fast``). Returns (NuState, out)
    interchangeable with the per-block engines."""
    b, c, n = blocks.shape
    ratio = state.inbuf.shape[-1] // n
    gr = cycles_per_step * ratio
    if b % gr:
        raise ValueError(
            f"block count {b} not a multiple of G*R={gr} "
            f"(G={cycles_per_step}, R={ratio})")
    _require_float(coeffs, state)
    gb = nu_to_gbatch(state)
    chunks = blocks.reshape(b // gr, gr, c, n)

    def body(st, ch):
        return step_nu_gbatch(st, coeffs, ch, ratio)

    gb, ys = jax.lax.scan(body, gb, chunks)
    return gbatch_to_nu(gb), ys.reshape(b, c, n)
