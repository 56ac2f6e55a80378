"""Non-uniform (two-stage) partitioned convolution: the streaming engine's
memory-traffic breaker.

The uniform engine (reference: brutefir.cpp:244-343, one partition size =
one block) reads the whole ring + coefficient set every block: at the
flagship geometry (64 ch x 131072 taps, N=1024, P=128) that is ~134 MB per
1024-sample block, so its streaming floor is that traffic at device-memory
bandwidth. The reference cannot
cheapen this: its per-block MAC loop (convolve_add, fftw_convolver.cpp:
1429-1525) touches every partition every block by construction.

This module implements the classical two-stage non-uniform partition
schedule (Gardner, "Efficient convolution without input-output delay",
JAES 43(3) 1995 — the standard low-latency convolution optimization the
reference never adopted): a small *head* engine at the streaming block size
N covers the first taps, and a *tail* engine with partition size M = R*N
covers the rest, running once every R blocks. Per-block amortized traffic
drops ~4x at the flagship geometry (head 16 partitions at N + tail at M
touched 1/R as often) with the SAME input->output latency N: the tail's
first tap starts at offset D*M (D >= 2), so its contribution to an output
block is computable R blocks before it is needed.

Scheduling invariant (the correctness core): with the tail covering taps
[D*M, D*M + P_tail*M) and a uniform overlap-save engine over M-blocks,
tail output z[k] (computed the moment input M-block k completes) is the
tail's contribution to output M-block k + D. z values wait in a [D, C, M]
pending queue; phase r = blockcounter mod R consumes slice r of
pending[0]. Warm-up falls out naturally: the queue starts zeroed and the
head covers all taps an output can touch before the first z lands.

Everything is static-shape and cond/scan-friendly: one jitted step serves
every phase (the tail MAC runs under ``lax.cond`` on phase R-1), so the
step compiles once and streams like the uniform engines.

Latency shape: per-block cost of ``step_nu`` is uneven by construction —
the phase-R-1 block additionally runs the whole tail fire. Real-time
budget per 1024-sample block at 44.1 kHz is 23.2 ms, so the spike is a
few percent of budget; where a tighter per-block bound matters, the
SPLIT-TAIL schedule below (``step_nu_split``) spreads the fire across its
R-block slack (same amortized floor, near-uniform phases — per-phase
differential timings in benchmarks/phase_latency.py, reported by bench.py
each round).

Storage tiers: the tail (and optionally head) ring+coefficient planes can
be stored as block-scaled integers — ``tail_store="int24"`` keeps >=125 dB
at 3 B/elem, ``"int16"`` is the halved-traffic ~86 dB tier (which one
``nu_tail_store="auto"`` picks is ``utils.platform.default_tail_store``);
see benchmarks/storage_snr.py for the
measured precision/traffic frontier and NuSpec.tail_store for the class
documentation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.kernels import spectrum_mac as K
from bfir_tpu.ops import fft as F


@dataclass(frozen=True)
class NuSpec:
    """Two-stage geometry. ``block_length``/``dtype`` as FilterSpec; the
    head runs ``p_head`` partitions at N, the tail ``p_tail`` partitions at
    M = ratio*N starting at tap offset p_head*N (which must be an integer
    multiple D >= 2 of M — the scheduling slack)."""

    block_length: int = 1024
    ratio: int = 8
    p_head: int = 16
    p_tail: int = 14
    dtype: str = "float32"
    # storage dtype for the TAIL stage's ring + coefficient planes; the
    # MAC always accumulates in f32 — only the stored/streamed bytes
    # change. Tiers (measured frontier: benchmarks/storage_snr.py):
    #   "float32"  4 B/elem, full precision (default)
    #   "int24"    3 B/elem (int16+int8+per-row scale), ~134 dB MAC SNR —
    #              the cheapest storage keeping >= 125 dB; -25% MAC traffic
    #   "int16"    2 B/elem, ~86 dB — the halved-traffic point (>=125 dB at
    #              2 B/elem is not physically reachable; see the artifact)
    #   "bfloat16" 2 B/elem, ~56 dB + the tail's energy deficit — the
    #              legacy fast tier, dominated by int16 at equal bytes
    tail_store: str = "float32"
    # storage for the HEAD stage's ring + coefficient planes (same tiers,
    # no bfloat16 — the head carries the signal's leading energy). The head
    # ring quantizes one [2C, Hp_head] slot per block (a ~1.4 MB encode at
    # the flagship geometry) and is then read by all p_head partitions, so
    # the encode amortizes p_head ways.
    head_store: str = "float32"

    def __post_init__(self):
        if self.tail_store not in ("float32", "bfloat16", "int16", "int24"):
            raise ValueError(
                "tail_store must be float32/bfloat16/int16/int24, "
                f"got {self.tail_store!r}")
        if self.head_store not in ("float32", "int16", "int24"):
            raise ValueError(
                "head_store must be float32/int16/int24, "
                f"got {self.head_store!r}")
        if self.ratio < 2 or (self.ratio & (self.ratio - 1)):
            raise ValueError(f"ratio must be a power of two >= 2, got {self.ratio}")
        if self.p_head % self.ratio:
            raise ValueError(
                f"p_head ({self.p_head}) must be a multiple of ratio ({self.ratio})"
            )
        if self.delay_blocks < 2:
            raise ValueError(
                "head must cover >= 2 tail partitions of taps (D >= 2): "
                f"p_head={self.p_head}, ratio={self.ratio}"
            )
        if self.p_tail < 1:
            raise ValueError(f"p_tail must be >= 1, got {self.p_tail}")

    @property
    def m(self) -> int:
        """Tail partition / tail block size."""
        return self.ratio * self.block_length

    @property
    def delay_blocks(self) -> int:
        """D: tail-output delay in M-blocks (= head taps / M)."""
        return self.p_head // self.ratio

    @property
    def max_taps(self) -> int:
        return self.p_head * self.block_length + self.p_tail * self.m

    @property
    def head_spec(self) -> FilterSpec:
        return FilterSpec(self.block_length, self.p_head, self.dtype)

    @property
    def tail_spec(self) -> FilterSpec:
        return FilterSpec(self.m, self.p_tail, self.dtype)

    @property
    def traffic_bytes_per_block(self) -> int:
        """Amortized MAC HBM bytes per N-block (ring+coeff, both stages) —
        the number the uniform engine pays P/(p_head + p_tail/R) times
        over."""
        sizes = {"float32": 4, "bfloat16": 2, "int16": 2, "int24": 3}
        it_head = sizes[self.head_store]
        it_tail = sizes[self.tail_store]
        head = 2 * self.p_head * 2 * self.block_length * it_head
        tail = 2 * self.p_tail * 2 * self.m * it_tail // self.ratio
        return (head + tail)  # per channel


def nu_geometry(taps: int, block_length: int = 1024, ratio: int = 8,
                dtype: str = "float32",
                tail_store: str = "float32",
                head_store: str = "float32") -> NuSpec:
    """Pick a two-stage geometry covering ``taps``: minimal head (D=2) and
    however many M-partitions the remainder needs."""
    p_head = 2 * ratio
    m = ratio * block_length
    rest = max(0, taps - p_head * block_length)
    p_tail = max(1, -(-rest // m))
    return NuSpec(block_length, ratio, p_head, p_tail, dtype, tail_store,
                  head_store)


class NuState(NamedTuple):
    """Streaming state: the two engine states plus the M-block input
    accumulator and the pending tail-output queue (pending[0] is the
    M-block being consumed now; pending[-1] the most recent z)."""

    head: K.HcState
    tail: K.HcState
    inbuf: jax.Array  # [C, M]
    pending: jax.Array  # [D, C, M]


def init_nu_state(spec: NuSpec, n_channels: int) -> NuState:
    dt = jnp.dtype(spec.dtype)
    head = K.init_hc_state(spec.head_spec, n_channels)
    if spec.head_store in ("int16", "int24"):
        p, c2, hp = head.ring.shape
        head = head._replace(ring=K.IntPlanes(
            hi=jnp.zeros((p, c2, hp), jnp.int16),
            lo=(jnp.zeros((p, c2, hp), jnp.uint8)
                if spec.head_store == "int24" else None),
            scale=jnp.full((p, c2, 128), 1e-30, jnp.float32)))
    tail = K.init_hc_state(spec.tail_spec, n_channels)
    if spec.tail_store == "bfloat16":
        tail = tail._replace(ring=tail.ring.astype(jnp.bfloat16))
    elif spec.tail_store in ("int16", "int24"):
        p, c2, hp = tail.ring.shape
        tail = tail._replace(ring=K.IntPlanes(
            hi=jnp.zeros((p, c2, hp), jnp.int16),
            lo=(jnp.zeros((p, c2, hp), jnp.uint8)
                if spec.tail_store == "int24" else None),
            scale=jnp.full((p, c2, 128), 1e-30, jnp.float32)))
    return NuState(
        head=head,
        tail=tail,
        inbuf=jnp.zeros((n_channels, spec.m), dtype=dt),
        pending=jnp.zeros((spec.delay_blocks, n_channels, spec.m), dtype=dt),
    )


class NuCoeffs(NamedTuple):
    head: jax.Array  # [p_head, 2C, Hp_head]
    tail: jax.Array  # [p_tail, 2C, Hp_tail]


def nu_coeffs(impulse, spec: NuSpec, n_channels: int, scale: float = 1.0,
              precise: bool = False, shared: bool = False) -> NuCoeffs:
    """Split the impulse at the head/tail boundary and build each stage's
    packed halfcomplex coefficient spectra (kernels.spectrum_mac.hc_coeffs
    semantics, including ``precise`` f64 build and ``shared``
    one-filter-for-all-channels planes)."""
    h = jnp.asarray(impulse)
    if h.ndim == 1:
        h = h[None, :]
    if h.shape[-1] > spec.max_taps:
        # mirror session._select_impl's explicit short-filter error: silent
        # truncation would drop filter tail energy for direct library callers
        # (the session always sizes the geometry via nu_geometry first)
        raise ValueError(
            f"impulse ({h.shape[-1]} taps) exceeds the geometry's "
            f"max_taps ({spec.max_taps}); enlarge p_tail (nu_geometry does)")
    t1 = spec.p_head * spec.block_length
    taps = h.shape[-1]
    head_imp = h[:, : min(taps, t1)]
    tail_imp = h[:, t1:] if taps > t1 else jnp.zeros((h.shape[0], 1), h.dtype)
    tail = K.hc_coeffs(tail_imp, spec.tail_spec, n_channels, scale, precise,
                       shared=shared)
    if spec.tail_store == "bfloat16":
        tail = tail.astype(jnp.bfloat16)
    elif spec.tail_store in ("int16", "int24"):
        tail = K.quantize_planes(tail, 24 if spec.tail_store == "int24"
                                 else 16)
    head = K.hc_coeffs(head_imp, spec.head_spec, n_channels, scale, precise,
                       shared=shared)
    if spec.head_store in ("int16", "int24"):
        head = K.quantize_planes(head, 24 if spec.head_store == "int24"
                                 else 16)
    return NuCoeffs(
        head=head,
        tail=tail,
    )


def _tail_inverse(yr, yi, m: int):
    """Overlap-save inverse for an M-block tail fire: the inverse transform
    of the 2M frame, keeping its upper half."""
    return F.irfft_split_hc(yr, yi, n=2 * m)[..., m:]


def _ring_shape(ring):
    """Shape of a tail ring in either representation."""
    return ring.hi.shape if isinstance(ring, K.IntPlanes) else ring.shape


def _ring_insert(ring, xpk, pos):
    """Insert the new packed spectrum [2C, Hp] at slot ``pos`` — f32/bf16
    rings store it directly; int-stored rings quantize the slot's rows
    (per-row block scale) and update the hi/lo/scale planes."""
    zero = jnp.zeros((), dtype=pos.dtype)
    if not isinstance(ring, K.IntPlanes):
        return jax.lax.dynamic_update_slice(
            ring, xpk[None].astype(ring.dtype), (pos, zero, zero))
    q = K.quantize_planes(xpk, 16 if ring.lo is None else 24)
    hi = jax.lax.dynamic_update_slice(ring.hi, q.hi[None], (pos, zero, zero))
    lo = (None if ring.lo is None else jax.lax.dynamic_update_slice(
        ring.lo, q.lo[None], (pos, zero, zero)))
    scale = jax.lax.dynamic_update_slice(ring.scale, q.scale[None],
                                         (pos, zero, zero))
    return K.IntPlanes(hi=hi, lo=lo, scale=scale)


def _tail_step(state: K.HcState, coeff_pk, mblock):
    """One overlap-save step of the tail engine on an M-block. Same math as
    kernels.spectrum_mac.step_hc, with the inverse always taken as a full
    transform + slice: at M = 8192 a dense [Hp, Hp] half-DFT tail basis
    (``ops.fft.irfft_hc_tail`` in matmul mode) would be a 256 MB operand."""
    p, c2, hp = _ring_shape(state.ring)
    m = mblock.shape[-1]
    mblock, xpk = K._hc_frame_spectrum(state, mblock, hp)
    pos = jnp.mod(state.blockcounter, p)
    ring = _ring_insert(state.ring, xpk, pos)
    yr, yi = K.mac_hc(ring, coeff_pk, pos)
    out = _tail_inverse(yr, yi, m)
    return K.HcState(ring, mblock, state.blockcounter + 1), out


def step_nu(
    state: NuState,
    coeffs: NuCoeffs,
    block: jax.Array,
    phase=None,
) -> Tuple[NuState, jax.Array]:
    """One N-block through the two-stage engine. Outputs match the uniform
    engine (step_hc at P = p_head + ratio*p_tail) to fp rounding; amortized
    memory traffic is ~4x lower at the flagship geometry.

    Every phase compiles into the same step: the tail engine fires under
    ``lax.cond`` on phase R-1 (both branches static-shape), so a
    ``lax.scan`` over blocks streams exactly like the uniform engines.
    ``phase``: a static int pins the fire/hold decision at trace time (no
    cond — used by the per-phase latency benchmark); None keeps the
    dynamic cond."""
    n = block.shape[-1]
    ratio = state.inbuf.shape[-1] // n
    r_phase = (jnp.mod(state.head.blockcounter, ratio) if phase is None
               else phase)

    head, y_head = _head_step(state.head, coeffs.head, block)

    zero = jnp.zeros((), dtype=jnp.int32)
    off = (r_phase * n if phase is None
           else jnp.asarray(phase * n, dtype=jnp.int32))
    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, block.astype(state.inbuf.dtype), (zero, off))

    c = state.inbuf.shape[0]
    tail_slice = jax.lax.dynamic_slice(
        state.pending[0], (zero, off), (c, n))

    def fire(args):
        tail, pending, inbuf = args
        tail, z = _tail_step(tail, coeffs.tail, inbuf)
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return tail, pending

    def hold(args):
        tail, pending, _ = args
        return tail, pending

    if phase is None:
        tail, pending = jax.lax.cond(
            r_phase == ratio - 1, fire, hold,
            (state.tail, state.pending, inbuf))
    elif phase == ratio - 1:
        tail, pending = fire((state.tail, state.pending, inbuf))
    else:
        tail, pending = hold((state.tail, state.pending, inbuf))

    out = y_head + tail_slice
    return NuState(head, tail, inbuf, pending), out


def _head_step(state: K.HcState, coeff, block):
    """Head-stage step: the plain hc step for float-stored heads, or the
    int-stored variant (quantizing ring insert + decoding MAC +
    direct half-DFT tail) for NuSpec.head_store int16/int24."""
    if not isinstance(coeff, K.IntPlanes):
        return K.step_hc(state, coeff, block)
    p, c2, hp = _ring_shape(state.ring)
    n = block.shape[-1]
    block, xpk = K._hc_frame_spectrum(state, block, hp)
    pos = jnp.mod(state.blockcounter, p)
    ring = _ring_insert(state.ring, xpk, pos)
    yr, yi = K.mac_hc(ring, coeff, pos)
    out = F.irfft_hc_tail(yr.astype(block.dtype), yi.astype(block.dtype),
                          n=2 * n)
    return K.HcState(ring, block, state.blockcounter + 1), out


def _tail_step2(state: K.HcState, coeff_a, coeff_b, mblock):
    """Tail step with ONE ring advance and TWO coefficient MACs — the
    transition fire of a live filter change (see step_nu_crossfade)."""
    p, c2, hp = _ring_shape(state.ring)
    m = mblock.shape[-1]
    mblock, xpk = K._hc_frame_spectrum(state, mblock, hp)
    pos = jnp.mod(state.blockcounter, p)
    ring = _ring_insert(state.ring, xpk, pos)
    ya = K.mac_hc(ring, coeff_a, pos)
    yb = K.mac_hc(ring, coeff_b, pos)
    za = _tail_inverse(ya[0], ya[1], m)
    zb = _tail_inverse(yb[0], yb[1], m)
    return K.HcState(ring, mblock, state.blockcounter + 1), za, zb


def step_nu_crossfade(
    state: NuState,
    coeffs_old: NuCoeffs,
    coeffs_new: NuCoeffs,
    block: jax.Array,
    head_ramp: bool = True,
) -> Tuple[NuState, jax.Array]:
    """Glitch-free live filter change on the two-stage engine.

    The change morphs head-first, each stage bridging at its own natural
    boundary so the output stays continuous throughout
    (convolver_crossfade_inplace's law, fftw_convolver.cpp:275-321, applied
    per stage):

    - head: two MACs + a linear intra-block ramp on the change block
      (``head_ramp=True``); later blocks run the new head coefficients.
    - tail: in-flight pending M-blocks were computed with the old
      coefficients and stay untouched (they are the *continuation* of the
      old-filter signal). The FIRST tail fire after the change computes the
      M-block with BOTH coefficient sets (one ring advance, two MACs) and
      stores a full-M linear ramp old->new: its start is continuous with
      the last old pending block, its end with the pure-new fires that
      follow. One extra tail MAC total per reconfigure.

    The caller keeps feeding blocks through this function (head_ramp=False
    after the first) until a fire has occurred — i.e. until a block with
    phase R-1 has passed — then returns to ``step_nu`` with the new
    coefficients. ``engine.session`` drives exactly that sequence."""
    n = block.shape[-1]
    c = state.inbuf.shape[0]
    ratio = state.inbuf.shape[-1] // n
    r_phase = jnp.mod(state.head.blockcounter, ratio)

    if head_ramp:
        # two head MACs + intra-block ramp (step_hc_crossfade's law, with
        # the same MAC selection as step_nu)
        p, c2, hp = _ring_shape(state.head.ring)
        blk, xpk = K._hc_frame_spectrum(state.head, block, hp)
        pos = jnp.mod(state.head.blockcounter, p)
        ring = _ring_insert(state.head.ring, xpk, pos)
        yo = K.mac_hc(ring, coeffs_old.head, pos)
        yn = K.mac_hc(ring, coeffs_new.head, pos)
        out_o = F.irfft_hc_tail(yo[0].astype(blk.dtype),
                                yo[1].astype(blk.dtype), n=2 * n)
        out_n = F.irfft_hc_tail(yn[0].astype(blk.dtype),
                                yn[1].astype(blk.dtype), n=2 * n)
        ramp = jnp.arange(n, dtype=out_o.dtype) / (n - 1)
        y_head = out_o * (1.0 - ramp) + out_n * ramp
        head = K.HcState(ring, blk, state.head.blockcounter + 1)
    else:
        head, y_head = _head_step(state.head, coeffs_new.head, block)

    zero = jnp.zeros((), dtype=r_phase.dtype)
    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, block.astype(state.inbuf.dtype), (zero, r_phase * n))
    tail_slice = jax.lax.dynamic_slice(
        state.pending[0], (zero, r_phase * n), (c, n))

    def fire(args):
        tail, pending, inbuf = args
        tail, z_old, z_new = _tail_step2(tail, coeffs_old.tail,
                                         coeffs_new.tail, inbuf)
        m = z_old.shape[-1]
        ramp_m = jnp.arange(m, dtype=z_old.dtype) / (m - 1)
        z = z_old * (1.0 - ramp_m) + z_new * ramp_m
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return tail, pending

    def hold(args):
        tail, pending, _ = args
        return tail, pending

    tail, pending = jax.lax.cond(
        r_phase == ratio - 1, fire, hold, (state.tail, state.pending, inbuf))

    out = y_head + tail_slice
    return NuState(head, tail, inbuf, pending), out


def step_nu_macro(
    state: NuState,
    coeffs: NuCoeffs,
    mblocks: jax.Array,
) -> Tuple[NuState, jax.Array]:
    """One full M-cycle (R consecutive N-blocks, ``mblocks`` [R, C, N]) with
    STATIC phases: the R head steps unroll, pending-queue slices are static,
    and the tail fires unconditionally at the end — no ``lax.cond`` at all.

    Identical state evolution and outputs to R calls of ``step_nu`` from
    phase 0 (the per-block path and this one are freely interchangeable at
    M-cycle boundaries). This is the throughput formulation: carrying the
    tail state through a per-block cond makes XLA materialize the untaken
    branch's pass-through as a copy of the ~60 MB tail ring every block,
    which erases the traffic advantage the two-stage schedule exists for.
    Requires ``state`` to be at phase 0 (asserted by the caller)."""
    r, c, n = mblocks.shape
    head = state.head
    outs = []
    for i in range(r):  # static unroll: phase is a python int
        head, y = _head_step(head, coeffs.head, mblocks[i])
        outs.append(y + state.pending[0][:, i * n:(i + 1) * n])
    inbuf = jnp.swapaxes(mblocks, 0, 1).reshape(c, r * n).astype(state.inbuf.dtype)
    tail, z = _tail_step(state.tail, coeffs.tail, inbuf)
    pending = jnp.concatenate([state.pending[1:], z[None]], axis=0)
    return (NuState(head, tail, inbuf, pending),
            jnp.stack(outs))


def process_blocks_nu(state: NuState, coeffs: NuCoeffs, blocks: jax.Array):
    """lax.scan of the per-block step over blocks [B, C, N] -> (state, out
    [B, C, N]). Valid from any phase. For M-cycle-aligned bulk streams
    prefer ``process_blocks_nu_fast`` (cond-free macro step; same outputs,
    no per-block tail-state pass-through)."""

    def body(st, blk):
        st, y = step_nu(st, coeffs, blk)
        return st, y

    return jax.lax.scan(body, state, blocks)


def process_blocks_nu_fast(state: NuState, coeffs: NuCoeffs,
                           blocks: jax.Array):
    """lax.scan of the macro step over M-cycles: blocks [B, C, N] with B a
    multiple of R, and ``state`` MUST be at phase 0 (caller-checked:
    ``int(state.head.blockcounter) % R == 0`` — engine/session and bench do
    this host-side to avoid compiling both formulations under a cond)."""
    b, c, n = blocks.shape
    ratio = state.inbuf.shape[-1] // n
    if b % ratio:
        raise ValueError(f"block count {b} not a multiple of R={ratio}")
    mcycles = blocks.reshape(b // ratio, ratio, c, n)

    def mbody(st, mb):
        st, y = step_nu_macro(st, coeffs, mb)
        return st, y

    st, ys = jax.lax.scan(mbody, state, mcycles)
    return st, ys.reshape(b, c, n)


# ---------------------------------------------------------------------------
# Split-tail schedule: the per-block latency smoother.
#
# step_nu's cost is uneven by construction: phase R-1 runs the whole tail
# fire (forward M-transform + full tail MAC + inverse). The tail output has
# R blocks of scheduling slack (D >= 2 guarantees a full M-cycle between an
# M-block completing and its tail contribution being consumed), so the fire
# can be SPREAD across the following cycle:
#
#   phase 0:      forward M-transform of the completed M-block + ring insert
#   phase r:      frequency band r of the tail MAC — all partitions, one
#                 Hp/R slice of the spectrum, written once into a carried
#                 accumulator (banding by FREQUENCY instead of partitions
#                 means no accumulator read-modify-write)
#   phase R-1:    last band + the inverse transform; z is appended to a
#                 pending queue of depth D-1 (one less than step_nu's: the
#                 append happens one cycle later, so the queue is one
#                 shorter — same consumption schedule, invariant preserved:
#                 z[k] appended at cycle k+1 reaches pending[0] for cycle
#                 k+D exactly as before).
#
# Amortized cost and SNR are unchanged (same arithmetic per M-cycle; the
# banded MAC accumulates partitions per bin in the same order as the full
# MAC). Outputs are identical to step_nu up to fp rounding. Per-phase
# device times: benchmarks/phase_latency.py.
# ---------------------------------------------------------------------------


class NuSplitState(NamedTuple):
    """Split-tail streaming state: the two engine states plus the banded
    MAC accumulator and a depth-(D-1) pending queue."""

    head: K.HcState
    tail: K.HcState
    acc_r: jax.Array  # [C, Hp_t] f32 banded-MAC accumulator
    acc_i: jax.Array
    inbuf: jax.Array  # [C, M]
    pending: jax.Array  # [D-1, C, M]


def split_band_len(spec: NuSpec) -> int:
    """Frequency band per phase; the geometry must split evenly into
    128-lane-aligned bands (true for every power-of-two geometry the
    session builds: Hp = M = ratio*N with N >= 128)."""
    hp = -(-spec.m // 128) * 128
    if hp % (spec.ratio * 128):
        raise ValueError(
            f"split-tail needs Hp ({hp}) divisible into {spec.ratio} "
            "128-lane-aligned bands")
    return hp // spec.ratio


def init_nu_split_state(spec: NuSpec, n_channels: int) -> NuSplitState:
    dt = jnp.dtype(spec.dtype)
    hp_t = -(-spec.m // 128) * 128
    split_band_len(spec)  # geometry check
    if spec.head_store != "float32":
        raise ValueError(
            "split-tail schedule supports integer storage on the TAIL only "
            "(the head runs the plain hc step); set head_store='float32'")
    tail = K.init_hc_state(spec.tail_spec, n_channels)
    if spec.tail_store == "bfloat16":
        tail = tail._replace(ring=tail.ring.astype(jnp.bfloat16))
    elif spec.tail_store in ("int16", "int24"):
        p, c2, hp = tail.ring.shape
        tail = tail._replace(ring=K.IntPlanes(
            hi=jnp.zeros((p, c2, hp), jnp.int16),
            lo=(jnp.zeros((p, c2, hp), jnp.uint8)
                if spec.tail_store == "int24" else None),
            scale=jnp.full((p, c2, 128), 1e-30, jnp.float32)))
    # accumulate in f32 for f32/bf16 engines, in the engine dtype otherwise
    acc_dt = jnp.float32 if dt == jnp.float32 else dt
    return NuSplitState(
        head=K.init_hc_state(spec.head_spec, n_channels),
        tail=tail,
        acc_r=jnp.zeros((n_channels, hp_t), acc_dt),
        acc_i=jnp.zeros((n_channels, hp_t), acc_dt),
        inbuf=jnp.zeros((n_channels, spec.m), dtype=dt),
        pending=jnp.zeros((max(1, spec.delay_blocks - 1), n_channels, spec.m),
                          dtype=dt),
    )


def _split_band_mac(ring, coeff, pos, band: int, band_len: int):
    if isinstance(ring, K.IntPlanes):
        return K.mac_reference_hc_band_int(ring, coeff, pos,
                                           band * band_len, band_len)
    return K.mac_reference_hc_band(ring, coeff, pos, band * band_len,
                                   band_len)


def _split_phase(state: NuSplitState, coeffs: NuCoeffs, block, phase: int):
    """One block at STATIC phase ``phase`` (python int) of the split-tail
    schedule. ``step_nu_split`` dispatches dynamically via lax.switch;
    scans and the phase-latency benchmark call this directly."""
    n = block.shape[-1]
    spec_ratio = state.inbuf.shape[-1] // n
    m = state.inbuf.shape[-1]
    c = state.inbuf.shape[0]
    hp_t = state.acc_r.shape[-1]
    band_len = hp_t // spec_ratio

    head, y_head = K.step_hc(state.head, coeffs.head, block)

    zero = jnp.zeros((), jnp.int32)
    off = jnp.asarray(phase * n, jnp.int32)
    tail_slice = jax.lax.dynamic_slice(state.pending[0], (zero, off), (c, n))

    tail = state.tail
    if phase == 0:
        # the M-block completed last cycle (state.inbuf, BEFORE this
        # block's slice-0 overwrite) enters the tail ring now
        p_t = _ring_shape(tail.ring)[0]
        mold, xpk = K._hc_frame_spectrum(tail, state.inbuf, hp_t)
        pos = jnp.mod(tail.blockcounter, p_t)
        ring = _ring_insert(tail.ring, xpk, pos)
        tail = K.HcState(ring, mold, tail.blockcounter + 1)

    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, block.astype(state.inbuf.dtype), (zero, off))

    # band MAC: the ring position of the newest slot is (counter-1) mod P
    acc_r, acc_i = state.acc_r, state.acc_i
    p_t = _ring_shape(tail.ring)[0]
    pos_now = jnp.mod(tail.blockcounter - 1, p_t)
    br, bi = _split_band_mac(tail.ring, coeffs.tail, pos_now, phase, band_len)
    boff = jnp.asarray(phase * band_len, jnp.int32)
    acc_r = jax.lax.dynamic_update_slice(
        acc_r, br.astype(acc_r.dtype), (zero, boff))
    acc_i = jax.lax.dynamic_update_slice(
        acc_i, bi.astype(acc_i.dtype), (zero, boff))

    pending = state.pending
    if phase == spec_ratio - 1:
        z = _tail_inverse(acc_r.astype(state.inbuf.dtype),
                          acc_i.astype(state.inbuf.dtype), m)
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)

    out = y_head + tail_slice
    return NuSplitState(head, tail, acc_r, acc_i, inbuf, pending), out


def step_nu_split(
    state: NuSplitState,
    coeffs: NuCoeffs,
    block: jax.Array,
) -> Tuple[NuSplitState, jax.Array]:
    """One N-block through the split-tail two-stage engine (phase picked
    dynamically with ``lax.switch``; outputs match ``step_nu`` to fp
    rounding — see the schedule derivation above). Requires D >= 2 (every
    ``nu_geometry`` output satisfies it)."""
    n = block.shape[-1]
    ratio = state.inbuf.shape[-1] // n
    r_phase = jnp.mod(state.head.blockcounter, ratio)
    branches = [
        (lambda ph: lambda st_blk: _split_phase(
            st_blk[0], coeffs, st_blk[1], ph))(ph)
        for ph in range(ratio)
    ]
    return jax.lax.switch(r_phase, branches, (state, block))


def process_blocks_nu_split(state: NuSplitState, coeffs: NuCoeffs, blocks):
    """Cond-free scan over M-cycle-aligned blocks [B, C, N] (B a multiple
    of R, state at phase 0): the R phases unroll statically per cycle."""
    b, c, n = blocks.shape
    ratio = state.inbuf.shape[-1] // n
    if b % ratio:
        raise ValueError(f"block count {b} not a multiple of R={ratio}")
    mcycles = blocks.reshape(b // ratio, ratio, c, n)

    def mbody(st, mb):
        outs = []
        for ph in range(ratio):
            st, y = _split_phase(st, coeffs, mb[ph], ph)
            outs.append(y)
        return st, jnp.stack(outs)

    st, ys = jax.lax.scan(mbody, state, mcycles)
    return st, ys.reshape(b, c, n)


# ---------------------------------------------------------------------------
# Three-stage partitioning: the two-stage schedule composed recursively.
#
# For very long filters (taps >> the flagship 131072 — e.g. 10 s cathedral
# impulse responses at 44.1 kHz) the two-stage tail itself becomes the
# traffic bottleneck: at 524288 taps its 62 M1-partitions cost ~1 MB per
# channel per block amortized. The cure is the same medicine applied again:
# the tail engine of ``step_nu`` is replaced by a full two-stage engine at
# block size M1 (head p1 partitions at M1 + far stage at M2 = r2*M1 fired
# every r2 M1-blocks). The scheduling invariant composes cleanly because
# the inner engine — like the uniform tail it replaces — produces its
# M1-block output with no extra latency: its own far stage hides inside
# its own pending queue, whose D2 >= 2 slack is guaranteed by the inner
# geometry (p1*M1 >= 2*M2), independent of the outer queue's D1 >= 2.
#
# The reference is strictly uniform-partition (brutefir.cpp:244-343); this
# and the two-stage engine above are beyond-reference capability.
#
# The three-stage cost is nearly flat in filter length, while the
# two-stage cost grows with every tail partition. The session's auto mode
# switches to three stages at 640 partitions (~650k taps at N = 1024); that
# crossover has not been measured on the GPU yet.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Nu3Spec:
    """Three-stage geometry: outer head (p_head partitions at N) + an inner
    two-stage ``NuSpec`` at block M1 = ratio1*N covering the rest."""

    block_length: int
    ratio1: int
    p_head: int
    inner: NuSpec

    def __post_init__(self):
        if self.ratio1 < 2 or (self.ratio1 & (self.ratio1 - 1)):
            raise ValueError(f"ratio1 must be a power of two >= 2, got {self.ratio1}")
        if self.p_head % self.ratio1:
            raise ValueError(
                f"p_head ({self.p_head}) must be a multiple of ratio1 ({self.ratio1})")
        if self.delay_blocks < 2:
            raise ValueError("outer head must cover >= 2 M1-blocks of taps")
        if self.inner.block_length != self.ratio1 * self.block_length:
            raise ValueError("inner block length must equal ratio1 * N")

    @property
    def m1(self) -> int:
        return self.ratio1 * self.block_length

    @property
    def delay_blocks(self) -> int:
        return self.p_head // self.ratio1

    @property
    def max_taps(self) -> int:
        return self.p_head * self.block_length + self.inner.max_taps

    @property
    def head_spec(self) -> FilterSpec:
        return FilterSpec(self.block_length, self.p_head, self.inner.dtype)

    @property
    def traffic_bytes_per_block(self) -> int:
        it = jnp.dtype(self.inner.dtype).itemsize
        head = 2 * self.p_head * 2 * self.block_length * it
        return head + self.inner.traffic_bytes_per_block // self.ratio1


def nu3_geometry(taps: int, block_length: int = 1024, ratio1: int = 8,
                 ratio2: int = 8, dtype: str = "float32",
                 tail_store: str = "float32") -> Nu3Spec:
    """Minimal-head three-stage geometry covering ``taps``."""
    p_head = 2 * ratio1
    m1 = ratio1 * block_length
    rest = max(1, taps - p_head * block_length)
    inner = nu_geometry(rest, m1, ratio2, dtype, tail_store)
    return Nu3Spec(block_length, ratio1, p_head, inner)


class Nu3State(NamedTuple):
    head: K.HcState
    tail: NuState  # the inner two-stage engine at M1
    inbuf: jax.Array  # [C, M1]
    pending: jax.Array  # [D1, C, M1]


def init_nu3_state(spec: Nu3Spec, n_channels: int) -> Nu3State:
    dt = jnp.dtype(spec.inner.dtype)
    return Nu3State(
        head=K.init_hc_state(spec.head_spec, n_channels),
        tail=init_nu_state(spec.inner, n_channels),
        inbuf=jnp.zeros((n_channels, spec.m1), dtype=dt),
        pending=jnp.zeros((spec.delay_blocks, n_channels, spec.m1), dtype=dt),
    )


class Nu3Coeffs(NamedTuple):
    head: jax.Array  # [p_head, 2C, Hp]
    tail: NuCoeffs  # inner two-stage coefficients


def nu3_coeffs(impulse, spec: Nu3Spec, n_channels: int, scale: float = 1.0,
               precise: bool = False, shared: bool = False) -> Nu3Coeffs:
    h = jnp.asarray(impulse)
    if h.ndim == 1:
        h = h[None, :]
    if h.shape[-1] > spec.max_taps:
        raise ValueError(
            f"impulse ({h.shape[-1]} taps) exceeds the geometry's "
            f"max_taps ({spec.max_taps}); enlarge the far stage (nu3_geometry does)")
    t1 = spec.p_head * spec.block_length
    taps = h.shape[-1]
    head_imp = h[:, : min(taps, t1)]
    tail_imp = h[:, t1:] if taps > t1 else jnp.zeros((h.shape[0], 1), h.dtype)
    return Nu3Coeffs(
        head=K.hc_coeffs(head_imp, spec.head_spec, n_channels, scale, precise,
                         shared=shared),
        tail=nu_coeffs(tail_imp, spec.inner, n_channels, scale, precise,
                       shared=shared),
    )


def _step_nu_tiled_head(state: NuState, coeffs: NuCoeffs, block, phase=None):
    """``step_nu`` with the HEAD stage run through ``_tail_step`` (full
    inverse + slice): required when the head's own block size is large (the
    inner engine of the 3-stage schedule runs its head at M1 = 8192, where
    a dense half-DFT tail basis would not fit). ``phase``: a static int pins the
    fire/hold decision at trace time (no ``lax.cond``, no pass-through copy
    of the far ring — the bulk form's requirement); None keeps the dynamic
    cond of ``step_nu``."""
    n = block.shape[-1]
    ratio = state.inbuf.shape[-1] // n
    r_phase = jnp.mod(state.head.blockcounter, ratio) if phase is None else phase

    head, y_head = _tail_step(state.head, coeffs.head, block)

    zero = jnp.zeros((), dtype=jnp.int32)
    off = (r_phase * n if phase is None
           else jnp.asarray(phase * n, dtype=jnp.int32))
    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, block.astype(state.inbuf.dtype), (zero, off))
    c = state.inbuf.shape[0]
    tail_slice = jax.lax.dynamic_slice(state.pending[0], (zero, off), (c, n))

    def fire(args):
        tail, pending, inbuf = args
        tail, z = _tail_step(tail, coeffs.tail, inbuf)
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return tail, pending

    def hold(args):
        tail, pending, _ = args
        return tail, pending

    if phase is None:
        tail, pending = jax.lax.cond(
            r_phase == ratio - 1, fire, hold,
            (state.tail, state.pending, inbuf))
    elif phase == ratio - 1:
        tail, pending = fire((state.tail, state.pending, inbuf))
    else:
        tail, pending = hold((state.tail, state.pending, inbuf))

    out = y_head + tail_slice
    return NuState(head, tail, inbuf, pending), out


def step_nu3(
    state: Nu3State,
    coeffs: Nu3Coeffs,
    block: jax.Array,
) -> Tuple[Nu3State, jax.Array]:
    """One N-block through the three-stage engine (outputs match the
    uniform engine to fp rounding). Structure identical to ``step_nu``; the
    fire at phase R1-1 runs ONE step of the inner two-stage engine on the
    completed M1-block (which itself fires its far stage every r2 such
    steps, under its own cond)."""
    n = block.shape[-1]
    ratio = state.inbuf.shape[-1] // n
    r_phase = jnp.mod(state.head.blockcounter, ratio)

    head, y_head = K.step_hc(state.head, coeffs.head, block)

    zero = jnp.zeros((), dtype=r_phase.dtype)
    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, block.astype(state.inbuf.dtype), (zero, r_phase * n))
    c = state.inbuf.shape[0]
    tail_slice = jax.lax.dynamic_slice(
        state.pending[0], (zero, r_phase * n), (c, n))

    def fire(args):
        tail, pending, inbuf = args
        tail, z = _step_nu_tiled_head(tail, coeffs.tail, inbuf)
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return tail, pending

    def hold(args):
        tail, pending, _ = args
        return tail, pending

    tail, pending = jax.lax.cond(
        r_phase == ratio - 1, fire, hold, (state.tail, state.pending, inbuf))

    out = y_head + tail_slice
    return Nu3State(head, tail, inbuf, pending), out


def step_nu_crossfade_tiled_head(
    state: NuState,
    coeffs_old: NuCoeffs,
    coeffs_new: NuCoeffs,
    mblock: jax.Array,
    head_ramp: bool = True,
) -> Tuple[NuState, jax.Array]:
    """``step_nu_crossfade`` with the large-block head (``_tail_step``/
    ``_tail_step2``): the INNER engine's crossfade step of the three-stage
    transition, running at block size M1 (see ``_step_nu_tiled_head``). Laws
    identical to ``step_nu_crossfade``: head_ramp=True ramps the head over
    the (M1-sized) change block; the first far fire after the change runs
    both far coefficient sets on one ring advance and stores a full-M2
    old->new ramp."""
    m1 = mblock.shape[-1]
    c = state.inbuf.shape[0]
    ratio = state.inbuf.shape[-1] // m1
    r_phase = jnp.mod(state.head.blockcounter, ratio)

    if head_ramp:
        head, za, zb = _tail_step2(state.head, coeffs_old.head,
                                   coeffs_new.head, mblock)
        ramp = jnp.arange(m1, dtype=za.dtype) / (m1 - 1)
        y_head = za * (1.0 - ramp) + zb * ramp
    else:
        head, y_head = _tail_step(state.head, coeffs_new.head, mblock)

    zero = jnp.zeros((), dtype=r_phase.dtype)
    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, mblock.astype(state.inbuf.dtype), (zero, r_phase * m1))
    tail_slice = jax.lax.dynamic_slice(
        state.pending[0], (zero, r_phase * m1), (c, m1))

    def fire(args):
        tail, pending, inbuf = args
        tail, z_old, z_new = _tail_step2(tail, coeffs_old.tail,
                                         coeffs_new.tail, inbuf)
        m2 = z_old.shape[-1]
        ramp_m = jnp.arange(m2, dtype=z_old.dtype) / (m2 - 1)
        z = z_old * (1.0 - ramp_m) + z_new * ramp_m
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return tail, pending

    def hold(args):
        tail, pending, _ = args
        return tail, pending

    tail, pending = jax.lax.cond(
        r_phase == ratio - 1, fire, hold, (state.tail, state.pending, inbuf))

    out = y_head + tail_slice
    return NuState(head, tail, inbuf, pending), out


def step_nu3_crossfade(
    state: Nu3State,
    coeffs_old: Nu3Coeffs,
    coeffs_new: Nu3Coeffs,
    block: jax.Array,
    head_ramp: bool = True,
    inner_mode: str = "ramp",
) -> Tuple[Nu3State, jax.Array]:
    """Glitch-free live filter change on the THREE-stage engine: the two-stage crossfade law applied recursively — each stage
    bridges at its own natural boundary, so the output stays continuous
    throughout (convolver_crossfade_inplace, fftw_convolver.cpp:275-321,
    composed twice).

    - outer head: intra-block ramp on the change block (``head_ramp=True``);
      new coefficients afterwards.
    - inner engine (the M1-cadence tail): its FIRST step after the change is
      its own crossfade ramp step (``inner_mode="ramp"`` — inner head ramps
      over that M1 block); subsequent inner steps run ``inner_mode="hold"``
      (new inner head, far stage bridging at its own first fire with a
      full-M2 ramp). Once the far stage has fired, the transition is
      complete and the caller returns to ``step_nu3`` with the new
      coefficients.

    The caller (``engine.session``) tracks the stage machine host-side from
    the block counter: outer fire at ``cnt % r1 == r1-1``; the inner step at
    that fire sits at inner phase ``(cnt // r1) % r2``. In-flight pending
    queues are never touched: they are the continuation of the old-filter
    signal, and each bridging ramp starts exactly where they end."""
    n = block.shape[-1]
    c = state.inbuf.shape[0]
    ratio = state.inbuf.shape[-1] // n
    r_phase = jnp.mod(state.head.blockcounter, ratio)

    if head_ramp:
        p, c2, hp = state.head.ring.shape
        blk, xpk = K._hc_frame_spectrum(state.head, block, hp)
        pos = jnp.mod(state.head.blockcounter, p)
        zero = jnp.zeros((), dtype=pos.dtype)
        ring = jax.lax.dynamic_update_slice(state.head.ring, xpk[None],
                                            (pos, zero, zero))
        yo = K.mac_hc(ring, coeffs_old.head, pos)
        yn = K.mac_hc(ring, coeffs_new.head, pos)
        out_o = F.irfft_hc_tail(yo[0], yo[1], n=2 * n)
        out_n = F.irfft_hc_tail(yn[0], yn[1], n=2 * n)
        ramp = jnp.arange(n, dtype=out_o.dtype) / (n - 1)
        y_head = out_o * (1.0 - ramp) + out_n * ramp
        head = K.HcState(ring, blk, state.head.blockcounter + 1)
    else:
        head, y_head = K.step_hc(state.head, coeffs_new.head, block)

    zero = jnp.zeros((), dtype=r_phase.dtype)
    inbuf = jax.lax.dynamic_update_slice(
        state.inbuf, block.astype(state.inbuf.dtype), (zero, r_phase * n))
    tail_slice = jax.lax.dynamic_slice(
        state.pending[0], (zero, r_phase * n), (c, n))

    def fire(args):
        tail, pending, inbuf = args
        tail, z = step_nu_crossfade_tiled_head(
            tail, coeffs_old.tail, coeffs_new.tail, inbuf,
            head_ramp=(inner_mode == "ramp"))
        pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return tail, pending

    def hold(args):
        tail, pending, _ = args
        return tail, pending

    tail, pending = jax.lax.cond(
        r_phase == ratio - 1, fire, hold, (state.tail, state.pending, inbuf))

    out = y_head + tail_slice
    return Nu3State(head, tail, inbuf, pending), out


def process_blocks_nu3(state: Nu3State, coeffs: Nu3Coeffs, blocks):
    """lax.scan of ``step_nu3`` over [B, C, N] blocks; valid from any
    phase. For M2-cycle-aligned bulk streams prefer
    ``process_blocks_nu3_fast``."""

    def body(st, blk):
        return step_nu3(st, coeffs, blk)

    return jax.lax.scan(body, state, blocks)


def process_blocks_nu3_fast(state: Nu3State, coeffs: Nu3Coeffs, blocks):
    """Cond-free bulk form: scan over SUPER-cycles of r1*r2 N-blocks with
    every phase static — the outer head steps unroll, the inner engine
    steps once per M1-cycle at a STATIC inner phase (so neither the M1 ring
    nor the far ring is ever carried through an untaken ``lax.cond``
    branch, whose pass-through copy is exactly what the two-stage macro
    form exists to avoid). ``state`` must be at super-cycle phase 0 and B a
    multiple of r1*r2 (caller-checked, like ``process_blocks_nu_fast``)."""
    b, c, n = blocks.shape
    r1 = state.inbuf.shape[-1] // n
    r2 = state.tail.inbuf.shape[-1] // state.inbuf.shape[-1]
    sup = r1 * r2
    if b % sup:
        raise ValueError(f"block count {b} not a multiple of r1*r2={sup}")
    cycles = blocks.reshape(b // sup, r2, r1, c, n)

    def sbody(st, sblocks):  # sblocks [r2, r1, C, N]
        head, tail, inbuf, pending = st
        outs = []
        for j in range(r2):  # static inner phase j
            for i in range(r1):  # static outer phase i
                head, y = K.step_hc(head, coeffs.head, sblocks[j, i])
                outs.append(y + pending[0][:, i * n:(i + 1) * n])
            inbuf = jnp.swapaxes(sblocks[j], 0, 1).reshape(c, r1 * n).astype(
                inbuf.dtype)
            tail, z = _step_nu_tiled_head(tail, coeffs.tail, inbuf, phase=j)
            pending = jnp.concatenate([pending[1:], z[None]], axis=0)
        return Nu3State(head, tail, inbuf, pending), jnp.stack(outs)

    st, ys = jax.lax.scan(sbody, state, cycles)
    return st, ys.reshape(b, c, n)
