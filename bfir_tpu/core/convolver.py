"""Partitioned overlap-save FFT convolution — the engine core.

Accelerator re-design of the reference's convolution pipeline
(``brutefir/fftw_convolver.{cpp,hpp}`` + the per-block engine loop
``brutefir::run``, brutefir.cpp:244-343):

reference (C++/FFTW, per channel, per block)          this module (JAX, all channels at once)
-----------------------------------------------      ---------------------------------------
convolver_raw2cbuf: prev block in lower half,         ``jnp.concatenate([prev, block])`` -> rfft
  new block in upper half (fftw_convolver.cpp:156)
convolver_time2freq: r2r halfcomplex FFT (:187)       ``F.rfft`` (natural complex layout —
convolver_mixnscale: scramble into 4r/4i SIMD           the reference's scrambled "cbuf" layout is
  groups + scale (:858-1427)                            an x86-SSE artifact and is not reproduced)
convolver_convolve(_add): complex MAC over            gather of delayed ring spectra + einsum MAC
  partitions vs ring of delayed input spectra           over the partition axis (psum-able)
  (brutefir.cpp:279-300)
convolver_freq2time + take first half (:350,:405)     ``F.irfft`` + take second half (we keep
                                                        the filter in the *lower* half of the padded
                                                        buffer, so the valid half is the upper one;
                                                        mathematically identical to the reference's
                                                        upper-half placement, coeffs2cbuf :474-537)
FFTW plans + wisdom files (:81-137)                   XLA compilation cache (nothing to manage)

State is a pytree of device arrays; one ``step`` is one jitted computation over
all channels. The FFT normalization 1/n_fft that the reference folds into the
coefficient spectra (fftw_convolver.cpp:521-523) is here provided by
``irfft``'s 1/N convention — net unit gain either way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bfir_tpu.ops import fft as F

from bfir_tpu.core.spec import FilterSpec


class ConvolverState(NamedTuple):
    """Streaming state (the device equivalent of brutefir's buffer arena,
    brutefir.cpp:738-810).

    spectra_ring: [P, C, F] complex — ring of the last P input-block spectra
        (reference: ``cbuf[n][blockcounter % n_blocks]``, brutefir.cpp:270-277).
        Slot ``blockcounter % P`` holds the newest spectrum.
    prev_block:   [C, N] real — previous time-domain input block (the lower
        half of the reference's double-buffered ``input_timecbuf``).
    blockcounter: int32 scalar (brutefir.hpp blockcounter; wraps like the
        reference's unsigned counter — irrelevant before ~2^31 blocks).
    """

    spectra_ring: jax.Array
    prev_block: jax.Array
    blockcounter: jax.Array


def init_state(spec: FilterSpec, n_channels: int) -> ConvolverState:
    """Fresh zeroed state (== reference reset(), brutefir.cpp:345-367).

    The reference skips cold partitions during warm-up via ``procblocks``
    (brutefir.cpp:265-268,292). We zero-initialize the ring instead, which
    makes cold partitions contribute exactly zero — same outputs, no
    data-dependent control flow for XLA.
    """
    cdt = jnp.dtype(spec.complex_dtype)
    rdt = jnp.dtype(spec.dtype)
    return ConvolverState(
        spectra_ring=F.czeros((spec.n_partitions, n_channels, spec.n_freq), dtype=cdt),
        prev_block=jnp.zeros((n_channels, spec.block_length), dtype=rdt),
        blockcounter=jnp.zeros((), dtype=jnp.int32),
    )


def coeffs_to_spectra(impulse, spec: FilterSpec, scale: float = 1.0) -> jax.Array:
    """Split an impulse response into per-partition spectra.

    Reference: ``coeff::preprocess_coeff`` (coeff.cpp:292-354) calling
    ``convolver_coeffs2cbuf`` per block (fftw_convolver.cpp:474-537): each
    N-tap slice is zero-padded to 2N and FFT'd. The reference zero-pads the
    tail of the last partition; impulses longer than P*N are truncated
    (coeff.cpp:292-354 semantics).

    impulse: [taps] (shared across channels) or [C, taps].
    Returns [P, C, F] complex (C=1 for shared; broadcasting happens in step).
    """
    h = jnp.asarray(impulse, dtype=spec.dtype) * jnp.asarray(scale, dtype=spec.dtype)
    if h.ndim == 1:
        h = h[None, :]
    c, taps = h.shape
    n, p = spec.block_length, spec.n_partitions
    if taps > n * p:
        h = h[:, : n * p]
    else:
        h = jnp.pad(h, ((0, 0), (0, n * p - taps)))
    parts = h.reshape(c, p, n).transpose(1, 0, 2)  # [P, C, N]
    # filter slice in the lower half of the 2N frame -> valid output is the
    # upper half after irfft (see module docstring for the half-placement note)
    return F.rfft(parts, n=spec.n_fft, axis=-1)


def spectra_to_impulse(coeff_spectra: jax.Array, spec: FilterSpec) -> jax.Array:
    """Invert per-partition coefficient spectra back to the time-domain
    impulse [C, P*N] — the reference's debug facility
    ``convolver_debug_dump_cbuf`` (fftw_convolver.cpp:604-651), which
    inverse-transforms each partition's cbuf for offline inspection.
    Exact inverse of ``coeffs_to_spectra`` (up to fp rounding)."""
    parts = F.irfft(coeff_spectra, n=spec.n_fft, axis=-1)  # [P, C, 2N]
    parts = parts[..., : spec.block_length]  # zero-padded upper half dropped
    p, c, n = parts.shape
    return parts.transpose(1, 0, 2).reshape(c, p * n)


def _delayed_ring(ring: jax.Array, blockcounter: jax.Array) -> jax.Array:
    """gathered[i] = ring[(blockcounter - i) mod P] — partition i sees the
    input spectrum delayed by i blocks (brutefir.cpp:292-299)."""
    p = ring.shape[0]
    idx = jnp.mod(blockcounter - jnp.arange(p, dtype=jnp.int32), p)
    return jnp.take(ring, idx, axis=0)


def step(
    state: ConvolverState,
    coeff_spectra: jax.Array,
    block: jax.Array,
) -> Tuple[ConvolverState, jax.Array]:
    """Process one N-frame block through the partitioned convolver.

    The device equivalent of one ``brutefir::run`` call (brutefir.cpp:244-343),
    minus raw-format conversion/dither (those live in ``ops.formats``): all
    channels are processed as one tensor computation.

    coeff_spectra: [P, C, F] or [P, 1, F] complex.
    block: [C, N] real input frames.
    Returns (new_state, out [C, N]).
    """
    n = block.shape[-1]
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)  # [C, 2N]
    x = F.rfft(frame, axis=-1)  # [C, F]

    pos = jnp.mod(state.blockcounter, state.spectra_ring.shape[0])
    zero = jnp.zeros((), dtype=pos.dtype)
    ring = jax.lax.dynamic_update_slice(state.spectra_ring, x[None], (pos, zero, zero))

    gathered = _delayed_ring(ring, state.blockcounter)  # [P, C, F]
    y = jnp.sum(coeff_spectra * gathered, axis=0)  # MAC over partitions -> [C, F]

    out = F.irfft(y, axis=-1)[..., n:]  # valid upper half

    new_state = ConvolverState(
        spectra_ring=ring,
        prev_block=block,
        blockcounter=state.blockcounter + 1,
    )
    return new_state, out


def step_rolled(
    state: ConvolverState,
    coeff_spectra: jax.Array,
    block: jax.Array,
) -> Tuple[ConvolverState, jax.Array]:
    """One block step in *rolled* ring representation: ``ring[i]`` always
    holds the spectrum delayed by exactly ``i`` blocks (newest at 0), so the
    partition MAC is an aligned elementwise product with no gather.

    This is the distribution-friendly form: with ``ring`` sharded over the
    partition mesh axis, ``jnp.roll`` by a *static* 1 becomes a
    nearest-neighbor boundary exchange (ICI collective-permute) instead of
    the all-gather a position-indexed ring (``step``) would need, and the
    partition sum becomes a psum. Numerically identical to ``step``
    (brutefir.cpp:270-300 semantics either way).
    """
    n = block.shape[-1]
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)
    x = F.rfft(frame, axis=-1)  # [C, F]

    ring = jnp.roll(state.spectra_ring, 1, axis=0)
    ring = jax.lax.dynamic_update_slice(
        ring, x[None], (0, 0, 0)
    )  # static slot 0 write
    y = jnp.sum(coeff_spectra * ring, axis=0)
    out = F.irfft(y, axis=-1)[..., n:]

    return (
        ConvolverState(ring, block, state.blockcounter + 1),
        out,
    )


def step_crossfade(
    state: ConvolverState,
    coeff_old: jax.Array,
    coeff_new: jax.Array,
    block: jax.Array,
) -> Tuple[ConvolverState, jax.Array]:
    """One block during a filter change: outputs are computed with both
    coefficient sets and linearly crossfaded over the block.

    Equivalent of ``convolver_crossfade_inplace`` (fftw_convolver.cpp:
    275-321) — the reference crossfades the two filtered time signals with
    ramp n/(N-1) — lifted to the whole-engine step. The session uses this
    for glitch-free reconfiguration (the reference plugin instead swaps
    filters only at full re-init).
    """
    n = block.shape[-1]
    mid_state, out_old = step(state, coeff_old, block)
    _, out_new = step(state, coeff_new, block)
    ramp = jnp.arange(n, dtype=out_old.dtype) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return mid_state, out


def rolled_from_state(state: ConvolverState) -> ConvolverState:
    """Convert pointer-based ring state (``step``) to rolled representation
    (``step_rolled``): rolled[i] = ring[(counter - 1 - i) mod P]."""
    p = state.spectra_ring.shape[0]
    idx = jnp.mod(state.blockcounter - 1 - jnp.arange(p, dtype=jnp.int32), p)
    return ConvolverState(
        jnp.take(state.spectra_ring, idx, axis=0), state.prev_block, state.blockcounter
    )


def state_from_rolled(state: ConvolverState) -> ConvolverState:
    """Inverse of ``rolled_from_state``: pointer ring[s] = rolled[(counter -
    1 - s) mod P], so ``step``/``process_batch`` can continue a stream whose
    state was produced by ``step_rolled``."""
    p = state.spectra_ring.shape[0]
    idx = jnp.mod(state.blockcounter - 1 - jnp.arange(p, dtype=jnp.int32), p)
    return ConvolverState(
        jnp.take(state.spectra_ring, idx, axis=0), state.prev_block, state.blockcounter
    )


def process_blocks(
    state: ConvolverState,
    coeff_spectra: jax.Array,
    blocks: jax.Array,
) -> Tuple[ConvolverState, jax.Array]:
    """Streaming-exact processing of ``blocks`` [B, C, N] via ``lax.scan``.

    Bit-identical semantics to B successive ``step`` calls.
    """

    def body(st, blk):
        return step(st, coeff_spectra, blk)

    return jax.lax.scan(body, state, blocks)


def batch_fft_len(b: int, p: int) -> int:
    """Block-axis FFT length for a B-block batch with P partitions."""
    return int(2 ** np.ceil(np.log2(max(b + 2 * (p - 1), 2))))


def prepare_batch_coeffs(coeff_spectra: jax.Array, b: int):
    """Precompute the block-axis FFT of the coefficient spectra for
    ``process_batch`` with batch size ``b`` — static per filter, so hoisting
    it out of the per-batch call saves one of the three block-axis
    transforms (~1/3 of batch-mode time).

    Returns split re/im planes [L, C, F] (a host-transfer-safe pair — this
    backend cannot move complex arrays across the host boundary; they are
    re-packed to complex inside process_batch)."""
    p = coeff_spectra.shape[0]
    l = batch_fft_len(b, p)
    hs = F.fft(coeff_spectra, n=l, axis=0)
    return jnp.real(hs), jnp.imag(hs)


def _batch_coeff_len(coeff_batch_fft) -> int:
    if isinstance(coeff_batch_fft, tuple):
        return coeff_batch_fft[0].shape[0]
    return coeff_batch_fft.shape[0]


def _batch_coeff_complex(coeff_batch_fft):
    if isinstance(coeff_batch_fft, tuple):
        return jax.lax.complex(*coeff_batch_fft)
    return coeff_batch_fft  # legacy complex [L, C, F]


def process_batch(
    state: ConvolverState,
    coeff_spectra: jax.Array,
    blocks: jax.Array,
    coeff_batch_fft: Optional[jax.Array] = None,
) -> Tuple[ConvolverState, jax.Array]:
    """High-throughput batched processing of ``blocks`` [B, C, N].

    Same outputs as ``process_blocks`` (up to fp rounding), restructured for
    the hardware: all B block FFTs are batched, and the partition MAC — a
    causal convolution along the block index, Y[b] = sum_p H[p] X[b-p] — is
    evaluated with a second FFT *over the block axis* (convolution theorem),
    turning the O(B*P) MAC into O((B+P) log(B+P)) batched muls. This is the
    offline/bulk path; ``step`` is the one-block-latency path.

    Pass ``coeff_batch_fft = prepare_batch_coeffs(coeff_spectra, B)`` to
    skip recomputing the static coefficient transform per call.

    Formulation note: this uses full complex transforms plus output
    slices (the sliced variants in ``ops.fft`` — ifft0_slice / irfft_tail —
    exist only on the matmul path). ``engine.selfcheck.check_batch`` is the
    known-answer guard for a batch geometry.
    """
    p, _, f = coeff_spectra.shape
    b, c, n = blocks.shape
    blocks = blocks.astype(state.prev_block.dtype)

    # Overlapped 2N frames: frame[i] = [block_{i-1} | block_i]
    prev = jnp.concatenate([state.prev_block[None], blocks[:-1]], axis=0)  # [B, C, N]
    frames = jnp.concatenate([prev, blocks], axis=-1)  # [B, C, 2N]
    x = F.rfft(frames, axis=-1)  # [B, C, F]

    # History: spectra for delays 1..P-1 relative to the first new block,
    # ordered oldest-first so xpad[k] is the spectrum of block index k-(P-1).
    hist_idx = jnp.mod(
        state.blockcounter - jnp.arange(p - 1, 0, -1, dtype=jnp.int32) + p,
        p,
    )
    hist = jnp.take(state.spectra_ring, hist_idx, axis=0) if p > 1 else x[:0]
    xpad = jnp.concatenate([hist, x], axis=0)  # [B+P-1, C, F]

    # Causal conv along block axis via FFT (zero-pad to L >= B+P-1 + P-1 to
    # avoid circular wrap of the history tail).
    l = batch_fft_len(b, p)
    xs = F.fft(xpad, n=l, axis=0)
    if coeff_batch_fft is not None and _batch_coeff_len(coeff_batch_fft) == l:
        hs = _batch_coeff_complex(coeff_batch_fft)
    else:
        hs = F.fft(coeff_spectra, n=l, axis=0)
    y_all = F.ifft(xs * hs, axis=0)  # [L, C, F]
    # output block b corresponds to xpad index (P-1)+b
    y = y_all[p - 1 : p - 1 + b]

    out = F.irfft(y, axis=-1)[..., n:]  # [B, C, N] valid upper half

    # New ring state: the last P spectra among xpad, placed at their slots.
    counters = state.blockcounter + jnp.arange(b, dtype=jnp.int32)
    if p > 1:
        tail_counters = jnp.concatenate(
            [state.blockcounter - jnp.arange(p - 1, 0, -1, dtype=jnp.int32), counters]
        )
    else:
        tail_counters = counters
    last = xpad[-p:] if xpad.shape[0] >= p else xpad
    last_counters = tail_counters[-p:]
    ring = state.spectra_ring
    slots = jnp.mod(last_counters, p)
    ring = ring.at[slots].set(last[: slots.shape[0]])

    new_state = ConvolverState(
        spectra_ring=ring,
        prev_block=blocks[-1],
        blockcounter=state.blockcounter + b,
    )
    return new_state, out


def direct_convolve_spectra(
    impulse_a, impulse_b, max_taps: Optional[int] = None, dtype=jnp.float64
):
    """Compose two impulses by direct spectral multiplication.

    The reference composes filter chains by streaming one impulse through a
    brutefir instance whose coefficients are the other
    (``preprocessor::convolve_impulses``, preprocessor.cpp:33-233) — block-wise
    circular machinery for what is mathematically a single linear convolution.
    We do the single full-length FFT convolution directly.
    """
    a = jnp.asarray(impulse_a, dtype=dtype)
    b = jnp.asarray(impulse_b, dtype=dtype)
    out_len = a.shape[-1] + b.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(max(out_len, 2))))
    y = F.irfft(
        F.rfft(a, n=nfft, axis=-1) * F.rfft(b, n=nfft, axis=-1),
        n=nfft,
        axis=-1,
    )[..., :out_len]
    if max_taps is not None:
        y = y[..., :max_taps]
    return y
