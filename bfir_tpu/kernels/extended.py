"""Extended-precision (df64) streaming engine path in float32 arithmetic.

The reference plugin runs REALSIZE=8 — C double end-to-end
(/root/reference/foo_dsp_bfir/common.h:17, fftw_convolver.cpp double
mirrors :1558-2251). Without float64 compute (x64 off) the honest
equivalent is double-float: every spectrum (ring, coefficients,
accumulator) is an unevaluated two-f32 sum with ~49-bit significands, the
transforms are the df64 four-step (ops.df64), and the partition MAC is
compensated elementwise arithmetic.

Measured f32 error budget (CPU, float64 scipy oracle): all-f32 127 dB; the transforms,
then the f32 spectra storage, are the caps. This path lifts both:
CPU-measured SNR vs a float64 scipy oracle rises from ~127 dB (f32 hc
path) to ~180+ dB at the same partition depth.

Cost: roughly 2x memory traffic (two planes per array) and elementwise-
bound transform stages — the price of precision; streaming stays comfortably
real-time. Layout mirrors the hc path (kernels.spectrum_mac): packed
[P, 2C, Hp] planes, Nyquist in the DC imaginary lane, lane-0 products
fixed up to two real multiplies.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.kernels.spectrum_mac import _round_up
from bfir_tpu.ops import df64 as D


class DfState(NamedTuple):
    """Extended-precision streaming state: the spectrum ring AND the
    overlap-save previous block as df64 (hi, lo) planes — float64 inputs
    (available on x64 hosts) are split losslessly, f32 inputs carry a zero
    lo plane."""

    ring_hi: jax.Array  # [P, 2C, Hp]
    ring_lo: jax.Array
    prev_hi: jax.Array  # [C, N]
    prev_lo: jax.Array
    blockcounter: jax.Array  # int32


def init_df_state(spec: FilterSpec, n_channels: int) -> DfState:
    hp = _round_up(spec.n_fft // 2, 128)
    return DfState(
        ring_hi=jnp.zeros((spec.n_partitions, 2 * n_channels, hp), jnp.float32),
        ring_lo=jnp.zeros((spec.n_partitions, 2 * n_channels, hp), jnp.float32),
        prev_hi=jnp.zeros((n_channels, spec.block_length), jnp.float32),
        prev_lo=jnp.zeros((n_channels, spec.block_length), jnp.float32),
        blockcounter=jnp.zeros((), jnp.int32),
    )


def _split_input(block):
    """Exact df64 view of an input block: float64 splits losslessly (x64
    hosts), float32 is already exact with a zero lo plane."""
    if block.dtype == jnp.float64:
        hi = block.astype(jnp.float32)
        lo = (block - hi.astype(jnp.float64)).astype(jnp.float32)
        return hi, lo
    b = block.astype(jnp.float32)
    return b, jnp.zeros_like(b)


def df_coeffs(impulse, spec: FilterSpec, n_channels: int, scale: float = 1.0):
    """Partitioned coefficient spectra as df64 packed planes
    ([P, 2C, Hp] hi, [P, 2C, Hp] lo): host float64 FFT split into two-f32
    — the full f64 coefficient accuracy, not just its f32 rounding."""
    n, p = spec.block_length, spec.n_partitions
    hp = _round_up(spec.n_fft // 2, 128)
    h64 = np.asarray(impulse, dtype=np.float64) * float(scale)
    if h64.ndim == 1:
        h64 = h64[None, :]
    c0, taps = h64.shape
    if taps > n * p:
        h64 = h64[:, : n * p]
    else:
        h64 = np.pad(h64, ((0, 0), (0, n * p - taps)))
    parts = h64.reshape(c0, p, n).transpose(1, 0, 2)
    sp = np.fft.rfft(parts, n=spec.n_fft, axis=-1)
    half = spec.n_fft // 2
    cr = sp.real[..., :half]
    ci = np.concatenate([sp.real[..., half:half + 1], sp.imag[..., 1:half]], -1)
    pk = np.concatenate([cr, ci], axis=1)  # [P, 2C0, half]
    pk = np.pad(pk, ((0, 0), (0, 0), (0, hp - half)))
    hi, lo = D.split_f64(pk)
    if c0 != n_channels:
        hi = np.broadcast_to(hi, (p, 2 * n_channels, hp))
        lo = np.broadcast_to(lo, (p, 2 * n_channels, hp))
    return jnp.asarray(hi), jnp.asarray(lo)


def _emit(pair):
    """Render a df output pair at the widest dtype the backend offers:
    float64 (exact hi+lo sum) when x64 is available, else the rounded f32
    — the chip's output is f32 regardless, and integer output formats
    requantize through dither downstream."""
    if jax.config.jax_enable_x64:
        return pair[0].astype(jnp.float64) + pair[1].astype(jnp.float64)
    return pair[0] + pair[1]


def mac_df(ring_hi, ring_lo, coeff_hi, coeff_lo, pos):
    """Compensated partition MAC on packed df planes: for each partition i,
    complex-multiply coeff[i] with ring slot (pos - i) mod P (df64 on split
    planes, lane 0 as two real products) and df-accumulate. Returns
    ((yr_hi, yr_lo), (yi_hi, yi_lo)) each [C, Hp]."""
    p, c2, hp = ring_hi.shape
    c = c2 // 2
    lane0 = jax.lax.broadcasted_iota(jnp.int32, (c, hp), 1) == 0
    zero = jnp.zeros((c, hp), jnp.float32)

    def body(i, acc):
        yr_h, yr_l, yi_h, yi_l = acc
        slot = jnp.mod(pos - i, p)
        rh = jax.lax.dynamic_index_in_dim(ring_hi, slot, 0, keepdims=False)
        rl = jax.lax.dynamic_index_in_dim(ring_lo, slot, 0, keepdims=False)
        gh = jax.lax.dynamic_index_in_dim(coeff_hi, i, 0, keepdims=False)
        gl = jax.lax.dynamic_index_in_dim(coeff_lo, i, 0, keepdims=False)
        rr = (rh[:c], rl[:c])
        ri = (rh[c:], rl[c:])
        cr = (gh[:c], gl[:c])
        ci = (gh[c:], gl[c:])
        pr, pi = D.cdf_mul(rr, ri, cr, ci)
        q1 = D.df_mul(rr, cr)  # lane 0: DC.re * coeff_DC
        q2 = D.df_mul(ri, ci)  # lane 0: Ny.re * coeff_Ny
        pr = (jnp.where(lane0, q1[0], pr[0]), jnp.where(lane0, q1[1], pr[1]))
        pi = (jnp.where(lane0, q2[0], pi[0]), jnp.where(lane0, q2[1], pi[1]))
        nr = D.df_add((yr_h, yr_l), pr)
        ni = D.df_add((yi_h, yi_l), pi)
        return nr[0], nr[1], ni[0], ni[1]

    yr_h, yr_l, yi_h, yi_l = jax.lax.fori_loop(
        0, p, body, (zero, zero, zero, zero))
    return (yr_h, yr_l), (yi_h, yi_l)


def step_df(
    state: DfState,
    coeff_hi: jax.Array,
    coeff_lo: jax.Array,
    block: jax.Array,
) -> Tuple[DfState, jax.Array]:
    """One streaming block at extended precision; output rounded to f32.

    Mirrors kernels.spectrum_mac.step_hc with df64 transforms (the input
    frame is f32, hence exact as a df value), df64 ring/coeff spectra, and
    the compensated MAC."""
    p, c2, hp = state.ring_hi.shape
    c = c2 // 2
    n = block.shape[-1]
    h = n  # n_fft // 2
    bh, bl = _split_input(block)
    frame = (jnp.concatenate([state.prev_hi, bh], axis=-1),
             jnp.concatenate([state.prev_lo, bl], axis=-1))
    hr, hi = D.rfft_hc_df(frame, 2 * n)
    pad = hp - h
    if pad:
        hr = (jnp.pad(hr[0], ((0, 0), (0, pad))), jnp.pad(hr[1], ((0, 0), (0, pad))))
        hi = (jnp.pad(hi[0], ((0, 0), (0, pad))), jnp.pad(hi[1], ((0, 0), (0, pad))))
    xpk_hi = jnp.concatenate([hr[0], hi[0]], axis=0)
    xpk_lo = jnp.concatenate([hr[1], hi[1]], axis=0)
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring_hi = jax.lax.dynamic_update_slice(state.ring_hi, xpk_hi[None],
                                           (pos, zero, zero))
    ring_lo = jax.lax.dynamic_update_slice(state.ring_lo, xpk_lo[None],
                                           (pos, zero, zero))
    yr, yi = mac_df(ring_hi, ring_lo, coeff_hi, coeff_lo, pos)
    yr = (yr[0][..., :h], yr[1][..., :h])
    yi = (yi[0][..., :h], yi[1][..., :h])
    out = D.irfft_hc_df(yr, yi, 2 * n)
    out_w = _emit((out[0][..., n:], out[1][..., n:]))
    return (
        DfState(ring_hi, ring_lo, bh, bl, state.blockcounter + 1),
        out_w,
    )


def step_df_crossfade(
    state: DfState,
    coeff_old: Tuple[jax.Array, jax.Array],
    coeff_new: Tuple[jax.Array, jax.Array],
    block: jax.Array,
) -> Tuple[DfState, jax.Array]:
    """Glitch-free filter-change block on the extended path (two MACs +
    linear ramp, fftw_convolver.cpp:275-321)."""
    p, c2, hp = state.ring_hi.shape
    n = block.shape[-1]
    h = n
    bh, bl = _split_input(block)
    frame = (jnp.concatenate([state.prev_hi, bh], axis=-1),
             jnp.concatenate([state.prev_lo, bl], axis=-1))
    hr, hi = D.rfft_hc_df(frame, 2 * n)
    pad = hp - h
    if pad:
        hr = (jnp.pad(hr[0], ((0, 0), (0, pad))), jnp.pad(hr[1], ((0, 0), (0, pad))))
        hi = (jnp.pad(hi[0], ((0, 0), (0, pad))), jnp.pad(hi[1], ((0, 0), (0, pad))))
    xpk_hi = jnp.concatenate([hr[0], hi[0]], axis=0)
    xpk_lo = jnp.concatenate([hr[1], hi[1]], axis=0)
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring_hi = jax.lax.dynamic_update_slice(state.ring_hi, xpk_hi[None],
                                           (pos, zero, zero))
    ring_lo = jax.lax.dynamic_update_slice(state.ring_lo, xpk_lo[None],
                                           (pos, zero, zero))

    def render(ch, cl):
        yr, yi = mac_df(ring_hi, ring_lo, ch, cl, pos)
        yr = (yr[0][..., :h], yr[1][..., :h])
        yi = (yi[0][..., :h], yi[1][..., :h])
        out = D.irfft_hc_df(yr, yi, 2 * n)
        return _emit((out[0][..., n:], out[1][..., n:]))

    out_old = render(*coeff_old)
    out_new = render(*coeff_new)
    ramp = jnp.arange(n, dtype=out_old.dtype) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    st = DfState(ring_hi, ring_lo, bh, bl, state.blockcounter + 1)
    return st, out
