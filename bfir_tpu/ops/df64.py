"""Double-float (two-f32) arithmetic and transforms in float32.

The reference plugin runs its whole pipeline in C double (REALSIZE=8,
foo_dsp_bfir/common.h:17). Without float64 compute (x64
off), f64-class capability is provided as *double-float* (df64): every value is
an unevaluated sum hi + lo of two f32s (~49 bits of significand), with
error-free transformations (Knuth TwoSum, Dekker/Veltkamp TwoProd — no FMA
required).

Where it's used:
- coefficient spectra preparation (one-time, per build): the measured f32
  error budget shows f32-computed coefficient FFTs cost ~9 dB
  of final SNR even when stored as f32 — df64-computed, f32-stored
  coefficients recover that for free at stream time;
- the extended-precision engine path (runtime df64 transforms).

Design note: a matrix unit cannot carry compensated accumulation (its f32
accumulator rounds every partial sum), so df64 DFT stages here are built
from *elementwise* mul/adds inside `lax.fori_loop` over the small DFT
dimension (n1, n2 <= 64 for the four-step) — each product/sum is an exact
EFT pair. That trades matrix throughput for exactness; the four-step keeps the
op count O(M·(n1+n2)) so a [64, 2048] transform stays sub-millisecond.

All functions take/return (hi, lo) pairs of identically-shaped f32 arrays.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Pair = Tuple[jax.Array, jax.Array]

_SPLIT_C = 4097.0  # 2^12 + 1: Veltkamp splitter for f32 (24-bit mantissa)


def _nofuse(x):
    """Pin an EFT-critical intermediate to its IEEE-rounded f32 value.

    Error-free transformations depend on specific intermediates being
    rounded exactly once. The XLA CPU backend breaks that in two ways
    (both measured here, see tests):
    - LLVM FMA-contracts ``mul`` feeding ``add`` within a fusion, so
      ``s = p + e`` with ``p = a*b`` becomes ``fma(a, b, e)`` — p's
      rounding never happens and the compensation term inherits an
      O(ulp(p)) error;
    - ``lax.optimization_barrier`` and identity ``reduce_precision`` are
      both elided before fusion, so neither blocks it.
    A NaN-guarded select does survive: ``where(x == x, x, x + x)`` is an
    identity (and still propagates NaN), but the compiler cannot prove the
    branches equal or see the mul through the select. VPU cost: one
    compare + one select per pinned value — noise next to the transforms'
    mul/add stream."""
    return jnp.where(x == x, x, x + x)


def two_sum(a, b) -> Pair:
    """s + err == a + b exactly (Knuth; no magnitude precondition)."""
    a = _nofuse(a)
    b = _nofuse(b)
    s = a + b
    bb = _nofuse(s - a)
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b) -> Pair:
    """s + err == a + b exactly, REQUIRES |a| >= |b| (or a == 0)."""
    a = _nofuse(a)
    b = _nofuse(b)
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a) -> Pair:
    """Veltkamp split: a == hi + lo with both halves 12-bit exact."""
    t = _nofuse(_SPLIT_C * a)
    hi = _nofuse(t - (t - a))
    return hi, a - hi


def two_prod(a, b) -> Pair:
    """p + err == a * b exactly (Dekker, FMA-free)."""
    p = _nofuse(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# -- df64 arithmetic --------------------------------------------------------


def df_from(hi, lo=None) -> Pair:
    hi = jnp.asarray(hi, dtype=jnp.float32)
    return hi, (jnp.zeros_like(hi) if lo is None else jnp.asarray(lo, jnp.float32))


def df_add(x: Pair, y: Pair) -> Pair:
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def df_neg(x: Pair) -> Pair:
    return -x[0], -x[1]


def df_sub(x: Pair, y: Pair) -> Pair:
    return df_add(x, df_neg(y))


def df_mul(x: Pair, y: Pair) -> Pair:
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def df_scale(x: Pair, s: float) -> Pair:
    """Multiply by an exactly-representable f32 scalar (e.g. 0.5, 2.0).
    Outputs are pinned: they are raw muls that would otherwise FMA-contract
    into downstream EFT adds (see _nofuse)."""
    return _nofuse(x[0] * np.float32(s)), _nofuse(x[1] * np.float32(s))


def df_round(x: Pair) -> jax.Array:
    """Round to nearest f32."""
    return x[0] + x[1]


def split_f64(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: represent an f64 array as (hi, lo) f32 with
    hi + lo == f64 value to ~2^-48 relative."""
    a = np.asarray(a, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# -- complex df64 (split re/im, each a df pair) -----------------------------
# carried as a 4-tuple (rr_hi, rr_lo, ri_hi, ri_lo) via two Pair objects


def cdf_mul(xr: Pair, xi: Pair, yr: Pair, yi: Pair) -> Tuple[Pair, Pair]:
    rr = df_sub(df_mul(xr, yr), df_mul(xi, yi))
    ri = df_add(df_mul(xr, yi), df_mul(xi, yr))
    return rr, ri


# -- df64 four-step complex FFT over the last axis --------------------------


@functools.lru_cache(maxsize=32)
def _dft_weights_df(n: int, inverse: bool):
    """DFT_n weights as host df pairs [n, n] (f64 cos/sin split hi/lo);
    forward sign -, no scale; inverse sign +, no scale (caller scales)."""
    k = np.arange(n)
    ang = (2.0 if inverse else -2.0) * np.pi * np.outer(k, k) / n
    cr_h, cr_l = split_f64(np.cos(ang))
    ci_h, ci_l = split_f64(np.sin(ang))
    return cr_h, cr_l, ci_h, ci_l


@functools.lru_cache(maxsize=32)
def _twiddle_df(m: int, n1: int, inverse: bool):
    """W_m^{±j2·k1} as df pairs [n2, n1] (indexed [j2, k1])."""
    n2 = m // n1
    k1 = np.arange(n1)[None, :]
    j2 = np.arange(n2)[:, None]
    ang = (2.0 if inverse else -2.0) * np.pi * j2 * k1 / m
    tr_h, tr_l = split_f64(np.cos(ang))
    ti_h, ti_l = split_f64(np.sin(ang))
    return tr_h, tr_l, ti_h, ti_l


def _df_split_factor(m: int) -> int:
    n1 = 1
    while n1 * n1 <= m // 2:
        n1 *= 2
    return n1


def _dft_stage_df(xr: Pair, xi: Pair, n: int, inverse: bool,
                  scale: float = 1.0) -> Tuple[Pair, Pair]:
    """DFT of size n over the LAST axis of [..., n] df operands, computed as
    n elementwise df mul-add passes (lax.fori_loop over the input index j):
    out[.., k] = sum_j x[.., j] * W[j, k]. Every product and sum is an EFT
    pair — no matrix-unit accumulator rounding."""
    cr_h, cr_l, ci_h, ci_l = _dft_weights_df(n, inverse)
    wr_h = jnp.asarray(cr_h * scale, jnp.float32)
    wr_l = jnp.asarray(cr_l * scale, jnp.float32)
    wi_h = jnp.asarray(ci_h * scale, jnp.float32)
    wi_l = jnp.asarray(ci_l * scale, jnp.float32)

    shape = xr[0].shape  # [..., n]
    zero = jnp.zeros(shape, jnp.float32)

    def body(j, acc):
        ar_h, ar_l, ai_h, ai_l = acc
        # x[.., j] broadcast against weight row W[j, :] -> [.., n]
        xj_r = (jax.lax.dynamic_index_in_dim(xr[0], j, -1, keepdims=True),
                jax.lax.dynamic_index_in_dim(xr[1], j, -1, keepdims=True))
        xj_i = (jax.lax.dynamic_index_in_dim(xi[0], j, -1, keepdims=True),
                jax.lax.dynamic_index_in_dim(xi[1], j, -1, keepdims=True))
        w_r = (jax.lax.dynamic_index_in_dim(wr_h, j, 0, keepdims=False),
               jax.lax.dynamic_index_in_dim(wr_l, j, 0, keepdims=False))
        w_i = (jax.lax.dynamic_index_in_dim(wi_h, j, 0, keepdims=False),
               jax.lax.dynamic_index_in_dim(wi_l, j, 0, keepdims=False))
        pr, pi = cdf_mul(xj_r, xj_i, w_r, w_i)
        nr = df_add((ar_h, ar_l), pr)
        ni = df_add((ai_h, ai_l), pi)
        return nr[0], nr[1], ni[0], ni[1]

    ar_h, ar_l, ai_h, ai_l = jax.lax.fori_loop(
        0, n, body, (zero, zero, zero, zero))
    return (ar_h, ar_l), (ai_h, ai_l)


def cfft_df(xr: Pair, xi: Pair, m: int, inverse: bool) -> Tuple[Pair, Pair]:
    """df64 complex FFT over the last axis, four-step factorization
    (same decomposition as ops.fft._cfft_fourstep, df arithmetic)."""
    if m & (m - 1):
        raise ValueError(f"pow2 sizes only, got {m}")
    if m <= 64:
        s = (1.0 / m) if inverse else 1.0
        return _dft_stage_df(xr, xi, m, inverse, scale=s)
    n1 = _df_split_factor(m)
    n2 = m // n1
    batch = xr[0].shape[:-1]

    def rs(a):
        return a.reshape(*batch, n1, n2)

    # view as [.., n1(j1), n2(j2)]; DFT over j1 -> transpose j1 to last
    yr = (jnp.swapaxes(rs(xr[0]), -1, -2), jnp.swapaxes(rs(xr[1]), -1, -2))
    yi = (jnp.swapaxes(rs(xi[0]), -1, -2), jnp.swapaxes(rs(xi[1]), -1, -2))
    ar, ai = _dft_stage_df(yr, yi, n1, inverse)  # [.., n2(j2), n1(k1)]

    tr_h, tr_l, ti_h, ti_l = _twiddle_df(m, n1, inverse)
    tw_r = (jnp.asarray(tr_h), jnp.asarray(tr_l))
    tw_i = (jnp.asarray(ti_h), jnp.asarray(ti_l))
    ar, ai = cdf_mul(ar, ai, tw_r, tw_i)

    # DFT over j2: transpose to [.., n1(k1), n2(j2)]
    ar = (jnp.swapaxes(ar[0], -1, -2), jnp.swapaxes(ar[1], -1, -2))
    ai = (jnp.swapaxes(ai[0], -1, -2), jnp.swapaxes(ai[1], -1, -2))
    s = (1.0 / m) if inverse else 1.0
    br, bi = _dft_stage_df(ar, ai, n2, inverse, scale=s)  # [.., k1, k2]

    # output index k = k2*n1 + k1 -> transpose back and flatten
    def fl(a):
        return jnp.swapaxes(a, -1, -2).reshape(*batch, m)

    return (fl(br[0]), fl(br[1])), (fl(bi[0]), fl(bi[1]))


# -- df64 real transforms (halfcomplex) -------------------------------------


@functools.lru_cache(maxsize=32)
def _half_twiddle_df(m: int):
    k = np.arange(m // 2)
    ang = -2.0 * np.pi * k / m
    cr_h, cr_l = split_f64(np.cos(ang))
    ci_h, ci_l = split_f64(np.sin(ang))
    return cr_h, cr_l, ci_h, ci_l


def rfft_hc_df(x: Pair, m: int) -> Tuple[Pair, Pair]:
    """df64 rfft of real df input [..., m] -> halfcomplex df planes
    [..., m//2] (lane 0 = (DC.re, Nyquist.re), like ops.fft.rfft_split_hc).
    Real-packing: one m/2 complex df FFT + untangle, all EFT."""
    h = m // 2
    zr = (x[0][..., 0::2], x[1][..., 0::2])
    zi = (x[0][..., 1::2], x[1][..., 1::2])
    zr, zi = cfft_df(zr, zi, h, inverse=False)

    def rev(p: Pair) -> Pair:
        return (jnp.concatenate([p[0][..., :1], p[0][..., :0:-1]], -1),
                jnp.concatenate([p[1][..., :1], p[1][..., :0:-1]], -1))

    zr_r, zi_r = rev(zr), rev(zi)
    ar = df_scale(df_add(zr, zr_r), 0.5)
    ai = df_scale(df_sub(zi, zi_r), 0.5)
    br = df_scale(df_add(zi, zi_r), 0.5)
    bi = df_scale(df_sub(zr_r, zr), 0.5)  # -0.5 (zr - zr_r)
    th_h, th_l, ti_h, ti_l = _half_twiddle_df(m)
    tw_r = (jnp.asarray(th_h), jnp.asarray(th_l))
    tw_i = (jnp.asarray(ti_h), jnp.asarray(ti_l))
    cr, ci = cdf_mul(br, bi, tw_r, tw_i)
    xr = df_add(ar, cr)  # bins 0..h-1
    xi = df_add(ai, ci)
    ny = df_sub((zr[0][..., :1], zr[1][..., :1]),
                (zi[0][..., :1], zi[1][..., :1]))  # X[h] = Re Z0 - Im Z0
    # halfcomplex: re plane = xr, im plane = [Nyquist, xi[1:]]
    hi_plane = (jnp.concatenate([ny[0], xi[0][..., 1:]], -1),
                jnp.concatenate([ny[1], xi[1][..., 1:]], -1))
    return xr, hi_plane


def irfft_hc_df(hr: Pair, hi: Pair, m: int) -> Pair:
    """df64 inverse of rfft_hc_df: halfcomplex df planes [..., m//2] ->
    real df [..., m]. Inverse real-packing: re-tangle + one m/2 inverse
    complex df FFT + interleave."""
    h = m // 2
    ny = (hi[0][..., :1], hi[1][..., :1])
    zero1 = jnp.zeros_like(ny[0])
    # full planes [.., h+1]
    yr = (jnp.concatenate([hr[0], ny[0]], -1),
          jnp.concatenate([hr[1], ny[1]], -1))
    yi = (jnp.concatenate([zero1, hi[0][..., 1:], zero1], -1),
          jnp.concatenate([zero1, hi[1][..., 1:], zero1], -1))

    def sl(p: Pair, s) -> Pair:
        return (p[0][..., s], p[1][..., s])

    xr_k, xi_k = sl(yr, slice(0, h)), sl(yi, slice(0, h))
    xr_rev = sl(yr, slice(h, 0, -1))
    xi_rev = sl(yi, slice(h, 0, -1))
    ar = df_scale(df_add(xr_k, xr_rev), 0.5)
    ai = df_scale(df_sub(xi_k, xi_rev), 0.5)
    dr = df_scale(df_sub(xr_k, xr_rev), 0.5)
    di = df_scale(df_add(xi_k, xi_rev), 0.5)
    th_h, th_l, ti_h, ti_l = _half_twiddle_df(m)
    tw_r = (jnp.asarray(th_h), jnp.asarray(th_l))
    tw_i = (-jnp.asarray(ti_h), -jnp.asarray(ti_l))  # conjugate
    er, ei = cdf_mul(dr, di, tw_r, tw_i)
    zr = df_sub(ar, ei)
    zi = df_add(ai, er)
    zr, zi = cfft_df(zr, zi, h, inverse=True)
    # interleave: out[2t] = Re Z[t], out[2t+1] = Im Z[t]
    hi_s = jnp.stack([zr[0], zi[0]], axis=-1).reshape(*zr[0].shape[:-1], m)
    lo_s = jnp.stack([zr[1], zi[1]], axis=-1).reshape(*zr[1].shape[:-1], m)
    return hi_s, lo_s
