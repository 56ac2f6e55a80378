"""FFT provider: XLA's FFT (cuFFT on the GPU) or DFT-as-matmul.

The reference leans on FFTW's r2r halfcomplex transforms with wisdom tuning
(``fftw_convolver.cpp:51-137,653-695``). Two formulations live here:

1. ``jnp.fft`` (XLA's FFT op): cuFFT on the GPU, XLA's own FFT on the CPU.
   The default everywhere.
2. DFT-as-matmul: X = x @ W with precomputed trig weight matrices, and for
   larger power-of-two sizes the four-step (Bailey) factorization with a
   radix-4 tail — every stage a dense matrix product at explicit HIGHEST
   precision. These do several times an FFT's FLOPs; they run only when
   ``set_mode("matmul")`` (or ``BFIR_FFT_MODE=matmul``) selects them,
   which the tests use to check them against numpy. The df64 path
   (``ops.df64``) mirrors the four-step decomposition in double-float
   arithmetic.

Dispatch is at trace time.

All transforms follow numpy conventions: ``rfft``/``irfft`` over the last
axis with irfft carrying the 1/N normalization (the reference folds 1/n_fft
into its coefficient spectra instead, fftw_convolver.cpp:521-523 — same net
gain), and ``fft``/``ifft`` over an arbitrary axis for the block-axis
convolution in ``core.convolver.process_batch``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Force mode for tests/benchmarks: "auto" | "xla" | "matmul"
_FORCE = os.environ.get("BFIR_FFT_MODE", "auto")


def set_mode(mode: str) -> None:
    global _FORCE
    if mode not in ("auto", "xla", "matmul"):
        raise ValueError(mode)
    _FORCE = mode


def _use_matmul() -> bool:
    return _FORCE == "matmul"


# DFT matmul precision: HIGHEST keeps full float32 products (a GPU would
# otherwise contract in TF32).
_MATMUL_PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=32)
def _rdft_weights(m: int, dtype: str):
    """Real-input DFT weights: cos/sin matrices [M, M//2+1]."""
    n = np.arange(m)[:, None]
    k = np.arange(m // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / m
    return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))


@functools.lru_cache(maxsize=32)
def _irdft_weights(m: int, dtype: str):
    """Inverse real DFT weights [M//2+1, M] for real output.

    x[n] = 1/M * sum_k w_k * (Re X_k cos(2pi k n/M) - Im X_k sin(2pi k n/M)),
    w_0 = w_{M/2} = 1, else 2.
    """
    f = m // 2 + 1
    k = np.arange(f)[:, None]
    n = np.arange(m)[None, :]
    ang = 2.0 * np.pi * k * n / m
    w = np.full((f, 1), 2.0)
    w[0, 0] = 1.0
    if m % 2 == 0:
        w[-1, 0] = 1.0
    wr = (w * np.cos(ang) / m).astype(dtype)
    wi = (-w * np.sin(ang) / m).astype(dtype)
    return wr, wi


@functools.lru_cache(maxsize=32)
def _cdft_weights(m: int, dtype: str, inverse: bool):
    n = np.arange(m)[:, None]
    k = np.arange(m)[None, :]
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * n * k / m
    scale = (1.0 / m) if inverse else 1.0
    return (np.cos(ang).astype(dtype) * scale, np.sin(ang).astype(dtype) * scale)


def _pad_last(x, n: int):
    if x.shape[-1] == n:
        return x
    if x.shape[-1] > n:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
    return jnp.pad(x, pad)


def rfft(x: jax.Array, n: Optional[int] = None, axis: int = -1) -> jax.Array:
    if not _use_matmul():
        return jnp.fft.rfft(x, n=n, axis=axis)
    if axis != -1 and axis != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
        return jnp.moveaxis(rfft(x, n=n, axis=-1), -1, axis)
    m = n or x.shape[-1]
    xr, xi = rfft_split(x, n=m)
    return jax.lax.complex(xr, xi)


def irfft(y: jax.Array, n: Optional[int] = None, axis: int = -1) -> jax.Array:
    if not _use_matmul():
        return jnp.fft.irfft(y, n=n, axis=axis)
    if axis != -1 and axis != y.ndim - 1:
        y = jnp.moveaxis(y, axis, -1)
        return jnp.moveaxis(irfft(y, n=n, axis=-1), -1, axis)
    m = n or 2 * (y.shape[-1] - 1)
    return irfft_split(jnp.real(y), jnp.imag(y), n=m)


# Above this size, use the four-step (Bailey) factorization instead of one
# dense DFT matmul: M = n1*n2 -> DFT_n1 stages + twiddles + DFT_n2 stages,
# all as batched matmuls. FLOPs drop from O(M^2) to O(M*(n1+n2)) per vector
# while every stage stays a dense matrix product.
_FOUR_STEP_MIN = 512


def _split_factor(m: int) -> int:
    """Largest power-of-two n1 <= sqrt(m) (m is a power of two here)."""
    n1 = 1
    while n1 * n1 <= m // 2:
        n1 *= 2
    return n1


@functools.lru_cache(maxsize=32)
def _twiddle(m: int, n1: int, dtype: str, inverse: bool):
    n2 = m // n1
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * k1 * k2 / m
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def _cmatmul(ar, ai, br, bi):
    """Complex matmul on split real/imag operands."""
    rr = jnp.matmul(ar, br, precision=_MATMUL_PRECISION) - jnp.matmul(
        ai, bi, precision=_MATMUL_PRECISION)
    ri = jnp.matmul(ar, bi, precision=_MATMUL_PRECISION) + jnp.matmul(
        ai, br, precision=_MATMUL_PRECISION)
    return rr, ri


def _cfft_fourstep_stage1(yr, yi, m: int, inverse: bool):
    """Stage 1 + twiddle of the balanced four-step (see _cfft_fourstep):
    returns (tr, ti) [.., n1, n2] indexed [k1, j2]."""
    rdt = yr.dtype.name
    n1 = _split_factor(m)
    n2 = m // n1
    fb = yr.shape[:-1]
    yr = yr.reshape(*fb, n1, n2)
    yi = yi.reshape(*fb, n1, n2)
    # DFT over j1 (axis -2): move to last axis for matmul
    yr_t = jnp.swapaxes(yr, -1, -2)  # [.., n2, n1]
    yi_t = jnp.swapaxes(yi, -1, -2)
    cr1, ci1 = _cdft_weights(n1, rdt, inverse)
    # forward small DFTs carry no scale; inverse scale folded at the end
    s1 = n1 if inverse else 1
    br1 = jnp.asarray(cr1 * s1)
    bi1 = jnp.asarray(ci1 * s1)
    ar, ai = _cmatmul(yr_t, yi_t, br1, bi1)  # [.., n2, n1] indexed [j2, k1]
    # twiddle W_m^{±j2*k1}
    twr, twi = _twiddle(m, n1, rdt, inverse)
    twr_j = jnp.asarray(twr).T  # [n2, n1] indexed [j2, k1]
    twi_j = jnp.asarray(twi).T
    tr = ar * twr_j - ai * twi_j
    ti = ar * twi_j + ai * twr_j
    # DFT over j2 next: [.., n1, n2] indexed [k1, j2]
    return jnp.swapaxes(tr, -1, -2), jnp.swapaxes(ti, -1, -2)


def _cfft_fourstep(yr, yi, m: int, inverse: bool, k2_range=None):
    """Four-step FFT over the last axis on split re/im arrays [..., M].

    ``k2_range=(lo, hi)`` restricts stage 2 to output-index chunks
    k = k2*n1 + k1 with k2 in [lo, hi) — the caller gets columns
    [lo*n1, hi*n1) only, with stage-2 FLOPs and writes cut pro rata
    (see ``ifft0_slice``)."""
    rdt = yr.dtype.name
    n1 = _split_factor(m)
    n2 = m // n1
    batch = yr.shape[:-1]
    # Flatten the batch to one axis (free for row-major data): every stage
    # is then a plain 2-D-batched product.
    flat = len(batch) > 1
    if flat:
        yr = yr.reshape(-1, m)
        yi = yi.reshape(-1, m)
    # step 1: view as [.., n2, n1] (column-major split: index = k2*n1 + k1
    # -> x[k1 stride n2?]). Standard decimation: x[j], j = j1*n2 + j2;
    # X[k2*n1 + k1] = sum_{j1,j2} x[j1*n2+j2] W_m^{(j1*n2+j2)(k1... } —
    # implement as: A[j2, j1] = x[j1*n2 + j2]; B = DFT_n1 over j1;
    # B *= twiddle(j2, k1); C = DFT_n2 over j2; X[k1*n2 + k2] = C[k2, k1].
    tr, ti = _cfft_fourstep_stage1(yr, yi, m, inverse)
    orr, oi = _cfft_fourstep_stage2(tr, ti, m, inverse, k2_range)
    mo = orr.shape[-1]
    return orr.reshape(*batch, mo), oi.reshape(*batch, mo)


def _cfft_fourstep_stage2(tr, ti, m: int, inverse: bool, k2_range=None):
    """Stage 2 + output transpose of the balanced four-step; ``tr``/``ti``
    are stage-1 outputs [.., n1, n2] (indexed [k1, j2]). Returns flattened
    [.., M'] planes."""
    rdt = tr.dtype.name
    n1 = _split_factor(m)
    n2 = m // n1
    cr2, ci2 = _cdft_weights(n2, rdt, inverse)
    s2 = n2 / m if inverse else 1  # total inverse scale = 1/m
    if k2_range is not None:  # emit only output columns with k2 in [lo, hi)
        lo, hi = k2_range
        cr2 = cr2[:, lo:hi]
        ci2 = ci2[:, lo:hi]
    br2 = jnp.asarray(cr2 * s2)
    bi2 = jnp.asarray(ci2 * s2)
    orr, oi = _cmatmul(tr, ti, br2, bi2)  # [.., n1, n2] indexed [k1, k2]
    # output index is k2*n1 + k1 -> transpose before flattening
    mo = orr.shape[-1] * n1
    fb = orr.shape[:-2]
    orr = jnp.swapaxes(orr, -1, -2).reshape(*fb, mo)
    oi = jnp.swapaxes(oi, -1, -2).reshape(*fb, mo)
    return orr, oi


def _cfft_fourstep_r4(yr, yi, m: int, inverse: bool):
    """Four-step FFT over the last axis with a radix-4 butterfly tail:
    m = n1*4 with n1 = m/4.

    The balanced n1~sqrt(m) split gives narrow DFT products (K=N in
    {16, 32}); this variant does ONE wide [.., 4, n1] @ [n1, n1] product
    (n1 >= 128 for m >= 512) plus a 4-point DFT whose twiddles are all
    {±1, ±i} — pure adds/subs that fuse into neighbors.
    Same decomposition as _cfft_fourstep (j = j1*4 + j2, k = k2*n1 + k1);
    the butterfly emits [.., k2, k1] directly, so no output transpose.
    """
    rdt = yr.dtype.name
    n1 = m // 4
    batch = yr.shape[:-1]
    if len(batch) > 1:  # see _cfft_fourstep's flatten note (backend bug)
        yr = yr.reshape(-1, m)
        yi = yi.reshape(-1, m)
    fb = yr.shape[:-1]
    yr = yr.reshape(*fb, n1, 4)
    yi = yi.reshape(*fb, n1, 4)
    yr_t = jnp.swapaxes(yr, -1, -2)  # [.., 4(j2), n1(j1)]
    yi_t = jnp.swapaxes(yi, -1, -2)
    cr1, ci1 = _cdft_weights(n1, rdt, inverse)
    s1 = n1 if inverse else 1  # unscale the table's 1/n1; apply 1/m at tail
    ar, ai = _cmatmul(yr_t, yi_t, jnp.asarray(cr1 * s1), jnp.asarray(ci1 * s1))
    # twiddle W_m^{±j2*k1}: _twiddle(m, n1) is [n1(k1), 4(k2-like j2)] — we
    # need [j2, k1], i.e. its transpose
    twr, twi = _twiddle(m, n1, rdt, inverse)
    twr_j = jnp.asarray(twr).T  # [4(j2), n1(k1)]
    twi_j = jnp.asarray(twi).T
    tr = ar * twr_j - ai * twi_j  # [.., j2, k1]
    ti = ar * twi_j + ai * twr_j
    t0r, t1r, t2r, t3r = tr[..., 0, :], tr[..., 1, :], tr[..., 2, :], tr[..., 3, :]
    t0i, t1i, t2i, t3i = ti[..., 0, :], ti[..., 1, :], ti[..., 2, :], ti[..., 3, :]
    # radix-4 DFT over j2: X[k2] = sum_j2 t[j2] W4^{s j2 k2}, s = ±1;
    # W4^{-1} = -i (forward), +i (inverse)
    er, ei = t0r + t2r, t0i + t2i        # even sums
    fr_, fi_ = t0r - t2r, t0i - t2i      # even diffs
    gr_, gi_ = t1r + t3r, t1i + t3i      # odd sums
    hr_, hi_ = t1r - t3r, t1i - t3i      # odd diffs
    # (±i)*(hr + i hi) = mp (hi? ...): -i*z = (zi, -zr); +i*z = (-zi, zr)
    if inverse:
        whr, whi = -hi_, hr_
    else:
        whr, whi = hi_, -hr_
    s = (1.0 / m) if inverse else 1.0
    x0r, x0i = er + gr_, ei + gi_
    x1r, x1i = fr_ + whr, fi_ + whi
    x2r, x2i = er - gr_, ei - gi_
    x3r, x3i = fr_ - whr, fi_ - whi
    orr = jnp.stack([x0r, x1r, x2r, x3r], axis=-2)  # [.., k2, k1]
    oi = jnp.stack([x0i, x1i, x2i, x3i], axis=-2)
    if inverse:
        orr = orr * s
        oi = oi * s
    return orr.reshape(*batch, m), oi.reshape(*batch, m)


@functools.lru_cache(maxsize=32)
def _r4_folded_weights(m: int, dtype: str, inverse: bool):
    """Stage-1 DFT weights with the four-step twiddle FOLDED per j2 branch:
    B_j2[j1, k1] = W_n1^{s j1 k1} * W_m^{s j2 k1} (s = sign). Stacked
    [4, n1, n1]; using these as a batched matmul removes the separate
    twiddle elementwise pass of ``_cfft_fourstep_r4`` entirely — one fewer
    full sweep of the [.., m] intermediate through memory."""
    n1 = m // 4
    j1 = np.arange(n1)[:, None]
    k1 = np.arange(n1)[None, :]
    sign = 2.0 if inverse else -2.0
    base = sign * np.pi * j1 * k1 / n1  # W_n1^{±j1 k1}
    out_r = np.empty((4, n1, n1), dtype=dtype)
    out_i = np.empty((4, n1, n1), dtype=dtype)
    for j2 in range(4):
        tw = sign * np.pi * j2 * k1 / m  # W_m^{±j2 k1}
        ang = base + tw
        out_r[j2] = np.cos(ang)
        out_i[j2] = np.sin(ang)
    return out_r, out_i


def _bmatmul(a, b):
    """Batched matmul [.., q, j] x [q, j, k] -> [q, .., k] (dot_general
    leads with the batch dims; callers index the q axis first)."""
    dn = (((a.ndim - 1,), (1,)), ((a.ndim - 2,), (0,)))
    return jax.lax.dot_general(a, b, dn, precision=_MATMUL_PRECISION)


def _cfft_fourstep_r4f(yr, yi, m: int, inverse: bool):
    """``_cfft_fourstep_r4`` with the twiddle folded into per-j2 stage-1
    weight matrices (see ``_r4_folded_weights``): the stage-1 matmul becomes
    a batch-4 dot_general against [4, n1, n1] weights and the twiddle
    multiply disappears. Same decomposition/indexing as _cfft_fourstep_r4."""
    rdt = yr.dtype.name
    n1 = m // 4
    batch = yr.shape[:-1]
    if len(batch) > 1:  # see _cfft_fourstep's flatten note (backend bug)
        yr = yr.reshape(-1, m)
        yi = yi.reshape(-1, m)
    fb = yr.shape[:-1]
    # [.., j2(4), j1(n1)]: j = j1*4 + j2
    yr_t = jnp.swapaxes(yr.reshape(*fb, n1, 4), -1, -2)
    yi_t = jnp.swapaxes(yi.reshape(*fb, n1, 4), -1, -2)
    wr, wi = _r4_folded_weights(m, rdt, inverse)
    # tables are raw cos/sin (no 1/n1 folded); the whole 1/m lands at the
    # butterfly tail for the inverse
    br = jnp.asarray(wr)
    bi = jnp.asarray(wi)
    tr = _bmatmul(yr_t, br) - _bmatmul(yi_t, bi)
    ti = _bmatmul(yr_t, bi) + _bmatmul(yi_t, br)
    # radix-4 butterfly over j2 (twiddle already applied): identical math to
    # _cfft_fourstep_r4's tail; tr/ti are [j2(4), .., k1] (batch-led)
    t0r, t1r, t2r, t3r = tr[0], tr[1], tr[2], tr[3]
    t0i, t1i, t2i, t3i = ti[0], ti[1], ti[2], ti[3]
    er, ei = t0r + t2r, t0i + t2i
    fr_, fi_ = t0r - t2r, t0i - t2i
    gr_, gi_ = t1r + t3r, t1i + t3i
    hr_, hi_ = t1r - t3r, t1i - t3i
    if inverse:
        whr, whi = -hi_, hr_
    else:
        whr, whi = hi_, -hr_
    s = (1.0 / m) if inverse else 1.0
    x0r, x0i = er + gr_, ei + gi_
    x1r, x1i = fr_ + whr, fi_ + whi
    x2r, x2i = er - gr_, ei - gi_
    x3r, x3i = fr_ - whr, fi_ - whi
    orr = jnp.stack([x0r, x1r, x2r, x3r], axis=-2)  # [.., k2, k1]
    oi = jnp.stack([x0i, x1i, x2i, x3i], axis=-2)
    if inverse:
        orr = orr * s
        oi = oi * s
    return orr.reshape(*batch, m), oi.reshape(*batch, m)


# Above this h the radix-4 tail's single [h/4, h/4] stage-1 product costs
# far more FLOPs than the balanced split: at h = 8192 r4 does
# 4·2·h·(h/4) = 134 MFLOP/row while the balanced split (n1 = 64, n2 = 128)
# does 2·4·h·(n1+n2) ≈ 12.6 MFLOP/row.
_R4_MAX_H = 4096


def _cfft_pow2_last(zr, zi, h: int, inverse: bool):
    """Pow2 complex FFT over the last axis as matrix products: the
    radix-4-tail four-step (folded twiddles) for
    512 <= h <= _R4_MAX_H, where the balanced split's factors are narrow;
    the balanced four-step above, where it needs ~10x fewer FLOPs. Both are
    checked against numpy in tests/test_fft.py."""
    if h % 4 == 0 and 128 <= h // 4 and h <= _R4_MAX_H:
        return _cfft_fourstep_r4f(zr, zi, h, inverse)
    return _cfft_fourstep(zr, zi, h, inverse)


def _pad_first(x, n: int):
    if x.shape[0] == n:
        return x
    if x.shape[0] > n:
        return x[:n]
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def _lmatmul(w, x):
    """w [K, J] contracted with x [.., J, R..] over x's axis -2? No —
    leading-axis contraction: x [J, R], out [K, R]."""
    return jnp.matmul(w, x, precision=_MATMUL_PRECISION)


def _clmatmul(wr, wi, xr, xi):
    """Complex left-matmul on split planes: (wr + i wi) @ (xr + i xi)."""
    rr = _lmatmul(wr, xr) - _lmatmul(wi, xi)
    ri = _lmatmul(wr, xi) + _lmatmul(wi, xr)
    return rr, ri


def _cfft0_fourstep(yr, yi, m: int, inverse: bool, k2_range=None):
    """Four-step FFT over the LEADING axis on split re/im arrays [M, ...].

    The transform along axis 0 is a left-matmul (X = W @ x), so — unlike the
    last-axis path, which needs moveaxis round-trips for big batch tensors —
    this factorization is completely transpose-free: with input index
    j = j1*n2 + j2 and output index k = k2*n1 + k1, stage 1 is a left matmul
    over j1, the twiddle is a broadcast multiply, and stage 2's dot_general
    contraction over j2 lands the result directly in (k2, k1, rest) order,
    which flattens to the natural output index. This is the hot transform of
    ``core.convolver.process_batch`` (block-axis convolution theorem).
    """
    rdt = yr.dtype.name
    n1 = _split_factor(m)
    n2 = m // n1
    rest = yr.shape[1:]
    r = int(np.prod(rest)) if rest else 1
    x3r = yr.reshape(n1, n2 * r)
    x3i = yi.reshape(n1, n2 * r)
    # stage 1: DFT_{n1} over j1 (W1[k1, j1] — matrices are symmetric, but
    # index for clarity); inverse scale folded into stage 2
    cr1, ci1 = _cdft_weights(n1, rdt, inverse)
    s1 = n1 if inverse else 1  # _cdft_weights folds 1/n1 into inverse tables
    ar, ai = _clmatmul(jnp.asarray(cr1 * s1), jnp.asarray(ci1 * s1), x3r, x3i)
    ar = ar.reshape(n1, n2, r)  # [k1, j2, R]
    ai = ai.reshape(n1, n2, r)
    # twiddle W_m^{±k1*j2} — same table as the last-axis path
    twr, twi = _twiddle(m, n1, rdt, inverse)
    twr = jnp.asarray(twr)[:, :, None]  # [n1(k1), n2(j2), 1]
    twi = jnp.asarray(twi)[:, :, None]
    tr = ar * twr - ai * twi
    ti = ar * twi + ai * twr
    # stage 2: X[k2*n1 + k1] = sum_j2 W2[k2, j2] T[k1, j2, R] — contract
    # T's middle axis; output comes out as [k2, k1, R], flattening straight
    # to the four-step output index. (dot_general: lhs free k2, rhs free k1,R)
    cr2, ci2 = _cdft_weights(n2, rdt, inverse)
    s2 = n2 / m if inverse else 1  # total inverse scale = 1/m
    if k2_range is not None:  # emit only output rows k2 in [lo, hi)
        lo, hi = k2_range
        cr2 = cr2[lo:hi]
        ci2 = ci2[lo:hi]
    w2r = jnp.asarray(cr2 * s2)
    w2i = jnp.asarray(ci2 * s2)
    dn = (((1,), (1,)), ((), ()))

    def dg(w, t):
        return jax.lax.dot_general(w, t, dn, precision=_MATMUL_PRECISION)

    orr = dg(w2r, tr) - dg(w2i, ti)  # [n2(k2), n1(k1), R]
    oi = dg(w2r, ti) + dg(w2i, tr)
    mo = orr.shape[0] * n1
    return orr.reshape((mo,) + rest), oi.reshape((mo,) + rest)


def _cfft0(y: jax.Array, n: Optional[int], inverse: bool) -> jax.Array:
    """FFT over the leading axis via left-matmuls (see _cfft0_fourstep).

    A tested alternative (``fft0``/``ifft0``); the public ``fft``/``ifft``
    route axis-0 transforms through moveaxis instead."""
    m = n or y.shape[0]
    y = _pad_first(y, m)
    rdt = "float32" if y.dtype == jnp.complex64 else "float64"
    yr, yi = jnp.real(y), jnp.imag(y)
    if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
        orr, oi = _cfft0_fourstep(yr, yi, m, inverse)
        return jax.lax.complex(orr, oi)
    cr, ci = _cdft_weights(m, rdt, inverse)
    rest = y.shape[1:]
    r = int(np.prod(rest)) if rest else 1
    orr, oi = _clmatmul(jnp.asarray(cr), jnp.asarray(ci),
                        yr.reshape(m, r), yi.reshape(m, r))
    return jax.lax.complex(orr.reshape((m,) + rest), oi.reshape((m,) + rest))


def fft0(y, n=None):
    """Leading-axis FFT via left-matmuls (alternative path; see _cfft0)."""
    return _cfft0(jnp.asarray(y, dtype=jnp.result_type(y, 1j)), n, inverse=False)


def ifft0(y, n=None):
    """Leading-axis inverse FFT via left-matmuls (alternative path)."""
    return _cfft0(jnp.asarray(y, dtype=jnp.result_type(y, 1j)), n, inverse=True)


def cfft_split(yr: jax.Array, yi: jax.Array, n: Optional[int] = None,
               inverse: bool = False, cols=None):
    """Complex FFT over the LAST axis on split re/im planes -> (re, im).

    The split-plane spelling of ``fft``/``ifft``: no complex dtype
    anywhere.

    ``cols=(start, count)`` returns only output columns
    [start, start+count): the selection folds into the final DFT-stage
    matmul (weight-column slice on the dense path, k2-chunk restriction on
    the four-step path), cutting its FLOPs and writes pro rata.
    """
    m = n or yr.shape[-1]
    yr = _pad_last(yr, m)
    yi = _pad_last(yi, m)
    if cols is not None:
        start, count = cols
        if start < 0 or count < 1 or start + count > m:
            raise ValueError(f"cols [{start}, {start + count}) out of range for {m}")
    if not _use_matmul():
        fn = jnp.fft.ifft if inverse else jnp.fft.fft
        z = fn(jax.lax.complex(yr, yi), n=m, axis=-1)
        if cols is not None:
            z = z[..., cols[0] : cols[0] + cols[1]]
        return jnp.real(z), jnp.imag(z)
    rdt = yr.dtype.name
    if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
        if cols is None:
            return _cfft_pow2_last(yr, yi, m, inverse)
        start, count = cols
        n1 = _split_factor(m)
        k2_lo = start // n1
        k2_hi = -(-(start + count) // n1)
        orr, oi = _cfft_fourstep(yr, yi, m, inverse, k2_range=(k2_lo, k2_hi))
        off = start - k2_lo * n1
        return orr[..., off : off + count], oi[..., off : off + count]
    cr, ci = _cdft_weights(m, rdt, inverse)
    if cols is not None:
        start, count = cols
        cr = cr[:, start : start + count]
        ci = ci[:, start : start + count]
    return _cmatmul(yr, yi, jnp.asarray(cr), jnp.asarray(ci))


def fft0_split(yr: jax.Array, yi: jax.Array, n: Optional[int] = None,
               inverse: bool = False, rows=None):
    """Complex FFT over the LEADING axis on split re/im planes.

    ``rows=(start, count)`` returns only output rows [start, start+count)
    (folded into the final DFT stage on the matmul path — see cfft_split).
    The matmul path transposes to the last axis internally (XLA cancels the
    adjacent transpose pairs across the elementwise stages between two
    transforms); the XLA-FFT path works on the natural layout directly,
    which the CPU FFT thunk requires (dim0-major operand RET_CHECK).
    """
    m = n or yr.shape[0]
    yr = _pad_first(yr, m)
    yi = _pad_first(yi, m)
    if not _use_matmul():
        fn = jnp.fft.ifft if inverse else jnp.fft.fft
        z = fn(jax.lax.complex(yr, yi), n=m, axis=0)
        if rows is not None:
            z = z[rows[0] : rows[0] + rows[1]]
        return jnp.real(z), jnp.imag(z)
    orr, oi = cfft_split(jnp.moveaxis(yr, 0, -1), jnp.moveaxis(yi, 0, -1),
                         n=m, inverse=inverse, cols=rows)
    return jnp.moveaxis(orr, -1, 0), jnp.moveaxis(oi, -1, 0)


def ifft0_slice(y: jax.Array, start: int, count: int) -> jax.Array:
    """``ifft(y, axis=0)[start : start + count]`` without materializing the
    full inverse transform.

    ``core.convolver.process_batch`` needs only B of the L = B + 2(P-1)
    block-axis inverse-FFT rows (the linear-convolution output region); on
    the matmul-DFT path the row selection folds into the final DFT-stage
    matmul, cutting its FLOPs and its HBM writes by ~L/B.
    """
    m = y.shape[0]
    if start < 0 or count < 1 or start + count > m:
        raise ValueError(f"rows [{start}, {start + count}) out of range for {m}")
    if not _use_matmul():
        return jnp.fft.ifft(y, axis=0)[start : start + count]
    rdt = "float32" if y.dtype == jnp.complex64 else "float64"
    yt = jnp.moveaxis(y, 0, -1)  # batched right-matmul form (see _cfft0)
    yr, yi = jnp.real(yt), jnp.imag(yt)
    if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
        n1 = _split_factor(m)
        # output index k = k2*n1 + k1: restrict stage 2 to the k2 chunks
        # covering [start, start+count), then slice the remainder
        k2_lo = start // n1
        k2_hi = -(-(start + count) // n1)
        orr, oi = _cfft_fourstep(yr, yi, m, inverse=True, k2_range=(k2_lo, k2_hi))
        off = start - k2_lo * n1
        out = jax.lax.complex(orr, oi)[..., off : off + count]
    else:
        cr, ci = _cdft_weights(m, rdt, inverse=True)
        out_r = (
            jnp.matmul(yr, jnp.asarray(cr[:, start : start + count]),
                       precision=_MATMUL_PRECISION)
            - jnp.matmul(yi, jnp.asarray(ci[:, start : start + count]),
                         precision=_MATMUL_PRECISION)
        )
        out_i = (
            jnp.matmul(yr, jnp.asarray(ci[:, start : start + count]),
                       precision=_MATMUL_PRECISION)
            + jnp.matmul(yi, jnp.asarray(cr[:, start : start + count]),
                         precision=_MATMUL_PRECISION)
        )
        out = jax.lax.complex(out_r, out_i)
    return jnp.moveaxis(out, -1, 0)


def _cfft(y: jax.Array, n: Optional[int], axis: int, inverse: bool) -> jax.Array:
    if not _use_matmul():
        fn = jnp.fft.ifft if inverse else jnp.fft.fft
        return fn(y, n=n, axis=axis)
    if axis != -1 and axis != y.ndim - 1:
        y = jnp.moveaxis(y, axis, -1)
        return jnp.moveaxis(_cfft(y, n, -1, inverse), -1, axis)
    m = n or y.shape[-1]
    y = _pad_last(y, m)
    cdt = y.dtype
    rdt = "float32" if cdt == jnp.complex64 else "float64"
    if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
        orr, oi = _cfft_pow2_last(jnp.real(y), jnp.imag(y), m, inverse)
        return jax.lax.complex(orr, oi)
    cr, ci = _cdft_weights(m, rdt, inverse)
    cr = jnp.asarray(cr)
    ci = jnp.asarray(ci)
    yr, yi = jnp.real(y), jnp.imag(y)
    out_r = (
        jnp.matmul(yr, cr, precision=_MATMUL_PRECISION)
        - jnp.matmul(yi, ci, precision=_MATMUL_PRECISION)
    )
    out_i = (
        jnp.matmul(yr, ci, precision=_MATMUL_PRECISION)
        + jnp.matmul(yi, cr, precision=_MATMUL_PRECISION)
    )
    return jax.lax.complex(out_r, out_i)


def fft(y, n=None, axis=-1):
    return _cfft(jnp.asarray(y, dtype=jnp.result_type(y, 1j)), n, axis, inverse=False)


def ifft(y, n=None, axis=-1):
    return _cfft(jnp.asarray(y, dtype=jnp.result_type(y, 1j)), n, axis, inverse=True)


# ---------------------------------------------------------------------------
# Split re/im API — the engines' representation.
#
# The streaming engines keep spectra as separate real/imag planes end to
# end (the halfcomplex packing below needs real planes). These entry points
# skip the lax.complex pack/unpack on the matmul path.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _half_twiddle(m: int, dtype: str):
    """e^{-2 pi i k / m} for k = 0..m//2-1 (the rfft-via-half-cfft unpack)."""
    k = np.arange(m // 2)
    ang = -2.0 * np.pi * k / m
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def rfft_split(x: jax.Array, n: Optional[int] = None):
    """rfft over the last axis -> (re, im), each [..., n//2 + 1] real.

    Large power-of-two sizes use the classic real-packing trick: pack
    even/odd samples as one complex vector, run a single M/2 complex
    four-step FFT, and untangle — half the transform work of a full-length
    complex FFT of the zero-extended input.
    """
    m = n or x.shape[-1]
    x = _pad_last(x, m)
    if _use_matmul():
        if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
            h = m // 2
            zr = x[..., 0::2]
            zi = x[..., 1::2]
            zr, zi = _cfft_pow2_last(zr, zi, h, inverse=False)
            # Z*[h-k] terms: index 0 maps to itself, rest reversed
            zr_rev = jnp.concatenate([zr[..., :1], zr[..., :0:-1]], axis=-1)
            zi_rev = jnp.concatenate([zi[..., :1], zi[..., :0:-1]], axis=-1)
            ar = 0.5 * (zr + zr_rev)
            ai = 0.5 * (zi - zi_rev)
            br = 0.5 * (zi + zi_rev)
            bi = -0.5 * (zr - zr_rev)
            twr, twi = _half_twiddle(m, x.dtype.name)
            twr = jnp.asarray(twr)
            twi = jnp.asarray(twi)
            xr = ar + twr * br - twi * bi
            xi = ai + twr * bi + twi * br
            # k = h bin: X[h] = Re Z[0] - Im Z[0]
            last_r = (zr[..., :1] - zi[..., :1])
            last_i = jnp.zeros_like(last_r)
            return (
                jnp.concatenate([xr, last_r], axis=-1),
                jnp.concatenate([xi, last_i], axis=-1),
            )
        cr, ci = _rdft_weights(m, x.dtype.name)
        return (
            jnp.matmul(x, jnp.asarray(cr), precision=_MATMUL_PRECISION),
            jnp.matmul(x, jnp.asarray(ci), precision=_MATMUL_PRECISION),
        )
    y = jnp.fft.rfft(x, n=m, axis=-1)
    return jnp.real(y), jnp.imag(y)


def irfft_split(yr: jax.Array, yi: jax.Array, n: Optional[int] = None) -> jax.Array:
    """Inverse rfft from split re/im planes -> real [..., n].

    Large sizes invert the real-packing trick: re-tangle the half spectrum
    into an M/2 complex vector, one M/2 inverse four-step FFT, interleave.
    """
    m = n or 2 * (yr.shape[-1] - 1)
    f = m // 2 + 1
    yr = _pad_last(yr, f)
    yi = _pad_last(yi, f)
    if _use_matmul():
        if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
            h = m // 2
            # A[k] = 0.5 (X[k] + X*[h-k]); iB[k] = 0.5 (X[k] - X*[h-k]);
            # Z[k] = A[k] + i e^{+2 pi i k/m} (iB[k]) ... derive on planes:
            xr_k = yr[..., :h]
            xi_k = yi[..., :h]
            xr_rev = yr[..., h:0:-1]  # X[h-k], k=0..h-1
            xi_rev = yi[..., h:0:-1]
            # X*[h-k] = (xr_rev, -xi_rev)
            ar = 0.5 * (xr_k + xr_rev)
            ai = 0.5 * (xi_k - xi_rev)
            dr = 0.5 * (xr_k - xr_rev)  # D = 0.5 (X[k] - X*[h-k])
            di = 0.5 * (xi_k + xi_rev)
            # Z[k] = A[k] + i W*[k] D[k], W* = e^{+2 pi i k/m}
            twr, twi = _half_twiddle(m, yr.dtype.name)
            twr = jnp.asarray(twr)
            twi = -jnp.asarray(twi)  # conjugate twiddle
            er = twr * dr - twi * di
            ei = twr * di + twi * dr
            zr = ar - ei
            zi = ai + er
            zr, zi = _cfft_pow2_last(zr, zi, h, inverse=True)
            out = jnp.stack([zr, zi], axis=-1).reshape(*zr.shape[:-1], m)
            return out
        wr, wi = _irdft_weights(m, yr.dtype.name)
        return (
            jnp.matmul(yr, jnp.asarray(wr), precision=_MATMUL_PRECISION)
            + jnp.matmul(yi, jnp.asarray(wi), precision=_MATMUL_PRECISION)
        )
    return jnp.fft.irfft(jax.lax.complex(yr, yi), n=m, axis=-1)


def irfft_split_tail(yr: jax.Array, yi: jax.Array, n: Optional[int] = None) -> jax.Array:
    """``irfft_split(yr, yi, n)[..., n//2:]`` — only the upper half.

    The overlap-save engine discards the lower half of every inverse
    transform (the circular-aliased region; reference keeps the upper half,
    fftw_convolver.cpp:405-466 via the cbuf layout). Folding the selection
    into the inverse halves the final DFT stage's FLOPs and writes: on the
    real-packing path output sample 2i(+1) is Re/Im Z[i], so the tail is
    exactly inverse-FFT rows i >= h/2 — a k2-chunk restriction of the
    four-step's last matmul.
    """
    m = n or 2 * (yr.shape[-1] - 1)
    f = m // 2 + 1
    yr = _pad_last(yr, f)
    yi = _pad_last(yi, f)
    if _use_matmul():
        if m >= _FOUR_STEP_MIN and (m & (m - 1)) == 0:
            h = m // 2
            xr_k = yr[..., :h]
            xi_k = yi[..., :h]
            xr_rev = yr[..., h:0:-1]
            xi_rev = yi[..., h:0:-1]
            ar = 0.5 * (xr_k + xr_rev)
            ai = 0.5 * (xi_k - xi_rev)
            dr = 0.5 * (xr_k - xr_rev)
            di = 0.5 * (xi_k + xi_rev)
            twr, twi = _half_twiddle(m, yr.dtype.name)
            twr = jnp.asarray(twr)
            twi = -jnp.asarray(twi)
            er = twr * dr - twi * di
            ei = twr * di + twi * dr
            zr = ar - ei
            zi = ai + er
            n1 = _split_factor(h)
            lo = (h // 2) // n1  # h/2 is a multiple of n1 for pow2 sizes
            zr, zi = _cfft_fourstep(zr, zi, h, inverse=True,
                                    k2_range=(lo, h // n1))
            return jnp.stack([zr, zi], axis=-1).reshape(*zr.shape[:-1], h)
        wr, wi = _irdft_weights(m, yr.dtype.name)
        return (
            jnp.matmul(yr, jnp.asarray(wr[:, m // 2 :]), precision=_MATMUL_PRECISION)
            + jnp.matmul(yi, jnp.asarray(wi[:, m // 2 :]), precision=_MATMUL_PRECISION)
        )
    return jnp.fft.irfft(jax.lax.complex(yr, yi), n=m, axis=-1)[..., m // 2 :]


def irfft_tail(y: jax.Array, n: Optional[int] = None) -> jax.Array:
    """``irfft(y, n, axis=-1)[..., n//2:]`` (see irfft_split_tail)."""
    return irfft_split_tail(jnp.real(y), jnp.imag(y), n=n)


# ---------------------------------------------------------------------------
# Halfcomplex split planes: FFTW's r2r "halfcomplex" idea on the split API.
#
# A real-input spectrum has imag(X[0]) = imag(X[n/2]) = 0, so the Nyquist
# bin's real part can ride in the DC bin's imaginary lane and the planes
# shrink from n/2+1 to exactly n/2 lanes. For the engine's n = 2048 that
# turns the MAC's frequency axis from 1025 (padded to 1152 for 128-wide
# tiles) into exactly 1024 — an 11.1% memory-traffic cut on the
# streaming hot loop's dominant arrays (ring + coeff planes). The reference
# gets the same effect from FFTW's halfcomplex r2r format
# (/root/reference/brutefir/fftw_convolver.cpp:76-79: rfftw-style plans;
# its MAC special-cases bins 0 and n/2 exactly like kernels.spectrum_mac's
# hc kernels do).
#
# These wrappers reuse the full-width transforms and repack at the (tiny)
# [C, F] boundary; the big [P, C, F] arrays live in hc form.
# ---------------------------------------------------------------------------


def rfft_split_hc(x: jax.Array, n: Optional[int] = None):
    """rfft over the last axis -> halfcomplex split planes [..., n//2].

    Lane 0 of the re plane is X[0].re; lane 0 of the im plane is X[n/2].re.
    """
    m = n or x.shape[-1]
    xr, xi = rfft_split(x, n=m)
    h = m // 2
    hr = xr[..., :h]
    hi = jnp.concatenate([xr[..., h : h + 1], xi[..., 1:h]], axis=-1)
    return hr, hi


def irfft_split_hc(hr: jax.Array, hi: jax.Array, n: Optional[int] = None) -> jax.Array:
    """Inverse rfft from halfcomplex split planes -> real [..., n].

    Accepts lane-padded planes (width >= n//2; extra lanes ignored).
    """
    m = n or 2 * hr.shape[-1]
    h = m // 2
    hr = hr[..., :h]
    hi = hi[..., :h]
    zero = jnp.zeros_like(hr[..., :1])
    yr = jnp.concatenate([hr, hi[..., :1]], axis=-1)
    yi = jnp.concatenate([zero, hi[..., 1:], zero], axis=-1)
    return irfft_split(yr, yi, n=m)


@functools.lru_cache(maxsize=16)
def _hc_tail_weights(m: int, dtype: str):
    """Direct half-DFT basis: halfcomplex planes [h] -> irfft(m) tail
    samples [m/2, m). Row k of (Wr, Wi) is the contribution of
    (hr[k], hi[k]); lane 0 carries (DC, Nyquist):

      x[t] = (1/m) [ X0 + Xny (-1)^t
                     + 2 sum_{k=1}^{h-1} (hr_k cos(2pi k t/m)
                                          - hi_k sin(2pi k t/m)) ]
    """
    h = m // 2
    t = np.arange(h, m)[None, :]  # output samples (the overlap-save tail)
    k = np.arange(h)[:, None]
    ang = 2.0 * np.pi * k * t / m
    wr = (2.0 / m) * np.cos(ang)
    wr[0, :] = 1.0 / m  # DC row (no doubling)
    wi = -(2.0 / m) * np.sin(ang)
    wi[0, :] = ((-1.0) ** t[0]) / m  # Nyquist rides lane 0 of the im plane
    return wr.astype(dtype), wi.astype(dtype)


def irfft_hc_tail(hr: jax.Array, hi: jax.Array, n: Optional[int] = None) -> jax.Array:
    """``irfft_split_hc(hr, hi, n)[..., n//2:]``: the overlap-save tail
    (reference: the cbuf tail copy, fftw_convolver.cpp:405-466).

    With the native FFT this is the full inverse plus a slice. On the
    matmul path it is ONE pair of dense products ([.., h] @ [h, h]) against
    the precomputed half-DFT tail basis, which halves the inverse work over
    the four-step chain. Lane-padded inputs accepted (extra lanes ignored).
    """
    m = n or 2 * hr.shape[-1]
    h = m // 2
    hr = hr[..., :h]
    hi = hi[..., :h]
    if not _use_matmul():
        return irfft_split_hc(hr, hi, n=m)[..., h:]
    wr, wi = _hc_tail_weights(m, hr.dtype.name)
    return (
        jnp.matmul(hr, jnp.asarray(wr), precision=_MATMUL_PRECISION)
        + jnp.matmul(hi, jnp.asarray(wi), precision=_MATMUL_PRECISION)
    )


# ---------------------------------------------------------------------------
# Complex-dtype helpers: device-born complex zeros and host transfers of
# complex arrays as two real planes.
# ---------------------------------------------------------------------------


def czeros(shape, dtype=jnp.complex64) -> jax.Array:
    """Device-born complex zeros (never crosses the host boundary)."""
    rdt = jnp.float32 if jnp.dtype(dtype) == jnp.complex64 else jnp.float64
    z = jnp.zeros(shape, dtype=rdt)
    return jax.lax.complex(z, z)


def to_numpy(x) -> np.ndarray:
    """Fetch any device array to host, splitting complex transfers."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return np.asarray(jnp.real(x)) + 1j * np.asarray(jnp.imag(x))
    return np.asarray(x)


def from_numpy_complex(x: np.ndarray) -> jax.Array:
    """Put a host complex array on device via two real transfers."""
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.complexfloating):
        return jnp.asarray(x)
    return jax.lax.complex(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))
