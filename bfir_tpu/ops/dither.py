"""TPDF dither + error-feedback requantization.

Device equivalent of the reference's ``brutefir/dither.{cpp,hpp}``:

- random table + randmap  -> ``dither.cpp:29-103``. The reference draws int8
  bytes from a Tausworthe PRNG and adds ``randmap[b[i] - b[i-1]]`` to each
  sample, where the 511-entry map is exactly
  ``d(diff) = 0.5 + (diff + 1)/255`` (verified against the table fill at
  dither.cpp:77-103 including the 1.5 endpoint). The *difference of
  consecutive* uniform bytes makes the dither triangular (TPDF) *and*
  first-difference high-passed — that, plus the {1,-1} error feedback, is
  the "hp tpdf" scheme.
- error feedback          -> ``dither.cpp:154-156,209``: x' = x + e0 - e1;
  e1 <- e0; e0 <- x' - q.
- quantizer               -> trunc-based: q = trunc(d) for d >= 0 and
  q = trunc(d) - 1 for d < 0 (dither.cpp:163-207), i.e. floor() except that
  exact negative integers land one step lower — reproduced bit-exactly.
- mid-tread no-dither     -> add 0.5 then the same truncation
  (dither.cpp:214-274).
- clipping + overflow     -> samples beyond [imin, imax] clip and bump the
  per-channel overflow counters / peak trackers (``bfoverflow_t``,
  global.h: overflow struct; accounting dither.cpp:163-207).

PRNG divergence (documented per SURVEY.md §7 hard-parts (a)): the reference
uses GSL's Tausworthe generator seeded with 1 (dither.cpp:418-449); we use
JAX's counter-based threefry so dither is reproducible *and* parallel across
channels/blocks. The dither statistics (triangular, 2-LSB peak-to-peak,
first-difference spectrum) match; the exact byte stream does not.

The error feedback is inherently sequential per sample -> ``lax.scan`` over
the block (vectorized across channels). Dither is off in the reference's
plugin path (float output, foo_dsp_bfir.cpp:287), so this op is outside the
streaming hot loop unless integer output is requested.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class DitherState(NamedTuple):
    """Per-channel dither state (reference ``dither_state_t``, global.h)."""

    e0: jax.Array  # previous quantization error (sf[0])
    e1: jax.Array  # error before that (sf[1])
    prev_byte: jax.Array  # last random byte of the previous block, int32 [C]
    key: jax.Array  # threefry key advanced per block


class OverflowStats(NamedTuple):
    """Per-channel clip accounting (reference ``bfoverflow_t``; reported by
    brutefir::print_overflows, brutefir.cpp:585-629)."""

    n_overflows: jax.Array  # int32 [C]
    largest: jax.Array  # float [C] — largest clipped magnitude
    intlargest: jax.Array  # int32 [C] — largest emitted |integer|


def init_dither_state(n_channels: int, seed: int = 1, dtype=jnp.float32) -> DitherState:
    key = jax.random.PRNGKey(seed)
    kb, key = jax.random.split(key)
    prev = jax.random.randint(kb, (n_channels,), -128, 128, dtype=jnp.int32)
    return DitherState(
        e0=jnp.zeros((n_channels,), dtype=dtype),
        e1=jnp.zeros((n_channels,), dtype=dtype),
        prev_byte=prev,
        key=key,
    )


def init_overflow_stats(n_channels: int, dtype=jnp.float32) -> OverflowStats:
    return OverflowStats(
        n_overflows=jnp.zeros((n_channels,), dtype=jnp.int32),
        largest=jnp.zeros((n_channels,), dtype=dtype),
        intlargest=jnp.zeros((n_channels,), dtype=jnp.int32),
    )


def _trunc_quantize(d):
    """q = trunc(d), minus 1 when d < 0 (dither.cpp:163-207)."""
    return jnp.where(d < 0, jnp.ceil(d) - 1.0, jnp.floor(d))


def _clip_account(d, imin, imax, of: OverflowStats):
    """Clip ``d`` to [imin, imax] with reference overflow accounting
    (dither.cpp:163-207: clipped samples bump n_overflows and track the
    largest clipped magnitude; in-range samples track the largest integer)."""
    q = _trunc_quantize(d)
    clip_lo = d <= imin
    clip_hi = d > imax
    clipped = clip_lo | clip_hi
    q = jnp.where(clip_lo, imin, jnp.where(clip_hi, imax, q))
    n_of = of.n_overflows + clipped.astype(jnp.int32)
    largest = jnp.where(clipped, jnp.maximum(of.largest, jnp.abs(d)), of.largest)
    intlargest = jnp.where(
        clipped, of.intlargest, jnp.maximum(of.intlargest, jnp.abs(q).astype(jnp.int32))
    )
    return q, OverflowStats(n_of, largest.astype(of.largest.dtype), intlargest)


def quantize_hp_tpdf(
    x: jax.Array,
    imin: float,
    imax: float,
    state: DitherState,
    of: OverflowStats,
) -> Tuple[jax.Array, DitherState, OverflowStats]:
    """Requantize ``x`` [C, N] (already scaled to integer full-scale units)
    with high-passed TPDF dither + {1,-1} error feedback.

    Returns (int32 samples [C, N], new_state, new_overflow_stats).
    """
    c, n = x.shape
    dtype = x.dtype
    kb, knext = jax.random.split(state.key)
    bytes_blk = jax.random.randint(kb, (c, n), -128, 128, dtype=jnp.int32)
    all_bytes = jnp.concatenate([state.prev_byte[:, None], bytes_blk], axis=1)
    diff = all_bytes[:, 1:] - all_bytes[:, :-1]  # [C, N]
    dither_vals = (0.5 + (diff.astype(dtype) + 1.0) / 255.0)  # randmap closed form

    imin_f = jnp.asarray(imin, dtype)
    imax_f = jnp.asarray(imax, dtype)

    def step(carry, inp):
        e0, e1, of_ = carry
        xs, dv = inp  # [C] each
        xp = xs + e0 - e1  # error feedback (dither.cpp:154-155)
        d = xp + dv
        q, of_ = _clip_account(d, imin_f, imax_f, of_)
        new_e1 = e0
        new_e0 = xp - q  # dither.cpp:209
        return (new_e0, new_e1, of_), q

    (e0, e1, of_out), q = jax.lax.scan(
        step, (state.e0, state.e1, of), (x.T, dither_vals.T)
    )
    new_state = DitherState(e0=e0, e1=e1, prev_byte=bytes_blk[:, -1], key=knext)
    return q.T.astype(jnp.int32), new_state, of_out


def quantize_no_dither(
    x: jax.Array,
    imin: float,
    imax: float,
    of: OverflowStats,
) -> Tuple[jax.Array, OverflowStats]:
    """Mid-tread requantization without dither (dither.cpp:214-274):
    add 0.5, truncate (with the negative-integer quirk), clip, account.
    Fully vectorized — no sequential state.
    """
    dtype = x.dtype
    d = x + jnp.asarray(0.5, dtype)
    q = _trunc_quantize(d)
    clip_lo = d <= imin
    clip_hi = d > imax
    clipped = clip_lo | clip_hi
    q = jnp.where(clip_lo, imin, jnp.where(clip_hi, imax, q))
    n_of = of.n_overflows + clipped.astype(jnp.int32).sum(axis=1)
    mag = jnp.where(clipped, jnp.abs(d), 0.0)
    largest = jnp.maximum(of.largest, mag.max(axis=1).astype(of.largest.dtype))
    largest = jnp.where(clipped.any(axis=1), largest, of.largest)
    intmag = jnp.where(clipped, 0, jnp.abs(q).astype(jnp.int32))
    intlargest = jnp.maximum(of.intlargest, intmag.max(axis=1))
    return q.astype(jnp.int32), OverflowStats(n_of, largest, intlargest)
