"""Partition MAC over the delayed-spectrum ring, and the streaming steps
built on it.

The streaming hot loop's dominant memory traffic is the frequency-domain
MAC (reference: the convolve/convolve_add loop, brutefir.cpp:279-300,
backed by the hand-unrolled SSE loops fftw_convolver.cpp:1429-1525). The
rolled formulation (``core.convolver.step_rolled``) physically rotates the
ring every block: read P·C·F + write P·C·F just for the roll, then read
ring + coeffs again for the MAC.

The steps here keep the ring fixed in device memory, overwrite one slot per
block, and read partition p from slot ``(pos - p) mod P`` (exactly
brutefir.cpp:292-295's ``(blockcounter - i) % n_blocks``). The MACs are
plain ``jax.numpy`` (``_mac_slots``): XLA fuses the P ring-slot reads, the
complex multiplies and the partition sum into one elementwise pass, so
ring and coefficients are read once and y is written once per block — the
memory-bandwidth floor.

Complex spectra are carried as split re/im planes (see the ops.fft split
API); the halfcomplex form packs the Nyquist bin into lane 0 of the
imaginary plane.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _mac_slots(ring_re, ring_im, coeff_re, coeff_im, pos, lane0: bool):
    """y = sum_p coeff[p] * ring[(pos - p) mod P] on split planes, written
    as P unrolled ring-slot reads accumulated in registers: XLA emits one
    elementwise loop fusion that reads every ring slot and coefficient row
    once (on an H100, 83% of HBM bandwidth at the flagship tail planes;
    PERF.md).
    ``lane0``: halfcomplex planes, whose lane 0 holds (DC.re, Nyquist.re)
    and takes two real products: dr = cr*wr - b*wi, di = a*wi + b*wr with
    (a, b) = (cr, ci), or (ci, 0) at lane 0."""
    p = ring_re.shape[0]
    first = jnp.arange(ring_re.shape[-1]) == 0
    acc_r = acc_i = None
    for q in range(p):
        s = jnp.mod(pos - q, p)
        wr = jax.lax.dynamic_index_in_dim(ring_re, s, 0, keepdims=False)
        wi = jax.lax.dynamic_index_in_dim(ring_im, s, 0, keepdims=False)
        cr, ci = coeff_re[q], coeff_im[q]
        if lane0:
            a = jnp.where(first, ci, cr)
            b = jnp.where(first, jnp.zeros_like(ci), ci)
        else:
            a, b = cr, ci
        dr = cr * wr - b * wi
        di = a * wi + b * wr
        acc_r = dr if acc_r is None else acc_r + dr
        acc_i = di if acc_i is None else acc_i + di
    return acc_r, acc_i


def mac_reference(ring_re, ring_im, coeff_re, coeff_im, pos):
    """y = sum_p coeff[p] * ring[(pos - p) mod P] (complex multiply on
    split planes)."""
    return _mac_slots(ring_re, ring_im, coeff_re, coeff_im, pos, lane0=False)


def chunk_reverse_coeffs(coeff_pk: jax.Array, k: int) -> jax.Array:
    """Reverse the partition order within each K-chunk (the coefficient
    layout of the doubled-ring ``step_chunked``; an involution)."""
    p, c2, fp = coeff_pk.shape
    return coeff_pk.reshape(p // k, k, c2, fp)[:, ::-1].reshape(p, c2, fp)


# ---------------------------------------------------------------------------
# Split-plane streaming steps.
# ---------------------------------------------------------------------------

from typing import NamedTuple  # noqa: E402

from bfir_tpu.core.spec import FilterSpec  # noqa: E402
from bfir_tpu.ops import fft as F  # noqa: E402


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class SplitState(NamedTuple):
    """Streaming state in split re/im planes with a fixed (pointer-indexed)
    ring — the split-plane representation of ConvolverState."""

    ring_re: jax.Array  # [P, C, Fp]
    ring_im: jax.Array
    prev_block: jax.Array  # [C, N]
    blockcounter: jax.Array  # int32


def init_split_state(spec: FilterSpec, n_channels: int) -> SplitState:
    fp = _round_up(spec.n_freq, 128)
    dt = jnp.dtype(spec.dtype)
    return SplitState(
        ring_re=jnp.zeros((spec.n_partitions, n_channels, fp), dtype=dt),
        ring_im=jnp.zeros((spec.n_partitions, n_channels, fp), dtype=dt),
        prev_block=jnp.zeros((n_channels, spec.block_length), dtype=dt),
        blockcounter=jnp.zeros((), dtype=jnp.int32),
    )


def split_coeffs(impulse, spec: FilterSpec, scale: float = 1.0):
    """coeffs_to_spectra in split planes, F padded to a lane multiple."""
    h = jnp.asarray(impulse, dtype=spec.dtype) * jnp.asarray(scale, dtype=spec.dtype)
    if h.ndim == 1:
        h = h[None, :]
    c, taps = h.shape
    n, p = spec.block_length, spec.n_partitions
    if taps > n * p:
        h = h[:, : n * p]
    else:
        h = jnp.pad(h, ((0, 0), (0, n * p - taps)))
    parts = h.reshape(c, p, n).transpose(1, 0, 2)
    cr, ci = F.rfft_split(parts, n=spec.n_fft)
    fp = _round_up(spec.n_freq, 128)
    pad = fp - cr.shape[-1]
    return jnp.pad(cr, ((0, 0), (0, 0), (0, pad))), jnp.pad(ci, ((0, 0), (0, 0), (0, pad)))


class PackedState(NamedTuple):
    """Split state with re/im stacked along the channel axis: ring
    [P, 2C, Fp] (re rows 0..C-1, im rows C..2C-1)."""

    ring: jax.Array
    prev_block: jax.Array
    blockcounter: jax.Array


def init_packed_state(spec: FilterSpec, n_channels: int) -> PackedState:
    fp = _round_up(spec.n_freq, 128)
    dt = jnp.dtype(spec.dtype)
    return PackedState(
        ring=jnp.zeros((spec.n_partitions, 2 * n_channels, fp), dtype=dt),
        prev_block=jnp.zeros((n_channels, spec.block_length), dtype=dt),
        blockcounter=jnp.zeros((), dtype=jnp.int32),
    )


def _mac_packed(ring_pk, coeff_pk, pos):
    """``mac_reference`` on packed [P, 2C, Fp] planes (re rows then im
    rows); coefficients may be [P, 2, Fp] (one filter for all channels)."""
    c = ring_pk.shape[1] // 2
    cs = coeff_pk.shape[1] // 2
    return mac_reference(ring_pk[:, :c], ring_pk[:, c:],
                         coeff_pk[:, :cs], coeff_pk[:, cs:], pos)


def pack_coeffs(impulse, spec: FilterSpec, n_channels: int, scale: float = 1.0):
    """split_coeffs stacked to [P, 2C, Fp] (broadcast to n_channels)."""
    cr, ci = split_coeffs(impulse, spec, scale)
    p, c0, fp = cr.shape
    if c0 != n_channels:
        cr = jnp.broadcast_to(cr, (p, n_channels, fp))
        ci = jnp.broadcast_to(ci, (p, n_channels, fp))
    return jnp.concatenate([cr, ci], axis=1)


def step_packed(
    state: PackedState,
    coeff_pk: jax.Array,
    block: jax.Array,
) -> Tuple[PackedState, jax.Array]:
    """One streaming block on the packed representation."""
    p, c2, fp = state.ring.shape
    n = block.shape[-1]
    f = n + 1
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)
    xr, xi = F.rfft_split(frame)
    xpk = jnp.concatenate(
        [jnp.pad(xr, ((0, 0), (0, fp - f))), jnp.pad(xi, ((0, 0), (0, fp - f)))],
        axis=0,
    )
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring = jax.lax.dynamic_update_slice(state.ring, xpk[None], (pos, zero, zero))
    yr, yi = _mac_packed(ring, coeff_pk, pos)
    out = F.irfft_split(yr[..., :f], yi[..., :f], n=2 * n)[..., n:]
    return PackedState(ring, block, state.blockcounter + 1), out


def step_packed_crossfade(
    state: PackedState,
    coeff_old: jax.Array,
    coeff_new: jax.Array,
    block: jax.Array,
) -> Tuple[PackedState, jax.Array]:
    """One block during a filter change on the packed path: a single ring
    advance, two MACs (old and new coefficient sets), and a linear ramp
    between the two outputs — ``convolver_crossfade_inplace``
    (fftw_convolver.cpp:275-321) on the packed representation. The extra
    MAC costs one more read of the ring+coeffs, paid only on the
    reconfigure block itself."""
    p, c2, fp = state.ring.shape
    n = block.shape[-1]
    f = n + 1
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)
    xr, xi = F.rfft_split(frame)
    xpk = jnp.concatenate(
        [jnp.pad(xr, ((0, 0), (0, fp - f))), jnp.pad(xi, ((0, 0), (0, fp - f)))],
        axis=0,
    )
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring = jax.lax.dynamic_update_slice(state.ring, xpk[None], (pos, zero, zero))
    yr_o, yi_o = _mac_packed(ring, coeff_old, pos)
    yr_n, yi_n = _mac_packed(ring, coeff_new, pos)
    out_old = F.irfft_split(yr_o[..., :f], yi_o[..., :f], n=2 * n)[..., n:]
    out_new = F.irfft_split(yr_n[..., :f], yi_n[..., :f], n=2 * n)[..., n:]
    ramp = jnp.arange(n, dtype=out_old.dtype) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return PackedState(ring, block, state.blockcounter + 1), out


def mac_reference_hc(ring_re, ring_im, coeff_re, coeff_im, pos):
    """The halfcomplex MAC: lane 0 carries (DC.re, Ny.re) in the (re, im)
    planes, so its product is two independent *real* multiplies instead of
    one complex multiply — exactly the bin-0/bin-n/2 special case of the
    reference's halfcomplex MAC loops
    (brutefir/fftw_convolver.cpp:1429-1525)."""
    return _mac_slots(ring_re, ring_im, coeff_re, coeff_im, pos, lane0=True)


# ---------------------------------------------------------------------------
# Block-scaled integer plane storage (the measured
# storage-precision frontier, benchmarks/storage_snr.py):
#
#   int24 (int16 hi + int8 lo + per-row f32 scale, 3 B/elem): ~134 dB MAC
#         SNR — the cheapest scheme that keeps >=125 dB; 25% fewer MAC
#         bytes than f32.
#   int16 (int16 + per-row scale, 2 B/elem): ~86 dB — the halved-traffic
#         point; >=125 dB at 2 B/elem is not physically reachable (the
#         spectra's in-row dynamic range eats ~10 dB of any 16-bit format,
#         and two-plane bf16 both costs full f32 bytes AND caps at ~109 dB).
#
# Planes quantize per ROW (one (partition, re/im-channel) spectrum row):
# q = round(a/s) with s = rowmax/qmax; int24 splits q into an arithmetic
# high int16 (q >> 8) and an unsigned low byte (q & 255), so
# hi*256 + lo reconstructs exactly, and |q| <= 2^23-1 converts to f32
# exactly. Scales ride along pre-broadcast to [ , 128] (tiny; the stored
# layout of the int tiers). The MAC decodes in f32 and accumulates in f32 —
# only the stored bytes shrink (same philosophy as the bf16 tier).
# ---------------------------------------------------------------------------

from typing import Optional  # noqa: E402


class IntPlanes(NamedTuple):
    """Block-scaled integer spectra: ``hi`` int16 [..., H], ``lo`` uint8
    [..., H] (None for the int16 tier), ``scale`` f32 [..., 128]
    (the per-row value, stored broadcast along 128 lanes)."""

    hi: jax.Array
    lo: Optional[jax.Array]
    scale: jax.Array


_I24_MAX = float(2 ** 23 - 1)
_I16_MAX = 32767.0


def quantize_planes(planes: jax.Array, bits: int) -> IntPlanes:
    """Quantize f32 planes [..., H] to the int24/int16 block-scaled form."""
    if bits not in (16, 24):
        raise ValueError(f"bits must be 16 or 24, got {bits}")
    qmax = _I24_MAX if bits == 24 else _I16_MAX
    planes = planes.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(planes), axis=-1, keepdims=True) / qmax,
                    jnp.float32(1e-30))
    q = jnp.clip(jnp.round(planes / s), -qmax, qmax).astype(jnp.int32)
    scale = jnp.broadcast_to(s, (*s.shape[:-1], 128))
    if bits == 16:
        return IntPlanes(hi=q.astype(jnp.int16), lo=None, scale=scale)
    return IntPlanes(hi=jnp.right_shift(q, 8).astype(jnp.int16),
                     lo=jnp.bitwise_and(q, 255).astype(jnp.uint8),
                     scale=scale)


def dequantize_planes(ip: IntPlanes) -> jax.Array:
    """Inverse of ``quantize_planes``."""
    if ip.lo is None:
        q = ip.hi.astype(jnp.float32)
    else:
        q = (ip.hi.astype(jnp.int32) * 256
             + ip.lo.astype(jnp.int32)).astype(jnp.float32)
    return q * ip.scale[..., :1]


def mac_reference_hc_int(ring: IntPlanes, coeff: IntPlanes, pos):
    """Halfcomplex MAC on int-stored planes: decode to f32, then
    ``mac_reference_hc`` (f32 accumulation)."""
    rp = dequantize_planes(ring)
    cp = dequantize_planes(coeff)
    c = rp.shape[1] // 2
    cs = cp.shape[1] // 2
    return mac_reference_hc(rp[:, :c], rp[:, c:], cp[:, :cs], cp[:, cs:], pos)


def mac_reference_hc_band_int(ring: IntPlanes, coeff: IntPlanes, pos,
                              band_start: int, band_len: int):
    """``mac_reference_hc_band`` on int-stored planes (f32 decode)."""
    rp = dequantize_planes(ring)
    cp = dequantize_planes(coeff)
    return mac_reference_hc_band(rp, cp, pos, band_start, band_len)


def mac_reference_hc_band(ring_pk, coeff_pk, pos, band_start: int,
                          band_len: int):
    """Halfcomplex MAC restricted to the frequency band
    [band_start, band_start + band_len) — every partition, one slice of the
    spectrum (the split-tail schedule's per-phase share). The lane-0
    fixup applies only to the band that holds lane 0."""
    p, c2, hp = ring_pk.shape
    c = c2 // 2
    cs = coeff_pk.shape[1] // 2
    ring = ring_pk[..., band_start:band_start + band_len]
    coeff = coeff_pk[..., band_start:band_start + band_len]
    if ring.dtype in (jnp.bfloat16, jnp.float16):
        ring = ring.astype(jnp.float32)
        coeff = coeff.astype(jnp.float32)
    return _mac_slots(ring[:, :c], ring[:, c:], coeff[:, :cs], coeff[:, cs:],
                      pos, lane0=band_start == 0)


def mac_hc(ring_pk, coeff_pk, pos):
    """Halfcomplex MAC on packed [P, 2C, Hp] planes in any stored form:
    float32/bfloat16 (bf16 accumulates in f32) or ``IntPlanes`` (decoded
    to f32). Coefficients may be shared ([P, 2, Hp])."""
    if isinstance(ring_pk, IntPlanes):
        return mac_reference_hc_int(ring_pk, coeff_pk, pos)
    if ring_pk.dtype == jnp.bfloat16:
        ring_pk = ring_pk.astype(jnp.float32)
        coeff_pk = coeff_pk.astype(jnp.float32)
    c = ring_pk.shape[1] // 2
    cs = coeff_pk.shape[1] // 2  # 1 = shared filter
    return mac_reference_hc(ring_pk[:, :c], ring_pk[:, c:],
                            coeff_pk[:, :cs], coeff_pk[:, cs:], pos)


class HcState(NamedTuple):
    """Packed halfcomplex streaming state: ring [P, 2C, Hp] (re rows 0..C-1,
    im rows C..2C-1; lane 0 = (DC.re, Nyquist.re), Hp = n_fft//2 rounded up
    to the 128-lane tile)."""

    ring: jax.Array
    prev_block: jax.Array  # [C, N]
    blockcounter: jax.Array  # int32


def init_hc_state(spec: FilterSpec, n_channels: int) -> HcState:
    hp = _round_up(spec.n_fft // 2, 128)
    dt = jnp.dtype(spec.dtype)
    return HcState(
        ring=jnp.zeros((spec.n_partitions, 2 * n_channels, hp), dtype=dt),
        prev_block=jnp.zeros((n_channels, spec.block_length), dtype=dt),
        blockcounter=jnp.zeros((), dtype=jnp.int32),
    )


def hc_coeffs(impulse, spec: FilterSpec, n_channels: int, scale: float = 1.0,
              precise: bool = False, shared: bool = False):
    """Partitioned coefficient spectra in packed halfcomplex form
    [P, 2C, Hp] (broadcast to n_channels).

    ``shared``: keep ONE filter's planes ([P, 2, Hp]) instead of
    broadcasting — the MACs broadcast them across channels, cutting
    coefficient memory traffic by 1/C for chains whose
    channels share the filter (the reference plugin's EQ-only chains render
    one FIR for all channels, prefs_eq.cpp). Requires a 1-channel (or
    all-rows-identical) impulse.

    ``precise``: compute the partition FFTs on the host in float64 (numpy)
    and round once to the engine dtype. Coefficients are built once per
    configuration, and the measured f32 error budget shows
    f32-computed coefficient spectra cost ~9 dB of streaming SNR even when
    the stored planes are f32 — this recovers that at build time only. The
    reference computes its coefficient spectra at its engine precision
    (REALSIZE=8 on the plugin path, convolver_coeffs2cbuf,
    fftw_convolver.cpp:474-537), so precise=True is the parity behavior
    for dtype float64 requests served in float32."""
    n, p = spec.block_length, spec.n_partitions
    hp = _round_up(spec.n_fft // 2, 128)
    if shared:
        imp = np.asarray(impulse)
        if imp.ndim == 2 and imp.shape[0] > 1:
            imp = imp[:1]  # caller asserts all rows identical
        return hc_coeffs(imp, spec, 1, scale=scale, precise=precise)
    if precise:
        h64 = np.asarray(impulse, dtype=np.float64) * float(scale)
        if h64.ndim == 1:
            h64 = h64[None, :]
        c0, taps = h64.shape
        if taps > n * p:
            h64 = h64[:, : n * p]
        else:
            h64 = np.pad(h64, ((0, 0), (0, n * p - taps)))
        parts = h64.reshape(c0, p, n).transpose(1, 0, 2)
        spec64 = np.fft.rfft(parts, n=spec.n_fft, axis=-1)
        half = spec.n_fft // 2
        cr = spec64.real[..., :half]
        ci = np.concatenate([spec64.real[..., half:half + 1],
                             spec64.imag[..., 1:half]], axis=-1)
        dt = np.float32 if spec.dtype == "float32" else np.float64
        cr = np.pad(cr, ((0, 0), (0, 0), (0, hp - half))).astype(dt)
        ci = np.pad(ci, ((0, 0), (0, 0), (0, hp - half))).astype(dt)
        if c0 != n_channels:
            cr = np.broadcast_to(cr, (p, n_channels, hp))
            ci = np.broadcast_to(ci, (p, n_channels, hp))
        return jnp.asarray(np.concatenate([cr, ci], axis=1))
    h = jnp.asarray(impulse, dtype=spec.dtype) * jnp.asarray(scale, dtype=spec.dtype)
    if h.ndim == 1:
        h = h[None, :]
    c0, taps = h.shape
    if taps > n * p:
        h = h[:, : n * p]
    else:
        h = jnp.pad(h, ((0, 0), (0, n * p - taps)))
    parts = h.reshape(c0, p, n).transpose(1, 0, 2)
    cr, ci = F.rfft_split_hc(parts, n=spec.n_fft)
    pad = hp - cr.shape[-1]
    cr = jnp.pad(cr, ((0, 0), (0, 0), (0, pad)))
    ci = jnp.pad(ci, ((0, 0), (0, 0), (0, pad)))
    if c0 != n_channels:
        cr = jnp.broadcast_to(cr, (p, n_channels, hp))
        ci = jnp.broadcast_to(ci, (p, n_channels, hp))
    return jnp.concatenate([cr, ci], axis=1)


def _hc_frame_spectrum(state, block, hp):
    """rfft of the overlap-save frame, packed halfcomplex [2C, Hp]."""
    n = block.shape[-1]
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)
    hr, hi = F.rfft_split_hc(frame)
    pad = hp - hr.shape[-1]
    xpk = jnp.concatenate(
        [jnp.pad(hr, ((0, 0), (0, pad))), jnp.pad(hi, ((0, 0), (0, pad)))],
        axis=0,
    )
    return block, xpk


def step_hc(
    state: HcState,
    coeff_pk: jax.Array,
    block: jax.Array,
) -> Tuple[HcState, jax.Array]:
    """One streaming block on the halfcomplex representation; outputs match
    ``step_split`` to f32 rounding with 11% fewer MAC bytes (1024 lanes
    instead of 1025 at N = 1024)."""
    p, c2, hp = state.ring.shape
    n = block.shape[-1]
    block, xpk = _hc_frame_spectrum(state, block, hp)
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring = jax.lax.dynamic_update_slice(state.ring, xpk[None], (pos, zero, zero))
    yr, yi = mac_hc(ring, coeff_pk, pos)
    out = F.irfft_hc_tail(yr, yi, n=2 * n)
    return HcState(ring, block, state.blockcounter + 1), out


def step_hc_crossfade(
    state: HcState,
    coeff_old: jax.Array,
    coeff_new: jax.Array,
    block: jax.Array,
) -> Tuple[HcState, jax.Array]:
    """Glitch-free filter-change block on the halfcomplex path (see
    step_packed_crossfade; same two-MAC + linear-ramp law,
    fftw_convolver.cpp:275-321)."""
    p, c2, hp = state.ring.shape
    n = block.shape[-1]
    block, xpk = _hc_frame_spectrum(state, block, hp)
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring = jax.lax.dynamic_update_slice(state.ring, xpk[None], (pos, zero, zero))
    yr_o, yi_o = mac_hc(ring, coeff_old, pos)
    yr_n, yi_n = mac_hc(ring, coeff_new, pos)
    out_old = F.irfft_hc_tail(yr_o, yi_o, n=2 * n)
    out_new = F.irfft_hc_tail(yr_n, yi_n, n=2 * n)
    ramp = jnp.arange(n, dtype=out_old.dtype) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return HcState(ring, block, state.blockcounter + 1), out


class DoubledState(NamedTuple):
    """Packed state with the ring doubled ([2P, 2C, Fp], slot s mirrored at
    s+P), so the K delayed slots of any K-chunk are one contiguous slice."""

    ring2: jax.Array
    prev_block: jax.Array
    blockcounter: jax.Array


def init_doubled_state(spec: FilterSpec, n_channels: int) -> DoubledState:
    fp = _round_up(spec.n_freq, 128)
    dt = jnp.dtype(spec.dtype)
    return DoubledState(
        ring2=jnp.zeros((2 * spec.n_partitions, 2 * n_channels, fp), dtype=dt),
        prev_block=jnp.zeros((n_channels, spec.block_length), dtype=dt),
        blockcounter=jnp.zeros((), dtype=jnp.int32),
    )


def step_chunked(
    state: DoubledState,
    coeff_rk: jax.Array,
    block: jax.Array,
    k: int = 4,
) -> Tuple[DoubledState, jax.Array]:
    """Streaming block step on the doubled-ring/chunk-reversed-coeff
    representation (coeffs from ``chunk_reverse_coeffs(pack_coeffs(...), k)``).
    Outputs match ``step_split`` to fp rounding."""
    p2, c2, fp = state.ring2.shape
    p = p2 // 2
    n = block.shape[-1]
    f = n + 1
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)
    xr, xi = F.rfft_split(frame)
    xpk = jnp.concatenate(
        [jnp.pad(xr, ((0, 0), (0, fp - f))), jnp.pad(xi, ((0, 0), (0, fp - f)))],
        axis=0,
    )[None]
    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring2 = jax.lax.dynamic_update_slice(state.ring2, xpk, (pos, zero, zero))
    ring2 = jax.lax.dynamic_update_slice(ring2, xpk, (pos + p, zero, zero))
    # the first P slots are the plain ring; undoing the chunk reversal
    # gives the plain coefficient order
    yr, yi = _mac_packed(ring2[:p], chunk_reverse_coeffs(coeff_rk, k), pos)
    out = F.irfft_split(yr[..., :f], yi[..., :f], n=2 * n)[..., n:]
    return DoubledState(ring2, block, state.blockcounter + 1), out


def step_split(
    state: SplitState,
    coeff_re: jax.Array,
    coeff_im: jax.Array,
    block: jax.Array,
) -> Tuple[SplitState, jax.Array]:
    """One streaming block in split representation; outputs bit-match
    ``core.convolver.step`` up to fp rounding."""
    p, c, fp = state.ring_re.shape
    n = block.shape[-1]
    f = n + 1
    block = block.astype(state.prev_block.dtype)
    frame = jnp.concatenate([state.prev_block, block], axis=-1)
    xr, xi = F.rfft_split(frame)  # [C, F]
    xr = jnp.pad(xr, ((0, 0), (0, fp - f)))
    xi = jnp.pad(xi, ((0, 0), (0, fp - f)))

    pos = jnp.mod(state.blockcounter, p)
    zero = jnp.zeros((), dtype=pos.dtype)
    ring_re = jax.lax.dynamic_update_slice(state.ring_re, xr[None], (pos, zero, zero))
    ring_im = jax.lax.dynamic_update_slice(state.ring_im, xi[None], (pos, zero, zero))

    yr, yi = mac_reference(ring_re, ring_im, coeff_re, coeff_im, pos)

    out = F.irfft_split(yr[..., :f], yi[..., :f], n=2 * n)[..., n:]
    return (
        SplitState(ring_re, ring_im, block, state.blockcounter + 1),
        out,
    )
