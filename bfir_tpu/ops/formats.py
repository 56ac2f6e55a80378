"""PCM sample-format codecs: raw interleaved bytes <-> float channel tensors.

Device/host split of the reference's ``brutefir/raw2real.{cpp,hpp}`` and
``real2raw.{cpp,hpp}``:

- the *scaling/quantization* (multiply by ``sf.scale``, dither, clip,
  overflow accounting — the per-sample inner loops of real2raw.cpp:38-1224)
  runs on device as vectorized jnp ops (``scale_*``, ``ops.dither``);
- the *byte packing* (endianness, 24-bit-in-3-bytes, padded containers with
  bit shift — raw2real.cpp:16-424, real2raw.cpp S24 path) is host-side numpy
  bit-twiddling: device-side audio is always native float32/float64, exactly as
  the reference's engine core is always float/double with formats only at
  the boundary.

Float outputs are never clipped; they only bump the overflow counter when
exceeding full scale (REAL_OVERFLOW_UPDATE, real2raw.cpp:17-32).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bfir_tpu.core.spec import SampleFormat
from bfir_tpu.ops.dither import (
    DitherState,
    OverflowStats,
    quantize_hp_tpdf,
    quantize_no_dither,
)

_INT_NP = {1: np.int8, 2: np.int16, 4: np.int32}


def _np_int_dtype(fmt: SampleFormat):
    e = ">" if fmt.big_endian else "<"
    if fmt.bytes == 1:
        return np.dtype(np.int8)
    return np.dtype(f"{e}i{fmt.bytes}")


def decode(raw, fmt: SampleFormat, n_channels: int, dtype=np.float64) -> np.ndarray:
    """Decode interleaved raw PCM bytes -> float [C, N] scaled to +-1 full
    scale (raw2real semantics with the input ``sf.scale`` of
    brutefir.cpp:435-539 folded in).

    Uses the native C++ codec (bfir_tpu.native) when built; numpy fallback
    below is exact-equivalent (tested)."""
    from bfir_tpu import native as _native

    if isinstance(raw, (bytes, bytearray)) and _native.available():
        out = _native.decode_f64(bytes(raw), fmt, n_channels)
        if out is not None:
            return out.astype(dtype, copy=False)
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.uint8)
    frame_bytes = fmt.bytes * n_channels
    n = buf.size // frame_bytes
    buf = buf[: n * frame_bytes]

    if fmt.isfloat:
        fdt = np.dtype(("<" if not fmt.big_endian else ">") + ("f4" if fmt.bytes == 4 else "f8"))
        x = buf.view(fdt).astype(dtype)
    elif fmt.bytes == 3:
        b = buf.reshape(-1, 3)
        if fmt.big_endian:
            b = b[:, ::-1]
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = (i32 << 8) >> 8
        x = i32.astype(dtype) / fmt.full_scale
    else:
        ints = buf.view(_np_int_dtype(fmt)).astype(np.int64)
        if fmt.sbytes != fmt.bytes:  # padded container (e.g. S24_4LE): samples
            # occupy the high sbytes with a (bytes-sbytes)*8-bit shift
            shift = (fmt.bytes - fmt.sbytes) * 8
            ints = ints >> shift
        x = ints.astype(dtype) / fmt.full_scale
    return x.reshape(n, n_channels).T.copy()


def encode_int(q: np.ndarray, fmt: SampleFormat) -> bytes:
    """Pack already-quantized int32 samples [C, N] -> interleaved raw bytes."""
    if fmt.isfloat:
        raise ValueError("encode_int is for integer formats")
    from bfir_tpu import native as _native

    if _native.available():
        out = _native.encode_int(np.asarray(q, dtype=np.int32), fmt)
        if out is not None:
            return out
    inter = np.asarray(q, dtype=np.int64).T.reshape(-1)  # [N*C] interleaved
    if fmt.bytes == 3:
        flat = inter.astype(np.int32)
        b = np.empty((flat.size, 3), dtype=np.uint8)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        if fmt.big_endian:
            b = b[:, ::-1]
        return b.tobytes()
    if fmt.sbytes != fmt.bytes:
        inter = inter << ((fmt.bytes - fmt.sbytes) * 8)
    return inter.astype(_np_int_dtype(fmt)).tobytes()


def encode_float(x: np.ndarray, fmt: SampleFormat) -> bytes:
    """Pack float samples [C, N] (+-1 full scale) -> interleaved raw bytes."""
    if not fmt.isfloat:
        raise ValueError("encode_float is for float formats")
    e = ">" if fmt.big_endian else "<"
    fdt = np.dtype(f"{e}f{fmt.bytes}")
    return np.asarray(x).T.astype(fdt).tobytes()


# ---------------------------------------------------------------------------
# Device-side output stage (the real2raw scaling/quantization inner loop)
# ---------------------------------------------------------------------------


def count_float_overflow(x: jax.Array, of: OverflowStats, fmax: float = 1.0) -> OverflowStats:
    """Overflow accounting for float outputs: count |x| > fmax, track peak,
    never clip (REAL_OVERFLOW_UPDATE, real2raw.cpp:17-32)."""
    over = jnp.abs(x) > fmax
    n_of = of.n_overflows + over.astype(jnp.int32).sum(axis=1)
    largest = jnp.maximum(of.largest, jnp.abs(x).max(axis=1).astype(of.largest.dtype))
    return OverflowStats(n_of, largest, of.intlargest)


def output_stage(
    y: jax.Array,
    fmt: SampleFormat,
    of: OverflowStats,
    dither_state: DitherState = None,
) -> Tuple[jax.Array, OverflowStats, DitherState]:
    """Convert engine-domain output [C, N] (+-1 full scale) to the output
    format's numeric domain on device.

    - float formats: passthrough + overflow count (no clip)
    - int formats, dither_state given: scale to int domain, hp-TPDF dither +
      error feedback + clip (convolver_cbuf2raw with apply_dither,
      fftw_convolver.cpp:405-466)
    - int formats, no dither_state: mid-tread round + clip

    Returns (samples, new_overflow, new_dither_state). ``samples`` is float
    (pass to encode_float) for float formats, int32 (pass to encode_int)
    for integer formats.
    """
    if fmt.isfloat:
        return y, count_float_overflow(y, of), dither_state
    scaled = y * jnp.asarray(fmt.full_scale, y.dtype)
    if dither_state is not None:
        q, dither_state, of = quantize_hp_tpdf(scaled, fmt.imin, fmt.imax, dither_state, of)
    else:
        q, of = quantize_no_dither(scaled, fmt.imin, fmt.imax, of)
    return q, of, dither_state


def input_stage(raw, fmt: SampleFormat, n_channels: int, dtype=np.float32) -> np.ndarray:
    """Decode raw input bytes to the engine float domain (raw2cbuf's
    raw2real call, fftw_convolver.cpp:156-185)."""
    return decode(raw, fmt, n_channels, dtype=dtype)
