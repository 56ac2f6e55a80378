"""Coefficient/ring storage-precision frontier.

Simulates the tail-stage MAC at the flagship geometry with ring+coeff
planes quantized per candidate scheme and measures output SNR against the
float64 MAC — the EVIDENCE for the engine's storage tiers and for why the
"halve traffic at >=125 dB" target is not physically reachable:

    scheme    bytes/elem   both-quantized   coeff-only   (measured 2026-08-21)
    f32       4            148.9 dB         148.9 dB
    bf16      2             52.6 dB          55.6 dB   (existing fast tier)
    bf16x2    4            109.2 dB         112.2 dB   (two-plane compensated)
    i16block  2             86.2 dB          89.2 dB   (int16 + per-row scale)
    i24block  3            134.4 dB         137.2 dB   (int16+int8 + scale)

Read-off: >=125 dB needs >=~21 significand bits per element against the
spectra's in-row dynamic range; two-plane bf16 carries 16 bits (and costs
full f32 bytes), int16 block-scaled carries ~16 against the row peak, and
the cheapest conforming scheme is block-scaled int24 at 3 bytes (-25%
traffic, ~134 dB). Halving bytes (2 B/elem) caps near ~86 dB no matter the
format. The engine therefore ships: int24 (quality tier, >=125 dB) and
int16 (~86 dB) alongside bf16 (~56 dB) — see NuSpec.tail_store.

Run:  python benchmarks/storage_snr.py   (CPU, ~30 s; prints one JSON line)
"""

from __future__ import annotations

import json
import sys

import numpy as np

try:
    import ml_dtypes
except ImportError:  # pragma: no cover
    ml_dtypes = None


def main() -> int:
    rng = np.random.default_rng(0)
    P, C, H = 14, 8, 8192  # tail geometry (channel subset for speed)
    taps = 131072
    dec = np.exp(-np.arange(taps) / 20000.0)
    h = rng.standard_normal((C, taps)) * dec * 0.05
    M = 8192
    parts = []
    for p in range(P):
        seg = h[:, 16384 + p * M:16384 + (p + 1) * M]
        if seg.shape[1] < M:
            seg = np.pad(seg, ((0, 0), (0, M - seg.shape[1])))
        parts.append(np.fft.rfft(seg, n=2 * M, axis=-1)[:, :H])
    co = np.stack(parts)
    co_planes = np.concatenate([co.real, co.imag], axis=1)  # [P, 2C, H]
    ring = np.fft.rfft(rng.standard_normal((P, C, 2 * M)), axis=-1)[..., :H]
    ring_planes = np.concatenate([ring.real, ring.imag], axis=1)

    def mac(cp, rp):
        cr, ci = cp[:, :C], cp[:, C:]
        rr, ri = rp[:, :C], rp[:, C:]
        return ((cr * rr - ci * ri).sum(0)
                + 1j * (cr * ri + ci * rr).sum(0))

    ref = mac(co_planes.astype(np.float64), ring_planes.astype(np.float64))

    def f32(a):
        return a.astype(np.float32).astype(np.float64)

    def bf16(a):
        return np.asarray(a, dtype=ml_dtypes.bfloat16).astype(np.float64)

    def bf16x2(a):
        hi = np.asarray(a, dtype=ml_dtypes.bfloat16).astype(np.float64)
        lo = np.asarray(a - hi, dtype=ml_dtypes.bfloat16).astype(np.float64)
        return hi + lo

    def i16block(a):
        s = np.maximum(np.abs(a).max(axis=-1, keepdims=True) / 32767.0, 1e-300)
        return np.round(a / s).clip(-32767, 32767) * s

    def i24block(a):
        s = np.maximum(np.abs(a).max(axis=-1, keepdims=True) / (2 ** 23 - 1),
                       1e-300)
        return np.round(a / s).clip(-(2 ** 23 - 1), 2 ** 23 - 1) * s

    schemes = [("f32", f32, 4), ("i16block", i16block, 2),
               ("i24block", i24block, 3)]
    if ml_dtypes is not None:
        schemes[1:1] = [("bf16", bf16, 2), ("bf16x2", bf16x2, 4)]
    out = {}
    for name, q, nbytes in schemes:
        y = mac(q(co_planes), q(ring_planes))
        snr = 10 * np.log10((np.abs(ref) ** 2).sum()
                            / (np.abs(y - ref) ** 2).sum())
        y2 = mac(q(co_planes), f32(ring_planes))
        snr2 = 10 * np.log10((np.abs(ref) ** 2).sum()
                             / (np.abs(y2 - ref) ** 2).sum())
        out[name] = {"bytes_per_elem": nbytes,
                     "snr_both_db": round(float(snr), 1),
                     "snr_coeff_only_db": round(float(snr2), 1)}
        print(f"{name:9s} {nbytes} B  both={snr:7.1f} dB  "
              f"coeff-only={snr2:7.1f} dB", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
