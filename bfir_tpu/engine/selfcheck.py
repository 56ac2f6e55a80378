"""Known-answer self-verification of compiled engine graphs.

The reference's runtime self-verification is ``convolver_verify_cbuf``
(/root/reference/brutefir/fftw_convolver.cpp:569-602), which screens
coefficient buffers for NaN after preprocessing. This module extends that
philosophy to the compiled-graph level: at coefficient
build time it streams a short noise input through the EXACT jitted callable
production will use and compares every channel against a scipy float64
oracle. This catches not just bad coefficients but *backend
miscompilation* (a compiler can produce deterministic, bit-identical wrong
results for specific large-shape graphs); without this check a library
user gets silently wrong audio.

On mismatch the caller must refuse the geometry: the session falls back to
the next engine implementation (sharded/packed -> complex -> passthrough),
and direct users of ``check_stream``/``check_batch`` get an
``EngineSelfCheckError``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Callable, Optional

import numpy as np

from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.utils.logging import pinfo

# f32 partitioned convolution measures ~130 dB vs the f64 oracle; a
# miscompile is O(1) wrong (observed ~4 dB). 80 dB splits those regimes
# with huge margin on both sides.
DEFAULT_MIN_SNR_DB = 80.0


class EngineSelfCheckError(RuntimeError):
    """A compiled engine graph failed its known-answer check."""


# ---------------------------------------------------------------------------
# Verdict cache: the nonuniform check streams (D+2)*R = 32 blocks through
# the compiled graph at every session open. Miscompiles are DETERMINISTIC
# per (backend, jax version, compute source, graph shape, coefficients) —
# bit-identical wrong results, not noise — so a verdict can be cached under
# a key covering exactly those inputs. Any change to the compute-path
# source files invalidates every entry.
# ---------------------------------------------------------------------------


_SOURCE_FINGERPRINT = None


def _source_fingerprint() -> str:
    """Hash of every compute-path source file (kernels/core/ops)."""
    global _SOURCE_FINGERPRINT
    if _SOURCE_FINGERPRINT is None:
        import bfir_tpu

        root = os.path.dirname(os.path.abspath(bfir_tpu.__file__))
        h = hashlib.sha256()
        for sub in ("kernels", "core", "ops"):
            d = os.path.join(root, sub)
            for name in sorted(os.listdir(d)):
                if name.endswith(".py"):
                    with open(os.path.join(d, name), "rb") as f:
                        h.update(name.encode())
                        h.update(f.read())
        _SOURCE_FINGERPRINT = h.hexdigest()
    return _SOURCE_FINGERPRINT


def cache_key(impl: str, impulse: np.ndarray, spec: FilterSpec,
              n_channels: int, n_blocks: int, min_snr_db: float,
              extra: str = "") -> str:
    """Stable verdict-cache key; see the miscompile-determinism note above.

    Covers the full compiler-stack identity (jax + jaxlib + PJRT plugin
    version + XLA flags): the miscompiles are a plugin-build
    property, so a plugin update must invalidate every verdict even when
    ``jax.__version__`` is unchanged.
    """
    from bfir_tpu.utils.hashing import backend_fingerprint

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(impulse, dtype=np.float64)).tobytes())
    h.update(repr((impl, spec, n_channels, n_blocks, round(min_snr_db, 3),
                   extra, impulse.shape)).encode())
    h.update(backend_fingerprint().encode())
    h.update(_source_fingerprint().encode())
    return h.hexdigest()[:24]


# Cached FAILURES expire: a failure usually marks a backend miscompile,
# and while the cache key covers the compiler stack, a day later the check
# re-runs so a fixed/transient condition cannot demote an engine forever.
# Passes never expire: a pass going stale is caught by the key change.
FAILURE_TTL_S = 24 * 3600.0


def load_verdict(cache_file: Optional[str], key: str):
    """Return the cached {"snr": float, "ok": bool} verdict or None.
    Failed verdicts older than ``FAILURE_TTL_S`` are treated as absent."""
    if not cache_file or not os.path.exists(cache_file):
        return None
    try:
        with open(cache_file) as f:
            verdict = json.load(f).get(key)
        if verdict is not None and not verdict.get("ok", False):
            import time

            if time.time() - float(verdict.get("t", 0.0)) > FAILURE_TTL_S:
                return None
        return verdict
    except Exception:
        return None


def store_verdict(cache_file: Optional[str], key: str, snr: float, ok: bool) -> None:
    if not cache_file:
        return
    try:
        import time

        data = {}
        if os.path.exists(cache_file):
            with open(cache_file) as f:
                data = json.load(f)
        data[key] = {"snr": float(snr), "ok": bool(ok), "t": time.time()}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache_file) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, cache_file)  # atomic vs concurrent sessions
    except Exception as e:  # cache failures must never break the engine
        pinfo("Self-check verdict cache write failed (%s).", e)


def _oracle(x: np.ndarray, impulse: np.ndarray) -> np.ndarray:
    """Per-channel linear convolution in float64 (scipy), truncated to the
    stream length. impulse: [C, taps] or [1, taps] (broadcast)."""
    from scipy import signal

    c, t = x.shape
    h = np.atleast_2d(np.asarray(impulse, dtype=np.float64))
    ref = np.empty((c, t), dtype=np.float64)
    for ch in range(c):
        hh = h[0] if h.shape[0] == 1 else h[ch]
        ref[ch] = signal.fftconvolve(x[ch].astype(np.float64), hh)[:t]
    return ref


def _worst_snr_db(y: np.ndarray, ref: np.ndarray) -> float:
    """Minimum per-channel SNR — a wrong-single-channel failure must not
    hide behind good channels."""
    worst = np.inf
    for ch in range(y.shape[0]):
        sig = float((ref[ch] ** 2).sum())
        err = float(((y[ch] - ref[ch]) ** 2).sum())
        snr = 10 * np.log10(max(sig, 1e-300) / max(err, 1e-300))
        worst = min(worst, snr)
    return worst


def check_stream(
    step_call: Callable,
    init_state: Callable,
    coeffs,
    impulse: np.ndarray,
    spec: FilterSpec,
    n_channels: int,
    *,
    n_blocks: int = 3,
    min_snr_db: float = DEFAULT_MIN_SNR_DB,
    label: str = "step",
    cache_file: Optional[str] = None,
    cache_extra: str = "",
) -> float:
    """Run ``n_blocks`` of seeded noise through ``step_call(state, coeffs,
    block)`` (the exact production callable: jitted, on the production
    backend, with the production coefficient arrays) and compare against
    scipy. Returns the worst-channel SNR in dB; raises
    ``EngineSelfCheckError`` below ``min_snr_db``.

    ``impulse`` must be the already-scaled impulse the coefficients were
    built from ([C, taps] or [taps]). With ``cache_file``, a previous
    verdict for the identical (backend, source, geometry, coefficients)
    tuple short-circuits the run — pass ``cache_extra`` for geometry not
    captured by ``spec`` (e.g. the nonuniform NuSpec)."""

    def _refuse(snr):
        raise EngineSelfCheckError(
            f"known-answer check FAILED for {label}: worst-channel SNR "
            f"{snr:.1f} dB < {min_snr_db:.0f} dB (geometry: C={n_channels}, "
            f"N={spec.block_length}, P={spec.n_partitions}, {spec.dtype}) — "
            "refusing this compiled graph (possible backend miscompile)"
        )

    key = None
    if cache_file:
        key = cache_key(label, np.atleast_2d(impulse), spec, n_channels,
                        n_blocks, min_snr_db, extra=cache_extra)
        verdict = load_verdict(cache_file, key)
        if verdict is not None:
            if verdict["ok"]:
                # a cached pass still gets a 2-block SPOT check: a
                # miscompile need not be deterministic, so caching alone
                # could mask intermittent corruption. Two dispatches vs
                # the full (D+2)*R-block stream.
                rng = np.random.default_rng(0x5B07)
                n = spec.block_length
                x = rng.standard_normal((n_channels, 2 * n)).astype(spec.dtype)
                st = init_state()
                outs = []
                for b in range(2):
                    st, out = step_call(st, coeffs, x[:, b * n:(b + 1) * n])
                    outs.append(np.asarray(out))
                y = np.concatenate(outs, axis=1).astype(np.float64)
                spot = _worst_snr_db(y, _oracle(x, impulse))
                if not np.isfinite(spot) or spot < min_snr_db:
                    pinfo("Self-check (%s): cached pass CONTRADICTED by the "
                          "spot check (%.1f dB) — rerunning the full check.",
                          label, spot)
                else:
                    pinfo("Self-check (%s): cached pass, worst-channel SNR "
                          "%.1f dB (spot check %.1f dB).", label,
                          verdict["snr"], spot)
                    return float(verdict["snr"])
            else:
                _refuse(verdict["snr"])
    rng = np.random.default_rng(0xB51C)
    n = spec.block_length
    x = rng.standard_normal((n_channels, n_blocks * n)).astype(spec.dtype)
    state = init_state()
    outs = []
    for b in range(n_blocks):
        state, out = step_call(state, coeffs, x[:, b * n : (b + 1) * n])
        outs.append(np.asarray(out))
    y = np.concatenate(outs, axis=1).astype(np.float64)
    snr = _worst_snr_db(y, _oracle(x, impulse))
    ok = np.isfinite(snr) and snr >= min_snr_db
    if key is not None:
        store_verdict(cache_file, key, snr, ok)
    if not ok:
        _refuse(snr)
    pinfo("Self-check (%s): worst-channel SNR %.1f dB.", label, snr)
    return snr


def check_batch(
    batch_call: Callable,
    init_state: Callable,
    coeffs,
    impulse: np.ndarray,
    spec: FilterSpec,
    n_channels: int,
    batch_blocks: int,
    *,
    min_snr_db: float = DEFAULT_MIN_SNR_DB,
    label: str = "batch",
) -> float:
    """Known-answer check for a batch geometry: one ``batch_call(state,
    coeffs, blocks[B,C,N])`` dispatch through the exact jitted graph. This
    is the guard against a miscompiled batch geometry — such a shape fails
    here instead of producing wrong audio."""
    rng = np.random.default_rng(0xBA7C)
    n = spec.block_length
    x = rng.standard_normal((batch_blocks, n_channels, n)).astype(spec.dtype)
    state = init_state()
    _, outs = batch_call(state, coeffs, x)
    y = np.asarray(outs).transpose(1, 0, 2).reshape(n_channels, -1).astype(np.float64)
    flat = x.transpose(1, 0, 2).reshape(n_channels, -1)
    snr = _worst_snr_db(y, _oracle(flat, impulse))
    if not np.isfinite(snr) or snr < min_snr_db:
        raise EngineSelfCheckError(
            f"known-answer check FAILED for {label}: worst-channel SNR "
            f"{snr:.1f} dB < {min_snr_db:.0f} dB (geometry: B={batch_blocks}, "
            f"C={n_channels}, N={spec.block_length}, P={spec.n_partitions}) — "
            "refusing this batch geometry (possible backend miscompile)"
        )
    pinfo("Self-check (%s): worst-channel SNR %.1f dB.", label, snr)
    return snr
