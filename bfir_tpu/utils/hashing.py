"""Hashing for artifact cache keys.

The reference keys its derived-artifact cache (rendered EQ FIRs, resampled
impulses, preconvolved chains) on DJB string hashes (``hash.c:113-124``,
used at ``equalizer.cpp:152-180``, ``buffer.cpp:243-253``,
``preprocessor.cpp:89-98``). We keep DJB for byte-level parity of the naming
scheme and add a stronger content hash for cache integrity.
"""

from __future__ import annotations

import hashlib


def djb_hash(data: bytes) -> int:
    """DJB string hash (hash.c:113-124), 32-bit."""
    h = 5381
    for b in data:
        h = ((h << 5) + h + b) & 0xFFFFFFFF
    return h


def content_key(*parts) -> str:
    """Stable hex key over heterogeneous parts (floats, strings, bytes)."""
    m = hashlib.sha256()
    for p in parts:
        if isinstance(p, bytes):
            m.update(p)
        else:
            m.update(repr(p).encode())
        m.update(b"\x00")
    return m.hexdigest()[:16]


def backend_fingerprint() -> str:
    """Full compiler-stack identity for compiled-artifact cache keys.

    A compiler-stack update under the same ``jax.__version__`` must
    invalidate cached self-check verdicts. Covers jax, jaxlib, backend
    platform, the backend's ``platform_version`` (e.g. the CUDA
    build string), device kind, device count, and any XLA_FLAGS override.
    """
    import os

    import jax

    dev = jax.devices()[0]
    try:
        import jaxlib.version

        jaxlib_v = jaxlib.version.__version__
    except Exception:
        jaxlib_v = "?"
    try:
        import jax.extend as jex

        platform_v = getattr(jex.backend.get_backend(), "platform_version",
                             "?")
    except Exception:
        platform_v = "?"
    return "|".join([
        jax.__version__, jaxlib_v, jax.default_backend(), str(platform_v),
        str(getattr(dev, "device_kind", "?")), str(jax.device_count()),
        os.environ.get("XLA_FLAGS", ""),
    ])
