"""What the backend offers, decided in one place.

Every question the engine asks about the platform it runs on is answered
here, so no other module compares backend names:

- ``is_cpu``: the XLA:CPU backend (tests, CPU-only hosts). The session's
  auto mode and the sharded engine keep the plain engines there, where the
  accelerator engines only add compile time.
- ``pallas_interpret``: whether a Pallas kernel must run interpreted (the
  CPU has no Pallas lowering).
- ``corr_mac_route``: what computes the bulk engine's correlation MAC.
- ``bulk_nu_engine``: the schedule long-filter offline renders take.
- ``default_tail_store``: what ``nu_tail_store="auto"`` means.
- ``enable_compile_cache``: where the persistent XLA cache lives.

The choices for the GPU follow measurements on an H100 (PERF.md, "Bring-up
findings").
"""

from __future__ import annotations

import os
from typing import Optional

import jax

# repository root: bfir_tpu/utils/platform.py -> ../..
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def backend(device=None) -> str:
    """Platform name of ``device`` (a ``jax.Device``), or of the default
    backend when None."""
    return device.platform if device is not None else jax.default_backend()


def is_cpu(device=None) -> bool:
    return backend(device) == "cpu"


def pallas_interpret(device=None) -> bool:
    """Pallas kernels run interpreted on the CPU and compiled elsewhere."""
    return is_cpu(device)


def corr_mac_route() -> str:
    """Route of the G-batched bulk engine's correlation MAC
    (``core.nubatch``): "triton" (the Pallas kernel of ``kernels.corr_mac``)
    on accelerators, where it measured 13-23x faster than the fused XLA
    form on the H100 (PERF.md); "xla" (the fused jnp form) on the CPU,
    where the kernel could only be interpreted."""
    return "xla" if is_cpu() else "triton"


def bulk_nu_engine() -> str:
    """Long-filter offline renders (``core.bulk``): the G-cycle batched
    scan ("gbatch") on accelerators, the split-tail scan ("split") on the
    CPU, where it measured better."""
    return "split" if is_cpu() else "gbatch"


def default_tail_store(engine: str) -> str:
    """Storage tier ``nu_tail_store="auto"`` resolves to for ``engine``.
    int24 for the single-device two-stage engine on accelerators: on an
    H100 at the flagship geometry the session's own programs ran 10.4%
    (per-block step) and 11.4-12.2% (aligned scan) less device time per
    M-cycle with int24 than with float32, in each of three rounds
    (PERF.md), and the session's known-answer self-check still gates it.
    float32 for every other engine (the sharded and three-stage engines
    store float32/bfloat16 only) and on the CPU, which gains nothing from
    storage compression."""
    return "int24" if engine == "nonuniform" and not is_cpu() else "float32"


def enable_compile_cache(root: Optional[str] = None) -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing else is configured. Otherwise the cache is ``.jax_cache/`` in
    the checkout (``root`` overrides the checkout, for tests): a fixed
    path, since the path is part of what makes a cached entry hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root or _CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
