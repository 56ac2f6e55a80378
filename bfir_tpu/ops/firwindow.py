"""Kaiser window + windowed-sinc FIR design.

Vectorized jnp equivalent of the reference's ``brutefir/firwindow.c``:

- ``i_zero``          -> ``firwindow.c:15-52``  (dynamic-range-safe Bessel I0)
- ``kaiser``          -> ``firwindow.c:54-87``
- ``firwindow_kaiser``-> ``firwindow.c:89-210`` (in-place window application with
  fractional offset and even/odd-length handling)

Divergence note (documented per SURVEY.md §2): the reference's fractional-offset
branch multiplies each tap by the window **twice** (``firwindow.c:129-130`` —
duplicated ``*= y`` statements), i.e. applies the *squared* window, while the
symmetric branches apply it once. We treat that as a bug and apply the window
exactly once in all branches; it only affects fractional-delay filters
(``delay.cpp:182-265`` subsample-delay sinc bank).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import i0 as _jax_i0


def kaiser_window(x, beta: float, dtype=jnp.float64):
    """Kaiser window evaluated at normalized positions ``x`` in [-1, 1].

    w(x) = I0(beta * sqrt(1 - x^2)) / I0(beta)   (firwindow.c:54-87)
    """
    x = jnp.clip(jnp.asarray(x, dtype=dtype), -1.0, 1.0)
    return _jax_i0(beta * jnp.sqrt(1.0 - x * x)) / _jax_i0(jnp.asarray(beta, dtype=dtype))


def window_positions(length: int, offset: float = 0.0) -> np.ndarray:
    """Normalized window positions for a length-N window, replicating the
    reference's three cases (firwindow.c:102-209):

    - offset == 0, odd N:  x_n = (n - N//2) / (N//2)
    - offset == 0, even N: centered between the middle samples
      (equivalent to offset = -0.5; firwindow.c:186-208)
    - fractional offset:  asymmetric rise/fall with center at N//2 + offset
      (firwindow.c:102-161)

    Computed host-side (static shapes; design-time only).
    """
    n = np.arange(length, dtype=np.float64)
    if offset != 0.0:
        center = length // 2 + offset
        max_i = int(np.floor(center))
        frac = center - max_i
        rise = max_i + frac  # distance from sample 0 to the center
        fall = (length - max_i - 1) - frac  # distance from center to sample N-1
        x = np.where(n <= max_i, (n - center) / rise, (n - center) / fall)
    elif length % 2 == 1:
        half = length // 2
        x = (n - half) / half
    else:
        half = length // 2
        # even length: center between the two middle samples (firwindow.c:186-208)
        x = (n - (half - 0.5)) / (half - 0.5)
    return np.clip(x, -1.0, 1.0)


def apply_kaiser(target, beta: float, offset: float = 0.0):
    """Apply a Kaiser window in place over an impulse (firwindow_kaiser)."""
    target = jnp.asarray(target)
    x = jnp.asarray(window_positions(target.shape[-1], offset), dtype=target.dtype)
    return target * kaiser_window(x, beta, dtype=target.dtype)


def sinc_impulse(length: int, cutoff: float, offset: float = 0.0, dtype=np.float64):
    """Ideal lowpass (sinc) impulse with normalized cutoff in (0, 0.5],
    centered at length//2 + offset, unit DC gain.

    This is the design core behind the reference's subsample-delay filter bank
    (``sample_sinc``, delay.cpp:278-306) and the windowed-sinc lowpasses of the
    BASELINE workloads.
    """
    n = np.arange(length, dtype=np.float64) - (length // 2 + offset)
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    return h.astype(dtype)


def kaiser_beta_for_attenuation(atten_db: float) -> float:
    """Standard Kaiser beta formula for a target stopband attenuation."""
    a = atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def design_lowpass(length: int, cutoff: float, beta: float = 9.0, offset: float = 0.0,
                   dtype=np.float64):
    """Kaiser-windowed sinc lowpass FIR (design-time, host-side numpy)."""
    h = sinc_impulse(length, cutoff, offset, dtype=np.float64)
    x = window_positions(length, offset)
    # host-side Bessel via the same series as the device path
    from numpy import i0 as _np_i0

    w = _np_i0(beta * np.sqrt(1.0 - x * x)) / _np_i0(beta)
    return (h * w).astype(dtype)
