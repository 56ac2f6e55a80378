"""Integer and fractional (subsample) delay lines.

Device equivalent of the reference's ``brutefir/delay.{cpp,hpp}``:

- integer delay ring + runtime delay changes -> ``delay_allocate_buffer`` /
  ``update_delay_buffer`` / ``change_delay`` (delay.cpp:56-140,495-600).
  Here: a [C, Dmax] history pytree + per-channel gather; changing the delay
  is just changing the (traced) delay vector — no buffer reshuffling.
- subsample delay via a bank of Kaiser-windowed sinc interpolators ->
  ``subsample_init`` / ``sample_sinc`` (delay.cpp:182-306): 2*step_count-1
  odd-length filters sampled at offsets n/step_count, applied through the
  small time-domain convolver (``convolver_td_convolve``). Here the bank is
  precomputed host-side and applied as a vectorized dot over a gathered
  window — no FFT needed at these lengths.

Divergences (documented):
- ``sample_sinc`` ignores its ``kaiser_beta`` argument and hardcodes beta=9
  (delay.cpp:305); we honor the argument (default 9 keeps parity).
- the reference's fractional-offset Kaiser window is applied twice
  (squared window — firwindow.c:129-130 duplicated ``*=``); we apply it
  once (see ops.firwindow docstring).

The reference compiles this capability into the engine but the plugin never
calls it (SURVEY.md §2 delay row); it is part of the BruteFIR capability
surface, so it is included and tested here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bfir_tpu.ops.firwindow import window_positions


class DelayState(NamedTuple):
    """history: [C, Dmax] — the last Dmax input samples per channel
    (newest at the right edge)."""

    history: jax.Array


def init_delay_state(n_channels: int, max_delay: int, dtype=jnp.float32) -> DelayState:
    return DelayState(history=jnp.zeros((n_channels, max_delay), dtype=dtype))


def apply_delay(
    state: DelayState, block: jax.Array, delays: jax.Array
) -> Tuple[DelayState, jax.Array]:
    """Delay each channel of ``block`` [C, N] by ``delays`` [C] samples
    (0 <= delay <= Dmax). Runtime-variable delays supported (the reference's
    change_delay, delay.cpp:552-600, without its buffer-shuffle machinery).
    """
    c, n = block.shape
    dmax = state.history.shape[1]
    ext = jnp.concatenate([state.history, block], axis=1)  # [C, Dmax + N]
    # out[c, t] = ext[c, Dmax + t - d_c]
    t_idx = jnp.arange(n)[None, :] + (dmax - delays[:, None])  # [C, N]
    out = jnp.take_along_axis(ext, t_idx, axis=1)
    new_hist = ext[:, -dmax:] if dmax > 0 else state.history
    return DelayState(history=new_hist), out


def sinc_interp_bank(step_count: int, half_length: int, beta: float = 9.0,
                     dtype=np.float64) -> np.ndarray:
    """Bank of fractional-delay filters, index s in [-(S-1) .. S-1] mapped to
    offset s/step_count samples (delay.cpp:222-265). Returns
    [2*step_count - 1, 2*half_length + 1]; row index s + (step_count - 1).

    Row for s=0 is the exact dirac (delay.cpp:236-247).
    """
    if step_count < 2 or half_length < 1:
        raise ValueError("step_count >= 2 and half_length >= 1 required")
    length = 2 * half_length + 1
    bank = np.zeros((2 * step_count - 1, length), dtype=np.float64)
    n = np.arange(length)
    from numpy import i0 as _i0

    for s in range(-(step_count - 1), step_count):
        row = s + step_count - 1
        if s == 0:
            bank[row, half_length] = 1.0
            continue
        offset = s / step_count
        x = np.pi * ((n - half_length) - offset)
        h = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0, 1.0, x))
        w = window_positions(length, offset)
        win = _i0(beta * np.sqrt(1.0 - w * w)) / _i0(beta)
        bank[row] = h * win
    return bank.astype(dtype)


class FractionalDelayLine:
    """Streaming fractional delay: integer part via ``apply_delay`` history,
    fractional part via the sinc bank (the reference applies the bank through
    its time-domain convolver, delay.cpp:148-180)."""

    def __init__(self, n_channels: int, max_delay: int, step_count: int = 16,
                 half_length: int = 16, beta: float = 9.0, dtype=jnp.float32):
        self.step_count = step_count
        self.half_length = half_length
        self.bank = jnp.asarray(
            sinc_interp_bank(step_count, half_length, beta), dtype=dtype
        )
        self.length = 2 * half_length + 1
        self.n_channels = n_channels
        # history needs max integer delay + filter span
        self.dmax = max_delay + self.length
        self.dtype = dtype

    def init_state(self) -> DelayState:
        return init_delay_state(self.n_channels, self.dmax, self.dtype)

    def __call__(
        self, state: DelayState, block: jax.Array, delays_int: jax.Array,
        substeps: jax.Array,
    ) -> Tuple[DelayState, jax.Array]:
        """delays_int [C] integer sample delays; substeps [C] in
        [-(step_count-1), step_count-1], fractional delay = substep/step_count
        samples (sign convention of subsample_update, delay.cpp:148-180)."""
        c, n = block.shape
        ext = jnp.concatenate([state.history, block], axis=1)
        # the sinc filter covers [t - half .. t + half]; total shift is
        # delays_int + half_length so the filter window stays causal
        base = state.history.shape[1] - delays_int[:, None] - self.length + 1
        t_idx = jnp.arange(n)[None, :] + base  # window start per output [C, N]
        # gather [C, N, K] windows
        k_idx = t_idx[:, :, None] + jnp.arange(self.length)[None, None, :]
        win = jnp.take_along_axis(
            ext[:, :, None], k_idx.reshape(c, -1)[:, :, None], axis=1
        ).reshape(c, n, self.length)
        coefs = self.bank[substeps + self.step_count - 1]  # [C, K]
        # correlation: out[t] = sum_k win[t, k] * h[K-1-k] (h applied as conv)
        # HIGHEST: full float32 products (a GPU would otherwise use TF32)
        out = jnp.einsum("cnk,ck->cn", win, coefs[:, ::-1],
                         precision=jax.lax.Precision.HIGHEST)
        new_hist = ext[:, -state.history.shape[1]:]
        return DelayState(history=new_hist), out
