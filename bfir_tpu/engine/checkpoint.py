"""Stream-state checkpoint / resume.

The reference has *no* runtime-state checkpointing (SURVEY.md §5: only
derived-artifact caching); a stream interrupted mid-block restarts cold.
This module adds it: the full convolver/dither/overflow state round-trips
through an ``.npz`` so a long offline render or a live stream can resume
exactly where it stopped. Complex arrays cross the host boundary as two
real planes (the ops.fft split-transfer helpers).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bfir_tpu.core import convolver as cv
from bfir_tpu.ops import dither as dth
from bfir_tpu.ops import fft as F


def save_state(
    path: str,
    state: cv.ConvolverState,
    dither_state: Optional[dth.DitherState] = None,
    overflow: Optional[dth.OverflowStats] = None,
) -> None:
    data = {
        "ring_re": np.real(F.to_numpy(state.spectra_ring)),
        "ring_im": np.imag(F.to_numpy(state.spectra_ring)),
        "prev_block": F.to_numpy(state.prev_block),
        "blockcounter": F.to_numpy(state.blockcounter),
    }
    if dither_state is not None:
        data.update(
            d_e0=F.to_numpy(dither_state.e0),
            d_e1=F.to_numpy(dither_state.e1),
            d_prev_byte=F.to_numpy(dither_state.prev_byte),
            d_key=F.to_numpy(dither_state.key),
        )
    if overflow is not None:
        data.update(
            of_n=F.to_numpy(overflow.n_overflows),
            of_largest=F.to_numpy(overflow.largest),
            of_intlargest=F.to_numpy(overflow.intlargest),
        )
    np.savez(path, **data)


def load_state(
    path: str,
) -> Tuple[cv.ConvolverState, Optional[dth.DitherState], Optional[dth.OverflowStats]]:
    z = np.load(path)
    import jax.numpy as jnp

    state = cv.ConvolverState(
        spectra_ring=F.from_numpy_complex(z["ring_re"] + 1j * z["ring_im"]),
        prev_block=jnp.asarray(z["prev_block"]),
        blockcounter=jnp.asarray(z["blockcounter"]),
    )
    dither_state = None
    if "d_e0" in z:
        dither_state = dth.DitherState(
            e0=jnp.asarray(z["d_e0"]),
            e1=jnp.asarray(z["d_e1"]),
            prev_byte=jnp.asarray(z["d_prev_byte"]),
            key=jnp.asarray(z["d_key"]),
        )
    overflow = None
    if "of_n" in z:
        overflow = dth.OverflowStats(
            n_overflows=jnp.asarray(z["of_n"]),
            largest=jnp.asarray(z["of_largest"]),
            intlargest=jnp.asarray(z["of_intlargest"]),
        )
    return state, dither_state, overflow
