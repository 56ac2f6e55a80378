"""31-band ISO 1/3-octave equalizer rendered to a linear-phase FIR.

Vectorized jnp equivalent of the reference's ``brutefir/equalizer.cpp``:

- ISO band table            -> ``equalizer.hpp:17-50`` (20 Hz .. 20 kHz)
- band grid with virtual
  endpoints at 0 / Nyquist  -> ``equalizer.cpp:57-66`` and ``:113-114``
  (endpoint mags copied from the first/last real band)
- normalization             -> ``equalizer.cpp:116-121`` (freq /= rate,
  mag dB -> linear)
- spectrum synthesis        -> ``equalizer.cpp:235-259``: per rfft bin,
  raised-cosine interpolation of magnitude between the surrounding band
  points in linear normalized frequency, linear phase
  ``rad = -taps*pi*f + phase(f)``
- iFFT + upper-half extract -> ``equalizer.cpp:261-277``: the impulse is
  centered at ``taps/2`` by the linear phase; the causal FIR is the upper
  half, length ``taps/2`` (65536 -> 32768 taps at plugin defaults,
  common.h:18-19)

The reference builds the FFTW halfcomplex buffer by hand and runs an
unnormalized HC2R plan with a folded 1/taps scale (equalizer.cpp:235-263);
``F.irfft`` has the same sign convention with the normalization built
in, so the impulse here is bit-equivalent up to fp rounding.

Divergence (documented): the reference converts band phase "degrees" to
radians by *dividing by* 180*pi (``equalizer.cpp:120``) instead of
multiplying by pi/180 — a bug with no effect in practice since the plugin
always passes phase = 0 (prefs_eq.cpp). We convert correctly.

Behavioral note (faithfully reproduced): extracting only the causal upper
half of the linear-phase impulse means the realized response is roughly the
average of the requested curve and the spectral mean — a +6 dB band boost
measures ~+3.8 dB. This is inherent to the reference's renderer (verified
against a literal transliteration in tests/test_equalizer.py), not an
artifact of this implementation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from bfir_tpu.ops import fft as F

# ISO 1/3-octave center frequencies, Hz (equalizer.hpp:17-50).
ISO_BANDS = (
    20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0,
    200.0, 250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0,
    2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0, 12500.0,
    16000.0, 20000.0,
)


def synthesize_spectrum(
    taps: int,
    band_freqs_hz: Sequence[float],
    band_mags_db: Sequence[float],
    sample_rate: int,
    band_phases_deg: Optional[Sequence[float]] = None,
    dtype=jnp.float64,
):
    """Build the rfft spectrum [taps//2 + 1] of the EQ filter.

    Implements the synthesis loop of ``equalizer::render_d``
    (equalizer.cpp:330-354) vectorized over bins, via the band grid built in
    the constructor/generate (equalizer.cpp:57-66,101-121).
    """
    freqs = np.asarray(band_freqs_hz, dtype=np.float64)
    mags_db = np.asarray(band_mags_db, dtype=np.float64)
    if band_phases_deg is None:
        phases = np.zeros_like(freqs)
    else:
        phases = np.asarray(band_phases_deg, dtype=np.float64)
    if not (len(freqs) == len(mags_db) == len(phases)):
        raise ValueError("band arrays must have equal length")
    if np.any(np.diff(freqs) <= 0):
        raise ValueError("band frequencies must be strictly increasing")
    nyq = sample_rate / 2.0
    if freqs[0] <= 0 or freqs[-1] > nyq:
        raise ValueError("band frequencies must lie in (0, nyquist]")

    # virtual endpoints at 0 and Nyquist, mags/phases copied from the edge
    # bands (equalizer.cpp:60-66,113-114)
    gf = np.concatenate([[0.0], freqs, [nyq]]) / sample_rate
    gm = 10.0 ** (np.concatenate([[mags_db[0]], mags_db, [mags_db[-1]]]) / 20.0)
    gp = np.deg2rad(np.concatenate([[phases[0]], phases, [phases[-1]]]))
    # collapse a duplicated Nyquist point (last real band == nyquist)
    if gf[-1] == gf[-2]:
        gf, gm, gp = gf[:-1], gm[:-1], gp[:-1]

    half = taps // 2
    n = jnp.arange(1, half, dtype=dtype)
    curfreq = n / taps  # bin n is n/taps cycles/sample (equalizer.cpp:337)

    gf_j = jnp.asarray(gf, dtype=dtype)
    gm_j = jnp.asarray(gm, dtype=dtype)
    gp_j = jnp.asarray(gp, dtype=dtype)

    # interval i such that gf[i] <= curfreq <= gf[i+1]
    # (the `while curfreq > eqfreq[i+1]` walk, equalizer.cpp:338-341)
    hi = jnp.searchsorted(gf_j, curfreq, side="left")
    hi = jnp.clip(hi, 1, gf_j.shape[0] - 1)
    lo = hi - 1
    f1, f2 = gf_j[lo], gf_j[hi]
    t = (curfreq - f1) / (f2 - f1)

    def cosine_int(a, b):
        # (a-b)/2 * cos(pi*t) + (a+b)/2  (equalizer.cpp:182-204)
        return (a - b) * 0.5 * jnp.cos(jnp.pi * t) + (a + b) * 0.5

    mag = cosine_int(gm_j[lo], gm_j[hi])
    rad = -taps * jnp.pi * curfreq + cosine_int(gp_j[lo], gp_j[hi])

    # build as split re/im and combine on device
    re = jnp.concatenate([gm_j[0:1], mag * jnp.cos(rad), gm_j[-1:]])
    im = jnp.concatenate([jnp.zeros(1, dtype), mag * jnp.sin(rad), jnp.zeros(1, dtype)])
    return jax.lax.complex(re, im)


def render_fir(
    taps: int,
    band_mags_db: Sequence[float],
    sample_rate: int,
    band_freqs_hz: Sequence[float] = ISO_BANDS,
    band_phases_deg: Optional[Sequence[float]] = None,
    dtype=jnp.float64,
    mode: str = "reference",
):
    """Render the EQ to a FIR filter.

    mode="reference" (default): mirrors ``equalizer::generate`` + ``render_d``
    (equalizer.cpp:86-140, 306-394) — synthesize the linear-phase spectrum
    over ``taps`` points, inverse-FFT, keep the upper half (length taps//2,
    peak at sample 0). Realizes roughly half of narrow boosts (see module
    docstring) — kept for parity.

    mode="accurate": new capability — returns the full ``taps``-length
    symmetric linear-phase FIR (group delay taps/2), which realizes the
    requested curve exactly at the band resolution. Not available in the
    reference; callers must account for the taps/2 latency.
    """
    if taps < 4 or taps & (taps - 1):
        raise ValueError(f"taps must be a power of two >= 4, got {taps}")
    if mode not in ("reference", "accurate"):
        raise ValueError(f"unknown mode {mode!r}")
    spectrum = synthesize_spectrum(
        taps, band_freqs_hz, band_mags_db, sample_rate, band_phases_deg, dtype=dtype
    )
    impulse = F.irfft(spectrum, n=taps)
    if mode == "accurate":
        return impulse.astype(dtype)
    return impulse[taps // 2 :].astype(dtype)


def render_eq_spec(eq, filter_spec, eq_filter_blocks: int, sample_rate: int):
    """Render an ``EqSpec`` the way the plugin does at init
    (foo_dsp_bfir.cpp:150-176): taps = block_length * eq_filter_blocks,
    31 ISO bands, magnitudes in 0.1 dB steps."""
    taps = filter_spec.block_length * eq_filter_blocks
    dtype = jnp.float32 if filter_spec.dtype == "float32" else jnp.float64
    return render_fir(taps, eq.mag_db, sample_rate, dtype=dtype)
