"""Extended-precision (df64) engine path vs float64 scipy oracle.

The claim under test: on an f32-only backend, the extended path delivers
f64-class streaming accuracy — far beyond the f32 hc path at the same
geometry (reference parity target: REALSIZE=8, foo_dsp_bfir/common.h:17).
"""

import numpy as np
import pytest
from scipy import signal

from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.kernels import extended as E
from bfir_tpu.kernels import spectrum_mac as K


def snr_db(y, ref):
    e = y - ref
    return 10 * np.log10(float((ref**2).sum()) / max(float((e**2).sum()), 1e-300))


def test_step_df_beats_f32_by_30db():
    rng = np.random.default_rng(0)
    c, n, p = 2, 128, 32
    spec = FilterSpec(block_length=n, n_partitions=p, dtype="float32")
    h = (rng.standard_normal((c, n * p)) *
         np.exp(-np.arange(n * p) / 800.0)).astype(np.float64) * 0.1
    x = rng.standard_normal((c, n * 6)).astype(np.float32)
    ref = signal.fftconvolve(x.astype(np.float64), h, axes=1)[:, : n * 6]

    # f32 hc path
    s32 = K.init_hc_state(spec, c)
    c32 = K.hc_coeffs(h.astype(np.float32), spec, c)
    outs32 = []
    for b in range(6):
        s32, o = K.step_hc(s32, c32, x[:, b * n:(b + 1) * n])
        outs32.append(np.asarray(o, np.float64))
    snr32 = snr_db(np.concatenate(outs32, 1), ref)

    # extended path
    sdf = E.init_df_state(spec, c)
    ch, cl = E.df_coeffs(h, spec, c)
    outsdf = []
    for b in range(6):
        sdf, o = E.step_df(sdf, ch, cl, x[:, b * n:(b + 1) * n])
        outsdf.append(np.asarray(o, np.float64))
    snrdf = snr_db(np.concatenate(outsdf, 1), ref)

    assert snrdf > snr32 + 30, (snrdf, snr32)
    assert snrdf > 160, snrdf


def test_df_coeffs_matches_hc_coeffs_layout():
    rng = np.random.default_rng(1)
    c, n, p = 2, 64, 4
    spec = FilterSpec(block_length=n, n_partitions=p, dtype="float32")
    h = rng.standard_normal((c, 150)) * 0.1
    pk32 = np.asarray(K.hc_coeffs(h.astype(np.float32), spec, c))
    hi, lo = E.df_coeffs(h, spec, c)
    np.testing.assert_allclose(np.asarray(hi), pk32, atol=2e-5)
    assert np.max(np.abs(np.asarray(lo))) < np.max(np.abs(pk32)) * 1e-6


def test_hc_coeffs_precise_layout_and_accuracy():
    rng = np.random.default_rng(2)
    c, n, p = 2, 64, 4
    spec = FilterSpec(block_length=n, n_partitions=p, dtype="float32")
    h = rng.standard_normal((c, 200)) * 0.1
    fast = np.asarray(K.hc_coeffs(h.astype(np.float32), spec, c))
    prec = np.asarray(K.hc_coeffs(h, spec, c, precise=True))
    assert prec.shape == fast.shape and prec.dtype == fast.dtype
    np.testing.assert_allclose(prec, fast, atol=2e-5)
    # precise equals the f64 truth to storage rounding
    hi, _ = E.df_coeffs(h, spec, c)
    np.testing.assert_array_equal(prec, np.asarray(hi))


def test_step_df_crossfade_glitch_free():
    rng = np.random.default_rng(3)
    c, n, p = 1, 64, 4
    spec = FilterSpec(block_length=n, n_partitions=p, dtype="float32")
    h_old = np.zeros((c, 8)); h_old[:, 0] = 1.0
    h_new = np.zeros((c, 8)); h_new[:, 0] = 0.25
    st = E.init_df_state(spec, c)
    co = E.df_coeffs(h_old, spec, c)
    cn = E.df_coeffs(h_new, spec, c)
    x = np.ones((c, n), np.float32)
    for _ in range(3):
        st, o = E.step_df(st, *co, x)
    np.testing.assert_allclose(np.asarray(o), 1.0, atol=1e-6)
    st, o = E.step_df_crossfade(st, co, cn, x)
    seq = np.asarray(o)[0]
    assert abs(seq[0] - 1.0) < 1e-4
    assert np.all(np.diff(seq) <= 1e-6)  # monotone fade
    st, o = E.step_df(st, *cn, x)
    np.testing.assert_allclose(np.asarray(o), 0.25, atol=1e-6)
