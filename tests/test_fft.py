"""Matmul-DFT provider validated against numpy FFT on CPU.

The engine's default provider is XLA's FFT; the matmul-DFT formulations
(four-step, radix-4) remain selectable. These tests force that
path and compare with numpy's FFT at tight tolerances.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bfir_tpu.ops import fft as F


@pytest.fixture(autouse=True)
def force_matmul():
    F.set_mode("matmul")
    yield
    F.set_mode("auto")


@pytest.mark.parametrize("m", [8, 64, 256, 2048])
@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-10), (np.float32, 2e-3)])
def test_rfft_matches_numpy(m, dtype, atol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, m)).astype(dtype)
    got = np.asarray(F.rfft(x))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=atol * m)


@pytest.mark.parametrize("m", [8, 64, 2048])
def test_irfft_roundtrip(m):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, m))
    back = np.asarray(F.irfft(F.rfft(x), n=m))
    np.testing.assert_allclose(back, x, atol=1e-10)


def test_rfft_with_padding():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 100))
    got = np.asarray(F.rfft(x, n=256))
    ref = np.fft.rfft(x, n=256, axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_cfft_axis0_matches_numpy():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((16, 4, 9)) + 1j * rng.standard_normal((16, 4, 9))
    got = np.asarray(F.fft(y, n=32, axis=0))
    ref = np.fft.fft(y, n=32, axis=0)
    np.testing.assert_allclose(got, ref, atol=1e-9)
    got_i = np.asarray(F.ifft(got, axis=0))
    ref_i = np.fft.ifft(ref, axis=0)
    np.testing.assert_allclose(got_i, ref_i, atol=1e-10)


@pytest.mark.parametrize("m,n", [(512, None), (1024, None), (255, 512), (700, 128)])
@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-11), (np.complex64, 5e-6)])
def test_cfft_axis0_fourstep_matches_numpy(m, n, dtype, tol):
    # leading-axis transforms (process_batch's hot path) on both the default
    # moveaxis route (F.fft axis=0) and the left-matmul alternative (F.fft0),
    # incl. pad/truncate along axis 0
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((m, 3, 17)) + 1j * rng.standard_normal((m, 3, 17))).astype(dtype)
    yj = F.from_numpy_complex(y)
    for inverse in (False, True):
        rfn = np.fft.ifft if inverse else np.fft.fft
        ref = rfn(y, n=n, axis=0)
        scale = max(np.abs(ref).max(), 1e-30)
        fn = F.ifft if inverse else F.fft
        assert np.abs(F.to_numpy(fn(yj, n=n, axis=0)) - ref).max() / scale < tol
        fn0 = F.ifft0 if inverse else F.fft0
        assert np.abs(F.to_numpy(fn0(yj, n=n)) - ref).max() / scale < tol


@pytest.mark.parametrize("m,start,count", [(512, 127, 128), (512, 0, 512),
                                           (512, 500, 12), (100, 7, 50)])
def test_ifft0_slice_matches_numpy(m, start, count):
    rng = np.random.default_rng(8)
    y = rng.standard_normal((m, 5, 9)) + 1j * rng.standard_normal((m, 5, 9))
    got = F.to_numpy(F.ifft0_slice(F.from_numpy_complex(y), start, count))
    ref = np.fft.ifft(y, axis=0)[start : start + count]
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-11


@pytest.mark.parametrize("m", [512, 1024, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_radix4_tail_matches_numpy(m, inverse):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 7, m)) + 1j * rng.standard_normal((3, 7, m))
    gr, gi = F._cfft_fourstep_r4(jnp.asarray(x.real), jnp.asarray(x.imag), m, inverse)
    ref = (np.fft.ifft if inverse else np.fft.fft)(x, axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(gr) - ref.real).max() / scale < 1e-12
    assert np.abs(np.asarray(gi) - ref.imag).max() / scale < 1e-12


@pytest.mark.parametrize("m", [64, 256, 512, 2048])
def test_irfft_tail_matches_full(m):
    # upper-half-only inverse (the overlap-save valid region) == full + slice
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, m))
    y = np.fft.rfft(x, axis=-1)
    got = np.asarray(F.irfft_split_tail(jnp.asarray(y.real), jnp.asarray(y.imag), n=m))
    np.testing.assert_allclose(got, x[..., m // 2 :], atol=1e-10)
    got_c = F.to_numpy(F.irfft_tail(F.from_numpy_complex(y), n=m))
    np.testing.assert_allclose(got_c, x[..., m // 2 :], atol=1e-10)


def test_odd_irfft_length():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 64))
    y = np.fft.rfft(x, axis=-1)
    got = np.asarray(F.irfft(y.astype(np.complex128), n=64))
    np.testing.assert_allclose(got, x, atol=1e-10)


def test_convolver_on_matmul_fft():
    # whole-engine check on the matmul-DFT path
    from scipy import signal

    from bfir_tpu.core import convolver as cv
    from bfir_tpu.core.spec import FilterSpec

    rng = np.random.default_rng(5)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float64")
    x = rng.standard_normal((2, 128 * 8))
    h = rng.standard_normal(512)
    state = cv.init_state(spec, 2)
    coeffs = cv.coeffs_to_spectra(h, spec)
    blocks = x.reshape(2, 8, 128).transpose(1, 0, 2)
    state, out = cv.process_batch(state, coeffs, blocks)
    y = np.asarray(out).transpose(1, 0, 2).reshape(2, -1)
    ref = np.stack([signal.fftconvolve(x[i], h)[: x.shape[-1]] for i in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-9)


def test_cfft_fourstep_r4f_matches_numpy():
    """Twiddle-folded radix-4 four-step: fwd + inverse, 2D and 3D
    batches."""
    rng = np.random.default_rng(40)
    for m in (512, 2048):
        for inv in (False, True):
            zr = rng.standard_normal((6, m)).astype(np.float32)
            zi = rng.standard_normal((6, m)).astype(np.float32)
            ref = (np.fft.ifft if inv else np.fft.fft)(zr + 1j * zi, axis=-1)
            orr, oi = F._cfft_fourstep_r4f(jnp.asarray(zr), jnp.asarray(zi),
                                           m, inv)
            err = max(np.abs(np.asarray(orr) - ref.real).max(),
                      np.abs(np.asarray(oi) - ref.imag).max())
            assert err < 2e-5 * np.abs(ref).max(), (m, inv)
    zr = rng.standard_normal((3, 4, 512)).astype(np.float32)
    zi = rng.standard_normal((3, 4, 512)).astype(np.float32)
    ref = np.fft.fft(zr + 1j * zi, axis=-1)
    orr, oi = F._cfft_fourstep_r4f(jnp.asarray(zr), jnp.asarray(zi), 512, False)
    err = max(np.abs(np.asarray(orr) - ref.real).max(),
              np.abs(np.asarray(oi) - ref.imag).max())
    assert err < 2e-5 * np.abs(ref).max()


def test_rfft_split_hc_f32_matches_numpy():
    """The halfcomplex forward transform in float32 at the engine's head
    and tail widths (real packing + folded stage-1 + butterfly + untangle
    + hc pack)."""
    rng = np.random.default_rng(41)
    for shape, m in [((64, 2048), 2048), ((129, 2048), 2048), ((4, 4096), 4096)]:
        x = rng.standard_normal(shape).astype(np.float32)
        hr, hi = F.rfft_split_hc(jnp.asarray(x), n=m)
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        h = m // 2
        ref_hr = ref.real[..., :h]
        ref_hi = np.concatenate([ref.real[..., h:h + 1], ref.imag[..., 1:h]],
                                axis=-1)
        scale = np.abs(ref).max()
        err = max(np.abs(np.asarray(hr) - ref_hr).max(),
                  np.abs(np.asarray(hi) - ref_hi).max())
        assert err < 2e-5 * scale, (shape, err / scale)


def test_irfft_hc_tail_f32_matches_full_inverse():
    """The half-DFT tail basis == the upper half of the full inverse, in
    float32 at the engine's widths."""
    rng = np.random.default_rng(42)
    for rows, m in [(64, 2048), (130, 2048), (8, 4096)]:
        h = m // 2
        hr = rng.standard_normal((rows, h)).astype(np.float32)
        hi = rng.standard_normal((rows, h)).astype(np.float32)
        ref = np.asarray(F.irfft_split_hc(jnp.asarray(hr), jnp.asarray(hi),
                                          n=m))[:, h:]
        out = F.irfft_hc_tail(jnp.asarray(hr), jnp.asarray(hi), n=m)
        err = np.abs(np.asarray(out) - ref).max()
        assert err < 2e-5 * max(1.0, np.abs(ref).max()), (rows, m, err)
