"""Core partitioned-convolver correctness vs scipy direct convolution.

Oracle strategy per SURVEY.md §4: scipy.signal direct/FFT convolution gives the
ground truth; property tests cover linearity, dirac-identity, and
partition-count invariance (the reference's brutefir.cpp:279-300 MAC must give
identical results for any partitioning of the same impulse).
"""

import numpy as np
import pytest
from scipy import signal

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import FilterSpec


def run_stream(spec, n_channels, impulse, x, mode="step"):
    """Push x [C, T] through the convolver block by block; return [C, T]."""
    state = cv.init_state(spec, n_channels)
    coeffs = cv.coeffs_to_spectra(impulse, spec)
    n = spec.block_length
    t = x.shape[-1]
    n_blocks = t // n
    blocks = x[:, : n_blocks * n].reshape(n_channels, n_blocks, n).transpose(1, 0, 2)
    if mode == "step":
        outs = []
        for b in range(n_blocks):
            state, out = cv.step(state, coeffs, blocks[b])
            outs.append(np.asarray(out))
        return np.concatenate(outs, axis=-1), state
    elif mode == "scan":
        state, outs = cv.process_blocks(state, coeffs, blocks)
        return np.asarray(outs).transpose(1, 0, 2).reshape(n_channels, -1), state
    elif mode == "batch":
        state, outs = cv.process_batch(state, coeffs, blocks)
        return np.asarray(outs).transpose(1, 0, 2).reshape(n_channels, -1), state
    raise ValueError(mode)


@pytest.mark.parametrize("mode", ["step", "scan", "batch"])
@pytest.mark.parametrize("n,p,taps", [(64, 1, 64), (64, 4, 200), (128, 8, 1024)])
def test_matches_scipy(mode, n, p, taps):
    rng = np.random.default_rng(42)
    spec = FilterSpec(block_length=n, n_partitions=p, dtype="float64")
    c = 2
    t = n * 16
    x = rng.standard_normal((c, t))
    h = rng.standard_normal(taps) * np.exp(-np.arange(taps) / taps)

    y, _ = run_stream(spec, c, h, x, mode=mode)
    ref = np.stack([signal.fftconvolve(x[i], h)[:t] for i in range(c)])
    np.testing.assert_allclose(y, ref, atol=1e-10)


def test_modes_agree_bitwise_state():
    rng = np.random.default_rng(1)
    spec = FilterSpec(block_length=32, n_partitions=4, dtype="float64")
    x = rng.standard_normal((3, 32 * 10))
    h = rng.standard_normal(100)
    y1, s1 = run_stream(spec, 3, h, x, mode="step")
    y2, s2 = run_stream(spec, 3, h, x, mode="scan")
    y3, s3 = run_stream(spec, 3, h, x, mode="batch")
    np.testing.assert_allclose(y1, y2, atol=1e-12)
    np.testing.assert_allclose(y1, y3, atol=1e-10)
    assert int(s1.blockcounter) == int(s2.blockcounter) == int(s3.blockcounter) == 10
    # ring state must agree so streaming can continue from any mode
    np.testing.assert_allclose(np.asarray(s1.spectra_ring), np.asarray(s3.spectra_ring),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(s1.prev_block), np.asarray(s3.prev_block))


def test_dirac_identity():
    # coeff::load_dirac_coeff semantics (coeff.cpp:32-59): unit impulse in
    # partition 0 -> output equals input delayed by 0 blocks.
    rng = np.random.default_rng(2)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    x = rng.standard_normal((1, 64 * 8))
    dirac = np.zeros(1)
    dirac[0] = 1.0
    y, _ = run_stream(spec, 1, dirac, x)
    np.testing.assert_allclose(y, x, atol=1e-12)


def test_partition_count_invariance():
    # same impulse split 1 vs 8 ways must agree (brutefir.cpp:279-300)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 512 * 6))
    h = rng.standard_normal(512)
    y1, _ = run_stream(FilterSpec(block_length=512, n_partitions=1, dtype="float64"), 2, h, x)
    y8, _ = run_stream(FilterSpec(block_length=64, n_partitions=8, dtype="float64"), 2, h, x)
    np.testing.assert_allclose(y1, y8, atol=1e-10)


def test_linearity():
    rng = np.random.default_rng(4)
    spec = FilterSpec(block_length=64, n_partitions=2, dtype="float64")
    x1 = rng.standard_normal((1, 64 * 4))
    x2 = rng.standard_normal((1, 64 * 4))
    h = rng.standard_normal(128)
    ya, _ = run_stream(spec, 1, h, x1)
    yb, _ = run_stream(spec, 1, h, x2)
    yab, _ = run_stream(spec, 1, h, 2.0 * x1 + 3.0 * x2)
    np.testing.assert_allclose(yab, 2 * ya + 3 * yb, atol=1e-10)


def test_per_channel_coefficients():
    rng = np.random.default_rng(5)
    spec = FilterSpec(block_length=64, n_partitions=2, dtype="float64")
    x = rng.standard_normal((2, 64 * 6))
    h = rng.standard_normal((2, 100))  # different filter per channel
    y, _ = run_stream(spec, 2, h, x)
    for ch in range(2):
        ref = signal.fftconvolve(x[ch], h[ch])[: x.shape[-1]]
        np.testing.assert_allclose(y[ch], ref, atol=1e-10)


def test_float32_snr():
    # float32 path (the accelerator default) must stay within float SNR of the
    # float64 oracle — BASELINE.md "output SNR dB" bound.
    rng = np.random.default_rng(6)
    spec = FilterSpec(block_length=256, n_partitions=4, dtype="float32")
    x = rng.standard_normal((2, 256 * 8)).astype(np.float32)
    h = (rng.standard_normal(1024) * np.exp(-np.arange(1024) / 300)).astype(np.float32)
    y, _ = run_stream(spec, 2, h, x)
    ref = np.stack([signal.fftconvolve(x[i].astype(np.float64), h.astype(np.float64))
                    [: x.shape[-1]] for i in range(2)])
    err = y - ref
    snr = 10 * np.log10(np.sum(ref**2) / np.sum(err**2))
    assert snr > 100.0, f"float32 SNR too low: {snr:.1f} dB"


def test_impulse_longer_than_filter_truncated():
    spec = FilterSpec(block_length=32, n_partitions=2, dtype="float64")
    h = np.ones(500)
    coeffs = cv.coeffs_to_spectra(h, spec)
    assert coeffs.shape == (2, 1, 33)


def test_direct_convolve_spectra():
    rng = np.random.default_rng(7)
    a = rng.standard_normal(300)
    b = rng.standard_normal(200)
    y = np.asarray(cv.direct_convolve_spectra(a, b))
    ref = np.convolve(a, b)
    np.testing.assert_allclose(y, ref, atol=1e-10)


def test_batch_with_prepared_coeffs_matches_scan():
    import jax.numpy as jnp
    # the bench path: prepare_batch_coeffs (split re/im planes, host-transfer
    # safe) passed into process_batch, on both the matmul and XLA FFT modes
    from bfir_tpu.ops import fft as F

    rng = np.random.default_rng(5)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float32")
    c, b = 2, 12
    h = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    blocks = jnp.asarray(rng.standard_normal((b, c, 64)).astype(np.float32))
    for mode in ("auto", "matmul"):
        F.set_mode(mode)
        try:
            coeffs = cv.coeffs_to_spectra(h, spec)
            hs = cv.prepare_batch_coeffs(coeffs, b)
            assert isinstance(hs, tuple) and hs[0].shape[0] == cv.batch_fft_len(b, 8)
            st1, out1 = cv.process_batch(cv.init_state(spec, c), coeffs, blocks,
                                         coeff_batch_fft=hs)
            st2, out2 = cv.process_blocks(cv.init_state(spec, c), coeffs, blocks)
        finally:
            F.set_mode("auto")
        np.testing.assert_allclose(np.asarray(out1), np.asarray(out2),
                                   atol=2e-4)
        # ring states agree too (resumability of the bulk path)
        np.testing.assert_allclose(np.asarray(jnp.real(st1.spectra_ring)),
                                   np.asarray(jnp.real(st2.spectra_ring)),
                                   atol=2e-4)
