import numpy as np
import pytest
from scipy import signal

from bfir_tpu.ops import delay as dl
from bfir_tpu.ops import noise as nz
from bfir_tpu.ops import resample as rs


# --------------------------------------------------------------------------
# resampler (replaces libsamplerate SRC_SINC_BEST_QUALITY, buffer.cpp:302)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("r_in,r_out", [(44100, 96000), (48000, 44100), (44100, 88200)])
def test_tone_preserved(r_in, r_out):
    # a passband tone must come out at the same frequency and amplitude
    f0 = 1000.0
    t_in = np.arange(int(r_in * 0.5)) / r_in
    x = np.sin(2 * np.pi * f0 * t_in)
    y = np.asarray(rs.resample(x, r_in, r_out))
    t_out = np.arange(y.size) / r_out
    ref = np.sin(2 * np.pi * f0 * t_out)
    # ignore filter-length edges
    k = 8192
    err = y[k:-k] - ref[k : y.size - k]
    snr = 10 * np.log10(np.mean(ref[k : y.size - k] ** 2) / np.mean(err**2))
    assert snr > 90.0, f"SNR {snr:.1f} dB"


def test_output_length():
    x = np.zeros(44100)
    y = rs.resample(x, 44100, 96000)
    assert y.shape[-1] == 96000


def test_multichannel_shape():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4410))
    y = np.asarray(rs.resample(x, 44100, 48000))
    assert y.shape == (3, 4800)


def test_imaging_rejected():
    # upsample then check spectrum above the original nyquist is deeply down
    rng = np.random.default_rng(1)
    x = rng.standard_normal(44100 * 1)
    # bandlimit the test signal itself first
    b = signal.firwin(513, 0.8)
    x = signal.lfilter(b, 1.0, x)
    y = np.asarray(rs.resample(x, 44100, 96000))
    f, pxx = signal.welch(y[8192:-8192], fs=96000, nperseg=8192)
    inband = pxx[(f > 1000) & (f < 17000)].mean()
    imaging = pxx[(f > 26000) & (f < 46000)].mean()
    assert 10 * np.log10(inband / imaging) > 100.0


def test_identity_rate():
    x = np.ones((2, 100))
    y = rs.resample(x, 48000, 48000)
    assert y.shape == (2, 100)
    np.testing.assert_array_equal(np.asarray(y), x)


# --------------------------------------------------------------------------
# delay lines (delay.cpp)
# --------------------------------------------------------------------------


def test_integer_delay_streaming():
    rng = np.random.default_rng(2)
    c, n, blocks = 2, 64, 6
    x = rng.standard_normal((c, n * blocks))
    delays = np.array([5, 17])
    st = dl.init_delay_state(c, max_delay=32, dtype=np.float64)
    outs = []
    for b in range(blocks):
        st, o = dl.apply_delay(st, x[:, b * n : (b + 1) * n], delays)
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)
    for ch in range(c):
        d = delays[ch]
        np.testing.assert_allclose(y[ch, d:], x[ch, : x.shape[1] - d], atol=1e-12)
        np.testing.assert_allclose(y[ch, :d], 0.0)


def test_runtime_delay_change():
    c, n = 1, 32
    x = np.arange(1.0, 2 * n + 1).reshape(1, -1)
    st = dl.init_delay_state(c, max_delay=16, dtype=np.float64)
    st, o1 = dl.apply_delay(st, x[:, :n], np.array([0]))
    st, o2 = dl.apply_delay(st, x[:, n:], np.array([4]))  # change_delay
    np.testing.assert_allclose(np.asarray(o1)[0], x[0, :n])
    # after the change the output is the input delayed by 4
    np.testing.assert_allclose(np.asarray(o2)[0], x[0, n - 4 : 2 * n - 4])


def test_sinc_bank_properties():
    bank = dl.sinc_interp_bank(step_count=8, half_length=16)
    assert bank.shape == (15, 33)
    # center row is an exact dirac (delay.cpp:236-247)
    center = bank[7]
    assert center[16] == 1.0 and np.abs(center).sum() == 1.0
    # every row has ~unit DC gain (interpolator)
    np.testing.assert_allclose(bank.sum(axis=1), 1.0, atol=5e-3)


def test_fractional_delay_interpolates():
    # delay a sine by 3 + 1/4 samples and compare to the analytic shift
    c, n = 1, 256
    f0 = 0.0123  # cycles/sample, well inside the interpolator band
    line = dl.FractionalDelayLine(c, max_delay=8, step_count=4, half_length=24,
                                  dtype=np.float64)
    st = line.init_state()
    t = np.arange(4 * n)
    x = np.sin(2 * np.pi * f0 * t).reshape(1, -1)
    outs = []
    for b in range(4):
        st, o = line(st, x[:, b * n : (b + 1) * n], np.array([3]), np.array([1]))
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)[0]
    total_delay = 3 + line.half_length + 1 / 4  # int + bank latency + frac
    ref = np.sin(2 * np.pi * f0 * (t - total_delay))
    seg = slice(2 * n, 3 * n)
    np.testing.assert_allclose(y[seg], ref[seg], atol=5e-4)


@pytest.mark.parametrize("delays,substeps", [([2, 5], [1, -3]),
                                             ([0, 7], [3, 0])])
def test_fractional_delay_float32_matches_f64_bank(delays, substeps):
    """The float32 line against a float64 literal of the same law,
    y[t] = sum_j h[j] x[t - d - j] with h the float64 bank row, within the
    rounding of a (K+2)-term f32 sum: a contraction that drops to TF32
    (10-bit mantissa) misses this bound by ~1000x."""
    c, n, blocks = 2, 64, 3
    line = dl.FractionalDelayLine(c, max_delay=8, step_count=4, half_length=8)
    bank = dl.sinc_interp_bank(step_count=4, half_length=8)
    x = np.random.default_rng(5).standard_normal((c, blocks * n)).astype(
        np.float32)
    st = line.init_state()
    outs = []
    for b in range(blocks):
        st, o = line(st, x[:, b * n:(b + 1) * n], np.array(delays),
                     np.array(substeps))
        outs.append(np.asarray(o, np.float64))
    y = np.concatenate(outs, axis=1)
    k = bank.shape[1]
    for ch in range(c):
        h = bank[substeps[ch] + 3]
        xs = np.r_[np.zeros(delays[ch]), x[ch].astype(np.float64)]
        ref = np.convolve(xs, h)[:blocks * n]
        mag = np.convolve(np.abs(xs), np.abs(h))[:blocks * n]
        err = np.abs(y[ch] - ref)
        assert np.all(err <= (k + 2) * np.finfo(np.float32).eps * mag
                      + 1e-30), float(np.max(err / (mag + 1e-30)))


# --------------------------------------------------------------------------
# noise probe (preprocessor::calculate_attenuation)
# --------------------------------------------------------------------------


def test_attenuation_zero_for_quiet_filter():
    h = np.zeros(256)
    h[0] = 0.5
    assert nz.calculate_attenuation(h, block_length=128) == 0.0


def test_attenuation_for_hot_filter():
    h = np.zeros(256)
    h[0] = 4.0  # +12 dB gain
    att = nz.calculate_attenuation(h, block_length=128)
    assert -12.5 < att < -11.0


def test_attenuation_bound_vs_probe():
    rng = np.random.default_rng(3)
    h = rng.standard_normal(512) * 0.2
    probe = nz.calculate_attenuation(h, block_length=256)
    bound = nz.attenuation_bound(h)
    # the analytic bound is at least as strict as the sampled probe
    assert bound <= probe + 1e-9


def test_white_noise_stats():
    x = np.asarray(nz.white_noise(2, 50000, seed=1, dtype=np.float64))
    assert x.shape == (2, 50000)
    assert np.abs(x).max() <= 1.0
    np.testing.assert_allclose(x.mean(), 0.0, atol=0.02)
    np.testing.assert_allclose(x.var(), 1 / 3, atol=0.02)  # uniform [-1,1)
