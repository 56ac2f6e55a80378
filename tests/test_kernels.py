"""Spectrum MACs and the streaming steps built on them, against float64
numpy literals of the same law, scipy, and the complex-dtype convolver
path."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.kernels import spectrum_mac as K
from bfir_tpu.ops import fft as F


def test_mac_reference_matches_complex():
    rng = np.random.default_rng(0)
    p, c, f = 4, 2, 33
    rr, ri = rng.standard_normal((2, p, c, f))
    cr, ci = rng.standard_normal((2, p, c, f))
    for pos in range(p):
        yr, yi = K.mac_reference(rr, ri, cr, ci, np.int32(pos))
        ring = rr + 1j * ri
        coeffs = cr + 1j * ci
        idx = (pos - np.arange(p)) % p
        ref = (coeffs * ring[idx]).sum(axis=0)
        np.testing.assert_allclose(np.asarray(yr), ref.real, atol=1e-12)
        np.testing.assert_allclose(np.asarray(yi), ref.imag, atol=1e-12)


def _mac_f64(ring, coeff, pos, halfcomplex):
    """float64 numpy literal of the partition MAC law:
    y = sum_p coeff[p] * ring[(pos - p) mod P] on packed [P, 2C, F] planes
    (coeff may be [P, 2, F]: one filter for every channel). Halfcomplex
    planes carry (DC.re, Nyquist.re) in lane 0, whose product is two real
    multiplies."""
    ring = np.asarray(ring, np.float64)
    coeff = np.asarray(coeff, np.float64)
    p, c2, _ = ring.shape
    c, cs = c2 // 2, coeff.shape[1] // 2
    idx = (pos - np.arange(p)) % p
    rr, ri = ring[idx, :c], ring[idx, c:]
    cr, ci = coeff[:, :cs], coeff[:, cs:]
    yr = (cr * rr - ci * ri).sum(axis=0)
    yi = (cr * ri + ci * rr).sum(axis=0)
    if halfcomplex:
        yr[..., 0] = (cr[..., 0] * rr[..., 0]).sum(axis=0)
        yi[..., 0] = (ci[..., 0] * ri[..., 0]).sum(axis=0)
    return yr, yi


# f32 products summed over P partitions: each term carries <= 1 ulp of its
# magnitude, so the sum's error is bounded by ~P * eps32 * max|term|
def _mac_tol(ring, coeff, p):
    return 4 * p * np.finfo(np.float32).eps * float(
        np.abs(ring).max() * np.abs(coeff).max())


@pytest.mark.parametrize("pos", [0, 3, 7])
def test_mac_reference_matches_numpy_f64(pos):
    rng = np.random.default_rng(1)
    p, c, fp = 8, 8, 128
    ring = rng.standard_normal((p, 2 * c, fp)).astype(np.float32)
    coef = rng.standard_normal((p, 2 * c, fp)).astype(np.float32)
    yr, yi = K.mac_reference(ring[:, :c], ring[:, c:], coef[:, :c],
                             coef[:, c:], jnp.int32(pos))
    er, ei = _mac_f64(ring, coef, pos, halfcomplex=False)
    tol = _mac_tol(ring, coef, p)
    np.testing.assert_allclose(np.asarray(yr), er, atol=tol)
    np.testing.assert_allclose(np.asarray(yi), ei, atol=tol)


@pytest.mark.parametrize("shared", [False, True])
def test_step_split_matches_scipy(shared):
    """Per-channel coefficients and one filter broadcast to every channel."""
    coeff_channels = 1 if shared else 2
    rng = np.random.default_rng(2)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float64")
    c = 2
    h = rng.standard_normal((coeff_channels, 450)) * 0.1
    x = rng.standard_normal((c, 128 * 8))

    state = K.init_split_state(spec, c)
    cr, ci = K.split_coeffs(h, spec)
    assert cr.shape[1] == coeff_channels
    outs = []
    for b in range(8):
        state, o = K.step_split(state, cr, ci, x[:, b * 128 : (b + 1) * 128])
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)
    ref = np.stack([signal.fftconvolve(x[i], h[i % coeff_channels])
                    [: x.shape[-1]] for i in range(c)])
    np.testing.assert_allclose(y, ref, atol=1e-9)


def test_split_coeffs_matches_complex():
    rng = np.random.default_rng(3)
    spec = FilterSpec(block_length=64, n_partitions=3, dtype="float64")
    h = rng.standard_normal((2, 150))
    cr, ci = K.split_coeffs(h, spec)
    ref = np.asarray(F.to_numpy(cv.coeffs_to_spectra(h, spec)))
    np.testing.assert_allclose(np.asarray(cr)[..., : spec.n_freq], ref.real, atol=1e-10)
    np.testing.assert_allclose(np.asarray(ci)[..., : spec.n_freq], ref.imag, atol=1e-10)
    assert cr.shape[-1] % 128 == 0


def test_rfft_irfft_split_roundtrip():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2048))
    F.set_mode("matmul")
    try:
        re, im = F.rfft_split(x)
        y = np.fft.rfft(x, axis=-1)
        np.testing.assert_allclose(np.asarray(re), y.real, atol=1e-9)
        np.testing.assert_allclose(np.asarray(im), y.imag, atol=1e-9)
        back = F.irfft_split(re, im, n=2048)
        np.testing.assert_allclose(np.asarray(back), x, atol=1e-10)
    finally:
        F.set_mode("auto")


@pytest.mark.parametrize("blocks", [6])
def test_step_packed_matches_split(blocks):
    rng = np.random.default_rng(7)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float64")
    c = 2
    h = rng.standard_normal(450) * 0.1
    x = rng.standard_normal((c, 128 * blocks))

    s1 = K.init_split_state(spec, c)
    cr, ci = K.split_coeffs(h, spec)
    s2 = K.init_packed_state(spec, c)
    cpk = K.pack_coeffs(h, spec, c)
    assert cpk.shape == (4, 2 * c, s2.ring.shape[-1])

    for b in range(blocks):
        blk = x[:, b * 128 : (b + 1) * 128]
        s1, o1 = K.step_split(s1, cr, ci, blk)
        s2, o2 = K.step_packed(s2, cpk, blk)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-10)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_step_chunked_matches_split(k):
    rng = np.random.default_rng(8)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float64")
    c = 2
    h = rng.standard_normal(450) * 0.1
    x = rng.standard_normal((c, 128 * 7))

    s1 = K.init_split_state(spec, c)
    cr, ci = K.split_coeffs(h, spec)
    s3 = K.init_doubled_state(spec, c)
    crk = K.chunk_reverse_coeffs(K.pack_coeffs(h, spec, c), k)

    for b in range(7):
        blk = x[:, b * 128 : (b + 1) * 128]
        s1, o1 = K.step_split(s1, cr, ci, blk)
        s3, o3 = K.step_chunked(s3, crk, blk, k=k)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o3), atol=1e-10,
                                   err_msg=f"block {b} k={k}")


def test_chunk_reverse_coeffs():
    x = np.arange(8 * 2 * 4, dtype=np.float64).reshape(8, 2, 4)
    y = np.asarray(K.chunk_reverse_coeffs(x, 4))
    np.testing.assert_array_equal(y[0], x[3])
    np.testing.assert_array_equal(y[3], x[0])
    np.testing.assert_array_equal(y[4], x[7])


def test_rfft_irfft_split_hc_roundtrip():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 2048))
    F.set_mode("matmul")
    try:
        hr, hi = F.rfft_split_hc(x)
        assert hr.shape[-1] == 1024 and hi.shape[-1] == 1024
        y = np.fft.rfft(x, axis=-1)
        np.testing.assert_allclose(np.asarray(hr[..., 0]), y[..., 0].real, atol=1e-9)
        np.testing.assert_allclose(np.asarray(hi[..., 0]), y[..., -1].real, atol=1e-9)
        np.testing.assert_allclose(np.asarray(hr[..., 1:]), y[..., 1:1024].real, atol=1e-9)
        np.testing.assert_allclose(np.asarray(hi[..., 1:]), y[..., 1:1024].imag, atol=1e-9)
        back = F.irfft_split_hc(hr, hi, n=2048)
        np.testing.assert_allclose(np.asarray(back), x, atol=1e-10)
        # padded planes accepted (engine stores lane-rounded arrays)
        back2 = F.irfft_split_hc(jnp.pad(hr, ((0, 0), (0, 64))),
                                 jnp.pad(hi, ((0, 0), (0, 64))), n=2048)
        np.testing.assert_allclose(np.asarray(back2), x, atol=1e-10)
    finally:
        F.set_mode("auto")


def test_irfft_hc_tail_matches_full():
    rng = np.random.default_rng(15)
    for m in (256, 2048):
        hr = rng.standard_normal((3, m // 2))
        hi = rng.standard_normal((3, m // 2))
        full = np.asarray(F.irfft_split_hc(hr, hi, n=m))
        tail = np.asarray(F.irfft_hc_tail(hr, hi, n=m))
        np.testing.assert_allclose(tail, full[..., m // 2:], atol=1e-10)
    # lane-padded input accepted
    t2 = np.asarray(F.irfft_hc_tail(jnp.pad(hr, ((0, 0), (0, 64))),
                                    jnp.pad(hi, ((0, 0), (0, 64))), n=2048))
    np.testing.assert_allclose(t2, tail, atol=1e-12)


@pytest.mark.parametrize("pos", [0, 3, 7])
def test_mac_hc_matches_numpy_f64(pos):
    rng = np.random.default_rng(10)
    p, c, hp = 8, 4, 128
    ring = rng.standard_normal((p, 2 * c, hp)).astype(np.float32)
    coef = rng.standard_normal((p, 2 * c, hp)).astype(np.float32)
    yr, yi = K.mac_hc(jnp.asarray(ring), jnp.asarray(coef), jnp.int32(pos))
    er, ei = _mac_f64(ring, coef, pos, halfcomplex=True)
    tol = _mac_tol(ring, coef, p)
    np.testing.assert_allclose(np.asarray(yr), er, atol=tol)
    np.testing.assert_allclose(np.asarray(yi), ei, atol=tol)


@pytest.mark.parametrize("shared", [False, True])
def test_step_hc_matches_split_and_scipy(shared):
    rng = np.random.default_rng(11)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float64")
    c = 2
    h = rng.standard_normal((1 if shared else c, 450)) * 0.1
    x = rng.standard_normal((c, 128 * 8))

    s1 = K.init_split_state(spec, c)
    cr, ci = K.split_coeffs(h, spec)
    s2 = K.init_hc_state(spec, c)
    chc = K.hc_coeffs(h, spec, c, shared=shared)
    # n_fft//2 = 128: no pad at all; shared planes carry one channel
    assert chc.shape == (4, 2 if shared else 2 * c, 128)

    outs = []
    for b in range(8):
        blk = x[:, b * 128 : (b + 1) * 128]
        s1, o1 = K.step_split(s1, cr, ci, blk)
        s2, o2 = K.step_hc(s2, chc, blk)
        np.testing.assert_allclose(np.asarray(o2), np.asarray(o1), atol=1e-10)
        outs.append(np.asarray(o2))
    y = np.concatenate(outs, axis=1)
    ref = np.stack([signal.fftconvolve(x[i], h[0 if shared else i])
                    [: x.shape[-1]] for i in range(c)])
    np.testing.assert_allclose(y, ref, atol=1e-9)


# stored forms of the MAC planes, with each form's distance from the f32
# result in units of the f32 bound _mac_tol: bfloat16 keeps 8 mantissa
# bits (2^-8 relative per plane); int16/int24 quantize each row to 15/23
# bits of its row maximum.
_STORES = {"float32": 1.0, "bfloat16": 2.0 ** 16, "int24": 64.0,
           "int16": 2.0 ** 14}


@pytest.mark.parametrize("store", list(_STORES))
def test_mac_hc_stored_forms_match_numpy(store):
    """``mac_hc`` decodes every stored plane form to f32 and matches the
    float64 law evaluated on the decoded planes (distinct and shared
    coefficient layouts both)."""
    rng = np.random.default_rng(19)
    p, c, hp = 6, 3, 256
    ring = rng.standard_normal((p, 2 * c, hp)).astype(np.float32)
    pos = 4
    for coef in (rng.standard_normal((p, 2 * c, hp)).astype(np.float32),
                 rng.standard_normal((p, 2, hp)).astype(np.float32)):
        if store == "bfloat16":
            r_st = jnp.asarray(ring).astype(jnp.bfloat16)
            c_st = jnp.asarray(coef).astype(jnp.bfloat16)
            r_dec, c_dec = r_st.astype(jnp.float32), c_st.astype(jnp.float32)
        elif store in ("int16", "int24"):
            bits = int(store[3:])
            r_st = K.quantize_planes(jnp.asarray(ring), bits)
            c_st = K.quantize_planes(jnp.asarray(coef), bits)
            r_dec = K.dequantize_planes(r_st)
            c_dec = K.dequantize_planes(c_st)
        else:
            r_st = r_dec = jnp.asarray(ring)
            c_st = c_dec = jnp.asarray(coef)
        yr, yi = K.mac_hc(r_st, c_st, jnp.int32(pos))
        er, ei = _mac_f64(r_dec, c_dec, pos, halfcomplex=True)
        tol = _mac_tol(ring, coef, p)  # the decode itself is exact in f32
        np.testing.assert_allclose(np.asarray(yr), er, atol=tol)
        np.testing.assert_allclose(np.asarray(yi), ei, atol=tol)
        # and the stored form stays within its storage precision of f32
        fr, fi = _mac_f64(ring, coef, pos, halfcomplex=True)
        np.testing.assert_allclose(np.asarray(yr), fr,
                                   atol=tol * _STORES[store])
        np.testing.assert_allclose(np.asarray(yi), fi,
                                   atol=tol * _STORES[store])


def test_step_hc_crossfade_matches_packed():
    rng = np.random.default_rng(13)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float64")
    c = 2
    h_old = rng.standard_normal((c, 400)) * 0.1
    h_new = rng.standard_normal((c, 400)) * 0.1
    x = rng.standard_normal((c, 128 * 5))

    sp = K.init_packed_state(spec, c)
    pk_old = K.pack_coeffs(h_old, spec, c)
    pk_new = K.pack_coeffs(h_new, spec, c)
    sh = K.init_hc_state(spec, c)
    hc_old = K.hc_coeffs(h_old, spec, c)
    hc_new = K.hc_coeffs(h_new, spec, c)

    for b in range(3):
        blk = x[:, b * 128 : (b + 1) * 128]
        sp, op = K.step_packed(sp, pk_old, blk)
        sh, oh = K.step_hc(sh, hc_old, blk)
        np.testing.assert_allclose(np.asarray(oh), np.asarray(op), atol=1e-10)
    blk = x[:, 3 * 128 : 4 * 128]
    sp, op = K.step_packed_crossfade(sp, pk_old, pk_new, blk)
    sh, oh = K.step_hc_crossfade(sh, hc_old, hc_new, blk)
    np.testing.assert_allclose(np.asarray(oh), np.asarray(op), atol=1e-10)
    blk = x[:, 4 * 128 : 5 * 128]
    sp, op = K.step_packed(sp, pk_new, blk)
    sh, oh = K.step_hc(sh, hc_new, blk)
    np.testing.assert_allclose(np.asarray(oh), np.asarray(op), atol=1e-10)


# -- overlap-save tail and the convolution law through the transforms ------


@pytest.mark.parametrize("mode", ["xla", "matmul"])
@pytest.mark.parametrize("m", [2048, 4096])
def test_irfft_hc_tail_matches_numpy_f64(mode, m):
    """Both FFT providers' overlap-save tail == the upper half of numpy's
    float64 inverse, at float32. Error bound: ~eps32 * log2(m) of the
    output scale (an FFT's rounding growth; the matmul DFT at HIGHEST
    precision is no worse)."""
    rng = np.random.default_rng(91)
    yr = rng.standard_normal((16, m // 2)).astype(np.float32)
    yi = rng.standard_normal((16, m // 2)).astype(np.float32)
    full = (np.concatenate([yr, yi[:, :1]], axis=1).astype(np.float64)
            + 1j * np.concatenate([np.zeros((16, 1)), yi[:, 1:],
                                   np.zeros((16, 1))], axis=1))
    ref = np.fft.irfft(full, n=m, axis=-1)[:, m // 2:]
    F.set_mode(mode)
    try:
        out = np.asarray(F.irfft_hc_tail(jnp.asarray(yr), jnp.asarray(yi),
                                         n=m))
    finally:
        F.set_mode("auto")
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=8 * np.log2(m)
                               * np.finfo(np.float32).eps * scale)


def test_hc_roundtrip_convolution_law():
    """End-to-end law: rfft_split_hc -> halfcomplex MAC (one partition) ->
    irfft_hc_tail == the valid block of a linear convolution (the step_hc
    data path)."""
    rng = np.random.default_rng(92)
    n = 2048
    m = 2 * n
    c = 4
    h = rng.standard_normal((c, n)).astype(np.float32) * 0.1
    prev = rng.standard_normal((c, n)).astype(np.float32)
    blk = rng.standard_normal((c, n)).astype(np.float32)
    frame = np.concatenate([prev, blk], axis=1)
    hr, hi = F.rfft_split_hc(jnp.asarray(frame))
    cr, ci = F.rfft_split_hc(jnp.asarray(np.pad(h, ((0, 0), (0, n)))))
    yr, yi = K.mac_reference_hc(hr[None], hi[None], cr[None], ci[None],
                                jnp.zeros((), jnp.int32))
    out = F.irfft_hc_tail(yr, yi, n=m)
    ref = np.stack([signal.fftconvolve(frame[ch].astype(np.float64),
                                       h[ch].astype(np.float64))[n: 2 * n]
                    for ch in range(c)])
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=1e-4 * np.abs(ref).max())


# -- shared-coefficient MAC (one filter for all channels) -------------------


def test_mac_shared_coeffs_match_broadcast():
    """coeff [P, 2, Hp] (shared) == coeff [P, 2C, Hp] (broadcast) through
    every MAC form: the split-plane reference, the packed ``mac_hc``, the
    banded MAC and the int-stored MAC."""
    rng = np.random.default_rng(95)
    p, c, hp = 4, 6, 256
    ring = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    co1 = rng.standard_normal((p, 2, hp)).astype(np.float32)
    cob = np.concatenate([np.repeat(co1[:, :1], c, axis=1),
                          np.repeat(co1[:, 1:], c, axis=1)], axis=1)
    pos = jnp.asarray(2, jnp.int32)
    r_ref = K.mac_reference_hc(ring[:, :c], ring[:, c:],
                               jnp.asarray(cob[:, :c]), jnp.asarray(cob[:, c:]),
                               pos)
    r_sh = K.mac_reference_hc(ring[:, :c], ring[:, c:],
                              jnp.asarray(co1[:, :1]), jnp.asarray(co1[:, 1:]),
                              pos)
    np.testing.assert_allclose(np.asarray(r_sh[0]), np.asarray(r_ref[0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(r_sh[1]), np.asarray(r_ref[1]),
                               atol=1e-5)
    k_b = K.mac_hc(ring, jnp.asarray(cob), pos)
    k_s = K.mac_hc(ring, jnp.asarray(co1), pos)
    np.testing.assert_allclose(np.asarray(k_s[0]), np.asarray(k_b[0]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(k_s[1]), np.asarray(k_b[1]), atol=1e-5)
    t_b = K.mac_reference_hc_band(ring, jnp.asarray(cob), pos, 128, 128)
    t_s = K.mac_reference_hc_band(ring, jnp.asarray(co1), pos, 128, 128)
    np.testing.assert_allclose(np.asarray(t_s[0]), np.asarray(t_b[0]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(t_s[1]), np.asarray(t_b[1]), atol=1e-5)
    q_b = K.mac_hc(K.quantize_planes(ring, 24),
                   K.quantize_planes(jnp.asarray(cob), 24), pos)
    q_s = K.mac_hc(K.quantize_planes(ring, 24),
                   K.quantize_planes(jnp.asarray(co1), 24), pos)
    np.testing.assert_allclose(np.asarray(q_s[0]), np.asarray(q_b[0]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(q_s[1]), np.asarray(q_b[1]), atol=1e-5)


def test_step_hc_with_shared_coeffs():
    """step_hc streams correctly with shared coefficient planes."""
    from scipy import signal

    rng = np.random.default_rng(96)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float32")
    c = 3
    h1 = rng.standard_normal((1, spec.max_taps)).astype(np.float32) * 0.1
    co = K.hc_coeffs(h1, spec, c, shared=True)
    assert co.shape[1] == 2  # one plane pair, not 2C
    st = K.init_hc_state(spec, c)
    x = rng.standard_normal((c, 64 * 8)).astype(np.float32)
    outs = []
    for b in range(8):
        st, o = K.step_hc(st, co, x[:, b * 64:(b + 1) * 64])
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)
    ref = np.stack([signal.fftconvolve(x[ch].astype(np.float64),
                                       h1[0].astype(np.float64))[:y.shape[1]]
                    for ch in range(c)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr
