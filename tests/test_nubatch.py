"""G-cycle batched bulk scan (core.nubatch): equivalence with the
per-cycle macro scan, the scipy oracle, state interchange with the
per-block engine, shared-coefficient planes, and the guard rails.

Reference behavior under test: the overlap-save partitioned MAC law of
/root/reference/brutefir/fftw_convolver.cpp:1429-1525 on the non-uniform
schedule — the batched formulation must be numerically interchangeable
with ``process_blocks_nu_fast`` (same spectra, same MAC law, same tails).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.core import nonuniform as NU
from bfir_tpu.core import nubatch as NB


SPEC = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=3)
C = 4


def _mk(seed=0, taps=None, shared=False):
    rng = np.random.default_rng(seed)
    taps = taps or SPEC.max_taps
    h = rng.standard_normal((1 if shared else C, taps)).astype(np.float32) * 0.1
    co = NU.nu_coeffs(h, SPEC, C, shared=shared)
    return rng, h, co


def _blocks(rng, nblocks):
    xs = rng.standard_normal((C, nblocks * 128)).astype(np.float32)
    return xs, jnp.asarray(xs.reshape(C, nblocks, 128).transpose(1, 0, 2))


@pytest.mark.parametrize("g", [1, 2, 4])
def test_gbatch_matches_macro_scan(g):
    rng, h, co = _mk()
    xs, blocks = _blocks(rng, 16)
    st_a, ya = NU.process_blocks_nu_fast(
        NU.init_nu_state(SPEC, C), co, blocks)
    st_b, yb = NB.process_blocks_nu_gbatch(
        NU.init_nu_state(SPEC, C), co, blocks, cycles_per_step=g)
    scale = float(np.abs(np.asarray(ya)).max())
    np.testing.assert_allclose(np.asarray(yb), np.asarray(ya),
                               atol=2e-6 * scale)
    # the returned NuState must continue identically under the per-block
    # engine (ring/counter/pending reconstruction is exact)
    _, b2 = _blocks(rng, 4)
    _, ya2 = NU.process_blocks_nu(st_a, co, b2)
    _, yb2 = NU.process_blocks_nu(st_b, co, b2)
    np.testing.assert_allclose(np.asarray(yb2), np.asarray(ya2),
                               atol=2e-6 * scale)


def test_gbatch_scipy_oracle():
    rng, h, co = _mk(seed=3)
    xs, blocks = _blocks(rng, 16)
    _, out = NB.process_blocks_nu_gbatch(
        NU.init_nu_state(SPEC, C), co, blocks, cycles_per_step=4)
    y = np.asarray(out).transpose(1, 0, 2).reshape(C, -1)
    ref = signal.fftconvolve(xs.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5


def test_gbatch_resume_from_midstream_state():
    """Conversion must be exact from a NON-zero counter (arbitrary ring
    rotation) at an M-cycle boundary."""
    rng, h, co = _mk(seed=5)
    xs, blocks = _blocks(rng, 20)
    # warm a per-block state through 3 cycles (6 blocks)
    st = NU.init_nu_state(SPEC, C)
    st, y0 = NU.process_blocks_nu(st, co, blocks[:6])
    st_a, ya = NU.process_blocks_nu_fast(st, co, blocks[6:14])
    st_b, yb = NB.process_blocks_nu_gbatch(st, co, blocks[6:14],
                                           cycles_per_step=2)
    scale = float(np.abs(np.asarray(ya)).max())
    np.testing.assert_allclose(np.asarray(yb), np.asarray(ya),
                               atol=2e-6 * scale)


def test_gbatch_shared_coeffs():
    rng, h, co = _mk(seed=7, shared=True)
    xs, blocks = _blocks(rng, 8)
    _, out = NB.process_blocks_nu_gbatch(
        NU.init_nu_state(SPEC, C), co, blocks, cycles_per_step=2)
    y = np.asarray(out).transpose(1, 0, 2).reshape(C, -1)
    hb = np.broadcast_to(h, (C, h.shape[-1]))
    ref = signal.fftconvolve(xs.astype(np.float64), hb.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5


def test_gbatch_rejects_int_planes_and_misaligned_blocks():
    rng = np.random.default_rng(9)
    spec_i = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=3,
                       tail_store="int24")
    h = rng.standard_normal((C, spec_i.max_taps)).astype(np.float32) * 0.1
    co_i = NU.nu_coeffs(h, spec_i, C)
    blocks = jnp.zeros((8, C, 128), jnp.float32)
    with pytest.raises(ValueError, match="float plane storage"):
        NB.process_blocks_nu_gbatch(NU.init_nu_state(spec_i, C), co_i,
                                    blocks, cycles_per_step=2)
    _, _, co = _mk()
    with pytest.raises(ValueError, match="multiple of G\\*R"):
        NB.process_blocks_nu_gbatch(NU.init_nu_state(SPEC, C), co,
                                    blocks[:6], cycles_per_step=2)


# -- the correlation MAC: Triton kernel (interpret mode) vs the laws --------


def _corr_law_f64(hist, coeff, nb):
    """float64 literal: out[b] = sum_q coeff[q] (*) hist[P-1+b-q] with the
    halfcomplex lane-0 fixup (two real products at lane 0)."""
    hist = np.asarray(hist, np.float64)
    coeff = np.asarray(coeff, np.float64)
    p = coeff.shape[0]
    c, cs = hist.shape[1] // 2, coeff.shape[1] // 2
    yr = np.zeros((nb, c, hist.shape[2]))
    yi = np.zeros_like(yr)
    for q in range(p):
        w = hist[p - 1 - q:p - 1 - q + nb]
        cr, ci = coeff[q, :cs], coeff[q, cs:]
        dr = cr * w[:, :c] - ci * w[:, c:]
        di = cr * w[:, c:] + ci * w[:, :c]
        dr[..., 0] = (cr * w[:, :c])[..., 0]
        di[..., 0] = (ci * w[:, c:])[..., 0]
        yr += dr
        yi += di
    return yr, yi


@pytest.mark.parametrize("shared,nb,block_b,block_f", [
    (False, 8, 4, 128),    # two output chunks, two lane tiles
    (True, 8, 8, 256),     # shared planes, one chunk, one tile
    (False, 16, 4, 256),   # four chunks
    (True, 4, 16, 128),    # block_b clipped to nblocks
])
def test_corr_mac_triton_interpret_matches_numpy(shared, nb, block_b,
                                                 block_f):
    """kernels.corr_mac (Triton route, interpret mode) == the float64 law
    == the fused XLA form, for shared/distinct coefficients, chunked B and
    tiled Hp. f32 sum of P products: (P+1) eps32 of sum|terms| (bounded
    here by P * max|term| with |normal| < 6)."""
    from bfir_tpu.kernels.corr_mac import corr_mac_triton

    rng = np.random.default_rng(nb + block_b)
    p, c, hp = 4, 3, 256
    hist = rng.standard_normal((p - 1 + nb, 2 * c, hp)).astype(np.float32)
    coeff = rng.standard_normal((p, 2 if shared else 2 * c, hp)).astype(
        np.float32)
    yr, yi = corr_mac_triton(jnp.asarray(hist), jnp.asarray(coeff), nb,
                             block_b=block_b, block_f=block_f)
    er, ei = _corr_law_f64(hist, coeff, nb)
    tol = (p + 1) * np.finfo(np.float32).eps * 4 * p * 36.0
    np.testing.assert_allclose(np.asarray(yr), er, atol=tol)
    np.testing.assert_allclose(np.asarray(yi), ei, atol=tol)
    xr, xi = NB._corr_mac(jnp.asarray(hist), jnp.asarray(coeff), nb)
    np.testing.assert_allclose(np.asarray(yr), np.asarray(xr), atol=tol)
    np.testing.assert_allclose(np.asarray(yi), np.asarray(xi), atol=tol)


def test_corr_mac_triton_rejects_bad_tiles():
    from bfir_tpu.kernels.corr_mac import corr_mac_triton

    hist = jnp.zeros((3 + 6, 4, 256), jnp.float32)
    with pytest.raises(ValueError, match="powers of two"):
        corr_mac_triton(hist, jnp.zeros((4, 4, 256), jnp.float32), 6,
                        block_b=4)
    with pytest.raises(ValueError, match="P-1\\+B"):
        corr_mac_triton(hist, jnp.zeros((3, 4, 256), jnp.float32), 6)


def test_gbatch_triton_route_matches_scipy(monkeypatch):
    """With the platform naming the Triton route, the batched scan runs the
    kernel (interpreted on the CPU) and still matches scipy."""
    from bfir_tpu.utils import platform

    monkeypatch.setattr(platform, "corr_mac_route", lambda: "triton")
    rng, h, co = _mk(7)
    xs, blocks = _blocks(rng, 8)
    _, y = NB.process_blocks_nu_gbatch(NU.init_nu_state(SPEC, C), co, blocks,
                                       cycles_per_step=2)
    y = np.asarray(y).transpose(1, 0, 2).reshape(C, -1)
    ref = np.stack([signal.fftconvolve(xs[c].astype(np.float64),
                                       h[c].astype(np.float64))[:y.shape[1]]
                    for c in range(C)])
    snr = min(10 * np.log10((ref[c] ** 2).sum() / ((y[c] - ref[c]) ** 2).sum())
              for c in range(C))
    assert snr > 120, snr
