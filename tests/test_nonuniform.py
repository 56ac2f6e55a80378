"""Two-stage non-uniform partitioned convolution (core/nonuniform.py):
scipy oracle, uniform-engine equivalence, state-carry/checkpoint property,
banded-MAC parity, geometry validation."""

import numpy as np
import pytest
from scipy import signal

import jax
import jax.numpy as jnp

from bfir_tpu.core import nonuniform as NU
from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.kernels import spectrum_mac as K


def _run_nu(spec, h, x, **kw):
    c = h.shape[0]
    coeffs = NU.nu_coeffs(h, spec, c)
    st = NU.init_nu_state(spec, c)
    n = spec.block_length
    blocks = jnp.asarray(x.reshape(c, -1, n).transpose(1, 0, 2))
    st, out = NU.process_blocks_nu(st, coeffs, blocks, **kw)
    return st, np.asarray(out.transpose(1, 0, 2).reshape(c, -1))


def _scipy_ref(h, x, nsamp):
    return np.stack(
        [signal.fftconvolve(x[c], h[c])[:nsamp] for c in range(h.shape[0])]
    )


@pytest.mark.parametrize("matmul_fft", [False, True])
def test_nu_matches_scipy(matmul_fft):
    """Both FFT providers (the native FFT and the matmul DFTs)."""
    from bfir_tpu.ops import fft as F

    rng = np.random.default_rng(0)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=3)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 30 * spec.block_length)).astype(np.float32)
    F.set_mode("matmul" if matmul_fft else "xla")
    try:
        _, y = _run_nu(spec, h, x)
    finally:
        F.set_mode("auto")
    ref = _scipy_ref(h, x, y.shape[1])
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_nu_partial_taps_and_ratio4():
    """Impulse shorter than max_taps (tail partially filled) and R=4."""
    rng = np.random.default_rng(1)
    spec = NU.NuSpec(block_length=4, ratio=4, p_head=8, p_tail=2)
    c = 3
    taps = spec.max_taps - spec.m - 3  # ends mid tail partition
    h = rng.standard_normal((c, taps)).astype(np.float32)
    x = rng.standard_normal((c, 64 * spec.block_length)).astype(np.float32)
    _, y = _run_nu(spec, h, x)
    ref = _scipy_ref(h, x, y.shape[1])
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_nu_head_only_taps():
    """Impulse entirely inside the head: tail contributes exact zeros."""
    rng = np.random.default_rng(2)
    spec = NU.NuSpec(block_length=4, ratio=2, p_head=4, p_tail=1)
    c = 2
    h = rng.standard_normal((c, 3 * spec.block_length)).astype(np.float32)
    x = rng.standard_normal((c, 20 * spec.block_length)).astype(np.float32)
    _, y = _run_nu(spec, h, x)
    ref = _scipy_ref(h, x, y.shape[1])
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_nu_matches_uniform_engine():
    """Same impulse through the uniform hc engine and the nu engine."""
    rng = np.random.default_rng(3)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 24 * spec.block_length)).astype(np.float32)
    _, y = _run_nu(spec, h, x)

    uspec = FilterSpec(spec.block_length, spec.max_taps // spec.block_length)
    ucoef = K.hc_coeffs(h, uspec, c)
    ust = K.init_hc_state(uspec, c)
    blocks = jnp.asarray(x.reshape(c, -1, spec.block_length).transpose(1, 0, 2))

    def body(st, blk):
        st, out = K.step_hc(st, ucoef, blk)
        return st, out

    _, uout = jax.lax.scan(body, ust, blocks)
    uy = np.asarray(uout.transpose(1, 0, 2).reshape(c, -1))
    np.testing.assert_allclose(y, uy, rtol=0, atol=2e-5 * np.abs(uy).max())


def test_nu_state_carry_equals_one_shot():
    """Splitting the stream across two process calls (checkpoint/resume
    pattern, engine/checkpoint.py) is bit-identical to one shot."""
    rng = np.random.default_rng(4)
    spec = NU.NuSpec(block_length=4, ratio=2, p_head=4, p_tail=2)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 21 * spec.block_length)).astype(np.float32)
    coeffs = NU.nu_coeffs(h, spec, c)
    n = spec.block_length
    blocks = jnp.asarray(x.reshape(c, -1, n).transpose(1, 0, 2))

    st = NU.init_nu_state(spec, c)
    _, one = NU.process_blocks_nu(st, coeffs, blocks)

    st = NU.init_nu_state(spec, c)
    st, a = NU.process_blocks_nu(st, coeffs, blocks[:7])
    st, b = NU.process_blocks_nu(st, coeffs, blocks[7:])
    two = jnp.concatenate([a, b], axis=0)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(two))


def test_mac_hc_band_tiles_match_full():
    """Frequency bands of the MAC, tiled across Hp, reassemble the full
    MAC (the split-tail schedule's per-phase shares)."""
    rng = np.random.default_rng(5)
    p, c, hp, tile = 5, 3, 512, 128
    ring = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    coef = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    for pos in [0, 2, 4]:
        bands = [K.mac_reference_hc_band(ring, coef, jnp.int32(pos), t, tile)
                 for t in range(0, hp, tile)]
        yr = jnp.concatenate([b[0] for b in bands], axis=-1)
        yi = jnp.concatenate([b[1] for b in bands], axis=-1)
        rr, ri = K.mac_hc(ring, coef, jnp.int32(pos))
        np.testing.assert_allclose(np.asarray(yr), np.asarray(rr), atol=1e-4)
        np.testing.assert_allclose(np.asarray(yi), np.asarray(ri), atol=1e-4)


def test_nu_macro_equals_per_block():
    """The cond-free macro formulation (one M-cycle per step, static
    phases) is state- and output-identical to R per-block steps."""
    rng = np.random.default_rng(9)
    spec = NU.NuSpec(block_length=8, ratio=4, p_head=8, p_tail=2)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 32 * spec.block_length)).astype(np.float32)
    coeffs = NU.nu_coeffs(h, spec, c)
    blocks = jnp.asarray(x.reshape(c, -1, spec.block_length).transpose(1, 0, 2))

    st_a = NU.init_nu_state(spec, c)
    st_a, ya = NU.process_blocks_nu(st_a, coeffs, blocks)
    st_b = NU.init_nu_state(spec, c)
    st_b, yb = NU.process_blocks_nu_fast(st_b, coeffs, blocks)

    np.testing.assert_allclose(np.asarray(ya), np.asarray(yb), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(st_a),
                    jax.tree_util.tree_leaves(st_b)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    # and the formulations are interchangeable mid-stream
    st_c = NU.init_nu_state(spec, c)
    st_c, y1 = NU.process_blocks_nu_fast(st_c, coeffs, blocks[:8])
    st_c, y2 = NU.process_blocks_nu(st_c, coeffs, blocks[8:20])
    st_c, y3 = NU.process_blocks_nu_fast(st_c, coeffs, blocks[20:])
    yc = jnp.concatenate([y1, y2, y3], axis=0)
    np.testing.assert_allclose(np.asarray(yc), np.asarray(ya), atol=1e-6)

    with pytest.raises(ValueError):
        NU.process_blocks_nu_fast(NU.init_nu_state(spec, c), coeffs,
                                  blocks[:3])


def _run_nu_crossfade(spec, h1, h2, x, swap_block):
    """Stream with h1, start a crossfade at ``swap_block``, then continue
    with h2 — the exact sequence engine.session drives."""
    c = h1.shape[0]
    n = spec.block_length
    c1 = NU.nu_coeffs(h1, spec, c)
    c2 = NU.nu_coeffs(h2, spec, c)
    st = NU.init_nu_state(spec, c)
    blocks = x.reshape(c, -1, n).transpose(1, 0, 2)
    outs = []
    in_transition = False
    for b in range(blocks.shape[0]):
        blk = jnp.asarray(blocks[b])
        phase = int(st.head.blockcounter) % spec.ratio
        fired = phase == spec.ratio - 1
        if b == swap_block:
            st, y = NU.step_nu_crossfade(st, c1, c2, blk, head_ramp=True)
            in_transition = not fired
        elif in_transition:
            st, y = NU.step_nu_crossfade(st, c1, c2, blk, head_ramp=False)
            in_transition = not fired
        else:
            co = c1 if b < swap_block else c2
            st, y = NU.step_nu(st, co, blk)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def test_nu_crossfade_identity_is_plain_step():
    """old == new collapses the crossfade to the plain engine."""
    rng = np.random.default_rng(6)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 24 * spec.block_length)).astype(np.float32)
    y = _run_nu_crossfade(spec, h, h, x, swap_block=9)
    _, ref = _run_nu(spec, h, x)
    np.testing.assert_allclose(y, ref, atol=1e-5 * np.abs(ref).max())


def test_nu_crossfade_converges_to_new_filter():
    """After the transition (head ramp + bridging tail fire + queue flush)
    the stream is exactly the new filter's."""
    rng = np.random.default_rng(7)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2)
    c = 2
    n, R, D = spec.block_length, spec.ratio, spec.delay_blocks
    h1 = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    h2 = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    nblk = 48
    x = rng.standard_normal((c, nblk * n)).astype(np.float32)
    swap = 11
    y = _run_nu_crossfade(spec, h1, h2, x, swap_block=swap)
    _, ref2 = _run_nu(spec, h2, x)
    # converged once the bridging M-block has been fully consumed and the
    # head ring holds only post-swap history
    settle = swap + R * (D + 2) + spec.p_head
    np.testing.assert_allclose(
        y[:, settle * n:], ref2[:, settle * n:],
        atol=2e-5 * np.abs(ref2).max())


def test_nu_crossfade_is_continuous():
    """No sample-level glitch anywhere across the change: consecutive-sample
    jumps stay at the steady-state scale of the smooth test signal."""
    rng = np.random.default_rng(8)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2)
    c = 2
    n = spec.block_length
    taps = spec.max_taps

    def smooth_filter(seed):
        r = np.random.default_rng(seed)
        hh = r.standard_normal((c, taps)) * np.exp(-np.arange(taps) / 6.0)
        return (hh / np.abs(hh).sum(axis=1, keepdims=True)).astype(np.float32)

    h1, h2 = smooth_filter(1), smooth_filter(2)
    t = np.arange(60 * n)
    sig = np.sin(2 * np.pi * t / 37.0)
    x = np.stack([sig, sig]).astype(np.float32)
    y = _run_nu_crossfade(spec, h1, h2, x, swap_block=20)
    _, ys = _run_nu(spec, h1, x)
    steady = np.abs(np.diff(ys[:, 5 * n:], axis=1)).max()
    trans = np.abs(np.diff(y[:, 5 * n:], axis=1)).max()
    assert trans < 3 * steady, (trans, steady)


def test_nu_bf16_tail_store():
    """tail_store="bfloat16": half the tail HBM traffic for a documented
    precision class — the tail contribution carries ~50+ dB SNR, and for a
    decaying impulse the output SNR gains the tail's energy deficit."""
    rng = np.random.default_rng(10)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=4,
                     tail_store="bfloat16")
    c = 2
    taps = spec.max_taps
    h = (rng.standard_normal((c, taps)) *
         np.exp(-np.arange(taps) / 16.0)).astype(np.float32)
    x = rng.standard_normal((c, 40 * spec.block_length)).astype(np.float32)
    coeffs = NU.nu_coeffs(h, spec, c)
    assert coeffs.tail.dtype == jnp.bfloat16
    st = NU.init_nu_state(spec, c)
    assert st.tail.ring.dtype == jnp.bfloat16
    blocks = jnp.asarray(x.reshape(c, -1, spec.block_length).transpose(1, 0, 2))
    _, out = NU.process_blocks_nu_fast(st, coeffs, blocks)
    y = np.asarray(out.transpose(1, 0, 2).reshape(c, -1))
    ref = _scipy_ref(h.astype(np.float64), x.astype(np.float64), y.shape[1])
    snr = 10 * np.log10(float((ref**2).sum()) /
                        float(((y - ref)**2).sum()))
    assert snr > 45, snr  # tail-limited but controlled precision class

    with pytest.raises(ValueError):
        NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=4,
                  tail_store="int8")


def test_nu_geometry_helper():
    spec = NU.nu_geometry(131072, 1024, 8)
    assert spec.p_head == 16 and spec.m == 8192
    assert spec.max_taps >= 131072
    assert spec.delay_blocks == 2
    # amortized traffic must beat the uniform engine's by >= 3x
    uniform = 2 * 128 * 2 * 1024 * 4
    assert uniform / spec.traffic_bytes_per_block > 3.0


def test_nu_spec_validation():
    with pytest.raises(ValueError):
        NU.NuSpec(block_length=8, ratio=3, p_head=6, p_tail=1)
    with pytest.raises(ValueError):
        NU.NuSpec(block_length=8, ratio=4, p_head=6, p_tail=1)  # not multiple
    with pytest.raises(ValueError):
        NU.NuSpec(block_length=8, ratio=4, p_head=4, p_tail=1)  # D < 2
    with pytest.raises(ValueError):
        NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=0)


def test_nu_coeffs_rejects_overlong_impulse():
    """An impulse longer than the geometry covers must raise, not silently
    drop tail energy."""
    rng = np.random.default_rng(12)
    spec = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2)
    h = rng.standard_normal((2, spec.max_taps + 1)).astype(np.float32)
    with pytest.raises(ValueError, match="max_taps"):
        NU.nu_coeffs(h, spec, 2)


def test_nu_traffic_bytes_honors_tail_store():
    """traffic_bytes_per_block must account the tail at its storage dtype:
    bf16 halves exactly the tail term."""
    f32 = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2)
    bf16 = NU.NuSpec(block_length=8, ratio=2, p_head=4, p_tail=2,
                     tail_store="bfloat16")
    head = 2 * f32.p_head * 2 * f32.block_length * 4
    tail_f32 = f32.traffic_bytes_per_block - head
    tail_bf16 = bf16.traffic_bytes_per_block - head
    assert tail_f32 == 2 * tail_bf16
    assert bf16.traffic_bytes_per_block < f32.traffic_bytes_per_block


def test_nu_double_swap_bridges_original_tail():
    """A second filter change arriving while the first change's bridging
    tail fire is still pending must keep the ORIGINAL coefficients as the
    tail crossfade's old side — the pending queue was computed with them.
    Drives the exact sequence engine.session now drives and
    checks sample-level continuity plus convergence to the final filter."""
    rng = np.random.default_rng(13)
    spec = NU.NuSpec(block_length=8, ratio=4, p_head=8, p_tail=2)
    c = 2
    n, R, D = spec.block_length, spec.ratio, spec.delay_blocks
    taps = spec.max_taps

    def smooth_filter(seed):
        r = np.random.default_rng(seed)
        hh = r.standard_normal((c, taps)) * np.exp(-np.arange(taps) / 10.0)
        return (hh / np.abs(hh).sum(axis=1, keepdims=True)).astype(np.float32)

    ha, hb, hc_ = smooth_filter(1), smooth_filter(2), smooth_filter(3)
    ca = NU.nu_coeffs(ha, spec, c)
    cb = NU.nu_coeffs(hb, spec, c)
    cc = NU.nu_coeffs(hc_, spec, c)

    nblk = 80
    t = np.arange(nblk * n)
    sig = np.sin(2 * np.pi * t / 37.0)
    x = np.stack([sig, sig]).astype(np.float32)
    blocks = x.reshape(c, -1, n).transpose(1, 0, 2)

    # swap1 lands at phase 0, swap2 one block later (phase 1): no tail fire
    # in between, so swap2 must inherit swap1's un-bridged tail
    swap1, swap2 = 20, 21
    assert swap1 % R == 0

    st = NU.init_nu_state(spec, c)
    outs = []
    coeffs, nu_old = ca, None
    pending_swap = None
    for b in range(nblk):
        blk = jnp.asarray(blocks[b])
        if b == swap1:
            pending_swap = cb
        elif b == swap2:
            pending_swap = cc
        phase = int(st.head.blockcounter) % R
        fired = phase == R - 1
        if pending_swap is not None:
            old = coeffs if nu_old is None else nu_old._replace(head=coeffs.head)
            st, y = NU.step_nu_crossfade(st, old, pending_swap, blk,
                                         head_ramp=True)
            nu_old = None if fired else old
            coeffs = pending_swap
            pending_swap = None
        elif nu_old is not None:
            st, y = NU.step_nu_crossfade(st, nu_old, coeffs, blk,
                                         head_ramp=False)
            if fired:
                nu_old = None
        else:
            st, y = NU.step_nu(st, coeffs, blk)
        outs.append(np.asarray(y))
    y = np.concatenate(outs, axis=1)

    # continuity: consecutive-sample jumps stay at the steady-state scale
    _, ys = _run_nu(spec, ha, x)
    steady = np.abs(np.diff(ys[:, 5 * n:], axis=1)).max()
    trans = np.abs(np.diff(y[:, 5 * n:], axis=1)).max()
    assert trans < 3 * steady, (trans, steady)

    # convergence: after the transition settles the stream is pure h_c
    _, ref = _run_nu(spec, hc_, x)
    settle = swap2 + R * (D + 2) + spec.p_head
    np.testing.assert_allclose(y[:, settle * n:], ref[:, settle * n:],
                               atol=2e-5 * np.abs(ref).max())


# -- three-stage (round 3: recursive composition) ---------------------------


def _run_nu3(spec, h, x, **kw):
    c = h.shape[0]
    coeffs = NU.nu3_coeffs(h, spec, c)
    st = NU.init_nu3_state(spec, c)
    n = spec.block_length
    blocks = jnp.asarray(x.reshape(c, -1, n).transpose(1, 0, 2))
    st, out = NU.process_blocks_nu3(st, coeffs, blocks, **kw)
    return st, np.asarray(out.transpose(1, 0, 2).reshape(c, -1))


def test_nu3_matches_scipy():
    rng = np.random.default_rng(50)
    spec = NU.nu3_geometry(70, block_length=4, ratio1=2, ratio2=2)
    assert spec.max_taps >= 70
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 64 * spec.block_length)).astype(np.float32)
    _, y = _run_nu3(spec, h, x)
    ref = _scipy_ref(h, x, y.shape[1])
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_nu3_partial_taps():
    """Impulse ending mid far-partition; all three stages partially used."""
    rng = np.random.default_rng(51)
    spec = NU.nu3_geometry(200, block_length=4, ratio1=2, ratio2=4)
    c = 2
    taps = spec.max_taps - spec.inner.m - 5
    h = rng.standard_normal((c, taps)).astype(np.float32)
    x = rng.standard_normal((c, 96 * spec.block_length)).astype(np.float32)
    _, y = _run_nu3(spec, h, x)
    ref = _scipy_ref(h, x, y.shape[1])
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_nu3_fast_equals_per_block():
    """The static-phase super-cycle form == per-block steps, including
    state, and the formulations interleave at super-cycle boundaries."""
    rng = np.random.default_rng(52)
    spec = NU.nu3_geometry(150, block_length=4, ratio1=2, ratio2=2)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    sup = spec.ratio1 * spec.inner.ratio
    nblk = 16 * sup
    x = rng.standard_normal((c, nblk * spec.block_length)).astype(np.float32)
    coeffs = NU.nu3_coeffs(h, spec, c)
    blocks = jnp.asarray(x.reshape(c, -1, spec.block_length).transpose(1, 0, 2))

    st_a = NU.init_nu3_state(spec, c)
    st_a, ya = NU.process_blocks_nu3(st_a, coeffs, blocks)
    st_b = NU.init_nu3_state(spec, c)
    st_b, yb = NU.process_blocks_nu3_fast(st_b, coeffs, blocks)
    np.testing.assert_allclose(np.asarray(ya), np.asarray(yb), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(st_a),
                    jax.tree_util.tree_leaves(st_b)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    st_c = NU.init_nu3_state(spec, c)
    st_c, y1 = NU.process_blocks_nu3_fast(st_c, coeffs, blocks[:2 * sup])
    st_c, y2 = NU.process_blocks_nu3(st_c, coeffs, blocks[2 * sup:5 * sup])
    st_c, y3 = NU.process_blocks_nu3_fast(st_c, coeffs, blocks[5 * sup:])
    yc = jnp.concatenate([y1, y2, y3], axis=0)
    np.testing.assert_allclose(np.asarray(yc), np.asarray(ya), atol=1e-6)

    with pytest.raises(ValueError):
        NU.process_blocks_nu3_fast(NU.init_nu3_state(spec, c), coeffs,
                                   blocks[:3])


def test_nu3_state_carry():
    rng = np.random.default_rng(53)
    spec = NU.nu3_geometry(100, block_length=4, ratio1=2, ratio2=2)
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 25 * spec.block_length)).astype(np.float32)
    coeffs = NU.nu3_coeffs(h, spec, c)
    blocks = jnp.asarray(x.reshape(c, -1, 4).transpose(1, 0, 2))
    st = NU.init_nu3_state(spec, c)
    _, one = NU.process_blocks_nu3(st, coeffs, blocks)
    st = NU.init_nu3_state(spec, c)
    st, a = NU.process_blocks_nu3(st, coeffs, blocks[:9])
    st, b = NU.process_blocks_nu3(st, coeffs, blocks[9:])
    np.testing.assert_array_equal(np.asarray(one),
                                  np.asarray(jnp.concatenate([a, b], axis=0)))


def test_nu3_geometry_and_validation():
    spec = NU.nu3_geometry(524288, 1024, 8, 8)
    assert spec.max_taps >= 524288
    assert spec.inner.block_length == 8192
    # three-stage beats two-stage on amortized traffic at this length
    two = NU.nu_geometry(524288, 1024, 8)
    assert two.traffic_bytes_per_block / spec.traffic_bytes_per_block > 1.5
    with pytest.raises(ValueError):
        NU.Nu3Spec(4, 3, 6, NU.NuSpec(8, 2, 4, 1))
    with pytest.raises(ValueError):  # inner block mismatch
        NU.Nu3Spec(4, 2, 4, NU.NuSpec(16, 2, 4, 1))
    with pytest.raises(ValueError, match="max_taps"):
        NU.nu3_coeffs(np.zeros((1, spec.max_taps + 1)), spec, 1)


def test_nu3_matches_scipy_matmul_fft():
    """The three-stage engine with every transform on the matmul DFTs."""
    from bfir_tpu.ops import fft as F

    rng = np.random.default_rng(54)
    spec = NU.nu3_geometry(150, block_length=128, ratio1=2, ratio2=2)
    c = 2
    h = rng.standard_normal((c, min(spec.max_taps, 900))).astype(np.float32)
    x = rng.standard_normal((c, 16 * spec.block_length)).astype(np.float32)
    F.set_mode("matmul")
    try:
        _, y = _run_nu3(spec, h, x)
    finally:
        F.set_mode("auto")
    ref = _scipy_ref(h, x, y.shape[1])
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


# ---------------------------------------------------------------------------
# Three-stage crossfade: the two-stage law composed
# recursively — continuity + convergence, mirroring the nu2 suite above.
# ---------------------------------------------------------------------------


def _run_nu3_crossfade(spec, h1, h2, x, swap_block):
    """Stream with h1, start the three-stage transition at ``swap_block``,
    then continue with h2 — the exact host-side stage machine
    engine.session drives (see step_nu3_crossfade docstring)."""
    c = h1.shape[0]
    n = spec.block_length
    r1, r2 = spec.ratio1, spec.inner.ratio
    c1 = NU.nu3_coeffs(h1, spec, c)
    c2 = NU.nu3_coeffs(h2, spec, c)
    st = NU.init_nu3_state(spec, c)
    blocks = x.reshape(c, -1, n).transpose(1, 0, 2)
    outs = []
    stage = None  # None | "outer" | "inner"
    for b in range(blocks.shape[0]):
        blk = jnp.asarray(blocks[b])
        cnt = int(st.head.blockcounter)
        fires = cnt % r1 == r1 - 1
        inner_fires = (cnt // r1) % r2 == r2 - 1
        if b == swap_block:
            st, y = NU.step_nu3_crossfade(st, c1, c2, blk, head_ramp=True,
                                          inner_mode="ramp")
            stage = None if (fires and inner_fires) else (
                "inner" if fires else "outer")
        elif stage == "outer":
            st, y = NU.step_nu3_crossfade(st, c1, c2, blk, head_ramp=False,
                                          inner_mode="ramp")
            if fires:
                stage = None if inner_fires else "inner"
        elif stage == "inner":
            st, y = NU.step_nu3_crossfade(st, c1, c2, blk, head_ramp=False,
                                          inner_mode="hold")
            if fires and inner_fires:
                stage = None
        else:
            co = c1 if b < swap_block else c2
            st, y = NU.step_nu3(st, co, blk)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def _nu3_small_spec():
    return NU.Nu3Spec(block_length=8, ratio1=2, p_head=4,
                      inner=NU.NuSpec(block_length=16, ratio=2, p_head=4,
                                      p_tail=2))


def test_nu3_crossfade_identity_is_plain_step():
    """old == new collapses the three-stage transition to the plain engine
    (every ramp mixes identical signals)."""
    rng = np.random.default_rng(60)
    spec = _nu3_small_spec()
    c = 2
    h = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((c, 40 * spec.block_length)).astype(np.float32)
    for swap in (9, 10, 11, 13):  # covers all (outer, inner) phase cases
        y = _run_nu3_crossfade(spec, h, h, x, swap_block=swap)
        _, ref = _run_nu3(spec, h, x)
        np.testing.assert_allclose(y, ref, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=f"swap at block {swap}")


def test_nu3_crossfade_converges_to_new_filter():
    """After every stage has bridged (outer head ramp, inner head ramp at
    the next inner step, far bridging at the next far fire) and the pending
    queues have flushed, the stream is exactly the new filter's."""
    rng = np.random.default_rng(61)
    spec = _nu3_small_spec()
    c = 2
    n = spec.block_length
    r1, r2 = spec.ratio1, spec.inner.ratio
    h1 = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    h2 = rng.standard_normal((c, spec.max_taps)).astype(np.float32)
    nblk = 96
    x = rng.standard_normal((c, nblk * n)).astype(np.float32)
    swap = 11
    y = _run_nu3_crossfade(spec, h1, h2, x, swap_block=swap)
    _, ref2 = _run_nu3(spec, h2, x)
    # settle: the far bridging fire lands within r1*r2 blocks of the swap;
    # its ramped M2-block drains through both pending queues (D2 inner +
    # D1 outer fires) and every ring must hold only post-swap history
    sup = r1 * r2
    settle = swap + sup * (spec.inner.delay_blocks + spec.delay_blocks + 3) \
        + spec.p_head + spec.inner.p_head * r1
    assert settle < nblk
    np.testing.assert_allclose(
        y[:, settle * n:], ref2[:, settle * n:],
        atol=2e-5 * np.abs(ref2).max())


def test_nu3_crossfade_is_continuous():
    """No sample-level glitch anywhere across the three-stage change
    (mirrors test_nu_crossfade_is_continuous)."""
    rng = np.random.default_rng(62)
    spec = _nu3_small_spec()
    c = 2
    n = spec.block_length
    taps = spec.max_taps

    def smooth_filter(seed):
        r = np.random.default_rng(seed)
        hh = r.standard_normal((c, taps)) * np.exp(-np.arange(taps) / 6.0)
        return (hh / np.abs(hh).sum(axis=1, keepdims=True)).astype(np.float32)

    h1, h2 = smooth_filter(1), smooth_filter(2)
    t = np.arange(90 * n)
    sig = np.sin(2 * np.pi * t / 37.0)
    x = np.stack([sig, sig]).astype(np.float32)
    y = _run_nu3_crossfade(spec, h1, h2, x, swap_block=20)
    _, ys = _run_nu3(spec, h1, x)
    steady = np.abs(np.diff(ys[:, 5 * n:], axis=1)).max()
    trans = np.abs(np.diff(y[:, 5 * n:], axis=1)).max()
    assert trans < 3 * steady, (trans, steady)


def test_nu_tail_m1024_matches_scipy():
    """A geometry with a 1024-sample tail M-block (h = M >= 1024) streams
    correctly vs scipy."""
    rng = np.random.default_rng(63)
    spec = NU.NuSpec(block_length=128, ratio=8, p_head=16, p_tail=2)
    c = 2
    h = (rng.standard_normal((c, spec.max_taps)) *
         np.exp(-np.arange(spec.max_taps) / 1500.0)).astype(np.float32) * 0.1
    x = rng.standard_normal((c, 40 * spec.block_length)).astype(np.float32)
    _, y = _run_nu(spec, h, x)
    ref = _scipy_ref(h.astype(np.float64), x.astype(np.float64), y.shape[1])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr


# -- split-tail schedule ----------------------------------------------------


@pytest.fixture(autouse=True)
def _fresh_compile_caches(request):
    """XLA's CPU compiler has segfaulted compiling the split engine's
    lax.switch graphs late in a full-suite run (hundreds of compiled
    executables accumulated in-process; the same graphs compile fine in a
    fresh interpreter). Dropping the in-process caches before each
    split-engine test keeps the compiler arena small. Scoped to this
    module's split tests only — elsewhere cache reuse is wanted."""
    if "split" in request.node.name or "band" in request.node.name:
        jax.clear_caches()
    yield




def _split_setup(seed=80, ratio=2, p_tail=3, n=128, dtype="float32"):
    rng = np.random.default_rng(seed)
    spec = NU.NuSpec(block_length=n, ratio=ratio, p_head=2 * ratio,
                     p_tail=p_tail, dtype=dtype)
    c = 3
    h = (rng.standard_normal((c, spec.max_taps - 11)) * 0.1).astype(dtype)
    co = NU.nu_coeffs(h, spec, c)
    return rng, spec, c, h, co


@pytest.mark.parametrize("ratio,p_tail", [(2, 3), (4, 2)])
def test_split_tail_matches_step_nu(ratio, p_tail):
    """step_nu_split == step_nu, block for block, through several full
    cycles (so the delayed-append queue and warm-up are exercised)."""
    rng, spec, c, h, co = _split_setup(81, ratio, p_tail)
    st_a = NU.init_nu_state(spec, c)
    st_b = NU.init_nu_split_state(spec, c)
    nblocks = (spec.delay_blocks + 3) * spec.ratio + 1
    x = rng.standard_normal((c, nblocks * spec.block_length)).astype(np.float32)
    n = spec.block_length
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st_a, ya = NU.step_nu(st_a, co, blk)
        st_b, yb = NU.step_nu_split(st_b, co, blk)
        scale = max(1.0, float(np.abs(np.asarray(ya)).max()))
        np.testing.assert_allclose(np.asarray(yb), np.asarray(ya),
                                   atol=1e-6 * scale, err_msg=f"block {b}")


def test_split_tail_matches_scipy_f64():
    """Absolute check at float64 (CPU x64): the split schedule is the same
    convolution."""
    from scipy import signal

    rng, spec, c, h, co = _split_setup(82, dtype="float64")
    st = NU.init_nu_split_state(spec, c)
    nblocks = (spec.delay_blocks + 3) * spec.ratio
    n = spec.block_length
    x = rng.standard_normal((c, nblocks * n))
    outs = []
    for b in range(nblocks):
        st, y = NU.step_nu_split(st, co, x[:, b * n:(b + 1) * n])
        outs.append(np.asarray(y))
    y = np.concatenate(outs, axis=1)
    ref = signal.fftconvolve(x, h, axes=1)[:, : y.shape[1]]
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 200, snr


def test_split_tail_scan_matches_steps():
    """process_blocks_nu_split (static-phase scan) == per-block switch
    steps, bit for bit, and the state threads across the boundary."""
    rng, spec, c, h, co = _split_setup(83)
    n = spec.block_length
    nblocks = 2 * spec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    blocks = jnp.asarray(x.reshape(c, nblocks, n).transpose(1, 0, 2))
    st_s, ys = NU.process_blocks_nu_split(NU.init_nu_split_state(spec, c),
                                          co, blocks)
    st_p = NU.init_nu_split_state(spec, c)
    refs = []
    for b in range(nblocks):
        st_p, y = NU.step_nu_split(st_p, co, x[:, b * n:(b + 1) * n])
        refs.append(np.asarray(y))
    np.testing.assert_array_equal(np.asarray(ys), np.stack(refs))
    blk = rng.standard_normal((c, n)).astype(np.float32)
    _, oa = NU.step_nu_split(st_s, co, blk)
    _, ob = NU.step_nu_split(st_p, co, blk)
    np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))


def test_mac_band_matches_numpy_f64():
    """The banded MAC == a float64 numpy literal of the halfcomplex law
    restricted to the band == the full MAC restricted to the band, incl.
    the DC fixup in band 0."""
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(84)
    p, c, hp = 5, 3, 512
    ring = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    coeff = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    pos = jnp.asarray(3, jnp.int32)
    full_r, full_i = K.mac_reference_hc(ring[:, :c], ring[:, c:],
                                        coeff[:, :c], coeff[:, c:], pos)
    r64 = np.asarray(ring, np.float64)
    c64 = np.asarray(coeff, np.float64)
    idx = (3 - np.arange(p)) % p
    rr64, ri64 = r64[idx, :c], r64[idx, c:]
    cr64, ci64 = c64[:, :c], c64[:, c:]
    er = (cr64 * rr64 - ci64 * ri64).sum(axis=0)
    ei = (cr64 * ri64 + ci64 * rr64).sum(axis=0)
    er[:, 0] = (cr64[..., 0] * rr64[..., 0]).sum(axis=0)
    ei[:, 0] = (ci64[..., 0] * ri64[..., 0]).sum(axis=0)
    # f32 sum of p products of unit-variance normals: ~p * eps32 * max term
    tol = 4 * p * np.finfo(np.float32).eps * float(
        np.abs(r64).max() * np.abs(c64).max())
    for band, blen in ((0, 128), (1, 128), (3, 128), (0, 256), (1, 256)):
        br, bi = K.mac_reference_hc_band(ring, coeff, pos, band * blen, blen)
        sl = slice(band * blen, band * blen + blen)
        np.testing.assert_allclose(np.asarray(br), er[:, sl], atol=tol)
        np.testing.assert_allclose(np.asarray(bi), ei[:, sl], atol=tol)
        np.testing.assert_allclose(np.asarray(br), np.asarray(full_r[:, sl]),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(bi), np.asarray(full_i[:, sl]),
                                   atol=1e-5)


def test_split_tail_matmul_fft_matches_step_nu():
    """With the transforms forced onto the matmul DFTs the split schedule
    still agrees with step_nu."""
    from bfir_tpu.ops import fft as F

    rng, spec, c, h, co = _split_setup(85)
    n = spec.block_length
    st_a = NU.init_nu_state(spec, c)
    st_b = NU.init_nu_split_state(spec, c)
    nblocks = (spec.delay_blocks + 2) * spec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    F.set_mode("matmul")
    try:
        for b in range(nblocks):
            blk = x[:, b * n:(b + 1) * n]
            st_a, ya = NU.step_nu(st_a, co, blk)
            st_b, yb = NU.step_nu_split(st_b, co, blk)
            scale = max(1.0, float(np.abs(np.asarray(ya)).max()))
            np.testing.assert_allclose(np.asarray(yb), np.asarray(ya),
                                       atol=1e-5 * scale,
                                       err_msg=f"block {b}")
    finally:
        F.set_mode("auto")


def test_split_band_len_validation():
    with pytest.raises(ValueError, match="128-lane"):
        NU.split_band_len(NU.NuSpec(block_length=8, ratio=2, p_head=4,
                                    p_tail=2))
    assert NU.split_band_len(NU.NuSpec(block_length=128, ratio=2, p_head=4,
                                       p_tail=2)) == 128


# -- block-scaled integer storage tiers -------------------------------------


def test_quantize_planes_roundtrip():
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(90)
    a = jnp.asarray((rng.standard_normal((3, 4, 256))
                     * 10.0 ** rng.uniform(-6, 2, (3, 4, 1))).astype(np.float32))
    for bits, rel in ((24, 3e-7), (16, 1e-4)):
        q = K.quantize_planes(a, bits)
        assert q.scale.shape == (3, 4, 128)
        if bits == 24:
            assert q.hi.dtype == jnp.int16 and q.lo.dtype == jnp.uint8
        else:
            assert q.lo is None
        back = K.dequantize_planes(q)
        rowmax = np.abs(np.asarray(a)).max(axis=-1, keepdims=True)
        err = np.abs(np.asarray(back) - np.asarray(a)) / rowmax
        assert err.max() < rel, (bits, err.max())


def test_int_mac_matches_numpy_f64():
    """The int-stored MAC == a float64 numpy literal of the halfcomplex
    law on the decoded planes (decode is exact in f32), for int24/int16
    and the shared-coefficient form."""
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(91)
    p, c, hp = 5, 3, 512
    ring = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    coeff = jnp.asarray(rng.standard_normal((p, 2 * c, hp)).astype(np.float32))
    pos = jnp.asarray(3, jnp.int32)
    def law(rq, cq):
        r64 = np.asarray(K.dequantize_planes(rq), np.float64)
        c64 = np.asarray(K.dequantize_planes(cq), np.float64)
        cs = c64.shape[1] // 2
        idx = (3 - np.arange(p)) % p
        rr, ri = r64[idx, :c], r64[idx, c:]
        cr, ci = c64[:, :cs], c64[:, cs:]
        er = (cr * rr - ci * ri).sum(axis=0)
        ei = (cr * ri + ci * rr).sum(axis=0)
        er[:, 0] = (cr[..., 0] * rr[..., 0]).sum(axis=0)
        ei[:, 0] = (ci[..., 0] * ri[..., 0]).sum(axis=0)
        return er, ei

    tol = 4 * p * np.finfo(np.float32).eps * 25.0  # |normal| < 5 here
    for bits in (24, 16):
        rq = K.quantize_planes(ring, bits)
        cq = K.quantize_planes(coeff, bits)
        jr, ji = K.mac_reference_hc_int(rq, cq, pos)
        er, ei = law(rq, cq)
        np.testing.assert_allclose(np.asarray(jr), er, atol=tol)
        np.testing.assert_allclose(np.asarray(ji), ei, atol=tol)
    # shared-coefficient form ([P, 2, Hp])
    cq1 = K.quantize_planes(coeff[:, [0, c]], 24)
    rq = K.quantize_planes(ring, 24)
    jr, ji = K.mac_reference_hc_int(rq, cq1, pos)
    er, ei = law(rq, cq1)
    np.testing.assert_allclose(np.asarray(jr), er, atol=tol)
    np.testing.assert_allclose(np.asarray(ji), ei, atol=tol)


@pytest.mark.parametrize("store,min_snr,max_snr", [
    ("int24", 115.0, 200.0),
    ("int16", 80.0, 110.0),
])
def test_nu_int_tail_store_stream(store, min_snr, max_snr):
    """step_nu with an integer-stored tail: SNR lands in the tier's
    documented class (benchmarks/storage_snr.py), well above bfloat16's."""
    from scipy import signal

    rng = np.random.default_rng(92)
    spec = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=4,
                     tail_store=store)
    c = 3
    h = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    co = NU.nu_coeffs(h, spec, c)
    from bfir_tpu.kernels import spectrum_mac as K

    assert isinstance(co.tail, K.IntPlanes)
    st = NU.init_nu_state(spec, c)
    assert isinstance(st.tail.ring, K.IntPlanes)
    n = spec.block_length
    nblocks = (spec.delay_blocks + 3) * spec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    outs = []
    for b in range(nblocks):
        st, y = NU.step_nu(st, co, x[:, b * n:(b + 1) * n])
        outs.append(np.asarray(y))
    y = np.concatenate(outs, axis=1)
    ref = signal.fftconvolve(x.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    snr = min(10 * np.log10(float((ref[ch]**2).sum())
                            / float(((y[ch] - ref[ch])**2).sum()))
              for ch in range(c))
    assert min_snr < snr < max_snr, snr


def test_nu_int_tail_macro_and_kernel_paths_agree():
    """Macro scan == per-block steps on the int24 tier."""
    rng = np.random.default_rng(93)
    spec = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=2,
                     tail_store="int24")
    c = 2
    h = (rng.standard_normal((c, spec.max_taps - 7)) * 0.1).astype(np.float32)
    co = NU.nu_coeffs(h, spec, c)
    n = spec.block_length
    nblocks = 3 * spec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    blocks = jnp.asarray(x.reshape(c, nblocks, n).transpose(1, 0, 2))
    st_m, ys = NU.process_blocks_nu_fast(NU.init_nu_state(spec, c), co,
                                         blocks)
    st_p = NU.init_nu_state(spec, c)
    refs = []
    for b in range(nblocks):
        st_p, y = NU.step_nu(st_p, co, x[:, b * n:(b + 1) * n])
        refs.append(np.asarray(y))
    np.testing.assert_allclose(np.asarray(ys), np.stack(refs), atol=2e-5)


def test_nu_int_tail_crossfade_runs():
    """The crossfade transition fire works on int-stored tails (one ring
    advance, two int MACs)."""
    rng = np.random.default_rng(94)
    spec = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=2,
                     tail_store="int16")
    c = 2
    h1 = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    h2 = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    co1, co2 = NU.nu_coeffs(h1, spec, c), NU.nu_coeffs(h2, spec, c)
    st = NU.init_nu_state(spec, c)
    n = spec.block_length
    for b in range(2 * spec.ratio):
        st, _ = NU.step_nu(st, co1, rng.standard_normal((c, n)).astype(np.float32))
    st, y = NU.step_nu_crossfade(st, co1, co2,
                                 rng.standard_normal((c, n)).astype(np.float32))
    assert np.isfinite(np.asarray(y)).all()


def test_split_tail_rejects_int_head_store():
    with pytest.raises(ValueError, match="TAIL only"):
        NU.init_nu_split_state(
            NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=2,
                      head_store="int24"), 2)


@pytest.mark.parametrize("store,min_snr", [("int24", 115.0), ("int16", 75.0)])
def test_nu_int_head_and_tail_store(store, min_snr):
    """Both stages int-stored: stream SNR in the tier's class; the
    per-block steps and the macro scan agree."""
    from scipy import signal

    rng = np.random.default_rng(95)
    spec = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=3,
                     tail_store=store, head_store=store)
    c = 2
    h = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    co = NU.nu_coeffs(h, spec, c)
    from bfir_tpu.kernels import spectrum_mac as K

    assert isinstance(co.head, K.IntPlanes)
    st = NU.init_nu_state(spec, c)
    assert isinstance(st.head.ring, K.IntPlanes)
    n = spec.block_length
    nblocks = (spec.delay_blocks + 3) * spec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    outs = []
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st, y = NU.step_nu(st, co, blk)
        outs.append(np.asarray(y))
    y = np.concatenate(outs, axis=1)
    _, ym = NU.process_blocks_nu_fast(
        NU.init_nu_state(spec, c), co,
        jnp.asarray(x.reshape(c, nblocks, n).transpose(1, 0, 2)))
    yk = np.asarray(ym).transpose(1, 0, 2).reshape(c, -1)
    np.testing.assert_allclose(yk, y, atol=2e-5 * max(1.0, np.abs(y).max()))
    ref = signal.fftconvolve(x.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    snr = min(10 * np.log10(float((ref[ch]**2).sum())
                            / float(((y[ch] - ref[ch])**2).sum()))
              for ch in range(c))
    assert snr > min_snr, snr


def test_nu_int_head_crossfade_converges():
    """Live filter change on an int-stored head: ramp + hold + bridging
    fire produce finite output converging to the new filter."""
    from scipy import signal

    rng = np.random.default_rng(96)
    spec = NU.NuSpec(block_length=128, ratio=2, p_head=4, p_tail=2,
                     tail_store="int24", head_store="int24")
    c = 2
    h1 = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    h2 = (rng.standard_normal((c, spec.max_taps)) * 0.05).astype(np.float32)
    co1, co2 = NU.nu_coeffs(h1, spec, c), NU.nu_coeffs(h2, spec, c)
    st = NU.init_nu_state(spec, c)
    n = spec.block_length
    xs = []
    for b in range(4 * spec.ratio):
        blk = rng.standard_normal((c, n)).astype(np.float32)
        xs.append(blk)
        st, _ = NU.step_nu(st, co1, blk)
    # transition: ramp block, then holds until a fire passes
    blk = rng.standard_normal((c, n)).astype(np.float32)
    xs.append(blk)
    st, y = NU.step_nu_crossfade(st, co1, co2, blk, head_ramp=True)
    assert np.isfinite(np.asarray(y)).all()
    outs = []
    for b in range(6 * spec.ratio):
        blk = rng.standard_normal((c, n)).astype(np.float32)
        xs.append(blk)
        st, y = NU.step_nu(st, co2, blk)
        outs.append(np.asarray(y))
    # the last blocks are pure new-filter output
    full = np.concatenate(xs, axis=1)
    ref = signal.fftconvolve(full.astype(np.float64), h2.astype(np.float64),
                             axes=1)[:, : full.shape[1]]
    got = np.concatenate(outs, axis=1)[:, -3 * n:]
    want = ref[:, -3 * n:]
    snr = 10 * np.log10(float((want**2).sum())
                        / float(((got - want)**2).sum()))
    assert snr > 100, snr


def test_split_tail_int24_matches_step_nu():
    """Split schedule composed with the int24 tail store (banded int
    MAC): matches step_nu on the same int-stored geometry, per block and
    through the cond-free split scan."""
    rng = np.random.default_rng(98)
    spec = NU.NuSpec(block_length=128, ratio=4, p_head=8, p_tail=2,
                     tail_store="int24")
    c = 3
    h = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    co = NU.nu_coeffs(h, spec, c)
    st_a = NU.init_nu_state(spec, c)
    st_b = NU.init_nu_split_state(spec, c)
    from bfir_tpu.kernels import spectrum_mac as K

    assert isinstance(st_b.tail.ring, K.IntPlanes)
    n = spec.block_length
    nblocks = (spec.delay_blocks + 3) * spec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    outs = []
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st_a, ya = NU.step_nu(st_a, co, blk)
        st_b, yb = NU.step_nu_split(st_b, co, blk)
        scale = max(1.0, float(np.abs(np.asarray(ya)).max()))
        np.testing.assert_allclose(np.asarray(yb), np.asarray(ya),
                                   atol=2e-5 * scale, err_msg=f"block {b}")
        outs.append(np.asarray(yb))
    _, yk = NU.process_blocks_nu_split(
        NU.init_nu_split_state(spec, c), co,
        jnp.asarray(x.reshape(c, nblocks, n).transpose(1, 0, 2)))
    np.testing.assert_allclose(np.asarray(yk), np.stack(outs),
                               atol=2e-5 * max(1.0, np.abs(outs).max()))
