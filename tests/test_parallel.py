"""Multi-device sharding tests on the 8-virtual-CPU-device mesh
(SURVEY.md §4c: this is how multi-chip is validated without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import FilterSpec
from bfir_tpu.parallel import mesh as M
from bfir_tpu.parallel.sharded import ShardedEngine, dryrun


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices")
    return d


def test_step_rolled_matches_step():
    rng = np.random.default_rng(0)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    h = rng.standard_normal(200)
    co = cv.coeffs_to_spectra(h, spec)
    s_ptr = cv.init_state(spec, 2)
    s_rol = cv.init_state(spec, 2)
    x = rng.standard_normal((2, 64 * 8))
    for b in range(8):
        blk = x[:, b * 64 : (b + 1) * 64]
        s_ptr, o1 = cv.step(s_ptr, co, blk)
        s_rol, o2 = cv.step_rolled(s_rol, co, blk)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-12)
    # representation conversion agrees
    conv = cv.rolled_from_state(s_ptr)
    np.testing.assert_allclose(np.asarray(conv.spectra_ring),
                               np.asarray(s_rol.spectra_ring), atol=1e-12)


@pytest.mark.parametrize("c_shards,p_shards", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_engine_matches_single_device(devices, c_shards, p_shards):
    rng = np.random.default_rng(1)
    mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float64")
    c = 8
    eng = ShardedEngine(spec, c, mesh)
    h = rng.standard_normal((c, spec.max_taps)) * 0.1
    coeffs = eng.prepare_coeffs(h)
    state = eng.init_state()

    st1 = cv.init_state(spec, c)
    co1 = cv.coeffs_to_spectra(h, spec)

    x = rng.standard_normal((c, 64 * 6))
    for b in range(6):
        blk = x[:, b * 64 : (b + 1) * 64]
        state, out = eng.step(state, coeffs, blk)
        st1, ref = cv.step(st1, co1, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_sharded_state_is_actually_sharded(devices):
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float32")
    eng = ShardedEngine(spec, 4, mesh)
    state = eng.init_state()
    ring = state.spectra_ring
    assert len(ring.sharding.device_set) == 8
    # each device holds a [P/4, C/2, F] shard
    shard_shapes = {s.data.shape for s in ring.addressable_shards}
    assert shard_shapes == {(2, 2, 65)}


def test_mesh_validation(devices):
    with pytest.raises(ValueError):
        M.make_mesh(channel_shards=3, partition_shards=3)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=7, dtype="float32")
    with pytest.raises(ValueError):
        ShardedEngine(spec, 4, mesh)  # 7 partitions not divisible by 4


def test_dryrun(devices):
    dryrun(8)


def test_sharded_batch_matches_single_device(devices):
    rng = np.random.default_rng(9)
    mesh = M.make_mesh(channel_shards=4, partition_shards=2)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    c, b = 8, 6
    eng = ShardedEngine(spec, c, mesh)
    h = rng.standard_normal((c, spec.max_taps)) * 0.1
    coeffs = eng.prepare_coeffs(h)
    state = eng.init_state()  # zero state is valid in both representations

    blocks = rng.standard_normal((b, c, 64))
    state, outs = eng.process_batch(state, coeffs, jnp.asarray(blocks))

    st1 = cv.init_state(spec, c)
    co1 = cv.coeffs_to_spectra(h, spec)
    st1, ref = cv.process_batch(st1, co1, jnp.asarray(blocks))
    np.testing.assert_allclose(np.asarray(outs), np.asarray(ref), atol=1e-10)
    # continued batch agrees too (state threading across sharded batches)
    blocks2 = rng.standard_normal((b, c, 64))
    state, outs2 = eng.process_batch(state, coeffs, jnp.asarray(blocks2))
    st1, ref2 = cv.process_batch(st1, co1, jnp.asarray(blocks2))
    np.testing.assert_allclose(np.asarray(outs2), np.asarray(ref2), atol=1e-10)


def test_ppermute_step_matches_rolled(devices):
    from bfir_tpu.parallel.sharded import make_ppermute_step

    rng = np.random.default_rng(10)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float64")
    c = 4
    h = rng.standard_normal((c, spec.max_taps)) * 0.1

    eng = ShardedEngine(spec, c, mesh)  # reuse shardings/placement helpers
    coeffs = eng.prepare_coeffs(h)
    state = eng.init_state()
    pstep = jax.jit(make_ppermute_step(mesh, spec, c), donate_argnums=0)

    st_ref = cv.init_state(spec, c)
    co_ref = cv.coeffs_to_spectra(h, spec)

    x = rng.standard_normal((c, 64 * 10))
    for b in range(10):
        blk = x[:, b * 64 : (b + 1) * 64]
        state, out = pstep(state, coeffs, jnp.asarray(blk))
        st_ref, ref = cv.step_rolled(st_ref, co_ref, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10,
                                   err_msg=f"block {b}")
    # ring state equivalence (rolled layout)
    np.testing.assert_allclose(
        np.asarray(jnp.real(state.spectra_ring)),
        np.asarray(jnp.real(st_ref.spectra_ring)), atol=1e-10)


@pytest.mark.parametrize("c_shards,p_shards", [(2, 4), (1, 8)])
def test_hlo_collectives(devices, c_shards, p_shards):
    """The flagship sharded step must lower to exactly the claimed schedule:
    one nearest-neighbor collective-permute (ring rotation) + one all-reduce
    (partition psum), and NO all-gather of the ring.
    """
    import re

    mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)
    spec = FilterSpec(block_length=128, n_partitions=8, dtype="float32")
    c = 8
    eng = ShardedEngine(spec, c, mesh)
    state = jax.eval_shape(eng._init)
    coeffs = jax.ShapeDtypeStruct((8, c, spec.n_freq), jnp.complex64,
                                  sharding=eng._coeff_sharding)
    state = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        state, eng._state_shardings)
    block = jax.ShapeDtypeStruct((c, 128), jnp.float32,
                                 sharding=eng._block_sharding)
    txt = eng._step.lower(state, coeffs, block).compile().as_text()
    n_cp = len(re.findall(r"collective-permute", txt))
    n_ar = len(re.findall(r"all-reduce", txt))
    n_ag = len(re.findall(r"all-gather", txt))
    if p_shards > 1:
        assert n_cp >= 1, "ring rotation did not lower to collective-permute"
        assert n_ar >= 1, "partition MAC did not lower to all-reduce (psum)"
    assert n_ag == 0, f"sharded step must not all-gather (found {n_ag})"
    # the schedule is minimal: one ppermute start/done pair, one psum
    assert n_cp <= 2 and n_ar <= 2, f"extra collectives: cp={n_cp} ar={n_ar}"


def test_gspmd_schedule_is_numerically_equal_but_not_flagship(devices):
    """The GSPMD-compiled step_rolled cross-check: numerically identical to
    the ppermute schedule, but the compiler inserts all-gathers around the
    ring insert — which is exactly why it is NOT the product path."""
    rng = np.random.default_rng(21)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float64")
    c = 4
    e1 = ShardedEngine(spec, c, mesh, schedule="ppermute")
    e2 = ShardedEngine(spec, c, mesh, schedule="gspmd")
    h = rng.standard_normal((c, spec.max_taps)) * 0.1
    co1, co2 = e1.prepare_coeffs(h), e2.prepare_coeffs(h)
    s1, s2 = e1.init_state(), e2.init_state()
    for _ in range(5):
        blk = rng.standard_normal((c, 64))
        s1, o1 = e1.step(s1, co1, jnp.asarray(blk))
        s2, o2 = e2.step(s2, co2, jnp.asarray(blk))
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-10)


def test_sharded_crossfade_matches_single_device(devices):
    rng = np.random.default_rng(22)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float64")
    c = 4
    eng = ShardedEngine(spec, c, mesh)
    h1 = rng.standard_normal((c, spec.max_taps)) * 0.1
    h2 = rng.standard_normal((c, spec.max_taps)) * 0.1
    co_old, co_new = eng.prepare_coeffs(h1), eng.prepare_coeffs(h2)
    state = eng.init_state()
    st_ref = cv.init_state(spec, c)
    r_old = cv.coeffs_to_spectra(h1, spec)
    r_new = cv.coeffs_to_spectra(h2, spec)
    # a couple of plain steps, then the crossfade block, then continue on new
    for _ in range(2):
        blk = rng.standard_normal((c, 64))
        state, out = eng.step(state, co_old, jnp.asarray(blk))
        st_ref, ref = cv.step(st_ref, r_old, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)
    blk = rng.standard_normal((c, 64))
    state, out = eng.step_crossfade(state, co_old, co_new, jnp.asarray(blk))
    st_ref, ref = cv.step_crossfade(st_ref, r_old, r_new, blk)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)
    for _ in range(2):
        blk = rng.standard_normal((c, 64))
        state, out = eng.step(state, co_new, jnp.asarray(blk))
        st_ref, ref = cv.step(st_ref, r_new, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_sharded_process_blocks_matches_step_loop(devices):
    rng = np.random.default_rng(23)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    c = 4
    eng = ShardedEngine(spec, c, mesh)
    h = rng.standard_normal((c, spec.max_taps)) * 0.1
    coeffs = eng.prepare_coeffs(h)
    state = eng.init_state()
    blocks = rng.standard_normal((6, c, 64))
    state, outs = eng.process_blocks(state, coeffs, jnp.asarray(blocks))
    st_ref = cv.init_state(spec, c)
    co_ref = cv.coeffs_to_spectra(h, spec)
    st_ref, refs = cv.process_blocks(st_ref, co_ref, jnp.asarray(blocks))
    np.testing.assert_allclose(np.asarray(outs), np.asarray(refs), atol=1e-10)


def test_sharded_step_and_batch_interoperate(devices):
    # review regression: step (rolled ring) and process_batch (pointer ring)
    # on the same state produced silently wrong audio when mixed
    rng = np.random.default_rng(15)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    c = 4
    eng = ShardedEngine(spec, c, mesh)
    h = rng.standard_normal((c, spec.max_taps)) * 0.1
    coeffs = eng.prepare_coeffs(h)
    state = eng.init_state()

    st_ref = cv.init_state(spec, c)
    co_ref = cv.coeffs_to_spectra(h, spec)

    # 3 streaming steps (leaves counter % P != 0), then a batch, then a step
    for b in range(3):
        blk = rng.standard_normal((c, 64))
        state, out = eng.step(state, coeffs, jnp.asarray(blk))
        st_ref, ref = cv.step(st_ref, co_ref, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)
    blocks = rng.standard_normal((5, c, 64))
    state, outs = eng.process_batch(state, coeffs, jnp.asarray(blocks))
    st_ref, refs = cv.process_batch(st_ref, co_ref, jnp.asarray(blocks))
    np.testing.assert_allclose(np.asarray(outs), np.asarray(refs), atol=1e-10)
    blk = rng.standard_normal((c, 64))
    state, out = eng.step(state, coeffs, jnp.asarray(blk))
    st_ref, ref = cv.step(st_ref, co_ref, blk)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


@pytest.mark.parametrize("c_shards,p_shards", [(2, 4), (4, 2), (1, 8)])
def test_sharded_hc_matches_single_chip_hc(devices, c_shards, p_shards):
    """local_impl="hc": the pod-scale path must run the exact single-chip
    optimized engine per shard — same packed
    halfcomplex state, same MAC, same overlap-save tail —
    and agree with the single-chip hc step to fp rounding."""
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(23)
    mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float32")
    c = 8
    eng = ShardedEngine(spec, c, mesh, local_impl="hc")
    assert eng.local_impl == "hc"
    h = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    coeffs = eng.prepare_coeffs(h)
    state = eng.init_state()

    ust = K.init_hc_state(spec, c)
    ucoef = K.hc_coeffs(h, spec, c)

    x = rng.standard_normal((c, 64 * 10)).astype(np.float32)
    for b in range(10):
        blk = x[:, b * 64 : (b + 1) * 64]
        state, out = eng.step(state, coeffs, blk)
        ust, ref = K.step_hc(ust, ucoef, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_sharded_hc_crossfade_and_scan(devices):
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(24)
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float32")
    c = 4
    eng = ShardedEngine(spec, c, mesh, local_impl="hc")
    h1 = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    h2 = (h1[:, ::-1]).copy()
    c1 = eng.prepare_coeffs(h1)
    c2 = eng.prepare_coeffs(h2)

    # crossfade block == single-chip hc crossfade
    state = eng.init_state()
    ust = K.init_hc_state(spec, c)
    u1 = K.hc_coeffs(h1, spec, c)
    u2 = K.hc_coeffs(h2, spec, c)
    x = rng.standard_normal((c, 64 * 6)).astype(np.float32)
    for b in range(3):
        blk = x[:, b * 64 : (b + 1) * 64]
        state, _ = eng.step(state, c1, blk)
        ust, _ = K.step_hc(ust, u1, blk)
    blk = x[:, 3 * 64 : 4 * 64]
    state, out = eng.step_crossfade(state, c1, c2, blk)
    ust, ref = K.step_hc_crossfade(ust, u1, u2, blk)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5 * max(1.0, np.abs(np.asarray(ref)).max()))

    # scan (process_blocks + the hc process_batch alias) == step loop
    blocks = jnp.asarray(
        x[:, 4 * 64 :].reshape(c, 2, 64).transpose(1, 0, 2))
    st_a = jax.tree_util.tree_map(lambda a: a.copy(), state)
    st_a, outs = eng.process_blocks(st_a, c2, blocks)
    st_b = state
    refs = []
    for b in range(2):
        st_b, o = eng.step(st_b, c2, np.asarray(blocks[b]))
        refs.append(np.asarray(o))
    np.testing.assert_allclose(np.asarray(outs), np.stack(refs), atol=1e-5)


def test_hlo_collectives_hc(devices):
    """The hc-local sharded step keeps the minimal schedule: one
    collective-permute + psum, zero all-gathers."""
    import re

    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    spec = FilterSpec(block_length=128, n_partitions=8, dtype="float32")
    c = 8
    eng = ShardedEngine(spec, c, mesh, local_impl="hc")
    state = jax.eval_shape(eng._init)
    state = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        state, eng._state_shardings)
    coeffs = jax.ShapeDtypeStruct((8, 2, c, eng._hp), jnp.float32,
                                  sharding=eng._coeff_sharding)
    block = jax.ShapeDtypeStruct((c, 128), jnp.float32,
                                 sharding=eng._block_sharding)
    txt = eng._step.lower(state, coeffs, block).compile().as_text()
    n_cp = len(re.findall(r"collective-permute", txt))
    n_ar = len(re.findall(r"all-reduce", txt))
    n_ag = len(re.findall(r"all-gather", txt))
    assert n_cp >= 1 and n_ar >= 1
    assert n_ag == 0, f"hc sharded step must not all-gather (found {n_ag})"
    assert n_cp <= 2 and n_ar <= 2, f"extra collectives: cp={n_cp} ar={n_ar}"


# ---------------------------------------------------------------------------
# Sharded NON-UNIFORM engine: the pod path must run the
# fastest (two-stage Gardner) engine, verified against the single-chip
# step_nu across mesh shapes, with the minimal collective inventory.
# ---------------------------------------------------------------------------


def _nu_sharded_setup(c_shards, p_shards, c=4, n=128, tail_parts=5, seed=0,
                      tail_store="float32"):
    from bfir_tpu.core import nonuniform as NU

    rng = np.random.default_rng(seed)
    taps = 16 * n + tail_parts * (8 * n)
    h = (rng.standard_normal((c, taps)) * 0.05).astype(np.float32)
    spec = FilterSpec(block_length=n, n_partitions=taps // n, dtype="float32")
    mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)
    eng = ShardedEngine(spec, c, mesh, local_impl="nonuniform",
                        nu_tail_store=tail_store)
    return rng, h, spec, mesh, eng, NU


@pytest.mark.parametrize("c_shards,p_shards", [(1, 8), (2, 4), (4, 2)])
def test_sharded_nu_matches_single_chip(devices, c_shards, p_shards):
    """Sharded two-stage engine == single-chip step_nu to fp rounding, on
    the same (padded) geometry, across mesh shapes."""
    rng, h, spec, mesh, eng, NU = _nu_sharded_setup(c_shards, p_shards, seed=30)
    c, n = 4, 128
    st = eng.init_state()
    co = eng.prepare_coeffs(h)
    st1 = NU.init_nu_state(eng.nuspec, c)
    co1 = NU.nu_coeffs(h, eng.nuspec, c)
    nblocks = 2 * eng.nuspec.ratio + 3
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st, o = eng.step(st, co, blk)
        st1, o1 = NU.step_nu(st1, co1, blk)
        scale = max(1.0, float(np.abs(np.asarray(o1)).max()))
        np.testing.assert_allclose(np.asarray(o), np.asarray(o1),
                                   atol=2e-5 * scale, err_msg=f"block {b}")


def test_sharded_nu_macro_scan_matches_steps(devices):
    """M-cycle-aligned process_blocks (cond-free macro scan) == per-block
    steps, bit-for-bit on CPU."""
    import jax.numpy as jnp

    rng, h, spec, mesh, eng, NU = _nu_sharded_setup(2, 4, seed=31)
    c, n = 4, 128
    R = eng.nuspec.ratio
    co = eng.prepare_coeffs(h)
    nblocks = 2 * R
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    blocks = jnp.asarray(x.reshape(c, nblocks, n).transpose(1, 0, 2))
    st_b, ys = eng.process_blocks(eng.init_state(), co, blocks)
    st_s = eng.init_state()
    refs = []
    for b in range(nblocks):
        st_s, o = eng.step(st_s, co, x[:, b * n:(b + 1) * n])
        refs.append(np.asarray(o))
    np.testing.assert_array_equal(np.asarray(ys), np.stack(refs))
    # and the state threads identically (continue per-block after the scan)
    blk = rng.standard_normal((c, n)).astype(np.float32)
    _, o_b = eng.step(st_b, co, blk)
    _, o_s = eng.step(st_s, co, blk)
    np.testing.assert_array_equal(np.asarray(o_b), np.asarray(o_s))


def test_hlo_collectives_nu(devices):
    """Sharded-nu inventory: exactly one collective-permute + one all-reduce
    per STAGE (head every block; tail under the fire cond), 0 all-gathers —
    amortized (1 + 1/R) pairs per block vs the uniform engine's 1 + 1 on a
    ring R/2x the size (COMM_MODEL.md)."""
    import re

    _, h, spec, mesh, eng, NU = _nu_sharded_setup(2, 4, seed=32)
    c, n = 4, 128
    st = jax.eval_shape(eng._init)
    st = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        st, eng._state_shardings)
    co = eng.prepare_coeffs(h)
    co = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding), co)
    block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                 sharding=eng._block_sharding)
    txt = eng._step.lower(st, co, block).compile().as_text()
    n_cp = len(re.findall(r"collective-permute\(", txt))
    n_ar = len(re.findall(r"all-reduce\(", txt))
    n_ag = len(re.findall(r"all-gather\(", txt))
    assert n_ag == 0, f"sharded-nu step must not all-gather (found {n_ag})"
    assert n_cp == 2 and n_ar == 2, \
        f"expected one cp+ar per stage: cp={n_cp} ar={n_ar}"


def test_sharded_nu_crossfade_protocol_matches_single_chip(devices):
    """The sharded (ramp, hold) crossfade pair == the single-chip
    step_nu_crossfade sequence, block for block, through a full transition
    (change mid-cycle -> bridging tail fire -> pure new)."""
    rng, h, spec, mesh, eng, NU = _nu_sharded_setup(2, 4, seed=33)
    c, n = 4, 128
    R = eng.nuspec.ratio
    h2 = (rng.standard_normal(h.shape) * 0.05).astype(np.float32)
    co_o, co_n = eng.prepare_coeffs(h), eng.prepare_coeffs(h2)
    u_o = NU.nu_coeffs(h, eng.nuspec, c)
    u_n = NU.nu_coeffs(h2, eng.nuspec, c)
    st = eng.init_state()
    st1 = NU.init_nu_state(eng.nuspec, c)
    ramp, hold = eng.nu_crossfade_steps()
    warm = R + 2  # change lands mid-cycle (phase 2)
    total = warm + 2 * R
    x = rng.standard_normal((c, total * n)).astype(np.float32)
    for b in range(total):
        blk = x[:, b * n:(b + 1) * n]
        phase = b % R
        if b < warm:
            st, o = eng.step(st, co_o, blk)
            st1, o1 = NU.step_nu(st1, u_o, blk)
        elif b == warm:
            st, o = ramp(st, co_o, co_n, blk)
            st1, o1 = NU.step_nu_crossfade(st1, u_o, u_n, blk, head_ramp=True)
        elif not fired:
            st, o = hold(st, co_o, co_n, blk)
            st1, o1 = NU.step_nu_crossfade(st1, u_o, u_n, blk, head_ramp=False)
        else:
            st, o = eng.step(st, co_n, blk)
            st1, o1 = NU.step_nu(st1, u_n, blk)
        if b >= warm:
            fired = fired or phase == R - 1 if b > warm else phase == R - 1
        scale = max(1.0, float(np.abs(np.asarray(o1)).max()))
        np.testing.assert_allclose(np.asarray(o), np.asarray(o1),
                                   atol=2e-5 * scale, err_msg=f"block {b}")


def test_sharded_nu_bf16_tail_store(devices):
    """nu_tail_store="bfloat16" shards too: tail ring/coeffs stored bf16,
    output within the documented reduced-precision class vs scipy."""
    from scipy import signal

    rng, h, spec, mesh, eng, NU = _nu_sharded_setup(2, 4, seed=34,
                                                    tail_store="bfloat16")
    c, n = 4, 128
    assert eng.init_state().tail.ring.dtype == jnp.bfloat16
    co = eng.prepare_coeffs(h)
    assert co.tail.dtype == jnp.bfloat16
    st = eng.init_state()
    nblocks = 4 * eng.nuspec.ratio
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    outs = []
    for b in range(nblocks):
        st, o = eng.step(st, co, x[:, b * n:(b + 1) * n])
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)
    ref = np.stack([signal.fftconvolve(x[ch].astype(np.float64), h[ch])[:y.shape[1]]
                    for ch in range(c)])
    snr = 10 * np.log10(float((ref ** 2).sum())
                        / float(((y - ref) ** 2).sum()))
    assert snr > 40, snr  # reduced-precision class, not garbage


def test_sharded_nu_validation(devices):
    """Geometry guards: head not divisible by mesh p, filter too short."""
    mesh = M.make_mesh(channel_shards=1, partition_shards=8)
    short = FilterSpec(block_length=128, n_partitions=8, dtype="float32")
    with pytest.raises(ValueError, match="too short"):
        ShardedEngine(short, 2, mesh, local_impl="nonuniform")
    with pytest.raises(ValueError, match="requires the ppermute"):
        spec = FilterSpec(block_length=128, n_partitions=64, dtype="float32")
        ShardedEngine(spec, 2, mesh, local_impl="nonuniform", schedule="gspmd")


# ---------------------------------------------------------------------------
# Collective BYTES vs COMM_MODEL.md: not just the op
# inventory — the payload of every collective is asserted against the
# model's formulas, so fattening a collective (or adding an all-gather)
# fails the suite.
# ---------------------------------------------------------------------------

_DT_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "c64": 8, "c128": 16,
             "s32": 4, "u32": 4, "pred": 1}


def _collective_bytes(txt):
    """Parse compiled HLO: result byte size of every collective op."""
    import re

    out = {"collective-permute": [], "all-reduce": [], "all-gather": []}
    pat = re.compile(
        r"= (\w+)\[([\d,]*)\]\S* (collective-permute|all-reduce|all-gather)\(")
    for m_ in pat.finditer(txt):
        dt, dims, op = m_.groups()
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out[op].append(_DT_BYTES.get(dt, 4) * n)
    return out


def _lowered_hc_hlo(c, p_total, c_shards, p_shards, n=128):
    mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)
    spec = FilterSpec(block_length=n, n_partitions=p_total, dtype="float32")
    eng = ShardedEngine(spec, c, mesh, local_impl="hc")
    state = jax.eval_shape(eng._init)
    state = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        state, eng._state_shardings)
    coeffs = jax.ShapeDtypeStruct((p_total, 2, c, eng._hp), jnp.float32,
                                  sharding=eng._coeff_sharding)
    block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                 sharding=eng._block_sharding)
    return eng, eng._step.lower(state, coeffs, block).compile().as_text()


@pytest.mark.parametrize("c,p_total,c_shards,p_shards",
                         [(8, 8, 2, 4), (8, 16, 2, 4), (4, 8, 1, 8)])
def test_collective_bytes_match_comm_model_hc(devices, c, p_total, c_shards,
                                              p_shards):
    """hc-local step: B_perm = B_psum payload = 2·(C/c)·Hp·4 exactly
    (COMM_MODEL.md 'hc-local shard compute'), and no all-gather."""
    eng, txt = _lowered_hc_hlo(c, p_total, c_shards, p_shards)
    got = _collective_bytes(txt)
    model = 2 * (c // c_shards) * eng._hp * 4
    assert got["all-gather"] == []
    assert got["collective-permute"] == [model], (got, model)
    assert got["all-reduce"] == [model], (got, model)


def test_collective_bytes_independent_of_partitions(devices):
    """Per-device traffic is O(C·Hp), INDEPENDENT of the filter length P —
    the scaling-efficiency premise of COMM_MODEL.md: doubling P must not
    change a single collective byte."""
    _, txt8 = _lowered_hc_hlo(8, 8, 2, 4)
    _, txt32 = _lowered_hc_hlo(8, 32, 2, 4)
    assert _collective_bytes(txt8) == _collective_bytes(txt32)


def test_collective_bytes_match_comm_model_nu(devices):
    """Sharded-nu step: head pair carries 2·(C/c)·Hp_head·4, tail pair
    2·(C/c)·Hp_tail·4 (fired every R blocks), nothing else."""
    c, n = 4, 128
    c_shards, p_shards = 2, 4
    _, h, spec, mesh, eng, NU = _nu_sharded_setup(c_shards, p_shards, seed=50)
    st = jax.eval_shape(eng._init)
    st = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        st, eng._state_shardings)
    co = eng.prepare_coeffs(h)
    co = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
        co)
    block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                 sharding=eng._block_sharding)
    txt = eng._step.lower(st, co, block).compile().as_text()
    got = _collective_bytes(txt)
    head = 2 * (c // c_shards) * eng._hp_h * 4
    tail = 2 * (c // c_shards) * eng._hp_t * 4
    assert got["all-gather"] == []
    assert sorted(got["collective-permute"]) == sorted([head, tail]), got
    assert sorted(got["all-reduce"]) == sorted([head, tail]), got


def test_per_device_bytes_scale_with_partition_shards(devices):
    """Compiler-level scaling evidence (beyond the byte-counted collectives):
    the compiled sharded step's per-device 'bytes accessed' follows
    A + B/p — a constant replicated part (transforms, block IO, output)
    plus the partition-sharded MAC traffic B that shrinks linearly with the
    mesh "p" axis. Fit A, B from p=2 and p=8 and PREDICT p=4; assert the
    prediction and that B matches the analytic ring+coeff traffic. This is
    the engine's scaling premise (the step is HBM-traffic-bound) checked on
    the compiled artifact itself."""
    import jax.numpy as jnp

    c, n, p_total = 8, 128, 32
    spec = FilterSpec(block_length=n, n_partitions=p_total, dtype="float32")
    meas = {}
    for p_shards in (2, 4, 8):
        mesh = M.make_mesh(channel_shards=1, partition_shards=p_shards,
                           devices=jax.devices()[:p_shards])
        eng = ShardedEngine(spec, c, mesh, local_impl="hc")
        st = jax.eval_shape(eng._init)
        st = jax.tree_util.tree_map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
            st, eng._state_shardings)
        co = jax.ShapeDtypeStruct((p_total, 2, c, eng._hp), jnp.float32,
                                  sharding=eng._coeff_sharding)
        blk = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                   sharding=eng._block_sharding)
        ca = eng._step.lower(st, co, blk).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        meas[p_shards] = float(ca["bytes accessed"])
    # fit A + B/p from p=2, p=8
    b = (meas[2] - meas[8]) / (1 / 2 - 1 / 8)
    a = meas[8] - b / 8
    assert b > 0, meas
    pred4 = a + b / 4
    assert abs(pred4 - meas[4]) < 0.05 * meas[4], (meas, pred4)
    # B tracks the partition-sharded state: a small multiple of the
    # ring+coeff bytes (the compiler sums per-op accesses, so the ring is
    # counted once per pass it appears in — update-slice in/out, MAC
    # custom-call operand, state threading; measured multiple ≈ 8)
    analytic = 2 * p_total * 2 * c * eng._hp * 4
    assert analytic < b < 16 * analytic, (b, analytic)


@pytest.mark.parametrize("local", ["hc", "nonuniform"])
def test_sharded_shared_coeffs_match_broadcast(devices, local):
    """shared_coeffs=True: [P, 2, 1, Hp] planes replicated over "c",
    broadcast in-kernel — identical outputs to the per-channel build, 1/C
    the per-chip coefficient bytes."""
    rng = np.random.default_rng(55)
    c, n = 4, 128
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    if local == "hc":
        spec = FilterSpec(block_length=n, n_partitions=8, dtype="float32")
        taps = spec.max_taps
    else:
        taps = 16 * n + 5 * 8 * n
        spec = FilterSpec(block_length=n, n_partitions=taps // n,
                          dtype="float32")
    h1 = (rng.standard_normal((1, taps)) * 0.05).astype(np.float32)
    hb = np.broadcast_to(h1, (c, taps)).copy()
    e_sh = ShardedEngine(spec, c, mesh, local_impl=local, shared_coeffs=True)
    e_bc = ShardedEngine(spec, c, mesh, local_impl=local)
    assert e_sh.shared_coeffs and not e_bc.shared_coeffs
    co_sh = e_sh.prepare_coeffs(h1)
    co_bc = e_bc.prepare_coeffs(hb)
    head_sh = co_sh.head if local == "nonuniform" else co_sh
    assert head_sh.shape[2] == 1  # one channel plane
    st_s, st_b = e_sh.init_state(), e_bc.init_state()
    nblocks = (2 * e_sh.nuspec.ratio + 3) if local == "nonuniform" else 6
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st_s, o_s = e_sh.step(st_s, co_sh, blk)
        st_b, o_b = e_bc.step(st_b, co_bc, blk)
        scale = max(1.0, float(np.abs(np.asarray(o_b)).max()))
        np.testing.assert_allclose(np.asarray(o_s), np.asarray(o_b),
                                   atol=2e-5 * scale, err_msg=f"block {b}")


# ---------------------------------------------------------------------------
# Sharded THREE-stage engine: the very-long-filter tier
# (session auto >= 640 partitions) must have a pod path too — verified
# against the single-chip step_nu3 across mesh shapes, with one cp+ar pair
# per stage at its own cadence.
# ---------------------------------------------------------------------------


def _nu3_sharded_setup(c_shards, p_shards, c=4, n=128, seed=0,
                       tail_store="float32"):
    from bfir_tpu.core import nonuniform as NU

    rng = np.random.default_rng(seed)
    r1 = r2 = 2
    p_head = int(np.lcm(2 * r1, p_shards))
    p_head_i = int(np.lcm(2 * r2, p_shards))
    p_far = int(np.lcm(1, p_shards)) * 2
    m1 = r1 * n
    inner = NU.NuSpec(block_length=m1, ratio=r2, p_head=p_head_i,
                      p_tail=p_far, dtype="float32", tail_store=tail_store)
    spec3 = NU.Nu3Spec(block_length=n, ratio1=r1, p_head=p_head, inner=inner)
    taps = spec3.max_taps
    h = (rng.standard_normal((c, taps)) * 0.05).astype(np.float32)
    spec = FilterSpec(block_length=n, n_partitions=taps // n, dtype="float32")
    mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)
    eng = ShardedEngine(spec, c, mesh, local_impl="nonuniform3", nuspec=spec3)
    return rng, h, spec, mesh, eng, NU


@pytest.mark.parametrize("c_shards,p_shards", [(1, 8), (2, 4), (4, 2)])
def test_sharded_nu3_matches_single_chip(devices, c_shards, p_shards):
    """Sharded three-stage engine == single-chip step_nu3 to fp rounding,
    across mesh shapes, through several full super-cycles (so the far
    stage's pending outputs land)."""
    rng, h, spec, mesh, eng, NU = _nu3_sharded_setup(c_shards, p_shards,
                                                     seed=60)
    c, n = 4, 128
    st = eng.init_state()
    co = eng.prepare_coeffs(h)
    st1 = NU.init_nu3_state(eng.nuspec, c)
    co1 = NU.nu3_coeffs(h, eng.nuspec, c)
    sup = eng.nuspec.ratio1 * eng.nuspec.inner.ratio
    nblocks = 3 * sup + 1
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st, o = eng.step(st, co, blk)
        st1, o1 = NU.step_nu3(st1, co1, blk)
        scale = max(1.0, float(np.abs(np.asarray(o1)).max()))
        np.testing.assert_allclose(np.asarray(o), np.asarray(o1),
                                   atol=2e-5 * scale, err_msg=f"block {b}")


def test_sharded_nu3_matches_scipy(devices):
    """Absolute correctness: the sharded three-stage stream vs the scipy
    float64 oracle, worst channel."""
    from scipy import signal

    rng, h, spec, mesh, eng, NU = _nu3_sharded_setup(2, 4, seed=61)
    c, n = 4, 128
    st = eng.init_state()
    co = eng.prepare_coeffs(h)
    sup = eng.nuspec.ratio1 * eng.nuspec.inner.ratio
    nblocks = 3 * sup
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    outs = []
    for b in range(nblocks):
        st, o = eng.step(st, co, x[:, b * n:(b + 1) * n])
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)
    ref = signal.fftconvolve(x.astype(np.float64), h.astype(np.float64),
                             axes=1)[:, : y.shape[1]]
    worst = min(
        10 * np.log10(float((ref[ch] ** 2).sum())
                      / max(float(((y[ch] - ref[ch]) ** 2).sum()), 1e-300))
        for ch in range(c))
    assert worst > 100, worst


def test_sharded_nu3_macro_scan_matches_steps(devices):
    """Super-cycle-aligned process_blocks (cond-free macro scan) == the
    per-block steps to f32 rounding (different XLA graphs fuse the inverse
    transforms differently on CPU, so bit-exactness is not guaranteed here
    the way the two-stage macro happens to be), and the state threads."""
    import jax.numpy as jnp

    rng, h, spec, mesh, eng, NU = _nu3_sharded_setup(2, 4, seed=62)
    c, n = 4, 128
    sup = eng.nuspec.ratio1 * eng.nuspec.inner.ratio
    co = eng.prepare_coeffs(h)
    nblocks = 2 * sup
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    blocks = jnp.asarray(x.reshape(c, nblocks, n).transpose(1, 0, 2))
    st_b, ys = eng.process_blocks(eng.init_state(), co, blocks)
    st_s = eng.init_state()
    refs = []
    for b in range(nblocks):
        st_s, o = eng.step(st_s, co, x[:, b * n:(b + 1) * n])
        refs.append(np.asarray(o))
    refs = np.stack(refs)
    scale = max(1.0, float(np.abs(refs).max()))
    np.testing.assert_allclose(np.asarray(ys), refs, atol=2e-5 * scale)
    blk = rng.standard_normal((c, n)).astype(np.float32)
    _, o_b = eng.step(st_b, co, blk)
    _, o_s = eng.step(st_s, co, blk)
    np.testing.assert_allclose(np.asarray(o_b), np.asarray(o_s),
                               atol=2e-5 * scale)


def test_hlo_collectives_nu3(devices):
    """Sharded-nu3 inventory: one collective-permute + one all-reduce per
    STAGE (outer head every block; inner head and far under their nested
    fire conds), 0 all-gathers."""
    import re

    _, h, spec, mesh, eng, NU = _nu3_sharded_setup(2, 4, seed=63)
    c, n = 4, 128
    st = jax.eval_shape(eng._init)
    st = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        st, eng._state_shardings)
    co = eng.prepare_coeffs(h)
    co = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
        co)
    block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                 sharding=eng._block_sharding)
    txt = eng._step.lower(st, co, block).compile().as_text()
    n_cp = len(re.findall(r"collective-permute\(", txt))
    n_ar = len(re.findall(r"all-reduce\(", txt))
    n_ag = len(re.findall(r"all-gather\(", txt))
    assert n_ag == 0, f"sharded-nu3 step must not all-gather (found {n_ag})"
    assert n_cp == 3 and n_ar == 3, \
        f"expected one cp+ar per stage: cp={n_cp} ar={n_ar}"


def test_collective_bytes_match_comm_model_nu3(devices):
    """Per-stage payloads: 2·(C/c)·Hp·4 for Hp in (Hp_N, Hp_M1, Hp_M2) —
    the COMM_MODEL.md nu3 rows, parsed from the compiled HLO."""
    c, n = 4, 128
    c_shards, p_shards = 2, 4
    _, h, spec, mesh, eng, NU = _nu3_sharded_setup(c_shards, p_shards,
                                                   seed=64)
    st = jax.eval_shape(eng._init)
    st = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        st, eng._state_shardings)
    co = eng.prepare_coeffs(h)
    co = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
        co)
    block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                 sharding=eng._block_sharding)
    txt = eng._step.lower(st, co, block).compile().as_text()
    got = _collective_bytes(txt)
    hp_n = -(-n // 128) * 128
    hp_m1 = -(-eng.nuspec.m1 // 128) * 128
    hp_m2 = -(-eng.nuspec.inner.m // 128) * 128
    sizes = [2 * (c // c_shards) * hp * 4 for hp in (hp_n, hp_m1, hp_m2)]
    assert got["all-gather"] == []
    assert sorted(got["collective-permute"]) == sorted(sizes), got
    assert sorted(got["all-reduce"]) == sorted(sizes), got


def test_sharded_nu3_validation(devices):
    """Geometry checks: head partition counts must divide the mesh "p"
    axis; the crossfade surface reports rebuild-only reconfigure."""
    from bfir_tpu.core import nonuniform as NU

    mesh = M.make_mesh(channel_shards=1, partition_shards=8)
    n = 128
    inner = NU.NuSpec(block_length=2 * n, ratio=2, p_head=4, p_tail=8,
                      dtype="float32")
    spec3 = NU.Nu3Spec(block_length=n, ratio1=2, p_head=4, inner=inner)
    taps = spec3.max_taps
    spec = FilterSpec(block_length=n, n_partitions=taps // n, dtype="float32")
    with pytest.raises(ValueError, match="not divisible"):
        ShardedEngine(spec, 4, mesh, local_impl="nonuniform3", nuspec=spec3)

    rng, h, spec, mesh, eng, NU = _nu3_sharded_setup(2, 4, seed=65)
    co = eng.prepare_coeffs(h)
    st = eng.init_state()
    with pytest.raises(NotImplementedError, match="rebuild"):
        eng.step_crossfade(st, co, co, np.zeros((4, 128), np.float32))


def test_sharded_nu3_shared_coeffs_match_broadcast(devices):
    """Shared-coefficient planes on the sharded three-stage engine: one
    filter for all channels ([P, 2, 1, Hp] replicated over "c") matches the
    per-channel broadcast build."""
    rng = np.random.default_rng(66)
    c, n = 4, 128
    mesh = M.make_mesh(channel_shards=2, partition_shards=4)
    from bfir_tpu.core import nonuniform as NU

    r1 = r2 = 2
    inner = NU.NuSpec(block_length=r1 * n, ratio=r2, p_head=4, p_tail=4,
                      dtype="float32")
    spec3 = NU.Nu3Spec(block_length=n, ratio1=r1, p_head=4, inner=inner)
    taps = spec3.max_taps
    spec = FilterSpec(block_length=n, n_partitions=taps // n, dtype="float32")
    h1 = (rng.standard_normal((1, taps)) * 0.05).astype(np.float32)
    hb = np.broadcast_to(h1, (c, taps)).copy()
    e_sh = ShardedEngine(spec, c, mesh, local_impl="nonuniform3",
                         nuspec=spec3, shared_coeffs=True)
    e_bc = ShardedEngine(spec, c, mesh, local_impl="nonuniform3",
                         nuspec=spec3)
    assert e_sh.shared_coeffs and not e_bc.shared_coeffs
    co_sh = e_sh.prepare_coeffs(h1)
    co_bc = e_bc.prepare_coeffs(hb)
    assert co_sh.head.shape[2] == 1  # one channel plane
    st_s, st_b = e_sh.init_state(), e_bc.init_state()
    nblocks = 2 * r1 * r2 + 3
    x = rng.standard_normal((c, nblocks * n)).astype(np.float32)
    for b in range(nblocks):
        blk = x[:, b * n:(b + 1) * n]
        st_s, o_s = e_sh.step(st_s, co_sh, blk)
        st_b, o_b = e_bc.step(st_b, co_bc, blk)
        scale = max(1.0, float(np.abs(np.asarray(o_b)).max()))
        np.testing.assert_allclose(np.asarray(o_s), np.asarray(o_b),
                                   atol=2e-5 * scale, err_msg=f"block {b}")
