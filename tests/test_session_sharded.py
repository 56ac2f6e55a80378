"""Session-level sharded execution (engine_mode="sharded") and the
known-answer self-check.

The reference makes its engine the product path (foo_dsp_bfir.cpp:279-351);
these tests make the multi-device engine reachable from the same
StreamProcessor surface, on the 8-virtual-CPU-device mesh."""

import dataclasses

import numpy as np
import pytest

from bfir_tpu.core.spec import (
    ChainSpec,
    EngineConfig,
    EqSpec,
    FilterSpec,
    ImpulseFileSpec,
    SampleFormat,
    StreamSpec,
)
from bfir_tpu.engine.cache import ArtifactCache
from bfir_tpu.engine.session import StreamProcessor
from bfir_tpu.io import wavio


@pytest.fixture
def cache(tmp_path):
    return ArtifactCache(str(tmp_path / "profile"))


@pytest.fixture(autouse=True)
def _fresh_compile_caches(request):
    """The sharded-session tests compile 8-device shard_map graphs; XLA's
    CPU compiler has hard-aborted the xdist worker at exactly this group
    when hundreds of executables had accumulated in-process (the same
    tests pass serially — CLAUDE.md documents the segfault class).
    Dropping the in-process caches before each sharded-NU test keeps the
    compiler arena small, the same defense test_nonuniform.py uses for
    the split-engine graphs."""
    import jax

    if "nonuniform" in request.node.name or "nu_" in request.node.name:
        jax.clear_caches()
    yield


def save_impulse(tmp_path, name, imp, rate=44100):
    p = str(tmp_path / name)
    wavio.write(p, np.asarray(imp).T, rate, subtype="float64")
    return p


def make_config(tmp_path, fname, block=256, engine_mode="sharded", level=0):
    files = [ImpulseFileSpec(enabled=True, filename=fname, level_steps=level),
             ImpulseFileSpec(), ImpulseFileSpec()]
    return EngineConfig(
        filter=FilterSpec(block_length=block, n_partitions=1, dtype="float64"),
        stream=StreamSpec(n_channels=2, sample_rate=44100),
        chain=ChainSpec(eq=EqSpec(), files=tuple(files)),
        engine_mode=engine_mode,
    )


@pytest.fixture
def impulse_file(tmp_path):
    rng = np.random.default_rng(3)
    imp = rng.standard_normal((2, 700)) * 0.1  # 3 partitions at block 256
    return save_impulse(tmp_path, "ir.wav", imp), imp


def test_sharded_session_matches_complex(cache, tmp_path, impulse_file):
    fname, _ = impulse_file
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 256 * 5))

    outs = {}
    for mode in ("complex", "sharded"):
        sp = StreamProcessor(make_config(tmp_path, fname, engine_mode=mode), cache)
        outs[mode] = sp.process(x)
        assert sp._impl == mode
    # sharded rounds 3 partitions up to the mesh multiple (8 devices -> 8)
    np.testing.assert_allclose(outs["sharded"], outs["complex"], atol=1e-10)


def test_sharded_session_process_buffer(cache, tmp_path, impulse_file):
    fname, _ = impulse_file
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 256 * 6 + 100))
    sp_s = StreamProcessor(make_config(tmp_path, fname, engine_mode="sharded"), cache)
    sp_c = StreamProcessor(make_config(tmp_path, fname, engine_mode="complex"), cache)
    y_s = sp_s.process_buffer(x)
    y_c = sp_c.process_buffer(x)
    assert y_s.shape == (2, 256 * 6)
    np.testing.assert_allclose(y_s, y_c, atol=1e-10)


def test_sharded_session_midstream_reconfigure_crossfade(cache, tmp_path, impulse_file):
    """Mid-stream filter change on the sharded engine: glitch-free crossfade
    block, identical to the complex path's crossfade."""
    fname, _ = impulse_file
    rng = np.random.default_rng(6)
    imp2 = rng.standard_normal((2, 700)) * 0.1
    fname2 = save_impulse(tmp_path, "ir2.wav", imp2)
    x = rng.standard_normal((2, 256 * 6))

    outs = {}
    for mode in ("complex", "sharded"):
        cfg = make_config(tmp_path, fname, engine_mode=mode)
        sp = StreamProcessor(cfg, cache)
        y1 = sp.process(x[:, : 256 * 3])
        cfg2 = make_config(tmp_path, fname2, engine_mode=mode)
        sp.reconfigure(cfg2)
        assert sp._pending_swap is not None, "same geometry => crossfade queued"
        y2 = sp.process(x[:, 256 * 3 :])
        outs[mode] = np.concatenate([y1, y2], axis=1)
    np.testing.assert_allclose(outs["sharded"], outs["complex"], atol=1e-10)


def test_self_check_refuses_corrupted_engine(cache, tmp_path, impulse_file, monkeypatch):
    """Prove the known-answer guard fires: corrupt the step function and the
    session must refuse the engine and degrade to passthrough instead of
    streaming wrong audio."""
    from bfir_tpu.core import convolver as cv

    orig = cv.step

    def corrupted(state, coeffs, block):
        st, out = orig(state, coeffs, block)
        return st, out + 0.01  # small deterministic corruption (~miscompile)

    monkeypatch.setattr(cv, "step", corrupted)
    fname, _ = impulse_file
    sp = StreamProcessor(make_config(tmp_path, fname, engine_mode="complex"), cache)
    x = np.random.default_rng(7).standard_normal((2, 1024))
    y = sp.process(x)
    assert not sp._active, "corrupted engine must not be activated"
    np.testing.assert_array_equal(y, x)  # passthrough


def test_self_check_fallback_to_complex(cache, tmp_path, impulse_file, monkeypatch):
    """A failing sharded build falls back to the complex engine."""
    from bfir_tpu.parallel import sharded as sh

    class Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("no mesh for you")

    monkeypatch.setattr(sh, "ShardedEngine", Boom)
    fname, imp = impulse_file
    sp = StreamProcessor(make_config(tmp_path, fname, engine_mode="sharded"), cache)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 256 * 4))
    y = sp.process(x)
    assert sp._active and sp._impl == "complex"
    from scipy import signal

    ref = np.stack([signal.fftconvolve(x[i], imp[i])[: x.shape[1]] for i in range(2)])
    assert np.max(np.abs(y - ref)) < 1e-9


def test_self_check_can_be_disabled(cache, tmp_path, impulse_file, monkeypatch):
    from bfir_tpu.core import convolver as cv

    orig = cv.step

    def corrupted(state, coeffs, block):
        st, out = orig(state, coeffs, block)
        return st, out + 0.01

    monkeypatch.setattr(cv, "step", corrupted)
    fname, _ = impulse_file
    cfg = dataclasses.replace(
        make_config(tmp_path, fname, engine_mode="complex"), self_check=False)
    sp = StreamProcessor(cfg, cache)
    x = np.random.default_rng(9).standard_normal((2, 1024))
    sp.process(x)
    assert sp._active  # explicit opt-out skips the guard


def _long_impulse(tmp_path, rng, block=128, tail_parts=3):
    taps = 16 * block + tail_parts * 8 * block + 50
    imp = rng.standard_normal((2, taps)) * 0.05
    return save_impulse(tmp_path, "irlong.wav", imp), imp


@pytest.mark.xdist_group(name="sharded-session")
def test_sharded_session_nonuniform_local(cache, tmp_path):
    """engine_mode="sharded" composes with long filters:
    sharded_local="nonuniform" activates the sharded two-stage engine behind
    the same StreamProcessor surface, verified vs scipy."""
    from scipy import signal

    rng = np.random.default_rng(40)
    block = 128
    fname, imp = _long_impulse(tmp_path, rng, block)
    cfg = dataclasses.replace(
        make_config(tmp_path, fname, block=block),
        filter=FilterSpec(block_length=block, n_partitions=1, dtype="float32"),
        sharded_local="nonuniform")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 40 * block))
    y = sp.process(x)
    assert sp._impl == "sharded"
    assert sp._sharded.local_impl == "nonuniform"
    ref = np.stack([signal.fftconvolve(x[c], imp[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr

    # mid-stream reconfigure drives the two-phase (ramp/hold) protocol and
    # converges to the new filter
    rng2 = np.random.default_rng(41)
    imp2 = rng2.standard_normal(imp.shape) * 0.05
    fname2 = save_impulse(tmp_path, "irlong2.wav", imp2)
    cfg2 = dataclasses.replace(cfg, chain=dataclasses.replace(
        cfg.chain, files=(ImpulseFileSpec(enabled=True, filename=fname2),
                          ImpulseFileSpec(), ImpulseFileSpec())))
    sp.reconfigure(cfg2)
    assert sp._pending_swap is not None, "same geometry => crossfade queued"
    x2 = rng.standard_normal((2, 40 * block))
    y2 = sp.process(x2)
    full = np.concatenate([x, x2], axis=1)
    ref2 = np.stack([signal.fftconvolve(full[c], imp2[c])[: full.shape[1]]
                     for c in range(2)])
    seg = slice(70 * block, 80 * block)
    yseg = np.concatenate([y, y2], axis=1)[:, seg]
    rseg = ref2[:, seg]
    snr2 = 10 * np.log10(float((rseg**2).sum())
                         / float(((yseg - rseg)**2).sum()))
    assert snr2 > 100, snr2


@pytest.mark.xdist_group(name="sharded-session")
def test_sharded_session_nu_selfcheck_fallback_to_uniform(cache, tmp_path,
                                                          monkeypatch):
    """A refused sharded-nu graph falls back to the UNIFORM sharded engine
    (the "sharded:uniform" candidate), not all the way to single-chip."""
    from bfir_tpu.parallel import sharded as sh

    orig = sh.make_ppermute_step_nu

    def corrupted(*a, **k):
        step = orig(*a, **k)

        def bad(state, coeffs, block):
            st, out = step(state, coeffs, block)
            return st, out + 0.01
        return bad

    monkeypatch.setattr(sh, "make_ppermute_step_nu", corrupted)
    rng = np.random.default_rng(42)
    block = 128
    fname, imp = _long_impulse(tmp_path, rng, block)
    cfg = dataclasses.replace(
        make_config(tmp_path, fname, block=block),
        filter=FilterSpec(block_length=block, n_partitions=1, dtype="float32"),
        sharded_local="nonuniform")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 16 * block))
    y = sp.process(x)
    assert sp._active and sp._impl == "sharded"
    assert sp._sharded.local_impl != "nonuniform"
    from scipy import signal

    ref = np.stack([signal.fftconvolve(x[c], imp[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr


@pytest.mark.xdist_group(name="sharded-session")
def test_sharded_session_nonuniform3_local(cache, tmp_path):
    """sharded_local="nonuniform3" activates the sharded three-stage engine
    behind the StreamProcessor surface (the very-long-filter pod tier),
    verified vs scipy through the bulk macro scan.
    Self-check is disabled here (the scipy check below IS the check; the
    full warm-up stream through 8 interpret-mode shard devices would
    dominate suite runtime), and reconfigure is rebuild-only."""
    import dataclasses

    from scipy import signal

    rng = np.random.default_rng(70)
    block = 128
    taps = 40960  # 320 partitions: beyond outer+inner head coverage (18432)
    imp = rng.standard_normal((2, taps)) * 0.05
    fname = save_impulse(tmp_path, "irnu3.wav", imp)
    cfg = dataclasses.replace(
        make_config(tmp_path, fname, block=block),
        filter=FilterSpec(block_length=block, n_partitions=1, dtype="float32"),
        sharded_local="nonuniform3", self_check=False)
    sp = StreamProcessor(cfg, cache)
    sup = 64  # r1 * r2 of the auto geometry
    x = rng.standard_normal((2, 4 * sup * block))
    y = sp.process_buffer(x)
    assert sp._impl == "sharded"
    assert sp._sharded.local_impl == "nonuniform3"
    ref = np.stack([signal.fftconvolve(x[c], imp[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr

    # reconfigure on this engine is rebuild-only (no sharded nu3 crossfade)
    imp2 = imp * 0.5
    fname2 = save_impulse(tmp_path, "irnu3b.wav", imp2)
    cfg2 = dataclasses.replace(cfg, chain=dataclasses.replace(
        cfg.chain, files=(ImpulseFileSpec(enabled=True, filename=fname2),
                          ImpulseFileSpec(), ImpulseFileSpec())))
    sp.reconfigure(cfg2)
    assert sp._pending_swap is None, "nu3 sharded must rebuild, not crossfade"
    y2 = sp.process_buffer(rng.standard_normal((2, sup * block)))
    assert sp._sharded.local_impl == "nonuniform3"
    assert y2.shape[1] == sup * block
