import json

import numpy as np
import pytest

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import EqSpec, FilterSpec
from bfir_tpu.engine import checkpoint as ck
from bfir_tpu.engine import presets
from bfir_tpu.ops import dither as dth


def test_preset_roundtrip(tmp_path):
    eq = EqSpec(enabled=True, level_steps=-35, mag_steps=tuple(range(-15, 16)))
    p = str(tmp_path / "preset.json")
    presets.save_preset(p, eq)
    # schema parity with prefs_eq.cpp:469-521
    data = json.load(open(p))
    assert set(data) == {"cfg_eq_level", "cfg_eq_mag"}
    assert data["cfg_eq_level"] == -35
    assert data["cfg_eq_mag"] == ",".join(str(v) for v in range(-15, 16))
    back = presets.load_preset(p)
    assert back.level_steps == eq.level_steps
    assert back.mag_steps == eq.mag_steps


def test_preset_reference_format_loads():
    # a preset as the reference writes it (default flat curve, common.h:28)
    s = '{"cfg_eq_level": 0, "cfg_eq_mag": "' + ",".join(["0"] * 31) + '"}'
    eq = presets.eq_from_preset_json(s)
    assert eq.mag_steps == tuple([0] * 31)
    with pytest.raises(ValueError):
        presets.eq_from_preset_json('{"cfg_eq_mag": "1,2,3"}')


def test_checkpoint_resume_bitexact(tmp_path):
    rng = np.random.default_rng(0)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    h = rng.standard_normal(200)
    co = cv.coeffs_to_spectra(h, spec)
    st = cv.init_state(spec, 2)
    x = rng.standard_normal((2, 64 * 10))

    # run 5 blocks, checkpoint, run 5 more
    for b in range(5):
        st, _ = cv.step(st, co, x[:, b * 64 : (b + 1) * 64])
    dst = dth.init_dither_state(2, seed=1, dtype=np.float64)
    of = dth.init_overflow_stats(2, dtype=np.float64)
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, st, dst, of)

    outs_a = []
    st_a = st
    for b in range(5, 10):
        st_a, o = cv.step(st_a, co, x[:, b * 64 : (b + 1) * 64])
        outs_a.append(np.asarray(o))

    st_b, dst_b, of_b = ck.load_state(path)
    assert dst_b is not None and of_b is not None
    assert int(st_b.blockcounter) == 5
    outs_b = []
    for b in range(5, 10):
        st_b, o = cv.step(st_b, co, x[:, b * 64 : (b + 1) * 64])
        outs_b.append(np.asarray(o))

    np.testing.assert_array_equal(np.concatenate(outs_a, 1), np.concatenate(outs_b, 1))


def test_process_buffer_equals_process(tmp_path):
    from tests.test_engine import make_config, save_impulse
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "h.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    x = rng.standard_normal((2, 2000))

    sp1 = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "c1")))
    y1 = sp1.process(x)
    sp2 = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "c2")))
    y2 = sp2.process_buffer(x)
    np.testing.assert_allclose(y1, y2, atol=1e-12)
    assert sp1.block_timer.count == 7  # per-block latency recorded


def test_block_timer():
    from bfir_tpu.utils.profiling import BlockTimer

    t = BlockTimer()
    for v in [0.001, 0.002, 0.003]:
        t.add(v)
    p = t.percentiles()
    assert p[50] == 0.002
    assert "3 blocks" in t.summary()


def test_wisdom_key_covers_compiler_stack(monkeypatch, tmp_path):
    """Compiler-stack (jaxlib, backend platform_version) changes must
    invalidate self-check verdicts even under an unchanged
    jax.__version__."""
    from bfir_tpu.utils import hashing

    fp = hashing.backend_fingerprint()
    import jax
    import jaxlib.version

    assert jax.__version__ in fp and jaxlib.version.__version__ in fp
    # the backend platform_version slot is present (non-empty 4th field)
    assert len(fp.split("|")) >= 6

    from bfir_tpu.core.spec import FilterSpec
    from bfir_tpu.engine import selfcheck

    spec = FilterSpec(block_length=64, n_partitions=2, dtype="float32")
    imp = np.zeros((1, 128))
    k1 = selfcheck.cache_key("hc", imp, spec, 2, 3, 80.0)
    monkeypatch.setattr(hashing, "backend_fingerprint",
                        lambda: fp + "|other-compiler-build")
    k2 = selfcheck.cache_key("hc", imp, spec, 2, 3, 80.0)
    assert k1 != k2


def test_selfcheck_failure_verdict_expires(tmp_path):
    """Cached FAILED verdicts age out (FAILURE_TTL_S) so a fixed
    backend/transient can't demote an engine forever; passes never expire."""
    import json

    from bfir_tpu.engine import selfcheck

    cf = str(tmp_path / "verdicts.json")
    selfcheck.store_verdict(cf, "kfail", 4.0, False)
    selfcheck.store_verdict(cf, "kpass", 130.0, True)
    assert selfcheck.load_verdict(cf, "kfail")["ok"] is False
    # age both entries beyond the TTL
    with open(cf) as f:
        data = json.load(f)
    for v in data.values():
        v["t"] -= selfcheck.FAILURE_TTL_S + 10
    with open(cf, "w") as f:
        json.dump(data, f)
    assert selfcheck.load_verdict(cf, "kfail") is None  # failure expired
    assert selfcheck.load_verdict(cf, "kpass")["ok"] is True  # pass kept


def test_selfcheck_cached_pass_spot_checked(tmp_path, monkeypatch):
    """A cached PASS verdict no longer short-circuits blindly: a 2-block
    spot check runs against the oracle (a miscompile need not be
    deterministic), and a contradicted cache triggers the full re-check."""
    import jax.numpy as jnp

    from bfir_tpu.core.spec import FilterSpec
    from bfir_tpu.engine import selfcheck

    spec = FilterSpec(block_length=64, n_partitions=2, dtype="float32")
    c = 2
    h = np.zeros((c, spec.max_taps), np.float32)
    h[:, 0] = 1.0  # dirac

    def good_step(st, co, blk):
        return st, jnp.asarray(blk)

    calls = {"n": 0}

    def bad_step(st, co, blk):  # intermittent corruption class
        calls["n"] += 1
        return st, jnp.asarray(blk) + 0.05

    init = lambda: None
    cf = str(tmp_path / "v.json")
    # first run populates the cache
    s1 = selfcheck.check_stream(good_step, init, None, h, spec, c,
                                cache_file=cf, label="x")
    assert s1 > 100
    # second run with a still-good graph: cached pass + passing spot check
    s2 = selfcheck.check_stream(good_step, init, None, h, spec, c,
                                cache_file=cf, label="x")
    assert s2 == s1
    # now the compiled graph goes bad while the cache says ok: the spot
    # check contradicts it and the full check refuses the engine
    with pytest.raises(selfcheck.EngineSelfCheckError):
        selfcheck.check_stream(bad_step, init, None, h, spec, c,
                               cache_file=cf, label="x")
    assert calls["n"] >= 2  # spot check + full check both streamed
