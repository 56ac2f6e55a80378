import numpy as np
import pytest

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import SampleFormat, FilterSpec
from bfir_tpu.io import coeffio
from bfir_tpu.ops import formats as fm


# -- coeff loaders (coeff.cpp:32-277) ---------------------------------------


def test_load_dirac():
    h = coeffio.load_dirac(3, 64)
    assert h.shape == (3, 64)
    assert (h[:, 0] == 1.0).all() and np.abs(h).sum() == 3.0


def test_load_text(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("# comment\n0.5\n-0.25\n0.125 0.0625\n\n; also comment\n1e-3\n")
    h = coeffio.load_text(str(p))
    np.testing.assert_allclose(h[0], [0.5, -0.25, 0.125, 0.0625, 1e-3])
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.raises(ValueError):
        coeffio.load_text(str(tmp_path / "empty.txt"))


def test_load_raw(tmp_path):
    rng = np.random.default_rng(0)
    q = rng.integers(-32768, 32768, size=(1, 100), dtype=np.int64).astype(np.int32)
    raw = fm.encode_int(q, SampleFormat.S16_LE)
    p = tmp_path / "c.raw"
    p.write_bytes(raw)
    h = coeffio.load_raw(str(p), SampleFormat.S16_LE)
    np.testing.assert_allclose(h * 32768.0, q)


def test_load_sound(tmp_path):
    from bfir_tpu.io import wavio

    imp = np.random.default_rng(1).standard_normal((2, 50)) * 0.1
    p = str(tmp_path / "c.wav")
    wavio.write(p, imp.T, 44100, subtype="float64")
    h = coeffio.load_sound(p)
    np.testing.assert_allclose(h, imp, atol=1e-12)
    assert coeffio.load_sound(p, max_taps=20).shape == (2, 20)


# -- crossfade (fftw_convolver.cpp:275-321 semantics at step level) ----------


def test_step_crossfade_endpoints():
    rng = np.random.default_rng(2)
    spec = FilterSpec(block_length=128, n_partitions=2, dtype="float64")
    h_old = np.zeros(64); h_old[0] = 1.0      # identity
    h_new = np.zeros(64); h_new[0] = 0.5      # -6 dB
    co_old = cv.coeffs_to_spectra(h_old, spec)
    co_new = cv.coeffs_to_spectra(h_new, spec)
    st = cv.init_state(spec, 1)
    # warm up with the old filter
    x = rng.standard_normal((1, 128))
    st, _ = cv.step(st, co_old, x)
    blk = np.ones((1, 128))
    st2, out = cv.step_crossfade(st, co_old, co_new, blk)
    out = np.asarray(out)[0]
    # ramp: start == old filter output, end == new filter output
    np.testing.assert_allclose(out[0], 1.0, atol=1e-9)
    np.testing.assert_allclose(out[-1], 0.5, atol=1e-9)
    assert np.all(np.diff(out) <= 1e-9)  # monotone fade for constant input


def test_session_reconfigure_crossfades(tmp_path):
    from tests.test_engine import make_config, save_impulse
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    h1 = np.zeros((2, 8)); h1[:, 0] = 1.0
    h2 = np.zeros((2, 8)); h2[:, 0] = 0.25
    p1 = save_impulse(tmp_path, "a.wav", h1)
    p2 = save_impulse(tmp_path, "b.wav", h2)
    cache = ArtifactCache(str(tmp_path / "c"))
    sp = StreamProcessor(make_config(tmp_path, files=[(p1, 0, False)]), cache)
    x = np.ones((2, 256))
    y1 = sp.process(x)
    np.testing.assert_allclose(y1, 1.0, atol=1e-9)
    sp.reconfigure(make_config(tmp_path, files=[(p2, 0, False)]))
    y2 = sp.process(x)  # crossfade block then steady state
    # first block fades 1.0 -> 0.25, second block is fully the new filter
    assert abs(y2[0, 0] - 1.0) < 1e-6
    np.testing.assert_allclose(y2[:, 256:], 0.25, atol=1e-9) if y2.shape[1] > 256 else None
    y3 = sp.process(x)
    np.testing.assert_allclose(y3, 0.25, atol=1e-9)
    # no discontinuity: concatenated output is monotone during the fade
    seq = np.concatenate([y2[0], y3[0]])
    assert np.all(np.diff(seq) <= 1e-6)


def test_session_reconfigure_crossfades_packed(tmp_path):
    """Same crossfade semantics on the packed engine path — the session
    same-geometry check does not exclude packed."""
    import dataclasses

    from tests.test_engine import make_config, save_impulse
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    h1 = np.zeros((2, 8)); h1[:, 0] = 1.0
    h2 = np.zeros((2, 8)); h2[:, 0] = 0.25
    p1 = save_impulse(tmp_path, "a.wav", h1)
    p2 = save_impulse(tmp_path, "b.wav", h2)
    cache = ArtifactCache(str(tmp_path / "c"))
    mk = lambda p: dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="packed")
    sp = StreamProcessor(mk(p1), cache)
    x = np.ones((2, 256), dtype=np.float32)
    y1 = sp.process(x)
    assert sp._impl == "packed"
    np.testing.assert_allclose(y1, 1.0, atol=1e-5)
    sp.reconfigure(mk(p2))
    assert sp._pending_swap is not None, "packed path must crossfade, not rebuild"
    y2 = sp.process(x)
    assert abs(y2[0, 0] - 1.0) < 1e-4
    y3 = sp.process(x)
    np.testing.assert_allclose(y3, 0.25, atol=1e-5)
    seq = np.concatenate([y2[0], y3[0]])
    assert np.all(np.diff(seq) <= 1e-4)  # glitch-free monotone fade


def test_session_reconfigure_crossfades_hc(tmp_path):
    """Crossfade semantics on the halfcomplex engine path (auto's pick for
    short filters on an accelerator) — glitch-free live reconfigure."""
    import dataclasses

    from tests.test_engine import make_config, save_impulse
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    h1 = np.zeros((2, 8)); h1[:, 0] = 1.0
    h2 = np.zeros((2, 8)); h2[:, 0] = 0.25
    p1 = save_impulse(tmp_path, "a.wav", h1)
    p2 = save_impulse(tmp_path, "b.wav", h2)
    cache = ArtifactCache(str(tmp_path / "c"))
    mk = lambda p: dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="hc")
    sp = StreamProcessor(mk(p1), cache)
    x = np.ones((2, 256), dtype=np.float32)
    y1 = sp.process(x)
    assert sp._impl == "hc"
    np.testing.assert_allclose(y1, 1.0, atol=1e-5)
    sp.reconfigure(mk(p2))
    assert sp._pending_swap is not None, "hc path must crossfade, not rebuild"
    y2 = sp.process(x)
    assert abs(y2[0, 0] - 1.0) < 1e-4
    y3 = sp.process(x)
    np.testing.assert_allclose(y3, 0.25, atol=1e-5)
    seq = np.concatenate([y2[0], y3[0]])
    assert np.all(np.diff(seq) <= 1e-4)  # glitch-free monotone fade


def test_step_packed_crossfade_matches_complex():
    """Packed crossfade block == complex crossfade block to fp tolerance."""
    from bfir_tpu.kernels import spectrum_mac as K

    rng = np.random.default_rng(11)
    spec = FilterSpec(block_length=128, n_partitions=4, dtype="float32")
    c = 2
    h_old = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    h_new = (rng.standard_normal((c, spec.max_taps)) * 0.1).astype(np.float32)
    x = rng.standard_normal((c, 128 * 4)).astype(np.float32)

    st_c = cv.init_state(spec, c)
    co_old = cv.coeffs_to_spectra(h_old, spec)
    co_new = cv.coeffs_to_spectra(h_new, spec)
    st_p = K.init_packed_state(spec, c)
    pk_old = K.pack_coeffs(h_old, spec, c)
    pk_new = K.pack_coeffs(h_new, spec, c)

    for b in range(2):
        blk = x[:, b * 128 : (b + 1) * 128]
        st_c, ref = cv.step(st_c, co_old, blk)
        st_p, out = K.step_packed(st_p, pk_old, blk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    blk = x[:, 256:384]
    st_c, ref = cv.step_crossfade(st_c, co_old, co_new, blk)
    st_p, out = K.step_packed_crossfade(st_p, pk_old, pk_new, blk)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    blk = x[:, 384:]
    st_c, ref = cv.step(st_c, co_new, blk)
    st_p, out = K.step_packed(st_p, pk_new, blk)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_session_reconfigure_geometry_change_reinits(tmp_path):
    from tests.test_engine import make_config, save_impulse
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    h1 = np.zeros((2, 8)); h1[:, 0] = 1.0
    h_long = np.zeros((2, 400)); h_long[:, 0] = 0.5  # forces 2 partitions
    p1 = save_impulse(tmp_path, "a.wav", h1)
    p2 = save_impulse(tmp_path, "long.wav", h_long)
    cache = ArtifactCache(str(tmp_path / "c"))
    sp = StreamProcessor(make_config(tmp_path, files=[(p1, 0, False)]), cache)
    sp.process(np.ones((2, 256)))
    assert sp.n_partitions == 1
    sp.reconfigure(make_config(tmp_path, files=[(p2, 0, False)]))
    y = sp.process(np.ones((2, 256)))
    assert sp.n_partitions == 2
    np.testing.assert_allclose(y[:, -1], 0.5, atol=1e-9)


def test_spectra_to_impulse_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    spec = FilterSpec(block_length=64, n_partitions=3, dtype="float64")
    h = rng.standard_normal((2, 150))
    co = cv.coeffs_to_spectra(h, spec)
    back = np.asarray(cv.spectra_to_impulse(co, spec))
    assert back.shape == (2, 192)
    np.testing.assert_allclose(back[:, :150], h, atol=1e-12)
    np.testing.assert_allclose(back[:, 150:], 0.0, atol=1e-12)
    # debug dump -> text -> load roundtrip (fftw_convolver.cpp:604-651)
    p = str(tmp_path / "dump.txt")
    coeffio.dump_text(p, back)
    re = coeffio.load_text(p)
    np.testing.assert_allclose(re[0], back[0], atol=1e-15)


def test_stale_swap_voided_by_geometry_change(tmp_path):
    # regression: a queued same-geometry swap must not survive a later
    # geometry-changing reconfigure (found by the live TCP drive: EQM sets
    # queued swaps, then EQEN changed the partition count)
    import dataclasses

    from tests.test_engine import make_config, save_impulse
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    h = np.zeros((2, 8)); h[:, 0] = 1.0
    p1 = save_impulse(tmp_path, "a.wav", h)
    cache = ArtifactCache(str(tmp_path / "c"))
    cfg = make_config(tmp_path, files=[(p1, 0, False)])
    sp = StreamProcessor(cfg, cache)
    sp.process(np.ones((2, 256)))

    # queue a same-geometry swap (level change only)
    cfg2 = make_config(tmp_path, files=[(p1, -60, False)])
    sp.reconfigure(cfg2)
    assert sp._pending_swap is not None

    # then a geometry change (longer impulse -> more partitions)
    h_long = np.zeros((2, 500)); h_long[:, 0] = 0.5
    p2 = save_impulse(tmp_path, "b.wav", h_long)
    sp.reconfigure(make_config(tmp_path, files=[(p2, 0, False)]))
    y = sp.process(np.ones((2, 512)))  # must not crash on mismatched shapes
    assert np.isfinite(y).all()
    assert sp.n_partitions == 2
