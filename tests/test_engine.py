"""Engine layer: cache, chain composition, streaming session."""

import numpy as np
import pytest
from scipy import signal

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
from bfir_tpu.engine.chain import build_chain
from bfir_tpu.engine.session import StreamProcessor
from bfir_tpu.io import wavio


@pytest.fixture
def cache(tmp_path):
    return ArtifactCache(str(tmp_path / "profile"))


def save_impulse(tmp_path, name, imp, rate=44100):
    p = str(tmp_path / name)
    wavio.write(p, np.asarray(imp).T, rate, subtype="float64")
    return p


def make_config(tmp_path, files=(), eq_enabled=False, eq_mags=None, block=256,
                dtype="float64", dither=False, out_format=SampleFormat.FLOAT_LE,
                eq_blocks=8):
    fspecs = []
    for fname, level, resamp in files:
        fspecs.append(ImpulseFileSpec(enabled=True, filename=fname,
                                      level_steps=level, resample=resamp))
    while len(fspecs) < 3:
        fspecs.append(ImpulseFileSpec())
    return EngineConfig(
        filter=FilterSpec(block_length=block, n_partitions=1, dtype=dtype),
        stream=StreamSpec(n_channels=2, sample_rate=44100,
                          out_format=out_format, apply_dither=dither),
        chain=ChainSpec(
            eq=EqSpec(enabled=eq_enabled, mag_steps=tuple(eq_mags or [0] * 31)),
            files=tuple(fspecs),
        ),
        eq_filter_blocks=eq_blocks,
    )


# -- cache ------------------------------------------------------------------


def test_cache_filenames_scheme(cache):
    p = cache.eq_filename([20.0], [0.0], [0.0], 512, 8, 2, 44100)
    assert "/temp/eq-" in p and p.endswith("-512-8-2-44100.wav")
    p = cache.resampled_filename("/a/b.wav", 2, 96000)
    assert "/temp/ir-" in p and p.endswith("-2-96000.wav")
    p = cache.preconvolved_filename(["a", "b"], 1000, 8, 2, 44100)
    assert "/temp/file-" in p and p.endswith("-1000-8-2-44100.wav")


def test_cache_clean_temp(cache):
    p = cache.temp_path("x.txt")
    open(p, "w").write("hi")
    cache.clean_temp()
    import os

    assert not os.path.exists(p)
    assert os.path.isdir(cache.temp)


# -- chain ------------------------------------------------------------------


def test_chain_inactive(cache, tmp_path):
    cfg = make_config(tmp_path)
    built = build_chain(cfg, cfg.stream, cache)
    assert built.impulse is None


def test_chain_single_file(cache, tmp_path):
    rng = np.random.default_rng(0)
    imp = rng.standard_normal((2, 300)) * 0.1
    p = save_impulse(tmp_path, "a.wav", imp)
    cfg = make_config(tmp_path, files=[(p, 60, False)])  # +6 dB level
    built = build_chain(cfg, cfg.stream, cache)
    np.testing.assert_allclose(built.impulse, imp, atol=1e-12)
    np.testing.assert_allclose(built.scale, 10 ** (6.0 / 20.0))
    assert built.n_partitions == 2  # ceil(300/256)


def test_chain_two_files_composed(cache, tmp_path):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 200)) * 0.2
    b = rng.standard_normal((2, 150)) * 0.2
    pa = save_impulse(tmp_path, "a.wav", a)
    pb = save_impulse(tmp_path, "b.wav", b)
    cfg = make_config(tmp_path, files=[(pa, 0, False), (pb, 20, False)])
    built = build_chain(cfg, cfg.stream, cache)
    # composition = (a * b*scale_b) truncated to max(200, 150)
    scale_b = 10 ** (2.0 / 20.0)
    ref = np.stack([np.convolve(a[c], b[c] * scale_b)[:200] for c in range(2)])
    assert built.impulse.shape == (2, 200)
    np.testing.assert_allclose(built.impulse, ref, atol=1e-10)
    assert built.scale == 1.0


def test_chain_rate_mismatch_drops_without_flag(cache, tmp_path):
    imp = np.ones((2, 100)) * 0.1
    p = save_impulse(tmp_path, "wrong_rate.wav", imp, rate=48000)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    built = build_chain(cfg, cfg.stream, cache)
    assert built.impulse is None  # dropped (foo_dsp_bfir.cpp:183-190)


def test_chain_rate_mismatch_resamples_with_flag(cache, tmp_path):
    imp = np.zeros((2, 480))
    imp[:, 0] = 0.5
    p = save_impulse(tmp_path, "rs.wav", imp, rate=48000)
    cfg = make_config(tmp_path, files=[(p, 0, True)])
    built = build_chain(cfg, cfg.stream, cache)
    assert built.impulse is not None
    assert built.impulse.shape[1] == 441  # 480 * 44100/48000
    # and the resampled artifact is cached
    import os

    assert os.path.exists(cache.resampled_filename(p, 2, 44100))


def test_chain_mono_impulse_broadcast(cache, tmp_path):
    imp = np.zeros((1, 64))
    imp[0, 0] = 1.0
    p = save_impulse(tmp_path, "mono.wav", imp)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    built = build_chain(cfg, cfg.stream, cache)
    assert built.impulse.shape == (2, 64)


def test_chain_eq_rendered_and_cached(cache, tmp_path):
    cfg = make_config(tmp_path, eq_enabled=True, eq_mags=[0] * 31)
    built = build_chain(cfg, cfg.stream, cache)
    taps_half = cfg.filter.block_length * cfg.eq_filter_blocks // 2
    assert built.impulse.shape == (2, taps_half)
    # flat EQ -> near-dirac
    assert abs(built.impulse[0, 0] - 1.0) < 1e-6
    import glob

    assert glob.glob(str(cache.temp / "eq-*.wav"))


# -- session ----------------------------------------------------------------


def test_session_passthrough_when_unconfigured(tmp_path):
    cfg = make_config(tmp_path)
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "p")))
    x = np.random.default_rng(0).standard_normal((2, 1000))
    y = sp.process(x)
    np.testing.assert_array_equal(y, x)


def test_session_filters_and_reblocks(cache, tmp_path):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "h.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 2000))
    # push in awkward chunk sizes
    outs = [sp.process(x[:, :100]), sp.process(x[:, 100:700]), sp.process(x[:, 700:2000])]
    y = np.concatenate([o for o in outs if o.size], axis=1)
    # 2000 frames -> 7 complete blocks of 256 = 1792 output frames
    assert y.shape == (2, 1792)
    ref = np.stack([signal.fftconvolve(x[c], h[c])[:1792] for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-10)
    # flush drops the partial 208 frames
    sp.flush()
    y2 = sp.process(x[:, :256])
    assert y2.shape == (2, 256)


def test_session_reinit_on_channel_change(cache, tmp_path):
    h = np.zeros((2, 10))
    h[:, 0] = 1.0
    p = save_impulse(tmp_path, "d.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    sp = StreamProcessor(cfg, cache)
    x2 = np.random.default_rng(3).standard_normal((2, 512))
    y = sp.process(x2)
    assert y.shape == (2, 512)
    # switch to 3 channels: impulse has 2 channels -> chain drops -> passthrough
    x3 = np.random.default_rng(4).standard_normal((3, 512))
    y3 = sp.process(x3)
    np.testing.assert_array_equal(y3, x3)


def test_session_nan_abort_to_passthrough(cache, tmp_path):
    h = np.zeros((2, 10))
    h[:, 0] = 1.0
    p = save_impulse(tmp_path, "d2.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    sp = StreamProcessor(cfg, cache)
    x = np.full((2, 256), np.nan)
    y = sp.process(x)
    assert y.shape == (2, 256)
    # engine is now in failed/passthrough mode
    x2 = np.ones((2, 256))
    y2 = sp.process(x2)
    np.testing.assert_array_equal(y2, x2)


def test_session_overflow_accounting(cache, tmp_path):
    h = np.zeros((2, 4))
    h[:, 0] = 10.0  # +20 dB -> guaranteed overflow vs float full scale
    p = save_impulse(tmp_path, "hot.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    sp = StreamProcessor(cfg, cache)
    sp.process(np.ones((2, 512)))
    of = sp.overflow_stats()
    assert int(of.n_overflows[0]) > 0
    assert float(of.largest[0]) > 9.0


def test_session_raw_path_s16_dither(cache, tmp_path):
    h = np.zeros((2, 4))
    h[:, 0] = 0.5
    p = save_impulse(tmp_path, "half.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)],
                      out_format=SampleFormat.S16_LE, dither=True)
    sp = StreamProcessor(cfg, cache)
    from bfir_tpu.ops import formats as fm

    x = (np.random.default_rng(5).uniform(-0.5, 0.5, (2, 512))).astype(np.float64)
    raw_in = fm.encode_float(x, SampleFormat.FLOAT_LE)
    raw_out = sp.process_raw(raw_in)
    y = fm.decode(raw_out, SampleFormat.S16_LE, 2)
    np.testing.assert_allclose(y, 0.5 * x, atol=5 / 32768.0)


def test_session_reconfigure(cache, tmp_path):
    cfg = make_config(tmp_path)
    sp = StreamProcessor(cfg, cache)
    x = np.ones((2, 512)) * 0.1
    np.testing.assert_array_equal(sp.process(x), x)  # passthrough
    h = np.zeros((2, 4))
    h[:, 0] = 2.0
    p = save_impulse(tmp_path, "g.wav", h)
    sp.reconfigure(make_config(tmp_path, files=[(p, 0, False)]))
    y = sp.process(x)
    np.testing.assert_allclose(y, 0.2 * np.ones((2, 512)), atol=1e-12)


def test_session_packed_engine_mode(cache, tmp_path):
    import dataclasses

    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "hp.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="packed")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 1024))
    y = sp.process(x)
    assert sp._impl == "packed"
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]] for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-9)
    # process_buffer falls back to the block loop on packed engines
    y2 = sp.process_buffer(rng.standard_normal((2, 512)))
    assert y2.shape == (2, 512)


def test_session_hc_engine_mode(cache, tmp_path):
    import dataclasses

    rng = np.random.default_rng(21)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "hh.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="hc")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 1024))
    y = sp.process(x)
    assert sp._impl == "hc"
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]] for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-9)
    # process_buffer falls back to the block loop on hc engines
    y2 = sp.process_buffer(rng.standard_normal((2, 512)))
    assert y2.shape == (2, 512)


def test_session_extended_engine_mode(cache, tmp_path):
    import dataclasses

    rng = np.random.default_rng(23)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "he.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="extended")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 1024))
    y = sp.process(x)
    assert sp._impl == "extended"
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]] for c in range(2)])
    # df64 path: f64-class accuracy, far tighter than the f32 paths' 1e-9
    np.testing.assert_allclose(y, ref, atol=1e-11)
    # crossfade reconfigure stays glitch-free on the extended path
    h2 = h * 0.5
    p2 = save_impulse(tmp_path, "he2.wav", h2)
    sp.reconfigure(dataclasses.replace(
        make_config(tmp_path, files=[(p2, 0, False)]), engine_mode="extended"))
    assert sp._pending_swap is not None, "extended path must crossfade"
    y2 = sp.process(x)
    assert y2.shape == x.shape


def test_session_nonuniform_engine_mode(cache, tmp_path):
    """engine_mode="nonuniform": two-stage engine behind the session
    surface, including the multi-block crossfade transition and the
    process_buffer scan path."""
    import dataclasses

    rng = np.random.default_rng(31)
    taps = 6100  # > head coverage (16 x 256 = 4096): tail stage engaged
    h = (rng.standard_normal((2, taps)) *
         np.exp(-np.arange(taps) / 2000.0)) * 0.05
    p = save_impulse(tmp_path, "hnu.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="nonuniform")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 40 * 256))
    y = sp.process(x)
    assert sp._impl == "nonuniform"
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]] for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-9 * np.abs(ref).max())

    # live reconfigure: head ramps in-block, tail bridges at its next fire;
    # stream must converge exactly to the new filter
    h2 = h[:, ::-1].copy()
    p2 = save_impulse(tmp_path, "hnu2.wav", h2)
    sp.reconfigure(dataclasses.replace(
        make_config(tmp_path, files=[(p2, 0, False)]), engine_mode="nonuniform"))
    assert sp._pending_swap is not None, "nonuniform path must crossfade"
    x2 = rng.standard_normal((2, 60 * 256))
    y2 = sp.process(x2)
    assert sp._nu_old is None, "transition must have completed"
    nu = sp._nuspec
    settle = (nu.ratio * (nu.delay_blocks + 2) + nu.p_head) * 256
    full = np.concatenate([x, x2], axis=1)
    ref2 = np.stack([signal.fftconvolve(full[c], h2[c]) for c in range(2)])
    ref2 = ref2[:, x.shape[1]: x.shape[1] + y2.shape[1]]
    np.testing.assert_allclose(y2[:, settle:], ref2[:, settle:],
                               atol=1e-9 * np.abs(ref2).max())

    # bulk path uses the nu scan
    y3 = sp.process_buffer(rng.standard_normal((2, 8 * 256)))
    assert y3.shape == (2, 8 * 256)


def test_session_nonuniform_short_filter_falls_back(cache, tmp_path):
    """A filter that fits in the head stage falls through to 'hc'/'complex'
    instead of paying two-stage overhead."""
    import dataclasses

    rng = np.random.default_rng(33)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "hns.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="nonuniform")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 1024))
    y = sp.process(x)
    assert sp._impl in ("hc", "complex")
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]] for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-9)


def test_engine_mode_validation():
    import dataclasses
    import pytest as _pytest

    with _pytest.raises(ValueError):
        EngineConfig(engine_mode="nope")
    with _pytest.raises(ValueError):
        EngineConfig(nu_tail_store="int8")


def test_session_nu_tail_store_reachable(cache, tmp_path):
    """EngineConfig.nu_tail_store="bfloat16" must reach the nonuniform
    engine's geometry (the option existed but no user
    could turn it on) and stream within its documented precision class
    (~56 dB + tail energy deficit; self-check gate relaxed to 35 dB)."""
    import dataclasses

    rng = np.random.default_rng(37)
    taps = 6100  # tail stage engaged (head covers 16 x 256 = 4096)
    h = (rng.standard_normal((2, taps)) *
         np.exp(-np.arange(taps) / 2000.0)) * 0.05
    p = save_impulse(tmp_path, "hbf.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="nonuniform",
                              nu_tail_store="bfloat16")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 40 * 256))
    y = sp.process(x)
    assert sp._impl == "nonuniform"
    assert sp._nuspec.tail_store == "bfloat16"
    import jax.numpy as jnp

    assert sp._state.tail.ring.dtype == jnp.bfloat16
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]] for c in range(2)])
    err = np.abs(y - ref)
    snr = 10 * np.log10(float((ref**2).sum()) / float((err**2).sum()))
    # pin the BAND, not just the floor: the bf16 tail's
    # documented class is ~56 dB + tail energy deficit. Below 50 means the
    # implementation degraded toward the relaxed 35 dB self-check gate
    # (where a real miscompile could hide); above 100 means the bf16 store
    # silently stopped being applied (f32 would read ~130 dB).
    assert 50 < snr < 100, snr


def test_process_buffer_first_call_on_packed_engine(cache, tmp_path):
    # review regression: process_buffer as the FIRST call on a packed-mode
    # engine decided its fallback on the stale pre-init _impl and crashed
    import dataclasses

    rng = np.random.default_rng(13)
    h = rng.standard_normal((2, 100)) * 0.05
    p = save_impulse(tmp_path, "pk.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="packed")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 512))
    y = sp.process_buffer(x)  # must not crash
    assert sp._impl == "packed"
    ref = np.stack([signal.fftconvolve(x[c], h[c])[:512] for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-9)


def test_process_raw_passthrough_int_format(tmp_path):
    # review regression: inactive chain + integer out_format crashed on
    # uninitialized overflow/dither state
    from bfir_tpu.ops import formats as fm

    cfg = make_config(tmp_path, out_format=SampleFormat.S16_LE, dither=True)
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "pc")))
    x = (np.random.default_rng(14).uniform(-0.4, 0.4, (2, 256))).astype(np.float64)
    raw_in = fm.encode_float(x, SampleFormat.FLOAT_LE)
    raw_out = sp.process_raw(raw_in)  # passthrough, quantized
    y = fm.decode(raw_out, SampleFormat.S16_LE, 2)
    np.testing.assert_allclose(y, x, atol=5 / 32768.0)


def test_composition_equals_blockwise_streaming_method():
    # SURVEY.md §3.5: the reference composes impulse chains by streaming one
    # impulse through a brutefir instance whose coefficients are the other
    # (preprocessor.cpp:104-194). Our chain.py uses one direct spectral
    # multiply. Emulate the reference's block-streamed method with our own
    # engine and verify both agree on the kept (truncated) region.
    from bfir_tpu.core import convolver as cv
    from bfir_tpu.core.spec import FilterSpec

    rng = np.random.default_rng(20)
    n = 64
    a = rng.standard_normal(200) * 0.3   # running coeff set
    b = rng.standard_normal(150) * 0.3   # impulse streamed through
    length = 256  # next multiple of n covering max(200,150)
    blocks = length // n

    # reference method: stream b (padded to length) through a filter whose
    # coeffs are a (padded), collecting `blocks` output blocks
    spec = FilterSpec(block_length=n, n_partitions=blocks, dtype="float64")
    st = cv.init_state(spec, 1)
    co = cv.coeffs_to_spectra(a, spec)
    b_pad = np.zeros(length)
    b_pad[: b.size] = b
    outs = []
    for k in range(blocks):
        st, o = cv.step(st, co, b_pad[None, k * n : (k + 1) * n])
        outs.append(np.asarray(o)[0])
    streamed = np.concatenate(outs)

    direct = np.asarray(
        cv.direct_convolve_spectra(a, b, max_taps=length, dtype=np.float64))
    np.testing.assert_allclose(streamed, direct[:length], atol=1e-10)


def test_selfcheck_verdict_cache(cache, tmp_path, monkeypatch):
    """A second session build with identical (backend, source, geometry,
    coefficients) must skip the known-answer run entirely (the nonuniform
    check streams 32 blocks per session init)."""
    import dataclasses
    import os

    from bfir_tpu.engine import selfcheck

    rng = np.random.default_rng(41)
    h = rng.standard_normal((2, 900)) * 0.05
    p = save_impulse(tmp_path, "hck.wav", h)
    cfg = dataclasses.replace(make_config(tmp_path, files=[(p, 0, False)]),
                              engine_mode="packed")

    calls = []
    real_oracle = selfcheck._oracle
    monkeypatch.setattr(selfcheck, "_oracle",
                        lambda *a, **k: calls.append(1) or real_oracle(*a, **k))

    sp1 = StreamProcessor(cfg, cache)
    sp1.process(np.zeros((2, 256)))
    assert sp1._impl == "packed"
    n_first = len(calls)
    assert n_first >= 1
    assert os.path.exists(cache.path("selfcheck-cache.json"))

    sp2 = StreamProcessor(cfg, cache)
    sp2.process(np.zeros((2, 256)))
    assert sp2._impl == "packed"
    # the cached pass skips the FULL stream but still runs the 2-block spot
    # check (one extra oracle call — the r4 non-determinism guard)
    assert len(calls) == n_first + 1, \
        "second build must hit the verdict cache (full check skipped)"

    # different coefficients -> different key -> check runs again
    h2 = h * 0.5
    p2 = save_impulse(tmp_path, "hck2.wav", h2)
    cfg2 = dataclasses.replace(make_config(tmp_path, files=[(p2, 0, False)]),
                               engine_mode="packed")
    sp3 = StreamProcessor(cfg2, cache)
    sp3.process(np.zeros((2, 256)))
    assert len(calls) > n_first + 1, "new coefficients must re-run the check"


def test_auto_mode_prefers_nonuniform_for_long_filters(monkeypatch, tmp_path):
    """On an accelerator (the backend mocked as the GPU) auto mode must
    pick the two-stage engine above the partition threshold and hc below
    it; on the CPU the complex engine."""
    import jax as _jax

    cfg = make_config(tmp_path, dtype="float32")
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "p")))
    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    sp.n_partitions = 128
    assert sp._resolve_engine_mode() == "nonuniform"
    sp.n_partitions = 8
    assert sp._resolve_engine_mode() == "hc"
    monkeypatch.setattr(_jax, "default_backend", lambda: "cpu")
    sp.n_partitions = 128
    assert sp._resolve_engine_mode() == "complex"


def test_session_nonuniform3_engine_mode(cache, tmp_path):
    """engine_mode="nonuniform3": the recursively composed three-stage
    engine behind the session surface, including the bulk scan and the
    rebuild-on-reconfigure divergence (no three-stage crossfade yet)."""
    import dataclasses

    rng = np.random.default_rng(61)
    taps = 40000  # > two-stage coverage at block 256 (16*256 + 16*2048)
    h = (rng.standard_normal((2, taps)) *
         np.exp(-np.arange(taps) / 9000.0)) * 0.05
    p = save_impulse(tmp_path, "hnu3.wav", h)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="nonuniform3")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 160 * 256)).astype(np.float32)
    y = sp.process(x)
    assert sp._impl == "nonuniform3", sp._impl
    assert sp._nuspec.inner.block_length == 8 * 256
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr

    # bulk path: super-cycle-aligned buffers take the cond-free scan
    sp.reset()
    x2 = rng.standard_normal((2, 128 * 256)).astype(np.float32)  # 2 supers
    y2 = sp.process_buffer(x2)
    ref2 = np.stack([signal.fftconvolve(x2[c], h[c])[: y2.shape[1]]
                     for c in range(2)])
    snr2 = 10 * np.log10(float((ref2**2).sum()) / float(((y2 - ref2)**2).sum()))
    assert snr2 > 100, snr2

    # reconfigure: same geometry queues the staged crossfade (r4 — the
    # full transition is exercised in
    # test_session_nonuniform3_reconfigure_crossfade)
    h2 = h * 0.5
    p2 = save_impulse(tmp_path, "hnu3b.wav", h2)
    sp.reconfigure(dataclasses.replace(
        make_config(tmp_path, files=[(p2, 0, False)], dtype="float32"),
        engine_mode="nonuniform3"))
    assert sp._pending_swap is not None
    y3 = sp.process(x[:, :4 * 256])
    assert sp._impl == "nonuniform3"
    assert y3.shape == (2, 4 * 256)


def test_session_nonuniform3_short_falls_back(cache, tmp_path):
    """A filter two stages cover falls through to 'nonuniform'."""
    import dataclasses

    rng = np.random.default_rng(62)
    h = rng.standard_normal((2, 20000)) * 0.05
    p = save_impulse(tmp_path, "hns3.wav", h)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="nonuniform3")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 40 * 256))
    y = sp.process(x)
    assert sp._impl == "nonuniform", sp._impl
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr


def test_auto_mode_prefers_nonuniform3_for_very_long_filters(monkeypatch, tmp_path):
    import jax as _jax

    cfg = make_config(tmp_path, dtype="float32")
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "p3")))
    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    sp.n_partitions = 640
    assert sp._resolve_engine_mode() == "nonuniform3"
    sp.n_partitions = 512
    assert sp._resolve_engine_mode() == "nonuniform"


def test_pipelined_nan_abort_loses_no_samples(cache, tmp_path):
    """A NaN abort inside the pipelined drain must pass the
    offending block AND every later already-dispatched block through
    (reference semantics, brutefir.cpp:313-321) — no input samples vanish."""
    h = np.zeros((2, 10))
    h[:, 0] = 1.0  # dirac: filtered output == input, so y == x throughout
    p = save_impulse(tmp_path, "dpipe.wav", h)
    cfg = make_config(tmp_path, files=[(p, 0, False)])
    sp = StreamProcessor(cfg, cache)
    rng = np.random.default_rng(77)
    x = rng.standard_normal((2, 8 * 256))
    x[:, 3 * 256] = np.nan  # first sample of block 3 trips the guard
    y = sp.process(x)
    assert y.shape == x.shape  # blocks 3..7 passthrough, nothing dropped
    # filtered blocks are FFT-approximate; passthrough blocks are bit-exact
    np.testing.assert_allclose(y, x, atol=1e-9)
    np.testing.assert_array_equal(y[:, 3 * 256:], x[:, 3 * 256:])
    assert sp._failed


def test_session_nonuniform3_reconfigure_crossfade(cache, tmp_path):
    """Live filter change on the three-stage engine is glitch-free: the
    session drives the staged transition (outer head ramp
    -> inner ramp -> far bridging) and converges to the new filter, with no
    full rebuild (state and warm history preserved)."""
    import dataclasses

    rng = np.random.default_rng(63)
    block = 64
    # smallest geometry the session's nu3 auto-build accepts at this block
    taps = 16 * block + 16 * (8 * block) + 4 * (64 * block) + 100
    h1 = (rng.standard_normal((2, taps)) * 0.05).astype(np.float64)
    h2 = (rng.standard_normal((2, taps)) * 0.05).astype(np.float64)
    p1 = save_impulse(tmp_path, "nu3a.wav", h1)
    p2 = save_impulse(tmp_path, "nu3b.wav", h2)

    def cfg(path):
        return dataclasses.replace(
            make_config(tmp_path, files=[(path, 0, False)], block=block,
                        dtype="float32"),
            engine_mode="nonuniform3")

    sp = StreamProcessor(cfg(p1), cache)
    nwarm = 80
    x1 = rng.standard_normal((2, nwarm * block))
    y1 = sp.process(x1)
    assert sp._impl == "nonuniform3", sp._impl
    state_before = sp._state
    sp.reconfigure(cfg(p2))
    assert sp._pending_swap is not None, "same geometry => transition queued"
    assert sp._state is state_before, "no rebuild on nu3 reconfigure"
    # far bridging lands within sup=64 blocks of the swap; its ramped
    # M2-block then drains through inner (D2) + outer (D1) pending queues
    # -- ~sup*(D1+D2+3) = 448 blocks; measure well past that
    ntail = 560
    x2 = rng.standard_normal((2, ntail * block))
    y2 = sp.process(x2)
    assert sp._nu_old is None, "transition must complete within the stream"
    x = np.concatenate([x1, x2], axis=1)
    y = np.concatenate([y1, y2], axis=1)
    ref2 = np.stack([signal.fftconvolve(x[c], h2[c])[: x.shape[1]]
                     for c in range(2)])
    seg = slice((nwarm + ntail - 32) * block, (nwarm + ntail) * block)
    num = float((ref2[:, seg] ** 2).sum())
    den = float(((y[:, seg] - ref2[:, seg]) ** 2).sum())
    snr = 10 * np.log10(num / max(den, 1e-30))
    assert snr > 100, snr


# -- per-channel output delay on the config surface -----------------------


def test_session_per_channel_integer_delay(cache, tmp_path):
    """EngineConfig.delay: integer per-channel delays applied at the engine
    output (the reference library's delay capability, delay.cpp:495-600,
    exposed on the config surface)."""
    import dataclasses

    from bfir_tpu.core.spec import DelaySpec

    rng = np.random.default_rng(70)
    h = rng.standard_normal((2, 300)) * 0.05
    p = save_impulse(tmp_path, "hdel.wav", h)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)]),
        delay=DelaySpec(enabled=True, samples=(7, 130)))
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 8 * 256))
    y = sp.process(x)
    base = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                     for c in range(2)])
    for c, d in enumerate((7, 130)):
        ref = np.concatenate([np.zeros(d), base[c][:-d]]) if d else base[c]
        np.testing.assert_allclose(y[c], ref, atol=1e-10,
                                   err_msg=f"channel {c} delay {d}")
    # bulk path agrees bit-for-bit with streaming
    sp2 = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "p2")))
    y2 = sp2.process_buffer(x)
    np.testing.assert_allclose(y2, y, atol=1e-12)


def test_session_fractional_delay(cache, tmp_path):
    """Fractional (subsample) delay: a pure sine through a dirac chain plus
    substep delay must match the analytically shifted sine (within the
    Kaiser-sinc interpolator's passband accuracy)."""
    import dataclasses

    from bfir_tpu.core.spec import DelaySpec

    h = np.zeros((2, 16))
    h[:, 0] = 1.0
    p = save_impulse(tmp_path, "dirfrac.wav", h)
    sub = 8  # 8/16 = half-sample delay
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)]),
        delay=DelaySpec(enabled=True, samples=(4,), subsample_steps=(sub,)))
    sp = StreamProcessor(cfg, cache)
    t = np.arange(16 * 256)
    f0 = 0.03  # cycles/sample, deep in the interpolator passband
    x = np.stack([np.sin(2 * np.pi * f0 * t)] * 2)
    y = sp.process(x)
    # total shift: 4 integer + 0.5 fractional + 16 (half_length latency)
    shift = 4 + sub / 16 + 16
    ref = np.sin(2 * np.pi * f0 * (t - shift))
    err = np.abs(y[0, 2048:] - ref[2048:]).max()
    assert err < 1e-3, err


def test_delay_live_value_change_and_spec_validation(cache, tmp_path):
    """Runtime delay changes apply without a rebuild (change_delay,
    delay.cpp:552-600) as long as they fit the built history."""
    import dataclasses

    from bfir_tpu.core.spec import DelaySpec

    h = np.zeros((2, 8))
    h[:, 0] = 1.0
    p = save_impulse(tmp_path, "dirdel.wav", h)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)]),
        delay=DelaySpec(enabled=True, samples=(64, 64)))
    sp = StreamProcessor(cfg, cache)
    x = np.arange(1.0, 2 * 256 + 1.0).reshape(1, -1).repeat(2, axis=0)
    y1 = sp.process(x)
    np.testing.assert_allclose(y1[:, 64:], x[:, :-64], atol=1e-10)
    state_before = sp._state
    sp.reconfigure(dataclasses.replace(
        cfg, delay=DelaySpec(enabled=True, samples=(16, 16))))
    assert sp._state is state_before, "delay value change must not rebuild"
    # spec validation
    with pytest.raises(ValueError):
        DelaySpec(enabled=True, samples=(-1,))
    with pytest.raises(ValueError):
        DelaySpec(enabled=True, subsample_steps=(16,), step_count=16)
    with pytest.raises(ValueError):
        DelaySpec(enabled=True, samples=(1, 2, 3)).per_channel(2)
    # JSON round-trip carries the delay spec
    from bfir_tpu.core.spec import engine_config_from_json, to_json

    cfg2 = engine_config_from_json(to_json(cfg))
    assert cfg2.delay == cfg.delay


def test_session_shared_coeffs_for_identical_channels(cache, tmp_path):
    """A chain whose channels share one filter (e.g. mono impulse broadcast,
    EQ-only chains) builds SHARED coefficient planes — [P, 2, Hp] instead of
    [P, 2C, Hp], 1/C the coefficient memory traffic — and streams identically."""
    import dataclasses

    rng = np.random.default_rng(97)
    h1 = rng.standard_normal((1, 900)) * 0.05  # mono -> broadcast by chain
    p = save_impulse(tmp_path, "mono_sh.wav", h1)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="hc")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 12 * 256))
    y = sp.process(x)
    assert sp._impl == "hc"
    assert sp._coeffs.shape[1] == 2, sp._coeffs.shape  # shared planes
    ref = np.stack([signal.fftconvolve(x[c], h1[0])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr

    # distinct-channel chains keep full planes
    h2 = rng.standard_normal((2, 900)) * 0.05
    p2 = save_impulse(tmp_path, "st_sh.wav", h2)
    sp2 = StreamProcessor(dataclasses.replace(
        make_config(tmp_path, files=[(p2, 0, False)], dtype="float32"),
        engine_mode="hc"), ArtifactCache(str(tmp_path / "p2")))
    sp2.process(x)
    assert sp2._coeffs.shape[1] == 4  # 2C


def test_session_shared_coeffs_nonuniform(cache, tmp_path):
    """Shared planes thread through the two-stage engine (head + tail)."""
    import dataclasses

    rng = np.random.default_rng(98)
    taps = 16 * 256 + 3 * 8 * 256 + 10
    h1 = (rng.standard_normal((1, taps)) *
          np.exp(-np.arange(taps) / 3000.0)) * 0.05
    p = save_impulse(tmp_path, "mono_nu.wav", h1)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="nonuniform")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 40 * 256))
    y = sp.process(x)
    assert sp._impl == "nonuniform"
    assert sp._coeffs.head.shape[1] == 2 and sp._coeffs.tail.shape[1] == 2
    ref = np.stack([signal.fftconvolve(x[c], h1[0])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 100, snr


def test_nu_tail_store_auto_resolution(cache, tmp_path, monkeypatch):
    """nu_tail_store="auto" resolves through utils.platform: float32 on
    the CPU; on the GPU int24 for the single-device two-stage engine
    (measured faster there) and float32 for every other engine."""
    from bfir_tpu.engine import session as S

    cfg = make_config(tmp_path)
    sp = StreamProcessor(cfg, cache)
    assert sp.config.nu_tail_store == "auto"
    assert sp._resolve_nu_tail_store("nonuniform") == "float32"  # CPU
    monkeypatch.setattr(S.jax, "default_backend", lambda: "gpu")
    assert sp._resolve_nu_tail_store("nonuniform") == "int24"
    assert sp._resolve_nu_tail_store("sharded") == "float32"
    assert sp._resolve_nu_tail_store("nonuniform3") == "float32"
    # explicit values pass through untouched
    import dataclasses

    sp2 = StreamProcessor(dataclasses.replace(cfg, nu_tail_store="bfloat16"),
                          cache)
    assert sp2._resolve_nu_tail_store("nonuniform") == "bfloat16"


def test_session_nonuniform_split_engine_mode(cache, tmp_path):
    """engine_mode="nonuniform_split": the latency-smooth split-tail
    schedule behind the session surface (per-block switch steps + aligned
    bulk scan), scipy-verified; reconfigure is rebuild-only."""
    import dataclasses

    rng = np.random.default_rng(62)
    taps = 7000  # > head coverage at block 256 (16*256)
    h = rng.standard_normal((2, taps)) * 0.05
    p = save_impulse(tmp_path, "hsplit.wav", h)
    cfg = dataclasses.replace(
        make_config(tmp_path, files=[(p, 0, False)], dtype="float32"),
        engine_mode="nonuniform_split")
    sp = StreamProcessor(cfg, cache)
    x = rng.standard_normal((2, 48 * 256)).astype(np.float32)
    y = sp.process(x)
    assert sp._impl == "nonuniform_split", sp._impl
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                    for c in range(2)])
    snr = 10 * np.log10(float((ref**2).sum()) / float(((y - ref)**2).sum()))
    assert snr > 110, snr

    # bulk path: aligned buffers take the cond-free scan
    sp.reset()
    x2 = rng.standard_normal((2, 64 * 256)).astype(np.float32)
    y2 = sp.process_buffer(x2)
    ref2 = np.stack([signal.fftconvolve(x2[c], h[c])[: y2.shape[1]]
                     for c in range(2)])
    snr2 = 10 * np.log10(float((ref2**2).sum())
                         / float(((y2 - ref2)**2).sum()))
    assert snr2 > 110, snr2

    # reconfigure = rebuild (no split crossfade)
    h2 = h * 0.5
    p2 = save_impulse(tmp_path, "hsplit2.wav", h2)
    sp.reconfigure(dataclasses.replace(
        make_config(tmp_path, files=[(p2, 0, False)], dtype="float32"),
        engine_mode="nonuniform_split"))
    assert sp._pending_swap is None
    y3 = sp.process(x[:, : 24 * 256])
    assert sp._impl == "nonuniform_split"
    assert y3.shape == (2, 24 * 256)
