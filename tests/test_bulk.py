"""Offline bulk rendering (core/bulk.py + StreamProcessor.render).

The bulk engine re-partitions the filter at a large block size and runs the
batched block-axis-FFT formulation; outputs must equal the exact linear
convolution (scipy float64 oracle) and the streaming engines' outputs.
Reference behavior: the reference reuses its streaming engine for offline
work (preprocessor.cpp:143-148); this path is the accelerator replacement.
"""

import numpy as np
import pytest
from scipy import signal

from bfir_tpu.core.bulk import BulkRenderer, BulkSpec, bulk_geometry
from bfir_tpu.core.spec import (
    ChainSpec,
    DelaySpec,
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


def _oracle(x, h):
    c = x.shape[0]
    hh = np.broadcast_to(np.atleast_2d(h), (c, np.atleast_2d(h).shape[-1]))
    return np.stack([
        signal.fftconvolve(x[i].astype(np.float64),
                           hh[i].astype(np.float64))[: x.shape[1]]
        for i in range(c)
    ])


def snr_db(y, ref):
    return 10 * np.log10(float((ref ** 2).sum())
                         / max(float(((y - ref) ** 2).sum()), 1e-300))


def test_bulk_geometry_flagship():
    g = bulk_geometry(131072)
    assert g.block_length == 8192
    assert g.n_partitions == 16
    assert g.batch_blocks == 30
    assert g.samples_per_dispatch == 245760


def test_bulk_geometry_short_filter():
    g = bulk_geometry(3000)
    assert g.block_length == 4096
    assert g.n_partitions == 1
    g2 = bulk_geometry(900)
    assert g2.block_length == 1024
    assert g2.n_partitions == 1


@pytest.mark.parametrize("t", [5000, 6144])  # non-multiple and exact multiple
def test_bulk_render_matches_scipy(t):
    rng = np.random.default_rng(5)
    c, taps = 3, 1800
    h = rng.standard_normal((c, taps)).astype(np.float64) * 0.1
    x = rng.standard_normal((c, t)).astype(np.float64)
    r = BulkRenderer(h, c, dtype="float64",
                     spec=BulkSpec(512, 4, 3, dtype="float64"))
    y = r.render(x)
    assert y.shape == x.shape
    assert snr_db(y, _oracle(x, h)) > 200  # f64 end to end


def test_bulk_render_shared_impulse_broadcasts():
    rng = np.random.default_rng(6)
    c, taps = 4, 700
    h = rng.standard_normal((1, taps)) * 0.2
    x = rng.standard_normal((c, 2500))
    r = BulkRenderer(h, c, dtype="float64",
                     spec=BulkSpec(256, 3, 4, dtype="float64"))
    y = r.render(x)
    assert snr_db(y, _oracle(x, h)) > 200


def test_bulk_render_scale_and_multibatch_state_continuity():
    """T spanning several dispatches: the ring state must thread through so
    partitions reach back across the batch boundary."""
    rng = np.random.default_rng(7)
    c, taps = 2, 2000
    h = rng.standard_normal((c, taps)) * 0.1
    x = rng.standard_normal((c, 9000))
    r = BulkRenderer(h, c, scale=0.5, dtype="float64",
                     spec=BulkSpec(512, 4, 2, dtype="float64"))  # 1024/dispatch
    y = r.render(x)
    assert snr_db(y, _oracle(x, h * 0.5)) > 200


# -- session integration ----------------------------------------------------


def _session_config(tmp_path, imp, block=256, delay=None, rate=44100):
    p = str(tmp_path / "imp.wav")
    wavio.write(p, np.asarray(imp).T, rate, subtype="float64")
    files = [ImpulseFileSpec(enabled=True, filename=p)]
    while len(files) < 3:
        files.append(ImpulseFileSpec())
    return EngineConfig(
        filter=FilterSpec(block_length=block, n_partitions=1, dtype="float64"),
        stream=StreamSpec(n_channels=2, sample_rate=rate,
                          out_format=SampleFormat.FLOAT_LE),
        chain=ChainSpec(eq=EqSpec(), files=tuple(files)),
        delay=delay or DelaySpec(),
    )


def test_session_render_matches_streaming(tmp_path):
    rng = np.random.default_rng(8)
    imp = rng.standard_normal((2, 900)) * 0.1
    cfg = _session_config(tmp_path, imp)
    cache = ArtifactCache(str(tmp_path / "profile"))
    x = rng.standard_normal((2, 4000))

    sp1 = StreamProcessor(cfg, cache)
    y_bulk = sp1.render(x)
    assert y_bulk.shape == x.shape
    assert sp1._bulk is not None  # the bulk path actually ran

    sp2 = StreamProcessor(cfg, cache)
    y_stream = sp2.process_buffer(np.pad(x, ((0, 0), (0, 256))))[:, :x.shape[1]]
    assert snr_db(y_bulk, y_stream) > 200
    # and both match the chain-composed oracle
    built_imp = sp1._built_impulse * sp1._built_scale
    assert snr_db(y_bulk, _oracle(x, built_imp)) > 150


def test_session_render_is_stateless_for_streaming(tmp_path):
    """render() must not advance the streaming engine on the bulk path."""
    rng = np.random.default_rng(9)
    imp = rng.standard_normal((2, 500)) * 0.1
    cfg = _session_config(tmp_path, imp)
    cache = ArtifactCache(str(tmp_path / "profile"))
    x = rng.standard_normal((2, 3000))

    sp = StreamProcessor(cfg, cache)
    a1 = sp.process(x[:, :512])
    _ = sp.render(x)
    a2 = sp.process(x[:, 512:1024])
    sp2 = StreamProcessor(cfg, cache)
    b1 = sp2.process(x[:, :512])
    b2 = sp2.process(x[:, 512:1024])
    np.testing.assert_allclose(np.concatenate([a1, a2], axis=1),
                               np.concatenate([b1, b2], axis=1), rtol=0, atol=0)


def test_session_render_delay_fallback(tmp_path):
    """A runtime delay line routes render() through the streaming engine
    (full tail flush, exact T frames out) and still matches the oracle
    shifted by the configured delay."""
    rng = np.random.default_rng(10)
    imp = rng.standard_normal((2, 300)) * 0.1
    d = 37
    cfg = _session_config(tmp_path, imp,
                          delay=DelaySpec(enabled=True, samples=(d,)))
    cache = ArtifactCache(str(tmp_path / "profile"))
    x = rng.standard_normal((2, 2100))
    sp = StreamProcessor(cfg, cache)
    y = sp.render(x)
    assert y.shape == x.shape
    assert sp._bulk is None  # fallback, not the bulk engine
    built_imp = sp._built_impulse * sp._built_scale
    ref = _oracle(x, built_imp)
    ref = np.concatenate([np.zeros((2, d)), ref[:, :-d]], axis=1)
    assert snr_db(y, ref) > 150


def test_session_render_refuses_bad_graph(tmp_path, monkeypatch):
    """If the bulk known-answer check fails (simulated miscompile), render
    must refuse the bulk graph rather than return wrong audio."""
    rng = np.random.default_rng(11)
    imp = rng.standard_normal((2, 400)) * 0.1
    cfg = _session_config(tmp_path, imp)
    cache = ArtifactCache(str(tmp_path / "profile"))
    x = rng.standard_normal((2, 1500))

    from bfir_tpu.core import bulk as BK
    from bfir_tpu.engine.selfcheck import EngineSelfCheckError

    real_render = BK.BulkRenderer.render

    def corrupt(self, xx):
        return real_render(self, xx) * 1.5  # O(1)-wrong, like a miscompile

    monkeypatch.setattr(BK.BulkRenderer, "render", corrupt)
    # the self-check goes through _call (not render), so corrupt _call too
    orig_init = BK.BulkRenderer.__init__

    def bad_init(self, *a, **k):
        orig_init(self, *a, **k)
        call = self._call

        def bad_call(st, co, hs, blocks):
            st2, out = call(st, co, hs, blocks)
            return st2, out * 1.5

        self._call = bad_call

    monkeypatch.setattr(BK.BulkRenderer, "__init__", bad_init)
    sp = StreamProcessor(cfg, cache)
    with pytest.raises(EngineSelfCheckError):
        sp.render(x)


def test_bulk_renderer_nu_engine_matches_scipy(monkeypatch):
    """Long filters route the renderer through the nu macro scan (the
    bulk schedule accelerators take); exactness unchanged."""
    from bfir_tpu.core import bulk as BK

    monkeypatch.setattr(BK, "NU_BULK_MIN_TAPS", 4000)
    rng = np.random.default_rng(20)
    c, taps = 2, 4608
    h = (rng.standard_normal((c, taps)) * 0.1).astype(np.float32)
    r = BK.BulkRenderer(h, c, dtype="float32", block_length=128)
    assert r.engine == "nonuniform"
    x = rng.standard_normal((c, 30000)).astype(np.float32)
    y = r.render(x)
    assert y.shape == x.shape
    assert snr_db(y, _oracle(x, h)) > 110


def test_bulk_renderer_nu_multi_dispatch_state_threads(monkeypatch):
    """T spanning several nu dispatches: pending/tail state threads."""
    from bfir_tpu.core import bulk as BK

    monkeypatch.setattr(BK, "NU_BULK_MIN_TAPS", 4000)
    rng = np.random.default_rng(21)
    c, taps = 2, 6000
    h = (rng.standard_normal((c, taps)) * 0.1).astype(np.float32)
    r = BK.BulkRenderer(h, c, dtype="float32", block_length=128)
    step = 24 * r._nuspec.ratio * r._nuspec.block_length
    x = rng.standard_normal((c, 2 * step + 777)).astype(np.float32)
    y = r.render(x)
    assert y.shape == x.shape
    assert snr_db(y, _oracle(x, h)) > 110


def test_bulk_renderer_gbatch_engine_matches_scipy(monkeypatch):
    """The accelerator-default G-cycle batched engine (forced on CPU via
    nu_engine='gbatch'): exactness and multi-dispatch state threading."""
    from bfir_tpu.core import bulk as BK

    monkeypatch.setattr(BK, "NU_BULK_MIN_TAPS", 4000)
    rng = np.random.default_rng(22)
    c, taps = 2, 4608
    h = (rng.standard_normal((c, taps)) * 0.1).astype(np.float32)
    r = BK.BulkRenderer(h, c, dtype="float32", block_length=128,
                        nu_engine="gbatch")
    assert r._nu_engine == "gbatch"
    step = 24 * r._nuspec.ratio * r._nuspec.block_length
    x = rng.standard_normal((c, step + 999)).astype(np.float32)
    y = r.render(x)
    assert y.shape == x.shape
    assert snr_db(y, _oracle(x, h)) > 110


def test_bulk_renderer_gbatch_rejects_int_store():
    from bfir_tpu.core import bulk as BK

    h = np.zeros((2, 70000), np.float32)
    h[:, 0] = 1.0
    with pytest.raises(ValueError, match="float-plane only"):
        BK.BulkRenderer(h, 2, dtype="float32", store="int24",
                        nu_engine="gbatch")


def test_bulk_renderer_gbatch_shared_planes(monkeypatch):
    """A one-row impulse with C>1 builds broadcast [P, 2, Hp] coefficient
    planes on the gbatch engine (1/C coefficient traffic) — output still
    the per-channel exact convolution."""
    from bfir_tpu.core import bulk as BK

    monkeypatch.setattr(BK, "NU_BULK_MIN_TAPS", 4000)
    rng = np.random.default_rng(23)
    c, taps = 3, 4608
    h = (rng.standard_normal((1, taps)) * 0.1).astype(np.float32)
    r = BK.BulkRenderer(h, c, dtype="float32", block_length=128,
                        nu_engine="gbatch")
    assert r._co.head.shape[1] == 2  # shared planes, not 2*C
    x = rng.standard_normal((c, 20000)).astype(np.float32)
    y = r.render(x)
    hb = np.broadcast_to(h, (c, taps))
    assert snr_db(y, _oracle(x, hb)) > 110
