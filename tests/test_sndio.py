"""Any-format impulse IO: FLAC codec, AIFF reader, sndio dispatch, and
chain integration (reference behavior:
buffer.cpp:37-139 loads impulses via libsndfile, any format)."""

import struct

import numpy as np
import pytest

from bfir_tpu.io import aiffio, flacio, sndio, wavio
from bfir_tpu.io.flacio import (BitWriter, _md5_of_samples, crc8, crc16,
                                read_flac, write_flac)


# -- FLAC roundtrips (encoder is verbatim/fixed+rice; decoder verifies CRCs
#    and the STREAMINFO MD5, so a matched encode/decode bug cannot hide) ----


def test_flac_roundtrip_16bit_stereo(tmp_path):
    rng = np.random.default_rng(0)
    # correlated signal so the fixed-predictor path is exercised
    x = np.cumsum(rng.integers(-500, 500, size=(9000, 2)), axis=0)
    x = np.clip(x, -32768, 32767).astype(np.int32)
    p = str(tmp_path / "a.flac")
    write_flac(p, x, 44100, bps=16)
    y, rate = read_flac(p)
    assert rate == 44100
    np.testing.assert_array_equal(np.rint(y * 32768).astype(np.int32), x)


def test_flac_roundtrip_24bit_mono_odd_tail(tmp_path):
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.integers(-60000, 60000, size=(5001, 1)), axis=0)
    x = np.clip(x, -(1 << 23), (1 << 23) - 1).astype(np.int64)
    p = str(tmp_path / "b.flac")
    write_flac(p, x, 96000, bps=24)
    y, rate = read_flac(p)
    assert rate == 96000 and y.shape == (5001, 1)
    np.testing.assert_array_equal(np.rint(y * (1 << 23)).astype(np.int64), x)


def test_flac_constant_and_noise_channels(tmp_path):
    rng = np.random.default_rng(2)
    n = 4096
    x = np.stack([np.full(n, 123), rng.integers(-30000, 30000, n)], axis=1)
    p = str(tmp_path / "c.flac")
    write_flac(p, x.astype(np.int64), 48000, bps=16)
    y, _ = read_flac(p)
    np.testing.assert_array_equal(np.rint(y * 32768).astype(np.int64), x)


def test_flac_md5_catches_corruption(tmp_path):
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.integers(-100, 100, size=(4096, 1)), axis=0).astype(np.int64)
    p = str(tmp_path / "d.flac")
    write_flac(p, x, 44100, bps=16)
    raw = bytearray(open(p, "rb").read())
    raw[60] ^= 0xFF  # corrupt one byte inside the first frame
    open(p, "wb").write(bytes(raw))
    with pytest.raises(flacio.FlacError):
        read_flac(p)


def _handcraft_flac(frames_writer, n, channels, bps, rate, samples):
    """Build a FLAC stream with custom frame content (LPC / stereo modes)."""
    out = bytearray(b"fLaC")
    si = BitWriter()
    si.write(n, 16); si.write(n, 16); si.write(0, 24); si.write(0, 24)
    si.write(rate, 20); si.write(channels - 1, 3); si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + _md5_of_samples(samples, bps)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body
    out += frames_writer()
    return bytes(out)


def _frame_header(n, channels_code, bps, frame_no=0):
    bw = BitWriter()
    bw.write(0x3FFE, 14); bw.write(0, 1); bw.write(0, 1)
    bw.write(7, 4)   # 16-bit blocksize at end
    bw.write(0, 4)   # rate from streaminfo
    bw.write(channels_code, 4)
    bw.write({8: 1, 16: 4, 24: 6}[bps], 3)
    bw.write(0, 1)
    bw.write_utf8_number(frame_no)
    bw.write(n - 1, 16)
    bw.align()
    hdr = bw.getvalue()
    return hdr + bytes([crc8(hdr)])


def _verbatim_subframe(bw, x, bps):
    bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)
    for v in x:
        bw.write_signed(int(v), bps)


def test_flac_lpc_subframe_decodes(tmp_path):
    """Hand-crafted LPC order-2 subframe (pred = 2a[n-1] - a[n-2] via
    quantized coeffs [2, -1] at shift 0)."""
    rng = np.random.default_rng(4)
    n, bps = 256, 16
    x = np.cumsum(rng.integers(-50, 50, n)).astype(np.int64)
    samples = x[:, None]

    def frames():
        hdr = _frame_header(n, 0, bps)
        bw = BitWriter()
        bw.write(0, 1)
        bw.write(32 + 1, 6)  # LPC, order 2 -> 0b100001
        bw.write(0, 1)
        for v in x[:2]:
            bw.write_signed(int(v), bps)
        bw.write(14, 4)       # precision 15
        bw.write_signed(0, 5)  # shift 0
        bw.write_signed(2, 15)
        bw.write_signed(-1, 15)
        res = x[2:] - (2 * x[1:-1] - x[:-2])
        bw.write(0, 2); bw.write(0, 4)  # rice, 1 partition
        k = 6
        bw.write(k, 4)
        for r in res:
            u = (int(r) << 1) ^ (int(r) >> 63)
            bw.write_unary(u >> k)
            bw.write(u & ((1 << k) - 1), k)
        bw.align()
        fr = hdr + bw.getvalue()
        return fr + crc16(fr).to_bytes(2, "big")

    p = str(tmp_path / "lpc.flac")
    open(p, "wb").write(_handcraft_flac(frames, n, 1, bps, 44100, samples))
    y, _ = read_flac(p)
    np.testing.assert_array_equal(np.rint(y[:, 0] * 32768).astype(np.int64), x)


@pytest.mark.parametrize("mode", ["left_side", "right_side", "mid_side"])
def test_flac_stereo_decorrelation_modes(tmp_path, mode):
    rng = np.random.default_rng(5)
    n, bps = 192, 16
    left = rng.integers(-20000, 20000, n).astype(np.int64)
    right = (left + rng.integers(-100, 100, n)).astype(np.int64)
    samples = np.stack([left, right], axis=1)
    side = left - right

    def frames():
        code = {"left_side": 8, "right_side": 9, "mid_side": 10}[mode]
        hdr = _frame_header(n, code, bps)
        bw = BitWriter()
        if mode == "left_side":
            _verbatim_subframe(bw, left, bps)
            _verbatim_subframe(bw, side, bps + 1)
        elif mode == "right_side":
            _verbatim_subframe(bw, side, bps + 1)
            _verbatim_subframe(bw, right, bps)
        else:
            mid = (left + right) >> 1
            _verbatim_subframe(bw, mid, bps)
            _verbatim_subframe(bw, side, bps + 1)
        bw.align()
        fr = hdr + bw.getvalue()
        return fr + crc16(fr).to_bytes(2, "big")

    p = str(tmp_path / f"{mode}.flac")
    open(p, "wb").write(_handcraft_flac(frames, n, 2, bps, 44100, samples))
    y, _ = read_flac(p)
    np.testing.assert_array_equal(np.rint(y * 32768).astype(np.int64), samples)


# -- AIFF --------------------------------------------------------------------


def test_aiff_reads_stdlib_aifc_output(tmp_path):
    """Oracle: python's own (independent) aifc writer."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc

    rng = np.random.default_rng(6)
    x = rng.integers(-30000, 30000, size=(1000, 2)).astype(np.int16)
    p = str(tmp_path / "a.aiff")
    w = aifc.open(p, "wb")
    w.setnchannels(2)
    w.setsampwidth(2)
    w.setframerate(44100)
    w.writeframes(x.astype(">i2").tobytes())
    w.close()
    y, rate = aiffio.read(p)
    assert rate == 44100
    np.testing.assert_array_equal(np.rint(y * 32768).astype(np.int16), x)


def _write_aifc(path, comp, body_bytes, ch, frames, bits, rate=44100):
    def ext80(r):
        # 44100 = 0x4000E * ... build via frexp
        import math

        m, e = math.frexp(r)
        mant = int(m * (1 << 64))
        return struct.pack(">H", e - 1 + 16383) + mant.to_bytes(8, "big")

    comm = struct.pack(">hIh", ch, frames, bits) + ext80(rate) + comp + b"\x00\x00"
    ssnd = struct.pack(">II", 0, 0) + body_bytes
    chunks = b"COMM" + struct.pack(">I", len(comm)) + comm + (b"\x00" if len(comm) & 1 else b"")
    chunks += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    data = b"AIFC" + chunks
    open(path, "wb").write(b"FORM" + struct.pack(">I", len(data)) + data)


def test_aifc_sowt_and_float32(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.integers(-30000, 30000, size=(500, 2)).astype(np.int16)
    p = str(tmp_path / "sowt.aifc")
    _write_aifc(p, b"sowt", x.astype("<i2").tobytes(), 2, 500, 16)
    y, _ = aiffio.read(p)
    np.testing.assert_array_equal(np.rint(y * 32768).astype(np.int16), x)

    f = rng.standard_normal((300, 1)).astype(np.float32) * 0.5
    p2 = str(tmp_path / "f32.aifc")
    _write_aifc(p2, b"fl32", f.astype(">f4").tobytes(), 1, 300, 32)
    y2, _ = aiffio.read(p2)
    np.testing.assert_allclose(y2, f.astype(np.float64), atol=0)


def test_aiff_24bit(tmp_path):
    rng = np.random.default_rng(8)
    v = rng.integers(-(1 << 23), 1 << 23, size=400).astype(np.int32)
    b = np.zeros((400, 3), np.uint8)
    u = v.astype(np.int64) & 0xFFFFFF
    b[:, 0] = u >> 16
    b[:, 1] = (u >> 8) & 0xFF
    b[:, 2] = u & 0xFF
    p = str(tmp_path / "x24.aiff")
    _write_aifc(p, b"NONE", b.tobytes(), 1, 400, 24)
    y, _ = aiffio.read(p)
    np.testing.assert_array_equal(np.rint(y[:, 0] * (1 << 23)).astype(np.int32), v)


# -- sndio dispatch + chain integration ---------------------------------------


def test_sndio_dispatch_and_info(tmp_path):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((600, 2)) * 0.2)

    pw = str(tmp_path / "i.wav")
    wavio.write(pw, x, 44100, subtype="float64")
    pf = str(tmp_path / "i.flac")
    write_flac(pf, x, 44100, bps=24)

    yw, rw = sndio.read(pw)
    yf, rf = sndio.read(pf)
    assert rw == rf == 44100
    np.testing.assert_allclose(yw, x, atol=1e-12)
    np.testing.assert_allclose(yf, x, atol=2 ** -23)
    iw, jf = sndio.read_info(pw), sndio.read_info(pf)
    assert (iw.n_channels, iw.sample_rate, iw.n_frames) == (2, 44100, 600)
    assert (jf.n_channels, jf.sample_rate, jf.n_frames) == (2, 44100, 600)
    assert jf.format == "flac"


def test_sndio_unsupported_names_format(tmp_path):
    p = str(tmp_path / "x.ogg")
    open(p, "wb").write(b"OggS" + b"\x00" * 64)
    with pytest.raises(ValueError, match="Ogg"):
        sndio.read(p)
    p2 = str(tmp_path / "junk.bin")
    open(p2, "wb").write(b"\x01\x02\x03\x04" + b"\x00" * 64)
    with pytest.raises(ValueError, match="unknown"):
        sndio.read(p2)


def test_chain_loads_flac_impulse(tmp_path):
    """A FLAC impulse file streams identically to the same impulse as WAV."""
    from tests.test_engine import make_config
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    rng = np.random.default_rng(10)
    imp = rng.standard_normal((2, 300)) * 0.1
    pw = str(tmp_path / "ir.wav")
    wavio.write(pw, imp.T, 44100, subtype="float64")
    pf = str(tmp_path / "ir.flac")
    write_flac(pf, imp.T, 44100, bps=24)

    x = rng.standard_normal((2, 1024))
    outs = {}
    for name, path in (("wav", pw), ("flac", pf)):
        sp = StreamProcessor(make_config(tmp_path, files=[(path, 0, False)]),
                             ArtifactCache(str(tmp_path / f"c{name}")))
        outs[name] = sp.process(x)
        assert sp._active, name
    # 24-bit quantization of the impulse bounds the output difference
    assert np.max(np.abs(outs["flac"] - outs["wav"])) < 1e-4


def test_coeffio_load_sound_flac(tmp_path):
    from bfir_tpu.io import coeffio

    rng = np.random.default_rng(11)
    imp = rng.standard_normal((2, 64)) * 0.3
    p = str(tmp_path / "c.flac")
    write_flac(p, imp.T, 44100, bps=24)
    h = coeffio.load_sound(p)
    assert h.shape == (2, 64)
    np.testing.assert_allclose(h, imp, atol=2 ** -22)


# -- AU / CAF ---------------------------------------------------------------


def _sine(frames=500, ch=2):
    t = np.arange(frames)[:, None]
    return 0.5 * np.sin(2 * np.pi * t * (np.arange(ch)[None, :] + 1) / 100.0)


@pytest.mark.parametrize("enc,atol", [
    ("s16", 2e-4), ("s24", 2e-6), ("s32", 1e-8),
    ("float32", 1e-7), ("float64", 1e-15),
])
def test_au_roundtrip(tmp_path, enc, atol):
    from bfir_tpu.io import auio, sndio

    a = _sine()
    p = str(tmp_path / f"x_{enc}.au")
    auio.write(p, a, 44100, encoding=enc)
    y, rate = sndio.read(p)  # via the magic-byte front door
    assert rate == 44100
    np.testing.assert_allclose(y, a, atol=atol)
    info = sndio.read_info(p)
    assert (info.n_channels, info.sample_rate, info.n_frames) == (2, 44100, 500)
    assert info.format == f"au/{enc}"


def test_au_mulaw_alaw(tmp_path):
    """G.711 companded AU decodes exactly per audioop's reference decoder
    (and within the 8-bit companded class of the original signal)."""
    import struct
    import warnings

    from bfir_tpu.io import auio

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # audioop deprecation (3.13)
        import audioop

    a = _sine(400, 1)
    x16 = np.clip(np.round(a[:, 0] * 32768), -32768, 32767).astype(np.int16)
    for enc_code, lin2, law2lin in ((1, audioop.lin2ulaw, audioop.ulaw2lin),
                                    (27, audioop.lin2alaw, audioop.alaw2lin)):
        enc = lin2(x16.tobytes(), 2)
        p = str(tmp_path / f"m{enc_code}.au")
        with open(p, "wb") as f:
            f.write(b".snd" + struct.pack(">IIIII", 24, len(enc), enc_code,
                                          8000, 1))
            f.write(enc)
        y, rate = auio.read(p)
        assert rate == 8000
        ref = np.frombuffer(law2lin(enc, 2), dtype=np.int16) / 32768.0
        np.testing.assert_allclose(y[:, 0], ref, atol=1e-12)
        assert np.abs(y[:, 0] - a[:, 0]).max() < 0.03  # companded class


@pytest.mark.parametrize("sub,atol", [
    ("float32", 1e-7), ("float64", 1e-15), ("pcm16", 2e-4),
])
def test_caf_roundtrip(tmp_path, sub, atol):
    from bfir_tpu.io import cafio, sndio

    a = _sine()
    p = str(tmp_path / f"x_{sub}.caf")
    cafio.write(p, a, 48000, subtype=sub)
    y, rate = sndio.read(p)
    assert rate == 48000
    np.testing.assert_allclose(y, a, atol=atol)
    info = sndio.read_info(p)
    assert (info.n_channels, info.sample_rate) == (2, 48000)
    assert info.n_frames == 500


def test_caf_rejects_compressed(tmp_path):
    import struct

    from bfir_tpu.io import cafio

    p = str(tmp_path / "c.caf")
    with open(p, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", 32))
        f.write(struct.pack(">d4sIIIII", 44100.0, b"aac ", 0, 0, 1024, 2, 0))
        f.write(b"data" + struct.pack(">q", 4))
        f.write(struct.pack(">I", 0))
    with pytest.raises(ValueError, match="codec"):
        cafio.read(p)


def test_au_caf_malformed_files_raise_cleanly(tmp_path):
    """Truncated/garbage AU and CAF inputs must raise ValueError with a
    named reason, never crash or return wrong audio (the libsndfile-parity
    error discipline of io/sndio.py)."""
    import struct

    from bfir_tpu.io import auio, cafio

    # AU: bad magic
    p = str(tmp_path / "bad1.au")
    open(p, "wb").write(b"nope" + b"\x00" * 30)
    with pytest.raises(ValueError, match="magic"):
        auio.read(p)
    # AU: unsupported encoding code
    p = str(tmp_path / "bad2.au")
    with open(p, "wb") as f:
        f.write(b".snd" + struct.pack(">IIIII", 24, 4, 99, 44100, 1) + b"\x00" * 4)
    with pytest.raises(ValueError, match="encoding"):
        auio.read(p)
    # AU: truncated header
    p = str(tmp_path / "bad3.au")
    open(p, "wb").write(b".snd\x00\x00")
    with pytest.raises(ValueError):
        auio.read(p)
    # CAF: bad magic
    p = str(tmp_path / "bad1.caf")
    open(p, "wb").write(b"wrong" + b"\x00" * 40)
    with pytest.raises(ValueError, match="magic"):
        cafio.read(p)
    # CAF: desc but no data chunk
    p = str(tmp_path / "bad2.caf")
    with open(p, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", 32))
        f.write(struct.pack(">d4sIIIII", 44100.0, b"lpcm", 1, 8, 1, 2, 32))
    with pytest.raises(ValueError, match="data"):
        cafio.read(p)
    # CAF: invalid PCM width
    p = str(tmp_path / "bad3.caf")
    with open(p, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", 32))
        f.write(struct.pack(">d4sIIIII", 44100.0, b"lpcm", 0, 0, 1, 2, 12))
        f.write(b"data" + struct.pack(">q", 8) + struct.pack(">I", 0) + b"\x00" * 4)
    with pytest.raises(ValueError, match="width"):
        cafio.read(p)


def test_caf_truncated_desc_raises_named_error(tmp_path):
    """Truncation INSIDE the 32-byte desc body must raise the
    named ValueError, not leak struct.error."""
    import struct

    from bfir_tpu.io import cafio

    p = str(tmp_path / "trunc.caf")
    with open(p, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", 32))
        f.write(b"\x00" * 12)  # desc body cut short
    with pytest.raises(ValueError, match="truncated CAF desc"):
        cafio.read(p)
    with pytest.raises(ValueError, match="truncated CAF desc"):
        cafio.read_info(p)


# ---------------------------------------------------------------------------
# libsndfile major-format matrix: every major format ID
# of /root/reference/libsndfile/sndfile.h:48-73 either decodes natively or
# raises a ValueError NAMING the detected format — never a silent failure.
# ---------------------------------------------------------------------------

# (sndfile.h constant, crafted magic bytes, expected name fragment)
_SF_MAJOR_MATRIX = [
    ("SF_FORMAT_PAF", b" paf" + b"\x00" * 20, "PARIS"),
    ("SF_FORMAT_PAF_LE", b"fap " + b"\x00" * 20, "PARIS"),
    ("SF_FORMAT_SVX", b"FORM\x00\x00\x00\x208SVX" + b"\x00" * 12, "SVX"),
    ("SF_FORMAT_NIST", b"NIST_1A\n   1024\n" + b"\x00" * 8, "NIST"),
    ("SF_FORMAT_VOC", b"Creative Voice File\x1a\x1a\x00", "VOC"),
    ("SF_FORMAT_IRCAM", b"\x64\xa3\x01\x00" + b"\x00" * 20, "IRCAM"),
    ("SF_FORMAT_MAT5", b"MATLAB 5.0 MAT-file" + b"\x00" * 5, "MAT5"),
    ("SF_FORMAT_PVF", b"PVF1\n1 44100 16\n" + b"\x00" * 8, "Portable Voice"),
    ("SF_FORMAT_XI", b"Extended Instrument: " + b"\x00" * 3, "XI"),
    ("SF_FORMAT_SDS", b"\xf0\x7e\x00\x01" + b"\x00" * 20, "SDS"),
    ("SF_FORMAT_AVR", b"2BIT" + b"\x00" * 20, "AVR"),
    ("SF_FORMAT_SD2", b"Sd2f" + b"\x00" * 20, "Sound Designer"),
    ("SF_FORMAT_WVE", b"ALawSoundFile**" + b"\x00" * 9, "WVE"),
    ("SF_FORMAT_OGG", b"OggS\x00\x02" + b"\x00" * 18, "Ogg"),
    # magic-less majors (RAW / MAT4 / HTK / MPC2K): named-unknown error
    ("SF_FORMAT_RAW", b"\x00\x01\x02\x03\x04\x05\x06\x07" * 3, "unknown"),
]


@pytest.mark.parametrize("const,magic,name",
                         _SF_MAJOR_MATRIX,
                         ids=[r[0] for r in _SF_MAJOR_MATRIX])
def test_libsndfile_major_format_matrix(tmp_path, const, magic, name,
                                        monkeypatch):
    """Every non-native libsndfile major format raises a ValueError naming
    the detected format, from read() AND read_info(), with no soundfile
    fallback installed."""
    import builtins
    import sys

    from bfir_tpu.io import sndio

    monkeypatch.setitem(sys.modules, "soundfile", None)  # force ImportError

    real_import = builtins.__import__

    def no_soundfile(nm, *a, **k):
        if nm == "soundfile":
            raise ImportError("not on this image")
        return real_import(nm, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_soundfile)
    p = str(tmp_path / "probe.bin")
    open(p, "wb").write(magic)
    with pytest.raises(ValueError, match=name):
        sndio.read(p)
    with pytest.raises(ValueError, match=name):
        sndio.read_info(p)


def test_native_major_formats_decode(tmp_path):
    """The natively-decoded majors (WAV incl. WAVEX, AIFF, AU, CAF, FLAC)
    round-trip through the sndio front door."""
    from bfir_tpu.io import auio, cafio, sndio, wavio

    rng = np.random.default_rng(80)
    a = (rng.standard_normal((64, 2)) * 0.4).astype(np.float64)
    made = []
    wavio.write(str(tmp_path / "t.wav"), a, 44100, subtype="float64")
    made.append(("t.wav", 1e-12))
    auio.write(str(tmp_path / "t.au"), a, 44100, encoding="float64")
    made.append(("t.au", 1e-12))
    cafio.write(str(tmp_path / "t.caf"), a, 44100, subtype="float64")
    made.append(("t.caf", 1e-12))
    for name, tol in made:
        got, rate = sndio.read(str(tmp_path / name))
        assert rate == 44100
        np.testing.assert_allclose(got, a, atol=tol, err_msg=name)
        info = sndio.read_info(str(tmp_path / name))
        assert info.n_channels == 2 and info.n_frames == 64


def test_soundfile_fallback_is_exercised(tmp_path, monkeypatch):
    """With a 'soundfile' module importable, unsupported formats route
    through it instead of erroring (the optional-dependency widening path,
    now actually TESTED via a stub)."""
    import sys
    import types

    data = np.linspace(-0.5, 0.5, 32).reshape(16, 2)

    stub = types.ModuleType("soundfile")
    stub.read = lambda path, dtype="float64", always_2d=True: (data, 48000)
    stub.info = lambda path: types.SimpleNamespace(
        channels=2, samplerate=48000, frames=16,
        format=types.SimpleNamespace(lower=lambda: "ogg"))
    monkeypatch.setitem(sys.modules, "soundfile", stub)

    from bfir_tpu.io import sndio

    p = str(tmp_path / "x.ogg")
    open(p, "wb").write(b"OggS\x00\x02" + b"\x00" * 100)
    got, rate = sndio.read(p)
    assert rate == 48000
    np.testing.assert_allclose(got, data)
    info = sndio.read_info(p)
    assert (info.n_channels, info.sample_rate, info.n_frames) == (2, 48000, 16)


def test_unsupported_subtypes_inside_native_containers(tmp_path):
    """Containers we decode natively must still NAME unsupported codecs
    inside them (WAV/ADPCM, AIFF-C/GSM) — libsndfile subtype IDs
    (sndfile.h:77-106) can't silently decode as garbage."""
    import struct

    from bfir_tpu.io import sndio

    # WAV with MS ADPCM format tag 0x0002
    p = str(tmp_path / "adpcm.wav")
    fmt = struct.pack("<HHIIHH", 0x0002, 2, 44100, 44100 * 4, 4, 16)
    data = b"\x00" * 64
    with open(p, "wb") as f:
        body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(data)) + data)
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    with pytest.raises(ValueError, match="format tag 0x0002"):
        sndio.read(p)

    # AIFF-C with GSM compression
    p = str(tmp_path / "gsm.aifc")
    comm = (struct.pack(">hLh", 2, 16, 16)
            + b"\x40\x0e\xac\x44\x00\x00\x00\x00\x00\x00"  # 44100 ext float
            + b"GSM " + b"\x04GSM\x00")
    ssnd = struct.pack(">LL", 0, 0) + b"\x00" * 64
    with open(p, "wb") as f:
        def chunk(tag, payload):  # IFF chunks are even-padded
            return (tag + struct.pack(">I", len(payload)) + payload
                    + (b"\x00" if len(payload) % 2 else b""))
        body = chunk(b"COMM", comm) + chunk(b"SSND", ssnd)
        f.write(b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFC" + body)
    with pytest.raises(Exception, match="GSM"):
        sndio.read(p)


def test_rf64_and_w64_read_natively(tmp_path):
    """SF_FORMAT_RF64 and SF_FORMAT_W64 are WAV in 64-bit framings; wavio
    parses both natively (sndfile.h:58,73)."""
    import struct

    from bfir_tpu.io import sndio, wavio

    rng = np.random.default_rng(81)
    a = (rng.standard_normal((48, 2)) * 0.3).astype(np.float64)
    payload = a.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 0x0003, 2, 44100, 44100 * 8, 8, 32)

    # RF64: riff size and data size deferred to the ds64 chunk
    p64 = str(tmp_path / "t.rf64.wav")
    ds64 = struct.pack("<QQQI", 0, len(payload), 48, 0)
    body = (b"ds64" + struct.pack("<I", len(ds64)) + ds64
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 0xFFFFFFFF) + payload)
    with open(p64, "wb") as f:
        f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE" + body)
    got, rate = sndio.read(p64)
    assert rate == 44100
    np.testing.assert_allclose(got, a, atol=1e-7)
    assert sndio.read_info(p64).n_frames == 48

    # W64: GUID chunk ids, 8-byte sizes including the 24-byte header,
    # 8-byte alignment
    pw = str(tmp_path / "t.w64")
    GUID_TAIL = b"\x2e\x91\xcf\x11\xa5\xd6\x28\xdb\x04\xc1\x00\x00"

    def w64chunk(cid, payload):
        size = 24 + len(payload)
        pad = b"\x00" * ((-size) % 8)
        return cid + GUID_TAIL + struct.pack("<Q", size) + payload + pad

    chunks = w64chunk(b"fmt ", fmt) + w64chunk(b"data", payload)
    hdr = b"riff" + GUID_TAIL + struct.pack("<Q", 40 + len(chunks)) \
        + b"wave" + GUID_TAIL
    with open(pw, "wb") as f:
        f.write(hdr + chunks)
    got, rate = sndio.read(pw)
    assert rate == 44100
    np.testing.assert_allclose(got, a, atol=1e-7)
    assert sndio.read_info(pw).n_frames == 48


# -- Ogg/Vorbis via system libvorbis (io/oggvorbis.py) --------


def _vorbis_available():
    from bfir_tpu.io import oggvorbis

    return oggvorbis.available()


@pytest.mark.skipif(not _vorbis_available(),
                    reason="system libvorbis not present")
def test_ogg_vorbis_roundtrip_mono(tmp_path):
    """write_vorbis -> read_vorbis on a mono tone: correct geometry and a
    high-quality lossy roundtrip (scale ~1, residual bounded)."""
    from bfir_tpu.io import oggvorbis as OV

    t = np.arange(22050) / 44100
    x = (0.5 * np.sin(2 * np.pi * 1000 * t))[:, None]
    p = str(tmp_path / "tone.ogg")
    OV.write_vorbis(p, x, 44100, quality=0.9)
    y, rate = OV.read_vorbis(p)
    assert rate == 44100 and y.shape == x.shape
    a, b = x[1000:-1000, 0], y[1000:-1000, 0]
    sc = float(np.dot(a, b) / np.dot(a, a))
    res = b - a * sc
    snr = 10 * np.log10(np.dot(a, a) * sc * sc / np.dot(res, res))
    assert 0.95 < sc < 1.05 and snr > 35, (sc, snr)


@pytest.mark.skipif(not _vorbis_available(),
                    reason="system libvorbis not present")
def test_sndio_routes_ogg_to_native_vorbis(tmp_path, monkeypatch):
    """sndio.read/read_info decode SF_FORMAT_OGG through the libvorbis
    binding WITHOUT the optional soundfile package present."""
    import builtins

    from bfir_tpu.io import oggvorbis as OV

    real_import = builtins.__import__

    def no_soundfile(nm, *a, **k):
        if nm == "soundfile":
            raise ImportError("absent")
        return real_import(nm, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_soundfile)
    t = np.arange(8192) / 44100
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                  0.4 * np.sin(2 * np.pi * 440 * t)], axis=1)
    p = str(tmp_path / "s.ogg")
    OV.write_vorbis(p, x, 44100, quality=0.8)
    audio, rate = sndio.read(p)
    assert rate == 44100 and audio.shape[1] == 2
    info = sndio.read_info(p)
    assert info.format == "ogg/vorbis"
    assert info.n_frames == audio.shape[0]


@pytest.mark.skipif(not _vorbis_available(),
                    reason="system libvorbis not present")
def test_ogg_impulse_loads_into_chain(tmp_path):
    """An Ogg/Vorbis impulse file works end to end as a chain impulse
    (coeffio -> sndio -> libvorbis), like any WAV."""
    from bfir_tpu.io import oggvorbis as OV
    from bfir_tpu.io.coeffio import load_sound

    rng = np.random.default_rng(0)
    # a smooth band-limited impulse survives lossy coding well enough to
    # verify the PLUMBING (numerical filter quality is the codec's domain)
    imp = np.cumsum(rng.standard_normal((2048, 1)), axis=0)
    imp = (imp - imp.mean()) / np.abs(imp).max() * 0.7
    p = str(tmp_path / "ir.ogg")
    OV.write_vorbis(p, imp, 44100, quality=0.9)
    h = load_sound(p)
    assert h.shape == (1, 2048)


def test_vorbis_unavailable_error_message(monkeypatch):
    from bfir_tpu.io import oggvorbis as OV

    monkeypatch.setattr(OV, "_libs", None)
    monkeypatch.setattr(OV.ctypes.util, "find_library", lambda n: None)

    class BoomDLL:
        def __init__(self, *a, **k):
            raise OSError("no lib")

    monkeypatch.setattr(OV.ctypes, "CDLL", BoomDLL)
    with pytest.raises(OV.VorbisUnavailable, match="libogg"):
        OV._load_libs()
    monkeypatch.setattr(OV, "_libs", None)
    assert OV.available() is False
    monkeypatch.setattr(OV, "_libs", None)
