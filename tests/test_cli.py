"""Control-protocol and server tests against the spec in README.markdown:56-96."""

import json
import socket

import numpy as np
import pytest

from bfir_tpu.cli.protocol import CommandHandler, dir_listing, parse_line
from bfir_tpu.cli.server import ControlServer
from bfir_tpu.cli.store import ConfigStore
from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                ImpulseFileSpec, SampleFormat, StreamSpec)
from bfir_tpu.io import wavio


@pytest.fixture
def store():
    changes = []
    s = ConfigStore(
        EngineConfig(filter=FilterSpec(block_length=256, n_partitions=1, dtype="float64")),
        on_change=changes.append,
    )
    s.test_changes = changes
    return s


@pytest.fixture
def handler(store, tmp_path):
    return CommandHandler(store, default_dir=str(tmp_path))


def test_parse_line():
    assert parse_line("EQM5 -30\r") == ("EQM5", "-30")
    assert parse_line("eqen") == ("EQEN", "")
    assert parse_line("F1FN C:\\my file.wav") == ("F1FN", "C:\\my file.wav")


def test_eq_mag_get_set_clamp(handler, store):
    assert handler.handle("EQM0") == "0"
    assert handler.handle("EQM0 -30") == "OK"
    assert handler.handle("EQM0") == "-30"
    # clamped to +-200 (connection.cpp:93-94)
    assert handler.handle("EQM1 999") == "OK"
    assert handler.handle("EQM1") == "200"
    # band index clamped (connection.cpp:86-87)
    assert handler.handle("EQM99 50") == "OK"
    assert handler.handle("EQM30") == "50"
    assert handler.handle("EQM2 abc") == "ERR"
    assert len(store.test_changes) == 3


def test_enables_and_levels(handler):
    for op in ("EQEN", "F1EN", "F2EN", "F3EN"):
        assert handler.handle(op) == "0"
        assert handler.handle(f"{op} 1") == "OK"
        assert handler.handle(op) == "1"
        assert handler.handle(f"{op} 7") == "OK"  # clamped to 1
        assert handler.handle(op) == "1"
    for op in ("EQLV", "F1LV", "F2LV", "F3LV"):
        assert handler.handle(f"{op} -55") == "OK"
        assert handler.handle(op) == "-55"
        assert handler.handle(f"{op} -999") == "OK"
        assert handler.handle(op) == "-200"


def test_filename_set_probes_and_autolevels(handler, tmp_path):
    # a +12 dB impulse => auto level ~ -12 dB = -120 steps (connection.cpp:318-346)
    imp = np.zeros((64, 2))
    imp[0, :] = 4.0
    p = str(tmp_path / "hot.wav")
    wavio.write(p, imp, 44100, subtype="float64")
    assert handler.handle(f"F1FN {p}") == "OK"
    assert handler.handle("F1FN") == p
    assert handler.handle("F1EN") == "1"
    md = handler.handle("F1MD")
    assert md == "64 samples, 2 channels, 44100 Hz"
    lvl = int(handler.handle("F1LV"))
    assert -125 <= lvl <= -110
    # '?' clears (connection.cpp:308-317)
    assert handler.handle("F1FN ?") == "OK"
    assert handler.handle("F1FN") == ""
    assert handler.handle("F1MD") == ""
    assert handler.handle("F1LV") == "0"
    assert handler.handle("F1EN") == "0"


def test_filename_missing_errors(handler):
    assert handler.handle("F2FN /no/such/file.wav") == "ERR"
    assert handler.handle("F2FN") == ""


def test_dir_listing(handler, tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.wav").write_bytes(b"")
    (tmp_path / "b.wav").write_bytes(b"")
    out = handler.handle("DIR")
    data = json.loads(out)
    assert data["dir"] == str(tmp_path)
    names = [e["name"] for e in data["subdir"]]
    assert names[0] == ".."
    assert "sub" in names
    assert [e["name"] for e in data["file"]] == ["a.wav", "b.wav"]
    assert handler.handle("DIR /definitely/not/here")  # falls back to default
    assert handler.handle("BOGUS") == "ERR"


def test_close(handler):
    assert handler.handle("CLOSE") == "OK"
    assert handler.close


def test_dir_listing_of_file(tmp_path):
    f = tmp_path / "x.txt"
    f.write_text("hi")
    out = dir_listing(str(f), str(tmp_path))
    assert json.loads(out) == str(f)


def test_server_end_to_end(store, tmp_path):
    srv = ControlServer(store, host="127.0.0.1", port=0, default_dir=str(tmp_path))
    srv.start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as sk:
            def rt(cmd):
                sk.sendall(cmd.encode() + b"\r")
                buf = b""
                while not buf.endswith(b"\r"):
                    chunk = sk.recv(4096)
                    if not chunk:
                        break
                    buf += chunk
                return buf[:-1].decode()

            assert rt("EQM0 -100") == "OK"
            assert rt("EQM0") == "-100"
            assert rt("EQEN 1") == "OK"
            assert rt("NOPE") == "ERR"
            assert rt("CLOSE") == "OK"
        # store reflects the mutations
        assert store.config.chain.eq.mag_steps[0] == -100
        assert store.config.chain.eq.enabled
    finally:
        srv.stop()


def test_server_crlf_clients(store, tmp_path):
    srv = ControlServer(store, host="127.0.0.1", port=0, default_dir=str(tmp_path))
    srv.start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as sk:
            sk.sendall(b"EQM3 40\r\nEQM3\r\n")  # telnet-style CRLF
            buf = b""
            while buf.count(b"\r") < 2:
                chunk = sk.recv(4096)
                if not chunk:
                    break
                buf += chunk
            assert buf.split(b"\r")[:2] == [b"OK", b"40"]
    finally:
        srv.stop()


def _cfg_with_impulse(path, block=256):
    files = [ImpulseFileSpec(enabled=True, filename=path),
             ImpulseFileSpec(), ImpulseFileSpec()]
    return EngineConfig(
        filter=FilterSpec(block_length=block, n_partitions=1, dtype="float64"),
        stream=StreamSpec(n_channels=2, sample_rate=44100),
        chain=ChainSpec(files=tuple(files)),
    )


# -- audio streaming server (cli/audio_server.py) ---------------------------


def _audio_client(port, channels, rate, frames_iter, in_format="float_le",
                  out_format="float_le"):
    """Minimal wire-protocol client: returns (header, concatenated bytes)."""
    import json
    import socket
    import struct

    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall((json.dumps({"channels": channels, "sample_rate": rate,
                           "in_format": in_format,
                           "out_format": out_format}) + "\n").encode())
    f = s.makefile("rb")
    hdr = json.loads(f.readline().decode())
    chunks = []
    if hdr.get("ok"):
        for raw in frames_iter:
            s.sendall(struct.pack("<I", len(raw)) + raw)
            (n,) = struct.unpack("<I", f.read(4))
            chunks.append(f.read(n))
        s.sendall(struct.pack("<I", 0))  # flush/end
        (n,) = struct.unpack("<I", f.read(4))
        chunks.append(f.read(n))
    s.close()
    return hdr, b"".join(chunks)


def test_audio_server_streams_filtered_pcm(tmp_path):
    """End-to-end socket audio path: PCM frames in, filtered PCM out, same
    numerics as the in-process session (process_raw path)."""
    import dataclasses

    import numpy as np
    from scipy import signal

    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.io import wavio
    from bfir_tpu.ops import formats as fmops

    rng = np.random.default_rng(70)
    h = rng.standard_normal((2, 700)) * 0.1
    p = str(tmp_path / "ir.wav")
    wavio.write(p, h.T, 44100, subtype="float64")
    cfg = _cfg_with_impulse(p, block=256)
    srv = AudioServer(cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        x = rng.standard_normal((2, 256 * 6 + 100))
        # stream in 3 unaligned chunks (the server re-blocks)
        cuts = [0, 700, 1100, x.shape[1]]
        frames = [fmops.encode_float(x[:, a:b], SampleFormat.FLOAT_LE)
                  for a, b in zip(cuts, cuts[1:])]
        hdr, out = _audio_client(srv.port, 2, 44100, frames)
        assert hdr["ok"] and hdr["block_length"] == 256
        y = fmops.decode(out, SampleFormat.FLOAT_LE, 2)
        assert y.shape == (2, 256 * 6)  # all complete blocks, flush drops rest
        ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                        for c in range(2)])
        err = np.abs(y - ref).max()
        assert err < 1e-5, err
    finally:
        srv.stop()


def test_audio_server_live_control_reconfigure(tmp_path):
    """A control-plane EQ change crossfades into a RUNNING audio stream
    (shared ConfigStore; no reconnect, no dropout)."""
    import dataclasses
    import json
    import socket
    import struct

    import numpy as np

    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.cli.store import ConfigStore
    from bfir_tpu.io import wavio
    from bfir_tpu.ops import formats as fmops

    h = np.zeros((2, 16))
    h[:, 0] = 1.0  # dirac chain
    p = str(tmp_path / "d.wav")
    wavio.write(p, h.T, 44100, subtype="float64")
    cfg = _cfg_with_impulse(p, block=256)
    store = ConfigStore(cfg)
    srv = AudioServer(cfg, host="127.0.0.1", port=0, store=store)
    srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        s.sendall((json.dumps({"channels": 2, "sample_rate": 44100}) + "\n")
                  .encode())
        f = s.makefile("rb")
        hdr = json.loads(f.readline().decode())
        assert hdr["ok"]

        def push(block):
            raw = fmops.encode_float(block, SampleFormat.FLOAT_LE)
            s.sendall(struct.pack("<I", len(raw)) + raw)
            (n,) = struct.unpack("<I", f.read(4))
            return fmops.decode(f.read(n), SampleFormat.FLOAT_LE, 2)

        x = np.ones((2, 256)) * 0.25
        y1 = push(x)
        np.testing.assert_allclose(y1, x, atol=1e-6)  # dirac passthrough
        # live change through the CONTROL surface: +6 dB file level
        store.set_file_level(1, 60)  # 1-based slots (F1FN et al.)
        y2 = push(x)  # crossfade block: ramps 1.0 -> 2.0 gain
        y3 = push(x)  # settled at the new gain
        assert y2[0, 0] < y2[0, -1], "crossfade must ramp within the block"
        np.testing.assert_allclose(y3, x * (10 ** (6 / 20)), rtol=1e-4)
        s.close()
    finally:
        srv.stop()


def test_audio_server_rejects_bad_header(tmp_path):
    import json
    import socket

    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.core.spec import EngineConfig

    srv = AudioServer(EngineConfig(), host="127.0.0.1", port=0)
    srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"not json\n")
        hdr = json.loads(s.makefile("rb").readline().decode())
        assert hdr["ok"] is False and "error" in hdr
        s.close()
    finally:
        srv.stop()


def test_audio_server_multi_client_concurrent(tmp_path):
    """N=4 clients streaming CONCURRENTLY: each gets
    its own session and its own correct output (worst channel vs scipy),
    with no cross-talk between connections."""
    import threading

    import numpy as np
    from scipy import signal

    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.io import wavio
    from bfir_tpu.ops import formats as fmops

    rng = np.random.default_rng(71)
    h = rng.standard_normal((2, 500)) * 0.1
    p = str(tmp_path / "ir.wav")
    wavio.write(p, h.T, 44100, subtype="float64")
    cfg = _cfg_with_impulse(p, block=256)
    srv = AudioServer(cfg, host="127.0.0.1", port=0)
    srv.start()
    n_clients = 4
    signals = [rng.standard_normal((2, 1440)) for _ in range(n_clients)]
    results = [None] * n_clients
    errors = []

    def client(i):
        try:
            frames = [fmops.encode_float(signals[i][:, a:a + 640],
                                         SampleFormat.FLOAT_LE)
                      for a in range(0, 1280, 640)] + [
                fmops.encode_float(signals[i][:, 1280:], SampleFormat.FLOAT_LE)]
            hdr, out = _audio_client(srv.port, 2, 44100, frames)
            assert hdr["ok"]
            results[i] = fmops.decode(out, SampleFormat.FLOAT_LE, 2)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        for i in range(n_clients):
            y = results[i]
            assert y is not None and y.shape == (2, 256 * 5)  # 1440//256
            ref = np.stack([signal.fftconvolve(signals[i][c], h[c])[: y.shape[1]]
                            for c in range(2)])
            assert np.abs(y - ref).max() < 1e-5
    finally:
        srv.stop()


def test_audio_server_pipelined_frames_in_flight(tmp_path):
    """The decoupled data plane: a client may send MANY frames before
    reading any reply (bounded in-flight queue; TCP backpressure past it)
    and still gets every reply, in order, numerically correct."""
    import json
    import socket
    import struct

    import numpy as np
    from scipy import signal

    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.io import wavio
    from bfir_tpu.ops import formats as fmops

    rng = np.random.default_rng(72)
    h = rng.standard_normal((2, 400)) * 0.1
    p = str(tmp_path / "ir.wav")
    wavio.write(p, h.T, 44100, subtype="float64")
    cfg = _cfg_with_impulse(p, block=256)
    srv = AudioServer(cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        nframes = 24
        x = rng.standard_normal((2, 256 * nframes))
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        s.sendall((json.dumps({"channels": 2, "sample_rate": 44100,
                               "in_format": "float_le",
                               "out_format": "float_le"}) + "\n").encode())
        f = s.makefile("rb")
        hdr = json.loads(f.readline().decode())
        assert hdr["ok"] and hdr.get("max_inflight", 0) >= 4
        # fire every frame (plus the flush) before reading a single reply
        for i in range(nframes):
            raw = fmops.encode_float(x[:, i * 256:(i + 1) * 256],
                                     SampleFormat.FLOAT_LE)
            s.sendall(struct.pack("<I", len(raw)) + raw)
        s.sendall(struct.pack("<I", 0))
        chunks = []
        for _ in range(nframes + 1):
            (n,) = struct.unpack("<I", f.read(4))
            chunks.append(f.read(n))
        s.close()
        y = fmops.decode(b"".join(chunks), SampleFormat.FLOAT_LE, 2)
        assert y.shape == (2, 256 * nframes)
        ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                        for c in range(2)])
        assert np.abs(y - ref).max() < 1e-5
    finally:
        srv.stop()
