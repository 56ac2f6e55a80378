"""Asyncio TCP AUDIO streaming server: raw PCM in -> filtered PCM out.

The reference's audio path lives inside a foobar2000 host (the plugin gets
pushed audio_chunk buffers, foo_dsp_bfir.cpp:279-351); its TCP surface is
control-only (cli_server/). For standalone production serving this module
adds the missing transport: a length-framed PCM stream over a socket,
driven through the SAME ``StreamProcessor.process_raw`` path as the plugin
(decode -> filter -> dither/quantize -> encode), composable with the
control server (one ConfigStore; EQ/impulse changes apply live with the
session's glitch-free crossfade).

Wire protocol (all little-endian):

    client -> server:  one JSON header line terminated by \\n:
        {"channels": C, "sample_rate": R,
         "in_format": "<SampleFormat label>",      (default float_le)
         "out_format": "<SampleFormat label>"}     (default float_le)
    then repeated frames: u32 byte-length + that many bytes of interleaved
    PCM in in_format. A zero-length frame flushes: the partial engine block
    is dropped (the plugin's flush semantics, foo_dsp_bfir.cpp:367-370) and
    the server closes after its final reply.

    server -> client:  one JSON header line {"ok": true, ...} (or
    {"ok": false, "error": ...}), then one u32+bytes frame per input frame
    carrying whatever COMPLETE blocks the engine produced for it (possibly
    zero-length while the re-blocker accumulates).

Each connection gets its own StreamProcessor (sessions are stateful); the
config snapshot comes from the shared ConfigStore at connect time, and
``reconfigure`` is wired to the store's change callback for live control.

Usage:
    python -m bfir_tpu.cli.audio_server --port 3010 --impulse ir.wav \\
        [--control-port 3000] [--cpu] [chain flags as bfir-render]
"""

from __future__ import annotations

import asyncio
import json
import struct
import threading
from typing import Optional

from bfir_tpu.core.spec import EngineConfig, SampleFormat
from bfir_tpu.utils.logging import pinfo

MAX_FRAME = 1 << 26  # 64 MB: bounds a hostile/corrupt length prefix


class AudioServer:
    def __init__(self, config: EngineConfig, host: str = "0.0.0.0",
                 port: int = 3010, store=None, cache=None):
        """``store``: optional cli.store.ConfigStore shared with a
        ControlServer — live config changes reconfigure every streaming
        session (crossfade, no dropout)."""
        self.config = config
        self.host = host
        self.port = port
        self.store = store
        self.cache = cache
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._sessions = []  # live StreamProcessors, for store callbacks
        self._lock = threading.Lock()

    # -- connection handling -------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        import dataclasses

        from bfir_tpu.engine.session import StreamProcessor

        sp = None
        listener = None
        try:
            head = await reader.readline()
            try:
                hdr = json.loads(head.decode("utf-8", "replace"))
                channels = int(hdr["channels"])
                rate = int(hdr["sample_rate"])
                in_fmt = SampleFormat.from_label(hdr.get("in_format", "float_le"))
                out_fmt = SampleFormat.from_label(hdr.get("out_format", "float_le"))
                if channels < 1 or channels > 1024 or rate < 1:
                    raise ValueError(f"bad header geometry {channels}ch@{rate}")
            except Exception as e:
                writer.write((json.dumps({"ok": False, "error": str(e)})
                              + "\n").encode())
                await writer.drain()
                return
            cfg = self.store.config if self.store is not None else self.config
            cfg = dataclasses.replace(cfg, stream=dataclasses.replace(
                cfg.stream, n_channels=channels, sample_rate=rate,
                in_format=in_fmt, out_format=out_fmt))
            # build the session off the event loop (coefficient build +
            # self-check can take seconds)
            sp = await asyncio.to_thread(StreamProcessor, cfg, self.cache)
            with self._lock:
                self._sessions.append(sp)
            if self.store is not None:
                listener = self._make_listener(sp, channels, rate, in_fmt,
                                               out_fmt)
                self.store.add_listener(listener)
            writer.write((json.dumps({
                "ok": True, "block_length": cfg.filter.block_length,
                "algorithmic_latency": cfg.filter.block_length,
                "max_inflight": self.MAX_INFLIGHT}) + "\n"
            ).encode())
            await writer.drain()
            await self._stream_frames(reader, writer, sp, rate,
                                      in_fmt.bytes * channels)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # client went away: normal stream end
        finally:
            if listener is not None:
                self.store.remove_listener(listener)
            if sp is not None:
                with self._lock:
                    if sp in self._sessions:
                        self._sessions.remove(sp)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # frames in flight between the socket reader and the socket writer;
    # a full queue stops the reader coroutine, which stops reading the
    # socket, which backpressures the client through TCP flow control.
    # 8 frames of the default 64 MB cap bounds per-connection memory
    MAX_INFLIGHT = 8

    async def _stream_frames(self, reader, writer, sp, rate: int,
                             frame_bytes: int) -> None:
        """Pipelined data plane: read, process and
        write run as three concurrent coroutines joined by bounded queues,
        so a frame's socket round-trip overlaps the processing of the
        frames behind it instead of serializing with it (the r4 loop was
        strict request-reply: on a high-latency transport every frame paid
        a full round trip). Ordering is preserved (single processor task);
        a zero-length frame still flushes and ends the stream; oversized or
        misaligned frames end it with a zero-length reply, as before."""
        in_q: asyncio.Queue = asyncio.Queue(self.MAX_INFLIGHT)
        out_q: asyncio.Queue = asyncio.Queue(self.MAX_INFLIGHT)
        _END = object()   # clean end of stream (flush reply already queued)
        _ABORT = object()  # protocol error: reply zero and stop

        async def read_frames():
            try:
                while True:
                    lenb = await reader.readexactly(4)
                    (nbytes,) = struct.unpack("<I", lenb)
                    if nbytes == 0:
                        await in_q.put(b"")
                        return
                    if nbytes > MAX_FRAME or nbytes % frame_bytes:
                        pinfo("audio conn: bad frame length %d (frame %d B)",
                              nbytes, frame_bytes)
                        await in_q.put(_ABORT)
                        return
                    await in_q.put(await reader.readexactly(nbytes))
            except (asyncio.IncompleteReadError, ConnectionResetError):
                await in_q.put(_ABORT)

        async def process_frames():
            while True:
                raw = await in_q.get()
                if raw is _ABORT:
                    await out_q.put(_ABORT)
                    return
                if raw == b"":
                    sp.flush()
                    await out_q.put(b"")
                    await out_q.put(_END)
                    return
                out = await asyncio.to_thread(sp.process_raw, raw, rate)
                await out_q.put(out)

        async def write_frames():
            while True:
                out = await out_q.get()
                if out is _END:
                    return
                if out is _ABORT:
                    writer.write(struct.pack("<I", 0))
                    await writer.drain()
                    return
                writer.write(struct.pack("<I", len(out)) + out)
                await writer.drain()

        rt = asyncio.ensure_future(read_frames())
        pt = asyncio.ensure_future(process_frames())
        try:
            await write_frames()
        finally:
            for t in (rt, pt):
                t.cancel()
            await asyncio.gather(rt, pt, return_exceptions=True)

    def _make_listener(self, sp, channels, rate, in_fmt, out_fmt):
        import dataclasses

        def on_change(cfg):
            sp.reconfigure(dataclasses.replace(cfg, stream=dataclasses.replace(
                cfg.stream, n_channels=channels, sample_rate=rate,
                in_format=in_fmt, out_format=out_fmt)))

        return on_change

    # -- lifecycle (mirrors ControlServer) -----------------------------------

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        pinfo("Audio server listening on %s:%d.", self.host, self.port)
        async with self._server:
            await self._server.serve_forever()

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except asyncio.CancelledError:
            pass
        finally:
            self._loop.close()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bfir-audio-server")
        self._thread.start()
        if not self._started.wait(10.0):
            raise RuntimeError("audio server failed to start")

    def stop(self) -> None:
        if self._loop is not None:

            def _shutdown():
                if self._server is not None:
                    self._server.close()
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(5.0)


def main(argv=None) -> int:
    import argparse
    import sys
    import time

    from bfir_tpu.cli.render import build_parser, config_from_args

    base = build_parser()
    p = argparse.ArgumentParser(
        prog="bfir-audio-server", parents=[], description=__doc__)
    # reuse the render chain flags minus the positional files
    for a in base._actions:
        if a.dest in ("input", "output", "help", "serve"):
            continue
        kwargs = dict(help=a.help, default=a.default)
        opt = f"--{a.dest.replace('_', '-')}"
        if isinstance(a, argparse._StoreTrueAction):
            p.add_argument(opt, action="store_true", **kwargs)
        elif a.choices:
            p.add_argument(opt, choices=a.choices, **kwargs)
        elif a.nargs == 0:
            continue
        else:
            kwargs["type"] = a.type or str
            if isinstance(a, argparse._AppendAction):
                p.add_argument(opt, action="append", **kwargs)
            else:
                p.add_argument(opt, **kwargs)
    p.add_argument("--port", type=int, default=3010)
    p.add_argument("--control-port", type=int, default=None,
                   help="also run the TCP control server on this port "
                        "(live EQ/impulse changes crossfade into running "
                        "streams)")
    args = p.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.dtype == "float64":
            jax.config.update("jax_enable_x64", True)
    from bfir_tpu.utils import platform

    platform.enable_compile_cache()
    args.serve = None  # config_from_args compatibility
    cfg = config_from_args(args)
    from bfir_tpu.cli.store import ConfigStore

    store = ConfigStore(cfg)
    srv = AudioServer(cfg, port=args.port, store=store)
    srv.start()
    ctl = None
    if args.control_port is not None:
        from bfir_tpu.cli.server import ControlServer

        ctl = ControlServer(store, port=args.control_port)
        ctl.start()
    print(f"audio server on :{srv.port}"
          + (f", control on :{ctl.port}" if ctl else ""), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        if ctl:
            ctl.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
