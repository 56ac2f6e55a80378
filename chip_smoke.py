"""Bring-up check of the engine on one NVIDIA GPU (four with --four-cards).

Drives the main paths through the entry points a user calls, at the
flagship deployment: multichannel room correction, 64 channels x
131072-tap (~3 s) filters, float32, block 1024, 44.1 kHz. The impulse and
the audio are generated from --seed and written as WAV; nothing is
downloaded. Phases, each of which must pass:

  (a) device: card name and power limit, compile cache, native codec
  (b) kernel parity: every MAC form, the bulk correlation MAC and the FFT
      provider at the flagship head/tail widths vs float64 numpy literals
  (c) streaming: 192 blocks through StreamProcessor.process (auto engine)
      vs scipy float64 convolution, worst-channel SNR >= 125 dB
  (d) render: ~10 s through the render CLI, file to file, vs scipy and vs
      process_buffer
  (e) audio server: 64-channel PCM frames over loopback vs process_buffer
  (f) extended precision: engine_mode="extended" beats float32 by >= 30 dB

``--four-cards`` runs only the sharded engine (sharded_local="nonuniform")
over a 1x4 ("c", "p") mesh of four GPUs, against the single-card
nonuniform engine and scipy.

Exits non-zero, with no result line, when JAX finds no GPU. The last line
of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.

Usage: python chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np

RATE = 44100
MIN_SNR_DB = 125.0  # the full-quality float32 gate (ROADMAP)
EPS32 = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class Geometry:
    """Deployment size: the flagship by default, tiny for CPU rehearsals."""

    channels: int = 64
    taps: int = 131072
    block: int = 1024
    stream_blocks: int = 192
    render_seconds: float = 10.0
    server_frames: int = 6
    frame_blocks: int = 8


FLAGSHIP = Geometry()


def log(msg: str) -> None:
    print(msg, flush=True)


def worst_snr_db(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    err = ((y - ref) ** 2).sum(axis=-1)
    sig = (ref ** 2).sum(axis=-1)
    return float(np.min(10 * np.log10(sig / np.maximum(err, 1e-300))))


def scipy_reference(x, h):
    from scipy import signal

    t = x.shape[1]
    return np.stack([signal.fftconvolve(x[ch].astype(np.float64),
                                        h[ch % h.shape[0]].astype(np.float64))
                     [:t] for ch in range(x.shape[0])])


# -- (b) kernel parity --------------------------------------------------------


def _mac_law_f64(ring, coeff, pos, halfcomplex=True, band=None):
    """float64 literal of the partition MAC on packed [P, 2C, F] planes:
    y = sum_p coeff[p] * ring[(pos - p) mod P]; halfcomplex lane 0 holds
    (DC.re, Nyquist.re), two real products. Returns (yr, yi, sum|terms|),
    the last being the scale of the f32 summation error bound."""
    ring = np.asarray(ring, np.float64)
    coeff = np.asarray(coeff, np.float64)
    if band is not None:
        ring, coeff = ring[..., band], coeff[..., band]
    p, c2, _ = ring.shape
    c, cs = c2 // 2, coeff.shape[1] // 2
    idx = (pos - np.arange(p)) % p
    rr, ri = ring[idx, :c], ring[idx, c:]
    cr, ci = coeff[:, :cs], coeff[:, cs:]
    a, b, d, e = cr * rr, ci * ri, cr * ri, ci * rr
    yr, yi = (a - b).sum(0), (d + e).sum(0)
    mag = (np.abs(a) + np.abs(b) + np.abs(d) + np.abs(e)).sum(0)
    if halfcomplex and (band is None or band.start == 0):
        yr[..., 0], yi[..., 0] = a[..., 0].sum(0), b[..., 0].sum(0)
    return yr, yi, mag


def _corr_law_f64(hist, coeff, nb):
    """float64 literal of the bulk correlation MAC:
    out[b] = sum_q coeff[q] (*) hist[P-1+b-q] (halfcomplex lane 0)."""
    hist = np.asarray(hist, np.float64)
    coeff = np.asarray(coeff, np.float64)
    p = coeff.shape[0]
    c, cs = hist.shape[1] // 2, coeff.shape[1] // 2
    yr = np.zeros((nb, c, hist.shape[2]))
    yi = np.zeros_like(yr)
    mag = np.zeros_like(yr)
    for q in range(p):
        w = hist[p - 1 - q:p - 1 - q + nb]
        cr, ci = coeff[q, :cs], coeff[q, cs:]
        a, b = cr * w[:, :c], ci * w[:, c:]
        d, e = cr * w[:, c:], ci * w[:, :c]
        dr, di = a - b, d + e
        dr[..., 0], di[..., 0] = a[..., 0], b[..., 0]
        yr += dr
        yi += di
        mag += np.abs(a) + np.abs(b) + np.abs(d) + np.abs(e)
    return yr, yi, mag


def kernel_parity(c: int, p_head: int, hp_head: int, p_tail: int,
                  hp_tail: int, gbatch_blocks: int, seed: int = 0):
    """Every remaining MAC form and the FFT provider, compiled for the
    default backend, against float64 numpy literals of the same law.
    Returns [(name, error, tolerance, reason)]; passes when error <= tol."""
    import jax
    import jax.numpy as jnp

    from bfir_tpu.core import nubatch as NB
    from bfir_tpu.kernels import spectrum_mac as K
    from bfir_tpu.kernels.corr_mac import corr_mac_triton
    from bfir_tpu.ops import fft as F

    rng = np.random.default_rng(seed)
    results = []
    # Summation of P f32 products: recursive or tree order, each product
    # and partial sum rounds once -> |err| <= (P + 1) eps32 sum|terms|.
    sum_reason = "f32 sum over {p} partitions: (P+1)*eps32*sum|terms|"

    def mac_check(name, ring, coeff, p, band=None, law_ring=None,
                  law_coeff=None):
        pos = p // 2 + 1
        if band is None:
            yr, yi = jax.jit(K.mac_hc)(ring, coeff, jnp.int32(pos))
        else:
            yr, yi = jax.jit(K.mac_reference_hc_band, static_argnums=(3, 4))(
                ring, coeff, jnp.int32(pos), band.start,
                band.stop - band.start)
        er, ei, mag = _mac_law_f64(
            ring if law_ring is None else law_ring,
            coeff if law_coeff is None else law_coeff, pos, band=band)
        err = max(float(np.max(np.abs(np.asarray(yr) - er) / (mag + 1e-30))),
                  float(np.max(np.abs(np.asarray(yi) - ei) / (mag + 1e-30))))
        results.append((name, err, (p + 1) * EPS32,
                        sum_reason.format(p=p) + " (error/sum|terms|)"))

    def normal(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32))

    head_r, head_c = normal(p_head, 2 * c, hp_head), normal(p_head, 2 * c, hp_head)
    tail_r, tail_c = normal(p_tail, 2 * c, hp_tail), normal(p_tail, 2 * c, hp_tail)
    mac_check("mac_hc head f32", head_r, head_c, p_head)
    mac_check("mac_hc head shared-coeff", head_r, normal(p_head, 2, hp_head),
              p_head)
    mac_check("mac_hc tail f32", tail_r, tail_c, p_tail)
    q_r, q_c = K.quantize_planes(tail_r, 24), K.quantize_planes(tail_c, 24)
    # the f32 decode of an int24 row is exact; the law runs on decoded planes
    mac_check("mac_hc tail int24", q_r, q_c, p_tail,
              law_ring=K.dequantize_planes(q_r),
              law_coeff=K.dequantize_planes(q_c))
    blen = hp_tail // 8
    mac_check("mac band (split tail, band 0)", tail_r, tail_c, p_tail,
              band=slice(0, blen))
    mac_check("mac band (split tail, band 1)", tail_r, tail_c, p_tail,
              band=slice(blen, 2 * blen))
    # split re/im planes (packed/split engines): full complex law, no fixup
    fp = hp_head + 128
    sr, sc = normal(p_head, 2 * c, fp), normal(p_head, 2 * c, fp)
    pos = 3
    yr, yi = jax.jit(K.mac_reference)(sr[:, :c], sr[:, c:], sc[:, :c],
                                      sc[:, c:], jnp.int32(pos))
    er, ei, mag = _mac_law_f64(sr, sc, pos, halfcomplex=False)
    results.append(("mac_reference split planes",
                    max(float(np.max(np.abs(np.asarray(yr) - er) / mag)),
                        float(np.max(np.abs(np.asarray(yi) - ei) / mag))),
                    (p_head + 1) * EPS32,
                    sum_reason.format(p=p_head) + " (error/sum|terms|)"))
    # bulk correlation MAC (gbatch): head over G*R blocks, tail over G;
    # the fused XLA form and the Triton kernel (compiled for the card,
    # interpreted only on the CPU)
    for stage, p, hp, nb in (("head", p_head, hp_head, gbatch_blocks),
                             ("tail", p_tail, hp_tail,
                              max(1, gbatch_blocks // 8))):
        hist, co = normal(p - 1 + nb, 2 * c, hp), normal(p, 2 * c, hp)
        er, ei, mag = _corr_law_f64(hist, co, nb)
        for route, fn in (("xla", jax.jit(NB._corr_mac, static_argnums=2)),
                          ("triton", corr_mac_triton)):
            yr, yi = fn(hist, co, nb)
            results.append((
                f"corr_mac {route} gbatch {stage}",
                max(float(np.max(np.abs(np.asarray(yr) - er) / mag)),
                    float(np.max(np.abs(np.asarray(yi) - ei) / mag))),
                (p + 1) * EPS32,
                sum_reason.format(p=p) + " (error/sum|terms|)"))
    # FFT provider: forward halfcomplex transform and overlap-save tails.
    # An FFT's rounding grows ~eps32 * log2(n) relative to the output
    # scale; 8x that is the tolerance (no TF32: the provider is cuFFT, and
    # the matmul path runs at HIGHEST precision).
    for n in (2 * hp_head, 2 * hp_tail):
        x = rng.standard_normal((c, n)).astype(np.float32)
        hr, hi = jax.jit(F.rfft_split_hc)(jnp.asarray(x))
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        h = n // 2
        err = max(float(np.abs(np.asarray(hr) - ref.real[:, :h]).max()),
                  float(np.abs(np.asarray(hi)[:, 1:] - ref.imag[:, 1:h]).max()),
                  float(np.abs(np.asarray(hi)[:, 0] - ref.real[:, h]).max()))
        scale = float(np.abs(ref).max())
        results.append((f"rfft_split_hc n={n}", err / scale,
                        8 * np.log2(n) * EPS32,
                        "FFT rounding ~eps32*log2(n) of the output scale"))
        spec = np.concatenate([ref.real[:, :h], ref.real[:, h:h + 1]], 1) \
            + 1j * np.concatenate([np.zeros((c, 1)), ref.imag[:, 1:h],
                                   np.zeros((c, 1))], 1)
        yr = spec.real[:, :h].astype(np.float32)
        yi = np.concatenate([spec.real[:, h:h + 1], spec.imag[:, 1:h]],
                            1).astype(np.float32)
        # lane 0 of yi is the Nyquist bin: rebuild the float64 spectrum
        full = np.concatenate([yr.astype(np.float64),
                               yi[:, :1].astype(np.float64)], 1) \
            + 1j * np.concatenate([np.zeros((c, 1)),
                                   yi[:, 1:].astype(np.float64),
                                   np.zeros((c, 1))], 1)
        tail_ref = np.fft.irfft(full, n=n, axis=-1)[:, h:]
        out = jax.jit(F.irfft_hc_tail, static_argnums=2)(
            jnp.asarray(yr), jnp.asarray(yi), n)
        err = float(np.abs(np.asarray(out) - tail_ref).max())
        scale = float(np.abs(tail_ref).max())
        results.append((f"irfft_hc_tail n={n}", err / scale,
                        8 * np.log2(n) * EPS32,
                        "FFT rounding ~eps32*log2(n) of the output scale"))
    return results


# -- shared set-up --------------------------------------------------------------


class EngineLog:
    """Collects the engine's messages, echoes them, and flags any engine
    build failure or self-check refusal (a fallback that hides the
    device's real engine)."""

    BAD = re.compile(r"Engine '.*' (failed to build|refused)|passing through")

    def __init__(self):
        self.lines = []

    def __call__(self, text: str) -> None:
        self.lines.append(text)
        print(f"  engine: {text}", flush=True)

    def failures(self):
        return [ln for ln in self.lines if self.BAD.search(ln)]


def make_files(tmp: str, geo: Geometry, seed: int):
    """A room-correction-like impulse (direct path + exponentially decaying
    reflections, ~0.3 s decay constant) per channel, and noise audio, both
    written as float32 WAV."""
    from bfir_tpu.io import wavio

    rng = np.random.default_rng(seed)
    t = np.arange(geo.taps)
    h = (rng.standard_normal((geo.channels, geo.taps))
         * np.exp(-t / (0.3 * RATE)) * 0.02).astype(np.float32)
    h[:, 0] += 0.5
    ir = os.path.join(tmp, "ir.wav")
    wavio.write(ir, h.T, RATE, subtype="float32")
    h, _ = wavio.read(ir)
    return ir, h.T.astype(np.float32)


def flagship_config(ir: str, geo: Geometry, **kw):
    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                ImpulseFileSpec, StreamSpec)

    return EngineConfig(
        filter=FilterSpec(block_length=geo.block, n_partitions=1,
                          dtype=kw.pop("dtype", "float32")),
        stream=StreamSpec(n_channels=geo.channels, sample_rate=RATE),
        chain=ChainSpec(files=(ImpulseFileSpec(enabled=True, filename=ir),
                               ImpulseFileSpec(), ImpulseFileSpec())),
        **kw)


def stream(sp, x, blocks_per_call: int, block: int):
    outs = []
    step = blocks_per_call * block
    for i in range(0, x.shape[1], step):
        outs.append(sp.process(x[:, i:i + step]))
    return np.concatenate(outs, axis=1)


# -- (c)-(f) ------------------------------------------------------------------


def phase_stream(ctx):
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    geo, rng = ctx["geo"], ctx["rng"]
    x = rng.standard_normal(
        (geo.channels, geo.stream_blocks * geo.block)).astype(np.float32)
    sp = StreamProcessor(flagship_config(ctx["ir"], geo),
                         ArtifactCache(os.path.join(ctx["tmp"], "profile")))
    y = stream(sp, x, 8, geo.block)
    want = ctx["expect_engine"]
    if sp._impl != want:
        raise AssertionError(f"auto engine is {sp._impl!r}, expected {want!r}")
    snr = worst_snr_db(y, scipy_reference(x, ctx["h"]))
    log(f"  stream engine: {sp._impl}; {geo.stream_blocks} blocks x "
        f"{geo.channels} ch; worst-channel SNR {snr:.2f} dB")
    if not snr >= MIN_SNR_DB:
        raise AssertionError(f"stream SNR {snr:.2f} dB < {MIN_SNR_DB}")


def phase_render(ctx):
    from bfir_tpu.cli import render
    from bfir_tpu.core import bulk as BK
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor
    from bfir_tpu.io import wavio
    from bfir_tpu.utils import platform

    geo, rng = ctx["geo"], ctx["rng"]
    t = int(geo.render_seconds * RATE)
    # quiet enough that the filtered output stays inside full scale
    x = (0.05 * rng.standard_normal((geo.channels, t))).astype(np.float32)
    src = os.path.join(ctx["tmp"], "in.wav")
    dst = os.path.join(ctx["tmp"], "out.wav")
    wavio.write(src, x.T, RATE, subtype="float32")
    rsp = render.render_file(render.build_parser().parse_args(
        [src, dst, "--impulse", ctx["ir"], "--dtype", "float32",
         "--block", str(geo.block), "--out-format", "float32"]))
    y, rate = wavio.read(dst)
    y = y.T
    if y.shape != x.shape or rate != RATE:
        raise AssertionError(f"render output {y.shape}@{rate}, input "
                             f"{x.shape}@{RATE}")
    # the renderer the CLI's session ran, and the MAC route it traced
    bulk = rsp._bulk
    if not isinstance(bulk, BK.BulkRenderer):
        raise AssertionError("the render CLI did not take the bulk renderer")
    want = ("nonuniform", platform.bulk_nu_engine(), ctx["expect_corr_mac"])
    got = (bulk.engine, getattr(bulk, "_nu_engine", None),
           platform.corr_mac_route())
    if got != want:
        raise AssertionError(f"render took {got}, expected {want}")
    snr = worst_snr_db(y, scipy_reference(x, ctx["h"]))
    sp = StreamProcessor(flagship_config(ctx["ir"], geo),
                         ArtifactCache(os.path.join(ctx["tmp"], "profile")))
    yb = sp.process_buffer(x)
    close = worst_snr_db(y[:, :yb.shape[1]], yb)
    log(f"  render engine: {got[0]}/{got[1]}, corr MAC {got[2]}; {t} frames x "
        f"{geo.channels} ch; worst-channel SNR {snr:.2f} dB vs scipy, "
        f"{close:.2f} dB vs process_buffer")
    if not (snr >= MIN_SNR_DB and close >= MIN_SNR_DB):
        raise AssertionError("render below the 125 dB gate")
    ctx["render_x"], ctx["render_pb"] = x, yb


def _client(port, x, frame_blocks, block, out, errors):
    """JAX-free loopback client: header, then one PCM frame and its reply
    at a time (lock-step, so neither side's socket buffer can fill), then
    the flush frame and whatever the server sends before it closes."""
    try:
        c, t = x.shape
        with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
            f = s.makefile("rb")

            def reply():
                head = f.read(4)
                if len(head) < 4:
                    return None
                (n,) = struct.unpack("<I", head)
                return np.frombuffer(f.read(n), "<f4")

            s.sendall((json.dumps({"channels": c, "sample_rate": RATE,
                                   "in_format": "float_le",
                                   "out_format": "float_le"}) + "\n").encode())
            hdr = json.loads(f.readline())
            if not hdr.get("ok"):
                raise RuntimeError(f"server refused: {hdr}")
            chunks = []
            step = frame_blocks * block
            for i in range(0, t, step):
                payload = np.ascontiguousarray(
                    x[:, i:i + step].T, dtype="<f4").tobytes()
                s.sendall(struct.pack("<I", len(payload)) + payload)
                chunks.append(reply())
            s.sendall(struct.pack("<I", 0))
            while (r := reply()) is not None:
                chunks.append(r)
        out.append(np.concatenate(chunks).reshape(-1, c).T)
    except Exception as e:  # reported by the main thread
        errors.append(e)


def phase_server(ctx):
    from bfir_tpu.cli.audio_server import AudioServer
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    geo, rng = ctx["geo"], ctx["rng"]
    x = (0.25 * rng.standard_normal(
        (geo.channels, geo.server_frames * geo.frame_blocks * geo.block))
         ).astype(np.float32)
    cfg = flagship_config(ctx["ir"], geo)
    srv = AudioServer(cfg, host="127.0.0.1", port=0,
                      cache=ArtifactCache(os.path.join(ctx["tmp"], "profile")))
    srv.start()
    out, errors = [], []
    try:
        th = threading.Thread(target=_client, args=(
            srv.port, x, geo.frame_blocks, geo.block, out, errors))
        th.start()
        th.join(900)
        if th.is_alive():
            raise AssertionError("audio-server client timed out")
    finally:
        srv.stop()
    if errors:
        raise errors[0]
    y = out[0]
    sp = StreamProcessor(cfg, ArtifactCache(os.path.join(ctx["tmp"],
                                                         "profile")))
    yb = sp.process_buffer(x)
    close = worst_snr_db(y, yb[:, :y.shape[1]])
    snr = worst_snr_db(y, scipy_reference(x, ctx["h"])[:, :y.shape[1]])
    log(f"  audio server: {geo.server_frames} frames -> {y.shape[1]} frames "
        f"back; worst-channel SNR {snr:.2f} dB vs scipy, {close:.2f} dB vs "
        "process_buffer")
    if y.shape[1] != yb.shape[1] or not (snr >= MIN_SNR_DB
                                         and close >= MIN_SNR_DB):
        raise AssertionError("audio server below the gate")


def phase_extended(ctx):
    """engine_mode="extended" (df64) vs the float32 engine through the
    session — the law of tests/test_extended.py, at 8 channels x 32768
    taps. x64 is on for this phase only, so the df64 engine can hand back
    its hi+lo sum in float64 instead of rounding it to float32 (the df64
    arithmetic itself stays float32 and is what this checks: whether the
    GPU compiler's FMA contraction breaks its error-free transforms)."""
    import jax

    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor
    from bfir_tpu.io import wavio

    geo, rng = ctx["geo"], ctx["rng"]
    c, n = 8, geo.block
    taps = 32 * n
    h = (rng.standard_normal((c, taps)) * np.exp(-np.arange(taps) / (6.25 * n))
         * 0.1)
    ir = os.path.join(ctx["tmp"], "ir_ext.wav")
    wavio.write(ir, h.T, RATE, subtype="float64")
    x = rng.standard_normal((c, 40 * n)).astype(np.float32)
    ref = scipy_reference(x, h)
    g = Geometry(channels=c, taps=taps, block=n)
    snrs = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for dtype, mode in (("float64", "extended"), ("float32", "auto")):
            sp = StreamProcessor(
                flagship_config(ir, g, dtype=dtype, engine_mode=mode),
                ArtifactCache(os.path.join(ctx["tmp"], "profile")))
            y = sp.process_buffer(x)
            snrs[sp._impl] = worst_snr_db(y, ref[:, :y.shape[1]])
    finally:
        jax.config.update("jax_enable_x64", False)
    if "extended" not in snrs:
        raise AssertionError(f"engine_mode='extended' ran {list(snrs)}")
    ext = snrs.pop("extended")
    (f32_impl, f32), = snrs.items()
    log(f"  extended: {ext:.2f} dB vs {f32_impl} float32 {f32:.2f} dB "
        f"(+{ext - f32:.2f} dB)")
    if not ext >= f32 + 30.0:
        raise AssertionError("extended does not beat float32 by 30 dB")


def phase_four_cards(ctx):
    import jax
    from jax.sharding import Mesh

    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    geo, rng = ctx["geo"], ctx["rng"]
    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.array(devs[:4]).reshape(1, 4), ("c", "p"))
    x = rng.standard_normal(
        (geo.channels, geo.stream_blocks * geo.block)).astype(np.float32)
    prof = ArtifactCache(os.path.join(ctx["tmp"], "profile"))
    sp4 = StreamProcessor(flagship_config(ctx["ir"], geo,
                                          engine_mode="sharded",
                                          sharded_local="nonuniform"),
                          prof, mesh=mesh)
    y4 = stream(sp4, x, 8, geo.block)
    if sp4._impl != "sharded" or sp4._sharded.local_impl != "nonuniform":
        raise AssertionError(f"sharded engine did not build ({sp4._impl})")
    sp1 = StreamProcessor(flagship_config(ctx["ir"], geo,
                                          engine_mode="nonuniform"), prof)
    y1 = stream(sp1, x, 8, geo.block)
    snr = worst_snr_db(y4, scipy_reference(x, ctx["h"]))
    close = worst_snr_db(y4, y1)
    log(f"  four cards: mesh {dict(mesh.shape)} of {devs[0].device_kind}; "
        f"sharded/{sp4._sharded.local_impl}; worst-channel SNR {snr:.2f} dB "
        f"vs scipy, {close:.2f} dB vs single-card nonuniform")
    if not (snr >= MIN_SNR_DB and close >= MIN_SNR_DB):
        raise AssertionError("four-card engine below the 125 dB gate")


# -- main ---------------------------------------------------------------------


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or f"nvidia-smi: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engine over four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from bfir_tpu.utils import platform

    devs = jax.devices()
    if platform.backend() != "gpu":
        print(f"no GPU: JAX reports {devs[0].platform} devices",
              file=sys.stderr)
        return 2
    cache_dir = platform.enable_compile_cache()

    from bfir_tpu import native
    from bfir_tpu.utils.logging import set_print_callback

    engine_log = EngineLog()
    set_print_callback(engine_log)
    geo = FLAGSHIP
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=os.path.dirname(
                                         os.path.abspath(__file__))) as tmp:
        ir, h = make_files(tmp, geo, args.seed)
        ctx = {"geo": geo, "rng": np.random.default_rng(args.seed + 1),
               "tmp": tmp, "ir": ir, "h": h, "expect_engine": "nonuniform",
               "expect_corr_mac": "triton"}
        t0 = time.perf_counter()
        log("(a) device")
        log(f"  card: {card_line()}")
        log(f"  jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
            f"({devs[0].platform})")
        log(f"  compile cache: {cache_dir}")
        log(f"  native codec loaded: {native.available()}")
        if args.four_cards:
            phases = [("four cards", phase_four_cards)]
        else:
            def parity(ctx):
                from bfir_tpu.core import nonuniform as NU

                sp = NU.nu_geometry(geo.taps, geo.block, ratio=8)
                hp_h = -(-sp.block_length // 128) * 128
                hp_t = -(-sp.m // 128) * 128
                failed = []
                for name, err, tol, why in kernel_parity(
                        geo.channels, sp.p_head, hp_h, sp.p_tail, hp_t,
                        8 * sp.ratio, args.seed):
                    ok = err <= tol
                    log(f"  {'ok  ' if ok else 'FAIL'} {name}: error "
                        f"{err:.3e} <= {tol:.3e} ({why})")
                    if not ok:
                        failed.append(name)
                if failed:
                    raise AssertionError(f"parity failed: {failed}")

            phases = [("(b) kernel parity", parity),
                      ("(c) streaming", phase_stream),
                      ("(d) render CLI", phase_render),
                      ("(e) audio server", phase_server),
                      ("(f) extended precision", phase_extended)]
        failed = []
        for name, fn in phases:
            log(name)
            t1 = time.perf_counter()
            try:
                fn(ctx)
            except Exception as e:  # every phase runs; any failure fails
                import traceback

                traceback.print_exc()
                failed.append(name)
                log(f"  FAILED: {e!r}")
            log(f"  wall {time.perf_counter() - t1:.1f} s")
        bad = engine_log.failures()
        if bad:
            log(f"engine fallbacks logged: {bad}")
            failed.append("engine fallback")
        log(f"total wall {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
