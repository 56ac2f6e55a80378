"""Offline render CLI: filter a WAV through a configured chain.

    python -m bfir_tpu.cli.render in.wav out.wav \
        [--impulse ir.wav [--impulse-level DB]] ... \
        [--eq "b0,b1,...,b30" --eq-level DB] \
        [--block 1024] [--dtype float64] [--out-format pcm16] [--dither] \
        [--serve PORT]

Convenience front-end the reference does not have (its host is foobar2000);
the engine path exercised is identical to the streaming plugin path. With
``--serve`` the control server runs during rendering, exposing the same TCP
protocol as the reference plugin.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from bfir_tpu.core.spec import (
    ChainSpec,
    EngineConfig,
    EqSpec,
    FilterSpec,
    ImpulseFileSpec,
    SampleFormat,
    StreamSpec,
)
from bfir_tpu.engine.session import StreamProcessor
from bfir_tpu.io import wavio

_SUBTYPE_FOR_FORMAT = {
    "pcm16": (SampleFormat.S16_LE, "pcm16"),
    "pcm24": (SampleFormat.S24_LE, "pcm24"),
    "pcm32": (SampleFormat.S32_LE, "pcm32"),
    "float32": (SampleFormat.FLOAT_LE, "float32"),
    "float64": (SampleFormat.FLOAT64_LE, "float64"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bfir-render", description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--impulse", action="append", default=[],
                   help="impulse WAV (repeat up to 3x)")
    p.add_argument("--impulse-level", action="append", type=float, default=[],
                   help="level dB for the matching --impulse")
    p.add_argument("--eq", help="31 comma-separated band gains in dB")
    p.add_argument("--eq-level", type=float, default=0.0)
    p.add_argument("--block", type=int, default=1024)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    p.add_argument("--out-format", choices=sorted(_SUBTYPE_FOR_FORMAT), default="float32")
    p.add_argument("--dither", action="store_true",
                   help="hp-TPDF dither + error feedback for integer output formats")
    p.add_argument("--resample", action="store_true",
                   help="resample impulse files whose rate differs from the input")
    p.add_argument("--auto-attenuate", action="store_true",
                   help="apply the white-noise headroom probe to each impulse")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="run the TCP control server on PORT during rendering "
                        "(same protocol as the reference plugin)")
    p.add_argument("--engine-mode",
                   choices=["auto", "complex", "packed", "hc", "nonuniform",
                            "nonuniform_split", "nonuniform3", "extended",
                            "sharded"],
                   default="auto",
                   help="compute path (default auto: the non-uniform "
                        "engine for long filters on an accelerator, complex "
                        "jnp on CPU, df64 'extended' for float64 with x64 "
                        "off)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (skip any accelerator; useful "
                        "when the device is busy or for reproducibility)")
    p.add_argument("--delay", metavar="SAMPLES[,SAMPLES...]",
                   help="per-channel output delay in samples (one value "
                        "broadcasts to all channels) — the reference "
                        "library's delay capability, delay.cpp:495-600")
    p.add_argument("--subdelay", metavar="STEPS[,STEPS...]",
                   help="per-channel fractional delay in 1/16-sample steps "
                        "(±15), via the Kaiser-sinc interpolator bank "
                        "(delay.cpp:182-306; adds 16 samples of latency)")
    return p


def config_from_args(args) -> EngineConfig:
    files = []
    for i, path in enumerate(args.impulse[:3]):
        level_db = args.impulse_level[i] if i < len(args.impulse_level) else 0.0
        files.append(ImpulseFileSpec(enabled=True, filename=path,
                                     level_steps=int(round(level_db * 10)),
                                     resample=args.resample))
    while len(files) < 3:
        files.append(ImpulseFileSpec())
    eq = EqSpec()
    if args.eq:
        mags = [int(round(float(v) * 10)) for v in args.eq.split(",")]
        if len(mags) != 31:
            raise SystemExit(f"--eq needs 31 values, got {len(mags)}")
        eq = EqSpec(enabled=True, mag_steps=tuple(mags),
                    level_steps=int(round(args.eq_level * 10)))
    out_fmt, _ = _SUBTYPE_FOR_FORMAT[args.out_format]
    from bfir_tpu.core.spec import DelaySpec

    delay = DelaySpec()
    if getattr(args, "delay", None) or getattr(args, "subdelay", None):
        samples = tuple(int(v) for v in args.delay.split(",")) \
            if args.delay else (0,)
        substeps = tuple(int(v) for v in args.subdelay.split(",")) \
            if args.subdelay else (0,)
        delay = DelaySpec(enabled=True, samples=samples,
                          subsample_steps=substeps)
    return EngineConfig(
        filter=FilterSpec(block_length=args.block, n_partitions=1, dtype=args.dtype),
        stream=StreamSpec(out_format=out_fmt, apply_dither=args.dither),
        chain=ChainSpec(eq=eq, files=tuple(files)),
        delay=delay,
        engine_mode=getattr(args, "engine_mode", "auto"),
    )


def main(argv=None) -> int:
    render_file(build_parser().parse_args(argv))
    return 0


def render_file(args) -> StreamProcessor:
    """Render ``args.input`` to ``args.output`` (parsed ``build_parser``
    arguments); returns the session that rendered."""
    if args.cpu:
        # must land before any backend init
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.dtype == "float64":
            jax.config.update("jax_enable_x64", True)
    from bfir_tpu.utils import platform

    platform.enable_compile_cache()
    audio, rate = wavio.read(args.input)
    cfg = config_from_args(args)
    if args.auto_attenuate:
        from bfir_tpu.ops.noise import calculate_attenuation
        import dataclasses

        files = []
        for f in cfg.chain.files:
            if f.enabled and f.filename:
                imp, _ = wavio.read(f.filename)
                att = calculate_attenuation(imp.T, block_length=args.block,
                                            dtype=args.dtype)
                files.append(dataclasses.replace(
                    f, level_steps=f.level_steps + int(att * 10)))
            else:
                files.append(f)
        cfg = dataclasses.replace(
            cfg, chain=dataclasses.replace(cfg.chain, files=tuple(files)))

    sp = StreamProcessor(cfg)
    server = None
    if args.serve is not None:
        from bfir_tpu.cli.server import ControlServer
        from bfir_tpu.cli.store import ConfigStore

        store = ConfigStore(cfg, on_change=sp.reconfigure)
        server = ControlServer(store, port=args.serve)
        server.start()
    x = audio.T  # [C, T]
    # offline one-shot: the bulk engine (core/bulk.py, large-block batched
    # geometry — no latency constraint to pay for); render() falls back to
    # the streaming scan for configs the bulk path doesn't model (delay
    # lines, extended precision, sharded) and always returns exactly T
    # filtered frames
    y = sp.render(x, sample_rate=rate)
    if not sp._active:
        print("no chain configured; passing through", file=sys.stderr)
    t = x.shape[1]
    out_fmt, subtype = _SUBTYPE_FOR_FORMAT[args.out_format]
    if args.dither and not out_fmt.isfloat:
        # run the real dither/error-feedback output stage; the quantized
        # integers round-trip exactly through the float WAV write below
        import jax.numpy as jnp

        from bfir_tpu.ops import dither as dth
        from bfir_tpu.ops import formats as fm

        dst = dth.init_dither_state(y.shape[0], dtype=np.float64)
        of = dth.init_overflow_stats(y.shape[0], dtype=np.float64)
        q, of, dst = fm.output_stage(jnp.asarray(y), out_fmt, of, dst)
        y = np.asarray(q, dtype=np.float64) / out_fmt.full_scale
        if int(np.sum(np.asarray(of.n_overflows))) > 0:
            print(f"warning: {int(np.sum(np.asarray(of.n_overflows)))} "
                  "samples clipped during dither", file=sys.stderr)
    wavio.write(args.output, y.T, rate, subtype=subtype)
    of = sp.overflow_stats()
    if of is not None and int(np.sum(of.n_overflows)) > 0:
        print(f"warning: {int(np.sum(of.n_overflows))} overflowed samples",
              file=sys.stderr)
    print(f"rendered {t} frames x {x.shape[0]} ch @ {rate} Hz -> {args.output}")
    if server is not None:
        server.stop()
    return sp


if __name__ == "__main__":
    sys.exit(main())
