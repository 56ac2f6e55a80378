"""Streaming session: the host-application layer of the engine.

Accelerator equivalent of the plugin's DSP object ``dsp_bfir``
(foo_dsp_bfir/foo_dsp_bfir.cpp:76-410):

reference                                        here
---------                                        ----
lazy (re)init on channel/rate change (:112-140)  ``_initialize`` on first
                                                   process() or format change
chain build: EQ render + impulse load/resample   ``engine.chain.build_chain``
  + preconvolve (:150-262)
brutefir instance + set_coeff (:279-289)         jitted ``core.convolver.step``
                                                   with donated state
re-block loop accumulating 1024 frames (:303-351)  pending-buffer re-blocking
NaN/Inf abort (brutefir.cpp:313-321)             first-sample finite check on
                                                   each fetched block; engine
                                                   drops to passthrough
overflow accounting + check_overflows            ``ops.dither.OverflowStats``
  (:337-340, brutefir.cpp:370-388)                 + ``check_overflows()``
passthrough when unconfigured/failed (:352-357)  same
flush() drops the partial block (:367-370)       same
get_latency() returns 0 (:372-375)               ``reported_latency = 0``
                                                   (parity quirk; the true
                                                   algorithmic latency is one
                                                   block and is exposed as
                                                   ``algorithmic_latency``)

Config handling: the reference mutates global cfg_* vars from two threads
with no locking (SURVEY.md §5); here a config snapshot is immutable and
``reconfigure(new_config)`` swaps it atomically, taking effect at the next
block boundary (stronger than the reference, which applies changes only on
the next format change).
"""

from __future__ import annotations

import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import EngineConfig, FilterSpec, SampleFormat, StreamSpec
from bfir_tpu.engine.cache import ArtifactCache
from bfir_tpu.engine.chain import build_chain
from bfir_tpu.ops import dither as dth
from bfir_tpu.ops import formats as fm
from bfir_tpu.utils import platform
from bfir_tpu.utils.logging import pinfo


class StreamProcessor:
    def __init__(self, config: EngineConfig, cache: Optional[ArtifactCache] = None,
                 mesh=None):
        """``mesh``: optional jax.sharding.Mesh with axes ("c", "p") for
        ``engine_mode="sharded"``; defaults to all visible devices on the
        partition axis (parallel.mesh.make_mesh)."""
        self.config = config
        self.cache = cache or ArtifactCache()
        self._mesh = mesh
        self._sharded = None
        self._channels = 0
        self._rate = 0
        self._active = False
        self._failed = False
        self._state = None
        self._coeffs = None
        self._pending = None  # np [C, <N] partial input block
        self._lock = threading.RLock()
        self._step = jax.jit(cv.step, donate_argnums=0)
        self._xfade_step = jax.jit(cv.step_crossfade)
        self._xfade_packed = None
        self._pending_swap = None
        self._impl = "complex"
        self._step_packed = None
        self._nuspec = None
        self._nu_old = None  # old coeffs during a nonuniform crossfade
        self._nu_xfade = None  # (ramp, hold) jitted crossfade steps
        self._nu3_xfade = None  # jitted nu3 transition steps by (ramp, mode)
        self._nu3_stage = None  # "outer" | "inner" during a nu3 transition
        self._scan_nu = None
        self._scan_nu_fast = None
        self._dither_state = None
        self._overflow = None
        self._last_overflow = None
        self._delay_call = None
        self._delay_scan = None
        self._delay_state = None
        self._delay_vecs = ()
        self._delay_dmax = 0
        self._scan = jax.jit(cv.process_blocks, donate_argnums=0)
        self._bulk = None  # lazy BulkRenderer for render() (core/bulk.py)
        self._built_impulse = None  # chain impulse the current coeffs use
        self._built_scale = 1.0
        self.reported_latency = 0  # parity: foo_dsp_bfir.cpp:372-375
        self.n_partitions = 0
        from bfir_tpu.utils.profiling import BlockTimer

        self.block_timer = BlockTimer()

    # -- lifecycle ----------------------------------------------------------

    @property
    def algorithmic_latency(self) -> int:
        return self.config.filter.block_length

    def reconfigure(self, config: EngineConfig) -> None:
        """Swap the config snapshot; rebuild at the next block boundary.

        When the new chain keeps the engine geometry (same block length,
        partition count, dtype) the coefficients are swapped in place and the
        next block is rendered with a linear crossfade between old and new
        filters (core.convolver.step_crossfade) — glitch-free, unlike the
        reference which swaps only at full re-init."""
        with self._lock:
            self._reconfigure_locked(config)

    def _reconfigure_locked(self, config: EngineConfig) -> None:
        old_cfg = self.config
        self.config = config
        self._failed = False
        if not self._channels or not self._active:
            self._channels = 0  # full (re)build on next process()
            return
        # delay-line geometry: runtime delay-VALUE changes are applied live
        # (the reference's change_delay, delay.cpp:552-600); changes to the
        # line's build parameters (enable, fractional-ness, bank shape) or a
        # delay exceeding the built history need a rebuild
        d_old, d_new = old_cfg.delay, config.delay
        delay_compat = d_new.enabled == d_old.enabled and (
            not d_new.enabled
            or (d_new.fractional == d_old.fractional
                and d_new.step_count == d_old.step_count
                and d_new.half_length == d_old.half_length
                and max(d_new.samples) <= self._delay_dmax))
        same_geom = (
            config.filter.block_length == old_cfg.filter.block_length
            and config.filter.dtype == old_cfg.filter.dtype
            and config.stream.apply_dither == old_cfg.stream.apply_dither
            and config.nu_tail_store == old_cfg.nu_tail_store
            and config.nu_head_store == old_cfg.nu_head_store
            and config.sharded_local == old_cfg.sharded_local
            and delay_compat
            # crossfade is implemented on every engine path (complex:
            # cv.step_crossfade; sharded: ppermute crossfade step; packed:
            # kernels.spectrum_mac.step_packed_crossfade)
        )
        if not same_geom:
            self._channels = 0
            return
        stream = StreamSpec(
            n_channels=self._channels, sample_rate=self._rate,
            in_format=config.stream.in_format, out_format=config.stream.out_format,
            apply_dither=config.stream.apply_dither,
        )
        try:
            built = build_chain(config, stream, self.cache)
        except Exception as e:
            pinfo("Chain rebuild failed (%s); passing through.", e)
            self._active = False
            return
        if built.impulse is None or built.n_partitions != self.n_partitions:
            self._channels = 0  # geometry changed (or chain gone): full path
            self._pending_swap = None
            if built.impulse is None:
                self._active = False
            return
        fspec = self._runtime_filter_spec
        if self._impl == "nonuniform_split":
            # live crossfade is not implemented on the split-tail engine:
            # reconfigure = rebuild (the split schedule's staged
            # mid-transform state has no two-filter bridging form yet;
            # PARITY.md)
            self._channels = 0
            self._pending_swap = None
            return
        if self._impl == "nonuniform3" and self._nu_old is not None:
            # a second change landing mid-transition on the three-stage
            # engine takes a full rebuild (the two-stage path handles this
            # gracefully via _nu_old head-substitution; composing it across
            # two tail cadences is not worth the state machine) — documented
            # divergence, PARITY.md
            self._channels = 0
            self._pending_swap = None
            return
        if self._impl == "sharded":
            if self._sharded.local_impl == "nonuniform3":
                # live crossfade is not implemented on the sharded
                # three-stage engine: reconfigure = rebuild (mirrors the
                # single-chip nu3 mid-transition rule; PARITY.md)
                self._channels = 0
                self._pending_swap = None
                return
            if self._sharded.shared_coeffs != (
                    self._sharded.local_impl in ("hc", "nonuniform")
                    and self._impulse_shared(built.impulse)):
                # coefficient sharding (shared vs per-channel planes) is
                # baked into the shard_map specs: a sharedness change needs
                # a rebuild
                self._channels = 0
                self._pending_swap = None
                return
            new_coeffs = self._sharded.prepare_coeffs(built.impulse, scale=built.scale)
        elif self._impl == "packed":
            from bfir_tpu.kernels import spectrum_mac as K

            new_coeffs = K.pack_coeffs(built.impulse, fspec, self._channels,
                                       scale=built.scale)
        elif self._impl == "hc":
            from bfir_tpu.kernels import spectrum_mac as K

            new_coeffs = K.hc_coeffs(built.impulse, fspec, self._channels,
                                     scale=built.scale,
                                     precise=config.filter.dtype == "float64",
                                     shared=self._impulse_shared(built.impulse))
        elif self._impl == "nonuniform":
            from bfir_tpu.core import nonuniform as NU

            new_coeffs = NU.nu_coeffs(built.impulse, self._nuspec,
                                      self._channels, scale=built.scale,
                                      precise=config.filter.dtype == "float64",
                                      shared=self._impulse_shared(built.impulse))
        elif self._impl == "nonuniform3":
            from bfir_tpu.core import nonuniform as NU

            new_coeffs = NU.nu3_coeffs(built.impulse, self._nuspec,
                                       self._channels, scale=built.scale,
                                       precise=config.filter.dtype == "float64",
                                       shared=self._impulse_shared(built.impulse))
        elif self._impl == "extended":
            from bfir_tpu.kernels import extended as E

            new_coeffs = E.df_coeffs(built.impulse, fspec, self._channels,
                                     scale=built.scale)
        else:
            new_coeffs = cv.coeffs_to_spectra(built.impulse, fspec, scale=built.scale)
        self._pending_swap = new_coeffs  # picked up at the next block
        self._built_impulse = np.atleast_2d(np.asarray(built.impulse))
        self._built_scale = built.scale
        self._bulk = None  # render() geometry follows the new coefficients
        if d_new.enabled:  # live delay-value update (state/history kept)
            samples, substeps = d_new.per_channel(self._channels)
            if d_new.fractional:
                self._delay_vecs = (jnp.asarray(samples, jnp.int32),
                                    jnp.asarray(substeps, jnp.int32))
            else:
                self._delay_vecs = (jnp.asarray(samples, jnp.int32),)

    def reset(self) -> None:
        """brutefir::reset (brutefir.cpp:345-367): clear all running state."""
        if self._channels:
            self._init_runtime_state()

    def _resolve_nu_tail_store(self, engine: str) -> str:
        """Resolve nu_tail_store="auto" through
        ``utils.platform.default_tail_store`` (the known-answer self-check
        gates whatever tier it names)."""
        v = self.config.nu_tail_store
        if v != "auto":
            return v
        return platform.default_tail_store(engine)

    def _resolve_engine_mode(self) -> str:
        mode = self.config.engine_mode
        if mode == "auto":
            if (self.config.filter.dtype == "float64"
                    and not jax.config.jax_enable_x64):
                # the reference plugin is REALSIZE=8 (double,
                # foo_dsp_bfir/common.h:17); without x64 the honest way to
                # honor that request is df64 two-float arithmetic
                # (kernels/extended.py), not silent f32
                return "extended"
            if platform.is_cpu():
                return "complex"
            # Long filters take the two-stage non-uniform engine: it reads
            # ~4x fewer MAC bytes per block than the uniform engine at the
            # flagship geometry. Threshold: the two-stage machinery must
            # have >= 2x the head's coverage to amortize its tail
            # transforms; below that the uniform hc engine is the right
            # call. A failed build or self-check falls through to hc
            # automatically (_initialize).
            if self.n_partitions >= 640:
                # very long filters: the three-stage schedule's nearly flat
                # cost undercuts the two-stage one, which grows with every
                # tail partition. Falls back to 'nonuniform' on any
                # build/self-check failure.
                return "nonuniform3"
            if self.n_partitions >= 32:
                return "nonuniform"
            # hc: same outputs as packed with 11% fewer MAC bytes
            return "hc"
        return mode

    def _init_runtime_state(self) -> None:
        fspec = self._runtime_filter_spec
        if self._impl == "packed":
            from bfir_tpu.kernels import spectrum_mac as K

            self._state = K.init_packed_state(fspec, self._channels)
        elif self._impl == "hc":
            from bfir_tpu.kernels import spectrum_mac as K

            self._state = K.init_hc_state(fspec, self._channels)
        elif self._impl == "extended":
            from bfir_tpu.kernels import extended as E

            self._state = E.init_df_state(fspec, self._channels)
        elif self._impl == "nonuniform":
            from bfir_tpu.core import nonuniform as NU

            self._state = NU.init_nu_state(self._nuspec, self._channels)
            self._nu_old = None
        elif self._impl == "nonuniform_split":
            from bfir_tpu.core import nonuniform as NU

            self._state = NU.init_nu_split_state(self._nuspec,
                                                 self._channels)
        elif self._impl == "nonuniform3":
            from bfir_tpu.core import nonuniform as NU

            self._state = NU.init_nu3_state(self._nuspec, self._channels)
        elif self._impl == "sharded":
            self._state = self._sharded.init_state()
        else:
            self._state = cv.init_state(fspec, self._channels)
        self._pending = np.zeros((self._channels, 0), dtype=fspec.dtype)
        dt = np.float32 if fspec.dtype == "float32" else np.float64
        self._overflow = dth.init_overflow_stats(self._channels, dtype=dt)
        self._last_overflow = jax.tree_util.tree_map(np.asarray, self._overflow)
        if self.config.stream.apply_dither and not self.config.stream.out_format.isfloat:
            self._dither_state = dth.init_dither_state(self._channels, dtype=dt)
        else:
            self._dither_state = None
        self._build_delay(fspec)

    @staticmethod
    def _impulse_shared(impulse) -> bool:
        """True when every channel carries the SAME filter (e.g. EQ-only
        chains: the reference renders one FIR for all channels,
        prefs_eq.cpp) — the MAC kernels then read one coefficient plane
        set and broadcast, cutting coefficient HBM traffic by 1/C."""
        imp = np.asarray(impulse)
        return imp.ndim == 2 and imp.shape[0] > 1 and bool(
            (imp == imp[:1]).all())

    def _build_delay(self, fspec) -> None:
        """Per-channel output delay line (EngineConfig.delay — the reference
        library's delay capability, delay.cpp:495-600, applied at the
        engine's output like brutefir's run loop). Integer delays use the
        history-gather (ops.delay.apply_delay); any nonzero subsample step
        switches to the Kaiser-sinc fractional bank
        (ops.delay.FractionalDelayLine), which adds ``half_length`` samples
        of extra latency (the causal span of the interpolator, exactly the
        reference's subsample filter delay)."""
        dcfg = self.config.delay
        if not dcfg.enabled:
            self._delay_call = None
            self._delay_scan = None
            self._delay_state = None
            self._delay_vecs = ()
            self._delay_dmax = 0
            return
        from bfir_tpu.ops import delay as dl

        samples, substeps = dcfg.per_channel(self._channels)
        dt = jnp.float32 if fspec.dtype == "float32" else jnp.float64
        self._delay_dmax = max(max(samples), 1)
        if dcfg.fractional:
            line = dl.FractionalDelayLine(
                self._channels, self._delay_dmax, dcfg.step_count,
                dcfg.half_length, dtype=dt)
            fn = lambda st, blk, di, ds: line(st, blk.astype(dt), di, ds)
            self._delay_vecs = (jnp.asarray(samples, jnp.int32),
                                jnp.asarray(substeps, jnp.int32))
            self._delay_state = line.init_state()
        else:
            fn = lambda st, blk, d: dl.apply_delay(st, blk.astype(dt), d)
            self._delay_vecs = (jnp.asarray(samples, jnp.int32),)
            self._delay_state = dl.init_delay_state(
                self._channels, self._delay_dmax, dtype=dt)
        self._delay_call = jax.jit(fn, donate_argnums=0)
        # bulk form: per-block lax.scan (one dispatch; the fractional line's
        # [C, T, K] window gather would not scale to whole buffers)
        self._delay_scan = jax.jit(
            lambda st, blks, *v: jax.lax.scan(
                lambda s, b: fn(s, b, *v), st, blks),
            donate_argnums=0)

    def _apply_delay(self, out):
        """Apply the configured output delay to one produced block/buffer
        (device-side, stateful; no-op when delay is disabled)."""
        if self._delay_call is None:
            return out
        self._delay_state, out = self._delay_call(
            self._delay_state, jax.numpy.asarray(out), *self._delay_vecs)
        return out

    def _initialize(self, n_channels: int, rate: int) -> None:
        re_init = self._channels != 0
        self._pending_swap = None  # a queued crossfade is void after rebuild
        if re_init:
            pinfo("Reinitializing filter.")
        self._channels = n_channels
        self._rate = rate
        stream = StreamSpec(
            n_channels=n_channels,
            sample_rate=rate,
            in_format=self.config.stream.in_format,
            out_format=self.config.stream.out_format,
            apply_dither=self.config.stream.apply_dither,
        )
        try:
            built = build_chain(self.config, stream, self.cache)
        except Exception as e:  # degrade to passthrough (foo_dsp_bfir.cpp:352-357)
            pinfo("Chain build failed (%s); passing through.", e)
            self._active = False
            return
        if built.impulse is None:
            self._active = False
            return
        self.n_partitions = built.n_partitions
        self._built_impulse = np.atleast_2d(np.asarray(built.impulse))
        self._built_scale = built.scale
        self._bulk = None  # rebuilt lazily at the new geometry

        # Candidate implementations, most capable first; a failed known-answer
        # self-check (engine/selfcheck.py) falls through to the next one
        # rather than streaming wrong audio (the reference's self-verification
        # philosophy: convolver_verify_cbuf, fftw_convolver.cpp:569-602).
        first = self._resolve_engine_mode()
        chain = {"extended": ["hc", "packed"], "hc": ["packed"],
                 "nonuniform": ["hc", "packed"],
                 "nonuniform_split": ["nonuniform", "hc", "packed"],
                 "nonuniform3": ["nonuniform", "hc", "packed"],
                 # plain "sharded" auto-picks the nonuniform local engine on
                 # long filters; "sharded:uniform" forces the uniform local
                 # engine so a refused sharded-nu graph still runs sharded
                 "sharded": ["sharded:uniform", "complex"]}
        candidates = list(dict.fromkeys(
            [first] + chain.get(first, []) + ["complex"]))
        for impl in candidates:
            try:
                self._build_impl(impl, built, n_channels)
                break
            except Exception as e:
                from bfir_tpu.engine.selfcheck import EngineSelfCheckError

                if isinstance(e, EngineSelfCheckError):
                    pinfo("%s", e)
                    pinfo("Engine '%s' refused; trying next implementation.", impl)
                else:
                    pinfo("Engine '%s' failed to build (%s); trying next.", impl, e)
                continue
        else:
            pinfo("No engine implementation passed verification; passing through.")
            self._active = False
            return
        self._active = True
        fspec = self._runtime_filter_spec
        pinfo("Filter length: %u samples, %u blocks.",
              fspec.block_length, fspec.n_partitions)
        pinfo("Format: %u channels, %u Hz.", n_channels, rate)

    def _build_impl(self, impl: str, built, n_channels: int) -> None:
        """Build coefficients + jitted step + state for one implementation
        and (unless disabled) run the known-answer self-check through the
        exact production callable."""
        variant = None
        if impl.startswith("sharded"):
            impl, _, variant = impl.partition(":")
        self._impl = impl
        self._xfade_packed = None  # lazily rebound: it closes over the impl
        self._nu_xfade = None
        self._nu3_xfade = None
        self._nu_old = None
        self._nu3_stage = None
        self._nuspec = None  # set by the nu-geometry branches below
        self._scan_packed = None  # bulk lax.scan for packed/hc/extended
        fspec = self._runtime_filter_spec
        if impl == "sharded":
            from bfir_tpu.parallel.sharded import ShardedEngine

            mesh = self._resolve_mesh()
            if n_channels % mesh.shape["c"]:
                raise ValueError(
                    f"{n_channels} channels not divisible by mesh c={mesh.shape['c']}")
            # auto: long filters take the sharded two-stage engine (the
            # mesh form of the single-chip long-filter engine);
            # "sharded:uniform" (the fallback candidate) and
            # config.sharded_local force the choice. CPU meshes keep the
            # uniform default under "auto".
            want = self.config.sharded_local
            local = None
            if variant != "uniform" and want != "uniform":
                on_accel = not platform.is_cpu(mesh.devices.flat[0])
                if want == "nonuniform3" or (
                        want == "auto" and on_accel
                        and self.n_partitions >= 640):
                    # the very-long-filter tier:
                    # same crossover as single-chip auto (~600k taps)
                    local = "nonuniform3"
                elif want == "nonuniform" or (on_accel
                                              and self.n_partitions >= 32):
                    local = "nonuniform"
            shared = self._impulse_shared(built.impulse)
            try:
                self._sharded = ShardedEngine(
                    fspec, n_channels, mesh, local_impl=local,
                    nu_tail_store=self._resolve_nu_tail_store("sharded"),
                    shared_coeffs=shared)
            except ValueError:
                if local == "nonuniform3":
                    # geometry unsuitable for the three-stage split: try the
                    # two-stage engine, then uniform
                    try:
                        self._sharded = ShardedEngine(
                            fspec, n_channels, mesh, local_impl="nonuniform",
                            nu_tail_store=self._resolve_nu_tail_store("sharded"),
                            shared_coeffs=shared)
                    except ValueError:
                        self._sharded = ShardedEngine(fspec, n_channels, mesh,
                                                      shared_coeffs=shared)
                elif local == "nonuniform":
                    # geometry unsuitable for the two-stage split: uniform
                    self._sharded = ShardedEngine(fspec, n_channels, mesh,
                                                  shared_coeffs=shared)
                else:
                    raise
            self._nuspec = (self._sharded.nuspec
                            if self._sharded.local_impl in ("nonuniform",
                                                            "nonuniform3")
                            else None)
            self._coeffs = self._sharded.prepare_coeffs(built.impulse,
                                                        scale=built.scale)
            step_call = self._sharded.step
            init_state = self._sharded.init_state
        elif impl == "packed":
            from bfir_tpu.kernels import spectrum_mac as K

            self._coeffs = K.pack_coeffs(built.impulse, fspec, self._channels,
                                         scale=built.scale)
            self._step_packed = jax.jit(K.step_packed, donate_argnums=0)
            self._scan_packed = jax.jit(
                lambda s, g, blocks: jax.lax.scan(
                    lambda st, blk: K.step_packed(st, g, blk),
                    s, blocks),
                donate_argnums=0,
            )
            step_call = self._step_packed
            init_state = lambda: K.init_packed_state(fspec, self._channels)
        elif impl == "hc":
            from bfir_tpu.kernels import spectrum_mac as K

            # float64 configs get precise (host-f64) coefficient spectra:
            # build-time only cost, ~9 dB of streaming SNR (hc_coeffs doc)
            precise = self.config.filter.dtype == "float64"
            self._coeffs = K.hc_coeffs(built.impulse, fspec, self._channels,
                                       scale=built.scale, precise=precise,
                                       shared=self._impulse_shared(built.impulse))
            self._step_packed = jax.jit(K.step_hc, donate_argnums=0)
            # single-dispatch bulk form: one lax.scan over all blocks (the
            # accelerator equivalent of the reference's "no per-block overhead" —
            # brutefir.cpp:244-343 is one in-process call per block; here one
            # dispatch per buffer, exactly the graph bench.py floor-measures)
            self._scan_packed = jax.jit(
                lambda s, g, blocks: jax.lax.scan(
                    lambda st, blk: K.step_hc(st, g, blk),
                    s, blocks),
                donate_argnums=0,
            )
            step_call = self._step_packed
            init_state = lambda: K.init_hc_state(fspec, self._channels)
        elif impl == "nonuniform_split":
            from bfir_tpu.core import nonuniform as NU

            n = fspec.block_length
            taps = fspec.n_partitions * n
            nuspec = NU.nu_geometry(
                taps, n, ratio=8, dtype=fspec.dtype,
                tail_store=self._resolve_nu_tail_store("nonuniform"))
            if taps <= nuspec.p_head * n:
                raise ValueError(
                    f"filter ({taps} taps) too short for the split-tail "
                    f"engine (head alone covers {nuspec.p_head * n})")
            NU.split_band_len(nuspec)  # geometry check (128-lane bands)
            self._nuspec = nuspec
            self._coeffs = NU.nu_coeffs(
                built.impulse, nuspec, self._channels, scale=built.scale,
                precise=self.config.filter.dtype == "float64",
                shared=self._impulse_shared(built.impulse))
            self._step_packed = jax.jit(NU.step_nu_split, donate_argnums=0)
            self._scan_nu = jax.jit(
                lambda s, g, blocks: jax.lax.scan(
                    lambda st, blk: NU.step_nu_split(st, g, blk),
                    s, blocks),
                donate_argnums=0,
            )
            self._scan_nu_fast = jax.jit(
                NU.process_blocks_nu_split, donate_argnums=0)
            step_call = self._step_packed
            init_state = lambda: NU.init_nu_split_state(nuspec,
                                                        self._channels)
            pinfo("Engine: non-uniform partitions, split-tail schedule "
                  "(head %u x %u + tail %u x %u, per-phase bands).",
                  nuspec.p_head, n, nuspec.p_tail, nuspec.m)
        elif impl == "nonuniform":
            from bfir_tpu.core import nonuniform as NU

            n = fspec.block_length
            taps = fspec.n_partitions * n
            nuspec = NU.nu_geometry(
                taps, n, ratio=8, dtype=fspec.dtype,
                tail_store=self._resolve_nu_tail_store("nonuniform"),
                head_store=self.config.nu_head_store)
            if taps <= nuspec.p_head * n:
                # filter fits inside the head: the two-stage machinery would
                # only add overhead — fall through to the uniform hc engine
                raise ValueError(
                    f"filter ({taps} taps) too short for the non-uniform "
                    f"engine (head alone covers {nuspec.p_head * n})")
            self._nuspec = nuspec
            precise = self.config.filter.dtype == "float64"
            self._coeffs = NU.nu_coeffs(built.impulse, nuspec, self._channels,
                                        scale=built.scale, precise=precise,
                                        shared=self._impulse_shared(built.impulse))
            self._step_packed = jax.jit(NU.step_nu, donate_argnums=0)
            self._scan_nu = jax.jit(NU.process_blocks_nu, donate_argnums=0)
            self._scan_nu_fast = jax.jit(
                NU.process_blocks_nu_fast, donate_argnums=0)
            step_call = self._step_packed
            init_state = lambda: NU.init_nu_state(nuspec, self._channels)
            pinfo("Engine: non-uniform partitions (head %u x %u + tail "
                  "%u x %u).", nuspec.p_head, n, nuspec.p_tail, nuspec.m)
        elif impl == "nonuniform3":
            from bfir_tpu.core import nonuniform as NU

            n = fspec.block_length
            taps = fspec.n_partitions * n
            nuspec = NU.nu3_geometry(
                taps, n, ratio1=8, ratio2=8, dtype=fspec.dtype,
                tail_store=self._resolve_nu_tail_store("nonuniform3"))
            # only pay three stages when the filter outgrows what the
            # two-stage inner head alone would cover
            two_stage_head = nuspec.p_head * n + nuspec.inner.p_head * nuspec.m1
            if taps <= two_stage_head:
                raise ValueError(
                    f"filter ({taps} taps) too short for the three-stage "
                    f"engine (two stages cover {two_stage_head})")
            self._nuspec = nuspec
            precise = self.config.filter.dtype == "float64"
            self._coeffs = NU.nu3_coeffs(built.impulse, nuspec, self._channels,
                                         scale=built.scale, precise=precise,
                                         shared=self._impulse_shared(built.impulse))
            self._step_packed = jax.jit(NU.step_nu3, donate_argnums=0)
            self._scan_nu = jax.jit(NU.process_blocks_nu3, donate_argnums=0)
            self._scan_nu_fast = jax.jit(
                NU.process_blocks_nu3_fast, donate_argnums=0)
            step_call = self._step_packed
            init_state = lambda: NU.init_nu3_state(nuspec, self._channels)
            pinfo("Engine: three-stage non-uniform partitions (head %u x %u "
                  "+ mid %u x %u + far %u x %u).",
                  nuspec.p_head, n, nuspec.inner.p_head, nuspec.m1,
                  nuspec.inner.p_tail, nuspec.inner.m)
        elif impl == "extended":
            from bfir_tpu.kernels import extended as E

            pinfo("Engine precision: extended (df64 two-float, f64-class "
                  "on an f32 backend).")
            self._coeffs = E.df_coeffs(built.impulse, fspec, self._channels,
                                       scale=built.scale)
            self._step_packed = jax.jit(
                lambda s, g, blk: E.step_df(s, g[0], g[1], blk),
                donate_argnums=0,
            )
            self._scan_packed = jax.jit(
                lambda s, g, blocks: jax.lax.scan(
                    lambda st, blk: E.step_df(st, g[0], g[1], blk), s, blocks),
                donate_argnums=0,
            )
            step_call = self._step_packed
            init_state = lambda: E.init_df_state(fspec, self._channels)
        else:
            self._coeffs = cv.coeffs_to_spectra(built.impulse, fspec, scale=built.scale)
            step_call = self._step
            init_state = lambda: cv.init_state(fspec, self._channels)
        if self.config.self_check:
            from bfir_tpu.engine import selfcheck

            scaled = np.asarray(built.impulse, dtype=np.float64) * built.scale
            # the non-uniform engine's tail only reaches the output after
            # (D+1) tail fires: stream enough blocks that a tail-stage
            # miscompile cannot hide behind a correct head
            sharded_nu = (impl == "sharded"
                          and self._sharded.local_impl == "nonuniform")
            sharded_nu3 = (impl == "sharded"
                           and self._sharded.local_impl == "nonuniform3")
            if impl in ("nonuniform", "nonuniform_split") or sharded_nu:
                n_blocks = (self._nuspec.delay_blocks + 2) * self._nuspec.ratio
            elif impl == "nonuniform3" or sharded_nu3:
                # enough blocks that the FAR stage's first pending output
                # has landed: inner warm-up in M1-blocks, times r1
                inner = self._nuspec.inner
                n_blocks = ((inner.delay_blocks + 2) * inner.ratio
                            + self._nuspec.delay_blocks) * self._nuspec.ratio1
            else:
                n_blocks = 3
            # a bfloat16 tail store legitimately sits near ~56 dB + the
            # tail's energy deficit (NuSpec.tail_store doc) — the default
            # 80 dB gate would silently demote it to 'hc'. A miscompile is
            # still O(1) wrong (~4 dB), so 35 dB keeps the guard honest.
            min_snr = (35.0 if (impl in ("nonuniform", "nonuniform_split",
                                         "nonuniform3")
                                or sharded_nu or sharded_nu3)
                       and self.config.nu_tail_store == "bfloat16"
                       else selfcheck.DEFAULT_MIN_SNR_DB)
            label = f"engine '{impl}'"
            extra = ""
            if self._nuspec is not None and (
                    impl in ("nonuniform", "nonuniform_split", "nonuniform3")
                    or sharded_nu or sharded_nu3):
                extra = repr(self._nuspec)
            if impl == "sharded":
                # a miscompile can be mesh-shape- or local-impl-specific:
                # the verdict must not transfer across them
                mesh = self._sharded.mesh
                label += f" ({self._sharded.local_impl})"
                extra += f"|mesh={dict(mesh.shape)}|{self._sharded.local_impl}"
            selfcheck.check_stream(step_call, init_state, self._coeffs, scaled,
                                   fspec, n_channels, n_blocks=n_blocks,
                                   min_snr_db=min_snr,
                                   label=label,
                                   cache_file=self.cache.path("selfcheck-cache.json"),
                                   cache_extra=extra)
        self._init_runtime_state()

    @property
    def _runtime_filter_spec(self) -> FilterSpec:
        """The filter spec with the partition count implied by the chain
        (the plugin derives filter_blocks from the impulse length,
        foo_dsp_bfir.cpp:270-272). float64 degrades to float32 with a
        warning when x64 is off: better an explicit decision
        than jax's silent truncation + per-op warning spam."""
        dtype = self.config.filter.dtype
        if dtype == "float64" and not jax.config.jax_enable_x64:
            if self._impl != "extended" and not getattr(self, "_warned_f64", False):
                pinfo("float64 unavailable (x64 disabled); engine runs float32 "
                      "(engine_mode='extended' gives df64 two-float precision).")
                self._warned_f64 = True
            dtype = "float32"
        parts = max(1, self.n_partitions)
        if self._impl == "sharded":
            # partitions must divide evenly over the mesh "p" axis; round up
            # (the extra partitions hold zero coefficients — exact output)
            p_shards = self._resolve_mesh().shape["p"]
            parts = -(-parts // p_shards) * p_shards
        return FilterSpec(
            block_length=self.config.filter.block_length,
            n_partitions=parts,
            dtype=dtype,
        )

    def _nu_phase(self) -> int:
        """Current block phase within the tail's M-block cycle."""
        return int(np.asarray(self._state.head.blockcounter)) % self._nuspec.ratio

    @property
    def _nu_protocol(self) -> bool:
        """True when the engine crossfades by the two-stage protocol (head
        ramp + bridging tail fire): the nonuniform engine, single-chip or
        sharded."""
        return (self._impl == "nonuniform"
                or (self._impl == "sharded" and self._sharded is not None
                    and self._sharded.local_impl == "nonuniform"))

    def _nu_xfade_steps(self):
        """Lazily jitted (ramp, hold) crossfade steps for the nonuniform
        engine (ramp: intra-block head crossfade; hold: new head, still
        waiting for the bridging tail fire). The sharded engine supplies
        its own sharded pair (parallel.sharded.nu_crossfade_steps)."""
        if self._nu_xfade is None:
            if self._impl == "sharded":
                self._nu_xfade = self._sharded.nu_crossfade_steps()
                return self._nu_xfade
            from bfir_tpu.core import nonuniform as NU
            mk = lambda hr: jax.jit(
                lambda s, o, nw, blk: NU.step_nu_crossfade(
                    s, o, nw, blk, head_ramp=hr))
            self._nu_xfade = (mk(True), mk(False))
        return self._nu_xfade

    def _nu3_xfade_steps(self):
        """Lazily jitted three-stage transition steps keyed by
        (head_ramp, inner_mode) — the sequence step_nu3_crossfade's
        docstring defines; the block loop drives it host-side."""
        if self._nu3_xfade is None:
            from bfir_tpu.core import nonuniform as NU
            mk = lambda hr, mode: jax.jit(
                lambda s, o, nw, blk: NU.step_nu3_crossfade(
                    s, o, nw, blk, head_ramp=hr, inner_mode=mode))
            self._nu3_xfade = {
                (True, "ramp"): mk(True, "ramp"),
                (False, "ramp"): mk(False, "ramp"),
                (False, "hold"): mk(False, "hold"),
            }
        return self._nu3_xfade

    def _nu3_fire_phases(self):
        """(outer_fires, inner_fires) for the block about to be stepped."""
        cnt = int(np.asarray(self._state.head.blockcounter))
        r1 = self._nuspec.ratio1
        r2 = self._nuspec.inner.ratio
        return (cnt % r1 == r1 - 1, (cnt // r1) % r2 == r2 - 1)

    def _resolve_mesh(self):
        if self._mesh is None:
            from bfir_tpu.parallel import mesh as M

            self._mesh = M.make_mesh()
        return self._mesh

    # -- streaming ----------------------------------------------------------

    def process(self, frames: np.ndarray, sample_rate: Optional[int] = None) -> np.ndarray:
        """Push ``frames`` [C, T] (engine float domain, +-1 full scale);
        returns the filtered frames produced by completed blocks (possibly
        fewer than T; the remainder is held until the next call).

        Passthrough (frames returned unmodified) when no chain is active or
        after a NaN abort. Thread-safe against concurrent reconfigure().
        """
        with self._lock:
            return self._process_locked(frames, sample_rate)

    # maximum blocks dispatched ahead of their output fetch: bounds device
    # memory held by pending outputs (and pathological queue depth) on very
    # long process() calls while keeping the fetch round-trips overlapped
    MAX_INFLIGHT = 64

    def _drain_inflight(self, inflight, outs, keep: int = 0) -> bool:
        """Fetch pipelined block outputs in order (down to ``keep`` still
        pending), NaN-guarding each (the guard runs at least one block
        behind the newest dispatch — SURVEY §7 hard part (b)). Returns False
        on NaN abort, with the offending raw block
        appended passthrough-style."""
        # start all device->host copies before the first blocking read:
        # fetches overlap instead of serializing one round-trip each
        for _, dev in inflight:
            try:
                dev.copy_to_host_async()
            except (AttributeError, RuntimeError):
                break  # non-jax output or backend without async copies
        while len(inflight) > keep:
            blk_np, dev = inflight.pop(0)
            out_np = np.asarray(dev)
            if not np.isfinite(out_np[0, 0]):
                pinfo("NaN or Inf values in the system! Invalid input? Aborting.")
                self._failed = True
                # pass the offending block AND every later dispatched block
                # through (their raw inputs) — sync-path/reference semantics
                # (brutefir.cpp:313-321) lose no samples on abort
                outs.append(blk_np)
                outs.extend(b for b, _ in inflight)
                inflight.clear()
                return False
            if self.config.stream.out_format.isfloat:
                self._overflow = fm.count_float_overflow(dev, self._overflow)
            outs.append(out_np)
            if self.config.overflow_warnings:
                self.check_overflows()
        return True

    def _process_locked(self, frames, sample_rate=None) -> np.ndarray:
        frames = np.atleast_2d(np.asarray(frames))
        rate = sample_rate or self._rate or self.config.stream.sample_rate
        if frames.shape[0] != self._channels or rate != self._rate:
            self._initialize(frames.shape[0], rate)
        if not self._active or self._failed:
            return frames

        import time as _time

        n = self.config.filter.block_length
        buf = np.concatenate([self._pending, frames.astype(self._pending.dtype)], axis=1)
        outs = []
        # plain steps are PIPELINED: dispatch block k+1 before synchronizing
        # block k (async JAX dispatch + donated state make this safe), so the
        # host<->device round-trip of the output fetch overlaps the next
        # block's compute. The reference never faced this (in-process FFTW,
        # brutefir.cpp:244-343). Stateful special blocks (coefficient
        # crossfades) flush the pipeline first.
        inflight = []  # [(raw block, device out)] dispatched, not fetched
        t_pipe0 = None
        n_pipe = 0
        while buf.shape[1] >= n:
            block, buf = buf[:, :n], buf[:, n:]
            swap = self._pending_swap
            if swap is None and self._nu_old is None:
                if t_pipe0 is None:
                    t_pipe0 = _time.perf_counter()
                n_pipe += 1
                if self._impl in ("packed", "hc", "extended", "nonuniform",
                                  "nonuniform_split",
                                  "nonuniform3"):
                    self._state, out = self._step_packed(self._state, self._coeffs, block)
                elif self._impl == "sharded":
                    self._state, out = self._sharded.step(self._state, self._coeffs, block)
                else:
                    self._state, out = self._step(self._state, self._coeffs, block)
                inflight.append((block, self._apply_delay(out)))
                if len(inflight) >= self.MAX_INFLIGHT:
                    # partial drain: fetch the older half, keep the pipeline
                    # primed (fetches of the kept half stay overlapped)
                    if not self._drain_inflight(inflight, outs,
                                                keep=self.MAX_INFLIGHT // 2):
                        self._pending = buf[:, :0]
                        return np.concatenate(outs, axis=1)
                continue
            # special (crossfade) block: flush the pipeline, then step
            # synchronously as before
            n_burst = len(inflight)
            ok = self._drain_inflight(inflight, outs)
            if n_burst and t_pipe0 is not None:
                per_block = (_time.perf_counter() - t_pipe0) / n_burst
                for _ in range(n_burst):
                    self.block_timer.add(per_block)
                t_pipe0 = None
                n_pipe = 0
            if not ok:
                self._pending = buf[:, :0]
                return np.concatenate(outs, axis=1)
            with self.block_timer.measure():
                if swap is not None and self._impl == "nonuniform3":
                    # three-stage transition: outer head
                    # ramps now; the inner engine bridges at its next step
                    # (its own ramp), its far stage at its next fire — see
                    # core.nonuniform.step_nu3_crossfade. The block loop
                    # tracks the stage machine host-side.
                    self._pending_swap = None
                    steps3 = self._nu3_xfade_steps()
                    fires, inner_fires = self._nu3_fire_phases()
                    self._state, out = steps3[(True, "ramp")](
                        self._state, self._coeffs, swap, block)
                    if fires and inner_fires:
                        self._nu_old = None  # whole transition in one block
                    else:
                        self._nu_old = self._coeffs
                        self._nu3_stage = "inner" if fires else "outer"
                    self._coeffs = swap
                elif (swap is None and self._impl == "nonuniform3"
                      and self._nu_old is not None):
                    steps3 = self._nu3_xfade_steps()
                    fires, inner_fires = self._nu3_fire_phases()
                    mode = "ramp" if self._nu3_stage == "outer" else "hold"
                    self._state, out = steps3[(False, mode)](
                        self._state, self._nu_old, self._coeffs, block)
                    if fires:
                        if inner_fires:
                            self._nu_old = None  # far stage bridged: done
                            self._nu3_stage = None
                        else:
                            self._nu3_stage = "inner"
                elif swap is not None and self._nu_protocol:
                    # two-stage crossfade: intra-block head ramp now; the
                    # tail bridges at its first fire after the change (one
                    # extra MAC there) — see core.nonuniform.step_nu_crossfade.
                    # If a previous swap's bridging tail fire is still
                    # pending (_nu_old), the tail's old side must stay the
                    # coefficients that produced the queued pending blocks —
                    # not the intermediate set — or the tail contribution
                    # steps discontinuously at the next M-block boundary.
                    self._pending_swap = None
                    ramp_step, _ = self._nu_xfade_steps()
                    fired = self._nu_phase() == self._nuspec.ratio - 1
                    old = (self._coeffs if self._nu_old is None
                           else self._nu_old._replace(head=self._coeffs.head))
                    self._state, out = ramp_step(self._state, old, swap, block)
                    self._nu_old = None if fired else old
                    self._coeffs = swap
                elif swap is None and self._nu_old is not None:
                    # nonuniform transition: waiting for the bridging tail
                    # fire; head already runs the new coefficients
                    _, hold_step = self._nu_xfade_steps()
                    fired = self._nu_phase() == self._nuspec.ratio - 1
                    self._state, out = hold_step(
                        self._state, self._nu_old, self._coeffs, block)
                    if fired:
                        self._nu_old = None
                elif swap is not None:
                    self._pending_swap = None
                    if self._impl == "sharded":
                        self._state, out = self._sharded.step_crossfade(
                            self._state, self._coeffs, swap, block)
                    elif self._impl in ("packed", "hc", "extended"):
                        if self._xfade_packed is None:
                            if self._impl == "extended":
                                from bfir_tpu.kernels import extended as E

                                self._xfade_packed = jax.jit(E.step_df_crossfade)
                            else:
                                from bfir_tpu.kernels import spectrum_mac as K

                                xf = (K.step_hc_crossfade if self._impl == "hc"
                                      else K.step_packed_crossfade)
                                self._xfade_packed = jax.jit(
                                    lambda s, o, nw, blk: xf(
                                        s, o, nw, blk))
                        self._state, out = self._xfade_packed(
                            self._state, self._coeffs, swap, block)
                    else:
                        self._state, out = self._xfade_step(
                            self._state, self._coeffs, swap, block)
                    self._coeffs = swap
                out_np = np.asarray(self._apply_delay(out))
            # single-sample NaN/Inf guard (brutefir.cpp:313-321)
            if not np.isfinite(out_np[0, 0]):
                pinfo("NaN or Inf values in the system! Invalid input? Aborting.")
                self._failed = True
                self._pending = buf[:, :0]
                # keep prior good output; pass the offending block through
                return np.concatenate(outs + [block], axis=1) if outs else block
            if self.config.stream.out_format.isfloat:
                self._overflow = fm.count_float_overflow(out, self._overflow)
            outs.append(out_np)
            if self.config.overflow_warnings:
                self.check_overflows()
        ok = self._drain_inflight(inflight, outs)
        if n_pipe and t_pipe0 is not None:
            # pipelined latencies only exist per burst; record the honest
            # per-block average (dispatch + overlapped fetch)
            per_block = (_time.perf_counter() - t_pipe0) / n_pipe
            for _ in range(n_pipe):
                self.block_timer.add(per_block)
        if not ok:
            self._pending = buf[:, :0]
            return np.concatenate(outs, axis=1) if outs else frames[:, :0]
        self._pending = buf
        if not outs:
            return frames[:, :0]
        return np.concatenate(outs, axis=1)

    def process_buffer(self, frames: np.ndarray,
                       sample_rate: Optional[int] = None) -> np.ndarray:
        """Offline/bulk variant of ``process``: all complete blocks go
        through one jitted ``lax.scan`` dispatch (identical outputs to the
        block loop; far fewer host round-trips). The partial tail is held
        like ``process``."""
        with self._lock:
            return self._process_buffer_locked(frames, sample_rate)

    def _process_buffer_locked(self, frames, sample_rate=None) -> np.ndarray:
        frames = np.atleast_2d(np.asarray(frames))
        rate = sample_rate or self._rate or self.config.stream.sample_rate
        if frames.shape[0] != self._channels or rate != self._rate:
            self._initialize(frames.shape[0], rate)
        if not self._active or self._failed:
            return frames
        # decided only after (re)initialization: a queued crossfade needs the
        # block loop (the scan paths handle plain steps only)
        if self._pending_swap is not None or self._nu_old is not None:
            return self._process_locked(frames, sample_rate)

        n = self.config.filter.block_length
        buf = np.concatenate([self._pending, frames.astype(self._pending.dtype)], axis=1)
        n_blocks = buf.shape[1] // n
        if n_blocks == 0:
            self._pending = buf
            return frames[:, :0]
        c = buf.shape[0]
        blocks = buf[:, : n_blocks * n].reshape(c, n_blocks, n).transpose(1, 0, 2)
        self._pending = buf[:, n_blocks * n :]
        if self._impl == "sharded":
            self._state, outs = self._sharded.process_blocks(
                self._state, self._coeffs, jax.numpy.asarray(blocks))
        elif self._impl == "nonuniform3":
            sup = self._nuspec.ratio1 * self._nuspec.inner.ratio
            aligned = (int(np.asarray(self._state.head.blockcounter)) % sup == 0
                       and n_blocks % sup == 0)
            scan = self._scan_nu_fast if aligned else self._scan_nu
            self._state, outs = scan(self._state, self._coeffs,
                                     jax.numpy.asarray(blocks))
        elif self._impl in ("nonuniform", "nonuniform_split"):
            # M-cycle-aligned bulk work takes the cond-free macro scan
            # (identical outputs; no per-block tail-state pass-through /
            # switch)
            aligned = (self._nu_phase() == 0
                       and n_blocks % self._nuspec.ratio == 0)
            scan = self._scan_nu_fast if aligned else self._scan_nu
            self._state, outs = scan(self._state, self._coeffs,
                                     jax.numpy.asarray(blocks))
        elif self._impl in ("packed", "hc", "extended"):
            self._state, outs = self._scan_packed(self._state, self._coeffs,
                                                  jax.numpy.asarray(blocks))
        else:
            self._state, outs = self._scan(self._state, self._coeffs, blocks)
        out_np = np.asarray(outs)  # [B, C, N]
        if not np.isfinite(out_np[0, 0, 0]):
            pinfo("NaN or Inf values in the system! Invalid input? Aborting.")
            self._failed = True
            return blocks.transpose(1, 0, 2).reshape(c, -1)
        if self._delay_call is not None:
            self._delay_state, outs = self._delay_scan(
                self._delay_state, jax.numpy.asarray(out_np),
                *self._delay_vecs)
            out_np = np.asarray(outs)
        y = out_np.transpose(1, 0, 2).reshape(c, -1)
        if self.config.stream.out_format.isfloat:
            self._overflow = fm.count_float_overflow(jax.numpy.asarray(y), self._overflow)
        return y

    def render(self, frames: np.ndarray,
               sample_rate: Optional[int] = None) -> np.ndarray:
        """One-shot OFFLINE render of [C, T] -> [C, T] at the bulk geometry.

        Unlike ``process``/``process_buffer`` this does not have (or pay
        for) the one-block latency constraint: the filter is re-partitioned
        at a large block size and run through the batched block-axis-FFT
        formulation (core/bulk.py), which is the fastest way through the
        chip when the whole input exists up front. Output is the exact same
        linear convolution the streaming engines produce (to fp rounding).
        On the bulk path this is stateless with respect to the streaming
        engine: it neither reads nor advances the streaming state (the
        reference's offline use streams through the engine instead,
        preprocessor.cpp:143-148).

        Falls back to ``process_buffer`` (which, like any processing call,
        advances the streaming engine) for paths the bulk engine does not
        model: pending crossfades, runtime delay lines, the df64 'extended'
        precision mode (bulk would silently degrade an honored float64
        request), and sharded execution.
        """
        with self._lock:
            frames = np.atleast_2d(np.asarray(frames))
            rate = sample_rate or self._rate or self.config.stream.sample_rate
            if frames.shape[0] != self._channels or rate != self._rate:
                self._initialize(frames.shape[0], rate)
            if not self._active or self._failed:
                return frames
            if (self._pending_swap is not None or self._nu_old is not None
                    or self._nu3_stage is not None
                    or self._delay_call is not None
                    or self._impl in ("extended", "sharded")):
                out = self._process_buffer_locked(frames, sample_rate)
                # flush the engine's partial-block tail so render() always
                # returns exactly T filtered frames like the bulk path does
                t = frames.shape[1]
                if out.shape[1] < t:
                    n = self.config.filter.block_length
                    short = t - out.shape[1]
                    pad = np.zeros((frames.shape[0], -(-short // n) * n),
                                   dtype=out.dtype)
                    tail = self._process_buffer_locked(pad, sample_rate)
                    out = np.concatenate([out, tail], axis=1)
                return out[:, :t]
            if self._bulk is None:
                from bfir_tpu.core import bulk as BK

                dtype = self._runtime_filter_spec.dtype
                bulk = BK.BulkRenderer(
                    self._built_impulse, self._channels,
                    scale=self._built_scale, dtype=dtype)
                if self.config.self_check:
                    # same miscompile defense as the streaming engines: one
                    # known-answer dispatch through the exact jitted graph.
                    # Engine-agnostic: drive render() itself for one
                    # dispatch of noise and compare against scipy.
                    from scipy import signal

                    from bfir_tpu.engine import selfcheck

                    scaled = (self._built_impulse.astype(np.float64)
                              * self._built_scale)
                    rng = np.random.default_rng(0xB01C)
                    t_chk = (bulk.spec.samples_per_dispatch
                             if bulk.engine == "batch"
                             else 24 * bulk._nuspec.ratio
                             * bulk._nuspec.block_length)
                    x_chk = rng.standard_normal(
                        (self._channels, t_chk)).astype(np.float32)
                    y_chk = bulk.render(x_chk)
                    ref = np.stack([signal.fftconvolve(
                        x_chk[ch].astype(np.float64),
                        scaled[0] if scaled.shape[0] == 1 else scaled[ch])
                        [: t_chk] for ch in range(self._channels)])
                    snr = selfcheck._worst_snr_db(
                        y_chk.astype(np.float64), ref)
                    if not np.isfinite(snr) or snr < 80.0:
                        raise selfcheck.EngineSelfCheckError(
                            f"bulk render ({bulk.engine}) known-answer "
                            f"check FAILED: worst-channel SNR {snr:.1f} dB "
                            "— refusing the bulk graph (possible backend "
                            "miscompile)")
                    pinfo("Self-check (bulk render, %s): worst-channel SNR "
                          "%.1f dB.", bulk.engine, snr)
                self._bulk = bulk
            y = self._bulk.render(frames)
            if self.config.stream.out_format.isfloat and self._overflow is not None:
                self._overflow = fm.count_float_overflow(
                    jax.numpy.asarray(y), self._overflow)
            return y

    def process_raw(self, raw: bytes, sample_rate: Optional[int] = None) -> bytes:
        """Full raw-format path: decode input bytes per the configured
        in_format, filter, and encode per out_format with dither — the
        convolver_raw2cbuf / cbuf2raw boundary (fftw_convolver.cpp:156,405).
        """
        sfmt = self.config.stream.in_format
        ofmt = self.config.stream.out_format
        # channels from config for raw mode
        c = self.config.stream.n_channels
        x = fm.decode(raw, sfmt, c, dtype=np.dtype(self.config.filter.dtype))
        y = self.process(x, sample_rate)
        if ofmt.isfloat:
            return fm.encode_float(y, ofmt)
        # passthrough (inactive chain / failed) still quantizes to the
        # output format; runtime stats may not exist yet in that case
        if self._overflow is None:
            dt = np.float32 if self.config.filter.dtype == "float32" else np.float64
            self._overflow = dth.init_overflow_stats(y.shape[0], dtype=dt)
        if (self.config.stream.apply_dither and self._dither_state is None):
            dt = np.float32 if self.config.filter.dtype == "float32" else np.float64
            self._dither_state = dth.init_dither_state(y.shape[0], dtype=dt)
        scaled, self._overflow, self._dither_state = fm.output_stage(
            jax.numpy.asarray(y), ofmt, self._overflow, self._dither_state
        )
        return fm.encode_int(np.asarray(scaled), ofmt)

    def flush(self) -> None:
        """Drop any partial block (foo_dsp_bfir.cpp:367-370)."""
        if self._pending is not None:
            self._pending = self._pending[:, :0]

    # -- observability ------------------------------------------------------

    def overflow_stats(self):
        if self._overflow is None:
            return None
        return jax.tree_util.tree_map(np.asarray, self._overflow)

    def check_overflows(self) -> None:
        """Print per-channel peak/overflow on change
        (brutefir::check_overflows + print_overflows, brutefir.cpp:370-388,
        585-629)."""
        cur = self.overflow_stats()
        if cur is None:
            return
        changed = any(
            not np.array_equal(a, b)
            for a, b in zip(jax.tree_util.tree_leaves(cur),
                            jax.tree_util.tree_leaves(self._last_overflow))
        )
        if changed:
            self._last_overflow = cur
            for ch in range(self._channels):
                peak = float(cur.largest[ch])
                peak_db = 20 * np.log10(peak) if peak > 0 else -np.inf
                pinfo("Channel %d: overflows %d, peak %.2f dBFS",
                      ch, int(cur.n_overflows[ch]), peak_db)
