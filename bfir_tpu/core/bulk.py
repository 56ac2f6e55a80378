"""Offline/bulk rendering engine: large-block batched partitioned convolution.

The streaming engines (core.convolver / core.nonuniform) are shaped by the
one-block latency constraint: a 1024-sample block must produce its output
before the next arrives, which forces small partitions (or the two-stage
schedule) and per-block dispatches. Offline rendering has NO latency
constraint — the whole input exists up front — so the optimal geometry is
different. Two engines:

- LONG filters (>= ``NU_BULK_MIN_TAPS``): the non-uniform schedule in its
  bulk form — on accelerators the G-cycle batched scan (``core.nubatch``,
  G=8: every stage one batched dispatch, coefficient planes read once per
  iteration); on the CPU the split-tail scan. ``utils.platform.
  bulk_nu_engine`` names the choice.
- shorter filters: re-partition at a large block size M (fewer, fatter
  partitions) and run the batched block-axis-FFT formulation
  (``core.convolver.process_batch``) over many M-blocks per dispatch.

Outputs are the exact linear convolution either way (overlap-save is exact
at any block size), so a bulk render is interchangeable with the streaming
engine's output to fp rounding — verified against scipy in
tests/test_bulk.py, and at full size on the GPU by chip_smoke.py.

Reference behavior being reimplemented: the reference reuses its streaming
engine for offline work (preprocessor.cpp:143-148 streams impulses through
a brutefir instance block by block); it has no bulk-optimized path — this
module is the accelerator replacement for that reuse. The session's
``render`` keeps a known-answer scipy check in front of the first use of
the compiled graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax

from bfir_tpu.core import convolver as cv
from bfir_tpu.core.spec import FilterSpec


@dataclass(frozen=True)
class BulkSpec:
    """Bulk render geometry: partition/block size M, partition count P at M,
    and the number of M-blocks per batched dispatch."""

    block_length: int
    n_partitions: int
    batch_blocks: int
    dtype: str = "float32"

    @property
    def filter_spec(self) -> FilterSpec:
        return FilterSpec(self.block_length, self.n_partitions, self.dtype)

    @property
    def samples_per_dispatch(self) -> int:
        return self.block_length * self.batch_blocks


def bulk_geometry(taps: int, dtype: str = "float32",
                  max_block: int = 8192,
                  samples_per_dispatch: int = 245760) -> BulkSpec:
    """Pick the offline geometry for a ``taps``-long filter.

    M is the largest power of two <= ``max_block`` that is not wastefully
    larger than the filter itself; P covers the taps at that M.
    ``batch_blocks`` targets ~240k samples per dispatch, with a floor of 4
    blocks so the block-axis FFT still amortizes.
    """
    taps = max(1, int(taps))
    m = 1024
    while m < max_block and m < taps:
        m *= 2
    m = min(m, max_block)
    p = max(1, -(-taps // m))
    b = max(4, samples_per_dispatch // m)
    return BulkSpec(m, p, b, dtype)


# At and above this tap count the non-uniform schedule renders long
# filters; below it the head would cover the filter and the batched
# block-axis-FFT form is the right engine.
NU_BULK_MIN_TAPS = 65536
GBATCH_CYCLES = 8  # M-cycles per batched-scan iteration
                   # (sweep: benchmarks/gbatch_probe.py)


class BulkRenderer:
    """One-shot offline renderer: exact linear convolution of [C, T] audio
    with a [C, taps] (or [1, taps] shared) impulse at the bulk geometry.

    Two engines behind one surface (see ``NU_BULK_MIN_TAPS``): long
    filters run the two-stage non-uniform schedule in its bulk form
    (``nu_engine``: "gbatch" or "split"; "auto" asks
    ``utils.platform.bulk_nu_engine``); shorter filters run
    ``process_batch`` at the large-M geometry.
    """

    def __init__(self, impulse, n_channels: int, scale: float = 1.0,
                 dtype: str = "float32", spec: Optional[BulkSpec] = None,
                 store: str = "auto",
                 block_length: int = 1024, nu_engine: str = "auto"):
        impulse = np.atleast_2d(np.asarray(impulse))
        taps = impulse.shape[-1]
        self.n_channels = n_channels
        self.engine = ("nonuniform"
                       if spec is None and taps >= NU_BULK_MIN_TAPS
                       and dtype == "float32"
                       else "batch")
        if self.engine == "nonuniform":
            from bfir_tpu.core import nonuniform as NU
            from bfir_tpu.utils import platform

            # explicit int stores keep the split scan (the batched scan is
            # float-plane only)
            if store == "auto":
                store = "float32"
            if nu_engine == "auto":
                nu_engine = (platform.bulk_nu_engine()
                             if store == "float32" else "split")
            if nu_engine == "gbatch" and store != "float32":
                raise ValueError(
                    "nu_engine='gbatch' is float-plane only; use "
                    "store='float32'")
            self._nu_engine = nu_engine
            self._nuspec = NU.nu_geometry(taps, block_length, ratio=8,
                                          dtype=dtype, tail_store=store)
            self.spec = None
            # one filter for every channel (EQ-only chains): the batched
            # engine's correlation MAC broadcasts [P, 2, Hp] shared planes
            # — 1/C the coefficient memory traffic
            shared = (self._nu_engine == "gbatch"
                      and impulse.shape[0] == 1 and n_channels > 1)
            self._co = NU.nu_coeffs(impulse, self._nuspec, n_channels,
                                    scale=scale, shared=shared)
            if self._nu_engine == "gbatch":
                from bfir_tpu.core import nubatch as NB

                self._call = jax.jit(
                    lambda st, co, blocks: NB.process_blocks_nu_gbatch(
                        st, co, blocks, cycles_per_step=GBATCH_CYCLES),
                    donate_argnums=0,
                )
            else:
                self._call = jax.jit(NU.process_blocks_nu_split,
                                     donate_argnums=0)
            return
        self.spec = spec or bulk_geometry(taps, dtype)
        fspec = self.spec.filter_spec
        self._co = cv.coeffs_to_spectra(impulse, fspec, scale=scale)
        self._hs = cv.prepare_batch_coeffs(self._co, self.spec.batch_blocks)
        self._call = jax.jit(
            lambda st, co, hs, blocks: cv.process_batch(
                st, co, blocks, coeff_batch_fft=hs),
            donate_argnums=0,
        )

    def render(self, x) -> np.ndarray:
        """Filter [C, T] -> [C, T] (exact convolution, first T samples).

        The input is cut into fixed-size dispatches (the last zero-padded to
        the static shape — one compiled graph regardless of T) and the
        output trimmed. State threads through the dispatches, so the result
        is the same single linear convolution the streaming engines
        produce.
        """
        x = np.atleast_2d(np.asarray(x))
        c, t = x.shape
        if c != self.n_channels:
            raise ValueError(f"expected {self.n_channels} channels, got {c}")
        if self.engine == "nonuniform":
            return self._render_nu(x)
        m = self.spec.block_length
        bm = self.spec.batch_blocks
        fspec = self.spec.filter_spec
        state = cv.init_state(fspec, c)
        dt = np.dtype(self.spec.dtype)
        step = m * bm
        n_batches = -(-max(t, 1) // step)
        pad = n_batches * step - t
        xp = np.pad(x.astype(dt, copy=False), ((0, 0), (0, pad)))
        outs = []
        for i in range(n_batches):
            chunk = xp[:, i * step:(i + 1) * step]
            blocks = jax.numpy.asarray(
                chunk.reshape(c, bm, m).transpose(1, 0, 2))
            state, out = self._call(state, self._co, self._hs, blocks)
            outs.append(np.asarray(out).transpose(1, 0, 2).reshape(c, -1))
        return np.concatenate(outs, axis=1)[:, :t]

    def _render_nu(self, x) -> np.ndarray:
        from bfir_tpu.core import nonuniform as NU

        c, t = x.shape
        sp = self._nuspec
        n = sp.block_length
        # one dispatch = 24 M-cycles (~192 blocks at the default geometry:
        # big enough to amortize the dispatch and transfer, small enough
        # to bound the resident input/output slabs; a multiple of
        # GBATCH_CYCLES so the batched engine's iterations tile it)
        step = 24 * sp.ratio * n
        state = (NU.init_nu_state(sp, c) if self._nu_engine == "gbatch"
                 else NU.init_nu_split_state(sp, c))
        dt = np.dtype(sp.dtype)
        n_disp = -(-max(t, 1) // step)
        pad = n_disp * step - t
        xp = np.pad(x.astype(dt, copy=False), ((0, 0), (0, pad)))
        outs = []
        for i in range(n_disp):
            chunk = xp[:, i * step:(i + 1) * step]
            blocks = jax.numpy.asarray(
                chunk.reshape(c, step // n, n).transpose(1, 0, 2))
            state, out = self._call(state, self._co, blocks)
            outs.append(np.asarray(out).transpose(1, 0, 2).reshape(c, -1))
        return np.concatenate(outs, axis=1)[:, :t]
