"""Correlation MAC of the G-cycle batched bulk scan as a GPU kernel
(Pallas, Triton route).

For an ordered (newest-last) spectrum history ``hist`` [P-1+B, 2C, Hp] and
coefficient planes ``coeff`` [P, 2cs, Hp] (cs = C, or 1 for shared
filters) it computes the B batched halfcomplex MACs

    out[b] = sum_q coeff[q] (*) hist[P-1+b-q],   b = 0..B-1

with the lane-0 fixup of ``mac_reference_hc`` (lane 0 packs DC.re and
Nyquist.re — two independent real products). The plain version is
``core.nubatch._corr_mac``, which XLA fuses into one elementwise pass that
reads P history rows and P coefficient rows for every output element.

Each program here owns one channel, one frequency tile of ``block_f``
lanes and ``block_b`` consecutive outputs, and keeps their accumulators in
registers while it walks the P taps: a coefficient row is loaded once per
tap and reused across the ``block_b`` outputs, and consecutive taps read
history rows shifted by one, which the L1 cache serves (the shared-memory
overlap-save idea of arXiv:1910.01972). Lane-0 handling costs one select
per tap on the coefficient row:

    dr = cr*wr - b*wi,   di = a*wi + b*wr,   (a, b) = (cr, ci), or (ci, 0)
    at lane 0.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from bfir_tpu.utils import platform


def _kernel(hist_ref, co_ref, yr_ref, yi_ref, *, p: int, c: int, cs: int,
            bc: int, ft: int):
    from jax.experimental import pallas as pl

    ch = pl.program_id(0)
    f0 = pl.program_id(1) * ft
    b0 = pl.program_id(2) * bc
    cc = ch if cs > 1 else 0
    lane0 = (f0 + jnp.arange(ft)) == 0
    acc_r = jnp.zeros((bc, ft), jnp.float32)
    acc_i = jnp.zeros((bc, ft), jnp.float32)
    for q in range(p):  # static: P is small, and unrolling lets loads overlap
        rows = pl.ds(b0 + (p - 1 - q), bc)
        wr = hist_ref[rows, ch, pl.ds(f0, ft)]
        wi = hist_ref[rows, ch + c, pl.ds(f0, ft)]
        cr = co_ref[q, cc, pl.ds(f0, ft)]
        ci = co_ref[q, cc + cs, pl.ds(f0, ft)]
        a = jnp.where(lane0, ci, cr)[None, :]
        b = jnp.where(lane0, 0.0, ci)[None, :]
        acc_r = acc_r + cr[None, :] * wr - b * wi
        acc_i = acc_i + a * wi + b * wr
    yr_ref[pl.ds(b0, bc), ch, pl.ds(f0, ft)] = acc_r
    yi_ref[pl.ds(b0, bc), ch, pl.ds(f0, ft)] = acc_i


@functools.partial(jax.jit, static_argnames=(
    "nblocks", "block_b", "block_f", "num_warps"))
def corr_mac_triton(hist: jax.Array, coeff: jax.Array, nblocks: int,
                    block_b: int = 8, block_f: int = 512,
                    num_warps: int = 4) -> Tuple[jax.Array, jax.Array]:
    """(yr, yi) [nblocks, C, Hp] f32 from hist [P-1+nblocks, 2C, Hp] and
    coeff [P, 2cs, Hp]. ``block_b``/``block_f`` are the program's output
    rows and lanes (powers of two; clipped to nblocks / Hp). Compiled for
    the GPU; interpreted on the CPU, which has no Triton lowering."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    h, c2, hp = hist.shape
    p = coeff.shape[0]
    cs = coeff.shape[1] // 2
    c = c2 // 2
    b = nblocks
    if h != p - 1 + b:
        raise ValueError(f"hist rows {h} != P-1+B = {p - 1 + b}")
    bc = min(block_b, b)
    ft = min(block_f, hp)
    if b % bc or hp % ft or bc & (bc - 1) or ft & (ft - 1):
        raise ValueError(
            f"tiles ({bc} blocks, {ft} lanes) must be powers of two "
            f"dividing ({b}, {hp})")
    kernel = functools.partial(_kernel, p=p, c=c, cs=cs, bc=bc, ft=ft)
    out = jax.ShapeDtypeStruct((b, c, hp), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(c, hp // ft, b // bc),
        out_shape=[out, out],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=platform.pallas_interpret(),
        name="corr_mac",
    )(hist.astype(jnp.float32), coeff.astype(jnp.float32))
