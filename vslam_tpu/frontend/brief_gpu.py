"""Pallas-Triton kernel: packed BRIEF-256 bit planes on the GPU.

Computes exactly brief.planes_from_pattern for a stack of smoothed images.
One program owns a BH x BW output tile of one image and loops over the
static BRIEF pattern: each of the 512 pattern points is one shifted
BH x BW load from the zero-padded image (the halo comes from the padding,
so no load needs a mask), each pair one compare, and 32 compares pack into
one uint32 word with shift-or.  The loads of neighbouring taps overlap and
hit in L1, so device memory sees about one read of the image and one write
of the eight planes.  XLA's own fusion of the same taps re-derived every
shifted index per element; on an H100 80GB HBM3 at 400 W this kernel
took the chunk step from 3.28 to 2.58 ms per frame (PERF.md).  The
16 x 128 tile with 8 warps was the fastest of six tile/warp shapes tried
there.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vslam_tpu.frontend.orb import PATTERN_RADIUS

BH, BW = 16, 128  # output tile: power-of-two sides, as Triton requires


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _kernel(pat, img_ref, out_ref):
    b = pl.program_id(0)
    r0 = pl.program_id(1) * BH + PATTERN_RADIUS
    c0 = pl.program_id(2) * BW + PATTERN_RADIUS

    def tap(dr, dc):
        return img_ref[b, pl.ds(r0 + dr, BH), pl.ds(c0 + dc, BW)]

    for w in range(8):
        acc = jnp.zeros((BH, BW), jnp.uint32)
        for j in range(32):
            (dr1, dc1), (dr2, dc2) = pat[w * 32 + j]
            bit = (tap(dr1, dc1) < tap(dr2, dc2)).astype(jnp.uint32)
            acc = acc | (bit << np.uint32(j))
        out_ref[w] = acc


@partial(jax.jit, static_argnames=("pat_key", "interpret"))
def _planes(smooth, pat_key, interpret=False):
    pat = np.asarray(pat_key, np.int32).reshape(256, 2, 2)
    B, H, W = smooth.shape
    R = PATTERN_RADIUS
    Hb, Wb = _round_up(H, BH), _round_up(W, BW)
    padded = jnp.zeros((B, Hb + 2 * R, Wb + 2 * R), jnp.float32)
    padded = jax.lax.dynamic_update_slice(padded, smooth.astype(jnp.float32),
                                          (0, R, R))
    planes = pl.pallas_call(
        partial(_kernel, pat.tolist()),
        out_shape=jax.ShapeDtypeStruct((B, 8, Hb, Wb), jnp.uint32),
        grid=(B, Hb // BH, Wb // BW),
        in_specs=[pl.no_block_spec],
        out_specs=pl.BlockSpec((None, 8, BH, BW), lambda b, i, j: (b, 0, i, j)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=1),
        interpret=interpret,
        name="brief_planes",
    )(padded)
    return planes[:, :, :H, :W]


def planes_from_pattern_gpu(smooth: jnp.ndarray, pat: np.ndarray,
                            interpret: bool = False) -> jnp.ndarray:
    """(B, H, W) smoothed images -> (B, 8, H, W) uint32 planes, equal to
    brief.planes_from_pattern applied to each image.  interpret=True runs
    the kernel body through the Pallas interpreter (CPU tests)."""
    key = tuple(int(v) for v in np.asarray(pat, np.int32).reshape(-1))
    return _planes(smooth, key, interpret=interpret)
