"""Micro-profile FAST detection sub-stages on the GPU (batch 32). Diagnostic."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(fn, n=4):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    from vslam_tpu.utils import compile_cache

    compile_cache.enable()
    from vslam_tpu.frontend import detect
    from vslam_tpu.frontend.orb import box_blur
    from vslam_tpu.io import synthetic
    from vslam_tpu.ops import camera as cam_ops

    cam = cam_ops.make_camera(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                              baseline_m=0.5372, rows=376, cols=1241)
    B = 32
    poses = synthetic.circle_trajectory(B, radius=13.0)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    frames = [synthetic.render_frame(world, t)[:2] for t in range(B)]
    chunk = np.stack([np.stack(f).astype(np.uint8) for f in frames])
    chunk_dev = jax.device_put(chunk)
    thr = jnp.float32(20.0)
    out = {}

    def bench(name, f):
        g = jax.jit(f)
        jax.block_until_ready(g(chunk_dev))
        out[name] = round(1e3 * timeit(lambda: jax.block_until_ready(g(chunk_dev))) / B, 3)

    # score map only (both images)
    bench("score_ms", lambda c: jax.vmap(
        lambda pair: (detect.fast_score_map(pair[0].astype(jnp.float32), thr),
                      detect.fast_score_map(pair[1].astype(jnp.float32), thr)))(c))

    # score + NMS
    bench("score_nms_ms", lambda c: jax.vmap(
        lambda pair: (detect.nms3(detect.fast_score_map(pair[0].astype(jnp.float32), thr)),
                      detect.nms3(detect.fast_score_map(pair[1].astype(jnp.float32), thr))))(c))

    # full detect
    bench("detect_full_ms", lambda c: jax.vmap(
        lambda pair: (detect.detect_keypoints(pair[0], thr, 16, 1024, 20, "FAST").uv,
                      detect.detect_keypoints(pair[1], thr, 16, 1024, 20, "FAST").uv))(c))

    # box blur alone (brief prereq)
    bench("box_blur_ms", lambda c: jax.vmap(
        lambda pair: (box_blur(pair[0].astype(jnp.float32), 2),
                      box_blur(pair[1].astype(jnp.float32), 2)))(c))

    print(out)


if __name__ == "__main__":
    main()
