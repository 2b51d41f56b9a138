"""Decompose fused-step device time on the GPU: batched chunk
front-end vs sequential track tail vs fully-fused chunk step.  In-session
diagnostic only (not a driver artifact).
"""

import copy
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(fn, n=5):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    from vslam_tpu.utils import compile_cache

    compile_cache.enable()
    from vslam_tpu.io import synthetic
    from vslam_tpu.io.config import ParameterCollection
    from vslam_tpu.ops import camera as cam_ops
    from vslam_tpu.tracking import fused
    from vslam_tpu.tracking.tracker import FusedPoseTracker

    cam = cam_ops.make_camera(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                              baseline_m=0.5372, rows=376, cols=1241)
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 1024
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.parallelism.frames_per_chunk = 32

    n_frames = 32
    poses = synthetic.circle_trajectory(n_frames, radius=13.0)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    frames = [synthetic.render_frame(world, t)[:2] for t in range(n_frames)]

    tr = FusedPoseTracker(cam, copy.deepcopy(cfg), landmark_capacity=65536)
    (chunk_dev, k), = tr.prestage(frames)
    k_dev = jnp.int32(k)

    out = {}

    # 1. fully fused chunk step
    st0 = tr.state
    motion = jnp.asarray(True)
    odom = jax.device_put(np.tile(np.eye(4, dtype=np.float32), (k, 1, 1)))
    use_odom = jnp.asarray(False)

    def run_chunk():
        st = tr._chunk_step(cam, st0, chunk_dev, k_dev, motion, odom, use_odom)
        jax.block_until_ready(st.T_world_cam)

    out["fused_chunk_ms_per_frame"] = round(1e3 * timeit(run_chunk) / k, 3)

    # 2. batched chunk frontend alone
    fe = fused.make_chunk_frontend(tr.params, None)

    def run_fe():
        r = fe(cam, st0.threshold, chunk_dev)
        jax.block_until_ready(r[1])

    out["frontend_batch_ms_per_frame"] = round(1e3 * timeit(run_fe) / k, 3)

    # 3. split chunk step (frontend batched + fori over track tails)
    split = fused.make_chunk_step_split(tr.params._replace(split_frontend=True), None)

    def run_split():
        st = split(cam, st0, chunk_dev, k_dev, motion, odom, use_odom)
        jax.block_until_ready(st.T_world_cam)

    out["split_chunk_ms_per_frame"] = round(1e3 * timeit(run_split) / k, 3)

    # 4. single-frame frontend (unbatched) for comparison
    img_pair = chunk_dev[0]

    @jax.jit
    def one_fe(threshold, pair):
        return fused._front_end(cam, tr.params, st0._replace(threshold=threshold),
                                pair[0], pair[1])[1]

    def run_one_fe():
        jax.block_until_ready(one_fe(st0.threshold, img_pair))

    out["frontend_single_ms_per_frame"] = round(1e3 * timeit(run_one_fe), 3)

    print(out)


if __name__ == "__main__":
    main()
