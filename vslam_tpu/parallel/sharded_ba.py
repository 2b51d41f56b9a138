"""Landmark-sharded Schur-complement bundle adjustment over a device mesh.

The flagship distributed component (SURVEY.md §2.9, BASELINE north star):
landmarks — and their grouped observations — are sharded across the "lm"
mesh axis.  Each device linearizes its landmark shard, eliminates its 3x3
landmark blocks, and assembles a PARTIAL reduced camera system; one `psum`
across the mesh combines the partials into the replicated 6P x 6P system, which
every device solves redundantly (P is small); landmark back-substitution
then happens shard-locally with zero further communication.

Communication per iteration: exactly one psum of (P*6)^2 + P*6 floats —
independent of landmark count, which is why scaling efficiency stays high
as the map grows.

Reuses backend/ba.py's build_reduced_system / solve_reduced_and_backsub
verbatim inside shard_map: the single-device and distributed paths cannot
drift apart.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vslam_tpu.backend import ba as ba_mod
from vslam_tpu.ops import camera as cam_ops


def bundle_adjust_sharded(
    cam: cam_ops.CameraParams,
    prob: ba_mod.BAProblem,
    mesh: Mesh,
    config: ba_mod.BAConfig = ba_mod.BAConfig(),
    axis_name: str = "lm",
):
    """Distributed Schur BA.  Landmark-dim arrays of `prob` must have a
    leading dimension divisible by the mesh size (pad with lm_valid=False
    rows via parallel.mesh.pad_to_multiple).

    Returns (T_wc, xyz, chi2_history) with xyz sharded like the input.
    """
    lm_spec = P(axis_name)
    rep = P()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            rep,  # T_wc
            lm_spec,  # xyz
            lm_spec,  # obs_cam
            lm_spec,  # obs_uv4
            lm_spec,  # obs_weight
            lm_spec,  # obs_mask
            lm_spec,  # lm_valid
            rep,  # cam_fixed
            rep,  # odo_T (replicated: pose factors are added post-psum)
            rep,  # odo_weight
            rep,  # odo_info
        ),
        out_specs=(rep, lm_spec, rep),
    )
    def run(T_wc, xyz, obs_cam, obs_uv4, obs_w, obs_m, lm_valid, cam_fixed,
            odo_T, odo_weight, odo_info):
        local = ba_mod.BAProblem(
            T_wc=T_wc,
            xyz=xyz,
            obs_cam=obs_cam,
            obs_uv4=obs_uv4,
            obs_weight=obs_w,
            obs_mask=obs_m,
            lm_valid=lm_valid,
            cam_fixed=cam_fixed,
            odo_T=odo_T,
            odo_weight=odo_weight,
            odo_info=odo_info,
        )

        def one_iter(carry, _):
            T, x = carry
            p = local._replace(xyz=x)
            S, b_S, Winv, b_l, Y, chi2 = ba_mod.build_reduced_system(
                cam, T, p, config
            )
            # The single collective of the iteration: combine partial
            # reduced systems from every landmark shard.
            S = jax.lax.psum(S, axis_name)
            b_S = jax.lax.psum(b_S, axis_name)
            chi2 = jax.lax.psum(chi2, axis_name)
            T_new, x_new = ba_mod.solve_reduced_and_backsub(
                T, p, S, b_S, Winv, b_l, Y, config
            )
            return (T_new, x_new), chi2

        (T_out, x_out), chi2s = jax.lax.scan(
            one_iter, (T_wc, xyz), None, length=config.iterations
        )
        return T_out, x_out, chi2s

    n_cam = prob.T_wc.shape[0]
    odo_T = prob.odo_T
    odo_w = prob.odo_weight
    odo_info = prob.odo_info
    if odo_T is None:
        # shard_map needs concrete arrays; zero weights disable the factors.
        odo_T = jnp.tile(jnp.eye(4, dtype=prob.T_wc.dtype), (n_cam, 1, 1))
        odo_w = jnp.zeros(n_cam, prob.T_wc.dtype)
        odo_info = jnp.zeros(6, prob.T_wc.dtype)
    return run(
        prob.T_wc,
        prob.xyz,
        prob.obs_cam,
        prob.obs_uv4,
        prob.obs_weight,
        prob.obs_mask,
        prob.lm_valid,
        prob.cam_fixed,
        odo_T,
        odo_w,
        odo_info,
    )
