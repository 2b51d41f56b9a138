"""Multi-process worker for the no-cluster multi-host harness (SURVEY §4).

Each process owns 4 virtual CPU devices; jax.distributed.initialize stitches
them into one 2-process global runtime, and the landmark-sharded Schur BA
runs over the GLOBAL 8-device mesh — the exact code path a 2-host GPU
cluster uses (mesh-topology-agnostic collectives).

Usage: python tests/multihost_worker.py <coordinator_port> <process_id> <out>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from vslam_tpu.backend import ba as ba_mod
    from vslam_tpu.ops import camera as cam_ops
    from vslam_tpu.parallel import sharded_ba

    mesh = Mesh(np.asarray(jax.devices()), ("lm",))
    rng = np.random.default_rng(7)  # identical problem in both processes

    cam = cam_ops.make_camera(fx=500.0, fy=500.0, cx=320.0, cy=160.0,
                              baseline_m=0.4, rows=320, cols=640)
    Pn, L, Omax = 4, 64, 3
    T_wc = np.tile(np.eye(4, dtype=np.float32), (Pn, 1, 1))
    T_wc[:, 0, 3] = 0.3 * np.arange(Pn)
    xyz = np.stack([rng.uniform(-5, 5, L), rng.uniform(-2, 2, L),
                    rng.uniform(6, 20, L)], 1).astype(np.float32)
    obs_cam = rng.integers(0, Pn, (L, Omax)).astype(np.int32)
    Tinv = np.linalg.inv(T_wc)
    p_c = np.einsum("loij,lj->loi", Tinv[obs_cam][:, :, :3, :3], xyz) + \
        Tinv[obs_cam][:, :, :3, 3]
    uv_l, uv_r, _ = cam_ops.project_stereo(cam, jnp.asarray(p_c.reshape(-1, 3)))
    obs_uv4 = np.concatenate([np.asarray(uv_l), np.asarray(uv_r)], 1).reshape(
        L, Omax, 4
    )
    noisy = xyz + rng.normal(0, 0.05, (L, 3)).astype(np.float32)

    # Globally-sharded device arrays: each process contributes its local
    # shard of the landmark axis.
    lm_sh = NamedSharding(mesh, P("lm"))
    rep = NamedSharding(mesh, P())

    def shard(x, sharding):
        return jax.make_array_from_process_local_data(sharding, x)

    prob = ba_mod.BAProblem(
        T_wc=shard(T_wc, rep),
        xyz=shard(noisy, lm_sh),
        obs_cam=shard(obs_cam, lm_sh),
        obs_uv4=shard(obs_uv4.astype(np.float32), lm_sh),
        obs_weight=shard(np.ones((L, Omax), np.float32), lm_sh),
        obs_mask=shard(np.ones((L, Omax), bool), lm_sh),
        lm_valid=shard(np.ones(L, bool), lm_sh),
        cam_fixed=shard(np.asarray(np.arange(Pn) == 0), rep),
    )
    cfg = ba_mod.BAConfig(iterations=5, damping=1e-3)
    T_out, xyz_out, chi2s = sharded_ba.bundle_adjust_sharded(cam, prob, mesh, cfg)
    T_np = np.asarray(jax.device_get(T_out))  # replicated -> full copy
    chi2 = np.asarray(jax.device_get(chi2s))

    if pid == 0:
        np.savez(out_path, T=T_np, chi2=chi2, T_true=T_wc)
    jax.effects_barrier()
    jax.distributed.shutdown()
    print(f"worker {pid}: OK chi2 {chi2[0]:.3f} -> {chi2[-1]:.3f}")


if __name__ == "__main__":
    main()
