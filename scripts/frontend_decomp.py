"""Front-end cost on the attached GPU at KITTI resolution (376x1241).

Measures, in one process:
  * BRIEF planes per stereo pair: the shifted-compare planes the system
    uses, and the same bits from four 64-filter difference convolutions
    pinned to Precision.HIGHEST (the formulation they replaced); the first
    call (compile included) and the steady per-pair time of each;
  * from a profiler trace of a steady window of fused chunk steps (the
    closed-loop workload of bench.py, 32-frame chunks, no drains): the
    device time per frame, the device idle share of the window, and the
    front-end's share of the device time — kernels whose HLO instruction
    carries the "frontend" named scope (tracking/fused.py) over all
    kernels.

    python scripts/frontend_decomp.py [--out-dir profiles/frontend]

Prints one JSON object; the trace and a per-kernel table go to --out-dir.
"""

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(fn, n=50):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def conv_planes(smooth, pat):
    """The same packed bits as brief.planes_from_pattern, as four 64-filter
    one-hot difference convolutions at full f32 precision."""
    import jax
    import jax.numpy as jnp

    from vslam_tpu.frontend.orb import PATTERN_RADIUS as R

    P = 2 * R + 1
    f = np.zeros((256, 1, P, P), np.float32)
    for b in range(256):
        (dr1, dc1), (dr2, dc2) = pat[b]
        f[b, 0, R + dr1, R + dc1] -= 1.0
        f[b, 0, R + dr2, R + dc2] += 1.0
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = []
    for chunk in range(4):
        diff = jax.lax.conv_general_dilated(
            smooth[None, None], jnp.asarray(f[chunk * 64:(chunk + 1) * 64]),
            (1, 1), padding=[(R, R)] * 2,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST,
        )[0]
        bits = (diff > 0).astype(jnp.uint32)
        words += [jnp.sum(bits[:32] << shifts[:, None, None], axis=0),
                  jnp.sum(bits[32:] << shifts[:, None, None], axis=0)]
    return jnp.stack(words)


def brief_timings(frames):
    import jax
    import jax.numpy as jnp

    from vslam_tpu.frontend import brief
    from vslam_tpu.frontend.orb import box_sum

    pair = jnp.asarray(np.stack(frames[0]))
    out = {}
    for name, planes in (("shifted_compare", brief.planes_from_pattern),
                         ("conv_highest", conv_planes)):
        f = jax.jit(lambda x, pl=planes: jnp.stack(
            [pl(box_sum(x[i], 2), brief._PAT) for i in range(2)]))
        t0 = time.perf_counter()
        res = jax.block_until_ready(f(pair))
        out[f"{name}_first_call_s"] = time.perf_counter() - t0
        out[f"{name}_ms_per_pair"] = 1e3 * timeit(
            lambda: jax.block_until_ready(f(pair)))
        out[f"_{name}"] = np.asarray(res)
    out["bits_differing"] = int(np.unpackbits(np.bitwise_xor(
        out.pop("_shifted_compare"), out.pop("_conv_highest")).view(np.uint8)).sum())
    return out


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata, from compiled HLO text.
    Each name is also entered with '.' and '-' as '_', the spelling of the
    kernel an XLA fusion becomes."""
    scopes = {}
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"",
                         hlo_text, re.M):
        scopes[m.group(1)] = m.group(2)
        scopes[re.sub(r"[.\-]", "_", m.group(1))] = m.group(2)
    return scopes


def layer_of(scope: str) -> str:
    """The first scope component inside the chunk loop's body."""
    tail = scope.split("/while/body/", 1)[-1] if "/while/body/" in scope else scope
    return tail.split("/", 1)[0] or "unattributed"


def device_events(trace_dir):
    """(name, hlo_op, start_ns, dur_ns) of every event on GPU 0's streams."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    assert planes, f"no GPU plane in {[p.name for p in pd.planes]}"
    lines = list(planes[0].lines)
    names = [ln.name for ln in lines]
    stream = [ln for ln in lines if "Stream" in ln.name] or lines
    ev = []
    for ln in stream:
        for e in ln.events:
            st = dict(e.stats)
            ev.append((e.name, str(st.get("hlo_op", e.name)), e.start_ns,
                       e.duration_ns))
    return ev, names


def chunk_trace(out_dir, n_frames=128):
    import copy

    import jax

    import bench
    from vslam_tpu.tracking.tracker import FusedPoseTracker

    cam, cfg, _, frames = bench.make_closed_loop(n_frames)
    tr = FusedPoseTracker(cam, copy.deepcopy(cfg), landmark_capacity=65536)
    staged = tr.prestage(frames)
    t0 = time.perf_counter()
    tr._dispatch_staged(staged[0])
    jax.block_until_ready(tr.state.T_world_cam)
    compile_s = time.perf_counter() - t0
    n = sum(h[1] for h in staged[1:])

    trace_dir = os.path.join(out_dir, "trace")
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    for h in staged[1:]:
        tr._dispatch_staged(h)
    jax.block_until_ready(tr.state.T_world_cam)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()

    chunk, k = staged[1]
    hlo = tr._chunk_step.lower(
        cam, tr.state, chunk, jax.numpy.int32(k), tr._motion,
        tr._odom_identity, tr._use_odom_false,
    ).compile().as_text()
    scopes = op_scopes(hlo)
    ev, line_names = device_events(trace_dir)
    # Busy = union of event intervals over the window spanned by them.
    iv = sorted((s, s + d) for _, _, s, d in ev)
    busy, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (iv[-1][1] - iv[0][0]) if iv else 0
    # Kernels inside a command buffer (CUDA graph) carry hlo_op
    # "command_buffer"; XLA's own fusions are then found by kernel name.
    per_kernel, per_layer = {}, {}
    fe = total = 0
    for name, op, _, d in ev:
        scope = scopes.get(op) or scopes.get(name, "")
        total += d
        if "/frontend/" in scope or scope.endswith("/frontend"):
            fe += d
        key = (name[:80], op, scope[:160])
        per_kernel[key] = per_kernel.get(key, 0) + d
        per_layer[layer_of(scope)] = per_layer.get(layer_of(scope), 0) + d
    table = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump({"lines": line_names, "n_scoped_ops": len(scopes),
                   "kernels": [{"name": k[0], "hlo_op": k[1], "scope": k[2],
                                "ns": v} for k, v in table[:400]]}, f, indent=1)
    return {
        "chunk_step_first_call_s": compile_s,
        "frames_in_window": n,
        "window_wall_ms_per_frame": 1e3 * wall / n,
        "device_busy_ms_per_frame": 1e-6 * busy / n,
        "device_kernel_ms_per_frame": 1e-6 * total / n,
        "device_idle_share": 1.0 - busy / span if span else None,
        "frontend_share_of_device_time": fe / total if total else None,
        "layer_ms_per_frame": {k: 1e-6 * v / n for k, v in sorted(
            per_layer.items(), key=lambda kv: -kv[1])[:12]},
        "n_device_events": len(ev),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="profiles/frontend")
    args = ap.parse_args()
    import subprocess

    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.enable()
    if jax.default_backend() != "gpu":
        raise SystemExit("frontend_decomp measures the GPU; none found")
    os.makedirs(args.out_dir, exist_ok=True)
    import bench

    card = bench.card_name_and_power_limit()
    _, _, _, frames = bench.make_closed_loop(2)
    out = {"card": card, "device_kind": jax.devices()[0].device_kind}
    out.update(brief_timings(frames))
    out.update(chunk_trace(args.out_dir))
    out["nvidia_smi_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    with open(os.path.join(args.out_dir, "result.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
