"""Dataset loaders: KITTI odometry, EuRoC MAV, TUM RGB-D, ICL-NUIM.

Replaces the reference's srrg txt_io message-file playback
(SLAMAssembly::loadCamerasFromMessageFile + playbackMessageFile,
slam_assembly.cpp:99-206,343-492) with direct readers for the public
dataset layouts named in its configurations/ directory.  Each loader is an
iterator of frames plus a CameraParams; images are decoded on the host by
the native library (native/), with cv2 as the fallback.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from vslam_tpu.ops import camera as cam_ops

try:
    import cv2
except ImportError:  # the native decoder (native/) reads PNG and PGM
    cv2 = None


@dataclass
class StereoFrame:
    img_left: np.ndarray  # (H, W) f32
    img_right: np.ndarray  # (H, W) f32 (depth_m for RGB-D datasets)
    timestamp: float
    index: int
    is_depth: bool = False


def _imread_gray(path: str) -> np.ndarray:
    from vslam_tpu.utils import native

    img = native.decode_image(path)
    if img is None and cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(
            f"{path}: missing, or no decoder for it (the native library "
            "in native/ builds with make; cv2 is the fallback)"
        )
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return img.astype(np.float32)


def equalize(img: np.ndarray) -> np.ndarray:
    """Histogram equalization (reference slam_assembly.cpp:391-410,
    -equalize-histogram flag)."""
    return cv2.equalizeHist(img.astype(np.uint8)).astype(np.float32)


# ---------------------------------------------------------------------------
# KITTI odometry
# ---------------------------------------------------------------------------


class KittiDataset:
    """KITTI odometry sequence directory:
    <seq>/image_0/*.png, image_1/*.png, times.txt, calib.txt."""

    def __init__(self, path: str, equalize_hist: bool = False):
        self.path = path
        self.equalize_hist = equalize_hist
        self.left = sorted(
            os.path.join(path, "image_0", f)
            for f in os.listdir(os.path.join(path, "image_0"))
            if f.endswith(".png")
        )
        self.right = sorted(
            os.path.join(path, "image_1", f)
            for f in os.listdir(os.path.join(path, "image_1"))
            if f.endswith(".png")
        )
        times_file = os.path.join(path, "times.txt")
        if os.path.exists(times_file):
            self.times = np.loadtxt(times_file)
        else:
            self.times = np.arange(len(self.left)) * 0.1
        self.cam = self._load_calib()

    def _load_calib(self) -> cam_ops.CameraParams:
        """Parse P0/P1 projection matrices (KITTI calib.txt)."""
        calib = os.path.join(self.path, "calib.txt")
        P = {}
        with open(calib) as f:
            for line in f:
                key, _, rest = line.partition(":")
                vals = np.fromstring(rest, sep=" ")
                if len(vals) == 12:
                    P[key.strip()] = vals.reshape(3, 4)
        P0, P1 = P["P0"], P["P1"]
        fx, fy = P0[0, 0], P0[1, 1]
        cx, cy = P0[0, 2], P0[1, 2]
        # Right-camera baseline from P1's -fx*b entry.
        baseline = -P1[0, 3] / P1[0, 0]
        sample = _imread_gray(self.left[0])
        return cam_ops.make_camera(fx, fy, cx, cy, baseline,
                                   rows=sample.shape[0], cols=sample.shape[1])

    def __len__(self):
        return len(self.left)

    def __iter__(self) -> Iterator[StereoFrame]:
        from vslam_tpu.utils import native

        if native.available():
            # Native threaded decode-ahead: left/right interleaved so the
            # background workers stay ahead of the per-frame device compute.
            interleaved = [p for pair in zip(self.left, self.right) for p in pair]
            pf = native.Prefetcher(interleaved, n_threads=2, look_ahead=8)
            try:
                it = iter(pf)
                for i in range(len(self.left)):
                    il = next(it).astype(np.float32)
                    ir = next(it).astype(np.float32)
                    if self.equalize_hist:
                        il, ir = equalize(il), equalize(ir)
                    yield StereoFrame(il, ir, float(self.times[i]), i)
            finally:
                pf.close()
            return
        for i, (l, r) in enumerate(zip(self.left, self.right)):
            il, ir = _imread_gray(l), _imread_gray(r)
            if self.equalize_hist:
                il, ir = equalize(il), equalize(ir)
            yield StereoFrame(il, ir, float(self.times[i]), i)


# ---------------------------------------------------------------------------
# EuRoC MAV
# ---------------------------------------------------------------------------


class EurocDataset:
    """EuRoC mav0 layout: cam0/data/*.png + cam0/data.csv (+ cam1).

    EuRoC images are RAW (radial-tangential distorted, unrectified): when
    the per-camera sensor.yaml files are present, undistort+rectify maps
    are precomputed from them (io/rectification.py, the reference's
    initUndistortRectifyMap role, node.cpp:225-244) and applied to every
    frame; `cam` then holds the rectified intrinsics.  Without sensor.yaml
    the loader falls back to nominal rectified intrinsics on raw images and
    warns — accuracy will suffer.
    """

    def __init__(self, path: str, cam_params: Optional[cam_ops.CameraParams] = None):
        from vslam_tpu.io import rectification

        self.base = path
        mav = os.path.join(path, "mav0") if os.path.isdir(os.path.join(path, "mav0")) else path
        self.cam0_dir = os.path.join(mav, "cam0", "data")
        self.cam1_dir = os.path.join(mav, "cam1", "data")
        self.entries = []
        with open(os.path.join(mav, "cam0", "data.csv")) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#"):
                    self.entries.append((int(row[0]), row[1].strip()))
        self.rectifier = rectification.rectifier_from_euroc(mav)
        if cam_params is not None:
            self.cam = cam_params
        elif self.rectifier is not None:
            self.cam = self.rectifier.cam
        else:
            print(
                "[euroc] no cam0/cam1 sensor.yaml found — feeding RAW "
                "(distorted) images with nominal intrinsics"
            )
            # EuRoC stereo (rectified nominal): fx 435.2, baseline 0.11 m.
            self.cam = cam_ops.make_camera(
                435.2046959714599, 435.2046959714599, 367.4517211914062,
                252.2008514404297, 0.110073808127187, rows=480, cols=752,
            )

    def __len__(self):
        return len(self.entries)

    def __iter__(self) -> Iterator[StereoFrame]:
        for i, (ts_ns, fname) in enumerate(self.entries):
            il = _imread_gray(os.path.join(self.cam0_dir, fname))
            ir = _imread_gray(os.path.join(self.cam1_dir, fname))
            if self.rectifier is not None:
                il = self.rectifier.rectify(il, 0)
                ir = self.rectifier.rectify(ir, 1)
            yield StereoFrame(il, ir, ts_ns * 1e-9, i)


# ---------------------------------------------------------------------------
# TUM RGB-D / ICL-NUIM
# ---------------------------------------------------------------------------


class TumRgbdDataset:
    """TUM RGB-D layout: rgb.txt + depth.txt (ts filename pairs), depth
    scale 1/5000 m per unit; ICL-NUIM uses the same layout."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, path: str, cam_params: Optional[cam_ops.CameraParams] = None,
                 max_dt: float = 0.02, depth_scale: Optional[float] = None):
        """depth_scale: meters per 16-bit depth unit.  None = the TUM PNG
        convention (1/5000).  The config key
        `depth_scale_factor_intensity_to_meters` (reference
        parameters.h:251) overrides it when explicitly set — e.g. 1e-3
        for millimeter-encoded xtion/ROS-bag exports."""
        self.depth_scale = float(depth_scale) if depth_scale else self.DEPTH_SCALE
        self.base = path
        rgb = self._parse_list(os.path.join(path, "rgb.txt"))
        depth = self._parse_list(os.path.join(path, "depth.txt"))
        # Associate rgb and depth by nearest timestamp.
        self.pairs = []
        d_ts = np.asarray([t for t, _ in depth])
        for t, f in rgb:
            j = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[j] - t) <= max_dt:
                self.pairs.append((t, f, depth[j][1]))
        # TUM fr1 defaults (freiburg1).
        self.cam = cam_params or cam_ops.make_camera(
            517.3, 516.5, 318.6, 255.3, 0.075, rows=480, cols=640,
        )

    @staticmethod
    def _parse_list(path: str):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, fname = line.split()[:2]
                out.append((float(ts), fname))
        return out

    def __len__(self):
        return len(self.pairs)

    def __iter__(self) -> Iterator[StereoFrame]:
        for i, (ts, rgb_f, depth_f) in enumerate(self.pairs):
            img = _imread_gray(os.path.join(self.base, rgb_f))
            d16 = cv2.imread(os.path.join(self.base, depth_f), cv2.IMREAD_UNCHANGED)
            if d16 is None:
                raise FileNotFoundError(depth_f)
            depth_m = d16.astype(np.float32) * self.depth_scale
            yield StereoFrame(img, depth_m, ts, i, is_depth=True)


def load_dataset(path: str, fmt: str, **kw):
    fmt = fmt.lower()
    if fmt == "kitti":
        return KittiDataset(path, **kw)
    if fmt == "euroc":
        return EurocDataset(path, **kw)
    if fmt in ("tum", "icl"):
        return TumRgbdDataset(path, **kw)
    raise ValueError(f"unknown dataset format '{fmt}' (kitti|euroc|tum|icl)")
