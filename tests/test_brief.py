"""Dense BRIEF: the shifted-compare planes against the plain numpy oracle
(bit-exact), and descriptors against a naive per-keypoint oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from vslam_tpu.frontend import brief, detect
from vslam_tpu.frontend.orb import box_sum
from vslam_tpu.mapping import frame as frame_mod
from vslam_tpu.ops import hamming

RNG = np.random.default_rng(37)


def naive_brief(img, uv):
    smooth = np.asarray(box_sum(jnp.asarray(img), 2))
    pat = brief._PAT
    out = np.zeros((len(uv), 256), np.uint8)
    for i, (c, r) in enumerate(uv.astype(int)):
        for b in range(256):
            dr1, dc1 = pat[b, 0]
            dr2, dc2 = pat[b, 1]
            out[i, b] = smooth[r + dr1, c + dc1] < smooth[r + dr2, c + dc2]
    return out


def smoothed(img):
    return np.asarray(box_sum(jnp.asarray(img), 2))


def test_dense_brief_matches_naive():
    img = RNG.uniform(0, 255, (120, 160)).astype(np.float32)
    uv = np.stack([RNG.uniform(20, 140, 64), RNG.uniform(20, 100, 64)], 1)
    uv = np.round(uv).astype(np.float32)
    desc = np.asarray(brief.describe_dense(jnp.asarray(img), jnp.asarray(uv)))
    oracle_bits = naive_brief(img, uv)
    got_bits = np.asarray(hamming.unpack_bits(jnp.asarray(desc)))
    # Exact compares: no unstable bits, whatever the backend's precision.
    assert np.array_equal(got_bits, oracle_bits)


def test_dense_brief_discriminates():
    img = RNG.uniform(0, 255, (100, 200)).astype(np.float32)
    uv = np.stack([RNG.uniform(20, 180, 32), RNG.uniform(20, 80, 32)], 1).astype(np.float32)
    desc = brief.describe_dense(jnp.asarray(img), jnp.asarray(np.round(uv)))
    d = np.array(hamming.hamming_matrix(desc, desc))
    np.fill_diagonal(d, 999)
    # distinct noise locations should be far apart (bits are spatially
    # correlated by the smoothing, so the floor sits below the 128 of
    # ideal random bits)
    assert d.min() > 40


def test_planes_single_image_match_oracle():
    img = RNG.uniform(0, 255, (40, 150)).astype(np.float32)
    got = np.asarray(brief.dense_planes(jnp.asarray(img)))
    assert np.array_equal(got, brief.planes_numpy(smoothed(img), brief._PAT))


def test_planes_stereo_pair_match_oracle():
    imgs = RNG.uniform(0, 255, (2, 24, 140)).astype(np.float32)
    got = np.asarray(brief.dense_planes_pair(jnp.asarray(imgs[0]),
                                             jnp.asarray(imgs[1])))
    for b in range(2):
        want = brief.planes_numpy(smoothed(imgs[b]), brief._PAT)
        assert np.array_equal(got[b], want)


@pytest.mark.parametrize("bank", [0, 5, 11])
def test_rotated_bank_planes_match_oracle(bank):
    s = smoothed(RNG.uniform(0, 255, (36, 90)).astype(np.float32))
    pat = brief._ROT_PATS[bank]
    got = np.asarray(brief.planes_from_pattern(jnp.asarray(s), pat))
    assert np.array_equal(got, brief.planes_numpy(s, pat))


def test_rotated_descriptors_equal_their_bank_planes():
    """describe_dense_rotated reads each keypoint's bank pattern directly;
    it must equal that bank's dense planes at the keypoint, including
    keypoints whose pattern reaches past the image edge."""
    img = RNG.uniform(0, 255, (60, 96)).astype(np.float32)
    uv = np.stack([RNG.uniform(-2, 98, 80), RNG.uniform(-2, 62, 80)], 1)
    desc = np.asarray(brief.describe_dense_rotated(jnp.asarray(img),
                                                   jnp.asarray(uv, jnp.float32)))
    s = smoothed(img)
    bins = np.asarray(brief.orientation_bin_map(jnp.asarray(s)))
    c = np.clip(np.round(uv[:, 0]).astype(int), 0, img.shape[1] - 1)
    r = np.clip(np.round(uv[:, 1]).astype(int), 0, img.shape[0] - 1)
    planes = {b: brief.planes_numpy(s, brief._ROT_PATS[b])
              for b in set(bins[r, c].tolist())}
    want = np.stack([planes[bins[i, j]][:, i, j] for i, j in zip(r, c)])
    assert np.array_equal(desc, want)


def test_pyramid_descriptors_level1_match_oracle():
    """2-octave description: level-0 planes and the level-1 keypoints'
    descriptors both equal the oracle on their own pyramid level."""
    imgs = RNG.uniform(0, 255, (2, 96, 160)).astype(np.float32)
    img_l, img_r = jnp.asarray(imgs[0]), jnp.asarray(imgs[1])
    capacity, octaves = 64, 2
    thr = jnp.float32(10.0)
    kl = detect.detect_keypoints(img_l, thr, 8, capacity, 16, octaves=octaves)
    kr = detect.detect_keypoints(img_r, thr, 8, capacity, 16, octaves=octaves)
    dl, dr, planes0 = frame_mod._pyramid_descriptors(img_l, img_r, kl, kr,
                                                     capacity, octaves)
    assert np.array_equal(np.asarray(planes0[0]),
                          brief.planes_numpy(smoothed(imgs[0]), brief._PAT))
    cap0 = detect.octave_capacities(capacity, octaves)[0]
    for img, kp, d in ((img_l, kl, dl), (img_r, kr, dr)):
        lvl1 = np.asarray(detect.downsample2(img))
        oracle = brief.planes_numpy(smoothed(lvl1), brief._PAT)
        uv1 = (np.asarray(kp.uv)[cap0:] - 0.5) / 2.0
        c = np.clip(np.round(uv1[:, 0]).astype(int), 0, lvl1.shape[1] - 1)
        r = np.clip(np.round(uv1[:, 1]).astype(int), 0, lvl1.shape[0] - 1)
        valid = np.asarray(kp.valid)[cap0:]
        assert valid.any()
        assert np.array_equal(np.asarray(d)[cap0:][valid],
                              oracle[:, r, c].T[valid])


@pytest.mark.parametrize("bank", [None, 5])
def test_triton_planes_kernel_matches_oracle(bank):
    """The GPU kernel's body, through the Pallas interpreter: a stack of
    two images whose sides are not multiples of the 16 x 128 tile."""
    from vslam_tpu.frontend import brief_gpu

    pat = brief._PAT if bank is None else brief._ROT_PATS[bank]
    s = np.stack([smoothed(RNG.uniform(0, 255, (40, 150)).astype(np.float32))
                  for _ in range(2)])
    got = np.asarray(brief_gpu.planes_from_pattern_gpu(jnp.asarray(s), pat,
                                                       interpret=True))
    assert got.shape == (2, 8, 40, 150)
    for b in range(2):
        assert np.array_equal(got[b], brief.planes_numpy(s[b], pat))
