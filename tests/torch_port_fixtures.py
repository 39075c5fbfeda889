"""Fixtures shared by the JAX-vs-torch parity tests (tests/test_torch_*.py).

numpy only, so both packages take the same arrays. Copied from
tests/ab_runner.py (which parses sys.argv at import and so cannot be
imported): a 32x32 camera, a scene whose depths lie on a bucket-centred
ladder (no two points share a quantized sort bucket, so the sorted key
order is the same in both packages), and two rasterizer configs whose
pools are sized so that the JAX binning drops nothing.
"""

import numpy as np

NEAR, FAR = 0.1, 100.0

# overflow-free configs (keyword arguments of RasterizerConfig)
CFG = dict(near_plane=NEAR, far_plane=FAR, max_keys=2048,
           max_tiles_per_point=16, mid_point_divisor=1, big_point_divisor=1,
           depth_to_sort_key_scale=100.0)
CFG_LADDER = dict(near_plane=NEAR, far_plane=FAR, max_keys=2048,
                  pool_slots=(4, 8, 16), pool_caps=(60, 60, 60),
                  depth_to_sort_key_scale=100.0)

# the three scenes of tests/ab_runner.py: (seed, alpha, label, config);
# "b" has a high alpha so that transmittance saturation triggers
AB_CASES = [(1, 2.0, "a", CFG), (2, 7.0, "b", CFG), (1, 2.0, "c", CFG_LADDER)]


def camera_intrinsics(w=32, h=32, f=25.0):
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def random_scene(n, seed=0, alpha=2.0):
    """(pc (n, 3), feats (n, 56)) float32; depths on a ladder 5 buckets
    apart, each 0.5 bucket from an edge."""
    rng = np.random.default_rng(seed)
    z = 1.005 + 0.05 * rng.permutation(n).astype(np.float32)
    pc = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                         z[:, None]], axis=1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-2.5, -1.0, (n, 3))
    feats[:, 7] = alpha + rng.normal(size=n)
    feats[:, 8:56] = 0.3 * rng.normal(size=(n, 48))
    feats[:, 8] += 1.0
    return pc, feats


def identity_pose(k=1):
    """Camera at the origin looking down +z: (q (k, 4), t (k, 3))."""
    q = np.tile(np.array([[0.0, 0.0, 0.0, 1.0]], np.float32), (k, 1))
    return q, np.zeros((k, 3), np.float32)


# Tolerances of tests/test_tpu_exactness.py: floats at rtol 2e-3 / atol
# 1e-4 (the two blends round the exponent and the transmittance product in
# a different order); normalized depth only where the accumulated alpha is
# above 1e-2 (it divides two near-zero sums elsewhere); integer counts
# statistically, because a key grazing the 1/255 skip gate may flip.
RTOL, ATOL = 2e-3, 1e-4
COVERED_ALPHA = 1e-2


def assert_counts_close(ref, got, what=""):
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    diff = np.abs(a - b)
    denom = max(a.mean(), 1.0)
    assert diff.mean() / denom < 0.05, (what, diff.mean(), denom)
    assert diff.max() <= max(0.1 * a.max(), 2.0), (what, diff.max())
