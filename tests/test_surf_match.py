"""SURF detector/descriptor + matcher tests on synthetic images."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spherical_ba.ops import integral, match, surf
from spherical_ba.utils.config import MatchConfig, SurfConfig

CFG = SurfConfig(max_keypoints=64, n_octaves=2)


def blob_image(h=96, w=128, centers=((30, 40), (60, 90), (50, 20)), r=5):
    img = np.full((h, w), 40.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for (cy, cx) in centers:
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[mask] = 220.0
    return jnp.asarray(img)


class TestDetect:
    def test_finds_blobs(self):
        centers = ((30, 40), (60, 90), (50, 20))
        img = blob_image(centers=centers)
        kp = surf.detect(img, CFG)
        found = np.asarray(kp.xy)[np.asarray(kp.valid)]
        assert found.shape[0] >= len(centers)
        for (cy, cx) in centers:
            d = np.min(np.linalg.norm(found - np.array([cx, cy]), axis=-1))
            assert d < 3.0, f"blob at {(cx, cy)} not localized (nearest {d:.1f}px)"

    def test_empty_image_no_keypoints(self):
        img = jnp.full((96, 128), 128.0)
        kp = surf.detect(img, CFG)
        assert int(jnp.sum(kp.valid)) == 0

    def test_static_shapes(self):
        img = blob_image()
        kp = surf.detect(img, CFG)
        assert kp.xy.shape == (CFG.max_keypoints, 2)
        assert kp.valid.shape == (CFG.max_keypoints,)


class TestDescribeAndMatch:
    def test_self_match_identity(self):
        img = blob_image()
        kp, desc = surf.detect_and_describe(img, CFG)
        mt = match.match_descriptors(
            desc, kp.valid, desc, kp.valid, cfg=MatchConfig(max_matches=64, ratio_thresh=0.9)
        )
        # each valid keypoint's nearest neighbor in the identical bank is
        # itself (distance 0); ratio test may kill some (duplicate blobs)
        v = np.asarray(mt.valid)
        q = np.asarray(mt.query_idx)[v]
        t = np.asarray(mt.train_idx)[v]
        assert v.sum() >= 1
        np.testing.assert_array_equal(q, t)
        assert float(np.max(np.asarray(mt.distance)[v])) < 1e-3

    def test_descriptors_unit_norm(self):
        img = blob_image()
        kp, desc = surf.detect_and_describe(img, CFG)
        norms = np.linalg.norm(np.asarray(desc), axis=-1)
        valid = np.asarray(kp.valid)
        np.testing.assert_allclose(norms[valid], 1.0, atol=1e-4)
        np.testing.assert_allclose(norms[~valid], 0.0, atol=1e-6)

    def test_translated_blobs_match(self):
        # shift the whole pattern: descriptors must still match 1-1
        img1 = blob_image(centers=((30, 40), (60, 90), (50, 20)))
        img2 = blob_image(centers=((33, 44), (63, 94), (53, 24)))
        kp1, d1 = surf.detect_and_describe(img1, CFG)
        kp2, d2 = surf.detect_and_describe(img2, CFG)
        mt = match.match_descriptors(
            d1, kp1.valid, d2, kp2.valid, cfg=MatchConfig(max_matches=64, ratio_thresh=0.8)
        )
        v = np.asarray(mt.valid)
        assert v.sum() >= 2
        # matched pairs should be the corresponding shifted blobs (+4, +4);
        # identical-looking blobs can produce an occasional cross match at
        # this lenient ratio, so require a correct majority, not all
        xy1 = np.asarray(kp1.xy)[np.asarray(mt.query_idx)[v]]
        xy2 = np.asarray(kp2.xy)[np.asarray(mt.train_idx)[v]]
        shift = xy2 - xy1
        good = np.all(np.abs(shift - 4.0) < 2.0, axis=-1)
        assert good.sum() >= 2, f"shifts {shift}"
        assert good.mean() > 0.5, f"shifts {shift}"


class TestGatherModes:
    def test_orientation_gather_matches_masked_select(self):
        """The orientation samples come from ONE flat take at
        q*H*W + cy*W + cx (surf._sample_haar); it must select exactly the
        elements a row take + one-hot masked column select picks."""
        rng = np.random.default_rng(5)
        img = blob_image() * jnp.float32(1.7) + 10.0
        ii = integral.integral_image(img)
        haar = surf._dense_haar_maps(ii, CFG)  # (Q, H, W) u32
        qn, h, w = haar.shape
        k = 48
        q = jnp.asarray(rng.integers(0, qn, k), jnp.int32)
        cy = jnp.asarray(rng.integers(0, h, (k, 13)), jnp.int32)
        cx = jnp.asarray(rng.integers(0, w, (k, 13)), jnp.int32)
        got = surf._sample_haar(haar, q, cy, cx)
        rows = jnp.take(
            haar.reshape(-1, w), (q[:, None] * h + cy).reshape(-1), axis=0
        ).reshape(k, 13, w)
        sel = cx[:, None, :, None] == jnp.arange(w)[None, None, None, :]
        ref = jnp.sum(jnp.where(sel, rows[:, :, None, :], jnp.uint32(0)), axis=-1)
        assert got.shape == (k, 13, 13) and got.dtype == jnp.uint32
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_dense_laplacian_parity(self):
        """laplacian_mode='dense' (one gather per keypoint from per-layer
        trace-sign maps, the default path) must agree with the 24-corner
        'gather' reference path. Signs can differ only for keypoints whose
        refined size falls between layers AND whose trace changes sign
        across that scale step — structured blob scenes have none."""
        import dataclasses

        img = blob_image() * jnp.float32(2.0) + 40.0
        cfg_d = SurfConfig(max_keypoints=64, n_octaves=2, laplacian_mode="dense")
        cfg_g = dataclasses.replace(cfg_d, laplacian_mode="gather")
        kd = surf.detect(img, cfg_d)
        kg = surf.detect(img, cfg_g)
        v = np.asarray(kd.valid)
        assert v.sum() >= 3
        np.testing.assert_array_equal(
            np.asarray(kd.laplacian)[v], np.asarray(kg.laplacian)[v]
        )


def structured_banks(n_train, seed, n_copies=None, all_invalid=False):
    """Unit descriptors: the train bank is random; the query bank holds
    noisy copies of a random subset of train rows (clear nearest
    neighbours) followed by unrelated random rows (ratio-test rejects)."""
    rng = np.random.default_rng(seed)
    d = 64
    train = rng.normal(size=(n_train, d))
    train /= np.linalg.norm(train, axis=-1, keepdims=True)
    n_copies = n_copies or n_train // 4
    src = rng.choice(n_train, n_copies, replace=False)
    copies = train[src] + 0.02 * rng.normal(size=(n_copies, d))
    rand = rng.normal(size=(n_train - n_copies, d))
    query = np.concatenate([copies, rand])
    query /= np.linalg.norm(query, axis=-1, keepdims=True)
    v_train = rng.random(n_train) > 0.1
    if all_invalid:
        v_train[:] = False
    v_query = rng.random(n_train) > 0.1
    return (query.astype(np.float32), v_query, train.astype(np.float32), v_train)


def numpy_matches(q, vq, t, vt, ratio):
    """Brute-force float64 top-2 + ratio test -> {(query, train): dist}."""
    d2 = np.sum((q[:, None, :].astype(np.float64) - t[None, :, :]) ** 2, -1)
    d2 = np.where(vt[None, :], d2, np.inf)
    order = np.argsort(d2, axis=1)[:, :2]
    best = np.sqrt(np.take_along_axis(d2, order[:, :1], 1)[:, 0])
    second = np.sqrt(np.take_along_axis(d2, order[:, 1:2], 1)[:, 0])
    good = vq & np.isfinite(best) & np.isfinite(second) & (best < ratio * second)
    return {(int(i), int(order[i, 0])): best[i] for i in np.nonzero(good)[0]}


@pytest.mark.parametrize(
    "bank,all_invalid", [(2048, False), (4096, False), (2048, True)],
    ids=["bank2048", "bank4096", "all_invalid"],
)
def test_match_descriptors_against_numpy_top2(bank, all_invalid):
    """The matcher at the pipeline's real bank sizes (4 bands x 512 at 2K,
    8 bands x 512 on the dense ladder) against a float64 NumPy top-2."""
    q, vq, t, vt = structured_banks(bank, seed=bank, all_invalid=all_invalid)
    cfg = MatchConfig(max_matches=bank, ratio_thresh=0.8)
    mt = match.match_descriptors(
        jnp.asarray(q), jnp.asarray(vq), jnp.asarray(t), jnp.asarray(vt), cfg=cfg
    )
    ref = numpy_matches(q, vq, t, vt, cfg.ratio_thresh)
    v = np.asarray(mt.valid)
    got = dict(zip(zip(np.asarray(mt.query_idx)[v].tolist(),
                       np.asarray(mt.train_idx)[v].tolist()),
                   np.asarray(mt.distance)[v]))
    assert set(got) == set(ref)
    if all_invalid:
        assert not ref
        return
    assert len(ref) > bank // 8
    for key, dist in got.items():
        # f32 distances from |a|^2 + |b|^2 - 2ab: ~1e-3 absolute near 0.1
        assert abs(dist - ref[key]) < 2e-3
    # valid matches come first, sorted by ascending distance
    assert np.all(np.diff(np.asarray(mt.distance)[v]) >= 0)


@pytest.mark.gpu
def test_match_descriptors_on_gpu_against_numpy_top2(gpu_device):
    """On the card the distance product must not run at reduced (TF32)
    precision: the match set at a 2048 bank equals the float64 one."""
    q, vq, t, vt = structured_banks(2048, seed=11)
    cfg = MatchConfig(max_matches=2048, ratio_thresh=0.8)
    args = [jax.device_put(jnp.asarray(x), gpu_device) for x in (q, vq, t, vt)]
    mt = match.match_descriptors(*args, cfg=cfg)
    ref = numpy_matches(q, vq, t, vt, cfg.ratio_thresh)
    v = np.asarray(mt.valid)
    got = set(zip(np.asarray(mt.query_idx)[v].tolist(),
                  np.asarray(mt.train_idx)[v].tolist()))
    assert got == set(ref)
