"""Descriptor matching: exact brute-force top-2 + Lowe ratio test.

Replaces the reference's FLANN approximate KD-tree kNN (k=2) + ratio 0.3
(feature_matcher.cpp:42-59) with one matmul: for L2-normalized SURF
descriptors, d^2(a, b) = 2 - 2 a.b, so the full distance matrix is a single
(K, 64) x (64, K) contraction — exact, with strictly better recall than
FLANN.

Static shapes throughout: inputs are fixed-capacity descriptor banks with
validity masks; the output is a fixed-capacity match list with a mask.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import HIGHEST
from ..utils.config import MatchConfig


class Matches(NamedTuple):
    """Fixed-capacity match set (M = cfg.max_matches).

    query_idx / train_idx: (M,) int32 indices into the left/right keypoint
    banks; distance: (M,) L2 descriptor distance; valid: (M,) bool.
    Valid entries are packed first (sorted by ascending distance).
    """

    query_idx: jax.Array
    train_idx: jax.Array
    distance: jax.Array
    valid: jax.Array

    @property
    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


@partial(jax.jit, static_argnames=("cfg",))
def match_descriptors(
    desc1,
    valid1,
    desc2,
    valid2,
    cfg: MatchConfig = MatchConfig(),
) -> Matches:
    """One-way kNN(k=2) + ratio test, mirroring match_two_image semantics.

    desc1: (K1, D) query descriptors, desc2: (K2, D) train descriptors,
    valid1/valid2: (K,) bool masks for padded slots.
    """
    d1 = desc1.astype(jnp.float32)
    d2 = desc2.astype(jnp.float32)
    big = jnp.asarray(jnp.inf, jnp.float32)

    # Full squared-distance matrix from one matmul. Descriptors are
    # unit-norm, but compute the general form so non-normalized banks also
    # work. HIGHEST precision: at default precision a GPU may run this f32
    # product in TF32 (10-bit mantissa), which moves distances across the
    # Lowe ratio cut — on an H100 it changed up to 16 of ~270 matches per
    # 2K pair at bank 4096 — while HIGHEST costs under 1% of a 2K step
    # (PERF.md, Findings).
    sq1 = jnp.sum(d1 * d1, axis=-1, keepdims=True)
    sq2 = jnp.sum(d2 * d2, axis=-1, keepdims=True)
    cross = jnp.dot(d1, d2.T, precision=HIGHEST,
                    preferred_element_type=jnp.float32)
    dist2 = jnp.maximum(sq1 + sq2.T - 2.0 * cross, 0.0)
    # mask invalid train columns with +inf
    dist2 = jnp.where(valid2[None, :], dist2, big)

    # top-2 nearest neighbors per query row
    neg, idx = jax.lax.top_k(-dist2, 2)
    best = jnp.sqrt(-neg[:, 0])
    second = jnp.sqrt(-neg[:, 1])
    best_idx = idx[:, 0]

    good = (
        valid1
        & jnp.isfinite(best)
        & jnp.isfinite(second)
        & (best < cfg.ratio_thresh * second)
    )
    if cfg.mutual_check:
        # best match of the best train column must point back
        dist2_t = jnp.where(valid1[:, None], dist2, big)
        back = jnp.argmin(dist2_t, axis=0)  # (K2,)
        good = good & (back[best_idx] == jnp.arange(d1.shape[0]))

    # pack the good matches first, ordered by distance
    m = cfg.max_matches
    score = jnp.where(good, best, big)
    order = jnp.argsort(score)
    take = order[:m] if score.shape[0] >= m else jnp.pad(order, (0, m - score.shape[0]))
    q = take.astype(jnp.int32)
    t = best_idx[take].astype(jnp.int32)
    d = best[take]
    v = good[take] & (jnp.arange(m) < jnp.sum(good.astype(jnp.int32)))
    return Matches(
        query_idx=jnp.where(v, q, 0),
        train_idx=jnp.where(v, t, 0),
        distance=jnp.where(v, d, 0.0),
        valid=v,
    )
