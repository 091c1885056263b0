"""Descriptor matching: mutual-nearest-neighbor with ratio test
(port of ``ucnerf_tpu/pose/matching.py``).

Functional parity with the reference's matchers
(``pose_refinement/stpr/scripts/mvs/matchers.py:37-56``):
cosine-similarity nearest neighbors, descriptor distance sqrt(2 - 2 sim),
Lowe ratio test in both directions, and mutual-NN consistency.  The
similarities are a float32 matmul on the working device (keep TF32 off on
the card); the top-2 is an argmax, which takes the lowest index among equal
values as ``jax.lax.top_k`` does, and a max over the rest.
``exhaustive_match`` matches every image against all later ones with one
product per image.  ``epipolar_filter``, ``UnionFind`` and ``build_tracks``
are numpy copies.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _top2(s):
    """Top-2 values and the top index along the last axis of `s`, in
    ``jax.lax.top_k``'s tie order."""
    nn1 = torch.argmax(s, dim=-1, keepdim=True)
    v1 = torch.gather(s, -1, nn1)
    v2 = torch.max(s.scatter(-1, nn1, -math.inf), dim=-1, keepdim=True).values
    return torch.cat([v1, v2], -1), nn1[..., 0]


def _ratios(top2):
    dist = torch.sqrt(torch.clamp(2 - 2 * top2, min=0.0))
    return dist[..., 0] / (dist[..., 1] + 1e-8)


def mutual_nn_ratio_match(desc1, desc2, ratio=0.8, device="cuda"):
    """Match unit-norm descriptors [N1, D] x [N2, D] (numpy or tensors) ->
    [M, 2] index pairs (int64 numpy), as the JAX package's
    ``mutual_nn_ratio_match``."""
    return exhaustive_match([desc1, desc2], ratio, device).get(
        (0, 1), np.zeros((0, 2), np.int64))


def exhaustive_match(descs, ratio=0.8, device="cuda"):
    """The mutual-NN ratio matches of every pair (i, j > i) of images whose
    descriptor lists are not empty: {(i, j): [M, 2] int64 numpy} in (i, j)
    order, pairs without a match left out.  One product per image against
    all later images (their descriptors concatenated); the top-2 of each
    pair's block of columns in one batched call."""
    descs = [torch.as_tensor(d, device=device) for d in descs]
    n = len(descs)
    sizes = [len(d) for d in descs]
    kmax = max(sizes, default=0)
    if n < 2 or kmax == 0:
        return {}
    dim = descs[0].shape[1]
    # Every image's descriptors padded to kmax rows; `valid` marks the real.
    table = torch.zeros((n, kmax, dim), device=device)
    valid = torch.zeros((n, kmax), dtype=torch.bool, device=device)
    for i, d in enumerate(descs):
        table[i, :sizes[i]] = d
        valid[i, :sizes[i]] = True
    out = {}
    for i in range(n - 1):
        if not sizes[i]:
            continue
        later = [j for j in range(i + 1, n) if sizes[j]]
        if not later:
            continue
        js = torch.as_tensor(later, device=device)
        d1 = table[i, :sizes[i]]                        # [K1, D]
        sim = (d1 @ table[js].reshape(-1, dim).T).reshape(
            sizes[i], len(later), kmax)                 # [K1, J, K]
        sim = sim.masked_fill(~valid[js][None], -math.inf)
        top12, nn12 = _top2(sim)                        # [K1, J]
        top21, nn21 = _top2(sim.permute(1, 2, 0))       # [J, K, K1]
        ratios12, ratios21 = _ratios(top12), _ratios(top21)
        jj = torch.arange(len(later), device=device)[None]
        ids1 = torch.arange(sizes[i], device=device)[:, None]
        mask = ((nn21[jj, nn12] == ids1) & (ratios12 <= ratio)
                & (ratios21[jj, nn12] <= ratio))        # [K1, J]
        col, kp = torch.nonzero(mask.T, as_tuple=True)  # pair-major
        pairs = torch.stack([kp, nn12[kp, col]], -1).cpu().numpy()
        counts = mask.sum(0).cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(counts)])
        for col, j in enumerate(later):
            if counts[col]:
                out[(i, j)] = pairs[starts[col]:starts[col + 1]]
    return out


def epipolar_filter(kps1, kps2, matches, k1, k2, pose1_w2c, pose2_w2c,
                    threshold=4.0):
    """Keep matches consistent with the known relative geometry.

    Replaces the reference's F/H RANSAC verification
    (prepare_all_data_for_mvs.py:195-218) with a direct epipolar check —
    initial poses exist in this pipeline, so no hypothesis sampling is
    needed.  threshold is in pixels (symmetric epipolar distance).
    """
    if len(matches) == 0:
        return matches
    rel = pose2_w2c @ np.linalg.inv(pose1_w2c)
    r, t = rel[:3, :3], rel[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    e = tx @ r
    f = np.linalg.inv(k2).T @ e @ np.linalg.inv(k1)

    p1 = np.concatenate([kps1[matches[:, 0]], np.ones((len(matches), 1))], 1)
    p2 = np.concatenate([kps2[matches[:, 1]], np.ones((len(matches), 1))], 1)
    fp1 = p1 @ f.T
    ftp2 = p2 @ f
    d = np.abs(np.sum(p2 * fp1, axis=1))
    denom = np.sqrt(fp1[:, 0] ** 2 + fp1[:, 1] ** 2 + 1e-12) + np.sqrt(
        ftp2[:, 0] ** 2 + ftp2[:, 1] ** 2 + 1e-12)
    sym_dist = 2 * d / denom
    return matches[sym_dist < threshold]


class UnionFind:
    """Track builder: merges matched keypoints into 3D point tracks."""

    def __init__(self):
        self.parent = {}

    def find(self, a):
        while self.parent.setdefault(a, a) != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(all_matches, min_track_len=2):
    """Merge pairwise matches into tracks.

    Args:
      all_matches: dict {(img_i, img_j): [M, 2] keypoint index pairs}.

    Returns:
      list of tracks, each a list of (img_idx, kp_idx); tracks with
      conflicting observations (two kps of one image) are dropped.
    """
    uf = UnionFind()
    for (i, j), m in all_matches.items():
        for a, b in np.asarray(m):
            uf.union((i, int(a)), (j, int(b)))
    groups = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)
    tracks = []
    for members in groups.values():
        if len(members) < min_track_len:
            continue
        imgs = [m[0] for m in members]
        if len(set(imgs)) != len(imgs):
            continue  # conflicting track
        tracks.append(sorted(members))
    return tracks
