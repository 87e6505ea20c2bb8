"""Feature-track building: union-find over pairwise matches, on the host.
The port's own copy of ``splat_one_tpu/sfm/tracks.py`` (pure numpy): a
component holding two features of one image is a false match somewhere
in its chain and is dropped whole; ``min_track_length`` images per track.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(
    matches: Dict[Tuple[int, int], np.ndarray],
    n_features: List[int],
    min_track_length: int = 2,
):
    """Merge pairwise matches into tracks.

    Args:
      matches: {(img_i, img_j): [M, 2] feature-index pairs}.
      n_features: feature count per image.
      min_track_length: minimum images per track (config.yaml:93).

    Returns:
      tracks: list of {image_idx: feature_idx} dicts,
      track_of: {(image, feature) -> track id}.
    """
    offsets = np.concatenate([[0], np.cumsum(n_features)])
    uf = UnionFind(int(offsets[-1]))
    for (i, j), m in matches.items():
        for fi, fj in m:
            uf.union(int(offsets[i] + fi), int(offsets[j] + fj))

    groups: Dict[int, Dict[int, int]] = {}
    bad: set = set()
    for img in range(len(n_features)):
        for f in range(n_features[img]):
            root = uf.find(int(offsets[img] + f))
            g = groups.setdefault(root, {})
            # two features of the SAME image merged into one component is
            # proof of a false match somewhere in the chain — the whole
            # track is unreliable. Discard it (OpenSfM's tracks_manager
            # does the same; keeping "the first" feature silently injects
            # observations of a different 3D point and warps BA).
            if img in g:
                bad.add(root)
            else:
                g[img] = f

    tracks = [
        g for root, g in groups.items()
        if root not in bad and len(g) >= min_track_length
    ]
    track_of = {}
    for tid, g in enumerate(tracks):
        for img, f in g.items():
            track_of[(img, f)] = tid
    return tracks, track_of
