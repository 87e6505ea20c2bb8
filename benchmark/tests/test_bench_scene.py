"""The seeded scene: the buffer laid out as a grown and pruned run leaves
it, and what belongs to the scene rather than the seed drawn alike."""

import numpy as np
import torch

from benchmark import scene as S
from benchmark.kinds import view as V
from benchmark.models import gaussians as G
from benchmark.tests import bench_tiny as B

CPU = torch.device("cpu")


def test_dead_rows_are_pruned_gaussians_then_zero_rows():
    cfg = B.tiny_config("garden", n=1500, cap=2048)
    w, alive = G.make_weights(cfg, 31, CPU)
    n, p = cfg["n_gaussians"], S.dead_rows(cfg)
    assert p == 75 and int(alive.sum()) == n
    used = n + p
    assert not bool(alive[used:].any())
    for v in w.values():
        assert v.shape[0] == 2048 and not bool(v[used:].any())  # grow_capacity's zero rows
    pruned = torch.nonzero(~alive[:used])[:, 0]
    assert pruned.numel() == p and int(pruned.min()) < n // 2  # scattered, not a tail
    logit = w["opacities"]
    assert float(logit[pruned].max()) <= cfg["dead_rows"]["prune_below_logit"]
    assert bool((w["scales"][pruned] != 0).all())  # they keep their last values


def test_pruned_rows_fit_below_the_capacity():
    cfg = B.tiny_config("room", n=500, cap=512)
    w, alive = G.make_weights(cfg, 32, CPU)
    assert S.dead_rows(cfg) == 12 and int(alive.sum()) == 500


def test_every_seed_serves_the_same_model_and_poses_in_its_own_order():
    cfg = B.tiny_config("room")
    mix = B.mix("view_360")
    a, b = V.view_poses(cfg, mix, 1), V.view_poses(cfg, mix, 2)
    shift = [k for k in range(len(a)) if np.array_equal(np.roll(a, -k, axis=0), b)]
    assert len(shift) == 1 and shift[0] != 0
    (wa, la), (wb, lb) = G.make_weights(cfg, 1, CPU), G.make_weights(cfg, 2, CPU)
    assert not torch.equal(wa["means"], wb["means"])

    def rows(w, live):
        x = torch.cat([v.reshape(v.shape[0], -1) for v in w.values()], 1)[live].numpy()
        return x[np.lexsort(x.T[::-1])]

    assert np.array_equal(rows(wa, la), rows(wb, lb))
    assert np.array_equal(rows(wa, ~la), rows(wb, ~lb))
