"""The harness's seams hold every reading of the existing cells: the
model, the poses, the reference's render, the counted work and the
compared numbers of the garden and room stand-ins are bit for bit what
the harness gave before its kinds, models and camera models became
files (SHA-256 digests of float32 and integer arrays, taken with
PyTorch's CPU kernels on x86-64; a CPU of another family may round its
vector paths otherwise). And a name with no file is refused."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark.kinds import view as V
from benchmark.reference import render as R
from benchmark.tests import bench_tiny as B

CPU = torch.device("cpu")
MIXES = {"garden": "view", "room": "view_360"}

GOLDEN = {
    ("garden", 7): dict(
        weights="b601c06ce307490e6bfa02eac771575904e0fe9e598254312023b0313e1c7f83",
        poses="42c3203dd2877e1a361547948facbbef792eada01a7e05eecc47b44f63d499e3",
        render=("b9a03ed18f24e80a312127bcb841d073c25ca99c1041e827caea4f6772b84293",
                "08060022cbb5a332eebade041950c4bfb3a354defc9a50f08b08264023689f14"),
        work="8da8d46343ba049ee3351130b6e95121c3d9cbeb1ed5aeb94ac1e2426dddf5aa",
        check={"frame_mae": "0.0",
               "rgb_mae": "4.6659906161039544e-08",
               "alpha_mae": "0.0",
               "depth_rel": "1.4842068196685432e-07"}),
    ("garden", 2147483659): dict(
        weights="17995b113cc213094be3babb9cb60b8e756ec57397e7db14f5681059b209ef09",
        poses="48d1c77704a907578794328e3e76161d6113f83ba55e1b9ac7700b17935d7070",
        render=("a0a795a139c8aaf790a27132b5281758fd098bf28f53b2ec5a2564d00d1c7351",
                "f970c613234cf058abc54e5141da71849e32c7bfc1579ab144e12238451d0373"),
        work="a37a64867c17cd72d691e34bc45452d6d0875a9f805ba1dfa3f43fbcb30a39ba",
        check={"frame_mae": "0.0",
               "rgb_mae": "4.917092155665159e-07",
               "alpha_mae": "7.466296665370464e-07",
               "depth_rel": "9.955988389265258e-06"}),
    ("room", 7): dict(
        weights="e1a74c7dc192dc543d04afacecb4165d0ddb5c6228f9c69742ab27992a22e620",
        poses="276c300d339c7590caaf2288064157b3973e74c316dffe84041275d3157b043b",
        render=("c5c724054f422ea1b2bbee7c99d4ff1599a1adf9256da365163bea18d8239bf8",
                "cb554e8e3f4b25f0babc13c6c195187946d0ecf95229e3286c030ff87a8a0e33"),
        work="e5289202109afa0695288940490dbab432acde258da240d98135429adcc56bb3",
        check={"frame_mae": "0.0",
               "rgb_mae": "1.4479479659712524e-07",
               "alpha_mae": "8.246085592134023e-09",
               "depth_rel": "2.6727491331257625e-07"}),
    ("room", 2147483659): dict(
        weights="511ed29d50025ce683693c86d52f995a759914c13763b8340612fb46d1208c89",
        poses="cac6cf7c5f8b6f63c5840e3e8d821a30b7f0bf6313d6ed46d666ad56e6006217",
        render=("b3491242474e643fbf5af54b085b1574cb0bf1c7b9d2259aa950a76e7e492f89",
                "dbd02213ffff86ccf1dc0f3381d281e8b40980b078ba363ada12316e19a30baf"),
        work="30e2323395e7ab110f1acad625723dd927ed1f0837065f68f63f424fc7a9d511",
        check={"frame_mae": "0.00021701388888888888",
               "rgb_mae": "5.952056625346813e-08",
               "alpha_mae": "1.1369896135704494e-08",
               "depth_rel": "1.1247612263787232e-07"}),
}


def digest(*arrays) -> str:
    m = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().contiguous().numpy()
        a = np.ascontiguousarray(a)
        m.update(f"{a.dtype}{a.shape}".encode())
        m.update(a.tobytes())
    return m.hexdigest()


class Clock:
    """A clock that moves 10 ms a reading: the window holds the same
    requests however fast the CPU is."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


@pytest.mark.parametrize("config,seed", sorted(GOLDEN))
def test_readings_are_bit_for_bit_unchanged(config, seed, monkeypatch):
    want = GOLDEN[(config, seed)]
    cfg = B.tiny_config(config)
    mix = B.mix(MIXES[config], expect_requests=2, check_requests=2, trace_units=2)
    w, alive = H.load_model(cfg).make_weights(cfg, seed, CPU)
    assert digest(*[w[k] for k in sorted(w)], alive) == want["weights"]
    poses = V.view_poses(cfg, mix, seed)
    assert digest(poses) == want["poses"]
    su = V.setup(cfg, mix, seed, CPU, [poses[0], poses[1]])
    got = tuple(digest(r.rgb, r.depth, r.alpha, np.array([r.needed, r.visible]))
                for r in V.reference_view(su))
    assert got == want["render"]
    monkeypatch.setattr(V, "time", Clock())
    out = V.run(cfg, mix, seed, 0.05, True, CPU, lambda: 0.0)
    work = out["work"]()
    assert digest(np.array([[r["pairs"], r["visible"]] for r in work["rows"]]),
                  np.array([work["n_alive"], work["pixels"]])) == want["work"]
    assert {k: repr(v) for k, v in out["check"]().items()} == want["check"]


def test_a_name_with_no_file_is_refused(tmp_path):
    with pytest.raises(H.Refused, match="kinds/train"):
        H.load_kind("train")
    with pytest.raises(H.Refused, match="models/mlp"):
        H.load_model({"model": "mlp"})
    assert H.model_name({}) == "gaussians"
    with pytest.raises(ValueError, match="fisheye"):
        R.camera("fisheye")
