"""The appearance head's two paths: ``appearance_rgb_from_centres`` is the
plain composition ``appearance_rgb(..., means[None] - centres[:, None])``
on the CPU; on CUDA tensors it launches the kernel (``appearance_fwd``,
``csrc/appearance_fwd.cu``), whose checks raise before any library is
loaded; its argument list
matches the launcher's C signature; on the card (``-m gpu``) the kernel
equals the plain version within 2e-6. No JAX here: the card runs this
file without the suite's conftest."""

import contextlib
import ctypes
from types import SimpleNamespace

import pytest
import torch

from splat_one_tpu_torch.ops import appearance as ao
from splat_one_tpu_torch.train import appearance as APP
from splat_one_tpu_torch.utils import cuda_build

# (name, linear layers): the port's init_appearance_params at its default
# (two: one hidden layer) and gsplat's mlp_depth=2 (three)
HEADS = (("trainer", 2), ("gsplat", 3))


def _head(layers, sh_degree, n_images=5, feature_dim=32, embed_dim=16, width=64,
          device="cpu", seed=0):
    """A head with every parameter drawn (the init's zero embeddings and
    biases would hide their terms)."""
    g = torch.Generator().manual_seed(seed)
    app = APP.init_appearance_params(g, n_images, feature_dim, embed_dim, sh_degree, width,
                                     layers)
    for k in app:
        if not k.startswith("w"):
            app[k] = 0.3 * torch.randn(app[k].shape, generator=g)
    return {k: v.to(device) for k, v in app.items()}


def _rows(n, feature_dim=32, c=2, device="cpu", seed=1):
    """(features, colour logits, image ids, means, centres): C camera
    centres, the first mean exactly at the first centre."""
    g = torch.Generator().manual_seed(seed)
    means = 3.0 * torch.randn((n, 3), generator=g)
    centres = torch.randn((c, 3), generator=g)
    means[0] = centres[0]
    out = (torch.rand((n, feature_dim), generator=g), torch.randn((n, 3), generator=g),
           torch.arange(c, dtype=torch.int64) % 5, means, centres)
    return tuple(t.to(device) for t in out)


def _kernel_must_not_run(*args, **kwargs):
    raise AssertionError("the kernel path was taken")


@pytest.mark.parametrize("sh_degree", [0, 3, 4])
@pytest.mark.parametrize("head", [h[0] for h in HEADS])
def test_cpu_entry_is_the_plain_composition(head, sh_degree, monkeypatch):
    """On CPU tensors the entry gives ``appearance_rgb`` on the directions
    from the centres bit for bit, for both heads and C = 2 cameras, and
    never reaches the kernel."""
    monkeypatch.setattr(ao, "appearance_fwd", _kernel_must_not_run)
    app = _head(dict(HEADS)[head], sh_degree)
    feats, logits, ids, means, centres = _rows(300)
    got = APP.appearance_rgb_from_centres(app, feats, logits, ids, means, centres, sh_degree)
    want = APP.appearance_rgb(app, feats, logits, ids, means[None] - centres[:, None],
                              sh_degree)
    assert got.shape == (2, 300, 3)
    assert torch.equal(got, want)


def test_cpu_entry_carries_the_gradients():
    """Autograd records through the entry as through ``appearance_rgb``."""
    app = {k: v.requires_grad_(True) for k, v in _head(3, 3).items()}
    feats, logits, ids, means, centres = _rows(64)
    grads = []
    for fn in (lambda: APP.appearance_rgb_from_centres(app, feats, logits, ids, means,
                                                       centres, 3),
               lambda: APP.appearance_rgb(app, feats, logits, ids,
                                          means[None] - centres[:, None], 3)):
        grads.append(torch.autograd.grad(fn().square().sum(), list(app.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _bad_inputs():
    """(case, (params, features, colours, image ids, means, centres,
    degree), what the refusal says) that the wrapper must refuse."""
    app = _head(3, 3)
    feats, logits, ids, means, centres = _rows(40, c=1)
    ok = (app, feats, logits, ids, means, centres, 3)

    def with_(i, v):
        return tuple(v if j == i else x for j, x in enumerate(ok))

    narrow = _head(3, 3, width=32)
    shallow = {k: v for k, v in _head(2, 3).items() if k not in ("w1", "b1")}
    shallow["w0"] = torch.zeros(64, 3)
    shallow["b0"] = torch.zeros(3)
    deep = dict(app, w3=torch.zeros(3, 3), b3=torch.zeros(3))
    deep["w2"], deep["b2"] = torch.zeros(64, 64), torch.zeros(64)
    wide = _head(3, 3, feature_dim=112)
    odd = _head(3, 3, feature_dim=30)
    unaligned = torch.zeros(40 * 32 + 1)[1:].view(40, 32)
    _, _, ids2, _, centres2 = _rows(40, c=2)
    recorded = dict(app, w0=app["w0"].clone().requires_grad_(True))
    return [
        ("features float64", with_(1, feats.double()), "features must be float32"),
        ("means [N, 4]", with_(4, torch.zeros(40, 4)), "means must be float32"),
        ("hidden width 32", with_(0, narrow), "w0 must be float32"),
        ("one linear layer", with_(0, shallow), "2 or 3 linear layers"),
        ("four linear layers", with_(0, deep), "2 or 3 linear layers"),
        ("input 16 + 112 + 16 wider than 128",
         (wide, torch.zeros(40, 112), logits, ids, means, centres, 3), "wider than 128"),
        ("w0 rows of another degree", with_(6, 2), "w0 must be float32"),
        ("SH degree 5", with_(6, 5), "SH degree"),
        ("features strided", with_(1, feats.t().contiguous().t()),
         "features must be contiguous"),
        ("features 30 wide", (odd, torch.zeros(40, 30), logits, ids, means, centres, 3),
         "got F = 30"),
        ("features not 16-byte aligned", with_(1, unaligned), "address 4 mod 16"),
        ("two cameras", (app, feats, logits, ids2, means, centres2, 3), "one camera"),
        ("image ids int32", with_(3, ids.int()), "image_ids must be int64"),
        ("autograd records through w0", with_(0, recorded), "autograd"),
        ("CPU tensors", ok, "CUDA device"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _bad_inputs()])
def test_kernel_wrapper_refuses_before_loading(case, monkeypatch):
    """Dtype, shape, hidden width, depth, input width, SH degree,
    contiguity, the features' width and alignment, the number of cameras,
    autograd and device are checked in Python and raise ValueError, each
    for its own reason, before the library is built."""
    monkeypatch.setattr(cuda_build, "library", _kernel_must_not_run)
    _, args, says = next(c for c in _bad_inputs() if c[0] == case)
    with pytest.raises(ValueError, match=says):
        ao.appearance_fwd(*args)


def test_renderer_refuses_a_head_without_image_0():
    """The Renderer serves image 0's embedding, which the kernel reads
    unchecked: a head whose ``embeds`` has no row 0 is refused when the
    Renderer is made, not per request."""
    from splat_one_tpu_torch.app.viewer import Renderer

    n = 8
    params = {"means": torch.zeros((n, 3)), "quats": torch.zeros((n, 4)),
              "scales": torch.zeros((n, 3)), "opacities": torch.zeros(n),
              "features": torch.zeros((n, 32)), "colors": torch.zeros((n, 3))}
    app = _head(3, 3)
    app["embeds"] = app["embeds"][:0]
    with pytest.raises(ValueError, match="image 0"):
        Renderer(params, torch.ones(n, dtype=torch.bool), 16, 16, sh_degree=3, device="cpu",
                 app_params=app)


@pytest.mark.parametrize("head", [h[0] for h in HEADS])
def test_wrapper_call_matches_signature(head, monkeypatch):
    """The wrapper's arguments pass ctypes' conversion for
    ``SIGNATURES["appearance_fwd"]``, in number and kind, with the sizes
    in their places and no second layer for the two-layer head; one
    launch, counted."""
    seen = []

    def launcher(*args):
        seen.append(args)
        return 0

    fn = ctypes.CFUNCTYPE(ctypes.c_int, *cuda_build.SIGNATURES["appearance_fwd"])(launcher)
    monkeypatch.setattr(cuda_build, "library", lambda name: SimpleNamespace(appearance_fwd=fn))
    monkeypatch.setattr(ao, "_check_cuda", lambda named, dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_build, "launch_counts", cuda_build.launch_counts.copy())
    layers = dict(HEADS)[head]
    feats, logits, ids, means, centres = _rows(40, c=1)
    out = ao.appearance_fwd(_head(layers, 2), feats, logits, ids, means, centres, 2)
    assert out.shape == (1, 40, 3)
    assert len(seen) == 1
    for args in seen:
        assert len(args) == len(cuda_build.SIGNATURES["appearance_fwd"])
        assert args[4] == 1  # the centres' element stride
        assert list(args[14:18]) == [40, 16, 32, 9]
        assert (args[9] is None) == (layers == 2)
    assert cuda_build.launch_counts["appearance_fwd"] == 1


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("head", [h[0] for h in HEADS])
def test_cuda_kernel_matches_plain(head):
    """On the card the kernel's colours are the plain version's within
    2e-6, at SH degrees 0-4, for N = 1, N off the 256-row tile and a mean
    exactly at the camera centre (the norm's 1e-8 clamp), one launch a
    call; inputs that autograd records through raise there. Run with ``python -m pytest tests/test_torch_appearance_fwd.py
    -m gpu --noconftest``."""
    _gpu()
    for sh_degree in range(5):
        app = _head(dict(HEADS)[head], sh_degree, device="cuda", seed=sh_degree)
        for n in (1, 3001):
            feats, logits, ids, means, centres = _rows(n, c=1, device="cuda", seed=n)
            before = cuda_build.launch_counts["appearance_fwd"]
            with torch.no_grad():
                got = APP.appearance_rgb_from_centres(app, feats, logits, ids, means, centres,
                                                      sh_degree)
                want = APP.appearance_rgb(app, feats, logits, ids,
                                          means[None] - centres[:, None], sh_degree)
            assert cuda_build.launch_counts["appearance_fwd"] == before + 1
            assert float((got - want).abs().max()) <= 2e-6, (sh_degree, n)
    recorded = dict(app, w0=app["w0"].clone().requires_grad_(True))
    with pytest.raises(ValueError, match="autograd"):
        APP.appearance_rgb_from_centres(recorded, feats, logits, ids, means, centres, 4)


@pytest.mark.gpu
def test_cuda_request_launches_the_kernel_once_and_no_gemm():
    """One appearance ``Renderer`` request on the card launches the kernel
    once and no matrix product; a head the kernel does not serve raises
    there."""
    _gpu()
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from splat_one_tpu_torch.app.viewer import Renderer

    n = 4000
    g = torch.Generator().manual_seed(2)
    params = {"means": 2.0 * torch.randn((n, 3), generator=g) + torch.tensor([0, 0, 6.0]),
              "quats": torch.randn((n, 4), generator=g),
              "scales": torch.full((n, 3), -3.0), "opacities": torch.zeros(n),
              "features": torch.rand((n, 32), generator=g), "colors": torch.zeros((n, 3))}
    alive = torch.ones(n, dtype=torch.bool)
    c2w, K = np.eye(4, dtype=np.float32), np.float32([[80, 0, 48], [0, 80, 32], [0, 0, 1]])
    rd = Renderer(params, alive, 96, 64, sh_degree=3, device="cuda", app_params=_head(3, 3))
    rd(c2w, K)
    torch.cuda.synchronize()
    before = cuda_build.launch_counts["appearance_fwd"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rd(c2w, K)
        torch.cuda.synchronize()
    assert cuda_build.launch_counts["appearance_fwd"] == before + 1
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert any("appearance_kernel" in x for x in names), names
    assert not [x for x in names if "gemm" in x.lower()]
    narrow = Renderer(params, alive, 96, 64, sh_degree=3, device="cuda",
                      app_params=_head(3, 3, width=32))
    with pytest.raises(ValueError):
        narrow(c2w, K)
