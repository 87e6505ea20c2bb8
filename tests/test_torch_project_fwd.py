"""The projection's two paths: ``project_gaussians`` takes the kernel
(``project_fwd``, ``csrc/project_fwd.cu``) only for CUDA inputs that
autograd does not record through; the kernel wrapper's checks raise
before any library is loaded; its argument list matches the launcher's C
signature; on the card (``-m gpu``) the kernel equals the plain version.
No JAX here: the card runs this file without the suite's conftest."""

import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import projection as tp
from splat_one_tpu_torch.utils import cuda_build


def _scene(n=64, c=2, k=16, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 4
    viewmats = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    viewmats[1:, 0, 3] = 0.4
    Ks = np.tile(np.float32([[60.0, 0, 32], [0, 58.0, 32], [0, 0, 1]]), (c, 1, 1))
    arrays = dict(means=means, quats=rng.normal(size=(n, 4)).astype(np.float32),
                  scales=np.exp(rng.uniform(-3.5, -2.0, (n, 3))).astype(np.float32),
                  opacities=rng.uniform(0.3, 1.0, n).astype(np.float32),
                  viewmats=viewmats, Ks=Ks,
                  sh=(rng.normal(size=(n, k, 3)) * 0.3).astype(np.float32))
    out = {key: torch.as_tensor(v, device=device) for key, v in arrays.items()}
    out["alive"] = torch.as_tensor(rng.uniform(size=n) > 0.1, device=device)
    return out


GEO = ("means", "quats", "scales", "opacities", "viewmats", "Ks")


def _kernel_must_not_run(*args, **kwargs):
    raise AssertionError("the kernel path was taken")


@pytest.mark.parametrize("grad", ["off", "on", "leaf"])
def test_cpu_inputs_take_the_plain_path(grad, monkeypatch):
    """CPU tensors run the plain version, with autograd recording or not,
    and count no kernel rows."""
    monkeypatch.setattr(tp, "project_fwd", _kernel_must_not_run)
    sc = _scene()
    if grad == "leaf":
        sc["means"].requires_grad_(True)
    geo = [sc[k] for k in GEO]
    kw = dict(sh_coeffs=sc["sh"], sh_degree=3, alive=sc["alive"])
    with torch.set_grad_enabled(grad != "off"):
        got = tp.project_gaussians(*geo, 64, 64, **kw)
        want = tp.project_gaussians_plain(*geo, 64, 64, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.means2d.requires_grad == (grad == "leaf")


def test_records_grad():
    """The kernel's half of the dispatch: grad mode on and an input that
    requires grad means autograd records; no_grad and inference_mode do
    not, nor inputs without requires_grad; None entries are skipped."""
    leaf = torch.zeros(3, requires_grad=True)
    plain = torch.zeros(3)
    assert tp.records_grad(plain, None, leaf)
    assert not tp.records_grad(plain, None)
    with torch.no_grad():
        assert not tp.records_grad(leaf)
    with torch.inference_mode():
        assert not tp.records_grad(leaf)


def _bad_inputs():
    """(case, inputs, keywords) that the wrapper must refuse."""
    sc = _scene()
    geo = {k: sc[k] for k in GEO}
    spare = torch.zeros(64 * 3 + 1)
    cases = [
        ("means float64", dict(geo, means=geo["means"].double()), {}),
        ("quats [N, 3]", dict(geo, quats=geo["quats"][:, :3].contiguous()), {}),
        ("scales strided", dict(geo, scales=geo["scales"].t().contiguous().t()), {}),
        ("means unaligned", dict(geo, means=spare[1:].view(64, 3)), {}),
        ("opacities [N, 1]", dict(geo, opacities=geo["opacities"][:, None]), {}),
        ("viewmats [C, 3, 4]", dict(geo, viewmats=geo["viewmats"][:, :3].contiguous()), {}),
        ("Ks of another C", dict(geo, Ks=geo["Ks"][:1]), {}),
        ("sh too short", geo, dict(sh_coeffs=sc["sh"][:, :9].contiguous(), sh_degree=3)),
        ("sh too long", geo, dict(sh_coeffs=torch.zeros(64, 26, 3), sh_degree=3)),
        ("sh degree 5", geo, dict(sh_coeffs=sc["sh"], sh_degree=5)),
        ("alive float", geo, dict(alive=sc["alive"].float())),
        ("unknown camera", geo, dict(camera_model="orthographic")),
        ("CPU tensors", geo, dict(sh_coeffs=sc["sh"], sh_degree=3, alive=sc["alive"])),
    ]
    return cases


@pytest.mark.parametrize("case", [c[0] for c in _bad_inputs()])
def test_kernel_wrapper_refuses_before_loading(case, monkeypatch):
    """Dtype, shape, contiguity, alignment, SH width, mask and device are
    checked in Python and raise ValueError before the library is built."""
    monkeypatch.setattr(cuda_build, "library", _kernel_must_not_run)
    _, geo, kw = next(c for c in _bad_inputs() if c[0] == case)
    with pytest.raises(ValueError):
        tp.project_fwd(*[geo[k] for k in GEO], 64, 64, **kw)


@pytest.mark.parametrize("with_sh", [True, False])
def test_wrapper_call_matches_signature(with_sh, monkeypatch):
    """The wrapper's arguments pass ctypes' conversion for
    ``SIGNATURES["project_fwd"]``, in number and kind, with the shape
    and mode integers in their places; a launch counts once."""
    seen = []

    def launcher(*args):
        seen.append(args)
        return 0

    fn = ctypes.CFUNCTYPE(ctypes.c_int, *cuda_build.SIGNATURES["project_fwd"])(launcher)
    lib = SimpleNamespace(project_fwd=fn)
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    monkeypatch.setattr(tp, "_check_cuda", lambda named, dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_build, "launch_counts", cuda_build.launch_counts.copy())
    sc = _scene(n=40, c=3, k=16)
    kw = dict(sh_coeffs=sc["sh"], sh_degree=2) if with_sh else {}
    out = tp.project_fwd(*[sc[k] for k in GEO], 96, 72, camera_model="fisheye",
                         antialiased=True, alive=sc["alive"], **kw)
    (args,) = seen
    assert len(args) == len(cuda_build.SIGNATURES["project_fwd"])
    assert list(args[15:23]) == [40, 3, 16 if with_sh else 0, 9 if with_sh else 1, 2, 1, 96, 72]
    assert (args[4] is not None, args[12] is not None) == (with_sh, with_sh)
    assert [tuple(t.shape) for t in out if t is not None] == (
        [(3, 40, 2), (3, 40, 3), (3, 40), (3, 40)] + [(3, 40, 3)] * with_sh
        + [(3, 40), (3, 40)])
    assert cuda_build.launch_counts["project_fwd"] == 1


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["pinhole", "ortho", "fisheye", "spherical"])
def test_cuda_kernel_matches_plain(model):
    """On the card the kernel gives the plain version's valid, radii,
    means2d, conics, depths and opacities bit for bit, and its colours
    within 2e-6 (the SH sum's order differs). Run with ``python -m pytest
    tests/test_torch_project_fwd.py -m gpu --noconftest``."""
    _gpu()
    sc = _scene(n=3000, c=2, k=16, device="cuda")
    geo = [sc[k] for k in GEO]
    for deg, aa in ((3, False), (1, True), (0, False)):
        kw = dict(sh_coeffs=sc["sh"], sh_degree=deg, camera_model=model, antialiased=aa,
                  alive=sc["alive"], radius_clip=0.3)
        before = cuda_build.launch_counts["project_fwd"]
        with torch.no_grad():
            got = tp.project_gaussians(*geo, 64, 64, **kw)
            want = tp.project_gaussians_plain(*geo, 64, 64, **kw)
        assert cuda_build.launch_counts["project_fwd"] == before + 1
        for name in ("means2d", "conics", "depths", "radii", "opacities", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert float((got.colors - want.colors).abs().max()) <= 2e-6
