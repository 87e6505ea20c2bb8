"""The build's pack: ``pack_stream_fields`` takes the plain composition
(``pack_stream(build_field_columns(...))``) for CPU tensors and the kernel
(``stream_pack``, ``csrc/stream_pack.cu``) for CUDA tensors; the kernel
wrapper's checks raise before any library is loaded; its argument list
matches the launcher's C signature; on the card (``-m gpu``) the kernel
writes the plain version's whole table bit for bit, and ``composite_stream``
renders and differentiates as before. No JAX here: the card runs this file
without the suite's conftest (``python -m pytest
tests/test_torch_stream_pack.py -m gpu --noconftest``)."""

import contextlib
import ctypes
from types import SimpleNamespace

import pytest
import torch

from splat_one_tpu_torch.ops import projection as tp
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.ops import stream_raster as tsr
from splat_one_tpu_torch.utils import cuda_build
from test_torch_slab import _port_slab_inputs
from test_torch_stream_raster import CASES, _scene

FIELDS = ("means2d", "conics", "opacities", "colors", "depths", "radii")


def _proj(case, device="cpu"):
    kw, model = CASES[case]
    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(**kw)
    t = lambda x: torch.as_tensor(x, device=device)
    with torch.no_grad():
        proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)),
                                    w, h, colors=t(colors), camera_model=model)
    return proj, model, w, h


def _layout(case, device="cpu"):
    """(fields, isect, caps) of a case: the projection's [C, N, ...]
    outputs as ``pack_stream_fields`` takes them, and the stream layout.
    ``overflow`` forces n_isect past exp_cap; ``all-sentinel`` culls every
    gaussian, so every slot is the sentinel."""
    if case == "slab":
        proj, cfg, isect, _, _ = _port_slab_inputs("spherical", device)
        return [getattr(proj, f) for f in FIELDS], isect, cfg.caps
    proj, model, w, h = _proj("pinhole" if case in ("overflow", "all-sentinel") else case,
                              device)
    if case == "all-sentinel":
        proj = proj._replace(valid=torch.zeros_like(proj.valid))
    C, N = proj.depths.shape
    _, _, sw, sh = tsi.supertile_grid(w, h, 16)
    caps = (tsi.StreamCaps(exp_cap=512, n_supertiles=C * sw * sh) if case == "overflow"
            else tsi.StreamCaps.choose(N, C, C * sw * sh))
    isect = tsi.build_stream_intersections(proj, w, h, 16, caps, camera_model=model)
    if case == "overflow":
        assert bool(isect.overflow)
    if case == "all-sentinel":
        assert int(isect.n_slots) == 0
    return [getattr(proj, f) for f in FIELDS], isect, caps


def _plain(fields, isect, caps):
    return tsi.pack_stream(tsi.build_field_columns(*fields), isect, caps)


def _kernel_must_not_run(*args, **kwargs):
    raise AssertionError("the kernel path was taken")


CPU_CASES = ("pinhole", "spherical", "edge-partial", "overflow")


@pytest.mark.parametrize("case", CPU_CASES)
def test_cpu_inputs_take_the_plain_path(case, monkeypatch):
    """CPU tensors run the plain composition, and no library is loaded."""
    monkeypatch.setattr(tsi, "stream_pack", _kernel_must_not_run)
    monkeypatch.setattr(cuda_build, "library", _kernel_must_not_run)
    fields, isect, caps = _layout(case)
    got = tsi.pack_stream_fields(*fields, isect, caps)
    assert got.shape == (caps.packed_rows, tsi.NF)
    assert torch.equal(got, _plain(fields, isect, caps))


def _bad_inputs():
    """(case, fields, sorted_g) that the kernel wrapper must refuse."""
    fields, isect, caps = _layout("pinhole")
    f = {k: t.contiguous() for k, t in zip(FIELDS, fields)}
    sg = isect.sorted_g
    cases = [
        ("means2d float64", dict(f, means2d=f["means2d"].double()), sg),
        ("conics [C, N, 2]", dict(f, conics=f["conics"][..., :2].contiguous()), sg),
        ("opacities [C*N]", dict(f, opacities=f["opacities"].reshape(-1)), sg),
        ("colors [C, N, 4]", dict(f, colors=torch.cat([f["colors"], f["depths"][..., None]],
                                                      -1)), sg),
        ("depths strided", dict(f, depths=f["depths"].t().contiguous().t()), sg),
        ("means2d strided",
         dict(f, means2d=f["means2d"].transpose(0, 1).contiguous().transpose(0, 1)), sg),
        ("radii int32", dict(f, radii=f["radii"].int()), sg),
        ("sorted_g int64", f, sg.long()),
        ("sorted_g short", f, sg[:-1]),
        ("CPU tensors", f, sg),
    ]
    return caps, cases


@pytest.mark.parametrize("case", [c[0] for c in _bad_inputs()[1]])
def test_kernel_wrapper_refuses_before_loading(case, monkeypatch):
    """Dtype, shape, contiguity and device are checked in Python and raise
    ValueError before the library is built."""
    monkeypatch.setattr(cuda_build, "library", _kernel_must_not_run)
    caps, cases = _bad_inputs()
    _, f, sg = next(c for c in cases if c[0] == case)
    with pytest.raises(ValueError):
        tsi.stream_pack(*[f[k] for k in FIELDS], sg, caps)


def test_wrapper_call_matches_signature(monkeypatch):
    """The wrapper's arguments pass ctypes' conversion for
    ``SIGNATURES["stream_pack"]``, in number and kind, with exp_cap, C * N
    and the rows in their places; the output is [packed_rows, NF]; a
    launch counts once."""
    seen = []

    def launcher(*args):
        seen.append(args)
        return 0

    fn = ctypes.CFUNCTYPE(ctypes.c_int, *cuda_build.SIGNATURES["stream_pack"])(launcher)
    lib = SimpleNamespace(stream_pack=fn)
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    monkeypatch.setattr(tsi, "_check_cuda", lambda named, dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_build, "launch_counts", cuda_build.launch_counts.copy())
    fields, isect, caps = _layout("pinhole")
    fields = [t.contiguous() for t in fields]  # the colours: a view of [N, 3]
    out = tsi.stream_pack(*fields, isect.sorted_g, caps)
    (args,) = seen
    assert len(args) == len(cuda_build.SIGNATURES["stream_pack"])
    C, N = fields[2].shape
    assert list(args[8:11]) == [caps.exp_cap, C * N, caps.packed_rows]
    assert args[0] == isect.sorted_g.data_ptr() and args[7] == out.data_ptr()
    assert tuple(out.shape) == (caps.packed_rows, tsi.NF)
    assert cuda_build.launch_counts["stream_pack"] == 1


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


GPU_PACK_CASES = ("pinhole", "edge-partial", "spherical", "slab", "overflow",
                  "all-sentinel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_PACK_CASES)
def test_cuda_kernel_matches_plain(case):
    """On the card the kernel's [packed_rows, NF] table equals the plain
    composition's bit for bit, every row and column: pinhole at C = 2
    (``pinhole``) and C = 1 (``edge-partial``), spherical, a spherical
    slab's layout (``st_lo`` / ``n_st_local``), an overflowing layout and
    one of sentinel slots alone."""
    _gpu()
    fields, isect, caps = _layout(case, "cuda")
    before = cuda_build.launch_counts["stream_pack"]
    got = tsi.pack_stream_fields(*fields, isect, caps)
    want = _plain(fields, isect, caps)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["stream_pack"] == before + 1
    assert got.shape == want.shape == (caps.packed_rows, tsi.NF)
    ne = got.view(torch.int32) != want.view(torch.int32)
    assert not bool(ne.any()), f"unequal elements by column: {ne.sum(0).tolist()}"
    kept = int(isect.n_slots)
    assert bool((got[kept:] == 0).all())
    if case != "all-sentinel":
        assert kept > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pinhole", "spherical"])
def test_composite_stream_unchanged_on_cuda(case, monkeypatch):
    """``composite_stream`` on CUDA with the kernel's table gives the
    plain pack's output and gradients bit for bit (the backward reads the
    saved table)."""
    _gpu()
    proj, model, w, h = _proj(case, "cuda")
    C, N = proj.depths.shape
    _, _, sw, sh = tsi.supertile_grid(w, h, 16)
    caps = tsi.StreamCaps.choose(N, C, C * sw * sh)
    isect = tsi.build_stream_intersections(proj, w, h, 16, caps, camera_model=model)
    cfg = tsr.StreamCfg.from_caps(caps, w, h, 16, C, N, wrap_x=model == "spherical")
    gout = torch.rand((cfg.cs, cfg.nt, tsr.OUT_CH, cfg.npix), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))

    def run():
        leaves = [proj.means2d, proj.conics, proj.colors, proj.opacities, proj.depths]
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        out = tsr.composite_stream(cfg, *leaves, proj.radii, isect)
        grads = torch.autograd.grad(out, leaves, gout)
        return out.detach(), grads

    before = cuda_build.launch_counts["stream_pack"]
    out_k, grads_k = run()
    assert cuda_build.launch_counts["stream_pack"] == before + 1
    monkeypatch.setattr(tsi, "pack_stream_fields",
                        lambda *a: _plain(a[:6], a[6], a[7]))
    out_p, grads_p = run()
    assert cuda_build.launch_counts["stream_pack"] == before + 1
    assert torch.equal(out_k, out_p)
    for a, b in zip(grads_k, grads_p):
        assert torch.equal(a, b)
    assert float(out_k[:, :, 3].max()) > 0.5  # the views composite something
