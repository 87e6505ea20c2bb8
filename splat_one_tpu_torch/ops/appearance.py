"""The viewer's appearance head in one kernel (``csrc/appearance_fwd.cu``).

``appearance_fwd`` launches the kernel: gsplat's colour ``sigmoid(colors
+ head([e, features, Y(d)]))`` of every row seen from one camera, where
``e`` is the camera's image embedding and ``Y(d)`` the SH basis of the
unit direction from the camera centre to the row's mean: what
``train.appearance.appearance_rgb`` computes on ``means[None] -
centres[:, None]``, with no [N, width] activation in device memory. It
serves heads of hidden width ``HIDDEN`` with two or three linear layers
(the port's ``init_appearance_params`` at its default; gsplat's
``mlp_depth=2``), features of a width divisible by 4 and inputs ``E + F +
(d + 1)**2`` of at most ``MAX_IN`` for SH degree d from 0 to 4, one camera
a call, and no autograd (the kernel has no backward); its checks raise
``ValueError`` on any other head, input or device before the library is
loaded. ``train.appearance.appearance_rgb_from_centres`` launches it for
CUDA tensors.
"""

from __future__ import annotations

import torch

from splat_one_tpu_torch.core import sh as shlib
from splat_one_tpu_torch.ops.projection import _check_cuda, records_grad
from splat_one_tpu_torch.utils import cuda_build

HIDDEN = 64  # the hidden width the kernel serves
MAX_IN = 128  # the widest input E + F + (d + 1)**2
_ROWS = 256  # rows a tile of the kernel


def appearance_fwd(params, features, colors, image_ids, means, centres,
                   sh_degree: int = 3) -> torch.Tensor:
    """The kernel -> the colour [1, N, 3] f32 of every row seen from the
    camera centre ``centres`` [1, 3] (any strides) with the embedding
    ``params["embeds"][image_ids]`` (int64 [1], which must index it: the
    kernel reads that row unchecked). ``means`` [N, 3], ``features`` [N,
    F] (F divisible by 4, 16-byte aligned), ``colors`` [N, 3] (logits)
    and the head's parameters float32, contiguous, on one CUDA device,
    none that autograd records through. Raises ``ValueError`` on anything
    else before the library is loaded."""
    if not 0 <= sh_degree <= shlib.MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be in [0,{shlib.MAX_SH_DEGREE}], got {sh_degree}")
    layers = []
    while f"w{len(layers)}" in params:
        layers.append((params[f"w{len(layers)}"], params[f"b{len(layers)}"]))
    if len(layers) not in (2, 3):
        raise ValueError(f"the kernel serves heads of 2 or 3 linear layers, got {len(layers)}")
    if means.dim() != 2 or features.dim() != 2 or centres.dim() != 2:
        raise ValueError(f"means [N, 3], features [N, F] and centres [C, 3] expected, got "
                         f"{tuple(means.shape)}, {tuple(features.shape)}, "
                         f"{tuple(centres.shape)}")
    N, F = features.shape
    C = centres.shape[0]
    if C != 1:
        raise ValueError(f"the kernel serves one camera a call, got {C} centres")
    if F % 4 or features.data_ptr() % 16:
        raise ValueError(f"features must be 16-byte aligned with F divisible by 4 (the "
                         f"kernel reads 16-byte words), got F = {F} at address "
                         f"{features.data_ptr() % 16} mod 16")
    embeds = params["embeds"]
    E = embeds.shape[-1]
    nb = shlib.num_sh_bases(sh_degree)
    n_in = E + F + nb
    if n_in > MAX_IN:
        raise ValueError(f"the head's input {E} + {F} + {nb} is wider than {MAX_IN}")
    named = [("means", means, (N, 3)), ("features", features, (N, F)),
             ("colors", colors, (N, 3)), ("centres", centres, (C, 3)),
             ("embeds", embeds, (embeds.shape[0], E))]
    widths = [n_in] + [HIDDEN] * (len(layers) - 1) + [3]
    for i, (w, b) in enumerate(layers):
        named += [(f"w{i}", w, (widths[i], widths[i + 1])), (f"b{i}", b, (widths[i + 1],))]
    for name, t, shape in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} (hidden width {HIDDEN}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if name != "centres" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if image_ids.dtype != torch.int64 or tuple(image_ids.shape) != (C,):
        raise ValueError(f"image_ids must be int64 ({C},), got {image_ids.dtype} "
                         f"{tuple(image_ids.shape)}")
    if records_grad(*(t for _, t, _ in named)):
        raise ValueError("autograd records through the inputs: the kernel has no backward "
                         "(train.appearance.appearance_rgb carries the gradients)")
    named.append(("image_ids", image_ids, None))
    dev = means.device
    _check_cuda(named, dev)
    if N >= 2**31 - _ROWS:
        raise ValueError(f"{N} rows: the kernel indexes its tiles with 32-bit ints")
    out = torch.empty((1, N, 3), dtype=torch.float32, device=dev)
    deep = len(layers) == 3
    (w0, b0), (wl, bl) = layers[0], layers[-1]
    w1, b1 = layers[1] if deep else (None, None)
    lib = cuda_build.library("appearance_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.appearance_fwd(
            means.data_ptr(), features.data_ptr(), colors.data_ptr(), centres.data_ptr(),
            centres.stride(1), embeds.data_ptr(), image_ids.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), None if w1 is None else w1.data_ptr(),
            None if b1 is None else b1.data_ptr(), wl.data_ptr(), bl.data_ptr(),
            out.data_ptr(), N, E, F, nb, stream)
    cuda_build.check(lib, rc, "appearance_fwd")
    cuda_build.launch_counts["appearance_fwd"] += 1
    return out
