"""LightGlue's f32 rounding on the card and on the CPU, op by op.

Runs the first self block of the official forward (phase 9b of
chip_smoke.py: random weights in the published ALIKED configuration, 128
-> 256 wide, 4 heads) on the ALIKED n16 features of one textured-sphere
view, in float64 on the CPU; then feeds each op the float64 run's inputs
cast to f32, on the CPU and on the card, and prints each op's max abs
error against float64. Run from the repository root on a machine with one
CUDA card (on the CPU alone both columns are the CPU's):

    python3 lightglue_precision.py [resolution=1024] [keypoints=2048]
"""

import sys

import numpy as np
import torch

from chip_smoke import card_line, sphere_images, spiral_cameras
from splat_one_tpu_torch.models import aliked_tpu as AL
from splat_one_tpu_torch.models import lightglue_tpu as LG


def main(W=1024, K=2048):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    dev = torch.device("cuda") if torch.cuda.is_available() else cpu
    print(card_line() if dev.type == "cuda" else "no CUDA card: both columns are the CPU's",
          flush=True)
    c2ws, Ks = spiral_cameras(60, W, W)
    im = torch.as_tensor(sphere_images(dev, c2ws[:1], Ks[:1], W, W)[0].astype(np.float32) / 255.0)
    f = AL.extract_aliked_ckpt(AL.init_aliked_ckpt("aliked-n16", device=dev), im.to(dev), K)
    xy, desc = f.xys.cpu().double(), f.descriptors.cpu().double()
    sd = {k: v.double() for k, v in LG.init_lightglue_ckpt(device=cpu).items()}
    sds = {d: {k: v.float().to(d) for k, v in sd.items()} for d in (cpu, dev)}
    P, H = "transformers.0.self_attn", 4
    hd = sd["input_proj.weight"].shape[0] // H

    def op(name, fn, *xs):
        """fn(sd, *xs) in float64, then in f32 on both devices from the same
        inputs; returns the float64 result."""
        ref = fn(sd, *xs)
        errs = [float((fn(sds[d], *[x.float().to(d) for x in xs]).cpu().double() - ref).abs().max())
                for d in (cpu, dev)]
        print(f"{name:20s} max |x| {float(ref.abs().max()):9.4g}  cpu {errs[0]:.3e}  card "
              f"{errs[1]:.3e}  ratio {errs[1] / max(errs[0], 1e-30):.2f}", flush=True)
        return ref

    size = torch.tensor([W, W], dtype=torch.float64)
    k0 = ((xy - size / 2) / (W / 2))[None]
    x = op("input_proj", lambda s, d: LG._lg_lin(s, "input_proj", d), desc[None])
    proj = op("posenc", lambda s, k: k @ s["posenc.Wr.weight"].T, k0)
    c = torch.repeat_interleave(torch.cos(proj), 2, -1)[:, None]
    sn = torch.repeat_interleave(torch.sin(proj), 2, -1)[:, None]
    qkv = op("Wqkv", lambda s, a: LG._lg_lin(s, f"{P}.Wqkv", a), x)
    qkv = qkv.reshape(1, -1, H, hd, 3).permute(0, 2, 1, 3, 4)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    rot = lambda s, a, cc, ss: a * cc + LG._rotate_half(a) * ss
    q = op("rotary", rot, q, c, sn)
    k = rot(sd, k, c, sn)
    sc = op("q @ k^T / sqrt(hd)", lambda s, a, b: (a @ b.transpose(-1, -2)) / float(np.sqrt(hd)),
            q, k)
    att = op("softmax", lambda s, a: torch.softmax(a, -1), sc)
    ctx = op("att @ v", lambda s, a, b: a @ b, att, v)
    msg = op("out_proj", lambda s, a: LG._lg_lin(
        s, f"{P}.out_proj", a.permute(0, 2, 1, 3).reshape(1, -1, H * hd)), ctx)
    h = op("ffn.0", lambda s, a, b: LG._lg_lin(s, f"{P}.ffn.0", torch.cat([a, b], -1)), x, msg)
    h = op("layer norm", lambda s, a: LG._lg_ln(s, f"{P}.ffn.1", a), h)
    h = op("gelu", lambda s, a: LG._lg_gelu(a), h)
    op("ffn.3 + residual", lambda s, a, b: a + LG._lg_lin(s, f"{P}.ffn.3", b), x, h)
    return 0


if __name__ == "__main__":
    sys.exit(main(*[int(a) for a in sys.argv[1:3]]))
