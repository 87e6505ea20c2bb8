"""Command-line interface: counterpart of ``splat_one_tpu/app/cli.py``.

    python -m splat_one_tpu_torch.app.cli extract-metadata <workdir>
    python -m splat_one_tpu_torch.app.cli detect-features <workdir>
    python -m splat_one_tpu_torch.app.cli match-features <workdir>
    python -m splat_one_tpu_torch.app.cli create-tracks <workdir>
    python -m splat_one_tpu_torch.app.cli reconstruct <workdir>
    python -m splat_one_tpu_torch.app.cli run-all <workdir>
    python -m splat_one_tpu_torch.app.cli train <workdir> [--max-steps N] ...
    python -m splat_one_tpu_torch.app.cli train <workdir> --ckpt <npz> [--compression png]
    python -m splat_one_tpu_torch.app.cli viewer <workdir> [--port 8080]
    python -m splat_one_tpu_torch.app.cli create-masks <workdir> [--clicks J] [--checkpoint N]
    python -m splat_one_tpu_torch.app.cli estimate-depth <workdir> [--equirect] [--camera-aware]

Every subcommand of the JAX package parses with its arguments and
defaults; the ported ones also take ``--device`` (default ``cuda``). The
subcommands whose stages are not ported yet exit non-zero and name the
slice that ports them; so does the live reconstruction viewer's option.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SFM_COMMANDS = ("extract-metadata", "detect-features", "match-features",
                "create-tracks", "reconstruct", "run-all")
# subcommand -> the ROADMAP slice that ports its stage
NOT_PORTED = dict.fromkeys(("resize", "restore-images", "mask-ui", "visualize-features",
                            "visualize-matches"), "Slice H (the app shell)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splat-one-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    for name in SFM_COMMANDS:
        sp = sub.add_parser(name)
        sp.add_argument("workdir")
        sp.add_argument("--device", default="cuda")
        if name == "detect-features":
            sp.add_argument("--max-keypoints", type=int, default=2048)
            sp.add_argument("--feature-process-size", type=int, default=1024)
            sp.add_argument("--feature-type", default="SIFT",
                            choices=["SIFT", "ORB", "HAHOG", "ALIKED", "AKAZE", "SURF"])
            sp.add_argument("--aliked-checkpoint", default=None)
        if name == "match-features":
            sp.add_argument("--lowes-ratio", type=float, default=0.8)
            sp.add_argument("--order-neighbors", type=int, default=0)
            sp.add_argument("--gps-neighbors", type=int, default=0)
            sp.add_argument("--vlad-neighbors", type=int, default=0)
            sp.add_argument("--matching-type", default="bruteforce",
                            choices=["bruteforce", "flann", "lightglue"])
            sp.add_argument("--lightglue-checkpoint", default=None)
        if name in ("reconstruct", "run-all"):
            sp.add_argument("--live-viewer-port", type=int, default=0)
            sp.add_argument("--bundle-use-gps", action="store_true")
            sp.add_argument("--gps-sd-m", type=float, default=5.0)

    sp = sub.add_parser("create-masks")
    sp.add_argument("workdir")
    sp.add_argument("--clicks", default=None)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--device", default="cuda")

    sp = sub.add_parser("resize")
    sp.add_argument("workdir")
    sp.add_argument("--max-dim", type=int, required=True)
    sp = sub.add_parser("restore-images")
    sp.add_argument("workdir")

    sp = sub.add_parser("train")
    sp.add_argument("workdir")
    sp.add_argument("--max-steps", type=int, default=30_000)
    sp.add_argument("--sh-degree", type=int, default=3)
    sp.add_argument("--strategy", choices=["default", "mcmc"], default="default")
    sp.add_argument("--max-images", type=int, default=None)
    # sets Config.data_factor, which no stage reads (as in the JAX package)
    sp.add_argument("--data-factor", type=int, default=1)
    sp.add_argument("--ckpt", default=None,
                    help="eval-only: load checkpoint, run eval+traj")
    sp.add_argument("--compression", choices=["png"], default=None)
    sp.add_argument("--device", default="cuda")

    sp = sub.add_parser("viewer")
    sp.add_argument("workdir")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--ckpt", default=None)
    sp.add_argument("--device", default="cuda")

    sp = sub.add_parser("mask-ui")
    sp.add_argument("workdir")
    sp.add_argument("--port", type=int, default=8081)
    sp.add_argument("--checkpoint", default=None)

    sp = sub.add_parser("estimate-depth")
    sp.add_argument("workdir")
    sp.add_argument("--encoder", default="vits", choices=["vits", "vitb", "vitl", "vitg"])
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--equirect", action="store_true",
                    help="panorama multi-crop path (DAC analog)")
    sp.add_argument("--camera-aware", action="store_true",
                    help="route each image by its calibrated camera model "
                         "(fisheye -> ERP resample, spherical -> multi-crop)")
    sp.add_argument("--device", default="cuda")

    sp = sub.add_parser("visualize-features")
    sp.add_argument("workdir")
    sp = sub.add_parser("visualize-matches")
    sp.add_argument("workdir")
    sp.add_argument("image_a")
    sp.add_argument("image_b")
    return p


def _progress(label):
    def cb(i, n):
        print(f"\r{label}: {i}/{n}", end="", flush=True)
        if i == n:
            print()

    return cb


def _sfm(args):
    """The SfM subcommands (the JAX CLI's stage calls, on ``--device``)."""
    from splat_one_tpu_torch.app import pipeline

    wd, dev = args.workdir, args.device
    if args.cmd == "extract-metadata":
        n = pipeline.extract_metadata(wd, _progress("metadata"))
        print(f"extracted metadata for {n} images")
    elif args.cmd == "detect-features":
        n = pipeline.detect_features(
            wd, max_keypoints=args.max_keypoints,
            feature_process_size=args.feature_process_size,
            feature_type=args.feature_type, aliked_checkpoint=args.aliked_checkpoint,
            progress=_progress("features"), device=dev)
        print(f"detected features for {n} images")
    elif args.cmd == "match-features":
        n = pipeline.match_features(
            wd, lowes_ratio=args.lowes_ratio, order_neighbors=args.order_neighbors,
            gps_neighbors=args.gps_neighbors, vlad_neighbors=args.vlad_neighbors,
            matching_type=args.matching_type,
            lightglue_checkpoint=args.lightglue_checkpoint,
            progress=_progress("matching"), device=dev)
        print(f"matched {n} pairs")
    elif args.cmd == "create-tracks":
        n = pipeline.create_tracks(wd)
        print(f"built {n} tracks")
    else:  # reconstruct, run-all
        if args.live_viewer_port:
            raise NotImplementedError(pipeline.LIVE_VIEWER_LATER)
        if args.cmd == "run-all":
            pipeline.extract_metadata(wd, _progress("metadata"))
            pipeline.detect_features(wd, progress=_progress("features"), device=dev)
            pipeline.match_features(wd, progress=_progress("matching"), device=dev)
            pipeline.create_tracks(wd)
        report = pipeline.reconstruct(
            wd, live_viewer_port=args.live_viewer_port,
            bundle_use_gps=args.bundle_use_gps, gps_sd_m=args.gps_sd_m, device=dev)
        print(json.dumps(report, indent=2, default=str))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in NOT_PORTED:
        print(f"splat-one-tpu-torch: '{args.cmd}' is not ported yet: it comes with "
              f"{NOT_PORTED[args.cmd]}", file=sys.stderr)
        return 2
    t0 = time.time()
    if args.cmd in SFM_COMMANDS:
        try:
            _sfm(args)
        except NotImplementedError as e:  # an option of a later slice
            print(f"splat-one-tpu-torch: {e}", file=sys.stderr)
            return 2
    elif args.cmd == "create-masks":
        from splat_one_tpu_torch.app import pipeline

        n = pipeline.create_masks(args.workdir, clicks_path=args.clicks,
                                  checkpoint=args.checkpoint, progress=_progress("masks"),
                                  device=args.device)
        print(f"wrote {n} masks")
    elif args.cmd == "estimate-depth":
        from splat_one_tpu_torch.app import pipeline

        n = pipeline.estimate_depth(args.workdir, encoder=args.encoder,
                                    checkpoint=args.checkpoint, equirect=args.equirect,
                                    camera_aware=args.camera_aware,
                                    progress=_progress("depth"), device=args.device)
        print(f"wrote {n} depth maps to depth/")
    elif args.cmd == "train":
        from splat_one_tpu_torch.app import pipeline
        from splat_one_tpu_torch.train.config import Config
        from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg, MCMCStrategyCfg

        cfg = Config(
            max_steps=args.max_steps, sh_degree=args.sh_degree,
            data_factor=args.data_factor, ckpt=[args.ckpt] if args.ckpt else None,
            compression=args.compression,
            strategy=MCMCStrategyCfg() if args.strategy == "mcmc" else DefaultStrategyCfg())
        _, history = pipeline.train_splats(args.workdir, cfg, max_images=args.max_images,
                                           device=args.device)
        if isinstance(history, list) and history:
            print(f"final: {history[-1]}")
        elif isinstance(history, dict):
            print(f"eval: {history}")
    else:  # viewer
        from splat_one_tpu_torch.app import viewer

        viewer.serve_workdir(args.workdir, port=args.port, ckpt=args.ckpt,
                             device=args.device)
    print(f"[{args.cmd}] done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
