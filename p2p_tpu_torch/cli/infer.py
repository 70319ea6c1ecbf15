"""Inference CLI (counterpart of ``p2p_tpu/cli/infer.py``): batched
generator inference over the test split from a training checkpoint.

    python -m p2p_tpu_torch.cli.infer --preset reference \\
        --data_root <dataset root> --workdir <run dir> [--metrics] \\
        [--step N] [--device cuda|cpu]

G (and net_c, for a preset with a compression net) are restored from the
newest step under ``<workdir>/<checkpoint_dir>/<dataset>/<name>/`` whose
files verify (or exactly ``--step``), reading no discriminator or optimizer
file, and served through the engine (serve/engine.py) on f32 masters at
``--dtype``; with ``--ema_decay`` G's parameters are the step's EMA
generator. One PNG per test image, named after it, goes to ``--out``
(default ``<workdir>/<result_dir>/<dataset>``). ``--metrics`` prints
``psnr_mean=… psnr_max=… ssim_mean=… ssim_max=…`` over every test image;
``--stats`` the engine's timing as a JSON line. The card is the default
device; ``--compilation_cache DIR`` builds the kernel and host image
libraries into (and reuses them from) DIR; flags of features the port
lacks are refused by name (exit 2).

A video config (``n_frames > 1``, ``vid2vid_temporal``) takes the clip
route: G alone restored the same way, run in f32 in eval mode on every
frame of every test clip (train/video_loop.py ``build_video_eval_step``,
as the JAX clip route runs it), one PNG a frame as
``<out>/<video>_<frame>.png``; ``--metrics`` prints the same line over
every frame. The engine serves image presets only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from p2p_tpu_torch.cli import add_unported, apply_overrides, refuse_unported

UNPORTED = (
    ("mesh", None, {"type": str}), ("tp_min_ch", None, {"type": int}),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="p2p_tpu_torch inference")
    p.add_argument("--preset", type=str, default="reference")
    p.add_argument("--name", type=str, default=None,
                   help="training name (checkpoint subdir; default preset)")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--direction", type=str, default=None,
                   choices=["a2b", "b2a"])
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--cuda", action="store_true",
                   help="run on the card (the default)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (default: newest intact)")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--workdir", type=str, default=".")
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default <workdir>/result/<dataset>)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--ndf", type=int, default=None,
                   help="accepted and not needed: only G and net_c are "
                        "restored")
    p.add_argument("--n_blocks", type=int, default=None)
    p.add_argument("--upsample_mode", type=str, default=None,
                   choices=["deconv", "subpixel", "resize"])
    p.add_argument("--pool_size", type=int, default=None,
                   help="accepted and not needed: only G and net_c are "
                        "restored")
    p.add_argument("--metrics", action="store_true",
                   help="also print mean/max PSNR and SSIM vs the targets")
    p.add_argument("--buckets", type=str, default=None,
                   help="comma-separated batch buckets warmed at start "
                        "(default: the test batch size)")
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=["bf16", "f32"])
    p.add_argument("--io_threads", type=int, default=4,
                   help="PNG encode worker threads")
    p.add_argument("--stats", action="store_true",
                   help="print the engine's timing breakdown as JSON")
    p.add_argument("--compilation_cache", type=str, default=None,
                   help="directory the kernel and host image libraries "
                        "are built into and reused from (core/cache.py)")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="the checkpoint was trained with --ema_decay: "
                        "restore the EMA generator weights and infer with "
                        "the SMOOTHED G (bitwise == raw at decay 0)")
    add_unported(p, UNPORTED)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = refuse_unported(args, UNPORTED)
    if rc:
        return rc
    if args.cuda and args.device not in (None, "cuda"):
        print("--cuda contradicts --device", file=sys.stderr)
        return 2
    for flag in ("ndf", "pool_size"):
        if getattr(args, flag) is not None:
            print(f"note: --{flag} is not needed: only G and net_c are "
                  "restored", file=sys.stderr)
    if args.compilation_cache:
        # before the first build: the libraries land in (and are reused
        # from) this directory, as under cli.train and cli.serve
        from p2p_tpu_torch.core.cache import enable_compilation_cache

        enable_compilation_cache(args.compilation_cache)

    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.data.pipeline import PairedImageDataset, make_loader
    from p2p_tpu_torch.models.registry import define_C, define_G
    from p2p_tpu_torch.serve.engine import InferenceEngine
    from p2p_tpu_torch.train.checkpoint import (CheckpointCorrupt,
                                                CheckpointManager)

    cfg = get_preset(args.preset)
    cfg = cfg.replace(
        name=args.name or cfg.name,
        data=apply_overrides(cfg.data, dataset=args.dataset,
                             direction=args.direction,
                             test_batch_size=args.batch_size,
                             image_size=args.image_size),
        model=apply_overrides(cfg.model, ngf=args.ngf,
                              n_blocks=args.n_blocks,
                              upsample_mode=args.upsample_mode),
        health=apply_overrides(cfg.health, ema_decay=args.ema_decay))
    if cfg.data.n_frames > 1:
        return _video_main(args, cfg)
    root = args.data_root or os.path.join(cfg.data.root, cfg.data.dataset)
    try:
        ds = PairedImageDataset(
            root, "test", cfg.data.direction, cfg.data.image_size,
            cfg.data.image_width,
            dtype="uint8" if cfg.data.uint8_pipeline else "float32")
    except (RuntimeError, FileNotFoundError) as e:
        print(f"no test images under {root}: {e}", file=sys.stderr)
        return 1

    net_g = define_G(cfg.model, image_hw=cfg.image_hw)
    net_c = define_C(cfg.model) if cfg.model.use_compression_net else None
    ckpt = CheckpointManager(os.path.join(
        args.workdir, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name))
    try:
        step = ckpt.restore_nets(net_g, net_c, step=args.step,
                                 ema=args.ema_decay is not None)
    except (FileNotFoundError, CheckpointCorrupt) as e:
        print(str(e), file=sys.stderr)
        return 1
    bs = cfg.data.test_batch_size
    buckets = ([int(b) for b in args.buckets.split(",")] if args.buckets
               else [bs])
    engine = InferenceEngine(
        cfg, net_g, buckets=buckets, dtype=args.dtype, device=args.device,
        net_c=net_c, with_metrics=args.metrics, io_workers=args.io_threads)
    out_dir = args.out or os.path.join(args.workdir, cfg.train.result_dir,
                                       cfg.data.dataset)
    os.makedirs(out_dir, exist_ok=True)
    loader = make_loader(ds, bs, shuffle=False, num_epochs=1,
                         drop_remainder=False)
    stats, metrics = engine.run(
        loader, names=[os.path.splitext(n)[0] + ".png" for n in ds.names],
        out_dir=out_dir, collect_metrics=args.metrics)
    print(f"wrote {stats.n_images} predictions (checkpoint step {step}) "
          f"to {out_dir}")
    if args.metrics:
        psnrs, ssims = metrics["psnr"], metrics["ssim"]
        print(f"psnr_mean={np.mean(psnrs):.4f} psnr_max={np.max(psnrs):.4f} "
              f"ssim_mean={np.mean(ssims):.4f} ssim_max={np.max(ssims):.4f}")
    if args.stats:
        print(json.dumps({"kind": "serve_stats", **stats.as_dict()}))
    return 0


def _video_main(args, cfg) -> int:
    """The clip route (counterpart of ``p2p_tpu/cli/infer.py:204
    _video_main``): per-frame predictions as ``<out>/<video>_<frame>.png``
    from G restored alone."""
    import torch

    from p2p_tpu_torch.core.device import resolve_device
    from p2p_tpu_torch.data.pipeline import device_prefetch, make_loader
    from p2p_tpu_torch.data.video import VideoClipDataset
    from p2p_tpu_torch.models.registry import define_G
    from p2p_tpu_torch.train.checkpoint import (CheckpointCorrupt,
                                                CheckpointManager)
    from p2p_tpu_torch.train.video_loop import build_video_eval_step
    from p2p_tpu_torch.utils.images import save_img

    root = args.data_root or os.path.join(cfg.data.root, cfg.data.dataset)
    try:
        ds = VideoClipDataset(
            root, "test", cfg.data.direction, cfg.data.image_size,
            cfg.data.image_width, n_frames=cfg.data.n_frames,
            dtype="uint8" if cfg.data.uint8_pipeline else "float32")
    except (RuntimeError, FileNotFoundError) as e:
        print(f"no test clips under {root}: {e}", file=sys.stderr)
        return 1
    device = resolve_device(args.device)
    net_g = define_G(cfg.model, image_hw=cfg.image_hw)
    ckpt = CheckpointManager(os.path.join(
        args.workdir, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name))
    try:
        step = ckpt.restore_nets(net_g, None, step=args.step)
    except (FileNotFoundError, CheckpointCorrupt) as e:
        print(str(e), file=sys.stderr)
        return 1
    net_g.to(device, memory_format=torch.channels_last)
    eval_step = build_video_eval_step(cfg)
    out_dir = args.out or os.path.join(args.workdir, cfg.train.result_dir,
                                       cfg.data.dataset)
    os.makedirs(out_dir, exist_ok=True)
    n_clip = n_written = 0
    psnrs, ssims = [], []
    loader = make_loader(ds, cfg.data.test_batch_size, shuffle=False,
                         num_epochs=1, drop_remainder=False)
    for batch in device_prefetch(loader, device):
        pred, metrics = eval_step(net_g, batch)
        psnrs.append(metrics["psnr"])
        ssims.append(metrics["ssim"])
        for clip in pred.float().cpu().numpy():
            vid, frames = ds.windows[n_clip]
            for frame, fname in zip(clip, frames):
                stem = os.path.splitext(fname)[0]
                save_img(frame, os.path.join(out_dir, f"{vid}_{stem}.png"))
                n_written += 1
            n_clip += 1
    print(f"wrote {n_written} frames / {n_clip} clips (checkpoint step "
          f"{step}) to {out_dir}")
    if args.metrics:
        p = torch.cat(psnrs).cpu().numpy()
        s = torch.cat(ssims).cpu().numpy()
        print(f"psnr_mean={np.mean(p):.4f} psnr_max={np.max(p):.4f} "
              f"ssim_mean={np.mean(s):.4f} ssim_max={np.max(s):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
