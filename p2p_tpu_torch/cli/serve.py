"""Serving CLI, directory mode (counterpart of ``p2p_tpu/cli/serve.py:283
main``): serve every image in ``--input_dir`` once and exit.

    python -m p2p_tpu_torch.cli.serve --input_dir reqs --once \\
        --weights g.npz [--preset pix2pixhd] [--device cuda|cpu]

``--weights`` is an ``.npz`` of the flax generator's variables, its
parameters and (the U-Net) BatchNorm statistics
(``p2p_tpu_torch.convert.save_npz``). Requests are PNG files, decoded by
the port's stdlib reader and resized bicubic to the preset's size
(``utils/images.py``; no Pillow); outputs are PNGs named after their inputs
under ``--out`` (default ``<input_dir>_out``). Watch mode, HTTP, tenancy
and quarantine come with later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from p2p_tpu_torch.cli import apply_overrides

IMG_EXTENSIONS = (".png",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="p2p_tpu_torch serving (directory mode)")
    p.add_argument("--preset", type=str, default="pix2pixhd")
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--out", type=str, default=None,
                   help="prediction dir (default <input_dir>_out)")
    p.add_argument("--once", action="store_true",
                   help="serve the directory's current contents and exit "
                        "(the only mode in this port so far)")
    p.add_argument("--weights", type=str, required=True,
                   help=".npz of the flax generator's variables")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--n_blocks", type=int, default=None)
    p.add_argument("--max_batch", type=int, default=4,
                   help="largest bucket; requests are grouped up to it")
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=["bf16", "f32"])
    return p


def default_buckets(max_batch: int):
    """1, 2, 4, ... below ``max_batch``, then ``max_batch`` itself."""
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


def build_config(args):
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset(args.preset)
    return cfg.replace(
        model=apply_overrides(cfg.model, ngf=args.ngf,
                              n_blocks=args.n_blocks),
        data=apply_overrides(cfg.data, image_size=args.image_size,
                             image_width=args.image_width))


def load_request(path: str, h: int, w: int) -> np.ndarray:
    """Decode one PNG request to uint8 (h, w, 3), bicubic-resized when its
    size differs (the JAX ``load_image`` semantics)."""
    from p2p_tpu_torch.utils.images import decode_png, resize_bicubic

    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[:2] != (h, w):
        img = resize_bicubic(img, h, w)
    return img


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.once:
        print("only --once is ported so far", file=sys.stderr)
        return 2

    from p2p_tpu_torch.convert import load_generator
    from p2p_tpu_torch.models.registry import define_G
    from p2p_tpu_torch.serve.engine import InferenceEngine

    cfg = build_config(args)
    h, w = cfg.image_hw
    generator = load_generator(define_G(cfg.model, image_hw=(h, w)),
                               args.weights)
    engine = InferenceEngine(cfg, generator,
                             buckets=default_buckets(args.max_batch),
                             dtype=args.dtype, device=args.device)
    t0 = time.perf_counter()
    engine.warmup()
    print(f"warmed {len(engine.buckets)} buckets {list(engine.buckets)} "
          f"on {engine.device} in {time.perf_counter() - t0:.2f}s",
          flush=True)

    names = sorted(f for f in os.listdir(args.input_dir)
                   if f.lower().endswith(IMG_EXTENSIONS))
    out_dir = args.out or args.input_dir.rstrip("/") + "_out"
    os.makedirs(out_dir, exist_ok=True)
    max_bs = engine.buckets[-1]

    def batches():
        for i in range(0, len(names), max_bs):
            group = names[i:i + max_bs]
            yield {"input": np.stack([
                load_request(os.path.join(args.input_dir, n), h, w)
                for n in group])}

    stats, _ = engine.run(
        batches(), names=[os.path.splitext(n)[0] + ".png" for n in names],
        out_dir=out_dir)
    print(json.dumps({"kind": "serve_summary", "served": stats.n_images,
                      "out_dir": out_dir, "device": str(engine.device),
                      **stats.as_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
