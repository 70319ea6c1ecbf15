"""Offline paired-dataset generation CLI (counterpart of
``p2p_tpu/cli/generate_dataset.py``, the same flags):

    python -m p2p_tpu_torch.cli.generate_dataset \\
        --dataset_path <source PNGs> --target_dataset_folder <dataset root> \\
        [--split train|test] [--crop_size 256] [--max_patches 100]

writes ``<target>/<split>/{a,b}/`` (data/generate.py). Sources are read
with the port's PNG decoder, so they must be PNG files; outputs are PNGs.
"""

from __future__ import annotations

import argparse
import sys

from p2p_tpu_torch.data.generate import generate_dataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="p2p_tpu_torch dataset generation")
    p.add_argument("--target_dataset_folder", type=str, required=True,
                   help="output dataset root (<split>/{a,b} under it)")
    p.add_argument("--dataset_path", type=str, required=True,
                   help="source image folder (PNG files)")
    p.add_argument("--split", type=str, default="train",
                   help="train or test")
    p.add_argument("--bit_size", type=int, default=3,
                   help="quantizer bit depth for the b/ images")
    p.add_argument("--max_patches", type=int, default=100)
    p.add_argument("--pool_size", type=int, default=0,
                   help="worker processes (0 = inline)")
    p.add_argument("--crop_size", type=int, default=256,
                   help="tile size; -1 keeps whole images")
    p.add_argument("--crop_width", type=int, default=0,
                   help="rectangular tile width (0 = square crop_size)")
    p.add_argument("--img_format", type=str, default="png",
                   choices=["png"], help="outputs are PNG")
    p.add_argument("--min_std", type=float, default=0.0,
                   help="drop near-constant patches (uint8 std below this)")
    p.add_argument("--upsampling", type=int, default=0,
                   help="nearest-upsample every source by this factor (>0)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n = generate_dataset(
        src_dir=args.dataset_path, out_dir=args.target_dataset_folder,
        split=args.split,
        crop_size=args.crop_size if args.crop_size > 0 else None,
        max_patches=args.max_patches, bits=args.bit_size,
        upsample=args.upsampling, workers=args.pool_size,
        min_std=args.min_std,
        crop_width=args.crop_width if args.crop_width > 0 else None)
    print(f"wrote {n} paired patches to "
          f"{args.target_dataset_folder}/{args.split}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
