#!/usr/bin/env python3
"""The f32 error that the bf16 tensor-core #7 may add to its plain version,
emulated on the CPU at the facades head (dx 128×128×128, F4 = 12).

    python3 scripts/torch_subpixel_dx_error.py [rows]

#7 cuts each f32 dz value into three bf16 pieces (hi and mid cut toward
zero, lo the rest) whose products with the bf16 weight are exact in f32,
and sums them with ``mma.sync.m16n8k16``: per k16 step the lo, mid and hi
products, in that order, into f32 accumulators. The tensor cores'
accumulation is not IEEE round-to-nearest, so this script bounds it two
ways against the exact (f64) sum of the same 48 terms, for dz drawn as
chip_smoke.py's ``make_input`` draws it for sample 0 (spread 1.5) and for
sample 3 (spread 3.0) and w = 0.05·N(0, 1) rounded to bf16:
- the emulated error: each MMA adds its 16 exact products to the
  accumulator exactly and cuts the result toward zero to f32;
- a bound: each MMA adds 17 terms (16 products and the accumulator), each
  cut by up to one f32 ulp of the largest of them.
Also the error of a plain f32 sum (numpy's matmul) for scale. Prints one
line per spread; runs in seconds on one CPU core for the default 16 rows.
"""

from __future__ import annotations

import sys

import numpy as np

H = W = 128
C = 128
F4 = 12


def pieces(v: np.ndarray):
    """(lo, mid, hi) of f32 ``v`` as #7's ``split3`` cuts it."""
    def cut(a):
        return (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)

    hi = cut(v)
    with np.errstate(invalid="ignore"):   # inf - inf: a NaN remainder
        r = (v - hi).astype(np.float32)
        mid = cut(r)
        return (r - mid).astype(np.float32), mid, hi


def toward_zero(x: np.ndarray) -> np.ndarray:
    """f64 ``x`` cut toward zero to f32."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def bf16(a: np.ndarray) -> np.ndarray:
    """f32 ``a`` rounded to nearest even bf16 (kept as f32)."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def errors(dz: np.ndarray, w: np.ndarray, rows) -> dict:
    """Max over the given dx rows of the plain f32, emulated and bounded
    errors against the f64 sum, and of the sum of |terms|."""
    out = dict(sum_abs=0.0, f32=0.0, emulated=0.0, bound=0.0)
    b = np.concatenate([w[tap >> 1, tap & 1].T for tap in range(4)], 0)
    for r in rows:
        a = np.zeros((W, 4 * F4), np.float32)
        for tap in range(4):
            dh, dw = tap >> 1, tap & 1
            a[:, tap * F4:(tap + 1) * F4] = dz[r + 1 - dh,
                                               np.arange(W) + 1 - dw]
        exact = a.astype(np.float64) @ b.astype(np.float64)
        absum = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
        out["sum_abs"] = max(out["sum_abs"], float(absum.max()))
        out["f32"] = max(out["f32"], float(np.abs(a @ b - exact).max()))
        acc = np.zeros((W, C), np.float32)
        bound = np.zeros((W, C))
        for ks in range(4 * F4 // 16):
            k = slice(16 * ks, 16 * ks + 16)
            for p in pieces(a):
                terms = p[:, k].astype(np.float64)[:, :, None] * b[k][None]
                top = np.maximum(np.abs(acc), np.abs(terms).max(1))
                bound += 17 * np.spacing(top.astype(np.float32))
                acc = toward_zero(acc.astype(np.float64) + terms.sum(1))
        out["emulated"] = max(out["emulated"],
                              float(np.abs(acc - exact).max()))
        out["bound"] = max(out["bound"], float(bound.max()))
    return out


def draw(spread: float, shift: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    dz = (rng.standard_normal((H + 1, W + 1, F4)) * spread
          + shift).astype(np.float32)
    w = bf16((rng.standard_normal((2, 2, C, F4)) * 0.05).astype(np.float32))
    return dz, w


def main(argv) -> int:
    n_rows = int(argv[1]) if len(argv) > 1 else 16
    rows = range(0, H, max(1, H // n_rows))
    for sample in (0, 3):
        dz, w = draw(1.5 + 0.5 * sample, 0.25 - 0.5 * sample)
        e = errors(dz, w, rows)
        print(f"dz spread {1.5 + 0.5 * sample} ({len(rows)} rows): max "
              f"sum|terms| {e['sum_abs']:.4g}; f32 sum error "
              f"{e['f32']:.3g}; emulated tensor-core error "
              f"{e['emulated']:.3g}; bound {e['bound']:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
