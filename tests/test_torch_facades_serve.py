"""Serving the U-Net through the port, and the port's stdlib PNG reader.

The ``facades`` U-Net (ngf 32 at 64², ``thin_head`` + ``head_pallas``,
the JAX init's kernels scaled by 5 and random running statistics of the
matching scale, so the tanh output spans most of (−1, 1)) served by the
port's ``InferenceEngine`` on the CPU against the JAX
``make_infer_forward`` on the same weights: f32 within atol 2e-4 (the
bound of tests/test_torch_serve.py; measured 3.6e-7); bf16 within 2⁻⁷, two
bf16 roundings of an output in [0.5, 1) (measured one, 3.9e-3): both
packages round every activation to bf16, at a few different points inside
an op (the conv bias, the folded BatchNorm affine). The engine keeps the
U-Net's parameters and BatchNorm statistics in f32 and computes in bf16,
as the JAX serving forward does.

``decode_png`` is held against ``encode_png`` (exactly) and against
Pillow, where it is importable, for colour types 0, 2, 3, 4 and 6
(exactly); the resize against Pillow's ``BICUBIC`` within one uint8 step.
"""

import dataclasses
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.registry import define_G as jax_define_G  # noqa: E402
from p2p_tpu.train.step import (  # noqa: E402
    make_infer_forward as jax_make_infer_forward)
from p2p_tpu_torch.convert import load_flax, save_npz  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_facades_batch  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.serve.engine import InferenceEngine  # noqa: E402
from p2p_tpu_torch.utils.images import (  # noqa: E402
    decode_png, encode_png, resize_bicubic)

SIZE = 64
TOL = {"f32": 2e-4, "bf16": 2.0 ** -7}
SCALE = 5.0


def _cfgs():
    kw = dict(ngf=32, thin_head=True, head_pallas=True)
    j, t = jax_preset("facades"), get_preset("facades")
    data = dict(image_size=SIZE)
    return (j.replace(model=dataclasses.replace(j.model, **kw),
                      data=dataclasses.replace(j.data, **data)),
            t.replace(model=dataclasses.replace(t.model, **kw),
                      data=dataclasses.replace(t.data, **data)))


@pytest.fixture(scope="module")
def served():
    """JAX variables of the small facades U-Net, kernels ×SCALE, random
    running statistics of that scale."""
    jcfg, tcfg = _cfgs()
    g = jax_define_G(jcfg.model)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: g.init(k, jnp.zeros((1, SIZE, SIZE, 3)), True))(
        jax.random.key(0)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * SCALE if path[-1].key == "kernel" else a,
        v["params"])
    rng = np.random.default_rng(1)
    stats = {}
    for k, b in v["batch_stats"].items():
        c = b["BatchNorm_0"]["mean"].shape
        stats[k] = {"BatchNorm_0": {
            "mean": (rng.normal(0, 0.1, c) * SCALE).astype(np.float32),
            "var": (rng.uniform(0.5, 1.5, c) * SCALE ** 2).astype(
                np.float32)}}
    tg = load_flax(define_G(tcfg.model, None, (SIZE, SIZE)), params, stats)
    return jcfg, tcfg, params, stats, tg


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_engine_serves_the_unet_as_the_jax_serving_forward(served, dtype):
    jcfg, tcfg, params, stats, tg = served
    reqs = synthetic_facades_batch(2, SIZE, seed=5)["input"]

    class _State:
        params_g = params
        batch_stats_g = stats

    jdt = jnp.bfloat16 if dtype == "bf16" else None
    fwd = jax_make_infer_forward(jcfg, jdt, with_metrics=False)
    want = np.asarray(jax.jit(lambda b: fwd(_State, b)[0])(
        {"input": jnp.asarray(reqs)}).astype(jnp.float32))

    engine = InferenceEngine(tcfg, tg, buckets=(2,), dtype=dtype,
                             device="cpu")
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    assert all(b.dtype == torch.float32 for b in engine.model.buffers())
    assert not engine.model.training
    pred, _, n_real = engine.infer_batch({"input": reqs})
    assert n_real == 2 and pred.shape == (2, SIZE, SIZE, 3)
    assert pred.dtype == (torch.bfloat16 if dtype == "bf16"
                          else torch.float32)
    np.testing.assert_allclose(pred.float().numpy(), want, atol=TOL[dtype],
                               rtol=0)


def test_served_unet_runs_no_dropout(served):
    _, _, _, _, tg = served
    cfg = _cfgs()[1]
    assert cfg.model.use_dropout
    engine = InferenceEngine(cfg, tg, buckets=(1,), dtype="f32",
                             device="cpu")
    req = {"input": synthetic_facades_batch(1, SIZE, seed=6)["input"]}
    a, _, _ = engine.infer_batch(req)
    b, _, _ = engine.infer_batch(req)
    assert torch.equal(a, b)


def _png_variants(img):
    Image = pytest.importorskip("PIL.Image")
    base = Image.fromarray(img)
    yield 0, base.convert("L")
    yield 2, base
    yield 3, base.quantize(40)
    yield 4, base.convert("L").convert("LA")
    yield 6, base.convert("RGBA")


def _structured(h=37, w=53, seed=0):
    """An image on which a PNG encoder picks every row filter."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 5) % 256, (yy * 7) % 256, (xx * yy) % 256],
                   -1).astype(np.uint8)
    img[5:20, 10:30] = np.random.default_rng(seed).integers(
        0, 256, (15, 20, 3))
    return img


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_png_inverts_encode_png(channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (13, 21, channels), dtype=np.uint8)
    got = decode_png(encode_png(img))
    assert got.shape == (13, 21, 3) and got.dtype == np.uint8
    want = np.repeat(img, 3, axis=2) if channels == 1 else img[:, :, :3]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("optimize", [False, True])
def test_decode_png_matches_pillow_for_every_colour_type(optimize):
    Image = pytest.importorskip("PIL.Image")
    types = []
    for color, im in _png_variants(_structured()):
        buf = io.BytesIO()
        im.save(buf, "PNG", optimize=optimize)
        data = buf.getvalue()
        assert data[25] == color
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)
        types.append(color)
    assert types == [0, 2, 3, 4, 6]


def _ihdr_png(depth=8, color=2, interlace=0):
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", 2, 2, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(2 * 13)))
            + chunk(b"IEND", b""))


def test_decode_png_refuses_what_it_does_not_read():
    good = encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(_ihdr_png(depth=16))
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_ihdr_png(interlace=1))
    with pytest.raises(ValueError, match="truncated"):
        decode_png(good[:-20])
    bad = bytearray(good)
    bad[40] ^= 0xFF                       # inside the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + good[6:])


@pytest.mark.parametrize("src,dst", [((67, 91), (256, 256)),
                                     ((120, 170), (100, 300)),
                                     ((600, 700), (256, 256)),
                                     ((64, 64), (64, 32))])
def test_resize_matches_pillow_bicubic(src, dst):
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(sum(src)).integers(
        0, 256, src + (3,), dtype=np.uint8)
    h, w = dst
    want = np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC))
    got = resize_bicubic(img, h, w)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cli_serve_once_runs_without_pillow(served, tmp_path, capsys,
                                           monkeypatch):
    """``cli/serve.py --once`` on PNG requests with Pillow hidden from the
    import system (the preset's own deconv head; one of the requests needs
    a resize)."""
    from p2p_tpu_torch.cli.serve import main

    jcfg, _ = _cfgs()
    g = jax_define_G(dataclasses.replace(jcfg.model, thin_head=False,
                                         head_pallas=False))
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: g.init(k, jnp.zeros((1, SIZE, SIZE, 3)), True))(
        jax.random.key(1)))
    weights = str(tmp_path / "g.npz")
    save_npz(weights, v["params"], v["batch_stats"])
    in_dir = tmp_path / "reqs"
    in_dir.mkdir()
    reqs = synthetic_facades_batch(2, SIZE, seed=7)["input"]
    (in_dir / "a.png").write_bytes(encode_png(reqs[0]))
    (in_dir / "b.png").write_bytes(encode_png(
        np.repeat(np.repeat(reqs[1], 2, axis=0), 2, axis=1)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    out_dir = tmp_path / "out"
    rc = main(["--preset", "facades", "--input_dir", str(in_dir), "--out",
               str(out_dir), "--once", "--weights", weights, "--device",
               "cpu", "--ngf", "32", "--image_size", str(SIZE), "--max_batch", "2", "--dtype",
               "f32"])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == ["a.png", "b.png"]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["served"] == 2
    out = decode_png((out_dir / "a.png").read_bytes())
    assert out.shape == (SIZE, SIZE, 3)
