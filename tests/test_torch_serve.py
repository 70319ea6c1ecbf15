"""The port's serving path on the CPU: config, ingest, PNG writer, weights
files, engine and CLI, held against the JAX package where it has a
counterpart. Weights come from the JAX init, inputs from numpy seeds.

Tolerance for the served prediction: f32, atol = rtol = 2e-4 (the bound of
tests/test_torch_parity.py).
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.registry import define_G as jax_define_G  # noqa: E402
from p2p_tpu.train.step import (  # noqa: E402
    make_infer_forward as jax_make_infer_forward)
from p2p_tpu_torch.convert import (  # noqa: E402
    flatten_tree, state_from_flax, load_generator, load_npz,
    save_npz)
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.serve.engine import InferenceEngine  # noqa: E402
from p2p_tpu_torch.utils.images import (  # noqa: E402
    encode_png, ingest, to_uint8_img)

ATOL = RTOL = 2e-4
H, W = 64, 128


def _cfgs():
    jcfg = jax_preset("pix2pixhd")
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, ngf=8, n_blocks=1),
        data=dataclasses.replace(jcfg.data, image_size=H, image_width=W))
    tcfg = get_preset("pix2pixhd")
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, ngf=8, n_blocks=1),
        data=dataclasses.replace(tcfg.data, image_size=H, image_width=W))
    return jcfg, tcfg


def _requests(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, H, W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def served():
    """JAX params of the small pix2pixhd generator and the port's copy."""
    jcfg, tcfg = _cfgs()
    g = jax_define_G(jcfg.model)
    params = jax.jit(lambda k: g.init(k, jnp.zeros((1, H, W, 3)), False))(
        jax.random.key(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tg = define_G(tcfg.model)
    tg.load_state_dict(state_from_flax(params), strict=True)
    return jcfg, tcfg, params, tg


def test_preset_matches_jax_preset():
    j, t = jax_preset("pix2pixhd"), get_preset("pix2pixhd")
    for section in ("model", "data"):
        port = getattr(t, section)
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(
                getattr(j, section), f.name), (section, f.name)
    assert t.image_hw == j.image_hw == (512, 1024)


def test_ingest_is_bitwise_the_jax_expression():
    from p2p_tpu.utils.images import ingest as jax_ingest

    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = ingest(torch.from_numpy(u8)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jax_ingest(u8)))
    assert ingest(torch.from_numpy(u8), torch.bfloat16).dtype \
        == torch.bfloat16


def test_to_uint8_img_matches_jax():
    from p2p_tpu.utils.images import to_uint8_img as jax_to_uint8

    x = np.random.default_rng(0).uniform(-1.2, 1.2, (1, 9, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(to_uint8_img(x), jax_to_uint8(x))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_decodes_through_pil(channels):
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(channels).integers(
        0, 256, (13, 21, channels), dtype=np.uint8)
    decoded = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(decoded.reshape(img.shape), img)


def test_npz_weights_round_trip(served, tmp_path):
    _, tcfg, params, tg = served
    path = str(tmp_path / "g.npz")
    save_npz(path, params)
    back = load_npz(path)
    a, b = flatten_tree(params), flatten_tree(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    fresh = load_generator(define_G(tcfg.model), path)
    for (k, v), (k2, v2) in zip(fresh.state_dict().items(),
                                tg.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(v, v2, atol=0, rtol=0)


def test_engine_matches_jax_infer_forward(served):
    jcfg, tcfg, params, tg = served
    reqs = _requests(2, 1)

    class _State:
        params_g = params
        batch_stats_g = {}

    fwd = jax_make_infer_forward(jcfg, None, with_metrics=False)
    want = np.asarray(jax.jit(lambda b: fwd(_State, b)[0])(
        {"input": jnp.asarray(reqs)}))

    engine = InferenceEngine(tcfg, tg, buckets=(2,), dtype="f32",
                             device="cpu")
    pred, metrics, n_real = engine.infer_batch({"input": reqs})
    assert n_real == 2 and metrics == {}
    assert pred.shape == (2, H, W, 3)
    np.testing.assert_allclose(pred.numpy(), want, atol=ATOL, rtol=RTOL)


def test_bucket_padding_is_inert(served):
    _, tcfg, _, tg = served
    reqs = _requests(3, 2)
    engine = InferenceEngine(tcfg, tg, buckets=(1, 4), dtype="f32",
                             device="cpu")
    pred, _, n_real = engine.infer_batch({"input": reqs})
    assert n_real == 3 and pred.shape[0] == 4
    for i in range(3):
        alone, _, _ = engine.infer_batch({"input": reqs[i:i + 1]})
        np.testing.assert_allclose(pred[i].numpy(), alone[0].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_engine_run_writes_every_image(served, tmp_path):
    _, tcfg, _, tg = served
    reqs = _requests(5, 3)
    engine = InferenceEngine(tcfg, tg, buckets=(1, 2), dtype="bf16",
                             device="cpu")
    names = [f"r{i}.png" for i in range(5)]
    stats, _ = engine.run([{"input": reqs[:3]}, {"input": reqs[3:]}],
                          names=names, out_dir=str(tmp_path))
    assert stats.n_images == 5 and stats.n_batches == 3
    assert stats.n_warmups == 2
    assert sorted(os.listdir(tmp_path)) == names


def test_engine_without_cuda_raises_unless_cpu_is_asked(served,
                                                        monkeypatch):
    _, tcfg, _, tg = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tcfg, tg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tcfg, tg, device="cuda")
    assert InferenceEngine(tcfg, tg, device="cpu").device.type == "cpu"


def test_cli_serve_once_on_cpu_writes_one_png_per_input(served, tmp_path,
                                                        capsys):
    Image = pytest.importorskip("PIL.Image")
    from p2p_tpu_torch.cli.serve import main

    _, _, params, _ = served
    weights = str(tmp_path / "g.npz")
    save_npz(weights, params)
    in_dir = tmp_path / "reqs"
    in_dir.mkdir()
    for i, img in enumerate(_requests(3, 4)):
        Image.fromarray(img).save(in_dir / f"img{i}.png")
    (in_dir / "notes.txt").write_text("not an image")
    out_dir = tmp_path / "out"
    rc = main(["--input_dir", str(in_dir), "--out", str(out_dir), "--once",
               "--weights", weights, "--preset", "pix2pixhd",
               "--device", "cpu", "--ngf", "8",
               "--n_blocks", "1", "--image_size", str(H), "--image_width",
               str(W), "--max_batch", "2", "--dtype", "f32"])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == ["img0.png", "img1.png",
                                           "img2.png"]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["served"] == 3 and summary["device"] == "cpu"
    out = np.asarray(Image.open(out_dir / "img0.png"))
    assert out.shape == (H, W, 3) and out.dtype == np.uint8
