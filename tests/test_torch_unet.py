"""The port's U-Net generator against the JAX ``UNetGenerator`` on the CPU.

ngf 32 at 64² with a batch of 2 (the depth clamps to 6 levels; 16·3 ≤
2·32, so ``thin_head`` really swaps the image head, as
tests/test_models.py's own pin does), f32, weights from the JAX init and
random running statistics, converted by ``convert.load_flax``. The three
head forms (ConvTranspose, ``thin_head``, ``thin_head + head_pallas``,
the last through the plain versions of kernels #6/#7 here and the JAX
kernel in interpret mode) are held within atol 1e-4 on the tanh output in
training (batch statistics; the running statistics after the forward
within 1e-5) and in eval (running statistics), and the parameter
gradients of the ``head_pallas`` form within 1e-4 of the largest.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.registry import define_G as jax_define_G  # noqa: E402
from p2p_tpu_torch.convert import load_flax, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.models import unet  # noqa: E402
from p2p_tpu_torch.models.registry import define_D, define_G  # noqa: E402
from p2p_tpu_torch.ops.conv import cast_conv  # noqa: E402

H = W = 64
HEADS = {"deconv": {}, "thin_head": {"thin_head": True},
         "head_pallas": {"thin_head": True, "head_pallas": True}}


def _cfgs(**model):
    kw = {"ngf": 32, "use_dropout": False, **model}
    j, t = jax_preset("facades"), get_preset("facades")
    return (j.replace(model=dataclasses.replace(j.model, **kw)),
            t.replace(model=dataclasses.replace(t.model, **kw)))


def _x(seed=0, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, H, W, 3)).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_stats(stats, rng):
    """Running statistics away from their init (mean 0, var 1), so a
    mis-mapped BatchNorm shows."""
    out = {}
    for k, v in stats.items():
        c = v["BatchNorm_0"]["mean"].shape
        out[k] = {"BatchNorm_0": {
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    return out


@pytest.fixture(scope="module", params=sorted(HEADS))
def pair(request):
    """(head form, JAX module, params, stats, port module) for one head."""
    jcfg, tcfg = _cfgs(**HEADS[request.param])
    g = jax_define_G(jcfg.model)
    v = _np(jax.jit(lambda k: g.init(k, jnp.zeros((1, H, W, 3)), True))(
        jax.random.key(0)))
    stats = _random_stats(v["batch_stats"], np.random.default_rng(1))
    tg = load_flax(define_G(tcfg.model, None, (H, W)), v["params"], stats)
    return request.param, g, v["params"], stats, tg.to(
        memory_format=torch.channels_last)


def test_head_form_is_the_one_asked_for(pair):
    head, _, params, _, tg = pair
    if head == "deconv":
        assert "kernel" in params["up0"]
        assert isinstance(tg.up0, torch.nn.ConvTranspose2d)
    else:
        assert params["up0"]["Conv_0"]["kernel"].shape == (2, 2, 64, 12)
        assert tg.up0.pallas == (head == "head_pallas")
    assert tg.num_downs == 6
    assert sum(k.startswith("BatchNorm_") for k, _ in tg.named_children()
               ) == 2 * 6 - 3


def test_train_forward_and_running_stats_match_jax(pair):
    _, g, params, stats, tg = pair
    x = _x(0)
    want, new = jax.jit(lambda p, s, x: g.apply(
        {"params": p, "batch_stats": s}, x, True, mutable=["batch_stats"]))(
        params, stats, x)
    tg.train()
    got = tg(_nchw(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    new = state_from_flax(_np(new["batch_stats"]))
    for k, v in tg.named_buffers():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_eval_forward_reads_running_stats_as_jax(pair):
    _, g, params, stats, tg = pair
    x = _x(1)
    want = jax.jit(lambda p, s, x: g.apply(
        {"params": p, "batch_stats": s}, x, False))(params, stats, x)
    load_flax(tg, params, stats).eval()
    with torch.no_grad():
        got = tg(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    tg.train()


def test_param_gradients_of_the_pallas_head_form_match_jax():
    jcfg, tcfg = _cfgs(thin_head=True, head_pallas=True)
    g = jax_define_G(jcfg.model)
    v = _np(jax.jit(lambda k: g.init(k, jnp.zeros((1, H, W, 3)), True))(
        jax.random.key(0)))
    x = _x(2)
    r = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def loss(p):
        y, _ = g.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                       True, mutable=["batch_stats"])
        return jnp.sum(y * r)

    tg = load_flax(define_G(tcfg.model, None, (H, W)), v["params"],
                   v["batch_stats"]).to(memory_format=torch.channels_last)
    want = state_from_flax(_np(jax.jit(jax.grad(loss))(v["params"])),
                           module=tg)
    (tg(_nchw(x)) * _nchw(r)).sum().backward()
    got = dict(tg.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        g_k = got[k].grad
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g_k.numpy() / scale, w.numpy() / scale,
                                   atol=1e-4, rtol=0, err_msg=k)


def test_conv_transpose_mapping_matches_flax():
    """flax ConvTranspose(k4, s2, "SAME") == ConvTranspose2d(k4, s2, pad 1)
    with the kernel flipped in both spatial axes (convert.py)."""
    x = np.random.default_rng(5).normal(size=(2, 5, 7, 6)).astype(np.float32)
    m = fnn.ConvTranspose(4, (4, 4), (2, 2), padding="SAME")
    p = _np(m.init(jax.random.key(0), jnp.asarray(x)))["params"]
    p["bias"] = np.linspace(-1, 1, 4).astype(np.float32)
    want = np.asarray(m.apply({"params": p}, x))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1)

    net = load_flax(Net(), {"up": p})
    np.testing.assert_allclose(
        net.up.weight.detach().numpy(),
        p["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
    got = cast_conv(net.up, _nchw(x))
    assert got.shape == (2, 4, 10, 14)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, atol=1e-5, rtol=1e-5)


def test_refused_options():
    _, tcfg = _cfgs(head_pallas=True)
    with pytest.raises(ValueError, match="head_pallas requires thin_head"):
        define_G(tcfg.model, None, (H, W))
    with pytest.raises(ValueError, match="upsample_mode 'bilinear'"):
        unet.UNetGenerator(ngf=8, image_hw=(H, W), upsample_mode="bilinear")
    with pytest.raises(ValueError, match="image_hw"):
        define_G(tcfg.model)
    tg = define_G(_cfgs()[1].model, None, (H, W))
    with pytest.raises(ValueError, match="6 levels"):
        tg(torch.zeros(1, 3, 128, 128))


def test_full_width_parameter_counts():
    """Counted from the JAX module's eval_shape at ngf 64, 256²: the U-Net
    with the subpixel head (and with the deconv head), and the 70×70
    PatchGAN on 6 input channels."""
    cfg = get_preset("facades")
    counts = {}
    with torch.device("meta"):
        for thin in (False, True):
            m = dataclasses.replace(cfg.model, thin_head=thin,
                                    head_pallas=thin)
            counts[thin] = sum(p.numel() for p in define_G(
                m, None, cfg.image_hw).parameters())
        n_d = sum(p.numel() for p in define_D(cfg.model).parameters())
    assert counts == {True: 54_414_540, False: 54_414_531}
    assert n_d == 2_767_809


def test_dropout_keeps_half_and_doubles_them():
    y = torch.ones((4, 16, 32, 32)).to(memory_format=torch.channels_last)
    out = unet.dropout(y, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) == {0.0, 2.0}
    assert abs(float((out == 2).float().mean()) - 0.5) < 0.01
    assert out.is_contiguous(memory_format=torch.channels_last)
    yb = y.to(torch.bfloat16)
    assert unet.dropout(yb, torch.Generator().manual_seed(0)).dtype \
        == torch.bfloat16


def test_dropout_levels_determinism_and_eval(monkeypatch):
    """Dropout runs on the three decoder levels after the innermost
    (i = 4, 3, 2 of 6, whose outputs are 8·ngf, 4·ngf and 2·ngf wide), only
    in training, with
    masks that the generator alone decides."""
    _, tcfg = _cfgs(use_dropout=True)
    torch.manual_seed(0)
    tg = define_G(tcfg.model, None, (H, W)).to(
        memory_format=torch.channels_last)
    x = _nchw(_x(4))
    seen = []
    real = unet.dropout

    def spy(y, generator):
        seen.append(y.shape[1])
        return real(y, generator)

    monkeypatch.setattr(unet, "dropout", spy)
    start = {k: v.clone() for k, v in tg.state_dict().items()}

    def train_forward(seed):
        tg.load_state_dict(start)   # the same running-mean shift each time
        return tg(x, generator=torch.Generator().manual_seed(seed))

    a = train_forward(7)
    assert seen == [256, 128, 64]
    b, c = train_forward(7), train_forward(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        tg(x)
    tg.eval()
    seen.clear()
    with torch.no_grad():
        e1 = tg(x)
        e2 = tg(x, generator=torch.Generator().manual_seed(9))
    assert seen == [] and torch.equal(e1, e2)
