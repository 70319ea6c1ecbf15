"""The delayed-int8 PatchGAN of ``facades_int8`` in the port
(``models/patchgan.py`` with ``ops/int8.py``) on the CPU.

- The fused D (``int8_fused_epilogue``: inner convs 2 and 3 take their
  input from the quantize-fused epilogue, #1 + #4) equals the unfused D
  (epilogue, then the conv quantizes): logits and every stored amax
  bitwise, in f32, for both instance kinds (the port pin of
  tests/test_int8.py:674); their parameter gradients agree within the
  JAX test's bands (rtol 2e-4, atol 1e-4 on the logits' loss; the
  feature-matching gradients, through the surrogate taps, within 10% in
  norm).
- The port's fused D against the JAX fused D on converted parameters and
  ``quant`` collection, the JAX Pallas kernels in interpret mode. The two
  packages sum the f32 norm statistics in another order, which moves the
  epilogue's values in their last bits and can flip q by one step at a
  rounding tie. Measured at ndf 8, 64²: logits within 3.3e-7 of the
  largest entry, the taps within 2.5e-6 (0.46% of one tap's q moved by
  one step), amax within 1.6e-7 relative; the bands are 1e-5 of each
  tensor's largest entry and 1e-6 relative.
- Eval mode leaves ``amax_x`` alone; the forms an earlier port refused
  (``int8_stem``, ``int8_head``, int8 under spectral norm) build and run.
"""

import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.models.patchgan import NLayerDiscriminator as JaxD  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402
from p2p_tpu_torch.models.patchgan import (  # noqa: E402
    MultiscaleDiscriminator, NLayerDiscriminator)
from p2p_tpu_torch.ops.int8 import QuantConv, QuantKN2RowConv  # noqa: E402
from p2p_tpu_torch.ops.spectral_norm import SpectralConv  # noqa: E402
from p2p_tpu_torch.train.state import init_amax  # noqa: E402

KW = dict(ndf=8, n_layers=3, use_spectral_norm=False, int8=True,
          int8_delayed=True)
TAP_RTOL_OF_MAX = 1e-5
AMAX_RTOL = 1e-6


def _x(seed=0, size=64):
    return np.random.default_rng(seed).normal(
        size=(1, size, size, 6)).astype(np.float32)


def _t4(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _amax(net):
    return {k: v.clone() for k, v in net.named_buffers()
            if k.endswith("amax_x")}


def _pair(norm, seed=0):
    """(unfused, fused) port Ds with the same weights and initialized amax."""
    nets = []
    gen_state = None
    for fused in (False, True):
        d = NLayerDiscriminator(6, **KW, norm=norm,
                                int8_fused_epilogue=fused)
        if gen_state is None:
            torch.manual_seed(seed)
            for p in d.parameters():
                torch.nn.init.normal_(p, 0.0, 0.05)
            gen_state = d.state_dict()
        d.load_state_dict(gen_state)
        d.to(memory_format=torch.channels_last).train()
        init_amax(d, _t4(_x(1)))
        nets.append(d)
    return nets


@pytest.mark.parametrize("norm", ["instance", "pallas_instance"])
def test_fused_equals_unfused_bitwise(norm):
    du, df = _pair(norm)
    for a, b in zip(_amax(du).values(), _amax(df).values()):
        assert torch.equal(a, b)
    x = _t4(_x())
    ou, of = du(x), df(x)
    assert torch.equal(ou[-1], of[-1])
    for (k, a), b in zip(_amax(du).items(), _amax(df).values()):
        assert torch.equal(a, b), k

    # the logits' loss: gradients within the JAX test's bands
    du.zero_grad(), df.zero_grad()
    du(x)[-1].float().square().sum().backward()
    df(x)[-1].float().square().sum().backward()
    for (k, pu), pf in zip(du.named_parameters(), df.parameters()):
        np.testing.assert_allclose(pf.grad.numpy(), pu.grad.numpy(),
                                   rtol=2e-4, atol=1e-4, err_msg=k)
    # the taps' loss: the surrogate taps pass their cotangent unscaled
    du.zero_grad(), df.zero_grad()
    sum(t.float().square().sum() for t in du(x)).backward()
    sum(t.float().square().sum() for t in df(x)).backward()
    for (k, pu), pf in zip(du.named_parameters(), df.parameters()):
        nu, nf = float(pu.grad.norm()), float(pf.grad.norm())
        if nu > 1e-2:   # the norm-cancelled biases' gradients are noise
            assert 0.9 < nf / nu < 1.1, (k, nf, nu)


def test_fused_d_runs_the_quantize_epilogue_twice_per_forward():
    from p2p_tpu_torch.ops import instance_norm as tin

    _, df = _pair("pallas_instance")
    with mock.patch.object(tin, "norm_act_quant",
                           wraps=tin.norm_act_quant) as q4, \
            mock.patch.object(tin, "norm_act", wraps=tin.norm_act) as n3, \
            mock.patch.object(tin, "instance_norm_stats",
                              wraps=tin.instance_norm_stats) as s1:
        df(_t4(_x()))
    assert (q4.call_count, n3.call_count, s1.call_count) == (2, 1, 3)


def test_port_d_matches_the_jax_d_on_converted_state():
    x = _x()
    jd = JaxD(**KW, norm="pallas_instance", int8_fused_epilogue=True)
    with mock.patch.dict(os.environ, {"P2P_TPU_FORCE_PALLAS": "1"}):
        v = jax.jit(lambda k: jd.init(k, jnp.asarray(x)))(jax.random.key(0))
        want, upd = jax.jit(lambda a: jd.apply(v, a, mutable=["quant"]))(
            jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    td = NLayerDiscriminator(6, **KW, norm="pallas_instance",
                             int8_fused_epilogue=True)
    td.load_state_dict(state_from_flax(v["params"], v["quant"], module=td),
                       strict=True)
    td.to(memory_format=torch.channels_last).train()
    got = td(_t4(x))
    assert len(got) == len(want) == 5
    for i, (t, j) in enumerate(zip(got, want)):
        j = np.asarray(j)
        diff = np.abs(t.detach().permute(0, 2, 3, 1).numpy() - j).max()
        assert diff <= TAP_RTOL_OF_MAX * np.abs(j).max(), (i, diff)
    want_amax = state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       upd["quant"]))
    got_amax = _amax(td)
    assert set(got_amax) == set(want_amax) == {
        f"_PlainConv_{i}.conv.amax_x" for i in (1, 2, 3)}
    for k, w in want_amax.items():
        assert float(got_amax[k]) == pytest.approx(float(w), rel=AMAX_RTOL)


def test_eval_mode_leaves_the_stored_scales_alone():
    _, df = _pair("pallas_instance")
    before = _amax(df)
    with torch.no_grad():
        df.eval()(_t4(3.0 * _x(2)))
    for k, v in _amax(df).items():
        assert torch.equal(v, before[k]), k
    df.train()(_t4(3.0 * _x(2)))
    assert any(not torch.equal(v, before[k]) for k, v in _amax(df).items())


def test_int8_modules_and_state_keys():
    d = MultiscaleDiscriminator(6, **KW, num_D=1, norm="pallas_instance",
                                int8_fused_epilogue=True)
    inner = [d.scale0._PlainConv_1, d.scale0._PlainConv_2,
             d.scale0._PlainConv_3]
    assert all(isinstance(m.conv, QuantConv) and m.conv.delayed
               for m in inner)
    assert [m.conv.epilogue is not None for m in inner] == [False, True,
                                                            True]
    assert not isinstance(d.scale0._PlainConv_0.conv, QuantConv)
    assert not isinstance(d.scale0._PlainConv_4.conv, QuantConv)
    keys = set(d.state_dict())
    assert {f"scale0._PlainConv_{i}.conv.amax_x" for i in (1, 2, 3)} <= keys
    dyn = NLayerDiscriminator(6, **dict(KW, int8_delayed=False),
                              norm="none")
    assert not any(k.endswith("amax_x") for k in dyn.state_dict())
    assert dyn(_t4(_x(size=32)))[-1].shape == (1, 1, 7, 7)


@pytest.mark.parametrize("kw,match", [
    (dict(int8_stem=True), "int8_stem"),
    (dict(int8_head=True), "int8_head"),
    (dict(use_spectral_norm=True), "spectral norm"),
])
def test_the_later_int8_slice_is_refused_by_name(kw, match):
    """The forms an earlier port refused by name (``match``) now build
    their quantized modules, each with a stored scale set by
    ``init_amax``, and a forward and backward run."""
    d = NLayerDiscriminator(6, **dict(KW, **kw), norm="pallas_instance")
    torch.manual_seed(0)
    for p in d.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    d.to(memory_format=torch.channels_last).train()
    name, kind = {"int8_stem": ("_PlainConv_0.conv", QuantConv),
                  "int8_head": ("_PlainConv_4.conv", QuantKN2RowConv),
                  "spectral norm": ("SpectralConv_1", SpectralConv)}[match]
    mod = d.get_submodule(name)
    assert isinstance(mod, kind) and hasattr(mod, "amax_x")
    x = _t4(_x(3, 32)).requires_grad_()
    init_amax(d, x.detach())
    amax = _amax(d)
    assert all(float(v) > 0 for v in amax.values())
    feats = d(x)
    sum(f.float().square().mean() for f in feats).backward()
    assert all(torch.isfinite(f).all() for f in feats)
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0


def test_fused_epilogue_needs_an_instance_norm():
    with pytest.raises(ValueError, match="instance-family"):
        NLayerDiscriminator(6, **KW, norm="none", int8_fused_epilogue=True)
