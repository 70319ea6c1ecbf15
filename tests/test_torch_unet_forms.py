"""The U-Net's remaining forms against the JAX ``UNetGenerator`` on the CPU:
``upsample_mode`` ``"subpixel"`` and ``"resize"``, ``thin_stem`` (the
JAX ``PatchesConv`` against the port's one ``nn.Conv2d`` stem), and
``norm`` ``"instance"`` and
``"pallas_instance"`` (the JAX Pallas kernels in interpret mode,
``P2P_TPU_FORCE_PALLAS=1``; the port's #1 + #2 on their plain versions).

ngf 8 at 32² with a batch of 2 (5 levels), f32, in training (batch
statistics, shifted by the running means of the flax init; a shift far
from a level's mean makes the one-pass variance of this tiny net's small
activations cancel, in both packages), weights from the JAX init
converted by ``convert.load_flax``. Tolerances: the tanh
output within 1e-5 abs; the parameter gradients of a random cotangent
within 1e-5 abs + 1e-4 of each tensor's largest |gradient| (f32 sums in
another order; the instance norms' backward divides by per-sample
spreads of a tiny 32² net, so 1e-4 of the largest, not of each element).
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.registry import define_G as jax_define_G  # noqa: E402
from p2p_tpu_torch.convert import load_flax, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.ops.conv import (SubpixelDeconv,  # noqa: E402
                                    UpsampleConvLayer)

H = W = 32
OUT_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL_OF_MAX = 1e-5, 1e-4
FORMS = {"subpixel": {"upsample_mode": "subpixel"},
         "resize": {"upsample_mode": "resize"},
         "thin_stem": {"thin_stem": True},
         "instance": {"norm": "instance"},
         "pallas_instance": {"norm": "pallas_instance"}}


def _cfgs(form):
    kw = {"ngf": 8, "use_dropout": False, **FORMS[form]}
    j, t = jax_preset("facades"), get_preset("facades")
    return (j.replace(model=dataclasses.replace(j.model, **kw)),
            t.replace(model=dataclasses.replace(t.model, **kw)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(FORMS))
def run(request):
    """One form: the JAX and port outputs and parameter gradients of one
    training forward on the same input and cotangent."""
    form = request.param
    jcfg, tcfg = _cfgs(form)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    ct = rng.normal(0, 1, (2, H, W, 3)).astype(np.float32)
    g = jax_define_G(jcfg.model)
    with mock.patch.dict(os.environ, {"P2P_TPU_FORCE_PALLAS": "1"}):
        v = _np(jax.jit(lambda k: g.init(k, jnp.zeros((1, H, W, 3)), True))(
            jax.random.key(0)))
        stats = v.get("batch_stats", {})

        def f(p):
            out, _ = g.apply({"params": p, "batch_stats": stats}, x, True,
                             mutable=["batch_stats"])
            return out

        want, vjp = jax.vjp(jax.jit(f), v["params"])
        (want_grads,) = vjp(jnp.asarray(ct))
    trees = [v["params"]] + ([stats] if stats else [])
    tg = load_flax(define_G(tcfg.model, None, (H, W)), *trees).to(
        memory_format=torch.channels_last).train()
    got = tg(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last))
    got.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    return dict(form=form, tg=tg, params=v["params"], want=np.asarray(want),
                got=got.detach().permute(0, 2, 3, 1).numpy(),
                want_grads=state_from_flax(_np(want_grads), module=tg),
                got_grads={k: p.grad for k, p in tg.named_parameters()})


def test_the_form_is_the_one_asked_for(run):
    tg, params, form = run["tg"], run["params"], run["form"]
    if form == "subpixel":
        assert all(isinstance(getattr(tg, f"up{i}"), SubpixelDeconv)
                   for i in range(tg.num_downs))
        assert params["up1"]["Conv_0"]["bias"].shape == (4 * 8,)
    elif form == "resize":
        assert all(isinstance(getattr(tg, f"up{i}"), UpsampleConvLayer)
                   for i in range(tg.num_downs))
        assert "bias" not in params["up1"]["Conv_0"]
    elif form == "thin_stem":
        assert params["down0"]["kernel"].shape == (4, 4, 3, 8)
    else:
        assert not any(n.startswith("BatchNorm_")
                       for n, _ in tg.named_children())


def test_training_forward_matches_jax(run):
    np.testing.assert_allclose(run["got"], run["want"], atol=OUT_ATOL,
                               rtol=0)


def test_parameter_gradients_match_jax(run):
    got, want = run["got_grads"], run["want_grads"]
    assert set(got) == set(want)
    for k, w in want.items():
        diff = float((got[k] - w).abs().max())
        limit = GRAD_ATOL + GRAD_RTOL_OF_MAX * float(w.abs().max())
        assert diff <= limit, (run["form"], k, diff, limit)


def test_pallas_instance_unet_runs_stats_and_apply_at_each_norm():
    """#1 + #2 once per U-Net norm (the encoder's nd − 2 and the decoder's
    nd − 1), none of #3: counted on the wrappers' CPU route."""
    from p2p_tpu_torch.ops import instance_norm as seam

    _, tcfg = _cfgs("pallas_instance")
    tg = define_G(tcfg.model, None, (H, W)).train()
    calls = {"stats": 0, "apply": 0}
    stats, apply = seam.instance_norm_stats, seam.instance_norm_apply

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    with mock.patch.object(seam, "instance_norm_stats",
                           count("stats", stats)), \
            mock.patch.object(seam, "instance_norm_apply",
                              count("apply", apply)):
        tg(torch.zeros(1, 3, H, W))
    nd = tg.num_downs
    assert calls == {"stats": 2 * nd - 3, "apply": 2 * nd - 3}
