"""The port's ``facades_int8`` train step with the quantize-fused D epilogue
(``norm_d="pallas_instance"``, ``int8_fused_epilogue``: #1 + #4 before
inner convs 2 and 3 of the delayed-int8 PatchGAN) against the JAX step on
the CPU, and the pieces it adds: ``AdamLP`` (bf16-stored Adam moments),
the ``amax_x`` init of ``create_train_state``, the registry's int8 wiring
and the forms an earlier port refused by name (each now builds and
trains a step).

One JAX ``create_train_state`` of the preset shrunk to ngf 32, ndf 16 at
64², dropout off (the two packages' random streams differ), takes 3 f32
steps on synthetic facades batches, the JAX Pallas kernels in interpret
mode. The port takes each of those steps from the JAX state before it,
carried across whole (``convert.load_train_state``: parameters, running
statistics, the ``quant_d`` scales; Adam's count and moments by the test's
own ``_load_adam``), so every step is compared from equal states. A
chained run would not test the step: Adam's first update is sign-like
(±lr on every weight), so a gradient near zero whose sign differs between
the packages (an int8 operand one step apart where an f32 sum rounds to a
tie; measured on 0.02% of D's and G's weights) moves that weight by 2·lr,
and the next forwards' amax then move by up to 1e-2 relative.

Bands, from equal states, those of tests/test_torch_facades_step.py: the
losses within rtol 1e-4 at step 1 (f32 sums in another order; measured
8e-8) and 1e-3 later (measured 1.4e-4 at step 3: the packages' f32 norm
statistics differ in their last bits, which flips q where yc/sx lies at a
rounding tie, and each flip moves a conv output by one quantum); the
stored amax within 1e-4 relative (measured 7e-8 at step 1, 2.0e-5 at step
3); after the step, each parameter within 1.2e-3 absolute and each
tensor's update within 0.2 of its L2 norm, the running statistics within
1e-3 absolute and 1e-3 of their update. The biases of D's three inner
convs are cancelled by the instance norm after them: their gradients are
rounding noise of random sign in both packages (measured: half the signs
differ), so they are held to the absolute band only. The amax init on
equal weights within 1e-6 relative (measured 4.5e-7: the norm statistics
are summed in another order).
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.train.state import scale_by_adam_lp  # noqa: E402
from p2p_tpu.train.step import build_train_step as jax_build  # noqa: E402
from p2p_tpu_torch.convert import load_train_state, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_facades_batch  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.ops import instance_norm as tin  # noqa: E402
from p2p_tpu_torch.train.state import AdamLP, create_train_state, \
    init_amax  # noqa: E402
from p2p_tpu_torch.ops.int8 import (QuantConv, QuantKN2RowConv,  # noqa: E402
                                    QuantSubpixelConv, quant_modules)
from p2p_tpu_torch.ops.spectral_norm import SpectralConv  # noqa: E402
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402
from torch_step_parity import jax_start, load_adam, np_tree  # noqa: E402

SIZE = 64
N_STEPS = 3
KEYS = ("loss_d", "loss_g", "g_gan", "g_l1", "loss_c")
FIELDS = ("params_g", "batch_stats_g", "params_d", "spectral_d", "quant_d")
STEP1_RTOL, LATER_RTOL = 1e-4, 1e-3
PARAM_ATOL, UPDATE_RTOL = 1.2e-3, 0.2
STATS_ATOL, STATS_UPDATE_RTOL = 1e-3, 1e-3
AMAX_RTOL = 1e-4
INIT_AMAX_RTOL = 1e-4
FORCE_PALLAS = {"P2P_TPU_FORCE_PALLAS": "1"}


def _small(cfg, fused=True, dropout=False):
    model = dataclasses.replace(cfg.model, ngf=32, ndf=16,
                                use_dropout=dropout)
    if fused:
        model = dataclasses.replace(model, norm_d="pallas_instance",
                                    int8_fused_epilogue=True)
    return cfg.replace(
        model=model, data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def _batches(n):
    return [synthetic_facades_batch(1, SIZE, seed=i) for i in range(n)]


def _amax(net):
    return {k: float(v) for k, v in net.named_buffers()
            if k.endswith("amax_x")}


def _port_step(tcfg, jstate, batch, sample):
    """One port step from the JAX state ``jstate``: (metrics, amax, state)."""
    ts = create_train_state(tcfg, device="cpu", sample_batch=sample)
    ts = load_train_state(ts, {f: np_tree(getattr(jstate, f))
                               for f in FIELDS})
    for net, opt, jopt in ((ts.net_g, ts.opt_g, jstate.opt_g),
                           (ts.net_d, ts.opt_d, jstate.opt_d)):
        load_adam(opt[0], net, jopt)
    ts.step = int(jstate.step)
    ts, m = build_train_step(tcfg)(ts, batch)
    return {k: float(m[k]) for k in KEYS}, _amax(ts.net_d), ts


@pytest.fixture(scope="module")
def runs():
    jcfg = _small(jax_preset("facades_int8"))
    tcfg = _small(get_preset("facades_int8"))
    batches = _batches(N_STEPS)
    with mock.patch.dict(os.environ, FORCE_PALLAS):
        start, _ = jax_start(jcfg, batches[0], vgg=False)
        js = jax.tree_util.tree_map(jnp.array, start)
        jstep = jax_build(jcfg, None, 1, None, jit=True)
        states, jax_metrics = [np_tree(js)], []
        for b in batches:
            js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
            jax_metrics.append({k: float(m[k]) for k in KEYS})
            states.append(np_tree(js))
    port = [_port_step(tcfg, states[i], b, batches[0])
            for i, b in enumerate(batches)]
    return dict(jax=jax_metrics, states=states, port=port, tcfg=tcfg,
                batch=batches[0])


@pytest.mark.parametrize("i", range(N_STEPS))
def test_per_loss_metrics_track_the_jax_step(runs, i):
    got = runs["port"][i][0]
    assert got["loss_c"] == 0.0 == runs["jax"][i]["loss_c"]
    for k in KEYS[:4]:
        want = runs["jax"][i][k]
        assert np.isfinite(got[k]), k
        rtol = STEP1_RTOL if i == 0 else LATER_RTOL
        assert got[k] == pytest.approx(want, rel=rtol), (i, k, want, got[k])


@pytest.mark.parametrize("i", range(N_STEPS))
def test_stored_scales_track_the_jax_step(runs, i):
    want = state_from_flax(runs["states"][i + 1].quant_d)
    before = state_from_flax(runs["states"][i].quant_d)
    got = runs["port"][i][1]
    assert set(got) == set(want) and len(want) == 3
    for k, w in want.items():
        assert got[k] == pytest.approx(float(w), rel=AMAX_RTOL), (i, k)
        assert float(w) != float(before[k]), k   # the step moved it


def _norm_cancelled(net, k):
    return net == "net_d" and k.endswith(".conv.bias") and \
        "_PlainConv_0" not in k and "_PlainConv_4" not in k


@pytest.mark.parametrize("i", range(N_STEPS))
@pytest.mark.parametrize("net,field", [
    ("net_g", "params_g"), ("net_g", "batch_stats_g"),
    ("net_d", "params_d")])
def test_networks_track_the_jax_step(runs, net, field, i):
    atol, update_rtol = ((STATS_ATOL, STATS_UPDATE_RTOL)
                         if field.startswith("batch") else
                         (PARAM_ATOL, UPDATE_RTOL))
    module = getattr(runs["port"][i][2], net)
    want, start = (state_from_flax(getattr(runs["states"][j], field),
                                   module=module) for j in (i + 1, i))
    got = module.state_dict()
    for k, v in want.items():
        diff = got[k] - v
        assert float(diff.abs().max()) <= atol, (k, float(diff.abs().max()))
        if _norm_cancelled(net, k):
            continue
        update = float((v - start[k]).norm())
        assert update > 0, k
        assert float(diff.norm()) <= update_rtol * update, k


def test_amax_init_matches_the_jax_state(runs):
    """``init_amax`` on the converted parameters reproduces the JAX
    state's ``quant_d`` (flax init's forward on the sample pair)."""
    start = runs["states"][0]
    ts = create_train_state(runs["tcfg"], device="cpu",
                            sample_batch=runs["batch"])
    ts = load_train_state(ts, {f: np_tree(getattr(start, f))
                               for f in FIELDS})
    for k, v in ts.net_d.named_buffers():
        if k.endswith("amax_x"):
            v.zero_()
    b = runs["batch"]
    pair = torch.cat([torch.from_numpy(b[k]).permute(0, 3, 1, 2).float()
                      / 127.5 - 1.0 for k in ("input", "target")], dim=1)
    init_amax(ts.net_d, pair.contiguous(memory_format=torch.channels_last))
    want = state_from_flax(start.quant_d)
    got = _amax(ts.net_d)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(float(w), rel=INIT_AMAX_RTOL), k


def test_adam_lp_matches_scale_by_adam_lp():
    """5 updates of the same gradients: parameters within 1e-6 relative
    (the bias corrections' powers are taken in f64 here, in f32 by optax),
    the stored bf16 moments within one bf16 step."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 2, 2), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = optax.chain(scale_by_adam_lp(0.5, 0.999, 1e-8, "bfloat16"),
                     optax.scale_by_learning_rate(2e-4))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamLP(tp, lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
    for g in grads:
        u, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, u)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    adam = st[0]
    for p, j, mu, nu in zip(tp, jp, adam.mu, adam.nu):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=0)
        s = opt.state[p]
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.bfloat16
        assert s["step"] == 5
        for got, want in ((s["exp_avg"], mu), (s["exp_avg_sq"], nu)):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7, atol=0)


def test_preset_builds_bf16_moments_and_the_bf16_unet():
    """``facades_int8`` keeps G bf16 (int8 needs int8_generator, as in the
    JAX registry) and stores Adam's moments in bf16."""
    cfg = get_preset("facades_int8")
    g8 = define_G(cfg.model, None, cfg.image_hw)
    g = define_G(get_preset("facades").model, None, cfg.image_hw)
    assert type(g8) is type(g)
    assert {k: v.shape for k, v in g8.state_dict().items()} == {
        k: v.shape for k, v in g.state_dict().items()}
    g8q = define_G(dataclasses.replace(cfg.model, int8_generator=True),
                   None, cfg.image_hw)
    assert not isinstance(g8q.down0, QuantConv)
    assert all(isinstance(getattr(g8q, f"down{i}"), QuantConv)
               for i in range(1, g8q.num_downs))
    small = _small(cfg, fused=False)
    ts = create_train_state(small, device="cpu",
                            sample_batch=_batches(1)[0])
    assert all(isinstance(o[0], AdamLP) for o in (ts.opt_g, ts.opt_d))
    with pytest.raises(ValueError, match="sample_batch"):
        create_train_state(small, device="cpu")


@pytest.mark.parametrize("flag", ["int8_generator", "int8_decoder",
                                  "int8_compression", "int8_stem",
                                  "int8_head", "use_spectral_norm"])
def test_the_later_int8_slice_is_refused_by_name(flag):
    """Each flag an earlier port refused by name now builds its quantized
    modules, with stored scales from ``create_train_state``, and a train
    step runs with finite losses and moves them."""
    cfg = _small(get_preset("facades_int8"), fused=False)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **{flag: True}))
    if flag in ("int8_decoder", "int8_compression"):
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, int8_generator=True, use_compression_net=True,
            ngf=8, ndf=8))
    b = _batches(1)[0]
    ts = create_train_state(cfg, device="cpu", sample_batch=b)
    net = {"int8_generator": ts.net_g, "int8_decoder": ts.net_g,
           "int8_compression": ts.net_c}.get(flag, ts.net_d)
    kinds = {"int8_generator": QuantConv, "int8_decoder": QuantSubpixelConv,
             "int8_compression": QuantConv, "int8_stem": QuantConv,
             "int8_head": QuantKN2RowConv, "use_spectral_norm": SpectralConv}
    mods = [m for m in quant_modules(net) if type(m) is kinds[flag]]
    assert mods and all(float(m.amax_x) > 0 for m in mods)
    before = [float(m.amax_x) for m in mods]
    ts, m = build_train_step(cfg)(ts, b)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert [float(q.amax_x) for q in mods] != before


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_steps_run_the_quantize_epilogue_four_times(fused):
    """A bf16 step (dropout on) runs #4 twice per D forward (fake, real)
    and #1 three times, #3 once; the preset as it is (no norm) runs none.
    The CPU takes the plain versions and counts no launch."""
    cfg = _small(get_preset("facades_int8"), fused=fused, dropout=True)
    batches = _batches(2)
    ts = create_train_state(cfg, device="cpu", train_dtype=torch.bfloat16,
                            sample_batch=batches[0])
    step = build_train_step(cfg, None, torch.bfloat16)
    amax0 = _amax(ts.net_d)
    with mock.patch.object(tin, "norm_act_quant",
                           wraps=tin.norm_act_quant) as q4, \
            mock.patch.object(tin, "norm_act", wraps=tin.norm_act) as n3, \
            mock.patch.object(tin, "instance_norm_stats",
                              wraps=tin.instance_norm_stats) as s1:
        for b in batches:
            ts, m = step(ts, b)
            assert all(np.isfinite(float(v)) for v in m.values())
    counts = (q4.call_count, s1.call_count, n3.call_count)
    assert counts == ((8, 12, 4) if fused else (0, 0, 0))
    amax = _amax(ts.net_d)
    assert len(amax) == 3 and amax != amax0
    assert all(np.isfinite(v) and v > 0 for v in amax.values())


def test_nonfinite_batch_restores_the_stored_scales():
    cfg = _small(get_preset("facades_int8"))
    b = _batches(1)[0]
    ts = create_train_state(cfg, device="cpu", sample_batch=b)
    before = {k: v.clone() for k, v in ts.net_d.state_dict().items()}
    bad = {k: v.astype(np.float32) / 127.5 - 1 for k, v in b.items()}
    bad["target"][0, 0, 0, 0] = np.nan
    ts, m = build_train_step(cfg)(ts, bad)
    assert float(m["health_ok"]) == 0.0
    for k, v in ts.net_d.state_dict().items():
        assert torch.equal(v, before[k]), k
