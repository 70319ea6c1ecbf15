"""The port's ``facades_int8_full`` train step (every int8 form but the
stems: the U-Net's int8 encoder and decoder, D's int8 inner convs and
kn2row head, int8 net_c, all with stored scales, ``AdamLP``) against the
JAX step on the CPU, then frozen-scale serving of a port checkpoint.

One JAX ``create_train_state`` of the preset shrunk to ngf 8, ndf 8 at
32², dropout off (the two packages' random streams differ), takes 1 + 3
f32 steps on synthetic facades batches. The port takes each of the last
3 from the JAX state before it, carried across whole (``convert.
load_train_state``: parameters, running statistics, the ``quant_g``,
``quant_d`` and ``quant_c`` scales; Adam's count and moments), so every
step is compared from equal states, as tests/test_torch_int8_step.py
does and for its reason (Adam's sign-like first update at int8 ties).
The first JAX step is not compared: G's and net_c's scales then are the
eval-mode init's, far below the training activations, so most of the
inputs of their int8 convs clip and f32 rounding noise in the BatchNorms
flips q at ties everywhere else (measured: G's running means 3.9e-3 of
their update apart, net_c's first Adam update 0.5 of its norm on a
bias; from the second step on, 3.3e-5 and 8.4e-3).

Bands, those of tests/test_torch_int8_step.py: the losses within rtol
1e-4 at step 1 and 1e-3 later; every stored scale of G, D and C within
1e-4 relative; after the step each parameter within 1.2e-3 absolute and
each tensor's update within 0.2 of its L2 norm, the running statistics
within 1e-3 absolute and 1e-3 of their update. net_c's second conv bias
sits in front of its BatchNorm, which cancels its gradient: rounding
noise of random sign on both sides, held to the absolute band only.

Then the port's own checkpoint of a stepped state (``CheckpointManager``)
is served by ``engine_from_checkpoint`` (G and net_c, f32 on the CPU):
its prediction equals the eval step's on the same batch bitwise, and
every ``amax_x`` is bitwise the same after the requests. A step the skip
guard drops (a NaN in the batch) leaves every buffer of G, D and C as it
was, their stored scales included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.train.step import build_train_step as jax_build  # noqa: E402
from p2p_tpu_torch.convert import load_train_state, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_facades_batch  # noqa: E402
from p2p_tpu_torch.ops.int8 import stored_scales  # noqa: E402
from p2p_tpu_torch.serve.engine import engine_from_checkpoint  # noqa: E402
from p2p_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from p2p_tpu_torch.train.state import AdamLP, create_train_state  # noqa: E402
from p2p_tpu_torch.train.step import build_eval_step, build_train_step  # noqa: E402
from torch_step_parity import jax_start, load_adam, np_tree  # noqa: E402

SIZE = 32
N_WARM, N_STEPS = 1, 3
KEYS = ("loss_d", "loss_g", "g_gan", "g_l1", "loss_c")
FIELDS = ("params_g", "batch_stats_g", "quant_g", "params_d", "spectral_d",
          "quant_d", "params_c", "batch_stats_c", "quant_c")
QUANT = {"net_g": "quant_g", "net_d": "quant_d", "net_c": "quant_c"}
STEP1_RTOL, LATER_RTOL = 1e-4, 1e-3
PARAM_ATOL, UPDATE_RTOL = 1.2e-3, 0.2
STATS_ATOL, STATS_UPDATE_RTOL = 1e-3, 1e-3
AMAX_RTOL = 1e-4


def _small(cfg):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8,
                                  use_dropout=False),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def _batches(n):
    return [synthetic_facades_batch(1, SIZE, seed=i) for i in range(n)]


def _amax(ts):
    return {net: {k: float(v) for k, v in getattr(ts, net).named_buffers()
                  if k.endswith("amax_x")} for net in QUANT}


def _port_step(tcfg, jstate, batch, sample):
    """One port step from the JAX state ``jstate``."""
    ts = create_train_state(tcfg, device="cpu", sample_batch=sample)
    ts = load_train_state(ts, {f: np_tree(getattr(jstate, f))
                               for f in FIELDS})
    for net, opt, jopt in ((ts.net_g, ts.opt_g, jstate.opt_g),
                           (ts.net_d, ts.opt_d, jstate.opt_d),
                           (ts.net_c, ts.opt_c, jstate.opt_c)):
        load_adam(opt[0], net, jopt)
    ts.step = int(jstate.step)
    ts, m = build_train_step(tcfg)(ts, batch)
    return {k: float(m[k]) for k in KEYS}, _amax(ts), ts


@pytest.fixture(scope="module")
def runs():
    jcfg = _small(jax_preset("facades_int8_full"))
    tcfg = _small(get_preset("facades_int8_full"))
    batches = _batches(N_WARM + N_STEPS)
    start, _ = jax_start(jcfg, batches[0], vgg=False)
    js = jax.tree_util.tree_map(jnp.array, start)
    jstep = jax_build(jcfg, None, 1, None, jit=True)
    states, jax_metrics = [np_tree(js)], []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append({k: float(m[k]) for k in KEYS})
        states.append(np_tree(js))
    port = [_port_step(tcfg, states[i], batches[i], batches[0])
            for i in range(N_WARM, N_WARM + N_STEPS)]
    # index i of port, jax and states (from, to) is compared step i
    return dict(jax=jax_metrics[N_WARM:], states=states[N_WARM:],
                port=port, tcfg=tcfg, batches=batches)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_per_loss_metrics_track_the_jax_step(runs, i):
    got = runs["port"][i][0]
    rtol = STEP1_RTOL if i == 0 else LATER_RTOL
    for k in KEYS:
        want = runs["jax"][i][k]
        assert np.isfinite(got[k]) and want != 0.0, k
        assert got[k] == pytest.approx(want, rel=rtol), (i, k, want, got[k])


@pytest.mark.parametrize("i", range(N_STEPS))
@pytest.mark.parametrize("net", list(QUANT))
def test_stored_scales_of_g_d_and_c_track_the_jax_step(runs, net, i):
    field = QUANT[net]
    want = state_from_flax(getattr(runs["states"][i + 1], field))
    before = state_from_flax(getattr(runs["states"][i], field))
    got = runs["port"][i][1][net]
    assert set(got) == set(want) and want
    for k, w in want.items():
        assert got[k] == pytest.approx(float(w), rel=AMAX_RTOL), (i, k)
    assert any(float(want[k]) != float(before[k]) for k in want)


def _norm_cancelled(net, k):
    return net == "net_c" and k == "ConvLayer_1.conv.bias"


@pytest.mark.parametrize("i", range(N_STEPS))
@pytest.mark.parametrize("net,field", [
    ("net_g", "params_g"), ("net_g", "batch_stats_g"),
    ("net_d", "params_d"), ("net_c", "params_c"),
    ("net_c", "batch_stats_c")])
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


def test_preset_is_int8_everywhere_but_the_stems(runs):
    ts = runs["port"][0][2]
    assert all(isinstance(o[0], AdamLP) for o in (ts.opt_g, ts.opt_d,
                                                  ts.opt_c))
    assert not hasattr(ts.net_g.down0, "amax_x")
    assert not hasattr(ts.net_g.up0, "conv")          # the image head
    assert [len(stored_scales(n)) for n in (ts.net_g, ts.net_d, ts.net_c)
            ] == [2 * (ts.net_g.num_downs - 1), 4, 3]


def test_checkpoint_serves_with_frozen_scales_equal_to_the_eval_step(
        runs, tmp_path):
    tcfg = runs["tcfg"]
    ts = runs["port"][-1][2]
    CheckpointManager(str(tmp_path)).save(int(ts.step), ts, epoch=1)
    engine, step = engine_from_checkpoint(tcfg, str(tmp_path), buckets=(1,),
                                          dtype="f32", device="cpu")
    assert step == int(ts.step)
    served = (engine.model, engine.net_c)
    scales = [s.clone() for n in served for s in stored_scales(n)]
    assert len(scales) == len(stored_scales(ts.net_g)) + 3
    batch = runs["batches"][1]
    want, _ = build_eval_step(tcfg)(ts, batch)
    for _ in range(2):
        pred, _, n_real = engine.infer_batch(batch)
        assert n_real == 1
        assert torch.equal(pred, want)
    after = [s for n in served for s in stored_scales(n)]
    assert all(torch.equal(a, b) for a, b in zip(scales, after))
    assert all(torch.equal(a, b) for a, b in zip(
        scales, [s for n in (ts.net_g, ts.net_c) for s in stored_scales(n)]))


def test_a_dropped_step_restores_every_stored_scale(runs):
    """The skip guard: a batch with a NaN leaves every buffer of G, D and
    C as it was, the stored scales of all three included."""
    tcfg = runs["tcfg"]
    b = runs["batches"][0]
    ts = create_train_state(tcfg, device="cpu", sample_batch=b)
    nets = ("net_g", "net_d", "net_c")
    before = {n: {k: v.clone() for k, v in getattr(ts, n).named_buffers()}
              for n in nets}
    bad = {k: v.astype(np.float32) / 127.5 - 1 for k, v in b.items()}
    bad["target"][0, 0, 0, 0] = np.nan
    ts, m = build_train_step(tcfg)(ts, bad)
    assert float(m["health_ok"]) == 0.0
    for n in nets:
        got = dict(getattr(ts, n).named_buffers())
        assert any(k.endswith("amax_x") for k in got), n
        for k, v in before[n].items():
            assert torch.equal(got[k], v), (n, k)
