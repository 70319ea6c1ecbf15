"""Pipeline parallelism over ``pipe`` (parallel/pp.py) against the JAX
package, on the CPU in f32 with 3 gloo ranks (one spawn for the file,
tests/torch_pp_worker.py ``pp_checks`` on ``data=1, pipe=3``), and the
seed streams of core/rng.py.

- Stacking: ``stack_trunk``/``unstack_trunk`` and ``pp_split_state``/
  ``pp_merge_state`` round-trip bitwise through widths 2 and 3 and flat,
  Adam moments included, with fresh optimizers at the split
  (``init_opt=True``) and carried ones (``init_opt=False``); the port's
  stack equals JAX's ``stack_trunk`` of the same variables (block
  ``s·B + j`` at ``[s, j]``) through convert.py, and a JAX split state
  loads through ``convert.load_pp_train_state``.
- The pipelined forward on 3 ranks, M = 4 microbatches of 2 at 32²,
  ngf 8: ExpandNetwork with BatchNorm in eval mode and with instance
  norms (6 blocks), and the ResNet family (``cityscapes_spatial``'s, 3
  blocks), against JAX's ``pp_generator_forward`` on 3 devices and
  bitwise the port's per-microbatch apply; the serial and overlapped
  schedules
  bitwise equal (outputs, gradients, amax proposals).
- The instance family's gradients of ``sum(y²)`` against JAX's train-mode
  unpipelined gradients (``tests/test_pp.py:325-350``): a trunk gradient
  multiplied by S (an all-reduce in the masked sum's backward) fails it.
- The delayed-int8 trunk (3 blocks) against JAX's unpipelined mutable
  apply on the microbatch-major flat batch: the outputs and the
  max-combined amax (JAX's ``gpipe_trunk`` with a ``quant`` stack fails on
  this JAX version, ``tests/test_pp.py`` reds; not the yardstick).
- Refusals by name; the pipe replicas' gradients averaged over the world
  and a stage's kept (each rank's gradients set to its index + 1); a
  merge that gathers the stages over ``pipe`` is the flat generator
  bitwise, moments included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.core.mesh import MeshSpec as JMeshSpec, make_mesh
from p2p_tpu.models.registry import define_G as jax_define_G, init_variables
from p2p_tpu.ops.int8 import reshard_amax as jax_reshard_amax
from p2p_tpu.parallel.pp import (pp_generator_forward as jax_pp_forward,
                                 pp_split_state as jax_pp_split,
                                 stack_trunk as jax_stack_trunk)
from p2p_tpu_torch.convert import (kernel_to_port, load_pp_train_state,
                                   state_from_flax)
from p2p_tpu_torch.core import mesh as tmesh
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.core.rng import RngStream
from p2p_tpu_torch.models.registry import define_G
from p2p_tpu_torch.ops.int8 import reshard_amax
from p2p_tpu_torch.parallel.pp import (pp_merge_state, pp_split_state,
                                       stack_trunk, trunk_prefix,
                                       unstack_trunk)
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.train.step import build_pp_train_step
from torch_dp_worker import spawn_start

N_MICRO, MB, SIZE = 4, 2, 32
CASES = {
    "batch": ("reference", dict(ngf=8, n_blocks=6, norm="batch"), False),
    "instance": ("reference", dict(ngf=8, n_blocks=6, norm="instance"),
                 True),
    "resnet": ("cityscapes_spatial", dict(ngf=8, n_blocks=3), False),
    "int8": ("reference", dict(ngf=8, n_blocks=3, norm="batch", int8=True,
                               int8_generator=True, int8_delayed=True),
             False),
}
# bands, by ROADMAP's band rule (2.5x the largest measured here, rounded
# up to 1, 2 or 5 x 10^-n): the pipelined forward from JAX's
# pp_generator_forward 1.60e-5 of the output's largest (instance norms;
# BatchNorm 1.16e-6, ResNet 2.01e-6: the one-device frameworks' own
# difference, the port's pipelined output being its per-microbatch apply
# bit for bit); the gradients from JAX's unpipelined ones 1.10e-5 of each
# tensor's largest; the int8 trunk's output from JAX's unpipelined apply
# 2.27e-9 of its largest and the amax 1.18e-7 relative
FWD_RTOL = 5e-5
GRAD_RTOL = 5e-5
INT8_RTOL, AMAX_RTOL = 1e-8, 5e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    preset, over, _ = CASES[name]
    jcfg = jax_preset(preset)
    tcfg = get_preset(preset)
    data = dict(image_size=SIZE, image_width=None)
    return (jcfg.replace(model=dataclasses.replace(jcfg.model, **over),
                         data=dataclasses.replace(jcfg.data, **data)),
            tcfg.replace(model=dataclasses.replace(tcfg.model, **over),
                         data=dataclasses.replace(tcfg.data, **data)))


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (N_MICRO * MB, SIZE, SIZE, 3)).astype(np.float32)
    return x.reshape(N_MICRO, MB, SIZE, SIZE, 3)


def _port_g(tcfg, v):
    g = define_G(tcfg.model, image_hw=tcfg.image_hw)
    trees = [v["params"]] + [v[c] for c in ("batch_stats", "quant")
                             if v.get(c)]
    g.load_state_dict(state_from_flax(*trees, module=g))
    return g.to(memory_format=torch.channels_last)



@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("pp")
    x_mb = _inputs()
    x_t = torch.from_numpy(x_mb).permute(0, 1, 4, 2, 3).contiguous()
    setup, cases = {}, {}
    for i, name in enumerate(CASES):
        jcfg, tcfg = _cfgs(name)
        g = jax_define_G(jcfg.model)
        v = jax.jit(lambda k, g=g, m=jcfg.model: init_variables(
            g, k, jnp.asarray(x_mb[0]), m.init_type, m.init_gain,
            train=False))(jax.random.key(i))
        v = jax.tree_util.tree_map(np.asarray, v)
        tg = _port_g(tcfg, v)
        setup[name] = (jcfg, tcfg, g, v, tg)
        cases[name] = {"cfg": tcfg, "net_g": tg.state_dict(), "x_mb": x_t,
                       "grad": CASES[name][2]}
    torch.save({"cases": cases}, tmp / "pp.pt")
    # the ranks run while this process computes JAX's side
    join = spawn_start("pp_checks", 3, str(tmp), str(tmp),
                       module="torch_pp_worker")
    mesh = make_mesh(JMeshSpec(data=1, pipe=3), devices=devices8[:3])
    xj = jnp.asarray(x_mb)
    want = {}
    for name, (jcfg, _, g, v, tg) in setup.items():
        vv = {k: v[k] for k in ("params", "batch_stats", "quant") if k in v}
        w = {}
        if name != "int8":
            w["pp"] = np.asarray(jax.jit(lambda vr, xm, m=jcfg.model:
                                         jax_pp_forward(m, vr, xm, mesh))(
                vv, xj))
        else:
            flat = np.swapaxes(x_mb, 0, 1).reshape((-1,) + x_mb.shape[2:])
            out, mut = jax.jit(lambda vr, xf, g=g: g.apply(
                vr, xf, False, mutable=["quant"]))(vv, jnp.asarray(flat))
            w["flat"] = np.swapaxes(np.asarray(out).reshape(
                (MB, N_MICRO) + x_mb.shape[2:]), 0, 1)
            w["quant"] = state_from_flax(
                jax.tree_util.tree_map(np.asarray, mut["quant"]))
        if CASES[name][2]:
            def loss(p, xm, g=g):
                return sum(jnp.sum(jnp.square(g.apply({"params": p}, xm[m],
                                                      True)))
                           for m in range(N_MICRO))
            grads = jax.jit(jax.grad(loss))(vv["params"], xj)
            w["grads"] = state_from_flax(
                jax.tree_util.tree_map(np.asarray, grads), module=tg)
        # the port's per-microbatch apply (eval mode)
        with torch.no_grad():
            tg.eval()
            w["micro"] = torch.stack([tg(x_t[m].contiguous(
                memory_format=torch.channels_last)) for m in range(N_MICRO)])
        want[name] = w
    return dict(tmp=tmp, ranks=join(600), want=want, setup=setup)


# -------------------------------------------------------------- stacking
def _blocks(g, prefix):
    return {k: {n: t.clone() for n, t in m.state_dict().items()}
            for k, m in g.named_children() if k.startswith(prefix)}


def test_stack_trunk_is_jax_and_round_trips(runs):
    jcfg, tcfg, _, v, tg = runs["setup"]["instance"]
    prefix = trunk_prefix(tcfg.model)
    for s in (2, 3):
        mine = stack_trunk(_blocks(tg, prefix), s, prefix)
        theirs = jax_stack_trunk({"params": v["params"]}, s)["params"]
        k = theirs["ConvLayer_0"]["Conv_0"]["kernel"]
        assert k.shape[:2] == (s, 6 // s)
        for i in range(s):
            for j in range(6 // s):
                assert torch.equal(
                    mine["ConvLayer_0.conv.weight"][i, j],
                    kernel_to_port(torch.from_numpy(np.array(k[i, j])), None))
        back = unstack_trunk(mine, prefix)
        for name, sd in _blocks(tg, prefix).items():
            assert all(torch.equal(sd[n], back[name][n]) for n in sd)
    with pytest.raises(ValueError, match="not divisible by 4 stages"):
        stack_trunk(_blocks(tg, prefix), 4, prefix)


def _tiny_cfg():
    cfg = get_preset("reference")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=6,
                                  num_D=2, n_layers_D=2, norm="instance"),
        data=dataclasses.replace(cfg.data, image_size=SIZE, batch_size=4),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def _state_tensors(state):
    out = {f"g/{k}": v.clone() for k, v in state.net_g.state_dict().items()}
    opt = state.opt_g[0]
    for k, p in state.net_g.named_parameters():
        for m, t in opt.state.get(p, {}).items():
            out[f"opt/{k}/{m}"] = t.clone() if torch.is_tensor(t) else t
    out["sched"] = state.opt_g[1].state_dict()["last_epoch"]
    return out


@pytest.mark.parametrize("init_opt", [True, False])
def test_split_and_merge_round_trip_bitwise(init_opt):
    """flat → 2 stages → flat → 3 stages → flat, with Adam moments filled
    per parameter (the split's fresh ones with ``init_opt``): every
    tensor, moment and count comes back bitwise, and each stage's moments
    sit at its blocks."""
    cfg = _tiny_cfg()
    state = create_train_state(cfg, 0, device="cpu")
    opt = state.opt_g[0]
    for i, p in enumerate(state.net_g.parameters()):
        opt.state[p] = {"step": torch.tensor(2.0),
                        "exp_avg": torch.full_like(p, i + 1.25),
                        "exp_avg_sq": torch.full_like(p, i + 0.5)}
    state.opt_g[1].last_epoch = 2
    if init_opt:
        pp_split_state(state, cfg, None, n_stages=2, init_opt=True)
        assert not state.opt_g[0].state and not state.opt_s[0].state
        for i, p in enumerate(state.pp_stages.parameters()):
            state.opt_s[0].state[p] = {"step": torch.tensor(1.0),
                                       "exp_avg": torch.full_like(p, -i),
                                       "exp_avg_sq": torch.full_like(p, i)}
        pp_merge_state(state, cfg)
        names = [k for k, _ in state.net_g.named_parameters()]
        prefix = trunk_prefix(cfg.model)
        for k, p in state.net_g.named_parameters():
            st = state.opt_g[0].state.get(p)
            assert (st is not None) == k.startswith(prefix), k
        del names
    ref = _state_tensors(state)
    for width in (2, 3):
        pp_split_state(state, cfg, None, n_stages=width, init_opt=False)
        assert state.pp_stages.n_stages == width
        assert len(state.pp_stages.blocks) == 6
        assert not any(k.startswith("ResidualBlock_")
                       for k, _ in state.net_g.named_parameters())
        pp_merge_state(state, cfg)
        got = _state_tensors(state)
        assert set(got) == set(ref)
        for k, t in ref.items():
            assert (torch.equal(t, got[k]) if torch.is_tensor(t)
                    else t == got[k]), k


def test_jax_split_state_loads_through_convert():
    """A JAX state split by JAX's ``pp_split_state`` at 3 stages loads
    into the port's flat state with every block where the law puts it."""
    jcfg = jax_preset("reference")
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, ngf=8, ndf=8, n_blocks=6, num_D=2, n_layers_D=2,
        norm="instance"), data=dataclasses.replace(jcfg.data,
                                                   image_size=SIZE))
    from p2p_tpu.train.state import create_train_state as jax_create
    from torch_step_parity import FIELDS, INIT_COMPILE, np_tree

    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, 256, (1, SIZE, SIZE, 3),
                                         dtype=np.uint8))
             for k in ("input", "target")}
    key = jax.random.key(0)
    js = jax.jit(lambda k: jax_create(jcfg, k, batch, 1)).lower(key).compile(
        compiler_options=INIT_COMPILE)(key)
    split = jax_pp_split(js, jcfg, mesh=None, n_stages=3, init_opt=True,
                         place=False)
    flat = {f: np_tree(getattr(js, f)) for f in FIELDS}
    parts = {f: np_tree(getattr(split, f)) for f in FIELDS}
    parts["pp_stages"] = np_tree(split.pp_stages)
    tcfg = _tiny_cfg()
    a = create_train_state(tcfg, 1, device="cpu")
    b = create_train_state(tcfg, 2, device="cpu")
    from p2p_tpu_torch.convert import load_train_state

    load_train_state(a, flat)
    load_pp_train_state(b, parts, trunk_prefix(tcfg.model))
    sa, sb = a.net_g.state_dict(), b.net_g.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


# -------------------------------------------------------------- forward
def _port_y(ranks, name, overlap=False):
    return [r["fwd"][name][overlap]["y"] for r in ranks]


@pytest.mark.parametrize("name", ["batch", "instance", "resnet"])
def test_pp_forward_matches_jax_and_the_per_microbatch_apply(runs, name):
    ys = _port_y(runs["ranks"], name)
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    y = ys[0]
    want = runs["want"][name]
    jy = torch.from_numpy(want["pp"].copy()).permute(0, 1, 4, 2, 3)
    scale = float(jy.abs().max())
    assert float((y - jy).abs().max()) <= FWD_RTOL * scale
    # JAX's pin: the pipelined output is the per-microbatch apply's
    assert torch.equal(y, want["micro"])


@pytest.mark.parametrize("name", list(CASES))
def test_pp_overlap_is_the_serial_schedule_bitwise(runs, name):
    for r in runs["ranks"]:
        s, o = r["fwd"][name][False], r["fwd"][name][True]
        assert torch.equal(s["y"], o["y"])
        for key in ("quant", "grads"):
            if key in s:
                assert set(s[key]) == set(o[key])
                assert all(torch.equal(s[key][k], o[key][k]) for k in s[key])
        if "gx" in s:
            assert torch.equal(s["gx"], o["gx"])
    # the schedules' hand-offs: serial T − 1 = M + S − 2 shifts a way,
    # overlapped T − 2 = M + 2S − 4, every rank alike
    stats = runs["ranks"][1]["fwd"][name]
    ways = 2 if CASES[name][2] else 1
    assert stats[False]["stats"]["p2p"]["calls"] == ways * (N_MICRO + 1)
    assert stats[True]["stats"]["p2p"]["calls"] == ways * (N_MICRO + 2)


def test_instance_gradients_match_jax_train_mode(runs):
    """Every gradient (the encoder's and decoder's on each rank, each
    block's on its stage) against JAX's train-mode unpipelined one: a
    trunk multiplied by the 3 stages would be 200% off."""
    want = runs["want"]["instance"]["grads"]
    ranks = runs["ranks"]
    stage_of = {}
    for i, r in enumerate(ranks):
        for k in r["fwd"]["instance"][False]["grads"]:
            if k.startswith("ResidualBlock_"):
                stage_of[k] = i
    assert len(set(stage_of.values())) == 3
    for k, w in want.items():
        gots = ([ranks[stage_of[k]]] if k in stage_of else ranks)
        for r in gots:
            g = r["fwd"]["instance"][False]["grads"][k]
            assert float((g - w).abs().max()) <= GRAD_RTOL * float(
                w.abs().max()) + 1e-12, k
    # the trunk input's cotangent reached every pipe rank
    gx = [r["fwd"]["instance"][False]["gx"] for r in ranks]
    assert all(torch.equal(gx[0], g) for g in gx[1:])
    assert float(gx[0].abs().max()) > 0


def test_int8_trunk_matches_the_unpipelined_mutable_apply(runs):
    want = runs["want"]["int8"]
    y = _port_y(runs["ranks"], "int8")[0]
    flat = torch.from_numpy(want["flat"].copy()).permute(0, 1, 4, 2, 3)
    scale = max(float(flat.abs().max()), 1.0)
    assert float((y - flat).abs().max()) <= INT8_RTOL * scale
    got = {}
    for r in runs["ranks"]:
        got.update(r["fwd"]["int8"][False]["quant"])
    assert set(got) == set(want["quant"]) and len(got) == 6
    for k, w in want["quant"].items():
        assert abs(float(got[k]) - float(w)) <= AMAX_RTOL * float(w), k


# -------------------------------------------------------------- replicas
def test_pipe_replicas_averaged_and_stages_kept(runs):
    """With each rank's gradients set to its index + 1 (data = 1), a stage
    block keeps its own and every replicated parameter gets the pipe
    peers' mean, so their copies take one update."""
    for rank, r in enumerate(runs["ranks"]):
        for k, values in r["sync"].items():
            stage = k.startswith("ResidualBlock_")
            assert values == ([rank + 1.0] if stage else [2.0]), (rank, k)


def test_merge_gathers_every_stage_exactly(runs):
    _, tcfg, _, _, tg = runs["setup"]["instance"]
    want = tg.state_dict()
    for r in runs["ranks"]:
        got = r["merge"]["net_g"]
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    # every parameter's moments where the split had them, whichever rank
    # held its stage
    flat = sorted(k for k, _ in tg.named_parameters())
    for r in runs["ranks"]:
        assert r["merge"]["moments"] == {
            k: (flat.index(k) + 0.25, flat.index(k) + 0.5) for k in flat}


def test_ring_shift_keeps_the_kernels_layout_on_both_routes(runs):
    """The hand-off by either route delivers the previous rank's values
    channels_last (the layout #1-#4 take on the card: the slot route's
    buffer is row-major)."""
    for rank, r in enumerate(runs["ranks"]):
        src = (rank - 1) % 3
        want = torch.arange(240, dtype=torch.float32).reshape(
            2, 6, 4, 5).add(1000.0 * src)
        for route in ("p2p", "slot"):
            y, channels_last = r["shift"][route]
            assert channels_last and torch.equal(y, want), (rank, route)


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("what", ["pix2pixhd", "ema", "pool"])
def test_pp_step_refuses_by_name(what):
    cfg = _tiny_cfg()
    if what == "pix2pixhd":
        cfg = get_preset("pix2pixhd")
        with pytest.raises(NotImplementedError,
                           match="not 'pix2pixhd'"):
            build_pp_train_step(cfg, None, 2)
        return
    if what == "ema":
        cfg = cfg.replace(health=dataclasses.replace(cfg.health,
                                                     ema_decay=0.999))
        match = "ema_decay is not supported on the pipelined step"
    else:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, pool_size=4))
        match = "historical-fake pool"
    with pytest.raises(ValueError, match=match):
        build_pp_train_step(cfg, None, 2)


@pytest.mark.parametrize("other", ["spatial", "time", "model", "fsdp"])
def test_uncomposed_pipe_pairs_are_refused_by_name(other):
    with pytest.raises(NotImplementedError, match=f"pipe=2 and {other}=2"):
        tmesh.check_ported_axes(tmesh.MeshSpec(data=1, pipe=2,
                                               **{other: 2}))
    tmesh.check_ported_axes(tmesh.MeshSpec(data=2, pipe=2))


# ------------------------------------------------------------ small parts
def test_rng_stream_is_deterministic_and_distinct():
    """tests/test_core.py:58's semantics on the port's law: the same
    stream draws the same, another step or name draws otherwise."""
    s = RngStream.from_seed(0)
    draw = [torch.rand(4, generator=x.generator()) for x in (
        s.at_step(3).key("dropout"), s.at_step(3).key("dropout"),
        s.at_step(4).key("dropout"), s.at_step(3).key("noise"))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])
    a, b = s.split(2)
    assert a.seed() != b.seed()
    # JAX's name word: a name's first 4 bytes pick its stream
    assert s.key("drop").entropy == s.key("dropout").entropy


def test_reshard_amax_is_jax():
    a = np.arange(1, 9, dtype=np.float32).reshape(4, 2)
    for old, new in ((4, 2), (4, 1), (2, 4), (4, 8)):
        src = a if old == 4 else np.repeat(a[:old], 1, axis=0)
        want = np.asarray(jax_reshard_amax(jnp.asarray(src), old, new))
        got = reshard_amax(torch.from_numpy(src), old, new).numpy()
        assert np.array_equal(got, want), (old, new)
    s = torch.tensor(3.5)
    assert torch.equal(reshard_amax(s, 2, 1), s)
    wide = reshard_amax(torch.from_numpy(a), 4, 8)
    assert torch.equal(reshard_amax(wide, 8, 4), torch.from_numpy(a))
    with pytest.raises(ValueError, match="4 -> 3"):
        reshard_amax(torch.from_numpy(a), 4, 3)
