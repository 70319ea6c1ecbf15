"""The trainer options of the port against the JAX package on the CPU,
op by op (no whole-step compile): the ``step``, ``cosine`` and
``plateau`` lr policies and ``PlateauController``, the historical-fake
pool (host and device forms), global-norm gradient clipping, the EMA
generator's update, the checkpoints of the EMA, the pool and the plateau
scale, and the two presets of this slice.

Tolerances: the schedules' multipliers within 1e-6 absolute (JAX
computes them in f32, the angle of ``cosine`` too, whose rounding at
π·11/4 moves the multiplier by ~2e-7; the port in f64); the plateau
scales, the host pool, the device pool given the JAX draws, the EMA at decay 0 and every checkpoint round trip bitwise;
clipped gradients within 1e-6 relative of JAX's (the global norm sums the
same squares in another order) and the parameters after one clipped Adam
step within 1e-7 absolute; the EMA at decay 0.999 within 1 ulp-scale
(1e-7 relative) of JAX's.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from p2p_tpu.core import config as jconfig  # noqa: E402
from p2p_tpu.train.schedules import (  # noqa: E402
    PlateauController as JaxPlateau, make_schedule as jax_schedule)
from p2p_tpu.train.state import _zero_nonfinite  # noqa: E402
from p2p_tpu.train.state import ema_update as jax_ema_update  # noqa: E402
from p2p_tpu.utils.pool import (  # noqa: E402
    ImagePool as JaxImagePool, device_pool_query as jax_pool_query)
from p2p_tpu_torch.core import config as tconfig  # noqa: E402
from p2p_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_dataset, synthetic_batch)
from p2p_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from p2p_tpu_torch.train.loop import Trainer  # noqa: E402
from p2p_tpu_torch.train.schedules import (PlateauController,  # noqa: E402
                                           make_schedule)
from p2p_tpu_torch.train.state import (clip_grads_,  # noqa: E402
                                       create_train_state, ema_update_)
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402
from p2p_tpu_torch.utils.pool import ImagePool, pool_query_draws  # noqa: E402

SCHED_ATOL = 1e-6
CLIP_RTOL, ADAM_ATOL = 1e-6, 1e-7
EMA_RTOL = 1e-7


@pytest.mark.parametrize("name", ["edges2shoes_dp", "cityscapes_spatial"])
def test_presets_match_the_jax_presets_but_the_mesh(name):
    j, t = jconfig.get_preset(name), tconfig.get_preset(name)
    for section in ("model", "loss", "optim", "data", "train", "health"):
        port = getattr(t, section)
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(
                getattr(j, section), f.name), (section, f.name)
    # the mesh too, since the data axis is ported (slice 13)
    assert dataclasses.asdict(t.parallel) == dataclasses.asdict(j.parallel)
    if name == "edges2shoes_dp":
        assert t.data.batch_size == 64 and t.image_hw == (256, 256)
    else:
        assert t.data.batch_size == 4 and t.image_hw == (256, 512)
        assert (t.model.generator, t.model.norm) == ("resnet", "instance")


@pytest.mark.parametrize("policy", ["lambda", "step", "cosine", "plateau"])
def test_lr_policies_match_jax(policy):
    kw = dict(lr_policy=policy, niter=4, niter_decay=3, lr_decay_iters=2)
    cfg, jcfg = tconfig.OptimConfig(**kw), jconfig.OptimConfig(**kw)
    for epoch_count in (1, 3):
        mult = make_schedule(cfg, steps_per_epoch=2,
                             epoch_count=epoch_count)
        jsched = jax_schedule(jcfg, steps_per_epoch=2,
                              epoch_count=epoch_count)
        for step in range(2 * 3 * cfg.niter + 1):     # epochs 0 … 3·niter
            assert cfg.lr * mult(step) == pytest.approx(
                float(jsched(step)), rel=0, abs=SCHED_ATOL * cfg.lr), step
    if policy == "cosine":          # no clamp past niter: it rises again
        assert mult(2 * 2 * cfg.niter) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="unknown lr policy"):
        make_schedule(tconfig.OptimConfig(lr_policy="linear"), 1)


def test_plateau_controller_follows_jax():
    metrics = [5.0, 4.0, 3.99, 3.98, 3.97, 3.96, 3.95, 3.94, 2.0, 2.5,
               2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5]
    port, ref = PlateauController(), JaxPlateau()
    scales = [(port.update(m), ref.update(m)) for m in metrics]
    assert [p for p, _ in scales] == [r for _, r in scales]
    assert scales[-1][0] == pytest.approx(0.2 ** 2)   # two reductions
    assert (port.best, port.bad_epochs) == (ref.best, ref.bad_epochs)


@pytest.mark.parametrize("size", [0, 3])
def test_host_image_pool_is_bitwise_jax(size):
    rng = np.random.default_rng(7)
    port, ref = ImagePool(size, seed=5), JaxImagePool(size, seed=5)
    for _ in range(8):
        batch = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
        np.testing.assert_array_equal(port.query(batch), ref.query(batch))


def _jax_draws(key, n, p_size):
    """The draws the JAX ``device_pool_query`` makes from ``key``."""
    k_idx, k_swap = jax.random.split(key)
    return (np.array(jax.random.randint(k_idx, (n,), 0, p_size,
                                        jnp.int32)),
            np.array(jax.random.uniform(k_swap, (n,)) > 0.5))


def _colliding_key(n, p_size):
    """The first key whose draws swap every sample into one slot."""
    for s in range(10_000):
        key = jax.random.key(s)
        idx, swap = _jax_draws(key, n, p_size)
        if swap.all() and len(set(idx.tolist())) == 1:
            return key
    raise AssertionError("no colliding key")


@pytest.mark.parametrize("case", ["fill_boundary", "empty", "full",
                                  "collide"])
def test_device_pool_query_matches_jax_given_its_draws(case):
    """The fill boundary (2 of 4 slots filled, 3 pairs in), a first batch
    larger than the pool (nothing filled to swap against), a full pool,
    and two swaps to one slot (the last wins)."""
    p_size, n = 4, 3
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(p_size, 5, 6, 2)).astype(np.float32)
    pool_n = {"fill_boundary": 2, "empty": 0, "full": 4, "collide": 4}[case]
    if case == "empty":
        n = 6
        pool[:] = 0
    pool[pool_n:] = 0
    pairs = rng.normal(size=(n, 5, 6, 2)).astype(np.float32)
    key = (_colliding_key(n, p_size) if case == "collide"
           else jax.random.key(11))
    want = jax.jit(jax_pool_query)(jnp.asarray(pool),
                                   jnp.asarray(pool_n, jnp.int32),
                                   jnp.asarray(pairs), key)
    idx, swap = _jax_draws(key, n, p_size)
    got = pool_query_draws(torch.from_numpy(pool),
                           torch.tensor(pool_n, dtype=torch.int32),
                           torch.from_numpy(pairs), torch.from_numpy(idx),
                           torch.from_numpy(swap))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32


def _grads(rng, scale, poison):
    g = [rng.normal(size=s).astype(np.float32) * scale
         for s in ((3, 4), (5,), (2, 2, 3))]
    if poison:
        g[0][1, 2], g[2][0, 1, 1], g[1][4] = np.inf, np.nan, -np.inf
    return g


@pytest.mark.parametrize("where", ["below", "at", "above", "poisoned"])
def test_grad_clip_matches_optax(where):
    """optax.chain(_zero_nonfinite, clip_by_global_norm, adam) on the same
    parameters and gradients: the clipped gradients, and the parameters
    after one Adam step."""
    rng = np.random.default_rng(1)
    params = [rng.normal(size=g.shape).astype(np.float32)
              for g in _grads(rng, 1.0, False)]
    grads = _grads(rng, 1.0, where == "poisoned")
    clean = [np.where(np.isfinite(g), g, 0) for g in grads]
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in clean)))
    max_norm = {"below": 2 * norm, "at": np.float32(norm),
                "above": norm / 3, "poisoned": norm / 2}[where]
    chain = optax.chain(_zero_nonfinite(),
                        optax.clip_by_global_norm(float(max_norm)))
    want, _ = chain.update([jnp.asarray(g) for g in grads],
                           chain.init(params))
    got = [torch.from_numpy(g.copy()) for g in grads]
    assert int(clip_grads_(got, float(max_norm))) == 3 * (where == "poisoned")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=CLIP_RTOL,
                                   atol=0)
    if where == "below":
        for g, c in zip(got, clean):
            np.testing.assert_array_equal(g.numpy(), c)
    opt = optax.chain(chain, optax.adam(2e-4, b1=0.5, b2=0.999))
    up, _ = opt.update([jnp.asarray(g) for g in grads], opt.init(params))
    jparams = optax.apply_updates(params, up)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    tadam = torch.optim.Adam(tp, lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
    for p, g in zip(tp, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_grads_([p.grad for p in tp], float(max_norm))
    tadam.step()
    for p, w in zip(tp, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=ADAM_ATOL, rtol=0)


def test_grad_clip_is_not_torch_clip_grad_norm():
    """At the threshold optax leaves the gradient as it is, while torch's
    clip_grad_norm_ divides by ‖g‖ + 1e-6: the port follows optax."""
    g = torch.tensor([3.0, 4.0])
    ours, theirs = g.clone(), g.clone().requires_grad_()
    clip_grads_([ours], 5.0)
    theirs.grad = g.clone()
    torch.nn.utils.clip_grad_norm_([theirs], 5.0)
    assert torch.equal(ours, g) and not torch.equal(theirs.grad, g)


def _small(name, **sections):
    cfg = tconfig.get_preset(name)
    base = dict(
        model=dict(ngf=8, ndf=8, n_blocks=1),
        data=dict(image_size=32),
        loss=dict(lambda_vgg=0.0),
        train=dict(mixed_precision=False))
    for sec, kw in sections.items():
        base[sec] = {**base.get(sec, {}), **kw}
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kw)
                          for sec, kw in base.items()})


def test_step_counts_nonfinite_gradient_entries_with_clip():
    """With grad_clip a poisoned G gradient entry is counted
    (``nonfinite_g``) and zeroed before the update; without it the step
    reports no counts."""
    cfg = _small("reference", optim=dict(grad_clip=1.0))
    ts = create_train_state(cfg, device="cpu")
    w = ts.net_g.ConvLayer_0.conv.weight
    hook = w.register_hook(lambda g: g.index_put(
        (torch.tensor([0]),) * 4, torch.tensor(float("inf"))))
    ts, m = build_train_step(cfg)(ts, synthetic_batch(1, 32, seed=0))
    hook.remove()
    assert (float(m["nonfinite_g"]), float(m["nonfinite_d"]),
            float(m["nonfinite_c"])) == (1.0, 0.0, 0.0)
    assert bool(torch.isfinite(w).all())
    plain = _small("reference")
    ts = create_train_state(plain, device="cpu")
    _, m = build_train_step(plain)(ts, synthetic_batch(1, 32, seed=0))
    assert not any(k.startswith("nonfinite") for k in m)


@pytest.mark.parametrize("decay", [0.0, 0.999])
def test_ema_update_matches_jax(decay):
    rng = np.random.default_rng(2)
    net = torch.nn.Linear(4, 3)
    ema = {k: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
           for k, p in net.named_parameters()}
    before = {k: v.numpy().copy() for k, v in ema.items()}
    want = jax_ema_update(
        before, {k: p.detach().numpy() for k, p in net.named_parameters()},
        decay)
    ema_update_(ema, net, decay)
    for k, p in net.named_parameters():
        if decay == 0.0:
            assert torch.equal(ema[k], p.detach())
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(want[k]),
                                   rtol=EMA_RTOL, atol=0)


def _stepped_state(cfg, seed, n=3):
    ts = create_train_state(cfg, seed, device="cpu")
    step = build_train_step(cfg)
    for i in range(n):
        ts, _ = step(ts, synthetic_batch(1, 32, seed=i))
    return ts


def test_ema_pool_and_plateau_scale_restore_bitwise(tmp_path):
    cfg = _small("facades", model=dict(use_dropout=False),
                 train=dict(pool_size=2), health=dict(ema_decay=0.9),
                 optim=dict(lr_policy="plateau", grad_clip=1.0))
    ts = _stepped_state(cfg, 0)
    ts.lr_scale = 0.04
    assert int(ts.pool_n) == 2 and bool(ts.pool.abs().sum() > 0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(ts.step, ts, 1)
    files = json.load(open(os.path.join(mgr.step_dir(ts.step),
                                        "manifest.json")))["files"]
    assert {"ema_g.pt", "pool.pt", "progress.pt"} <= set(files)
    assert set(files["pool.pt"]["tensors"]) == {"pool", "pool_n"}
    fresh = create_train_state(cfg, 5, device="cpu")
    assert mgr.restore(fresh) == (ts.step, 1)
    assert fresh.lr_scale == 0.04
    assert torch.equal(fresh.pool, ts.pool) and \
        torch.equal(fresh.pool_n, ts.pool_n)
    for k, v in ts.ema_g.items():
        assert torch.equal(fresh.ema_g[k], v), k
        assert not torch.equal(v, dict(ts.net_g.named_parameters())[k]), k


def test_ema_decay_over_a_checkpoint_without_ema_gives_the_hint(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=1,
                                  n_test=1, size=32, seed=0)
    cfg = _small("facades", model=dict(use_dropout=False),
                 train=dict(nepoch=1, epoch_save=1))
    Trainer(cfg, root, str(tmp_path / "w"), device="cpu").fit()
    ema = cfg.replace(health=dataclasses.replace(cfg.health, ema_decay=0.9))
    with pytest.raises(RuntimeError, match="resume without --ema_decay"):
        Trainer(ema, root, str(tmp_path / "w"), device="cpu").maybe_resume()


def test_plateau_scale_feeds_the_updates_and_the_logged_lr(tmp_path):
    """A plateau run: the epoch's loss_g is fed to the controller after
    the epoch record, its scale multiplies the updates (an lr_scale of 0
    leaves the parameters as they were) and the logged lr carries it."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=1,
                                  n_test=1, size=32, seed=0)
    cfg = _small("facades", model=dict(use_dropout=False),
                 optim=dict(lr_policy="plateau"),
                 train=dict(nepoch=2, epoch_save=1))
    tr = Trainer(cfg, root, str(tmp_path / "w"), device="cpu")
    fed = []
    tr.plateau.update = lambda m: fed.append(m) or 0.5
    hist = tr.fit()
    assert fed == [h["loss_g"] for h in hist]
    assert [h["lr"] for h in hist] == [cfg.optim.lr, cfg.optim.lr * 0.5]
    tr.state.lr_scale = 0.0
    before = {k: v.clone() for k, v in tr.state.net_g.named_parameters()}
    tr.train_step(tr.state, synthetic_batch(1, 32, seed=9))
    for k, v in tr.state.net_g.named_parameters():
        assert torch.equal(v, before[k]), k
    again = Trainer(cfg, root, str(tmp_path / "w"), device="cpu")
    assert again.maybe_resume() and again.plateau.scale == 0.5
    assert math.isclose(again.current_lr(), cfg.optim.lr * 0.5)

