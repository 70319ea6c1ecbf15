"""Shared harness of the train-step parity tests: one JAX train state carried
into the port, the same batches through both steps, the per-step metrics
and the step-1 gradients of G and D.

The gradients are read from Adam's first moment after step 1: with the
moment starting at 0, both optax and ``torch.optim.Adam`` hold
``(1 − β1)·g`` = ``0.5·g`` exactly (β1 = 0.5), so ``2·mu`` is the step's
gradient on either side, without a second forward.
"""

import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from p2p_tpu.models.vgg import load_vgg19_params
from p2p_tpu.train.state import create_train_state as jax_create
from p2p_tpu.train.step import build_train_step as jax_build
from p2p_tpu_torch.convert import load_train_state, state_from_flax
from p2p_tpu_torch.models.vgg import VGG19Features
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.train.step import build_train_step

FIELDS = ("params_g", "batch_stats_g", "params_d", "spectral_d",
          "params_c", "batch_stats_c", "ema_g", "pool", "pool_n",
          "lr_scale")
POOL_SALT = 0x705501


def jax_pool_draws(seed, step, n, p_size):
    """The draws of the JAX step's pool query at ``step``
    (``p2p_tpu/train/step.py``: ``fold_in(key(seed ^ 0x705501), step)``,
    split into the index and the swap key)."""
    key = jax.random.fold_in(jax.random.key(seed ^ POOL_SALT), step)
    k_idx, k_swap = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.randint(
        k_idx, (n,), 0, p_size, jnp.int32))),
        torch.from_numpy(np.array(jax.random.uniform(k_swap, (n,)) > 0.5)))


@contextlib.contextmanager
def jax_pool_draws_fed(seed):
    """The port's pool queries take the JAX step's draws: its generator
    stands for the step it was made for."""
    from p2p_tpu_torch.utils import pool as pool_lib

    def query(pool, pool_n, pairs, step):
        idx, swap = jax_pool_draws(seed, step, pairs.shape[0],
                                   pool.shape[0])
        return pool_lib.pool_query_draws(pool, pool_n, pairs, idx, swap)

    with mock.patch.object(pool_lib, "pool_generator",
                           lambda s, step, dev: step), \
            mock.patch.object(pool_lib, "device_pool_query", query):
        yield


def np_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a), tree)


def adam_mu(opt_state):
    """The first moment of the Adam inside an optax state."""
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    (adam,) = [s for s in leaves if isinstance(s, optax.ScaleByAdamState)]
    return np_tree(adam.mu)


def load_adam(opt, net, jopt):
    """The count and moments of the Adam inside the optax state ``jopt``
    into the port's optimizer ``opt`` of ``net`` (an ``AdamLP`` keeps its
    moment dtype)."""
    leaves = jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    (adam,) = [s for s in leaves if isinstance(s, optax.ScaleByAdamState)]
    count = int(adam.count)
    if count == 0:
        return
    mu, nu = (state_from_flax(np_tree(t), module=net)
              for t in (adam.mu, adam.nu))
    dt = getattr(opt, "moment_dtype", torch.float32)
    for k, p in net.named_parameters():
        opt.state[p] = {"step": count, "exp_avg": mu[k].to(dt),
                        "exp_avg_sq": nu[k].to(dt)}


def port_grads(net, opt):
    """``{name: 2·exp_avg}`` of a port network after its first step."""
    state = opt[0].state
    return {k: 2.0 * state[p]["exp_avg"] for k, p in net.named_parameters()}


# the initial state is run once per configuration, so its compile is cut
# short; initialization draws integers (threefry) and does not depend on
# the optimization level
INIT_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_start(jcfg, sample_batch, vgg=True):
    """The JAX train state both packages start from and the VGG19
    parameters as a numpy tree (None without VGG).
    Mixed precision keeps f32 masters, so one start serves the f32 and the
    bf16 steps of a configuration."""
    sample = {k: jnp.asarray(v) for k, v in sample_batch.items()}
    key = jax.random.key(0)
    init = jax.jit(lambda k: jax_create(jcfg, k, sample, 1)).lower(
        key).compile(compiler_options=INIT_COMPILE)
    js = init(key)
    vgg_params = (np_tree(jax.jit(lambda: load_vgg19_params(seed=190))())
                  if vgg else None)
    return js, vgg_params


def run_both(jcfg, tcfg, batches, keys, start, jax_dtype=None,
             torch_dtype=None, keep_states=False):
    """len(batches) steps of both packages from one JAX state ``start``
    (:func:`jax_start`), converted into the port. The JAX side runs its
    Pallas kernels in interpret mode with their custom VJPs. Returns the
    per-step metrics of each and the step-1 gradients of G and D of each
    (JAX's converted to the port's names); with ``keep_states`` also both
    final states, ``(jax, port)``."""
    # the JAX step donates its state: step a copy
    js = jax.tree_util.tree_map(jnp.array, start[0])
    with mock.patch.dict(os.environ, {"P2P_TPU_FORCE_PALLAS": "1"}):
        jstep = jax_build(jcfg, start[1], 1, jax_dtype, jit=True)
        jax_metrics, jax_grads = [], None
        for b in batches:
            js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
            jax_metrics.append({k: float(m[k]) for k in keys})
            if jax_grads is None:
                jax_grads = {"g": adam_mu(js.opt_g), "d": adam_mu(js.opt_d)}

    port_metrics, grads, ts = run_port(tcfg, batches, keys, start,
                                       torch_dtype)
    want = {"g": state_from_flax(jax_grads["g"], module=ts.net_g),
            "d": state_from_flax(jax_grads["d"], module=ts.net_d)}
    out = dict(jax=jax_metrics, port=port_metrics, grads={
        net: (grads[net], {k: 2.0 * v for k, v in want[net].items()})
        for net in grads})
    if keep_states:
        out["states"] = (js, ts)
    return out


def run_port(tcfg, batches, keys, start, torch_dtype=None):
    """The port's side of :func:`run_both`: its per-step metrics, its
    step-1 gradients of G and D and its final state."""
    js, vgg_params = start
    ts = load_train_state(create_train_state(
        tcfg, device="cpu", train_dtype=torch_dtype),
        {f: np_tree(getattr(js, f)) for f in FIELDS})
    tvgg = None
    if vgg_params is not None:
        tvgg = VGG19Features()
        tvgg.load_state_dict(state_from_flax(vgg_params), strict=True)
        tvgg.eval()
    tstep = build_train_step(tcfg, tvgg, torch_dtype)
    metrics, grads = [], None
    for b in batches:
        with jax_pool_draws_fed(tcfg.train.seed):
            ts, m = tstep(ts, b)
        metrics.append({k: float(m[k]) for k in keys})
        if grads is None:
            grads = {"g": port_grads(ts.net_g, ts.opt_g),
                     "d": port_grads(ts.net_d, ts.opt_d)}
    return metrics, grads, ts


def assert_grads_close(got, want, atol, rtol_of_max, slack=None):
    """Every parameter's step-1 gradient, port against JAX: within
    ``atol`` plus ``rtol_of_max`` of the tensor's largest |gradient|, plus
    ``slack[name]`` where given."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = got[k].detach()
        assert g.shape == w.shape, k
        diff = float((g - w).abs().max())
        limit = atol + rtol_of_max * float(w.abs().max())
        assert diff <= limit + (slack or {}).get(k, 0.0), (k, diff, limit)


def assert_losses_close(runs, keys, rtol, slack=None):
    """Every metric of ``keys`` at every step, port against JAX: within
    ``rtol`` relative, plus ``slack[step][key]`` where given."""
    for i, (jm, pm) in enumerate(zip(runs["jax"], runs["port"])):
        for k in keys:
            assert np.isfinite(pm[k]), (i, k)
            extra = slack[i][k] if slack else 0.0
            assert abs(pm[k] - jm[k]) <= rtol * abs(jm[k]) + extra, (
                i, k, jm[k], pm[k], extra)
