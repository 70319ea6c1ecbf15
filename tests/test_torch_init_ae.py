"""``model.init_type`` and the compression autoencoder against the JAX
package on the CPU, at ngf and ndf 8, 32².

init_type: the port re-draws exactly the JAX tree's ``kernel`` leaves of
G, D and net_c (``p2p_tpu/models/registry.py:133 apply_init_type``), whose
flax shapes, and so fans, ``convert.py`` maps onto the port's layouts; each
re-drawn kernel, and JAX's own initializers' draws at such shapes, follow
the law: xavier and kaiming normals truncated at ±2σ′ (σ′ =
σ/0.87962566, σ from the HWIO fans, ``init_gain`` unused) with their std
within 6 standard errors of σ, orthogonal kernels with WᵀW (or WWᵀ where
the (H·W·I, O) matrix is wide) = gain²·I within 1e-5·gain². Everything else
keeps the reference init bitwise. The compression autoencoder's forward
(and its quantized latent) against flax's through ``convert.py``: within
1e-4 of the largest output, the 3-bit levels equal."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.models.compression_ae import CompressionAutoencoder as JaxAE
from p2p_tpu.models.registry import _kernel_initializer
from p2p_tpu.train.state import create_train_state as jax_create
from p2p_tpu_torch.convert import (flatten_tree, kernel_to_flax, load_flax,
                                   state_from_flax)
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.models.compression_ae import CompressionAutoencoder
from p2p_tpu_torch.models.registry import jax_kernels, kernel_fans
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.train.video_step import create_video_train_state

torch.set_num_threads(1)
GAIN = 0.5
NETS = (("net_g", "params_g"), ("net_d", "params_d"), ("net_c", "params_c"))


def _small(cfg, **model):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  **model),
        data=dataclasses.replace(cfg.data, image_size=32))


def check_law(w: np.ndarray, init_type: str, gain: float, what: str):
    """``w`` (flax layout) drawn from ``init_type``'s law."""
    w = np.asarray(w, np.float64)
    if init_type == "orthogonal":
        m = w.reshape(-1, w.shape[-1])
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        err = np.abs(gram - gain ** 2 * np.eye(len(gram))).max()
        assert err <= 1e-5 * gain ** 2, (what, err)
        return
    fan_in, fan_out = kernel_fans(w.shape)
    sigma = math.sqrt(2.0 / (fan_in + fan_out) if init_type == "xavier"
                      else 2.0 / fan_in)
    se = 1.0 / math.sqrt(2 * w.size)
    assert abs(w.std() / sigma - 1.0) <= 6 * se + 1e-3, (what, w.std(), sigma)
    assert abs(w.mean()) <= 6 * sigma / math.sqrt(w.size), what
    assert np.abs(w).max() <= 2 * sigma / 0.87962566103423978 * (1 + 1e-6), \
        what


@pytest.fixture(scope="module")
def jax_trees():
    """Abstract JAX train-state trees of the small ``reference`` preset."""
    cfg = _small(jax_preset("reference"))
    sample = {k: jnp.zeros((1, 32, 32, 3)) for k in ("input", "target")}
    st = jax.eval_shape(lambda: jax_create(cfg, jax.random.key(0), sample))
    return {f: getattr(st, f) for _, f in NETS}


@pytest.mark.parametrize("init_type", ["xavier", "kaiming", "orthogonal"])
def test_init_type_redraws_the_jax_kernel_leaves_by_their_law(init_type,
                                                              jax_trees):
    port = create_train_state(_small(get_preset("reference"),
                                     init_type=init_type, init_gain=GAIN),
                              seed=3, device="cpu")
    base = create_train_state(_small(get_preset("reference")), seed=3,
                              device="cpu")
    for net_name, field in NETS:
        net, ref = getattr(port, net_name), getattr(base, net_name)
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      jax_trees[field])
        jax_leaves = {k: v.shape for k, v in flatten_tree(tree).items()
                      if k.endswith("/kernel") and v.ndim >= 2}
        theirs = state_from_flax(tree, module=net)
        kernels = list(jax_kernels(net))
        # the JAX tree's kernel leaves, one for one, at their flax shapes
        flax = {n: kernel_to_flax(p.detach(), owner)
                for n, p, owner in kernels}
        assert len(kernels) == len(jax_leaves) > 0
        assert set(flax) == {
            k for k in theirs if k.endswith((".weight", ".kernel"))}
        assert sorted(tuple(w.shape) for w in flax.values()) == sorted(
            jax_leaves.values())
        for name, p, owner in kernels:
            assert kernel_to_flax(theirs[name], owner).shape \
                == flax[name].shape
            check_law(flax[name].numpy(), init_type, GAIN, name)
        # everything but the kernels keeps the reference init
        for k, v in net.state_dict().items():
            if k not in flax:
                assert torch.equal(v, ref.state_dict()[k]), k


def test_jax_initializers_draw_by_the_same_law():
    draws = (("xavier", (3, 3, 8, 16)), ("kaiming", (3, 4, 4, 6, 8)),
             ("orthogonal", (2, 2, 4, 32)))
    drawn = jax.jit(lambda key: {(t, s): _kernel_initializer(t, GAIN)(
        jax.random.fold_in(key, i), s, jnp.float32)
        for i, (t, s) in enumerate(draws)})(jax.random.key(0))
    for (t, s), w in drawn.items():
        check_law(np.asarray(w), t, GAIN, f"jax {t} {s}")


def test_truncated_laws_ignore_the_gain_and_temporal_kernels_follow():
    cfgs = [_small(get_preset("reference"), init_type="kaiming",
                   init_gain=g) for g in (0.02, 1.0)]
    a, b = (create_train_state(c, seed=5, device="cpu") for c in cfgs)
    for net in ("net_g", "net_d", "net_c"):
        for (k, x), (_, y) in zip(getattr(a, net).state_dict().items(),
                                  getattr(b, net).state_dict().items()):
            assert torch.equal(x, y), k
    vid = get_preset("vid2vid_temporal")
    vid = vid.replace(
        model=dataclasses.replace(vid.model, ngf=8, ndf=8, num_D=2,
                                  n_layers_D=2, init_type="xavier"),
        data=dataclasses.replace(vid.data, image_size=16, n_frames=4))
    dt = create_video_train_state(vid, seed=1, device="cpu").net_dt
    kernels = list(jax_kernels(dt))
    assert kernels and all(p.dim() == 5 for _, p, _ in kernels)
    for name, p, owner in kernels:
        check_law(kernel_to_flax(p.detach(), owner).numpy(), "xavier", 0.0,
                  name)


def test_compression_autoencoder_matches_jax():
    """quant_bits 0 (the forward within 1e-4 of its largest output) and 3
    (the latent's 3-bit levels equal away from a rounding boundary), on
    one random parameter tree."""
    kw = dict(ngf=4, latent_channels=8, n_blocks=1)
    jm0, jm3 = JaxAE(**kw), JaxAE(quant_bits=3, **kw)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.2, s.shape).astype(np.float32),
        jax.eval_shape(jm0.init, jax.random.key(0), x)["params"])
    want, want_raw, want_q = map(np.asarray, jax.jit(lambda p, x: (
        jm0.apply({"params": p}, x),
        jm0.apply({"params": p}, x, method=jm0.encode),
        jm3.apply({"params": p}, x, method=jm3.encode)))(params, x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    t0 = load_flax(CompressionAutoencoder(**kw), params).eval()
    t3 = load_flax(CompressionAutoencoder(quant_bits=3, **kw), params).eval()
    with torch.no_grad():
        got, got_raw, got_q = t0(tx), t0.encode(tx), t3.encode(tx)
    assert tuple(got.shape) == (2, 3, 32, 32)
    assert tuple(got_raw.shape) == tuple(got_q.shape) == (2, 8, 2, 2)
    for g, w in ((got, want), (got_raw, want_raw)):
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), err
    level = 7 / (1 + np.exp(-want_raw.astype(np.float64)))
    away = np.abs(level - np.floor(level) - 0.5) > 1e-3
    assert away.mean() > 0.9
    np.testing.assert_array_equal(
        np.rint(got_q.permute(0, 2, 3, 1).numpy() * 7)[away],
        np.rint(want_q * 7)[away])
