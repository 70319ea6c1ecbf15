"""The port's ``pix2pixhd`` train step (the coarse-to-fine generator with
its 36 fused instance-norm epilogues on #1 + #3, the 3-scale spectral-norm
D, LSGAN + 10·FM + 10·VGG19, no net_c) against the JAX step on the CPU,
whose Pallas kernels run in interpret mode with their custom VJPs
(``P2P_TPU_FORCE_PALLAS=1``) and whose D takes split (input, output) pairs
as the preset asks (the port's D takes them concatenated: the same
function, held by ``test_split_stem_pair_path_equals_concat``).

One JAX state of the preset shrunk to ngf 8, ndf 8, 2 global residual
blocks (the 3 local ones stay: the JAX registry fixes them) at 128×256
(the global generator's 1/16 bottleneck holds 4×8 pixels), VGG on, f32,
is carried into the port by ``convert.load_train_state``; both packages
take 3 steps on the same synthetic street-scene batches
(``synthetic_hd_batch``, uint8).

Tolerances. Every loss at every step within 1e-4 relative, and the
step-1 gradients of G and D within 1e-5 abs + 1e-4 of the tensor's
largest |gradient|, as tests/test_torch_instance_train_step.py states
them, plus ``SENS_FACTOR`` = 3 times how far the port itself moves when
only its instance-norm statistics are summed in f64 instead of f32,
measured in the same run (``runs["sens"]``): for a loss, the largest
relative movement of any metric at that step; for a gradient tensor, its
own largest movement or the network's median movement relative to each
tensor's largest |gradient|, whichever is more. G's f32 gradient is
ill-conditioned at this state, not only at a small size: that change
alone moves it by 3e-3 to 1.1e-2 of a tensor's largest |gradient| at
128×256 (median 3.3e-3 to 5.3e-3), and so does running the port with
another number of torch threads (1 to 8: up to 1e-2 against JAX, 5.8e-3
at 8); the losses of steps 2 and 3, which Adam's sign-like first updates
build on it, move by up to 9e-4 relative. Against JAX the port needed at
most 1.86 of those movements on the losses and 1.13 on the gradients over
1 to 8 threads (a per-metric yardstick needed 18 at one thread: one
metric's own movement can be small by chance, hence the pooled ones). D's
gradients and step 1's losses do not move with the statistics (D's by
1e-7 of its largest at most), so they stay at the plain band (measured
against JAX: 2.8e-6, 1.6e-7). One bf16 step within 2e-2 relative. The
port's D on a concatenated pair against the JAX D on the split pair: f32,
1e-5 abs + 1e-5 rel (sums in another order).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.patchgan import (  # noqa: E402
    MultiscaleDiscriminator as JaxMultiscaleD)
from p2p_tpu_torch.convert import load_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_hd_batch  # noqa: E402
from p2p_tpu_torch.models.patchgan import MultiscaleDiscriminator  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.ops import instance_norm as seam  # noqa: E402
from p2p_tpu_torch.serve.engine import InferenceEngine  # noqa: E402
from p2p_tpu_torch.train.state import create_train_state  # noqa: E402
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402
from torch_step_parity import (  # noqa: E402
    assert_grads_close, assert_losses_close, jax_start, np_tree, run_both,
    run_port)

H, W = 128, 256
N_STEPS = 3
KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg")
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
SENS_FACTOR = 3.0
BF16_RTOL = 2e-2
STEM = dict(atol=1e-5, rtol=1e-5)


def _small(cfg, mixed=False):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=2),
        data=dataclasses.replace(cfg.data, image_size=H, image_width=W),
        train=dataclasses.replace(cfg.train, mixed_precision=mixed))


def _batches(n):
    return [synthetic_hd_batch(1, H, W, seed=i) for i in range(n)]


def _epilogues(n_global, n_local=3):
    """#1 + #3 epilogues of one Pix2PixHDGenerator forward: G1's stem, 4
    downsamples, 2 per block and 4 upsamples; G2's stem, downsample, 2 per
    local block and upsample."""
    return 1 + 4 + 2 * n_global + 4 + 2 + 2 * n_local + 1


@pytest.fixture(scope="module")
def start():
    return jax_start(_small(jax_preset("pix2pixhd")), _batches(1)[0])


def _stats_f64(x, eps=1e-5):
    """#1's statistics summed in f64 and rounded to f32 once."""
    x64 = x.double()
    mean = x64.mean(dim=(2, 3))
    var = (x64.square().mean(dim=(2, 3)) - mean.square()).clamp_min(0.0)
    return mean.float(), torch.rsqrt(var + eps).float()


@pytest.fixture(scope="module")
def runs(start):
    """Both steps, and how far the port moves when only its statistics
    change rounding (``sens``): per step, the largest relative movement of
    any metric; per step-1 gradient, the largest movement of its elements,
    and per network the median of those relative to each tensor's largest
    |gradient|."""
    tcfg, batches = _small(get_preset("pix2pixhd")), _batches(N_STEPS)
    out = run_both(_small(jax_preset("pix2pixhd")), tcfg, batches, KEYS,
                   start)
    with mock.patch.object(seam, "instance_norm_stats", _stats_f64):
        metrics, grads, _ = run_port(tcfg, batches, KEYS, start)
    moved = {net: {k: float((out["grads"][net][0][k] - g).abs().max())
                   for k, g in grads[net].items()} for net in grads}
    out["sens"] = {
        "losses": [max(abs(pm[k] - qm[k]) / abs(pm[k]) for k in KEYS)
                   for pm, qm in zip(out["port"], metrics)],
        "grads": moved,
        "median": {net: float(np.median([
            moved[net][k] / float(w.abs().max())
            for k, w in out["grads"][net][1].items()])) for net in grads}}
    return out


@pytest.mark.parametrize("i", range(N_STEPS))
def test_losses_track_the_jax_step(runs, i):
    jm = runs["jax"][i]
    slack = [{k: SENS_FACTOR * runs["sens"]["losses"][i] * abs(jm[k])
              for k in KEYS}]
    assert_losses_close({k: runs[k][i:i + 1] for k in ("jax", "port")},
                        KEYS, LOSS_RTOL, slack)


@pytest.mark.parametrize("net", ["g", "d"])
def test_step1_gradients_match_the_jax_step(runs, net):
    got, want = runs["grads"][net]
    moved, median = runs["sens"]["grads"][net], runs["sens"]["median"][net]
    slack = {k: SENS_FACTOR * max(moved[k], median * float(w.abs().max()))
             for k, w in want.items()}
    assert_grads_close(got, want, GRAD_ATOL, GRAD_RTOL, slack)


def test_bf16_step_matches_the_jax_bf16_step(start):
    got = run_both(_small(jax_preset("pix2pixhd")),
                   _small(get_preset("pix2pixhd")), _batches(1), KEYS, start,
                   jax_dtype=jnp.bfloat16, torch_dtype=torch.bfloat16)
    assert_losses_close(got, KEYS, BF16_RTOL)


def test_preset_trains_on_split_pairs_through_the_fused_epilogues():
    """The port's preset mirrors the JAX one (split pairs, 3 D scales, no
    TV, no net_c); one step runs 36 epilogues per G forward at full depth
    (22 here) through #1 + #3 and none through #2 (norm_d is "none")."""
    cfg = get_preset("pix2pixhd")
    m = cfg.model
    assert (m.split_d_pairs, m.num_D, m.norm, m.norm_d) == (
        True, 3, "pallas_instance", "none")
    assert not m.use_compression_net and cfg.loss.lambda_tv == 0
    assert _epilogues(m.n_blocks) == 36
    small = _small(cfg).replace(loss=dataclasses.replace(
        cfg.loss, lambda_vgg=0.0))
    ts = create_train_state(small, device="cpu")
    step = build_train_step(small)
    with mock.patch.object(seam, "instance_norm_apply",
                           wraps=seam.instance_norm_apply) as apply, \
            mock.patch.object(seam, "norm_act", wraps=seam.norm_act) as na:
        ts, m1 = step(ts, _batches(1)[0])
    assert (apply.call_count, na.call_count) == (0, _epilogues(2)) == (0, 22)
    assert float(m1["health_ok"]) == 1.0 and np.isfinite(float(m1["loss_g"]))
    assert float(m1["loss_c"]) == 0.0


def _d_loss(feats):
    return sum(f[-1].sum() for f in feats)


@pytest.fixture(scope="module")
def jax_split_d():
    """A small JAX multiscale D applied to a split (a, b) pair: its
    parameters, every scale's every tap and the gradient to b."""
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    jd = JaxMultiscaleD(ndf=8, n_layers=2, num_D=2, use_spectral_norm=False)
    params = jax.jit(jd.init)(jax.random.key(0),
                              jnp.concatenate([a, b], -1))

    def on_split(bb):
        feats = jd.apply(params, (a, bb))
        return _d_loss(feats), feats

    (_, feats), db = jax.jit(jax.value_and_grad(on_split, has_aux=True))(
        jnp.asarray(b))
    return a, b, np_tree(params["params"]), np_tree(feats), np.asarray(db)


@pytest.mark.parametrize("channels_last", [False, True])
def test_split_stem_pair_path_equals_concat(jax_split_d, channels_last):
    """The JAX D of the preset takes the unconcatenated (a, b) pair through
    its split stem (``_SplitStemConv``, the whole 6-channel kernel kept as
    one parameter); the port's D takes concat(a, b) with the same
    converted tree. Every scale's every tap agrees, and so does the
    gradient to b (the train step's route to G), with the port's module in
    either memory format (a train state holds it channels_last)."""
    a, b, params, want, want_db = jax_split_d
    d = load_flax(MultiscaleDiscriminator(6, ndf=8, n_layers=2, num_D=2,
                                          use_spectral_norm=False), params)
    assert tuple(d.scale1._PlainConv_0.conv.weight.shape) == (8, 6, 4, 4)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    d = d.to(memory_format=fmt)
    ta, tb = (torch.from_numpy(t).permute(0, 3, 1, 2).contiguous(
        memory_format=fmt) for t in (a, b))
    tb.requires_grad_()
    got = d(torch.cat([ta, tb], dim=1))
    _d_loss(got).backward()
    pairs = [(g, w) for fg, fw in zip(got, want) for g, w in zip(fg, fw)]
    assert len(pairs) == 2 * 4
    for g, w in pairs:
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   w, **STEM)
    np.testing.assert_allclose(tb.grad.permute(0, 2, 3, 1).numpy(), want_db,
                               **STEM)


def test_split_pairs_with_a_fake_pool_raise():
    """JAX refuses split pairs with the fake pool (the pool stores
    concatenated pairs); so does the port, whose preset sets split pairs
    although its D always takes them concatenated."""
    cfg = _small(get_preset("pix2pixhd"))
    assert cfg.model.split_d_pairs
    with pytest.raises(ValueError, match="split_d_pairs is incompatible"):
        build_train_step(cfg.replace(train=dataclasses.replace(
            cfg.train, pool_size=4)))


def test_serving_keeps_its_whole_model_cast_copy():
    """Training builds the generator with a compute dtype on f32 masters;
    the serving engine still serves pix2pixHD as a whole-model bf16 copy
    built without one (slice 1's route)."""
    cfg = _small(get_preset("pix2pixhd"))
    g = define_G(cfg.model, torch.bfloat16)
    assert g.ConvLayer_0.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in g.parameters())
    eng = InferenceEngine(cfg, define_G(cfg.model), buckets=(1,),
                          dtype="bf16", device="cpu")
    assert eng.model.ConvLayer_0.dtype is None
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())


def test_synthetic_hd_batch_has_the_preset_shape():
    b = synthetic_hd_batch(2, seed=3)
    assert b["input"].shape == b["target"].shape == (2, 512, 1024, 3)
    assert b["input"].dtype == np.uint8
    assert len(np.unique(b["input"].reshape(-1, 3), axis=0)) >= 4
    f = synthetic_hd_batch(1, H, W, seed=3, dtype="float32")
    assert f["input"].shape == (1, H, W, 3)
    assert -1.0 <= f["target"].min() and f["target"].max() <= 1.0
    np.testing.assert_array_equal(synthetic_hd_batch(1, H, W, seed=3)[
        "input"], synthetic_hd_batch(1, H, W, seed=3)["input"])
