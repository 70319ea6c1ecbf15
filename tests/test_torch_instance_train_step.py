"""The port's train step with ``pallas_instance`` norms in G and D (the
``reference`` preset with ``norm="pallas_instance", norm_d=
"pallas_instance"``: kernels #1 + #2 at the ExpandNetwork's six plain
norms, #1 + #3 at its residual-block and D epilogues) against the JAX step
on the CPU, whose Pallas kernels run in interpret mode with their custom
VJPs (``P2P_TPU_FORCE_PALLAS=1``).

One JAX state of the preset shrunk to ngf 8, ndf 8, 2 residual blocks at
32², VGG on, f32, is carried into the port by ``convert.load_train_state``
(the ExpandNetwork holds no norm parameters here; only net_c's BatchNorm
does); both packages take 3 steps on the same synthetic batches.

Tolerances: every loss within 1e-4 relative at every step (measured:
1.5e-6; step 1 differs by f32 sums taken in another order, and Adam's
sign-like first updates move each weight by about ±lr on both sides
alike). The step-1 gradients of G and D (read from Adam's first moment,
0.5·g on both sides) within 1e-5 abs + 1e-4 of the tensor's largest
|gradient|: each element is a sum over pixels (and, for G, through D, VGG
and the feature-matching taps) taken in another order on each side, so
its rounding scales with the magnitude of the tensor's gradients, not
with the element's own (measured: 2.0e-5 of the largest in G, 2.5e-6 in
D; an element near 0 in a tensor whose gradients reach 8 is off by up to
1.2e-4). One bf16 step of both within 2e-2 relative, the band of
tests/test_torch_train_step.py (bf16 rounds at other points inside an op
on each side).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.ops import instance_norm as seam  # noqa: E402
from p2p_tpu_torch.ops import norm  # noqa: E402
from p2p_tpu_torch.train.state import (  # noqa: E402
    create_train_state, load_vgg19)
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402
from torch_step_parity import (  # noqa: E402
    assert_grads_close, assert_losses_close, jax_start, run_both)

N_STEPS = 3
KEYS = ("loss_g", "loss_d", "loss_c", "g_gan", "g_feat", "g_vgg", "g_tv")
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_RTOL = 2e-2


def _instance(cfg):
    return cfg.replace(model=dataclasses.replace(
        cfg.model, norm="pallas_instance", norm_d="pallas_instance"))


def _small(cfg, mixed=False):
    cfg = _instance(cfg)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=2),
        data=dataclasses.replace(cfg.data, image_size=32),
        train=dataclasses.replace(cfg.train, mixed_precision=mixed))


def _batches(n):
    return [synthetic_batch(1, 32, seed=i) for i in range(n)]


@pytest.fixture(scope="module")
def start():
    return jax_start(_small(jax_preset("reference")), _batches(1)[0])


@pytest.fixture(scope="module")
def runs(start):
    return run_both(_small(jax_preset("reference")),
                    _small(get_preset("reference")), _batches(N_STEPS), KEYS,
                    start)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_losses_track_the_jax_step(runs, i):
    assert_losses_close({k: runs[k][i:i + 1] for k in ("jax", "port")},
                        KEYS, LOSS_RTOL)


@pytest.mark.parametrize("net", ["g", "d"])
def test_step1_gradients_match_the_jax_step(runs, net):
    got, want = runs["grads"][net]
    assert_grads_close(got, want, GRAD_ATOL, GRAD_RTOL)


def test_bf16_step_matches_the_jax_bf16_step(start):
    got = run_both(_small(jax_preset("reference")),
                   _small(get_preset("reference")), _batches(1), KEYS, start,
                   jax_dtype=jnp.bfloat16, torch_dtype=torch.bfloat16)
    assert_losses_close(got, KEYS, BF16_RTOL)


def test_expand_network_builds_six_norm_and_eighteen_epilogue_sites():
    """At full width: the k9 stem, two downsamples, two upsamples and the
    head take #1 + #2; both epilogues of the 9 residual blocks #1 + #3;
    none of them holds a parameter (the JAX ``PallasInstanceNorm`` has
    ``affine=False``)."""
    g = define_G(_instance(get_preset("reference")).model)
    norms = [getattr(g, f"BatchNorm_{i}") for i in range(6)]
    assert all(fn is seam.instance_norm_fused for fn in norms)
    x = torch.zeros((1, 128, 4, 4))
    epilogues = [getattr(getattr(g, f"ResidualBlock_{i}"), f"BatchNorm_{j}")
                 for i in range(9) for j in range(2)]
    assert len(epilogues) == 18
    for na in epilogues:
        y = na(x.clone().requires_grad_(), act="relu", residual=x)
        assert isinstance(y.grad_fn, seam._InstanceNormAct._backward_cls)
    assert not [n for n, _ in g.named_parameters() if "BatchNorm" in n]


def test_every_pallas_instance_site_goes_through_the_two_functions():
    """Per step: G runs twice (the G step and the net_c branch), each with
    6 #2 sites and 2·n_blocks #3 epilogues; D runs twice (fake, real) with
    num_D·n_layers_D = 9 leaky #3 epilogues; #1 runs before each; net_c's
    one BatchNorm takes #5 twice. On the CPU the wrappers take their plain
    versions and count no launch."""
    cfg = _small(get_preset("reference"))
    ts = create_train_state(cfg, device="cpu")
    step = build_train_step(cfg, load_vgg19(device="cpu"))
    nb = cfg.model.n_blocks
    d_sites = cfg.model.num_D * cfg.model.n_layers_D
    wrappers = (seam.instance_norm_stats, seam.instance_norm_apply,
                seam.norm_act)
    launches = [fn.launches for fn in wrappers]
    with mock.patch.object(seam, "instance_norm_stats",
                           wraps=seam.instance_norm_stats) as stats, \
            mock.patch.object(seam, "instance_norm_apply",
                              wraps=seam.instance_norm_apply) as apply, \
            mock.patch.object(seam, "norm_act", wraps=seam.norm_act) as na, \
            mock.patch.object(norm, "batch_moments",
                              wraps=norm.batch_moments) as moments:
        _, m = step(ts, synthetic_batch(1, 32, seed=0))
    assert np.isfinite(float(m["loss_g"]))
    assert apply.call_count == 2 * 6 == 12
    assert na.call_count == 2 * 2 * nb + 2 * d_sites == 26
    assert stats.call_count == apply.call_count + na.call_count
    assert moments.call_count == 2
    assert [fn.launches for fn in wrappers] == launches
    # at the full preset: 12 #2, 2·18 + 18 = 54 #3, 66 #1 per step
    full = _instance(get_preset("reference")).model
    assert 2 * 2 * full.n_blocks + 2 * full.num_D * full.n_layers_D == 54


def test_step_refuses_norms_the_port_does_not_have():
    cfg = _small(get_preset("reference"))
    with pytest.raises(ValueError, match="norm_d 'batch'"):
        build_train_step(cfg.replace(model=dataclasses.replace(
            cfg.model, norm_d="batch")))
    with pytest.raises(ValueError, match="norm_d.*stateless"):
        create_train_state(cfg.replace(model=dataclasses.replace(
            cfg.model, norm_d="batch")), device="cpu")
    with pytest.raises(ValueError, match="norm 'group'"):
        build_train_step(cfg.replace(model=dataclasses.replace(
            cfg.model, norm="group")))
