"""The int8 networks of the port (``p2p_tpu_torch/models``) against the JAX
package's on the CPU, at 32² (the U-Net at 16², 4 levels; pix2pixHD at
64×128, its smallest), ngf and ndf 8, one block: the U-Net with its int8 encoder, stem and decoder, the
ExpandNetwork, ResNet and pix2pixHD int8 trunks, net_c, and a 2-scale
spectral-norm D with ``int8_stem``, ``int8_head`` (the kn2row head) and
the quantize-fused epilogue (``norm_d="instance"``: the reference
epilogue; the kernels' route is held elsewhere), all with stored scales
(``int8_delayed``).

Each JAX network is initialized as ``create_train_state`` does it
(``init_variables``; G and net_c on the input in eval mode), and the
port's copy takes its parameters, statistics and scales (convert.py).
Then one forward of each side on the same input and the gradient of
``Σ out·g`` for fixed cotangents ``g``: the outputs and the input and
parameter gradients, and for D, whose forward trains, its updated ``u``
and scales. G and net_c run as the JAX init runs them, in eval mode
(BatchNorm on its running statistics, scales frozen): in training mode
the U-Net's BatchNorm normalizes 4 values at its 2×2 levels at this size,
which turns a q flip at a rounding tie into a visible output change, so
their training-mode scale updates are held by the whole-step test
(tests/test_torch_int8_full_step.py). Also the stored-scale init against
flax init's (``init_amax`` from zeroed scales, G and net_c on the input
in eval mode, D on the pair in training mode), and the frozen-scale eval
forward, which leaves every ``amax_x`` (and D's ``u``) bitwise and equals
the JAX forward with every collection read-only. pix2pixHD runs without
norms (the port's ResNet family takes no BatchNorm; instance norm at G1's
2×4 bottleneck moves JAX's own jitted forward from its eager one by 0.85%
of the largest output).

Bands. The int8 products are exact on both sides, but the f32 convs,
norms and sums around them run in another order, which moves a value in
its last bits and can move a quantized one by one step at a rounding tie
(each such flip moves a conv output by one quantum). Measured here: the
outputs within 1.1e-6 of their largest entry (pix2pixHD's, whose output
is below 2e-3, within 3.6e-5), the gradients within 4.8e-4 of each
tensor's largest entry, the scales within 1e-6 relative. The bands:
``OUT_RTOL_OF_MAX`` 1e-5 (pix2pixHD 1e-4), ``GRAD_RTOL_OF_MAX`` 1e-3,
``STATS_ATOL`` 1e-5, ``AMAX_RTOL`` 1e-5. D's inner conv biases sit in
front of instance norms, which cancel their gradient: rounding noise of
random sign on both sides, held below 1e-3 of D's largest gradient.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models import registry as jreg  # noqa: E402
from p2p_tpu_torch.convert import load_flax, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.models import registry as treg  # noqa: E402
from p2p_tpu_torch.ops.int8 import quant_modules, stored_scales  # noqa: E402
from p2p_tpu_torch.train.state import init_amax  # noqa: E402
from torch_step_parity import INIT_COMPILE as FAST_COMPILE  # noqa: E402

OUT_RTOL_OF_MAX = 1e-5
GRAD_RTOL_OF_MAX = 1e-3
STATS_ATOL = 1e-5
AMAX_RTOL = 1e-5
# pix2pixHD without norms: (outputs, gradients, scales), see the module
# docstring
HD_BANDS = (1e-4, GRAD_RTOL_OF_MAX, AMAX_RTOL)
# D's inner conv biases in front of its instance norms: their gradient
# is cancelled, rounding noise of random sign on both sides
CANCELLED_OF_LARGEST = 1e-3
Q = dict(int8=True, int8_delayed=True)

# name: (preset, model overrides, net, (H, W), input channels)
CASES = {
    "unet": ("facades_int8_full", dict(use_dropout=False, int8_stem=True),
             "G", (16, 16), 3),
    "expand": ("reference", dict(int8_generator=True, **Q), "G", (32, 32),
               3),
    "resnet": ("cityscapes_spatial", dict(int8_generator=True, **Q), "G",
               (32, 32), 3),
    "pix2pixhd": ("pix2pixhd", dict(int8_generator=True, norm="none",
                                    **Q), "G", (64, 128), 3),
    "net_c": ("reference", dict(int8_compression=True, **Q), "C",
              (32, 32), 3),
    "d": ("reference", dict(num_D=2, int8_stem=True, int8_head=True,
                            int8_fused_epilogue=True, norm_d="instance",
                            **Q), "D", (32, 32), 6),
}


def _model(preset, over):
    base = dict(ngf=8, ndf=8, n_blocks=1)
    return (dataclasses.replace(jax_preset(preset).model, **base, **over),
            dataclasses.replace(get_preset(preset).model, **base, **over))


def _t4(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _n4(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _within(got, want, rtol_of_max, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rtol_of_max * float(np.abs(want).max()), (what, err)


def _leaves_t(out):
    return [out] if isinstance(out, torch.Tensor) else [
        t for scale in out for t in scale]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both sides of one network: the JAX init, one training forward with
    its updates and gradients, the eval forward; the port's network
    loaded from the JAX init, and the same on its side."""
    name = request.param
    preset, over, kind, (h, w), cin = CASES[name]
    jm, tm = _model(preset, over)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, h, w, cin)).astype(np.float32)
    jnet = {"G": jreg.define_G, "C": jreg.define_C,
            "D": jreg.define_D}[kind](jm)
    # G and net_c in eval mode (train=False), D in training mode, whose
    # forward advances u and the scales
    kw = {} if kind == "D" else {"train": False}
    colls = ["quant", "spectral"] if kind == "D" else False
    out_shapes = jax.eval_shape(
        lambda k, a: jnet.apply(jnet.init(k, a, **kw), a, **kw,
                                mutable=colls),
        jax.random.key(0), x)
    if colls:
        out_shapes = out_shapes[0]
    gs = [rng.normal(size=s.shape).astype(np.float32)
          for s in jax.tree_util.tree_leaves(out_shapes)]

    def run(key, a):
        v = jreg.init_variables(jnet, key, a, **kw)
        rest = {k: t for k, t in v.items() if k != "params"}

        def loss(p, a):
            out = jnet.apply({"params": p, **rest}, a, **kw, mutable=colls)
            out, upd = out if colls else (out, {})
            s = sum(jnp.sum(o.astype(jnp.float32) * g) for o, g in
                    zip(jax.tree_util.tree_leaves(out), gs))
            return s, (out, upd)

        (_, (out, upd)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(v["params"], a)
        init_quant = v["quant"]
        if kind == "D":
            # the scales flax init makes from the stored u (init itself
            # draws u and then advances it)
            init_quant = jnet.apply(
                {k: t for k, t in v.items() if k != "quant"}, a,
                mutable=["quant", "spectral"])[1]["quant"]
        return v, out, upd, grads, init_quant

    key = jax.random.key(0)
    v, out, upd, (dp, dx), init_quant = _np(jax.jit(run).lower(
        key, x).compile(compiler_options=FAST_COMPILE)(key, x))
    build = {"G": lambda: treg.define_G(tm, None, (h, w)),
             "C": lambda: treg.define_C(tm), "D": lambda: treg.define_D(tm)}
    net = load_flax(build[kind](), *v.values()).to(
        memory_format=torch.channels_last)
    return dict(name=name, kind=kind, x=x, gs=gs, v=v, out=out, upd=upd, init_quant=init_quant,
                dp=dp, dx=dx, net=net, build=build[kind])


def _bands(case):
    if case["name"] == "pix2pixhd":
        return HD_BANDS
    return OUT_RTOL_OF_MAX, GRAD_RTOL_OF_MAX, AMAX_RTOL


def _cancelled(case, k):
    return case["kind"] == "D" and k.endswith("bias") and \
        "SpectralConv_" in k


def test_training_forward_and_gradients_match_jax(case):
    """The forward and the gradients: D in training mode (with its
    updated ``u`` and scales), G and net_c as the JAX init runs them
    (eval mode: normalized by running statistics, scales frozen)."""
    out_band, grad_band, amax_band = _bands(case)
    net = case["net"].train(case["kind"] == "D")
    assert quant_modules(net), case["name"]
    xt = _t4(case["x"]).requires_grad_()
    leaves = _leaves_t(net(xt))
    sum((t.float() * _t4(g)).sum() for t, g in zip(leaves, case["gs"])
        ).backward()
    for i, (t, want) in enumerate(zip(
            leaves, jax.tree_util.tree_leaves(case["out"]))):
        _within(_n4(t), want, out_band, ("out", i))
    _within(_n4(xt.grad), case["dx"], grad_band, "dx")
    want = state_from_flax(case["dp"], module=net)
    largest = max(float(t.abs().max()) for t in want.values())
    for k, p in net.named_parameters():
        if _cancelled(case, k):
            for t in (p.grad, want[k]):
                assert float(t.abs().max()) <= CANCELLED_OF_LARGEST * largest
        else:
            _within(p.grad.numpy(), want[k].numpy(), grad_band, k)
    upd = state_from_flax(*case["upd"].values(), module=net)
    got = net.state_dict()
    for k, t in upd.items():
        if k.endswith("amax_x"):
            assert float(got[k]) == pytest.approx(float(t), rel=amax_band), k
        elif k.endswith(("mean", "var", "u")):
            np.testing.assert_allclose(got[k].numpy(), t.numpy(),
                                       atol=STATS_ATOL, rtol=0, err_msg=k)


def test_stored_scale_init_matches_the_jax_init(case):
    """``init_amax`` from zeroed scales on the port's copy of the JAX
    init reproduces the JAX init's ``quant`` (G and net_c on the input in
    eval mode, D in training mode)."""
    net = load_flax(case["build"](), *case["v"].values()).to(
        memory_format=torch.channels_last)
    for s in stored_scales(net):
        s.zero_()
    init_amax(net, _t4(case["x"]), train=case["kind"] == "D")
    want = state_from_flax(case["init_quant"], module=net)
    got = {k: float(t) for k, t in net.state_dict().items()
           if k.endswith("amax_x")}
    assert set(got) == set(want) and got
    for k, w in want.items():
        assert got[k] == pytest.approx(float(w), rel=_bands(case)[2]), k


def test_eval_reads_the_scales_frozen_and_matches_jax(case):
    """Eval mode writes no scale (nor D's ``u``) and equals the JAX
    forward with every collection read-only: G's and net_c's eval forward
    above, and D's, whose values a read-only forward reproduces (it reads
    the same stored ``u`` and scales, and only stores nothing)."""
    net = load_flax(case["build"](), *case["v"].values()).to(
        memory_format=torch.channels_last).eval()
    before = {k: t.clone() for k, t in net.named_buffers()
              if k.endswith(("amax_x", "u"))}
    with torch.no_grad():
        leaves = _leaves_t(net(_t4(case["x"])))
        net(_t4(3.0 * case["x"]))
    for k, t in net.named_buffers():
        if k in before:
            assert torch.equal(t, before[k]), k
    for i, (t, want) in enumerate(zip(
            leaves, jax.tree_util.tree_leaves(case["out"]))):
        _within(_n4(t), want, _bands(case)[0], ("eval", i))
