"""Every windowed op of the spatial step and the sharded instance norms
(``p2p_tpu_torch/parallel/spatial.py``, ``ops/instance_norm.py``,
``ops/norm.py``) on 2 gloo ranks on the CPU, against the JAX op on the
whole map.

The ops are the ones ``pix2pixhd`` and ``cityscapes_spatial`` run on a
block of rows: the reflect-padded ``ConvLayer`` at k3 and k7, stride 1 and
2; the nearest ×2 ``UpsampleConvLayer``; the D's k4 zero-pad-2 convs at
stride 2 and 1, plain and spectral-normed; VGG19's k3 conv with its 2×2
max pool; ``avg_pool_downsample``; and the norms: #1–#3's route (the sums
entry, one all-reduce, the finalize with the global count, then #3 or #2;
their plain versions on the CPU), with relu, a residual, and a γ/β
affine, and the plain two-pass instance norm. Each on an even map
(16 rows: 8 a rank) and an uneven one (13 rows: 6 and 7), where the D's
convs give 7 and 8 rows (stride 2: H/2 + 1) and 14 (stride 1: H + 1).

The JAX side runs jitted over an input sharded along H on 2 fake CPU
devices (GSPMD inserts the exchanges, as in tests/test_parallel.py
``test_gspmd_stride2_conv_matches_unsharded``) on the even map, and on the
whole map unsharded on the uneven one (a jax.Array's shards are even);
the #1–#3 route is held
against ``sharded_pallas_instance_norm`` and ``sharded_pallas_instance_
norm_act`` in interpret mode on the even map and, since those step aside
on rows that do not split evenly (``p2p_tpu/ops/pallas/instance_norm.py:
129``), against the unsharded Pallas norms on the uneven one. The
spectral-normed convs are held against the port's own unsharded
``SpectralConv`` (its σ is per weight; the whole-map form is held against
JAX by tests/test_torch_reference_models.py). Bands: outputs and input
gradients within 2e-6 of the largest |value| of the reference (f32 sums
in another order), parameter gradients (summed over the ranks) within
1e-5 of theirs; the statistics all-reduces: one forward and one backward
per #1–#3 norm, none elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_spatial_worker as SW  # noqa: E402
from torch_dp_worker import spawn  # noqa: E402
from p2p_tpu.core.mesh import MeshSpec, make_mesh  # noqa: E402
from p2p_tpu.models.patchgan import avg_pool_downsample  # noqa: E402
from p2p_tpu.ops.conv import reflect_pad_2d, upsample_nearest  # noqa: E402
from p2p_tpu.ops.norm import InstanceNorm  # noqa: E402
from p2p_tpu.ops.pallas import instance_norm as jpin  # noqa: E402
from p2p_tpu.parallel import spatial as jsp  # noqa: E402

OUT_TOL = 2e-6      # of the reference's largest |value|
PARAM_TOL = 1e-5
SHAPES = {"even": (2, 4, 16, 10), "uneven": (1, 4, 13, 9)}
NORMS = ("norm_act", "norm_res", "norm_act_affine", "norm_fused_affine")
CONVS = {  # name: (kernel, stride, pad, edge)
    "conv_k3s1": (3, 1, 1, "reflect"), "conv_k7s1": (7, 1, 3, "reflect"),
    "conv_k3s2": (3, 2, 1, "reflect"), "upconv_k3": (3, 1, 1, "reflect"),
    "d_k4s2": (4, 2, 2, "zero"), "d_k4s1": (4, 1, 2, "zero"),
    "sn_k4s2": (4, 2, 2, "zero"), "sn_k4s1": (4, 1, 2, "zero"),
    "vgg_k3_pool": (3, 1, 1, "zero"),
}
OPS = tuple(SW.op_forms())


def _hwio(w):
    return jnp.asarray(w.numpy().transpose(2, 3, 1, 0))


def _conv(x, w, b, k, s, p, edge):
    if edge == "reflect":
        x = reflect_pad_2d(x, p)
        pad = "VALID"
    else:
        pad = [(p, p), (p, p)]
    dn = lax.conv_dimension_numbers(x.shape, w.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(x, w, (s, s), pad,
                                    dimension_numbers=dn) + b


def _jax_op(name, mesh, even):
    """``f(x, w, b) -> y`` of ``name`` on NHWC; ``w`` HWIO."""
    if name in CONVS:
        k, s, p, edge = CONVS[name]

        def f(x, w, b):
            if name == "upconv_k3":
                x = upsample_nearest(x, 2)
            y = _conv(x, w, b, k, s, p, edge)
            if name == "vgg_k3_pool":
                y = lax.reduce_window(jnp.maximum(y, 0), -jnp.inf, lax.max,
                                      (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
            return y
        return f
    if name == "avg_pool":
        return lambda x, w, b: avg_pool_downsample(x)
    if name == "norm_plain":
        return lambda x, w, b: InstanceNorm().apply({}, x)
    c = SHAPES["even"][1]

    def affine(w, b):
        return 1.0 + 0.1 * w.reshape(-1)[:c], b[:c]

    if name == "norm_fused_affine":
        if even:
            return lambda x, w, b: jpin.sharded_pallas_instance_norm(
                x, *affine(w, b), 1e-5, mesh, interpret=True)
        return lambda x, w, b: jpin.pallas_instance_norm(
            x, *affine(w, b), force_pallas=True, interpret=True)
    args = {"norm_act": lambda x, w, b: (None, None, None, "relu"),
            "norm_res": lambda x, w, b: (None, None, 0.5 * x, "none"),
            "norm_act_affine": lambda x, w, b: (*affine(w, b), None,
                                                "leaky")}[name]

    def f(x, w, b):
        s, bb, r, act = args(x, w, b)
        if even:
            return jpin.sharded_pallas_instance_norm_act(
                x, s, bb, r, act, 0.2, 1e-5, mesh, interpret=True)
        return jpin.pallas_instance_norm_act(
            x, s, bb, r, act, 0.2, force_pallas=True, interpret=True)
    return f


def _case(name, shape, seed):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    k = CONVS.get(name, (3,))[0]
    cout = 5 if name in CONVS else c
    case = {"x": rng.standard_normal(shape).astype(np.float32),
            "w": (rng.standard_normal((cout, c, k, k)) * 0.2).astype(
                np.float32),
            "b": rng.standard_normal(cout).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in case.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references (forward and VJP of every op at both shapes) and
    the 2 ranks' results of the same inputs and cotangents."""
    tmp = tmp_path_factory.mktemp("spatial_ops")
    mesh = make_mesh(MeshSpec(data=1, spatial=2), devices=jax.devices()[:2])
    mesh_s = Mesh(np.asarray(jax.devices()[:2]), ("spatial",))
    h_sharded = NamedSharding(mesh, P(None, "spatial", None, None))
    cases, refs = {}, {}
    for seed, name in enumerate(OPS):
        for kind, shape in SHAPES.items():
            key = f"{name}@{kind}"
            case = _case(name, shape, seed)
            if name.startswith("sn_"):
                y, dx, dps = _port_whole(name, case)
            else:
                f = _jax_op(name, mesh, kind == "even")
                x = jnp.asarray(case["x"].numpy().transpose(0, 2, 3, 1))
                if kind == "even":
                    x = jax.device_put(x, h_sharded)
                w = (_hwio(case["w"]) if name in CONVS
                     else jnp.asarray(case["w"].numpy()))
                b = jnp.asarray(case["b"].numpy())

                @jax.jit
                def fwd_vjp(x, w, b, g, f=f):
                    y, vjp = jax.vjp(f, x, w, b)
                    return (y,) + vjp(g)

                y0 = jax.eval_shape(f, x, w, b)
                rng = np.random.default_rng(1000 + seed)
                g = rng.standard_normal(y0.shape).astype(np.float32)
                y, dx, dw, db = (np.array(t) for t in fwd_vjp(
                    x, w, b, jnp.asarray(g)))
                y, dx = y.transpose(0, 3, 1, 2), dx.transpose(0, 3, 1, 2)
                dps = _jax_param_grads(name, dw, db)
                case["g"] = torch.from_numpy(np.ascontiguousarray(
                    g.transpose(0, 3, 1, 2)))
            if "g" not in case:
                case["g"] = torch.from_numpy(np.random.default_rng(
                    1000 + seed).standard_normal(y.shape).astype(np.float32))
                y, dx, dps = _port_whole(name, case)
            cases[key] = case
            refs[key] = (np.asarray(y), np.asarray(dx), dps)
    torch.save(cases, tmp / "ops.pt")
    rng = np.random.default_rng(99)
    conv = {"x": torch.from_numpy(rng.standard_normal((2, 4, 16, 10))
                                  .astype(np.float32)),
            "w": torch.from_numpy((rng.standard_normal((5, 4, 3, 3)) * 0.2)
                                  .astype(np.float32))}
    torch.save(conv, tmp / "sharded_conv.pt")
    refs["sharded_conv"] = {
        mode: np.array(jsp.make_sharded_conv(mesh_s, edge_mode=mode)(
            jnp.asarray(conv["x"].numpy().transpose(0, 2, 3, 1)),
            _hwio(conv["w"]))).transpose(0, 3, 1, 2)
        for mode in ("reflect", "zero")}
    return refs, spawn("op_checks", 2, str(tmp), str(tmp),
                       module="torch_spatial_worker")


def _jax_param_grads(name, dw, db):
    """The JAX parameter gradients in the port's layouts (OIHW kernels;
    γ's gradient through ``1 + 0.1·w``)."""
    if name in CONVS:
        return [dw.transpose(3, 2, 0, 1), db]
    if name in ("norm_act_affine", "norm_fused_affine"):
        c = SHAPES["even"][1]
        return [dw.reshape(-1)[:c] / 0.1, db[:c]]
    return []


def _port_whole(name, case):
    """The port's op on the whole map (no mesh): y, dx and the parameter
    gradients for ``case["g"]`` (a cotangent drawn when it has none)."""
    x = case["x"].contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y, params = SW.op_forms()[name](x, case["w"], case["b"])
    if "g" not in case:
        return y.detach(), None, None
    (y.float() * case["g"]).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(),
            [p.grad.numpy() for p in params])


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("name", OPS)
def test_sharded_op_matches_the_whole_map(runs, name, kind):
    refs, res = runs
    key = f"{name}@{kind}"
    y, dx, dps = refs[key]
    parts = [r[key] for r in res]
    # each output row has one owner: the rows tile the whole map
    assert [p["rows"] for p in parts] == [
        (0, parts[0]["rows"][1]), (parts[0]["rows"][1], y.shape[2])]
    got_y = torch.cat([p["y"].float() for p in parts], dim=2).numpy()
    got_dx = torch.cat([p["dx"] for p in parts], dim=2).numpy()
    assert got_y.shape == y.shape
    _close(got_y, y, OUT_TOL, "y")
    _close(got_dx, dx, OUT_TOL, "dx")
    assert len(parts[0]["dp"]) == len(dps)
    for i, want in enumerate(dps):
        got = sum(p["dp"][i] for p in parts).numpy()
        _close(got, np.asarray(want), PARAM_TOL, f"param {i}")
    want_ar = (1, 1) if name in NORMS else (0, 0)
    assert all(p["allreduces"] == want_ar for p in parts), name


@pytest.mark.parametrize("mode", ["reflect", "zero"])
def test_make_sharded_conv_is_jax(runs, mode):
    """The port's ``make_sharded_conv`` (one symmetric exchange, a local
    VALID conv, the blocks gathered) on 2 ranks against the JAX one under
    ``shard_map`` on 2 fake devices: within 2e-6 of the largest |value|
    (tests/test_parallel.py holds the JAX one bitwise its unsharded
    conv)."""
    refs, res = runs
    want = refs["sharded_conv"][mode]
    for r in res:
        _close(r["sharded_conv"][mode].numpy(), want, OUT_TOL, mode)


@pytest.mark.parametrize("h,spatial,downs", [(512, 2, 5), (256, 2, 2),
                                             (64, 4, 5), (96, 4, 3)])
def test_check_spatial_divisible_is_jax(h, spatial, downs):
    """The JAX divisibility rule of the generator's deepest map, with its
    message, on a mesh of that spatial width."""
    from p2p_tpu_torch.parallel.spatial import check_spatial_divisible

    class _Shape:
        shape = {"spatial": spatial}

    try:
        jsp.check_spatial_divisible(h, _Shape(), downs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            check_spatial_divisible(h, _Shape(), downs)
        assert str(got.value) == str(e)
        return
    check_spatial_divisible(h, _Shape(), downs)
