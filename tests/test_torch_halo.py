"""The port's halo exchange (``p2p_tpu_torch/parallel/halo.py``) on 2 and 4
gloo ranks on the CPU, against the JAX ``halo_exchange`` and
``ring_shift`` under ``shard_map`` on as many fake CPU devices, and its
adjoint against autograd of the whole tensor padded and cut into the
ranks' windows.

Every edge mode (reflect, zero, wrap), both transports (``"p2p"``:
``batch_isend_irecv``; ``"slot"``: one ``all_reduce`` of a zeroed buffer
summed as integer words, the route of CUDA tensors under gloo) and halos
of 1 and 2 rows, on 4 rows a rank of an (2, 4·W, 5, 3) NHWC array split
along dim 1. The exchange moves rows and adds gradients in a fixed order,
so the forward is bitwise and the adjoint within 1e-6 of the largest
|gradient| (f32 sums in another order than autograd's). At 4 ranks the
same spawn holds sync-BatchNorm over data=2 × spatial=2 (the moments of
each rank's sample rows and image rows, one all-reduce over the world)
against JAX's ``BatchNorm`` on the global batch, at tests/
test_torch_batch_moments.py's tolerances. Each rank runs one torch
thread (tests/torch_dp_worker.py ``spawn``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import torch_spatial_worker as SW  # noqa: E402
from torch_dp_worker import spawn  # noqa: E402
from p2p_tpu.core.mesh import shard_map_compat as shard_map  # noqa: E402
from p2p_tpu.ops.norm import BatchNorm as JaxBatchNorm  # noqa: E402
from p2p_tpu.parallel import halo_exchange, ring_shift  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402

ROWS = 4            # rows a rank
ADJOINT_TOL = 1e-6  # of the largest |gradient|
# tests/test_torch_dp.py's sync-BatchNorm tolerances
BN_TOL = dict(rtol=1e-4, atol=1e-5)
AFFINE_TOL = dict(rtol=1e-4, atol=5e-4)
BN_SHAPE = (4, 6, 5, 8)     # NHWC: 2 samples a slot, 3 rows a rank

PAD_MODES = {"reflect": "reflect", "zero": "constant", "wrap": "circular"}


def _inputs(world, tmp):
    rng = np.random.default_rng(world)
    x = rng.standard_normal((2, ROWS * world, 5, 3)).astype(np.float32)
    saved = {"x": torch.from_numpy(x),
             "g0": torch.from_numpy(rng.standard_normal(x.shape).astype(
                 np.float32))}
    for halo in SW.HALOS:
        shape = (2, world * (ROWS + 2 * halo), 5, 3)
        saved[f"g{halo}"] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    torch.save(saved, tmp / "halo.pt")
    bn = None
    if world == 4:
        bn = _bn_inputs()
        x, g, v = bn
        torch.save({"x": _nchw(x), "g": _nchw(g),
                    "bn": state_from_flax(jax.tree_util.tree_map(
                        np.asarray, v)["params"]["BatchNorm_0"]) | {
                        k: t for k, t in state_from_flax(
                            v["batch_stats"]["BatchNorm_0"]).items()}},
                   tmp / "bn.pt")
    return saved, bn


def _bn_inputs():
    """The global (x, g) of the sync-BatchNorm check (NHWC) and the flax
    variables: running mean away from 0, γ away from 1, channel 0 at mean
    40 with a spread of 1 (as tests/test_torch_dp.py)."""
    rng = np.random.default_rng(11)
    c = BN_SHAPE[-1]
    mean, spread = rng.uniform(-2, 2, c), rng.uniform(0.1, 3, c)
    mean[0], spread[0] = 40.0, 1.0
    x = (rng.normal(size=BN_SHAPE) * spread + mean).astype(np.float32)
    g = rng.normal(size=BN_SHAPE).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, JaxBatchNorm().init(
        jax.random.key(0), jnp.asarray(x)))
    running = np.linspace(-1, 1, c).astype(np.float32)
    running[0] = 39.9
    v["batch_stats"]["BatchNorm_0"]["mean"] = running
    v["params"]["BatchNorm_0"]["scale"] = np.linspace(
        0.5, 1.5, c).astype(np.float32)
    return x, g, v


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _jax_halo(x, world, mode, halo):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("s",))
    fn = shard_map(functools.partial(halo_exchange, dim=1, halo=halo,
                                     axis_name="s", edge_mode=mode),
                   mesh=mesh, in_specs=P(None, "s", None, None),
                   out_specs=P(None, "s", None, None), check_vma=False)
    return np.array(jax.jit(fn)(jnp.asarray(x)))


def _windows(x, world, mode, halo):
    """Every rank's window of the whole tensor padded along dim 1, in rank
    order (the exchange's output, whole)."""
    t = x.permute(0, 3, 1, 2)       # rows on dim 2 for F.pad
    if mode == "zero":
        padded = F.pad(t, (0, 0, halo, halo))
    else:
        padded = F.pad(t, (0, 0, halo, halo), mode=PAD_MODES[mode])
    padded = padded.permute(0, 2, 3, 1)
    return torch.cat([padded[:, r * ROWS:r * ROWS + ROWS + 2 * halo]
                      for r in range(world)], dim=1)


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """One spawn of 2 ranks and one of 4, with their inputs."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"halo{world}")
        saved, bn = _inputs(world, tmp)
        out[world] = (world, saved, bn,
                      spawn("halo_checks", world, str(tmp), str(tmp),
                            module="torch_spatial_worker"))
    return out


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, spawns):
    return spawns[request.param]


@pytest.mark.parametrize("halo", SW.HALOS)
@pytest.mark.parametrize("route", SW.ROUTES)
@pytest.mark.parametrize("mode", SW.EDGE_MODES)
def test_halo_exchange_matches_jax_and_its_adjoint(ranks, mode, route,
                                                   halo):
    world, saved, _, res = ranks
    x = saved["x"]
    got = torch.cat([r[mode, route, halo][0] for r in res], dim=1)
    want = _jax_halo(x.numpy(), world, mode, halo)
    assert torch.equal(got, torch.from_numpy(want))
    # the adjoint: autograd of the padded whole tensor cut into windows
    xw = x.clone().requires_grad_(True)
    (_windows(xw, world, mode, halo) * saved[f"g{halo}"]).sum().backward()
    dx = torch.cat([r[mode, route, halo][1] for r in res], dim=1)
    err = float((dx - xw.grad).abs().max())
    assert err <= ADJOINT_TOL * float(xw.grad.abs().max()), err
    # each rank counted its forward and adjoint exchange on its route
    for r in res:
        stats = r[mode, route, halo][2]
        assert stats[route]["calls"] == 2, stats
        other = [k for k in SW.ROUTES if k != route][0]
        assert stats[other]["calls"] == 0, stats


def test_ring_shift_matches_jax_both_routes(ranks):
    world, saved, _, res = ranks
    x = saved["x"]
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("t",))
    fn = shard_map(functools.partial(ring_shift, axis_name="t", shift=1),
                   mesh=mesh, in_specs=P(None, "t", None, None),
                   out_specs=P(None, "t", None, None), check_vma=False)
    want = torch.from_numpy(np.array(jax.jit(fn)(jnp.asarray(x))))
    assert torch.equal(torch.cat([r["ring"][0] for r in res], dim=1), want)
    assert torch.equal(torch.cat([r["ring_slot"] for r in res], dim=1), want)
    # its adjoint shifts the cotangent back
    back = torch.cat([r["ring"][1] for r in res], dim=1)
    assert torch.equal(back, torch.roll(saved["g0"], -ROWS, dims=1))


def test_sync_batchnorm_over_data_and_spatial_is_jax(spawns):
    """BatchNorm on each rank's sample rows (its batch slot) and image rows
    (its spatial block), its moments summed over the world with the row
    counts: the output, input and parameter gradients and the running
    statistics of JAX's BatchNorm on the global batch."""
    _, _, bn, res = spawns[4]
    x, g, v = bn

    def f(params, xx):
        y, upd = JaxBatchNorm().apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xx,
            mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), (dp, dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    y, dx = _nchw(np.asarray(y)), _nchw(np.asarray(dx))
    stats = state_from_flax(jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])["BatchNorm_0"])
    grads = state_from_flax(jax.tree_util.tree_map(
        np.asarray, dp)["BatchNorm_0"])
    for r in res:
        part = r["bn"]
        n0, n1, a, b = part["rows"]
        np.testing.assert_allclose(part["y"], y[n0:n1, :, a:b], **BN_TOL)
        np.testing.assert_allclose(part["dx"], dx[n0:n1, :, a:b], **BN_TOL)
        np.testing.assert_allclose(part["dscale"], grads["scale"],
                                   **AFFINE_TOL)
        np.testing.assert_allclose(part["dbias"], grads["bias"],
                                   **AFFINE_TOL)
        np.testing.assert_allclose(part["mean"], stats["mean"], **BN_TOL)
        np.testing.assert_allclose(part["var"], stats["var"], **BN_TOL)
