"""Ranks of the port's spatial-axis CPU tests (tests/test_torch_halo.py,
tests/test_torch_spatial_ops.py, tests/test_torch_spatial_step.py):
spawned gloo processes with one torch thread each, no JAX, started by
``torch_dp_worker.spawn``. Each function takes ``(rank, world, tmp)``,
reads its inputs from ``tmp`` (written by the parent from a numpy seed)
and returns what the parent compares.
"""

import contextlib
import os
from unittest import mock

import torch
import torch.distributed as dist
import torch.nn.functional as F

EDGE_MODES = ("reflect", "zero", "wrap")
ROUTES = ("p2p", "slot")
HALOS = (1, 2)


# ---------------------------------------------------------------- halo
def halo_checks(rank: int, world: int, tmp: str):
    """Every edge mode, route and halo on this rank's block (rows along
    dim 1 of an NHWC array): the exchange's output and its adjoint for a
    fixed cotangent; ``ring_shift`` by 1 and its adjoint; at 4 ranks,
    sync-BatchNorm over data=2 × spatial=2."""
    from p2p_tpu_torch.parallel.halo import (halo_exchange, halo_stats,
                                             reset_halo_stats, ring_shift)

    saved = torch.load(os.path.join(tmp, "halo.pt"), weights_only=True)
    x = saved["x"]
    m = x.shape[1] // world
    out = {}
    for mode in EDGE_MODES:
        for route in ROUTES:
            for halo in HALOS:
                reset_halo_stats()
                xl = x[:, rank * m:(rank + 1) * m].clone().requires_grad_(True)
                y = halo_exchange(xl, 1, halo, None, mode, route)
                g = saved[f"g{halo}"][:, rank * (m + 2 * halo):
                                      (rank + 1) * (m + 2 * halo)]
                (y * g).sum().backward()
                out[mode, route, halo] = (
                    y.detach(), xl.grad.clone(),
                    {r: dict(v) for r, v in halo_stats.items()})
    xs = x[:, rank * m:(rank + 1) * m].clone().requires_grad_(True)
    ys = ring_shift(xs, None, 1, "p2p")
    (ys * saved["g0"][:, rank * m:(rank + 1) * m]).sum().backward()
    out["ring"] = (ys.detach(), xs.grad.clone())
    ys = ring_shift(x[:, rank * m:(rank + 1) * m], None, 1, "slot")
    out["ring_slot"] = ys
    if world == 4:
        out["bn"] = sync_bn_data_spatial(rank, tmp)
    return out


def sync_bn_data_spatial(rank: int, tmp: str):
    """The port's BatchNorm inside a data=2 × spatial=2 mesh on this
    rank's sample rows and image rows of the global (x, g): y, dx, the
    parameter gradients summed over the world and the running
    statistics."""
    from p2p_tpu_torch.core.mesh import (Mesh, MeshSpec, mesh_context,
                                         row_block, set_rows)
    from p2p_tpu_torch.ops.norm import BatchNorm

    saved = torch.load(os.path.join(tmp, "bn.pt"), weights_only=True)
    x, g = saved["x"], saved["g"]
    mesh = Mesh(MeshSpec(data=2, spatial=2))
    n = x.shape[0] // 2
    rows = slice(mesh.batch_rank * n, (mesh.batch_rank + 1) * n)
    a, b = row_block(x.shape[2], 2, mesh.spatial_rank)
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(saved["bn"])
    xt = x[rows, :, a:b].contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    set_rows(xt, x.shape[2])
    with mesh_context(mesh):
        y = bn(xt)
        (y * g[rows, :, a:b]).sum().backward()
    grads = torch.stack([bn.scale.grad, bn.bias.grad])
    dist.all_reduce(grads)
    return {"rows": (rows.start, rows.stop, a, b), "y": y.detach().clone(),
            "dx": xt.grad.clone(), "dscale": grads[0], "dbias": grads[1],
            "mean": bn.mean.clone(), "var": bn.var.clone()}


# ----------------------------------------------------------------- ops
def op_forms():
    """``{name: fn(x, w, b) -> (y, params)}``: each windowed op of the two
    presets and the instance norms, as the models call them (under a
    spatial mesh their sharded forms), with the parameters whose
    gradients are compared."""
    from p2p_tpu_torch.core.mesh import spatial_mesh
    from p2p_tpu_torch.models.patchgan import _PlainConv, avg_pool_downsample
    from p2p_tpu_torch.ops.activations import relu_y
    from p2p_tpu_torch.ops.conv import ConvLayer, UpsampleConvLayer
    from p2p_tpu_torch.ops.instance_norm import (instance_norm_act,
                                                 instance_norm_fused)
    from p2p_tpu_torch.ops.norm import instance_norm
    from p2p_tpu_torch.ops.spectral_norm import SpectralConv

    def layer(make):
        def fn(x, w, b):
            mod = make(w.shape[1], w.shape[0])
            conv = mod.conv
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(b)
            return mod(x), [conv.weight, conv.bias]
        return fn

    def vgg_block(x, w, b):
        # conv k3 zero pad 1 + relu, then the 2×2 max pool, as VGG19 runs
        # them (models/vgg.py)
        w, b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        if spatial_mesh() is not None:
            from p2p_tpu_torch.parallel.spatial import (conv_rows,
                                                        max_pool_rows)
            y = max_pool_rows(relu_y(conv_rows(x, w, b, 1, 1, "zero")))
        else:
            y = F.max_pool2d(relu_y(F.conv2d(x, w, b, padding=1)), 2, 2)
        return y, [w, b]

    def spectral(stride):
        def fn(x, w, b):
            mod = SpectralConv(w.shape[1], w.shape[0], 4, stride=stride,
                               padding=2)
            with torch.no_grad():
                mod.weight.copy_(w)
                mod.bias.copy_(b)
            mod.eval()
            return mod(x), [mod.weight, mod.bias]
        return fn

    def affine(fn):
        def wrapped(x, w, b):
            c = x.shape[1]
            scale = (1.0 + 0.1 * w.reshape(-1)[:c]).clone().requires_grad_(
                True)
            bias = b[:c].clone().requires_grad_(True)
            return fn(x, scale, bias), [scale, bias]
        return wrapped

    def no_w(fn):
        return lambda x, w, b: (fn(x), [])

    return {
        "conv_k3s1": layer(lambda i, o: ConvLayer(i, o, 3)),
        "conv_k7s1": layer(lambda i, o: ConvLayer(i, o, 7)),
        "conv_k3s2": layer(lambda i, o: ConvLayer(i, o, 3, stride=2)),
        "upconv_k3": layer(lambda i, o: UpsampleConvLayer(i, o, 3,
                                                          upsample=2)),
        "d_k4s2": layer(lambda i, o: _PlainConv(i, o, 2)),
        "d_k4s1": layer(lambda i, o: _PlainConv(i, o, 1)),
        "sn_k4s2": spectral(2),
        "sn_k4s1": spectral(1),
        "vgg_k3_pool": vgg_block,
        "avg_pool": no_w(avg_pool_downsample),
        "norm_act": no_w(lambda x: instance_norm_act(x, act="relu")),
        "norm_res": no_w(lambda x: instance_norm_act(x, residual=x * 0.5)),
        "norm_act_affine": affine(lambda x, s, b: instance_norm_act(
            x, s, b, act="leaky", slope=0.2)),
        "norm_fused_affine": affine(instance_norm_fused),
        "norm_plain": no_w(instance_norm),
    }


def op_checks(rank: int, world: int, tmp: str):
    """Each op of :func:`op_forms` on this rank's rows of every input in
    ``ops.pt``: the output rows, the input gradient rows and the
    parameter gradients (this rank's part) for the saved cotangent, and
    the statistics all-reduces of the norms (forward, backward)."""
    from p2p_tpu_torch.core.mesh import (Mesh, MeshSpec, mesh_context,
                                         row_block, set_rows)
    from p2p_tpu_torch.ops.instance_norm import sharded_stats

    saved = torch.load(os.path.join(tmp, "ops.pt"), weights_only=True)
    mesh = Mesh(MeshSpec(data=1, spatial=world))
    forms = op_forms()
    out = {}
    for key, case in saved.items():
        name = key.split("@")[0]
        x, w, b, g = case["x"], case["w"], case["b"], case["g"]
        a, z = row_block(x.shape[2], world, rank)
        xl = x[:, :, a:z].contiguous(memory_format=torch.channels_last)
        xl.requires_grad_(True)
        set_rows(xl, x.shape[2])
        before = (sharded_stats.allreduces, sharded_stats.backward_allreduces)
        with mesh_context(mesh):
            y, params = forms[name](xl, w, b)
            oa, oz = row_block(g.shape[2], world, rank)
            (y.float() * g[:, :, oa:oz]).sum().backward()
        out[key] = {"rows": (oa, oz), "y": y.detach().clone(),
                    "dx": xl.grad.clone(),
                    "dp": [p.grad.clone() for p in params],
                    "allreduces": (sharded_stats.allreduces - before[0],
                                   sharded_stats.backward_allreduces
                                   - before[1])}
    out["sharded_conv"] = sharded_conv_checks(rank, world, tmp, mesh)
    return out


def sharded_conv_checks(rank, world, tmp, mesh):
    """``make_sharded_conv`` (the stride-1 'same' conv by one symmetric
    exchange) on the whole tensor of ``sharded_conv.pt``, each edge
    mode's output on every rank."""
    from p2p_tpu_torch.core.mesh import mesh_context
    from p2p_tpu_torch.parallel.spatial import make_sharded_conv

    saved = torch.load(os.path.join(tmp, "sharded_conv.pt"),
                       weights_only=True)
    with mesh_context(mesh):
        return {mode: make_sharded_conv(mesh, mode)(saved["x"], saved["w"])
                for mode in ("reflect", "zero")}


# ---------------------------------------------------------------- step
def step_checks(rank: int, world: int, tmp: str):
    """The slice on 2 ranks: the shrunk ``cityscapes_spatial`` and
    ``pix2pixhd`` steps from the parent's start states, the mesh's groups
    and batch slots, the trainer's loader by slot, and ``cli.train``
    with the preset's mesh and its elastic relaunch."""
    out = {}
    out["mesh"] = mesh_layout()
    for name in ("cityscapes", "hd"):
        out[name] = spatial_step(name, tmp)
    out["cli"] = spatial_cli(rank, tmp)
    return out


def mesh_layout():
    """The ``data=1, spatial=2`` mesh's batch slot, spatial coordinate
    and groups as this rank sees them."""
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec

    mesh = Mesh(MeshSpec(data=1, spatial=2))
    return {"batch_shards": mesh.batch_shards, "batch_rank": mesh.batch_rank,
            "spatial_rank": mesh.spatial_rank,
            "batch_group_size": dist.get_world_size(mesh.batch_group)
            if mesh.batch_group is not None else dist.get_world_size(),
            "spatial_ranks": mesh.group_ranks("spatial")}


def spatial_step(name: str, tmp: str):
    """One f32 step of the shrunk preset on ``data=1, spatial=2`` from the
    state the parent saved: the metrics (global), the updated networks,
    and the exchanges and statistics all-reduces of the step."""
    from p2p_tpu_torch.core.mesh import Mesh
    from p2p_tpu_torch.ops import instance_norm as inorm
    from p2p_tpu_torch.parallel import (make_parallel_train_step,
                                        place_state, shard_batch)
    from p2p_tpu_torch.parallel.halo import halo_stats, reset_halo_stats
    from p2p_tpu_torch.train.state import create_train_state

    saved = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
    cfg = saved["cfg"]
    state = create_train_state(cfg, 0, device="cpu")
    state.net_g.load_state_dict(saved["net_g"])
    state.net_d.load_state_dict(saved["net_d"])
    vgg = None
    if saved.get("vgg") is not None:
        from p2p_tpu_torch.models.vgg import VGG19Features

        vgg = VGG19Features()
        vgg.load_state_dict(saved["vgg"])
        vgg.eval()
    mesh = Mesh(cfg.parallel.mesh)
    place_state(state, mesh)
    step = make_parallel_train_step(cfg, mesh, vgg)
    out = {}
    if "cot" in saved:
        out["g_cot"] = g_with_cotangent(state.net_g, saved["image"],
                                        saved["cot"], mesh)
    if "eval" in saved:
        from p2p_tpu_torch.parallel import make_parallel_eval_step

        pred, em = make_parallel_eval_step(cfg, mesh)(state, saved["eval"])
        out["eval"] = (pred.cpu(), {k: v.cpu() for k, v in em.items()})
    reset_halo_stats()
    a0 = (inorm.sharded_stats.allreduces,
          inorm.sharded_stats.backward_allreduces)
    state, m = step(state, shard_batch(saved["batch"], mesh))
    return {**out, "metrics": {k: float(v) for k, v in m.items()},
            "nets": {f"{n}/{k}": v.detach().clone()
                     for n in ("net_g", "net_d")
                     for k, v in getattr(state, n).state_dict().items()},
            "grads": step1_grads(state),
            "halo": {r: dict(v) for r, v in halo_stats.items()},
            "norm_allreduces": (inorm.sharded_stats.allreduces - a0[0],
                                inorm.sharded_stats.backward_allreduces
                                - a0[1])}


def g_with_cotangent(net_g, image, cot, mesh):
    """G's parameter gradients, summed over the ranks, of ``Σ G(image)·cot``
    with G on this rank's rows (its gradients then cleared)."""
    from p2p_tpu_torch.core.mesh import mesh_context, row_block, set_rows

    h = image.shape[2]
    a, b = row_block(h, mesh.spatial, mesh.spatial_rank)
    x = set_rows(image[:, :, a:b].contiguous(
        memory_format=torch.channels_last), h)
    with mesh_context(mesh):
        (net_g(x) * cot[:, :, a:b]).sum().backward()
    out = {}
    for k, p in net_g.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        out[k] = g
    net_g.zero_grad(set_to_none=True)
    return out


def step1_grads(state):
    """``{net: {name: 2·exp_avg}}``: each network's step-1 gradient (Adam's
    first moment after one step is 0.5·g)."""
    out = {}
    for net, opt in (("g", state.opt_g), ("d", state.opt_d)):
        st = opt[0].state
        params = getattr(state, f"net_{net}").named_parameters()
        out[net] = {k: 2.0 * st[p]["exp_avg"].clone() for k, p in params}
    return out


@contextlib.contextmanager
def reading_train_split(reads):
    from p2p_tpu_torch.data.pipeline import PairedImageDataset

    getitem = PairedImageDataset.__getitem__

    def reading(self, idx):
        if os.path.basename(os.path.dirname(self.a_dir)) == "train":
            reads.append(int(idx))
        return getitem(self, idx)

    with mock.patch.object(PairedImageDataset, "__getitem__", reading):
        yield


def spatial_cli(rank: int, tmp: str):
    """``cli.train`` of the shrunk ``cityscapes_spatial`` at 2 ranks with
    ``--mesh 1,2,1``: 2 epochs (exit code, the train samples read, the
    eval records); then a run preempted with ``elastic@3`` (exit 75)."""
    import io

    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos

    out = {}
    for what, chaos in (("full", None), ("elastic", "elastic@3")):
        reads = []
        install_chaos(ChaosMonkey.from_spec(chaos) if chaos else None)
        try:
            with reading_train_split(reads), \
                    contextlib.redirect_stdout(io.StringIO()):
                rc = train.main(cli_args(tmp, what) + ["--mesh", "1,2,1"])
        finally:
            install_chaos(None)
        out[what] = {"rc": rc, "reads": reads}
    return out


CLI_SIZE = (64, 64)


def cli_args(tmp: str, work: str):
    return ["--preset", "cityscapes_spatial", "--data_root",
            os.path.join(tmp, "data"), "--workdir", os.path.join(tmp, work),
            "--device", "cpu", "--image_size", str(CLI_SIZE[0]),
            "--image_width", str(CLI_SIZE[1]), "--ngf", "8", "--ndf", "8",
            "--n_blocks", "1", "--lambda_vgg", "0", "--batch_size", "2",
            "--test_batch_size", "1", "--nepoch", "2", "--epochsave", "1"]
