"""The spatial axis end to end (slice 13b): one f32 train step of the
shrunk ``cityscapes_spatial`` and ``pix2pixhd`` presets with H split over
2 gloo ranks on the CPU (``MeshSpec(data=1, spatial=2)``, the presets'
own mesh at world size 2), the mesh's groups and batch slots, and
``cli.train`` with ``--mesh 1,2,1`` and its elastic relaunch.

- ``cityscapes_spatial`` (the ResnetGenerator with plain instance norms,
  the 3-scale spectral-norm D, LSGAN + 10·FM + 1·TV; VGG off as in
  tests/test_parallel.py ``_tiny_cfg``) at ngf 8, ndf 8, one residual
  block, 64×64, global batch 2: the port's two ranks against JAX's
  ``make_parallel_train_step`` on ``MeshSpec(data=1, spatial=2)`` over 2
  fake CPU devices, from the same JAX state carried across by
  ``convert.py``. Losses within 1e-4 relative (tests/test_torch_dp.py's
  step-1 band); step-1 gradients of D within 1e-5 + 1e-4 of each
  tensor's largest and of G within 1e-5 + 5e-3 (tests/
  test_torch_cityscapes_step.py's bands: G's cotangent through D, FM and
  TV is ill-conditioned at this size); every updated tensor within
  2·lr = 4e-4 absolute (Adam's first step moves a weight by ±lr whatever
  its gradient's size).
- ``pix2pixhd`` (the local enhancer around G1, #1–#3's route at every
  epilogue, the 3-scale D, LSGAN + 10·FM + 10·VGG19) at ngf 8, ndf 8, one
  global block, 128×128 (G1's deepest map: 4 rows, 2 a rank, the halo+1
  rule of its k3 convs; 64 would leave 1), batch 1: the 2 ranks against
  the port's own one-device step on the same batch (held against JAX by
  tests/test_torch_hd_train_step.py). Losses within 1e-5 relative (f32
  sums in another order: measured ~1e-7); D's step-1 gradient within
  1e-5 abs + 1e-5 of each tensor's largest (measured 2.7e-6). G's step
  gradient is not compared element by element: the cotangent the loss
  sends to G's output is ill-conditioned at this state (the random VGG19's
  max pools and relus flip on G's near-constant initial output: a 1e-6
  change of that output moves the VGG term's gradient by 1.6e-2 of its
  largest, and the two routes' outputs differ by 4e-6 through f32 sums in
  another order). G itself is held alone instead: its forward and
  backward on the ranks' rows for a fixed cotangent on its output, the
  parameter gradients summed over the ranks, within 2e-5 of each tensor's
  largest (measured 4.8e-6). One statistics all-reduce per norm in the
  forward and one in the backward: 20 + 20 a step at this depth (36 + 36
  at the preset's).
- the eval step on 2 ranks (prediction rows gathered, PSNR and SSIM on
  the whole image) against the one-device eval;
- the mesh: one batch slot, spatial coordinates 0 and 1, the batch group
  of one rank (not the world);
- ``cli.train --mesh 1,2,1``: exit 0 on both ranks, the two spatial peers
  reading the same train samples (the loader by batch slot); with
  ``P2P_CHAOS=elastic@3`` exit 75 on both, then this process relaunches
  it alone (no group): an elastic ``reshard`` that exits 0, and the two
  runs' samples are the uninterrupted run's, none twice, none missing.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_spatial_worker as SW  # noqa: E402
from torch_dp_worker import spawn  # noqa: E402
from torch_step_parity import (FIELDS, adam_mu, jax_start,  # noqa: E402
                               np_tree)
from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.core.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from p2p_tpu.core.mesh import make_mesh  # noqa: E402
from p2p_tpu.parallel import (  # noqa: E402
    make_parallel_train_step as jax_parallel, replicate_state, shard_batch)
from p2p_tpu_torch.cli import train  # noqa: E402
from p2p_tpu_torch.convert import (load_train_state,  # noqa: E402
                                   state_from_flax)
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.core.mesh import MeshSpec  # noqa: E402
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from p2p_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                       load_vgg19)
from p2p_tpu_torch.train.step import (build_eval_step,  # noqa: E402
                                      build_train_step)

CS_KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_tv")
HD_KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg")
CS_LOSS_RTOL, HD_LOSS_RTOL = 1e-4, 1e-5
GRAD_ATOL = 1e-5
CS_GRAD_RTOL = {"g": 5e-3, "d": 1e-4}
HD_D_RTOL, HD_G_COT_RTOL = 1e-5, 2e-5
# G1: stem, 4 downs, 2 a block (1 block), 4 ups; the enhancer: stem,
# down, 2 a block (3 blocks), up (36 at the preset's 9 global blocks)
HD_EPILOGUES = 1 + 4 + 2 + 4 + 1 + 1 + 6 + 1
NET_ATOL = 4e-4        # 2·lr
SSIM_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shrunk(get, name, h, w, batch, **model):
    cfg = get(name)
    mesh_cls = JaxMeshSpec if get is jax_preset else MeshSpec
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  **model),
        loss=dataclasses.replace(cfg.loss, **(
            {"lambda_vgg": 0.0} if name == "cityscapes_spatial" else {})),
        data=dataclasses.replace(cfg.data, image_size=h, image_width=w,
                                 batch_size=batch),
        train=dataclasses.replace(cfg.train, mixed_precision=False),
        parallel=dataclasses.replace(cfg.parallel,
                                     mesh=mesh_cls(data=1, spatial=2)))


def _batch(h, w, n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
            for k in ("input", "target")}


def _cityscapes(tmp):
    """The JAX spatial step's metrics, step-1 gradients and networks (in
    the port's names), with the start written for the ranks."""
    jcfg = _shrunk(jax_preset, "cityscapes_spatial", 64, 64, 2)
    tcfg = _shrunk(get_preset, "cityscapes_spatial", 64, 64, 2)
    batch = _batch(64, 64, 2, 21)
    js, _ = jax_start(jcfg, batch, vgg=False)
    ts = load_train_state(create_train_state(tcfg, device="cpu"),
                          {f: np_tree(getattr(js, f)) for f in FIELDS})
    eval_batch = _batch(64, 64, 2, 24)
    pred, em = build_eval_step(tcfg)(ts, eval_batch)
    torch.save({"cfg": tcfg, "net_g": ts.net_g.state_dict(),
                "net_d": ts.net_d.state_dict(), "batch": batch,
                "eval": eval_batch}, tmp / "cityscapes.pt")
    mesh = make_mesh(JaxMeshSpec(data=1, spatial=2),
                     devices=jax.devices()[:2])
    step = jax_parallel(jcfg, mesh)
    state = replicate_state(jax.tree_util.tree_map(jnp.array, js), mesh)
    new, m = step(state, shard_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()}, mesh))
    grads = {n: {k: 2.0 * v for k, v in state_from_flax(
        adam_mu(getattr(new, f"opt_{n}")),
        module=getattr(ts, f"net_{n}")).items()} for n in ("g", "d")}
    nets = {f"net_g/{k}": v for k, v in state_from_flax(
        np_tree(new.params_g), module=ts.net_g).items()}
    nets.update({f"net_d/{k}": v for k, v in state_from_flax(
        np_tree(new.params_d), module=ts.net_d).items()})
    return {"metrics": {k: float(m[k]) for k in CS_KEYS}, "grads": grads,
            "nets": nets, "eval": (pred, em)}


def _hd(tmp):
    """The port's one-device pix2pixHD step on the same batch and start,
    and G's parameter gradients for a fixed cotangent on its output."""
    tcfg = _shrunk(get_preset, "pix2pixhd", 128, 128, 1)
    batch = _batch(128, 128, 1, 22)
    rng = np.random.default_rng(23)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 128, 128)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal((1, 3, 128, 128)).astype(
        np.float32))
    vgg = load_vgg19(device="cpu")
    start = create_train_state(tcfg, 0, device="cpu")
    torch.save({"cfg": tcfg, "net_g": start.net_g.state_dict(),
                "net_d": start.net_d.state_dict(), "batch": batch,
                "vgg": vgg.state_dict(), "image": image, "cot": cot},
               tmp / "hd.pt")
    g = start.net_g
    (g(image.contiguous(memory_format=torch.channels_last)) * cot
     ).sum().backward()
    g_cot = {k: p.grad.clone() for k, p in g.named_parameters()}
    g.zero_grad(set_to_none=True)
    _, m = build_train_step(tcfg, vgg)(start, batch)
    return {"metrics": {k: float(m[k]) for k in HD_KEYS},
            "grads": SW.step1_grads(start), "g_cot": g_cot}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_step")
    make_synthetic_dataset(str(tmp / "data"), n_train=4, n_test=2,
                           size=SW.CLI_SIZE[0])
    want = {"cityscapes": _cityscapes(tmp), "hd": _hd(tmp)}
    ranks = spawn("step_checks", 2, str(tmp), str(tmp),
                  module="torch_spatial_worker", timeout=480)
    return tmp, want, ranks


def _grads_close(got, want, rtol):
    for net in ("g", "d"):
        assert set(got[net]) == set(want[net])
        for k, w in want[net].items():
            w = torch.as_tensor(w)
            diff = float((got[net][k] - w).abs().max())
            limit = GRAD_ATOL + rtol[net] * float(w.abs().max())
            assert diff <= limit, (net, k, diff, limit)


def test_cityscapes_spatial_step_is_jax_spatial_step(runs):
    _, want, ranks = runs
    w = want["cityscapes"]
    for r in ranks:
        got = r["cityscapes"]
        for k in CS_KEYS:
            assert abs(got["metrics"][k] - w["metrics"][k]) <= \
                CS_LOSS_RTOL * abs(w["metrics"][k]), k
        _grads_close(got["grads"], w["grads"], CS_GRAD_RTOL)
        for k, v in w["nets"].items():
            assert float((got["nets"][k] - torch.as_tensor(v)).abs().max()
                         ) <= NET_ATOL, k
        # the halo exchanges went point to point (gloo, CPU tensors)
        assert got["halo"]["p2p"]["calls"] > 0
        assert got["halo"]["slot"]["calls"] == 0
        # plain instance norms: no #1-#3 statistics all-reduce
        assert got["norm_allreduces"] == (0, 0)
    # both ranks hold the same updated state
    assert all(torch.equal(ranks[0]["cityscapes"]["nets"][k], v)
               for k, v in ranks[1]["cityscapes"]["nets"].items())


def test_spatial_eval_scores_the_whole_image(runs):
    """The eval step on 2 ranks: G on each rank's rows, the prediction's
    rows gathered on every rank, PSNR and SSIM (whose windows cross the
    blocks) on the whole image: the one-device eval's, the prediction
    within 2e-6 of its largest |value| (f32 sums in another order), PSNR
    within 1e-5 relative and SSIM within 1e-6 absolute (its value is
    ~1e-2 on these random images, a mean of ratios of small window
    statistics)."""
    _, want, ranks = runs
    pred, em = want["cityscapes"]["eval"]
    for r in ranks:
        got_pred, got_m = r["cityscapes"]["eval"]
        assert got_pred.shape == pred.shape
        err = float((got_pred - pred).abs().max())
        assert err <= 2e-6 * float(pred.abs().max()), err
        assert torch.allclose(got_m["psnr"], em["psnr"], rtol=1e-5, atol=0)
        ssim_err = float((got_m["ssim"] - em["ssim"]).abs().max())
        assert ssim_err <= SSIM_ATOL, ssim_err


def test_pix2pixhd_spatial_step_is_the_one_device_step(runs):
    _, want, ranks = runs
    w = want["hd"]
    for r in ranks:
        got = r["hd"]
        for k in HD_KEYS:
            assert abs(got["metrics"][k] - w["metrics"][k]) <= \
                HD_LOSS_RTOL * abs(w["metrics"][k]), k
        for k, v in w["grads"]["d"].items():
            diff = float((got["grads"]["d"][k] - v).abs().max())
            assert diff <= GRAD_ATOL + HD_D_RTOL * float(v.abs().max()), k
        # G alone, for a fixed cotangent on its output: the rows' forward
        # and backward through every sharded form of G
        for k, v in w["g_cot"].items():
            diff = float((got["g_cot"][k] - v).abs().max())
            assert diff <= HD_G_COT_RTOL * float(v.abs().max()), k
        # every epilogue through the sums entry, one all-reduce of its sums
        # and one of m1/m2, once a step each
        assert got["norm_allreduces"] == (HD_EPILOGUES, HD_EPILOGUES)
    assert all(torch.equal(ranks[0]["hd"]["nets"][k], v)
               for k, v in ranks[1]["hd"]["nets"].items())


def test_mesh_splits_slots_and_rows(runs):
    _, _, ranks = runs
    got = [r["mesh"] for r in ranks]
    assert [g["spatial_rank"] for g in got] == [0, 1]
    for g in got:
        assert g["batch_shards"] == 1 and g["batch_rank"] == 0
        # the data x fsdp line through the rank is the rank alone
        assert g["batch_group_size"] == 1
        assert g["spatial_ranks"] == [0, 1]


def test_cli_train_on_the_presets_mesh_and_its_elastic_reshard(runs):
    tmp, _, ranks = runs
    full = [r["cli"]["full"] for r in ranks]
    pre = [r["cli"]["elastic"] for r in ranks]
    assert [f["rc"] for f in full] == [0, 0]
    # spatial peers read the same samples: one batch slot
    assert full[0]["reads"] == full[1]["reads"]
    assert len(full[0]["reads"]) == 8      # 2 epochs of 4 samples
    assert [p["rc"] for p in pre] == [75, 75]
    assert pre[0]["reads"] == pre[1]["reads"]
    reads = []
    with SW.reading_train_split(reads):
        rc = train.main(SW.cli_args(str(tmp), "elastic"))
    assert rc == 0
    # the preempted run read 3 steps' samples, the relaunch the rest
    assert pre[0]["reads"] + reads == full[0]["reads"]
    work = tmp / "elastic"
    records = [json.loads(line) for line in open(
        work / "metrics_cityscapes_spatial.jsonl")]
    kinds = [r for r in records if r["kind"] == "elastic_resume"]
    assert kinds and kinds[-1]["decision"] == "reshard", kinds
