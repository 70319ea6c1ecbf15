"""The port's serving service on the CPU: engines restored from the port's
checkpoints, hot-swap, the multi-tenant HTTP server and the serving CLI,
at tiny sizes (``reference`` at ngf 8, one block, 32²; ``pix2pixhd`` at
ngf 8, one block, 64×128; f32 unless a case says otherwise).

- ``engine_from_checkpoint`` reads only ``net_g`` and ``net_c``;
  ``swap_state`` changes the outputs with no new warm-up, rejects a shape
  mismatch, and a forward never mixes two versions' G and net_c (a
  stress run against concurrent swaps); the kernels' launch counts stay
  exact under threads.
- ``Tenant.reload`` swaps to a good step and rejects a corrupt ``net_g``,
  a missing manifest, a shape mismatch and an empty directory, never
  reading the whole step, with the old weights still serving.
- HTTP, two tenants: each response's pixels equal the file the directory
  frontend writes for the same request (both at batch 1: the same bits);
  ``/healthz``; ``/metrics``; an admin hot-swap; the drain returns 0. The
  status ladder 404/411/413/422/429/503/504/409 against a stub engine
  that blocks on an ``Event``; the per-tenant quota, released once.
- One response against the JAX package: a tiny JAX ``facades`` state
  carried into the port (``convert.load_train_state``), saved by the
  port's ``CheckpointManager``, served over HTTP, and compared with the
  JAX ``make_infer_forward`` at f32: within 1 uint8 level (f32 sums in
  another order move an output by ~1e-6, which can cross a rounding edge
  of the uint8 conversion).
- The request decoder and the response encoder against the JAX package's
  (PNG bodies: bitwise), the writer's retry, chaos seam and error list,
  and the CLI: watch mode with ``--max_requests`` and quarantine, HTTP as
  a subprocess (serve, hot-swap, SIGTERM → exit 0), refused flags and bad
  ``--tenant`` specs (exit 2).
"""

import dataclasses
import http.client
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.data.pipeline import load_image_bytes as jax_load_image_bytes
from p2p_tpu.data.synthetic import make_synthetic_dataset
from p2p_tpu.serve.io import encode_png as jax_encode_png
from p2p_tpu.train.state import create_train_state as jax_create
from p2p_tpu.train.step import make_infer_forward as jax_infer_forward
from p2p_tpu_torch.cli import serve as cli_serve
from p2p_tpu_torch.convert import load_train_state
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.pipeline import load_image_bytes
from p2p_tpu_torch.data.synthetic import synthetic_batch
from p2p_tpu_torch.obs import MetricsRegistry
from p2p_tpu_torch.ops.cuda import build
from p2p_tpu_torch.resilience import ChaosMonkey, PreemptionGuard, \
    install_chaos
from p2p_tpu_torch.serve.engine import (InferenceEngine,
                                        engine_from_checkpoint,
                                        serving_restore_template)
from p2p_tpu_torch.serve.io import AsyncImageWriter, encode_png
from p2p_tpu_torch.serve.server import (HttpRequest, ServeApp,
                                        TenantQuotaExceeded, run_server)
from p2p_tpu_torch.serve.tenancy import HotSwapRejected, Tenant, \
    checkpoint_dir
from p2p_tpu_torch.train.checkpoint import CheckpointManager
from p2p_tpu_torch.train.loop import Trainer
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.utils.images import decode_png, to_uint8_img

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
HD_HW = (64, 128)
JAX_LEVELS = 1
TINY = ["--device", "cpu", "--dtype", "f32", "--image_size", str(SIZE),
        "--ngf", "8", "--n_blocks", "1"]


def _ref_cfg(ngf=8):
    cfg = get_preset("reference")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=ngf, ndf=8, n_blocks=1,
                                  num_D=1),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, image_size=SIZE))


def _hd_cfg():
    cfg = get_preset("pix2pixhd")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=1),
        data=dataclasses.replace(cfg.data, image_size=HD_HW[0],
                                 image_width=HD_HW[1]))


def _images(n, hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One workdir with the checkpoints of a tiny ``reference`` run, steps
    1 and 2 (seeds 0 and 1), written by a ``Trainer`` (so under the path
    it writes), and of a tiny ``pix2pixhd`` run, step 1."""
    tmp = tmp_path_factory.mktemp("runs")
    root = make_synthetic_dataset(str(tmp / "data"), n_train=1, n_test=1,
                                  size=SIZE)
    work = str(tmp / "work")
    cfg = _ref_cfg()
    trainer = Trainer(cfg, data_root=root, workdir=work, device="cpu")
    trainer.ckpt.save(1, trainer.state, 0)
    trainer.ckpt.save(2, create_train_state(cfg, 1, device="cpu"), 0)
    hd = _hd_cfg()
    CheckpointManager(checkpoint_dir(hd, work)).save(
        1, create_train_state(hd, 0, device="cpu"), 0)
    return dict(work=work, ref=cfg, hd=hd, trainer_dir=trainer.ckpt.directory)


def _engine(cfg, ckpt, step, buckets=(1, 2)):
    return engine_from_checkpoint(cfg, ckpt, step=step, buckets=buckets,
                                  dtype="f32", device="cpu")[0]


def _copy_run(runs, tmp_path):
    """A private copy of the reference run's checkpoints."""
    src = checkpoint_dir(runs["ref"], runs["work"])
    dst = str(tmp_path / "ckpt")
    shutil.copytree(src, dst)
    return dst


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


# ------------------------------------------------------------ the engine
def test_checkpoint_dir_is_where_the_trainer_writes(runs):
    assert runs["trainer_dir"] == os.path.abspath(
        checkpoint_dir(runs["ref"], runs["work"]))


def test_engine_from_checkpoint_reads_only_g_and_net_c(runs):
    read = CheckpointManager.read
    names = []

    def spy(self, step, wanted):
        names.append(list(wanted))
        return read(self, step, wanted)

    ckpt = checkpoint_dir(runs["ref"], runs["work"])
    with mock.patch.object(CheckpointManager, "read", spy), \
            mock.patch.object(CheckpointManager, "verify",
                              side_effect=AssertionError("verify")):
        engine, step = engine_from_checkpoint(
            runs["ref"], ckpt, buckets=(2,), dtype="f32", device="cpu")
    assert step == 2 and names == [["net_g", "net_c"]]
    state = create_train_state(runs["ref"], 1, device="cpu")
    want = InferenceEngine(runs["ref"], state.net_g, buckets=(2,),
                           dtype="f32", device="cpu", net_c=state.net_c)
    x = _images(2, (SIZE, SIZE), 3)
    batch = {k: x for k in engine.batch_keys}
    assert engine.batch_keys == ("input", "target")
    torch.testing.assert_close(engine.infer_batch(batch)[0],
                               want.infer_batch(batch)[0], atol=0, rtol=0)


def test_swap_state_changes_outputs_adds_no_warmup_and_rejects_mismatch(
        runs):
    ckpt = checkpoint_dir(runs["ref"], runs["work"])
    engine = _engine(runs["ref"], ckpt, 1).warmup()
    batch = {k: _images(2, (SIZE, SIZE), 4) for k in engine.batch_keys}
    before = engine.infer_batch(batch)[0]
    warmups = engine.n_warmups
    g, c = serving_restore_template(runs["ref"])
    CheckpointManager(ckpt).restore_nets(g, c, 2)
    engine.swap_state(g, c)
    after = engine.infer_batch(batch)[0]
    assert engine.n_warmups == warmups == 2
    assert not torch.equal(before, after)
    torch.testing.assert_close(
        after, _engine(runs["ref"], ckpt, 2).infer_batch(batch)[0],
        atol=0, rtol=0)
    wide_g, wide_c = serving_restore_template(_ref_cfg(ngf=16))
    with pytest.raises(ValueError, match="hot-swap rejected"):
        engine.swap_state(wide_g, wide_c)
    with pytest.raises(ValueError, match="hot-swap rejected"):
        engine.swap_state(g)                       # net_c missing
    torch.testing.assert_close(engine.infer_batch(batch)[0], after,
                               atol=0, rtol=0)


def test_a_forward_never_mixes_two_versions_under_concurrent_swaps(runs):
    ckpt = checkpoint_dir(runs["ref"], runs["work"])
    engine = _engine(runs["ref"], ckpt, 1, buckets=(1,)).warmup()
    versions = []
    for step in (1, 2):
        versions.append(serving_restore_template(runs["ref"]))
        CheckpointManager(ckpt).restore_nets(*versions[-1], step)
    batch = {k: _images(1, (SIZE, SIZE), 5) for k in engine.batch_keys}
    want = [_engine(runs["ref"], ckpt, s, (1,)).infer_batch(batch)[0]
            for s in (1, 2)]
    got, stop = [], threading.Event()

    def serve():
        while not stop.is_set():
            got.append(engine.infer_batch(batch)[0])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve) for _ in range(4)]
        for t in threads:
            t.start()
        for k in range(6):
            engine.swap_state(*versions[k % 2], warm=False)
        stop.set()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got and all(torch.equal(y, want[0]) or torch.equal(y, want[1])
                       for y in got)


def test_launch_counts_are_exact_under_threads():
    def kernel():
        pass

    kernel.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(kernel) for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 8 * 2000


# ------------------------------------------------------------- tenancy
def test_tenant_reload_swaps_good_steps_and_rejects_bad_ones(runs,
                                                             tmp_path):
    ckpt = _copy_run(runs, tmp_path)
    reg = MetricsRegistry()
    tenant = Tenant("ref", runs["ref"], ckpt, step=1, registry=reg,
                    buckets=(1,), dtype="f32", device="cpu").warmup()
    batch = {k: _images(1, (SIZE, SIZE), 6)
             for k in tenant.engine.batch_keys}
    mgr = CheckpointManager(ckpt)
    with mock.patch.object(CheckpointManager, "verify",
                           side_effect=AssertionError("verify")):
        assert tenant.reload(2) == {"tenant": "ref", "from_step": 1,
                                    "step": 2, "swapped": True}
        serving = tenant.engine.infer_batch(batch)[0]
        shutil.copytree(mgr.step_dir(2), mgr.step_dir(3))
        _flip_byte(os.path.join(mgr.step_dir(3), "net_g.pt"))
        shutil.copytree(mgr.step_dir(2), mgr.step_dir(4))
        os.remove(os.path.join(mgr.step_dir(4), "manifest.json"))
        mgr.save(5, create_train_state(_ref_cfg(ngf=16), 0, device="cpu"),
                 0)
        for step, why in ((3, "CRC32"), (4, "manifest"), (5, "size"),
                          (None, "size"), (9, "no checkpoint at step 9")):
            with pytest.raises(HotSwapRejected, match=why):
                tenant.reload(step)
        for s in mgr.all_steps():
            shutil.rmtree(mgr.step_dir(s))
        with pytest.raises(HotSwapRejected, match="no checkpoint"):
            tenant.reload()
    assert tenant.step == 2 and tenant.swap_count == 1
    assert reg.counter("serve_hot_swap_rejected_total",
                       tenant="ref").value == 6
    assert tenant.status() == {"step": 2, "buckets": [1], "n_warmups": 1,
                               "swaps": 1}
    torch.testing.assert_close(tenant.engine.infer_batch(batch)[0],
                               serving, atol=0, rtol=0)


# ---------------------------------------------------------------- HTTP
def _post(base, path, data, timeout=60):
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve(app, guard):
    """``run_server`` in a thread; returns (thread, base URL, result)."""
    ready, result = threading.Event(), {}
    t = threading.Thread(target=lambda: result.update(rc=run_server(
        app, "127.0.0.1", 0, guard=guard, ready_event=ready)), daemon=True)
    t.start()
    assert ready.wait(120)
    return t, f"http://127.0.0.1:{app.httpd.server_address[1]}", result


def _directory_files(args, bodies, tmp):
    """The directory frontend's PNGs for ``bodies``, decoded."""
    in_dir, out_dir = tmp / "in", tmp / "out"
    in_dir.mkdir(parents=True)
    for i, body in enumerate(bodies):
        (in_dir / f"r{i}.png").write_bytes(body)
    assert cli_serve.main(["--input_dir", str(in_dir), "--out",
                           str(out_dir), "--once", "--buckets", "1"]
                          + args) == 0
    return [decode_png((out_dir / f"r{i}.png").read_bytes())
            for i in range(len(bodies))]


def test_two_tenants_over_http_match_the_directory_frontend(runs, tmp_path,
                                                            capsys):
    work, reg = runs["work"], MetricsRegistry()
    app = ServeApp(registry=reg, io_threads=2, max_queue=16, linger_ms=2.0)
    for alias, cfg in (("ref", runs["ref"]), ("hd", runs["hd"])):
        app.add_tenant(Tenant(alias, cfg, checkpoint_dir(cfg, work),
                              step=1, registry=reg, buckets=(1,),
                              dtype="f32", device="cpu"))
    bodies = {"ref": [encode_png(x) for x in _images(3, (SIZE, SIZE), 7)],
              "hd": [encode_png(x) for x in _images(3, HD_HW, 8)]}
    guard = PreemptionGuard(registry=reg)
    thread, base, result = _serve(app, guard)
    got = {}

    def hit(alias, i):
        got[(alias, i)] = _post(base, f"/v1/{alias}/translate",
                                bodies[alias][i])

    threads = [threading.Thread(target=hit, args=(a, i))
               for i in range(3) for a in ("ref", "hd")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    health = json.loads(_get(base, "/healthz")[1])
    metrics = _get(base, "/metrics")[1].decode().splitlines()
    swapped = _post(base, "/admin/reload?tenant=ref&step=2", b"")
    after = _post(base, "/v1/ref/translate", bodies["ref"][0])
    guard.request()
    thread.join(60)
    assert result == {"rc": 0}
    assert all(st == 200 and hdr["Content-Type"] == "image/png"
               for st, _, hdr in got.values())
    assert health["status"] == "ok" and set(health["tenants"]) == {"ref",
                                                                   "hd"}
    assert health["tenants"]["hd"]["n_warmups"] == 1
    for a in ("ref", "hd"):
        assert f'serve_http_requests_total{{code="200",tenant="{a}"}} 3.0' \
            in metrics
    assert swapped[0] == 200 and json.loads(swapped[1])["step"] == 2
    want_ref = _directory_files(["--workdir", work, "--step", "1"] + TINY,
                                bodies["ref"], tmp_path / "ref")
    want_hd = _directory_files(
        ["--workdir", work, "--step", "1", "--preset", "pix2pixhd"] + TINY
        + ["--image_size", str(HD_HW[0]), "--image_width", str(HD_HW[1])],
        bodies["hd"], tmp_path / "hd")
    for i in range(3):
        np.testing.assert_array_equal(decode_png(got[("ref", i)][1]),
                                      want_ref[i])
        np.testing.assert_array_equal(decode_png(got[("hd", i)][1]),
                                      want_hd[i])
    assert not np.array_equal(decode_png(after[1]), want_ref[0])
    summaries = {s["tenant"]: s for s in app.summaries()}
    assert summaries["ref"]["served"] == 4 and summaries["hd"]["served"] == 3
    assert summaries["ref"]["hot_swaps"] == 1
    assert summaries["ref"]["n_warmups"] == 1
    capsys.readouterr()


class _StubEngine:
    """Serves zeros; a forward waits until ``release`` is set."""

    buckets = (1, 2, 4)
    batch_keys = ("input",)
    n_warmups = 0

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()

    def infer_batch(self, batch):
        self.entered.set()
        assert self.release.wait(60)
        n = batch["input"].shape[0]
        bucket = next(b for b in self.buckets if b >= n)
        return torch.zeros((bucket, 16, 16, 3)), {}, n


class _StubTenant:
    """The Tenant surface the server reads, over a stub engine."""

    def __init__(self, alias="t"):
        self.alias = alias
        self.step = 0
        self.swap_count = 0
        self.engine = _StubEngine()
        cfg = get_preset("facades")
        self.cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                        image_size=16))

    def warmup(self):
        return self

    def status(self):
        return {"step": 0, "buckets": [1, 2, 4], "n_warmups": 0, "swaps": 0}

    def reload(self, step=None):
        raise HotSwapRejected(self.alias, step, "stub")


def _raw(base, method, path, headers, body=b""):
    """One request with exactly these headers (urllib adds its own)."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.putrequest(method, path, skip_accept_encoding=True)
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders()
    if body:
        conn.send(body)
    status = conn.getresponse().status
    conn.close()
    return status


def test_status_code_ladder_with_a_blocking_engine():
    reg = MetricsRegistry()
    app = ServeApp(registry=reg, io_threads=1, max_queue=1, deadline_ms=300,
                   linger_ms=0.0, max_attempts=1)
    tenant = app.add_tenant(_StubTenant())
    engine = tenant.engine
    body = encode_png(_images(1, (16, 16), 9)[0])
    guard = PreemptionGuard(registry=reg)
    thread, base, result = _serve(app, guard)
    answers = {}

    def hit(key):
        answers[key] = _post(base, "/v1/t/translate", body)

    engine.release.clear()
    a = threading.Thread(target=hit, args=("a",))
    a.start()
    assert engine.entered.wait(30)          # "a" is in the engine
    b = threading.Thread(target=hit, args=("b",))
    b.start()
    deadline = time.monotonic() + 30
    while len(app.runtime("t").batcher) < 1:  # "b" waits in the queue
        assert time.monotonic() < deadline
        time.sleep(0.01)
    shed = _post(base, "/v1/t/translate", body)
    time.sleep(0.4)                         # "b" outlives its deadline
    engine.release.set()
    a.join(30)
    b.join(30)
    poison = _post(base, "/v1/t/translate", b"not a png")
    codes = {
        "unknown tenant": _post(base, "/v1/ghost/translate", body)[0],
        "unknown route": _get(base, "/nope")[0],
        "no length": _raw(base, "POST", "/v1/t/translate", {}),
        "bad length": _raw(base, "POST", "/v1/t/translate",
                           {"Content-Length": "-1"}),
        "too large": _raw(base, "POST", "/v1/t/translate",
                          {"Content-Length": str(32 * 1024 * 1024 + 1)}),
        "reload rejected": _post(base, "/admin/reload",
                                 json.dumps({"tenant": "t"}).encode())[0],
        "reload unknown": _post(base, "/admin/reload?tenant=ghost", b"")[0],
    }
    engine.entered.clear()
    engine.release.clear()
    c = threading.Thread(target=hit, args=("c",))
    c.start()
    assert engine.entered.wait(30)
    guard.request()                         # drain with "c" in the engine
    deadline = time.monotonic() + 30
    while not app.draining:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    draining = _post(base, "/v1/t/translate", body)
    engine.release.set()
    c.join(30)
    thread.join(60)
    assert result == {"rc": 0}
    assert (answers["a"][0], answers["b"][0], answers["c"][0]) == (200, 504,
                                                                   200)
    assert decode_png(answers["a"][1]).shape == (16, 16, 3)
    assert shed[0] == 429 and shed[2]["Retry-After"] == "1"
    assert poison[0] == 422 and json.loads(poison[1])["attempts"] == 1
    assert codes == {"unknown tenant": 404, "unknown route": 404,
                     "no length": 411, "bad length": 411, "too large": 413,
                     "reload rejected": 409, "reload unknown": 404}
    assert draining[0] == 503 and draining[2]["Retry-After"] == "1"
    s = app.summaries()[0]
    assert (s["served"], s["shed"], s["deadline_expired"],
            s["quarantined"]) == (2, 1, 1, 1)


def _quota_app(**kw):
    app = ServeApp(registry=MetricsRegistry(), **kw)
    for alias in ("qa", "qb"):
        app.add_tenant(_StubTenant(alias))
    return app


def test_tenant_quota_rejects_then_releases_each_slot_once():
    app = _quota_app(max_queue=32, tenant_quota=2)
    rt = app.runtime("qa")
    r1, r2 = app.submit("qa", b"one"), app.submit("qa", b"two")
    assert r1 is not None and r2 is not None and rt.inflight == 2
    with pytest.raises(TenantQuotaExceeded) as e:
        app.submit("qa", b"three")
    assert (e.value.tenant, e.value.quota) == ("qa", 2)
    assert app.submit("qb", b"x") is not None      # the other tenant
    r1.complete(200, b"ok", "image/png")
    r1.complete(504, b"late")                      # no-op: first one won
    assert rt.inflight == 1 and r1.status == 200
    assert app.submit("qa", b"four") is not None and rt.inflight == 2
    summaries = {s["tenant"]: s for s in app.summaries()}
    assert summaries["qa"]["quota_rejected"] == 1
    assert summaries["qb"]["quota_rejected"] == 0
    # a shed request never entered: its slot comes straight back
    small = _quota_app(max_queue=1, tenant_quota=8)
    assert small.submit("qa", b"a") is not None
    assert small.submit("qa", b"b") is None
    assert small.runtime("qa").inflight == 1
    # unlimited by default
    free = _quota_app(max_queue=64)
    for i in range(16):
        assert free.submit("qa", bytes([i])) is not None
    assert free.runtime("qa").inflight == 16
    released = []
    req = HttpRequest(name="r", enqueued_at=0.0, payload=b"x",
                      on_complete=released.append)
    req.complete(504, b"")
    req.complete(200, b"png", "image/png")
    assert req.status == 504 and released == [req]


# ------------------------------------------------- against the JAX package
def test_http_response_matches_the_jax_serving_forward(tmp_path):
    """A tiny JAX facades state, carried into the port, saved by the
    port's CheckpointManager and served over HTTP; the JAX serving
    forward on the same state at f32 within JAX_LEVELS uint8 levels."""
    fields = ("params_g", "batch_stats_g", "params_d", "spectral_d",
              "params_c", "batch_stats_c")

    def small(cfg):
        return cfg.replace(
            model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
            data=dataclasses.replace(cfg.data, image_size=SIZE),
            train=dataclasses.replace(cfg.train, mixed_precision=False))

    jcfg, tcfg = small(jax_preset("facades")), small(get_preset("facades"))
    sample = {k: jnp.asarray(v)
              for k, v in synthetic_batch(1, SIZE, dtype="uint8").items()}
    js = jax.jit(lambda k: jax_create(jcfg, k, sample, 1))(
        jax.random.key(0))
    start = {f: jax.tree_util.tree_map(np.asarray, getattr(js, f))
             for f in fields}
    ts = load_train_state(create_train_state(tcfg, device="cpu"), start)
    ckpt = checkpoint_dir(tcfg, str(tmp_path))
    CheckpointManager(ckpt).save(1, ts, 0)
    reqs = _images(2, (SIZE, SIZE), 10)
    want = np.asarray(jax.jit(
        lambda b: jax_infer_forward(jcfg, None, with_metrics=False)(js, b)[0])(
        {"input": jnp.asarray(reqs)}))
    reg = MetricsRegistry()
    app = ServeApp(registry=reg, io_threads=1)
    app.add_tenant(Tenant("f", tcfg, ckpt, registry=reg, buckets=(1, 2),
                          dtype="f32", device="cpu"))
    guard = PreemptionGuard(registry=reg)
    thread, base, result = _serve(app, guard)
    got = [_post(base, "/v1/f/translate", encode_png(x)) for x in reqs]
    guard.request()
    thread.join(60)
    assert result == {"rc": 0}
    for (status, body, _), w in zip(got, want):
        assert status == 200
        diff = np.abs(decode_png(body).astype(int)
                      - to_uint8_img(w).astype(int))
        assert diff.max() <= JAX_LEVELS


# ---------------------------------------------------------- request I/O
@pytest.mark.parametrize("case", ["same size", "resized", "grey", "rgba"])
def test_request_decode_matches_jax(case):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(11)
    shape = {"same size": (32, 32, 3), "resized": (40, 24, 3),
             "grey": (32, 32), "rgba": (32, 32, 4)}[case]
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
        buf, format="PNG")
    body = buf.getvalue()
    for as_uint8 in (True, False):
        got = load_image_bytes(body, 32, 32, as_uint8=as_uint8)
        want = jax_load_image_bytes(body, 32, 32, as_uint8=as_uint8)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_a_non_png_body_is_refused_naming_the_png_decoder(monkeypatch):
    """Without Pillow the port reads PNG bodies only."""
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(_images(1, (8, 8), 12)[0]).save(buf, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PNG only"):
        load_image_bytes(buf.getvalue(), 8, 8)


@pytest.mark.parametrize("size", [(32, 32), (40, 24)])
def test_a_jpeg_body_is_read_by_pillow_as_jax_reads_it(size):
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(_images(1, size, 14)[0]).save(buf, format="JPEG")
    for as_uint8 in (True, False):
        got = load_image_bytes(buf.getvalue(), 32, 32, as_uint8=as_uint8)
        want = jax_load_image_bytes(buf.getvalue(), 32, 32,
                                    as_uint8=as_uint8)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="neither a PNG nor"):
        load_image_bytes(b"GIF89a not an image", 8, 8)


def test_response_png_decodes_to_the_jax_response_pixels():
    Image = pytest.importorskip("PIL.Image")
    pred = np.random.default_rng(13).uniform(-1.1, 1.1, (24, 40, 3)).astype(
        np.float32)
    jax_pixels = np.asarray(Image.open(io.BytesIO(jax_encode_png(pred))))
    np.testing.assert_array_equal(decode_png(encode_png(pred)), jax_pixels)


def test_writer_retries_injected_faults_and_records_bad_paths(tmp_path):
    reg = MetricsRegistry()
    pred = torch.zeros((3, 8, 8, 3))
    prev = install_chaos(ChaosMonkey.from_spec("serve_write@1",
                                               registry=reg))
    try:
        with mock.patch("p2p_tpu_torch.resilience.retry.time.sleep"):
            w = AsyncImageWriter(2, fail_fast=False)
            (tmp_path / "squat.png").mkdir()    # a directory in the way
            w.submit_batch(pred, [str(tmp_path / n)
                                  for n in ("a.png", "squat.png", "c.png")])
            assert w.drain() == 2
            w.close()
            strict = AsyncImageWriter(1)
            strict.submit_batch(pred[:1], [str(tmp_path / "squat.png")])
            with pytest.raises(OSError):
                strict.drain()
            strict.close()
    finally:
        install_chaos(prev)
    assert [p for p, _ in w.write_errors] == [str(tmp_path / "squat.png")]
    assert sorted(os.listdir(tmp_path)) == ["a.png", "c.png", "squat.png"]
    assert reg.counter("chaos_injected_total",
                       seam="serve_write").value == 1


# ------------------------------------------------------------------ CLI
def test_cli_watch_mode_serves_max_requests_and_quarantines(runs, tmp_path,
                                                            capsys):
    in_dir = tmp_path / "watch"
    in_dir.mkdir()
    result = {}
    args = ["--input_dir", str(in_dir), "--workdir", runs["work"],
            "--max_requests", "3", "--poll_ms", "20", "--linger_ms", "10",
            "--max_attempts", "1", "--buckets", "1,2"] + TINY
    t = threading.Thread(target=lambda: result.update(
        rc=cli_serve.main(args)))
    t.start()
    (in_dir / "bad.png").write_bytes(b"not a png")
    for i, img in enumerate(_images(3, (SIZE, SIZE), 14)):
        time.sleep(0.2)
        (in_dir / f".part{i}").write_bytes(encode_png(img))
        os.replace(in_dir / f".part{i}", in_dir / f"w{i}.png")
    t.join(120)
    assert not t.is_alive() and result == {"rc": 0}
    out = tmp_path / "watch_out"
    assert sorted(os.listdir(out)) == ["w0.png", "w1.png", "w2.png"]
    assert decode_png((out / "w0.png").read_bytes()).shape == (SIZE, SIZE, 3)
    assert sorted(os.listdir(in_dir / "failed")) == ["bad.png",
                                                     "bad.png.reason.txt"]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["served"], summary["written"], summary["step"],
            summary["quarantined"], summary["n_warmups"]) == (3, 3, 2, 1, 2)


def test_cli_http_subprocess_serves_hot_swaps_and_drains(runs):
    cmd = [sys.executable, "-m", "p2p_tpu_torch.cli.serve", "--http",
           "127.0.0.1:0", "--workdir", runs["work"], "--tenant",
           "alias=ref,preset=reference,step=1", "--buckets", "1,2",
           "--drain_timeout", "20"] + TINY
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "serving 1 tenant(s)" in line:
                break
        assert "serving 1 tenant(s)" in lines[-1], "".join(lines)
        base = "http://" + lines[-1].split("http://")[1].split()[0]
        body = encode_png(_images(1, (SIZE, SIZE), 15)[0])
        first = _post(base, "/v1/ref/translate", body)
        swap = _post(base, "/admin/reload",
                     json.dumps({"tenant": "ref", "step": 2}).encode())
        second = _post(base, "/v1/ref/translate", body)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert (first[0], swap[0], second[0]) == (200, 200, 200)
    assert first[1] != second[1]
    summaries = [json.loads(x) for x in out.splitlines()
                 if x.startswith('{"kind": "serve_summary"')]
    assert len(summaries) == 1
    assert (summaries[0]["served"], summaries[0]["hot_swaps"],
            summaries[0]["step"]) == (2, 1, 2)


@pytest.mark.parametrize("args, says", [
    (["--http", "127.0.0.1:0", "--tenant", "alias=x,bogus=1"], "bogus"),
    (["--http", "127.0.0.1:0", "--tenant", "noequals"], "noequals"),
    (["--http", "127.0.0.1:0", "--tenant", "step=3"], "alias"),
    (["--http", "127.0.0.1:0", "--tenant", "alias=x,ema_decay=high"],
     "ema_decay"),
    (["--http", "localhost"], "HOST:PORT"),
    (["--http", "127.0.0.1:0", "--weights", "g.npz"], "--weights"),
    (["--once"], "--input_dir"),
    (["--input_dir", "x", "--mesh", "1,1,1"], "--mesh"),
    (["--input_dir", "x", "--weights", "g.npz", "--ema_decay", "0.99"],
     "--ema_decay"),
    (["--input_dir", "x", "--tp_min_ch", "8"], "--tp_min_ch"),
    # --compilation_cache is accepted: the kernel libraries are built into
    # (and reused from) the directory it names, set before the bad tenant
    # spec is refused
    (["--http", "127.0.0.1:0", "--compilation_cache", "c", "--tenant",
      "noequals"], "noequals"),
])
def test_cli_refuses_bad_specs_and_unported_flags(args, says, capsys,
                                                  tmp_path, monkeypatch):
    from p2p_tpu_torch.core import cache
    from p2p_tpu_torch.ops.cuda import build

    monkeypatch.setattr(cache, "_enabled_dir", None)
    monkeypatch.chdir(tmp_path)
    assert cli_serve.main(args) == 2
    assert says in capsys.readouterr().err
    if "--compilation_cache" in args:
        assert build.build_dir() == tmp_path / "c"
        assert (tmp_path / "c").is_dir()
    else:
        assert build.build_dir() == build.BUILD_DIR


def test_cli_defaults_are_the_jax_defaults():
    from p2p_tpu.cli.serve import build_parser as jax_parser

    port, jax_args = cli_serve.build_parser().parse_args([]), \
        jax_parser().parse_args([])
    for flag in ("preset", "max_batch", "linger_ms", "poll_ms", "dtype",
                 "io_threads", "max_queue", "deadline_ms", "max_attempts",
                 "retry_delay_ms", "drain_timeout", "tenant_quota",
                 "workdir"):
        assert getattr(port, flag) == getattr(jax_args, flag), flag
    assert cli_serve.default_buckets(16) == (1, 2, 4, 8, 16)
