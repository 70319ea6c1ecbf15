"""The port's training telemetry (``p2p_tpu_torch/obs``, ``core/debug.py``,
``core/cache.py``) against the JAX package's, fed the same inputs, and the
trainer's wiring, on the CPU.

- Sinks: the same records through both packages' ``JSONLSink``,
  ``StdoutSink`` and ``MetricsLogger`` give the same lines; the same
  registry content gives the same Prometheus exposition, which the port's
  ``PrometheusTextfileSink`` writes to its file.
- ``export_perfetto``: the same span records give the same Chrome-trace
  document; spans nest by depth.
- ``StepTimer``: the JAX timer's arithmetic on a fake clock (ticks,
  chains less the round trip, credits).
- ``check_finite`` / ``find_nonfinite``: the same findings on the same
  tree, the leaf named in the error and the ``nonfinite`` record.
- The sentinel's events and the grad-norm taps against the JAX taps.
- The manifest's fields (the JAX keys, ``torch_version`` in place of
  ``jax_version``), its hash and its CPU backend block.
- ``MemoryWatchdog`` is quiet on the CPU; ``budget_drift`` as JAX's.
- The build watchdog on a stubbed ``nvcc``: builds into the cache
  directory count as compiles, reuses as cache hits, a build after
  ``arm()`` as unexpected, under the JAX counter names.
- The trainer's wiring on a tiny ``reference`` epoch with every debug tap
  on: manifest, records, span trace, Prometheus textfile, no sentinel
  event, finite gradient norms, the watchdog armed with no unexpected
  build.
"""

import dataclasses
import json
import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu import obs as jax_obs
from p2p_tpu.core import debug as jax_debug
from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.obs import taps as jax_taps
from p2p_tpu_torch import obs
from p2p_tpu_torch.cli import train as cli_train
from p2p_tpu_torch.core import cache, debug
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.obs import taps
from p2p_tpu_torch.ops.cuda import build
from p2p_tpu_torch.train.loop import Trainer

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread, restored afterwards: these tiny steps are
    latency-bound, and one thread keeps them fast when the suite's workers
    share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


RECORDS = [
    {"kind": "train", "epoch": 1, "step": 1, "loss_g": 4.25, "ts": 1.5},
    {"kind": "train", "epoch": 1, "step": 50, "loss_g": 3.5, "ts": 2.5},
    {"kind": "eval", "epoch": 1, "psnr_mean": 21.125, "n_images": 2,
     "ts": 3.0},
    {"kind": "health", "event": "spiking", "step": 7, "rung": 1,
     "action": "skip", "metric": "loss_g", "ts": 4.0},
    {"kind": "epoch", "epoch": 1, "lr": 2e-4, "tags": ["a", "b"],
     "ts": 5.0},
]


def _fill(reg):
    """The same metric state in a registry of either package."""
    reg.counter("health_skips_total").inc(2)
    reg.counter("retry_attempts_total", seam="ckpt_save").inc()
    reg.counter("nonfinite_events", tag='tr"ain\\step').inc(3)
    reg.gauge("hbm_bytes_in_use", device=0).set(1024)
    reg.gauge("never_set")
    h = reg.histogram("dispatch_secs")
    for v in (0.001, 0.02, 0.3, 0.3, 7.0):
        h.observe(v)
    t = [0.0]
    e = reg.ewma("img_dispatch_rate")
    e._clock = lambda: t[0]
    e.mark(4)
    t[0] = 2.0
    e.mark(4)
    return reg


# ------------------------------------------------------------------ sinks
def test_jsonl_stdout_and_logger_lines_equal_the_jax_sinks(tmp_path,
                                                          capsys):
    for mod, tag in ((jax_obs, "jax"), (obs, "port")):
        jsonl = mod.JSONLSink(str(tmp_path / tag / "m.jsonl"))
        out = mod.StdoutSink(print_every=50)
        reg = mod.MetricsRegistry()
        reg.add_sink(jsonl)
        reg.add_sink(out)
        for r in RECORDS:
            reg.record(dict(r), force=r["kind"] == "health")
        reg.flush()
        reg.remove_sink(out)
        assert reg.sinks == (jsonl,)
        reg.close()
        reg.record({"kind": "after_close", "ts": 9.0})   # dropped
        logger = mod.MetricsLogger(str(tmp_path / tag / "l.jsonl"),
                                   print_every=2)
        for r in RECORDS:
            logger.log(dict(r))
        logger.close()
        print(f"--- {tag}")
    printed = capsys.readouterr().out.split("--- jax\n")
    assert printed[1].endswith("--- port\n")
    assert printed[0] == printed[1][:-len("--- port\n")]
    for name in ("m.jsonl", "l.jsonl"):
        j = (tmp_path / "jax" / name).read_text()
        p = (tmp_path / "port" / name).read_text()
        assert p == j and p.count("\n") == len(RECORDS)


def test_record_coerces_tensors_as_jax_coerces_arrays(tmp_path):
    lines = []
    for mod, val in ((jax_obs, jnp.float32(0.5)),
                     (obs, torch.tensor(0.5))):
        reg = mod.MetricsRegistry()
        sink = mod.JSONLSink(str(tmp_path / f"{mod.__name__}.jsonl"))
        reg.add_sink(sink)
        reg.record({"kind": "x", "v": val, "n": 3, "ok": True, "s": "a",
                    "ts": 1.0})
        reg.close()
        lines.append(open(sink.path).read())
    assert lines[0] == lines[1] == (
        '{"kind": "x", "v": 0.5, "n": 3.0, "ok": 1.0, "s": "a", '
        '"ts": 1.0}\n')


def test_prometheus_textfile_equals_the_jax_exposition(tmp_path):
    want = jax_obs.prometheus_exposition(_fill(jax_obs.MetricsRegistry()))
    reg = _fill(obs.MetricsRegistry())
    assert obs.prometheus_exposition(reg) == want
    path = str(tmp_path / "prom" / "p2p.prom")
    sink = obs.PrometheusTextfileSink(path, reg, export_every=2)
    reg.add_sink(sink)
    reg.record({"kind": "a"})
    assert not os.path.exists(path)
    reg.record({"kind": "b"})
    assert open(path).read() == want
    reg.counter("health_skips_total").inc()
    reg.close()
    text = open(path).read()
    assert "health_skips_total 3.0" in text
    assert not os.path.exists(path + ".tmp")
    # every sample line parses as `name{labels} value`
    for line in text.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            assert name.split("{")[0].replace("_", "").isalnum()


def test_tensorboard_sink_is_optional(tmp_path, monkeypatch, capsys):
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name.startswith("tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError):
        obs.TensorBoardSink(str(tmp_path / "tb"))
    # cli.train notes the missing package and trains on with its other
    # sinks; --prom_textfile keeps the registry in Prometheus format
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=2,
                                  n_test=1, size=32, seed=4)
    prom = str(tmp_path / "p2p.prom")
    assert cli_train.main([
        "--preset", "reference", "--data_root", root, "--workdir",
        str(tmp_path / "w"), "--device", "cpu", "--image_size", "32",
        "--ngf", "8", "--ndf", "8", "--n_blocks", "1", "--lambda_vgg", "0",
        "--nepoch", "1", "--tensorboard", "--prom_textfile", prom]) == 0
    assert "note: --tensorboard unavailable" in capsys.readouterr().err
    text = open(prom).read()
    assert "# TYPE dispatch_secs summary" in text
    assert "dispatch_secs_count 2.0" in text


# ------------------------------------------------------------------ spans
def test_export_perfetto_equals_the_jax_layout(tmp_path):
    spans = [{"name": "epoch", "ts": 100.0, "dur_s": 2.5, "depth": 0,
              "epoch": 1},
             {"name": "train_dispatch", "ts": 100.25, "dur_s": 1e-7,
              "depth": 1, "steps": 1},
             {"name": "checkpoint_save", "ts": 102.0, "dur_s": 0.375,
              "depth": 1, "epoch": 1}]
    docs = []
    for mod in (jax_obs, obs):
        rec = mod.SpanRecorder(max_spans=2)
        for s in spans:
            rec.spans.append(dict(s))
            rec._total += 1
        path = str(tmp_path / mod.__name__ / "trace.json")
        assert rec.export_perfetto(path) == path
        docs.append(json.load(open(path)))
    assert docs[0] == docs[1]
    assert docs[1]["p2p_tpu_dropped_spans"] == 1
    rec = obs.SpanRecorder()
    reg = obs.MetricsRegistry()
    got = []
    reg.add_sink(types.SimpleNamespace(write=lambda r, force: got.append(r)))
    with rec.span("epoch", epoch=3):
        with rec.span("evaluate", registry=reg, epoch=3):
            pass
    assert [(s["name"], s["depth"]) for s in rec.spans] == [
        ("evaluate", 1), ("epoch", 0)]
    assert got[0]["kind"] == "span" and got[0]["span"] == "evaluate"
    with obs.timed_annotation("x", reg.histogram("h")):
        pass
    assert reg.histogram("h").count == 1


# ----------------------------------------------------------------- timing
def test_step_timer_math_equals_the_jax_timer(monkeypatch):
    import time as time_mod

    from p2p_tpu.obs import timing as jax_timing

    t = [0.0]
    monkeypatch.setattr(time_mod, "perf_counter", lambda: t[0])
    out = []
    for mod, one in ((jax_timing, jnp.ones(())),
                     (obs.timing, torch.ones(()))):
        t[0] = 0.0
        timer = mod.StepTimer(batch_size=10)
        with timer.chain(steps=8, rtt=1.0) as ch:
            t[0] += 5.0
            ch.fence(one)
        timer.credit(2, 0.5)
        timer2 = mod.StepTimer(batch_size=6, skip_first=2)
        for dt in (3.0, 1.0, 0.5, 0.25, 2.0):
            timer2.tick(one)
            t[0] += dt
        timer2.tick()
        out.append((timer.intervals, timer.elapsed, timer.images_per_sec,
                    timer2.intervals, timer2.elapsed,
                    timer2.images_per_sec, ch.fenced))
    assert out[0] == out[1]
    assert out[1][:3] == (10, 4.5, 10 * 10 / 4.5)
    assert obs.measure_rtt() >= 0.0


# ------------------------------------------------------------ debug, taps
TREE = {"loss_g": np.float32(np.nan),
        "parts": {"a": np.array([1.0, np.inf, -np.inf], np.float32),
                  "b": np.ones(3, np.float32)},
        "steps": np.array([1, 2], np.int32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_check_finite_names_the_leaf_as_jax_does():
    want = jax_debug.find_nonfinite(TREE)
    assert debug.find_nonfinite(_torch_tree(TREE)) == want == [
        {"leaf": "loss_g", "nan": 1, "inf": 0},
        {"leaf": "parts/a", "nan": 0, "inf": 2}]
    reg = obs.MetricsRegistry()
    got = []
    reg.add_sink(types.SimpleNamespace(write=lambda r, force: got.append(r)))
    with pytest.raises(FloatingPointError, match=r"step_metrics:loss_g "
                                                 r"\(nan=1, inf=0\)"):
        debug.check_finite(_torch_tree(TREE), "step_metrics", registry=reg)
    assert got[0]["kind"] == "nonfinite" and got[0]["leaves"] == want
    assert debug.check_finite({"x": torch.ones(2)}) == []
    assert debug.check_finite(_torch_tree(TREE), raise_=False) == want


def test_sentinel_events_equal_the_jax_events():
    flat = {"loss_g": np.float32(np.nan), "loss_d": np.float32(1.0),
            "grad": np.array([np.inf, 1.0, np.nan, np.nan], np.float32),
            "steps": np.array([3], np.int32)}
    names = ("loss_g", "loss_d", "grad", "lr_scale")
    counts = np.array([[1, 0], [0, 0], [2, 1], [0, 1]], np.int32)
    taps.read_sentinels()                    # nothing queued before
    want, got = [], []
    jax_taps.add_sentinel_handler(want.append)
    taps.add_sentinel_handler(got.append)
    try:
        jax_taps._on_counts(counts, tag="train_step", names=names)
        taps.nan_sentinel({**_torch_tree(flat), "lr_scale": math.inf},
                          tag="train_step")
        assert got == []                     # read one call later
        taps.nan_sentinel({"ok": torch.ones(2)}, tag="train_step")
        assert got == want and len(got) == 1
        taps.nan_sentinel({"ok": torch.ones(2)}, tag="train_step")
        taps.read_sentinels()
        assert len(got) == 1                 # a clean tree reports nothing
    finally:
        jax_taps.remove_sentinel_handler(want.append)
        taps.remove_sentinel_handler(got.append)
    assert got[0]["leaves"] == {"loss_g": {"nan": 1, "inf": 0},
                                "grad": {"nan": 2, "inf": 1},
                                "lr_scale": {"nan": 0, "inf": 1}}


def test_grad_norm_taps_equal_optax_global_norm():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((8, 3, 3, 3), (8,), (16, 8, 1, 1))]
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    m = obs.grad_norm_taps({}, g=[torch.from_numpy(g) for g in grads],
                           d=None)
    assert list(m) == ["grad_norm_g"] and m["grad_norm_g"].dtype == \
        torch.float32
    assert float(m["grad_norm_g"]) == pytest.approx(want, rel=1e-6)


# --------------------------------------------------------------- manifest
def test_manifest_fields_hash_and_backend(tmp_path):
    cfg = get_preset("reference")
    want = set(jax_obs.build_manifest(jax_preset("reference"))) \
        - {"jax_version"} | {"torch_version"}
    path = str(tmp_path / "m" / "manifest.json")
    man = obs.write_manifest(path, cfg, device="cpu")
    assert set(man) == want
    assert json.load(open(path)) == json.loads(json.dumps(man, default=str))
    assert not os.path.exists(path + ".tmp")
    assert man["backend"] == {"platform": "cpu", "torch": torch.__version__}
    assert man["config_hash"] == obs.config_hash(get_preset("reference"))
    cfg2 = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=7))
    assert obs.config_hash(cfg2) != man["config_hash"]
    assert man["dtype_policy"] == jax_obs.build_manifest(
        jax_preset("reference"))["dtype_policy"]
    assert (man["process_count"], man["n_devices"], man["mesh_shape"]) == \
        (1, 1, None)


# ------------------------------------------------------------- watchdogs
def test_memory_watchdog_is_quiet_on_the_cpu_and_budget_drift():
    reg = obs.MetricsRegistry()
    logged = []
    logger = types.SimpleNamespace(log=lambda r, force=False:
                                   logged.append(r))
    for devices in (None, [torch.device("cpu")]):
        assert obs.MemoryWatchdog(reg, devices).sample(logger) == {}
    assert logged == [] and reg.snapshot() == {}
    from p2p_tpu.obs.watchdogs import budget_drift as jax_drift

    for pair in ((110, 100), (111, 100), (5, 0), (0, 7), (90, 100)):
        assert obs.budget_drift(*pair) == jax_drift(*pair)


class _FakeProc:
    """``nvcc`` stand-in: writes the ``-o`` file, exits 0."""

    def __init__(self, cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"lib")
        self.returncode = 0

    def communicate(self):
        return "", None


class _FakeLib:
    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_build_watchdog_counts_builds_hits_and_unexpected(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(cache, "_enabled_dir", None)
    monkeypatch.setattr(build, "find_nvcc", lambda: "/nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: _FakeLib())
    d = str(tmp_path / "kcache")
    assert cache.enable_compilation_cache(d) == d
    assert cache.compilation_cache_dir() == d and \
        str(build.build_dir()) == d
    reg = obs.MetricsRegistry()
    logged = []
    logger = types.SimpleNamespace(log=lambda r, force=False:
                                   logged.append(r))
    w = obs.RetraceWatchdog(registry=reg, logger=logger)
    try:
        built = build.build_all()
        assert sorted(built) == sorted(build.KERNELS)
        assert sorted(os.listdir(d)) == sorted(
            build._library_path(k, "/nvcc").name for k in build.KERNELS)
        assert build.build_all() == {}          # all reused from the dir
        for k in build.KERNELS:
            build._library.__wrapped__(k)       # past the per-process cache
        assert (w.compiles, w.cache_misses, w.cache_hits, w.unexpected) \
            == (4, 4, 4, 0)
        w.arm()
        os.remove(build._library_path("batch_moments", "/nvcc"))
        build.build_all()
        assert (w.compiles, w.unexpected) == (5, 1)
        assert logged[0]["kind"] == "retrace" and \
            logged[0]["library"] == "batch_moments"
        snap = reg.snapshot()
        assert snap["xla_compiles"]["value"] == 5
        assert snap["persistent_cache_hits"]["value"] == 4
        assert snap["persistent_cache_misses"]["value"] == 5
        assert snap["unexpected_recompiles"]["value"] == 1
        assert snap["xla_compile_secs"]["count"] == 5
    finally:
        w.close()
    assert w._on_event not in build._listeners


# ---------------------------------------------------------- the trainer
def test_trainer_obs_wiring(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=3,
                                  n_test=1, size=32, seed=2)
    cfg = get_preset("reference")
    cfg = cfg.replace(
        name="obswire",
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=1),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, image_size=32),
        train=dataclasses.replace(cfg.train, nepoch=1, epoch_save=1,
                                  log_every=1, mixed_precision=False),
        debug=dataclasses.replace(cfg.debug, check_finite=True,
                                  nan_sentinel=True, grad_norms=True))
    work = str(tmp_path / "w")
    tr = Trainer(cfg, data_root=root, workdir=work, device="cpu")
    prom = str(tmp_path / "w" / "p2p.prom")
    tr.obs.add_sink(obs.PrometheusTextfileSink(prom, tr.obs))
    assert tr.logger.registry is tr.obs and tr.ckpt._reg() is tr.obs
    tr.fit()
    manifest = json.load(open(os.path.join(work, "manifest_obswire.json")))
    assert manifest["config_hash"] == obs.config_hash(cfg)
    assert manifest["config"]["debug"] == {"check_finite": True,
                                           "nan_sentinel": True,
                                           "grad_norms": True}
    recs = [json.loads(x) for x in open(os.path.join(
        work, "metrics_obswire.jsonl"))]
    kinds = [r["kind"] for r in recs]
    assert kinds == ["manifest", "train", "train", "train", "eval", "epoch",
                     "health_summary"]
    assert recs[0]["backend"]["platform"] == "cpu"
    for r in recs[1:4] + recs[5:6]:
        assert math.isfinite(r["grad_norm_g"]) and r["grad_norm_g"] > 0
        assert math.isfinite(r["grad_norm_d"]) and r["grad_norm_c"] > 0
    doc = json.load(open(os.path.join(work, "trace_obswire.json")))
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(set(names)) == ["checkpoint_save", "epoch", "evaluate",
                                  "train_dispatch"]
    assert names.count("train_dispatch") == 3
    text = open(prom).read()
    assert "# TYPE img_dispatch_rate gauge" in text
    assert "dispatch_secs_count 3.0" in text
    assert tr.obs.total("nonfinite_events") == 0
    assert tr.retrace.armed and tr.retrace.unexpected == 0
    assert tr.ckpt.last_good_step() == 3
    # fit removed its process-wide hooks
    assert tr._sentinel_handler is None
    assert tr.retrace._on_event not in build._listeners
