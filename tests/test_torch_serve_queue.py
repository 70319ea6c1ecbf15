"""The serving service's machinery, port against the JAX package: the
metrics registry and its Prometheus text (``obs``), fault injection,
retry, the request queue and graceful shutdown (``resilience``), the
dispatch loop and the continuous batcher (``serve``). Each case runs one
scripted sequence of operations on both packages' modules, on a fake
clock where time matters, and requires the same outcomes: the same
returns, groups, delays and firing sequence, the same counters, and
byte-identical exposition text. No model runs here (a stub engine stands
in for the dispatch loop's), so there is no tolerance: everything is
compared exactly.
"""

import dataclasses
import math
import os
import random
import signal
import threading
import time

import numpy as np
import pytest

import p2p_tpu.obs.registry as jax_registry
import p2p_tpu.obs.sinks as jax_sinks
import p2p_tpu.resilience.chaos as jax_chaos
import p2p_tpu.resilience.preempt as jax_preempt
import p2p_tpu.resilience.queue as jax_queue
import p2p_tpu.resilience.retry as jax_retry
import p2p_tpu.serve.batcher as jax_batcher
import p2p_tpu.serve.frontend as jax_frontend
import p2p_tpu_torch.obs.registry as port_registry
import p2p_tpu_torch.obs.sinks as port_sinks
import p2p_tpu_torch.resilience.chaos as port_chaos
import p2p_tpu_torch.resilience.preempt as port_preempt
import p2p_tpu_torch.resilience.queue as port_queue
import p2p_tpu_torch.resilience.retry as port_retry
import p2p_tpu_torch.serve.batcher as port_batcher
import p2p_tpu_torch.serve.frontend as port_frontend

JAX = dict(registry=jax_registry, sinks=jax_sinks, chaos=jax_chaos,
           retry=jax_retry, queue=jax_queue, batcher=jax_batcher,
           frontend=jax_frontend, preempt=jax_preempt)
PORT = dict(registry=port_registry, sinks=port_sinks, chaos=port_chaos,
            retry=port_retry, queue=port_queue, batcher=port_batcher,
            frontend=port_frontend, preempt=port_preempt)


class Clock:
    """A monotonic clock that moves only when told."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def both(script):
    """``script(modules)`` on each package; returns (jax, port)."""
    return script(JAX), script(PORT)


def _snapshot(reg):
    """A registry snapshot with NaN made comparable."""
    return {k: {f: ("nan" if isinstance(v, float) and math.isnan(v) else v)
                for f, v in fields.items()}
            for k, fields in reg.snapshot().items()}


# ------------------------------------------------------------------ obs
def _fill(m):
    """The same metrics on one package's registry; returns it."""
    reg = m["registry"].MetricsRegistry()
    reg.counter("serve_shed_total", tenant="hd").inc(3)
    reg.counter("serve_shed_total", tenant="ref").inc()
    reg.counter("retry-attempts.total", seam="decode", tenant="a").inc(2.5)
    reg.counter("9lives")
    reg.gauge("serve_queue_depth", tenant="hd").set(7)
    reg.gauge("never_set", tenant='q"uo\\te')
    h = reg.histogram("serve_request_latency_seconds", tenant="hd")
    for v in (1e-7, 3e-4, 0.02, 0.02, 0.5, 7.0, 5e3):
        h.observe(v)
    occ = reg.histogram("serve_batch_occupancy",
                        bounds=port_frontend.OCCUPANCY_BOUNDS, tenant="hd")
    for v in (1.0, 0.75, 0.5, 1.0):
        occ.observe(v)
    clock = Clock()
    e = reg.ewma("serve_requests_per_sec", tenant="hd")
    e._clock = clock
    for dt, n in ((0.0, 1), (0.5, 2), (0.25, 1), (2.0, 4)):
        clock.t += dt
        e.mark(n)
    return reg


def test_registry_snapshot_kinds_and_totals_match_jax():
    j, p = both(_fill)
    assert _snapshot(p) == _snapshot(j)
    assert p.kinds() == j.kinds()
    assert p.total("serve_shed_total") == j.total("serve_shed_total") == 4
    h = p.histogram("serve_request_latency_seconds", tenant="hd")
    hj = j.histogram("serve_request_latency_seconds", tenant="hd")
    assert [h.quantile(q) for q in (0.1, 0.5, 0.9, 1.0)] == \
        [hj.quantile(q) for q in (0.1, 0.5, 0.9, 1.0)]
    # get-or-create is idempotent per (name, tags), tag order ignored
    assert p.counter("a", x=1, y=2) is p.counter("a", y=2, x=1)


def test_prometheus_exposition_is_byte_identical_to_jax():
    j, p = both(_fill)
    text = port_sinks.prometheus_exposition(p)
    assert text == jax_sinks.prometheus_exposition(j)
    assert 'serve_shed_total{tenant="hd"} 3.0' in text.splitlines()
    assert "p2p_9lives 0.0" in text.splitlines()
    assert "never_set" not in text.replace("# TYPE never_set gauge", "")


def test_default_registry_get_and_set():
    prev = port_registry.set_registry(None)
    try:
        a = port_registry.get_registry()
        assert a is port_registry.get_registry()
        mine = port_registry.MetricsRegistry()
        assert port_registry.set_registry(mine) is a
        assert port_registry.get_registry() is mine
    finally:
        port_registry.set_registry(prev)


# ---------------------------------------------------------------- chaos
SPECS = ["decode:0.3", "decode@7", "ckpt_save:0.5x3", "nan@50x3",
         "serve_write", "decode:0.2x1,ckpt_save@12", " a:1e-1 , b@0x2 "]
BAD_SPECS = ["", " , ", "x:2", "elastic:0.5", "elastic", "a:b", "@3"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_as_jax(spec):
    got = {k: dataclasses.asdict(v)
           for k, v in port_chaos.parse_spec(spec).items()}
    want = {k: dataclasses.asdict(v)
            for k, v in jax_chaos.parse_spec(spec).items()}
    assert got == want


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_chaos_bad_spec_raises_as_jax(spec):
    with pytest.raises(ValueError):
        jax_chaos.parse_spec(spec)
    with pytest.raises(ValueError):
        port_chaos.parse_spec(spec)


def _fire(m):
    reg = m["registry"].MetricsRegistry()
    monkey = m["chaos"].ChaosMonkey.from_spec(
        "decode:0.3,serve_write@3x2,nan@5x3,ckpt_save:0.5x4", seed=11,
        registry=reg)
    fired = []
    for k in range(1, 31):
        for seam in ("decode", "serve_write", "nan", "ckpt_save", "other"):
            try:
                monkey.maybe_fail(seam, step=k if seam == "nan" else None)
                fired.append(0)
            except m["chaos"].FaultInjected as e:
                assert (e.seam, e.step) == (seam,
                                            k if seam == "nan" else None)
                fired.append(1)
    return fired, monkey.counts(), _snapshot(reg)


def test_chaos_fires_the_jax_sequence_for_a_seed():
    (fj, cj, sj), (fp, cp, sp) = both(_fire)
    assert fp == fj and cp == cj and sp == sj
    assert sum(fp) == sum(cp.values()) > 0
    assert cp["serve_write"] == 2 and cp["nan"] == 3


def _armed_from_env(m, monkeypatch):
    chaos = m["chaos"]
    monkeypatch.setenv("P2P_CHAOS", "decode@2")
    chaos.install(None)             # re-arms from the environment
    out = []
    try:
        for _ in range(3):
            try:
                chaos.chaos_point("decode")
                out.append(0)
            except chaos.FaultInjected:
                out.append(1)
        monkey = chaos.ChaosMonkey.from_spec("serve_write",
                                             registry=m["registry"]
                                             .MetricsRegistry())
        chaos.install(monkey)
        with pytest.raises(chaos.FaultInjected):
            chaos.chaos_point("serve_write")
        chaos.chaos_point("serve_write")      # its one fault is spent
    finally:
        monkeypatch.delenv("P2P_CHAOS")
        chaos.install(None)
    chaos.chaos_point("decode")               # disarmed
    return out


def test_chaos_arms_from_the_environment_and_install_as_jax(monkeypatch):
    assert _armed_from_env(PORT, monkeypatch) == \
        _armed_from_env(JAX, monkeypatch) == [0, 1, 0]


# ---------------------------------------------------------------- retry
def _retries(m):
    retry = m["retry"]
    reg = m["registry"].MetricsRegistry()
    policy = retry.RetryPolicy()
    delays = [policy.backoff(k, random.Random(3)) for k in range(1, 8)]
    flat = [retry.RetryPolicy(jitter=False).backoff(k) for k in range(1, 8)]
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("blip")
        return "done"

    slept = []
    out = retry.retry_call(flaky, policy=policy, seam="s", registry=reg,
                           rng=random.Random(5), sleep=slept.append)
    exhausted = []
    with pytest.raises(TimeoutError):
        retry.retry_call(lambda: (_ for _ in ()).throw(TimeoutError()),
                         policy=retry.RetryPolicy(max_attempts=3),
                         seam="t", registry=reg, rng=random.Random(6),
                         sleep=exhausted.append)
    with pytest.raises(ValueError):
        retry.retry_call(lambda: (_ for _ in ()).throw(ValueError()),
                         seam="u", registry=reg, sleep=exhausted.append)
    clock = Clock()
    late = []

    def tick(d):
        late.append(d)
        clock.t += d

    with pytest.raises(OSError):
        retry.retry_call(lambda: (_ for _ in ()).throw(OSError()),
                         policy=retry.RetryPolicy(max_attempts=20,
                                                  deadline=0.5),
                         seam="v", registry=reg, rng=random.Random(7),
                         sleep=tick, clock=clock)
    faults = [retry.RetryPolicy().is_retryable(e) for e in (
        OSError(), TimeoutError(), m["chaos"].FaultInjected("x"),
        ValueError(), KeyError())]
    deco = retry.retrying(seam="w", registry=reg, sleep=lambda d: None)(
        lambda x: x + 1)
    return (delays, flat, out, slept, exhausted, late, faults, deco(1),
            _snapshot(reg))


def test_retry_delays_and_counters_match_jax():
    j, p = both(_retries)
    assert p == j
    delays, flat, out, slept, exhausted, late, faults, deco, snap = p
    assert out == "done" and len(slept) == 2 and len(exhausted) == 2
    assert flat == [0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 2.0]
    assert sum(late) <= 0.5 and faults == [True, True, True, False, False]
    assert snap["retry_exhausted_total{seam=t}"]["value"] == 1
    assert snap["retry_exhausted_total{seam=v}"]["value"] == 1


# ---------------------------------------------------------------- queue
def _queue_script(m):
    reg = m["registry"].MetricsRegistry()
    clock = Clock()
    q = m["queue"].BoundedRequestQueue(3, deadline_s=1.0, registry=reg,
                                       clock=clock, tenant="t",
                                       max_bytes=100)
    log = []

    def state(tag):
        log.append((tag, len(q), q.queued_bytes, q.shed_count,
                    q.expired_count, q.oldest_enqueued_at()))

    def names(rs):
        return [r.name for r in rs]

    for name, body in (("a", b"x" * 40), ("b", b"x" * 40), ("c", b"x" * 40),
                       ("d", None), ("e", None)):
        log.append((name, q.offer(name, payload=body) is not None))
        clock.t += 0.1
    state("offered")
    ready, expired = q.take(1)
    log.append(("take1", names(ready), names(expired)))
    ready[0].attempts += 1
    log.append(("requeue", q.requeue(ready[0], delay_s=0.3)))
    log.append(("requeue-full", q.requeue(
        m["queue"].Request("z", 0.0, payload=b"y" * 90))))
    state("requeued")
    log.append(("take-held",) + tuple(names(x) for x in q.take(5)))
    clock.t += 0.35
    log.append(("take-ready",) + tuple(names(x) for x in q.take(1)))
    for name in ("f", "g"):
        log.append((name, q.offer(name) is not None))
    clock.t += 1.2
    log.append(("take-expired",) + tuple(names(x) for x in q.take(5)))
    state("expired")
    log.append(("h", q.offer("h", payload=b"x" * 60) is not None))
    r = q.take(1)[0][0]
    r.attempts += 1
    q.requeue(r, delay_s=60.0)
    log.append(("flush", names(q.flush())))
    state("flushed")
    return log, _snapshot(reg)


def test_queue_sheds_expires_requeues_and_flushes_as_jax():
    (lj, sj), (lp, sp) = both(_queue_script)
    assert lp == lj and sp == sj
    log = dict((x[0], x[1:]) for x in lp)
    assert log["c"] == (False,) and log["d"] == (True,) \
        and log["e"] == (False,)                  # byte budget, then depth
    # "a" waits out its backoff behind younger requests, then goes
    assert log["take-held"] == (["b", "d"], [])
    assert log["take-ready"] == (["a"], [])
    assert log["flush"] == (["h"],)               # backoff holdouts too
    assert sp["serve_queue_depth{tenant=t}"]["value"] == 0


def _quarantine(m, tmp):
    reg = m["registry"].MetricsRegistry()
    src = os.path.join(tmp, "in")
    os.makedirs(src, exist_ok=True)
    path = os.path.join(src, "bad.png")
    with open(path, "wb") as f:
        f.write(b"junk")
    qu = m["queue"].Quarantine(os.path.join(tmp, "failed"), registry=reg,
                               tenant="t")
    dest = qu.quarantine(path, "3 failed decodes")
    gone = qu.quarantine(path, "again")
    with open(dest + ".reason.txt") as f:
        reason = f.read()
    return (os.path.relpath(dest, tmp), gone, os.path.exists(path), reason,
            qu.count, _snapshot(reg))


def test_quarantine_moves_the_file_as_jax(tmp_path):
    j = _quarantine(JAX, str(tmp_path / "j"))
    p = _quarantine(PORT, str(tmp_path / "p"))
    assert p == j
    assert p[:5] == (os.path.join("failed", "bad.png"), None, False,
                     "3 failed decodes\n", 1)


# -------------------------------------------------------------- batcher
def _batcher(m, clock, buckets=(1, 2, 4), linger_s=0.02, max_depth=32):
    reg = m["registry"].MetricsRegistry()
    q = m["queue"].BoundedRequestQueue(max_depth, registry=reg, clock=clock)
    return m["batcher"].ContinuousBatcher(q, buckets, linger_s=linger_s,
                                          clock=clock)


def _batcher_scenarios(m):
    """The scenarios of tests/test_serve_http.py:59-144 on a fake clock."""
    out = {}

    def names(rs):
        return [r.name for r in rs]

    clock = Clock()
    b = _batcher(m, clock)
    for i in range(5):
        b.submit(f"r{i}")
    out["loaded"] = names(b.next_group(timeout=1.0)[0])

    clock = Clock()
    b = _batcher(m, clock, linger_s=0.03)
    for i in range(3):
        b.submit(f"r{i}")
    out["lingering"] = b._group_size(clock())
    clock.t += 0.03
    out["after_linger"] = [names(b.next_group(timeout=1.0)[0]),
                           names(b.next_group(timeout=1.0)[0])]

    clock = Clock()
    b = _batcher(m, clock, linger_s=0.25)
    b.submit("r0")
    clock.t += 0.05
    out["straggler_wait"] = b._group_size(clock())
    for i in range(1, 4):
        b.submit(f"r{i}")
    out["straggler_group"] = names(b.next_group(timeout=1.0)[0])

    clock = Clock()
    b = _batcher(m, clock, max_depth=2)
    out["full"] = [b.submit(x) is not None for x in "abc"]
    out["shed"] = b.queue.shed_count
    b.close()
    out["closed_submit"] = b.submit("d") is None
    out["drained"] = names(b.next_group(timeout=0.2)[0])
    out["empty"] = (len(b), b.closed)

    clock = Clock()
    b = _batcher(m, clock, buckets=(2, 4, 8), linger_s=0.0)
    for i in range(7):
        b.submit(f"s{i}")
    out["largest_full_bucket"] = [names(b.next_group(timeout=1.0)[0])
                                  for _ in range(3)]
    b = _batcher(m, Clock(), buckets=(1, 2, 4))
    r = b.submit("x")
    b.take(1)
    r.attempts += 1
    out["requeue"] = (b.requeue(r, 5.0), len(b), names(b.flush()))
    return out


def test_batcher_forms_the_jax_groups():
    j, p = both(_batcher_scenarios)
    assert p == j
    assert p["loaded"] == ["r0", "r1", "r2", "r3"]
    assert p["after_linger"] == [["r0", "r1"], ["r2"]]
    assert p["straggler_group"] == ["r0", "r1", "r2", "r3"]
    assert p["largest_full_bucket"] == [["s0", "s1", "s2", "s3"],
                                        ["s4", "s5"], ["s6"]]
    assert p["drained"] == ["a", "b"] and p["closed_submit"]


def test_batcher_wakes_a_waiting_consumer_on_arrival():
    b = _batcher(PORT, time.monotonic, linger_s=0.25)
    b.submit("r0")
    got = {}
    t = threading.Thread(target=lambda: got.update(
        ready=b.next_group(timeout=5.0)[0]))
    t.start()
    time.sleep(0.05)
    for i in range(1, 4):
        b.submit(f"r{i}")
    t.join(5.0)
    assert not t.is_alive()
    assert [r.name for r in got["ready"]] == ["r0", "r1", "r2", "r3"]


# ------------------------------------------------------- dispatch loop
@pytest.mark.parametrize("n", range(1, 65))
def test_default_buckets_match_jax(n):
    assert port_frontend.default_buckets(n) == \
        jax_frontend.default_buckets(n)


class StubEngine:
    """Pads like the engine: a group of n rows runs at the smallest
    bucket >= n."""

    buckets = (1, 2, 4)
    batch_keys = ("input",)

    def __init__(self):
        self.rows = []

    def infer_batch(self, batch):
        n = batch["input"].shape[0]
        self.rows.append(batch["input"][:, 0].tolist())
        bucket = next(b for b in self.buckets if b >= n)
        return np.zeros((bucket, 1), np.float32), {}, n


def _dispatch(m):
    reg = m["registry"].MetricsRegistry()
    clock = Clock()
    q = m["queue"].BoundedRequestQueue(16, deadline_s=5.0, registry=reg,
                                       clock=clock, tenant="t")
    engine = StubEngine()
    log = []

    def decode(req):
        if req.payload == "bad" or (req.payload == "flaky"
                                    and req.attempts == 0):
            raise OSError(f"cannot decode {req.name}")
        return np.array([int(req.name[1:])])

    loop = m["frontend"].DispatchLoop(
        engine, q, decode=decode,
        deliver=lambda reqs, pred, n: log.append(
            ("deliver", [r.name for r in reqs], int(pred.shape[0]), n)),
        on_poison=lambda req, e: log.append(("poison", req.name,
                                             req.attempts)),
        on_expired=lambda req: log.append(("expired", req.name)),
        max_attempts=3, retry_delay_s=0.5, registry=reg, tenant="t",
        group_cap=16)
    payloads = ["ok"] * 4 + ["bad", "ok", "ok", "ok", "flaky"]
    for i, p in enumerate(payloads):
        q.offer(f"r{i}", payload=p)
    log.append(("drain", loop.drain()))
    clock.t += 0.6
    log.append(("drain", loop.drain()))
    clock.t += 1.1
    log.append(("drain", loop.drain()))
    q.offer("r99", payload="ok")
    clock.t += 6.0
    log.append(("drain", loop.drain()))
    return (log, engine.rows, loop.served, loop.padded_images,
            loop.occupancy_mean, loop.decode_retries, loop.group_cap,
            _snapshot(reg))


def test_dispatch_loop_occupancy_padding_and_retries_match_jax():
    j, p = both(_dispatch)
    assert p == j
    log, rows, served, padded, occ, retries, cap, snap = p
    assert cap == 4                    # the largest bucket caps a group
    assert ("poison", "r4", 3) in log and ("expired", "r99") in log
    assert served == 8 and retries == 3
    assert rows == [[0, 1, 2, 3], [5, 6, 7], [8]]
    assert padded == 1                 # the group of 3 ran in bucket 4
    assert snap["serve_batches_total{tenant=t}"]["value"] == 3
    assert occ == pytest.approx((1 + 0.75 + 1) / 3, abs=0)


# -------------------------------------------------------------- preempt
def _preempt(m):
    reg = m["registry"].MetricsRegistry()
    guard = m["preempt"].PreemptionGuard(registry=reg)
    flushed = threading.Event()
    guard.add_flush_hook(flushed.set)
    before = signal.getsignal(signal.SIGTERM)
    with guard:
        assert guard.install() is guard          # idempotent
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert flushed.wait(10)
        deadline = time.monotonic() + 10
        counter = reg.counter("preemptions_total", signal="SIGTERM")
        while counter.value < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        out = (guard.requested, guard.signum, counter.value)
    restored = signal.getsignal(signal.SIGTERM) is before
    other = m["preempt"].PreemptionGuard(registry=reg)
    other.request()
    return out + (restored, other.requested, other.signum)


def test_preemption_guard_sets_the_flag_as_jax():
    assert _preempt(PORT) == _preempt(JAX) == (
        True, signal.SIGTERM, 1.0, True, True, None)
