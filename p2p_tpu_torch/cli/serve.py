"""Serving CLI (counterpart of ``p2p_tpu/cli/serve.py:58-508``):
directory-watching and HTTP frontends over the engine, one request
lifecycle (serve/frontend.py: bounded queue, shedding, deadlines,
decode retry with backoff, quarantine, bucket occupancy).

**Directory mode** (the default) serves image files dropped into
``--input_dir`` and writes predictions named after them under ``--out``
(default ``<input_dir>_out``), grouping arrivals as the HTTP tenants do
(serve/batcher.py: up to ``--max_batch``, lingering at most
``--linger_ms`` from the oldest). ``--once`` serves the directory's
current contents and exits; otherwise it watches (every ``--poll_ms``)
until ``--max_requests`` are served. Poison files go to
``--quarantine_dir`` (default ``<input_dir>/failed``) after
``--max_attempts`` failed decodes.

    python -m p2p_tpu_torch.cli.serve --input_dir reqs --workdir run \\
        [--preset reference] [--step N] [--once | --max_requests N]

**HTTP mode** (``--http HOST:PORT``; port 0 binds a free one) serves
``POST /v1/<tenant>/translate`` (PNG body → PNG), ``/healthz``,
``/metrics`` and ``POST /admin/reload`` (hot-swap) with one or more
tenants resident in the process (``--tenant alias=hd,preset=pix2pixhd,
step=2``, repeatable; keys alias preset name dataset step image_size
image_width ngf n_blocks), batched continuously across requests;
SIGTERM drains (stop admitting, run the queues down) and exits 0 after
one ``serve_summary`` line per tenant.

    python -m p2p_tpu_torch.cli.serve --http 127.0.0.1:8000 --workdir run \\
        --tenant alias=ref,preset=reference --tenant alias=hd,preset=pix2pixhd

G (and net_c) are restored from the newest intact step under
``<workdir>/<checkpoint_dir>/<dataset>/<name>/`` (or exactly ``--step``),
reading no discriminator or optimizer file; with ``--ema_decay`` (or the
tenant key ``ema_decay=``) G's parameters are the step's EMA generator. In
directory mode ``--weights g.npz`` (flax generator variables,
``convert.save_npz``) serves G from that file instead. Requests are PNGs
(the port's stdlib decoder; no Pillow), resized bicubic to the preset's size. A preset with
a compression net serves the request image as its target. The card is
the default device (``--device cpu`` to serve on the CPU);
``--compilation_cache DIR`` builds the CUDA kernel libraries into (and
reuses them from) DIR (core/cache.py); flags of features the port lacks
are refused by name (exit 2), and so is a video preset (``n_frames >
1``), whose clips ``cli/infer.py`` serves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from p2p_tpu_torch.cli import add_unported, apply_overrides, refuse_unported
from p2p_tpu_torch.serve.frontend import default_buckets

UNPORTED = (
    ("mesh", None, {"type": str}), ("tp_min_ch", None, {"type": int}),
)
TENANT_KEYS = {"alias", "preset", "name", "dataset", "step", "image_size",
               "image_width", "ngf", "n_blocks", "ema_decay"}
VIDEO_REFUSAL = "serve covers image presets; use cli/infer.py for video"
# the tenant keys that take a number, and its type
_NUMERIC_KEYS = {"step": int, "image_size": int, "image_width": int,
                 "ngf": int, "n_blocks": int, "ema_decay": float}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="p2p_tpu_torch serving")
    p.add_argument("--preset", type=str, default="reference")
    p.add_argument("--name", type=str, default=None,
                   help="training name (checkpoint subdir; default preset)")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to serve (default: newest intact)")
    p.add_argument("--workdir", type=str, default=".")
    p.add_argument("--weights", type=str, default=None,
                   help="directory mode: serve G from this .npz of flax "
                        "generator variables instead of a checkpoint")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--input_dir", type=str, default=None,
                   help="directory mode's request directory (required "
                        "unless --http)")
    p.add_argument("--out", type=str, default=None,
                   help="prediction dir (default <input_dir>_out)")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--n_blocks", type=int, default=None)
    p.add_argument("--once", action="store_true",
                   help="serve the directory's current contents and exit")
    p.add_argument("--max_requests", type=int, default=None,
                   help="watch mode: exit after this many served requests")
    p.add_argument("--max_batch", type=int, default=16,
                   help="group cap (also the largest default bucket)")
    p.add_argument("--linger_ms", type=float, default=50.0,
                   help="longest wait for stragglers before a partial "
                        "group is dispatched")
    p.add_argument("--poll_ms", type=float, default=200.0,
                   help="directory scan cadence in watch mode")
    p.add_argument("--buckets", type=str, default=None,
                   help="comma-separated batch buckets (default: powers of "
                        "two up to --max_batch)")
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=["bf16", "f32"])
    p.add_argument("--ema_decay", type=float, default=None,
                   help="the checkpoint was trained with --ema_decay: "
                        "restore the EMA generator weights and serve the "
                        "SMOOTHED G (bitwise == raw at decay 0)")
    p.add_argument("--io_threads", type=int, default=4,
                   help="PNG encode threads")
    p.add_argument("--compilation_cache", type=str, default=None,
                   metavar="DIR",
                   help="directory the CUDA kernel libraries are built "
                        "into and reused from")
    p.add_argument("--http", type=str, default=None, metavar="HOST:PORT",
                   help="serve over HTTP instead of a watched directory")
    p.add_argument("--tenant", action="append", default=None,
                   metavar="SPEC",
                   help="HTTP mode: a resident model, repeatable; SPEC is "
                        "key=value,... over the base flags (keys: "
                        f"{' '.join(sorted(TENANT_KEYS))}). Default: one "
                        "tenant from the base flags")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="HTTP mode: seconds after SIGTERM to run the "
                        "queues down before stragglers are answered 503")
    p.add_argument("--tenant_quota", type=int, default=None,
                   help="HTTP mode: most requests in flight per tenant; "
                        "more get 429 (default: unlimited)")
    p.add_argument("--max_queue", type=int, default=512,
                   help="queue depth cap; arrivals beyond it are shed")
    p.add_argument("--deadline_ms", type=float, default=0.0,
                   help="per-request deadline from arrival (0 = none)")
    p.add_argument("--max_attempts", type=int, default=3,
                   help="decode attempts before quarantine (HTTP: 422)")
    p.add_argument("--retry_delay_ms", type=float, default=1000.0,
                   help="base delay between decode attempts (doubles)")
    p.add_argument("--quarantine_dir", type=str, default=None,
                   help="where poison inputs go (default "
                        "<input_dir>/failed)")
    p.add_argument("--chaos", type=str, default=None, metavar="SPEC",
                   help="arm fault injection, e.g. 'decode:0.3' or "
                        "'serve_write:0.2x5' (P2P_CHAOS works too)")
    add_unported(p, UNPORTED)
    return p


def _build_config(args, overrides=None):
    """One tenant's Config from the base flags and a tenant spec's
    overrides ({key: str})."""
    from p2p_tpu_torch.core.config import get_preset

    ov = dict(overrides or {})

    def get(key, cast, default):
        return cast(ov[key]) if key in ov else default

    cfg = get_preset(ov.get("preset", args.preset))
    return cfg.replace(
        name=get("name", str, args.name) or cfg.name,
        data=apply_overrides(
            cfg.data, dataset=get("dataset", str, args.dataset),
            image_size=get("image_size", int, args.image_size),
            image_width=get("image_width", int, args.image_width)),
        model=apply_overrides(cfg.model, ngf=get("ngf", int, args.ngf),
                              n_blocks=get("n_blocks", int, args.n_blocks)),
        health=apply_overrides(
            cfg.health, ema_decay=get("ema_decay", float, args.ema_decay)))


def _parse_tenant_spec(spec: str):
    """'alias=hd,preset=pix2pixhd,step=2' → (alias, {key: value}).
    Raises ``ValueError`` on an unknown key or a value that is not a
    number where one is wanted."""
    kv = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq or k not in TENANT_KEYS:
            raise ValueError(f"bad --tenant entry {part!r} (allowed keys: "
                             f"{sorted(TENANT_KEYS)})")
        if k in _NUMERIC_KEYS:
            try:
                _NUMERIC_KEYS[k](v)
            except ValueError:
                raise ValueError(f"bad --tenant value {k}={v!r} (wants "
                                 f"{_NUMERIC_KEYS[k].__name__})") from None
        kv[k] = v
    alias = kv.pop("alias", None) or kv.get("name") or kv.get("preset")
    if not alias:
        raise ValueError(f"--tenant {spec!r} needs an alias= (or name=/"
                         "preset= to derive one)")
    return alias, kv


def _engine_kw(args, buckets):
    return dict(buckets=buckets, dtype=args.dtype, device=args.device,
                io_workers=args.io_threads)


def _serve_http(args, buckets) -> int:
    """N resident tenants, continuous batching, hot-swap, graceful drain
    (serve/server.py)."""
    from p2p_tpu_torch.obs import get_registry
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos
    from p2p_tpu_torch.serve.server import ServeApp, run_server
    from p2p_tpu_torch.serve.tenancy import Tenant, checkpoint_dir
    from p2p_tpu_torch.train.checkpoint import CheckpointCorrupt

    host, _, port = args.http.rpartition(":")
    host = host or "0.0.0.0"
    try:
        port = int(port)
    except ValueError:
        print(f"--http wants HOST:PORT, got {args.http!r}", file=sys.stderr)
        return 2
    try:
        specs = ([_parse_tenant_spec(s) for s in args.tenant]
                 if args.tenant else [(None, {})])
    except (ValueError, NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 2
    reg = get_registry()
    prev_chaos = None
    if args.chaos:
        prev_chaos = install_chaos(
            ChaosMonkey.from_spec(args.chaos, registry=reg))
    app = ServeApp(
        registry=reg, io_threads=args.io_threads, max_queue=args.max_queue,
        deadline_ms=args.deadline_ms, linger_ms=args.linger_ms,
        group_cap=args.max_batch, max_attempts=args.max_attempts,
        retry_delay_ms=args.retry_delay_ms, tenant_quota=args.tenant_quota)
    try:
        for alias, ov in specs:
            cfg = _build_config(args, ov)
            if cfg.data.n_frames > 1:
                print(VIDEO_REFUSAL, file=sys.stderr)
                return 2
            alias = alias or cfg.name
            if alias in app.tenants:
                print(f"duplicate tenant alias {alias!r}: give each "
                      "--tenant a distinct alias=", file=sys.stderr)
                return 2
            step = int(ov["step"]) if "step" in ov else args.step
            t0 = time.perf_counter()
            try:
                tenant = Tenant(alias, cfg, checkpoint_dir(cfg, args.workdir),
                                step=step, registry=reg,
                                **_engine_kw(args, buckets))
            except (FileNotFoundError, CheckpointCorrupt, ValueError) as e:
                print(f"tenant {alias!r}: {e}", file=sys.stderr)
                return 1
            tenant.warmup()
            app.add_tenant(tenant)
            print(f"tenant {alias!r}: checkpoint step {tenant.step}, "
                  f"{len(tenant.engine.buckets)} buckets warmed in "
                  f"{time.perf_counter() - t0:.2f}s on {tenant.engine.device} "
                  f"(buckets {list(tenant.engine.buckets)})", flush=True)
        return run_server(app, host, port, drain_timeout_s=args.drain_timeout)
    finally:
        if args.chaos:
            install_chaos(prev_chaos)


def _directory_engine(args, cfg, buckets):
    """``(engine, step)``: G from ``--weights`` (step None) or restored
    from the run's checkpoints."""
    from p2p_tpu_torch.serve.engine import (InferenceEngine,
                                            engine_from_checkpoint)
    from p2p_tpu_torch.serve.tenancy import checkpoint_dir

    if args.weights:
        from p2p_tpu_torch.convert import load_generator
        from p2p_tpu_torch.models.registry import define_G

        g = load_generator(define_G(cfg.model, image_hw=cfg.image_hw),
                           args.weights)
        return InferenceEngine(cfg, g, **_engine_kw(args, buckets)), None
    return engine_from_checkpoint(cfg, checkpoint_dir(cfg, args.workdir),
                                  step=args.step,
                                  **_engine_kw(args, buckets))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = refuse_unported(args, UNPORTED)
    if rc:
        return rc
    if args.compilation_cache:
        # the kernel libraries are built into (and reused from) this
        # directory (core/cache.py), before any is loaded
        from p2p_tpu_torch.core.cache import enable_compilation_cache

        enable_compilation_cache(args.compilation_cache)
    buckets = ([int(b) for b in args.buckets.split(",")] if args.buckets
               else default_buckets(args.max_batch))
    if args.weights and args.ema_decay is not None:
        print("--ema_decay serves a checkpoint's EMA generator; --weights "
              "holds one generator and no EMA", file=sys.stderr)
        return 2
    if args.http:
        if args.weights:
            print("--weights serves directory mode only: HTTP tenants are "
                  "restored from checkpoints", file=sys.stderr)
            return 2
        return _serve_http(args, buckets)
    if not args.input_dir:
        print("--input_dir is required in directory mode (or pass --http)",
              file=sys.stderr)
        return 2

    from p2p_tpu_torch.data.generate import is_image_file
    from p2p_tpu_torch.data.pipeline import load_image
    from p2p_tpu_torch.obs import get_registry
    from p2p_tpu_torch.resilience import (BoundedRequestQueue, ChaosMonkey,
                                          Quarantine, chaos_point,
                                          install_chaos)
    from p2p_tpu_torch.serve.batcher import ContinuousBatcher
    from p2p_tpu_torch.serve.frontend import DispatchLoop
    from p2p_tpu_torch.serve.io import AsyncImageWriter
    from p2p_tpu_torch.train.checkpoint import CheckpointCorrupt

    cfg = _build_config(args)
    if cfg.data.n_frames > 1:
        print(VIDEO_REFUSAL, file=sys.stderr)
        return 2
    h, w = cfg.image_hw
    as_uint8 = cfg.data.uint8_pipeline
    try:
        engine, step = _directory_engine(args, cfg, buckets)
    except (FileNotFoundError, CheckpointCorrupt) as e:
        print(str(e), file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    engine.warmup()
    source = args.weights if step is None else f"checkpoint step {step}"
    print(f"serving {source}: {len(engine.buckets)} buckets warmed in "
          f"{time.perf_counter() - t0:.2f}s on {engine.device} "
          f"(buckets {list(engine.buckets)})", flush=True)

    out_dir = args.out or args.input_dir.rstrip("/") + "_out"
    os.makedirs(out_dir, exist_ok=True)
    reg = get_registry()
    prev_chaos = None
    if args.chaos:
        prev_chaos = install_chaos(
            ChaosMonkey.from_spec(args.chaos, registry=reg))
    # counters are tagged with the model's name, as the HTTP frontend's
    tenant = cfg.name
    queue = BoundedRequestQueue(
        max_depth=args.max_queue,
        deadline_s=(args.deadline_ms / 1e3) if args.deadline_ms > 0
        else None, registry=reg, tenant=tenant)
    # the HTTP tenants' batching policy: a full group when loaded, else
    # linger from the oldest request, then the largest full bucket
    batcher = ContinuousBatcher(queue, engine.buckets,
                                group_cap=args.max_batch,
                                linger_s=args.linger_ms / 1e3)
    quarantine = Quarantine(
        args.quarantine_dir or os.path.join(args.input_dir, "failed"),
        registry=reg, tenant=tenant)
    # a write that fails for good is recorded, never fatal
    writer = AsyncImageWriter(args.io_threads, fail_fast=False)
    retry_delay = args.retry_delay_ms / 1e3
    seen = set()

    def decode_req(req):
        # the request image fills the batch keys the engine reads (the
        # target too, with a compression net); the `decode` chaos seam is
        # here, where retry and quarantine surround it
        chaos_point("decode")
        return load_image(os.path.join(args.input_dir, req.name), h, w,
                          as_uint8=as_uint8)

    def deliver(reqs, pred, n_real):
        writer.submit_batch(pred, [
            os.path.join(out_dir, os.path.splitext(r.name)[0] + ".png")
            for r in reqs])

    def on_poison(req, e):
        dest = quarantine.quarantine(
            os.path.join(args.input_dir, req.name),
            f"{req.attempts} failed decodes; last: {e!r}")
        print(f"WARNING: quarantined request {req.name!r} after "
              f"{req.attempts} failed decodes → {dest or 'GONE'}: {e}",
              file=sys.stderr, flush=True)

    def on_expired(req):
        print(f"note: request {req.name!r} exceeded its "
              f"{args.deadline_ms:.0f} ms deadline — dropped",
              file=sys.stderr, flush=True)

    def on_retry_shed(req):
        # a later, quieter scan may offer the file again
        seen.discard(req.name)
        print(f"WARNING: queue full — decode retry for {req.name!r} shed; "
              "the file stays in the input dir for a later scan",
              file=sys.stderr, flush=True)

    loop = DispatchLoop(
        engine, batcher, decode=decode_req, deliver=deliver,
        on_poison=on_poison, on_expired=on_expired,
        on_retry_shed=on_retry_shed, max_attempts=args.max_attempts,
        retry_delay_s=retry_delay, registry=reg, tenant=tenant,
        group_cap=args.max_batch)

    def scan():
        """Offer new arrivals; a shed one leaves ``seen`` so a later scan
        offers it again (``--once`` scans once, so its sheds are
        final)."""
        try:
            entries = sorted(os.listdir(args.input_dir))
        except FileNotFoundError:
            return
        shed_now = 0
        for f in entries:
            if f in seen or not is_image_file(f):
                continue
            seen.add(f)
            if batcher.submit(f) is None:
                seen.discard(f)
                shed_now += 1
        if shed_now:
            print(f"WARNING: queue full ({args.max_queue}) — shed "
                  f"{shed_now} arrivals (files stay in the input dir for "
                  "a later scan)", file=sys.stderr, flush=True)

    try:
        scan()
        if args.once:
            loop.drain()
            while len(batcher):   # wait out backoff windows, then finish
                time.sleep(min(retry_delay / 2, 0.25))
                loop.drain()
        else:
            try:
                while (args.max_requests is None
                       or loop.served < args.max_requests):
                    # no producer thread wakes the batcher: an empty or
                    # lingering queue waits out at most one poll
                    ready, expired = batcher.next_group(
                        timeout=args.poll_ms / 1e3)
                    for req in expired:
                        on_expired(req)
                    if ready:
                        loop.dispatch(ready)
                    else:
                        scan()
            except KeyboardInterrupt:
                loop.drain()
        n_written = writer.drain()
        writer.close()
        for path, err in writer.write_errors:
            print(f"WARNING: prediction write failed permanently for "
                  f"{path!r}: {err}", file=sys.stderr, flush=True)
    finally:
        if args.chaos:
            # chaos is process-wide: in-process callers must not inherit it
            install_chaos(prev_chaos)
    wall = time.perf_counter() - t0
    occ = loop.occupancy_mean
    print(json.dumps({
        "kind": "serve_summary", "tenant": tenant, "served": loop.served,
        "written": n_written, "out_dir": out_dir, "step": step,
        "device": str(engine.device), "buckets": list(engine.buckets),
        "n_warmups": engine.n_warmups,
        "encode_sec": round(writer.encode_sec, 4),
        "wall_sec": round(wall, 4), "shed": queue.shed_count,
        "deadline_expired": queue.expired_count,
        "quarantined": quarantine.count,
        "write_failures": len(writer.write_errors),
        "decode_retries": loop.decode_retries,
        "write_retries": int(reg.counter("retry_attempts_total",
                                         seam="serve_write").value),
        "chaos_injected": int(reg.total("chaos_injected_total")),
        "batch_occupancy_mean": round(occ, 4) if occ is not None else None,
        "padded_images": loop.padded_images,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
