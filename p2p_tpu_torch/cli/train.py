"""Training CLI (counterpart of ``p2p_tpu/cli/train.py``): the JAX flag
names, unset flags inheriting from ``--preset``:

    python -m p2p_tpu_torch.cli.train --preset reference \\
        --data_root <dataset root> --workdir <run dir> [--nepoch 200] \\
        [--epochsave 20] [--device cuda|cpu]

It resumes from the newest intact checkpoint under
``<workdir>/<checkpoint_dir>/<dataset>/<name>/`` when there is one (at the
exact next sample, from its iterator sidecar), then trains to
``--nepoch`` (train/loop.py ``Trainer``). The card is the default device;
the CPU runs only with ``--device cpu``.

Exit codes, as the JAX CLI's: 0 done; 75 preempted (SIGTERM/SIGINT, or
``P2P_CHAOS=elastic@N``) after an exact-step checkpoint: relaunch with the
same flags to resume; 76 diverged, the recovery ladder exhausted
(``--max_rollbacks``): do not relaunch unchanged; 2 a flag the port does
not have. ``--tensorboard`` writes event files under
``<workdir>/tb/<name>/`` where the ``tensorboard`` package is installed
(else a note, and the run goes on); ``--prom_textfile PATH`` keeps the
run's registry in Prometheus text format at PATH.

A config with ``n_frames > 1`` (the ``vid2vid_temporal`` preset) trains
clips through train/video_loop.py's ``VideoTrainer``, with the same
resume, exit codes and sinks; it has no fake pool, so ``--pool_size``
above 0 is refused for it (exit 2).

pix2pixHD's coarse-to-fine schedule: ``--phase global`` trains G1 alone
(``pix2pixhd_global``) at half the resolution, with its checkpoints under
``<name>_g1``; ``--phase full`` then trains the whole generator with G1's
weights grafted in from that run's newest step (or from
``--init_g1_from``) when it starts fresh (train/graft.py).

The losses and eval options: ``--lambda_sobel`` (with
``--sobel_warmup_epochs``) and ``--lambda_angular`` add the Sobel-edge and
angular terms to the G loss (train/step.py ``make_g_loss_fn``);
``--eval_fid`` adds VFID to each eval (loading VGG19 whatever
``--lambda_vgg`` is); ``--save_masks`` writes ``e{epoch}_mask.png`` beside
the samples; ``--threads N`` reads a split of more than 64 items that is
not memoized with N loader worker processes.

Data parallel on several cards (or CPU processes): start the CLI with
``torchrun`` (``python -m torch.distributed.run --nproc_per_node N -m
p2p_tpu_torch.cli.train ...``): each rank joins the default group (NCCL on
the cards, gloo with ``--device cpu``; one that fails to form exits non-zero
and nothing falls back) and trains its stride of each global batch
(``--batch_size`` is the global batch) on ``cuda:LOCAL_RANK``. ``--mesh``
sets the mesh in either grammar (``data=-1``, ``data=2,fsdp=2``,
``4,1,1``); ``--fsdp_params`` splits the parameters too when ``fsdp`` > 1
(train/loop.py, parallel/). A ``spatial`` axis wider than one splits the
images along H over its ranks (``pix2pixhd`` and ``cityscapes_spatial``
carry ``data=-1,spatial=2`` in their own mesh; ``--mesh 1,2,1`` names it);
a ``time`` axis splits each clip's frames (``vid2vid_temporal`` carries
``data=-1,time=4``: at world size 4 it trains on it); a ``model`` axis
runs Megatron tensor parallelism over each conv pair of at least
``--tp_min_ch`` channels (``--mesh 1,1,1,2``), int8 included. On a
``pipe`` axis wider than one the trainer prints JAX's warning and runs
flat, the pipe ranks as replicas (the GPipe step is train/step.py
``build_pp_train_step``); ``--pp_overlap`` sets that step's schedule.
``--recalibrate_steps N`` holds the int8 scales frozen for N steps after
a model-width migration under delayed int8 (``tp_amax_recalibrate``) or a
restore that initialized scales the checkpoint lacked. The axis
combinations the port does not compose and the options a parallel step
refuses by name exit 2; a ``--mesh`` wider than the launch's processes
exits 2 saying so. A relaunch on another
process count, mesh or global batch resumes elastically;
``--no-elastic`` makes any topology change exit 2 with the
``TopologyMismatch`` text, and a dtype change exits 2 unless
``--cast_on_restore``. A plain ``python -m p2p_tpu_torch.cli.train`` is one
process with no group.

A flag of the JAX CLI whose feature the port does not have (tensor and
pipeline parallelism, scan steps, …) is refused by name with exit code 2
unless it is left at its default.
"""

from __future__ import annotations

import argparse
import sys

from p2p_tpu_torch.cli import add_unported, apply_overrides, refuse_unported
from p2p_tpu_torch.train.schedules import LR_POLICIES

_TRUE = {"action": "store_true"}
_BOOL = {"action": argparse.BooleanOptionalAction}
UNPORTED = (
    ("scan_steps", 1, {"type": int}),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="p2p_tpu_torch training")
    p.add_argument("--preset", type=str, default="reference")
    p.add_argument("--data_root", type=str, default=None,
                   help="dataset root (default <data.root>/<dataset>)")
    p.add_argument("--workdir", type=str, default=".",
                   help="checkpoints, samples and metrics land here")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--cuda", action="store_true",
                   help="run on the card (the default)")
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--n_blocks", type=int, default=None)
    p.add_argument("--upsample_mode", type=str, default=None,
                   choices=["deconv", "subpixel", "resize"],
                   help="U-Net decoder upsampling")
    p.add_argument("--augment", action="store_true", default=None)
    p.add_argument("--int8", action="store_true", default=None,
                   help="int8 QAT for the discriminator's inner convs "
                        "(ops/int8.py); --int8_generator extends it to G")
    p.add_argument("--int8_generator", action="store_true", default=None,
                   help="extend --int8 to the generator: the U-Net "
                        "encoder, the ResNet-family residual trunks")
    p.add_argument("--int8_stem", action="store_true", default=None,
                   help="extend the int8 path to the 3/6-channel input "
                        "stems (U-Net down0, PatchGAN stage 0)")
    p.add_argument("--int8_head", action="store_true", default=None,
                   help="discriminator logits head on the int8 kn2row "
                        "path (ops/int8.py int8_kn2row_conv); the U-Net "
                        "image head always stays in the compute dtype")
    p.add_argument("--int8_compression", action="store_true", default=None,
                   help="CompressionNetwork (net_c) convs on the int8 "
                        "path, with stored scales under --int8_delayed")
    p.add_argument("--int8_delayed", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--int8_fused_epilogue", action="store_true",
                   default=None)
    p.add_argument("--norm_d", type=str, default=None,
                   choices=["none", "instance", "pallas_instance"])
    p.add_argument("--thin_head", action="store_true", default=None)
    p.add_argument("--legacy_layout", action="store_true", default=None)
    p.add_argument("--health", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the in-step skip guard (on by default)")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--epoch_count", type=int, default=None)
    p.add_argument("--nepoch", type=int, default=None)
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--niter_decay", type=int, default=None)
    p.add_argument("--epochsave", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--test_batch_size", type=int, default=None)
    p.add_argument("--direction", type=str, default=None,
                   choices=["a2b", "b2a"])
    p.add_argument("--input_nc", type=int, default=None)
    p.add_argument("--output_nc", type=int, default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--ndf", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_policy", type=str, default=None,
                   choices=list(LR_POLICIES),
                   help="lambda|step|plateau|cosine")
    p.add_argument("--lr_decay_iters", type=int, default=None,
                   help="the step policy's period in epochs")
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--moment_dtype", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--lamb", type=float, default=None, help="L1 weight")
    p.add_argument("--lambda_vgg", type=float, default=None)
    p.add_argument("--lambda_feat", type=float, default=None)
    p.add_argument("--lambda_tv", type=float, default=None)
    p.add_argument("--lambda_sobel", type=float, default=None,
                   help="Sobel edge-L1 weight (the reference's commented "
                        "edge experiment; 0 = off)")
    p.add_argument("--sobel_warmup_epochs", type=int, default=None,
                   help="ramp the sobel weight linearly over this many "
                        "epochs (0 = constant)")
    p.add_argument("--lambda_angular", type=float, default=None,
                   help="mean-angular-error weight (the reference's "
                        "commented experiment; 0 = off)")
    p.add_argument("--threads", type=int, default=None,
                   help="loader worker processes for a split of more than "
                        "64 items that is not memoized (default 4)")
    p.add_argument("--save_masks", action="store_true", default=None,
                   help="write e<epoch>_mask.png = uint8(pred) AND "
                        "uint8(input) with the eval samples")
    p.add_argument("--eval_fid", action="store_true", default=None,
                   help="VFID (Fréchet distance of VGG19 features) in each "
                        "eval; the feature source (pretrained npz or "
                        "random) is reported")
    p.add_argument("--log_every", type=int, default=None)
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA generator decay (e.g. 0.999): the state "
                        "carries smoothed G weights, eval/serve use them "
                        "(0 = EMA tracks raw params exactly — the parity "
                        "mode; unset = off)")
    p.add_argument("--grad_clip", type=float, default=None,
                   help="global-norm gradient clipping (0 = off; guards "
                        "per-sample-norm backward blowups on degenerate "
                        "images — see train/state.py)")
    p.add_argument("--pool_size", type=int, default=None,
                   help="historical-fake pool fed to D (reference "
                        "ImagePool(0) = passthrough); >0 enables a "
                        "device-side ring buffer")
    p.add_argument("--phase", choices=["global", "full"], default=None,
                   help="pix2pixHD coarse-to-fine schedule: 'global' trains "
                        "G1 alone at half resolution (checkpoints under "
                        "<name>_g1); 'full' trains the enhancer-wrapped "
                        "generator with the phase-1 G1 weights grafted in")
    p.add_argument("--compilation_cache", type=str, default=None,
                   help="directory the CUDA kernel libraries are built "
                        "into and reused from (core/cache.py)")
    p.add_argument("--max_rollbacks", type=int, default=None,
                   help="recovery-ladder rollbacks before exit 76 "
                        "(default 3)")
    p.add_argument("--spike_zscore", type=float, default=None,
                   help="divergence sentinel: robust z-score of a spike "
                        "(default 6.0)")
    p.add_argument("--cooldown_steps", type=int, default=None,
                   help="ladder rung 2: steps at cooldown_factor x LR "
                        "(default 20)")
    p.add_argument("--health_window", type=int, default=None,
                   help="sentinel window of healthy steps (default 32)")
    p.add_argument("--check_finite", action="store_true", default=None,
                   help="read every step's metrics on the host; a "
                        "non-finite one is recorded, then raises (a fence)")
    p.add_argument("--nan_sentinel", action="store_true", default=None,
                   help="per-leaf NaN/Inf counts of every step's metrics, "
                        "read one step late (no fence)")
    p.add_argument("--grad_norms", action="store_true", default=None,
                   help="grad_norm_g / grad_norm_d in the step metrics")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files under "
                        "<workdir>/tb/<name>/")
    p.add_argument("--prom_textfile", type=str, default=None,
                   help="keep the run's metrics in Prometheus text format "
                        "at this path (node_exporter's textfile "
                        "collector)")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh axes: positional 'data,spatial,time[,model[,"
                        "pipe]]' or named 'axis=size,...' over data/fsdp/"
                        "spatial/time/model/pipe (data may be -1 = every "
                        "process); on pipe>1 the trainer runs flat, the "
                        "pipe ranks as replicas")
    p.add_argument("--tp_min_ch", type=int, default=None,
                   help="tensor parallelism (mesh model>1): the smallest "
                        "channel count a Megatron pair shards (default "
                        "512)")
    p.add_argument("--fsdp_params", action="store_true", default=None,
                   help="with mesh fsdp>1: split the parameters too, "
                        "gathered on use, not only the Adam moments and "
                        "the EMA")
    p.add_argument("--elastic", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="elastic relaunch: on resume, reshard or migrate "
                        "the checkpoint onto this launch's topology (on by "
                        "default); --no-elastic: any topology change "
                        "exits 2")
    p.add_argument("--cast_on_restore",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="a mixed-precision or --moment_dtype change on "
                        "resume is an explicit, logged cast instead of "
                        "exit 2")
    p.add_argument("--init_g1_from", type=str, default=None,
                   help="explicit phase-1 checkpoint dir for --phase full "
                        "(default: checkpoint/<dataset>/<name>_g1)")
    p.add_argument("--pp_overlap", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the pipelined step's latency-hiding schedule (the "
                        "stage hand-off under the next tick's blocks)")
    p.add_argument("--recalibrate_steps", type=int, default=None,
                   help="after a model-width migration under delayed "
                        "int8, or a restore that initialized int8 scales, "
                        "hold the scales frozen for this many steps")
    add_unported(p, UNPORTED)
    return p


def config_from_flags(args: argparse.Namespace):
    """The preset, overridden by every flag that was set."""
    import dataclasses

    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset(args.preset)
    over = apply_overrides
    model = over(cfg.model, input_nc=args.input_nc, output_nc=args.output_nc,
                 ngf=args.ngf, ndf=args.ndf, n_blocks=args.n_blocks,
                 upsample_mode=args.upsample_mode, int8=args.int8,
                 int8_delayed=args.int8_delayed,
                 int8_generator=args.int8_generator,
                 int8_stem=args.int8_stem, int8_head=args.int8_head,
                 int8_compression=args.int8_compression,
                 int8_fused_epilogue=args.int8_fused_epilogue,
                 legacy_layout=args.legacy_layout, thin_head=args.thin_head,
                 norm_d=args.norm_d)
    loss = over(cfg.loss, lambda_l1=args.lamb, lambda_vgg=args.lambda_vgg,
                lambda_feat=args.lambda_feat, lambda_tv=args.lambda_tv,
                lambda_sobel=args.lambda_sobel,
                sobel_warmup_epochs=args.sobel_warmup_epochs,
                lambda_angular=args.lambda_angular)
    optim = over(cfg.optim, lr=args.lr, lr_policy=args.lr_policy,
                 lr_decay_iters=args.lr_decay_iters, beta1=args.beta1,
                 niter=args.niter, niter_decay=args.niter_decay,
                 grad_clip=args.grad_clip, moment_dtype=args.moment_dtype)
    data = over(cfg.data, dataset=args.dataset, direction=args.direction,
                batch_size=args.batch_size, image_size=args.image_size,
                image_width=args.image_width,
                test_batch_size=args.test_batch_size, augment=args.augment,
                threads=args.threads)
    if args.image_size is not None and args.image_width is None \
            and data.image_width is not None:
        # a square --image_size overrides a rectangular preset wholesale
        data = dataclasses.replace(data, image_width=None)
    train = over(cfg.train, nepoch=args.nepoch, epoch_count=args.epoch_count,
                 epoch_save=args.epochsave, seed=args.seed,
                 log_every=args.log_every, pool_size=args.pool_size,
                 compilation_cache_dir=args.compilation_cache,
                 eval_fid=args.eval_fid, save_masks=args.save_masks,
                 elastic=args.elastic, cast_on_restore=args.cast_on_restore,
                 recalibrate_steps=args.recalibrate_steps)
    parallel = over(cfg.parallel, fsdp_params=args.fsdp_params,
                    tp_min_ch=args.tp_min_ch, pp_overlap=args.pp_overlap)
    if args.mesh is not None:
        from p2p_tpu_torch.core.mesh import parse_mesh_arg

        parallel = dataclasses.replace(parallel,
                                       mesh=parse_mesh_arg(args.mesh))
    debug = over(cfg.debug, check_finite=args.check_finite,
                 nan_sentinel=args.nan_sentinel, grad_norms=args.grad_norms)
    health = over(cfg.health, enabled=args.health, ema_decay=args.ema_decay,
                  max_rollbacks=args.max_rollbacks,
                  spike_zscore=args.spike_zscore,
                  cooldown_steps=args.cooldown_steps,
                  window=args.health_window)
    cfg = cfg.replace(name=args.name or cfg.name, model=model, loss=loss,
                      optim=optim, data=data, train=train, health=health,
                      debug=debug, parallel=parallel)
    if args.phase == "global":
        # coarse-to-fine phase 1, after the flags: an explicit --image_size
        # or --name is halved or suffixed as phase 2 expects to find it
        from p2p_tpu_torch.train.graft import g1_phase_config

        cfg = g1_phase_config(cfg)
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = refuse_unported(args, UNPORTED)
    if rc:
        return rc
    if args.cuda and args.device not in (None, "cuda"):
        print("--cuda contradicts --device", file=sys.stderr)
        return 2
    from p2p_tpu_torch.core.mesh import (check_ported_axes,
                                         distributed_init, process_count,
                                         rank_device)
    try:
        cfg = config_from_flags(args)
        if args.mesh is not None:
            check_ported_axes(cfg.parallel.mesh)
    except (ValueError, NotImplementedError) as e:
        if args.mesh is None:
            raise
        print(f"--mesh {args.mesh!r}: {e}", file=sys.stderr)
        return 2
    if cfg.data.n_frames > 1 and cfg.train.pool_size > 0:
        print(f"--pool_size {cfg.train.pool_size}: preset {cfg.name!r} "
              "trains video clips, and the video step has no fake pool",
              file=sys.stderr)
        return 2

    if cfg.data.n_frames > 1:
        from p2p_tpu_torch.train.video_loop import VideoTrainer as Trainer
    else:
        from p2p_tpu_torch.train.loop import Trainer

    import torch.distributed as dist

    # the group torchrun's environment names (a caller may have formed one)
    formed = not dist.is_initialized() and distributed_init(
        rank_device(args.device))
    if not dist.is_initialized() and args.mesh is not None:
        try:
            cfg.parallel.mesh.resolve(process_count())
        except ValueError as e:
            print(f"--mesh {args.mesh!r}: {e} (the mesh is wider than "
                  f"this launch's {process_count()} process(es): start "
                  "several processes with torchrun)", file=sys.stderr)
            return 2
    try:
        return _run(Trainer, cfg, args)
    except NotImplementedError as e:
        # a parallel step's refusal by name (the time, model or spatial
        # step's check)
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    finally:
        if formed:
            dist.destroy_process_group()


def _run(Trainer, cfg, args: argparse.Namespace) -> int:
    """Build the trainer, resume and fit; the exit code."""
    from p2p_tpu_torch.core.mesh import TopologyMismatch
    from p2p_tpu_torch.resilience import (DIVERGED_EXIT_CODE,
                                          PREEMPTED_EXIT_CODE,
                                          DivergenceError, Preempted)
    try:
        trainer = Trainer(cfg, data_root=args.data_root,
                          workdir=args.workdir, device=args.device)
    except NotImplementedError as e:
        print(f"not ported yet: {e}", file=sys.stderr)
        return 2
    try:
        attach_sinks(trainer, args)
        try:
            resumed = trainer.maybe_resume()
        except TopologyMismatch as tm:
            # a flags problem, not a transient: exit 2, not 75
            print(f"topology mismatch: {tm}", file=sys.stderr, flush=True)
            return 2
        if resumed:
            print(f"resumed at epoch {trainer.epoch} (step "
                  f"{trainer.state.step})", flush=True)
        elif args.phase == "full":
            from p2p_tpu_torch.train.graft import load_and_graft_g1

            from p2p_tpu_torch.parallel.tp import tp_full

            with tp_full(trainer.state):
                load_and_graft_g1(trainer.state, cfg, workdir=args.workdir,
                                  g1_dir=args.init_g1_from)
        trainer.fit()
    except Preempted as p:
        # the exact step is on disk: "re-run these flags" resumes it
        print(f"preempted: checkpoint saved at step {p.step} — "
              f"relaunch with identical flags to resume "
              f"(exit {PREEMPTED_EXIT_CODE})", flush=True)
        return PREEMPTED_EXIT_CODE
    except DivergenceError as d:
        # rolled back max_rollbacks times and diverged again: relaunching
        # the same flags would diverge again
        print(f"diverged: {d} (exit {DIVERGED_EXIT_CODE})", flush=True)
        trainer.logger.registry.flush()
        return DIVERGED_EXIT_CODE
    finally:
        # the sinks (the JSONL file, a last Prometheus export)
        trainer.logger.close()
    return 0


def attach_sinks(trainer, args: argparse.Namespace) -> None:
    """The optional sinks of ``--tensorboard`` and ``--prom_textfile``."""
    import os

    from p2p_tpu_torch.obs import PrometheusTextfileSink, TensorBoardSink

    reg = trainer.logger.registry
    if args.tensorboard:
        try:
            reg.add_sink(TensorBoardSink(
                os.path.join(args.workdir, "tb", trainer.cfg.name)))
        except ImportError as e:
            print(f"note: --tensorboard unavailable ({e}); continuing "
                  "with JSONL/stdout only", file=sys.stderr)
    if args.prom_textfile:
        reg.add_sink(PrometheusTextfileSink(args.prom_textfile, reg))


if __name__ == "__main__":
    sys.exit(main())
