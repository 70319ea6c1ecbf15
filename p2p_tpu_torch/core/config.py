"""Configuration (counterpart of ``p2p_tpu/core/config.py``), cut to the
fields the serving paths, the train steps of the registered presets, the
data pipeline, the trainer (train/loop.py) and data-parallel training
(parallel/) read. Field names, defaults and the preset values are those of
the JAX package, so one preset name means one model in both, its
``parallel=`` mesh included. A preset whose mesh widens ``spatial`` or
``time`` (``cityscapes_spatial``, ``pix2pixhd``, ``vid2vid_temporal``)
trains on one card with those axes resolved as 1 (train/loop.py
``build_trainer_mesh``); on more processes the spatial axis splits H
(slice 13b, parallel/spatial.py) and the time axis each clip's frames
(parallel/temporal.py), and a ``model`` axis (``--mesh ...,model=M``)
runs Megatron tensor parallelism (parallel/tp.py). A ``pipe`` axis is
the GPipe step's (train/step.py ``build_pp_train_step``); the trainer
runs flat on it, the pipe ranks as replicas, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from p2p_tpu_torch.core.mesh import MeshSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # generator family: "expand" (the reference ExpandNetwork, trained),
    # "unet" (the pix2pix U-Net, trained and served), "pix2pixhd"
    # (coarse-to-fine global + local), "pix2pixhd_global" (G1 alone),
    # "resnet" (9-block ResnetGenerator); the last three are served
    generator: str = "expand"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 32
    ndf: int = 64
    n_blocks: int = 9
    # multiscale PatchGAN: num_D scales of n_layers_D inner convs, spectral
    # norm on the inner convs, every intermediate tap kept for the
    # feature-matching loss
    num_D: int = 3
    n_layers_D: int = 3
    use_spectral_norm: bool = True
    get_interm_feat: bool = True
    # the compression pre-filter (net_c) and its quantizer's bits, with a
    # straight-through gradient when quant_ste
    use_compression_net: bool = True
    quant_bits: int = 3
    quant_ste: bool = True
    # "batch" | "instance" | "pallas_instance" | "none"
    norm: str = "batch"
    # discriminator-side norm on the inner convs: "none" | "instance" |
    # "pallas_instance" (stateless kinds only, as the JAX D; affine-free,
    # so the parameter tree does not change)
    norm_d: str = "none"
    # U-Net: dropout 0.5 on three decoder levels in training
    use_dropout: bool = False
    # U-Net decoder upsample: "deconv" (ConvTranspose k4 s2), "subpixel"
    # (k2-s1 conv to 4·F channels + shifted interleave, bias kept) or
    # "resize" (nearest ×2 + reflect-padded k3 conv)
    upsample_mode: str = "deconv"
    # keep the conv biases in front of norms (dead: the norm cancels them)
    legacy_layout: bool = False
    # U-Net image head as the subpixel form (k2-s1 conv to 4·F channels +
    # shifted interleave); with head_pallas its conv runs through the
    # Hopper kernels #6 (forward) and #7 (dx)
    thin_head: bool = False
    head_pallas: bool = False
    # the JAX U-Net's k4-s2 RGB stem (down0) as im2col patches + one
    # matmul, a TPU rewrite of the same conv with the same parameters;
    # the port's stem is the one nn.Conv2d either way (models/unet.py)
    thin_stem: bool = False
    # int8 QAT (ops/int8.py): the discriminator's inner convs (spectral-
    # normed or not) as int8 × int8 → int32 products with dynamic
    # per-tensor activation scales; with int8_delayed the activation scale
    # is a stored amax (a buffer ``amax_x`` per conv, updated by each
    # training-mode forward, read frozen in eval mode)
    int8: bool = False
    int8_delayed: bool = False
    # with int8 + int8_delayed + an instance-family norm_d: each inner
    # conv after the first takes its input quantized by the fused
    # [instance norm + LeakyReLU + clip/round + amax] epilogue (#1 + #4
    # under "pallas_instance")
    int8_fused_epilogue: bool = False
    # with int8: the input stems (U-Net down0 under int8_generator, D's
    # concatenated 6-channel stem), D's logits head on the int8 kn2row
    # path, G (the U-Net encoder; the ResNet-family residual trunks), the
    # U-Net decoder (QuantSubpixelDeconv, with int8_generator) and net_c
    int8_stem: bool = False
    int8_head: bool = False
    int8_generator: bool = False
    int8_decoder: bool = False
    int8_compression: bool = False
    # JAX: feed D the unconcatenated (input, output) pair through a split
    # stem conv with the same parameters and result. Accepted so that one
    # preset means one model in both packages; the port always feeds D the
    # concatenated pair (the split saves memory only under spatial
    # sharding, which the port does not have; models/patchgan.py)
    split_d_pairs: bool = False
    # the kernels' init (models/registry.py apply_init_type): "normal"
    # keeps the reference's N(0, 0.02); "xavier" and "kaiming" re-draw every
    # conv kernel from flax's truncated-normal laws (init_gain unused),
    # "orthogonal" from an orthogonal matrix times init_gain
    init_type: str = "normal"
    init_gain: float = 0.02


@dataclasses.dataclass(frozen=True)
class LossConfig:
    gan_mode: str = "lsgan"          # lsgan | vanilla | hinge
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    lambda_tv: float = 1.0
    # feed VGG [-1, 1] images un-normalized, as the reference does
    vgg_imagenet_norm: bool = False
    lambda_l1: float = 0.0
    # Gram-matrix style loss on the VGG19 taps (losses/style.py; 0 = off)
    lambda_style: float = 0.0
    # Sobel edge L1 between fake and real (ops/sobel.py; 0 = off), its
    # weight ramped linearly over sobel_warmup_epochs epochs (0 = constant)
    lambda_sobel: float = 0.0
    sobel_warmup_epochs: int = 0
    # mean angular error (degrees) of the illumination quotients (0 = off)
    lambda_angular: float = 0.0


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    lr_policy: str = "lambda"        # lambda | step | plateau | cosine
    niter: int = 100                 # epochs at constant lr
    niter_decay: int = 100           # epochs of linear decay to 0
    lr_decay_iters: int = 50         # step policy period (epochs)
    # False is the reference's bug: its optimizer_c never trains net_c
    train_compression_net: bool = True
    # global-norm gradient clipping of each optimizer's gradients, after
    # their non-finite entries are zeroed (0 = off, the reference)
    grad_clip: float = 0.0
    # storage dtype of both Adam moments (None = f32); the arithmetic stays
    # f32 (train/state.py AdamLP)
    moment_dtype: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root: str = "dataset"
    dataset: str = "facades"
    direction: str = "b2a"           # which of a/ and b/ is the input
    image_size: int = 256
    image_width: Optional[int] = None  # None → square
    batch_size: int = 1
    test_batch_size: int = 1
    # loader worker processes for a split that is not memoized and has
    # more than 64 items (data/pipeline.py make_loader)
    threads: int = 4
    # the paired resize-286 / random-crop / flip of the train split
    augment: bool = False
    # frames per clip: > 1 selects the video path (data/video.py,
    # train/video_step.py, train/video_loop.py)
    n_frames: int = 1
    # requests travel host → device as uint8 and are normalized on the
    # device (utils/images.ingest)
    uint8_pipeline: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    nepoch: int = 200
    epoch_count: int = 1             # 1-based epoch label of step 0
    epoch_save: int = 20             # checkpoint every this many epochs
    # seeds the trainer's weight init, each epoch's shuffle and crops
    # (seed + epoch) and the per-step dropout noise (with the step number)
    seed: int = 123
    # per-step "train" records in the metrics JSONL (each one a host sync)
    log_every: int = 50
    checkpoint_dir: str = "checkpoint"
    result_dir: str = "result"
    # the per-epoch eval (off: no eval record, no samples, no mark_good)
    eval_every_epoch: bool = True
    # VFID (Fréchet distance of mean-pooled VGG19 taps, losses/fid.py) in
    # each eval; loads VGG19 whatever lambda_vgg says
    eval_fid: bool = False
    # e{epoch}_mask.png = uint8(pred) AND uint8(input) beside the samples
    save_masks: bool = False
    # bf16 compute on f32 master parameters (core/dtypes.py)
    mixed_precision: bool = True
    # the historical-fake pool of concatenated (input ‖ fake) pairs fed to
    # D (utils/pool.py; 0 = passthrough, the reference)
    pool_size: int = 0
    # the directory the CUDA kernel libraries are built into and reused
    # from (core/cache.py; None = build/torch_ext/ of the checkout)
    compilation_cache_dir: Optional[str] = None
    # torch.autograd's anomaly mode: the backward op that first makes a
    # NaN raises with the forward's trace (a debugging tool, slow)
    debug_nans: bool = False
    # elastic relaunch: on resume, reconcile the checkpoint's recorded
    # topology (process count, mesh axes, global batch, dtype policy) with
    # this launch's and reshard compatible deltas (resilience/reshape.py);
    # False: any delta aborts (exit 2)
    elastic: bool = True
    # a mixed_precision / moment_dtype delta on resume is an explicit,
    # logged cast (MOMENT_MIGRATION) instead of an abort
    cast_on_restore: bool = False
    # after a TP-width amax migration (tp_amax_recalibrate) or a restore
    # that initialized int8 scales a checkpoint lacked, hold the int8
    # scales frozen for this many steps (resilience/reshape.py
    # hold_frozen_quant); 0 = off
    recalibrate_steps: int = 0


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    # the in-step skip guard (a step whose G, D or C loss is not finite
    # leaves parameters, optimizer state and running statistics
    # unchanged) and the trainer's divergence sentinel and recovery ladder
    # (resilience/health.py)
    enabled: bool = True
    # sentinel: robust z-score over the last `window` healthy steps per
    # watched loss; a spike when |z| > spike_zscore, diverged when a
    # watched value is not finite; the EWMA (alpha) recenters the window
    window: int = 32
    spike_zscore: float = 6.0
    ewma_alpha: float = 0.1
    # ladder rung 2: the learning rate times cooldown_factor for
    # cooldown_steps observed steps
    cooldown_steps: int = 20
    cooldown_factor: float = 0.1
    # ladder rung 3: rollbacks to the last eval-validated checkpoint before
    # the run gives up with exit code 76
    max_rollbacks: int = 3
    # a healthy streak this long resets the ladder to rung 0
    reset_after: int = 16
    # the EMA generator: smoothed copies of G's parameters, updated after
    # each applied G step, evaluated and served in G's place (None = off;
    # 0 = a copy of G)
    ema_decay: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class DebugConfig:
    # the trainer reads every step's metrics on the host, writes a
    # kind="nonfinite" record for a non-finite one and raises (a fence)
    check_finite: bool = False
    # per-leaf NaN/Inf counts of every step's metrics, read one step late
    # from a pinned host buffer (obs/taps.py; no fence)
    nan_sentinel: bool = False
    # grad_norm_g / grad_norm_d (and grad_norm_c) in the step's metrics
    grad_norms: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mesh: MeshSpec = MeshSpec(data=-1, spatial=1, time=1)
    # tensor parallelism (mesh model > 1): the smallest channel count a
    # Megatron pair shards (parallel/tp.py)
    tp_min_ch: int = 512
    # with mesh.fsdp > 1: split the parameters too, gathered on use, not
    # only the Adam moments and the EMA (parallel/rules.py)
    fsdp_params: bool = False
    # BatchNorm statistics over the global batch: each rank's (Σx, Σx²)
    # from kernel #5, then one all-reduce (ops/norm.py)
    sync_batchnorm: bool = True
    # recompute the generator's residual blocks in the backward (ops/
    # conv.py remat_call): False off; True/"full" the whole block; "conv"
    # keeps the conv outputs and the norm statistics and recomputes only
    # the elementwise chain
    remat: Union[bool, str] = False
    # the latency-hiding GPipe schedule of train/step.py
    # build_pp_train_step (parallel/pp.py gpipe_trunk overlap=): the stage
    # hand-off of the previous tick runs under this tick's blocks
    pp_overlap: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    health: HealthConfig = HealthConfig()
    debug: DebugConfig = DebugConfig()
    parallel: ParallelConfig = ParallelConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def image_hw(self) -> Tuple[int, int]:
        h = self.data.image_size
        w = self.data.image_width or h
        return h, w


_PRESETS = {}


def _register(cfg: Config) -> Config:
    _PRESETS[cfg.name] = cfg
    return cfg


# the reference system: net_c → 3-bit STE quantizer → ExpandNetwork →
# 3-scale spectral-norm PatchGAN, LSGAN + 10·FM + 10·VGG19 + 1·TV
_register(
    Config(
        name="reference",
        model=ModelConfig(generator="expand"),
        data=DataConfig(dataset="facades", image_size=256, batch_size=1),
        parallel=ParallelConfig(mesh=MeshSpec(data=1)),
    )
)

# classic pix2pix: U-Net G (8 levels, dropout) + one 70×70 PatchGAN
# without spectral norm, LSGAN + 100·L1, batch 1 at 256²
_register(
    Config(
        name="facades",
        model=ModelConfig(generator="unet", ngf=64, num_D=1, n_layers_D=3,
                          use_spectral_norm=False,
                          use_compression_net=False, use_dropout=True),
        loss=LossConfig(lambda_feat=0.0, lambda_vgg=0.0, lambda_tv=0.0,
                        lambda_l1=100.0),
        data=DataConfig(dataset="facades", image_size=256, batch_size=1),
        parallel=ParallelConfig(mesh=MeshSpec(data=1)),
    )
)

# facades with the discriminator's three inner convs on the delayed-int8
# path (stored activation scales); G stays bf16 (int8_generator off), the
# stem and the logits head stay bf16; both Adam moments stored in bf16
_register(
    Config(
        name="facades_int8",
        model=ModelConfig(generator="unet", ngf=64, num_D=1, n_layers_D=3,
                          use_spectral_norm=False,
                          use_compression_net=False, use_dropout=True,
                          int8=True, int8_delayed=True),
        loss=LossConfig(lambda_feat=0.0, lambda_vgg=0.0, lambda_tv=0.0,
                        lambda_l1=100.0),
        data=DataConfig(dataset="facades", image_size=256, batch_size=1),
        optim=OptimConfig(moment_dtype="bfloat16"),
        parallel=ParallelConfig(mesh=MeshSpec(data=1)),
    )
)

# pix2pixHD coarse-to-fine G at 1024×512, fused instance-norm epilogues,
# 3-scale spectral-norm D (split pairs in JAX); LSGAN + 10·FM + 10·VGG19,
# on the JAX preset's MeshSpec(data=-1, spatial=2) (spatial is 1 on one
# card; on more ranks H is split over them, parallel/spatial.py).
_register(
    Config(
        name="pix2pixhd",
        model=ModelConfig(generator="pix2pixhd", ngf=64,
                          norm="pallas_instance", use_compression_net=False,
                          split_d_pairs=True),
        loss=LossConfig(lambda_tv=0.0),
        data=DataConfig(dataset="cityscapes_hd", image_size=512,
                        image_width=1024, batch_size=1),
        parallel=ParallelConfig(mesh=MeshSpec(data=-1, spatial=2)),
    )
)


# edges2shoes at 256², batch 64: the facades U-Net and PatchGAN, data
# parallel over every process (MeshSpec(data=-1); one card without
# torchrun).
_register(
    Config(
        name="edges2shoes_dp",
        model=ModelConfig(generator="unet", ngf=64, num_D=1, n_layers_D=3,
                          use_spectral_norm=False,
                          use_compression_net=False, use_dropout=True),
        loss=LossConfig(lambda_feat=0.0, lambda_vgg=0.0, lambda_tv=0.0,
                        lambda_l1=100.0),
        data=DataConfig(dataset="edges2shoes", image_size=256,
                        batch_size=64),
        parallel=ParallelConfig(mesh=MeshSpec(data=-1)),
    )
)

# Cityscapes labels→photo at 256×512, batch 4: the 9-block ResnetGenerator
# with plain instance norms and the 3-scale spectral-norm D, LSGAN + 10·FM
# + 10·VGG19 + 1·TV, on the JAX preset's MeshSpec(data=-1, spatial=2)
# (spatial is 1 on one card; on more ranks H is split over them).
_register(
    Config(
        name="cityscapes_spatial",
        model=ModelConfig(generator="resnet", ngf=64, norm="instance",
                          use_compression_net=False),
        loss=LossConfig(lambda_l1=0.0),
        data=DataConfig(dataset="cityscapes", image_size=256,
                        image_width=512, batch_size=4),
        parallel=ParallelConfig(mesh=MeshSpec(data=-1, spatial=2)),
    )
)


# vid2vid: the facades-width U-Net (norm "instance", no dropout) on every
# frame, the 3-scale spectral-norm PatchGAN on each (input ‖ frame) pair
# and a 2-scale temporal 3-D PatchGAN on the (input ‖ clip) pair; LSGAN +
# 10·FM (spatial and temporal), 8-frame clips of 256², batch 1, on the JAX
# preset's MeshSpec(data=-1, time=4) (time is 1 on one card; at world
# size 4 each rank holds 2 frames of every clip, parallel/temporal.py).
_register(
    Config(
        name="vid2vid_temporal",
        model=ModelConfig(generator="unet", ngf=64, norm="instance",
                          use_compression_net=False),
        loss=LossConfig(lambda_feat=10.0, lambda_vgg=0.0, lambda_tv=0.0),
        data=DataConfig(dataset="vid2vid", image_size=256, batch_size=1,
                        n_frames=8),
        parallel=ParallelConfig(mesh=MeshSpec(data=-1, time=4)),
    )
)


def int8_full_coverage(cfg: Config) -> Config:
    """Full-model delayed int8 on top of ``cfg`` (``p2p_tpu/core/config.py:
    541 int8_full_coverage``): int8 in G, its decoder, D's head and net_c
    (which it switches on); the stems stay off, as the U-Net image
    head."""
    return cfg.replace(model=dataclasses.replace(
        cfg.model, int8=True, int8_delayed=True, int8_generator=True,
        int8_decoder=True, int8_head=True, use_compression_net=True,
        int8_compression=True))


# facades_int8 with every int8 knob but the stems: U-Net encoder and
# decoder, D's kn2row head and net_c on the delayed-int8 path, bf16 Adam
# moments, batch 1 at 256²
_register(int8_full_coverage(_PRESETS["facades_int8"]).replace(
    name="facades_int8_full"))


def get_preset(name: str) -> Config:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}"
                       ) from None
