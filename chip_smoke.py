#!/usr/bin/env python3
"""Drive the p2p_tpu_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # one card; exits 0 only if all passes
    python3 chip_smoke.py --profile  # also prints a torch.profiler table

Phases, each of which fails the run (nothing is caught, nothing falls back
to the CPU or to a plain version):

1. device and build: the card's name and power limit (nvidia-smi), then the
   port's CUDA kernels built from the sources in this checkout;
2. kernels: at every shape of the main paths each kernel is held against
   its plain PyTorch version on the card, in bf16 and f32, and timed with
   CUDA events (median of 20 cold-L2 runs) beside its plain version, a
   PyTorch library yardstick and its bound (the larger of the bytes moved
   over the card's memory rate and the operations over its peak rate for
   the operands' type): #1, #2 and #3 at every norm shape of the
   instance-norm paths (the full-width pix2pixHD generator at each batch
   size serving uses, N = 1, 2, 4, and in training at N = 1; the
   instance-norm ``reference`` G and D at N = 1; the video kernel form's
   U-Net and D on N = 8 frames) and each
   activation/residual form; #2, #3 and #4 bitwise, alone and right
   after #1 (launched as ops/instance_norm.py launches them, x and #3's
   residual read before the dependent launch's wait), each row with its
   path (#2's C = 3 head on 16-byte vectors across pixels) and its µs
   alone and as a site; #5
   at the (M, C) shapes of the reference, facades and instance-norm train
   steps; #6 and #7 at the facades image head's shapes (N = 1, 2, 4
   serving, N = 1 training); each also launched twice at each shape (the
   same bits), #7 in bf16 held within ``HEAD_DX_TOL``, and each one's bf16
   time per shape printed beside its time before its redesign; then, in
   f32, the gradients through the two
   instance-norm autograd Functions (kernels forward, closed-form
   backward) against autograd through the plain versions at the largest
   shapes of both instance-norm training paths;
3. pix2pixHD serving: the full-width generator (random weights from a
   seed) served through ``InferenceEngine`` in bf16 on synthetic 512×1024
   requests; the launch counts of that run must be exactly 36 + 36 per
   forward batch (and nothing else); the f32 generator through the kernels
   must match the f32 generator through the plain versions within 1e-3 on
   a batch of 4;
4. reference training: the full-width ``reference`` preset (net_c,
   ExpandNetwork, 3-scale spectral-norm PatchGAN, VGG19; random weights
   from a seed) trained through ``create_train_state`` /
   ``build_train_step`` in bf16 on synthetic 256² batches: 2 warm-up and 8
   timed steps with finite losses and exactly 50 launches of #5 per step
   (and nothing else); then in f32 with TF32 off, 2 steps through the
   kernel against 2 through the plain version from the same state, losses
   and running statistics within the stated bands;
5. facades serving: the full-width ``facades`` U-Net with the subpixel
   head on #6 (``thin_head``, ``head_pallas``) served in bf16 on synthetic
   256² label maps: exactly one #6 per forward batch and nothing else; the
   f32 U-Net through #6 against it through the plain version within 1e-3;
6. facades training: the same U-Net with the 70×70 PatchGAN, dropout on,
   bf16: 2 warm-up and 8 timed steps with finite losses and exactly 13
   #5, one #6 and one #7 per step; then in f32 with TF32 off, 2 steps
   through the kernels against 2 through the plain versions from the same
   state and dropout seed, losses within the stated bands;
7. instance-norm training, path A: the full-width ``reference`` preset
   with ``norm="pallas_instance", norm_d="pallas_instance"`` (ExpandNetwork
   on #1 + #2 at its 6 plain norms and #1 + #3 at its 18 residual-block
   epilogues, the D's 9 inner epilogues on #1 + #3 with LeakyReLU), bf16:
   2 warm-up and 8 timed steps with finite losses and exactly 66 #1, 12
   #2, 54 #3 and 2 #5 per step; then the f32 (TF32 off) 2-step
   kernels-vs-plain check;
8. instance-norm training, path B: the full-width ``pix2pixhd`` preset at
   1024×512 (3-scale D, LSGAN + 10·FM + 10·VGG19), bf16: 2 warm-up
   and 4 timed steps with finite losses, the peak device memory, exactly
   36 #1 and 36 #3 per step and no #2; then the f32 (TF32 off) 2-step
   kernels-vs-plain check at full depth;
9. facades int8 training: ``facades_int8`` with ``norm_d=
   "pallas_instance", int8_fused_epilogue=True`` (the U-Net G in bf16, the
   70×70 PatchGAN's three inner convs on the delayed-int8 path, inner
   convs 2 and 3 fed by the quantize-fused epilogue #1 + #4, bf16 Adam
   moments), dropout on, bf16: 2 warm-up and 8 timed steps with finite
   losses, the peak device memory, exactly 4 #4, 6 #1, 2 #3 and 13 #5 per
   step, and every stored amax finite and moved; then the f32 (TF32 off,
   cuDNN deterministic) 2-step check from one state: through every kernel
   against every plain version within the stated bands, and with #1 and
   #5 on their plain versions equal to it (q and losses); then 2 bf16 steps of ``facades_int8``
   as it is (no D norm: no #4, only its 13 #5 per step). Before it, in
   the kernel phase, #4 at the path's shapes bitwise against its plain
   version given the same statistics (at the path's scale and at one
   whose quotients hit rounding ties), and every int8 contraction form of
   the path (im2col + ``torch._int_mm``) exact against an f64 conv or
   product of the same int8 operands, timed beside cuDNN's bf16 conv of
   the same shape;
10. the reference loop end to end: 6 synthetic 512×512 sources from
   the port's generator, ``cli.generate_dataset`` into 256² train (4) and
   test (2) splits, ``cli.train`` of the full-width ``reference`` preset
   for 2 epochs (bf16 on f32 masters, batch 1, an eval and a checkpoint
   each epoch), then ``cli.infer --metrics`` from the last checkpoint:
   two ``epoch`` and two ``eval`` records, all finite; two checkpoints
   whose manifests verify; exactly 50 #5 per train step and none in eval
   or inference; the infer line's PSNR/SSIM equal to the last eval within
   ``LOOP_PSNR_BAND`` and ``LOOP_SSIM_BAND``; one 256×256×3 PNG per test
   image; SSIM(x, x) exactly 1 and SSIM on the card within
   ``SSIM_F64_TOL`` of a float64 numpy SSIM; the loop's ms/step beside
   the step alone (phase 4), eval ms per image and infer img/s;
11. HTTP serving: two full-width pix2pixhd checkpoints (``create_train_state``
   at seeds 0 and 1, saved as steps 1 and 2 by the port's
   ``CheckpointManager``); ``ServeApp`` + ``run_server`` in a thread with
   tenants ``hd`` (pix2pixhd, step 1) and ``ref`` (phase 10's reference
   run, step 4), buckets (1, 2, 4), bf16, cuDNN deterministic; 8 client
   threads send 32 synthetic PNGs a tenant (512×1024 and 256², seed 0),
   then 8 more a tenant, sent on in turn while both tenants hot-swap (hd
   to step 2, ref to step 8) until both reloads answer (512 requests at
   most); a reload of a copy of hd's step 2 with a corrupted ``net_g``
   must answer 409 and leave the probe's image as it was; a non-PNG body
   422, an unknown tenant 404; ``/healthz`` both tenants at their new
   steps with no new warm-up; ``/metrics`` the clients' count of 200s;
   the drain returns 0. Every 200 is held against an in-process
   ``engine_from_checkpoint`` engine serving the same group of bodies at
   the allowed steps (``HTTP_LEVELS_BAND`` uint8 levels); #1 and #3
   exactly 36 a pix2pixHD forward (warm-ups, dispatched groups, the
   swap's warm forward) and nothing else. Then ``cli.serve --http`` as a
   subprocess (4 requests, SIGTERM: exit 0 within the drain timeout, one
   summary) and watch mode with ``--max_requests 4`` (PNGs copied in
   while it runs: 4 outputs, exit 0). Printed per tenant: requests
   served, img/s over the traffic window, client latency p50/p99/max,
   mean bucket occupancy, padded images and the responder's encode
   seconds, beside phase 3's directory-mode img/s;
12. slice 8: (b) ``edges2shoes_dp`` at batch 64, 256², bf16: 2 warm-up
   and 4 timed steps with finite losses and exactly 13 #5 a step, img/s,
   the device's busy share of one profiled step and the peak memory; then
   the f32 (TF32 off, cuDNN deterministic) 2-step check through #5 against
   its plain version from one state (bands ``E2S_STEP1_RTOL``,
   ``E2S_LATER_RTOL`` from ``scripts/torch_edges2shoes_f32_spread.py``);
   (c) ``cityscapes_spatial`` at 256×512, batch 4, bf16: 2 + 4 steps,
   finite losses, no kernel launched, ms/step and peak memory; (d) the
   trainer options on ``facades`` (pool 50, EMA 0.999, clip 1.0, the
   plateau policy): 8 bf16 steps on a ring filled first, D fed a stored
   pair on at least one, one step at lr_scale 0.2 changing every
   parameter by 0.2 × the change at 1, an EMA at decay 0 bitwise G, a
   checkpoint with EMA, pool and plateau scale restored bitwise, and
   ``engine_from_checkpoint(..., ema_decay)`` serving 0 uint8 levels from
   an engine built from the EMA's weights (cuDNN deterministic); (e) the
   U-Net's forms at 256², one bf16 step each: ``upsample_mode``
   subpixel and resize and ``thin_stem`` (the plain stem conv; 13 #5),
   ``norm`` instance (no kernel) and pallas_instance (13 #1 + 13 #2); (a)
   pix2pixHD's
   coarse-to-fine schedule through the CLIs: ``cli.generate_dataset``
   cuts 4 train and 1 test pair of 512×1024 out of synthetic 1024²
   sources, ``cli.train --phase global`` one epoch of G1 at 512×256
   (27 #1 + 27 #3 a step and an eval forward), ``cli.train --phase
   full`` one epoch at 1024×512 (36 + 36) with G1 grafted in, every
   grafted leaf bitwise phase 1's checkpoint, the image head dropped,
   ms/step and peak memory of each phase. The kernel phases hold #1, #2,
   #3 and #5 at these paths' shapes too;
13. slice 9, the rest of int8: (e) ``QuantConvTranspose`` k4 s2 at (1,
   512, 16, 16) → 256 on integer grids, forward and both gradients exact
   against the f64 transposed conv; (a) ``facades_int8_full`` as
   registered at 256² (int8 U-Net encoder and decoder, int8 net_c, D's
   int8 inner convs and kn2row head, stored scales, bf16 Adam moments):
   every int8 form at its shapes (encoder k4 s2 and subpixel k2 at levels
   1–7, the kn2row head's forward and wgrad, net_c's k5, k3 and k3-s2
   convs) exact against f64 on random int8 operands; the f32 (TF32 off,
   cuDNN deterministic) one-step check through #5 against its plain
   version (``I8F_STEP1_RTOL``, ``I8F_AFTER_RTOL``); 2 + 6 bf16 steps with
   finite losses, exactly 28 #5 a step, every stored scale of G, D and C
   finite and moved, ms/step and peak memory; (b) its checkpoint
   (``CheckpointManager``) served by ``engine_from_checkpoint`` with G and
   net_c: 4 requests each 0 uint8 levels from the eval step (cuDNN
   deterministic), no kernel launched, every scale bitwise the same after
   them; ``cli.serve --once`` over a directory and ``cli.infer --metrics``
   exit 0 with every output; (c) path A with every int8 form (G's trunk,
   net_c, the 3-scale spectral-norm D's stem, fused epilogues and kn2row
   head): 2 bf16 steps with exactly 66 #1, 12 #2, 42 #3, 12 #4 and 2 #5 a
   step and every scale moved (the kernel phase holds #4 bitwise at its
   spectral-norm sites); (d) ``pix2pixhd`` with int8 trunks at 1024×512:
   one bf16 step and one served forward, 36 #1 + 36 #3 each, the scales
   moved by the step and bitwise after the forward;
14. slice 10, preemptible self-healing training, on phase 10's
   ``reference`` data (full width, bf16 on f32 masters, 2 epochs of 4
   steps, an eval and a checkpoint an epoch), every run through
   ``cli.train`` in process unless named: (a) two uninterrupted runs and
   one preempted at step 6 (``P2P_CHAOS=elastic@6``: exit 75, the step-6
   checkpoint, its sidecar with ``batches_done`` 2, a ``preempt``
   record), all cuDNN deterministic, then its relaunch (exit 0): it
   resumes at epoch 2, batch 2 (a ``resume`` record), its live state
   after the restore bitwise the step as saved (the manifest's CRC32s),
   it reads exactly the uninterrupted run's last 2 train samples, and its
   losses of steps 7-8 and its final networks (parameters and buffers)
   lie within the bands
   ``band_of`` sets from the two uninterrupted runs' difference
   (``RES_BAND_FACTOR``; bitwise where they are bitwise); then a
   ``cli.train`` subprocess sent SIGTERM after its first ``train`` record
   exits 75 with a sidecar, and its relaunch exits 0; (b) the ladder:
   ``RES_LADDER_NAN`` with ``--cooldown_steps 8 --max_rollbacks 1`` skips,
   cools down, rolls back to the marked step 4 (``rollback`` and
   ``health_summary`` records), logs the rerun epoch's ``lr`` times
   ``cooldown_factor`` and exits 0; ``RES_GIVEUP_NAN`` exits 76 after one
   rollback; (c) the records (``manifest`` with the card's backend block,
   ``epoch``, ``eval``, ``memory`` with the card's bytes, ``preempt``,
   ``resume``, ``rollback``, ``health_summary``), ``trace_reference.json``
   with ``epoch``, ``evaluate``, ``train_dispatch`` and
   ``checkpoint_save`` spans, the ``--prom_textfile`` file parsed,
   ``--check_finite --nan_sentinel --grad_norms`` on a healthy epoch with
   no event and finite gradient norms, no unexpected kernel build after
   the first epoch; (d) exactly 50 #5 launches a train step in every run,
   none in eval; (e) the loop's ms/step with health and obs on, beside
   phase 10's;
15. slice 11, video: ``vid2vid_temporal`` at full width (U-Net ngf 64 on
   every frame, the 3-scale spectral-norm PatchGAN on each (input ‖
   frame) pair, the 2-scale temporal 3-D PatchGAN on the (input ‖ clip)
   pair, 8 frames of 256², batch 1, bf16 on f32 masters): (a) the port's
   synthetic clips, 2 videos of 16 frames a split (4 train and 4 test
   clips); (b) ``cli.train`` in process for 2 epochs of 4 steps (an eval
   and a checkpoint an epoch): finite ``loss_d``, ``loss_dt``, ``loss_g``,
   ``g_gan_t`` every step, ``n_frames_scored`` 32 in each eval, no kernel
   launched, the step's ms (median after 2 warm-up), frames/s and the
   peak memory; (c) ``P2P_CHAOS=elastic@6`` exits 75 and its relaunch 0,
   resuming at epoch 2, batch 2 with its live state bitwise the saved
   step (the manifest's CRC32s), reading exactly the uninterrupted run's
   last 2 train clips; (d) ``cli.infer --metrics`` on that checkpoint: 32
   PNGs of 256² and the metrics line; one profiled bf16 step of the
   preset (busy share, largest device shares); (e) the kernel form
   (``norm`` and ``norm_d`` ``pallas_instance``): 2 bf16 steps with
   exactly 31 #1, 13 #2 and 18 #3 a step at N = 8, then the f32 (TF32
   off, cuDNN deterministic) one-step check through them against their
   plain versions within ``VID_F32_RTOL``;
16. slice 12, the rest of the one-device surface: (a) the C++ host image
   path on the card's host: 512x1024 PNGs written here with every row
   Paeth, every row Average, all five filters in turn, and RGBA, decoded
   bitwise equal by the C++ route and the numpy plain version; Pillow's
   bicubic resize 512x1024 → 256x512 and 1024x512 → 286x572 bitwise
   equal by both; a JPEG request body read through Pillow; the ms of
   each route (median of ``S12_REPS``); (b) ``make_loader`` with a pool
   of 4 worker processes kept across three epochs against none over 72
   uncached 256² pairs: the same batches, bitwise and in order, with and
   without ``skip_samples``, each epoch's seconds; (c) the full-width ``reference`` preset through ``cli.train``
   on phase 10's data, 2 epochs of 4 bf16 steps, with ``--lambda_sobel 1
   --sobel_warmup_epochs 2 --lambda_angular 1 --eval_fid --save_masks
   --threads 4`` and ``lambda_style`` ``S12_STYLE``: ``g_style``,
   ``g_sobel`` and ``g_angular`` finite in every train record, a finite
   ``vfid`` and its feature source in each eval, each mask PNG the AND of
   the saved prediction and input, exactly 50 #5 a step and none in eval,
   ms/step and peak memory; (d) the backward of ``sobel_edges``,
   ``angular_loss`` and ``gram_matrix`` on the card in f32, in the train
   step's TF32 setting, and channels_last against f64 on the CPU, the same bits twice under cuDNN
   deterministic; (e) ``init_type`` xavier, kaiming and orthogonal on the
   full-width ``reference`` state, every re-drawn kernel by its law; (f)
   phase 12's pix2pixHD phase-1 line is the end-to-end reading of the
   host path; (g) ``cli.infer --compilation_cache <dir>`` in a process of
   its own exits 0 with its libraries built into ``<dir>``;
17. slice 13, data parallel (``torchrun`` starts this script's
   ``--worker`` ranks, which call the port's entry points in process so
   that their launches are counted; the kernels are built in phase 1,
   before any rank starts): (a) NCCL at world size 1: the full-width
   ``edges2shoes_dp`` at batch 64, bf16, 2 steps with the process group
   bitwise the 2 steps without it (cuDNN deterministic: losses, G, D and
   G's Adam state), exactly 13 #5 a step, each followed by one all-reduce
   of its sums (and one of their cotangents in the backward), the
   ms/step beside phase 12's, then ``cli.train --mesh data=-1`` for
   ``DP_EPOCHS`` epochs of 2 steps on synthetic 256² pairs; (b) two ranks
   on the one card through gloo: one f32 step (TF32 off, cuDNN
   deterministic) at global batch ``DP_GLOBAL_BATCH`` with dropout on
   against the one-rank step at that batch (losses within
   ``E2S_STEP1_RTOL``; each tensor's distance over its update within
   ``band_of`` the one-rank kernel-vs-plain distance of the same call),
   ``fsdp=2`` bitwise ``data=2``, and the sync-BatchNorm backward in
   channels_last against f64 on the CPU (``DP_BN_TOL_OF_MAX``), the same
   bits twice; (c) ``cli.train`` at 2 gloo ranks with
   ``P2P_CHAOS=elastic@DP_STOP`` exits 75 on both, its relaunch at world
   size 1 (NCCL) is a ``reshard`` whose live state is bitwise the saved
   step (the manifest's CRC32s), the two runs read exactly the
   uninterrupted run's samples (none twice, none missing), a relaunch at
   global batch ``DP_REBASE_BATCH`` resumes through ``batch_rebase`` and
   completes, and ``--no-elastic`` exits 2 with the ``TopologyMismatch``
   text; (d) ``pix2pixhd`` at 1024×512 in bf16 with remat off, "full" and
   "conv": the peak memory (off > conv > full), ms/step and the #1/#3
   launches a step of the recompute plan, and one f32 step with each
   remat bitwise the no-remat step (cuDNN deterministic);
18. slice 13b, the spatial axis (``torchrun`` starts two ``--worker
   spatial2`` ranks that form a gloo group on the one card; H is split
   over them, ``MeshSpec(data=-1, spatial=2)``, the presets' own mesh):
   (a) ``pix2pixhd`` at 1024×512, bf16, ``SP_WARMUP`` + ``SP_TIMED``
   steps: each rank's ms/step and peak memory, and a step's launches of
   #1's sums entry, its finalize and #3 (36 each, no #1) against the
   epilogue plan, the statistics all-reduces (36 forward, 36 backward)
   and the halo exchanges by route with their bytes (gloo on CUDA
   tensors: the slot route; these times stage through the host and are
   no speed of the spatial axis); (b) f32 (TF32 off, cuDNN
   deterministic): one ``cityscapes_spatial`` step at 256×512, batch 4,
   on 2 ranks against the one-rank step on the same global batch (losses
   within ``SP_LOSS_RTOL``; each tensor's distance over its update within
   ``band_of`` the one-rank spread from summing the plain instance norm's
   statistics in f64), and ``pix2pixhd``'s step-1 losses at 2 ranks
   against 1 (losses only: its f32 G gradient is ill-conditioned); (c)
   in this process, at every epilogue shape on a rank's rows: the sums
   entry and the finalize against their plain versions, the global
   statistics of two blocks against #1 on the whole map, #2 and #3 fed
   them bitwise their plain versions, each timed (the ``kernels`` line's
   rows of the two new entries and of #3 at a rank's rows); (d) the halo
   exchange's backward and each sharded windowed op's input gradient
   (reflect-padded k3/k7 at stride 1 and 2, the upsample conv, the D's
   k4 convs at stride 2 and 1, the AvgPool, VGG's conv and max pool) on
   an uneven map, channels_last, against f64 on the CPU
   (``SP_GRAD_TOL_OF_MAX``), the same bits twice under cuDNN
   deterministic; (e) ``cli.train --mesh 1,2,1`` of the full-width
   ``cityscapes_spatial`` at 2 ranks for 2 epochs (exit 0, the spatial
   peers reading the same samples), then ``P2P_CHAOS=elastic@
   SP_CLI_STOP`` (exit 75 on both) and the relaunch at world size 1 in
   this process: a ``reshard`` whose live state is bitwise the saved
   step, the two runs reading the uninterrupted run's samples, none
   twice, none missing;
19. slice 13b-time and 13c, the time and model axes (``torchrun``
   starts four ``--worker time4`` ranks, then two ``--worker tp2``, gloo
   on the one card): (a) ``cli.train`` of the full-width
   ``vid2vid_temporal`` (8 frames of 256², bf16) on its own mesh
   ``data=-1, time=4`` at world size 4, 2 epochs of 2 clips: every step
   timed with its halo exchanges by route (2 frames a rank), the peak
   memory a rank; (b) its kernel form (``norm``/``norm_d``
   ``pallas_instance``) on the same mesh: #1/#2/#3 exactly the one-rank
   plan a rank a step at N = 2 frames, then f32 (TF32 off, cuDNN
   deterministic) losses of the 4-rank step within ``AX_LOSS_RTOL`` of
   the one-rank step on the whole clip; (c) ``pix2pixhd`` at 1024×512
   bf16 on ``data=1, model=2`` (Megatron pairs of at least 512
   channels: G1's 9 residual blocks, ConvLayer_3/4, UpsampleConvLayer_0/
   1; each D scale's 256→512 conv and head): 36 #1 + 36 #3 a step (the
   pairs' inner norms at their channel slice), ms/step, peak memory and
   the model group's collectives a step with their bytes, every
   replicated parameter and buffer (spectral ``u`` included) the same
   bits on both ranks after the steps in cuDNN's default mode, then f32
   losses against the one-rank step; (d) the engine on the model mesh
   serving phase 3's requests in f32, rank 0 leading and rank 1
   following, within ``AX_SERVE_ATOL`` and ``AX_SERVE_LEVELS`` uint8
   levels of the one-rank engine (TF32 off, cuDNN deterministic); then,
   in this process,
   #1/#2/#3 at every shape (b) and (c) launched, held against their
   plain versions and timed (the ``kernels`` line's rows of these
   launches);
20. slice 13c-PP, the pipe axis and TP × int8 (``torchrun`` starts three
   ``--worker pp3`` ranks, ``MeshSpec(data=1, pipe=3)``, then two
   ``--worker tp8``, ``MeshSpec(data=1, model=2)``, gloo on the one card):
   (a) path A (``reference`` with ``pallas_instance`` in G and D, global
   batch ``PP_BATCH`` in ``PP_MICRO`` microbatches of 1, 3 blocks a
   stage) through ``train/step.build_pp_train_step``, ``PP_WARMUP`` +
   ``PP_TIMED`` bf16 steps: each rank's ms/step (the ranks share the
   card: no speed of the axis) and peak memory, the #1/#2/#3 launches a
   rank a step exactly :func:`pp_rank_plan` (the encoder, decoder and D
   at N = 4, the rank's stage's blocks at N = 1 on each of its M ticks,
   both G forwards) and 2 #5, the ring shifts a step by route with their
   bytes, every replicated parameter and buffer the same bits on the
   three ranks after the steps in cuDNN's default mode; then f32 (TF32
   off, cuDNN deterministic): the 3-rank step against the one-rank
   unpipelined step on the same batch (losses within ``PP_LOSS_RTOL``;
   each updated tensor's distance over its update, the stage blocks
   gathered back, within ``band_of`` the larger of the one-rank
   kernel-vs-plain spread and the one-rank pipelined-vs-unpipelined
   spread, each measured in the same call), and the overlapped schedule
   (``pp_overlap``) bitwise the serial one on every rank; (b) path A
   int8 (every int8 form, stored scales), one f32 step on the same mesh
   against the one-rank step: the losses before the update and every
   stored amax (the stages', D's, net_c's) within ``PP_INT8_RTOL``, loss_c
   within ``PP_INT8_AFTER_RTOL``, #4 a
   rank as :func:`path_a8_step_plan` plans it; (c) ``cityscapes_spatial``
   (ResNet G, ngf 64, 9 blocks of 256 channels, 256×512, batch 4) one f32
   step on ``pipe=3`` against the one-rank step (losses); (d)
   ``pix2pixhd`` with its residual blocks int8 (stored scales) at
   1024×512 on ``data=1, model=2``: ``PP_TP_WARMUP`` + ``PP_TP_TIMED``
   bf16 steps, ms/step, peak, 36 #1 + 36 #3 a step by C, the model
   group's collectives a step with their bytes (the int8 pairs' int32
   accumulator sums and amax maxes), the replicas' bits, then one f32
   step against the one-rank step (losses within ``PP_INT8_RTOL``; every
   amax within ``band_of`` the one-rank kernels-vs-plain spread of the
   same call); then, in this
   process, #1/#2/#3 and #5 at every shape (a) and (d) launched, held
   against their plain versions and timed (the ``kernels`` line's rows
   of these launches);
21. the script's total seconds, a ``{"kernels": [...]}`` line, then the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from unittest import mock

import numpy as np
import torch

SEED = 0
N_REQUESTS = 6
BUCKETS = (1, 2, 4)
# the main path: engine.run over these batches, then every request alone
RUN_BATCHES = (4, 2)
NORMS_PER_FORWARD = 36
# published H100 SXM peaks: HBM3 bytes/s, and FLOP/s for the operands'
# type (bf16 on the tensor cores, f32 outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OP_PER_S = 1979e12
# kernel vs plain version: f32 differs only in the order of partial sums;
# bf16 outputs may differ by one rounding of the stored value
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}
STATS_TOL = (1e-4, 1e-4)   # (atol, rtol): f32 outputs from either input type
SLICE_F32_TOL = 1e-3
TIMING_REPS = 20
# #5 vs plain: f32 sums of the same terms in two orders; the error of
# either is a small multiple of 2^-24 times the sum of |terms|
MOMENTS_RTOL_OF_ABS_SUM = 1e-5
# the train phase: batch 1 at 256² (the preset's shape), bf16 steps
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# f32 train steps through #5 vs through its plain version, from one state.
# Step 1 holds each loss to its own band, set from its largest relative
# difference over 8 seeds on an H100 with #5 and with the same sums in f64
# rounded once (scripts/torch_reference_f32_spread.py): 1e-4 where #5's is
# at most half of it, else 2.5× the larger of the two routes, rounded up to
# 1, 2 or 5 × 10^-n. loss_c is the widest: it is computed after G's first
# Adam update, which turns last-bit differences of #5's sums into ±lr
# moves (up to 1.27e-4 with #5 and 2.13e-4 in f64, so 1e-3). Adam's
# first update moves every weight by exactly +-lr (m/sqrt(v) = sign(g)),
# so weights whose gradient is near 0 and flips sign between the routes
# end 2 lr = 4e-4 apart; step 2's losses
# then differ by up to 2% (the band of tests/test_torch_train_step.py), and
# a running statistic, which takes 0.1 of a batch statistic of activations
# that sum up to 1,152 such weights (a k3 conv over 128 channels), by up to
# 0.05 plus 2% of its value.
TRAIN_F32_STEPS = 2
TRAIN_STEP1_RTOL = {"loss_g": 1e-4, "loss_d": 1e-4, "loss_c": 1e-3,
                    "g_gan": 1e-4, "g_feat": 1e-4, "g_vgg": 1e-4,
                    "g_tv": 1e-4}
TRAIN_LATER_RTOL = 2e-2
TRAIN_STATS_ATOL = 5e-2
LOSS_KEYS = ("loss_g", "loss_d", "loss_c", "g_gan", "g_feat", "g_vgg",
             "g_tv")
# #6 and #7: z (f32) differs from the plain version only by the order of
# f32 sums of 512 products of magnitude ~0.1; dx is stored in x's dtype
HEAD_Z_TOL = (1e-4, 1e-4)
# bf16 device µs per launch of #6 at the facades head (x N×128×128×128)
# at N = 1, 2, 4 before its redesign (on the CUDA cores; PERF.md §6, NVIDIA
# H100 80GB HBM3, 700.00 W), printed beside this run's times
HEAD_BEFORE_US = {1: 45.0, 2: 72.9, 4: 132.1}
# #7 in bf16 against its plain version: both form the same exact f32
# products (dz in three bf16 pieces on the tensor cores), so their f32 sums
# differ only by order and the tensor cores' accumulation (emulated at the
# facades head by scripts/torch_subpixel_dx_error.py: 8e-7, bounded by
# 1.9e-5 at N = 1 and 3.9e-5 at twice the spread of dz); then each rounds
# once to bf16 (2^-7 relative)
HEAD_DX_TOL = (5e-5, 2.0 ** -7)
# bf16 device µs per launch of #7 at the facades head at N = 1, 2, 4 before
# its redesign (on the CUDA cores; NVIDIA H100 80GB HBM3, 700.00 W: N = 1
# from PERF.md §6, N = 2 and 4 from the redesign's same-call A/B with
# scripts/torch_kernel_times.py)
HEAD_DX_BEFORE_US = {1: 17.9, 2: 28.7, 4: 48.7}
# the facades train check: f32 steps through #5/#6/#7 vs through their
# plain versions from one state and one dropout seed. Step 1 differs only
# by the order of f32 sums (rtol 1e-4); from step 2 Adam's sign-like first
# update moves weights whose gradient is near 0 by ±lr on either route
# (tests/test_torch_facades_step.py measured 8.5e-7 between the two
# packages on the CPU at step 3): rtol 1e-3.
FACADES_STEP1_RTOL, FACADES_LATER_RTOL = 1e-4, 1e-3
FACADES_LOSS_KEYS = ("loss_g", "loss_d", "g_gan", "g_l1")
# instance-norm training: path A (reference with pallas_instance norms)
# 2 + 8 bf16 steps, path B (pix2pixhd at 1024x512) 2 + 4
HD_TRAIN_WARMUP, HD_TRAIN_STEPS = 2, 4
HD_LOSS_KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg")
# the f32 kernels-vs-plain steps of the instance-norm paths: the losses of
# step 1 taken before any update differ only by the order of f32 sums in
# the norm statistics (rtol 1e-5); those after an update (step 1's net_c
# loss, against the updated G, and all of step 2) follow Adam's sign-like
# first update, which moves a weight whose gradient is near 0 by +-lr on
# either route, and on path B a G gradient that is ill-conditioned (it
# moves by 1.5e-3 of a tensor's largest when only the last bit of its
# norm statistics changes, tests/test_torch_hd_train_step.py): within
# 5e-2 (measured on an H100: path A's net_c loss 1.3e-2 at step 2, path
# B 1.6e-5; the gradients themselves are held by the backward check)
INSTANCE_STEP1_RTOL = 1e-5
INSTANCE_LATER_RTOL = 5e-2
AFTER_UPDATE_KEYS = ("loss_c",)
# gradients through the instance-norm Functions vs autograd through the
# plain chain, f32: dx and dres within 1e-4 + 1e-4 relative (elementwise
# closed form against autograd's chain: rounding of O(1) values); dscale
# and dbias, sums over H*W pixels, within 1e-4 of the tensor's largest.
# Elements whose activation input (the plain pre-activation) lies within
# MASK_MARGIN of 0 are left out of dx and dres: the kernel's and the plain
# forward's y differ in their last bits (~1e-7), so the two routes may put
# the relu/leaky mask on either side of such an element (the margin leaves
# out about one element in 10^4; the CPU tests pin the mask rule)
GRAD_TOL = (1e-4, 1e-4)
GRAD_SUM_RTOL_OF_MAX = 1e-4
MASK_MARGIN = 1e-4
# facades int8 training (slice 5): launches per step of the fused path: #4
# before inner convs 2 and 3, #1 before those and the last inner epilogue
# (#3), in the fake and the real D forward; #5 under the U-Net's 13
# BatchNorms. The preset as it is runs 2 steps.
INT8_PER_STEP = dict(norm_act_quant=4, instance_norm_stats=6, norm_act=2,
                     batch_moments=13)
INT8_AS_IS_STEPS = 2
# the loop phase (slice 6): train and test sources of 512², one 256² patch
# each, 2 epochs at batch 1
LOOP_SOURCES = (4, 2)
LOOP_EPOCHS = 2
LOOP_STEPS = LOOP_EPOCHS * LOOP_SOURCES[0]
# eval and infer run the same bf16 forward (f32 masters, eval-mode
# BatchNorm) on the same checkpoint and test images; the infer line prints
# 4 decimals, so the two agree within its rounding (5e-5) unless cuDNN
# picks other algorithms in the two runs
LOOP_PSNR_BAND, LOOP_SSIM_BAND = 0.01, 1e-4
# SSIM on the card (f32, window sums on the CUDA cores) against float64
SSIM_F64_TOL = 1e-5
# the HTTP serving phase (slice 7): tenants hd (pix2pixhd) and ref
# (reference), HTTP_REQUESTS each from HTTP_CLIENTS client threads, then
# HTTP_RELOAD_REQUESTS distinct bodies each, sent on in turn until both
# tenants' hot-swaps have answered, HTTP_RELOAD_STREAM_CAP at most
HTTP_CLIENTS = 8
HTTP_REQUESTS = 32
HTTP_RELOAD_REQUESTS = 8
HTTP_RELOAD_STREAM_CAP = 512
HTTP_CLI_REQUESTS = 4
# each 200 against the in-process engine_from_checkpoint engine's output
# for the same bodies in the same group (the same padded bucket batch),
# cuDNN deterministic on both: the same bits, so 0 uint8 levels
HTTP_LEVELS_BAND = 0
# the slice-10 phase (preemption, exact resume, the recovery ladder and
# the training telemetry) on phase 10's reference data: 2 epochs of 4
# steps. Preempted in process at step 6 (the elastic chaos seam); the
# ladder: NaN observed at steps 6-8 (skip, cooldown, rollback to the
# marked step 4) with a post-rollback cooldown that outlives the rerun
# epoch, then NaN at every step from 5 (one rollback, then exit 76)
RES_STOP = 6
RES_PREEMPT = f"elastic@{RES_STOP}"
RES_LADDER_NAN = "nan@6x3"
RES_GIVEUP_NAN = "nan@5x1000"
RES_COOLDOWN_STEPS = 8
RES_MAX_ROLLBACKS = 1
# the resume bands (ROADMAP Queue C's rule): 2.5x the largest difference
# between any two of three resumes of one step-6 checkpoint (cuDNN
# deterministic), for the losses of steps 7-8 and for each network's
# final parameters over their update from step 6, rounded up to 1, 2 or
# 5 x 10^-n; bitwise where the resumes are bitwise equal, as they are
# with the reflect pad's backward in a fixed order under cuDNN
# deterministic (scripts/torch_reference_determinism.py). A resume at
# RES_PLANTED_LR times the learning rate (the cooldown factor: a cooldown
# carried across the resume) must fall outside them
RES_BAND_FACTOR = 2.5
RES_PLANTED_LR = 0.1
# its f32 kernels-vs-plain check (cuDNN deterministic): given the plain
# statistics of #1 and #5, #3 and #4 are bitwise their plain versions and
# the backward is the same code, so both steps' losses are equal (rel diff
# 0 over 8 seeds, scripts/torch_int8_f32_spread.py on an H100). Through
# every kernel, the last bits of #5's BatchNorm statistics move G's output
# and so D's quantizers: 2–1,406 q elements of a #4 call differ at step
# 1 (about as many with #1 on its plain version), and the losses moved
# by up to 3.4e-4 at step 1 and 4.1e-3 at step 2 over those 8 seeds:
# rtol 1e-3 and 1e-2
INT8_STEP1_RTOL, INT8_LATER_RTOL = 1e-3, 1e-2
INT8_SAME_STATS_RTOL = 0.0
# #4's elementwise operations per element (normalize 2, activation, the
# cast, the divide, round, clip, |.|, max)
QUANT_OPS_PER_ELEMENT = 9
# slice 8. (a) pix2pixHD coarse-to-fine through the CLIs: train and test
# pairs of 512x1024 cut from synthetic 1024² sources, one epoch a phase
C2F_SOURCES = (4, 1)
# (b) edges2shoes_dp at batch 64: 2 + 4 bf16 steps, then the f32
# kernels-vs-plain check (2 steps, cuDNN deterministic). Its bands follow
# PR 11's rule (1e-4 where #5's largest relative difference from the plain
# route is at most half of it, else 2.5× the larger of #5's and the f64
# sums', rounded up to 1, 2 or 5 × 10^-n) from
# scripts/torch_edges2shoes_f32_spread.py over 8 seeds on an H100 (NVIDIA
# H100 80GB HBM3, 700.00 W): #5 at most 1.13e-7 at step 1 and 1.30e-6 at
# step 2, the f64 sums 1.13e-7 and 2.28e-6, so both bands are 1e-4
E2S_WARMUP, E2S_STEPS = 2, 4
E2S_STEP1_RTOL, E2S_LATER_RTOL = 1e-4, 1e-4
# (c) cityscapes_spatial at 256x512, batch 4: 2 + 4 bf16 steps
CITY_WARMUP, CITY_STEPS = 2, 4
# (d) the trainer options on facades: bf16 steps with the pool (its ring
# filled first, so each step may swap with a stored pair at 1/2), the EMA,
# the clip and the plateau policy; then 2 steps with the EMA at decay 0
# and 2 from one state at lr_scale 1 and OPTIONS_LR_SCALE
OPTIONS_STEPS = 8
OPTIONS_ALL_STEPS = OPTIONS_STEPS + 4
OPTIONS_LR_SCALE = 0.2
# the update at lr_scale s against s × the update at 1, per element: the
# two roundings of p + u (each at most half an ulp of |p| ≤ 2^-23·|p|),
# and 1e-5 of the update for the scaled Adam step's own roundings
OPTIONS_LR_PARAM_ULPS, OPTIONS_LR_RTOL = 2.4e-7, 1e-5
# (e) the U-Net's forms, one bf16 step each at 256²
UNET_FORMS = {"subpixel": {"upsample_mode": "subpixel"},
              "resize": {"upsample_mode": "resize"},
              "thin_stem": {"thin_stem": True},
              "instance": {"norm": "instance"},
              "pallas_instance": {"norm": "pallas_instance"}}
# slice 9. (a) facades_int8_full at 256²: the f32 check's one step
# through #5 against its plain version (cuDNN deterministic), then 2 + 6
# bf16 steps; (b) its checkpoint served for I8F_SERVE_REQUESTS requests.
# The bands, set before the first run on the card: #5's last bits move the
# BatchNorms' outputs in front of G's int8 convs, and their quantizers
# flip q where a value sits at a rounding tie, as facades_int8's D does
# (INT8_STEP1_RTOL); loss_c follows G's first Adam update (its sign-like
# first step), as INT8_LATER_RTOL
I8F_STEPS, I8F_F32_STEPS, I8F_SERVE_REQUESTS = 8, 1, 4
I8F_STEP1_RTOL, I8F_AFTER_RTOL = 1e-3, 1e-2
# (c) path A with every int8 form: 2 bf16 steps; (d) pix2pixhd int8: one
# bf16 step and one served forward
A8_STEPS = 2


# slice 11 (video): vid2vid_temporal through its CLIs on the port's
# synthetic clips of 256², VID_SOURCES = (videos a split, frames a video),
# so 4 train and 4 test clips of 8 frames; 2 epochs of 4 steps, preempted
# in process at step VID_STOP and resumed; then its kernel form (#1 + #2
# at the U-Net's norms, #1 + #3 at D's, N = 8 frames) for
# VID_KERNEL_STEPS bf16 steps and the f32 one-step check through the
# kernels against their plain versions. VID_F32_RTOL (ROADMAP Queue C's
# rule): 2.5x the larger of the kernel route's and the f64-statistics
# route's largest relative loss difference from the plain route over 8
# seeds (scripts/torch_vid2vid_f32_spread.py on an H100), rounded up to
# 1, 2 or 5 x 10^-n: the kernels 1.80e-7 (loss_d), the f64 sums 1.37e-7
# (g_feat) on NVIDIA H100 80GB HBM3, 700.00 W; all its losses are taken
# before any update, so one step differs only by the order of #1's sums
VID_SOURCES = (2, 16)
VID_EPOCHS = 2
VID_STOP = 6
VID_KERNEL_STEPS = 2
VID_LOSS_KEYS = ("loss_d", "loss_dt", "loss_g", "g_gan", "g_gan_t",
                 "g_feat")
VID_F32_RTOL = 5e-7
# slice 12: the host image path at pix2pixHD's 512x1024 (median of
# S12_REPS decodes and resizes per route), the loader over S12_PAIRS
# uncached 256² pairs with S12_WORKERS worker processes against none, the
# reference run of phase 10's data with the new losses and eval options
# (S12_STYLE is lambda_style, which has no flag), the new ops' backward
# against f64 (S12_GRAD_RTOL of the largest entry), init_type at full width
S12_REPS = 5
S12_PAIRS = 72
S12_WORKERS = 4
S12_SKIP = 5
S12_STYLE = 1.0
S12_GRAD_RTOL = 1e-4
S12_INIT_GAIN = 0.5
# slice 13 (phase 17), data parallel: (a) and (c) train edges2shoes_dp
# through cli.train on DP_E2S_PAIRS (train, test) synthetic 256² pairs, 2
# steps an epoch at the preset's global batch 64, DP_EPOCHS epochs; (a)
# times DP_TIMED steps with the process group; (b) takes one f32 step at
# global batch DP_GLOBAL_BATCH on 2 gloo ranks and holds the sync-BatchNorm
# backward within DP_BN_TOL_OF_MAX of the largest |dx| of f64; (c)
# preempts at step DP_STOP and relaunches at world size 1 and at global
# batch DP_REBASE_BATCH; (d) takes REMAT_STEPS bf16 pix2pixHD steps a mode
DP_E2S_PAIRS = (128, 2)
DP_EPOCHS = 2
DP_TIMED = 3
DP_GLOBAL_BATCH = 8
DP_BN_TOL_OF_MAX = 1e-4
DP_STOP = 3
DP_REBASE_BATCH = 32
# (b)'s replica check: bf16 steps at data=2 in cuDNN's default mode
DP_HASH_STEPS = 2
REMAT_MODES = (False, "full", "conv")
REMAT_STEPS = 3
# slice 13b (phase 18), the spatial axis: (a) pix2pixhd bf16 at 2 ranks,
# SP_WARMUP + SP_TIMED steps; (b) the f32 losses' band (step 1, as
# E2S_STEP1_RTOL); (d) the windowed ops' input gradients against f64 on
# an uneven map; (e) cli.train on SP_CLI_PAIRS synthetic pairs, preempted
# at step SP_CLI_STOP
SP_WARMUP, SP_TIMED = 2, 3
SP_LOSS_RTOL = 1e-4
SP_CITY_KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg", "g_tv")
SP_OPS_SHAPE = (1, 32, 129, 96)
SP_GRAD_TOL_OF_MAX = 1e-5
SP_CLI_PAIRS = (4, 2)
SP_CLI_STOP = 3
# slice 13b-time and 13c (phase 19), the time and model axes: (a) cli.train
# of vid2vid_temporal on time=4 over AX_CLIPS clips for AX_EPOCHS epochs;
# (b) AX_KERNEL_STEPS kernel-form steps; (c) pix2pixhd on model=2 for
# AX_TP_WARMUP + AX_TP_TIMED steps; (b)/(c)'s f32 losses against the
# one-rank step within AX_LOSS_RTOL (step 1, as SP_LOSS_RTOL), and after
# (c)'s bf16 steps every replicated tensor the same bits on both model
# ranks; (d) the model=2 engine within AX_SERVE_ATOL and AX_SERVE_LEVELS
# uint8 levels of the one-rank engine (the partial convs' all-reduce adds
# in another order: 5.38e-5 max abs measured on an H100, so a level can
# flip at a rounding edge)
AX_CLIPS, AX_EPOCHS = 2, 2
AX_KERNEL_STEPS = 2
AX_TP_WARMUP, AX_TP_TIMED = 2, 3
AX_LOSS_RTOL = 1e-4
AX_SERVE_ATOL = 1e-4
AX_SERVE_LEVELS = 1
# slice 13c-PP (phase 20): path A at global batch PP_BATCH (the preset's
# 1 cannot fill 3 stages) in PP_MICRO microbatches on pipe=3, PP_WARMUP +
# PP_TIMED bf16 steps; pix2pixhd int8 on model=2 for PP_TP_WARMUP +
# PP_TP_TIMED bf16 steps. The f32 bands, set before the first run on the
# card: the losses of a multi-rank step 1 against the one-rank step as
# AX_LOSS_RTOL; under int8 ((b), (d)) the losses before the first update
# and (b)'s stored amax after the step (each a max of activations the
# step moves) as INT8_STEP1_RTOL, since a quantizer flips q where a value
# sits at a rounding tie (the microbatches' and the model group's sums add
# in another order), and loss_c, which follows G's first Adam update, as
# INT8_LATER_RTOL. (d)'s amax: band_of the one-rank kernels-vs-plain
# spread of the same call (set after the first card run, PR 21, where a
# flat 1e-3 failed at 1.51e-2: a single flipped q moves an activation's
# max by a grid step, 1/127 of it)
PP_STAGES, PP_BATCH, PP_MICRO = 3, 4, 4
PP_WARMUP, PP_TIMED = 2, 3
PP_TP_WARMUP, PP_TP_TIMED = 2, 3
PP_LOSS_RTOL = 1e-4
PP_INT8_RTOL, PP_INT8_AFTER_RTOL = 1e-3, 1e-2
# net_c's conv bias in front of its BatchNorm: the norm subtracts it, so
# its gradient is rounding noise and Adam's first step takes its sign from
# that noise (1.25 of its update between two one-rank routes on the CPU);
# the update distances leave it out
PP_DEAD = ("net_c/ConvLayer_1.conv.bias",)


def epilogue_plan(ngf: int, n_global: int, n_local: int, h: int, w: int):
    """(H, W, C, act, residual) of every norm epilogue of one
    Pix2PixHDGenerator forward, in order (models/pix2pixhd.py)."""
    plan = []
    hh, ww, c = h // 2, w // 2, ngf          # G1 runs at half resolution
    plan.append((hh, ww, c, "relu", False))
    for i in range(4):
        hh, ww, c = hh // 2, ww // 2, min(ngf * 2 ** (i + 1), 1024)
        plan.append((hh, ww, c, "relu", False))
    plan += [(hh, ww, c, "relu", False), (hh, ww, c, "none", True)] * n_global
    for i in reversed(range(4)):
        hh, ww, c = hh * 2, ww * 2, min(ngf * 2 ** i, 1024)
        plan.append((hh, ww, c, "relu", False))
    plan.append((h, w, ngf // 2, "relu", False))             # G2 stem
    plan.append((h // 2, w // 2, ngf, "relu", False))        # G2 down
    plan += [(h // 2, w // 2, ngf, "relu", False),
             (h // 2, w // 2, ngf, "none", True)] * n_local
    plan.append((h, w, ngf // 2, "relu", False))             # G2 up
    return plan


class Timer:
    """Device time of a callable with CUDA events: the stream is held by a
    sleep kernel while the host enqueues the timed work, so host launch
    overhead is not counted; the L2 cache is evicted before every run."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = TIMING_REPS) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_row(nbytes: int, flops: float, dtype: torch.dtype):
    """``bound_ms``, the larger of the bytes over the memory rate and the
    operations over the peak rate for the operands' type, and
    ``bound_by``, which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def batchnorm_plan(ngf: int, n_blocks: int, h: int, w: int):
    """(M, C) of every BatchNorm of one reference train step at batch 1, in
    order: G twice (the G step, then the net_c branch), each with 3
    encoder, 2·n_blocks trunk, 2 decoder and the head's BatchNorm
    (models/expand.py), and net_c twice with one (models/compression.py)."""
    p = h * w
    g = ([(p, ngf), (p // 4, 2 * ngf), (p // 16, 4 * ngf)]
         + [(p // 16, 4 * ngf)] * (2 * n_blocks)
         + [(p // 4, 2 * ngf), (p, ngf), (p, 3)])
    return 2 * g + 2 * [(p, 64)]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(what, got, want, atol, rtol):
    excess = ((got.float() - want.float()).abs()
              - (atol + rtol * want.float().abs())).max()
    if not bool(excess <= 0):
        raise AssertionError(f"{what}: kernel differs from plain version by "
                             f"{max_err(got, want):.3g} (atol {atol}, "
                             f"rtol {rtol})")


def main_path_forwards():
    """Forward batches of the main path by batch size (each batch size is
    a bucket, so N of every kernel launch equals it)."""
    return collections.Counter(RUN_BATCHES) + collections.Counter(
        {1: N_REQUESTS})


def make_input(gen, n, c, h, w, dtype, device):
    """channels_last (n, c, h, w) with a different mean and spread per
    sample, so a kernel that mixes samples up disagrees."""
    i = torch.arange(n, device=device, dtype=torch.float32).view(n, 1, 1, 1)
    x = torch.randn((n, c, h, w), generator=gen, device=device)
    return (x * (1.5 + 0.5 * i) + 0.25 - 0.5 * i).to(dtype).contiguous(
        memory_format=torch.channels_last)


def expand_norm_plan(ngf: int, n_blocks: int, h: int, w: int,
                     out_nc: int = 3):
    """(H, W, C, form) of every instance norm of one ExpandNetwork forward
    with ``norm="pallas_instance"`` (models/expand.py): #2 ("apply") at the
    k9 stem, two downsamples, two upsamples and the head; #3 at both
    epilogues of each residual block."""
    apply = [(h, w, ngf), (h // 2, w // 2, 2 * ngf), (h // 4, w // 4, 4 * ngf),
             (h // 2, w // 2, 2 * ngf), (h, w, ngf), (h, w, out_nc)]
    blocks = [(h // 4, w // 4, 4 * ngf, "relu"),
              (h // 4, w // 4, 4 * ngf, "relu+residual")] * n_blocks
    return [shape + ("apply",) for shape in apply] + blocks


def d_norm_plan(ndf: int, n_layers: int, num_D: int, h: int, w: int):
    """(H, W, C, "leaky") of every inner epilogue of one multiscale D
    forward (models/patchgan.py): k4 pad-2 convs give H // stride + 1 rows
    (stride 2) or H + 1 (stride 1); each scale sees the input pooled by
    AvgPool(3, 2, 1) once more."""
    plan = []
    for _ in range(num_D):
        hh, ww = h // 2 + 1, w // 2 + 1              # the stem, stride 2
        nf = ndf
        for i in range(n_layers):
            stride = 2 if i < n_layers - 1 else 1
            nf = min(nf * 2, 512)
            hh, ww = hh // stride + 1, ww // stride + 1
            plan.append((hh, ww, nf, "leaky"))
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return plan


def instance_config():
    """Path A: the ``reference`` preset with instance norms in G and D."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("reference")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, norm="pallas_instance", norm_d="pallas_instance"))


def path_a_step_plan(cfg):
    """(H, W, C, form) of every instance norm of one path-A train step: G
    twice (the G step and the net_c branch), D twice (fake, real)."""
    m = cfg.model
    h, w = cfg.image_hw
    return (2 * expand_norm_plan(m.ngf, m.n_blocks, h, w, m.output_nc)
            + 2 * d_norm_plan(m.ndf, m.n_layers_D, m.num_D, h, w))


def form_of(act: str, has_res: bool) -> str:
    return act + ("+residual" if has_res else "")


def instance_launches(plan, a_plan, a_steps: int, b_steps: int):
    """{(N, H, W, C, form): launches of #2 (form "apply") or #3 (the
    others)} on the main paths: pix2pixHD serving (``plan`` per forward at
    each batch size), path A (``a_plan`` per step, N = 1) and path B
    (``plan`` per step, N = 1). #1 runs once before each of them."""
    out = collections.Counter()
    for n, forwards in main_path_forwards().items():
        for h, w, c, act, res in plan:
            out[(n, h, w, c, form_of(act, res))] += forwards
    for h, w, c, form in a_plan:
        out[(1, h, w, c, form)] += a_steps
    for h, w, c, act, res in plan:
        out[(1, h, w, c, form_of(act, res))] += b_steps
    return out


def kernel_phase(device, launches):
    """#1, #2, #3 and #4 at every (N, shape) of ``launches`` (and each of
    its forms), in bf16 and f32, against their plain versions, with
    times."""
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats, instance_norm_stats_plain)

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    by_shape = collections.defaultdict(dict)
    for (n, h, w, c, form), count in launches.items():
        by_shape[(n, h, w, c)][form] = count
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.tensor([], dtype=dtype).element_size()
        for (n, h, w, c), forms in sorted(by_shape.items()):
            where = f"{str(dtype)[6:]} N={n} {h}x{w}x{c}"
            x = make_input(gen, n, c, h, w, dtype, device)
            numel = x.numel()
            mean, rstd = instance_norm_stats(x)
            pmean, prstd = instance_norm_stats_plain(x)
            assert_close(f"stats {where} mean", mean, pmean, *STATS_TOL)
            assert_close(f"stats {where} rstd", rstd, prstd, *STATS_TOL)
            common = dict(dtype=str(dtype)[6:], n=n, shape=(h, w, c))
            rows.append(dict(
                kernel="instance_norm_stats", **common, form="-",
                launches=sum(forms.values()),
                max_abs_err=max(max_err(mean, pmean), max_err(rstd, prstd)),
                ms=timer(lambda: instance_norm_stats(x)),
                plain_ms=timer(lambda: instance_norm_stats_plain(x)),
                library_ms=timer(lambda: torch.var_mean(
                    x, dim=(2, 3), correction=0)),
                **bound_row(numel * elt + 2 * n * c * 4, 3 * numel, dtype)))
            for form, count in sorted(forms.items()):
                if form.endswith("+quant"):
                    rows.append(quant_row(timer, x, pmean, prstd, common,
                                          count, where, form))
                    continue
                if form == "apply":
                    rows.append(apply_row(timer, x, pmean, prstd, common,
                                          count, where))
                    continue
                r = make_input(gen, n, c, h, w, dtype, device) \
                    if form.endswith("+residual") else None
                rows.append(norm_act_row(timer, x, r, pmean, prstd, common,
                                         count, where, form))
    print("kernel phase (#1, #2, #3, #4; device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def site_check(what, kernel, plain, x, **kw):
    """#1 then ``kernel`` as ops/instance_norm.py launches them (x read
    before the dependent launch's wait): its outputs bitwise ``plain``'s on
    #1's statistics. Returns a callable that runs the site once."""
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats)

    def site():
        mean, rstd = instance_norm_stats(x)
        return mean, rstd, kernel(x, mean, rstd, x_ready=True, **kw)

    mean, rstd, got = site()
    want = plain(x, mean, rstd, **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what} after #1: not bitwise the plain "
                                 f"version ({max_err(g, w):.3g})")
    return site


def norm_act_row(timer, x, r, mean, rstd, common, count, where, form):
    """#3 against its plain version at one shape and form (``r`` the
    residual, or None): bitwise, given the same statistics and right after
    #1 on #1's statistics (x and the residual read before the dependent
    launch's wait), with and without the affine; then its times alone and
    as a site (#1 then #3). The library yardstick is ``F.instance_norm``,
    which computes the normalize alone (no activation or residual)."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.cuda.norm_act import (norm_act, norm_act_plain,
                                                 plan_for)

    n, c = x.shape[:2]
    act = form.partition("+")[0]
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    affine = {"scale": torch.randn(c, generator=gen, device=x.device) * 0.1
              + 1, "bias": torch.randn(c, generator=gen, device=x.device)
              * 0.1}
    sites = []
    for kw in ({}, affine):
        y = norm_act(x, mean, rstd, residual=r, act=act, **kw)
        if not torch.equal(y, norm_act_plain(x, mean, rstd, residual=r,
                                             act=act, **kw)):
            raise AssertionError(f"norm_act {where} {form}: not bitwise the "
                                 "plain version")
        sites.append(site_check(f"norm_act {where} {form}", norm_act,
                                norm_act_plain, x, residual=r, act=act,
                                **kw))
    elt = x.element_size()
    ms = timer(lambda: norm_act(x, mean, rstd, residual=r, act=act))
    site_ms = timer(sites[0])
    return dict(
        kernel="norm_act", **common, form=form,
        path=plan_for(x, x, flat3=False, residual=r).path, launches=count,
        max_abs_err=0.0, ms=ms, us=ms * 1e3, site_us=site_ms * 1e3,
        plain_ms=timer(lambda: norm_act_plain(x, mean, rstd, residual=r,
                                              act=act)),
        library_ms=timer(lambda: F.instance_norm(x)),
        **bound_row(x.numel() * elt * (2 if r is None else 3)
                    + 2 * n * c * 4, 4 * x.numel(), x.dtype))


def quant_row(timer, x, mean, rstd, common, count, where, form):
    """#4 against its plain version at one shape, given the same
    statistics: q and amax bitwise, at the path's kind of scale (the
    activation's amax / 127) and at 2⁻⁴ on inputs from binary grids (whose
    quotients hit rounding ties), and right after #1 on #1's statistics;
    then its times alone and as a site (#1 then #4). The library yardstick
    is ``F.instance_norm``, which computes the normalize alone (no
    activation, quantize or amax)."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.cuda.norm_act import (norm_act_quant,
                                                 norm_act_quant_plain,
                                                 plan_for)

    act = form.partition("+")[0]
    one = torch.ones((), device=x.device)
    sx = norm_act_quant_plain(x, mean, rstd, sx=one, act=act)[1] / 127.0
    grid = ((x.float() * 16).round() / 16).to(x.dtype)
    cases = ((x, mean, rstd, sx),
             (grid, (mean * 16).round() / 16, (rstd * 4).round() / 4,
              torch.full((), 2.0 ** -4, device=x.device)))
    for xx, mm, rr, ss in cases:
        q, amax = norm_act_quant(xx, mm, rr, sx=ss, act=act)
        pq, pamax = norm_act_quant_plain(xx, mm, rr, sx=ss, act=act)
        if not (torch.equal(q, pq) and torch.equal(amax, pamax)):
            raise AssertionError(
                f"norm_act_quant {where} {form}: not bitwise the plain "
                f"version (q {max_err(q, pq):.3g}, amax "
                f"{max_err(amax, pamax):.3g})")
    site = site_check(f"norm_act_quant {where} {form}", norm_act_quant,
                      norm_act_quant_plain, x, sx=sx, act=act)
    n, c = x.shape[:2]
    elt = x.element_size()
    ms = timer(lambda: norm_act_quant(x, mean, rstd, sx=sx, act=act))
    site_ms = timer(site)
    return dict(
        kernel="norm_act_quant", **common, form=form,
        path=plan_for(x, x, flat3=False).path, launches=count,
        max_abs_err=0.0, ms=ms, us=ms * 1e3, site_us=site_ms * 1e3,
        plain_ms=timer(lambda: norm_act_quant_plain(x, mean, rstd, sx=sx,
                                                    act=act)),
        library_ms=timer(lambda: F.instance_norm(x)),
        **bound_row(2 * x.numel() * elt + 2 * n * c * 4 + 8,
                    QUANT_OPS_PER_ELEMENT * x.numel(), x.dtype))


def int8_config():
    """Slice 5: ``facades_int8`` with the quantize-fused D epilogue."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("facades_int8")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, norm_d="pallas_instance", int8_fused_epilogue=True))


def int8_d_plan(cfg):
    """(H, W, C, form) of every epilogue of one D forward of a fused int8
    path: in each scale #4 ("leaky+quant") before inner convs 2 and 3, #3
    after inner conv 3; #1 before each."""
    m = cfg.model
    plan = d_norm_plan(m.ndf, m.n_layers_D, m.num_D, *cfg.image_hw)
    n = m.n_layers_D
    return [(h, w, c, "leaky" if i % n == n - 1 else "leaky+quant")
            for i, (h, w, c, _) in enumerate(plan)]


def int8_forms_phase(device):
    """Every int8 contraction of the fused facades_int8 D at its shapes
    (256², batch 1), on random int8 operands: the im2col + ``_int_mm``
    result exact against an f64 conv (or product) of the same operands;
    then its time beside cuDNN's bf16 conv of the same shape (forward,
    input gradient, weight gradient). Also the times of the forms the
    JAX dispatch keeps in bf16 (the stride-2 dgrads, the 65² wgrad)."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from p2p_tpu_torch.ops.int8 import conv_i32, im2col, int_mm

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def bf(t):
        return t.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    rows = []
    # (name, x NHWC, w HWIO, stride): inner convs 1, 2, 3
    convs = [("conv1", (1, 129, 129, 64), (4, 4, 64, 128), 2),
             ("conv2", (1, 65, 65, 128), (4, 4, 128, 256), 2),
             ("conv3", (1, 33, 33, 256), (4, 4, 256, 512), 1)]
    for name, xs, ws, s in convs:
        x8, w8 = i8(*xs), i8(*ws)
        pads = (2, 2)
        y = conv_i32(x8, w8, (s, s), pads)
        ho, wo, o = y.shape[1:]
        x64 = x8.double().permute(0, 3, 1, 2)
        w64 = w8.double().permute(3, 2, 0, 1)
        want = F.conv2d(x64, w64, stride=s, padding=2).permute(0, 2, 3, 1)
        forms = [("forward", y, want,
                  lambda: conv_i32(x8, w8, (s, s), pads),
                  lambda xb=bf(x8), wb=w8.to(torch.bfloat16).permute(
                      3, 2, 0, 1).contiguous(): F.conv2d(
                      xb, wb, stride=s, padding=2),
                  2 * ho * wo * o * 16 * xs[3])]
        g8 = i8(1, ho, wo, o)
        if s == 1:     # the int8 dgrad: the flipped, transposed kernel
            wt = w8.flip(0, 1).transpose(2, 3).contiguous()
            dx = conv_i32(g8, wt, (1, 1), (1, 1))
            want_dx = F.conv_transpose2d(
                g8.double().permute(0, 3, 1, 2), w64, stride=1,
                padding=2).permute(0, 2, 3, 1)
            forms.append((
                "dgrad", dx, want_dx,
                lambda: conv_i32(g8, wt, (1, 1), (1, 1)),
                lambda gb=bf(g8), wb=w8.to(torch.bfloat16).permute(
                    3, 2, 0, 1).contiguous(): conv2d_input(
                    (1, xs[3], xs[1], xs[2]), wb, gb, s, 2),
                2 * xs[1] * xs[2] * xs[3] * 16 * o))
        if ho * wo <= 4096:   # the int8 wgrad: one product over N·Ho·Wo
            rows_x, _ = im2col(x8, (4, 4), (s, s), pads)
            g2 = g8.reshape(ho * wo, o)
            dw = int_mm(rows_x.t(), g2)
            want_dw = rows_x.t().double() @ g2.double()
            forms.append((
                "wgrad", dw, want_dw,
                lambda: int_mm(im2col(x8, (4, 4), (s, s), pads)[0].t(),
                               g2),
                lambda xb=bf(x8), gb=bf(g8): conv2d_weight(
                    xb, (o, xs[3], 4, 4), gb, s, 2),
                2 * ho * wo * o * 16 * xs[3]))
        for form, got, exact, fn, cudnn, flops in forms:
            if got.dtype != torch.int32 or not torch.equal(got.double(),
                                                           exact):
                raise AssertionError(f"int8 {name} {form}: not exact "
                                     "against the f64 conv")
            # bytes: both int8 operands read once, the int32 result written
            nbytes = x8.numel() + w8.numel() + 4 * got.numel()
            if form == "dgrad":
                nbytes = g8.numel() + w8.numel() + 4 * got.numel()
            elif form == "wgrad":
                nbytes = x8.numel() + g8.numel() + 4 * got.numel()
            rows.append(dict(
                conv=name, form=form, shape=dict(x=list(xs), w=list(ws),
                                                 stride=s),
                exact=True, ms=timer(fn), cudnn_bf16_ms=timer(cudnn),
                gop=flops / 1e9, bound_ms=max(
                    nbytes / PEAK_BYTES_PER_S, flops / PEAK_INT8_OP_PER_S
                ) * 1e3))
    # the forms the JAX dispatch keeps in bf16 (f32 convs on bf16 values)
    for name, xs, ws, s in convs:
        xb = torch.randn((1, xs[3], xs[1], xs[2]), generator=gen,
                         device=device).contiguous(
            memory_format=torch.channels_last)
        wb = torch.randn((ws[3], ws[2], 4, 4), generator=gen, device=device)
        y = F.conv2d(xb, wb, stride=s, padding=2)
        gb = torch.randn(y.shape, generator=gen, device=device).contiguous(
            memory_format=torch.channels_last)
        if s == 2:
            rows.append(dict(conv=name, form="dgrad (bf16 on w_hat)",
                             ms=timer(lambda: conv2d_input(xb.shape, wb, gb,
                                                           s, 2))))
        if y.shape[2] * y.shape[3] > 4096:
            rows.append(dict(conv=name, form="wgrad (bf16 on x_hat)",
                             ms=timer(lambda: conv2d_weight(xb, wb.shape, gb,
                                                            s, 2))))
    print("int8 forms (facades_int8 D at 256², batch 1; im2col + _int_mm "
          "exact against f64; device ms, median of "
          f"{TIMING_REPS} cold-L2 runs):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def apply_row(timer, x, mean, rstd, common, count, where):
    """#2 against its plain version at one shape: bitwise, given the same
    statistics and right after #1 on #1's statistics, with and without the
    affine; on a vector path (16-byte vectors along C, or across pixels at
    C = 3); then its times alone and as a site (#1 then #2). The library
    yardstick is ``F.batch_norm`` in inference mode on the (1, C, H, W)
    tensor with ``running_var = rstd⁻² − ε``, the same function, at N = 1;
    at N > 1 (the video kernel form's frames), where no library call
    normalizes each sample by given statistics, ``F.instance_norm`` (the
    normalize with its own statistics, #3's yardstick)."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_apply, instance_norm_apply_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import plan_for

    n, c = x.shape[:2]
    path = plan_for(x, x).path
    if path == "element":
        raise AssertionError(f"#2 {where}: one element at a time on the "
                             "main path")
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    affine = {"scale": torch.randn(c, generator=gen, device=x.device) * 0.1
              + 1, "bias": torch.randn(c, generator=gen, device=x.device)
              * 0.1}
    sites = []
    for kw in ({}, affine):
        y = instance_norm_apply(x, mean, rstd, **kw)
        if not torch.equal(y, instance_norm_apply_plain(x, mean, rstd,
                                                        **kw)):
            raise AssertionError(f"instance_norm_apply {where}: not bitwise "
                                 "the plain version")
        sites.append(site_check(f"instance_norm_apply {where}",
                                instance_norm_apply,
                                instance_norm_apply_plain, x, **kw))
    eps = 1e-5
    if n == 1:
        var = rstd[0].double().pow(-2).sub(eps).float()

        def library():
            return F.batch_norm(x, mean[0], var, training=False, eps=eps)
    else:
        def library():
            return F.instance_norm(x, eps=eps)
    elt = x.element_size()
    ms = timer(lambda: instance_norm_apply(x, mean, rstd))
    site_ms = timer(sites[0])
    return dict(
        kernel="instance_norm_apply", **common, form="apply", path=path,
        launches=count, max_abs_err=0.0, ms=ms, us=ms * 1e3,
        site_us=site_ms * 1e3,
        plain_ms=timer(lambda: instance_norm_apply_plain(x, mean, rstd)),
        library_ms=timer(library),
        **bound_row(2 * x.numel() * elt + 2 * n * c * 4, 2 * x.numel(),
                    x.dtype))


def moments_phase(device, launches):
    """#5 at every (M, C) of the reference and facades train steps
    (``launches``: their count on the main paths): kernel vs plain version
    (per channel, within MOMENTS_RTOL_OF_ABS_SUM of Σ|x| and Σx²), and
    times. Channel 0 of each input has a large mean and a small spread;
    the others differ in mean and spread."""
    from p2p_tpu_torch.ops.cuda.batch_moments import (
        batch_moments, batch_moments_plain)

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.tensor([], dtype=dtype).element_size()
        for m, c in sorted(launches):
            mean = torch.linspace(-2.0, 2.0, c, device=device)
            spread = torch.linspace(3.0, 0.1, c, device=device)
            mean[0], spread[0] = 40.0, 0.01
            x = (torch.randn((m, c), generator=gen, device=device) * spread
                 + mean).to(dtype)
            s1, s2 = batch_moments(x)
            p1, p2 = batch_moments_plain(x)
            abs_sum = x.float().abs().sum(dim=0)
            where = f"batch_moments {str(dtype)[6:]} M={m} C={c}"
            for what, got, want, scale in (("sum", s1, p1, abs_sum),
                                           ("sum of squares", s2, p2, p2)):
                excess = ((got - want).abs()
                          - MOMENTS_RTOL_OF_ABS_SUM * scale).max()
                if not bool(excess <= 0):
                    raise AssertionError(
                        f"{where} {what}: kernel differs from plain version "
                        f"by {max_err(got, want):.3g}")
            rows.append(dict(
                kernel="batch_moments", dtype=str(dtype)[6:], n=1,
                shape=(m, c), form="-", launches=launches[(m, c)],
                max_abs_err=max(max_err(s1, p1), max_err(s2, p2)),
                max_rel_err=max(float(((s1 - p1).abs() / abs_sum).max()),
                                float(((s2 - p2).abs() / p2).max())),
                ms=timer(lambda: batch_moments(x)),
                plain_ms=timer(lambda: batch_moments_plain(x)),
                library_ms=timer(lambda: torch.var_mean(x, dim=0)),
                **bound_row(m * c * elt + 2 * c * 4, 3 * m * c, dtype)))
    print("moments phase (#5; device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def subpixel_phase(device, fwd_launches, dx_launches):
    """#6 and #7 at the facades image head's shapes, x (N, 128, 128, 128)
    and w (2, 2, 128, 12) (``*_launches``: N → launches on the main
    paths), in bf16 and f32 against their plain versions (TF32 off), and
    times beside the library's conv (#6) and conv input gradient (#7)."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.cuda.subpixel_head import (
        subpixel_head_dx, subpixel_head_dx_plain, subpixel_head_fwd,
        subpixel_head_fwd_plain)

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    c, h, w, f4 = 128, 128, 128, 12
    rows = []
    with tf32_off():
        for dtype in (torch.bfloat16, torch.float32):
            elt = torch.tensor([], dtype=dtype).element_size()
            atol, rtol = TOL[dtype]
            wt = (torch.randn((2, 2, c, f4), generator=gen, device=device)
                  * 0.05).to(dtype)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            for n in sorted(set(fwd_launches) | set(dx_launches)):
                where = f"{str(dtype)[6:]} N={n}"
                x = make_input(gen, n, c, h, w, dtype, device)
                dz = make_input(gen, n, f4, h + 1, w + 1, torch.float32,
                                device)
                z_bytes = n * (h + 1) * (w + 1) * f4 * 4
                flops = 2 * n * (h + 1) * (w + 1) * f4 * 4 * c
                z = subpixel_head_fwd(x, wt)
                pz = subpixel_head_fwd_plain(x, wt)
                assert_close(f"subpixel_head_fwd {where}", z, pz,
                             *HEAD_Z_TOL)
                if not torch.equal(subpixel_head_fwd(x, wt), z):
                    raise AssertionError(f"subpixel_head_fwd {where}: two "
                                         "launches differ")
                dx = subpixel_head_dx(dz, wt)
                pdx = subpixel_head_dx_plain(dz, wt)
                assert_close(f"subpixel_head_dx {where}", dx, pdx,
                             *(HEAD_DX_TOL if dtype == torch.bfloat16
                               else (atol, rtol)))
                if not torch.equal(subpixel_head_dx(dz, wt), dx):
                    raise AssertionError(f"subpixel_head_dx {where}: two "
                                         "launches differ")
                common = dict(dtype=str(dtype)[6:], n=n, shape=(h, w, c),
                              form=f"F4={f4}")
                rows.append(dict(
                    kernel="subpixel_head_fwd", **common,
                    launches=fwd_launches.get(n, 0), max_abs_err=max_err(
                        z, pz),
                    ms=timer(lambda: subpixel_head_fwd(x, wt)),
                    plain_ms=timer(lambda: subpixel_head_fwd_plain(x, wt)),
                    library_ms=timer(lambda: F.conv2d(x, w_oihw,
                                                      padding=1)),
                    flop_ms_cuda_cores=flops / PEAK_FLOP_PER_S[
                        torch.float32] * 1e3,
                    **bound_row(x.numel() * elt + wt.numel() * elt + z_bytes,
                                flops, dtype)))
                dz_in = dz.to(dtype)
                rows.append(dict(
                    kernel="subpixel_head_dx", **common,
                    launches=dx_launches.get(n, 0), max_abs_err=max_err(
                        dx, pdx),
                    ms=timer(lambda: subpixel_head_dx(dz, wt)),
                    plain_ms=timer(lambda: subpixel_head_dx_plain(dz, wt)),
                    library_ms=timer(lambda: torch.nn.grad.conv2d_input(
                        x.shape, w_oihw, dz_in, padding=1)),
                    flop_ms_cuda_cores=flops / PEAK_FLOP_PER_S[
                        torch.float32] * 1e3,
                    **bound_row(z_bytes + wt.numel() * elt + x.numel() * elt,
                                flops, dtype)))
    print("subpixel head phase (#6, #7; device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    for num, kernel, before, library in (
            (6, "subpixel_head_fwd", HEAD_BEFORE_US, "F.conv2d"),
            (7, "subpixel_head_dx", HEAD_DX_BEFORE_US, "conv2d_input")):
        print(f"#{num} bf16 against its time before the redesign (device us "
              f"per launch; library: {library}):")
        for r in rows:
            if r["kernel"] == kernel and r["dtype"] == "bfloat16":
                print(f"  N={r['n']}: {r['ms'] * 1e3:.2f} (before: "
                      f"{before.get(r['n'], 'not measured')}), bound "
                      f"{r['bound_ms'] * 1e3:.3f}, library "
                      f"{r['library_ms'] * 1e3:.2f}, {r['launches']} "
                      "launches")
    return rows


def totals(rows, kernel, dtype="bfloat16"):
    """A kernel's launches on its main paths at their dtype (bf16): each
    (N, shape, form) time weighted by how often the paths launched it;
    ``bound_by`` is what bounds the launch-weighted sum."""
    sel = [r for r in rows if r["kernel"] == kernel and r["dtype"] == dtype]
    out = {k: sum(r[k] * r["launches"] for r in sel)
           for k in ("ms", "plain_ms", "bound_ms")}
    # a kernel with no one-call library counterpart has none on any row
    out["library_ms"] = (None if any(r["library_ms"] is None for r in sel)
                         else sum(r["library_ms"] * r["launches"]
                                  for r in sel))
    out["launches"] = sum(r["launches"] for r in sel)
    out["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    by = collections.Counter()
    for r in sel:
        by[r["bound_by"]] += r["bound_ms"] * r["launches"]
    out["bound_by"] = max(by, key=by.get)
    return out


def _wrappers():
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_apply, instance_norm_finalize, instance_norm_stats,
        instance_norm_sums)
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act, norm_act_quant
    from p2p_tpu_torch.ops.cuda.subpixel_head import (subpixel_head_dx,
                                                      subpixel_head_fwd)

    return {"instance_norm_stats": instance_norm_stats,
            "instance_norm_sums": instance_norm_sums,
            "instance_norm_finalize": instance_norm_finalize,
            "instance_norm_apply": instance_norm_apply, "norm_act": norm_act,
            "norm_act_quant": norm_act_quant,
            "batch_moments": batch_moments,
            "subpixel_head_fwd": subpixel_head_fwd,
            "subpixel_head_dx": subpixel_head_dx}


def only(**counts):
    """The launch counts of a run that launched these kernels, and no
    other."""
    return {name: counts.get(name, 0) for name in _wrappers()}


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def check_png(path: str, h: int, w: int) -> None:
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    pw, ph = int.from_bytes(head[16:20], "big"), int.from_bytes(
        head[20:24], "big")
    if (ph, pw) != (h, w):
        raise AssertionError(f"{path} is {pw}x{ph}, expected {w}x{h}")


def slice_phase(device, card, profile: bool):
    import p2p_tpu_torch.ops.instance_norm as seam
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.models.registry import define_G, init_weights
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_plain
    from p2p_tpu_torch.serve.engine import InferenceEngine

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    t0 = time.perf_counter()
    generator = init_weights(define_G(cfg.model),
                             torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in generator.parameters())
    engine = InferenceEngine(cfg, generator, buckets=BUCKETS, dtype="bf16")
    engine.warmup()
    print(f"slice: pix2pixhd generator, {n_params} parameters, ngf "
          f"{cfg.model.ngf}, {h}x{w}; built and warmed {BUCKETS} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    reqs = np.random.default_rng(SEED).integers(
        0, 256, (N_REQUESTS, h, w, 3), dtype=np.uint8)
    names = [f"req{i}.png" for i in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        reset_launch_counts()
        # the main path: RUN_BATCHES through the serving pipeline (PNG
        # files), then every request alone for its latency
        starts = np.cumsum((0,) + RUN_BATCHES)
        stats, _ = engine.run([{"input": reqs[a:b]}
                               for a, b in zip(starts[:-1], starts[1:])],
                              names=names, out_dir=out_dir)
        latencies, preds = [], []
        for i in range(N_REQUESTS):
            t = time.perf_counter()
            pred, _, n_real = engine.infer_batch({"input": reqs[i:i + 1]})
            engine.synchronize()
            latencies.append((time.perf_counter() - t) * 1e3)
            preds.append(pred[:n_real])
        counts = launch_counts()
        n_forwards = stats.n_batches + N_REQUESTS
        for path in names:
            check_png(os.path.join(out_dir, path), h, w)
    want = NORMS_PER_FORWARD * n_forwards
    print(f"slice: launches over {n_forwards} forward batches: {counts} "
          f"(want {want} of #1 and #3, nothing else)")
    if counts != only(instance_norm_stats=want, norm_act=want):
        raise AssertionError(f"launch counts {counts} != {want} of #1, #3")
    pred = torch.cat(preds)
    if tuple(pred.shape) != (N_REQUESTS, h, w, 3):
        raise AssertionError(f"pred shape {tuple(pred.shape)}")
    if not bool(torch.isfinite(pred).all()) or float(pred.abs().max()) > 1:
        raise AssertionError("pred is not finite within [-1, 1]")
    print(f"slice: served {stats.n_images} requests in {stats.n_batches} "
          f"batches: {stats.img_per_sec:.3f} img/s end to end, "
          f"{stats.device_img_per_sec:.3f} img/s to the last device result; "
          f"latency alone (bucket 1) median "
          f"{statistics.median(latencies):.2f} ms, min {min(latencies):.2f}, "
          f"max {max(latencies):.2f} ms; on {card}", flush=True)

    # f32: the kernels against the plain versions on the same weights and
    # the largest bucket's batch
    n32 = max(BUCKETS)
    with tf32_off():
        eng32 = InferenceEngine(cfg, generator, buckets=(n32,), dtype="f32")
        eng32.warmup()
        before = launch_counts()
        y_kernel, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        with mock.patch.object(seam, "instance_norm_stats",
                               instance_norm_stats_plain), \
                mock.patch.object(seam, "norm_act",
                                  as_wrapper(norm_act_plain)):
            mid = launch_counts()
            y_plain, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        after = launch_counts()
    if any(mid[k] - before[k] != NORMS_PER_FORWARD
           for k in ("instance_norm_stats", "norm_act")) or after != mid:
        raise AssertionError(f"f32 check did not take the intended routes: "
                             f"{before} {mid} {after}")
    diff = max_err(y_kernel, y_plain)
    print(f"slice: f32 (TF32 off) kernels vs plain versions on a batch of "
          f"{n32}: max abs diff "
          f"{diff:.3g} on the tanh output (limit {SLICE_F32_TOL})")
    if not diff <= SLICE_F32_TOL:
        raise AssertionError(f"f32 slice diff {diff} > {SLICE_F32_TOL}")
    del eng32

    if profile:
        profile_forward(engine, reqs[:1])
    return counts, stats, latencies


@contextlib.contextmanager
def tf32_off():
    """f32 convolutions and matmuls in full f32 (no TF32) inside."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def profiled(fn):
    """torch.profiler over one call: ``(table, wall ms, device busy ms,
    kernel launches)``, the table ``key_averages()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    table = prof.key_averages()
    # the table's own "Self CUDA time total": device events only
    busy = sum(e.self_device_time_total for e in table
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in table
                   if e.key.startswith("cudaLaunchKernel"))
    return table, wall, busy, launches


def profile_call(what: str, fn) -> None:
    """torch.profiler over one call: device time by kernel, then the
    call's wall time, the device's busy time and the kernel launches."""
    table, wall, busy, launches = profiled(fn)
    print(table.table(sort_by="cuda_time_total", row_limit=30))
    print(f"profile {what}: wall {wall:.3f} ms (profiler on), device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the wall), "
          f"{launches} kernel launches")


def host_yardstick_ms(n: int = 20000) -> float:
    """Host-clock ms of ``n`` in-place adds on a 4-element CPU tensor, the
    median of 3: PyTorch's per-op host cost alone, no device. Printed
    beside step times, which the host bounds (device busy ~9% of a
    reference step), to tell a slower host from a slower step."""
    a = torch.zeros(4)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(n):
            a.add_(1.0)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def timed_step_calls(trainer):
    """For the duration, ``trainer.train_step`` appends the host-clock
    (start, end) of each call to the list it yields; a call ends at the
    step's last host sync, so its queued device tail falls after it."""
    calls = []
    step = trainer.train_step

    def timed(*a):
        t = time.perf_counter()
        res = step(*a)
        calls.append((t, time.perf_counter()))
        return res

    trainer.train_step = timed
    try:
        yield calls
    finally:
        trainer.train_step = step


def loop_split(calls, t0: float, t1: float):
    """An epoch from ``t0`` to ``t1`` (synchronized) split by its step
    calls: ms a step inside the calls, ms a gap between consecutive calls
    (loader, copies, metric sums), and ms at its ends (the loader's first
    batch before the first call; the last step's device tail and the
    sums' fetch after the last)."""
    inside = sum(e - s for s, e in calls)
    between = sum(b[0] - a[1] for a, b in zip(calls, calls[1:]))
    return (1e3 * inside / len(calls),
            1e3 * between / max(len(calls) - 1, 1),
            1e3 * (t1 - t0 - inside - between))


def profile_forward(engine, batch):
    """One bf16 bucket-1 forward of the serving engine."""
    def fwd():
        engine.infer_batch({"input": batch})
        engine.synchronize()

    profile_call("serving forward", fwd)


def train_phase(device, card, profile: bool):
    """The reference preset's training slice: bf16 steps with their times,
    losses and #5 launch counts, then the f32 kernel-vs-plain check."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_batch
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = get_preset("reference")
    h, w = cfg.image_hw
    m = cfg.model
    per_step = len(batchnorm_plan(m.ngf, m.n_blocks, h, w))
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    host = synthetic_batch(n_steps * cfg.data.batch_size, h, m.quant_bits,
                           seed=SEED, width=w)
    bs = cfg.data.batch_size
    batches = [{k: v[i * bs:(i + 1) * bs] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    vgg = load_vgg19(device=device)
    step = build_train_step(cfg, vgg, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d), ("C", state.net_c))}
    print(f"train: reference preset, {h}x{w}, batch {bs}, {dtype}, ngf "
          f"{m.ngf}, ndf {m.ndf}, {m.n_blocks} blocks, {m.num_D} D scales, "
          f"parameters {sizes}; built in {time.perf_counter() - t0:.1f}s",
          flush=True)

    host = [host_yardstick_ms()]
    counts, med = bf16_train_run(
        "train", state, step, batches, TRAIN_WARMUP,
        only(batch_moments=per_step * n_steps), LOSS_KEYS, card, profile)
    host.append(host_yardstick_ms())
    print(f"train: host yardstick before and after the steps "
          f"{host[0]:.2f}, {host[1]:.2f} ms", flush=True)
    del state, step

    runs = reference_f32_routes(cfg, batches[:TRAIN_F32_STEPS], vgg, SEED,
                                ("kernel", "plain"))
    rels = [{} for _ in range(TRAIN_F32_STEPS)]
    for i, (lk, lp) in enumerate(zip(runs["kernel"][0], runs["plain"][0])):
        for k in LOSS_KEYS:
            rtol = TRAIN_STEP1_RTOL[k] if i == 0 else TRAIN_LATER_RTOL
            rels[i][k] = rel = abs(lk[k] - lp[k]) / abs(lp[k])
            if not rel <= rtol:
                raise AssertionError(f"f32 step {i + 1} {k}: kernel "
                                     f"{lk[k]} vs plain {lp[k]} (rtol {rtol})")
    sk, sp = runs["kernel"][1], runs["plain"][1]
    step1 = ", ".join(f"{k} {rels[0][k]:.3g} ({TRAIN_STEP1_RTOL[k]})"
                      for k in LOSS_KEYS)
    print(f"train: f32 (TF32 off) {TRAIN_F32_STEPS} steps through #5 vs its "
          f"plain version: step 1 rel diff (limit) {step1}; later steps max "
          f"{max(max(r.values()) for r in rels[1:]):.3g} (limit "
          f"{TRAIN_LATER_RTOL}); running stats "
          f"max abs diff {max_err(sk, sp):.3g} (limit {TRAIN_STATS_ATOL} + "
          f"{TRAIN_LATER_RTOL} of the value)")
    assert_close("f32 running stats", sk, sp, TRAIN_STATS_ATOL,
                 TRAIN_LATER_RTOL)
    return counts, med, statistics.mean(host)


def moments_f64(xc: torch.Tensor):
    """#5's function with its sums in f64, each rounded once to f32."""
    xd = xc.double()
    return xd.sum(dim=0).float(), (xd * xd).sum(dim=0).float()


def reference_f32_routes(cfg, batches, vgg, seed, routes):
    """f32 (TF32 off) reference train steps on ``batches`` from the state
    of ``seed``, once per route of BatchNorm's moments: ``"kernel"`` (#5),
    ``"plain"`` (its plain version) or ``"f64"`` (:func:`moments_f64`).
    Returns ``{route: (per-step losses, running statistics of G and net_c
    after the steps)}``."""
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import (
        batch_moments, batch_moments_plain)
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    m = cfg.model
    per_step = len(batchnorm_plan(m.ngf, m.n_blocks, *cfg.image_hw))
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    swap = {"kernel": None, "plain": batch_moments_plain, "f64": moments_f64}
    runs = {}
    with tf32_off():
        for route in routes:
            st = create_train_state(cfg32, seed)
            stp = build_train_step(cfg32, vgg)
            patch = (mock.patch.object(norm, "batch_moments", swap[route])
                     if swap[route] else contextlib.nullcontext())
            before = batch_moments.launches
            with patch:
                losses = [{k: float(v) for k, v in stp(st, b)[1].items()}
                          for b in batches]
            launched = batch_moments.launches - before
            if launched != (per_step * len(batches) if route == "kernel"
                            else 0):
                raise AssertionError(f"f32 {route} run launched #5 "
                                     f"{launched} times")
            stats = torch.cat([b.reshape(-1) for net in (st.net_g, st.net_c)
                               for b in net.buffers()])
            runs[route] = (losses, stats)
    return runs


def facades_config():
    """The ``facades`` preset with the subpixel head on #6/#7."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("facades")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, thin_head=True, head_pallas=True))


def facades_bn_plan(ngf: int, h: int, w: int, num_downs: int = 8):
    """(M, C) of every BatchNorm of one facades U-Net forward at batch 1,
    in order (models/unet.py): encoder levels 1…num_downs−2, then decoder
    levels num_downs−1…1."""
    feats = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
    enc = [(h * w >> 2 * (i + 1), feats[i]) for i in range(1, num_downs - 1)]
    dec = [(h * w >> 2 * i, feats[i - 1])
           for i in reversed(range(1, num_downs))]
    return enc + dec


def facades_serving_phase(device, card, profile: bool):
    """The full-width facades U-Net with the subpixel head served in bf16:
    exactly one #6 per forward batch, then the f32 U-Net through #6
    against it through the plain version."""
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.models.registry import define_G, init_weights
    from p2p_tpu_torch.ops.cuda import subpixel_head
    from p2p_tpu_torch.serve.engine import InferenceEngine

    cfg = facades_config()
    h, w = cfg.image_hw
    t0 = time.perf_counter()
    generator = init_weights(define_G(cfg.model, None, (h, w)),
                             torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in generator.parameters())
    engine = InferenceEngine(cfg, generator, buckets=BUCKETS, dtype="bf16")
    engine.warmup()
    print(f"facades serving: U-Net, {n_params} parameters, ngf "
          f"{cfg.model.ngf}, {h}x{w}, subpixel head on #6; built and warmed "
          f"{BUCKETS} in {time.perf_counter() - t0:.1f}s", flush=True)
    reqs = synthetic_facades_batch(N_REQUESTS, h, seed=SEED)["input"]
    names = [f"req{i}.png" for i in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        reset_launch_counts()
        starts = np.cumsum((0,) + RUN_BATCHES)
        stats, _ = engine.run([{"input": reqs[a:b]}
                               for a, b in zip(starts[:-1], starts[1:])],
                              names=names, out_dir=out_dir)
        latencies, preds = [], []
        for i in range(N_REQUESTS):
            t = time.perf_counter()
            pred, _, n_real = engine.infer_batch({"input": reqs[i:i + 1]})
            engine.synchronize()
            latencies.append((time.perf_counter() - t) * 1e3)
            preds.append(pred[:n_real])
        counts = launch_counts()
        for path in names:
            check_png(os.path.join(out_dir, path), h, w)
    n_forwards = stats.n_batches + N_REQUESTS
    print(f"facades serving: launches over {n_forwards} forward batches: "
          f"{counts} (want {n_forwards} of #6, nothing else)")
    if counts != only(subpixel_head_fwd=n_forwards):
        raise AssertionError(f"launch counts {counts}")
    pred = torch.cat(preds)
    if tuple(pred.shape) != (N_REQUESTS, h, w, 3):
        raise AssertionError(f"pred shape {tuple(pred.shape)}")
    if not bool(torch.isfinite(pred).all()) or float(pred.abs().max()) > 1:
        raise AssertionError("pred is not finite within [-1, 1]")
    print(f"facades serving: {stats.n_images} requests in {stats.n_batches} "
          f"batches: {stats.img_per_sec:.3f} img/s end to end, "
          f"{stats.device_img_per_sec:.3f} img/s to the last device result; "
          f"latency alone (bucket 1) median "
          f"{statistics.median(latencies):.2f} ms, min {min(latencies):.2f}, "
          f"max {max(latencies):.2f} ms; on {card}", flush=True)

    n32 = max(BUCKETS)
    with tf32_off():
        eng32 = InferenceEngine(cfg, generator, buckets=(n32,), dtype="f32")
        eng32.warmup()
        before = subpixel_head.subpixel_head_fwd.launches
        y_kernel, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        with mock.patch.object(subpixel_head, "subpixel_head_fwd",
                               subpixel_head.subpixel_head_fwd_plain):
            y_plain, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        launched = subpixel_head.subpixel_head_fwd.launches - before
    if launched != 1:
        raise AssertionError(f"f32 check launched #6 {launched} times")
    diff = max_err(y_kernel, y_plain)
    print(f"facades serving: f32 (TF32 off) U-Net through #6 vs its plain "
          f"version on a batch of {n32}: max abs diff {diff:.3g} on the "
          f"tanh output (limit {SLICE_F32_TOL})")
    if not diff <= SLICE_F32_TOL:
        raise AssertionError(f"f32 facades diff {diff} > {SLICE_F32_TOL}")
    del eng32
    if profile:
        profile_forward(engine, reqs[:1])
    return counts, stats, latencies


def facades_train_phase(device, card, profile: bool):
    """The facades preset's training with the subpixel head: bf16 steps
    with dropout, their times, losses and launch counts (13 #5, one #6,
    one #7 per step), then the f32 kernels-vs-plain check."""
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda import subpixel_head
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments_plain
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    cfg = facades_config()
    h, w = cfg.image_hw
    m = cfg.model
    per_step = len(facades_bn_plan(m.ngf, h, w))
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    bs = cfg.data.batch_size
    host = synthetic_facades_batch(n_steps * bs, h, seed=SEED)
    batches = [{k: v[i * bs:(i + 1) * bs] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    step = build_train_step(cfg, None, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d))}
    print(f"facades train: {h}x{w}, batch {bs}, {dtype}, ngf {m.ngf}, ndf "
          f"{m.ndf}, dropout {m.use_dropout}, subpixel head on #6/#7, "
          f"parameters {sizes}; built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    counts, med = bf16_train_run(
        "facades train", state, step, batches, TRAIN_WARMUP,
        only(batch_moments=per_step * n_steps, subpixel_head_fwd=n_steps,
             subpixel_head_dx=n_steps), FACADES_LOSS_KEYS, card, profile)
    del state, step

    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    plain = (mock.patch.object(norm, "batch_moments", batch_moments_plain),
             mock.patch.object(subpixel_head, "subpixel_head_fwd",
                               subpixel_head.subpixel_head_fwd_plain),
             mock.patch.object(subpixel_head, "subpixel_head_dx",
                               subpixel_head.subpixel_head_dx_plain))
    runs = {}
    with tf32_off():
        for route in ("kernel", "plain"):
            st = create_train_state(cfg32, SEED)
            stp = build_train_step(cfg32)
            before = launch_counts()
            with contextlib.ExitStack() as stack:
                if route == "plain":
                    for patch in plain:
                        stack.enter_context(patch)
                runs[route] = [{k: float(v) for k, v in stp(st, b)[1].items()}
                               for b in batches[:TRAIN_F32_STEPS]]
            launched = {k: launch_counts()[k] - before[k] for k in before}
            n = TRAIN_F32_STEPS if route == "kernel" else 0
            if launched != only(batch_moments=per_step * n,
                                subpixel_head_fwd=n, subpixel_head_dx=n):
                raise AssertionError(f"f32 {route} run launched {launched}")
    worst = 0.0
    for i, (lk, lp) in enumerate(zip(runs["kernel"], runs["plain"])):
        rtol = FACADES_STEP1_RTOL if i == 0 else FACADES_LATER_RTOL
        for k in FACADES_LOSS_KEYS:
            rel = abs(lk[k] - lp[k]) / abs(lp[k])
            worst = max(worst, rel)
            if not rel <= rtol:
                raise AssertionError(f"f32 facades step {i + 1} {k}: kernel "
                                     f"{lk[k]} vs plain {lp[k]} (rtol {rtol})")
    print(f"facades train: f32 (TF32 off) {TRAIN_F32_STEPS} steps through "
          f"#5/#6/#7 vs their plain versions, same dropout seed: losses max "
          f"rel diff {worst:.3g} (step 1 limit {FACADES_STEP1_RTOL}, later "
          f"{FACADES_LATER_RTOL})")
    return counts, med


def backward_phase(device, a_plan, plan):
    """In f32 (TF32 off), at the largest shape of each instance-norm form
    on paths A (``a_plan``) and B (``plan``, N = 1): the gradients through
    the two autograd Functions (kernels forward, closed-form backward)
    against autograd through the plain versions of the kernels. Returns
    the largest error of dx (and dres) and of dscale/dbias."""
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_plain
    from p2p_tpu_torch.ops.instance_norm import (instance_norm_act,
                                                 instance_norm_fused)

    largest = {}
    for path, entries in (("A", a_plan), ("B", [
            (h, w, c, form_of(act, res)) for h, w, c, act, res in plan])):
        for h, w, c, form in entries:
            key = (path, form)
            if h * w * c > np.prod(largest.get(key, (0,))):
                largest[key] = (h, w, c)
    # the path has no affine; #2 is also checked with one, for dγ and dβ
    cases = sorted(largest.items()) + [
        (("A", "apply+affine"), largest[("A", "apply")])]
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"dx": 0.0, "dparam": 0.0}
    with tf32_off():
        for (path, form), (h, w, c) in cases:
            act, _, rest = form.partition("+")
            res, affine = rest == "residual", rest == "affine"
            x = make_input(gen, 1, c, h, w, torch.float32, device)
            r = make_input(gen, 1, c, h, w, torch.float32, device) if res \
                else None
            scale = bias = None
            if affine:
                scale = torch.randn(c, generator=gen, device=device) * 0.1 + 1
                bias = torch.randn(c, generator=gen, device=device) * 0.1
            up = torch.randn((1, c, h, w), generator=gen, device=device
                             ).contiguous(memory_format=torch.channels_last)
            leaves = [t.requires_grad_(True) for t in (x, r, scale, bias)
                      if t is not None]
            if act == "apply":
                y = instance_norm_fused(x, scale, bias)
            else:
                y = instance_norm_act(x, scale, bias, r, act=act)
            got = torch.autograd.grad((y * up).sum(), leaves)
            mean, rstd = instance_norm_stats_plain(x)
            yp = norm_act_plain(x, mean, rstd, scale, bias, r,
                                "none" if act == "apply" else act)
            want = torch.autograd.grad((yp * up).sum(), leaves)
            names = ["dx"] + (["dres"] if res else []) + (
                ["dscale", "dbias"] if affine else [])
            with torch.no_grad():
                z = norm_act_plain(x, mean, rstd, scale, bias, r, "none")
            keep = (z.abs() > MASK_MARGIN if act in ("relu", "leaky")
                    else torch.ones_like(z, dtype=torch.bool))
            errs = {"left_out": int((~keep).sum())}
            for name, a, b in zip(names, got, want):
                if name in ("dx", "dres"):
                    a, b = a[keep], b[keep]
                errs[name] = max_err(a, b)
                if name in ("dx", "dres"):
                    assert_close(f"backward {path} {form} {h}x{w}x{c} {name}",
                                 a, b, *GRAD_TOL)
                    worst["dx"] = max(worst["dx"], errs[name])
                else:
                    lim = GRAD_SUM_RTOL_OF_MAX * float(b.abs().max())
                    if not errs[name] <= lim:
                        raise AssertionError(
                            f"backward {path} {form} {name}: {errs[name]:.3g}"
                            f" > {lim:.3g}")
                    worst["dparam"] = max(worst["dparam"], errs[name])
            print(f"backward: path {path} {form} at 1x{c}x{h}x{w}, f32: "
                  f"Functions vs autograd of the plain chain, max abs "
                  f"{json.dumps(errs)}", flush=True)
    print(f"backward: largest |dx|, |dres| error {worst['dx']:.3g} (limit "
          f"{GRAD_TOL[0]} + {GRAD_TOL[1]} relative), |dscale|, |dbias| "
          f"{worst['dparam']:.3g} (limit {GRAD_SUM_RTOL_OF_MAX} of the "
          f"largest)")
    return worst


def bf16_train_run(what, state, step, batches, warmup, want, loss_keys,
                   card, profile):
    """``len(batches)`` bf16 steps: each step's time (host clock to a
    synchronized device) and losses, which must be finite; the launch
    counts of the run, which must equal ``want``. Returns the counts and
    the median of the steps after ``warmup``."""
    reset_launch_counts()
    times = []
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses = {k: float(metrics[k]) for k in loss_keys}
        print(f"{what}: step {i + 1} {times[-1]:.2f} ms {json.dumps(losses)}")
        if not all(np.isfinite(v) for v in losses.values()) \
                or float(metrics["health_ok"]) != 1.0:
            raise AssertionError(f"step {i + 1}: non-finite losses {losses}")
    counts = launch_counts()
    print(f"{what}: launches over {len(batches)} steps: {counts} (want "
          f"{want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    timed = times[warmup:]
    med = statistics.median(timed)
    n_img = len(batches[0]["input"])
    print(f"{what}: {len(timed)} timed bf16 steps (after {warmup} warm-up): "
          f"median {med:.2f} ms/step, min {min(timed):.2f}, max "
          f"{max(timed):.2f}; {n_img * 1e3 / med:.3f} img/s; on {card}",
          flush=True)
    if profile:
        profile_call(f"{what} step", lambda: step(state, batches[0]))
    return counts, med


def instance_plain_patches(stats=None):
    """Patches that route every kernel of the instance-norm paths (#1, #2,
    #3, #4 and the BatchNorms' #5) to its plain version (#1 to ``stats``
    when given)."""
    import p2p_tpu_torch.ops.instance_norm as seam
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments_plain
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_apply_plain, instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import (norm_act_plain,
                                                 norm_act_quant_plain)

    return (mock.patch.object(seam, "instance_norm_stats",
                              stats or instance_norm_stats_plain),
            mock.patch.object(seam, "instance_norm_apply",
                              as_wrapper(instance_norm_apply_plain)),
            mock.patch.object(seam, "norm_act", as_wrapper(norm_act_plain)),
            mock.patch.object(seam, "norm_act_quant",
                              as_wrapper(norm_act_quant_plain)),
            mock.patch.object(norm, "batch_moments", batch_moments_plain))


def as_wrapper(plain):
    """``plain`` called as #2's, #3's and #4's wrappers are: ``x_ready``
    (when the kernel may read x before its wait) means nothing to it."""
    return lambda *args, x_ready=False, **kwargs: plain(*args, **kwargs)


def f32_route(cfg, batches, vgg, patches, want, route, seed=SEED):
    """The losses of f32 (TF32 off) steps on ``batches`` from the state
    made from ``seed``, under ``patches``; the run must launch ``want``.
    Under ``int8_delayed`` the stored scales are initialized from the first
    batch, before the patches apply."""
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    with tf32_off():
        st = create_train_state(cfg32, seed, sample_batch=batches[0])
        stp = build_train_step(cfg32, vgg)
        before = launch_counts()
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            losses = [{k: float(v) for k, v in stp(st, b)[1].items()}
                      for b in batches]
        launched = {k: launch_counts()[k] - before[k] for k in before}
    if launched != want:
        raise AssertionError(f"f32 {route} run launched {launched}")
    del st, stp
    torch.cuda.empty_cache()
    return losses


def f32_check(what, cfg, batches, vgg, per_step, loss_keys,
              bands=(INSTANCE_STEP1_RTOL, INSTANCE_LATER_RTOL)):
    """f32 (TF32 off) steps from one state through the kernels and through
    their plain versions: the launches of each route (``per_step`` per
    step through the kernels, none through the plain versions) and the
    losses, within ``bands[0]`` before the first update and ``bands[1]``
    after it. Under ``int8_delayed`` the state's stored scales are
    initialized from the first batch (through the kernels on both
    routes)."""
    runs = {}
    for route in ("kernel", "plain"):
        patches = instance_plain_patches() if route == "plain" else ()
        n = len(batches) if route == "kernel" else 0
        runs[route] = f32_route(cfg, batches, vgg, patches, only(
            **{k: v * n for k, v in per_step.items()}), route)
    worst = {"before": 0.0, "after": 0.0}
    failed = []
    for i, (lk, lp) in enumerate(zip(runs["kernel"], runs["plain"])):
        rels = {k: abs(lk[k] - lp[k]) / abs(lp[k]) for k in loss_keys}
        print(f"{what}: f32 step {i + 1} kernel vs plain, rel diff "
              f"{json.dumps(rels)}")
        for k, rel in rels.items():
            when = "before" if i == 0 and k not in AFTER_UPDATE_KEYS \
                else "after"
            rtol = bands[0] if when == "before" else bands[1]
            worst[when] = max(worst[when], rel)
            if not rel <= rtol:
                failed.append(f"step {i + 1} {k}: kernel {lk[k]} vs plain "
                              f"{lp[k]} (rtol {rtol})")
    print(f"{what}: f32 (TF32 off) {len(batches)} steps through the kernels "
          f"vs their plain versions from one state: losses max rel diff "
          f"{worst['before']:.3g} before the first update (limit "
          f"{bands[0]}), {worst['after']:.3g} after (limit {bands[1]})",
          flush=True)
    if failed:
        raise AssertionError(f"f32 {what}: " + "; ".join(failed))
    return worst


def instance_a_phase(device, card, profile, per_step):
    """Path A: the instance-norm ``reference`` preset trained in bf16, then
    the f32 kernels-vs-plain check."""
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_batch
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = instance_config()
    h, w = cfg.image_hw
    m = cfg.model
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    host = synthetic_batch(n_steps, h, m.quant_bits, seed=SEED, width=w)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    vgg = load_vgg19(device=device)
    step = build_train_step(cfg, vgg, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d), ("C", state.net_c))}
    what = "path A train"
    print(f"{what}: reference preset with norm={m.norm}, norm_d={m.norm_d}, "
          f"{h}x{w}, batch 1, {dtype}, ngf {m.ngf}, ndf {m.ndf}, "
          f"{m.n_blocks} blocks, parameters {sizes}; built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    counts, med = bf16_train_run(
        what, state, step, batches, TRAIN_WARMUP,
        only(**{k: v * n_steps for k, v in per_step.items()}), LOSS_KEYS,
        card, profile)
    del state, step
    f32_check(what, cfg, batches[:TRAIN_F32_STEPS], vgg, per_step,
              LOSS_KEYS)
    return counts, med


def instance_b_phase(device, card, profile, per_step):
    """Path B: the ``pix2pixhd`` preset trained at 1024x512 in bf16 with
    its peak device memory, then the f32 kernels-vs-plain check."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    m = cfg.model
    n_steps = HD_TRAIN_WARMUP + HD_TRAIN_STEPS
    host = synthetic_hd_batch(n_steps, h, w, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    vgg = load_vgg19(device=device)
    step = build_train_step(cfg, vgg, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d))}
    what = "path B train"
    print(f"{what}: pix2pixhd preset, {h}x{w}, batch 1, {dtype}, ngf "
          f"{m.ngf}, {m.n_blocks} global + 3 local blocks, ndf {m.ndf}, "
          f"{m.num_D} D scales on concatenated pairs, norm_d "
          f"{m.norm_d}, parameters {sizes}; built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    counts, med = bf16_train_run(
        what, state, step, batches, HD_TRAIN_WARMUP,
        only(**{k: v * n_steps for k, v in per_step.items()}), HD_LOSS_KEYS,
        card, profile)
    peak = torch.cuda.max_memory_allocated(device)
    print(f"{what}: peak device memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated over build and steps)",
          flush=True)
    del state, step
    f32_check(what, cfg, batches[:TRAIN_F32_STEPS], vgg, per_step,
              HD_LOSS_KEYS)
    return counts, med, peak


def _amax(net):
    return {k: v.detach().clone() for k, v in net.named_buffers()
            if k.endswith("amax_x")}


def _floats(tensors):
    return {k: float(v) for k, v in tensors.items()}


def int8_f32_routes(cfg, batches, seed=SEED, deterministic=True):
    """f32 (TF32 off) steps of the fused int8 path from the state made from
    ``seed`` on four routes: every kernel; #1 on its plain version; #1 and
    #5 on theirs; every plain version. With ``deterministic`` cuDNN runs
    deterministic algorithms (otherwise a conv may sum in another order
    each run, and a last-bit change anywhere before a quantizer can move
    q). Returns ``{route: losses per step}`` and
    ``{route: per #4 call of step 1, the elements of q that differ from
    the plain route's}``."""
    import p2p_tpu_torch.ops.instance_norm as seam
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments_plain
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import (norm_act_quant,
                                                 norm_act_quant_plain)

    def stats1():
        return mock.patch.object(seam, "instance_norm_stats",
                                 instance_norm_stats_plain)

    def stats5():
        return mock.patch.object(norm, "batch_moments", batch_moments_plain)

    n = len(batches)
    fused = {k: INT8_PER_STEP[k] * n for k in ("norm_act_quant", "norm_act")}
    # route: (patches, the #4 route recorded, launches)
    routes = {
        "kernel": ((), norm_act_quant, only(
            **{k: v * n for k, v in INT8_PER_STEP.items()})),
        "#1 plain": ((stats1(),), norm_act_quant, only(
            batch_moments=INT8_PER_STEP["batch_moments"] * n, **fused)),
        "#1 #5 plain": ((stats1(), stats5()), norm_act_quant, only(**fused)),
        "plain": (instance_plain_patches(), as_wrapper(norm_act_quant_plain),
                  only()),
    }
    runs, qs = {}, {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        for route, (patches, quant, want) in routes.items():
            seen = qs[route] = []

            def record(*args, quant=quant, seen=seen, **kwargs):
                q, amax = quant(*args, **kwargs)
                seen.append(q.detach().clone())
                return q, amax

            runs[route] = f32_route(
                cfg, batches, None, (*patches, mock.patch.object(
                    seam, "norm_act_quant", record)), want, route, seed)
    finally:
        torch.backends.cudnn.deterministic = saved
    step1 = INT8_PER_STEP["norm_act_quant"]
    flips = {route: [int((a != b).sum()) for a, b in zip(
        q[:step1], qs["plain"][:step1])] for route, q in qs.items()}
    return runs, flips


def int8_f32_check(what, cfg, batches):
    """The fused int8 path's f32 kernels-vs-plain check (the routes of
    :func:`int8_f32_routes`): given the plain statistics of #1 and #5, the
    kernels' q equals the plain q and every step's losses agree within
    INT8_SAME_STATS_RTOL; through every kernel the losses are within
    INT8_STEP1_RTOL before the first update and INT8_LATER_RTOL after."""
    runs, flips = int8_f32_routes(cfg, batches)
    print(f"{what}: f32 q elements that differ from the plain route's, per "
          f"#4 call of step 1: {json.dumps(flips)}")
    failed = []
    worst = collections.defaultdict(float)
    for route in ("kernel", "#1 plain", "#1 #5 plain"):
        for i, (lk, lp) in enumerate(zip(runs[route], runs["plain"])):
            rels = {k: abs(lk[k] - lp[k]) / abs(lp[k])
                    for k in FACADES_LOSS_KEYS}
            print(f"{what}: f32 step {i + 1} {route} vs plain, rel diff "
                  f"{json.dumps(rels)}")
            worst[route, i == 0] = max(worst[route, i == 0], *rels.values())
    limits = {("kernel", True): INT8_STEP1_RTOL,
              ("kernel", False): INT8_LATER_RTOL,
              ("#1 #5 plain", True): INT8_SAME_STATS_RTOL,
              ("#1 #5 plain", False): INT8_SAME_STATS_RTOL}
    for (route, first), limit in limits.items():
        if not worst[route, first] <= limit:
            failed.append(f"{route} {'step 1' if first else 'after'}: "
                          f"{worst[route, first]} (rtol {limit})")
    if any(flips["#1 #5 plain"]):
        failed.append(f"q differs given the same statistics: {flips}")
    print(f"{what}: f32 (TF32 off) {len(batches)} steps from one state, "
          f"losses max rel diff against the plain versions: through every "
          f"kernel {worst['kernel', True]:.3g} at step 1 (limit "
          f"{INT8_STEP1_RTOL}), {worst['kernel', False]:.3g} after (limit "
          f"{INT8_LATER_RTOL}); with #1 and #5 plain "
          f"{worst['#1 #5 plain', True]:.3g} at step 1 and "
          f"{worst['#1 #5 plain', False]:.3g} after (limit "
          f"{INT8_SAME_STATS_RTOL}), q equal; with #1 plain "
          f"{worst['#1 plain', True]:.3g} at step 1", flush=True)
    if failed:
        raise AssertionError(f"f32 {what}: " + "; ".join(failed))


def int8_train_phase(device, card, profile):
    """Slice 5: the fused facades_int8 path trained in bf16 with its peak
    device memory and stored scales, the f32 kernels-vs-plain check, then
    two bf16 steps of the preset as it is."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    cfg = int8_config()
    h, w = cfg.image_hw
    m = cfg.model
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    host = synthetic_facades_batch(n_steps, h, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype,
                               sample_batch=batches[0])
    step = build_train_step(cfg, None, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d))}
    amax0 = _amax(state.net_d)
    what = "facades int8 train"
    print(f"{what}: facades_int8 with norm_d={m.norm_d}, "
          f"int8_fused_epilogue={m.int8_fused_epilogue}, {h}x{w}, batch 1, "
          f"{dtype}, ngf {m.ngf}, ndf {m.ndf}, dropout {m.use_dropout}, Adam "
          f"moments {cfg.optim.moment_dtype}, parameters {sizes}; stored "
          f"amax at init {json.dumps(_floats(amax0))}; built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    counts, med = bf16_train_run(
        what, state, step, batches, TRAIN_WARMUP,
        only(**{k: v * n_steps for k, v in INT8_PER_STEP.items()}),
        FACADES_LOSS_KEYS, card, profile)
    peak = torch.cuda.max_memory_allocated(device)
    amax1 = _amax(state.net_d)
    print(f"{what}: peak device memory {peak / 2 ** 30:.2f} GiB; stored amax "
          f"after {n_steps} steps {json.dumps(_floats(amax1))}",
          flush=True)
    if len(amax1) != 3 or not all(bool(torch.isfinite(v)) and float(v) > 0
                                  for v in amax1.values()):
        raise AssertionError(f"stored amax not finite and positive: {amax1}")
    if any(torch.equal(amax0[k], v) for k, v in amax1.items()):
        raise AssertionError("a stored amax did not move in training")
    del state, step
    int8_f32_check(what, cfg, batches[:TRAIN_F32_STEPS])

    as_is = get_preset("facades_int8")
    state = create_train_state(as_is, SEED, train_dtype=dtype,
                               sample_batch=batches[0])
    step = build_train_step(as_is, None, dtype)
    a0 = _amax(state.net_d)
    print(f"facades_int8 as it is: norm_d={as_is.model.norm_d}, "
          f"int8_fused_epilogue={as_is.model.int8_fused_epilogue}",
          flush=True)
    as_is_counts, _ = bf16_train_run(
        "facades_int8 as it is", state, step, batches[:INT8_AS_IS_STEPS], 1,
        only(batch_moments=INT8_PER_STEP["batch_moments"]
             * INT8_AS_IS_STEPS), FACADES_LOSS_KEYS, card, False)
    a1 = _amax(state.net_d)
    if len(a1) != 3 or any(torch.equal(a0[k], v) or not bool(
            torch.isfinite(v)) for k, v in a1.items()):
        raise AssertionError(f"facades_int8 stored amax {a0} -> {a1}")
    del state, step
    return counts, as_is_counts, med, peak


def ssim_f64(target: np.ndarray, pred: np.ndarray, win: int = 7
             ) -> np.ndarray:
    """Per-image SSIM of NHWC uint8-space float64 images, the formula of
    ``losses/metrics.ssim`` with its window means as float64 box sums."""
    t, p = target.astype(np.float64), pred.astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2

    def window(x):
        c = np.cumsum(np.cumsum(x, axis=1), axis=2)
        c = np.pad(c, ((0, 0), (1, 0), (1, 0), (0, 0)))
        return (c[:, win:, win:] - c[:, :-win, win:] - c[:, win:, :-win]
                + c[:, :-win, :-win]) / (win * win)

    tc = t - t.mean(axis=(1, 2), keepdims=True)
    pc = p - p.mean(axis=(1, 2), keepdims=True)
    mu_tc, mu_pc = window(tc), window(pc)
    mu_t = mu_tc + (t - tc)[:, :1, :1]
    mu_p = mu_pc + (p - pc)[:, :1, :1]
    norm = win * win / (win * win - 1.0)
    var_t = norm * (window(tc * tc) - mu_tc ** 2)
    var_p = norm * (window(pc * pc) - mu_pc ** 2)
    cov = norm * (window(tc * pc) - mu_tc * mu_pc)
    smap = ((2 * mu_t * mu_p + c1) * (2 * cov + c2)
            / ((mu_t ** 2 + mu_p ** 2 + c1) * (var_t + var_p + c2)))
    return smap.mean(axis=(1, 2, 3))


def ssim_check(device, data_dir: str) -> None:
    """SSIM on the card: exactly 1 for an image against itself, and
    within SSIM_F64_TOL of :func:`ssim_f64` for the test split's pairs."""
    from p2p_tpu_torch.data.pipeline import PairedImageDataset
    from p2p_tpu_torch.losses.metrics import ssim, to_uint8_space
    from p2p_tpu_torch.utils.images import ingest

    ds = PairedImageDataset(data_dir, "test", dtype="uint8")
    items = [ds[i] for i in range(len(ds))]
    a, b = (ingest(torch.as_tensor(np.stack([it[k] for it in items]))
                   .to(device)) for k in ("input", "target"))
    same = ssim(b, b, per_image=True)
    if not bool((same == 1.0).all()):
        raise AssertionError(f"SSIM(x, x) on the card: {same.tolist()}")
    got = ssim(b, a, per_image=True).cpu().numpy()
    want = ssim_f64(to_uint8_space(b).cpu().numpy(),
                    to_uint8_space(a).cpu().numpy())
    err = float(np.abs(got - want).max())
    print(f"loop: SSIM on the card: SSIM(x, x) = 1 exactly on {len(ds)} "
          f"images; SSIM of the test pairs {got.tolist()} vs float64 "
          f"{want.tolist()}: max abs diff {err:.3g} (limit {SSIM_F64_TOL})")
    if not err <= SSIM_F64_TOL:
        raise AssertionError(f"SSIM differs from float64 by {err}")


def read_records(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def loop_phase(device, card, step_median: float, step_host: float,
               tmp: str):
    """The reference loop through its CLIs (phase 10): generate, train 2
    epochs, infer, in ``tmp`` (the caller keeps its checkpoints for phase
    11). Returns the launch counts of the training run."""
    from p2p_tpu_torch.cli import generate_dataset, infer, train
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments
    from p2p_tpu_torch.train.checkpoint import CheckpointManager
    from p2p_tpu_torch.train.loop import Trainer
    from p2p_tpu_torch.utils.images import decode_png

    cfg = get_preset("reference")
    h, w = cfg.image_hw
    m = cfg.model
    per_step = len(batchnorm_plan(m.ngf, m.n_blocks, h, w))
    n_train, n_test = LOOP_SOURCES
    src, data, work, out = (os.path.join(tmp, d)
                            for d in ("src", "data", "work", "pred"))
    t0 = time.perf_counter()
    make_synthetic_dataset(src, n_train, n_test, size=2 * h, seed=SEED)
    for split in ("train", "test"):
        rc = generate_dataset.main([
            "--dataset_path", os.path.join(src, split, "a"),
            "--target_dataset_folder", data, "--split", split,
            "--crop_size", str(h), "--max_patches", "1"])
        if rc:
            raise AssertionError(f"generate_dataset {split}: exit {rc}")
    names = sorted(os.listdir(os.path.join(data, "test", "a")))
    if (len(os.listdir(os.path.join(data, "train", "a"))),
            len(names)) != LOOP_SOURCES:
        raise AssertionError("the generated splits are not 4 and 2")
    print(f"loop: generated {n_train} train and {n_test} test pairs of "
          f"{h}x{w} from {sum(LOOP_SOURCES)} sources of {2 * h}x{2 * w} "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    ssim_check(device, data)

    wall = collections.defaultdict(list)
    eval_launches = []
    train_epoch, evaluate = Trainer.train_epoch, Trainer.evaluate
    save = CheckpointManager.save

    def timed_save(self, *a, **kw):
        t = time.perf_counter()
        res = save(self, *a, **kw)
        wall["save"].append(time.perf_counter() - t)
        return res

    def timed_train_epoch(self, *a, **kw):
        wall["host"].append(host_yardstick_ms())
        with timed_step_calls(self) as calls:
            t = time.perf_counter()
            res = train_epoch(self, *a, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        wall["train"].append(t1 - t)
        wall["calls"].append(calls)
        wall["split"].append(loop_split(calls, t, t1))
        return res

    def timed_evaluate(self, *a, **kw):
        before = batch_moments.launches
        t = time.perf_counter()
        res = evaluate(self, *a, **kw)
        torch.cuda.synchronize()
        wall["eval"].append(time.perf_counter() - t)
        eval_launches.append(batch_moments.launches - before)
        return res

    common = ["--preset", "reference", "--data_root", data,
              "--workdir", work]
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(Trainer, "train_epoch", timed_train_epoch), \
            mock.patch.object(Trainer, "evaluate", timed_evaluate), \
            mock.patch.object(CheckpointManager, "save", timed_save):
        rc = train.main(common + ["--nepoch", str(LOOP_EPOCHS),
                                  "--epochsave", "1"])
    train_wall = time.perf_counter() - t0
    counts = launch_counts()
    if rc:
        raise AssertionError(f"cli.train: exit {rc}")
    want = only(batch_moments=per_step * LOOP_STEPS)
    print(f"loop: cli.train {LOOP_EPOCHS} epochs x {n_train} steps in "
          f"{train_wall:.2f}s; launches {counts} (want {want}); #5 "
          f"launches in each eval: {eval_launches}", flush=True)
    if counts != want or eval_launches != [0] * LOOP_EPOCHS:
        raise AssertionError("loop launch counts")

    records = read_records(os.path.join(work, "metrics_reference.jsonl"))
    epochs = [r for r in records if r["kind"] == "epoch"]
    evals = [r for r in records if r["kind"] == "eval"]
    if [r["epoch"] for r in epochs] != [1.0, 2.0] or \
            [r["epoch"] for r in evals] != [1.0, 2.0]:
        raise AssertionError(f"records: {records}")
    for r in epochs + evals:
        if not all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)):
            raise AssertionError(f"non-finite record {r}")
    for r in epochs:
        print("loop: epoch record " + json.dumps(
            {k: v for k, v in r.items() if k != "ts"}))
    ckpt = CheckpointManager(os.path.join(
        work, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name))
    steps = ckpt.all_steps()
    bad = {s: ckpt.verify(s) for s in steps}
    print(f"loop: checkpoints at steps {steps}, manifest problems {bad}")
    if steps != [n_train, LOOP_STEPS] or any(bad.values()):
        raise AssertionError("loop checkpoints")

    before = launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = infer.main(common + ["--metrics", "--stats", "--out", out])
    text = buf.getvalue()
    print("\n".join("loop: infer: " + line
                    for line in text.splitlines()))
    if rc or launch_counts() != before:
        raise AssertionError(f"cli.infer: exit {rc}, launches "
                             f"{launch_counts()} after {before}")
    line = next(x for x in text.splitlines()
                if x.startswith("psnr_mean="))
    got = {k: float(v) for k, v in
           (kv.split("=") for kv in line.split())}
    stats = json.loads(next(x for x in text.splitlines()
                            if x.startswith('{"kind": "serve_stats"')))
    last = evals[-1]
    diffs = {k: abs(got[k] - last[k]) for k in got}
    print(f"loop: infer vs the last eval record: {diffs} (bands "
          f"{LOOP_PSNR_BAND} dB, {LOOP_SSIM_BAND})")
    for k, d in diffs.items():
        if not d <= (LOOP_PSNR_BAND if k.startswith("psnr")
                     else LOOP_SSIM_BAND):
            raise AssertionError(f"infer {k} {got[k]} vs eval {last[k]}")
    for name in names:
        with open(os.path.join(out, name), "rb") as f:
            img = decode_png(f.read())
        if img.shape != (h, w, 3):
            raise AssertionError(f"{name}: {img.shape}")
    def ms(values, scale):
        return ", ".join(f"{scale * v:.2f}" for v in values)

    print(f"loop: ms/step by host clock over each epoch's training "
          f"(device synchronized at the end): "
          f"{ms(wall['train'], 1e3 / n_train)}; from the records' img/s "
          f"(steps 2-{n_train}): "
          f"{ms([1 / r['img_per_sec'] for r in epochs], 1e3)}; the step "
          f"alone (phase 4) median {step_median:.2f} ms; eval "
          f"{ms(wall['eval'], 1e3 / n_test)} ms per image (samples "
          f"written); checkpoint saves {ms(wall['save'], 1)} s; infer "
          f"{stats['img_per_sec']:.3f} img/s end to end, "
          f"{stats['device_img_per_sec']:.3f} to the last device result "
          f"({stats['n_images']} images); on {card}", flush=True)
    for e, calls in enumerate(wall["calls"]):
        inside, between, ends = wall["split"][e]
        took = [1e3 * (b - a) for a, b in calls]
        print(f"loop: epoch {e + 1}: train_step calls {ms(took, 1)} ms "
              f"(mean {inside:.2f}); {between:.2f} ms between calls; "
              f"{ends:.2f} ms at the epoch's ends; calls 2-{len(took)} over "
              f"phase 4's median {statistics.mean(took[1:]) / step_median:.3f}"
              f"x; host yardstick {wall['host'][e]:.2f} ms (phase 4 "
              f"{step_host:.2f}, {wall['host'][e] / step_host:.3f}x)",
              flush=True)
    return counts, [round(1e3 * t / n_train, 2) for t in wall["train"]]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside (ROADMAP Queue C: a card
    check that compares two runs must set it)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def band_of(spread: float) -> float:
    """ROADMAP Queue C's rule: RES_BAND_FACTOR x ``spread`` rounded up to
    1, 2 or 5 x 10^-n; 0 (bitwise) when the spread is 0."""
    if spread == 0:
        return 0.0
    x = RES_BAND_FACTOR * spread
    e = math.floor(math.log10(x))
    return next(m * 10.0 ** e for m in (1, 2, 5, 10) if m * 10.0 ** e >= x)


def manifest_tensors(step_dir: str):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return {k: v["tensors"] for k, v in json.load(f)["files"].items()}


def live_is_saved(tr, step: int) -> bool:
    """Every tensor of the trainer's live state has the CRC32, shape and
    dtype the step's manifest recorded when it was saved."""
    from p2p_tpu_torch.train.checkpoint import NETS, OPTS, tensor_checksums

    man = manifest_tensors(tr.ckpt.step_dir(step))
    for name in NETS:
        net = getattr(tr.state, name, None)
        if net is not None and tensor_checksums(net.state_dict()) != \
                man[f"{name}.pt"]:
            return False
    for name in OPTS:
        opt = getattr(tr.state, name, None)
        if opt is not None and tensor_checksums(
                {"optimizer": opt[0].state_dict(),
                 "scheduler": opt[1].state_dict()}) != man[f"{name}.pt"]:
            return False
    return True


@contextlib.contextmanager
def watched_trainer(video: bool = False):
    """For the duration, ``cli.train``'s trainers (the video trainer's
    with ``video``) report into the dict yielded: train steps run and the
    host-clock (start, end) of each step call, the train split's item
    indices in the order read, kernel launches in each eval, seconds and
    steps of each ``train_epoch`` (device synchronized at its end), the
    build watchdog's counts when ``fit`` removes its hooks and, after a
    resume, whether the live state is bitwise the restored step's as
    saved."""
    from p2p_tpu_torch.data import pipeline, video as clips
    from p2p_tpu_torch.train import loop, video_loop

    seen = {"steps": 0, "calls": [], "reads": [], "eval_launches": [],
            "epochs": [], "builds": [], "restored": []}
    tr_cls = loop.Trainer
    build_mod, build_name, ds_cls = (
        (video_loop, "build_video_train_step", clips.VideoClipDataset)
        if video else (loop, "build_train_step", pipeline.PairedImageDataset))
    build_step, evaluate = getattr(build_mod, build_name), tr_cls.evaluate
    train_epoch, close = tr_cls.train_epoch, loop.close_trainer_obs
    resume, getitem = tr_cls.maybe_resume, ds_cls.__getitem__

    def counting_build(*a, **kw):
        step = build_step(*a, **kw)

        def counted(state, batch):
            seen["steps"] += 1
            t = time.perf_counter()
            res = step(state, batch)
            seen["calls"].append((t, time.perf_counter()))
            return res

        return counted

    def watched_evaluate(self, *a, **kw):
        before = sum(launch_counts().values())
        res = evaluate(self, *a, **kw)
        seen["eval_launches"].append(sum(launch_counts().values()) - before)
        return res

    def watched_epoch(self, *a, **kw):
        n0, t = seen["steps"], time.perf_counter()
        res = train_epoch(self, *a, **kw)
        torch.cuda.synchronize()
        seen["epochs"].append((time.perf_counter() - t, seen["steps"] - n0))
        return res

    def watched_close(tr):
        w = tr.retrace
        seen["builds"].append((w.compiles, w.cache_hits, w.unexpected,
                               w.armed))
        close(tr)

    def watched_resume(self):
        ok = resume(self)
        if ok:
            step = self.ckpt.last_restored_step
            seen["restored"].append((step, live_is_saved(self, step)))
        return ok

    def reading(self, idx):
        if os.path.basename(os.path.dirname(self.a_dir)) == "train":
            seen["reads"].append(int(idx))
        return getitem(self, idx)

    with mock.patch.object(build_mod, build_name, counting_build), \
            mock.patch.object(tr_cls, "evaluate", watched_evaluate), \
            mock.patch.object(tr_cls, "train_epoch", watched_epoch), \
            mock.patch.object(loop, "close_trainer_obs", watched_close), \
            mock.patch.object(tr_cls, "maybe_resume", watched_resume), \
            mock.patch.object(ds_cls, "__getitem__", reading):
        yield seen


def res_train(what: str, args, want_rc: int, per_step: int,
              chaos: str = None, within=None, video: bool = False,
              label: str = None):
    """One in-process ``cli.train`` run (its output kept, not printed),
    inside the context ``within`` if given: the exit code as wanted,
    exactly ``per_step`` #5 launches a train step run and no other kernel
    launch (none in eval), no unexpected kernel build after the first
    epoch. ``video`` watches the video trainer (slice 11); ``label`` heads
    the printed line. Returns what ``watched_trainer`` saw and the
    output."""
    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos

    reset_launch_counts()
    buf = io.StringIO()
    install_chaos(ChaosMonkey.from_spec(chaos) if chaos else None)
    try:
        with watched_trainer(video) as seen, \
                contextlib.redirect_stdout(buf), \
                (within or contextlib.nullcontext()):
            rc = train.main(args)
    finally:
        install_chaos(None)
    out = buf.getvalue()
    counts = launch_counts()
    want = only(batch_moments=per_step * seen["steps"])
    label = label or f"slice {11 if video else 10}"
    print(f"{label}: {what}: exit {rc} (want "
          f"{want_rc}), {seen['steps']} train steps, #5 launches "
          f"{counts['batch_moments']} (want {want['batch_moments']}), "
          f"kernel launches in each eval {seen['eval_launches']}; builds "
          f"(compiles, cache hits, unexpected, armed) {seen['builds']}",
          flush=True)
    if rc != want_rc:
        raise AssertionError(f"{what}: exit {rc}:\n{out[-4000:]}")
    if counts != want or any(seen["eval_launches"]):
        raise AssertionError(f"{what}: launches {counts}, want {want}")
    if any(unexpected for _, _, unexpected, _ in seen["builds"]):
        raise AssertionError(f"{what}: unexpected kernel builds")
    seen["out"] = out
    return seen


def prom_samples(path: str):
    """``{sample: value}`` of a Prometheus textfile."""
    samples = {}
    with open(path) as f:
        for line in f.read().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
    return samples


def run_records(work: str):
    return read_records(os.path.join(work, "metrics_reference.jsonl"))


def step_losses(records):
    """``{step: {loss: value}}`` of the ``train`` records."""
    return {int(r["step"]): {k: r[k] for k in LOSS_KEYS if k in r}
            for r in records if r["kind"] == "train"}


def loss_spread(a, b, steps) -> float:
    return max(abs(a[s][k] - b[s][k]) / max(abs(a[s][k]), 1e-12)
               for s in steps for k in a[s])


RES_NETS = ("net_g", "net_d", "net_c")
# the buffers of the networks' state (the BatchNorms' running statistics,
# spectral norm's power-iteration vector), which move whatever the
# learning rate: the update a resume is held to is the parameters'
RES_BUFFERS = ("mean", "var", "u")


def net_tensors(ckpt: str, step: int):
    """``{network: {name: tensor}}`` of the parameters of a checkpoint's
    step (its buffers left out)."""
    from p2p_tpu_torch.train.checkpoint import CheckpointManager, tensor_paths

    got = CheckpointManager(ckpt).read(step, list(RES_NETS))
    return {n: {k: t for k, t in tensor_paths(got[n])
                if k.rsplit(".", 1)[-1] not in RES_BUFFERS}
            for n in RES_NETS}


def update_spread(base, a, b):
    """How far apart two runs that continued from one checkpoint end,
    against how far they moved: for each network, ||b - a|| / ||a - base||
    over all its float tensors as one vector (inf where an integer tensor
    of ``a`` and ``b`` differs), each argument a ``net_tensors``. Returns
    ``{network: distance}``."""
    rel = {}
    for name, ta in a.items():
        tb, t0 = b[name], base[name]
        if ta.keys() != tb.keys():
            raise AssertionError(f"{name}: the checkpoints hold different "
                                 "tensors")
        diff = moved = 0.0
        for k, x in ta.items():
            if not x.is_floating_point():
                if not torch.equal(x, tb[k]):
                    diff = math.inf
                continue
            x = x.double()
            diff += float(((tb[k].double() - x) ** 2).sum())
            moved += float(((x - t0[k].double()) ** 2).sum())
        rel[name] = math.sqrt(diff) / max(math.sqrt(moved), 1e-30)
    return rel


@contextlib.contextmanager
def saving_at(step: int, copies):
    """For the duration, the trainer saves its checkpoint and sidecar at
    host step ``step`` and trains on (a preemption's save without the
    stop), and copies its checkpoint directory and sidecars as they then
    are to each directory of ``copies``."""
    from p2p_tpu_torch.train import loop

    poll = loop.poll_preempt

    def polling(tr):
        if tr._host_step == step:
            loop.save_trainer_ckpt(tr)
            for d in copies:
                for suffix in ("", ".aux"):
                    shutil.copytree(tr.ckpt.directory + suffix, d + suffix)
        return poll(tr)

    with mock.patch.object(loop, "poll_preempt", polling):
        yield


@contextlib.contextmanager
def resuming_at_lr(factor: float):
    """For the duration, a resume restores the learning-rate scale times
    ``factor`` (a planted fault: a cooldown carried across the resume)."""
    from p2p_tpu_torch.train import loop

    resume = loop.Trainer.maybe_resume

    def planted(tr):
        ok = resume(tr)
        tr._base_lr_scale *= factor
        tr.state.lr_scale = tr._applied_lr_scale = tr._base_lr_scale
        return ok

    with mock.patch.object(loop.Trainer, "maybe_resume", planted):
        yield


def resilience_phase(device, card, tmp: str, loop_ms):
    """Slice 10 on phase 10's reference data (4 + 2 pairs of 256²,
    full width, bf16 on f32 masters), every run through ``cli.train``.
    Returns ``{"batch_moments": n}``, the #5 launches of its train
    steps."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.train.checkpoint import CheckpointManager

    cfg = get_preset("reference")
    m = cfg.model
    per_step = len(batchnorm_plan(m.ngf, m.n_blocks, *cfg.image_hw))
    data = os.path.join(tmp, "data")
    base = os.path.join(tmp, "slice10")

    def args(name, *extra):
        return ["--preset", "reference", "--data_root", data, "--workdir",
                os.path.join(base, name), "--nepoch", "2", "--epochsave",
                "1", "--log_every", "1", *extra]

    def ckpt_dir(name):
        return os.path.join(base, name, cfg.train.checkpoint_dir,
                            cfg.data.dataset, cfg.name)

    t_phase = time.perf_counter()
    steps = 0
    # ---- (a) exact resume, cuDNN deterministic. The uninterrupted run
    # saves at step 6 as a preemption would and trains on; four runs
    # resume copies of that step-6 checkpoint: r1, r2 and r3 (their
    # largest pairwise spread sets the bands, the uninterrupted run is
    # held against r1) and rf, with a planted fault the bands must catch.
    # The run preempted at step 6 and its resume hold the position.
    resumes = {n: ckpt_dir(n) for n in ("r1", "r2", "r3", "rf")}
    with cudnn_deterministic():
        u = res_train("uninterrupted run (saved at step 6 as a preemption "
                      "saves, trained on)", args(
                          "u", "--prom_textfile",
                          os.path.join(base, "u", "p2p.prom")),
                      0, per_step,
                      within=saving_at(RES_STOP, list(resumes.values())))
        pre = res_train("preempted run (P2P_CHAOS=" + RES_PREEMPT + ")",
                        args("p"), 75, per_step, chaos=RES_PREEMPT)
        res = res_train("the resumed run", args("p"), 0, per_step)
        rs = {n: res_train(f"resume {n} of the uninterrupted run's step "
                           f"{RES_STOP}" + (
                               f" (planted: lr scale x {RES_PLANTED_LR})"
                               if n == "rf" else ""),
                           args(n), 0, per_step,
                           within=(resuming_at_lr(RES_PLANTED_LR)
                                   if n == "rf" else None))
              for n in resumes}
    steps += sum(r["steps"] for r in (u, pre, res, *rs.values()))
    rec_u = run_records(os.path.join(base, "u"))
    rec_p = run_records(os.path.join(base, "p"))
    tail_steps = tuple(range(RES_STOP + 1, LOOP_STEPS + 1))
    losses = {"u": step_losses(rec_u)}
    losses.update((n, step_losses(run_records(os.path.join(base, n))))
                  for n in resumes)
    if sorted(losses["u"]) != list(range(1, LOOP_STEPS + 1)) or any(
            sorted(losses[n]) != list(tail_steps) for n in resumes):
        raise AssertionError("the runs' train records")
    t0 = net_tensors(ckpt_dir("u"), RES_STOP)
    nets = {"u": net_tensors(ckpt_dir("u"), LOOP_STEPS)}
    nets.update((n, net_tensors(d, LOOP_STEPS)) for n, d in resumes.items())

    def apart(a, b):
        """The losses' largest relative difference over steps 7-8, and
        each network's final distance over its update."""
        return (loss_spread(losses[a], losses[b], tail_steps),
                update_spread(t0, nets[a], nets[b]))

    pairs = {f"{a}-{b}": apart(a, b)
             for a, b in (("r1", "r2"), ("r1", "r3"), ("r2", "r3"))}
    spread = (max(lo for lo, _ in pairs.values()),
              {k: max(d[k] for _, d in pairs.values()) for k in RES_NETS})
    band = (band_of(spread[0]), {k: band_of(v) for k, v in spread[1].items()})
    got, bad = apart("u", "r1"), apart("u", "rf")

    def within(d):
        return d[0] <= band[0] and all(d[1][k] <= band[1][k]
                                       for k in RES_NETS)

    def show(d):
        return (f"losses {d[0]:.3g}, "
                + ", ".join(f"{k} {v:.3g}" for k, v in d[1].items()))

    mgr = CheckpointManager(ckpt_dir("p"))
    aux = mgr.restore_aux(RES_STOP)
    preempts = [r for r in rec_p if r["kind"] == "preempt"]
    resumed = [r for r in rec_p if r["kind"] == "resume"]
    tail = u["reads"][RES_STOP:]
    print(f"slice 10 (a): from step {RES_STOP}, the resumes apart by "
          f"(losses of steps {tail_steps}, relative; each network's final "
          f"parameters over their update from step {RES_STOP}): "
          + "; ".join(f"{k} {show(d)}" for k, d in pairs.items())
          + f"; bands {show(band)} (0 = bitwise); the uninterrupted run "
          f"against r1 {show(got)}; against the planted fault rf "
          f"{show(bad)}; restored (step, bitwise as saved) "
          f"{[rs[n]['restored'] for n in resumes]}", flush=True)
    print(f"slice 10 (a): preempted at step {pre['steps']}, checkpoints "
          f"after the resume {mgr.all_steps()}, step {RES_STOP}'s sidecar "
          f"{aux}, preempt records "
          f"{[(r['step'], r['signum']) for r in preempts]}; the resume "
          f"record "
          f"{[(r['step'], r['epoch'], r['batches_done']) for r in resumed]}"
          f", restored {res['restored']}, read {res['reads']} against the "
          f"uninterrupted tail {tail}", flush=True)
    if pre["steps"] != RES_STOP or mgr.all_steps() != [4, RES_STOP,
                                                        LOOP_STEPS] \
            or aux is None \
            or aux["batches_done"] != 2 or aux["epoch"] != 2 \
            or [r["step"] for r in preempts] != [RES_STOP]:
        raise AssertionError("the preempted run")
    if pre["reads"][:RES_STOP] != u["reads"][:RES_STOP] \
            or res["reads"] != tail \
            or res["restored"] != [(RES_STOP, True)] or res["steps"] != 2 \
            or [(r["step"], r["epoch"], r["batches_done"])
                for r in resumed] != [(RES_STOP, 2, 2)]:
        raise AssertionError("the resumed run's position or restore")
    if any(r["restored"] != [(RES_STOP, True)] or r["reads"] != tail
           for r in rs.values()):
        raise AssertionError("the resumes of the uninterrupted run")
    if not within(got):
        raise AssertionError(f"resume outside its bands: {show(got)}")
    if within(bad):
        raise AssertionError("the bands pass a resume at the wrong "
                             "learning rate")

    # ---- a real SIGTERM after the first train record of a subprocess, a
    # fresh process whose build watchdog sees #5's library reused
    s_prom = os.path.join(base, "s", "p2p.prom")
    proc, lines = cli_subprocess(
        [sys.executable, "-m", "p2p_tpu_torch.cli.train", *args("s"),
         "--prom_textfile", s_prom],
        until="kind=train", timeout=600)
    proc.send_signal(signal.SIGTERM)
    rc, lines = finish(proc, lines, 300)
    smgr = CheckpointManager(ckpt_dir("s"))
    s_step = smgr.latest_step()
    s_aux = smgr.restore_aux(s_step) if s_step is not None else None
    s_builds = {k: prom_samples(s_prom).get(k) for k in (
        "xla_compiles", "persistent_cache_hits", "unexpected_recompiles")}
    print(f"slice 10 (a): SIGTERM subprocess: exit {rc}, checkpoint "
          f"{s_step}, sidecar {s_aux}, its build watchdog {s_builds}; last "
          f"line: {lines[-1]}", flush=True)
    if rc != 75 or s_aux is None or s_aux["step"] != s_step:
        raise AssertionError("the SIGTERM run:\n" + "\n".join(lines[-30:]))
    if s_builds != {"xla_compiles": None, "persistent_cache_hits": 1.0,
                    "unexpected_recompiles": None}:
        raise AssertionError("the SIGTERM run's build watchdog")
    relaunch = res_train("SIGTERM relaunch", args("s"), 0, per_step)
    steps += relaunch["steps"]
    if relaunch["steps"] != LOOP_STEPS - s_step:
        raise AssertionError("the SIGTERM relaunch's steps")

    # ---- (b) the recovery ladder
    ladder = res_train(
        f"ladder ({RES_LADDER_NAN}, --cooldown_steps {RES_COOLDOWN_STEPS}, "
        f"--max_rollbacks {RES_MAX_ROLLBACKS})",
        args("l", "--cooldown_steps", str(RES_COOLDOWN_STEPS),
             "--max_rollbacks", str(RES_MAX_ROLLBACKS)),
        0, per_step, chaos=RES_LADDER_NAN)
    giveup = res_train(
        f"give-up ({RES_GIVEUP_NAN}, --max_rollbacks {RES_MAX_ROLLBACKS})",
        args("g", "--max_rollbacks", str(RES_MAX_ROLLBACKS)),
        76, per_step, chaos=RES_GIVEUP_NAN)
    steps += ladder["steps"] + giveup["steps"]
    rec_l = run_records(os.path.join(base, "l"))
    rec_g = run_records(os.path.join(base, "g"))

    def actions(recs):
        return [r["action"] for r in recs
                if r["kind"] == "health" and "action" in r]

    epochs_l = [r for r in rec_l if r["kind"] == "epoch"]
    rollbacks = [(r["step"], r["target_step"]) for r in rec_l
                 if r["kind"] == "rollback"]
    summ_l = [r for r in rec_l if r["kind"] == "health_summary"]
    summ_g = [r for r in rec_g if r["kind"] == "health_summary"]
    print(f"slice 10 (b): ladder actions {actions(rec_l)}, rollbacks "
          f"(step, target) {rollbacks}, epoch lr "
          f"{[r['lr'] for r in epochs_l]}, summary {summ_l}; give-up "
          f"actions {actions(rec_g)}, summary {summ_g}, "
          f"'{[x for x in giveup['out'].splitlines() if x.startswith('diverged')]}'",
          flush=True)
    if actions(rec_l) != ["skip", "cooldown", "rollback"] \
            or rollbacks != [(8, 4)] or [r["epoch"] for r in epochs_l] \
            != [1, 2] or ladder["steps"] != 12 or len(summ_l) != 1 \
            or summ_l[0]["health_rollbacks_total"] != 1 \
            or not math.isclose(epochs_l[1]["lr"],
                                cfg.health.cooldown_factor
                                * epochs_l[0]["lr"], rel_tol=1e-6):
        raise AssertionError("the ladder run")
    if actions(rec_g) != ["skip", "cooldown", "rollback", "rollback",
                          "skip", "cooldown", "giveup"] \
            or len(summ_g) != 1 or "(exit 76)" not in giveup["out"]:
        raise AssertionError("the give-up run")

    # ---- (c) telemetry: the debug taps on a healthy epoch, the records,
    # the span trace, the Prometheus textfile, the manifest
    taps = res_train("--check_finite --nan_sentinel --grad_norms",
                     args("t", "--nepoch", "1", "--check_finite",
                          "--nan_sentinel", "--grad_norms"), 0, per_step)
    steps += taps["steps"]
    rec_t = run_records(os.path.join(base, "t"))
    norms = [r[k] for r in rec_t if r["kind"] == "train"
             for k in ("grad_norm_g", "grad_norm_d", "grad_norm_c")]
    bad_t = [r for r in rec_t if r["kind"] in ("sentinel", "nonfinite")]
    kinds = {r["kind"] for recs in (rec_u, rec_p, rec_l) for r in recs}
    memory = [r for r in rec_u if r["kind"] == "memory"]
    man = [r for r in rec_u if r["kind"] == "manifest"][0]
    with open(os.path.join(base, "u", "trace_reference.json")) as f:
        trace = json.load(f)
    spans = collections.Counter(e["name"] for e in trace["traceEvents"]
                                if e.get("ph") == "X")
    samples = prom_samples(os.path.join(base, "u", "p2p.prom"))
    print(f"slice 10 (c): record kinds {sorted(kinds)}; memory records "
          f"{[{k: r[k] for k in ('bytes_in_use', 'peak_bytes_in_use', 'bytes_limit', 'largest_alloc_size')} for r in memory]}"
          f"; manifest backend {man['backend']}; spans {dict(spans)}; "
          f"Prometheus textfile {len(samples)} samples, dispatch_secs_count "
          f"{samples.get('dispatch_secs_count')}; taps run: {len(norms)} "
          f"grad norms, all finite {all(map(math.isfinite, norms))}, "
          f"sentinel/nonfinite records {bad_t}", flush=True)
    want_kinds = {"manifest", "epoch", "eval", "memory", "preempt",
                  "resume", "rollback", "health_summary", "health", "train"}
    if not want_kinds <= kinds or len(memory) != 2 \
            or not all(r["bytes_in_use"] > 0 and r["peak_bytes_in_use"] > 0
                       for r in memory) \
            or man["backend"].get("platform") != "gpu" \
            or not {"epoch", "evaluate", "train_dispatch",
                    "checkpoint_save"} <= set(spans) \
            or samples.get("dispatch_secs_count") != LOOP_STEPS \
            or len(norms) != 3 * LOOP_SOURCES[0] \
            or not all(map(math.isfinite, norms)) or bad_t:
        raise AssertionError("slice 10 telemetry")
    # in process the libraries are loaded already, so these watchdogs see
    # no build and no reuse; the SIGTERM subprocess's saw its reuse
    if not all(armed for *_, armed in u["builds"] + ladder["builds"]):
        raise AssertionError("the build watchdog was not armed")

    # ---- (e) the loop's ms/step with health and obs on
    def ms(seen):
        return [1e3 * sec / n for sec, n in seen["epochs"] if n]

    print(f"slice 10 (e): loop ms/step by host clock over each epoch's "
          f"training (device synchronized at the end), a record a step: "
          f"the uninterrupted run {ms(u)} (its second epoch holds the step-"
          f"{RES_STOP} save), the SIGTERM relaunch {ms(relaunch)}, with the "
          f"debug taps {ms(taps)}; phase 10's "
          f"loop in this call, a record every {cfg.train.log_every} steps, "
          f"{loop_ms} (health and obs on in both); the phase "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}", flush=True)
    return {"batch_moments": per_step * steps}


def vid_kernel_config():
    """``vid2vid_temporal`` with its U-Net's and spatial D's instance norms
    on the kernels (#1 + #2 at the U-Net's 13 norms, #1 + #3 at D's 9
    inner epilogues, on all N·T frames); the temporal D has no norm."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("vid2vid_temporal")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, norm="pallas_instance", norm_d="pallas_instance"))


def vid_kernel_plan(cfg):
    """(H, W, C, form) of every instance norm of one video train step of
    ``cfg`` (:func:`vid_kernel_config`): the U-Net's once (one G forward),
    the spatial D's twice (fake, real)."""
    m = cfg.model
    h, w = cfg.image_hw
    return (unet_norm_plan(m.ngf, h, w)
            + 2 * d_norm_plan(m.ndf, m.n_layers_D, m.num_D, h, w))


def vid_per_step(plan):
    n_apply = sum(form == "apply" for *_, form in plan)
    return dict(instance_norm_stats=len(plan), instance_norm_apply=n_apply,
                norm_act=len(plan) - n_apply)


def stats_f64(x: torch.Tensor, eps: float = 1e-5):
    """#1's function with its sums in f64, each result rounded once."""
    xd = x.double()
    count = float(x.shape[2] * x.shape[3])
    mean = xd.sum(dim=(2, 3)) / count
    var = ((xd * xd).sum(dim=(2, 3)) / count - mean * mean).clamp_min(0.0)
    return mean.float(), torch.rsqrt(var + eps).float()


def vid_clips(tmp: str, cfg, n_clips: int, seed: int):
    """``n_clips`` uint8 batches of one clip each from the port's
    synthetic videos of ``seed`` (``cfg``'s frames and size)."""
    from p2p_tpu_torch.data.video import (VideoClipDataset,
                                          make_synthetic_video_dataset)

    t, (h, w) = cfg.data.n_frames, cfg.image_hw
    root = make_synthetic_video_dataset(
        os.path.join(tmp, f"clips{seed}"), n_videos=1, n_frames=n_clips * t,
        size=h, seed=seed, splits=("train",))
    ds = VideoClipDataset(root, "train", image_size=h, image_width=w,
                          n_frames=t, dtype="uint8")
    return [{k: v[None] for k, v in ds[i].items()} for i in range(n_clips)]


def vid_f32_routes(cfg, batch, seed, routes):
    """The losses of one f32 (TF32 off, cuDNN deterministic) video step of
    ``cfg`` on ``batch`` from the state of ``seed``, per route of the
    instance norms: ``"kernel"`` (#1, #2, #3), ``"plain"`` (their plain
    versions) or ``"f64"`` (the plain versions, #1's sums in f64,
    :func:`stats_f64`). Each run must launch exactly its kernels."""
    from p2p_tpu_torch.train.video_step import (build_video_train_step,
                                                create_video_train_state)

    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    per_step = vid_per_step(vid_kernel_plan(cfg))
    runs = {}
    with tf32_off(), cudnn_deterministic():
        for route in routes:
            patches = {"kernel": (), "plain": instance_plain_patches(),
                       "f64": instance_plain_patches(stats_f64)}[route]
            st = create_video_train_state(cfg32, seed)
            stp = build_video_train_step(cfg32)
            before = launch_counts()
            with contextlib.ExitStack() as stack:
                for patch in patches:
                    stack.enter_context(patch)
                runs[route] = {k: float(v)
                               for k, v in stp(st, batch)[1].items()}
            launched = {k: launch_counts()[k] - before[k] for k in before}
            want = only(**per_step) if route == "kernel" else only()
            if launched != want:
                raise AssertionError(f"f32 {route} video step launched "
                                     f"{launched}, want {want}")
            del st, stp
            torch.cuda.empty_cache()
    return runs


def device_shares(table, busy_ms: float, n: int = 6):
    """The ``n`` largest device-time entries of a profiler table, as
    ``name: ms (share of the busy time)``."""
    from torch.autograd import DeviceType

    rows = sorted(((e.self_device_time_total / 1e3, e.key) for e in table
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), reverse=True)[:n]
    return "; ".join(f"{k[:70]}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}%)"
                     for ms, k in rows)


def video_phase(device, card, tmp: str):
    """Slice 11, ``vid2vid_temporal`` at full width (U-Net ngf 64, the
    3-scale spatial D and the 2-scale temporal D, ndf 64, n_layers 3, 8
    frames of 256², batch 1, bf16 on f32 masters): (a) the data; (b) 2
    epochs through ``cli.train``; (c) ``elastic@VID_STOP`` and its
    resume; (d) ``cli.infer --metrics``; a profiled step; (e) the kernel
    form's bf16 steps and its f32 check. Returns the launch counts of (e)'s
    bf16 steps."""
    from p2p_tpu_torch.cli import infer
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.video import make_synthetic_video_dataset
    from p2p_tpu_torch.train.checkpoint import CheckpointManager
    from p2p_tpu_torch.train.video_step import (build_video_train_step,
                                                create_video_train_state)

    t_phase = time.perf_counter()
    cfg = get_preset("vid2vid_temporal")
    m, t = cfg.model, cfg.data.n_frames
    h, w = cfg.image_hw
    n_videos, n_frames = VID_SOURCES
    n_clips = n_videos * (n_frames // t)
    steps = VID_EPOCHS * n_clips
    # ---- (a) the data
    t0 = time.perf_counter()
    data = make_synthetic_video_dataset(os.path.join(tmp, "data"),
                                        n_videos=n_videos, n_frames=n_frames,
                                        size=h, seed=SEED)
    print(f"slice 11 (a): {n_videos} videos of {n_frames} frames of "
          f"{h}x{w} a split ({n_clips} train and {n_clips} test clips of "
          f"{t}) written in {time.perf_counter() - t0:.1f}s", flush=True)

    def args(name, *extra):
        return ["--preset", "vid2vid_temporal", "--data_root", data,
                "--workdir", os.path.join(tmp, name), "--nepoch",
                str(VID_EPOCHS), "--epochsave", "1", "--log_every", "1",
                *extra]

    def ckpt(name):
        return CheckpointManager(os.path.join(
            tmp, name, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name))

    def records(name):
        return read_records(os.path.join(tmp, name,
                                         f"metrics_{cfg.name}.jsonl"))

    # ---- (b) training through cli.train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    u = res_train("uninterrupted run", args("u"), 0, 0, video=True)
    peak = torch.cuda.max_memory_allocated(device)
    rec_u = records("u")
    trains = [r for r in rec_u if r["kind"] == "train"]
    evals = [r for r in rec_u if r["kind"] == "eval"]
    epochs = [r for r in rec_u if r["kind"] == "epoch"]
    calls = [1e3 * (e - s) for s, e in u["calls"]]
    med = statistics.median(calls[TRAIN_WARMUP:])
    print(f"slice 11 (b): {len(trains)} train records, losses "
          + json.dumps([{k: r[k] for k in VID_LOSS_KEYS} for r in trains])
          + f"; eval {[(r['psnr_mean'], r['n_frames_scored']) for r in evals]}"
          f"; step calls ms {[round(c, 2) for c in calls]}; median after "
          f"{TRAIN_WARMUP} {med:.2f} ms/step, {t * 1e3 / med:.1f} frames/s "
          f"(epoch records' frames_per_sec "
          f"{[round(r['frames_per_sec'], 2) for r in epochs]}); peak "
          f"device memory {peak / 2 ** 30:.2f} GiB; checkpoints "
          f"{ckpt('u').all_steps()}; on {card}", flush=True)
    if u["steps"] != steps or len(trains) != steps or not all(
            np.isfinite(r[k]) for r in trains
            for k in ("loss_d", "loss_dt", "loss_g", "g_gan_t")) \
            or [r["n_frames_scored"] for r in evals] != [n_clips * t] * 2 \
            or len(epochs) != VID_EPOCHS \
            or ckpt("u").all_steps() != [n_clips, steps] \
            or any(ckpt("u").verify(s) for s in (n_clips, steps)):
        raise AssertionError("slice 11 (b): the training run")

    # ---- (c) preemption at VID_STOP and the exact resume
    pre = res_train(f"preempted run (P2P_CHAOS=elastic@{VID_STOP})",
                    args("p"), 75, 0, chaos=f"elastic@{VID_STOP}",
                    video=True)
    res = res_train("the resumed run", args("p"), 0, 0, video=True)
    rec_p = records("p")
    resumed = [(r["step"], r["epoch"], r["batches_done"]) for r in rec_p
               if r["kind"] == "resume"]
    print(f"slice 11 (c): preempted after {pre['steps']} steps, "
          f"checkpoints {ckpt('p').all_steps()}, the resume record "
          f"{resumed}, restored (step, bitwise as saved) {res['restored']}, "
          f"read {res['reads']} against the uninterrupted tail "
          f"{u['reads'][VID_STOP:]}", flush=True)
    # the loader runs one clip ahead on the card: the preempted run has
    # read the first VID_STOP clips (and the next one, unconsumed)
    if pre["steps"] != VID_STOP \
            or pre["reads"][:VID_STOP] != u["reads"][:VID_STOP] \
            or resumed != [(VID_STOP, 2, VID_STOP - n_clips)] \
            or res["restored"] != [(VID_STOP, True)] \
            or res["reads"] != u["reads"][VID_STOP:] \
            or ckpt("p").all_steps() != [n_clips, VID_STOP, steps]:
        raise AssertionError("slice 11 (c): the preempted run or its resume")

    # ---- (d) clip inference from the resumed run's checkpoint
    out_dir = os.path.join(tmp, "frames")
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = infer.main(["--preset", "vid2vid_temporal", "--data_root", data,
                         "--workdir", os.path.join(tmp, "p"), "--metrics",
                         "--out", out_dir])
    sec = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    pngs = sorted(os.listdir(out_dir))
    print(f"slice 11 (d): cli.infer exit {rc} in {sec:.1f}s, {len(pngs)} "
          f"PNGs; {lines}", flush=True)
    if rc != 0 or len(pngs) != n_clips * t or launch_counts() != only() \
            or not any(x.startswith("psnr_mean=") for x in lines):
        raise AssertionError("slice 11 (d): cli.infer")
    for name in pngs:
        check_png(os.path.join(out_dir, name), h, w)

    # ---- a profiled step of the preset as registered
    dtype = train_dtype(cfg.train.mixed_precision)
    batches = vid_clips(tmp, cfg, 2, SEED)
    state = create_video_train_state(cfg, SEED, train_dtype=dtype)
    step = build_video_train_step(cfg, None, dtype)
    step(state, batches[0])
    table, wall, busy, launches = profiled(lambda: step(state, batches[1]))
    print(f"slice 11: one profiled bf16 step: wall {wall:.2f} ms (profiler "
          f"on), device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of "
          f"that wall, {100 * busy / med:.1f}% of (b)'s median step), "
          f"{launches} kernel launches; largest device shares: "
          f"{device_shares(table, busy)}; on {card}", flush=True)
    del state, step
    torch.cuda.empty_cache()

    # ---- (e) the kernel form: 2 bf16 steps, then the f32 check
    kcfg = vid_kernel_config()
    per_step = vid_per_step(vid_kernel_plan(kcfg))
    state = create_video_train_state(kcfg, SEED, train_dtype=dtype)
    step = build_video_train_step(kcfg, None, dtype)
    what = "slice 11 (e) vid2vid kernel form"
    print(f"{what}: norm={kcfg.model.norm}, norm_d={kcfg.model.norm_d}, "
          f"{t} frames of {h}x{w}, {dtype}; per step {per_step} at N = "
          f"{kcfg.data.batch_size * t}", flush=True)
    counts, _ = bf16_train_run(
        what, state, step, batches[:VID_KERNEL_STEPS], 1,
        only(**{k: v * VID_KERNEL_STEPS for k, v in per_step.items()}),
        VID_LOSS_KEYS, card, False)
    del state, step
    torch.cuda.empty_cache()
    runs = vid_f32_routes(kcfg, batches[0], SEED, ("kernel", "plain"))
    rels = {k: abs(runs["kernel"][k] - runs["plain"][k])
            / abs(runs["plain"][k]) for k in VID_LOSS_KEYS}
    print(f"{what}: f32 (TF32 off, cuDNN deterministic) one step through "
          f"#1, #2, #3 vs their plain versions from one state: rel diff "
          f"{json.dumps(rels)} (limit {VID_F32_RTOL}); the phase "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}", flush=True)
    if not all(rel <= VID_F32_RTOL for rel in rels.values()):
        raise AssertionError(f"{what}: f32 kernels vs plain {rels}")
    return counts


def paeth_np(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit RGB or RGBA PNG of ``img`` whose row r is written with
    filter ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), the filters applied here in numpy."""
    import struct
    import zlib

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * c, np.int64)
    for r in range(h):
        x = rows[r]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        ftype = filters[r % len(filters)]
        pred = {0: 0, 1: a, 2: prior, 3: (a + prior) >> 1,
                4: paeth_np(a, prior, cc)}[ftype]
        out.append(ftype)
        out += ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def median_ms(fn, reps: int = S12_REPS):
    """``(result, median ms)`` of ``reps`` host-clock calls."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t) * 1e3)
    return out, statistics.median(times)


def host_image_check(card: str):
    """(a) The C++ host image path against its numpy plain versions on
    the card's host: 512x1024 PNGs with every row Paeth, every row
    Average, all five filters in turn, and RGBA, decoded bitwise equal by
    both routes (the C++ route counted); Pillow's bicubic resize 512x1024
    → 256x512 and 1024x512 → 286x572 bitwise equal by both; a JPEG body
    read through Pillow as Pillow reads it; the ms of each route, median
    of ``S12_REPS``."""
    import io

    from p2p_tpu_torch import native
    from p2p_tpu_torch.data.pipeline import load_image_bytes
    from p2p_tpu_torch.obs.registry import get_registry
    from p2p_tpu_torch.utils import images

    rng = np.random.default_rng(SEED)
    img = np.cumsum(rng.integers(0, 8, (512, 1024, 4), dtype=np.uint8),
                    axis=1, dtype=np.uint8)
    native.library()                       # built before the timing
    cases = {"paeth": (img[..., :3], (4,)), "average": (img[..., :3], (3,)),
             "all five": (img[..., :3], (0, 1, 2, 3, 4)),
             "rgba": (img, (4, 3, 2, 1, 0))}
    routes = "png_decode_total{route=native}"
    for what, (x, filters) in cases.items():
        data = filtered_png(x, filters)
        before = get_registry().snapshot().get(routes, {}).get("value", 0)
        got, ms = median_ms(lambda: images.decode_png(data))
        after = get_registry().snapshot()[routes]["value"]
        want, plain_ms = median_ms(lambda: images.decode_png_plain(data))
        if not (np.array_equal(got, want) and np.array_equal(got, x[..., :3])
                and after - before == S12_REPS):
            raise AssertionError(f"host decode {what}: the routes differ")
        print(f"slice 12 (a): decode 512x1024 {what} ({len(data)} bytes): "
              f"C++ {ms:.2f} ms, numpy {plain_ms:.2f} ms, bitwise equal; "
              f"on the host of {card}", flush=True)
    for (h, w), (oh, ow) in (((512, 1024), (256, 512)),
                             ((1024, 512), (286, 572))):
        x = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, ms = median_ms(lambda: images.resize_bicubic(x, oh, ow))
        want, plain_ms = median_ms(
            lambda: images.resize_bicubic_plain(x, oh, ow))
        if got.shape != (oh, ow, 3) or not np.array_equal(got, want):
            raise AssertionError(f"host resize {h}x{w} -> {oh}x{ow}")
        print(f"slice 12 (a): bicubic resize {h}x{w} -> {oh}x{ow}: C++ "
              f"{ms:.2f} ms, numpy {plain_ms:.2f} ms, bitwise equal",
              flush=True)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img[:256, :256, :3]).save(buf, format="JPEG")
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    got = load_image_bytes(buf.getvalue(), 256, 256, as_uint8=True)
    if not np.array_equal(got, want):
        raise AssertionError("a JPEG body is not read as Pillow reads it")
    print("slice 12 (a): a 256x256 JPEG request body decoded through "
          "Pillow as Pillow decodes it", flush=True)


def loader_check(tmp: str):
    """(b) ``make_loader`` over ``S12_PAIRS`` uncached 256² pairs in this
    process against a pool of ``S12_WORKERS`` worker processes kept across
    three epochs, as the trainer keeps it: the same batches, bitwise and
    in order, with and without ``skip_samples``; each epoch's seconds
    (the first with the workers' start)."""
    from p2p_tpu_torch.data.pipeline import (LoaderWorkers,
                                             PairedImageDataset, make_loader)
    from p2p_tpu_torch.utils.images import encode_png

    root = os.path.join(tmp, "loader")
    rng = np.random.default_rng(SEED)
    for side in "ab":
        os.makedirs(os.path.join(root, "train", side))
    for i in range(S12_PAIRS):
        for side in "ab":
            x = np.cumsum(rng.integers(0, 8, (256, 256, 3), dtype=np.uint8),
                          axis=1, dtype=np.uint8)
            with open(os.path.join(root, "train", side, f"{i:03d}.png"),
                      "wb") as f:
                f.write(encode_png(x))
    ds = PairedImageDataset(root, "train", image_size=256, cache=False,
                            dtype="uint8")

    def epoch(skip, workers=None):
        t = time.perf_counter()
        out = list(make_loader(ds, 1, seed=SEED, skip_samples=skip,
                               workers=workers))
        return out, time.perf_counter() - t

    want = {skip: epoch(skip) for skip in (0, S12_SKIP)}
    pool = LoaderWorkers(ds, S12_WORKERS)
    try:
        kept = [(skip,) + epoch(skip, pool) for skip in (0, S12_SKIP, 0)]
    finally:
        pool.close()
    for i, (skip, got, secs) in enumerate(kept):
        a = want[skip][0]
        if len(a) != S12_PAIRS - skip or len(got) != len(a) or any(
                x.keys() != y.keys() or any(not np.array_equal(x[k], y[k])
                                            for k in x)
                for x, y in zip(a, got)):
            raise AssertionError(f"loader workers, epoch {i + 1}, skip "
                                 f"{skip}: batches differ")
        print(f"slice 12 (b): epoch {i + 1} of {len(a)} uncached 256² pairs "
              f"(skip_samples {skip}): {want[skip][1]:.2f} s in process, "
              f"{secs:.2f} s with {S12_WORKERS} kept worker processes"
              f"{' (their start included)' if i == 0 else ''}, the same "
              "batches in the same order", flush=True)


def op_grads(fn, x: torch.Tensor, g: torch.Tensor):
    """``(value, d<value·g>/dx)`` of ``fn`` at ``x``."""
    x = x.detach().clone().requires_grad_(True)
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, g)
    return y.detach(), dx


def new_ops_backward(device):
    """(d) ``sobel_edges``, ``angular_loss`` and ``gram_matrix`` forward and
    backward on the card in f32, channels_last, at the shapes of the
    reference step (256² images; the five VGG19 taps), against f64 on the
    CPU within ``S12_GRAD_RTOL`` of the largest entry, each twice under
    cuDNN deterministic for the same bits. They run in the TF32 setting
    the train step runs them in, PyTorch's defaults (checked here): cuDNN
    TF32 on, which the Sobel sums never reach, and matmul TF32 off, which
    Gram's ``bmm`` reads."""
    from p2p_tpu_torch.losses.style import gram_matrix
    from p2p_tpu_torch.ops.sobel import angular_loss, sobel_edges

    gen = torch.Generator(device=device).manual_seed(SEED)
    img = (1, 3, 256, 256)
    cases = [("sobel_edges", sobel_edges, img, (1, 1, 256, 256)),
             ("angular_loss", None, img, ())]
    for c, s in ((64, 256), (128, 128), (256, 64), (512, 32), (512, 16)):
        cases.append((f"gram_matrix {c}x{s}x{s}", gram_matrix,
                      (1, c, s, s), (1, c, c)))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    if tf32 != (True, False):
        raise AssertionError(f"(d) wants PyTorch's TF32 defaults, the train "
                             f"step's (cuDNN on, matmul off); got {tf32}")
    with cudnn_deterministic():
        for what, fn, shape, out_shape in cases:
            x = make_input(gen, *shape, torch.float32, device)
            if fn is None:
                other = make_input(gen, *shape, torch.float32, device)

                def fn(v, other=other):
                    return angular_loss(v, other)
            g = torch.randn(out_shape, generator=gen, device=device)
            runs = [op_grads(fn, x, g) for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"{what}: two runs differ")
            x64 = x.detach().cpu().double()
            if what == "angular_loss":
                o64 = other.detach().cpu().double()
                want = op_grads(lambda v: angular_loss(v, o64), x64,
                                g.cpu().double())
            else:
                want = op_grads(fn, x64, g.cpu().double())
            errs = []
            for got, ref in zip(runs[0], want):
                err = (got.cpu().double() - ref).abs().max().item()
                errs.append(err / max(ref.abs().max().item(), 1e-30))
            if max(errs) > S12_GRAD_RTOL:
                raise AssertionError(f"{what}: {errs} of the largest entry")
            print(f"slice 12 (d): {what} on the card (f32 in the step's "
                  f"TF32 setting, channels_last) "
                  f"against f64: value {errs[0]:.2e}, gradient {errs[1]:.2e} "
                  "of the largest entry; the same bits twice", flush=True)


def init_type_check(device):
    """(e) ``init_type`` on the full-width ``reference`` state: every
    re-drawn kernel of G, D and net_c follows its law (the std within 6
    standard errors of σ and |w| ≤ 2σ/0.87962566 for the truncated
    xavier and kaiming; WᵀW = gain²·I in the JAX (H·W·I, O) layout, WWᵀ
    where it is wide, for orthogonal)."""
    from p2p_tpu_torch.convert import kernel_to_flax
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.models.registry import jax_kernels, kernel_fans
    from p2p_tpu_torch.train.state import create_train_state

    cfg = get_preset("reference")
    for init_type in ("xavier", "kaiming", "orthogonal"):
        st = create_train_state(cfg.replace(model=dataclasses.replace(
            cfg.model, init_type=init_type, init_gain=S12_INIT_GAIN)),
            cfg.train.seed, device=device)
        n, worst = 0, 0.0
        for net in (st.net_g, st.net_d, st.net_c):
            for name, p, owner in jax_kernels(net):
                w = kernel_to_flax(p.detach(), owner).double().cpu()
                shape = tuple(w.shape)
                n += 1
                if init_type == "orthogonal":
                    m = w.reshape(-1, shape[-1])
                    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
                    err = (gram - S12_INIT_GAIN ** 2 * torch.eye(
                        len(gram), dtype=torch.float64)).abs().max().item()
                    worst = max(worst, err / S12_INIT_GAIN ** 2)
                    if err > 1e-5 * S12_INIT_GAIN ** 2:
                        raise AssertionError(f"{init_type} {name}: {err}")
                    continue
                fan_in, fan_out = kernel_fans(shape)
                sigma = math.sqrt(2.0 / (fan_in + fan_out)
                                  if init_type == "xavier" else 2.0 / fan_in)
                se = 1.0 / math.sqrt(2 * w.numel())
                dev = abs(w.std().item() / sigma - 1.0) / se
                worst = max(worst, dev)
                if dev > 6 + 1e-3 / se or w.abs().max().item() > (
                        2 * sigma / 0.87962566103423978 * (1 + 1e-6)):
                    raise AssertionError(f"{init_type} {name}: std "
                                         f"{w.std().item()} vs {sigma}")
        what = ("largest |WᵀW − g²I| / g²" if init_type == "orthogonal"
                else "largest |std/σ − 1| in standard errors")
        print(f"slice 12 (e): init_type {init_type} on the full-width "
              f"reference state: {n} kernels of G, D and net_c by the law; "
              f"{what} {worst:.3g}", flush=True)
        del st


def infer_cache_check(work: str, data: str, tmp: str):
    """(g) ``cli.infer --compilation_cache <dir>`` in a process of its own
    exits 0 and builds its libraries into ``<dir>``."""
    built = os.path.join(tmp, "infer_cache")
    out = os.path.join(tmp, "infer_cache_pred")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "p2p_tpu_torch.cli.infer", "--preset",
         "reference", "--data_root", data, "--workdir", work, "--out", out,
         "--compilation_cache", built], capture_output=True, text=True,
        timeout=600)
    libs = sorted(os.listdir(built)) if os.path.isdir(built) else []
    print(f"slice 12 (g): cli.infer --compilation_cache: exit "
          f"{proc.returncode} in {time.perf_counter() - t:.1f} s; built "
          f"there {libs}", flush=True)
    if proc.returncode != 0 or not any(
            f.startswith("libfastimage-") and f.endswith(".so")
            for f in libs):
        raise AssertionError(f"cli.infer --compilation_cache:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")


def slice12_phase(device, card, tmp: str):
    """Slice 12 (phase 16): (a) the host image path, (b) the loader's
    workers, (c) the full-width ``reference`` run through ``cli.train`` on
    phase 10's data with the Sobel, angular and style terms, VFID and the
    masks, (d) the new ops' backward, (e) ``init_type``, (g) ``cli.infer
    --compilation_cache``. Returns the launch counts of (c)'s steps."""
    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.utils.images import decode_png

    t_phase = time.perf_counter()
    host_image_check(card)
    loader_check(tmp)

    cfg = get_preset("reference")
    m = cfg.model
    per_step = len(batchnorm_plan(m.ngf, m.n_blocks, *cfg.image_hw))
    data = os.path.join(tmp, "data")
    work = os.path.join(tmp, "slice12")
    config_from_flags = train.config_from_flags

    def with_style(args):
        c = config_from_flags(args)
        return c.replace(loss=dataclasses.replace(c.loss,
                                                  lambda_style=S12_STYLE))

    torch.cuda.reset_peak_memory_stats(device)
    seen = res_train(
        "reference with --lambda_sobel 1 --sobel_warmup_epochs 2 "
        "--lambda_angular 1 --eval_fid --save_masks --threads 4, "
        f"lambda_style {S12_STYLE}",
        ["--preset", "reference", "--data_root", data, "--workdir", work,
         "--nepoch", str(LOOP_EPOCHS), "--epochsave", "1", "--log_every",
         "1", "--lambda_sobel", "1", "--sobel_warmup_epochs", "2",
         "--lambda_angular", "1", "--eval_fid", "--save_masks", "--threads",
         "4"], 0, per_step,
        within=mock.patch.object(train, "config_from_flags", with_style),
        label="slice 12 (c)")
    peak = torch.cuda.max_memory_allocated(device)
    records = run_records(work)
    steps = [r for r in records if r["kind"] == "train"]
    evals = [r for r in records if r["kind"] == "eval"]
    keys = ("g_style", "g_sobel", "g_angular")
    if len(steps) != LOOP_STEPS or seen["steps"] != LOOP_STEPS or not all(
            np.isfinite(r[k]) for r in steps for k in keys):
        raise AssertionError(f"slice 12 (c): train records {steps}")
    if len(evals) != LOOP_EPOCHS or not all(
            np.isfinite(r["vfid"]) and r["vfid_feature_source"] == "random"
            for r in evals):
        raise AssertionError(f"slice 12 (c): eval records {evals}")
    out = os.path.join(work, cfg.train.result_dir, cfg.data.dataset)
    for e in range(1, LOOP_EPOCHS + 1):
        pred, inp, mask = (decode_png(open(os.path.join(
            out, f"e{e}_{k}.png"), "rb").read())
            for k in ("pred", "input", "mask"))
        if not np.array_equal(mask, np.bitwise_and(pred, inp)):
            raise AssertionError(f"slice 12 (c): e{e}_mask.png is not the "
                                 "AND of the saved prediction and input")
    took = sorted(b - a for a, b in seen["calls"][2:])
    print(f"slice 12 (c): {seen['steps']} steps, g_style/g_sobel/g_angular "
          "finite in every train record ("
          + ", ".join(f"{k} {steps[-1][k]:.4g}" for k in keys)
          + "), vfid " + ", ".join(f"{r['vfid']:.4f}" for r in evals)
          + f" ({evals[0]['vfid_feature_source']} VGG19 features), masks "
          f"the AND of pred and input; step median "
          f"{statistics.median(took) * 1e3:.2f} ms (steps 3-{LOOP_STEPS}); "
          f"peak device memory {peak / 2 ** 30:.2f} GiB; on {card}",
          flush=True)

    new_ops_backward(device)
    init_type_check(device)
    infer_cache_check(os.path.join(tmp, "work"), data, tmp)
    print(f"slice 12: phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"batch_moments": per_step * seen["steps"]}


def add_moment_launches(rows, plan, steps: int) -> None:
    """Add ``steps`` reference train steps to the bf16 #5 rows that weight
    the ``kernels`` line: one launch at each shape of ``plan`` a step."""
    by_key = {(r["kernel"], r["n"], tuple(r["shape"]), r["form"]): r
              for r in rows if r["dtype"] == "bfloat16"}
    for shape in plan:
        by_key[("batch_moments", 1, tuple(shape), "-")]["launches"] += steps


def http_post(base: str, path: str, data: bytes, timeout: float = 300):
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_get(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


def run_clients(base: str, jobs, n_threads: int):
    """POST each ``(alias, index, body)`` of the iterable ``jobs`` to its
    tenant from ``n_threads`` client threads, taking the jobs in order.
    Returns one ``(alias, index, status, response, t_start, t_end)`` a
    job, in the jobs' order."""
    jobs = iter(jobs)
    out = {}
    taken = iter(range(1 << 62))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                job, k = next(jobs, None), next(taken)
            if job is None:
                return
            alias, i, body = job
            t0 = time.perf_counter()
            status, resp = http_post(base, f"/v1/{alias}/translate", body)
            out[k] = (alias, i, status, resp, t0, time.perf_counter())

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [out[k] for k in sorted(out)]


def percentile(values, q: float) -> float:
    """The q-quantile by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(values), 100 * q))


def hd_checkpoints(cfg, ckpt_dir: str) -> None:
    """Steps 1 and 2 of a full-width pix2pixhd run: ``create_train_state``
    at seeds 0 and 1, saved by the port's ``CheckpointManager``."""
    from p2p_tpu_torch.train.checkpoint import CheckpointManager
    from p2p_tpu_torch.train.state import create_train_state

    mgr = CheckpointManager(ckpt_dir)
    for step, seed in ((1, 0), (2, 1)):
        state = create_train_state(cfg, seed)
        mgr.save(step, state, 0)
        del state
    torch.cuda.empty_cache()


def served_images(cfg, ckpt_dir: str, step: int, groups):
    """``{image bytes: [uint8 outputs]}``: each recorded group served again
    by an in-process ``engine_from_checkpoint`` engine at ``step``, as the
    server served it (the same rows, so the same padded bucket batch)."""
    from p2p_tpu_torch.serve.engine import engine_from_checkpoint
    from p2p_tpu_torch.serve.io import to_host
    from p2p_tpu_torch.utils.images import to_uint8_img

    engine, _ = engine_from_checkpoint(cfg, ckpt_dir, step=step,
                                       buckets=BUCKETS)
    out = collections.defaultdict(list)
    for g in groups:
        pred, _, n = engine.infer_batch({k: g for k in engine.batch_keys})
        arr = to_host(pred[:n])
        for row in range(n):
            out[g[row].tobytes()].append(to_uint8_img(arr[row]))
    del engine
    torch.cuda.empty_cache()
    return out


def levels_apart(got: np.ndarray, candidates) -> int:
    """The fewest uint8 levels by which ``got`` differs from one of
    ``candidates`` at its worst pixel (256 with none)."""
    return min((int(np.abs(got.astype(np.int16) - c.astype(np.int16)).max())
                for c in candidates), default=256)


def add_serving_launches(rows, plan, forwards) -> None:
    """Add ``forwards`` ({batch size: pix2pixHD forwards}) to the bf16
    rows of #1 and #3 that weight the ``kernels`` line: one of each per
    epilogue of ``plan`` a forward."""
    by_key = {(r["kernel"], r["n"], tuple(r["shape"]), r["form"]): r
              for r in rows if r["dtype"] == "bfloat16"}
    for n, count in forwards.items():
        for h, w, c, act, res in plan:
            by_key[("instance_norm_stats", n, (h, w, c), "-")][
                "launches"] += count
            by_key[("norm_act", n, (h, w, c), form_of(act, res))][
                "launches"] += count


def cli_subprocess(cmd, until: str, timeout: float = 600):
    """Start ``cmd`` from the checkout's root and read its output until a
    line holds ``until``; returns ``(process, lines)``. The process is
    killed if that line does not come within ``timeout`` seconds."""
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if until in line:
                return proc, lines
    finally:
        killer.cancel()
    proc.wait()
    raise AssertionError(f"{cmd[2]} exited {proc.returncode} before "
                         f"{until!r}:\n" + "\n".join(lines[-40:]))


def finish(proc, lines, timeout: float):
    """Wait for ``proc`` (killing it after ``timeout`` s); returns its exit
    code and all its output lines."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return proc.returncode, lines + out.splitlines()


def summaries_in(lines):
    return [json.loads(x) for x in lines
            if x.startswith('{"kind": "serve_summary"')]


def cli_phase(ref_work: str, ref_step: int, tmp: str, bodies,
              shape) -> None:
    """``cli.serve`` as subprocesses on the ``reference`` checkpoint: HTTP
    (HTTP_CLI_REQUESTS requests, then SIGTERM: exit 0 within the drain
    timeout, one summary) and watch mode (PNGs copied in while it runs,
    ``--max_requests``: every output written, exit 0)."""
    import signal

    from p2p_tpu_torch.utils.images import decode_png

    drain = 30.0
    serve = [sys.executable, "-m", "p2p_tpu_torch.cli.serve",
             "--workdir", ref_work, "--buckets", "1,2,4"]
    proc, lines = cli_subprocess(
        serve + ["--http", "127.0.0.1:0", "--drain_timeout", str(drain),
                 "--tenant", f"alias=ref,preset=reference,step={ref_step}"],
        "serving 1 tenant(s)")
    try:
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        got = run_clients(f"http://127.0.0.1:{port}",
                          [("ref", i, bodies[i])
                           for i in range(HTTP_CLI_REQUESTS)], 2)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc, lines = finish(proc, lines, drain + 30)
        took = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    codes = [g[2] for g in got]
    shapes = {decode_png(g[3]).shape for g in got if g[2] == 200}
    summaries = summaries_in(lines)
    print(f"http: cli.serve --http subprocess: codes {codes}, shapes "
          f"{shapes}, exit {rc} {took:.2f}s after SIGTERM (drain timeout "
          f"{drain:.0f}s), summaries {summaries}", flush=True)
    if codes != [200] * HTTP_CLI_REQUESTS or shapes != {shape} \
            or rc != 0 or took > drain or len(summaries) != 1 \
            or summaries[0]["served"] != HTTP_CLI_REQUESTS:
        raise AssertionError("cli.serve --http:\n" + "\n".join(lines[-40:]))

    watch = os.path.join(tmp, "watch")
    os.makedirs(watch)
    proc, lines = cli_subprocess(
        serve + ["--preset", "reference", "--step", str(ref_step),
                 "--input_dir", watch, "--max_requests",
                 str(HTTP_CLI_REQUESTS), "--poll_ms", "50",
                 "--linger_ms", "20"], "buckets warmed")
    try:
        for i in range(HTTP_CLI_REQUESTS):
            part = os.path.join(watch, f".part{i}")
            with open(part, "wb") as f:
                f.write(bodies[i])
            os.replace(part, os.path.join(watch, f"w{i}.png"))
            time.sleep(0.1)
        rc, lines = finish(proc, lines, 120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    outs = sorted(os.listdir(watch + "_out"))
    shapes = set()
    for name in outs:
        with open(os.path.join(watch + "_out", name), "rb") as f:
            shapes.add(decode_png(f.read()).shape)
    summaries = summaries_in(lines)
    print(f"http: cli.serve watch mode: exit {rc}, outputs {outs} "
          f"{shapes}, summary {summaries}", flush=True)
    if rc != 0 or outs != [f"w{i}.png" for i in range(HTTP_CLI_REQUESTS)] \
            or shapes != {shape} or len(summaries) != 1 \
            or summaries[0]["written"] != HTTP_CLI_REQUESTS:
        raise AssertionError("cli.serve watch mode:\n"
                             + "\n".join(lines[-40:]))


def http_phase(card: str, ref_work: str, ref_steps, tmp: str,
               dir_img_s: float):
    """Phase 11: the HTTP service with two tenants restored from the
    port's checkpoints (full-width pix2pixhd ``hd`` and the phase-10
    ``reference`` run ``ref``), continuous batching, hot-swap of both under
    traffic, a rejected reload, the status ladder, the drain; then the
    CLI as subprocesses. Returns ``(launch counts, hd forwards by batch
    size)``."""
    import shutil

    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.obs import MetricsRegistry
    from p2p_tpu_torch.resilience import PreemptionGuard
    from p2p_tpu_torch.serve.io import pick_bucket
    from p2p_tpu_torch.serve.server import ServeApp, run_server
    from p2p_tpu_torch.serve.tenancy import Tenant, checkpoint_dir
    from p2p_tpu_torch.train.checkpoint import CheckpointManager
    from p2p_tpu_torch.utils.images import decode_png, encode_png

    cfgs = {"hd": get_preset("pix2pixhd"), "ref": get_preset("reference")}
    dirs = {"hd": checkpoint_dir(cfgs["hd"], os.path.join(tmp, "hd")),
            "ref": checkpoint_dir(cfgs["ref"], ref_work)}
    steps = {"hd": (1, 2), "ref": tuple(ref_steps)}
    t0 = time.perf_counter()
    hd_checkpoints(cfgs["hd"], dirs["hd"])
    t_ckpt = time.perf_counter() - t0
    # distinct bodies: HTTP_REQUESTS + HTTP_RELOAD_REQUESTS a tenant, and
    # one probe for the rejected reload
    n_img = HTTP_REQUESTS + HTTP_RELOAD_REQUESTS + 1
    rng = np.random.default_rng(SEED)
    imgs, bodies = {}, {}
    for alias in ("hd", "ref"):
        h, w = cfgs[alias].image_hw
        imgs[alias] = rng.integers(0, 256, (n_img, h, w, 3), dtype=np.uint8)
        bodies[alias] = [encode_png(im) for im in imgs[alias]]
    index = {a: {im.tobytes(): i for i, im in enumerate(imgs[a])}
             for a in imgs}
    print(f"http: two pix2pixhd checkpoints in {t_ckpt:.1f}s; "
          f"{n_img} request PNGs a tenant", flush=True)

    reg = MetricsRegistry()
    app = ServeApp(registry=reg, io_threads=4, max_queue=32, linger_ms=5.0,
                   max_attempts=2, retry_delay_ms=50.0)
    t0 = time.perf_counter()
    for alias in ("hd", "ref"):
        app.add_tenant(Tenant(alias, cfgs[alias], dirs[alias],
                              step=steps[alias][0], registry=reg,
                              buckets=BUCKETS))
    print(f"http: tenants restored in {time.perf_counter() - t0:.1f}s",
          flush=True)
    groups = {"hd": [], "ref": []}

    def recording(alias):
        infer_batch = app.tenants.get(alias).engine.infer_batch

        def record(batch):
            groups[alias].append(np.array(batch["input"]))
            return infer_batch(batch)

        return record

    guard = PreemptionGuard(registry=reg)
    ready = threading.Event()
    result = {}
    reset_launch_counts()
    with cudnn_deterministic(), \
            mock.patch.object(app.tenants.get("hd").engine, "infer_batch",
                              recording("hd")), \
            mock.patch.object(app.tenants.get("ref").engine, "infer_batch",
                              recording("ref")):
        server = threading.Thread(target=lambda: result.update(
            rc=run_server(app, "127.0.0.1", 0, guard=guard,
                          ready_event=ready)))
        server.start()
        try:
            if not ready.wait(600):
                raise AssertionError("the server did not come up")
            base = f"http://127.0.0.1:{app.httpd.server_address[1]}"
            wave1 = run_clients(base, [(a, i, bodies[a][i])
                                       for i in range(HTTP_REQUESTS)
                                       for a in ("hd", "ref")],
                                HTTP_CLIENTS)
            # both tenants hot-swap while 8 requests each are in flight
            reloads = {}

            def reload(alias, step):
                # whatever ends the reload ends the stream below; a
                # dropped connection is a failed reload, not a hang
                try:
                    reloads[alias] = http_post(
                        base, "/admin/reload", json.dumps(
                            {"tenant": alias, "step": step}).encode())
                except Exception as e:
                    reloads[alias] = (None, repr(e))

            def during_reloads():
                """The reload bodies, tenants alternating, at least
                HTTP_RELOAD_REQUESTS a tenant and on until both reloads
                have answered or HTTP_RELOAD_STREAM_CAP were sent."""
                k = 0
                while k < HTTP_RELOAD_STREAM_CAP and (
                        k < 2 * HTTP_RELOAD_REQUESTS or len(reloads) < 2):
                    a = ("hd", "ref")[k % 2]
                    i = HTTP_REQUESTS + (k // 2) % HTTP_RELOAD_REQUESTS
                    yield a, i, bodies[a][i]
                    k += 1

            window = {}
            threads = [threading.Thread(target=lambda: window.update(
                got=run_clients(base, during_reloads(), HTTP_CLIENTS)))] + [
                threading.Thread(target=reload, args=(a, steps[a][1]))
                for a in ("hd", "ref")]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if len(window["got"]) >= HTTP_RELOAD_STREAM_CAP:
                raise AssertionError(
                    f"the reloads answered only after "
                    f"{HTTP_RELOAD_STREAM_CAP} requests: {reloads}")
            # a reload of a copy of hd's step whose net_g is corrupted: 409,
            # and the same body gives the same image before and after
            probe = n_img - 1
            before = http_post(base, "/v1/hd/translate", bodies["hd"][probe])
            mgr = CheckpointManager(dirs["hd"])
            bad = steps["hd"][1] + 1
            shutil.copytree(mgr.step_dir(steps["hd"][1]), mgr.step_dir(bad))
            with open(os.path.join(mgr.step_dir(bad), "net_g.pt"),
                      "r+b") as f:
                f.seek(os.path.getsize(f.name) // 2)
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
            rejected = http_post(base, "/admin/reload", json.dumps(
                {"tenant": "hd", "step": bad}).encode())
            after = http_post(base, "/v1/hd/translate", bodies["hd"][probe])
            not_png = http_post(base, "/v1/hd/translate", b"not a png")
            unknown = http_post(base, "/v1/ghost/translate",
                                bodies["ref"][0])
            health = json.loads(http_get(base, "/healthz")[1])
            metrics = http_get(base, "/metrics")[1].decode()
        finally:
            guard.request()
            server.join(600)
    counts = launch_counts()
    summaries = {s["tenant"]: s for s in app.summaries()}

    # what the server did
    every = wave1 + window["got"] + [("hd", probe) + before + (0, 0),
                                     ("hd", probe) + after + (0, 0)]
    ok = collections.Counter(a for a, _, st, *_ in every if st == 200)
    bad_codes = [(a, i, st) for a, i, st, *_ in every if st != 200]
    print(f"http: reloads {reloads}; rejected reload {rejected}; non-PNG "
          f"{not_png[0]}, unknown tenant {unknown[0]}; 200s {dict(ok)}, "
          f"others {bad_codes}; healthz {health}; summaries {summaries}",
          flush=True)
    want_metric = {a: f'serve_http_requests_total{{code="200",tenant="{a}"}} '
                      f'{float(ok[a])}' for a in ok}
    fails = []
    if result.get("rc") != 0:
        fails.append(f"run_server returned {result.get('rc')}")
    if bad_codes:
        fails.append(f"non-200 translate answers {bad_codes}")
    if any(reloads[a][0] != 200 for a in reloads) or rejected[0] != 409:
        fails.append("reload codes")
    if (not_png[0], unknown[0]) != (422, 404):
        fails.append("the 422/404 ladder")
    if set(health.get("tenants", {})) != {"hd", "ref"} or any(
            health["tenants"][a]["step"] != steps[a][1]
            or health["tenants"][a]["n_warmups"] != len(BUCKETS)
            for a in ("hd", "ref")):
        fails.append("healthz steps or warm-ups")
    if any(summaries[a]["n_warmups"] != len(BUCKETS)
           or summaries[a]["hot_swaps"] != 1 for a in summaries):
        fails.append("warm-ups moved or swaps miscounted")
    for a, line in want_metric.items():
        if line not in metrics.splitlines():
            fails.append(f"/metrics lacks {line!r}")
    if before[1] != after[1]:
        fails.append("the probe's image changed across the rejected reload")

    # every 200 against the in-process engine, group by group
    want = {a: {s: served_images(cfgs[a], dirs[a], s, groups[a])
                for s in steps[a]} for a in ("hd", "ref")}
    apart = collections.defaultdict(list)
    moved = collections.Counter()
    for phase, got, allowed in (
            ("wave", wave1, lambda a: steps[a][:1]),
            ("reload", window["got"], lambda a: steps[a]),
            ("probe", [("hd", probe) + before + (0, 0),
                       ("hd", probe) + after + (0, 0)],
             lambda a: steps[a][1:])):
        for a, i, st, resp, *_ in got:
            if st != 200:
                continue  # failed above as a non-200 answer
            img = decode_png(resp)
            if img.shape != imgs[a][i].shape:
                fails.append(f"{a} {i}: shape {img.shape}")
                continue
            key = imgs[a][i].tobytes()
            by_step = {s: levels_apart(img, want[a][s][key])
                       for s in allowed(a)}
            best = min(by_step, key=by_step.get)
            apart[phase].append(by_step[best])
            if phase == "reload":
                moved[(a, best)] += 1
            if by_step[best] > HTTP_LEVELS_BAND:
                fails.append(f"{phase} {a} {i}: {by_step} levels from "
                             f"steps {list(by_step)}")
    print(f"http: responses vs the in-process engine, worst uint8 levels "
          f"apart: " + ", ".join(f"{p} {max(v)} over {len(v)}"
                                 for p, v in apart.items())
          + f" (band {HTTP_LEVELS_BAND}); during the reload, responses by "
          f"(tenant, step): {dict(moved)}", flush=True)

    # launches: #1 and #3 36 times an hd forward (warm-ups, dispatched
    # groups, the swap's warm forward), nothing else
    forwards = collections.Counter({b: 1 for b in BUCKETS})
    for g in groups["hd"]:
        forwards[pick_bucket(len(g), BUCKETS)] += 1
    forwards[min(BUCKETS)] += summaries["hd"]["hot_swaps"]
    n_fwd = sum(forwards.values())
    want_counts = only(instance_norm_stats=NORMS_PER_FORWARD * n_fwd,
                       norm_act=NORMS_PER_FORWARD * n_fwd)
    print(f"http: launches {counts} over {n_fwd} hd forwards by batch size "
          f"{dict(forwards)} (want {want_counts})", flush=True)
    if counts != want_counts:
        fails.append(f"launch counts {counts} != {want_counts}")
    if fails:
        raise AssertionError("http phase: " + "; ".join(fails))

    span = max(g[5] for g in wave1) - min(g[4] for g in wave1)
    print(f"http: wave of {len(wave1)} requests over both tenants: "
          f"{len(wave1) / span:.3f} img/s end to end in {span:.3f}s",
          flush=True)
    for a in ("hd", "ref"):
        mine = [g for g in wave1 if g[0] == a]
        lat = [1e3 * (g[5] - g[4]) for g in mine]
        window = max(g[5] for g in mine) - min(g[4] for g in mine)
        s = summaries[a]
        # one wave of noise PNGs: a smoke reading, too few requests for
        # a tail percentile, so p50 and max only
        print(f"http: {a}: {s['served']} served; wave of {HTTP_REQUESTS}: "
              f"{len(lat) / window:.3f} img/s end to end over its window; "
              f"client latency p50 {percentile(lat, 0.5):.2f}, "
              f"max {max(lat):.2f} ms; occupancy mean "
              f"{s['batch_occupancy_mean']}, padded {s['padded_images']}; "
              f"responder encode {s['encode_sec']:.3f}s; directory mode "
              f"(phase 3) {dir_img_s:.3f} img/s; on {card}", flush=True)
    cli_phase(ref_work, steps["ref"][0], tmp, bodies["ref"],
              imgs["ref"].shape[1:])
    return counts, forwards


def g1_plan(ngf: int, n_blocks: int, h: int, w: int):
    """(H, W, C, act, residual) of every norm epilogue of one
    GlobalGenerator forward alone (pix2pixHD's phase 1) on an (h, w)
    input: the first 27 of a full generator's at twice the size
    (models/pix2pixhd.py)."""
    plan = epilogue_plan(ngf, n_blocks, 3, 2 * h, 2 * w)
    return plan[:1 + 4 + 2 * n_blocks + 4]


def unet_norm_plan(ngf: int, h: int, w: int, num_downs: int = 8):
    """(H, W, C, "apply") of every norm of one U-Net forward with
    ``norm="pallas_instance"`` (#1 + #2 each; models/unet.py): encoder
    levels 1…num_downs−2, then decoder levels num_downs−1…1."""
    feats = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
    enc = [(h >> (i + 1), w >> (i + 1), feats[i], "apply")
           for i in range(1, num_downs - 1)]
    dec = [(h >> i, w >> i, feats[i - 1], "apply")
           for i in reversed(range(1, num_downs))]
    return enc + dec


def epoch_records(path: str, n_epochs: int):
    """The ``epoch`` records of a metrics file: ``n_epochs`` of them, every
    number finite."""
    epochs = [r for r in read_records(path) if r["kind"] == "epoch"]
    if len(epochs) != n_epochs or not all(
            np.isfinite(v) for r in epochs for v in r.values()
            if isinstance(v, float)):
        raise AssertionError(f"{path}: epoch records {epochs}")
    return epochs


def coarse_to_fine_phase(device, card, tmp: str, per_image):
    """pix2pixHD's coarse-to-fine schedule through its CLIs (slice 8, a):
    ``cli.generate_dataset`` cuts 1024×512 pairs out of synthetic 1024²
    sources; ``cli.train --phase global`` trains G1 alone at 512×256 for
    one epoch; ``cli.train --phase full`` trains the full generator at
    1024×512 for one epoch with G1 grafted in from phase 1's checkpoint:
    every grafted leaf bitwise the checkpoint's, the image head dropped,
    the epoch records finite, ``per_image[phase]`` launches of #1 and of
    #3 per train step and per eval forward (batch 1). Returns the launch
    counts."""
    from p2p_tpu_torch.cli import generate_dataset, train
    from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
    from p2p_tpu_torch.train import graft
    from p2p_tpu_torch.train.checkpoint import CheckpointManager

    n_train, n_test = C2F_SOURCES
    src, data, work = (os.path.join(tmp, d) for d in ("c2f_src", "c2f_data",
                                                       "c2f_work"))
    t0 = time.perf_counter()
    make_synthetic_dataset(src, n_train, n_test, size=1024, seed=SEED)
    for split in ("train", "test"):
        rc = generate_dataset.main([
            "--dataset_path", os.path.join(src, split, "a"),
            "--target_dataset_folder", data, "--split", split,
            "--crop_size", "512", "--crop_width", "1024",
            "--max_patches", "1"])
        if rc:
            raise AssertionError(f"generate_dataset {split}: exit {rc}")
    print(f"coarse-to-fine: generated {n_train} train and {n_test} test "
          f"pairs of 512x1024 in {time.perf_counter() - t0:.2f}s",
          flush=True)
    common = ["--preset", "pix2pixhd", "--data_root", data, "--workdir",
              work, "--nepoch", "1", "--epochsave", "1"]
    seen = {}
    graft_into = graft.graft_into

    def record(net_g, g1_params, verbose=True):
        graft_into(net_g, g1_params, verbose)
        seen.update({k: p.detach().cpu().clone()
                     for k, p in net_g.named_parameters()})

    counts = collections.Counter()
    for phase, name in (("global", "pix2pixhd_g1"), ("full", "pix2pixhd")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.object(graft, "graft_into", record), \
                contextlib.redirect_stdout(buf):
            rc = train.main(common + ["--phase", phase])
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        print("\n".join(f"coarse-to-fine {phase}: {line}"
                        for line in text.splitlines()[-6:]))
        if rc:
            raise AssertionError(f"cli.train --phase {phase}: exit {rc}")
        got = launch_counts()
        n = per_image[phase] * (n_train + n_test)
        want = only(instance_norm_stats=n, norm_act=n)
        (epoch,) = epoch_records(os.path.join(work, f"metrics_{name}.jsonl"),
                                 1)
        peak = torch.cuda.max_memory_allocated(device)
        print(f"coarse-to-fine {phase}: {name}, {n_train} steps + {n_test} "
              f"eval forwards in {wall:.2f}s; loss_g {epoch['loss_g']:.4f}, "
              f"loss_d {epoch['loss_d']:.4f}; {1e3 / epoch['img_per_sec']:.2f}"
              f" ms/step (the record's steps 2-{n_train}, the loader's PNG "
              f"decode and bicubic resize on the host included: phase 1's "
              f"line is the end-to-end reading of the C++ host image path, "
              f"slice 12); peak device "
              f"memory {peak / 2 ** 30:.2f} GiB; launches {got} (want "
              f"{want}); on {card}", flush=True)
        if got != want:
            raise AssertionError(f"coarse-to-fine {phase}: launches {got}")
        counts.update(got)
    g1_dir = os.path.join(work, "checkpoint", "cityscapes_hd",
                          "pix2pixhd_g1")
    mgr = CheckpointManager(g1_dir)
    saved = mgr.read(mgr.latest_step(), ["net_g"])["net_g"]
    head = sorted(k for k in saved if k.startswith("ConvLayer_5."))
    grafted = [k for k in saved if k not in head]
    if not head or not grafted or len(seen) == 0:
        raise AssertionError("coarse-to-fine: nothing grafted")
    bad = [k for k in grafted if not torch.equal(seen[f"global.{k}"],
                                                 saved[k])]
    dropped_line = "1 head leaves dropped (global.ConvLayer_5)"
    if bad or any(f"global.{k}" in seen for k in head) \
            or dropped_line not in text:
        raise AssertionError(f"coarse-to-fine graft: differs at {bad[:3]}")
    print(f"coarse-to-fine: {len(grafted)} G1 leaves grafted bitwise from "
          f"phase 1's step {mgr.latest_step()}, head {head} dropped",
          flush=True)
    return counts


def e2s_f32_routes(cfg, batches, seed, routes):
    """f32 (TF32 off, cuDNN deterministic) ``edges2shoes_dp`` steps on
    ``batches`` from the state of ``seed``, once per route of BatchNorm's
    moments: ``"kernel"`` (#5), ``"plain"`` or ``"f64"``
    (:func:`moments_f64`). Returns ``{route: per-step losses}``."""
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments_plain

    per_step = len(facades_bn_plan(cfg.model.ngf, *cfg.image_hw))
    swap = {"kernel": None, "plain": batch_moments_plain, "f64": moments_f64}
    runs = {}
    with cudnn_deterministic():
        for route in routes:
            patches = ((mock.patch.object(norm, "batch_moments",
                                          swap[route]),)
                       if swap[route] else ())
            n = len(batches) if route == "kernel" else 0
            runs[route] = f32_route(cfg, batches, None, patches,
                                    only(batch_moments=per_step * n), route,
                                    seed)
    return runs


def e2s_batches(cfg, n_steps: int, seed: int):
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch

    bs = cfg.data.batch_size
    host = synthetic_facades_batch(n_steps * bs, cfg.image_hw[0], seed=seed)
    return [{k: v[i * bs:(i + 1) * bs] for k, v in host.items()}
            for i in range(n_steps)]


def edges2shoes_phase(device, card, profile: bool):
    """``edges2shoes_dp`` at batch 64 (slice 8, b): 2 warm-up and 4 timed
    bf16 steps with finite losses and exactly 13 #5 per step, the device's
    busy share of a step and the peak memory; then the f32 kernels-vs-plain
    check within ``E2S_STEP1_RTOL`` / ``E2S_LATER_RTOL``."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    cfg = get_preset("edges2shoes_dp")
    h, w = cfg.image_hw
    per_step = len(facades_bn_plan(cfg.model.ngf, h, w))
    n_steps = E2S_WARMUP + E2S_STEPS
    batches = e2s_batches(cfg, n_steps, SEED)
    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    step = build_train_step(cfg, None, dtype)
    what = "edges2shoes_dp train"
    print(f"{what}: {h}x{w}, batch {cfg.data.batch_size}, {dtype}, ngf "
          f"{cfg.model.ngf}, dropout {cfg.model.use_dropout}, one device",
          flush=True)
    counts, med = bf16_train_run(
        what, state, step, batches, E2S_WARMUP,
        only(batch_moments=per_step * n_steps), FACADES_LOSS_KEYS, card,
        profile)
    peak = torch.cuda.max_memory_allocated(device)
    before = launch_counts()
    _, wall, busy, launches = profiled(lambda: step(state, batches[0]))
    counts = {k: counts[k] + launch_counts()[k] - before[k] for k in counts}
    print(f"{what}: peak device memory {peak / 2 ** 30:.2f} GiB; one "
          f"profiled step: wall {wall:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}% of that wall, "
          f"{100 * busy / med:.1f}% of the median step), {launches} kernel "
          f"launches; median {med:.2f} ms/step, "
          f"{cfg.data.batch_size * 1e3 / med:.1f} img/s; on {card}",
          flush=True)
    del state, step
    torch.cuda.empty_cache()
    runs = e2s_f32_routes(cfg, batches[:TRAIN_F32_STEPS], SEED,
                          ("kernel", "plain"))
    worst = 0.0
    for i, (lk, lp) in enumerate(zip(runs["kernel"], runs["plain"])):
        rtol = E2S_STEP1_RTOL if i == 0 else E2S_LATER_RTOL
        for k in FACADES_LOSS_KEYS:
            rel = abs(lk[k] - lp[k]) / abs(lp[k])
            worst = max(worst, rel)
            if not rel <= rtol:
                raise AssertionError(f"f32 edges2shoes step {i + 1} {k}: "
                                     f"kernel {lk[k]} vs plain {lp[k]} "
                                     f"(rtol {rtol})")
    print(f"{what}: f32 (TF32 off, cuDNN deterministic) "
          f"{TRAIN_F32_STEPS} steps through #5 vs its plain version, same "
          f"state and dropout seed: losses max rel diff {worst:.3g} (step 1 "
          f"limit {E2S_STEP1_RTOL}, step 2 {E2S_LATER_RTOL})", flush=True)
    return counts, n_steps + 1, med


def cityscapes_phase(device, card, profile: bool):
    """``cityscapes_spatial`` at 256×512, batch 4, bf16 (slice 8, c): the
    ResnetGenerator with plain instance norms, the 3-scale spectral-norm D
    and VGG19: 2 warm-up and 4 timed steps with finite losses and no
    kernel launched; ms/step and the peak memory."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = get_preset("cityscapes_spatial")
    h, w = cfg.image_hw
    bs = cfg.data.batch_size
    n_steps = CITY_WARMUP + CITY_STEPS
    host = synthetic_hd_batch(n_steps * bs, h, w, seed=SEED)
    batches = [{k: v[i * bs:(i + 1) * bs] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    step = build_train_step(cfg, load_vgg19(device=device), dtype)
    what = "cityscapes_spatial train"
    print(f"{what}: {h}x{w}, batch {bs}, {dtype}, resnet G ngf "
          f"{cfg.model.ngf} with {cfg.model.n_blocks} blocks, norm "
          f"{cfg.model.norm} (plain PyTorch: no kernel), {cfg.model.num_D} "
          "D scales, one device", flush=True)
    counts, med = bf16_train_run(
        what, state, step, batches, CITY_WARMUP, only(),
        ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg", "g_tv"), card,
        profile)
    peak = torch.cuda.max_memory_allocated(device)
    print(f"{what}: peak device memory {peak / 2 ** 30:.2f} GiB; median "
          f"{med:.2f} ms/step, {bs * 1e3 / med:.2f} img/s; on {card}",
          flush=True)
    del state, step
    torch.cuda.empty_cache()
    return counts


def options_lr_scale_check(cfg, step, batch, dtype) -> float:
    """One ``step`` from one fresh state at lr_scale 1 and at
    OPTIONS_LR_SCALE, cuDNN deterministic: every parameter change of G and
    D at the scale must be OPTIONS_LR_SCALE times the change at 1, within
    OPTIONS_LR_PARAM_ULPS of |p| + OPTIONS_LR_RTOL of the change. Returns
    the largest error as a share of its band; raises past 1 or when
    nothing moved."""
    from p2p_tpu_torch.train.state import create_train_state

    deltas, starts = [], None
    with cudnn_deterministic():
        for scale in (1.0, OPTIONS_LR_SCALE):
            st = create_train_state(cfg, SEED, train_dtype=dtype)
            st.lr_scale = scale
            params = [*st.net_g.parameters(), *st.net_d.parameters()]
            before = [p.detach().clone() for p in params]
            st, _ = step(st, batch)
            deltas.append([p.detach() - b for p, b in zip(params, before)])
            starts = before
            del st
    worst, moved = 0.0, False
    for p0, d1, ds in zip(starts, *deltas):
        want = OPTIONS_LR_SCALE * d1
        band = OPTIONS_LR_PARAM_ULPS * p0.abs() + OPTIONS_LR_RTOL * want.abs()
        err = (ds - want).abs()
        worst = max(worst, float((err / band.clamp_min(1e-30)).max()))
        moved = moved or bool((d1 != 0).any())
    if not moved or worst > 1.0:
        raise AssertionError(f"options: lr_scale {OPTIONS_LR_SCALE} update "
                             f"{worst:.3g} of its band from the scaled "
                             f"update at 1 (moved {moved})")
    return worst


def options_phase(device, card):
    """The trainer options at full width on ``facades`` (slice 8, d):
    ``pool_size=50``, ``ema_decay=0.999``, ``grad_clip=1.0`` and
    ``lr_policy="plateau"`` (its controller fed each step's loss_g as an
    epoch's) for OPTIONS_STEPS bf16 steps (13 #5 each), with the ring
    first filled with 50 real pairs, so that D is fed a stored pair on at
    least one step (each query is watched: its output is a slot of the
    old ring, not the incoming pair); one step from one state at lr_scale
    1 and at OPTIONS_LR_SCALE, whose parameter changes differ by that
    factor; an EMA at decay 0 bitwise G after 2 steps; a checkpoint with
    the EMA, the pool and the plateau scale restored bitwise into a state
    of another seed; and
    ``engine_from_checkpoint(..., ema_decay)`` serving, cuDNN
    deterministic, the same uint8 images as an engine built from G with the
    EMA's parameters, on one group of bodies. Returns the launch counts
    (train steps only; serving runs no kernel)."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.models.registry import define_G
    from p2p_tpu_torch.serve.engine import (InferenceEngine,
                                            engine_from_checkpoint)
    from p2p_tpu_torch.serve.io import to_host
    from p2p_tpu_torch.train.checkpoint import CheckpointManager
    from p2p_tpu_torch.train.schedules import PlateauController
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step, to_device_image
    from p2p_tpu_torch.utils import pool as pool_lib
    from p2p_tpu_torch.utils.images import to_uint8_img

    base = get_preset("facades")
    cfg = base.replace(
        optim=dataclasses.replace(base.optim, grad_clip=1.0,
                                  lr_policy="plateau"),
        train=dataclasses.replace(base.train, pool_size=50),
        health=dataclasses.replace(base.health, ema_decay=0.999))
    h, w = cfg.image_hw
    per_step = len(facades_bn_plan(cfg.model.ngf, h, w))
    host = synthetic_facades_batch(OPTIONS_STEPS, h, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(OPTIONS_STEPS)]
    dtype = train_dtype(cfg.train.mixed_precision)
    reset_launch_counts()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    step = build_train_step(cfg, None, dtype)
    pool_size = state.pool.shape[0]
    fill = synthetic_facades_batch(pool_size, h, seed=SEED + 3)
    state.pool.copy_(torch.cat(
        [to_device_image(fill[k], device, torch.float32)
         for k in ("input", "target")], dim=1).permute(0, 2, 3, 1))
    state.pool_n.fill_(pool_size)
    stored_steps = []
    query = pool_lib.device_pool_query

    def watched_query(pool, pool_n, pairs, generator):
        out, new_pool, new_n = query(pool, pool_n, pairs, generator)
        from_ring = (pool.to(out.dtype) == out[:1]).flatten(1).all(1).any()
        stored_steps.append(bool(from_ring) and not torch.equal(out, pairs))
        return out, new_pool, new_n

    plateau = PlateauController()
    with mock.patch.object(pool_lib, "device_pool_query", watched_query):
        for i, b in enumerate(batches):
            state, m = step(state, b)
            losses = {k: float(m[k]) for k in FACADES_LOSS_KEYS + (
                "nonfinite_g", "nonfinite_d", "health_ok")}
            if not all(np.isfinite(v) for v in losses.values()) \
                    or losses["health_ok"] != 1.0:
                raise AssertionError(f"options step {i + 1}: {losses}")
            state.lr_scale = plateau.update(losses["loss_g"])
            print(f"options: step {i + 1} {json.dumps(losses)}, D fed a "
                  f"stored pair {bool(stored_steps[-1])}, lr_scale "
                  f"{state.lr_scale}", flush=True)
    n_stored = sum(stored_steps)
    moved = max(float((state.ema_g[k] - p.detach()).abs().max())
                for k, p in state.net_g.named_parameters())
    if int(state.pool_n) != pool_size or n_stored == 0 \
            or len(stored_steps) != OPTIONS_STEPS or not moved > 0:
        raise AssertionError(f"options: pool_n {int(state.pool_n)}, D fed "
                             f"a stored pair on {n_stored} of "
                             f"{len(stored_steps)} steps, EMA moved {moved}")
    lr_ratio = options_lr_scale_check(cfg, step, batches[0], dtype)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ema_") as ck:
        mgr = CheckpointManager(ck)
        mgr.save(state.step, state, 1)
        fresh = create_train_state(cfg, SEED + 1, train_dtype=dtype)
        mgr.restore(fresh)
        same = (fresh.lr_scale == state.lr_scale
                and torch.equal(fresh.pool, state.pool)
                and torch.equal(fresh.pool_n, state.pool_n)
                and all(torch.equal(fresh.ema_g[k], v)
                        for k, v in state.ema_g.items())
                and all(torch.equal(a, b) for a, b in zip(
                    fresh.net_g.state_dict().values(),
                    state.net_g.state_dict().values())))
        if not same:
            raise AssertionError("options: the checkpoint did not restore "
                                 "bitwise")
        del fresh
        bodies = synthetic_facades_batch(4, h, seed=SEED + 7)["input"]
        with cudnn_deterministic():
            served, _ = engine_from_checkpoint(cfg, ck, buckets=(4,))
            want_g = define_G(cfg.model, image_hw=cfg.image_hw)
            want_g.load_state_dict({**{k: v.cpu() for k, v in
                                       state.net_g.state_dict().items()},
                                    **{k: v.cpu() for k, v in
                                       state.ema_g.items()}})
            ref = InferenceEngine(cfg, want_g, buckets=(4,))
            outs = [np.stack([to_uint8_img(img) for img in to_host(
                e.infer_batch({"input": bodies})[0])]) for e in (served, ref)]
        levels = int(np.abs(outs[0].astype(np.int16)
                            - outs[1].astype(np.int16)).max())
        if levels != 0:
            raise AssertionError(f"options: EMA serving {levels} levels off")
        del served, ref
    zero = cfg.replace(health=dataclasses.replace(cfg.health, ema_decay=0.0))
    st0 = create_train_state(zero, SEED, train_dtype=dtype)
    stp0 = build_train_step(zero, None, dtype)
    for b in batches[:2]:
        st0, _ = stp0(st0, b)
    if not all(torch.equal(st0.ema_g[k], p)
               for k, p in st0.net_g.named_parameters()):
        raise AssertionError("options: the EMA at decay 0 is not G")
    counts = launch_counts()
    want = only(batch_moments=per_step * OPTIONS_ALL_STEPS)
    print(f"options: pool 50 (filled; D fed a stored pair on {n_stored} of "
          f"{OPTIONS_STEPS} steps), EMA 0.999 (moved up to {moved:.3g} from "
          f"G), clip 1.0, plateau; the update at lr_scale "
          f"{OPTIONS_LR_SCALE} within {lr_ratio:.3g} of its band from "
          f"{OPTIONS_LR_SCALE} x the update at 1; checkpoint restored "
          f"bitwise; EMA serving "
          f"equal to the EMA weights' engine at 0 uint8 levels; EMA at "
          f"decay 0 bitwise G; launches {counts} (want {want}); on {card}",
          flush=True)
    if counts != want:
        raise AssertionError(f"options: launches {counts}")
    del state, step, st0, stp0
    torch.cuda.empty_cache()
    return counts


def unet_forms_phase(device, card):
    """The U-Net's forms at 256² (slice 8, e): one bf16 step each of
    ``upsample_mode`` subpixel and resize and ``thin_stem`` (13 #5 each),
    ``norm="instance"`` (no kernel) and ``"pallas_instance"`` (#1 + #2 at
    each of its 13 norms), finite losses, exact launches. Returns the
    launch counts."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    fac = get_preset("facades")
    counts = collections.Counter()
    for form, kw in UNET_FORMS.items():
        cfg = fac.replace(model=dataclasses.replace(fac.model, **kw))
        h, w = cfg.image_hw
        n_norms = len(facades_bn_plan(cfg.model.ngf, h, w))
        want = {"instance": only(),
                "pallas_instance": only(instance_norm_stats=n_norms,
                                        instance_norm_apply=n_norms)}.get(
            form, only(batch_moments=n_norms))
        dtype = train_dtype(cfg.train.mixed_precision)
        state = create_train_state(cfg, SEED, train_dtype=dtype)
        step = build_train_step(cfg, None, dtype)
        batch = synthetic_facades_batch(1, h, seed=SEED)
        reset_launch_counts()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = launch_counts()
        losses = {k: float(m[k]) for k in FACADES_LOSS_KEYS}
        print(f"unet forms: {form} {json.dumps(losses)}, first step "
              f"{ms:.1f} ms, launches {got} (want {want})", flush=True)
        if got != want or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"unet form {form}: {losses}, {got}")
        counts.update(got)
        del state, step
    return counts


def int8_full_config():
    """Slice 9 (a): ``facades_int8_full`` as registered."""
    from p2p_tpu_torch.core.config import get_preset

    return get_preset("facades_int8_full")


def int8_full_bn_plan(cfg):
    """(M, C) of every BatchNorm of one facades_int8_full train step at
    batch 1: the U-Net's 13 twice (the G step and the net_c branch), net_c's
    one twice (its run for G's input and the net_c branch)."""
    h, w = cfg.image_hw
    return 2 * facades_bn_plan(cfg.model.ngf, h, w) + 2 * [(h * w, 64)]


def path_a8_config():
    """Slice 9 (c): path A (``reference`` with pallas_instance norms in G
    and D) with every int8 form: G's trunk, net_c, D's spectral-norm inner
    convs fed by the quantize-fused epilogue, its stem and kn2row head, all
    with stored scales."""
    cfg = instance_config()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, int8=True, int8_delayed=True, int8_generator=True,
        int8_compression=True, int8_stem=True, int8_head=True,
        int8_fused_epilogue=True))


def path_a8_step_plan(cfg):
    """(H, W, C, form) of every instance norm of one path-A int8 train
    step: path A's, with #4 ("leaky+quant") in place of #3 before inner
    convs 2 and 3 of each scale, in the fake and the real D forward."""
    m = cfg.model
    h, w = cfg.image_hw
    return (2 * expand_norm_plan(m.ngf, m.n_blocks, h, w, m.output_nc)
            + 2 * int8_d_plan(cfg))


def hd_int8_config():
    """Slice 9 (d): ``pix2pixhd`` with its G's residual blocks (G1's trunk
    and the enhancer's) on the delayed-int8 path."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("pix2pixhd")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, int8=True, int8_delayed=True, int8_generator=True))


def exact_forms(device):
    """Every int8 form of facades_int8_full at its 256² shapes, on random
    int8 operands: the im2col + ``_int_mm`` result equal to an f64 conv (or
    product) of the same operands. The U-Net's encoder QuantConv k4 s2 p1
    and QuantSubpixelDeconv (k2 s1 p1 to 4F) at levels 1–7, D's kn2row
    head (forward, and its wgrad pad(Q(x))ᵀ·Q(pz)), net_c's k5, k3 and
    k3-s2 ConvLayers (zero padding 0 after the reflect pad). Returns the
    number of forms checked."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.int8 import conv_i32, im2col, int_mm

    cfg = int8_full_config()
    m = cfg.model
    h = cfg.image_hw[0]
    gen = torch.Generator(device=device).manual_seed(SEED)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    feats = [min(m.ngf * 2 ** i, m.ngf * 8) for i in range(8)]
    # (name, x NHWC, w HWIO, stride, padding)
    forms = [(f"down{i}", (1, h >> i, h >> i, feats[i - 1]),
              (4, 4, feats[i - 1], feats[i]), 2, 1) for i in range(1, 8)]
    forms += [(f"up{i}", (1, h >> (i + 1), h >> (i + 1),
                          feats[i] * (1 if i == 7 else 2)),
               (2, 2, feats[i] * (1 if i == 7 else 2), 4 * feats[i - 1]),
               1, 1) for i in range(1, 8)]
    # D: the head's input is inner conv 3's output (35 - 1 = 34 rows)
    d_in = d_norm_plan(m.ndf, m.n_layers_D, m.num_D, h, h)[-1]
    forms.append(("head", (1, d_in[0], d_in[1], d_in[2]), (4, 4, d_in[2], 1),
                  1, 2))
    forms += [("net_c k5", (1, h + 4, h + 4, 3), (5, 5, 3, 64), 1, 0),
              ("net_c k3", (1, h + 2, h + 2, 64), (3, 3, 64, 64), 1, 0),
              ("net_c k3-s2", (1, h + 2, h + 2, 64), (3, 3, 64, 12), 2, 0)]
    n = 0
    for name, xs, ws, s, p in forms:
        x8, w8 = i8(*xs), i8(*ws)
        y = conv_i32(x8, w8, (s, s), p)
        want = F.conv2d(x8.double().permute(0, 3, 1, 2),
                        w8.double().permute(3, 2, 0, 1), stride=s,
                        padding=p).permute(0, 2, 3, 1)
        if y.dtype != torch.int32 or not torch.equal(y.double(), want):
            raise AssertionError(f"int8 {name} forward: not exact against "
                                 "the f64 conv")
        n += 1
        if name == "head":
            # kn2row wgrad: the padded int8 input against Q(pz), pz the
            # im2col of the cotangent padded k - 1
            k = ws[0]
            gq = i8(1, y.shape[1], y.shape[2], 1)
            pz, _ = im2col(gq, (k, k), (1, 1), k - 1)
            xp = F.pad(x8, (0, 0, p, p, p, p)).reshape(-1, xs[3])
            dw = int_mm(xp.t(), pz)
            if not torch.equal(dw.double(), xp.t().double() @ pz.double()):
                raise AssertionError("int8 head kn2row wgrad: not exact "
                                     "against the f64 product")
            n += 1
    return n


def conv_transpose_check(device):
    """(e) QuantConvTranspose k4 s2 'SAME' at a U-Net decoder shape, (1,
    512, 16, 16) → 256, on integer grids where quantization is lossless:
    the forward and both gradients exactly the f64 transposed conv's (the
    int8 forward and dgrad: exact int32 products; the bf16 wgrad on x̂:
    exact products of integers, f32 sums below 2^24)."""
    from p2p_tpu_torch.ops.int8 import QuantConvTranspose

    gen = torch.Generator(device=device).manual_seed(SEED)

    def grid(shape, scale, channel_dim=None):
        v = torch.randint(-127, 128, shape, generator=gen, device=device
                          ).float()
        idx = [0] * len(shape)
        if channel_dim is not None:
            idx[channel_dim] = slice(None)
        v[tuple(idx)] = 127.0
        return v * scale

    m = QuantConvTranspose(512, 256).to(device)
    with torch.no_grad():
        m.weight.copy_(grid(tuple(m.weight.shape), 0.25, channel_dim=1))
        m.bias.zero_()
    x = grid((1, 512, 16, 16), 0.5).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    x64 = x.detach().double().requires_grad_()
    w64 = m.weight.detach().double().requires_grad_()
    with tf32_off():
        y = m(x)
        y64 = torch.nn.functional.conv_transpose2d(x64, w64, stride=2,
                                                   padding=1)
        g = grid(tuple(y.shape), 2.0)
        y.backward(g)
        y64.backward(g.double())
    for what, got, want in (("forward", y, y64), ("dgrad", x.grad, x64.grad),
                            ("wgrad", m.weight.grad, w64.grad)):
        if not torch.equal(got.double(), want):
            raise AssertionError(f"QuantConvTranspose {what}: not exact "
                                 f"({max_err(got.double(), want):.3g})")
    print(f"slice 9 (e): QuantConvTranspose (1, 512, 16, 16) -> "
          f"{tuple(y.shape)}: forward, dgrad (int8) and wgrad (bf16 on "
          "x_hat) exact against the f64 transposed conv", flush=True)


def _scales(*nets):
    """``{name: stored scale}`` of the nets' int8 modules (names prefixed
    by the net's position)."""
    return {f"{i}.{k}": v.detach().clone()
            for i, n in enumerate(nets) if n is not None
            for k, v in n.named_buffers() if k.endswith("amax_x")}


def _image_scale(name: str) -> bool:
    """A scale whose input holds an image itself: net_c's k5 stem reads
    the target, D's stem the pair with the input image, both in [-1, 1],
    whose saturated pixels keep max|x| at 1 every step."""
    rel = name.split(".", 1)[1]
    return rel == "ConvLayer_0.conv.amax_x" or (
        rel.startswith("scale") and rel.endswith("._PlainConv_0.conv.amax_x"))


def _check_scales(what, before, after, moved):
    """Every stored scale finite and positive; with ``moved`` "every" each
    moved (but those that read an image, which stay at its max 1), with
    "some" at least one, with "none" each bitwise the same."""
    if list(before) != list(after) or not after:
        raise AssertionError(f"{what}: scales {list(before)} -> "
                             f"{list(after)}")
    still, pinned, changed = [], [], []
    for k, a in before.items():
        b = after[k]
        if not bool(torch.isfinite(b)) or float(b) <= 0:
            raise AssertionError(f"{what}: stored scale {k} is {float(b)}")
        if not torch.equal(a, b):
            changed.append(k)
        elif _image_scale(k) and float(b) == 1.0:
            pinned.append(k)
        else:
            still.append(k)
    bad = {"every": still, "some": [] if changed else still,
           "none": changed}[moved]
    if bad:
        raise AssertionError(f"{what}: stored scales "
                             + ("moved" if moved == "none" else
                                "did not move") + f": {bad}")


def int8_full_phase(device, card, profile, tmp):
    """Slice 9 (a) and (b): facades_int8_full at 256², its int8 forms exact
    against f64, the f32 (TF32 off, cuDNN deterministic) one-step check
    through #5 against its plain version, I8F_STEPS bf16 steps (finite
    losses, every scale of G, D and C finite and moved, #5 as planned, ms
    per step and peak memory); then serving its checkpoint with frozen
    scales: ``engine_from_checkpoint`` against the eval step (0 uint8
    levels, cuDNN deterministic), the scales bitwise after the requests,
    ``cli.serve --once`` over a directory and ``cli.infer --metrics``."""
    from p2p_tpu_torch.cli import infer as infer_cli
    from p2p_tpu_torch.cli import serve as serve_cli
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                              synthetic_facades_batch)
    from p2p_tpu_torch.serve.engine import engine_from_checkpoint
    from p2p_tpu_torch.serve.tenancy import checkpoint_dir
    from p2p_tpu_torch.train.checkpoint import CheckpointManager
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_eval_step, build_train_step
    from p2p_tpu_torch.utils.images import to_uint8_img

    cfg = int8_full_config()
    m = cfg.model
    h, w = cfg.image_hw
    what = "slice 9 (a) facades_int8_full"
    t0 = time.perf_counter()
    n_forms = exact_forms(device)
    print(f"{what}: {n_forms} int8 forms at the preset's shapes exact "
          f"against f64 ({time.perf_counter() - t0:.1f}s)", flush=True)
    host = synthetic_facades_batch(I8F_STEPS, h, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(I8F_STEPS)]
    bn = int8_full_bn_plan(cfg)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {route: f32_route(
            cfg, batches[:I8F_F32_STEPS], None, patches, only(
                batch_moments=n * len(bn) * I8F_F32_STEPS), route)
            for route, patches, n in (
                ("kernel", (), 1), ("plain", instance_plain_patches(), 0))}
    finally:
        torch.backends.cudnn.deterministic = saved
    worst = {}
    for i, (lk, lp) in enumerate(zip(runs["kernel"], runs["plain"])):
        for k in FACADES_LOSS_KEYS + ("loss_c",):
            rel = abs(lk[k] - lp[k]) / abs(lp[k])
            worst[k] = max(worst.get(k, 0.0), rel)
    print(f"{what}: f32 (TF32 off, cuDNN deterministic) {I8F_F32_STEPS} "
          f"step through #5 vs its plain version, losses rel diff "
          f"{json.dumps(worst)} (limits {I8F_STEP1_RTOL} before the "
          f"update, {I8F_AFTER_RTOL} for loss_c, after G's)", flush=True)
    bad = [k for k, rel in worst.items() if not rel <= (
        I8F_AFTER_RTOL if k == "loss_c" else I8F_STEP1_RTOL)]
    if bad:
        raise AssertionError(f"{what}: f32 kernel vs plain {bad}: {worst}")

    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype,
                               sample_batch=batches[0])
    step = build_train_step(cfg, None, dtype)
    nets = (state.net_g, state.net_d, state.net_c)
    s0 = _scales(*nets)
    print(f"{what}: {h}x{w}, batch 1, {dtype}, ngf {m.ngf}, ndf {m.ndf}, "
          f"dropout {m.use_dropout}, Adam moments {cfg.optim.moment_dtype}, "
          f"{len(s0)} stored scales (G {len(_scales(state.net_g))}, D "
          f"{len(_scales(state.net_d))}, C {len(_scales(state.net_c))}); "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    # the profiled step comes after the scales' check: it steps again
    counts, med = bf16_train_run(
        what, state, step, batches, TRAIN_WARMUP,
        only(batch_moments=len(bn) * I8F_STEPS),
        FACADES_LOSS_KEYS + ("loss_c",), card, False)
    peak = torch.cuda.max_memory_allocated(device)
    _check_scales(what + " training", s0, _scales(*nets), moved="every")
    if profile:
        profile_call(f"{what} step", lambda: step(state, batches[0]))
    print(f"{what}: peak device memory {peak / 2 ** 30:.2f} GiB; every "
          f"stored scale of G, D and C finite, positive and moved over "
          f"{I8F_STEPS} steps", flush=True)

    # (b) frozen-scale serving of this state's checkpoint
    what = "slice 9 (b) frozen-scale serving"
    work = os.path.join(tmp, "int8_full")
    ckpt = checkpoint_dir(cfg, work)
    CheckpointManager(ckpt).save(state.step, state, epoch=1)
    eval_step = build_eval_step(cfg, dtype)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        engine, got_step = engine_from_checkpoint(cfg, ckpt, buckets=(1,),
                                                  dtype="bf16")
        served = _scales(engine.model, engine.net_c)
        levels = 0
        reset_launch_counts()
        for b in batches[:I8F_SERVE_REQUESTS]:
            pred, _, _ = engine.infer_batch(b)
            want, _ = eval_step(state, b)
            levels = max(levels, int(np.abs(
                to_uint8_img(pred[0].float().cpu().numpy()).astype(int)
                - to_uint8_img(want[0].float().cpu().numpy()).astype(int)
            ).max()))
        launched = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = saved
    _check_scales(what, served, _scales(engine.model, engine.net_c),
                  moved="none")
    trained = _scales(state.net_g, state.net_c)
    if not all(torch.equal(a, b) for a, b in zip(served.values(),
                                                 trained.values())):
        raise AssertionError(f"{what}: served scales differ from the "
                             "trained state's")
    print(f"{what}: engine_from_checkpoint step {got_step}, "
          f"{I8F_SERVE_REQUESTS} requests against the eval step: "
          f"{levels} uint8 levels apart; every stored scale of G and C "
          f"bitwise after the requests; launches {launched}", flush=True)
    if levels != 0 or any(launched.values()):
        raise AssertionError(f"{what}: {levels} levels, launches {launched}")
    del engine, state, step
    torch.cuda.empty_cache()
    data = make_synthetic_dataset(os.path.join(tmp, "int8_data"), n_train=0,
                                  n_test=2, size=h)
    req = os.path.join(tmp, "int8_requests")
    os.makedirs(req)
    for name in sorted(os.listdir(os.path.join(data, "test", "b"))):
        with open(os.path.join(data, "test", "b", name), "rb") as src, \
                open(os.path.join(req, name), "wb") as dst:
            dst.write(src.read())
    out = os.path.join(tmp, "int8_served")
    common = ["--preset", cfg.name, "--workdir", work]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_serve = serve_cli.main(common + ["--once", "--input_dir", req,
                                            "--out", out])
        rc_infer = infer_cli.main(common + ["--data_root", data,
                                            "--metrics"])
    lines = buf.getvalue().strip().splitlines()
    print("\n".join(f"{what}: cli: {line}" for line in lines[-3:]))
    n_out = len(os.listdir(out)) if os.path.isdir(out) else 0
    if rc_serve != 0 or rc_infer != 0 or n_out != len(os.listdir(req)):
        raise AssertionError(f"{what}: cli.serve exit {rc_serve} with "
                             f"{n_out} outputs, cli.infer exit {rc_infer}")
    print(f"{what}: cli.serve --once --preset {cfg.name}: exit 0, {n_out} "
          f"outputs; cli.infer --metrics: exit 0", flush=True)
    return counts, med, peak


def path_a8_phase(device, card, profile, per_step):
    """Slice 9 (c): path A with every int8 form, A8_STEPS bf16 steps with
    finite losses, #1-#5 as planned and every stored scale moved."""
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_batch
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = path_a8_config()
    h, w = cfg.image_hw
    host = synthetic_batch(A8_STEPS, h, cfg.model.quant_bits, seed=SEED,
                           width=w)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(A8_STEPS)]
    dtype = train_dtype(cfg.train.mixed_precision)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype,
                               sample_batch=batches[0])
    step = build_train_step(cfg, load_vgg19(device=device), dtype)
    nets = (state.net_g, state.net_d, state.net_c)
    s0 = _scales(*nets)
    what = "slice 9 (c) path A int8"
    print(f"{what}: reference, norm={cfg.model.norm}, norm_d="
          f"{cfg.model.norm_d}, int8 in G, C and the 3-scale spectral-norm "
          f"D (stem, fused epilogues, kn2row head), {len(s0)} stored scales; "
          f"{h}x{w}, {dtype}; built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    counts, _ = bf16_train_run(
        what, state, step, batches[:VID_KERNEL_STEPS], 1,
        only(**{k: v * A8_STEPS for k, v in per_step.items()}), LOSS_KEYS,
        card, False)
    _check_scales(what, s0, _scales(*nets), moved="some")
    if profile:
        profile_call(f"{what} step", lambda: step(state, batches[0]))
    del state, step
    torch.cuda.empty_cache()
    return counts


def hd_int8_phase(device, card, profile, per_forward):
    """Slice 9 (d): pix2pixhd with its int8 trunks at 1024x512: one bf16
    step (its scales move) and one served forward with frozen scales (bitwise
    after it), each with ``per_forward`` launches."""
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.serve.engine import InferenceEngine
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = hd_int8_config()
    h, w = cfg.image_hw
    batch = synthetic_hd_batch(1, h, w, seed=SEED)
    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.reset_peak_memory_stats(device)
    # scales set on another image than the step's, so that every one moves
    state = create_train_state(cfg, SEED, train_dtype=dtype,
                               sample_batch=synthetic_hd_batch(
                                   1, h, w, seed=SEED + 1))
    step = build_train_step(cfg, load_vgg19(device=device), dtype)
    s0 = _scales(state.net_g)
    what = "slice 9 (d) pix2pixhd int8"
    counts, _ = bf16_train_run(
        what, state, step, [batch], 0,
        only(**per_forward), HD_LOSS_KEYS, card, False)
    _check_scales(what + " training", s0, _scales(state.net_g),
                  moved="every")
    if profile:
        profile_call(f"{what} step", lambda: step(state, batch))
    peak = torch.cuda.max_memory_allocated(device)
    engine = InferenceEngine(cfg, state.net_g, buckets=(1,), dtype="bf16")
    served = _scales(engine.model)
    engine.warmup()
    reset_launch_counts()
    pred, _, _ = engine.infer_batch(batch)
    torch.cuda.synchronize()
    serve_counts = launch_counts()
    _check_scales(what + " serving", served, _scales(engine.model),
                  moved="none")
    if serve_counts != only(**per_forward) or not bool(
            torch.isfinite(pred).all()):
        raise AssertionError(f"{what} serving: launches {serve_counts}")
    print(f"{what}: {len(s0)} stored scales moved in training, bitwise in "
          f"serving (f32 in the bf16 copy); served forward launches "
          f"{serve_counts}; peak device memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    del state, step, engine
    torch.cuda.empty_cache()
    return collections.Counter(counts) + collections.Counter(serve_counts)


# ------------------------------------------------------------- slice 13
def dp_config(batch: int, f32: bool = False):
    """``edges2shoes_dp`` (the U-Net with dropout, 13 BatchNorms) at
    ``batch`` (the global batch), in f32 with ``f32``."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("edges2shoes_dp")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=batch),
        train=dataclasses.replace(cfg.train,
                                  mixed_precision=not f32 and
                                  cfg.train.mixed_precision))


def dp_cli_args(data: str, work: str, device: str = "cuda:0"):
    """``cli.train`` of the full-width ``edges2shoes_dp`` on ``data``:
    ``DP_EPOCHS`` epochs of 2 steps at the preset's global batch 64, an
    eval of the 2 test pairs (one a rank on two) each and a checkpoint at
    the end (and at a preemption), the images read in process."""
    return ["--preset", "edges2shoes_dp", "--data_root", data, "--workdir",
            work, "--device", device, "--nepoch", str(DP_EPOCHS),
            "--epochsave", str(DP_EPOCHS), "--log_every", "1",
            "--threads", "0", "--test_batch_size", "2"]


def nets_of(state):
    """G's and D's parameters and buffers, on the CPU."""
    return {f"{n}/{k}": v.detach().cpu().clone()
            for n in ("net_g", "net_d")
            for k, v in getattr(state, n).state_dict().items()}


def replica_hashes(state, skip=()) -> dict:
    """The sha256 of every parameter and buffer of the state's networks
    that each rank holds whole (``skip``: ``(net, name)`` of this rank's
    own parts, Megatron shards), by ``<net>.<name>``."""
    out = {}
    for net in ("net_g", "net_d", "net_c", "net_dt"):
        mod = getattr(state, net, None)
        if mod is None:
            continue
        for k, t in list(mod.named_parameters()) + list(mod.named_buffers()):
            if (net, k) not in skip:
                out[f"{net}.{k}"] = hashlib.sha256(
                    t.detach().reshape(-1).contiguous().view(torch.uint8)
                    .cpu().numpy()).hexdigest()
    return out


def replicas_differ(ranks, what: str, card: str, fails) -> None:
    """Print how many replicated tensors have the same bits on every rank
    (``ranks``: each rank's :func:`replica_hashes`) and add a failure when
    any differs."""
    names = set(ranks[0])
    differ = sorted(k for k in names
                    if any(r.get(k) != ranks[0][k] for r in ranks[1:]))
    print(f"{what}: after the steps (cuDNN's default mode) "
          f"{len(names) - len(differ)} of {len(names)} replicated parameters "
          f"and buffers have the same bits on all {len(ranks)} ranks; "
          f"differ: {differ[:6]}; on {card}", flush=True)
    if differ or any(set(r) != names for r in ranks[1:]):
        fails.append(f"{what}: replicated tensors differ across ranks: "
                     f"{differ[:20]}")


def counted_sync(fn):
    """``fn()`` and the #5 launches and sync-BatchNorm all-reduces (sums,
    cotangents) it made."""
    from p2p_tpu_torch.ops import norm

    before = (launch_counts()["batch_moments"], norm.sync_moments.allreduces,
              norm.sync_moments.backward_allreduces)
    out = fn()
    torch.cuda.synchronize()
    after = (launch_counts()["batch_moments"], norm.sync_moments.allreduces,
             norm.sync_moments.backward_allreduces)
    return out, tuple(a - b for a, b in zip(after, before))


@contextlib.contextmanager
def watched_parallel(seen):
    """``cli.train``'s data-parallel steps for the duration: each counted
    in ``seen["steps"]`` with its #5 launches and sync all-reduces, the
    train split's reads in ``seen["reads"]``, and after a resume whether
    the live state is bitwise the restored step (``seen["restored"]``)."""
    from p2p_tpu_torch.data import pipeline
    from p2p_tpu_torch.train import loop

    build, resume = loop.make_parallel_train_step, loop.Trainer.maybe_resume
    getitem = pipeline.PairedImageDataset.__getitem__

    def counting_build(*a, **kw):
        step = build(*a, **kw)

        def counted(state, batch):
            res, c = counted_sync(lambda: step(state, batch))
            seen["steps"] += 1
            seen["per_step"].append(c)
            seen["local_batch"] = int(batch["input"].shape[0])
            return res

        return counted

    def watched_resume(self):
        ok = resume(self)
        if ok:
            step = self.ckpt.last_restored_step
            seen["restored"].append((int(step), live_is_saved(self, step)))
        return ok

    def reading(self, idx):
        if os.path.basename(os.path.dirname(self.a_dir)) == "train":
            seen["reads"].append(int(idx))
        return getitem(self, idx)

    with mock.patch.object(loop, "make_parallel_train_step",
                           counting_build), \
            mock.patch.object(loop.Trainer, "maybe_resume", watched_resume), \
            mock.patch.object(pipeline.PairedImageDataset, "__getitem__",
                              reading):
        yield seen


def dp_cli(args, chaos=None):
    """One in-process ``cli.train`` run under :func:`watched_parallel`:
    its exit code, what it saw and its output."""
    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos

    seen = {"steps": 0, "per_step": [], "reads": [], "restored": [],
            "local_batch": None}
    buf = io.StringIO()
    install_chaos(ChaosMonkey.from_spec(chaos) if chaos else None)
    try:
        with watched_parallel(seen), contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            rc = train.main(args)
    finally:
        install_chaos(None)
    seen["rc"] = rc
    seen["out"] = buf.getvalue()[-3000:]
    return seen


def bn_f64_grad(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """dx of Σ BatchNorm(x)·g in f64 on the CPU (batch statistics)."""
    xd = x.detach().cpu().double().requires_grad_(True)
    mean = xd.mean(dim=(0, 2, 3), keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    y = ((xd - mean) / torch.sqrt(var + eps)
         * scale.detach().cpu().double().view(1, -1, 1, 1)
         + bias.detach().cpu().double().view(1, -1, 1, 1))
    (y * g.cpu().double()).sum().backward()
    return xd.grad


def worker_note(what: str) -> None:
    """A rank's progress line (the phase prints a failed rank's output)."""
    print(f"worker: {what} at {time.strftime('%H:%M:%S')}", flush=True)


def gloo2_worker(rank: int, out: str, tmp: str) -> dict:
    """Two ranks on the one card through gloo: (b) one f32 data-parallel
    step at the global batch against the one-rank step (rank 0), ``fsdp=2``
    against ``data=2``, the sync-BatchNorm backward against f64; (c) the
    ``elastic@DP_STOP`` preemption of ``cli.train`` at 2 ranks."""
    import torch.distributed as dist

    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec, mesh_context
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments_plain
    from p2p_tpu_torch.parallel import (full_params, make_parallel_train_step,
                                        place_state, shard_batch)
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    res = {}
    cfg = dp_config(DP_GLOBAL_BATCH, f32=True)
    batch = e2s_batches(cfg, 1, SEED)[0]
    with tf32_off(), cudnn_deterministic():
        # the one-rank step at the global batch, through #5 on rank 0 and
        # #5's plain version on rank 1 (its distance from the first is the
        # spread the band is set from)
        route = ("kernel", "plain")[rank]
        st = create_train_state(cfg, SEED)
        start = nets_of(st)
        with (mock.patch.object(norm, "batch_moments", batch_moments_plain)
              if route == "plain" else contextlib.nullcontext()):
            _, m = build_train_step(cfg)(st, batch)
        torch.save(({k: float(m[k]) for k in FACADES_LOSS_KEYS},
                    nets_of(st)), f"{out}.route.{route}")
        del st
        torch.cuda.empty_cache()
        dist.barrier()
        worker_note("(b) one-rank routes done")
        dp = {}
        for name, spec in (("data", MeshSpec(data=-1)),
                           ("fsdp", MeshSpec(data=1, fsdp=2))):
            mesh = Mesh(spec)
            st = create_train_state(cfg, SEED)
            place_state(st, mesh)
            step = make_parallel_train_step(cfg, mesh)
            # the step's metrics are the global batch's (their mean over
            # the ranks)
            (_, m), c = counted_sync(lambda: step(st, shard_batch(batch,
                                                                  mesh)))
            with full_params(st):
                nets = nets_of(st)
            opt = {i: {k: v.cpu() for k, v in s.items()
                       if torch.is_tensor(v)}
                   for i, s in st.opt_g[0].state_dict()["state"].items()}
            dp[name] = ({k: float(m[k]) for k in FACADES_LOSS_KEYS}, nets,
                        opt, c, {k: float(v) for k, v in m.items()})
            del st, step
            torch.cuda.empty_cache()
        res["counts"] = {k: v[3] for k, v in dp.items()}
        res["fsdp_bitwise"] = (
            dp["fsdp"][4] == dp["data"][4]
            and all(torch.equal(dp["fsdp"][1][k], v)
                    for k, v in dp["data"][1].items())
            and all(torch.equal(dp["fsdp"][2][i][k], v)
                    for i, s in dp["data"][2].items() for k, v in s.items()))
        if rank == 0:
            one_l, one_n = torch.load(f"{out}.route.kernel",
                                      weights_only=False)
            plain_n = torch.load(f"{out}.route.plain", weights_only=False)[1]

            def update_dist(a, b):
                worst = 0.0
                for k, v in b.items():
                    if not v.is_floating_point() or k.endswith(
                            ("mean", "var")):
                        continue
                    upd = float((v - start[k]).norm())
                    if upd > 0:
                        worst = max(worst, float((a[k] - v).norm()) / upd)
                return worst

            res["loss_rel"] = max(abs(dp["data"][0][k] - one_l[k])
                                  / abs(one_l[k]) for k in one_l)
            res["spread_update"] = update_dist(plain_n, one_n)
            res["dp_update"] = update_dist(dp["data"][1], one_n)
            res["dp_max_abs"] = max(float((dp["data"][1][k] - v).abs().max())
                                    for k, v in one_n.items()
                                    if v.is_floating_point())
        worker_note("(b) data=2 and fsdp=2 steps done")
        # the sync-BatchNorm backward at the U-Net's first decoder-sized
        # BatchNorm shape, channels_last, against f64 on the CPU
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        n, c, h, w = DP_GLOBAL_BATCH, 64, 128, 128
        mean = torch.linspace(-2.0, 2.0, c, device="cuda").view(1, c, 1, 1)
        x = (torch.randn((n, c, h, w), generator=gen, device="cuda") * 1.5
             + mean).contiguous(memory_format=torch.channels_last)
        g = torch.randn((n, c, h, w), generator=gen, device="cuda"
                        ).contiguous(memory_format=torch.channels_last)
        rows = slice(rank * n // 2, (rank + 1) * n // 2)
        mesh = Mesh(MeshSpec(data=-1))
        dxs = []
        for _ in range(2):
            # a fresh module each time: the forward moves its running mean,
            # which is the next forward's shift
            bn = norm.BatchNorm(c).cuda()
            with torch.no_grad():
                bn.scale.copy_(torch.linspace(0.5, 1.5, c))
            xr = x[rows].clone().requires_grad_(True)
            with mesh_context(mesh):
                (bn(xr) * g[rows]).sum().backward()
            dxs.append(xr.grad.detach().cpu())
        mine = dxs[0].contiguous()
        parts = [torch.empty_like(mine) for _ in range(2)]
        dist.all_gather(parts, mine)
        res["bn_same_bits"] = bool(torch.equal(dxs[0], dxs[1]))
        if rank == 0:
            want = bn_f64_grad(x, g, bn.scale.detach(), bn.bias.detach())
            got = torch.cat(parts).double()
            res["bn_err_of_max"] = float((got - want).abs().max()
                                         / want.abs().max())
    worker_note("(b) sync-BatchNorm backward done")
    # (b) the replicas after DP_HASH_STEPS bf16 steps in cuDNN's default
    # mode
    cfg = dp_config(DP_GLOBAL_BATCH)
    mesh = Mesh(MeshSpec(data=-1))
    st = create_train_state(cfg, SEED, train_dtype=torch.bfloat16)
    place_state(st, mesh)
    step = make_parallel_train_step(cfg, mesh, None, torch.bfloat16)
    for b in e2s_batches(cfg, DP_HASH_STEPS, SEED + 5):
        st, _ = step(st, shard_batch(b, mesh))
    torch.cuda.synchronize()
    res["replicated"] = replica_hashes(st)
    del st, step
    torch.cuda.empty_cache()
    worker_note("(b) replica hashes done")
    # (c) two ranks preempted at step DP_STOP
    reset_launch_counts()
    seen = dp_cli(dp_cli_args(os.path.join(tmp, "e2s"),
                              os.path.join(tmp, "work_c"))
                  + ["--mesh", "data=-1"], chaos=f"elastic@{DP_STOP}")
    res["elastic"] = {k: seen[k] for k in ("rc", "steps", "per_step",
                                           "reads", "local_batch", "out")}
    res["launches"] = launch_counts()
    return res


def nccl1_worker(rank: int, out: str, tmp: str) -> dict:
    """One rank through NCCL: (a) the full-width ``edges2shoes_dp`` step
    at batch 64 with the process group against the step without it
    (bitwise, cuDNN deterministic), its ms/step, then ``cli.train`` for
    ``DP_EPOCHS`` epochs; (c) the relaunch of (c)'s preempted run at
    world size 1 and, from a copy, at global batch ``DP_REBASE_BATCH``."""
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.parallel import make_parallel_train_step, place_state
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    res = {}
    cfg = dp_config(64)
    dtype = train_dtype(cfg.train.mixed_precision)
    batches = e2s_batches(cfg, 2 + DP_TIMED, SEED)
    mesh = Mesh(MeshSpec(data=-1))
    reset_launch_counts()
    with cudnn_deterministic():
        plain = create_train_state(cfg, SEED, train_dtype=dtype)
        p_step = build_train_step(cfg, None, dtype)
        p_losses = [{k: float(v) for k, v in p_step(plain, b)[1].items()}
                    for b in batches[:2]]
        p_nets = nets_of(plain)
        p_opt = {i: {k: v.cpu() for k, v in s.items() if torch.is_tensor(v)}
                 for i, s in plain.opt_g[0].state_dict()["state"].items()}
        del plain, p_step
        torch.cuda.empty_cache()
        st = create_train_state(cfg, SEED, train_dtype=dtype)
        place_state(st, mesh)
        step = make_parallel_train_step(cfg, mesh, None, dtype)
        d_losses, per_step = [], []
        for b in batches[:2]:
            (_, m), c = counted_sync(lambda: step(st, b))
            d_losses.append({k: float(v) for k, v in m.items()})
            per_step.append(c)
    res["bitwise"] = (
        d_losses == p_losses
        and all(torch.equal(v, p_nets[k]) for k, v in nets_of(st).items())
        and all(torch.equal(v.cpu(), p_opt[i][k]) for i, s in
                st.opt_g[0].state_dict()["state"].items()
                for k, v in s.items() if torch.is_tensor(v)))
    times = []
    for b in batches[2:]:
        t = time.perf_counter()
        _, c = counted_sync(lambda: step(st, b))
        times.append((time.perf_counter() - t) * 1e3)
        per_step.append(c)
    res["per_step"] = per_step
    res["ms"] = times
    worker_note("(a) bitwise and timed steps done")
    del st, step
    torch.cuda.empty_cache()
    res["direct_launches"] = launch_counts()
    # (a) through cli.train
    reset_launch_counts()
    seen = dp_cli(dp_cli_args(os.path.join(tmp, "e2s"),
                              os.path.join(tmp, "work_a"))
                  + ["--mesh", "data=-1"])
    res["cli"] = {k: seen[k] for k in ("rc", "steps", "per_step",
                                       "local_batch", "out")}
    res["cli"]["launches"] = launch_counts()
    worker_note("(a) cli.train done")
    # (c) the relaunch at world size 1, and at another global batch
    for name, extra in (("reshard", []),
                        ("rebase", ["--batch_size", str(DP_REBASE_BATCH)])):
        work = os.path.join(tmp, "work_c" if name == "reshard"
                            else "work_rebase")
        reset_launch_counts()
        seen = dp_cli(dp_cli_args(os.path.join(tmp, "e2s"), work)
                      + ["--mesh", "data=-1"] + extra)
        res[name] = {k: seen[k] for k in ("rc", "steps", "per_step", "reads",
                                          "restored", "local_batch", "out")}
        res[name]["launches"] = launch_counts()
        res[name]["records"] = [
            r for r in read_records(os.path.join(
                work, "metrics_edges2shoes_dp.jsonl"))
            if r["kind"] in ("elastic_resume", "resharded_restore",
                             "batch_rebase", "resume")]
    return res


def dp_worker(name: str, out: str, tmp: str) -> int:
    """A rank of the slice-13 phase, started by ``torchrun``: forms its
    group (``gloo2``: gloo, both ranks on cuda:0; ``nccl1``: NCCL, one
    rank), runs its part and writes it to ``out.<rank>``."""
    import torch.distributed as dist

    from p2p_tpu_torch.core.mesh import distributed_init

    torch.cuda.set_device(0)
    if name in ("gloo2", "spatial2", "time4", "tp2", "pp3", "tp8"):
        dist.init_process_group("gloo", init_method="env://")
    else:
        distributed_init(torch.device("cuda", 0))
    rank = dist.get_rank()
    try:
        fn = {"gloo2": gloo2_worker, "nccl1": nccl1_worker,
              "spatial2": spatial2_worker, "time4": time4_worker,
              "tp2": tp2_worker, "pp3": pp3_worker,
              "tp8": tp8_worker}[name]
        res = fn(rank, out, tmp)
        torch.save(res, f"{out}.{rank}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def torchrun(name: str, n: int, tmp: str, timeout: float = 600):
    """``chip_smoke.py --worker name`` on ``n`` ranks under ``torchrun``;
    every rank's result."""
    out = os.path.join(tmp, name)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__),
           "--worker", name, out, tmp]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"torchrun {name}: exit {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-20000:]}")
    print(f"torchrun --nproc_per_node {n} ({name}): "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(n)]


def remat_plan(cfg):
    """#1 and #3 launches a ``pix2pixhd`` train step per remat mode: the
    36 epilogues of the forward, then the recompute of the residual
    blocks' 2 epilogues each (9 global + 3 local blocks): "full" both
    kernels again, "conv" #3 only (#1's statistics are kept)."""
    n_blocks = cfg.model.n_blocks + 3
    extra = 2 * n_blocks
    return {False: (NORMS_PER_FORWARD, NORMS_PER_FORWARD),
            "full": (NORMS_PER_FORWARD + extra, NORMS_PER_FORWARD + extra),
            "conv": (NORMS_PER_FORWARD, NORMS_PER_FORWARD + extra)}


def set_remat(net, mode) -> int:
    """Switch every residual block of ``net`` to ``mode``; how many."""
    blocks = [m for m in net.modules() if hasattr(m, "remat")]
    for m in blocks:
        m.remat = mode
    return len(blocks)


def remat_phase(device, card):
    """(d) ``pix2pixhd`` at 1024×512 with remat off, "full" and "conv":
    peak memory, ms/step and the #1/#3 launches a bf16 step (the recompute
    plan); one f32 step (TF32 off, cuDNN deterministic) bitwise the
    no-remat step. Returns the launch counts and the per-mode steps."""
    import copy

    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    plan = remat_plan(cfg)
    host = synthetic_hd_batch(REMAT_STEPS, h, w, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(REMAT_STEPS)]
    vgg = load_vgg19(device=device)
    dtype = train_dtype(cfg.train.mixed_precision)
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    step = build_train_step(cfg, vgg, dtype)
    counts = collections.Counter()
    out = {}
    for mode in REMAT_MODES:
        n = set_remat(state.net_g, mode)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        times = []
        for b in batches:
            t = time.perf_counter()
            _, m = step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if not np.isfinite(float(m["loss_g"])):
                raise AssertionError(f"remat {mode}: non-finite loss")
        got = launch_counts()
        want = only(instance_norm_stats=plan[mode][0] * len(batches),
                    norm_act=plan[mode][1] * len(batches))
        if got != want:
            raise AssertionError(f"remat {mode}: launches {got}, want {want}")
        counts.update(got)
        out[mode] = (torch.cuda.max_memory_allocated(device),
                     statistics.median(times[1:]))
        print(f"slice 13 (d): pix2pixhd {h}x{w} bf16, remat {mode!r} on "
              f"{n} blocks: peak {out[mode][0] / 2 ** 30:.3f} GiB, median "
              f"{out[mode][1]:.2f} ms/step ({times[1:]}), #1 "
              f"{plan[mode][0]} and #3 {plan[mode][1]} a step as planned; "
              f"on {card}", flush=True)
    set_remat(state.net_g, False)
    del state, step
    torch.cuda.empty_cache()
    peaks = [out[m][0] for m in REMAT_MODES]
    if not peaks[0] > peaks[2] > peaks[1]:
        raise AssertionError(f"remat peaks off/full/conv {peaks}: want "
                             "off > conv > full")
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    nets = {}
    with tf32_off(), cudnn_deterministic(), warnings.catch_warnings():
        # a deep copy of an optimizer its scheduler wrapped: the copy's
        # step counts as unwrapped to LambdaLR's check (its warning only)
        warnings.simplefilter("ignore", UserWarning)
        base = create_train_state(cfg32, SEED)
        step32 = build_train_step(cfg32, vgg)
        for mode in REMAT_MODES:
            st = copy.deepcopy(base)
            set_remat(st.net_g, mode)
            _, m = step32(st, batches[0])
            nets[mode] = ({k: float(v) for k, v in m.items()}, nets_of(st))
            del st
            torch.cuda.empty_cache()
    for mode in REMAT_MODES[1:]:
        same = nets[mode][0] == nets[False][0] and all(
            torch.equal(v, nets[False][1][k]) for k, v in
            nets[mode][1].items())
        if not same:
            raise AssertionError(f"remat {mode!r}: the f32 step is not "
                                 "bitwise the no-remat step")
    print("slice 13 (d): one f32 step (TF32 off, cuDNN deterministic) with "
          "remat 'full' and 'conv' bitwise the no-remat step (losses, G "
          "and D)", flush=True)
    del base, step32, vgg
    torch.cuda.empty_cache()
    return counts, {m: len(batches) for m in REMAT_MODES}


def dp_phase(device, card, tmp: str, e2s_med: float):
    """Slice 13 (phase 17), data parallel: (a) NCCL at world size 1, (b)
    two gloo ranks on the card, (c) elastic, (d) remat (module
    docstring). Returns the main path's launch counts, the #5 launches
    by local batch and the remat steps by mode."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.data.synthetic import make_synthetic_dataset

    t_phase = time.perf_counter()
    data = make_synthetic_dataset(os.path.join(tmp, "e2s"),
                                  n_train=DP_E2S_PAIRS[0],
                                  n_test=DP_E2S_PAIRS[1], size=256,
                                  seed=SEED)
    counts = collections.Counter()
    moments_by_batch = collections.Counter()
    fails = []
    g2 = torchrun("gloo2", 2, tmp)
    r0 = g2[0]
    per_bn = 13
    for r in g2:
        for name, c in r["counts"].items():
            if c != (per_bn, per_bn, per_bn):
                fails.append(f"(b) {name}: #5 / all-reduces {c}")
            moments_by_batch[DP_GLOBAL_BATCH // 2] += c[0]
            counts["batch_moments"] += c[0]
    band = band_of(r0["spread_update"])
    print(f"slice 13 (b): 2 gloo ranks on one card, f32 (TF32 off, cuDNN "
          f"deterministic), global batch {DP_GLOBAL_BATCH} of 256², "
          f"dropout on: losses vs the one-rank step max rel "
          f"{r0['loss_rel']:.3g} (band E2S_STEP1_RTOL {E2S_STEP1_RTOL}); "
          f"each tensor's distance over its update {r0['dp_update']:.3g} "
          f"(band {band:.3g} = band_of the one-rank kernel-vs-plain "
          f"spread {r0['spread_update']:.3g}), max abs "
          f"{r0['dp_max_abs']:.3g}; fsdp=2 bitwise data=2: "
          f"{[r['fsdp_bitwise'] for r in g2]}; sync-BatchNorm backward vs "
          f"f64 {r0['bn_err_of_max']:.3g} of the largest |dx| (limit "
          f"{DP_BN_TOL_OF_MAX}), same bits twice "
          f"{[r['bn_same_bits'] for r in g2]}; on {card}", flush=True)
    if not r0["loss_rel"] <= E2S_STEP1_RTOL:
        fails.append(f"(b) losses {r0['loss_rel']}")
    if not r0["dp_update"] <= band:
        fails.append(f"(b) update distance {r0['dp_update']} > {band}")
    if not all(r["fsdp_bitwise"] for r in g2):
        fails.append("(b) fsdp=2 is not bitwise data=2")
    if not r0["bn_err_of_max"] <= DP_BN_TOL_OF_MAX \
            or not all(r["bn_same_bits"] for r in g2):
        fails.append("(b) sync-BatchNorm backward")
    replicas_differ([r["replicated"] for r in g2],
                    f"slice 13 (b): edges2shoes_dp bf16 on data=2, "
                    f"{DP_HASH_STEPS} steps at global batch "
                    f"{DP_GLOBAL_BATCH}", card, fails)
    # (c) the preempted two-rank run: both exit 75 after DP_STOP steps
    local = None
    for r in g2:
        e = r["elastic"]
        local = e["local_batch"]
        if e["rc"] != 75 or e["steps"] != DP_STOP or any(
                c != (per_bn, per_bn, per_bn) for c in e["per_step"]):
            fails.append(f"(c) rank exit {e['rc']}, {e['steps']} steps, "
                         f"{e['per_step']}:\n{e['out']}")
        moments_by_batch[local] += sum(c[0] for c in e["per_step"])
        counts.update(r["launches"])
    # copies of the preempted run for the batch relaunch and --no-elastic
    shutil.copytree(os.path.join(tmp, "work_c"),
                    os.path.join(tmp, "work_rebase"))
    shutil.copytree(os.path.join(tmp, "work_c"),
                    os.path.join(tmp, "work_strict"))
    strict = dp_cli(dp_cli_args(data, os.path.join(tmp, "work_strict"),
                                "cuda") + ["--no-elastic"])
    if strict["rc"] != 2 or "topology changed with elastic resume " \
            "disabled" not in strict["out"]:
        fails.append(f"(c) --no-elastic: exit {strict['rc']}\n"
                     f"{strict['out']}")
    (n1,) = torchrun("nccl1", 1, tmp)
    # (a)
    ms = statistics.median(n1["ms"])
    print(f"slice 13 (a): NCCL at world size 1, edges2shoes_dp batch 64 "
          f"bf16: 2 steps with the process group bitwise the steps without "
          f"it (cuDNN deterministic): {n1['bitwise']}; #5 / sum all-reduces "
          f"/ cotangent all-reduces a step "
          f"{sorted(set(map(tuple, n1['per_step'])))}; "
          f"median {ms:.2f} ms/step ({n1['ms']}) against {e2s_med:.2f} "
          f"without a group (phase 12); cli.train --mesh data=-1: exit "
          f"{n1['cli']['rc']}, {n1['cli']['steps']} steps; on {card}",
          flush=True)
    if not n1["bitwise"]:
        fails.append("(a) the NCCL step is not bitwise the plain step")
    for c in n1["per_step"] + n1["cli"]["per_step"]:
        if tuple(c) != (per_bn, per_bn, per_bn):
            fails.append(f"(a) #5 / all-reduces a step {c}")
    if n1["cli"]["rc"] != 0 or n1["cli"]["steps"] != \
            DP_EPOCHS * DP_E2S_PAIRS[0] // 64:
        fails.append(f"(a) cli.train: {n1['cli']}")
    # the plain route's 2 steps and the process group's are main-path
    # launches at batch 64
    moments_by_batch[64] += n1["direct_launches"]["batch_moments"]
    counts.update(n1["direct_launches"])
    counts.update(n1["cli"]["launches"])
    moments_by_batch[64] += n1["cli"]["launches"]["batch_moments"]
    # (c) the relaunches
    rs, rb = n1["reshard"], n1["rebase"]
    kinds = {r["kind"]: r for r in rs["records"]}
    if rs["rc"] != 0 or kinds.get("elastic_resume", {}).get(
            "decision") != "reshard" or rs["restored"] != [(DP_STOP, True)]:
        fails.append(f"(c) reshard relaunch: {rs}")
    if rb["rc"] != 0 or "batch_rebase" not in {r["kind"]
                                               for r in rb["records"]}:
        fails.append(f"(c) batch relaunch: {rb}")
    for r in (rs, rb):
        counts.update(r["launches"])
        moments_by_batch[r["local_batch"]] += r["launches"]["batch_moments"]
    # gapless: the uninterrupted run's epochs from the loader's arithmetic;
    # each rank's consumed reads are its first DP_STOP batches (the card's
    # loader reads one batch ahead)
    seed = get_preset("edges2shoes_dp").train.seed
    n = DP_E2S_PAIRS[0]
    perms = {}
    for e in (1, 2):
        idx = np.arange(n)
        np.random.default_rng(seed + e).shuffle(idx)
        perms[e] = [int(i) for i in idx]
    spe = n // 64
    e1 = sorted(v for r in g2 for v in r["elastic"]["reads"][:spe * local])
    e2 = sorted(v for r in g2 for v in r["elastic"]["reads"][
        spe * local:DP_STOP * local])
    rest = rs["reads"][:(2 * spe - DP_STOP) * 64]
    gapless = (e1 == sorted(perms[1]) and e2 == sorted(perms[2][:64])
               and rest == perms[2][64:])
    print(f"slice 13 (c): elastic@{DP_STOP} at 2 gloo ranks: exits "
          f"{[r['elastic']['rc'] for r in g2]}; relaunch at world size 1 "
          f"(NCCL): {kinds.get('elastic_resume', {}).get('decision')}, "
          f"restored {rs['restored']} (step, live state bitwise the "
          f"manifest), {rs['steps']} steps, exit {rs['rc']}; the two runs "
          f"read the uninterrupted run's samples, none twice, none "
          f"missing: {gapless}; relaunch at global batch "
          f"{DP_REBASE_BATCH}: batch_rebase, {rb['steps']} steps, exit "
          f"{rb['rc']}; --no-elastic: exit {strict['rc']}", flush=True)
    if not gapless:
        fails.append(f"(c) not gapless: {e1} {e2} {rest}")
    # (d)
    remat_counts, remat_steps = remat_phase(device, card)
    counts.update(remat_counts)
    secs = time.perf_counter() - t_phase
    print(f"slice 13: phase 17 took {secs:.1f} s; on {card}", flush=True)
    if fails:
        raise AssertionError("slice 13: " + "; ".join(fails))
    return counts, moments_by_batch, remat_steps


def add_dp_launches(rows, moments_by_batch, remat_steps, plan) -> None:
    """Add phase 17's launches to the bf16 rows that weight the
    ``kernels`` line: #5 at the U-Net's BatchNorm shapes at each local
    batch (13 a step), #1 and #3 at pix2pixHD's epilogues per the remat
    plan."""
    by_key = {(r["kernel"], r["n"], tuple(r["shape"]), r["form"]): r
              for r in rows if r["dtype"] == "bfloat16"}
    for batch, launches in moments_by_batch.items():
        shapes = [(batch * m, c) for m, c in facades_bn_plan(64, 256, 256)]
        if launches % len(shapes):
            raise AssertionError(f"#5 at batch {batch}: {launches} launches")
        for shape in shapes:
            by_key[("batch_moments", 1, shape, "-")]["launches"] += \
                launches // len(shapes)
    blocks = {i for i, (_, _, _, act, res) in enumerate(plan)
              if res or (i + 1 < len(plan) and plan[i + 1][4])}
    for mode, steps in remat_steps.items():
        for i, (h, w, c, act, res) in enumerate(plan):
            again = i in blocks and mode in ("full", "conv")
            by_key[("instance_norm_stats", 1, (h, w, c), "-")][
                "launches"] += steps * (1 + (again and mode == "full"))
            by_key[("norm_act", 1, (h, w, c), form_of(act, res))][
                "launches"] += steps * (1 + again)


# ------------------------------------------------------------- slice 13b
def spatial_config(name: str, f32: bool = False):
    """The preset ``name`` (``pix2pixhd`` or ``cityscapes_spatial``) at full
    width on its own mesh ``data=-1, spatial=2``; in f32 with ``f32``."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset(name)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, mixed_precision=not f32 and cfg.train.mixed_precision))


def spatial_counts():
    """The sums entry, the finalize, #1, #3, the statistics all-reduces
    (forward, backward) and the halo exchanges by route (calls, bytes)
    so far."""
    from p2p_tpu_torch.ops import instance_norm as inorm
    from p2p_tpu_torch.parallel.halo import halo_stats

    c = launch_counts()
    return (c["instance_norm_sums"], c["instance_norm_finalize"],
            c["instance_norm_stats"], c["norm_act"],
            inorm.sharded_stats.allreduces,
            inorm.sharded_stats.backward_allreduces,
            halo_stats["slot"]["calls"], halo_stats["slot"]["bytes"],
            halo_stats["p2p"]["calls"], halo_stats["p2p"]["bytes"])


def spatial_step_run(cfg, mesh, batches, vgg, dtype):
    """The spatial step of ``cfg`` on ``mesh`` over ``batches`` (global
    host batches) from a fresh state at SEED: per step its metrics,
    ms and :func:`spatial_counts` delta; then the final state."""
    from p2p_tpu_torch.parallel import (make_parallel_train_step,
                                        place_state, shard_batch)
    from p2p_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, SEED, train_dtype=dtype)
    place_state(state, mesh)
    step = make_parallel_train_step(cfg, mesh, vgg, dtype)
    out = []
    for b in batches:
        local = shard_batch(b, mesh)
        torch.cuda.synchronize()
        before = spatial_counts()
        t = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        out.append(({k: float(v) for k, v in m.items()}, ms,
                    tuple(a - b for a, b in zip(spatial_counts(), before))))
    return out, state


def spatial_ops_check(mesh, device) -> dict:
    """(d): the halo exchange's backward and each sharded windowed op's
    input gradient on the card in channels_last (f32, TF32 off, cuDNN
    deterministic), on an uneven map (129 rows: 64 and 65), gathered
    against f64 on the CPU (rank 0) and the same bits twice."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from p2p_tpu_torch.core.mesh import mesh_context, row_block, set_rows
    from p2p_tpu_torch.models.patchgan import avg_pool_downsample
    from p2p_tpu_torch.parallel.halo import halo_exchange
    from p2p_tpu_torch.parallel.spatial import (conv_rows, gather_rows,
                                                max_pool_rows, spatial_ring,
                                                upsample_rows)

    n, c, h, w = SP_OPS_SHAPE
    g = torch.Generator().manual_seed(SEED + 11)
    x = torch.randn((n, c, h, w), generator=g)
    wt = torch.randn((c, c, 7, 7), generator=g) * 0.05
    a, b = row_block(h, mesh.spatial, mesh.spatial_rank)

    def k(kk):
        return wt[:, :, :kk, :kk].contiguous()

    forms = {
        "halo_reflect": (lambda t, W: halo_exchange(
            t, 2, 3, spatial_ring(mesh).group, "reflect"),
            lambda t: F.pad(t, (0, 0, 3, 3), mode="reflect"), None),
        "conv_k3s1": (lambda t, W: conv_rows(t, W, None, 1, 1, "reflect"),
                      lambda t: F.conv2d(F.pad(t, (1,) * 4, mode="reflect"),
                                         k(3).double()), 3),
        "conv_k7s1": (lambda t, W: conv_rows(t, W, None, 1, 3, "reflect"),
                      lambda t: F.conv2d(F.pad(t, (3,) * 4, mode="reflect"),
                                         k(7).double()), 7),
        "conv_k3s2": (lambda t, W: conv_rows(t, W, None, 2, 1, "reflect"),
                      lambda t: F.conv2d(F.pad(t, (1,) * 4, mode="reflect"),
                                         k(3).double(), stride=2), 3),
        "upconv_k3": (lambda t, W: conv_rows(upsample_rows(t, 2), W, None,
                                             1, 1, "reflect"),
                      lambda t: F.conv2d(F.pad(F.interpolate(
                          t, scale_factor=2, mode="nearest"), (1,) * 4,
                          mode="reflect"), k(3).double()), 3),
        "d_k4s2": (lambda t, W: conv_rows(t, W, None, 2, 2, "zero"),
                   lambda t: F.conv2d(t, k(4).double(), stride=2,
                                      padding=2), 4),
        "d_k4s1": (lambda t, W: conv_rows(t, W, None, 1, 2, "zero"),
                   lambda t: F.conv2d(t, k(4).double(), padding=2), 4),
        "avg_pool": (lambda t, W: avg_pool_downsample(t),
                     lambda t: F.avg_pool2d(t, 3, 2, 1,
                                            count_include_pad=False), None),
        "vgg_k3_pool": (lambda t, W: max_pool_rows(conv_rows(
            t, W, None, 1, 1, "zero")),
            lambda t: F.max_pool2d(F.conv2d(t, k(3).double(), padding=1), 2,
                                   2), 3),
    }
    res = {}
    with tf32_off(), cudnn_deterministic():
        for name, (sharded, whole, kk) in forms.items():
            W = None if kk is None else k(kk).to(device)
            dxs = []
            for _ in range(2):
                xl = set_rows(x[:, :, a:b].to(device).contiguous(
                    memory_format=torch.channels_last).requires_grad_(True),
                    h)
                with mesh_context(mesh):
                    y = sharded(xl, W)
                    hy = getattr(y, "p2p_rows", None)
                    gen = torch.Generator().manual_seed(SEED + 12)
                    if hy is None:
                        # the exchange: this rank's window of the rank-
                        # ordered windows (its rows and 3 more each side)
                        cot = torch.randn((n, c, h + 6 * mesh.spatial, w),
                                          generator=gen)
                        start = a + 6 * mesh.spatial_rank
                        cot_local = cot[:, :, start:start + b - a + 6]
                    else:
                        oa, oz = row_block(hy, mesh.spatial,
                                           mesh.spatial_rank)
                        cot = torch.randn((n, y.shape[1], hy, y.shape[3]),
                                          generator=gen)
                        cot_local = cot[:, :, oa:oz]
                    (y * cot_local.to(device)).sum().backward()
                    dxs.append(set_rows(xl.grad.detach().contiguous(), h))
            same = bool(torch.equal(dxs[0], dxs[1]))
            with mesh_context(mesh):
                full = gather_rows(dxs[0], mesh).cpu().double()
            if hy is None:
                # the exchange's adjoint: the windows of the padded whole
                # tensor, in rank order
                z = x.double().requires_grad_(True)
                pad = whole(z)
                wins = torch.cat([pad[:, :, r0:r1 + 6] for r0, r1 in (
                    row_block(h, mesh.spatial, r)
                    for r in range(mesh.spatial))], dim=2)
                (wins * cot.double()).sum().backward()
            else:
                z = x.double().requires_grad_(True)
                (whole(z) * cot.double()).sum().backward()
            err = float((full - z.grad).abs().max() / z.grad.abs().max())
            res[name] = (err, same)
    dist.barrier()
    return res


def spatial2_worker(rank: int, out: str, tmp: str) -> dict:
    """Two ranks on the one card through gloo, H split over them (phase
    18): (a) ``pix2pixhd`` at 1024×512 bf16 on its own mesh; (b) f32 steps
    of ``cityscapes_spatial`` and ``pix2pixhd`` against the one-rank step
    on the same global batch; (d) the exchanges' and windowed ops'
    gradients against f64; (e) ``cli.train --mesh 1,2,1`` and its
    ``elastic@SP_CLI_STOP`` preemption."""
    from unittest import mock

    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.parallel.halo import reset_halo_stats
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    device = torch.device("cuda", 0)
    res = {}
    mesh = Mesh(MeshSpec(data=-1, spatial=2))
    vgg = load_vgg19(device=device)
    # (a) pix2pixHD bf16 on the preset's mesh
    cfg = spatial_config("pix2pixhd")
    h, w = cfg.image_hw
    dtype = train_dtype(cfg.train.mixed_precision)
    host = synthetic_hd_batch(SP_WARMUP + SP_TIMED, h, w, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(SP_WARMUP + SP_TIMED)]
    reset_launch_counts()
    reset_halo_stats()
    torch.cuda.reset_peak_memory_stats(device)
    runs, state = spatial_step_run(cfg, mesh, batches, vgg, dtype)
    res["a"] = {"steps": [(m, ms, c) for m, ms, c in runs],
                "peak": torch.cuda.max_memory_allocated(device),
                "launches": launch_counts(),
                "replicated": replica_hashes(state)}
    del state
    torch.cuda.empty_cache()
    worker_note("(a) pix2pixhd bf16 steps done")
    # (b) one f32 step at 2 ranks against the one-rank step on the same
    # global batch (rank 0), and the one-rank step with the plain instance
    # norm's statistics in f64 (rank 1): the spread the band is set from
    with tf32_off(), cudnn_deterministic():
        for name in ("cityscapes_spatial", "pix2pixhd"):
            cfg = spatial_config(name, f32=True)
            h, w = cfg.image_hw
            bs = cfg.data.batch_size
            batch = synthetic_hd_batch(bs, h, w, seed=SEED + 1)
            start = nets_of(create_train_state(cfg, SEED))
            runs, state = spatial_step_run(cfg, mesh, [batch], vgg, None)
            res[name] = {"metrics": runs[0][0], "counts": runs[0][2],
                         "nets": nets_of(state), "start": start}
            del state
            torch.cuda.empty_cache()
            route = ("plain", "f64")[rank]
            if name == "pix2pixhd" and route == "f64":
                continue
            patch = (mock.patch.object(norm, "instance_norm", norm_f64)
                     if route == "f64" else contextlib.nullcontext())
            with patch:
                st = create_train_state(cfg, SEED)
                _, m = build_train_step(cfg, vgg)(st, batch)
            torch.save(({k: float(v) for k, v in m.items()}, nets_of(st)),
                       f"{out}.{name}.{route}")
            del st
            torch.cuda.empty_cache()
    import torch.distributed as dist

    dist.barrier()
    worker_note("(b) f32 steps done")
    res["ops"] = spatial_ops_check(mesh, device)
    worker_note("(d) ops done")
    # (e) cli.train on the preset's mesh, then preempted
    data = os.path.join(tmp, "city")
    for what, chaos in (("full", None), ("elastic", f"elastic@{SP_CLI_STOP}")):
        reset_launch_counts()
        seen = dp_cli(spatial_cli_args(data, os.path.join(tmp, what)),
                      chaos=chaos)
        res[what] = {k: seen[k] for k in ("rc", "steps", "reads", "out")}
    return res


def norm_f64(x, eps: float = 1e-5):
    """The plain instance norm with its statistics in f64 (the spread
    route of phase 18 (b))."""
    x64 = x.double()
    mean = x64.mean(dim=(2, 3), keepdim=True)
    var = (x64 - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x64 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def spatial_cli_args(data: str, work: str, device: str = "cuda:0"):
    """``cli.train`` of the full-width ``cityscapes_spatial`` on ``data``
    with ``--mesh 1,2,1``: 2 epochs of 2 steps at global batch 2, one
    eval image a batch, a checkpoint at the end (and at a preemption)."""
    return ["--preset", "cityscapes_spatial", "--data_root", data,
            "--workdir", work, "--device", device, "--nepoch", "2",
            "--epochsave", "2", "--log_every", "1", "--threads", "0",
            "--batch_size", "2", "--test_batch_size", "1", "--mesh",
            "1,2,1"]


def spatial_kernel_rows(device, plan, steps: int, ranks: int):
    """(c): the sums entry, the finalize and #3 at pix2pixHD's epilogue
    shapes on a rank's rows (H halved), each held against its plain
    version, the global statistics against #1 on the whole map, #2 and #3
    fed them bitwise their plain versions; timed as the kernel phase times
    them, each row weighted by the (a) run's launches (``steps`` bf16
    steps on ``ranks`` ranks)."""
    from p2p_tpu_torch.core.mesh import row_block
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_apply, instance_norm_apply_plain, instance_norm_finalize,
        instance_norm_finalize_plain, instance_norm_stats, instance_norm_sums,
        instance_norm_sums_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act, norm_act_plain

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    forms = collections.defaultdict(collections.Counter)
    for hh, ww, c, act, res in plan:
        forms[(hh, ww, c)][form_of(act, res)] += steps * ranks
    rows = []
    worst = {"sums": 0.0, "stats": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.tensor([], dtype=dtype).element_size()
        for (hh, ww, c), by_form in sorted(forms.items()):
            where = f"{str(dtype)[6:]} N=1 {hh}x{ww}x{c} in 2 blocks"
            x = make_input(gen, 1, c, hh, ww, dtype, device)
            sums = []
            for r in range(2):
                a, b = row_block(hh, 2, r)
                xr = x[:, :, a:b].contiguous(
                    memory_format=torch.channels_last)
                s = instance_norm_sums(xr)
                p = instance_norm_sums_plain(xr)
                for got, want in zip(s, p):
                    assert_close(f"sums {where}", got, want, *STATS_TOL)
                    worst["sums"] = max(worst["sums"], max_err(got, want))
                sums.append((xr, s, p))
            s1 = sums[0][1][0] + sums[1][1][0]
            s2 = sums[0][1][1] + sums[1][1][1]
            count = float(hh * ww)
            mean, rstd = instance_norm_finalize(s1, s2, count)
            pm, pr = instance_norm_finalize_plain(s1, s2, count)
            assert_close(f"finalize {where}", mean, pm, 0.0, 2e-7)
            assert_close(f"finalize {where}", rstd, pr, 0.0, 2e-7)
            wm, wr = instance_norm_stats(x)
            assert_close(f"global stats {where} mean", mean, wm, *STATS_TOL)
            assert_close(f"global stats {where} rstd", rstd, wr, *STATS_TOL)
            worst["stats"] = max(worst["stats"], max_err(mean, wm),
                                 max_err(rstd, wr))
            xr = sums[0][0]
            if not torch.equal(instance_norm_apply(xr, mean, rstd),
                               instance_norm_apply_plain(xr, mean, rstd)):
                raise AssertionError(f"#2 fed global statistics {where}")
            if not torch.equal(norm_act(xr, mean, rstd, act="relu"),
                               norm_act_plain(xr, mean, rstd, act="relu")):
                raise AssertionError(f"#3 fed global statistics {where}")
            n_launch = sum(by_form.values()) // 2     # a rank's rows each
            common = dict(dtype=str(dtype)[6:], n=1, shape=(b - a, ww, c))
            numel = xr.numel()
            rows.append(dict(
                kernel="instance_norm_sums", **common, form="-",
                launches=2 * n_launch,
                max_abs_err=max(max_err(g, w) for g, w in zip(
                    sums[0][1], sums[0][2])),
                ms=timer(lambda: instance_norm_sums(xr)),
                plain_ms=timer(lambda: instance_norm_sums_plain(xr)),
                # the statistics the sums give, as #1's row times them
                library_ms=timer(lambda: torch.var_mean(
                    xr, dim=(2, 3), correction=0)),
                **bound_row(numel * elt + 2 * c * 4, 3 * numel, dtype)))
            rows.append(dict(
                kernel="instance_norm_finalize", **common, form="-",
                launches=2 * n_launch,
                max_abs_err=max(max_err(mean, pm), max_err(rstd, pr)),
                ms=timer(lambda: instance_norm_finalize(s1, s2, count)),
                plain_ms=timer(lambda: instance_norm_finalize_plain(
                    s1, s2, count)),
                library_ms=None,
                **bound_row(4 * c * 4, 6 * c, torch.float32)))
            for form, k in sorted(by_form.items()):
                r = make_input(gen, 1, c, b - a, ww, dtype, device) \
                    if form.endswith("+residual") else None
                rows.append(norm_act_row(timer, xr, r, mean, rstd, common,
                                         k, where, form))
    print("slice 13b (c): the sums entry and the finalize of #1 on a "
          "rank's rows against their plain versions (max abs "
          f"{worst['sums']:.3g}), the global statistics against #1 on the "
          f"whole map (max abs {worst['stats']:.3g}), #2 and #3 fed them "
          "bitwise; rows (device ms, median of cold-L2 runs):", flush=True)
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def spatial_phase(device, card, tmp: str, plan):
    """Slice 13b (phase 18), the spatial axis: (a)-(e) of the module
    docstring. Returns the main path's launch counts and the (c) rows."""
    from p2p_tpu_torch.data.synthetic import make_synthetic_dataset

    t_phase = time.perf_counter()
    make_synthetic_dataset(os.path.join(tmp, "city"),
                           n_train=SP_CLI_PAIRS[0], n_test=SP_CLI_PAIRS[1],
                           size=256, seed=SEED)
    fails = []
    ranks = torchrun("spatial2", 2, tmp)
    # (a)
    per = {"sums": len(plan), "finalize": len(plan), "stats": 0,
           "norm_act": len(plan), "fwd_ar": len(plan), "bwd_ar": len(plan)}
    for i, r in enumerate(ranks):
        a = r["a"]
        ms = [s[1] for s in a["steps"][SP_WARMUP:]]
        c = a["steps"][-1][2]
        print(f"slice 13b (a) rank {i}: pix2pixhd 1024x512 bf16 on "
              f"data=1,spatial=2 (512 rows of 1024 a rank, gloo): "
              f"{statistics.median(ms):.2f} ms/step median of {ms}; peak "
              f"{a['peak'] / 2 ** 30:.3f} GiB (phase 17 (d): 5.44 at one "
              f"rank); a step: {c[0]} sums, {c[1]} finalize, {c[2]} #1, "
              f"{c[3]} #3 (plan {len(plan)} each, #1 0), statistics "
              f"all-reduces {c[4]} forward, {c[5]} backward; halo "
              f"exchanges: slot {c[6]} calls, {c[7]} bytes sent; p2p "
              f"{c[8]} calls, {c[9]} bytes; losses "
              f"{ {k: round(v, 4) for k, v in a['steps'][-1][0].items()} }; "
              f"on {card}", flush=True)
        for m, _, c in a["steps"]:
            if c[:6] != (per["sums"], per["finalize"], 0, per["norm_act"],
                         per["fwd_ar"], per["bwd_ar"]) or c[8] or not c[6]:
                fails.append(f"(a) rank {i} counts {c}")
            if not all(math.isfinite(v) for v in m.values()):
                fails.append(f"(a) rank {i} losses {m}")
    replicas_differ([r["a"]["replicated"] for r in ranks],
                    f"slice 13b (a): pix2pixhd bf16 on data=1,spatial=2, "
                    f"{SP_WARMUP + SP_TIMED} steps", card, fails)
    # (b) against the one-rank step
    for name, keys in (("cityscapes_spatial", SP_CITY_KEYS),
                       ("pix2pixhd", HD_LOSS_KEYS)):
        one_m, one_n = torch.load(f"{os.path.join(tmp, 'spatial2')}."
                                  f"{name}.plain", weights_only=False)
        got = ranks[0][name]
        rel = max(abs(got["metrics"][k] - one_m[k]) / abs(one_m[k])
                  for k in keys)
        line = (f"slice 13b (b) {name} f32 (TF32 off, cuDNN deterministic),"
                f" 2 ranks vs the one-rank step: losses max rel {rel:.3g}")
        if name == "cityscapes_spatial":
            f64_m, f64_n = torch.load(f"{os.path.join(tmp, 'spatial2')}."
                                      f"{name}.f64", weights_only=False)
            spread = update_distance(f64_n, one_n, got["start"])
            dist_ = update_distance(got["nets"], one_n, got["start"])
            band = band_of(spread)
            line += (f" (band {SP_LOSS_RTOL}); each tensor's distance over "
                     f"its update {dist_:.3g} (band {band:.3g} = band_of the "
                     f"one-rank f64-statistics spread {spread:.3g})")
            if not dist_ <= band:
                fails.append(f"(b) {name} update distance {dist_} > {band}")
        else:
            line += f" (band {SP_LOSS_RTOL}; G's f32 gradient is " \
                    "ill-conditioned: losses only)"
        print(line + f"; on {card}", flush=True)
        if not rel <= SP_LOSS_RTOL:
            fails.append(f"(b) {name} losses {rel}")
        if not all(torch.equal(ranks[1][name]["nets"][k], v)
                   for k, v in got["nets"].items()):
            fails.append(f"(b) {name}: the ranks' states differ")
    # (c) on the main process
    rows = spatial_kernel_rows(device, plan, SP_WARMUP + SP_TIMED,
                               len(ranks))
    # (d)
    for i, r in enumerate(ranks):
        ops = r["ops"]
        print(f"slice 13b (d) rank {i}: input gradients on the card "
              f"(channels_last, f32, {SP_OPS_SHAPE}, slot route) vs f64, of "
              "the largest |dx|, same bits twice: "
              + ", ".join(f"{k} {e:.3g} {s}" for k, (e, s) in ops.items())
              + f" (limit {SP_GRAD_TOL_OF_MAX}); on {card}", flush=True)
        for k, (e, s) in ops.items():
            if not (e <= SP_GRAD_TOL_OF_MAX and s):
                fails.append(f"(d) {k}: {e}, same bits {s}")
    # (e) cli.train at 2 ranks, the preemption, the relaunch at world 1
    for r in ranks:
        if r["full"]["rc"] != 0 or r["elastic"]["rc"] != 75:
            fails.append(f"(e) exits {r['full']['rc']} "
                         f"{r['elastic']['rc']}:\n{r['elastic']['out']}")
    rel = dp_cli(spatial_cli_args(os.path.join(tmp, "city"),
                                  os.path.join(tmp, "elastic"), "cuda")[:-2])
    recs = [r for r in read_records(os.path.join(
        tmp, "elastic", "metrics_cityscapes_spatial.jsonl"))
        if r["kind"] == "elastic_resume"]
    full = ranks[0]["full"]["reads"]
    pre = ranks[0]["elastic"]["reads"]
    n_pre = SP_CLI_STOP * 2
    gapless = (ranks[0]["full"]["reads"] == ranks[1]["full"]["reads"]
               and pre[:n_pre] + rel["reads"][:len(full) - n_pre]
               == full[:len(full)])
    decision = recs[-1]["decision"] if recs else None
    print(f"slice 13b (e): cli.train --mesh 1,2,1 (cityscapes_spatial "
          f"256x512, 2 gloo ranks): exits "
          f"{[r['full']['rc'] for r in ranks]}, {ranks[0]['full']['steps']} "
          f"steps; elastic@{SP_CLI_STOP}: exits "
          f"{[r['elastic']['rc'] for r in ranks]}; relaunch at world size 1:"
          f" {decision}, restored {rel['restored']}, exit {rel['rc']}; the "
          f"spatial peers read the same samples and the two runs the "
          f"uninterrupted run's, none twice, none missing: {gapless}; on "
          f"{card}", flush=True)
    if rel["rc"] != 0 or decision != "reshard" or rel["restored"] != [
            (SP_CLI_STOP, True)] or not gapless:
        fails.append(f"(e) relaunch: {rel['rc']} {decision} "
                     f"{rel['restored']} gapless {gapless}\n{rel['out']}")
    counts = collections.Counter()
    for r in ranks:
        counts.update(r["a"]["launches"])
    secs = time.perf_counter() - t_phase
    print(f"slice 13b: phase 18 took {secs:.1f} s; on {card}", flush=True)
    if fails:
        raise AssertionError("slice 13b: " + "; ".join(fails))
    return counts, rows


# ------------------------------------------------- slice 13b-time and 13c
def time4_args(data: str, work: str):
    """``cli.train`` of the full-width ``vid2vid_temporal`` on its own mesh
    (``data=-1, time=4`` at world size 4) on ``data``: 2 epochs of 2
    clips, a checkpoint at the end."""
    return ["--preset", "vid2vid_temporal", "--data_root", data, "--workdir",
            work, "--device", "cuda:0", "--nepoch", str(AX_EPOCHS),
            "--epochsave", str(AX_EPOCHS), "--log_every", "1", "--threads",
            "0"]


@contextlib.contextmanager
def recording_norms(rec):
    """For the duration, every #2 and #3 launch of ops/instance_norm.py
    adds one to ``rec[(N, H, W, C, form)]`` (the #1 before each is
    implied), the kernel phase's keys."""
    from p2p_tpu_torch.ops import instance_norm as inorm

    norm_act, apply = inorm.norm_act, inorm.instance_norm_apply

    def rec_act(x, mean, rstd, scale=None, bias=None, residual=None,
                act="none", *a, **kw):
        n, c, h, w = x.shape
        rec[(n, h, w, c, form_of(act, residual is not None))] += 1
        return norm_act(x, mean, rstd, scale, bias, residual, act, *a, **kw)

    def rec_apply(x, *a, **kw):
        n, c, h, w = x.shape
        rec[(n, h, w, c, "apply")] += 1
        return apply(x, *a, **kw)

    with mock.patch.object(inorm, "norm_act", rec_act), \
            mock.patch.object(inorm, "instance_norm_apply", rec_apply):
        yield rec


def time4_worker(rank: int, out: str, tmp: str) -> dict:
    """Four ranks on the one card through gloo, each clip's 8 frames split
    over ``time=4`` (phase 19): (a) ``cli.train`` of the full-width
    ``vid2vid_temporal`` on its own mesh, each step timed with its halo
    exchanges; (b) its kernel form's bf16 steps at N = 2 frames a rank,
    the norms recorded, then one f32 step against the one-rank step on the
    whole clip (rank 0)."""
    import torch.distributed as dist

    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.parallel import place_state, shard_batch
    from p2p_tpu_torch.parallel.halo import halo_stats
    from p2p_tpu_torch.train import video_loop
    from p2p_tpu_torch.train.video_step import (build_video_train_step,
                                                create_video_train_state,
                                                make_parallel_video_step)

    device = torch.device("cuda", 0)
    res = {}
    # (a) through cli.train, every step timed
    seen = {"steps": []}
    build = video_loop.make_parallel_video_step

    def timed_build(*a, **kw):
        step = build(*a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            h0 = {r: dict(v) for r, v in halo_stats.items()}
            t = time.perf_counter()
            out_ = step(state, batch)
            torch.cuda.synchronize()
            seen["state"] = out_[0]
            seen["steps"].append((
                (time.perf_counter() - t) * 1e3,
                {r: (halo_stats[r]["calls"] - h0[r]["calls"],
                     halo_stats[r]["bytes"] - h0[r]["bytes"])
                 for r in halo_stats},
                int(batch["input"].shape[1])))
            return out_

        return timed

    torch.cuda.reset_peak_memory_stats(device)
    with mock.patch.object(video_loop, "make_parallel_video_step",
                           timed_build):
        cli = dp_cli(time4_args(os.path.join(tmp, "clips"),
                                os.path.join(tmp, "time4")))
    res["a"] = {"rc": cli["rc"], "out": cli["out"], "steps": seen["steps"],
                "peak": torch.cuda.max_memory_allocated(device),
                "replicated": replica_hashes(seen.pop("state"))}
    worker_note("(a) vid2vid_temporal cli.train done")
    # (b) the kernel form on the same mesh
    mesh = Mesh(MeshSpec(data=-1, time=4))
    cfg = vid_kernel_config()
    dtype = train_dtype(cfg.train.mixed_precision)
    batches = vid_clips(os.path.join(tmp, f"rank{rank}"), cfg,
                        AX_KERNEL_STEPS, SEED + 19)
    state = create_video_train_state(cfg, SEED, train_dtype=dtype)
    place_state(state, mesh)
    step = make_parallel_video_step(cfg, mesh, None, dtype)
    rec = collections.Counter()
    per_step = []
    for b in batches:
        before = launch_counts()
        with recording_norms(rec):
            state, m = step(state, shard_batch(b, mesh))
        torch.cuda.synchronize()
        per_step.append({k: launch_counts()[k] - before[k] for k in before})
    res["b"] = {"per_step": per_step, "rec": rec,
                "finite": all(math.isfinite(float(v)) for v in m.values())}
    del state, step
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    with tf32_off(), cudnn_deterministic():
        st = create_video_train_state(cfg32, SEED)
        place_state(st, mesh)
        _, m = make_parallel_video_step(cfg32, mesh)(
            st, shard_batch(batches[0], mesh))
        res["b"]["f32"] = {k: float(v) for k, v in m.items()}
        del st
        if rank == 0:
            st = create_video_train_state(cfg32, SEED)
            _, m = build_video_train_step(cfg32)(st, batches[0])
            res["b"]["f32_one"] = {k: float(v) for k, v in m.items()}
            del st
    torch.cuda.empty_cache()
    dist.barrier()
    worker_note("(b) kernel form done")
    return res


def tp2_worker(rank: int, out: str, tmp: str) -> dict:
    """Two ranks on the one card through gloo, Megatron tensor parallelism
    over ``model=2`` (phase 19): (c) ``pix2pixhd`` at 1024×512 bf16, each
    step timed with its norms recorded and its model-group collectives
    counted, then one f32 step against the one-rank step (rank 0); (d) the
    engine on the model mesh serving the requests of phase 3 in f32
    against the one-rank engine (rank 0), TF32 off and cuDNN
    deterministic."""
    import torch.distributed as dist

    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.models.registry import define_G, init_weights
    from p2p_tpu_torch.parallel import make_parallel_train_step, place_state
    from p2p_tpu_torch.parallel.tp import tp_stats
    from p2p_tpu_torch.serve.engine import InferenceEngine
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    device = torch.device("cuda", 0)
    mesh = Mesh(MeshSpec(data=1, model=2))
    vgg = load_vgg19(device=device)
    res = {}
    # (c) bf16 steps
    cfg = spatial_config("pix2pixhd")
    h, w = cfg.image_hw
    dtype = train_dtype(cfg.train.mixed_precision)
    host = synthetic_hd_batch(AX_TP_WARMUP + AX_TP_TIMED, h, w, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(AX_TP_WARMUP + AX_TP_TIMED)]
    torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    place_state(state, mesh, tp_min_ch=cfg.parallel.tp_min_ch)
    shards = len(state.tp_shards)
    step = make_parallel_train_step(cfg, mesh, vgg, dtype)
    rec = collections.Counter()
    steps = []
    for b in batches:
        s0 = {k: dict(v) for k, v in tp_stats.items()}
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording_norms(rec):
            state, m = step(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        steps.append((ms, {k: launch_counts()[k] - before[k] for k in before},
                      {k: (tp_stats[k]["calls"] - s0[k]["calls"],
                           tp_stats[k]["bytes"] - s0[k]["bytes"])
                       for k in tp_stats},
                      {k: float(v) for k, v in m.items()}))
    cut = {(sh.net, sh.name) for sh in state.tp_shards}
    replicated = {}
    for net in ("net_g", "net_d"):
        mod = getattr(state, net)
        for k, t in list(mod.named_parameters()) + list(mod.named_buffers()):
            if (net, k) not in cut:
                replicated[f"{net}.{k}"] = hashlib.sha256(
                    t.detach().reshape(-1).contiguous().view(torch.uint8)
                    .cpu().numpy()).hexdigest()
    res["c"] = {"steps": steps, "rec": rec, "shards": shards,
                "peak": torch.cuda.max_memory_allocated(device),
                "replicated": replicated}
    del state, step
    torch.cuda.empty_cache()
    worker_note("(c) pix2pixhd TP bf16 steps done")
    cfg32 = spatial_config("pix2pixhd", f32=True)
    batch = synthetic_hd_batch(1, h, w, seed=SEED + 1)
    with tf32_off(), cudnn_deterministic():
        st = create_train_state(cfg32, SEED)
        place_state(st, mesh, tp_min_ch=cfg32.parallel.tp_min_ch)
        _, m = make_parallel_train_step(cfg32, mesh, vgg)(st, batch)
        res["c"]["f32"] = {k: float(v) for k, v in m.items()}
        del st
        if rank == 0:
            st = create_train_state(cfg32, SEED)
            _, m = build_train_step(cfg32, vgg)(st, batch)
            res["c"]["f32_one"] = {k: float(v) for k, v in m.items()}
            del st
    torch.cuda.empty_cache()
    dist.barrier()
    worker_note("(c) f32 check done")
    # (d) serving on the model mesh, f32, against the one-rank engine
    g = define_G(cfg.model, image_hw=cfg.image_hw)
    init_weights(g, torch.Generator().manual_seed(SEED))
    reqs = synthetic_hd_batch(N_REQUESTS, h, w, seed=SEED + 3)["input"]
    groups, i = [], 0
    for n in RUN_BATCHES:
        groups.append({"input": reqs[i:i + n]})
        i += n
    with tf32_off(), cudnn_deterministic():
        eng = InferenceEngine(cfg, g, buckets=BUCKETS, dtype="f32",
                              mesh=mesh)
        if eng.leads:
            try:
                got = [eng.infer_batch(b)[0][:b["input"].shape[0]].float()
                       .cpu() for b in groups]
            finally:
                eng.close()
            one = InferenceEngine(cfg, g, buckets=BUCKETS, dtype="f32")
            want = [one.infer_batch(b)[0][:b["input"].shape[0]].float().cpu()
                    for b in groups]
            res["d"] = {"max_abs": max(float((a - b).abs().max())
                                       for a, b in zip(got, want)),
                        "levels": max(int(np.abs(to_levels(a)
                                                 - to_levels(b)).max())
                                      for a, b in zip(got, want)),
                        "served": sum(int(x.shape[0]) for x in got)}
        else:
            res["d"] = {"followed": eng.follow()}
    dist.barrier()
    worker_note("(d) TP serving done")
    return res


def pp_config(int8: bool = False, f32: bool = False):
    """Path A (or path A int8) at global batch ``PP_BATCH`` for the pipe
    phase; in f32 with ``f32``."""
    cfg = path_a8_config() if int8 else instance_config()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=PP_BATCH),
        train=dataclasses.replace(
            cfg.train, mixed_precision=not f32 and cfg.train.mixed_precision))


def pp_rank_plan(cfg, stage: int):
    """(N, H, W, C, form) → launches of #2/#3 (each after a #1) of one
    pipelined path-A step on pipe rank ``stage``: the encoder's and
    decoder's norms on the local batch, the stage's blocks' epilogues on
    each of its ``PP_MICRO`` ticks at N = batch / M, both G forwards (the
    G step and the net_c branch), and D's on the batch (fake, real)."""
    m = cfg.model
    h, w = cfg.image_hw
    n = cfg.data.batch_size
    mb = n // PP_MICRO
    per = m.n_blocks // PP_STAGES
    plan = collections.Counter()
    g = expand_norm_plan(m.ngf, m.n_blocks, h, w, m.output_nc)
    for hh, ww, c, form in g[:6]:
        plan[(n, hh, ww, c, form)] += 2
    for hh, ww, c, form in g[6 + 2 * per * stage:6 + 2 * per * (stage + 1)]:
        plan[(mb, hh, ww, c, form)] += 2 * PP_MICRO
    for hh, ww, c, form in d_norm_plan(m.ndf, m.n_layers_D, m.num_D, h, w):
        plan[(n, hh, ww, c, form)] += 2
    return plan


def nets_all(state):
    """G's, D's and net_c's parameters and buffers, on the CPU."""
    out = nets_of(state)
    if state.net_c is not None:
        out.update({f"net_c/{k}": v.detach().cpu().clone()
                    for k, v in state.net_c.state_dict().items()})
    return out


def pp_f32_one_rank(cfg, batch, vgg, route: str, out: str) -> None:
    """One f32 step of ``cfg`` on one rank from SEED, by ``route``:
    ``kernel`` (the unpipelined step), ``plain`` (the unpipelined step with
    every kernel on its plain version) or ``pp1`` (the pipelined step with
    no mesh: the microbatches in sequence); its losses and networks to
    ``out``."""
    from p2p_tpu_torch.parallel.pp import pp_merge_state, pp_split_state
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import (build_pp_train_step,
                                          build_train_step)

    st = create_train_state(cfg, SEED, sample_batch=batch)
    if route == "pp1":
        pp_split_state(st, cfg, None, n_stages=PP_STAGES)
        st, m = build_pp_train_step(cfg, None, PP_MICRO, vgg)(st, batch)
        pp_merge_state(st, cfg)
    else:
        with contextlib.ExitStack() as stack:
            if route == "plain":
                for p in instance_plain_patches():
                    stack.enter_context(p)
            st, m = build_train_step(cfg, vgg)(st, batch)
    torch.save(({k: float(v) for k, v in m.items()}, nets_all(st)), out)
    del st
    torch.cuda.empty_cache()


def pp_f32_step(cfg, mesh, batch, vgg, n_micro: int = PP_MICRO):
    """One f32 pipelined step of ``cfg`` on ``mesh`` from SEED: its
    metrics, the networks (the stages gathered back) and the launches."""
    from p2p_tpu_torch.parallel import place_state
    from p2p_tpu_torch.parallel.pp import pp_merge_state, pp_split_state
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_pp_train_step

    st = create_train_state(cfg, SEED, sample_batch=batch)
    place_state(st, mesh)
    pp_split_state(st, cfg, mesh)
    step = build_pp_train_step(cfg, mesh, n_micro, vgg)
    before = launch_counts()
    st, m = step(st, batch)
    torch.cuda.synchronize()
    launched = {k: launch_counts()[k] - before[k] for k in before}
    pp_merge_state(st, cfg, mesh=mesh)
    nets = nets_all(st)
    del st, step
    torch.cuda.empty_cache()
    return {k: float(v) for k, v in m.items()}, nets, launched


def pp3_worker(rank: int, out: str, tmp: str) -> dict:
    """Three ranks on the one card through gloo, the generator's trunk on
    ``pipe=3`` (phase 20): (a) path A's pipelined bf16 steps, each timed
    with its norms recorded and its ring shifts counted, the replicas
    hashed, then the f32 checks (the one-rank routes on ranks 0-2, the
    3-rank step serial and overlapped); (b) path A int8 and (c)
    ``cityscapes_spatial``, one f32 step each against the one-rank step
    (rank 0)."""
    import torch.distributed as dist

    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.data.synthetic import (synthetic_batch,
                                              synthetic_hd_batch)
    from p2p_tpu_torch.parallel import place_state
    from p2p_tpu_torch.parallel.pp import pp_split_state, pp_stats
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_pp_train_step

    device = torch.device("cuda", 0)
    mesh = Mesh(MeshSpec(data=1, pipe=PP_STAGES))
    vgg = load_vgg19(device=device)
    res = {}
    # (a) bf16 steps
    cfg = pp_config()
    h, w = cfg.image_hw
    n_steps = PP_WARMUP + PP_TIMED
    host = synthetic_batch(n_steps * PP_BATCH, h, cfg.model.quant_bits,
                           seed=SEED, width=w)
    batches = [{k: v[i * PP_BATCH:(i + 1) * PP_BATCH]
                for k, v in host.items()} for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    place_state(state, mesh)
    pp_split_state(state, cfg, mesh)
    step = build_pp_train_step(cfg, mesh, PP_MICRO, vgg, 1, dtype)
    rec = collections.Counter()
    steps = []
    for b in batches:
        s0 = {k: dict(v) for k, v in pp_stats.items()}
        before = launch_counts()
        one = collections.Counter()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording_norms(one):
            state, m = step(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        rec.update(one)
        steps.append((ms, {k: launch_counts()[k] - before[k]
                           for k in before},
                      {k: (pp_stats[k]["calls"] - s0[k]["calls"],
                           pp_stats[k]["bytes"] - s0[k]["bytes"])
                       for k in pp_stats}, one,
                      {k: float(v) for k, v in m.items()}))
    res["a"] = {"steps": steps, "rec": rec,
                "peak": torch.cuda.max_memory_allocated(device),
                "replicated": replica_hashes(state),
                "stage": state.pp_stages.stage}
    del state, step
    torch.cuda.empty_cache()
    worker_note("(a) path A pipelined bf16 steps done")
    # (a) f32: the one-rank routes, one a rank, then the 3-rank step
    cfg32 = pp_config(f32=True)
    batch = {k: v[:PP_BATCH] for k, v in synthetic_batch(
        PP_BATCH, h, cfg.model.quant_bits, seed=SEED + 1, width=w).items()}
    with tf32_off(), cudnn_deterministic():
        route = ("kernel", "plain", "pp1")[rank]
        pp_f32_one_rank(cfg32, batch, vgg, route, f"{out}.route.{route}")
        dist.barrier()
        worker_note("(a) one-rank f32 routes done")
        runs = {}
        for overlap in (False, True):
            c = cfg32.replace(parallel=dataclasses.replace(
                cfg32.parallel, pp_overlap=overlap))
            runs[overlap] = pp_f32_step(c, mesh, batch, vgg)
        res["a32"] = {"metrics": runs[False][0], "launched": runs[False][2],
                      "overlap_bitwise": runs[False][0] == runs[True][0]
                      and all(torch.equal(v, runs[True][1][k])
                              for k, v in runs[False][1].items())}
        if rank == 0:
            loaded = {r: torch.load(f"{out}.route.{r}", weights_only=False)
                      for r in ("kernel", "plain", "pp1")}
            start = nets_all(create_train_state(cfg32, SEED))
            one_m, one_n = loaded["kernel"]
            res["a32"].update(
                one=one_m,
                dist=update_distance(runs[False][1], one_n, start, PP_DEAD),
                spread_plain=update_distance(loaded["plain"][1], one_n,
                                             start, PP_DEAD),
                spread_pp1=update_distance(loaded["pp1"][1], one_n, start,
                                           PP_DEAD),
                pp1=loaded["pp1"][0],
                worst={what: sorted(
                    ((update_distance({k: v}, {k: one_n[k]}, start), k)
                     for k, v in nets.items() if k not in PP_DEAD),
                    reverse=True)[:3]
                    for what, nets in (("pp", runs[False][1]),
                                       ("plain", loaded["plain"][1]))})
        del runs
        torch.cuda.empty_cache()
        worker_note("(a) 3-rank f32 steps done")
        # (b) path A int8
        cfg8 = pp_config(int8=True, f32=True)
        m8, n8, launched8 = pp_f32_step(cfg8, mesh, batch, vgg)
        res["b"] = {"metrics": m8, "launched": launched8,
                    "amax": {k: float(v) for k, v in n8.items()
                             if k.endswith("amax_x")}}
        if rank == 0:
            st = create_train_state(cfg8, SEED, sample_batch=batch)
            from p2p_tpu_torch.train.step import build_train_step

            st, m = build_train_step(cfg8, vgg)(st, batch)
            res["b"]["one"] = {k: float(v) for k, v in m.items()}
            res["b"]["one_amax"] = {k: float(v) for k, v in
                                    nets_all(st).items()
                                    if k.endswith("amax_x")}
            del st
        torch.cuda.empty_cache()
        dist.barrier()
        worker_note("(b) path A int8 f32 done")
        # (c) cityscapes_spatial's ResNet trunk on pipe=3
        cfgc = spatial_config("cityscapes_spatial", f32=True)
        hc, wc = cfgc.image_hw
        bc = synthetic_hd_batch(cfgc.data.batch_size, hc, wc, seed=SEED + 2)
        mc, _, _ = pp_f32_step(cfgc, mesh, bc, vgg,
                               n_micro=cfgc.data.batch_size)
        res["c"] = {"metrics": mc}
        if rank == 0:
            from p2p_tpu_torch.train.step import build_train_step

            st = create_train_state(cfgc, SEED)
            _, m = build_train_step(cfgc, vgg)(st, bc)
            res["c"]["one"] = {k: float(v) for k, v in m.items()}
            del st
        torch.cuda.empty_cache()
        dist.barrier()
    worker_note("(c) cityscapes_spatial f32 done")
    return res


def tp8_worker(rank: int, out: str, tmp: str) -> dict:
    """Two ranks on the one card through gloo, ``pix2pixhd`` int8 on
    ``model=2`` (phase 20 (d)): bf16 steps, each timed with its norms
    recorded and its model-group collectives counted, the replicas
    hashed; then one f32 step against the one-rank step (rank 0)."""
    import torch.distributed as dist

    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.data.synthetic import synthetic_hd_batch
    from p2p_tpu_torch.parallel import make_parallel_train_step, place_state
    from p2p_tpu_torch.parallel.tp import tp_full, tp_stats
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    device = torch.device("cuda", 0)
    mesh = Mesh(MeshSpec(data=1, model=2))
    vgg = load_vgg19(device=device)
    cfg = hd_int8_config()
    h, w = cfg.image_hw
    dtype = train_dtype(cfg.train.mixed_precision)
    n_steps = PP_TP_WARMUP + PP_TP_TIMED
    host = synthetic_hd_batch(n_steps, h, w, seed=SEED)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(n_steps)]
    torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, SEED, train_dtype=dtype,
                               sample_batch=batches[0])
    place_state(state, mesh, tp_min_ch=cfg.parallel.tp_min_ch)
    step = make_parallel_train_step(cfg, mesh, vgg, dtype)
    rec = collections.Counter()
    steps = []
    for b in batches:
        s0 = {k: dict(v) for k, v in tp_stats.items()}
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording_norms(rec):
            state, m = step(state, b)
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t) * 1e3,
                      {k: launch_counts()[k] - before[k] for k in before},
                      {k: (tp_stats[k]["calls"] - s0[k]["calls"],
                           tp_stats[k]["bytes"] - s0[k]["bytes"])
                       for k in tp_stats},
                      {k: float(v) for k, v in m.items()}))
    res = {"d": {"steps": steps, "rec": rec,
                 "peak": torch.cuda.max_memory_allocated(device),
                 "shards": sorted({(s.net, type(s.module).__name__)
                                   for s in state.tp_shards}),
                 "replicated": replica_hashes(
                     state, {(s.net, s.name) for s in state.tp_shards})}}
    del state, step
    torch.cuda.empty_cache()
    worker_note("(d) pix2pixhd int8 TP bf16 steps done")
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    batch = synthetic_hd_batch(1, h, w, seed=SEED + 1)
    with tf32_off(), cudnn_deterministic():
        st = create_train_state(cfg32, SEED, sample_batch=batch)
        place_state(st, mesh, tp_min_ch=cfg32.parallel.tp_min_ch)
        st, m = make_parallel_train_step(cfg32, mesh, vgg)(st, batch)
        res["d"]["f32"] = {k: float(v) for k, v in m.items()}
        with tp_full(st):
            res["d"]["amax"] = {k: float(v) for k, v in nets_of(st).items()
                                if k.endswith("amax_x")}
        del st
        # the one-rank step (rank 0) and, for the spread the amax band is
        # set from, the one-rank step with every kernel on its plain
        # version (rank 1)
        with contextlib.ExitStack() as stack:
            if rank == 1:
                for p in instance_plain_patches():
                    stack.enter_context(p)
            st = create_train_state(cfg32, SEED, sample_batch=batch)
            st, m = build_train_step(cfg32, vgg)(st, batch)
        torch.save(({k: float(v) for k, v in m.items()},
                    {k: float(v) for k, v in nets_of(st).items()
                     if k.endswith("amax_x")}), f"{out}.one.{rank}")
        del st
        dist.barrier()
        if rank == 0:
            (res["d"]["f32_one"], res["d"]["one_amax"]), plain = (
                torch.load(f"{out}.one.{r}", weights_only=False)
                for r in (0, 1))
            res["d"]["spread_loss"] = max_rel(plain[0],
                                              res["d"]["f32_one"],
                                              HD_LOSS_KEYS)
            res["d"]["spread_amax"] = max_rel(plain[1],
                                              res["d"]["one_amax"])
    torch.cuda.empty_cache()
    dist.barrier()
    worker_note("(d) f32 check done")
    return res


def max_rel(got: dict, want: dict, keys=None) -> float:
    """The largest relative difference of ``got`` from ``want`` over
    ``keys`` (every key of ``want``)."""
    keys = list(want) if keys is None else [k for k in keys if k in want]
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in keys)


def pp_phase(device, card, tmp: str):
    """Slice 13c-PP (phase 20), the pipe axis and TP × int8: (a)-(d) of the
    module docstring. Returns the main paths' launch counts ((a)'s and
    (d)'s bf16 steps) and the kernel rows at their shapes."""
    t_phase = time.perf_counter()
    fails = []
    ranks = torchrun("pp3", PP_STAGES, tmp)
    t_pp3 = time.perf_counter() - t_phase
    cfg = pp_config()
    h, w = cfg.image_hw
    counts = collections.Counter()
    rec = collections.Counter()
    # (a)
    for i, r in enumerate(ranks):
        a = r["a"]
        want = pp_rank_plan(cfg, a["stage"])
        n_apply = sum(v for k, v in want.items() if k[4] == "apply")
        n_norms = sum(want.values())
        per_step = only(instance_norm_stats=n_norms,
                        instance_norm_apply=n_apply,
                        norm_act=n_norms - n_apply, batch_moments=2)
        ms = [s[0] for s in a["steps"][PP_WARMUP:]]
        shifts = a["steps"][-1][2]
        print(f"slice 13c-PP (a) rank {i} (stage {a['stage']}): path A "
              f"{h}x{w} bf16 on data=1,pipe={PP_STAGES}, global batch "
              f"{PP_BATCH} in {PP_MICRO} microbatches of "
              f"{PP_BATCH // PP_MICRO}: {statistics.median(ms):.2f} ms/step "
              f"median of {[round(v, 2) for v in ms]} (3 ranks share the "
              f"card through gloo: no speed of the pipe axis); peak "
              f"{a['peak'] / 2 ** 30:.3f} GiB; a step: "
              f"{ {k: v for k, v in a['steps'][-1][1].items() if v} } "
              f"(plan {n_norms} #1, {n_apply} #2, {n_norms - n_apply} #3, "
              f"2 #5); transfers a step (calls, bytes sent): "
              f"{ {k: v for k, v in shifts.items() if v[0]} }; losses "
              f"{ {k: round(v, 4) for k, v in a['steps'][-1][4].items()} }; "
              f"on {card}", flush=True)
        for ms_, lc, st, one, m in a["steps"]:
            if lc != per_step or one != want or not st["slot"][0] \
                    or st["p2p"][0] or not all(math.isfinite(v)
                                               for v in m.values()):
                fails.append(f"(a) rank {i} launches {lc} (want {per_step}"
                             f"), norms {dict(one)} (want {dict(want)}), "
                             f"transfers {st}, losses {m}")
            counts.update(lc)
        rec.update(a["rec"])
    replicas_differ([r["a"]["replicated"] for r in ranks],
                    f"slice 13c-PP (a): path A bf16 on data=1,pipe="
                    f"{PP_STAGES}, {PP_WARMUP + PP_TIMED} steps (the encoder, "
                    "decoder, D and net_c)", card, fails)
    a32 = ranks[0]["a32"]
    worst = a32["worst"].items()
    rel = max_rel(a32["metrics"], a32["one"], LOSS_KEYS)
    band = band_of(max(a32["spread_plain"], a32["spread_pp1"]))
    print(f"slice 13c-PP (a) f32 (TF32 off, cuDNN deterministic): the "
          f"3-rank pipelined step vs the one-rank unpipelined step: losses "
          f"max rel {rel:.3g} (band {PP_LOSS_RTOL}); each updated tensor's "
          f"distance over its update {a32['dist']:.3g} (band {band:.3g} = "
          f"band_of the larger of the one-rank spreads: kernels vs plain "
          f"{a32['spread_plain']:.3g}, pipelined on one rank vs unpipelined "
          f"{a32['spread_pp1']:.3g}; the largest: "
          f"{ {k: [(f'{d:.3g}', n) for d, n in v] for k, v in worst} }"
          f"); pp_overlap bitwise the serial step on every rank: "
          f"{[r['a32']['overlap_bitwise'] for r in ranks]}; on {card}",
          flush=True)
    if not rel <= PP_LOSS_RTOL:
        fails.append(f"(a) f32 losses {rel}")
    if not a32["dist"] <= band:
        fails.append(f"(a) f32 update distance {a32['dist']} > {band}")
    if not all(r["a32"]["overlap_bitwise"] for r in ranks):
        fails.append("(a) pp_overlap is not bitwise the serial step")
    # (b)
    b0 = ranks[0]["b"]
    plan8 = path_a8_step_plan(pp_config(int8=True))
    want4 = sum(f.endswith("+quant") for *_, f in plan8)
    step1 = [k for k in LOSS_KEYS if k != "loss_c"]
    rel = max_rel(b0["metrics"], b0["one"], step1)
    rel_c = max_rel(b0["metrics"], b0["one"], ["loss_c"])
    amax_rel = max_rel(b0["amax"], b0["one_amax"])
    got4 = [r["b"]["launched"]["norm_act_quant"] for r in ranks]
    print(f"slice 13c-PP (b) path A int8 f32 on data=1,pipe={PP_STAGES}: "
          f"losses before the update vs the one-rank step max rel "
          f"{rel:.3g} (band {PP_INT8_RTOL}), loss_c {rel_c:.3g} (band "
          f"{PP_INT8_AFTER_RTOL}); {len(b0['one_amax'])} stored amax "
          f"(stages, D, net_c) max rel {amax_rel:.3g} (band "
          f"{PP_INT8_RTOL}); #4 a rank {got4} (plan {want4}); on {card}",
          flush=True)
    if not rel <= PP_INT8_RTOL or not rel_c <= PP_INT8_AFTER_RTOL \
            or not amax_rel <= PP_INT8_RTOL \
            or set(b0["amax"]) != set(b0["one_amax"]) \
            or any(g != want4 for g in got4):
        fails.append(f"(b) losses {rel}, loss_c {rel_c}, amax {amax_rel}, "
                     f"#4 {got4}")
    # (c)
    c0 = ranks[0]["c"]
    rel = max_rel(c0["metrics"], c0["one"], SP_CITY_KEYS)
    print(f"slice 13c-PP (c) cityscapes_spatial f32 (ResNet trunk, 9 blocks "
          f"of 256 channels, 256x512, batch 4) on data=1,pipe={PP_STAGES}: "
          f"losses vs the one-rank step max rel {rel:.3g} (band "
          f"{PP_LOSS_RTOL}); on {card}", flush=True)
    if not rel <= PP_LOSS_RTOL:
        fails.append(f"(c) losses {rel}")
    # (d)
    t1 = time.perf_counter()
    tp = torchrun("tp8", 2, tmp)
    t_tp8 = time.perf_counter() - t1
    hd = hd_int8_config()
    full_plan = epilogue_plan(hd.model.ngf, hd.model.n_blocks, 3,
                              *hd.image_hw)
    for i, r in enumerate(tp):
        d = r["d"]
        rec.update(d["rec"])
        ms = [s[0] for s in d["steps"][PP_TP_WARMUP:]]
        by_c = collections.Counter()
        for key, v in d["rec"].items():
            by_c[key[3]] += v
        stats = d["steps"][-1][2]
        print(f"slice 13c-PP (d) rank {i}: pix2pixhd int8 1024x512 bf16 on "
              f"data=1,model=2 (sharded: {d['shards']}, gloo): "
              f"{statistics.median(ms):.2f} ms/step median of "
              f"{[round(v, 2) for v in ms]}; peak {d['peak'] / 2 ** 30:.3f} "
              f"GiB; a step: {d['steps'][-1][1]['instance_norm_stats']} #1, "
              f"{d['steps'][-1][1]['norm_act']} #3, #3 by C over the steps "
              f"{dict(sorted(by_c.items()))}; model-group collectives a "
              f"step (calls, bytes): "
              f"{ {k: v for k, v in stats.items() if v[0]} }; on {card}",
              flush=True)
        for _, lc, st, m in d["steps"]:
            if (lc["instance_norm_stats"], lc["norm_act"]) != (
                    len(full_plan), len(full_plan)) \
                    or not st["int32_sum"][0] or not st["amax_max"][0] \
                    or not all(math.isfinite(v) for v in m.values()):
                fails.append(f"(d) rank {i} step {lc} {st} {m}")
            counts.update(lc)
    replicas_differ([r["d"]["replicated"] for r in tp],
                    f"slice 13c-PP (d): pix2pixhd int8 bf16 on data=1,"
                    f"model=2, {PP_TP_WARMUP + PP_TP_TIMED} steps", card,
                    fails)
    d0 = tp[0]["d"]
    rel = max_rel(d0["f32"], d0["f32_one"], HD_LOSS_KEYS)
    amax_rel = max_rel(d0["amax"], d0["one_amax"])
    amax_band = band_of(d0["spread_amax"])
    print(f"slice 13c-PP (d) f32 (TF32 off, cuDNN deterministic): the "
          f"model=2 int8 step vs the one-rank step: losses max rel "
          f"{rel:.3g} (band {PP_INT8_RTOL}; the one-rank kernels-vs-plain "
          f"spread {d0['spread_loss']:.3g}); {len(d0['one_amax'])} stored "
          f"amax max rel {amax_rel:.3g} (band {amax_band:.3g} = band_of the "
          f"one-rank kernels-vs-plain spread {d0['spread_amax']:.3g}); on "
          f"{card}", flush=True)
    if not rel <= PP_INT8_RTOL or not amax_rel <= amax_band \
            or set(d0["amax"]) != set(d0["one_amax"]):
        fails.append(f"(d) f32 losses {rel}, amax {amax_rel}")
    rows = kernel_phase(device, rec)
    net_c_bn = (PP_BATCH * h * w, 64)
    rows += moments_phase(device, {net_c_bn: counts["batch_moments"]})
    for kernel in ("instance_norm_stats", "instance_norm_apply",
                   "norm_act", "batch_moments"):
        t = totals(rows, kernel)
        print(f"slice 13c-PP {kernel} ((a) and (d), bf16, {t['launches']} "
              "launches over the ranks' steps): "
              + ", ".join(f"{k} {t[k]:.4f}" for k in (
                  "ms", "bound_ms", "plain_ms", "library_ms")
                  if t[k] is not None)
              + f"; on {card}", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"slice 13c-PP: phase 20 took {secs:.1f} s (pp3 ranks "
          f"{t_pp3:.1f} s, tp8 ranks {t_tp8:.1f} s); on {card}", flush=True)
    if fails:
        raise AssertionError("phase 20: " + "; ".join(fails))
    return counts, rows


def to_levels(x: torch.Tensor) -> np.ndarray:
    """A [-1, 1] NHWC prediction as uint8 levels (int32)."""
    return np.round((x.numpy() + 1.0) * 127.5).clip(0, 255).astype(np.int32)


def axes_phase(device, card, tmp: str):
    """Slice 13b-time and 13c (phase 19), the time and model axes: (a)-(d)
    of the module docstring. Returns the main paths' launch counts ((b)'s
    and (c)'s bf16 steps) and the kernel rows at their shapes."""
    from p2p_tpu_torch.data.video import make_synthetic_video_dataset

    t_phase = time.perf_counter()
    cfg = vid_kernel_config()
    make_synthetic_video_dataset(
        os.path.join(tmp, "clips"), n_videos=1,
        n_frames=AX_CLIPS * cfg.data.n_frames, size=cfg.image_hw[0],
        seed=SEED)
    fails = []
    ranks = torchrun("time4", 4, tmp)
    t_time4 = time.perf_counter() - t_phase
    # (a)
    for i, r in enumerate(ranks):
        a = r["a"]
        if a["rc"] != 0:
            fails.append(f"(a) rank {i} exit {a['rc']}:\n{a['out']}")
            continue
        ms = [s[0] for s in a["steps"][AX_CLIPS:]]
        slot = a["steps"][-1][1]["slot"]
        print(f"slice 13b-time (a) rank {i}: vid2vid_temporal 8 frames of "
              f"256x256 bf16 on data=1,time=4 through cli.train (2 frames a "
              f"rank, gloo): {len(a['steps'])} steps, "
              f"{statistics.median(ms):.2f} ms/step median of "
              f"{[round(v, 2) for v in ms]}; peak "
              f"{a['peak'] / 2 ** 30:.3f} GiB (one rank, phase 15: 2.00); "
              f"halo exchanges a step: slot {slot[0]} calls, {slot[1]} "
              f"bytes sent, p2p {a['steps'][-1][1]['p2p'][0]}; on {card}",
              flush=True)
        if len(a["steps"]) != AX_EPOCHS * AX_CLIPS or any(
                s[2] != 2 or s[1]["slot"][0] == 0 or s[1]["p2p"][0]
                for s in a["steps"]):
            fails.append(f"(a) rank {i} steps {a['steps']}")
    if all(r["a"]["rc"] == 0 for r in ranks):
        replicas_differ([r["a"]["replicated"] for r in ranks],
                        f"slice 13b-time (a): vid2vid_temporal bf16 on "
                        f"data=1,time=4 through cli.train, "
                        f"{AX_EPOCHS * AX_CLIPS} steps", card, fails)
    # (b)
    plan = vid_kernel_plan(cfg)
    n_local = cfg.data.batch_size * cfg.data.n_frames // 4
    want = only(**vid_per_step(plan))
    want_rec = collections.Counter()
    for hh, ww, c, form in plan:
        want_rec[(n_local, hh, ww, c, form)] += AX_KERNEL_STEPS
    rec = collections.Counter()
    for i, r in enumerate(ranks):
        b = r["b"]
        rec.update(b["rec"])
        if any(s != want for s in b["per_step"]) or b["rec"] != want_rec \
                or not b["finite"]:
            fails.append(f"(b) rank {i} launches {b['per_step']} (want "
                         f"{want})")
    one = ranks[0]["b"]["f32_one"]
    rel = max(abs(ranks[0]["b"]["f32"][k] - one[k]) / abs(one[k])
              for k in VID_LOSS_KEYS)
    print(f"slice 13b-time (b): the kernel form on data=1,time=4: a rank a "
          f"step {dict((k, v) for k, v in want.items() if v)} at N = "
          f"{n_local} frames (the one-rank plan at N = 8: 31/13/18); f32 "
          f"(TF32 off, cuDNN deterministic) losses of the 4-rank step vs "
          f"the one-rank step on the whole clip: max rel {rel:.3g} (band "
          f"{AX_LOSS_RTOL}); on {card}", flush=True)
    if not rel <= AX_LOSS_RTOL:
        fails.append(f"(b) f32 losses {rel}")
    t1 = time.perf_counter()
    tp = torchrun("tp2", 2, tmp)
    t_tp2 = time.perf_counter() - t1
    # (c)
    hd = spatial_config("pix2pixhd")
    full_plan = epilogue_plan(hd.model.ngf, hd.model.n_blocks, 3,
                              *hd.image_hw)
    for i, r in enumerate(tp):
        c = r["c"]
        rec.update(c["rec"])
        ms = [s[0] for s in c["steps"][AX_TP_WARMUP:]]
        stats = c["steps"][-1][2]
        launched = c["steps"][-1][1]
        by_c = collections.Counter()
        for key, v in c["rec"].items():
            by_c[key[3]] += v
        print(f"slice 13c (c) rank {i}: pix2pixhd 1024x512 bf16 on "
              f"data=1,model=2 ({c['shards']} sharded tensors, gloo): "
              f"{statistics.median(ms):.2f} ms/step median of "
              f"{[round(v, 2) for v in ms]}; peak {c['peak'] / 2 ** 30:.3f} "
              f"GiB (one rank, phase 17 (d): 5.44); a step: "
              f"{launched['instance_norm_stats']} #1, {launched['norm_act']} "
              f"#3, #3 launches by C over the steps "
              f"{dict(sorted(by_c.items()))}"
              f"; model-group collectives a step (calls, bytes sent): "
              f"{ {k: v for k, v in stats.items() if v[0]} }; losses "
              f"{ {k: round(v, 4) for k, v in c['steps'][-1][3].items()} }; "
              f"on {card}", flush=True)
        for _, lc, st, m in c["steps"]:
            if (lc["instance_norm_stats"], lc["norm_act"]) != (
                    len(full_plan), len(full_plan)) or not st["reduce"][0] \
                    or not all(math.isfinite(v) for v in m.values()):
                fails.append(f"(c) rank {i} step {lc} {st} {m}")
    reps = [r["c"]["replicated"] for r in tp]
    differ = sorted(k for k in reps[0] if reps[0][k] != reps[1].get(k))
    print(f"slice 13c (c): after the bf16 steps (cuDNN's default mode) "
          f"{len(reps[0]) - len(differ)} of {len(reps[0])} replicated "
          f"parameters and buffers "
          f"({sum(k.endswith('.u') for k in reps[0])} spectral u) have the "
          f"same bits on both model ranks; differ: {differ[:6]}; on {card}",
          flush=True)
    if differ or set(reps[0]) != set(reps[1]):
        fails.append(f"(c) replicated tensors differ across the model "
                     f"ranks: {differ[:20]}")
    one = tp[0]["c"]["f32_one"]
    rel = max(abs(tp[0]["c"]["f32"][k] - one[k]) / abs(one[k])
              for k in HD_LOSS_KEYS)
    print(f"slice 13c (c): f32 (TF32 off, cuDNN deterministic) losses of the "
          f"model=2 step vs the one-rank step: max rel {rel:.3g} (band "
          f"{AX_LOSS_RTOL}); on {card}", flush=True)
    if not rel <= AX_LOSS_RTOL:
        fails.append(f"(c) f32 losses {rel}")
    # (d)
    d = tp[0]["d"]
    print(f"slice 13c (d): the engine on data=1,model=2 served "
          f"{d['served']} pix2pixhd requests in f32 (TF32 off, cuDNN "
          f"deterministic; rank 1 followed "
          f"{tp[1]['d']['followed']} forwards): max abs {d['max_abs']:.3g} "
          f"(limit {AX_SERVE_ATOL}) and {d['levels']} uint8 levels from "
          f"the one-rank engine (limit {AX_SERVE_LEVELS}); on {card}",
          flush=True)
    if d["served"] != N_REQUESTS or d["levels"] > AX_SERVE_LEVELS \
            or not d["max_abs"] <= AX_SERVE_ATOL:
        fails.append(f"(d) {d}")
    rows = kernel_phase(device, rec)
    for what, n in (("time ranks (b), N = 2 frames", n_local),
                    ("model ranks (c), N = 1", 1)):
        sel = [r for r in rows if r["n"] == n]
        for kernel in ("instance_norm_stats", "instance_norm_apply",
                       "norm_act"):
            tot = [r for r in sel if r["kernel"] == kernel]
            if tot:
                t = totals(tot, kernel)
                print(f"slice 13b-time/13c {kernel} on the {what} (bf16, "
                      f"{t['launches']} launches over the ranks' steps): "
                      + ", ".join(f"{k} {t[k]:.4f}" for k in (
                          "ms", "bound_ms", "plain_ms", "library_ms"))
                      + f"; on {card}", flush=True)
    counts = collections.Counter()
    for r in ranks:
        for s in r["b"]["per_step"]:
            counts.update(s)
    for r in tp:
        for s in r["c"]["steps"]:
            counts.update(s[1])
    secs = time.perf_counter() - t_phase
    print(f"slice 13b-time/13c: phase 19 took {secs:.1f} s (time4 ranks "
          f"{t_time4:.1f} s, tp2 ranks {t_tp2:.1f} s); on {card}", flush=True)
    if fails:
        raise AssertionError("phase 19: " + "; ".join(fails))
    return counts, rows


def update_distance(a, b, start, skip=()) -> float:
    """The largest distance between two states' tensors over the update
    ``b`` made from ``start`` (floating parameters; running statistics
    and the names in ``skip`` left out)."""
    worst = 0.0
    for k, v in b.items():
        if not v.is_floating_point() or k.endswith(("mean", "var")) \
                or k in skip:
            continue
        upd = float((v - start[k]).norm())
        if upd > 0:
            worst = max(worst, float((a[k] - v).norm()) / upd)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one forward")
    ap.add_argument("--worker", nargs=3, metavar=("NAME", "OUT", "TMP"),
                    help="a rank of the slice-13 or 13b phase (started by "
                         "the phase itself through torchrun)")
    args = ap.parse_args(argv)
    if args.worker:
        return dp_worker(*args.worker)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.ops.cuda import (
        batch_moments, build, instance_norm_kernel, norm_act, subpixel_head)

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.KERNELS:
        build.library(name)
    print(f"build: {built or 'all cached'}; {time.perf_counter() - t0:.1f}s "
          "wall", flush=True)

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    plan = epilogue_plan(cfg.model.ngf, cfg.model.n_blocks, 3, h, w)
    if len(plan) != NORMS_PER_FORWARD:
        raise AssertionError(f"plan has {len(plan)} epilogues")
    if sum(RUN_BATCHES) != N_REQUESTS or not set(RUN_BATCHES) <= set(BUCKETS):
        raise AssertionError("RUN_BATCHES must split the requests into buckets")
    ref = get_preset("reference")
    bn_plan = batchnorm_plan(ref.model.ngf, ref.model.n_blocks,
                             *ref.image_hw)
    fac = facades_config()
    fac_bn_plan = facades_bn_plan(fac.model.ngf, *fac.image_hw)
    inst = instance_config()
    a_plan = path_a_step_plan(inst)
    n_apply = sum(form == "apply" for *_, form in a_plan)
    # path A per step: #2 and #3 as planned, #1 before each, #5 under
    # net_c's one BatchNorm in its two runs; path B: the 36 epilogues
    a_per_step = dict(instance_norm_stats=len(a_plan),
                      instance_norm_apply=n_apply,
                      norm_act=len(a_plan) - n_apply, batch_moments=2)
    if (len(a_plan), n_apply) != (66, 12):
        raise AssertionError(f"path A plan: {len(a_plan)} norms, {n_apply} "
                             "#2 (want 66, 12)")
    b_per_step = dict(instance_norm_stats=NORMS_PER_FORWARD,
                      norm_act=NORMS_PER_FORWARD)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    hd_steps = HD_TRAIN_WARMUP + HD_TRAIN_STEPS
    net_c_bn = (ref.image_hw[0] * ref.image_hw[1], 64)
    i8 = int8_config()
    i8_plan = 2 * int8_d_plan(i8)          # the fake and the real D forward
    i8_count = collections.Counter(form for *_, form in i8_plan)
    if (len(i8_plan), i8_count["leaky+quant"], i8_count["leaky"]) != (
            INT8_PER_STEP["instance_norm_stats"],
            INT8_PER_STEP["norm_act_quant"], INT8_PER_STEP["norm_act"]):
        raise AssertionError(f"facades_int8 D plan {i8_plan}")
    if len(facades_bn_plan(i8.model.ngf, *i8.image_hw)) != \
            INT8_PER_STEP["batch_moments"]:
        raise AssertionError("facades_int8 BatchNorm plan")
    bn_launches = collections.Counter()
    for shape in bn_plan + fac_bn_plan + [net_c_bn] * 2:
        bn_launches[shape] += steps
    for shape in facades_bn_plan(i8.model.ngf, *i8.image_hw):
        bn_launches[shape] += steps + INT8_AS_IS_STEPS
    # the loop phase's train steps are main-path launches of #5 too
    for shape in bn_plan:
        bn_launches[shape] += LOOP_STEPS
    # slice 8: G1 alone at 256x512 (phase 1) and the full generator
    # (phase 2) per train step and eval forward of the coarse-to-fine
    # phase; edges2shoes_dp's 13 BatchNorms at batch 64; the options'
    # facades steps; the U-Net forms
    g1 = g1_plan(cfg.model.ngf, cfg.model.n_blocks, h // 2, w // 2)
    if len(g1) != 27:
        raise AssertionError(f"G1 plan has {len(g1)} epilogues (want 27)")
    c2f_per_image = {"global": len(g1), "full": NORMS_PER_FORWARD}
    c2f_images = sum(C2F_SOURCES)
    e2s = get_preset("edges2shoes_dp")
    e2s_bs = e2s.data.batch_size
    e2s_plan = [(e2s_bs * m, c) for m, c in facades_bn_plan(
        e2s.model.ngf, *e2s.image_hw)]
    e2s_steps = E2S_WARMUP + E2S_STEPS + 1       # and one profiled step
    u_plan = unet_norm_plan(fac.model.ngf, *fac.image_hw)
    if len(e2s_plan) != 13 or len(u_plan) != 13:
        raise AssertionError("edges2shoes_dp / U-Net norm plans")
    for shape in e2s_plan:
        bn_launches[shape] += e2s_steps
    # slice 13: edges2shoes_dp's BatchNorms at the local batches of the
    # data-parallel runs (4: two ranks of 8; 32: two ranks of 64, and the
    # relaunch at global batch 32); their launches are added after phase 17
    for local in (DP_GLOBAL_BATCH // 2, DP_REBASE_BATCH):
        for m, c in facades_bn_plan(e2s.model.ngf, *e2s.image_hw):
            bn_launches[(local * m, c)] += 0
    bn_forms = sum(f not in ("instance", "pallas_instance")
                   for f in UNET_FORMS)
    for shape in fac_bn_plan:
        bn_launches[shape] += OPTIONS_ALL_STEPS + bn_forms
    # slice 9: facades_int8_full's 28 #5 a step; path A int8 (#4 in place
    # of #3 before D's inner convs 2 and 3 of each scale); pix2pixhd int8's
    # step and served forward (36 #1 + 36 #3 each)
    i8f = int8_full_config()
    i8f_bn = int8_full_bn_plan(i8f)
    if len(i8f_bn) != 28:
        raise AssertionError(f"facades_int8_full plan has {len(i8f_bn)} #5")
    for shape in i8f_bn:
        bn_launches[shape] += I8F_STEPS
    a8 = path_a8_config()
    a8_plan = path_a8_step_plan(a8)
    a8_forms = collections.Counter(
        "apply" if f == "apply" else "quant" if f.endswith("+quant")
        else "act" for *_, f in a8_plan)
    a8_per_step = dict(instance_norm_stats=len(a8_plan),
                       instance_norm_apply=a8_forms["apply"],
                       norm_act=a8_forms["act"],
                       norm_act_quant=a8_forms["quant"], batch_moments=2)
    if (len(a8_plan), a8_forms["apply"], a8_forms["act"],
            a8_forms["quant"]) != (66, 12, 42, 12):
        raise AssertionError(f"path A int8 plan: {a8_per_step}")
    bn_launches[net_c_bn] += 2 * A8_STEPS
    # slice 11: the video kernel form's steps, every norm at N = 8 frames
    vk = vid_kernel_config()
    vk_plan = vid_kernel_plan(vk)
    vk_n = vk.data.batch_size * vk.data.n_frames
    vk_per_step = vid_per_step(vk_plan)
    if (vk_per_step["instance_norm_stats"], vk_per_step[
            "instance_norm_apply"], vk_per_step["norm_act"]) != (31, 13, 18):
        raise AssertionError(f"vid2vid kernel-form plan: {vk_per_step}")
    head_fwd = main_path_forwards() + collections.Counter({1: steps})
    head_dx = collections.Counter({1: steps})
    norm_launches = instance_launches(plan, a_plan, steps, hd_steps)
    for hh, ww, c, form in i8_plan:
        norm_launches[(1, hh, ww, c, form)] += steps
    for hh, ww, c, act, res in g1:
        norm_launches[(1, hh, ww, c, form_of(act, res))] += c2f_images
    for hh, ww, c, act, res in plan:
        norm_launches[(1, hh, ww, c, form_of(act, res))] += c2f_images
    for hh, ww, c, form in u_plan:
        norm_launches[(1, hh, ww, c, form)] += 1
    for hh, ww, c, form in a8_plan:
        norm_launches[(1, hh, ww, c, form)] += A8_STEPS
    for hh, ww, c, act, res in plan:
        norm_launches[(1, hh, ww, c, form_of(act, res))] += 2
    for hh, ww, c, form in vk_plan:
        norm_launches[(vk_n, hh, ww, c, form)] += VID_KERNEL_STEPS
    rows = (kernel_phase(device, norm_launches)
            + moments_phase(device, bn_launches)
            + subpixel_phase(device, head_fwd, head_dx))
    int8_forms_phase(device)
    backward_phase(device, a_plan, plan)
    serve_counts, serve_stats, _ = slice_phase(device, card, args.profile)
    train_counts, train_med, train_host = train_phase(device, card,
                                                      args.profile)
    fac_serve_counts, _, _ = facades_serving_phase(device, card,
                                                   args.profile)
    fac_train_counts, _ = facades_train_phase(device, card, args.profile)
    a_counts, _ = instance_a_phase(device, card, args.profile, a_per_step)
    b_counts, _, _ = instance_b_phase(device, card, args.profile, b_per_step)
    i8_counts, i8_as_is_counts, _, _ = int8_train_phase(device, card,
                                                         args.profile)
    conv_transpose_check(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        i8f_counts, _, _ = int8_full_phase(device, card, args.profile, tmp)
    a8_counts = path_a8_phase(device, card, args.profile, a8_per_step)
    hd8_counts = hd_int8_phase(device, card, args.profile, b_per_step)
    e2s_counts, n_e2s, e2s_med = edges2shoes_phase(device, card,
                                                   args.profile)
    if n_e2s != e2s_steps:
        raise AssertionError(f"edges2shoes_dp ran {n_e2s} steps")
    city_counts = cityscapes_phase(device, card, args.profile)
    options_counts = options_phase(device, card)
    forms_counts = unet_forms_phase(device, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        loop_counts, loop_ms = loop_phase(device, card, train_med,
                                          train_host, tmp)
        http_counts, http_forwards = http_phase(
            card, os.path.join(tmp, "work"), (LOOP_SOURCES[0], LOOP_STEPS),
            tmp, serve_stats.img_per_sec)
        res_counts = resilience_phase(device, card, tmp, loop_ms)
        s12_counts = slice12_phase(device, card, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c2f_") as tmp:
        c2f_counts = coarse_to_fine_phase(device, card, tmp, c2f_per_image)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        vid_counts = video_phase(device, card, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        dp_counts, dp_moments, remat_steps = dp_phase(device, card, tmp,
                                                      e2s_med)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        sp_counts, sp_rows = spatial_phase(device, card, tmp, plan)
    rows += sp_rows
    with tempfile.TemporaryDirectory(prefix="chip_smoke_axes_") as tmp:
        ax_counts, ax_rows = axes_phase(device, card, tmp)
    rows += ax_rows
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        pp_counts, pp_rows = pp_phase(device, card, tmp)
    rows += pp_rows
    # the HTTP phase's pix2pixHD forwards are main-path launches of #1, #3,
    # the slice-10 phase's reference steps of #5
    add_serving_launches(rows, plan, http_forwards)
    add_moment_launches(rows, bn_plan,
                        res_counts["batch_moments"] // len(bn_plan))
    add_moment_launches(rows, bn_plan,
                        s12_counts["batch_moments"] // len(bn_plan))
    add_dp_launches(rows, dp_moments, remat_steps, plan)
    counts = collections.Counter()
    for c in (serve_counts, train_counts, fac_serve_counts,
              fac_train_counts, a_counts, b_counts, i8_counts,
              i8_as_is_counts, loop_counts, http_counts, e2s_counts,
              city_counts, options_counts, forms_counts, c2f_counts,
              i8f_counts, a8_counts, hd8_counts, res_counts, vid_counts,
              s12_counts, dp_counts, sp_counts, ax_counts, pp_counts):
        counts.update(c)

    kernels = []
    for name, source, replaces in (
            ("instance_norm_stats", instance_norm_kernel.SOURCE,
             instance_norm_kernel.REPLACES),
            ("instance_norm_sums", instance_norm_kernel.SOURCE,
             instance_norm_kernel.REPLACES_SUMS),
            ("instance_norm_finalize", instance_norm_kernel.SOURCE,
             instance_norm_kernel.REPLACES_FINALIZE),
            ("instance_norm_apply", instance_norm_kernel.SOURCE_APPLY,
             instance_norm_kernel.REPLACES_APPLY),
            ("norm_act", norm_act.SOURCE, norm_act.REPLACES),
            ("norm_act_quant", norm_act.SOURCE, norm_act.REPLACES_QUANT),
            ("batch_moments", batch_moments.SOURCE, batch_moments.REPLACES),
            ("subpixel_head_fwd", subpixel_head.SOURCE,
             subpixel_head.REPLACES_FWD),
            ("subpixel_head_dx", subpixel_head.SOURCE,
             subpixel_head.REPLACES_DX)):
        tot = totals(rows, name)
        if tot["launches"] != counts[name]:
            raise AssertionError(f"{name}: timed rows cover {tot['launches']} "
                                 f"launches, the main paths made "
                                 f"{counts[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces.split(" ")[0],
            "launches": counts[name], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"]})
    bf16 = {(r["kernel"], r["n"], tuple(r["shape"]), r["form"]): r
            for r in rows if r["dtype"] == "bfloat16"}
    a_keys = collections.Counter()
    for hh, ww, c, form in a_plan:
        a_keys[("instance_norm_stats", 1, (hh, ww, c), "-")] += 1
        name = "instance_norm_apply" if form == "apply" else "norm_act"
        a_keys[(name, 1, (hh, ww, c), form)] += 1
    b_keys = collections.Counter()
    for hh, ww, c, act, res in plan:
        b_keys[("instance_norm_stats", 1, (hh, ww, c), "-")] += 1
        b_keys[("norm_act", 1, (hh, ww, c), form_of(act, res))] += 1
    g1_keys = collections.Counter()
    for hh, ww, c, act, res in g1:
        g1_keys[("instance_norm_stats", 1, (hh, ww, c), "-")] += 1
        g1_keys[("norm_act", 1, (hh, ww, c), form_of(act, res))] += 1
    a8_keys = collections.Counter()
    for hh, ww, c, form in a8_plan:
        a8_keys[("instance_norm_stats", 1, (hh, ww, c), "-")] += 1
        name = ("instance_norm_apply" if form == "apply" else
                "norm_act_quant" if form.endswith("+quant") else "norm_act")
        a8_keys[(name, 1, (hh, ww, c), form)] += 1
    vk_keys = collections.Counter()
    for hh, ww, c, form in vk_plan:
        vk_keys[("instance_norm_stats", vk_n, (hh, ww, c), "-")] += 1
        name = "instance_norm_apply" if form == "apply" else "norm_act"
        vk_keys[(name, vk_n, (hh, ww, c), form)] += 1
    u_keys = collections.Counter()
    for hh, ww, c, form in u_plan:
        u_keys[("instance_norm_stats", 1, (hh, ww, c), "-")] += 1
        u_keys[("instance_norm_apply", 1, (hh, ww, c), form)] += 1
    i8_keys = collections.Counter()
    for hh, ww, c, form in i8_plan:
        i8_keys[("instance_norm_stats", 1, (hh, ww, c), "-")] += 1
        name = "norm_act_quant" if form.endswith("+quant") else "norm_act"
        i8_keys[(name, 1, (hh, ww, c), form)] += 1
    for what, kernel, keys in (
            ("#5 per reference train step", "batch_moments",
             collections.Counter((1, shape, "-") for shape in bn_plan)),
            ("#5 per facades train step", "batch_moments",
             collections.Counter((1, shape, "-") for shape in fac_bn_plan)),
            ("#6 per facades forward at N=1", "subpixel_head_fwd",
             {(1, (128, 128, 128), "F4=12"): 1}),
            ("#7 per facades train step", "subpixel_head_dx",
             {(1, (128, 128, 128), "F4=12"): 1}),
            *[(f"#{i} per path A train step", name,
               {k[1:]: v for k, v in a_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"),
                              (2, "instance_norm_apply"), (3, "norm_act"))],
            *[(f"#{i} per path B train step", name,
               {k[1:]: v for k, v in b_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"), (3, "norm_act"))],
            *[(f"#{i} per facades int8 train step", name,
               {k[1:]: v for k, v in i8_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"), (3, "norm_act"),
                              (4, "norm_act_quant"))],
            *[(f"#{i} per pix2pixHD phase-1 (G1) train step", name,
               {k[1:]: v for k, v in g1_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"), (3, "norm_act"))],
            ("#5 per facades_int8_full train step", "batch_moments",
             collections.Counter((1, shape, "-") for shape in i8f_bn)),
            *[(f"#{i} per path A int8 train step", name,
               {k[1:]: v for k, v in a8_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"),
                              (2, "instance_norm_apply"), (3, "norm_act"),
                              (4, "norm_act_quant"))],
            ("#5 per edges2shoes_dp train step (batch 64)", "batch_moments",
             collections.Counter((1, shape, "-") for shape in e2s_plan)),
            *[(f"#{i} per pallas_instance U-Net train step", name,
               {k[1:]: v for k, v in u_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"),
                              (2, "instance_norm_apply"))],
            *[(f"#{i} per vid2vid kernel-form train step (N = {vk_n})",
               name, {k[1:]: v for k, v in vk_keys.items() if k[0] == name})
              for i, name in ((1, "instance_norm_stats"),
                              (2, "instance_norm_apply"), (3, "norm_act"))]):
        sel = [(bf16[(kernel,) + key], v) for key, v in keys.items()]
        print(f"{what} (bf16, {sum(v for _, v in sel)} launches): "
              + ", ".join(f"{k} {sum(r[k] * v for r, v in sel):.4f}"
                          for k in ("ms", "bound_ms", "plain_ms",
                                    "library_ms")))
    for kernel in ("instance_norm_apply", "norm_act", "norm_act_quant"):
        sel = [r for r in rows if r["kernel"] == kernel
               and r["dtype"] == "bfloat16"]
        print(f"{kernel} (bf16, {sum(r['launches'] for r in sel)} "
              "launches): alone ms "
              f"{sum(r['us'] * r['launches'] for r in sel) / 1e3:.4f}, as "
              "a site (#1 then it) ms "
              f"{sum(r['site_us'] * r['launches'] for r in sel) / 1e3:.4f}; "
              "paths " + ", ".join(sorted({r["path"] for r in sel})))
    print("per-kernel numbers are the main paths' bf16 launches (#1, #3: "
          f"pix2pixHD serving at {h}x{w} (phase 3, and the HTTP phase's "
          f"{sum(http_forwards.values())} forwards), path A ({steps} "
          f"steps), path B "
          f"({hd_steps} steps) and facades int8 ({steps} steps) training, "
          f"and the coarse-to-fine CLIs' {c2f_images} steps and eval "
          f"forwards a phase; "
          f"#2: path A and the pallas_instance U-Net step; #4: facades "
          f"int8; #5: {steps} reference, facades, "
          f"path A and facades int8 train steps, {INT8_AS_IS_STEPS} of "
          f"facades_int8 as it is, the loop's {LOOP_STEPS} reference "
          f"steps, {e2s_steps} edges2shoes_dp steps at batch {e2s_bs}, "
          f"{OPTIONS_ALL_STEPS} facades steps with the trainer options and "
          f"{bn_forms} U-Net form steps, the slice-10 phase's "
          f"{res_counts['batch_moments'] // len(bn_plan)} reference steps "
          f"and the slice-12 phase's "
          f"{s12_counts['batch_moments'] // len(bn_plan)}; "
          f"#6: facades serving and training; "
          "#7: facades training; slice 9: #5 in "
          f"{I8F_STEPS} facades_int8_full steps, #1-#5 in {A8_STEPS} path "
          "A int8 steps (#4 at its spectral-norm sites), #1 and #3 in "
          "pix2pixhd int8's step and served forward; slice 11: #1, #2 and "
          f"#3 in {VID_KERNEL_STEPS} vid2vid kernel-form steps at N = "
          f"{vk_n}; slice 13: #5 in the data-parallel edges2shoes_dp "
          f"steps at local batches {dict(dp_moments)} (launches), #1 and "
          f"#3 in pix2pixhd's remat steps {remat_steps}; slice 13b: the "
          f"sums entry, the finalize and #3 in {SP_WARMUP + SP_TIMED} bf16 "
          "pix2pixhd steps on 2 spatial ranks, at a rank's rows; slice "
          f"13b-time: #1, #2 and #3 in {AX_KERNEL_STEPS} kernel-form steps "
          "on 4 time ranks at N = 2 frames a rank; slice 13c: #1 and #3 in "
          f"{AX_TP_WARMUP + AX_TP_TIMED} bf16 pix2pixhd steps on 2 model "
          "ranks, the pairs' inner norms on their channel slice; slice "
          f"13c-PP: #1, #2, #3 and #5 in {PP_WARMUP + PP_TIMED} bf16 path A "
          f"steps on {PP_STAGES} pipe ranks (the encoder, decoder and D at "
          f"N = {PP_BATCH}, a stage's blocks at N = {PP_BATCH // PP_MICRO} "
          f"on each tick), #1 and #3 in {PP_TP_WARMUP + PP_TP_TIMED} bf16 "
          "pix2pixhd int8 steps on 2 model ranks): per-(N, shape, form) "
          "device times weighted by launches")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"kernels' build included; on {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
