#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's serving and training paths on one
CUDA card.

Drives ``vsr_tpu_torch`` (never JAX, never ``vsr_tpu``) through its three
serving paths and its training path, each at the full width of the repo's
config for its net, with random seeded weights:

- video mode: DRFNet x2 (F=64, G=6, ``configs/test/acdc_vsr_drf_x2.yaml``),
  whose squeezes run the fused concat + 1x1 kernel (K1);
- frame mode: MoEEDSRNet x2 (16 resblocks, 64 features, 4 experts, groups of
  256, ``configs/test/acdc_sisr_moe_x2.yaml``), whose router runs the
  pairwise-rank kernel (K3);
- window mode: DUFNet x2 (7 frames, 5x5 filters, ``_DenseLayer16``,
  ``configs/test/acdc_misr_duf_x2.yaml``) with ``--windows 7 --chunk 100``,
  whose dynamic filters run the fused filter kernel (K2);
- training: ``vsr_tpu_torch.main.run_train`` on
  ``configs/train/acdc_vsr_drf_x2.yaml`` (DRFNet F=64 G=6, batch 16, 5-frame
  windows of 32 x 32 patches, L1, Adam, PSNR + SSIM), whose squeezes run K1
  forward and backward, on ``configs/train/acdc_sisr_edsr_x2.yaml``
  (EDSRNet 16 x 64, no kernel) and on ``configs/train/acdc_sisr_srfb_x2.yaml``
  (SRFBNet F=64 G=6, 4 feedback steps, batch 16 of 32 x 32 patches: K1
  forward and backward, 48 launches of each per step), on a synthetic
  processed tree that the script writes itself;
- testing: ``python -m vsr_tpu_torch.main <config> --test`` (its ``main``) on
  ``configs/test/acdc_sisr_srfb_x2.yaml``, ``acdc_vsr_drf_x2.yaml`` and
  ``acdc_sisr_edsr_x2.yaml`` with the checkpoints those runs wrote:
  ``results.csv``, PNGs and GIFs, PSNR / SSIM and their Cardiac* twins;
- the MISR and FRVSR training paths, one epoch each at the configs' widths
  and batches: ``configs/train/acdc_misr_duf_x2.yaml`` (DUFNet with
  ``use_pallas_filter``: K2 in its validation pass, none in its train
  steps), ``acdc_sisr_moe_x2.yaml`` (MoE-EDSR with ``rank_pallas``: K3 in
  every train step), ``acdc_misr_toflow_x2.yaml``, ``acdc_misr_rbpn_x2.yaml``,
  ``acdc_misr_edvr_x4.yaml`` and ``acdc_vsr_frvsr_x4.yaml``, then ``main
  --test`` on DUF (``AcdcMISRPredictor``, K2) and FRVSR (the VSR predictor
  on a tuple output);
- the volumetric slice, one epoch each at the configs' widths and batches:
  ``configs/train/acdc_3d_vol_x2.yaml`` (Volume3DSRNet, 8 resblocks of 32,
  ``fused_tail``) and ``acdc_4d_vol_x2.yaml`` (Volume4DSRNet, 4 resblocks
  of 32, ``remat``, ``fused_tail``) on a volume tree of its own, then
  ``main --test`` on ``configs/test/acdc_{3d,4d}_vol_x2.yaml`` and the
  infer CLI's volume mode. No kernel of the port lies on these paths;
- the device-epoch slice: the four ``configs/train/*_device.yaml`` through
  the device trainers (the train split resident on the card, the step
  captured as one CUDA graph and replayed; bf16 compute on float32
  parameters), the DRF one also through K1 forward and backward in bf16,
  then ``main --test`` on their ``configs/test/*_device.yaml`` twins;
- the serving deployment: the three serving paths exported as artifacts
  (``vsr_tpu_torch.export``), served by the HTTP daemon
  (``vsr_tpu_torch.serve``) and as online streams
  (``vsr_tpu_torch.stream``), and phase 7's checkpoint through the daemon's
  live backend;
- quantized serving (int8 weights, W8A8 convs through ``w8a8_conv``);
- the training knobs: ``grad_accumulation``, ``grad_clip`` and
  ``ema_decay`` in the host-loop DRF trainer (K1 forward and backward) and
  inside the device trainers' captured graphs, ``qat``, ``infer --ema
  --gif``, and a QAT-trained EDSRNet served W8A8;
- the rest of the feedback family and the MoE routers: DRFSISRNet (K1)
  trained, tested and served, DRFNet with experts, sub-pixel deconvs and
  ``remat``, MoEEDSRNet's ``sort`` / ``radix`` routers and ``dense_nhwc``
  dispatch (K3 with ``rank_pallas``), the step-stacked nets through an
  artifact, the daemon and a frame stream;
- the offline tools to a tested checkpoint: raw ACDC NIfTIs and raw DSB15
  DICOMs of the script's own making through the port's CLIs
  (``vsr_tpu_torch.io.dicom``, ``preprocess.dsb15`` and ``preprocess.acdc``
  with ``--backend torch`` on the card, ``preprocess.cropping``), then
  ``configs/train/acdc_vsr_drf_x2.yaml`` trained on the processed tree with
  ``native_decode``, ``async_ckpt`` and ``profile_dir`` (K1 forward and
  backward) and ``main --test`` on ``configs/test/acdc_vsr_drf_x2.yaml``
  with the cropping's ``coordinates.pkl``.

Phases; any failure exits non-zero and prints no result. They run in this
order: 1-6 and 16 alone on the card and the host; then three lanes,
processes of this script started together, run 10 and 11; 14, 17 and 18;
15 and 19, beside this process's 7, 9 and 12 (each lane that trains
writes phase 7a's tree for itself; every process runs on 2 CPU threads;
12 and 15, the two largest, take turns on a file lock); then 13 alone. A lane's output is printed when it ends, with the
host's busy cores and the card's utilization while the lanes ran. The
step times, rates and latencies of phases 7, 9-12, 14, 15 and 17-19 are
taken while the lanes share the card and the host's cores; the kernel
times of 3, 6, 13 and 16 are not:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``vsr_tpu_torch/csrc/*.cu`` with nvcc, prints the time
   (the native NIfTI decoder, ``csrc_host/vsr_native.cpp``, is built with
   g++ at its first use, in phase 17);
3. kernel vs twin: every kernel against its plain PyTorch twin on the card
   at the shapes its path gives it (K1: every squeeze shape of a DRFNet
   frame step, f32 and bf16, without and with its PReLU epilogue, plus a
   ragged case off every tile and off 16-byte alignment; K3: 43 200 rows of
   256 affinities, bit-equal, plus many ties, a ragged row length and a row
   count off the rows per block; K2: one chunk of 100 windows at
   96 x 96 with 5 x 5 filters, plus an odd geometry), with max error, median
   CUDA-event times (device time: the host queues ahead of the card) of
   kernel, twin and (where one exists) the one PyTorch
   call that computes the same function, and the bound: the least time the
   card could take, from the bytes moved and the operations done;
4. paths: each path is served by the port's infer CLI on small NIfTI volumes
   (192 x 192, one slice, 30 frames) with its kernel on and off, and through
   the same pipeline without file I/O on full volumes (192 x 192 x 10 x 30).
   Every kernel's launch count is set to 0 before a run and read after it:
   a run with the kernel on must launch it the expected number of times, a
   run with it off never. Outputs with the kernel on and off must agree
   (MoE: identically; DRF, DUF: >= 99.9 % exact grey values, <= 1 grey);
5. card vs CPU: a small volume of each path served on the card (kernels)
   and on the CPU (plain twins) must agree at that same bar;
6. K1 backward vs twin: ``concat_conv1x1``'s gradients (dx_i, dW, db and
   the PReLU weight's) against autograd through the twin, float32, for
   alpha 0.2, 0 and -0.3, at the training shapes (N = 16, 32 x 32 and
   64 x 64, 2-6 parts), one serving shape and the ragged shape; the bars are
   the forward's for dx and 1e-5 of the sum of the terms' magnitudes for the
   sums over pixels (outputs within 1e-4 of the PReLU's kink get no upstream
   gradient: the side of the kink is the forward's rounding); times one
   frame step's 12 squeezes forward + backward, and the dx launches alone,
   against ``torch.cat`` + library conv + ``prelu`` under autograd; the
   dW / db kernel of that backward against its own twin (f32 and bf16, two
   launches bit-equal; also rows of pixels off 16 bytes, off the kernel's
   step and tiles, and pointers off 16 bytes) and against cuDNN's weight
   and bias gradient, with its bound by bytes beside its bound at the
   float32 rate; then the same in bf16 under float32 master weights (what
   bf16 training hands K1) against autograd through the twin in bf16, at
   the training shapes and at the device-epoch config's (N = 8, 32 x 32 and
   64 x 64): the activated output at twice the bf16 forward's bar, dx at
   that bar, dW / db / dalpha within 1e-2 of their terms' magnitudes, timed
   against ``torch.cat`` + library bf16 conv + ``prelu``;
7. training: writes a seeded, low-passed (learnable) processed tree; trains
   DRFNet through ``run_train`` with K1 on, on again and off from one seed,
   and EDSRNet once. Gates: K1's forward launches are 12 per frame step of
   every train and validation forward, its dx launches and its dW / db
   launches 12 per frame step of every train step, all 0 with the kernel
   off; the first loss on
   vs off within 1e-4 relative; the loss falls; ``model_best.ckpt`` exists;
   no parameter is NaN. Then the trained checkpoint is served by the infer
   CLI (``--checkpoint``) and must equal the trainer's own validation output
   to <= 1 grey; one batch's loss and gradients on the card (K1) agree with
   the CPU (twin); a SIGTERM after 3 steps writes ``model_preempt.ckpt`` and
   the resumed run finishes the epoch. SRFBNet is trained with K1 on and off
   (first loss within 1e-4 relative; 48 forward, 48 dx and 48 dW / db
   launches per train step with it on, 0 with it off). Then ``main --test``
   runs on the best checkpoints of SRFBNet, DRFNet and EDSRNet (the test
   split is the validation split again): a row per frame, a PNG per frame,
   a GIF per sequence, K1's launches counted, and the mean PSNR of
   ``results.csv`` within 0.01 dB of the validation PSNR the trainer logged
   for that checkpoint. Prints step times, rates and peak memory with the
   kernel on and off, and the test runs' frames/s;
8. (``--profile``) ``torch.profiler`` traces;
9. the MISR / FRVSR slice: DUF trained with K2 on (its launches equal the
   validation windows, none in the train steps; the running statistics
   moved; the validation windows through the plain softmax + filter equal
   the validation pass's K2 output to 1e-4; the served checkpoint equals the
   trainer's validation output to <= 1 grey; ``main --test`` within
   0.01 dB), MoE-EDSR trained with K3 and
   with the plain rank (8 launches a train step; first losses equal), then
   TOFlow, RBPN, EDVR x4 and FRVSR x4; each net's first batch on the card
   against the CPU (loss <= 1e-4 relative, gradients <= 1e-3 of their own
   largest entry where K1 or K3 runs in the step, of the net's largest
   entry where none does; MoE mask first), step times,
   patches/s, peak memory; ``main --test`` on FRVSR;
10. the volumetric slice: a tree of 3 patients of 12 slices of 192 x 192 x
   30 (2 train, 1 valid, which is the test split too, cut to its first 10
   frames), low-passed like phase 7's; Volume3DSRNet and Volume4DSRNet trained through ``run_train``
   (no parameter NaN, ``model_best.ckpt``; the first batch on the card
   against the CPU: loss <= 1e-4 relative, gradients <= 1e-3 of the net's
   largest entry; 4D: the first step's gradients with ``remat`` on and off
   within 1e-6 of the net's largest entry, with the peak memory of both),
   the trained checkpoint served by the infer CLI in volume mode (= the
   trainer's validation output to <= 1 grey), ``main --test`` (a row per
   frame, the NIfTI shapes, mean PSNR within 0.01 dB of the trainer's
   validation PSNR), 2 full 192 x 192 x 10 x 30 volumes through
   ``make_pipeline`` with ``fused_tail`` on and off (>= 99.9 % exact grey,
   <= 1 grey; frames/s, ms a volume, peak memory); every kernel's launch
   count reads 0 throughout;
11. the device-epoch trainers: the four ``configs/train/*_device.yaml``
   (EDSRNet 16 x 64 bf16, DRFNet F=64 G=6 bf16 ``carry_f32``, Volume3DSRNet
   8 x 32 bf16, Volume4DSRNet 4 x 32 f32 ``remat``) trained through
   ``run_train`` at their widths, batches, patches and steps per epoch for
   one epoch (the train split resident on the card, each trainer's step
   captured once as a CUDA graph after 3 eager steps and replayed, the
   replayed step timed as the window of CUDA events from the first replay
   to the last over the replays; no parameter NaN, all float32); the DRF
   config also with ``carry_f32``
   removed and ``fused_squeeze`` on and off (K1 forward, dx and dW / db in
   bf16 training under the graph: 12 launches of each per frame step of
   every train step, counted as the calls per step that the counters read
   times the eager steps and replays, 0 off; the batch and patch are the
   shapes phase 6 held K1 at; first loss on vs off within 1e-2 relative);
   8 steps of that config eagerly and through the graph
   from the same draws (per-step losses within 1e-5 relative); the DRF
   device checkpoint resumed by the host-loop ``AcdcVSRTrainer`` for one
   epoch; ``main --test`` on the four ``configs/test/*_device.yaml`` (mean
   PSNR within 0.01 dB of the trainer's validation PSNR; the volume twins
   write no files: phase 10 gates their predictors' NIfTI); a trace of 20
   replayed steps of each run (device time, idle share, and K1's kernels
   counted per replay against the launch count);
12. the serving deployment: (a) the DRF (K1), MoE (K3) and DUF (K2)
   pipelines exported with ``torch.export`` at (300, 192, 192) on the
   card, saved, loaded back and run on a noise volume: equal to
   ``make_pipeline``'s and to the kernel-off program's (the DRF one exported
   with ``fused_squeeze: false``) at >= 99.9 % exact grey, <= 1 grey, with
   360 K1 / 8 K3 / 3 K2 launches a volume; (b) one HTTP daemon
   (``serve.make_server`` on 127.0.0.1, a thread) per artifact, each taking
   8 .npy volumes from 8 closed-loop clients, DRF also a NIfTI volume and
   two half volumes that share one program call; every response against
   the artifact called directly (the same bar; how many are bit-equal is
   printed), ``/metrics`` counting the requests, the launches = per volume
   x program calls; the p50 and the largest of the 8 request latencies
   and volumes/s through HTTP beside the direct call's; (c) the streams: DRF
   ``RecurrentStream`` (12 K1 a push), MoE ``FrameStream`` (8 K3 a push),
   DUF ``WindowStream`` (one K2 an emitted output, boundary frames by
   ``flush``) and Volume4DSRNet (``configs/train/acdc_4d_vol_x2.yaml``, no
   kernel), 30 pushes of (10, 192, 192) each against the batch pipeline of
   the same volume, median push latency; (d) phase 7's DRF checkpoint
   through the daemon's live backend (NIfTI in, .nii.gz out) against the
   output ``infer --checkpoint`` served in phase 7;
13. quantized serving: (a) the W8A8 kernel (``csrc/w8a8_conv.cu``) against
   its twin at every eligible conv shape of EDSRNet x2 (16 x 64,
   ``configs/test/acdc_sisr_edsr_x2.yaml``), DRFNet x2 (F=64 G=6) and
   DUFNet x2 (``--windows 7 --chunk 100``) at full width: the int32
   accumulators bit-equal, the outputs within 1e-6 of the largest entry
   (float32) or one bf16 ulp, float32 and bf16, dynamic and static scale, on
   the first 2 items of each batch; at the full shape the kernel's median
   time against its bound (bytes at 3.35 TB/s, int8 operations at 1,979
   TOPS) and the share of it reached, the kernel and tiles the shape takes
   (``kernel_plan``), the per-tap kernel's time at the shape
   (``PER_TAP_W8A8_MS``),
   cuDNN's bf16 conv and unfold + ``torch._int_mm`` (its accumulators
   equal the kernel's); (b) the pipelines on a 192 x 192 x 10 x 30 volume of
   phase 7's low-passed sequences with the trained checkpoints of phases 7
   and 9: EDSRNet f32 and bf16 unquantized, ``--int8``, ``--w8a8`` (lazy)
   and ``--w8a8-scales``; DRFNet unquantized, ``--int8`` (K1 360 a volume on
   dequantized weights) and W8A8 with callback-calibrated scales (K1 still
   360, the k6 s2 convs through the kernel); DUFNet unquantized and
   ``--w8a8`` (K2 3): frames/s against the unquantized run, weight bytes,
   launches = calibrated convs x calls, PSNR against the HR volume within
   0.05 dB (int8) and 0.5 dB (W8A8) of the unquantized run's; (c) W8A8 and
   int8 artifacts of the EDSR net exported, loaded and run against the live
   pipelines, and the daemon's live backend with ``--w8a8-scales``
   answering 2 requests;
14. the training knobs, on phase 7's tree: (a) DRFNet F=64 G=6
   (``configs/train/acdc_vsr_drf_x2.yaml``, ``fused_squeeze`` on) with
   ``grad_accumulation: 2``, ``grad_clip: 1.0``, ``ema_decay: 0.999``
   through ``run_train`` for one epoch (8 micro-steps, 4 updates): K1's 60
   forward, 60 dx and 60 dW / db launches a micro-step, the EMA equal to
   the recursion over the updates' parameters, a run preempted after 3
   micro-steps (an accumulation in progress) and resumed against the
   straight run (1e-3 of each tensor's largest entry), 8 batches of 4 on
   the card against the CPU (first loss 1e-4 relative, parameters and EMA
   1e-3 of each tensor's largest entry); (b) ``infer --ema --gif`` on its
   checkpoint, 2 slices of a 192 x 192 x 10 x 30 volume: 360 K1 launches,
   a GIF of 30 frames a slice decoded to the SR's truncated frames, the
   output against a net given the checkpoint's EMA by hand (<= 1 grey); (c) the EDSR device
   config with the knobs and ``qat: true``: two captured graphs against
   the eager epoch (per-step losses 1e-5 relative), the replayed step; the
   DRF bf16 K1 device config with accumulation (K1 captured in both
   graphs); SGD with momentum and Adagrad replayed; (d) EDSRNet 16 x 64
   trained one epoch with ``qat: true``, served ``--w8a8`` on one slice of
   that volume (34 launches a volume); the fake-quant forward against the W8A8 one at
   ``tests/test_qat.py``'s bar (2e-3): conv by conv on the trained net's
   W8A8 inputs, and whole at that test's geometry (its 2 x 16 net, 8 LR
   patches of 8 x 8); both unlike the unquantized forward (> 1e-4);
15. the feedback family and the MoE routers, on phase 7's tree: (a)
   ``configs/train/acdc_sisr_srfb_x2.yaml`` with its net swapped for
   DRFSISRNet at the same width (F=64, G=6, 4 steps, ``fused_squeeze``),
   one epoch through ``run_train`` (K1 48 forward, 48 dx and 48 dW / db a
   train step, 48 forward a validation frame; the loss falls), one batch
   on the card against the CPU, ``main --test`` on the checkpoint (48 a
   frame, PSNR within 0.01 dB), the infer CLI on the checkpoint against the
   trainer's validation output (<= 1 grey) and a 192 x 192 x 10 x 30
   volume served in frame mode on it (the last step); (b) DRFNet F=64 G=6:
   4 experts served a volume (K1 360, K3 none), sub-pixel deconvs on and
   off on the same weights (f32 at the grey bar, bf16 printed, frames/s of
   both), ``remat`` on and off for 2 SGD steps with cuDNN's deterministic
   algorithms (gradients 1e-3 of each
   gradient's largest entry, peak memory, the recompute's K1 launches); (c)
   MoEEDSRNet (``configs/test/acdc_sisr_moe_x2.yaml``) under ``rank_pallas``
   with each dispatch, ``sort`` / ``sparse`` and ``radix`` / ``dense`` at
   1, 4 and 8 bits: the masks first (on every layer's affinities of one
   volume, bit-equal to the rank kernel's), each output against the rank
   kernel's with the same dispatch (identical) or, for ``dense_nhwc``,
   with ``dense`` (phase 4b's 99.5 % exact), K3 8 a volume with
   ``rank_pallas`` and none with the others, frames/s; (d) SRFBNet and
   DRFSISRNet through an artifact, the daemon (2 requests) and a frame
   stream (30 pushes), each against ``make_pipeline``'s last step at the
   grey bar, K1 counted on each route; (e) small nets on the card against
   the CPU: SRFBNet with sub-pixel deconvs (f32) and bf16 ``carry_f32``
   (within twice the CPU's own bf16 error), RBPNet with sub-pixel deconvs,
   FRVSRNet with ``remat`` (and remat on against off);
16. W8A8 deconvs, the serving presets, the tuner and bf16 training of the
   nets moved onto the precision policy: (a) the W8A8 kernel on the
   sub-pixel banks of the k6 s2 p2 (64 -> 256, LR 96) and k8 s4 p2 (64 ->
   1024, LR 48) transposed convs (``quantize_deconvs``): int32 bit-equal
   to its twin and to the unfused int8 transposed conv, outputs at phase
   13a's bars, its median ms against its byte bound and cuDNN's float32
   and bf16 transposed convs; (b) ``infer --preset tuned`` and ``--preset
   fast`` against no preset on one low-passed 192 x 192 x 10 x 30 volume
   for EDSRNet, DUFNet (K2), DRFNet (K1) and MoEEDSRNet (K3) at the test
   configs' widths: frames/s, launches a volume gated (each kernel per net
   call, W8A8 where the preset sets it: phase 13's convs a net call),
   the pipeline built by ``infer.serving_pipelines``, tuned at the grey
   bar of no
   preset (where it changes the MoE dispatch, phase 4b's bar for the two
   dispatches: >= 99.5 % exact), fast's PSNR within 0.5 dB; EDSR
   ``export --preset fast``
   (``--calib``) and ``serve --preset fast`` against the fast pipeline at
   the grey bar; (c) ``python -m vsr_tpu_torch.tune`` on EDSRNet at (300,
   192, 192) with chunks 0 / 100, its file through ``infer --preset-file``
   (the same knobs); (d) ``tune --train`` on MoEEDSRNet and Volume4DSRNet,
   4 steps a row, no row an error; (e) one bf16 train step of MoEEDSRNet,
   DUFNet, EDVRNet, FRVSRNet (``carry_f32``), RBPNet, TOFlowNet and
   Volume4DSRNet (``carry_f32``) at their test configs' widths, a batch
   of 2, through ``DeviceEpochTrainer`` (L1, Adam), on the card against
   the CPU: losses within the larger of 1e-4 relative and twice the CPU's
   own bf16 error of the loss, outputs within twice the CPU's own bf16
   error, parameters float32;
17. the offline tools to a tested checkpoint: (a) a raw ACDC tree
   (``training/patient00{1,2,3}``, ``testing/patient101``, each a (216,
   256, 2, 30) int16 4D NIfTI: ACDC's in-plane size and frame count, 2
   slices, a low-passed background with a beating disc) and a raw DSB15
   DICOM tree (``train/1/study/sax_5``, 30 explicit-VR frames of 256 x 192,
   ``validate/2/study/sax_7``, 30 implicit-VR frames, ``train/1/study/
   sax_6``, 20 frames; file names shuffled against InstanceNumber); (b)
   the CLIs as processes: ``io.dicom`` (its arrays equal the pixels
   written), ``preprocess.dsb15 --backend torch`` (the 20-frame series
   absent) and ``preprocess.acdc --backend torch``, their HR frames/s and
   the share of wall time in the downscale calls and in the NIfTI writes;
   (c) every LR file against the numpy backend's downscale of its HR
   sequence in memory (>= 98 % exact, <= 1 grey; each frame file equal to
   its video's frame), a numpy-backend run of one patient (its HR files
   byte-equal; its HR frames/s), ``preprocess.cropping`` on the valid and
   the test HR videos into one directory (every patient in
   ``coordinates.pkl``, a box holding the disc); (d) the native decoder
   built at its first use, decode ms a file, native against Python; the first 64 training samples bit-equal with
   ``native_decode`` on and off; ``acdc_vsr_drf_x2.yaml`` (F=64, G=6, batch
   16) for 2 epochs on the processed tree with ``native_decode``,
   ``async_ckpt`` and ``profile_dir`` (K1 launches as in phase 7; a trace
   after epoch 2 and none after epoch 1, naming K1's kernel; the last
   asynchronous checkpoints equal to a synchronous save of the trainer's
   state tensor for tensor; the ms the loop blocks in an async and a sync
   save); (e) ``main --test`` on ``configs/test/acdc_vsr_drf_x2.yaml`` on
   the test patient (finite CardiacPSNR / CardiacSSIM, K1 12 a frame);
18. data-parallel training on phase 7's tree: ``python -m
   vsr_tpu_torch.main`` as separate processes that join through
   ``main.distributed``'s ``VSR_*`` variables, ``acdc_vsr_drf_x2.yaml``
   (DRFNet F=64 G=6 through K1, global batch 16, ``host_shard``,
   ``drop_last``: one epoch of 7 steps and its validation pass); (a) one
   rank over NCCL with ``mesh_axes: {data: 1}`` and ``sharded_ckpt``:
   every step's loss within 1e-4 of the same run without a mesh (in this
   process), K1's forward, dx and dW / db launches under DDP, the step ms
   with and without DDP; ``convert --consolidate`` of its sharded
   checkpoint and ``infer --checkpoint`` on the sharded main file and on
   the consolidated one (the same volume to 1 grey); a seeded DRFNet's flax
   variables written as ``vsr_tpu``'s sharded-v1 layout of two processes
   by the port's writer and served directly against the plain flax file
   of the same variables (to 1 grey); (b) two ranks sharing the card over
   gloo, on CUDA tensors: ``data: 2``, then with ``zero_optim``, then with
   ``fsdp``, each rank's backend and device, the parameters after the
   epoch within 1e-3 of each leaf's largest entry of run (a)'s; (c)
   ``acdc_sisr_edsr_x2_device.yaml`` (bf16) with ``mesh_axes: {data: 1}``
   over NCCL for 40 steps: the gradients' all-reduce inside the captured
   graph, the per-step losses within 1e-4 of the run without a mesh, the
   replayed step ms against that run's;
19. ``--mesh`` serving and the ``model`` / ``expert`` axes, as separate
   processes given ``torchrun``'s variables: (a) ``make_pipeline(mesh=)``
   of DRFNet x2 (F=64, G=6) with ``--mesh data=1`` on a 192 x 192 x 10 x 30
   volume (two calls: the second warm) and ``infer --mesh data=1`` on its
   first slice, as the one rank of an NCCL group, against the same
   pipeline without a mesh in this process (no pixel more than one grey
   apart; K1 360 launches a call); then two ranks sharing the card over
   gloo: (b) ``--mesh model=2`` of DRFNet on that slice through the
   pipeline (K1 at F = 32 on each rank, 360 launches a rank and call; at
   the same bar) and ``--mesh expert=2`` of MoE-EDSR x2 (``rank_pallas``,
   sparse) through the pipeline and the CLI (K3 on the rows of 2 of 4
   experts, 8 launches a rank and call; within one grey and < 1 % of
   pixels different); (c) 4 steps of 16 of
   ``acdc_sisr_moe_x2.yaml`` with ``{expert: 2}`` and of
   ``acdc_vsr_drf_x2.yaml`` (K1) with ``{model: 2}``: each step's loss
   within 1e-4 of the run without a mesh, the parameters within 1e-3 of a
   leaf's largest entry or JAX's own bar of these tests (``rtol`` 5e-4,
   ``atol`` 1e-5), each split leaf and its Adam moments 1/2 a rank;
   (d) ``serve --mesh expert=2`` answers 2 requests (within the expert
   bar) while the follower rank runs the same calls, and both ranks shut
   down;
20. prints the kernels' JSON line, then the final JSON line.

``--profile`` adds one ``torch.profiler`` trace of a full volume per serving
path (f32, and bf16 for DRFNet; the two volume nets) and of 6 train steps
per training path, the MISR / FRVSR and volume nets included (device time
by kernel, idle share, K1's own kernels against the PyTorch rest of its
backward) to the details, and whether the DRF f32 pipeline repeats its bits
with ``cudnn.deterministic`` off and on, at what cost a volume.

``--quantized`` runs only the build and phase 13 (seeded weights where no
trained checkpoint exists) and prints a summary line. ``--knobs`` runs only
the build, phase 7's tree and phase 14, and ``--feedback`` the build, phase
7's tree and phase 15, ``--presets`` the build and phase 16; each prints
a summary line. ``--preset-table [NET ...]`` runs only the build and the
sweep behind ``vsr_tpu_torch/presets.py``'s table: ``python -m
vsr_tpu_torch.tune`` on each net at (300, 192, 192) in its serving mode,
then W8A8 on and off at the winning knobs (first-batch calibration, or
callback scales for the nets whose convs run in their frame or step
loops), frames/s and PSNR on a low-passed volume.

``--offline`` runs only the build and phase 17, prints a summary line and
the final JSON line; ``--parallel`` the build, phase 7's tree and phase 18,
and ``--mesh-axes`` the build, phase 7's tree and phase 19, then the same
two lines.

``--latency N`` runs only the build, phase 12a and phase 12b with N
requests per client (8 N a daemon; a p99 is printed from 100 on), then
traces one volume through the DRF artifact and through ``make_pipeline``
(device kernels and host operators, and where their totals differ).

Usage: python3 chip_smoke.py [--out details.json] [--profile | --latency N |
                             --quantized | --knobs | --feedback |
                             --presets | --preset-table [NET ...] |
                             --offline | --parallel | --mesh-axes]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

FACTOR, HR, T_FRAMES = 2, 192, 30
LR = HR // FACTOR
FULL_SLICES, FULL_VOLUMES = 10, 2   # volumes through make_pipeline, no I/O
CLI_SLICES, CLI_VOLUMES = 1, 1      # volumes through the infer CLI
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# bytes/s, float32 FLOP/s outside the tensor cores, dense bf16 FLOP/s.
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12

# --- DRFNet (video mode, K1) -------------------------------------------------
F_, G_ = 64, 6
DRF_KWARGS = dict(in_channels=1, out_channels=1, num_features=F_,
                  num_groups=G_, upscale_factor=FACTOR)
# Squeezes of one DRFNet frame step through the kernel: {(k inputs, side): count}.
# LR: the input squeeze (k=2), the LR ladder (k=2..6), the output fuse (k=6);
# HR: the HR ladder (k=2..6).
STEP_SQUEEZES = {(2, LR): 2, (3, LR): 1, (4, LR): 1, (5, LR): 1, (6, LR): 2,
                 (2, HR): 1, (3, HR): 1, (4, HR): 1, (5, HR): 1, (6, HR): 1}
SQUEEZES_PER_STEP = sum(STEP_SQUEEZES.values())  # 12
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 kernel vs the f32 twin on the same bf16-rounded operands: one bf16
# rounding of the output (rtol), plus f32 summation-order noise near 0 (atol).
BF16_TOL = dict(atol=1e-4, rtol=8e-3)

# --- MoEEDSRNet (frame mode, K3) ---------------------------------------------
MOE_KWARGS = dict(in_channels=1, out_channels=1, num_resblocks=16,
                  num_features=64, upscale_factor=FACTOR, num_experts=4,
                  group_size=256, moe_every=2)
MOE_LAYERS = MOE_KWARGS["num_resblocks"] // MOE_KWARGS["moe_every"]  # 8
# Rows the router ranks for one full volume: frames x groups x experts.
RANK_ROWS = (FULL_SLICES * T_FRAMES * (LR * LR // MOE_KWARGS["group_size"])
             * MOE_KWARGS["num_experts"])  # 43 200

# --- DUFNet (window mode, K2) ------------------------------------------------
DUF_KWARGS = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5,
                  upscale_factor=FACTOR, backbone="_DenseLayer16")
DUF_CHUNK = 100
DUF_TOL = 1e-4  # f32 kernel vs twin, the bar of the JAX kernel's own test


def log(msg: str) -> None:
    print(msg, flush=True)


SPIN_CYCLES = 40_000_000  # ~20 ms of the card's clock


def median_ms(fn, reps: int = 20, spins: int = 1) -> float:
    """Median device time of one call of ``fn``. The calls are queued behind
    a spin of the card, so the host, which needs tens of microseconds to
    enqueue a call, runs ahead of it: a short kernel's time is then the
    card's and not the host's. ``spins``: that many spins, for a call that
    costs the host a millisecond (a forward and backward through autograd)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(spins):
        torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def within(got: torch.Tensor, ref: torch.Tensor, atol: float,
           rtol: float) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def bound(n_bytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): every input byte read
    once and every output byte written once at the memory rate, against the
    operations at the peak rate for their type."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# ============================================================ kernel vs twin


def library_squeeze_prelu(xs, w4, b, alpha):
    """The library's form of a squeeze and its activation: ``torch.cat``, the
    1x1 conv, ``prelu`` (timed beside the kernel, used nowhere in the port)."""
    return torch.nn.functional.prelu(
        torch.nn.functional.conv2d(torch.cat(xs, dim=1), w4, b), alpha)


def squeeze_ragged_case(dev, gen) -> dict:
    """K1 off every tile and off 16-byte rows (9 x 13 pixels, channels 3, 17
    and 40, 70 output channels), with the epilogue: the kernel's
    element-wise load and store path against the twin."""
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_reference)

    channels, f_out = (3, 17, 40), 70
    xs = [torch.randn(2, c, 9, 13, generator=gen).to(dev) for c in channels]
    w = (torch.rand(f_out, sum(channels), generator=gen) - 0.5).to(dev)
    b = (torch.rand(f_out, generator=gen) - 0.5).to(dev)
    alpha = torch.full((1,), 0.2, device=dev)
    res = {}
    with torch.inference_mode():
        for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                                 ("bf16", torch.bfloat16, BF16_TOL)):
            ops = [t.to(dtype) for t in (*xs, w, b, alpha)]
            got = concat_conv1x1(ops[:3], *ops[3:]).float()
            ref = concat_conv1x1_reference(
                [t.float() for t in ops[:3]], *(t.float() for t in ops[3:]))
            torch.cuda.synchronize()
            res[f"{name}_max_abs_err"] = (got - ref).abs().max().item()
            ok = got.shape == ref.shape and within(got, ref, **tol)
            log(f"  K1 ragged (9x13, channels {channels}, F={f_out}, PReLU) "
                f"{name}: err {res[f'{name}_max_abs_err']:.3g} "
                f"({'ok' if ok else 'FAIL'})")
            if not ok:
                raise SystemExit(f"K1 disagrees with its twin on the ragged "
                                 f"{name} case")
    return res


def phase_kernel_squeeze(dev) -> dict:
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_reference)

    n = FULL_SLICES
    gen = torch.Generator().manual_seed(1)
    prelu = torch.nn.functional.prelu
    alpha32 = torch.full((1,), 0.2, device=dev)
    alpha16 = alpha32.bfloat16()
    rows = []
    for (k, side) in sorted(STEP_SQUEEZES):
        xs32 = [torch.randn(n, F_, side, side, generator=gen).to(dev)
                for _ in range(k)]
        scale = (k * F_) ** -0.5
        w32 = ((torch.rand(F_, k * F_, generator=gen) * 2 - 1) * scale).to(dev)
        b32 = ((torch.rand(F_, generator=gen) * 2 - 1) * scale).to(dev)
        xs16 = [x.bfloat16() for x in xs32]
        w16, b16 = w32.bfloat16(), b32.bfloat16()
        elements = n * side * side * (k * F_ + F_) + F_ * k * F_ + F_
        flops = 2.0 * n * side * side * k * F_ * F_
        with torch.inference_mode():
            got32 = concat_conv1x1(xs32, w32, b32)
            ref32 = concat_conv1x1_reference(xs32, w32, b32)
            got16 = concat_conv1x1(xs16, w16, b16).float()
            ref16 = concat_conv1x1_reference(
                [x.float() for x in xs16], w16.float(), b16.float())
            # The PReLU epilogue: against twin-then-PReLU, and bit for bit
            # the separate PReLU on the kernel's own output.
            act32 = concat_conv1x1(xs32, w32, b32, alpha32)
            raw16 = concat_conv1x1(xs16, w16, b16)
            act16 = concat_conv1x1(xs16, w16, b16, alpha16)
            w4_32, w4_16 = w32[:, :, None, None], w16[:, :, None, None]
            torch.cuda.synchronize()
            row = {
                "k": k, "side": side, "count_per_step": STEP_SQUEEZES[k, side],
                "f32_max_abs_err": (got32 - ref32).abs().max().item(),
                "f32_ok": within(got32, ref32, **F32_TOL),
                "bf16_max_abs_err": (got16 - ref16).abs().max().item(),
                "bf16_ok": within(got16, ref16, **BF16_TOL),
                "f32_act_max_abs_err":
                    (act32 - prelu(ref32, alpha32)).abs().max().item(),
                "f32_act_ok": within(act32, prelu(ref32, alpha32), **F32_TOL)
                and torch.equal(act32, prelu(got32, alpha32)),
                "bf16_act_max_abs_err":
                    (act16.float() - prelu(ref16, alpha32)).abs().max().item(),
                "bf16_act_ok":
                    within(act16.float(), prelu(ref16, alpha32), **BF16_TOL)
                    and torch.equal(act16, prelu(raw16, alpha16)),
                "f32_act_ms": median_ms(
                    lambda: concat_conv1x1(xs32, w32, b32, alpha32)),
                "f32_act_library_ms": median_ms(
                    lambda: library_squeeze_prelu(xs32, w4_32, b32, alpha32)),
                "bf16_act_ms": median_ms(
                    lambda: concat_conv1x1(xs16, w16, b16, alpha16)),
                "bf16_act_library_ms": median_ms(
                    lambda: library_squeeze_prelu(xs16, w4_16, b16, alpha16)),
                "f32_ms": median_ms(lambda: concat_conv1x1(xs32, w32, b32)),
                "f32_plain_ms": median_ms(
                    lambda: concat_conv1x1_reference(xs32, w32, b32)),
                "bf16_ms": median_ms(lambda: concat_conv1x1(xs16, w16, b16)),
                "bf16_plain_ms": median_ms(
                    lambda: concat_conv1x1_reference(xs16, w16, b16)),
                "f32_bytes": 4 * elements, "bf16_bytes": 2 * elements,
                "flops": flops,
            }
        rows.append(row)
        log(f"  K1 k={k} {side}x{side} N={n}: f32 err "
            f"{row['f32_max_abs_err']:.3g} ({'ok' if row['f32_ok'] else 'FAIL'})"
            f" kernel {row['f32_ms']:.4f} ms twin {row['f32_plain_ms']:.4f} ms"
            f" | bf16 err {row['bf16_max_abs_err']:.3g} "
            f"({'ok' if row['bf16_ok'] else 'FAIL'}) kernel "
            f"{row['bf16_ms']:.4f} ms twin {row['bf16_plain_ms']:.4f} ms")
        log(f"     with PReLU: f32 err {row['f32_act_max_abs_err']:.3g} "
            f"({'ok' if row['f32_act_ok'] else 'FAIL'}) kernel "
            f"{row['f32_act_ms']:.4f} ms library conv + prelu "
            f"{row['f32_act_library_ms']:.4f} ms | bf16 err "
            f"{row['bf16_act_max_abs_err']:.3g} "
            f"({'ok' if row['bf16_act_ok'] else 'FAIL'}) kernel "
            f"{row['bf16_act_ms']:.4f} ms library "
            f"{row['bf16_act_library_ms']:.4f} ms")
    bad = [(r["k"], r["side"]) for r in rows
           if not (r["f32_ok"] and r["bf16_ok"] and r["f32_act_ok"]
                   and r["bf16_act_ok"])]
    if bad:
        raise SystemExit(f"K1 disagrees with its twin at {bad}")
    ragged = squeeze_ragged_case(dev, gen)

    def per_step(key):
        return sum(r[key] * r["count_per_step"] for r in rows)

    summary = {key: per_step(key) for key in
               ("f32_ms", "f32_plain_ms", "bf16_ms", "bf16_plain_ms",
                "f32_act_ms", "f32_act_library_ms", "bf16_act_ms",
                "bf16_act_library_ms", "f32_bytes", "bf16_bytes", "flops")}
    summary["f32_bound_ms"], summary["f32_bound_by"] = bound(
        summary["f32_bytes"], summary["flops"], PEAK_F32)
    summary["bf16_bound_ms"], summary["bf16_bound_by"] = bound(
        summary["bf16_bytes"], summary["flops"], PEAK_BF16)
    log(f"  K1, one frame step's {SQUEEZES_PER_STEP} squeezes (N={n}): f32 "
        f"kernel {summary['f32_ms']:.4f} ms vs twin (torch.cat + library 1x1 "
        f"conv) {summary['f32_plain_ms']:.4f} ms, bound "
        f"{summary['f32_bound_ms']:.4f} ms by {summary['f32_bound_by']}; bf16 "
        f"kernel {summary['bf16_ms']:.4f} ms vs twin "
        f"{summary['bf16_plain_ms']:.4f} ms, bound "
        f"{summary['bf16_bound_ms']:.4f} ms by {summary['bf16_bound_by']}")
    log(f"  K1 with its PReLU epilogue, same {SQUEEZES_PER_STEP} squeezes: f32 "
        f"kernel {summary['f32_act_ms']:.4f} ms vs torch.cat + library conv + "
        f"prelu {summary['f32_act_library_ms']:.4f} ms; bf16 kernel "
        f"{summary['bf16_act_ms']:.4f} ms vs {summary['bf16_act_library_ms']:.4f}"
        f" ms (bounds as above: the epilogue moves no further byte)")
    return {"rows": rows, "per_step": summary, "ragged": ragged,
            "f32_max_abs_err": max(
                max(r["f32_max_abs_err"], r["f32_act_max_abs_err"])
                for r in rows),
            "bf16_max_abs_err": max(
                max(r["bf16_max_abs_err"], r["bf16_act_max_abs_err"])
                for r in rows)}


def argsort_rank(af: torch.Tensor) -> torch.Tensor:
    """The one-call library form of the rank: the inverse permutation of a
    stable descending argsort (timed beside the kernel, used nowhere in the
    port)."""
    order = torch.argsort(af, dim=-1, descending=True, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(
        af.shape[-1], device=af.device).expand_as(order))
    return rank.int()


def phase_kernel_rank(dev) -> dict:
    from vsr_tpu_torch.ops.rank import pairwise_rank, pairwise_rank_reference

    gen = torch.Generator().manual_seed(2)
    groups, e, gs = RANK_ROWS // 4, 4, 256
    # Softmax affinities in the router's (G, e, gs) layout.
    af = torch.randn(groups, gs, e, generator=gen).softmax(-1).transpose(
        1, 2).contiguous().to(dev)
    cases = {
        "affinities": af,
        # Many exact ties: 16 distinct values per row of 256.
        "ties": (af * 64).round().div(64).contiguous(),
        # A row length the TPU kernel refuses (not a multiple of 128).
        "ragged_gs200": torch.rand(1000, 4, 200, generator=gen).to(dev),
        # A row count that is no multiple of the 4 rows a block takes.
        "ragged_rows1001": torch.rand(1001, gs, generator=gen).to(dev),
    }
    res = {}
    for name, a in cases.items():
        got, ref = pairwise_rank(a), pairwise_rank_reference(a)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        res[name] = {"shape": list(a.shape), "mismatches": mismatches}
        log(f"  K3 {name} {tuple(a.shape)}: {mismatches} ranks differ from "
            f"the twin ({'ok' if not mismatches else 'FAIL'})")
        if mismatches or got.dtype != torch.int32:
            raise SystemExit(f"K3 disagrees with its twin on {name}")
    if not torch.equal(pairwise_rank(af), argsort_rank(af)):
        raise SystemExit("K3 disagrees with the stable argsort's ranks")
    rows = af.numel() // gs
    res["ms"] = median_ms(lambda: pairwise_rank(af))
    res["plain_ms"] = median_ms(lambda: pairwise_rank_reference(af), reps=5)
    res["library_ms"] = median_ms(lambda: argsort_rank(af))
    # One compare per (i, j) pair, against the float32 rate.
    res["bytes"], res["ops"] = 2 * 4 * rows * gs, float(rows) * gs * gs
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"], PEAK_F32)
    res["max_abs_err"] = 0.0  # bit-equal int32 ranks, checked above
    log(f"  K3 {rows} rows x {gs}: kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms, stable argsort + scatter "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}")
    return res


def phase_kernel_duf(dev) -> dict:
    from vsr_tpu_torch.ops.duf_filter import (duf_dynamic_filter,
                                              duf_dynamic_filter_reference)

    gen = torch.Generator().manual_seed(3)
    res, inputs = {}, {}
    # (N, H, W, size, upscale): one --chunk 100 call; an odd geometry.
    for name, (n, h, w, k, r) in {"chunk": (DUF_CHUNK, LR, LR, 5, FACTOR),
                                  "odd": (3, 9, 12, 3, 3)}.items():
        x = torch.randn(n, h, w, generator=gen).to(dev)
        logits = (2 * torch.randn(n, k * k * r * r, h, w, generator=gen)).to(dev)
        inputs[name] = (x, logits, k, r)
        with torch.inference_mode():
            got = duf_dynamic_filter(x, logits, k, r)
            ref = duf_dynamic_filter_reference(x, logits, k, r)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = err <= DUF_TOL and got.shape == (n, h * r, w * r)
        res[name] = {"shape": [n, h, w, k, r], "max_abs_err": err}
        log(f"  K2 {name} x ({n}, {h}, {w}) k={k} r={r}: err {err:.3g} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            raise SystemExit(f"K2 disagrees with its twin on {name}")
    args = inputs["chunk"]
    n, h, w, k, r = res["chunk"]["shape"]
    with torch.inference_mode():
        res["ms"] = median_ms(lambda: duf_dynamic_filter(*args))
        res["plain_ms"] = median_ms(lambda: duf_dynamic_filter_reference(*args))
    # Logits and x read once, the output written once; per logit a compare,
    # a subtract, an exponential, an add and a multiply-add (5 operations).
    res["bytes"] = 4 * n * h * w * (k * k * r * r + 1 + r * r)
    res["ops"] = 5.0 * n * h * w * k * k * r * r
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"], PEAK_F32)
    res["max_abs_err"] = max(res["chunk"]["max_abs_err"],
                             res["odd"]["max_abs_err"])
    log(f"  K2 x ({n}, {h}, {w}) k={k} r={r}: kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']} (no single library call computes it)")
    return res


# ================================================================= the paths


def make_volume(seed: int, slices: int) -> np.ndarray:
    """(H, W, D, T) float32 volume of integer noise in [0, 255] (bench.py's
    synthetic data)."""
    rng = np.random.default_rng(seed)
    return np.round(rng.random((HR, HR, slices, T_FRAMES)) * 255).astype(
        np.float32)


def as_frames(vol: np.ndarray) -> np.ndarray:
    """(H, W, D, T) -> (D*T, H, W), as the infer CLI regroups a volume (no
    crop at 192: a multiple of 12; float input skips the outlier clip)."""
    h, w, d, t = vol.shape
    return np.ascontiguousarray(np.moveaxis(vol.reshape(h, w, d * t), -1, 0))


def agreement(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float((diff == 0).mean()), float(diff.max())


def check_sr(name: str, sr: np.ndarray, shape: tuple) -> None:
    if sr.shape != shape or not (np.isfinite(sr).all() and sr.min() >= 0
                                 and sr.max() <= 255):
        raise SystemExit(f"{name}: bad SR output, shape {sr.shape}")


def kernel_counters() -> dict:
    """Kernel name -> the wrapper that carries its launch count."""
    from vsr_tpu_torch.ops.duf_filter import duf_dynamic_filter
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_dw)
    from vsr_tpu_torch.ops.rank import pairwise_rank
    from vsr_tpu_torch.ops.w8a8_conv import w8a8_conv

    return {"concat_conv1x1": concat_conv1x1,
            "concat_conv1x1_dw": concat_conv1x1_dw,
            "duf_dynamic_filter": duf_dynamic_filter,
            "pairwise_rank": pairwise_rank, "w8a8_conv": w8a8_conv}


def reset_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
    kernel_counters()["concat_conv1x1"].backward_launches = 0


def check_launches(name: str, kernel: str, want: int,
                   want_backward: int = 0) -> int:
    """The run just made launched ``kernel`` exactly ``want`` times (and, in
    K1's backward, its dx launch and its dW / db kernel ``want_backward``
    times each) and no other kernel of the port at all."""
    counts = {k: fn.launches for k, fn in kernel_counters().items()}
    counts["concat_conv1x1 backward"] = kernel_counters()[
        "concat_conv1x1"].backward_launches
    expected = {k: (want if k == kernel else 0) for k in counts}
    expected["concat_conv1x1 backward"] = want_backward
    expected["concat_conv1x1_dw"] = want_backward
    if counts != expected:
        raise SystemExit(f"{name}: kernel launches {counts}, expected "
                         f"{expected}")
    return counts[kernel]


@dataclasses.dataclass
class Path_:
    """One serving path: its net, its kernel, the CLI flags and the
    ``make_pipeline`` arguments of its mode, the net's arguments with the
    kernel on and off, and how often one volume of ``slices`` slices
    launches the kernel."""

    key: str
    net: str
    kernel: str
    cli_flags: list
    on: dict
    off: dict
    pipe_kw: Callable[[int], dict]        # frames per slice -> arguments
    launches_per_volume: Callable[[int], int]
    identical: bool  # kernel on/off outputs must be identical


PATHS = [
    Path_("drf", "DRFNet", "concat_conv1x1", ["--video", "--fused-tail"],
          dict(DRF_KWARGS, fused_squeeze=True),
          dict(DRF_KWARGS, fused_squeeze=False),
          lambda t: dict(video_t=t),
          lambda slices: SQUEEZES_PER_STEP * T_FRAMES, identical=False),
    # One net call per volume (no --chunk): every MoE layer ranks once.
    Path_("moe", "MoEEDSRNet", "pairwise_rank", [],
          dict(MOE_KWARGS, router_impl="rank_pallas"),
          dict(MOE_KWARGS, router_impl="rank"),
          lambda t: dict(),
          lambda slices: MOE_LAYERS, identical=True),
    # One launch per chunk of windows (the last chunk is padded).
    Path_("duf", "DUFNet", "duf_dynamic_filter",
          ["--windows", str(DUF_KWARGS["num_frames"]), "--chunk",
           str(DUF_CHUNK)],
          dict(DUF_KWARGS, use_pallas_filter=True),
          dict(DUF_KWARGS, use_pallas_filter=False),
          lambda t: dict(window=(DUF_KWARGS["num_frames"], t, "middle"),
                         chunk=DUF_CHUNK),
          lambda slices: -(-slices * T_FRAMES // DUF_CHUNK), identical=False),
]


def serve_cli(path: Path_, src: Path, out: Path, kwargs: dict) -> dict:
    """The port's infer CLI (f32), as a user runs it."""
    from vsr_tpu_torch import infer

    return infer.main([str(src), str(out), "--psnr", *path.cli_flags,
                       "--net", path.net, "--net-kwargs", json.dumps(kwargs)])


def build_net(path: Path_, kwargs: dict, dev, bf16: bool = False):
    """The seeded net the CLI builds for these arguments."""
    from vsr_tpu_torch.registry import build

    kwargs = dict(kwargs)
    if bf16:
        kwargs["dtype"] = torch.bfloat16
    if "--fused-tail" in path.cli_flags:
        kwargs["fused_tail"] = True
    return build("net", {"name": path.net, "kwargs": kwargs}, device=dev,
                 generator=torch.Generator().manual_seed(0))


def run_pipeline(path: Path_, kwargs: dict, frames: list[np.ndarray], dev,
                 bf16: bool = False, t: int | None = None):
    """The CLI's pipeline without its NIfTI I/O: the same seeded net, the
    same host-to-device copy, pipeline and device-to-host copy per volume.
    Returns the SR frames and frames/s."""
    from vsr_tpu_torch.infer import make_pipeline

    pipe = make_pipeline(build_net(path, kwargs, dev, bf16), FACTOR, "acdc",
                         **path.pipe_kw(t or T_FRAMES))
    start = time.perf_counter()
    outs = [pipe(torch.from_numpy(f).to(dev))[1].cpu().numpy() for f in frames]
    return outs, sum(len(f) for f in frames) / (time.perf_counter() - start)


def compare_on_off(path: Path_, what: str, on: list, off: list) -> dict:
    stats = [agreement(a, b) for a, b in zip(on, off)]
    res = {"exact_fraction": min(e for e, _ in stats),
           "max_grey_diff": max(m for _, m in stats)}
    log(f"  {path.key} {what}, kernel on vs off: "
        f"{res['exact_fraction'] * 100:.4f}% exact, max "
        f"{res['max_grey_diff']:g} grey")
    if path.identical and res["max_grey_diff"] != 0:
        raise SystemExit(f"{path.key} {what}: the kernel's selection differs "
                         "from the plain router's (outputs not identical)")
    if res["exact_fraction"] < 0.999 or res["max_grey_diff"] > 1:
        raise SystemExit(f"{path.key} {what}: kernel-on and kernel-off SR "
                         "outputs disagree")
    return res


def phase_path_cli(path: Path_, tmp: Path, card: str) -> dict:
    """The path through the infer CLI, kernel on and off: small NIfTI
    volumes in, .nii.gz out (the level-9 gzip write of a full volume takes
    about a minute, so the CLI runs get one-slice volumes)."""
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti

    src = tmp / f"{path.key}_volumes"
    for i in range(CLI_VOLUMES):
        save_nifti(make_volume(10 + i, CLI_SLICES),
                   src / f"patient{i:03d}" / f"patient{i:03d}_4d.nii")
    runs, srs = {}, {}
    for mode, kwargs in (("on", path.on), ("off", path.off)):
        name = f"{path.key}_cli_{mode}"
        reset_launches()
        stats = serve_cli(path, src, tmp / name, kwargs)
        want = (path.launches_per_volume(CLI_SLICES) * CLI_VOLUMES
                if mode == "on" else 0)
        stats["launches"] = check_launches(name, path.kernel, want)
        if not np.isfinite(stats["psnr_mean"]):
            raise SystemExit(f"{name}: non-finite PSNR")
        srs[mode] = [load_nifti(tmp / name / f"patient{i:03d}"
                                / f"patient{i:03d}_4d_sr.nii.gz")
                     for i in range(CLI_VOLUMES)]
        for sr in srs[mode]:
            check_sr(name, sr, (HR, HR, CLI_SLICES, T_FRAMES))
        runs[mode] = stats
        log(f"  {name} (infer CLI, {CLI_VOLUMES} volumes of {HR}x{HR}x"
            f"{CLI_SLICES}x{T_FRAMES}): {stats['frames']} frames, end to end "
            f"{stats['frames_per_sec']:.2f} frames/s, pipeline "
            f"{stats['pipeline_frames_per_sec']:.2f} frames/s, PSNR "
            f"{stats['psnr_mean']:.3f} dB, {path.kernel} launches "
            f"{stats['launches']} [{card}]")
    return {"runs": runs,
            "on_vs_off": compare_on_off(path, "CLI", srs["on"], srs["off"])}


def phase_path_full(path: Path_, variants: dict, frames, warm, card: str,
                    dev) -> tuple[dict, dict]:
    """Full volumes through ``make_pipeline`` without file I/O. ``variants``:
    name -> (net kwargs, bf16, kernel on). Returns the runs' statistics and
    their SR frames, both by name."""
    runs, srs = {}, {}
    for name, (kwargs, bf16, kernel_on) in variants.items():
        run_pipeline(path, kwargs, warm, dev, bf16)  # library handles, caches
        reset_launches()
        srs[name], fps = run_pipeline(path, kwargs, frames, dev, bf16)
        want = (path.launches_per_volume(FULL_SLICES) * len(frames)
                if kernel_on else 0)
        runs[name] = {
            "frames": sum(len(f) for f in frames),
            "pipeline_frames_per_sec": fps,
            "launches": check_launches(f"{path.key} {name}", path.kernel, want)}
        for sr in srs[name]:
            check_sr(name, sr, (FULL_SLICES * T_FRAMES, HR, HR))
        log(f"  {path.key} {name} (pipeline, no file I/O, {len(frames)} "
            f"volumes of {HR}x{HR}x{FULL_SLICES}x{T_FRAMES}): pipeline "
            f"{fps:.2f} frames/s, {path.kernel} launches "
            f"{runs[name]['launches']} [{card}]")
    return runs, srs


def phase_paths(tmp: Path, card: str, dev) -> dict:
    frames = [as_frames(make_volume(20 + i, FULL_SLICES))
              for i in range(FULL_VOLUMES)]
    warm = [as_frames(make_volume(99, FULL_SLICES))]
    drf, moe, duf = PATHS
    res = {}

    log("phase 4a: DRFNet, video mode (K1 concat_conv1x1)")
    runs, srs = phase_path_full(drf, {
        "f32_fused": (drf.on, False, True),
        "f32_unfused": (drf.off, False, False),
        "bf16_fused": (drf.on, True, True),
        "bf16_unfused": (drf.off, True, False)}, frames, warm, card, dev)
    checks = {"f32": compare_on_off(drf, "full f32", srs["f32_fused"],
                                    srs["f32_unfused"])}
    exact, worst = zip(*(agreement(a, b) for a, b in
                         zip(srs["bf16_fused"], srs["bf16_unfused"])))
    checks["bf16"] = {"exact_fraction": min(exact), "max_grey_diff": max(worst)}
    log(f"  drf full bf16, kernel on vs off: {min(exact) * 100:.4f}% exact, "
        f"max {max(worst):g} grey (not gated: bf16 roundings compound over "
        f"{T_FRAMES} recurrent frames)")
    res["drf"] = {"full": runs, "full_on_vs_off": checks,
                  "cli": phase_path_cli(drf, tmp, card)}

    log("phase 4b: MoEEDSRNet, frame mode (K3 pairwise_rank)")
    runs, srs = phase_path_full(moe, {
        "rank_pallas_sparse": (moe.on, False, True),
        "rank_pallas_dense": (dict(moe.on, dispatch_impl="dense"), False, True),
        "rank_dense": (dict(moe.off, dispatch_impl="dense"), False, False)},
        frames, warm, card, dev)
    checks = {"dense": compare_on_off(moe, "full dense",
                                      srs["rank_pallas_dense"],
                                      srs["rank_dense"])}
    exact, worst = zip(*(agreement(a, b) for a, b in
                         zip(srs["rank_pallas_sparse"],
                             srs["rank_pallas_dense"])))
    checks["sparse_vs_dense"] = {"exact_fraction": min(exact),
                                 "max_grey_diff": max(worst)}
    # The two dispatches run their expert FFNs as products of other shapes,
    # so they differ in the last bits; a later layer's router can then flip
    # a token at a capacity boundary, which moves a few pixels by several
    # grey values. Gated on the share of exact pixels only, at 99.5 %: a
    # handful of flips among 33 million pixels, not a wrong dispatch.
    log(f"  moe full, sparse vs dense dispatch: {min(exact) * 100:.4f}% "
        f"exact, max {max(worst):g} grey (isolated router flips)")
    if min(exact) < 0.995:
        raise SystemExit("moe: sparse and dense dispatch outputs disagree")
    res["moe"] = {"full": runs, "full_on_vs_off": checks,
                  "cli": phase_path_cli(moe, tmp, card)}

    log("phase 4c: DUFNet, window mode (K2 duf_dynamic_filter)")
    runs, srs = phase_path_full(duf, {
        "kernel": (duf.on, False, True),
        "plain": (duf.off, False, False)}, frames, warm, card, dev)
    checks = {"f32": compare_on_off(duf, "full f32", srs["kernel"],
                                    srs["plain"])}
    res["duf"] = {"full": runs, "full_on_vs_off": checks,
                  "cli": phase_path_cli(duf, tmp, card)}
    return res


def phase_cpu_reference(dev) -> dict:
    """A small volume of each path through the same seeded net on the card
    (kernels) and on the CPU (plain twins).

    DRF and DUF go through the whole pipeline on both devices. The MoE net
    routes discretely: the two devices' k-space LR frames differ by one grey
    value in about one pixel of a thousand (they are rounded), and such a
    pixel flips tokens at capacity boundaries layer after layer, so its
    pipelines cannot be held to a per-pixel bar. Its net is therefore fed the
    CPU's normalized LR frames on both devices."""
    from vsr_tpu_torch.infer import make_prep
    from vsr_tpu_torch.utils.normalize import DATASET_STATS

    rng = np.random.default_rng(7)
    frames = np.round(rng.random((3, 48, 48)) * 255).astype(np.float32)
    mean, std = DATASET_STATS["acdc"]
    res = {}
    for path in PATHS:
        outs = {}
        for device in ("cpu", dev):
            reset_launches()
            if path.identical:
                z = make_prep(FACTOR, "acdc")(torch.from_numpy(frames))[1]
                with torch.inference_mode():
                    sr = build_net(path, path.on, device).eval()(z.to(device))
                sr = torch.clamp(torch.round(sr[:, 0].float() * std + mean),
                                 0.0, 255.0).cpu().numpy()
            else:
                (sr,), _ = run_pipeline(path, path.on, [frames], device, t=3)
            launched = kernel_counters()[path.kernel].launches
            if (launched > 0) != (device != "cpu"):
                raise SystemExit(f"{path.key} on {device}: {launched} launches")
            outs[str(device)] = sr
        exact, worst = agreement(outs[str(dev)], outs["cpu"])
        res[path.key] = {"exact_fraction": exact, "max_grey_diff": worst}
        log(f"  {path.key} card vs CPU, 48^2 x 3 frames"
            f"{' (net on shared LR frames)' if path.identical else ''}: SR "
            f"{exact * 100:.3f}% exact (max {worst:g})")
        if exact < 0.999 or worst > 1:
            raise SystemExit(f"{path.key}: card and CPU SR outputs disagree")
    return res


def device_rows(prof) -> list[tuple[str, float, int]]:
    """(name, self device ms, calls) of a trace's device kernels and copies,
    largest first. Host-side operators are left out (they carry their
    kernels' device time a second time), and so are the device-side spans of
    user annotations such as ``Optimizer.step``."""
    from torch.autograd import DeviceType

    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])


def phase_profile(dev) -> dict:
    """One ``torch.profiler`` trace per path (f32, and bf16 for DRFNet;
    kernel on, one full volume through ``make_pipeline``): self device time
    by kernel, and the idle share against the median wall time of 3
    unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    from vsr_tpu_torch.infer import make_pipeline

    frames = torch.from_numpy(as_frames(make_volume(30, FULL_SLICES)))
    res = {}
    for path in PATHS:
        variants = {"on": (path.on, False)}
        if path.key == "moe":
            variants["on_dense"] = (dict(path.on, dispatch_impl="dense"), False)
        if path.key == "drf":
            variants["on_bf16"] = (path.on, True)
        for name, (kwargs, bf16) in variants.items():
            pipe = make_pipeline(build_net(path, kwargs, dev, bf16), FACTOR,
                                 "acdc", **path.pipe_kw(T_FRAMES))

            def once():
                out = pipe(frames.to(dev))[1].cpu()
                torch.cuda.synchronize()
                return out

            once()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                once()
                walls.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                once()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            rows = device_rows(prof)
            busy, wall = sum(r[1] for r in rows), statistics.median(walls)
            res[f"{path.key}_{name}"] = {
                "wall_ms": wall, "busy_ms": busy,
                "idle_share": 1 - busy / wall, "peak_memory_gb": peak_gb,
                "top": [{"kernel": k[:100], "ms": ms, "calls": c}
                        for k, ms, c in rows[:20]]}
            log(f"  profile {path.key} {name}: wall {wall:.1f} ms, busy "
                f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, peak "
                f"memory {peak_gb:.2f} GB")
            for k, ms, c in rows[:12]:
                log(f"    {ms:9.2f} ms {c:6d} x {k[:90]}")
    return res


# ============================================================ training slice

TRAIN_N, TRAIN_T, TRAIN_LR = 16, 5, 32   # configs/train/acdc_vsr_drf_x2.yaml
TRAIN_HR = TRAIN_LR * FACTOR
# Squeezes of one DRFNet frame step at the training patch size.
TRAIN_SQUEEZES = {(k, TRAIN_LR if side == LR else TRAIN_HR): count
                  for (k, side), count in STEP_SQUEEZES.items()}
TRAIN_EPOCHS = 2  # the loss must fall from the first epoch to the last
# configs/train/acdc_vsr_drf_x2_device.yaml: batches of 8 patches of
# TRAIN_LR x TRAIN_LR, the shapes K1 gets in device-epoch training.
DEVICE_N = 8
TREE_SEQUENCES = {"train": (2, 2), "valid": (1, 2)}  # patients, slices each
# The test split holds the validation sequences again, so that what
# ``main --test`` scores is what the trainer's validation pass scored.
TEST_FRAMES = TREE_SEQUENCES["valid"][0] * TREE_SEQUENCES["valid"][1] * T_FRAMES
# configs/train/acdc_sisr_srfb_x2.yaml: SRFBNet F=64 G=6, 4 feedback steps,
# each with the 12 squeezes of a DRFNet frame step.
SRFB_STEPS = 4
SRFB_KWARGS = dict(in_channels=1, out_channels=1, num_steps=SRFB_STEPS,
                   num_features=F_, num_groups=G_, upscale_factor=FACTOR)
# A heart box inside the 192 x 192 frames for the Cardiac* metrics.
HEART_BOX = (48, 144, 40, 152)
# main --test against the trainer's validation pass of the same checkpoint,
# in dB: the same weights, data and batch-1 forward; what may differ is
# cuDNN's choice of algorithm between two processes' worth of calls.
TEST_PSNR_TOL = 0.01
ALPHAS = (0.2, 0.0, -0.3)
# Gradient bars. dx sums F products like the forward: the forward's bar.
# dW, db and the PReLU weight's gradient sum up to N * H * W = 65 536
# float32 terms in another order than the twin's autograd, so each is held
# to 1e-5 of the sum of the terms' magnitudes (a wrong term is off by O(1)).
SUM_TOL = 1e-5
# The PReLU's derivative jumps by (1 - alpha) at 0. Where the pre-activation
# is within the forward's bar of 0, the kernel's and the twin's last bits may
# fall on different sides of the kink; which side is a question of the
# forward's rounding, not of the backward, so the upstream gradient is zeroed
# there (for both) before the gradients are compared.
KINK = 1e-4


def squeeze_grads(fn, xs, w, b, alpha, g):
    """Forward through ``fn``, backward with ``g``: (dxs, dW, db, dalpha)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (*xs, w, b, alpha)]
    out = fn(leaves[:len(xs)], *leaves[len(xs):])
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads[:len(xs)], *grads[len(xs):]


def backward_case(name, xs, w, b, g, dev) -> dict:
    """One shape, alpha 0.2 / 0 / -0.3: the Function's gradients against
    autograd through the twin, in float32."""
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_dw,
                                                 concat_conv1x1_reference)

    n_px = xs[0].shape[0] * xs[0].shape[2] * xs[0].shape[3]
    with torch.no_grad():
        pre = concat_conv1x1_reference(xs, w, b)
    near_kink = pre.abs() < KINK
    g = g.masked_fill(near_kink, 0.0)
    abs_g = g.abs().flatten(2)
    res = {"dx": 0.0, "dw": 0.0, "db": 0.0, "dalpha": 0.0, "ok": True,
           "near_kink": int(near_kink.sum())}
    for a in ALPHAS:
        alpha = torch.full((1,), a, device=dev)
        before = (concat_conv1x1.launches, concat_conv1x1.backward_launches,
                  concat_conv1x1_dw.launches)
        out, dxs, dw, db, da = squeeze_grads(concat_conv1x1, xs, w, b, alpha, g)
        counted = (concat_conv1x1.launches - before[0],
                   concat_conv1x1.backward_launches - before[1],
                   concat_conv1x1_dw.launches - before[2])
        ref, rxs, rw, rb, ra = squeeze_grads(concat_conv1x1_reference, xs, w,
                                             b, alpha, g)
        torch.cuda.synchronize()
        # The PReLU scales g where the pre-activation is negative.
        g_pre = torch.where(pre > 0, abs_g.view_as(g), abs(a) * abs_g.view_as(g))
        dw_scale = torch.cat([torch.bmm(g_pre.flatten(2),
                                        x.abs().flatten(2).transpose(1, 2))
                              for x in xs], dim=2).sum(0)
        checks = {
            "out": within(out, ref, **F32_TOL),
            "dx": all(within(d, r, **F32_TOL) for d, r in zip(dxs, rxs)),
            "dw": bool(((dw - rw).abs() <= SUM_TOL * dw_scale + 1e-6).all()),
            "db": bool(((db - rb).abs()
                        <= SUM_TOL * g_pre.sum(dim=(0, 2, 3)) + 1e-6).all()),
            "dalpha": bool((da - ra).abs()
                           <= SUM_TOL * (abs_g.view_as(g) * pre.abs()).sum() + 1e-6),
            "launches": counted == (1, 1, 1),
        }
        res["dx"] = max(res["dx"], max((d - r).abs().max().item()
                                       for d, r in zip(dxs, rxs)))
        res["dw"] = max(res["dw"], (dw - rw).abs().max().item())
        res["db"] = max(res["db"], (db - rb).abs().max().item())
        res["dalpha"] = max(res["dalpha"], (da - ra).abs().item())
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            res["ok"] = False
            log(f"  K1 backward {name} alpha={a}: FAIL {bad}")
    log(f"  K1 backward {name} ({n_px} pixels, alpha in {ALPHAS}; "
        f"{res['near_kink']} of {pre.numel()} outputs within {KINK:g} of the "
        f"PReLU's kink left out): max err dx {res['dx']:.3g}, dW "
        f"{res['dw']:.3g}, db {res['db']:.3g}, dalpha {res['dalpha']:.3g} "
        f"({'ok' if res['ok'] else 'FAIL'})")
    return res


def dw_case(name, xs, g) -> dict:
    """K1's dW / db kernel against its plain twin on the same operands, in
    float32 and in bfloat16 (the twin then in float32 on the rounded
    operands; the kernel sums in float32 either way), each within
    ``SUM_TOL`` of the sum of its terms' magnitudes; two launches must give
    the same bits (no atomics)."""
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1_dw,
                                                 concat_conv1x1_dw_reference)

    res = {"ok": True}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ops, gg = [x.to(dtype) for x in xs], g.to(dtype)
        with torch.no_grad():
            before = concat_conv1x1_dw.launches
            dw, db = concat_conv1x1_dw(ops, gg)
            again = concat_conv1x1_dw(ops, gg)
            launched = concat_conv1x1_dw.launches - before
            floats = [x.float() for x in ops]
            rw, rb = concat_conv1x1_dw_reference(floats, gg.float())
            # The twin on the magnitudes: the sums of |g| |x| and of |g|.
            sw, sb = concat_conv1x1_dw_reference([x.abs() for x in floats],
                                                 gg.float().abs())
        torch.cuda.synchronize()
        res[f"{label}_dw"] = (dw - rw).abs().max().item()
        res[f"{label}_db"] = (db - rb).abs().max().item()
        ok = (dw.dtype == db.dtype == torch.float32 and dw.shape == rw.shape
              and db.shape == rb.shape and launched == 2
              and bool(((dw - rw).abs() <= SUM_TOL * sw + 1e-6).all())
              and bool(((db - rb).abs() <= SUM_TOL * sb + 1e-6).all())
              and torch.equal(dw, again[0]) and torch.equal(db, again[1]))
        res["ok"] = res["ok"] and ok
    log(f"  K1 dW/db kernel {name}: max err f32 dW {res['f32_dw']:.3g} db "
        f"{res['f32_db']:.3g} | bf16 dW {res['bf16_dw']:.3g} db "
        f"{res['bf16_db']:.3g}, two launches bit-equal "
        f"({'ok' if res['ok'] else 'FAIL'})")
    return res


# K1's backward in bf16 under float32 master weights (what bf16 training
# hands it: ``FusedSqueezeConv`` casts W and b to bf16 at use) against
# autograd through the twin's squeeze in float32 on the same bf16-rounded
# operands (the forward's reference: the library's bf16 conv rounds its own
# way), rounded to bf16 before the PReLU as the kernel's output is: dx at
# the bf16 forward's bar; the activated output at twice its rtol (two bf16
# roundings, the squeeze's and the PReLU's, and the squeeze's may fall on
# either side of a tie: one ulp, 0.78 % at worst, then the PReLU's); dW, db
# (rounded to bf16 by the kernel's path, as in the JAX backward) and the
# PReLU weight's gradient within 1e-2 of the sum of their terms' magnitudes.
BF16_SUM_TOL = 1e-2
BF16_ACT_TOL = dict(atol=BF16_TOL["atol"], rtol=2 * BF16_TOL["rtol"])


def backward_case_bf16(name, xs, w, b, g, dev) -> dict:
    """One shape, alpha 0.2 / 0 / -0.3: the kernel's bf16 gradients against
    the float32 twin's on the bf16-rounded operands, with float32 leaves
    for W, b and alpha."""
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_reference)

    bf = torch.bfloat16
    xs16, g16 = [x.to(bf) for x in xs], g.to(bf)
    with torch.no_grad():
        pre = concat_conv1x1_reference(xs16, w.to(bf), b.to(bf)).float()
    near_kink = pre.abs() < KINK
    g16 = g16.masked_fill(near_kink, 0.0)
    abs_g = g16.float().abs()
    res = {"dx": 0.0, "dw": 0.0, "db": 0.0, "dalpha": 0.0, "ok": True,
           "near_kink": int(near_kink.sum())}

    def kernel(xs_, w_, b_, a_):
        return concat_conv1x1(xs_, w_.to(bf), b_.to(bf), a_)

    def twin(xs_, w_, b_, a_):
        # The squeeze in float32 on the rounded operands, its output rounded
        # to bf16 and the PReLU in bf16, as on the kernel's path: both
        # backwards then see the same bf16 gradient at the squeeze's output.
        out = concat_conv1x1_reference(xs_, w_.to(bf).float(),
                                       b_.to(bf).float()).to(bf)
        return torch.nn.functional.prelu(out, a_.to(bf))

    for a in ALPHAS:
        alpha = torch.full((1,), a, device=dev)
        out, dxs, dw, db, da = squeeze_grads(kernel, xs16, w, b, alpha, g16)
        ref, rxs, rw, rb, ra = squeeze_grads(
            twin, [x.float() for x in xs16], w, b, alpha, g16)
        torch.cuda.synchronize()
        g_pre = torch.where(pre > 0, abs_g, abs(a) * abs_g)
        dw_scale = torch.cat([torch.bmm(g_pre.flatten(2),
                                        x.float().abs().flatten(2)
                                        .transpose(1, 2))
                              for x in xs16], dim=2).sum(0)
        checks = {
            "types": (out.dtype == bf and all(d.dtype == bf for d in dxs)
                      and dw.dtype == db.dtype == da.dtype == torch.float32),
            "out": within(out.float(), ref.float(), **BF16_ACT_TOL),
            "dx": all(within(d.float(), r.float(), **BF16_TOL)
                      for d, r in zip(dxs, rxs)),
            "dw": bool(((dw - rw).abs()
                        <= BF16_SUM_TOL * dw_scale + 1e-6).all()),
            "db": bool(((db - rb).abs()
                        <= BF16_SUM_TOL * g_pre.sum(dim=(0, 2, 3)) + 1e-6
                        ).all()),
            "dalpha": bool((da - ra).abs() <= BF16_SUM_TOL
                           * (abs_g * pre.abs()).sum() + 1e-6)}
        res["dx"] = max(res["dx"], max((d.float() - r.float()).abs().max()
                                       .item() for d, r in zip(dxs, rxs)))
        res["dw"] = max(res["dw"], (dw - rw).abs().max().item())
        res["db"] = max(res["db"], (db - rb).abs().max().item())
        res["dalpha"] = max(res["dalpha"], (da - ra).abs().item())
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            res["ok"] = False
            log(f"  K1 bf16 backward {name} alpha={a}: FAIL {bad}")
    log(f"  K1 bf16 backward {name} (float32 master W, b, alpha; "
        f"{res['near_kink']} outputs at the PReLU's kink left out): max err "
        f"dx {res['dx']:.3g}, dW {res['dw']:.3g}, db {res['db']:.3g}, dalpha "
        f"{res['dalpha']:.3g} ({'ok' if res['ok'] else 'FAIL'})")
    return res


def phase_kernel_squeeze_backward(dev) -> dict:
    """K1's gradient on the card against the twin's autograd, and one frame
    step's 12 squeezes forward + backward against ``torch.cat`` + library
    conv + ``prelu`` under autograd."""
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_dw,
                                                 concat_conv1x1_dw_reference)

    gen = torch.Generator().manual_seed(4)

    def operands(n, channels, f_out, h, w):
        xs = [torch.randn(n, c, h, w, generator=gen).to(dev) for c in channels]
        scale = sum(channels) ** -0.5
        wt = ((torch.rand(f_out, sum(channels), generator=gen) * 2 - 1)
              * scale).to(dev)
        b = ((torch.rand(f_out, generator=gen) * 2 - 1) * scale).to(dev)
        g = torch.randn(n, f_out, h, w, generator=gen).to(dev)
        return xs, wt, b, g

    cases, bf16_cases, dw_cases, rows = {}, {}, {}, []
    alpha = torch.full((1,), 0.2, device=dev)
    for (k, side), count in sorted(TRAIN_SQUEEZES.items()):
        xs, w, b, g = operands(TRAIN_N, (F_,) * k, F_, side, side)
        name = f"train k={k} {side}x{side} N={TRAIN_N}"
        cases[name] = backward_case(name, xs, w, b, g, dev)
        bf16_cases[name] = backward_case_bf16(name, xs, w, b, g, dev)
        dw_cases[name] = dw_case(name, xs, g)
        # The library's form of dW and db: cuDNN's weight and bias gradient
        # of the 1x1 conv on the concatenated input.
        w4 = w[:, :, None, None].clone().requires_grad_(True)
        b1 = b.clone().requires_grad_(True)
        conv_out = torch.nn.functional.conv2d(torch.cat(xs, dim=1), w4, b1)
        with torch.no_grad():
            dw_times = {
                "dw_ms": median_ms(lambda: concat_conv1x1_dw(xs, g)),
                "dw_plain_ms": median_ms(
                    lambda: concat_conv1x1_dw_reference(xs, g))}
        dw_times["dw_library_ms"] = median_ms(lambda: torch.autograd.grad(
            conv_out, (w4, b1), g, retain_graph=True))
        del conv_out
        leaves = [t.requires_grad_(True) for t in (*xs, w, b, alpha)]

        # dx alone, as the backward launches it: the kernel on g with the
        # weight W^T and no bias.
        w_t, zero = w.detach().t().contiguous(), torch.zeros(k * F_, device=dev)

        def dx_kernel():
            with torch.no_grad():
                return concat_conv1x1([g], w_t, zero)

        def fwd_kernel():
            return concat_conv1x1(xs, w, b, alpha)

        def fwd_library():
            return library_squeeze_prelu(xs, w[:, :, None, None], b, alpha)

        def both(fwd):
            return lambda: torch.autograd.grad(fwd(), leaves, g)

        def backward_only(fwd):
            out = fwd()
            return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

        # bf16 training: bf16 activations and gradient, float32 masters
        # cast to bf16 at use (FusedSqueezeConv), against the same under
        # autograd through torch.cat + the library's bf16 conv + prelu.
        xs16, g16 = [x.detach().bfloat16() for x in xs], g.bfloat16()
        leaves16 = [t.requires_grad_(True) for t in (*xs16, w, b, alpha)]

        def fwd_kernel16():
            return concat_conv1x1(xs16, w.bfloat16(), b.bfloat16(), alpha)

        def fwd_library16():
            return library_squeeze_prelu(xs16, w[:, :, None, None].bfloat16(),
                                         b.bfloat16(), alpha.bfloat16())

        def both16(fwd):
            return lambda: torch.autograd.grad(fwd(), leaves16, g16)

        def backward_only16(fwd):
            out = fwd()
            return lambda: torch.autograd.grad(out, leaves16, g16,
                                               retain_graph=True)

        px = TRAIN_N * side * side
        bf16_row = {
            "bf16_fwd_bwd_ms": median_ms(both16(fwd_kernel16), spins=5),
            "bf16_fwd_bwd_library_ms": median_ms(both16(fwd_library16),
                                                 spins=5),
            "bf16_backward_ms": median_ms(backward_only16(fwd_kernel16),
                                          spins=5),
            "bf16_backward_library_ms": median_ms(
                backward_only16(fwd_library16), spins=5),
            # bf16 g, x_i and dx, W and dW as bf16 (cast at use), db f32.
            "bf16_bytes": 2 * (px * (F_ + 2 * k * F_) + 2 * k * F_ * F_)
            + 4 * F_}
        row = {"k": k, "side": side, "count_per_step": count, **bf16_row,
               "fwd_bwd_ms": median_ms(both(fwd_kernel), spins=5),
               "fwd_bwd_library_ms": median_ms(both(fwd_library), spins=5),
               "backward_ms": median_ms(backward_only(fwd_kernel), spins=5),
               "backward_library_ms": median_ms(backward_only(fwd_library),
                                                spins=5),
               "dx_ms": median_ms(dx_kernel), **dw_times,
               # dW / db alone: g and the x_i read once, dW and db written;
               # 2 N hw sum(C) F for dW and N hw F for db.
               "dw_bytes": 4 * (px * (F_ + k * F_) + k * F_ * F_ + F_),
               "dw_flops": 2.0 * px * k * F_ * F_ + px * F_,
               # g and the x_i read once, dx written once, W read, dW and db
               # written; dx = g W^T and dW = x^T g at 2 N hw sum(C) F each.
               "bytes": 4 * (px * (F_ + 2 * k * F_) + 2 * k * F_ * F_ + F_),
               "flops": 4.0 * px * k * F_ * F_}
        for t in leaves:
            t.requires_grad_(False)
        rows.append(row)
        log(f"     forward + backward kernel {row['fwd_bwd_ms']:.4f} ms, "
            f"library {row['fwd_bwd_library_ms']:.4f} ms | backward alone "
            f"kernel {row['backward_ms']:.4f} ms (its dx launch "
            f"{row['dx_ms']:.4f} ms, its dW/db kernel {row['dw_ms']:.4f} ms: "
            f"twin {row['dw_plain_ms']:.4f} ms, cuDNN wgrad + bias "
            f"{row['dw_library_ms']:.4f} ms), library "
            f"{row['backward_library_ms']:.4f} ms")
    xs, w, b, g = operands(FULL_SLICES, (F_,) * 6, F_, LR, LR)
    cases["serving k=6 96x96 N=10"] = backward_case(
        f"serving k=6 {LR}x{LR} N={FULL_SLICES}", xs, w, b, g, dev)
    dw_cases["serving k=6 96x96 N=10"] = dw_case(
        f"serving k=6 {LR}x{LR} N={FULL_SLICES}", xs, g)
    xs, w, b, g = operands(2, (3, 17, 40), 70, 9, 13)
    cases["ragged"] = backward_case("ragged 9x13, channels (3, 17, 40), F=70",
                                    xs, w, b, g, dev)
    dw_cases["ragged"] = dw_case("ragged 9x13, channels (3, 17, 40), F=70",
                                 xs, g)
    # The dW / db kernel off 16-byte rows, off its pixel step and off its
    # 64-wide tiles, and with every pointer one element off 16 bytes.
    for name, args in (
            ("rows of 8 bytes (1x2), channels (5, 130), F=9",
             (5, (5, 130), 9, 1, 2)),
            ("odd rows 33x31, channels (64, 63, 100), F=130",
             (2, (64, 63, 100), 130, 33, 31)),
            ("aligned rows off the step 20x20, channels (64, 32)",
             (4, (64, 32), F_, 20, 20))):
        xs, _, _, g = operands(*args)
        dw_cases[name] = dw_case(name, xs, g)

    def off_by_one(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    xs, _, _, g = operands(TRAIN_N, (F_, F_), F_, TRAIN_LR, TRAIN_LR)
    name = f"pointers off 16 bytes, k=2 {TRAIN_LR}x{TRAIN_LR} N={TRAIN_N}"
    dw_cases[name] = dw_case(name, [off_by_one(x) for x in xs], off_by_one(g))
    # bf16 at the shapes of device-epoch training (phase 11e).
    for (k, side) in sorted(TRAIN_SQUEEZES):
        xs, w, b, g = operands(DEVICE_N, (F_,) * k, F_, side, side)
        name = f"device k={k} {side}x{side} N={DEVICE_N}"
        bf16_cases[name] = backward_case_bf16(name, xs, w, b, g, dev)
    bad = [name for name, c in cases.items() if not c["ok"]]
    if bad:
        raise SystemExit(f"K1's backward disagrees with its twin's at {bad}")
    bad = [name for name, c in bf16_cases.items() if not c["ok"]]
    if bad:
        raise SystemExit(f"K1's bf16 backward disagrees with its twin's at "
                         f"{bad}")
    bad = [name for name, c in dw_cases.items() if not c["ok"]]
    if bad:
        raise SystemExit(f"K1's dW / db kernel disagrees with its twin at {bad}")
    summary = {key: sum(r[key] * r["count_per_step"] for r in rows)
               for key in ("fwd_bwd_ms", "fwd_bwd_library_ms", "backward_ms",
                           "backward_library_ms", "dx_ms", "bytes", "flops",
                           "dw_ms", "dw_plain_ms", "dw_library_ms",
                           "dw_bytes", "dw_flops", "bf16_fwd_bwd_ms",
                           "bf16_fwd_bwd_library_ms", "bf16_backward_ms",
                           "bf16_backward_library_ms", "bf16_bytes")}
    summary["bound_ms"], summary["bound_by"] = bound(
        summary["bytes"], summary["flops"], PEAK_F32)
    summary["dw_bound_ms"], summary["dw_bound_by"] = bound(
        summary["dw_bytes"], summary["dw_flops"], PEAK_F32)
    summary["bf16_bound_ms"], summary["bf16_bound_by"] = bound(
        summary["bf16_bytes"], summary["flops"], PEAK_BF16)
    # The kernel multiplies on the tensor cores (three TF32 products), so
    # the bytes bound it; the float32 rate outside them is the larger, and
    # the one reported.
    summary["dw_bytes_bound_ms"] = summary["dw_bytes"] / PEAK_BYTES * 1e3
    log(f"  K1 backward, one training frame step's {SQUEEZES_PER_STEP} "
        f"squeezes (N={TRAIN_N}, {TRAIN_LR}x{TRAIN_LR} patches): backward "
        f"{summary['backward_ms']:.4f} ms (of it the dx launches "
        f"{summary['dx_ms']:.4f} ms and the dW/db kernel "
        f"{summary['dw_ms']:.4f} ms: twin {summary['dw_plain_ms']:.4f} ms, "
        f"cuDNN wgrad + bias {summary['dw_library_ms']:.4f} ms, bound "
        f"{summary['dw_bound_ms']:.4f} ms by {summary['dw_bound_by']} at the "
        f"float32 rate, {summary['dw_bytes_bound_ms']:.4f} ms by bytes) vs "
        f"autograd through torch.cat + "
        f"library conv + prelu {summary['backward_library_ms']:.4f} ms, bound "
        f"{summary['bound_ms']:.4f} ms by {summary['bound_by']}; forward + "
        f"backward {summary['fwd_bwd_ms']:.4f} ms vs "
        f"{summary['fwd_bwd_library_ms']:.4f} ms")
    log(f"  K1 bf16 backward (float32 masters), the same step: backward "
        f"{summary['bf16_backward_ms']:.4f} ms vs autograd through torch.cat "
        f"+ library bf16 conv + prelu {summary['bf16_backward_library_ms']:.4f}"
        f" ms, bound {summary['bf16_bound_ms']:.4f} ms by "
        f"{summary['bf16_bound_by']}; forward + backward "
        f"{summary['bf16_fwd_bwd_ms']:.4f} ms vs "
        f"{summary['bf16_fwd_bwd_library_ms']:.4f} ms")
    return {"cases": cases, "bf16_cases": bf16_cases, "dw_cases": dw_cases,
            "rows": rows,
            "bf16_max_abs_err": max(max(c["dx"], c["dw"], c["db"])
                                    for c in bf16_cases.values()),
            "per_step": summary,
            "max_abs_err": max(max(c["dx"], c["dw"], c["db"])
                               for c in cases.values()),
            "dw_max_abs_err": max(max(c["f32_dw"], c["f32_db"])
                                  for c in dw_cases.values())}


def smooth_sequence(rng: np.random.Generator) -> np.ndarray:
    """(H, W, 1, T) uint8: noise low-passed in space and time, scaled to
    [0, 255]. Smooth enough to be learnable, unlike white noise."""
    noise = rng.standard_normal((HR, HR, T_FRAMES))
    fy = np.fft.fftfreq(HR)[:, None, None]
    fx = np.fft.fftfreq(HR)[None, :, None]
    ft = np.fft.fftfreq(T_FRAMES)[None, None, :]
    lowpass = np.exp(-(fy ** 2 + fx ** 2) / (2 * 0.04 ** 2) - ft ** 2 / (2 * 0.1 ** 2))
    smooth = np.fft.ifftn(np.fft.fftn(noise) * lowpass).real
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    return np.round(smooth * 255).astype(np.uint8)[:, :, None, :]


def make_training_tree(root: Path, dev) -> dict:
    """The processed tree the datasets glob (``videos/`` and ``imgs/``,
    ``{train,valid,test}/{HR,LR/X2}/patientNNN/...``; the test split is the
    validation split again), LR made by the port's own k-space chain on the
    card, and the ``coordinates.pkl`` of the Cardiac* metrics; files are
    written by a thread pool (gzip releases the GIL)."""
    import pickle

    from concurrent.futures import ThreadPoolExecutor

    from vsr_tpu_torch.io.nifti import save_nifti
    from vsr_tpu_torch.preprocess.kspace import kspace_downscale_torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    jobs, n_bytes, sequences = [], 0, {}
    splits = [*TREE_SEQUENCES.items(), ("test", TREE_SEQUENCES["valid"])]
    for split, (patients, slices) in splits:
        for p in range(1, patients + 1):
            for s in range(1, slices + 1):
                hr = (sequences["valid", p, s] if split == "test"
                      else smooth_sequence(rng))
                frames = torch.from_numpy(np.ascontiguousarray(
                    np.moveaxis(hr[:, :, 0], -1, 0))).float().to(dev)
                lrs = {f: np.moveaxis(kspace_downscale_torch(frames, f).cpu()
                                      .numpy(), 0, -1).astype(np.uint8)[:, :, None]
                       for f in (FACTOR, 4)}
                pat = f"patient{p:03d}"
                sequences[split, p, s] = hr
                for sub, vol in (("HR", hr), (f"LR/X{FACTOR}", lrs[FACTOR]),
                                 ("LR/X4", lrs[4])):
                    jobs.append((vol, root / "videos" / split / sub / pat
                                 / f"{pat}_2d+1d_sequence{s:02d}.nii.gz"))
                    n_bytes += vol.nbytes
                    if sub == "LR/X4":  # the x4 nets are VSR / MISR nets
                        continue
                    jobs += [(vol[..., t], root / "imgs" / split / sub / pat
                              / f"{pat}_2d_slice{s:02d}_frame{t + 1:02d}.nii.gz")
                             for t in range(T_FRAMES)]
                    n_bytes += vol.nbytes
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: save_nifti(*job), jobs))
    with open(root / "coordinates.pkl", "wb") as f:
        pickle.dump({f"patient{p:03d}": HEART_BOX for p in range(1, 10)}, f)
    seconds = time.perf_counter() - t0
    log(f"  wrote the synthetic processed tree: {len(sequences)} sequences of "
        f"{HR}x{HR}x1x{T_FRAMES} (+ LR x{FACTOR} and x4), {len(jobs)} files, "
        f"{n_bytes / 1e6:.1f} MB before gzip, in {seconds:.1f} s")
    return {"seconds": seconds, "files": len(jobs), "sequences": sequences}


class StepProbe:
    """Wraps the trainers' step methods for one run: a CUDA-event pair and
    the loss (left on the device) per train step, wall time and weight of
    every epoch pass, the validation outputs of the last pass, and
    optionally a SIGTERM to the process after ``sigterm_after`` steps."""

    def __init__(self, sigterm_after: int = 0):
        self.events, self.losses, self.passes = [], [], []
        self.valid_outputs, self.sigterm_after = [], sigterm_after

    def __enter__(self):
        from vsr_tpu_torch.runner.trainers import BaseTrainer

        self._cls = BaseTrainer
        self._saved = (BaseTrainer._train_step, BaseTrainer._eval_step,
                       BaseTrainer._run_epoch)
        train_step, eval_step, run_epoch = self._saved
        probe = self

        def timed_train_step(trainer, inputs, targets):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            scalars, outputs = train_step(trainer, inputs, targets)
            end.record()
            probe.events.append((start, end))
            probe.losses.append(scalars[0])
            if len(probe.events) == probe.sigterm_after:
                import os
                import signal

                os.kill(os.getpid(), signal.SIGTERM)
            return scalars, outputs

        def kept_eval_step(trainer, inputs, targets):
            scalars, outputs = eval_step(trainer, inputs, targets)
            probe.valid_outputs.append(outputs)
            return scalars, outputs

        def timed_run_epoch(trainer, mode, epoch):
            if mode == "validation":
                probe.valid_outputs.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            log_, batch, outputs = run_epoch(trainer, mode, epoch)
            torch.cuda.synchronize()
            probe.passes.append((mode, time.perf_counter() - t0))
            return log_, batch, outputs

        (BaseTrainer._train_step, BaseTrainer._eval_step,
         BaseTrainer._run_epoch) = (timed_train_step, kept_eval_step,
                                    timed_run_epoch)
        return self

    def __exit__(self, *exc):
        (self._cls._train_step, self._cls._eval_step,
         self._cls._run_epoch) = self._saved

    def step_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def seconds(self, mode: str) -> float:
        return sum(s for m, s in self.passes if m == mode)


def data_sub(config_name: str) -> str:
    """The tree a config's dataset reads: sequences for the VSR and MISR
    tasks, frames for SISR."""
    return "imgs" if "_sisr_" in config_name else "videos"


def training_config(name: str, tree: Path, saved: Path, net_kwargs: dict,
                    tmp: Path, net_name: str = "", **main_kwargs):
    """``configs/train/<name>.yaml`` pointed at the temporary tree (and, with
    ``net_name``, at another net of the same width), written to a file and
    read back as a user's config would be."""
    from vsr_tpu_torch.config import load_config, save_config

    root = Path(__file__).resolve().parent
    cfg = load_config(root / "configs" / "train" / f"{name}.yaml")
    cfg.net.name = net_name or cfg.net.name
    cfg.main.saved_dir = str(saved)
    cfg.main.update(main_kwargs)
    cfg.dataset.kwargs.data_dir = str(tree / data_sub(name))
    cfg.net.kwargs.update(net_kwargs)
    cfg.trainer.kwargs.num_epochs = TRAIN_EPOCHS
    cfg.monitor.kwargs.saved_freq = TRAIN_EPOCHS
    path = tmp / f"{saved.name}.yaml"
    save_config(cfg, path)
    return load_config(path)


def train_run(what: str, cfg, card: str, per_sample: int,
              squeezes_on: bool | None, sigterm_after: int = 0,
              frame_steps: tuple[int, int] = (TRAIN_T, 1)) -> dict:
    """One ``run_train`` of a config on the card, probed; checks the launch
    counts (``squeezes_on`` None: a net without K1), the loss, the files.
    ``frame_steps``: how many times the net runs the feedback block (12
    squeezes) per training sample and per validation frame."""
    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.runner.trainers import SISRSRFBTrainer

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    with StepProbe(sigterm_after) as probe:
        trainer = run_train(cfg)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    step_ms = probe.step_ms()
    losses = torch.stack(probe.losses).tolist()
    steps = len(step_ms)
    if isinstance(trainer, SISRSRFBTrainer):  # outputs (S, N, C, H, W)
        valid_frames = sum(o.shape[1] for o in probe.valid_outputs)
    else:
        valid_frames = sum(o.shape[0] * (o.shape[1] if o.dim() == 5 else 1)
                           for o in probe.valid_outputs)
    valid_passes = sum(m == "validation" for m, _ in probe.passes)
    samples = trainer.train_dataloader.batch_size * per_sample  # a full batch
    want_fwd = want_bwd = 0
    if squeezes_on:
        # Every sample of a batch goes through one launch together.
        want_bwd = SQUEEZES_PER_STEP * frame_steps[0] * steps
        want_fwd = want_bwd + (SQUEEZES_PER_STEP * frame_steps[1]
                               * valid_frames * valid_passes)
    check_launches(what, "concat_conv1x1", want_fwd, want_bwd)
    params = {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}
    if not all(torch.isfinite(v).all() for v in params.values()):
        raise SystemExit(f"{what}: a parameter is not finite")
    epochs = [json.loads(line) for line in
              (Path(cfg.main.saved_dir) / "log" / "metrics.jsonl")
              .read_text().splitlines()]
    res = {"steps": steps, "first_loss": losses[0], "last_loss": losses[-1],
           "train_loss_by_epoch": [e["train"]["Loss"] for e in epochs],
           "valid_loss_by_epoch": [e["valid"]["Loss"] for e in epochs],
           "valid_psnr_by_epoch": [e["valid"]["PSNR"] for e in epochs],
           "median_step_ms": statistics.median(step_ms[3:] or step_ms),
           "train_seconds": probe.seconds("training"),
           "valid_seconds": probe.seconds("validation"),
           "valid_frames_per_pass": valid_frames,
           "peak_memory_gb": peak_gb, "launches": want_fwd,
           "backward_launches": want_bwd, "epochs_logged": len(epochs)}
    res["train_frames_per_sec"] = samples * 1e3 / res["median_step_ms"]
    if valid_passes:
        res["valid_frames_per_sec"] = (valid_frames * valid_passes
                                       / res["valid_seconds"])
    log(f"  {what}: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(epoch means {[round(v, 4) for v in res['train_loss_by_epoch']]}, "
        f"validation {[round(v, 4) for v in res['valid_loss_by_epoch']]}), "
        f"median step {res['median_step_ms']:.2f} ms "
        f"({res['train_frames_per_sec']:.0f} patch-frames/s in a step; "
        f"{res['train_seconds']:.2f} s of training passes with the loader), "
        f"validation {res.get('valid_frames_per_sec', 0):.1f} frames/s, peak "
        f"memory {peak_gb:.2f} GB, K1 launches {want_fwd} forward "
        f"{want_bwd} backward [{card}]")
    return {"stats": res, "trainer": trainer, "params": params,
            "valid_outputs": list(probe.valid_outputs)}


def check_loss_fell(what: str, stats: dict) -> None:
    """The loss after the last step is lower than after the first, and so
    are the epoch means of the training loss and the validation loss (the
    same whole sequences every epoch: no sampling noise)."""
    pairs = {"step": (stats["first_loss"], stats["last_loss"]),
             "training epoch": (stats["train_loss_by_epoch"][0],
                                stats["train_loss_by_epoch"][-1]),
             "validation": (stats["valid_loss_by_epoch"][0],
                            stats["valid_loss_by_epoch"][-1])}
    bad = {k: v for k, v in pairs.items() if not v[1] < v[0]}
    if bad:
        raise SystemExit(f"{what}: the loss did not fall (first, last): {bad}")


def testing_config(name: str, tree: Path, run: Path, net_kwargs: dict,
                   tmp: Path, exported: bool | None = None,
                   net_name: str = ""):
    """``configs/test/<name>.yaml`` pointed at the temporary tree and at the
    best checkpoint of the training run ``run`` (with ``net_name``, of
    another net), written to a file as a user's config would be; returns the
    file's path."""
    from vsr_tpu_torch.config import load_config, save_config

    root = Path(__file__).resolve().parent
    cfg = load_config(root / "configs" / "test" / f"{name}.yaml")
    cfg.net.name = net_name or cfg.net.name
    out = run / "predictions"
    cfg.main.saved_dir = str(out)
    cfg.main.loaded_path = str(run / "checkpoints" / "model_best.ckpt")
    cfg.dataset.kwargs.data_dir = str(tree / data_sub(name))
    cfg.net.kwargs.update(net_kwargs)
    for spec in cfg.metrics:
        if "coordinates_path" in (spec.get("kwargs") or {}):
            spec.kwargs.coordinates_path = str(tree / "coordinates.pkl")
    cfg.predictor.kwargs.saved_dir = str(out)
    if exported is not None:
        cfg.predictor.kwargs.exported = exported
    path = tmp / f"{run.name}_test.yaml"
    save_config(cfg, path)
    return path


def test_run(what: str, name: str, tree: Path, run: Path, net_kwargs: dict,
             tmp: Path, train_stats: dict, want_launches: int,
             card: str, kernel: str = "concat_conv1x1",
             psnr_tol: float | None = TEST_PSNR_TOL,
             net_name: str = "") -> dict:
    """``python -m vsr_tpu_torch.main <test config> --test`` (its ``main``)
    on the best checkpoint of a training run: the launch counts, a row of
    ``results.csv``, a PNG per frame and a GIF per sequence, and the mean
    PSNR of the rows against the validation PSNR that the trainer logged for
    the epoch the monitor kept as best."""
    import csv

    from vsr_tpu_torch import main as port_main

    path = testing_config(name, tree, run, net_kwargs, tmp,
                          net_name=net_name)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    port_main.main([str(path), "--test"])  # the default device: the card
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_launches(what, kernel, want_launches)
    out = run / "predictions"
    with open(out / "results.csv", newline="") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    values = np.array([[float(v) for v in r[1:]] for r in rows])
    pngs = sorted(out.glob("imgs/*/*.png"))
    gifs = sorted(out.glob("videos/*/*.gif"))
    sequences = TEST_FRAMES // T_FRAMES
    if (len(rows) != TEST_FRAMES or len(pngs) != TEST_FRAMES
            or len(gifs) != sequences or not np.isfinite(values).all()
            or rows[0][0] != "patient001_2d_slice01_frame01"):
        raise SystemExit(f"{what}: {len(rows)} rows, {len(pngs)} PNGs, "
                         f"{len(gifs)} GIFs for {TEST_FRAMES} frames of "
                         f"{sequences} sequences (first row {rows[0][:2]})")
    if any(p.stat().st_size < 100 for p in (*pngs, *gifs)):
        raise SystemExit(f"{what}: an empty PNG or GIF")
    best = int(np.argmin(train_stats["valid_loss_by_epoch"]))
    psnr = float(values[:, header.index("PSNR") - 1].mean())
    want = train_stats["valid_psnr_by_epoch"][best]
    res = {"seconds": seconds, "frames": len(rows),
           "frames_per_sec": len(rows) / seconds, "psnr": psnr,
           "trainer_valid_psnr": want, "best_epoch": best + 1,
           "launches": want_launches, "columns": header[1:],
           "means": dict(zip(header[1:], values.mean(axis=0).tolist()))}
    log(f"  {what}: {len(rows)} rows, {len(pngs)} PNGs, {len(gifs)} GIFs in "
        f"{seconds:.2f} s ({res['frames_per_sec']:.1f} frames/s, files "
        f"included); mean PSNR {psnr:.4f} dB vs the trainer's validation "
        f"PSNR of epoch {best + 1} {want:.4f} dB; means "
        f"{ {k: round(v, 4) for k, v in res['means'].items()} }; {kernel} "
        f"launches {want_launches} [{card}]")
    if psnr_tol is not None and abs(psnr - want) > psnr_tol:
        raise SystemExit(f"{what}: main --test scores {psnr:.4f} dB, the "
                         f"trainer's validation pass {want:.4f} dB")
    return res


def phase_training(tmp: Path, card: str, dev) -> dict:
    from vsr_tpu_torch import infer
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
    from vsr_tpu_torch.utils.normalize import DATASET_STATS

    log("phase 7a: the synthetic processed tree")
    tree = make_training_tree(tmp / "tree", dev)
    res = {"tree": {k: tree[k] for k in ("seconds", "files")},
           "sequences": tree}

    log("phase 7b: VSR training, DRFNet F=64 G=6 x2 (AcdcVSRTrainer, K1 "
        "forward and backward)")
    runs = {}
    for name, fused in (("fused", True), ("fused_again", True),
                        ("unfused", False)):
        cfg = training_config("acdc_vsr_drf_x2", tmp / "tree",
                              tmp / f"vsr_{name}", {"fused_squeeze": fused}, tmp)
        runs[name] = train_run(f"vsr {name}", cfg, card, TRAIN_T, fused)
    for name, run in runs.items():
        s = run["stats"]
        check_loss_fell(f"vsr {name}", s)
        ckpts = tmp / f"vsr_{name}" / "checkpoints"
        for file in ("model_best.ckpt", f"model_{TRAIN_EPOCHS}.ckpt"):
            if not (ckpts / file).is_file():
                raise SystemExit(f"vsr {name}: no {file}")
        if s["epochs_logged"] != TRAIN_EPOCHS:
            raise SystemExit(f"vsr {name}: {s['epochs_logged']} epochs logged")
    on, off = runs["fused"]["stats"], runs["unfused"]["stats"]
    # One seed, one first batch, one init: the first loss differs only by the
    # kernel's summation order against cuDNN's.
    first_rel = abs(on["first_loss"] - off["first_loss"]) / off["first_loss"]
    if first_rel > 1e-4:
        raise SystemExit(f"vsr: first loss with the kernel on and off differ "
                         f"by {first_rel:.3g} relative")
    bit_equal = all(torch.equal(v, runs["fused_again"]["params"][k])
                    for k, v in runs["fused"]["params"].items())
    log(f"  vsr kernel on vs off: first loss {on['first_loss']:.6f} vs "
        f"{off['first_loss']:.6f} (relative {first_rel:.2g}); peak memory "
        f"{on['peak_memory_gb']:.2f} vs {off['peak_memory_gb']:.2f} GB; two "
        f"runs from one seed end in bit-equal parameters: {bit_equal} (not "
        f"gated)")
    res["vsr"] = {name: run["stats"] for name, run in runs.items()}
    res["vsr"]["first_loss_relative_diff"] = first_rel
    res["vsr"]["two_runs_bit_equal"] = bit_equal

    log("phase 7c: SISR training, EDSRNet 16 x 64 x2 (AcdcSISRTrainer, no "
        "kernel)")
    cfg = training_config("acdc_sisr_edsr_x2", tmp / "tree", tmp / "sisr", {},
                          tmp)
    sisr = train_run("sisr", cfg, card, 1, None)["stats"]
    check_loss_fell("sisr", sisr)
    if not (tmp / "sisr" / "checkpoints" / "model_best.ckpt").is_file():
        raise SystemExit("sisr: no model_best.ckpt")
    res["sisr"] = sisr

    log("phase 7c2: SISR training with feedback, SRFBNet F=64 G=6, 4 steps, "
        "x2 (AcdcSISRSRFBTrainer, K1 forward and backward)")
    srfb = {}
    for name, fused in (("fused", True), ("unfused", False)):
        cfg = training_config("acdc_sisr_srfb_x2", tmp / "tree",
                              tmp / f"srfb_{name}", {"fused_squeeze": fused},
                              tmp)
        srfb[name] = train_run(f"srfb {name}", cfg, card, 1, fused,
                               frame_steps=(SRFB_STEPS, SRFB_STEPS))["stats"]
        check_loss_fell(f"srfb {name}", srfb[name])
        if not (tmp / f"srfb_{name}" / "checkpoints"
                / "model_best.ckpt").is_file():
            raise SystemExit(f"srfb {name}: no model_best.ckpt")
    first_rel = (abs(srfb["fused"]["first_loss"] - srfb["unfused"]["first_loss"])
                 / srfb["unfused"]["first_loss"])
    per_step = srfb["fused"]["backward_launches"] // srfb["fused"]["steps"]
    log(f"  srfb kernel on vs off: first loss {srfb['fused']['first_loss']:.6f}"
        f" vs {srfb['unfused']['first_loss']:.6f} (relative {first_rel:.2g}); "
        f"{per_step} forward, dx and dW/db launches per train step with it "
        f"on, 0 with it off; median step "
        f"{srfb['fused']['median_step_ms']:.2f} vs "
        f"{srfb['unfused']['median_step_ms']:.2f} ms; peak memory "
        f"{srfb['fused']['peak_memory_gb']:.2f} vs "
        f"{srfb['unfused']['peak_memory_gb']:.2f} GB")
    if first_rel > 1e-4 or per_step != SQUEEZES_PER_STEP * SRFB_STEPS:
        raise SystemExit("srfb: the first loss with the kernel on and off "
                         "differ, or the launches per step are not 48")
    res["srfb"] = dict(srfb, first_loss_relative_diff=first_rel)

    log("phase 7d: train, then serve (infer --video --checkpoint)")
    hr = tree["sequences"]["valid", 1, 1].astype(np.float32)  # (H, W, 1, T)
    save_nifti(hr, tmp / "serve_in" / "patient001" / "patient001_4d.nii")
    net_kwargs = dict(DRF_KWARGS, fused_squeeze=True)
    served = {}
    for name, extra in (("trained", ["--checkpoint", str(
            tmp / "vsr_fused" / "checkpoints" / f"model_{TRAIN_EPOCHS}.ckpt")]),
                        ("untrained", [])):
        stats = infer.main([str(tmp / "serve_in"), str(tmp / f"serve_{name}"),
                            "--video", "--psnr", "--net", "DRFNet",
                            "--net-kwargs", json.dumps(net_kwargs), *extra])
        served[name] = (stats["psnr_mean"], load_nifti(
            tmp / f"serve_{name}" / "patient001" / "patient001_4d_sr.nii.gz"))
    mean, std = DATASET_STATS["acdc"]
    own = runs["fused"]["valid_outputs"][0]  # (1, T, 1, H, W), sequence 1
    own = torch.clamp(torch.round(own[0, :, 0] * std + mean), 0.0, 255.0)
    own = np.moveaxis(own.cpu().numpy(), 0, -1)  # (H, W, T)
    exact, worst = agreement(served["trained"][1][:, :, 0], own)
    log(f"  served PSNR against HR on one validation sequence: trained "
        f"{served['trained'][0]:.3f} dB, untrained {served['untrained'][0]:.3f}"
        f" dB; served vs the trainer's own validation output: "
        f"{exact * 100:.3f}% exact, max {worst:g} grey")
    check_sr("serve trained", served["trained"][1], (HR, HR, 1, T_FRAMES))
    if worst > 1:
        raise SystemExit("the served output of the trained checkpoint is not "
                         "the trainer's own validation output")
    res["serve"] = {"trained_psnr": served["trained"][0],
                    "untrained_psnr": served["untrained"][0],
                    "exact_fraction": exact, "max_grey_diff": worst}
    # Phase 12d serves the same checkpoint through the daemon's live backend.
    res["served_checkpoint"] = {
        "ckpt": str(tmp / "vsr_fused" / "checkpoints"
                    / f"model_{TRAIN_EPOCHS}.ckpt"),
        "nifti": str(tmp / "serve_in" / "patient001" / "patient001_4d.nii"),
        "net_kwargs": net_kwargs, "sr": served["trained"][1]}

    log("phase 7e: card vs CPU, one training batch")
    res["card_vs_cpu"] = card_vs_cpu("vsr", runs["fused"]["trainer"], dev,
                                     kernel="concat_conv1x1")
    failed = []
    gate_card_vs_cpu("vsr", res["card_vs_cpu"], failed)
    if failed:
        raise SystemExit(failed[0])

    log("phase 7f: preemption on the card")
    cfg = training_config("acdc_vsr_drf_x2", tmp / "tree", tmp / "vsr_preempt",
                          {"fused_squeeze": True}, tmp, auto_resume=True)
    cfg.trainer.kwargs.num_epochs = 1
    first = train_run("vsr preempted after 3 steps", cfg, card, TRAIN_T, True,
                      sigterm_after=3)["stats"]
    preempt = tmp / "vsr_preempt" / "checkpoints" / "model_preempt.ckpt"
    if first["steps"] != 3 or not preempt.is_file():
        raise SystemExit("preemption: no model_preempt.ckpt after 3 steps")
    resumed = train_run("vsr resumed", cfg, card, TRAIN_T, True)["stats"]
    per_epoch = on["steps"] // TRAIN_EPOCHS
    if first["steps"] + resumed["steps"] != per_epoch or resumed[
            "epochs_logged"] != 1:
        raise SystemExit(f"preemption: {first['steps']} + {resumed['steps']} "
                         f"steps do not make the epoch's {per_epoch}")
    log(f"  SIGTERM after 3 steps wrote model_preempt.ckpt; the resumed run "
        f"trained the epoch's other {resumed['steps']} steps and logged it")
    res["preemption"] = {"steps_before": first["steps"],
                         "steps_after": resumed["steps"]}

    log("phase 7g: train, then test (python -m vsr_tpu_torch.main <test "
        "config> --test on model_best.ckpt: results.csv, PNGs, GIFs)")
    squeezes = SQUEEZES_PER_STEP * TEST_FRAMES
    res["test"] = {
        "srfb": test_run("test srfb", "acdc_sisr_srfb_x2", tmp / "tree",
                         tmp / "srfb_fused", {"fused_squeeze": True}, tmp,
                         srfb["fused"], squeezes * SRFB_STEPS, card),
        "vsr": test_run("test vsr", "acdc_vsr_drf_x2", tmp / "tree",
                        tmp / "vsr_fused", {"fused_squeeze": True}, tmp,
                        runs["fused"]["stats"], squeezes, card),
        "sisr": test_run("test sisr", "acdc_sisr_edsr_x2", tmp / "tree",
                         tmp / "sisr", {}, tmp, sisr, 0, card)}
    return res


# ====================================================== MISR / FRVSR / MoE

# configs/train/acdc_misr_duf_x2.yaml (batch 16, 7-frame windows of 32 x 32
# LR patches, _DenseLayer16) with the filter kernel on; the MISR dataset
# gives one window per frame, so a validation pass filters one window per
# validation frame, each in its own K2 launch (batch 1).
DUF_TRAIN_KWARGS = {"use_pallas_filter": True}
# The nets of this slice at their configs' widths and batches, one epoch
# each: (config, net arguments).
ALIGN_RUNS = {"toflow": ("acdc_misr_toflow_x2", {}),
              "rbpn": ("acdc_misr_rbpn_x2", {}),
              "edvr": ("acdc_misr_edvr_x4", {}),
              "frvsr": ("acdc_vsr_frvsr_x4", {})}
# Card vs CPU: of the largest entry of each gradient where a kernel of the
# port runs in the step, else of the net's largest gradient entry.
GRAD_SHARE = 1e-3
CARD_VS_CPU_SAMPLES = 4


def outputs_frames(outputs) -> int:
    """Frames in one output: (N, C, H, W), (N, T, C, H, W), FRVSR's
    (sr, warped_lr) pair, or a volume net's (N, 1, D, H, W) (one frame a
    volume) or (N, T, 1, D, H, W)."""
    o = outputs[0] if isinstance(outputs, tuple) else outputs
    return o.shape[0] * (o.shape[1] if o.dim() >= 5 else 1)


def slice_run(what: str, cfg, card: str, kernel: str, per_step: int,
              per_valid_frame: int) -> dict:
    """One ``run_train`` of a config on the card, probed: ``kernel``
    launched ``per_step`` times a train step and ``per_valid_frame`` times a
    validation frame, no other kernel of the port; step times, rates, peak
    memory, the loss by epoch."""
    from vsr_tpu_torch.main import run_train

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with StepProbe() as probe:
        trainer = run_train(cfg)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    step_ms = probe.step_ms()
    losses = torch.stack(probe.losses).tolist()
    steps = len(step_ms)
    valid_frames = sum(outputs_frames(o) for o in probe.valid_outputs)
    launches = per_step * steps + per_valid_frame * valid_frames
    check_launches(what, kernel, launches)
    if not all(torch.isfinite(v).all() for v in trainer.net.state_dict().values()):
        raise SystemExit(f"{what}: a parameter or buffer is not finite")
    epochs = [json.loads(line) for line in
              (Path(cfg.main.saved_dir) / "log" / "metrics.jsonl")
              .read_text().splitlines()]
    batch = trainer.train_dataloader.batch_size
    median = statistics.median(step_ms[3:] or step_ms)
    res = {"steps": steps, "first_loss": losses[0], "last_loss": losses[-1],
           "train_loss_by_epoch": [e["train"]["Loss"] for e in epochs],
           "valid_loss_by_epoch": [e["valid"]["Loss"] for e in epochs],
           "valid_psnr_by_epoch": [e["valid"]["PSNR"] for e in epochs],
           "median_step_ms": median, "patches_per_sec": batch * 1e3 / median,
           "train_seconds": probe.seconds("training"),
           "valid_seconds": probe.seconds("validation"),
           "valid_frames": valid_frames, "peak_memory_gb": peak_gb,
           "kernel": kernel, "launches": launches,
           "launches_per_train_step": per_step}
    log(f"  {what}: {steps} steps of {batch}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, validation loss {res['valid_loss_by_epoch']} PSNR "
        f"{[round(v, 3) for v in res['valid_psnr_by_epoch']]}, median step "
        f"{median:.2f} ms ({res['patches_per_sec']:.1f} patches/s in a step; "
        f"{res['train_seconds']:.2f} s of training passes with the loader), "
        f"{valid_frames} validation frames in {res['valid_seconds']:.2f} s, "
        f"peak memory {peak_gb:.2f} GB, {kernel} launches {launches} "
        f"({per_step} a train step) [{card}]")
    return {"stats": res, "trainer": trainer,
            "valid_outputs": list(probe.valid_outputs)}


def _to(x, device):
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x.to(device)


def card_vs_cpu(what: str, trainer, dev, hooks=None,
                kernel: str | None = None) -> dict:
    """Loss and every parameter's gradient of the first training batch's
    first samples on the card (the path's kernels) against the CPU (the
    plain twins), from the trainer's weights, in train mode. ``hooks``:
    ``(net, 0 for the card or 1 for the CPU) -> handles``, set on each copy
    before its forward. ``kernel``: launched in the card's step, never in
    the CPU's.

    Where a kernel of the port runs in the step (K1, K3), each gradient is
    held against GRAD_SHARE of its own largest entry. Where none runs, the
    card runs PyTorch's own operators, whose float32 sums are not the CPU's
    (the CPU's BatchNorm sums in float64; cuDNN picks its algorithms per
    call), and a gradient that is small beside the net's moves by more than
    GRAD_SHARE of itself from rounding alone (TOFlow's SpyNet: 0.04 of its
    own largest entry); there each gradient is held against GRAD_SHARE of
    the net's largest entry."""
    import copy

    batch = next(trainer.train_dataloader.epoch(trainer.rng_tree, 1))
    batch = {k: v[:CARD_VS_CPU_SAMPLES] for k, v in batch.items()}
    inputs, targets = trainer._get_inputs_targets(batch)

    def step(device, index):
        reset_launches()
        net = copy.deepcopy(trainer.net).to(device).train()
        net.zero_grad(set_to_none=True)
        handles = hooks(net, index) if hooks else []
        loss = trainer._weighted_total(trainer._compute_losses(
            net(inputs.to(device)), _to(targets, device)))
        loss.backward()
        for h in handles:
            h.remove()
        if kernel:
            launched = kernel_counters()[kernel].launches
            if (launched > 0) != (index == 0):
                raise SystemExit(f"{what} on {device}: {kernel} launched "
                                 f"{launched} times")
        return loss.item(), {
            k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
            for k, p in net.named_parameters()}

    (loss_card, g_card), (loss_cpu, g_cpu) = step(dev, 0), step("cpu", 1)
    net_max = max(g.abs().max().item() for g in g_cpu.values())
    scale = {k: (g.abs().max().clamp_min(1e-12).item() if kernel else net_max)
             for k, g in g_cpu.items()}
    share = {k: (g_card[k] - g).abs().max().item() / scale[k]
             for k, g in g_cpu.items()}
    worst = max(share, key=share.get)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    whose = "its own" if kernel else "the net's"
    log(f"  {what} card vs CPU, {CARD_VS_CPU_SAMPLES} samples of a training "
        f"batch: loss {loss_card:.6f} vs {loss_cpu:.6f} (relative "
        f"{loss_rel:.2g}); worst parameter gradient ({worst}) differs by "
        f"{share[worst]:.2g} of {whose} largest entry (bar {GRAD_SHARE:g})")
    return {"loss_relative_diff": loss_rel,
            "worst_gradient_relative_diff": share[worst],
            "worst_gradient": worst, "bar": "own" if kernel else "net",
            "gradients_held": share[worst] <= GRAD_SHARE}


def gate_card_vs_cpu(what: str, res: dict, failed: list,
                     gradients: bool = True) -> None:
    """Record a disagreement in ``failed``; phase 9 fails at its end with
    every one of them."""
    if res["loss_relative_diff"] > 1e-4 or (
            gradients and not res["gradients_held"]):
        failed.append(f"{what}: card and CPU losses or gradients disagree")


def moe_card_vs_cpu(trainer, dev, failed: list) -> dict:
    """``card_vs_cpu`` for MoE-EDSR with the routing caveat, mask first: the
    input of every MoE layer is captured on both devices and routed by the
    plain rank; a token whose selection differs must lie within 1e-6 of the
    cap-th affinity. With no such token the gradients are held as for every
    net; with one, only the loss (a flipped token moves gradients by O(1))."""
    from vsr_tpu_torch.models.moe import route

    captured = ([], [])  # the card's MoE inputs, the CPU's

    def hooks(net, index):
        return [layer.register_forward_pre_hook(
            lambda m, args: captured[index].append(args[0].detach().cpu()))
            for layer in net.moes.values()]

    import copy

    res = card_vs_cpu("moe", trainer, dev, hooks, kernel="pairwise_rank")
    flips = 0
    for layer, a, b in zip(trainer.net.moes.values(), *captured):
        layer = copy.deepcopy(layer).cpu()
        with torch.no_grad():
            af_a, gs = layer.affinities(a)
            af_b, _ = layer.affinities(b)
        cap = layer.capacity(gs)
        flipped = (route(af_a, "rank") < cap) != (route(af_b, "rank") < cap)
        kth = af_b.sort(dim=-1).values[..., -cap][..., None]
        if bool(((af_b - kth).abs() > 1e-6)[flipped].any()):
            raise SystemExit("moe: a token away from the capacity boundary is "
                             "routed differently on the card and the CPU")
        flips += int(flipped.sum())
    res["flipped_selections"] = flips
    log(f"  moe routing, card vs CPU: {flips} (token, expert) selections "
        f"differ, all within 1e-6 of the cap-th affinity; gradients "
        f"{'held' if not flips else 'not held (a flip moves them)'}")
    gate_card_vs_cpu("moe", res, failed, gradients=not flips)
    return res


def served_vs_validation(what: str, tree: dict, tmp: Path, ckpt: Path,
                         net: str, net_kwargs: dict, flags: list,
                         valid_outputs: list, want_launches: int,
                         kernel: str, last_step: bool = False) -> dict:
    """The infer CLI serves validation sequence 1 from the HR volume (it
    makes the LR itself, by the k-space chain the tree was made with) with
    the trained checkpoint; its output must be the trainer's own validation
    output of those frames to <= 1 grey."""
    from vsr_tpu_torch import infer
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
    from vsr_tpu_torch.utils.normalize import DATASET_STATS

    src = tmp / f"{what}_serve_in"
    hr = tree["sequences"]["valid", 1, 1].astype(np.float32)  # (H, W, 1, T)
    save_nifti(hr, src / "patient001" / "patient001_4d.nii")
    reset_launches()
    stats = infer.main([str(src), str(tmp / f"{what}_served"), "--psnr",
                        *flags, "--net", net, "--net-kwargs",
                        json.dumps(net_kwargs), "--checkpoint", str(ckpt)])
    check_launches(f"{what} served", kernel, want_launches)
    served = load_nifti(tmp / f"{what}_served" / "patient001"
                        / "patient001_4d_sr.nii.gz")[:, :, 0]  # (H, W, T)
    mean, std = DATASET_STATS["acdc"]
    # The first T_FRAMES validation windows are sequence 1's frames, batch 1
    # (a feedback net's: its steps stacked first, the last one served).
    own = torch.cat([(o[-1] if last_step else o).reshape(-1, HR, HR)
                     for o in valid_outputs[:T_FRAMES]])
    own = torch.clamp(torch.round(own * std + mean), 0.0, 255.0)
    exact, worst = agreement(served, np.moveaxis(own.cpu().numpy(), 0, -1))
    log(f"  {what} served by the infer CLI with the trained checkpoint: PSNR "
        f"{stats['psnr_mean']:.3f} dB; vs the trainer's own validation output "
        f"{exact * 100:.3f}% exact, max {worst:g} grey; {kernel} launches "
        f"{want_launches}")
    if worst > 1:
        raise SystemExit(f"{what}: the served output of the trained checkpoint "
                         "is not the trainer's own validation output")
    return {"psnr": stats["psnr_mean"], "exact_fraction": exact,
            "max_grey_diff": worst}


def duf_valid_vs_plain(trainer, valid_outputs: list) -> float:
    """K2 against its plain twin on the validation path: every validation
    window goes through the trained net again on the card under
    ``no_grad``, with the plain softmax + filter route, and must equal the
    validation pass's own output (K2) to DUF_TOL."""
    net = trainer.net.eval()
    net.use_pallas_filter = False
    worst, windows = 0.0, 0
    reset_launches()
    try:
        with torch.no_grad():
            batches = trainer._device_batches(
                trainer.valid_dataloader.epoch(None, 1))
            for (_, inputs, _), k2 in zip(batches, valid_outputs, strict=True):
                worst = max(worst, (net(inputs) - k2).abs().max().item())
                windows += outputs_frames(k2)
    finally:
        net.use_pallas_filter = True
    check_launches("duf validation through the plain filter",
                   "duf_dynamic_filter", 0)
    log(f"  duf validation, K2 vs the plain softmax + filter on the same "
        f"{windows} windows: max abs diff {worst:.3g} (tolerance {DUF_TOL:g})")
    if worst > DUF_TOL:
        raise SystemExit("duf: K2's validation output is not the plain "
                         "filter's")
    return worst


def phase_slice_training(tmp: Path, tree: dict, card: str, dev) -> dict:
    """DUF (K2), MoE-EDSR (K3), TOFlow, RBPN, EDVR and FRVSR trained through
    ``run_train`` at their configs' widths and batches, one epoch each; DUF
    and FRVSR then tested through ``main --test``."""
    from vsr_tpu_torch.models.duf import DUFNet

    res, failed = {}, []  # card-vs-CPU disagreements, raised at the end
    log("phase 9a: MISR training, DUFNet _DenseLayer16 x2, 7-frame windows "
        "(AcdcMISRTrainer; K2 in validation only)")
    cfg = training_config("acdc_misr_duf_x2", tmp / "tree", tmp / "duf",
                          DUF_TRAIN_KWARGS, tmp)
    cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = 1
    initial = DUFNet(**cfg.net.kwargs).backbone.norm.running_var.clone()
    duf = slice_run("duf", cfg, card, "duf_dynamic_filter", 0, 1)
    stats = duf["stats"]
    moved = (duf["trainer"].net.backbone.norm.running_var.cpu()
             - initial).abs().max().item()
    log(f"  duf BatchNorm running variance moved by up to {moved:.4g} (flax's "
        f"update, biased batch variance); K2 ran {stats['launches']} times "
        f"for {stats['valid_frames']} validation windows, 0 times in "
        f"{stats['steps']} train steps")
    if moved < 1e-3:
        raise SystemExit("duf: the running statistics did not move")
    res["duf"] = dict(stats, running_var_moved=moved,
                      valid_k2_vs_plain=duf_valid_vs_plain(
                          duf["trainer"], duf["valid_outputs"]))
    res["duf"]["card_vs_cpu"] = card_vs_cpu("duf", duf["trainer"], dev)
    gate_card_vs_cpu("duf", res["duf"]["card_vs_cpu"], failed)
    res["duf"]["serve"] = served_vs_validation(
        "duf", tree, tmp, tmp / "duf" / "checkpoints" / "model_1.ckpt",
        "DUFNet", dict(cfg.net.kwargs), ["--windows", "7", "--chunk",
                                         str(DUF_CHUNK)],
        duf["valid_outputs"], -(-T_FRAMES // DUF_CHUNK), "duf_dynamic_filter")
    res["duf"]["test"] = test_run(
        "test duf", "acdc_misr_duf_x2", tmp / "tree", tmp / "duf",
        DUF_TRAIN_KWARGS, tmp, stats, TEST_FRAMES, card,
        kernel="duf_dynamic_filter")

    log("phase 9b: MoE-EDSR training, 16 x 64, 4 experts, x2 "
        "(AcdcSISRTrainer; K3 in every forward, train steps included)")
    moe = {}
    for name, router in (("rank_pallas", "rank_pallas"), ("rank", "rank")):
        cfg = training_config("acdc_sisr_moe_x2", tmp / "tree",
                              tmp / f"moe_{name}", {"router_impl": router}, tmp)
        cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = 1
        per = MOE_LAYERS if router == "rank_pallas" else 0
        moe[name] = slice_run(f"moe {name}", cfg, card, "pairwise_rank", per,
                              per)
    on, off = moe["rank_pallas"]["stats"], moe["rank"]["stats"]
    first_rel = abs(on["first_loss"] - off["first_loss"]) / off["first_loss"]
    log(f"  moe K3 vs the plain rank: first loss {on['first_loss']:.6f} vs "
        f"{off['first_loss']:.6f} (relative {first_rel:.2g}: the ranks are "
        f"bit-equal, so the first step is too); median step "
        f"{on['median_step_ms']:.2f} vs {off['median_step_ms']:.2f} ms")
    if first_rel > 1e-4:
        raise SystemExit("moe: the first loss with K3 and with the plain rank "
                         "differ")
    res["moe"] = {name: run["stats"] for name, run in moe.items()}
    res["moe"]["first_loss_relative_diff"] = first_rel
    res["moe"]["card_vs_cpu"] = moe_card_vs_cpu(moe["rank_pallas"]["trainer"],
                                                dev, failed)

    for key, (name, kwargs) in ALIGN_RUNS.items():
        log(f"phase 9c: {key} training at {name}'s width and batch")
        cfg = training_config(name, tmp / "tree", tmp / key, kwargs, tmp)
        cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = 1
        run = slice_run(key, cfg, card, "concat_conv1x1", 0, 0)
        res[key] = run["stats"]
        res[key]["card_vs_cpu"] = card_vs_cpu(key, run["trainer"], dev)
        gate_card_vs_cpu(key, res[key]["card_vs_cpu"], failed)
        if not (tmp / key / "checkpoints" / "model_best.ckpt").is_file():
            raise SystemExit(f"{key}: no model_best.ckpt")
    res["frvsr"]["test"] = test_run(
        "test frvsr", "acdc_vsr_frvsr_x4", tmp / "tree", tmp / "frvsr", {},
        tmp, res["frvsr"], 0, card)
    if failed:
        raise SystemExit("; ".join(failed))
    return res


def phase_profile_training(tmp: Path, dev, runs: list | None = None,
                           tree: Path | None = None) -> dict:
    """``torch.profiler`` over 6 train steps of each training path (DRFNet
    and SRFBNet kernel on and off, EDSRNet; DUF, MoE-EDSR with K3, TOFlow,
    RBPN, EDVR and FRVSR; or ``runs``, (key, config, net arguments) on
    ``tree``) after 3 warm-up steps: device time by
    kernel, the idle share against the wall time of 6 unprofiled steps, and
    for K1 the device time of its own kernels (forward and dx launches
    together, phase 6 times them apart; the dW / db kernel with its second
    pass) and of the PyTorch kernels its backward launches besides (W^T,
    the zero bias, casts), read from a profiler range around the backward: a
    range's device time is that of the PyTorch kernels launched inside it,
    and leaves out the port's own launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.ops import fused_squeeze as fs

    def ranged_backward(ctx, grad_out):
        with record_function("K1 backward"):
            return backward(ctx, grad_out)

    res = {}
    for key, name, kwargs in runs or (
            ("vsr_fused", "acdc_vsr_drf_x2", {"fused_squeeze": True}),
            ("vsr_unfused", "acdc_vsr_drf_x2", {"fused_squeeze": False}),
            ("srfb_fused", "acdc_sisr_srfb_x2", {"fused_squeeze": True}),
            ("srfb_unfused", "acdc_sisr_srfb_x2", {"fused_squeeze": False}),
            ("sisr", "acdc_sisr_edsr_x2", {}),
            ("duf", "acdc_misr_duf_x2", DUF_TRAIN_KWARGS),
            ("moe", "acdc_sisr_moe_x2", {"router_impl": "rank_pallas"}),
            *((key, name, kwargs) for key, (name, kwargs)
              in ALIGN_RUNS.items())):
        cfg = training_config(name, tree or tmp / "tree",
                              tmp / f"profile_{key}", kwargs, tmp)
        cfg.trainer.kwargs.num_epochs = 0  # build everything, train nothing
        trainer = run_train(cfg)
        batches = list(trainer.train_dataloader.epoch(trainer.rng_tree, 1))[:3]

        def steps(n):
            """Host batches in: the copy to the device is part of a step."""
            for i in range(n):
                trainer._train_step(*trainer._get_inputs_targets(
                    batches[i % len(batches)]))
            torch.cuda.synchronize()

        steps(3)
        t0 = time.perf_counter()
        steps(6)
        wall = (time.perf_counter() - t0) * 1e3
        backward = fs._ConcatConv1x1.backward
        fs._ConcatConv1x1.backward = staticmethod(ranged_backward)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                steps(6)
        finally:
            fs._ConcatConv1x1.backward = staticmethod(backward)
        rows = device_rows(prof)
        busy = sum(r[1] for r in rows)
        k1_rest = sum(e.device_time_total / 1e3 for e in prof.key_averages()
                      if e.key == "K1 backward"
                      and e.device_type == DeviceType.CPU)
        # Device ms per step of the kernels whose name holds the word.
        share = {name: sum(ms for k, ms, _ in rows if word in k) / 6
                 for name, word in (("k1_kernel", "concat_conv1x1_kernel"),
                                    ("k1_dw_kernel", "concat_dw_"),  # + its second pass
                                    ("k3_kernel", "pairwise_rank_kernel"),
                                    # the warps' and deformable convs'
                                    # gathers and their scatter-adds
                                    ("gather_scatter",
                                     "_scatter_gather_elementwise"),
                                    # cuDNN's bn_fw / bn_bw kernels
                                    ("batch_norm", "cudnn::bn_"),
                                    ("cudnn_dgrad", "dgrad"),
                                    ("cudnn_wgrad", "wgrad"),
                                    ("optimizer", "multi_tensor_apply"),
                                    ("h2d", "Memcpy HtoD"))}
        res[key] = {
            "wall_ms_per_step": wall / 6, "busy_ms_per_step": busy / 6,
            "idle_share": 1 - busy / wall,
            **{f"{name}_ms_per_step": ms for name, ms in share.items()},
            "k1_backward_rest_ms_per_step": k1_rest / 6,
            "top": [{"kernel": k[:100], "ms_per_step": ms / 6, "calls": c // 6}
                    for k, ms, c in rows[:20]]}
        log(f"  profile training {key}: wall {wall / 6:.1f} ms/step, busy "
            f"{busy / 6:.1f} ms/step, idle share {1 - busy / wall:.3f}; ms "
            f"per step of device time: K1's kernel (forward + dx) "
            f"{share['k1_kernel']:.2f}, its dW/db kernel "
            f"{share['k1_dw_kernel']:.2f}, the PyTorch kernels of its "
            f"backward (W^T, the zero bias, casts) {k1_rest / 6:.2f}, "
            f"K3 {share['k3_kernel']:.3f}, gathers and scatter-adds "
            f"{share['gather_scatter']:.2f}, cuDNN BatchNorm "
            f"{share['batch_norm']:.2f}, cuDNN dgrad {share['cudnn_dgrad']:.2f}, "
            f"wgrad {share['cudnn_wgrad']:.2f}, optimizer "
            f"{share['optimizer']:.2f}, H2D {share['h2d']:.3f}")
        for k, ms, c in rows[:12]:
            log(f"    {ms / 6:9.3f} ms/step {c // 6:5d} x {k[:90]}")
    return res


# ================================================================= volumes

# Patients of VOL_SLICES slice sequences (ACDC stacks hold about 6-20; the
# test configs' SSIM with dim 3 needs a depth of 11 or more); the valid
# patient doubles as the test split.
VOL_SLICES = 12
VOL_PATIENTS = {"train": 2, "valid": 1}
# Frames of the validation (= test) sequences: the 4D test writes one
# (HR, HR, VOL_SLICES, VOL_VALID_T) gzip-9 NIfTI, 53 MB and about a minute
# at 30 frames.
VOL_VALID_T = 10
VOL_SERVE_T = 6  # frames of the validation patient served by the CLI
# (config, net, training samples' frames): configs/train/acdc_3d_vol_x2.yaml
# (batch 4 of [32, 32, 4] LR crops) and acdc_4d_vol_x2.yaml (batch 2 of
# 5-frame windows of those crops, remat and fused_tail).
VOL_RUNS = {"3d": ("acdc_3d_vol_x2", "Volume3DSRNet", 1),
            "4d": ("acdc_4d_vol_x2", "Volume4DSRNet", 5)}
REMAT_SHARE = 1e-6  # remat on vs off: of the net's largest gradient entry


def make_volume_tree(root: Path, dev) -> dict:
    """``videos/{train,valid,test}/{HR,LR/X2}/patientNNN/...sequenceSS.nii.gz``
    for VOL_PATIENTS patients of VOL_SLICES slices of HR x HR x T_FRAMES
    (the validation sequences cut to their first VOL_VALID_T frames), each
    slice low-passed like the training tree and its LR made by the port's
    k-space chain on the card; the test split is the validation split
    again. Returns the validation patient's HR volume (H, W, D, T)."""
    from concurrent.futures import ThreadPoolExecutor

    from vsr_tpu_torch.io.nifti import save_nifti
    from vsr_tpu_torch.preprocess.kspace import kspace_downscale_torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    jobs, valid_hr = [], []
    for split, patients in VOL_PATIENTS.items():
        for p in range(1, patients + 1):
            pat = f"patient{p:03d}"
            for s in range(1, VOL_SLICES + 1):
                hr = smooth_sequence(rng)  # (H, W, 1, T) uint8
                if split == "valid":
                    hr = np.ascontiguousarray(hr[..., :VOL_VALID_T])
                frames = torch.from_numpy(np.ascontiguousarray(
                    np.moveaxis(hr[:, :, 0], -1, 0))).float().to(dev)
                lr = np.moveaxis(kspace_downscale_torch(frames, FACTOR).cpu()
                                 .numpy(), 0, -1).astype(np.uint8)[:, :, None]
                for sub, vol in (("HR", hr), (f"LR/X{FACTOR}", lr)):
                    for into in ((split, "test") if split == "valid"
                                 else (split,)):
                        jobs.append((vol, root / "videos" / into / sub / pat
                                     / f"{pat}_2d+1d_sequence{s:02d}.nii.gz"))
                if split == "valid":
                    valid_hr.append(hr[:, :, 0])
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: save_nifti(*job), jobs))
    seconds = time.perf_counter() - t0
    log(f"  wrote the volume tree: {sum(VOL_PATIENTS.values())} patients of "
        f"{VOL_SLICES} slices of {HR}x{HR}x{T_FRAMES} (validation "
        f"{VOL_VALID_T} frames; + LR x{FACTOR}; test = valid), {len(jobs)} "
        f"files, in {seconds:.1f} s")
    return {"seconds": seconds, "files": len(jobs),
            "valid_hr": np.stack(valid_hr, axis=2).astype(np.float32)}


def remat_on_off(cfg, trainer, dev) -> dict:
    """The first train step (the config's seeded weights, the first batch)
    of Volume4DSRNet with ``remat`` on and off on the card: every gradient
    within REMAT_SHARE of the net's largest entry; the step's peak memory
    above what was held before it, both ways."""
    from vsr_tpu_torch.main import build_net

    batch = next(trainer.train_dataloader.epoch(trainer.rng_tree, 1))
    inputs, targets = trainer._get_inputs_targets(batch)
    grads, peak = {}, {}
    for remat in (True, False):
        cfg.net.kwargs.remat = remat
        net = build_net(cfg, dev).train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        trainer._weighted_total(trainer._compute_losses(
            net(inputs), targets)).backward()
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated() - held) / 1e9
        grads[remat] = {k: p.grad for k, p in net.named_parameters()}
    cfg.net.kwargs.remat = True
    scale = max(g.abs().max().item() for g in grads[False].values())
    share = max((grads[True][k] - g).abs().max().item() / scale
                for k, g in grads[False].items())
    log(f"  4d first step, remat on vs off: gradients differ by {share:.3g} of "
        f"the net's largest entry (bar {REMAT_SHARE:g}); peak memory of the "
        f"step {peak[True]:.3f} GB with remat, {peak[False]:.3f} GB without")
    if share > REMAT_SHARE:
        raise SystemExit("4d: the gradients with remat on and off differ")
    return {"gradient_share": share, "peak_memory_gb_remat": peak[True],
            "peak_memory_gb_no_remat": peak[False]}


def volume_served(what: str, net: str, net_kwargs: dict, ckpt: Path,
                  valid_hr: np.ndarray, valid_outputs: list, tmp: Path) -> dict:
    """The infer CLI serves the first VOL_SERVE_T frames of the validation
    patient (it makes the LR itself, by the k-space chain the tree was made
    with) with the trained checkpoint, in volume mode; its output must be
    the trainer's own validation output of those frames to <= 1 grey (4D:
    the recurrence is causal, so a shorter sequence gives the same first
    frames)."""
    from vsr_tpu_torch import infer
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
    from vsr_tpu_torch.utils.normalize import DATASET_STATS

    src = tmp / f"{what}_serve_in"
    save_nifti(np.ascontiguousarray(valid_hr[..., :VOL_SERVE_T]),
               src / "patient001" / "patient001_4d.nii")
    reset_launches()
    stats = infer.main([str(src), str(tmp / f"{what}_served"), "--psnr",
                        "--net", net, "--net-kwargs", json.dumps(net_kwargs),
                        "--checkpoint", str(ckpt)])
    check_launches(f"{what} served", "concat_conv1x1", 0)
    served = load_nifti(tmp / f"{what}_served" / "patient001"
                        / "patient001_4d_sr.nii.gz")  # (H, W, D, T)
    if what == "3d":  # one (1, 1, D, H, W) output a validation frame
        own = torch.cat([o[:, 0] for o in valid_outputs[:VOL_SERVE_T]])
    else:  # one (1, T, 1, D, H, W) output, the whole sequence
        own = valid_outputs[0][0, :VOL_SERVE_T, 0]
    mean, std = DATASET_STATS["acdc"]
    own = torch.clamp(torch.round(own * std + mean), 0.0, 255.0)
    own = own.permute(2, 3, 1, 0).cpu().numpy()  # (T, D, H, W) -> (H, W, D, T)
    exact, worst = agreement(served, own)
    log(f"  {what} served by the infer CLI with the trained checkpoint "
        f"({HR}x{HR}x{VOL_SLICES}x{VOL_SERVE_T}): PSNR {stats['psnr_mean']:.3f}"
        f" dB, end to end {stats['frames_per_sec']:.2f} frames/s, pipeline "
        f"{stats['pipeline_frames_per_sec']:.2f} frames/s; vs the trainer's "
        f"own validation output {exact * 100:.3f}% exact, max {worst:g} grey")
    if served.shape != own.shape or worst > 1:
        raise SystemExit(f"{what}: the served output of the trained checkpoint "
                         "is not the trainer's own validation output")
    return {"psnr": stats["psnr_mean"], "exact_fraction": exact,
            "max_grey_diff": worst, "frames_per_sec": stats["frames_per_sec"],
            "pipeline_frames_per_sec": stats["pipeline_frames_per_sec"]}


def volume_test_run(what: str, name: str, tree: Path, run: Path, tmp: Path,
                    train_stats: dict, card: str,
                    per_frame: bool | None = None,
                    psnr_tol: float | None = TEST_PSNR_TOL) -> dict:
    """``main --test`` on the trained checkpoint: a row of ``results.csv``
    per validation frame, the NIfTI volumes of their shapes, no port kernel,
    and the mean PSNR of the rows against the trainer's validation PSNR."""
    import csv

    from vsr_tpu_torch import main as port_main
    from vsr_tpu_torch.io.nifti import load_nifti

    path = testing_config(name, tree, run, {}, tmp)
    reset_launches()
    t0 = time.perf_counter()
    port_main.main([str(path), "--test"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_launches(what, "concat_conv1x1", 0)
    out = run / "predictions"
    with open(out / "results.csv", newline="") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    values = np.array([[float(v) for v in r[1:]] for r in rows])
    vols = sorted(out.glob("volumes/*/*.nii.gz"))
    if per_frame is None:
        per_frame = what == "test 3d"
    want = ([(HR, HR, VOL_SLICES)] * VOL_VALID_T if per_frame
            else [(HR, HR, VOL_SLICES, VOL_VALID_T)])
    shapes = [load_nifti(v).shape for v in vols]
    if (len(rows) != VOL_VALID_T or shapes != want
            or rows[0][0] != "patient001_frame01"
            or not np.isfinite(values).all()):
        raise SystemExit(f"{what}: {len(rows)} rows (first {rows[0][:1]}), "
                         f"NIfTI shapes {sorted(set(shapes))}")
    psnr = float(values[:, header.index("PSNR") - 1].mean())
    # The epoch the monitor kept as best (the last one of a one-epoch run).
    best = int(np.argmin(train_stats["valid_loss_by_epoch"]))
    valid = train_stats["valid_psnr_by_epoch"][best]
    res = {"seconds": seconds, "frames": len(rows),
           "frames_per_sec": len(rows) / seconds, "psnr": psnr,
           "trainer_valid_psnr": valid, "columns": header[1:],
           "means": dict(zip(header[1:], values.mean(axis=0).tolist()))}
    log(f"  {what}: {len(rows)} rows, {len(vols)} NIfTI volumes in "
        f"{seconds:.2f} s ({res['frames_per_sec']:.2f} frames/s, files "
        f"included); mean PSNR {psnr:.4f} dB vs the trainer's validation "
        f"PSNR {valid:.4f} dB; means "
        f"{ {k: round(v, 4) for k, v in res['means'].items()} } [{card}]")
    if psnr_tol is not None and abs(psnr - valid) > psnr_tol:
        raise SystemExit(f"{what}: main --test scores {psnr:.4f} dB, the "
                         f"trainer's validation pass {valid:.4f} dB")
    return res


def volume_serving(key: str, net: str, state: dict, net_kwargs: dict, dev,
                   card: str) -> dict:
    """FULL_VOLUMES noise volumes of HR x HR x FULL_SLICES x T_FRAMES
    through ``make_pipeline`` in volume mode, the trained weights with
    ``fused_tail`` on and off (f32, TF32 off): pipeline frames/s, wall ms a
    volume, peak memory; the two must agree to >= 99.9 % exact grey and
    <= 1 grey, and no port kernel runs."""
    from vsr_tpu_torch.infer import VOLUME_NETS, make_pipeline
    from vsr_tpu_torch.registry import build

    frames = [as_frames(make_volume(20 + i, FULL_SLICES))
              for i in range(FULL_VOLUMES)]
    runs, srs = {}, {}
    for fused in (True, False):
        model = build("net", {"name": net, "kwargs": dict(
            net_kwargs, fused_tail=fused)}, device=dev)
        model.load_state_dict(state)
        pipe = make_pipeline(model, FACTOR, "acdc",
                             volume=(VOLUME_NETS[net], T_FRAMES))
        pipe(torch.from_numpy(frames[0]).to(dev))  # library handles, caches
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        walls, outs = [], []
        for f in frames:
            t0 = time.perf_counter()
            outs.append(pipe(torch.from_numpy(f).to(dev))[1].cpu().numpy())
            walls.append((time.perf_counter() - t0) * 1e3)
        check_launches(f"{key} serving", "concat_conv1x1", 0)
        name = "fused_tail" if fused else "unfused"
        for sr in outs:
            check_sr(f"{key} {name}", sr, (FULL_SLICES * T_FRAMES, HR, HR))
        n = FULL_SLICES * T_FRAMES * len(frames)
        runs[name] = {"pipeline_frames_per_sec": n * 1e3 / sum(walls),
                      "wall_ms_per_volume": statistics.median(walls),
                      "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                         - held) / 1e9}
        srs[name] = outs
        log(f"  {key} serving {name} ({len(frames)} volumes of {HR}x{HR}x"
            f"{FULL_SLICES}x{T_FRAMES}, pipeline, no file I/O): "
            f"{runs[name]['pipeline_frames_per_sec']:.1f} frames/s, "
            f"{runs[name]['wall_ms_per_volume']:.1f} ms a volume, peak memory "
            f"{runs[name]['peak_memory_gb']:.2f} GB [{card}]")
    stats = [agreement(a, b) for a, b in zip(srs["fused_tail"], srs["unfused"])]
    exact, worst = min(e for e, _ in stats), max(m for _, m in stats)
    log(f"  {key} serving, fused_tail on vs off: {exact * 100:.4f}% exact, "
        f"max {worst:g} grey")
    if exact < 0.999 or worst > 1:
        raise SystemExit(f"{key}: fused_tail on and off serve different SR")
    runs["fused_vs_unfused"] = {"exact_fraction": exact,
                                "max_grey_diff": worst}
    return runs


def phase_volumes(tmp: Path, card: str, dev) -> dict:
    """The volumetric slice: Volume3DSRNet and Volume4DSRNet trained through
    ``run_train`` at their configs' widths and batches for one epoch on a
    volume tree of their own, each first batch held against the CPU (4D
    also with remat on and off), the checkpoint served by the infer CLI and
    tested by ``main --test``, full volumes served with fused_tail on and
    off. No kernel of the port lies on these paths: every launch count
    reads 0."""
    res, failed = {}, []
    tree = tmp / "volume_tree"
    log("phase 10a: the volume tree")
    made = make_volume_tree(tree, dev)
    res["tree"] = {k: made[k] for k in ("seconds", "files")}
    for key, (name, net, frames_per_sample) in VOL_RUNS.items():
        log(f"phase 10{'b' if key == '3d' else 'c'}: {net} trained at "
            f"{name}'s width and batch, one epoch")
        cfg = training_config(name, tree, tmp / f"vol_{key}", {}, tmp)
        cfg.dataset.kwargs.data_dir = str(tree / "videos")
        cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = 1
        run = slice_run(key, cfg, card, "concat_conv1x1", 0, 0)
        res[key] = dict(run["stats"], patch_frames_per_sec=run["stats"][
            "patches_per_sec"] * frames_per_sample)
        log(f"  {key}: {res[key]['patch_frames_per_sec']:.1f} patch-frames/s "
            f"in a step")
        if not (tmp / f"vol_{key}" / "checkpoints" / "model_best.ckpt").is_file():
            raise SystemExit(f"{key}: no model_best.ckpt")
        res[key]["card_vs_cpu"] = card_vs_cpu(key, run["trainer"], dev)
        gate_card_vs_cpu(key, res[key]["card_vs_cpu"], failed)
        if key == "4d":
            res[key]["remat"] = remat_on_off(cfg, run["trainer"], dev)
        check_launches(f"{key} card vs CPU and remat", "concat_conv1x1", 0)
        ckpt = tmp / f"vol_{key}" / "checkpoints" / "model_best.ckpt"
        res[key]["serve"] = volume_served(
            key, net, dict(cfg.net.kwargs), ckpt, made["valid_hr"],
            run["valid_outputs"], tmp)
        res[key]["test"] = volume_test_run(
            f"test {key}", name, tree, tmp / f"vol_{key}", tmp, res[key], card)
        res[key]["serving"] = volume_serving(
            key, net, run["trainer"].net.state_dict(), dict(cfg.net.kwargs),
            dev, card)
    if failed:
        raise SystemExit("; ".join(failed))
    return res


# ========================================================== device epochs

# The four device-epoch configs: (config, tree, frames a training sample).
DEVICE_RUNS = {"sisr": ("acdc_sisr_edsr_x2_device", "tree", 1),
               "vsr": ("acdc_vsr_drf_x2_device", "tree", TRAIN_T),
               "3d": ("acdc_3d_vol_x2_device", "volume_tree", 1),
               "4d": ("acdc_4d_vol_x2_device", "volume_tree", 5)}
DEVICE_EPOCHS = 1  # a second epoch only repeats the first's replays
# The DRF device config through K1: carry_f32 does not compose with
# fused_squeeze (the JAX package refuses the pair too), so it is removed.
K1_DEVICE = {"carry_f32": False, "fused_squeeze": True}
GRAPH_STEPS = 8      # the epoch run eagerly and through the graph
GRAPH_TOL = 1e-5     # per-step loss, relative: the same kernels and draws
K1_ON_OFF_TOL = 1e-2  # first loss, relative: bf16 forwards that round apart
PROFILE_REPLAYS = 20
# A trace may drop kernel records (CUPTI's buffers: one run of 20 replays
# counted 4 % fewer of every kernel); it never adds any. K1's launches are
# counted in TRACE_TRIES short traces and the most any of them saw is
# held to the expected count.
TRACE_TRIES, TRACE_REPLAYS = 3, 5


def k1_calls() -> tuple[int, int, int]:
    """K1's counters: the forward's calls, the dx calls of its backward,
    the dW / db kernel's calls."""
    fwd, dw = (kernel_counters()[k] for k in ("concat_conv1x1",
                                               "concat_conv1x1_dw"))
    return fwd.launches, fwd.backward_launches, dw.launches


class EpochClock:
    """Times the device trainers' training passes (synchronized on both
    sides) and every graph replay (a CUDA-event pair each), keeps each
    epoch's per-step scalars, and sums what K1's counters (``k1_calls``)
    read over the training passes alone."""

    def __enter__(self):
        from vsr_tpu_torch.runner.device_trainer import DeviceTrainerMixin

        self._cls, self.seconds, self.logs = DeviceTrainerMixin, [], []
        self.k1_train_calls, self.replay_events = [0, 0, 0], []
        self._saved = saved = DeviceTrainerMixin._run_epoch
        self._replay = replay = torch.cuda.CUDAGraph.replay
        clock = self

        def timed_replay(graph):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            replay(graph)
            end.record()
            clock.replay_events.append((start, end))

        def timed(trainer, mode, epoch):
            if mode != "training":
                return saved(trainer, mode, epoch)
            before = k1_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved(trainer, mode, epoch)
            torch.cuda.synchronize()
            clock.seconds.append(time.perf_counter() - t0)
            clock.logs.append(trainer.engine.log.clone())
            clock.k1_train_calls = [n + a - b for n, a, b in zip(
                clock.k1_train_calls, k1_calls(), before)]
            return out

        DeviceTrainerMixin._run_epoch = timed
        torch.cuda.CUDAGraph.replay = timed_replay
        return self

    def __exit__(self, *exc):
        self._cls._run_epoch = self._saved
        torch.cuda.CUDAGraph.replay = self._replay

    def replay_ms(self) -> float:
        """One replayed step: the window from the first replay's start to
        the last one's end over the replays, the host's gaps between
        replays included (the eager steps and the capture are not)."""
        torch.cuda.synchronize()
        start, end = self.replay_events[0][0], self.replay_events[-1][1]
        return start.elapsed_time(end) / len(self.replay_events)


def device_config(name: str, tree: Path, saved: Path, tmp: Path,
                  net_kwargs: dict | None = None, **trainer_kwargs):
    cfg = training_config(name, tree, saved, net_kwargs or {}, tmp)
    cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = (
        DEVICE_EPOCHS)
    cfg.trainer.kwargs.update(trainer_kwargs)
    return cfg


def device_run(what: str, cfg, card: str, frames: int, k1: bool) -> dict:
    """``run_train`` of a device config: the epochs' captures, replays and
    eager steps, K1's launch counts (each counts its Python calls: the
    captured step once, its replays not at all; the launches on the card
    are the calls per step times the eager steps and replays), finite
    parameters, the per-step losses, the replayed step's time
    (``EpochClock.replay_ms``)."""
    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.runner.device_trainer import WARMUP_STEPS

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with EpochClock() as clock:
        trainer = run_train(cfg)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    eng, per_epoch = trainer.engine, trainer.steps_per_epoch
    steps = per_epoch * DEVICE_EPOCHS
    if (eng.eager_steps, eng.captures, eng.replays,
            len(clock.replay_events)) != (
            WARMUP_STEPS, 1, steps - WARMUP_STEPS, steps - WARMUP_STEPS):
        raise SystemExit(f"{what}: {eng.eager_steps} eager steps, "
                         f"{eng.captures} captures, {eng.replays} replays "
                         f"for {steps} steps")
    per_step = SQUEEZES_PER_STEP * frames if k1 else 0
    calls = eng.eager_steps + eng.captures
    valid = SQUEEZES_PER_STEP * TEST_FRAMES * DEVICE_EPOCHS if k1 else 0
    check_launches(what, "concat_conv1x1", per_step * calls + valid,
                   per_step * calls)
    # Per kernel (forward, dx, dW / db): the calls the counters read in the
    # training passes, per Python call of the step, times the steps that
    # ran on the card (eager steps and replays).
    ran = eng.eager_steps + eng.replays
    k1_per_step, k1_launches = {}, {}
    for kind, n in zip(("forward", "dx", "dw"), clock.k1_train_calls):
        if n % calls:
            raise SystemExit(f"{what}: {n} {kind} calls of K1 in {calls} "
                             "calls of the step")
        k1_per_step[kind] = n // calls
        k1_launches[kind] = n // calls * ran
    if not all(torch.isfinite(v).all() and v.dtype == torch.float32
               for v in trainer.net.state_dict().values()):
        raise SystemExit(f"{what}: a parameter is not a finite float32")
    epochs = [json.loads(line) for line in
              (Path(cfg.main.saved_dir) / "log" / "metrics.jsonl")
              .read_text().splitlines()]
    if len(epochs) != DEVICE_EPOCHS or not (
            Path(cfg.main.saved_dir) / "checkpoints" / "model_best.ckpt"
    ).is_file():
        raise SystemExit(f"{what}: {len(epochs)} epochs logged, or no "
                         "model_best.ckpt")
    losses = torch.cat([log_[:, 0] for log_ in clock.logs]).tolist()
    step_ms = clock.replay_ms()
    batch = trainer.batch_size
    res = {"steps": steps, "steps_per_epoch": per_epoch, "batch": batch,
           "eager_steps": eng.eager_steps, "replays": eng.replays,
           "buffer_mb": (trainer.lr_buf.nbytes + trainer.hr_buf.nbytes) / 1e6,
           "first_loss": losses[0], "last_loss": losses[-1],
           "train_loss_by_epoch": [e["train"]["Loss"] for e in epochs],
           "valid_loss_by_epoch": [e["valid"]["Loss"] for e in epochs],
           "valid_psnr_by_epoch": [e["valid"]["PSNR"] for e in epochs],
           "epoch_seconds": clock.seconds, "replay_step_ms": step_ms,
           "patch_frames_per_sec": batch * frames * 1e3 / step_ms,
           "peak_memory_gb": peak_gb,
           # What ran on the card in the train steps, per kernel (forward,
           # dx, dW / db): per step times the eager steps and replays.
           "k1_launches": k1_launches,
           "k1_validation_launches": valid,
           "k1_launches_per_step": k1_per_step}
    log(f"  {what}: {steps} steps ({eng.eager_steps} eager, 1 captured, "
        f"{eng.replays} replays), loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(validation {[round(v, 4) for v in res['valid_loss_by_epoch']]}), "
        f"epochs {[round(t, 2) for t in clock.seconds]} s, replayed step "
        f"{step_ms:.2f} ms ({res['patch_frames_per_sec']:.0f} patch-frames/s),"
        f" buffers {res['buffer_mb']:.0f} MB, peak memory {peak_gb:.2f} GB, "
        f"K1 launches in the train steps {k1_launches} [{card}]")
    return {"stats": res, "trainer": trainer, "logs": clock.logs}


def replay_profile(what: str, trainer, card: str, traces: int = 1) -> dict:
    """``PROFILE_REPLAYS`` replays of the captured step, timed, then traced:
    device time by kernel and the idle share; and the K1 kernels' launches
    a replay as ``traces`` traces of ``TRACE_REPLAYS`` replays count them
    (the most of each)."""
    from torch.profiler import ProfilerActivity, profile

    eng = trainer.engine
    (graph,) = eng.graphs.values()  # the config's step: one graph

    def replays(n):
        eng.counter.zero_()
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()

    replays(3)
    t0 = time.perf_counter()
    replays(PROFILE_REPLAYS)
    wall = (time.perf_counter() - t0) * 1e3 / PROFILE_REPLAYS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replays(PROFILE_REPLAYS)
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows) / PROFILE_REPLAYS
    words = (("k1", "concat_conv1x1_kernel"), ("k1_dw", "concat_dw_kernel"),
             ("k1_dw_reduce", "concat_dw_reduce_kernel"))
    tries = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as short:
            replays(TRACE_REPLAYS)
        found = device_rows(short)
        tries.append({name: sum(c for k, _, c in found if word in k)
                      / TRACE_REPLAYS for name, word in words})
    counts = {name: max(t[name] for t in tries) for name, _ in words}
    res = {"wall_ms_per_step": wall, "busy_ms_per_step": busy,
           "idle_share": 1 - busy / wall, "trace_launches_per_step": counts,
           "trace_tries": tries,
           "top": [{"kernel": k[:100], "ms_per_step": ms / PROFILE_REPLAYS,
                    "calls": c // PROFILE_REPLAYS} for k, ms, c in rows[:12]]}
    log(f"  profile {what}: replayed step {wall:.2f} ms wall, {busy:.2f} ms "
        f"busy, idle share {res['idle_share']:.3f}; K1 kernels a step in the "
        f"trace {counts} [{card}]")
    for k, ms, c in rows[:8]:
        log(f"    {ms / PROFILE_REPLAYS:9.3f} ms/step "
            f"{c // PROFILE_REPLAYS:5d} x {k[:90]}")
    return res


def test_in_dtype(what: str, name: str, tree: Path, run: Path, tmp: Path,
                  train_stats: dict, net_kwargs: dict, card: str) -> dict:
    """``run_test`` of a test config with ``net_kwargs`` and nothing
    exported: its log's mean PSNR against the trainer's validation PSNR of
    the epoch the monitor kept."""
    from vsr_tpu_torch.config import load_config
    from vsr_tpu_torch.main import run_test

    path = testing_config(name, tree, run, net_kwargs, tmp, exported=False)
    t0 = time.perf_counter()
    log_ = run_test(load_config(path))
    seconds = time.perf_counter() - t0
    best = int(np.argmin(train_stats["valid_loss_by_epoch"]))
    want = train_stats["valid_psnr_by_epoch"][best]
    log(f"  {what}: mean PSNR {log_['PSNR']:.4f} dB vs the trainer's "
        f"validation PSNR of epoch {best + 1} {want:.4f} dB, in {seconds:.2f}"
        f" s (nothing exported) [{card}]")
    if abs(log_["PSNR"] - want) > TEST_PSNR_TOL:
        raise SystemExit(f"{what}: main --test scores {log_['PSNR']:.4f} dB, "
                         f"the trainer's validation pass {want:.4f} dB")
    return {"psnr": log_["PSNR"], "trainer_valid_psnr": want,
            "seconds": seconds, "log": log_}


def phase_device_epochs(tmp: Path, card: str, dev) -> dict:
    """The four ``*_device.yaml`` configs trained through ``run_train`` at
    their widths, batches, patches and steps per epoch for two epochs (one
    captured CUDA graph of the step each, replayed), the DRF one also
    through K1 (bf16 training, carry_f32 off) with the kernel on and off,
    one epoch eagerly and through the graph from the same draws, a device
    checkpoint resumed by the host-loop trainer, ``main --test`` on the
    four test twins, and a trace of the replays."""
    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.runner.device_trainer import WARMUP_STEPS

    res, runs = {}, {}
    for key, (name, tree, frames) in DEVICE_RUNS.items():
        log(f"phase 11{'abcd'[list(DEVICE_RUNS).index(key)]}: {name}, "
            f"device epochs: {DEVICE_EPOCHS}")
        cfg = device_config(name, tmp / tree, tmp / f"dev_{key}", tmp)
        runs[key] = device_run(f"device {key}", cfg, card, frames, k1=False)
        res[key] = runs[key]["stats"]

    log("phase 11e: the DRF device config through K1 (bf16, fused_squeeze), "
        "on and off")
    name, tree, frames = DEVICE_RUNS["vsr"]
    for label, on in (("k1_on", True), ("k1_off", False)):
        cfg = device_config(name, tmp / tree, tmp / f"dev_vsr_{label}", tmp,
                            dict(K1_DEVICE, fused_squeeze=on))
        runs[label] = device_run(f"device vsr {label}", cfg, card, frames,
                                 k1=on)
        res[label] = runs[label]["stats"]
    on, off = res["k1_on"]["first_loss"], res["k1_off"]["first_loss"]
    res["k1_first_loss_relative_diff"] = rel = abs(on - off) / abs(off)
    shape = (res["k1_on"]["batch"], runs["k1_on"]["trainer"].patch)
    if shape != (DEVICE_N, TRAIN_LR):
        raise SystemExit(f"device vsr: batch and patch {shape}, phase 6 held "
                         f"K1 at {(DEVICE_N, TRAIN_LR)}")
    log(f"  K1 on vs off: first loss {on:.6f} vs {off:.6f} (relative "
        f"{rel:.3g}); launches a train step with it on "
        f"{res['k1_on']['k1_launches_per_step']}, 0 with it off; replayed "
        f"step {res['k1_on']['replay_step_ms']:.2f} vs "
        f"{res['k1_off']['replay_step_ms']:.2f} ms")
    if rel > K1_ON_OFF_TOL:
        raise SystemExit(f"device vsr: first loss with K1 on and off differ "
                         f"by {rel:.3g} relative")

    log("phase 11f: one epoch eagerly and through the graph, same draws")
    step_losses = {}
    for graph in (True, False):
        cfg = device_config(name, tmp / tree, tmp / f"dev_graph_{graph}", tmp,
                            K1_DEVICE, steps_per_epoch=GRAPH_STEPS)
        cfg.trainer.kwargs.num_epochs = 0  # built, not trained
        trainer = run_train(cfg)
        trainer._ensure_buffers()
        trainer.engine.use_graph = graph
        trainer._run_epoch("training", 1)
        step_losses[graph] = trainer.engine.log[:, 0].clone()
        if graph and trainer.engine.replays != GRAPH_STEPS - WARMUP_STEPS:
            raise SystemExit("graph vs eager: the graph epoch did not replay")
        if not graph and trainer.engine.graphs:
            raise SystemExit("graph vs eager: the eager epoch captured")
    diff = ((step_losses[True] - step_losses[False]).abs()
            / step_losses[False].abs()).max().item()
    res["graph_vs_eager"] = {"steps": GRAPH_STEPS, "max_relative_diff": diff,
                             "graph": step_losses[True].tolist(),
                             "eager": step_losses[False].tolist()}
    log(f"  graph vs eager, {GRAPH_STEPS} steps of the DRF K1 config: per-step"
        f" losses within {diff:.3g} relative")
    if diff > GRAPH_TOL:
        raise SystemExit(f"graph vs eager: per-step losses differ by "
                         f"{diff:.3g} relative")

    log("phase 11g: a device checkpoint resumed by the host-loop trainer")
    ckpt = tmp / "dev_vsr" / "checkpoints" / f"model_{DEVICE_EPOCHS}.ckpt"
    cfg = training_config("acdc_vsr_drf_x2", tmp / "tree", tmp / "dev_host",
                          {"dtype": "bfloat16", "carry_f32": True,
                           "fused_tail": True}, tmp, loaded_path=str(ckpt))
    cfg.trainer.kwargs.num_epochs = DEVICE_EPOCHS + 1
    reset_launches()
    host = run_train(cfg)
    epochs = [json.loads(line)["epoch"] for line in
              (tmp / "dev_host" / "log" / "metrics.jsonl").read_text()
              .splitlines()]
    adam = {float(st["step"]) for st in host.optimizer.state.values()}
    want = {float(res["vsr"]["steps"] + len(host.train_dataloader))}
    res["host_resume"] = {"epochs": epochs, "adam_steps": sorted(adam),
                          "valid_psnr": json.loads(
                              (tmp / "dev_host" / "log" / "metrics.jsonl")
                              .read_text().splitlines()[-1])["valid"]["PSNR"]}
    log(f"  the host-loop AcdcVSRTrainer resumed model_{DEVICE_EPOCHS}.ckpt "
        f"of the device run: epochs {epochs}, Adam steps {sorted(adam)} "
        f"(want {sorted(want)}), validation PSNR "
        f"{res['host_resume']['valid_psnr']:.3f} dB")
    if epochs != [DEVICE_EPOCHS + 1] or adam != want or not all(
            torch.isfinite(v).all() for v in host.net.state_dict().values()):
        raise SystemExit("the host-loop trainer did not resume the device "
                         "checkpoint")

    log("phase 11h: main --test on the four test twins")
    from vsr_tpu_torch.config import load_config

    root = Path(__file__).resolve().parent
    for key, (name, tree, _) in DEVICE_RUNS.items():
        # A twin that serves in float32 what was trained (and validated) in
        # bf16 scores it apart from the trainer's validation pass by bf16's
        # rounding: it runs as written, reported, and again with the
        # training dtype and no files written (its log: the mean of its
        # rows), held to the trainer's validation PSNR.
        dtypes = [load_config(root / "configs" / kind / f"{name}.yaml")
                  .net.kwargs.get("dtype") for kind in ("train", "test")]
        same = dtypes[0] == dtypes[1]
        what, run = f"device test {key}", tmp / f"dev_{key}"
        tol = TEST_PSNR_TOL if same else None
        if tree != "tree":
            # Depth cut: the volume twins write no NIfTI here (about a
            # minute of gzip each); phase 10 gates the same predictors'
            # rows and files. Held to the trainer's validation PSNR in the
            # training dtype, as below.
            res[key]["test_in_training_dtype"] = test_in_dtype(
                f"{what} in {dtypes[0] or 'float32'}", name, tmp / tree, run,
                tmp, res[key], {"dtype": dtypes[0]} if dtypes[0] else {},
                card)
            continue
        res[key]["test"] = test_run(what, name, tmp / tree, run, {}, tmp,
                                    res[key], 0, card, psnr_tol=tol)
        if not same:
            res[key]["test_in_training_dtype"] = test_in_dtype(
                f"{what} in {dtypes[0]}", name, tmp / tree, run, tmp,
                res[key], {"dtype": dtypes[0]}, card)

    log("phase 11i: traces of the replayed steps")
    for key in (*DEVICE_RUNS, "k1_on", "k1_off"):
        # A dropped record only lowers a count: one trace shows K1 absent,
        # the launch count held to what is expected takes the most of
        # TRACE_TRIES.
        res[key]["profile"] = replay_profile(
            key, runs[key]["trainer"], card,
            TRACE_TRIES if key == "k1_on" else 1)
    counts = res["k1_on"]["profile"]["trace_launches_per_step"]
    per_step = res["k1_on"]["k1_launches_per_step"]
    # The kernel's forward and dx launches, the dW / db kernel with its
    # second pass, as the counters read them per step.
    want = {"k1": per_step["forward"] + per_step["dx"],
            "k1_dw": per_step["dw"], "k1_dw_reduce": per_step["dw"]}
    off = res["k1_off"]["profile"]["trace_launches_per_step"]
    if counts != want or any(off.values()):
        raise SystemExit(f"the trace counts K1 kernels {counts} a replayed "
                         f"step with it on (want {want}), {off} with it off")
    return res


def phase_profile_volumes(dev) -> dict:
    """One ``torch.profiler`` trace of a full volume through each volume
    net's pipeline (seeded weights, fused_tail on): device time by kernel,
    the idle share against the median wall of 3 unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    from vsr_tpu_torch.config import load_config
    from vsr_tpu_torch.infer import VOLUME_NETS, make_pipeline
    from vsr_tpu_torch.registry import build

    root = Path(__file__).resolve().parent
    frames = torch.from_numpy(as_frames(make_volume(30, FULL_SLICES)))
    res = {}
    for key, (name, net, _) in VOL_RUNS.items():
        kwargs = dict(load_config(root / "configs" / "train" / f"{name}.yaml")
                      .net.kwargs, fused_tail=True)
        pipe = make_pipeline(
            build("net", {"name": net, "kwargs": kwargs}, device=dev,
                  generator=torch.Generator().manual_seed(0)),
            FACTOR, "acdc", volume=(VOLUME_NETS[net], T_FRAMES))

        def once():
            out = pipe(frames.to(dev))[1].cpu()
            torch.cuda.synchronize()
            return out

        once()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            once()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            once()
        rows = device_rows(prof)
        busy, wall = sum(r[1] for r in rows), statistics.median(walls)
        res[key] = {"wall_ms": wall, "busy_ms": busy,
                    "idle_share": 1 - busy / wall,
                    "top": [{"kernel": k[:100], "ms": ms, "calls": c}
                            for k, ms, c in rows[:20]]}
        log(f"  profile {key} serving: wall {wall:.1f} ms, busy {busy:.1f} ms, "
            f"idle share {1 - busy / wall:.3f}")
        for k, ms, c in rows[:12]:
            log(f"    {ms:9.2f} ms {c:6d} x {k[:90]}")
    return res


def phase_profile_determinism(dev, card: str) -> dict:
    """Does the DRF f32 pipeline (kernel on) repeat its bits on the card,
    with ``cudnn.deterministic`` off (the default) and on, and what does
    each cost a volume? Per setting: one traced call (its largest device
    kernel), then two timed calls compared bit for bit; the flag is
    restored."""
    from torch.profiler import ProfilerActivity, profile

    from vsr_tpu_torch.infer import make_pipeline

    path = PATHS[0]
    pipe = make_pipeline(build_net(path, path.on, dev), FACTOR, "acdc",
                         **path.pipe_kw(T_FRAMES))
    x = torch.from_numpy(as_frames(make_volume(40, FULL_SLICES))).to(dev)
    res = {}
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pipe(x)[1].cpu()
            name, top_ms, calls = device_rows(prof)[0]
            outs, ms = [], []
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                outs.append(pipe(x)[1].cpu().numpy())
                ms.append((time.perf_counter() - t0) * 1e3)
            mode = "on" if det else "off"
            res[mode] = {"repeat_bit_equal": bool(np.array_equal(*outs)),
                         "ms": statistics.median(ms),
                         "largest_kernel": {"name": name[:120], "ms": top_ms,
                                            "calls": calls}}
            log(f"  drf make_pipeline repeated, cudnn.deterministic {mode}: "
                f"bit-equal {res[mode]['repeat_bit_equal']}, "
                f"{res[mode]['ms']:.1f} ms a volume; largest kernel "
                f"{top_ms:.1f} ms ({calls} x {name[:60]}) [{card}]")
    finally:
        torch.backends.cudnn.deterministic = False
    return res


# ================================================================ deployment

# configs/train/acdc_4d_vol_x2.yaml's net, served as a stream (no kernel).
VOL4D_CONFIG = "acdc_4d_vol_x2"
CLIENTS, REQUESTS_PER_CLIENT = 8, 1   # phase 12b's traffic, every daemon
P99_MIN_REQUESTS = 100  # fewer: report the largest latency, not a p99
BATCH_WAIT_MS = 50.0  # lets two half volumes share one program call
HALF_SLICES = FULL_SLICES // 2


def post(url: str, body: bytes, ctype: str) -> tuple[bytes, float, dict]:
    """One POST: the response body, its wall seconds and headers."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = resp.read()
        headers = dict(resp.headers)
    return out, time.perf_counter() - t0, headers


def npy_bytes(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def from_npy(body: bytes) -> np.ndarray:
    import io

    return np.load(io.BytesIO(body), allow_pickle=False)


def gate_agreement(what: str, got: np.ndarray, want: np.ndarray) -> dict:
    """>= 99.9 % exact grey and <= 1 grey (bit-equal passes)."""
    if got.shape != want.shape:
        raise SystemExit(f"{what}: shape {got.shape} vs {want.shape}")
    exact, worst = agreement(got, want)
    if exact < 0.999 or worst > 1:
        raise SystemExit(f"{what}: {exact * 100:.4f}% exact, max {worst:g} "
                         "grey")
    return {"exact_fraction": exact, "max_grey_diff": worst}


def timed_volume(fn, frames: np.ndarray, dev, reps: int = 2) -> float:
    """Median wall ms of one volume through ``fn`` (H2D, program, D2H)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(torch.from_numpy(frames).to(dev))[1].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def deploy_artifacts(tmp: Path, frames: np.ndarray, card: str, dev) -> dict:
    """12a: each path's pipeline exported at the full frames shape on the
    card, saved, loaded back, run on one noise volume: against
    ``make_pipeline`` on the same net, against the kernel-off program, and
    its launches per volume."""
    from vsr_tpu_torch import export
    from vsr_tpu_torch.infer import make_pipeline

    res = {}
    x = torch.from_numpy(frames).to(dev)
    for path in PATHS:
        net = build_net(path, path.on, dev)
        mode = path.pipe_kw(T_FRAMES)
        t0 = time.perf_counter()
        program, meta = export.export_serving(net, frames.shape, FACTOR,
                                              **mode)
        export_s = time.perf_counter() - t0
        file = tmp / f"{path.key}.pt2.zip"
        t0 = time.perf_counter()
        export.save_artifact(file, program, {**meta, "net": path.net})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = export.ExportedServing(file, device=dev)
        load_s = time.perf_counter() - t0
        ops = sum(1 for n in program.graph.nodes
                  if str(n.target) == f"vsr_tpu_torch.{path.kernel}.default")
        del program
        pipe = make_pipeline(net, FACTOR, "acdc", **mode)
        want = pipe(x)[1].cpu().numpy()
        reset_launches()
        got = served(frames)[1].cpu().numpy()
        launches = check_launches(f"{path.key} artifact", path.kernel,
                                  path.launches_per_volume(FULL_SLICES))
        check_sr(f"{path.key} artifact", got, frames.shape)
        vs_pipeline = gate_agreement(f"{path.key} artifact vs make_pipeline",
                                     got, want)
        plain_net = build_net(path, path.off, dev)
        if path.key == "drf":  # exported too, run without a save / load
            plain_prog, _ = export.export_serving(plain_net, frames.shape,
                                                  FACTOR, **mode)
            with torch.inference_mode():
                plain = plain_prog.module()(x)[1].cpu().numpy()
            del plain_prog
        else:
            plain = make_pipeline(plain_net, FACTOR, "acdc", **mode)(x)[1]
            plain = plain.cpu().numpy()
        vs_plain = gate_agreement(f"{path.key} artifact vs the kernel-off "
                                  "program", got, plain)
        artifact_ms = timed_volume(served, frames, dev)
        pipeline_ms = timed_volume(pipe, frames, dev)
        res[path.key] = {
            "file_mb": file.stat().st_size / 1e6, "op_nodes": ops,
            "export_s": export_s, "save_s": save_s, "load_s": load_s,
            "launches": launches, "vs_pipeline": vs_pipeline,
            "vs_plain": vs_plain, "artifact_ms": artifact_ms,
            "pipeline_ms": pipeline_ms, "served": served, "pipe": pipe,
            "out": got}
        log(f"  {path.key} artifact ({frames.shape}, {ops} {path.kernel} op "
            f"nodes, {res[path.key]['file_mb']:.1f} MB): export "
            f"{export_s:.1f} s, save {save_s:.1f} s, load {load_s:.1f} s; "
            f"{path.kernel} launches {launches} a volume; vs make_pipeline "
            f"{vs_pipeline['exact_fraction'] * 100:.4f}% exact; a volume "
            f"{artifact_ms:.1f} ms (artifact) vs {pipeline_ms:.1f} ms "
            f"(make_pipeline) [{card}]")
    return res


def latency_stats(lat: list[float]) -> dict:
    """p50 and the largest of ``n`` request latencies in ms; a p99 only
    from P99_MIN_REQUESTS requests on, below that it would be the largest
    sample under another name."""
    out = {"requests": len(lat), "p50_ms": 1e3 * float(np.percentile(lat, 50)),
           "max_ms": 1e3 * max(lat)}
    if len(lat) >= P99_MIN_REQUESTS:
        out["p99_ms"] = 1e3 * float(np.percentile(lat, 99))
    return out


def deploy_daemon(tmp: Path, arts: dict, vols: list, card: str, dev,
                  per_client: int = REQUESTS_PER_CLIENT) -> dict:
    """12b: one daemon per artifact (a geometry routes to one program), each
    taking the same traffic: CLIENTS threads, each POSTing ``per_client``
    .npy volumes back to back (closed loop). DRF also takes a NIfTI volume
    and two concurrent half volumes that share one program call. Every
    response is held against the artifact called directly; ``/metrics``
    counts the requests."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from vsr_tpu_torch import serve
    from vsr_tpu_torch.infer import load_hr_frames
    from vsr_tpu_torch.io.nifti import save_nifti

    res = {}
    for path in PATHS:
        art = arts[path.key]
        served = art["served"]
        drf = path.key == "drf"
        # The direct calls every response is held against, made before the
        # counts are reset.
        direct = [served(v)[1].cpu().numpy() for v in vols]
        if drf:
            # A NIfTI volume (int16, 10 slices x 30 frames), answered as
            # .npy; two half volumes against their solo (padded) calls.
            nii = tmp / "daemon_in.nii"
            save_nifti(np.moveaxis(vols[0].reshape(
                FULL_SLICES, T_FRAMES, HR, HR), (0, 1), (2, 3)).astype(
                np.int16), nii)
            frames_nii, geom = load_hr_frames(nii)
            want_nii = served(frames_nii.astype(np.float32))[1].cpu().numpy()
            half = [v[:HALF_SLICES * T_FRAMES] for v in vols]
            want_half = [served(np.concatenate(
                [h] + [h[-T_FRAMES:]] * (FULL_SLICES - HALF_SLICES)))[1]
                .cpu().numpy()[:len(h)] for h in half]
        reset_launches()
        srv = serve.make_server([served], port=0, warmup=True, device=dev,
                                batch_wait_ms=BATCH_WAIT_MS)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            bodies = [npy_bytes(v) for v in vols]

            def client(c):
                out = []
                for r in range(per_client):
                    j = (c * per_client + r) % len(vols)
                    body, sec, _ = post(f"{url}/v1/sr", bodies[j],
                                        "application/x-npy")
                    out.append((j, from_npy(body), sec))
                return out

            t0 = time.perf_counter()
            with ThreadPoolExecutor(CLIENTS) as ex:
                done = [o for outs in ex.map(client, range(CLIENTS))
                        for o in outs]
            wall = time.perf_counter() - t0
            held = [gate_agreement(f"{path.key} daemon response", sr,
                                   direct[j]) for j, sr, _ in done]
            entry = {"clients": CLIENTS, "wall_s": wall,
                     **latency_stats([sec for _, _, sec in done]),
                     "bit_equal_responses": sum(
                         h["max_grey_diff"] == 0 for h in held),
                     "min_exact_fraction": min(
                         h["exact_fraction"] for h in held),
                     "max_grey_diff": max(h["max_grey_diff"] for h in held),
                     "volumes_per_s": len(done) / wall,
                     "direct_volumes_per_s": 1e3 / art["artifact_ms"]}
            sent = len(done)
            if drf:
                body, _, _ = post(f"{url}/v1/sr?format=npy",
                                  nii.read_bytes(), "application/octet-stream")
                entry["nifti"] = gate_agreement(
                    "drf daemon NIfTI response", from_npy(body), want_nii)
                coalesced = srv.metrics.coalesced_requests
                with ThreadPoolExecutor(2) as ex:
                    outs = list(ex.map(lambda h: from_npy(post(
                        f"{url}/v1/sr", npy_bytes(h), "application/x-npy")[0]),
                        half))
                entry["half"] = [gate_agreement(
                    "drf daemon coalesced half volume vs its solo call", g, w)
                    for g, w in zip(outs, want_half)]
                entry["coalesced_half_volumes"] = (
                    srv.metrics.coalesced_requests - coalesced)
                entry["nifti_geom"] = list(geom)
                sent += 3
            with urllib.request.urlopen(f"{url}/metrics") as resp:
                text = resp.read().decode()
            calls = srv.metrics.batch_calls + 1  # + the warm-up call
            entry.update(program_calls=calls,
                         batched_calls=srv.metrics.batch_calls,
                         coalesced_requests=srv.metrics.coalesced_requests)
            line = f'vsr_requests_total{{endpoint="/v1/sr",status="200"}} {sent}'
            if line not in text or srv.metrics.volumes != sent:
                raise SystemExit(f"{path.key} daemon: /metrics does not count "
                                 f"the {sent} requests")
        finally:
            srv.shutdown()
            srv.server_close()
        entry["launches"] = check_launches(
            f"{path.key} daemon", path.kernel,
            path.launches_per_volume(FULL_SLICES) * calls)
        if drf and entry["coalesced_half_volumes"] < 2:
            raise SystemExit("drf daemon: the half volumes did not coalesce")
        res[path.key] = entry
        p99 = (f"p99 {entry['p99_ms']:.1f} ms, " if "p99_ms" in entry else "")
        log(f"  {path.key} daemon: {entry['requests']} .npy volumes from "
            f"{CLIENTS} clients, p50 {entry['p50_ms']:.1f} ms, {p99}max of "
            f"{entry['requests']} {entry['max_ms']:.1f} ms, "
            f"{entry['volumes_per_s']:.3f} volumes/s through HTTP vs "
            f"{entry['direct_volumes_per_s']:.3f} direct; {calls} program "
            f"calls, {entry['launches']} {path.kernel} launches; "
            f"{entry['bit_equal_responses']} of {entry['requests']} responses "
            f"bit-equal to the direct call (min "
            f"{entry['min_exact_fraction'] * 100:.4f}% exact, max "
            f"{entry['max_grey_diff']:g} grey) [{card}]")
    return res


def push_all(stream, seq: np.ndarray) -> tuple[dict, list]:
    """Push the (D, T, H, W) sequence a time point at a time, then flush:
    SR frames by output index and each push's wall ms (SR copied back)."""
    out, lat = {}, []
    for t in range(seq.shape[1]):
        t0 = time.perf_counter()
        got = stream.push(seq[:, t])
        if got is not None:
            t_out = got[0] if len(got) == 3 else t
            out[t_out] = got[-1].cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1e3)
    for t_out, _lr, sr in stream.flush():
        out[t_out] = sr.cpu().numpy()
    return out, lat


def deploy_streams(frames: np.ndarray, card: str, dev) -> dict:
    """12c: the streams at the full geometry, one time point (10 slices) a
    push, against the batch pipeline of the same volume."""
    from vsr_tpu_torch.infer import build_serving_net, make_pipeline
    from vsr_tpu_torch.stream import make_stream

    root = Path(__file__).resolve().parent
    from vsr_tpu_torch.config import load_config

    vol4d_kw = dict(load_config(root / "configs" / "train"
                                / f"{VOL4D_CONFIG}.yaml").net.kwargs)
    seq = frames.reshape(FULL_SLICES, T_FRAMES, HR, HR)
    x = torch.from_numpy(frames).to(dev)
    cases = [(path.key, path.net, build_net(path, path.on, dev),
              path.pipe_kw(T_FRAMES), path.kernel,
              {"drf": SQUEEZES_PER_STEP * T_FRAMES, "moe": MOE_LAYERS * T_FRAMES,
               "duf": T_FRAMES}[path.key]) for path in PATHS]
    cases.append(("vol4d", "Volume4DSRNet", build_serving_net(
        "Volume4DSRNet", vol4d_kw, device=dev), {"volume": ("4d", T_FRAMES)},
        None, 0))
    res = {}
    for key, net_name, net, mode, kernel, want_launches in cases:
        _, want = make_pipeline(net, FACTOR, "acdc", **mode)(x)
        want = want.cpu().numpy().reshape(FULL_SLICES, T_FRAMES, HR, HR)
        windows = mode["window"][0] if "window" in mode else 0
        stream = make_stream(net, FACTOR, windows=windows)
        reset_launches()
        out, lat = push_all(stream, seq)
        launches = check_launches(f"{key} stream", kernel or "concat_conv1x1",
                                  want_launches)
        if sorted(out) != list(range(T_FRAMES)):
            raise SystemExit(f"{key} stream: outputs {sorted(out)}")
        got = np.stack([out[t] for t in range(T_FRAMES)], axis=1)
        res[key] = dict(gate_agreement(f"{key} stream vs its batch pipeline",
                                       got, want),
                        family=type(stream).__name__, launches=launches,
                        median_push_ms=statistics.median(lat),
                        max_push_ms=max(lat))
        log(f"  {key} {type(stream).__name__}: {T_FRAMES} pushes of "
            f"({FULL_SLICES}, {HR}, {HR}), median push {res[key]['median_push_ms']:.2f}"
            f" ms (max {res[key]['max_push_ms']:.1f}), vs the batch pipeline "
            f"{res[key]['exact_fraction'] * 100:.4f}% exact, max "
            f"{res[key]['max_grey_diff']:g} grey, {kernel or 'no kernel'} "
            f"launches {launches} [{card}]")
    return res


def deploy_checkpoint(tmp: Path, served7: dict, card: str, dev) -> dict:
    """12d: the daemon's live backend serves phase 7's DRF checkpoint (the
    one ``infer --checkpoint`` served there) on its NIfTI volume: equal to
    phase 7's served output."""
    import threading

    from vsr_tpu_torch import serve
    from vsr_tpu_torch.io.nifti import load_nifti

    reset_launches()
    live = serve.LivePipeline(
        net_name="DRFNet", net_kwargs=served7["net_kwargs"],
        checkpoint=served7["ckpt"], frames_shape=(T_FRAMES, HR, HR),
        factor=FACTOR, video_t=T_FRAMES, device=dev)
    srv = serve.make_server([], port=0, warmup=True, live=[live], device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body, sec, headers = post(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/sr",
            Path(served7["nifti"]).read_bytes(), "application/octet-stream")
    finally:
        srv.shutdown()
        srv.server_close()
    launches = check_launches("checkpoint daemon", "concat_conv1x1",
                              2 * SQUEEZES_PER_STEP * T_FRAMES)
    out = tmp / "checkpoint_daemon_sr.nii.gz"
    out.write_bytes(body)
    got = load_nifti(out)
    res = dict(gate_agreement("the daemon's live checkpoint pipeline vs "
                              "phase 7's infer --checkpoint", got,
                              served7["sr"]),
               launches=launches, request_ms=sec * 1e3,
               content_type=headers.get("Content-Type"))
    log(f"  live DRF pipeline on phase 7's checkpoint over HTTP (NIfTI in, "
        f".nii.gz out): vs phase 7's infer --checkpoint output "
        f"{res['exact_fraction'] * 100:.4f}% exact, max "
        f"{res['max_grey_diff']:g} grey; {launches} K1 launches (warm-up + "
        f"request) [{card}]")
    return res


def trace_artifact_vs_pipeline(arts: dict, frames: np.ndarray, card: str,
                               dev, key: str = "drf") -> dict:
    """One volume through a path's loaded artifact and through
    ``make_pipeline`` on the same net, each traced once after 3 unprofiled
    runs: wall, device busy ms, device kernels, host ATen operators
    dispatched, and the device kernels and host operators whose totals
    differ most between the two."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(frames).to(dev)
    res, kernels, host_ops = {}, {}, {}
    for name, fn in (("artifact", arts[key]["served"]),
                     ("make_pipeline", arts[key]["pipe"])):
        def once():
            fn(x)[1].cpu()
            torch.cuda.synchronize(dev)

        once()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            once()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            once()
        rows = device_rows(prof)
        host = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU
                and e.key.startswith(("aten::", "vsr_tpu_torch::"))]
        kernels[name] = {k: (ms, c) for k, ms, c in rows}
        host_ops[name] = {e.key: (e.self_cpu_time_total / 1e3, e.count)
                          for e in host}
        res[name] = {"wall_ms": statistics.median(walls),
                     "busy_ms": sum(r[1] for r in rows),
                     "kernels": sum(r[2] for r in rows),
                     "host_ops": sum(e.count for e in host),
                     "host_self_ms": sum(e.self_cpu_time_total
                                         for e in host) / 1e3}
        log(f"  {key} {name}: wall {res[name]['wall_ms']:.1f} ms, busy "
            f"{res[name]['busy_ms']:.1f} ms, {res[name]['kernels']} kernels, "
            f"{res[name]['host_ops']} host ATen ops ({res[name]['host_self_ms']:.1f}"
            f" ms self) [{card}]")

    def diff(table, n=8):
        a, b = table["artifact"], table["make_pipeline"]
        rows = [(k, a.get(k, (0, 0))[0] - b.get(k, (0, 0))[0],
                 a.get(k, (0, 0))[1], b.get(k, (0, 0))[1]) for k in {*a, *b}]
        rows.sort(key=lambda r: -abs(r[1]))
        return [{"name": k[:100], "ms_diff": d, "calls_artifact": ca,
                 "calls_pipeline": cp} for k, d, ca, cp in rows[:n]]

    res["kernel_diff"] = diff(kernels)
    res["host_op_diff"] = diff(host_ops)
    for what in ("kernel_diff", "host_op_diff"):
        log(f"  {key} artifact - make_pipeline, {what}:")
        for r in res[what]:
            log(f"    {r['ms_diff']:+9.2f} ms {r['calls_artifact']:6d} vs "
                f"{r['calls_pipeline']:6d} x {r['name'][:80]}")
    return res


def phase_latency(tmp: Path, card: str, dev, per_client: int) -> dict:
    """``--latency``: phase 12a's artifacts, then each daemon under CLIENTS
    closed-loop clients of ``per_client`` requests each (enough for a p99),
    and the DRF artifact traced against ``make_pipeline``."""
    frames = as_frames(make_volume(40, FULL_SLICES))
    vols = [frames, as_frames(make_volume(41, FULL_SLICES))]
    log("latency: artifacts (torch.export at the full frames shape)")
    arts = deploy_artifacts(tmp, frames, card, dev)
    log(f"latency: the HTTP daemons, {CLIENTS} clients x {per_client} "
        "requests")
    res = {"daemon": deploy_daemon(tmp, arts, vols, card, dev,
                                   per_client=per_client)}
    log("latency: the DRF artifact against make_pipeline, traced")
    res["trace"] = trace_artifact_vs_pipeline(arts, frames, card, dev)
    res["artifacts"] = {k: {n: v for n, v in a.items()
                            if n not in ("served", "pipe", "out")}
                        for k, a in arts.items()}
    return res


def phase_deployment(tmp: Path, card: str, dev, served7: dict) -> dict:
    """Phase 12: the serving deployment (artifacts, daemon, streams, the
    checkpoint's live pipeline), K1, K2 and K3 through each."""
    frames = as_frames(make_volume(40, FULL_SLICES))
    vols = [frames, as_frames(make_volume(41, FULL_SLICES))]
    res = {}
    log("phase 12a: artifacts (torch.export at the full frames shape)")
    arts = deploy_artifacts(tmp, frames, card, dev)
    torch.cuda.empty_cache()
    log("phase 12b: the HTTP daemon")
    res["daemon"] = deploy_daemon(tmp, arts, vols, card, dev)
    res["artifacts"] = {k: {n: v for n, v in a.items()
                            if n not in ("served", "pipe", "out")}
                        for k, a in arts.items()}
    del arts
    torch.cuda.empty_cache()
    log("phase 12c: streams")
    res["streams"] = deploy_streams(frames, card, dev)
    torch.cuda.empty_cache()
    log("phase 12d: the checkpoint through the daemon's live backend")
    res["checkpoint"] = deploy_checkpoint(tmp, served7, card, dev)
    return res


# ========================================================= quantized serving

PEAK_INT8 = 1979e12  # dense int8 tensor-core operations/s (data sheet)
# configs/test/acdc_sisr_edsr_x2.yaml's net (frame mode, no chunk).
EDSR_KWARGS = dict(in_channels=1, out_channels=1, num_resblocks=16,
                   num_features=64, upscale_factor=FACTOR)
INT8_PSNR_BAR, W8A8_PSNR_BAR = 0.05, 0.5  # dB: tests/test_quantize.py's
W8A8_CHECK_ITEMS = 2   # batch items held against the twin per shape
SHAPE_REPS = 3         # CUDA-event timings per conv shape (median)
LIBRARY_MAX_BYTES = 4e9  # im2col matrices larger than this are not timed
# tests/test_torch_quantize.py's bars for the kernel against the twin:
# float32 within 1e-6 of the largest output entry, bf16 within one ulp.
W8A8_F32_SHARE = 1e-6
# The per-tap kernel (the earlier implicit GEMM that re-quantized each
# activation per tap) at each eligible shape: (float32, bf16) ms, keyed by
# (x, weight, stride, padding); measured on one NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md section 6). Printed beside the patch kernel's times.
PER_TAP_W8A8_MS = {
    ((300, 64, 96, 96), (64, 64, 3, 3), (1, 1), (1, 1)):
        (5.846, 5.767),
    ((300, 64, 96, 96), (256, 64, 3, 3), (1, 1), (1, 1)):
        (22.46, 21.914),
    ((300, 256, 96, 96), (64, 256, 1, 1), (1, 1), (0, 0)):
        (4.277, 4.12),
    ((10, 64, 192, 192), (64, 64, 6, 6), (2, 2), (2, 2)):
        (0.879, 0.866),
    ((10, 64, 96, 96), (256, 64, 3, 3), (1, 1), (1, 1)):
        (0.896, 0.851),
    ((100, 64, 7, 96, 96), (64, 64, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (3.016, 2.945),
    ((100, 64, 7, 96, 96), (32, 64, 3, 3, 3), (1, 1, 1), (1, 1, 1)):
        (34.192, 34.419),
    ((100, 96, 7, 96, 96), (96, 96, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (8.162, 7.747),
    ((100, 96, 7, 96, 96), (32, 96, 3, 3, 3), (1, 1, 1), (1, 1, 1)):
        (51.194, 51.217),
    ((100, 128, 7, 96, 96), (128, 128, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (10.551, 10.015),
    ((100, 128, 7, 96, 96), (32, 128, 3, 3, 3), (1, 1, 1), (1, 1, 1)):
        (68.06, 68.053),
    ((100, 160, 7, 96, 96), (160, 160, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (18.903, 18.063),
    ((100, 160, 7, 96, 96), (32, 160, 3, 3, 3), (1, 1, 1), (0, 1, 1)):
        (63.442, 63.297),
    ((100, 192, 5, 96, 96), (192, 192, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (16.09, 15.415),
    ((100, 192, 5, 96, 96), (32, 192, 3, 3, 3), (1, 1, 1), (0, 1, 1)):
        (46.318, 46.072),
    ((100, 224, 3, 96, 96), (224, 224, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (14.796, 14.219),
    ((100, 224, 3, 96, 96), (32, 224, 3, 3, 3), (1, 1, 1), (0, 1, 1)):
        (18.76, 18.861),
    ((100, 256, 1, 96, 96), (256, 256, 1, 3, 3), (1, 1, 1), (0, 1, 1)):
        (28.88, 28.623),
    ((100, 256, 1, 96, 96), (512, 256, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (11.304, 10.853),
    ((100, 512, 1, 96, 96), (100, 512, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (5.382, 5.284),
    ((100, 256, 1, 96, 96), (256, 256, 1, 1, 1), (1, 1, 1), (0, 0, 0)):
        (5.711, 5.454),
}


def w8a8_bytes_and_ops(x_shape, weight_shape, out_shape, x_itemsize: int,
                       out_itemsize: int) -> tuple[int, int]:
    """The bytes one W8A8 conv must move (the activations read once, the
    int8 weights, their scales and the bias read once, the output written
    once) and its int8 multiply-adds counted as two operations each."""
    f, k = weight_shape[0], int(np.prod(weight_shape[1:]))
    n_bytes = (int(np.prod(x_shape)) * x_itemsize + f * k + 8 * f
               + int(np.prod(out_shape)) * out_itemsize)
    return n_bytes, 2 * int(np.prod(out_shape)) * k


def eligible_conv_shapes(net, z, shapes: dict) -> None:
    """Add the geometry of every eligible conv that one forward of ``net``
    on ``z`` calls: ``(x shape, weight shape, stride, padding, groups)`` ->
    where it was seen."""
    from vsr_tpu_torch import quantize
    from vsr_tpu_torch.models.common import intercept_convs

    paths = quantize._conv_paths(net)

    def record(mod, x, plain):
        if id(mod) in paths and quantize._conv_eligible(mod, x, 16):
            key = (tuple(x.shape), tuple(mod.weight.shape), tuple(mod.stride),
                   tuple(mod.padding), mod.groups)
            shapes.setdefault(key, set()).add(paths[id(mod)])
        return plain(x)

    with torch.inference_mode(), intercept_convs(record):
        net(z)


def int_mm_conv(xq: torch.Tensor, wq: torch.Tensor, stride, padding,
                groups: int) -> torch.Tensor | None:
    """The library's int8 convolution: the int8 activations unfolded into
    k copies (``Tensor.unfold`` views, one copy) and ``torch._int_mm``.
    ``None`` where it does not apply (groups, ``_int_mm``'s multiples of 8)
    or the unfolded matrix passes ``LIBRARY_MAX_BYTES``."""
    import torch.nn.functional as F

    rank = xq.dim() - 2
    k = wq[0].numel()
    out = [(s + 2 * p - kk) // st + 1 for s, p, kk, st in
           zip(xq.shape[2:], padding, wq.shape[2:], stride)]
    rows = xq.shape[0] * int(np.prod(out))
    if groups != 1 or k % 8 or wq.shape[0] % 8 or rows * k > LIBRARY_MAX_BYTES:
        return None
    pads = [p for pad in reversed(padding) for p in (pad, pad)]
    cols = F.pad(xq, pads)
    for d in range(rank):
        cols = cols.unfold(2 + d, wq.shape[2 + d], stride[d])
    # (N, C, *out, *kernel) -> (N, *out, C, *kernel) -> rows x k
    perm = [0, *range(2, 2 + rank), 1, *range(2 + rank, 2 + 2 * rank)]
    cols = cols.permute(perm).reshape(rows, k)
    return torch._int_mm(cols, wq.reshape(wq.shape[0], k).t())


def w8a8_shape(key, dev, gen, where: set) -> dict:
    """One eligible conv shape: the kernel against the twin on its first
    items (int32 accumulators bit-equal, outputs at the CPU tests' bars;
    float32 and bf16, dynamic and static scale), then at the full shape the
    kernel's median time against its bound, cuDNN's bf16 conv, and unfold +
    ``torch._int_mm`` (whose accumulators must equal the kernel's)."""
    import torch.nn.functional as F

    from vsr_tpu_torch.ops import w8a8_conv as wc

    xshape, wshape, stride, padding, groups = key
    x = torch.randn(xshape, device=dev, generator=gen)
    w = 0.05 * torch.randn(wshape, device=dev, generator=gen)
    b = torch.randn(wshape[0], device=dev, generator=gen)
    res = {"x": list(xshape), "weight": list(wshape), "stride": list(stride),
           "padding": list(padding), "groups": groups,
           "convs": sorted(where), "max_abs_err": 0.0,
           "plan": wc.kernel_plan(xshape, wshape, stride, padding, groups),
           "per_tap_ms": PER_TAP_W8A8_MS.get(
               (xshape, wshape, stride, padding))}
    cut = x[:W8A8_CHECK_ITEMS]
    static = 1.25 * float(wc.dynamic_scale(cut))
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xc = cut.to(dtype)
            for scale in (None, static):
                args = (xc, w, b, scale, stride, padding, groups)
                acc = wc.w8a8_conv(*args, out_dtype=torch.int32)
                want_acc = wc.w8a8_conv_reference(*args, out_dtype=torch.int32)
                out = wc.w8a8_conv(*args, out_dtype=dtype)
                want = wc.w8a8_conv_reference(*args, out_dtype=dtype).float()
                err = (out.float() - want).abs()
                if dtype == torch.float32:
                    ok = err.max().item() <= W8A8_F32_SHARE * want.abs().max().item()
                else:
                    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                        out.float().abs(), want.abs()) + 1e-30)) - 7)
                    ok = bool((err <= ulp).all())
                if not (torch.equal(acc, want_acc) and ok):
                    raise SystemExit(
                        f"w8a8_conv disagrees with its twin at x {xshape}, "
                        f"weight {wshape} ({dtype}, scale {scale}): "
                        f"accumulators equal {torch.equal(acc, want_acc)}, "
                        f"max error {err.max().item():.3g}")
                res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
        xs = float(wc.dynamic_scale(x))
        full = (x, w, b, xs, stride, padding, groups)
        res["ms"] = median_ms(lambda: wc.w8a8_conv(*full), reps=SHAPE_REPS)
        xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        res["bf16_ms"] = median_ms(
            lambda: wc.w8a8_conv(xb, w, b, xs, stride, padding, groups,
                                 torch.bfloat16), reps=SHAPE_REPS)
        conv = F.conv2d if len(wshape) == 4 else F.conv3d
        res["cudnn_bf16_ms"] = median_ms(
            lambda: conv(xb, wb, bb, stride, padding, 1, groups),
            reps=SHAPE_REPS)
        xq = wc.quantize_activations(x, torch.tensor(xs, device=dev)).to(
            torch.int8)
        wq, _ = wc.quantize_weight(w)
        lib = int_mm_conv(xq, wq, stride, padding, groups)
        res["library_ms"] = None
        if lib is not None:
            acc = wc.w8a8_conv(*full, out_dtype=torch.int32)
            rank = len(stride)
            lib = lib.reshape(acc.shape[0], *acc.shape[2:], -1).permute(
                0, rank + 1, *range(1, rank + 1))
            if not torch.equal(lib, acc):
                raise SystemExit(f"unfold + _int_mm and the kernel's "
                                 f"accumulators differ at x {xshape}")
            res["library_ms"] = median_ms(
                lambda: int_mm_conv(xq, wq, stride, padding, groups),
                reps=SHAPE_REPS)
        out_shape = wc._out_shape(x, w, stride, padding)
    res["out"] = list(out_shape)
    for name, size in (("", 4), ("bf16_", 2)):
        n_bytes, ops = w8a8_bytes_and_ops(xshape, wshape, out_shape, size,
                                          size)
        res[f"{name}bound_ms"], res[f"{name}bound_by"] = bound(
            n_bytes, ops, PEAK_INT8)
    res["bytes"], res["ops"] = w8a8_bytes_and_ops(xshape, wshape, out_shape,
                                                  4, 4)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["bf16_bound_share"] = res["bf16_bound_ms"] / res["bf16_ms"]
    return res


def plan_text(plan: dict) -> str:
    """``kernel_plan``'s choice in a few words: the kernel, its N tile,
    output tile and weights' residence."""
    if plan["kernel"] != "patch":
        return plan["kernel"]
    return (f"patch N{plan['bn']} tile {'x'.join(map(str, plan['tile']))} "
            f"{plan['stages']} stages, weights "
            + ("resident" if plan["resident"] else "streamed"))


# The serving runs of 13b: (path key, net, its config's kwargs, the
# make_pipeline mode, the trained checkpoint of phases 7 / 9 if present).
QUANT_NETS = {
    "edsr": ("EDSRNet", EDSR_KWARGS, {}, "sisr/checkpoints/model_best.ckpt"),
    "drf": ("DRFNet", dict(DRF_KWARGS, fused_squeeze=True, fused_tail=True),
            dict(video_t=T_FRAMES),
            f"vsr_fused/checkpoints/model_{TRAIN_EPOCHS}.ckpt"),
    "duf": ("DUFNet", dict(DUF_KWARGS, use_pallas_filter=True),
            dict(window=(DUF_KWARGS["num_frames"], T_FRAMES, "middle"),
                 chunk=DUF_CHUNK), "duf/checkpoints/model_1.ckpt"),
}


def quality_volume() -> np.ndarray:
    """(D*T, H, W) HR frames of FULL_SLICES slices: phase 7's low-passed
    train and validation sequences (the same seed and draws) in turn."""
    rng = np.random.default_rng(11)
    seqs = [smooth_sequence(rng) for _ in range(6)]
    vol = np.concatenate([seqs[i % len(seqs)] for i in range(FULL_SLICES)],
                         axis=2).astype(np.float32)
    return as_frames(vol)


def psnr(sr: np.ndarray, hr: np.ndarray) -> float:
    """The infer CLI's ``--psnr``: the mean over frames, max 255."""
    mse = np.mean(np.square(sr.astype(np.float64) - hr.astype(np.float64)),
                  axis=(1, 2))
    return float(np.mean(10.0 * np.log10(255.0 ** 2 / (mse + 1e-10))))


def quant_launches() -> dict:
    counters = kernel_counters()
    return {k: fn.launches for k, fn in counters.items()}


def quant_run(what: str, key: str, form: str, frames: np.ndarray, dev,
              ckpt: str, bf16: bool = False, scales: dict | None = None,
              base: dict | None = None) -> dict:
    """One quantized serving run: the pipeline ``infer`` builds for the
    form (``"plain"``, ``"int8"``, ``"w8a8"`` lazy, ``"scales"``), a
    warm-up volume (the lazy form calibrates there), then two volumes: the
    launches per volume, the median wall ms of a volume (H2D and D2H
    included), the SR's PSNR against the HR input, weight bytes."""
    from vsr_tpu_torch import quantize
    from vsr_tpu_torch.infer import build_serving_net, make_pipeline

    name, kwargs, mode, _ = QUANT_NETS[key]
    kwargs = dict(kwargs, dtype="bfloat16") if bf16 else kwargs
    net = build_serving_net(name, kwargs, ckpt, device=dev)
    f32_bytes = quantize.quantized_nbytes(net, {})
    weight_bytes = f32_bytes
    kw = {}
    if form == "int8":
        q8, s8 = quantize.quantize_params(net)
        weight_bytes = quantize.quantized_nbytes(net, q8)
        net = quantize.make_quantized_apply(net, q8, s8)
        kw = dict(int8=True)
    elif form == "w8a8":
        kw = dict(w8a8=True)
    elif form == "scales":
        kw = dict(w8a8=scales)
    pipe = make_pipeline(net, FACTOR, "acdc", **mode, **kw)
    pipe(torch.from_numpy(frames).to(dev))  # warm-up; a lazy pipeline calibrates
    reset_launches()
    times = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sr = pipe(torch.from_numpy(frames).to(dev))[1].cpu().numpy()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v // 2 for k, v in quant_launches().items()}
    check_sr(what, sr, frames.shape)
    ms = statistics.median(times)
    res = {"launches": launches, "volume_ms": ms,
           "frames_per_s": len(frames) / ms * 1e3,
           "psnr": psnr(sr, frames), "weight_bytes": weight_bytes,
           "f32_weight_bytes": f32_bytes, "sr": sr, "pipe": pipe}
    if form == "w8a8":  # the scales the lazy calibration kept
        res["scales"] = pipe.act_scales
    if base is not None:
        res["psnr_delta"] = base["psnr"] - res["psnr"]
        res["speed_vs_plain"] = res["frames_per_s"] / base["frames_per_s"]
        exact, worst = agreement(sr, base["sr"])
        res["vs_plain"] = {"exact_fraction": exact, "max_grey_diff": worst}
    log(f"  {what}: {res['frames_per_s']:.1f} frames/s ({ms:.1f} ms a "
        f"volume" + (f", {res['speed_vs_plain']:.3f}x the unquantized run"
                     if base else "") + f"), PSNR {res['psnr']:.3f} dB"
        + (f" (delta {res['psnr_delta']:+.4f})" if base else "")
        + f", weights {weight_bytes / 1e6:.2f} MB of {f32_bytes / 1e6:.2f} "
        f"MB float32, launches {launches}")
    return res


def pipe_input(key: str, frames: np.ndarray, dev) -> torch.Tensor:
    from vsr_tpu_torch.infer import make_prep

    mode = QUANT_NETS[key][2]
    prep = make_prep(FACTOR, "acdc", mode.get("video_t", 0),
                     mode.get("window"))
    with torch.inference_mode():
        return prep(torch.from_numpy(frames).to(dev))[1]


def expected_w8a8_launches(key: str, scales: dict) -> int:
    """Eligible (calibrated) convs x their calls in one volume: DRF's step
    convs once per frame, DUF's once per chunk of windows."""
    if key == "drf":
        return sum(T_FRAMES if p.startswith("step/") else 1 for p in scales)
    if key == "duf":
        return len(scales) * -(-FULL_SLICES * T_FRAMES // DUF_CHUNK)
    return len(scales)


def gate_quant(what: str, res: dict, want: dict, bar: float | None) -> None:
    got = {k: v for k, v in res["launches"].items() if v}
    want = {k: v for k, v in want.items() if v}
    if got != want:
        raise SystemExit(f"{what}: kernel launches {got}, expected {want}")
    if bar is not None and not abs(res["psnr_delta"]) < bar:
        raise SystemExit(f"{what}: PSNR delta {res['psnr_delta']:.4f} dB "
                         f"against the unquantized run (bar {bar} dB)")


def quant_pipelines(tmp: Path, frames: np.ndarray, card: str, dev) -> dict:
    """13b: each net's unquantized run, then its quantized forms."""
    res = {}
    for key in QUANT_NETS:
        ckpt = tmp / QUANT_NETS[key][3]
        ckpt = str(ckpt) if ckpt.is_file() else ""
        runs = res[key] = {"checkpoint": ckpt or "seeded init"}
        k2 = -(-FULL_SLICES * T_FRAMES // DUF_CHUNK) if key == "duf" else 0
        k1 = SQUEEZES_PER_STEP * T_FRAMES if key == "drf" else 0
        base_launches = {"concat_conv1x1": k1, "duf_dynamic_filter": k2}
        dtypes = (False, True) if key == "edsr" else (False,)
        for bf16 in dtypes:
            tag = f"{key} {'bf16' if bf16 else 'f32'}"
            base = runs[f"{'bf16' if bf16 else 'f32'}_plain"] = quant_run(
                f"{tag} unquantized", key, "plain", frames, dev, ckpt, bf16)
            gate_quant(f"{tag} unquantized", base, base_launches, None)
            forms = {}
            if key != "duf":
                forms["int8"] = quant_run(f"{tag} --int8", key, "int8", frames,
                                          dev, ckpt, bf16, base=base)
                gate_quant(f"{tag} --int8", forms["int8"], base_launches,
                           INT8_PSNR_BAR)
            if key == "drf":  # the scan body's convs need callback scales
                from vsr_tpu_torch import quantize
                from vsr_tpu_torch.infer import build_serving_net

                net = build_serving_net(QUANT_NETS[key][0],
                                        QUANT_NETS[key][1], ckpt, device=dev)
                scales = quantize.calibrate_w8a8(
                    net, [pipe_input(key, frames, dev)], method="callback")
                forms["scales"] = quant_run(
                    f"{tag} --w8a8-scales (callback calibration)", key,
                    "scales", frames, dev, ckpt, bf16, scales, base)
            else:
                lazy = forms["w8a8"] = quant_run(
                    f"{tag} --w8a8", key, "w8a8", frames, dev, ckpt, bf16,
                    base=base)
                scales = lazy.pop("scales")
                gate_quant(f"{tag} --w8a8", lazy, dict(
                    base_launches,
                    w8a8_conv=expected_w8a8_launches(key, scales)),
                    W8A8_PSNR_BAR)
                if key == "edsr":
                    forms["scales"] = quant_run(
                        f"{tag} --w8a8-scales", key, "scales", frames, dev,
                        ckpt, bf16, scales, base)
            if "scales" in forms:
                gate_quant(f"{tag} --w8a8-scales", forms["scales"], dict(
                    base_launches,
                    w8a8_conv=expected_w8a8_launches(key, scales)),
                    W8A8_PSNR_BAR)
            for form, run in forms.items():
                runs[f"{'bf16' if bf16 else 'f32'}_{form}"] = run
            if not bf16:  # the float32 net's scales, which 13c exports
                runs["scales"] = scales
    return res


def quant_deployment(tmp: Path, frames: np.ndarray, edsr: dict, card: str,
                     dev) -> dict:
    """13c: W8A8 (``--w8a8-scales``) and int8 artifacts of the EDSR net
    exported at the full frames shape on the card, loaded and run against
    the live pipelines; the daemon's live backend with ``--w8a8-scales``
    answering 2 requests."""
    import threading

    from vsr_tpu_torch import export, serve
    from vsr_tpu_torch.infer import build_serving_net

    ckpt = edsr["checkpoint"] if edsr["checkpoint"] != "seeded init" else ""
    kwargs, scales = QUANT_NETS["edsr"][1], edsr["scales"]
    res = {}
    for form, kw, live in (("w8a8", dict(w8a8=scales), edsr["f32_scales"]),
                           ("int8", dict(int8=True), edsr["f32_int8"])):
        net = build_serving_net("EDSRNet", kwargs, ckpt, device=dev)
        t0 = time.perf_counter()
        program, meta = export.export_serving(net, frames.shape, FACTOR, **kw)
        ops = sum(1 for n in program.graph.nodes
                  if str(n.target) == "vsr_tpu_torch.w8a8_conv.default")
        file = tmp / f"edsr_{form}.pt2.zip"
        export.save_artifact(file, program, {**meta, "net": "EDSRNet"})
        served = export.ExportedServing(file, device=dev)
        setup_s = time.perf_counter() - t0
        reset_launches()
        got = served(frames)[1].cpu().numpy()
        launches = quant_launches()
        want = len(scales) if form == "w8a8" else 0
        if launches["w8a8_conv"] != want or ops != want:
            raise SystemExit(f"{form} artifact: {launches['w8a8_conv']} "
                             f"w8a8_conv launches and {ops} op nodes, "
                             f"expected {want}")
        res[form] = dict(gate_agreement(f"{form} artifact vs its live "
                                        "pipeline", got, live["sr"]),
                         launches=launches["w8a8_conv"], op_nodes=ops,
                         export_save_load_s=setup_s,
                         file_mb=file.stat().st_size / 1e6,
                         artifact_ms=timed_volume(served, frames, dev))
        log(f"  EDSR {form} artifact ({res[form]['file_mb']:.1f} MB, {ops} "
            f"w8a8_conv nodes; export + save + load {setup_s:.1f} s): "
            f"{res[form]['exact_fraction'] * 100:.4f}% exact vs the live "
            f"pipeline, {res[form]['artifact_ms']:.1f} ms a volume [{card}]")
    file = tmp / "edsr_scales.json"
    file.write_text(json.dumps(scales))
    args = serve.parse_args([
        "--net", "EDSRNet", "--net-kwargs", json.dumps(kwargs),
        "--frames-shape", ",".join(map(str, frames.shape)),
        "--w8a8-scales", str(file), "--device", str(dev)]
        + (["--checkpoint", ckpt] if ckpt else []))
    reset_launches()
    (live,) = serve.live_from_args(args)
    srv = serve.make_server([], port=0, warmup=True, live=[live], device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        lat = []
        for _ in range(2):
            body, sec, _ = post(
                f"http://127.0.0.1:{srv.server_address[1]}/v1/sr",
                npy_bytes(frames), "application/x-npy")
            lat.append(sec * 1e3)
            gate_agreement("the daemon's W8A8 live backend vs the live "
                           "pipeline", from_npy(body), edsr["f32_scales"]["sr"])
    finally:
        srv.shutdown()
        srv.server_close()
    launches = quant_launches()["w8a8_conv"]
    if launches != 3 * len(scales):  # warm-up + 2 requests
        raise SystemExit(f"W8A8 daemon: {launches} launches, expected "
                         f"{3 * len(scales)}")
    res["daemon"] = {"launches": launches, "request_ms": lat}
    log(f"  the daemon's live backend with --w8a8-scales: 2 requests, "
        f"{lat[0]:.1f} / {lat[1]:.1f} ms, {launches} w8a8_conv launches "
        f"(warm-up + requests) [{card}]")
    return res


def phase_quantized(tmp: Path, card: str, dev) -> dict:
    """Phase 13: int8 and W8A8 serving. 13a the W8A8 kernel against its
    twin at every eligible conv shape of EDSRNet, DRFNet and DUFNet at
    full width; 13b the pipelines (f32 and EDSR bf16) on a 192 x 192 x 10 x
    30 volume of phase 7's low-passed sequences, with the trained
    checkpoints of phases 7 and 9; 13c artifacts and the daemon."""
    from vsr_tpu_torch.infer import build_serving_net

    frames = quality_volume()
    res = {"shapes": []}
    log("phase 13a: the W8A8 kernel against its twin at every eligible conv "
        "shape")
    shapes: dict = {}
    for key, (name, kwargs, _, _) in QUANT_NETS.items():
        net = build_serving_net(name, kwargs, device=dev)
        z = pipe_input(key, frames, dev)
        chunk = QUANT_NETS[key][2].get("chunk")
        eligible_conv_shapes(net, z[:chunk] if chunk else z, shapes)
        del net, z
    gen = torch.Generator(device=dev).manual_seed(13)
    for key, where in shapes.items():
        row = w8a8_shape(key, dev, gen, where)
        res["shapes"].append(row)
        torch.cuda.empty_cache()
        per_tap = row["per_tap_ms"]
        log(f"  x {row['x']} weight {row['weight']} s{row['stride']} "
            f"p{row['padding']} ({len(where)} convs), {plan_text(row['plan'])}"
            f": err {row['max_abs_err']:.3g}; kernel {row['ms']:.3f} ms (bf16 "
            f"{row['bf16_ms']:.3f}), bound {row['bound_ms']:.3f} by "
            f"{row['bound_by']} (bf16 {row['bf16_bound_ms']:.3f}), share "
            f"{row['bound_share']:.3f} (bf16 {row['bf16_bound_share']:.3f}); "
            + (f"the per-tap kernel {per_tap[0]:.3f} "
               f"(bf16 {per_tap[1]:.3f}); "
               if per_tap else "the per-tap kernel not timed; ")
            + f"cuDNN bf16 {row['cudnn_bf16_ms']:.3f}; unfold"
            f" + _int_mm " + (f"{row['library_ms']:.3f}"
                              if row["library_ms"] is not None
                              else "not timed") + f" [{card}]")
    timed = [r for r in res["shapes"] if r["per_tap_ms"]]
    faster = sum(r["ms"] < r["per_tap_ms"][0]
                 and r["bf16_ms"] < r["per_tap_ms"][1] for r in timed)
    res["faster_than_per_tap"] = [faster, len(timed)]
    log(f"  faster than the per-tap kernel (f32 and bf16) at {faster} of "
        f"{len(timed)} shapes it timed; kernels taken: " + ", ".join(
            f"{k} {n}" for k, n in sorted(collections.Counter(
                r["plan"]["kernel"] for r in res["shapes"]).items()))
        + f" [{card}]")
    main = max(res["shapes"], key=lambda r: (len(r["convs"]), r["ops"]))
    with torch.inference_mode():
        from vsr_tpu_torch.ops import w8a8_conv as wc

        x = torch.randn(main["x"], device=dev, generator=gen)
        w = 0.05 * torch.randn(main["weight"], device=dev, generator=gen)
        b = torch.randn(main["weight"][0], device=dev, generator=gen)
        xs = float(wc.dynamic_scale(x))
        main["plain_ms"] = median_ms(lambda: wc.w8a8_conv_reference(
            x, w, b, xs, main["stride"], main["padding"], main["groups"]),
            reps=SHAPE_REPS)
        del x, w, b
    res["main"] = main
    log(f"  the most used shape, x {main['x']} weight {main['weight']}: "
        f"kernel {main['ms']:.3f} ms, twin {main['plain_ms']:.3f} ms [{card}]")
    log("phase 13b: quantized pipelines at the configs' widths")
    res["pipelines"] = quant_pipelines(tmp, frames, card, dev)
    log("phase 13c: quantized artifacts and the daemon's live backend")
    res["deployment"] = quant_deployment(tmp, frames, res["pipelines"]["edsr"],
                                         card, dev)
    for runs in res["pipelines"].values():
        for run in runs.values():
            if isinstance(run, dict):
                run.pop("sr", None)
                run.pop("pipe", None)
    return res


# ====================================================== the training knobs

# The knobs of configs/train/example_config.yaml:81-94 on phase 7's tree.
KNOBS = dict(grad_accumulation=2, grad_clip=1.0, ema_decay=0.999)
KNOB_MICRO_STEPS = 8     # epoch 1 of the DRF config: 120 windows, batch 16
KNOB_UPDATES = KNOB_MICRO_STEPS // KNOBS["grad_accumulation"]
KNOB_RESUME_AFTER = 3    # a preemption in the middle of an accumulation
KNOB_CPU_SAMPLES = 4     # card vs CPU: batches of 4, the first 8 of epoch 1
KNOB_SHARE = 1e-3        # of each tensor's largest entry: a path of K1
EMA_SLICES = 2           # slices of the volume infer --ema --gif serves
QAT_W8A8_TOL = 2e-3      # tests/test_qat.py: fake quant vs W8A8, normalized
QAT_FRAMES = T_FRAMES    # LR frames of the forward-agreement check
QAT_TEST_KWARGS = dict(in_channels=1, out_channels=1, num_resblocks=2,
                       num_features=16, upscale_factor=FACTOR)
EDSR_W8A8_CONVS = 34     # EDSRNet 16 x 64's calibrated convs: a volume's launches


def knob_config(name: str, tmp: Path, saved: str, net_kwargs: dict,
                **trainer_kwargs):
    """``training_config`` for one epoch with ``trainer_kwargs`` (the
    knobs) added to the config's trainer kwargs; a checkpoint each epoch."""
    cfg = training_config(name, tmp / "tree", tmp / saved, net_kwargs, tmp)
    cfg.trainer.kwargs.update(num_epochs=1, **trainer_kwargs)
    cfg.monitor.kwargs.saved_freq = 1
    return cfg


class UpdateProbe:
    """Snapshots the parameters a gradient chain holds before its first step
    and after every update it applies."""

    def __enter__(self):
        from vsr_tpu_torch.optim import GradientChain

        self._cls, self._saved = GradientChain, GradientChain.step
        self.initial, self.snapshots = None, []
        saved, probe = self._saved, self

        def step(chain, **kwargs):
            if probe.initial is None:
                probe.initial = [p.detach().clone() for p in chain.params]
            saved(chain, **kwargs)
            if chain.mini_step == 0:
                probe.snapshots.append([p.detach().clone()
                                        for p in chain.params])

        GradientChain.step = step
        return self

    def __exit__(self, *exc):
        self._cls.step = self._saved


def share_diff(got: dict, want: dict) -> tuple[float, str]:
    """The largest ``|got - want|`` over ``want``'s tensors, each over its own
    largest entry, and the tensor it is at."""
    share = {k: ((got[k].float().cpu() - v.float().cpu()).abs().max()
                 / v.float().abs().max().clamp_min(1e-12)).item()
             for k, v in want.items()}
    worst = max(share, key=share.get)
    return share[worst], worst


def gif_frames(path: Path) -> list[np.ndarray]:
    """Decode a GIF89a (a global palette, full-size LZW frames: what
    ``utils/gif.py`` writes) to its frames' palette values, as uint8."""
    data = path.read_bytes()
    if data[:6] != b"GIF89a":
        raise SystemExit(f"{path.name}: not a GIF89a")
    w, h, packed = int.from_bytes(data[6:8], "little"), int.from_bytes(
        data[8:10], "little"), data[10]
    pos = 13
    palette = np.arange(256, dtype=np.uint8)
    if packed & 0x80:
        size = 3 * (2 << (packed & 7))
        palette = np.frombuffer(data[pos:pos + size], np.uint8)[::3].copy()
        pos += size
    frames = []
    while pos < len(data) and data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:  # an extension: label, then sub-blocks
            pos += 2
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
            continue
        if kind != 0x2C or data[pos + 9] & 0x80:
            raise SystemExit(f"{path.name}: unexpected block {kind:#x}")
        fw, fh = (int.from_bytes(data[pos + 5:pos + 7], "little"),
                  int.from_bytes(data[pos + 7:pos + 9], "little"))
        min_size, pos = data[pos + 10], pos + 11
        chunks = []
        while data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += data[pos] + 1
        pos += 1
        idx = np.frombuffer(lzw_decode(b"".join(chunks), min_size), np.uint8)
        if (fw, fh) != (w, h) or idx.size != w * h:
            raise SystemExit(f"{path.name}: a frame of {idx.size} pixels")
        frames.append(palette[idx].reshape(h, w))
    return frames


def lzw_decode(data: bytes, min_size: int) -> bytes:
    """GIF's variable-width LZW, codes least significant bit first."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, acc, bits, prev, out = min_size + 1, 0, 0, None, bytearray()
    for byte in data:
        acc |= byte << bits
        bits += 8
        while bits >= size:
            code, acc, bits = acc & ((1 << size) - 1), acc >> size, bits - size
            if code == clear:
                del table[end + 1:]
                size, prev = min_size + 1, None
                continue
            if code == end:
                return bytes(out)
            if code < len(table):
                entry = table[code]
                if prev is not None:
                    table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) == 1 << size and size < 12:
                size += 1
    return bytes(out)


def knob_volume(tmp: Path, slices: int) -> Path:
    """The first ``slices`` slices of phase 13's 192 x 192 x 10 x 30 volume
    of phase 7's low-passed sequences, as an uncompressed NIfTI file (H, W,
    D, T) in a directory of its own (gzip-9 would take ~40 s)."""
    from vsr_tpu_torch.io.nifti import save_nifti

    rng = np.random.default_rng(11)
    seqs = [smooth_sequence(rng) for _ in range(6)]
    vol = np.concatenate([seqs[i % len(seqs)] for i in range(slices)],
                         axis=2).astype(np.float32)
    path = (tmp / f"knobs_in_{slices}" / "patient001"
            / "patient001_4d.nii")
    save_nifti(vol, path)
    return path


def knobs_host_loop(tmp: Path, card: str, dev) -> dict:
    """14a: the DRF config at full width with every knob, K1 on: one epoch
    (8 micro-steps, 4 updates) through ``run_train``; the EMA against the
    recursion over the updates' parameters; a run preempted after 3
    micro-steps and resumed against the straight one; 8 batches of 4 on
    the card against the CPU."""
    from vsr_tpu_torch.main import run_train

    net_kwargs = {"fused_squeeze": True}
    res = {}
    cfg = knob_config("acdc_vsr_drf_x2", tmp, "knobs_drf", net_kwargs, **KNOBS)
    with UpdateProbe() as probe:
        run = train_run("knobs drf", cfg, card, TRAIN_T, True)
    trainer, s = run["trainer"], run["stats"]
    chain = trainer.chain
    if (s["steps"], len(probe.snapshots), chain.mini_step) != (
            KNOB_MICRO_STEPS, KNOB_UPDATES, 0):
        raise SystemExit(f"knobs drf: {s['steps']} micro-steps, "
                         f"{len(probe.snapshots)} updates, micro-step "
                         f"{chain.mini_step} left")
    per_step = s["backward_launches"] // s["steps"]
    if per_step != SQUEEZES_PER_STEP * TRAIN_T:
        raise SystemExit(f"knobs drf: {per_step} K1 launches a micro-step")
    ema = [e.clone() for e in probe.initial]
    d = chain.decay
    for snap in probe.snapshots:
        ema = [e * d + p * (1.0 - d) for e, p in zip(ema, snap)]
    recursion_diff = max((a - b).abs().max().item()
                         for a, b in zip(ema, chain.ema))
    moved = max((a - b).abs().max().item()
                for a, b in zip(probe.snapshots[-1], probe.initial))
    log(f"  knobs drf: {s['steps']} micro-steps, {KNOB_UPDATES} updates, K1 "
        f"{per_step} forward, dx and dW/db launches a micro-step; EMA against "
        f"the recursion over the updates' parameters: max diff "
        f"{recursion_diff:g}; parameters moved by up to {moved:.3g}; median "
        f"micro-step {s['median_step_ms']:.2f} ms [{card}]")
    if recursion_diff != 0 or not moved > 0:
        raise SystemExit("knobs drf: the EMA is not the recursion over the "
                         "applied updates, or nothing moved")
    res["straight"] = dict(s, k1_launches_per_micro_step=per_step,
                           ema_recursion_max_diff=recursion_diff)

    # Preempted after 3 micro-steps (one gradient accumulated), resumed.
    cfg = knob_config("acdc_vsr_drf_x2", tmp, "knobs_drf_resumed", net_kwargs,
                      **KNOBS)
    cfg.main.auto_resume = True
    cut = train_run("knobs drf preempted", cfg, card, TRAIN_T, True,
                    sigterm_after=KNOB_RESUME_AFTER)
    preempt = tmp / "knobs_drf_resumed" / "checkpoints" / "model_preempt.ckpt"
    from vsr_tpu_torch.utils.checkpoint import load_checkpoint

    state, _ = load_checkpoint(preempt)
    if state["chain"]["mini_step"] != KNOB_RESUME_AFTER % 2:
        raise SystemExit("knobs drf: the preemption checkpoint holds no "
                         "accumulation in progress")
    resumed = train_run("knobs drf resumed", cfg, card, TRAIN_T, True)
    steps = cut["stats"]["steps"] + resumed["stats"]["steps"]
    p_share, p_at = share_diff(resumed["params"], run["params"])
    e_share, e_at = share_diff(resumed["trainer"].chain.ema_state(),
                               chain.ema_state())
    log(f"  preempted after {KNOB_RESUME_AFTER} micro-steps (micro-step "
        f"{state['chain']['mini_step']} of 2 saved), resumed for "
        f"{resumed['stats']['steps']}: against the straight run, parameters "
        f"within {p_share:.3g} ({p_at}) and EMA within {e_share:.3g} ({e_at})"
        f" of each tensor's largest entry (bar {KNOB_SHARE:g}; cuDNN's "
        f"dgrad is not deterministic)")
    if steps != KNOB_MICRO_STEPS or max(p_share, e_share) > KNOB_SHARE:
        raise SystemExit("knobs drf: the resumed run is not the straight one")
    res["resume"] = {"steps_before": cut["stats"]["steps"],
                     "steps_after": resumed["stats"]["steps"],
                     "params_share": p_share, "ema_share": e_share}
    del cut, resumed

    # Card vs CPU: batches of 4 from one build, the first 8 of epoch 1.
    t0 = time.perf_counter()
    trainers = {}
    for where in ("cuda", "cpu"):
        cfg = knob_config("acdc_vsr_drf_x2", tmp, f"knobs_drf_{where}",
                          net_kwargs, **KNOBS)
        cfg.dataloader.kwargs.train_batch_size = KNOB_CPU_SAMPLES
        cfg.trainer.kwargs.num_epochs = 0  # built, not trained
        trainers[where] = run_train(cfg, device=where)
    card_t, cpu_t = trainers["cuda"], trainers["cpu"]
    init_share, _ = share_diff(dict(card_t.net.named_parameters()),
                               dict(cpu_t.net.named_parameters()))
    batches = [b for _, b in zip(range(KNOB_MICRO_STEPS),
                                 card_t.train_dataloader.epoch(
                                     card_t.rng_tree, 1))]
    first = {}
    for where, tr in trainers.items():
        reset_launches()
        for batch in batches:
            scalars, _ = tr._train_step(*tr._get_inputs_targets(batch))
            first.setdefault(where, scalars[0].item())
        launched = kernel_counters()["concat_conv1x1"].launches
        if (launched > 0) != (where == "cuda"):
            raise SystemExit(f"knobs drf on {where}: K1 launched {launched}")
    loss_rel = abs(first["cuda"] - first["cpu"]) / abs(first["cpu"])
    p_share, p_at = share_diff(dict(card_t.net.named_parameters()),
                               dict(cpu_t.net.named_parameters()))
    e_share, e_at = share_diff(card_t.chain.ema_state(),
                               cpu_t.chain.ema_state())
    log(f"  card vs CPU, {KNOB_MICRO_STEPS} micro-steps of "
        f"{KNOB_CPU_SAMPLES} samples ({KNOB_UPDATES} updates): first loss "
        f"{first['cuda']:.6f} vs {first['cpu']:.6f} (relative {loss_rel:.2g});"
        f" parameters within {p_share:.3g} ({p_at}), EMA within {e_share:.3g}"
        f" ({e_at}) of each tensor's largest entry (bar {KNOB_SHARE:g}), in "
        f"{time.perf_counter() - t0:.1f} s")
    if init_share != 0 or loss_rel > 1e-4 or max(p_share, e_share) > KNOB_SHARE:
        raise SystemExit("knobs drf: the card and the CPU disagree")
    res["card_vs_cpu"] = {"first_loss_relative_diff": loss_rel,
                          "params_share": p_share, "ema_share": e_share}
    res["checkpoint"] = str(tmp / "knobs_drf" / "checkpoints"
                            / "model_1.ckpt")
    return res


def knobs_infer_ema(tmp: Path, ckpt: str, vol_path: Path, card: str,
                    dev) -> dict:
    """14b: ``infer --ema --gif`` on 14a's checkpoint: K1's launches, the
    GIFs decoded against the SR volume's truncated frames, and the output
    against a net given the checkpoint's EMA by hand."""
    from vsr_tpu_torch import infer
    from vsr_tpu_torch.io.nifti import load_nifti
    from vsr_tpu_torch.registry import build

    net_kwargs = dict(DRF_KWARGS, fused_squeeze=True)
    out = tmp / "knobs_ema_out"
    reset_launches()
    t0 = time.perf_counter()
    stats = infer.main([str(vol_path.parent.parent), str(out), "--video",
                        "--net", "DRFNet", "--net-kwargs",
                        json.dumps(net_kwargs), "--checkpoint", ckpt,
                        "--ema", "--gif"])
    seconds = time.perf_counter() - t0
    launched = check_launches("infer --ema", "concat_conv1x1",
                              SQUEEZES_PER_STEP * T_FRAMES)
    sr = load_nifti(out / "patient001" / "patient001_4d_sr.nii.gz")
    slices = sr.shape[2]
    check_sr("infer --ema", sr, (HR, HR, EMA_SLICES, T_FRAMES))
    gifs = sorted((out / "patient001").glob("*.gif"))
    names = [f"patient001_4d_slice{d + 1:02d}.gif" for d in range(slices)]
    if [g.name for g in gifs] != names:
        raise SystemExit(f"infer --gif wrote {[g.name for g in gifs]}")
    t1 = time.perf_counter()
    for d, path in enumerate(gifs):
        frames = gif_frames(path)
        want = [sr[:, :, d, t].astype(np.uint8) for t in range(T_FRAMES)]
        if len(frames) != T_FRAMES or not all(
                np.array_equal(a, b) for a, b in zip(frames, want)):
            raise SystemExit(f"{path.name} does not decode to the SR "
                             "volume's truncated frames")
    decode_s = time.perf_counter() - t1
    # The EMA by hand: the checkpoint's parameters replaced by its chain's.
    state = torch.load(ckpt, map_location=dev, weights_only=True)
    net = build("net", {"name": "DRFNet", "kwargs": net_kwargs}, device=dev)
    net.load_state_dict({**state["net"], **state["chain"]["ema"]})
    frames, _ = infer.load_hr_frames(vol_path)
    pipe = infer.make_pipeline(net.eval(), FACTOR, "acdc", video_t=T_FRAMES)
    by_hand = pipe(torch.from_numpy(frames).to(dev))[1].cpu().numpy()
    exact, worst = agreement(as_frames(sr), by_hand)
    log(f"  infer --ema --gif: {slices} x {T_FRAMES} frames of "
        f"{HR}x{HR} in {seconds:.1f} s ({stats['frames_per_sec']:.1f} frames/s"
        f" with the GIFs), K1 {launched} launches; {len(gifs)} GIFs of "
        f"{T_FRAMES} frames decode to the SR's truncated frames (decoded in "
        f"{decode_s:.1f} s); against a net given the EMA by hand: "
        f"{exact * 100:.3f}% exact, max {worst:g} grey [{card}]")
    if worst > 1:
        raise SystemExit("infer --ema does not serve the checkpoint's EMA")
    return {"launches": launched, "seconds": seconds, "gifs": len(gifs),
            "exact_fraction": exact, "max_grey_diff": worst}


def knobs_device(tmp: Path, card: str, dev) -> dict:
    """14c: the device trainers with the knobs inside the captured steps:
    the EDSR device config with every knob and QAT (two graphs) against its
    eager epoch, and its replayed step; the DRF bf16 K1 config with
    accumulation (K1 inside both graphs); SGD and Adagrad replayed."""
    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.optim import CapturableAdagrad, CapturableSGD
    from vsr_tpu_torch.runner.device_trainer import WARMUP_STEPS

    def built(what, name, net_kwargs=None, optimizer=None, steps=GRAPH_STEPS,
              **knobs):
        cfg = device_config(name, tmp / "tree", tmp / f"knobs_dev_{what}",
                            tmp, net_kwargs, steps_per_epoch=steps, **knobs)
        cfg.trainer.kwargs.num_epochs = 0  # built, not trained
        if optimizer:
            cfg.optimizer = optimizer
        trainer = run_train(cfg)
        trainer._ensure_buffers()
        return trainer

    res = {}
    losses = {}
    for graph in (True, False):
        tr = built(f"edsr_{graph}", "acdc_sisr_edsr_x2_device", qat=True,
                   **KNOBS)
        tr.engine.use_graph = graph
        tr._run_epoch("training", 1)
        losses[graph] = tr.engine.log[:, 0].clone()
        eng = tr.engine
        if graph:
            if (eng.eager_steps, eng.captures, eng.replays) != (
                    WARMUP_STEPS, 2, GRAPH_STEPS - WARMUP_STEPS):
                raise SystemExit(f"knobs device edsr: {eng.eager_steps} eager"
                                 f" steps, {eng.captures} captures, "
                                 f"{eng.replays} replays")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._run_epoch("training", 2)  # all replays
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_STEPS
            ema_ok = all(torch.isfinite(e).all() for e in tr.chain.ema)
        elif eng.graphs:
            raise SystemExit("knobs device edsr: the eager epoch captured")
    diff = ((losses[True] - losses[False]).abs()
            / losses[False].abs()).max().item()
    log(f"  device EDSR 16 x 64 bf16 with {KNOBS} and qat: 2 graphs captured "
        f"(accumulate; accumulate and apply), {GRAPH_STEPS} steps through "
        f"them against eager: per-step losses within {diff:.3g} relative "
        f"(bar {GRAPH_TOL:g}); replayed micro-step {step_ms:.2f} ms [{card}]")
    if diff > GRAPH_TOL or not ema_ok:
        raise SystemExit("knobs device edsr: graph and eager disagree, or "
                         "the EMA is not finite")
    res["edsr"] = {"graphs": 2, "graph_vs_eager": diff,
                   "replay_step_ms": step_ms}

    # DRF bf16 through K1 with accumulation: K1 inside both graphs.
    name, _, frames = DEVICE_RUNS["vsr"]
    tr = built("drf", name, K1_DEVICE,
               grad_accumulation=KNOBS["grad_accumulation"])
    eng, in_graph = tr.engine, {}
    capture = eng._capture

    def counted_capture():
        key, before = eng.graph_key(), k1_calls()
        graph = capture()
        in_graph[key] = [a - b for a, b in zip(k1_calls(), before)]
        return graph

    eng._capture = counted_capture
    reset_launches()
    tr._run_epoch("training", 1)
    want = [SQUEEZES_PER_STEP * frames] * 3
    log(f"  device DRF bf16 (K1) with grad_accumulation 2: K1 calls (forward,"
        f" dx, dW/db) captured in the accumulate graph {in_graph.get(False)}, "
        f"in the apply graph {in_graph.get(True)}; {eng.replays} replays")
    if in_graph != {False: want, True: want}:
        raise SystemExit("knobs device drf: K1 is not inside both graphs")
    res["drf"] = {"k1_calls_per_graph": in_graph[True],
                  "replays": eng.replays}

    # SGD with momentum and Adagrad through their capturable steps.
    for label, optimizer, cls in (
            ("sgd", {"name": "SGD", "kwargs": {"lr": 1e-3, "momentum": 0.9}},
             CapturableSGD),
            ("adagrad", {"name": "Adagrad", "kwargs": {"lr": 1e-3}},
             CapturableAdagrad)):
        tr = built(label, "acdc_sisr_edsr_x2_device", optimizer=optimizer,
                   steps=WARMUP_STEPS + 3)
        before = {k: v.clone() for k, v in tr.net.state_dict().items()}
        tr._run_epoch("training", 1)
        eng, log_ = tr.engine, tr.engine.log[:, 0]
        moved = max((v - before[k]).abs().max().item()
                    for k, v in tr.net.state_dict().items())
        log(f"  device EDSR with {optimizer['name']}: {type(tr.optimizer).__name__}"
            f", {eng.captures} capture, {eng.replays} replays, losses "
            f"{[round(v, 4) for v in log_.tolist()]}, parameters moved by up "
            f"to {moved:.3g}")
        if (type(tr.optimizer) is not cls or eng.replays != 3
                or not torch.isfinite(log_).all() or not moved > 0):
            raise SystemExit(f"knobs device {label}: did not train through "
                             "its captured step")
        res[label] = {"replays": eng.replays, "losses": log_.tolist()}
    return res


def knobs_qat(tmp: Path, vol_path: Path, card: str, dev) -> dict:
    """14d: EDSRNet 16 x 64 trained one epoch with ``qat: true`` through
    ``run_train``, served with ``--w8a8`` on a one-slice volume (34
    launches a volume); the
    fake-quant forward on the card against the W8A8 one, conv by conv on
    the trained net and whole on ``tests/test_qat.py``'s net, and unlike
    the unquantized forward."""
    from vsr_tpu_torch import infer, quantize
    from vsr_tpu_torch.infer import build_serving_net
    from vsr_tpu_torch.models.common import intercept_convs

    cfg = knob_config("acdc_sisr_edsr_x2", tmp, "knobs_qat", {}, qat=True)
    stats = train_run("qat edsr", cfg, card, 1, None)["stats"]
    ckpt = str(tmp / "knobs_qat" / "checkpoints" / "model_1.ckpt")
    reset_launches()
    served = infer.main([str(vol_path.parent.parent), str(tmp / "knobs_w8a8"),
                         "--net", "EDSRNet", "--net-kwargs",
                         json.dumps(EDSR_KWARGS), "--checkpoint", ckpt,
                         "--w8a8", "--psnr"])
    launched = check_launches("qat --w8a8", "w8a8_conv", EDSR_W8A8_CONVS)
    frames, _ = infer.load_hr_frames(vol_path)
    z = infer.make_prep(FACTOR, "acdc")(
        torch.from_numpy(frames[:QAT_FRAMES]).to(dev))[1]

    def forwards(net, z):
        """Static scales of ``z``; each eligible conv's fake-quant output
        against its W8A8 output on the same input (the largest
        difference); the fake-quant, W8A8 and unquantized forwards."""
        scales = quantize.calibrate_w8a8(net, [z])
        diffs = []

        def both(mod, x, scale, out_axis):
            w8a8 = quantize._w8a8_conv(mod, x, scale)
            diffs.append((quantize.fake_quant_conv(mod, x, scale, out_axis)
                          - w8a8).abs().max())
            return w8a8

        with torch.inference_mode():
            with intercept_convs(quantize._conv_interceptor(
                    net, both, scales, 16, None, False)):
                net(z)
            outs = (quantize.make_fake_quant_apply(net, scales)(z),
                    quantize.make_w8a8_apply(net, scales)(z), net(z))
        return len(scales), torch.stack(diffs).max().item(), outs

    # The trained net at full width: per conv, and the whole forward, whose
    # 34 quantized convs turn the float32 rounding of the fake-quant
    # products into int8 rounding flips of the next conv's input (the more
    # pixels, the more flips: not gated).
    n, per_conv, (fake, w8a8, plain) = forwards(build_serving_net(
        "EDSRNet", EDSR_KWARGS, ckpt, device=dev), z)
    whole = (fake - w8a8).abs().max().item()
    vs_plain = (plain - w8a8).abs().max().item()
    # tests/test_qat.py's geometry: its net (2 resblocks of 16) on 8 LR
    # patches of 8 x 8, here cut from the same frames.
    small = build_serving_net("EDSRNet", QAT_TEST_KWARGS, device=dev)
    n_small, _, (fake, w8a8, plain) = forwards(small, z[:8, :, 44:52, 44:52])
    small_diff = (fake - w8a8).abs().max().item()
    small_plain = (plain - w8a8).abs().max().item()
    log(f"  qat edsr: {stats['steps']} steps, loss {stats['first_loss']:.4f} "
        f"-> {stats['last_loss']:.4f}, median step "
        f"{stats['median_step_ms']:.2f} ms; served --w8a8: w8a8_conv "
        f"{launched} launches a volume, PSNR {served['psnr_mean']:.3f} dB, "
        f"{served['pipeline_frames_per_sec']:.1f} frames/s [{card}]")
    log(f"  fake quant vs W8A8 on {QAT_FRAMES} frames (bar {QAT_W8A8_TOL:g}):"
        f" each of the trained net's {n} convs on its W8A8 input within "
        f"{per_conv:.3g}, its whole forward {whole:.3g} (not gated), W8A8 vs"
        f" unquantized {vs_plain:.3g}; tests/test_qat.py's net ({n_small} "
        f"convs) on 8 LR patches of 8 x 8: {small_diff:.3g}, vs unquantized "
        f"{small_plain:.3g} (both must exceed 1e-4)")
    if (n != EDSR_W8A8_CONVS or max(per_conv, small_diff) > QAT_W8A8_TOL
            or not min(vs_plain, small_plain) > 1e-4):
        raise SystemExit("qat: the fake-quant forward is not the W8A8 one")
    return {"train": stats, "launches": launched,
            "psnr": served["psnr_mean"], "per_conv_fake_vs_w8a8": per_conv,
            "fake_vs_w8a8": whole, "w8a8_vs_plain": vs_plain,
            "test_net_fake_vs_w8a8": small_diff}


def phase_knobs(tmp: Path, card: str, dev) -> dict:
    """Phase 14: the training knobs on phase 7's tree (14a-14d)."""
    res, seconds = {}, {}
    # 14b serves EMA_SLICES slices, 14d one: their launches are per volume
    # (the slices go through the net together), and the CLI's gzip-9 NIfTI
    # write of ten slices and the GIF writer would take most of the step.
    vol_path = knob_volume(tmp, EMA_SLICES)
    slice_path = knob_volume(tmp, 1)
    for key, label, run in (
            ("host_loop", "14a: DRFNet F=64 G=6 with grad_accumulation 2, "
             "grad_clip 1.0, ema_decay 0.999 (K1 forward and backward)",
             lambda: knobs_host_loop(tmp, card, dev)),
            ("ema_infer", "14b: infer --ema --gif on 14a's checkpoint",
             lambda: knobs_infer_ema(tmp, res["host_loop"]["checkpoint"],
                                     vol_path, card, dev)),
            ("device", "14c: the device trainers: knobs and QAT inside the "
             "captured steps, SGD and Adagrad",
             lambda: knobs_device(tmp, card, dev)),
            ("qat", "14d: QAT, then W8A8 serving",
             lambda: knobs_qat(tmp, slice_path, card, dev))):
        log(f"phase {label}")
        t0 = time.perf_counter()
        res[key] = run()
        seconds[key] = time.perf_counter() - t0
        log(f"  phase 14{'abcd'[len(seconds) - 1]} took {seconds[key]:.1f} s "
            f"[{card}]")
    res["seconds_by_step"] = seconds
    return res


# ==================================== the feedback family and the routers

# 15a: configs/train/acdc_sisr_srfb_x2.yaml with its net swapped for
# DRFSISRNet at the same width (F=64, G=6, 4 steps; 12 squeezes a step).
DRFSISR_KWARGS = dict(SRFB_KWARGS, fused_squeeze=True)
# 15b: DRFNet's experts at acdc_vsr_drf_x2.yaml's width, with the module's
# default router (the plain rank) and dispatch (sparse).
DRF_EXPERTS = dict(num_experts=4, expert_group_size=256)
REMAT_STEPS = 2
# 15a: frames a call of the volume's frame pipeline (3 calls a volume).
FEEDBACK_CHUNK = 100
FEEDBACK_CALLS = -(-FULL_SLICES * T_FRAMES // FEEDBACK_CHUNK)
SISR_SQUEEZES = SQUEEZES_PER_STEP * SRFB_STEPS  # 48 a forward call
# 15c: MoEEDSRNet's routers and dispatches (acdc_sisr_moe_x2.yaml's net),
# each against the rank kernel with the same dispatch.
MOE_ROUTES = {
    "rank_pallas/sparse": dict(router_impl="rank_pallas"),
    "rank_pallas/dense": dict(router_impl="rank_pallas",
                              dispatch_impl="dense"),
    "rank_pallas/dense_nhwc": dict(router_impl="rank_pallas",
                                   dispatch_impl="dense_nhwc"),
    "sort/sparse": dict(router_impl="sort"),
    **{f"radix{b}/dense": dict(router_impl="radix", dispatch_impl="dense",
                               radix_bits=b) for b in (1, 4, 8)}}
DAEMON_REQUESTS = 2  # 15d: one request from each of two clients


def feedback_drfsisr(tmp: Path, tree: dict, card: str, dev) -> dict:
    """15a: DRFSISRNet trained one epoch through ``run_train`` (K1 forward,
    dx and dW / db: 48 each a train step, 48 forward a validation frame),
    one batch on the card against the CPU, ``main --test`` on the
    checkpoint, the infer CLI on the checkpoint against the trainer's own
    validation output, and a 192 x 192 x 10 x 30 volume served in frame
    mode (the last step) on the checkpoint."""
    from vsr_tpu_torch.infer import build_serving_net, make_pipeline

    cfg = training_config("acdc_sisr_srfb_x2", tmp / "tree", tmp / "drfsisr",
                          {"fused_squeeze": True}, tmp,
                          net_name="DRFSISRNet")
    cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = 1
    run = train_run("drfsisr", cfg, card, 1, True,
                    frame_steps=(SRFB_STEPS, SRFB_STEPS))
    stats = run["stats"]
    ckpt = tmp / "drfsisr" / "checkpoints" / "model_best.ckpt"
    if not stats["last_loss"] < stats["first_loss"] or not ckpt.is_file():
        raise SystemExit("drfsisr: the loss did not fall, or no "
                         "model_best.ckpt")
    per_step = stats["backward_launches"] // stats["steps"]
    if per_step != SISR_SQUEEZES:
        raise SystemExit(f"drfsisr: {per_step} K1 launches a train step")
    failed = []
    res = {"train": stats, "card_vs_cpu": card_vs_cpu(
        "drfsisr", run["trainer"], dev, kernel="concat_conv1x1")}
    gate_card_vs_cpu("drfsisr", res["card_vs_cpu"], failed)
    if failed:
        raise SystemExit(failed[0])
    res["test"] = test_run("test drfsisr", "acdc_sisr_srfb_x2", tmp / "tree",
                           tmp / "drfsisr", {"fused_squeeze": True}, tmp,
                           stats, SISR_SQUEEZES * TEST_FRAMES, card,
                           net_name="DRFSISRNet")
    res["serve"] = served_vs_validation(
        "drfsisr", tree, tmp, ckpt, "DRFSISRNet", DRFSISR_KWARGS, [],
        run["valid_outputs"], SISR_SQUEEZES, "concat_conv1x1",
        last_step=True)
    # The volume: infer's serving net and pipeline, without its NIfTI I/O.
    net = build_serving_net("DRFSISRNet", DRFSISR_KWARGS, str(ckpt),
                            device=dev)
    pipe = make_pipeline(net, FACTOR, "acdc", chunk=FEEDBACK_CHUNK)
    hr = quality_volume()
    pipe(torch.from_numpy(hr).to(dev))  # library handles
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sr = pipe(torch.from_numpy(hr).to(dev))[1].cpu().numpy()
    fps = len(hr) / (time.perf_counter() - t0)
    launches = check_launches("drfsisr volume", "concat_conv1x1",
                              SISR_SQUEEZES * FEEDBACK_CALLS)
    check_sr("drfsisr volume", sr, hr.shape)
    res["volume"] = {"frames_per_sec": fps, "launches": launches,
                     "psnr": psnr(sr, hr)}
    log(f"  drfsisr volume ({FULL_SLICES}x{T_FRAMES} frames of {HR}x{HR}, "
        f"--chunk {FEEDBACK_CHUNK}, the trained checkpoint): {fps:.1f} "
        f"frames/s, PSNR {res['volume']['psnr']:.3f} dB, K1 launches "
        f"{launches} [{card}]")
    return res


def feedback_drf(card: str, dev) -> dict:
    """15b: DRFNet at full width (i) with 4 experts (K1 360 a volume, K3
    none: the experts rank with the plain compare), (ii) with sub-pixel
    deconvs on and off on the same weights, f32 (gated) and bf16 (printed),
    (iii) ``remat`` on and off for REMAT_STEPS train steps."""
    from vsr_tpu_torch.models import DRFNet

    drf = PATHS[0]
    frames = [as_frames(make_volume(50, FULL_SLICES))]
    warm = [as_frames(make_volume(99, FULL_SLICES))]
    res = {}
    runs, srs = phase_path_full(drf, {
        "f32_experts": (dict(drf.on, **DRF_EXPERTS), False, True),
        "f32_subpixel": (dict(drf.on, subpixel_deconv=True), False, True),
        "f32_plain": (drf.on, False, True),
        "bf16_subpixel": (dict(drf.on, subpixel_deconv=True), True, True),
        "bf16_plain": (drf.on, True, True)}, frames, warm, card, dev)
    res["pipelines"] = runs
    f32 = gate_agreement("drf sub-pixel vs transposed deconvs, f32",
                         srs["f32_subpixel"][0], srs["f32_plain"][0])
    exact, worst = agreement(srs["bf16_subpixel"][0], srs["bf16_plain"][0])
    res["subpixel"] = {"f32": f32, "bf16": {"exact_fraction": exact,
                                            "max_grey_diff": worst}}
    log(f"  drf sub-pixel deconvs on vs off: f32 "
        f"{f32['exact_fraction'] * 100:.4f}% exact, max "
        f"{f32['max_grey_diff']:g} grey, "
        f"{runs['f32_subpixel']['pipeline_frames_per_sec']:.1f} vs "
        f"{runs['f32_plain']['pipeline_frames_per_sec']:.1f} frames/s; bf16 "
        f"{exact * 100:.4f}% exact, max {worst:g} grey (not gated), "
        f"{runs['bf16_subpixel']['pipeline_frames_per_sec']:.1f} vs "
        f"{runs['bf16_plain']['pipeline_frames_per_sec']:.1f} frames/s "
        f"[{card}]")

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(TRAIN_N, TRAIN_T, 1, TRAIN_LR, TRAIN_LR,
                    generator=gen).to(dev)
    y = torch.randn(TRAIN_N, TRAIN_T, 1, TRAIN_HR, TRAIN_HR,
                    generator=gen).to(dev)
    grads, peak, counts = {}, {}, {}
    # cuDNN's deterministic algorithms: its default f32 dgrad alone moves
    # the PReLU weights' gradients (largest entries ~4e-8) of two plain runs
    # by up to 8e-4 of themselves, which is not what remat is held to.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for remat in (False, True):
        net = DRFNet(**DRF_KWARGS, fused_squeeze=True, remat=remat,
                     device=dev, generator=torch.Generator().manual_seed(0))
        # SGD: Adam would turn the nondeterministic dgrad's last bits in
        # near-zero gradients into +-lr steps before the second step.
        opt = torch.optim.SGD(net.parameters(), lr=1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        grads[remat] = []
        for _ in range(REMAT_STEPS):
            opt.zero_grad(set_to_none=True)
            (net(x) - y).abs().mean().backward()
            grads[remat].append({k: p.grad.clone()
                                 for k, p in net.named_parameters()})
            opt.step()
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated() - held) / 1e9
        # The recompute runs every frame step's forward again.
        per_step = SQUEEZES_PER_STEP * TRAIN_T
        k1 = kernel_counters()
        counts[remat] = {
            "forward": check_launches(
                f"drf remat {remat}", "concat_conv1x1",
                per_step * REMAT_STEPS * (2 if remat else 1),
                per_step * REMAT_STEPS),
            "backward": k1["concat_conv1x1"].backward_launches,
            "dw": k1["concat_conv1x1_dw"].launches}
    torch.backends.cudnn.deterministic = deterministic
    shares = [max((g_on[k] - g).abs().max().item()
                  / max(g.abs().max().item(), 1e-12)
                  for k, g in g_off.items())
              for g_off, g_on in zip(grads[False], grads[True])]
    share = max(shares)
    res["remat"] = {"steps": REMAT_STEPS, "gradient_share_by_step": shares,
                    "peak_memory_gb_remat": peak[True],
                    "peak_memory_gb_no_remat": peak[False],
                    "launches": counts,
                    "recompute_launches": counts[True]["forward"]
                    - counts[False]["forward"],
                    "dw_launches": counts[True]["dw"]}
    log(f"  drf remat on vs off (cuDNN deterministic), {REMAT_STEPS} SGD "
        f"steps of {TRAIN_N} x "
        f"{TRAIN_T} x {TRAIN_LR}x{TRAIN_LR}: gradients within "
        f"{[float(f'{v:.3g}') for v in shares]} of each gradient's largest "
        f"entry by step (bar {GRAD_SHARE:g}); peak memory "
        f"{peak[True]:.2f} GB with remat, {peak[False]:.2f} GB without; the "
        f"recompute's K1 forward launches "
        f"{res['remat']['recompute_launches']} ({counts[True]['forward']} "
        f"with remat, {counts[False]['forward']} without), dW/db "
        f"{res['remat']['dw_launches']} [{card}]")
    if share > GRAD_SHARE:
        raise SystemExit("drf: the gradients with remat on and off differ")
    return res


def feedback_moe(card: str, dev) -> dict:
    """15c: MoEEDSRNet at full width under every router and dispatch, one
    volume each: the masks first (on one set of every layer's affinities,
    the radix and sort selections against the rank kernel's, bit for bit),
    then each output against the rank kernel's with the same dispatch
    (identical), dense_nhwc against dense (phase 4b's sparse-vs-dense bar);
    K3 8 a volume for rank_pallas, none for the others."""
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.models.moe import ExpertChoiceMoE
    from vsr_tpu_torch.ops.rank import pairwise_rank

    moe = PATHS[1]
    frames = [as_frames(make_volume(51, FULL_SLICES))]
    warm = [as_frames(make_volume(99, FULL_SLICES))]
    variants = {name: (dict(MOE_KWARGS, **kw), False,
                       kw["router_impl"] == "rank_pallas")
                for name, kw in MOE_ROUTES.items()}
    # The masks first: every layer's affinities on this volume.
    net = build_net(moe, variants["rank_pallas/dense"][0], dev)
    afs = []
    hooks = [layer.register_forward_pre_hook(
        lambda m, args: afs.append(m.affinities(args[0])))
        for layer in net.moes.values()]
    make_pipeline(net, FACTOR, "acdc")(torch.from_numpy(frames[0]).to(dev))
    for h in hooks:
        h.remove()
    layer = next(iter(net.moes.values()))
    # The routers' own selections: a layer each, whose weights go unused
    # (the affinities are given).
    routers = {name: ExpertChoiceMoE(
        *layer.router.shape, router_impl=router, dispatch_impl=dispatch,
        radix_bits=bits)
        for name, router, dispatch, bits in (
            ("radix1", "radix", "dense", 1), ("radix4", "radix", "dense", 4),
            ("radix8", "radix", "dense", 8), ("sort", "sort", "sparse", 4))}
    masks = dict.fromkeys(routers, 0)
    with torch.inference_mode():
        for af, gs in afs:
            cap = layer.capacity(gs)
            rank = pairwise_rank(af) < cap
            for name, router in routers.items():
                masks[name] += int((router.selection(af, cap)
                                    != rank).sum())
    log(f"  moe masks on {len(afs)} layers' affinities ({afs[0][0].shape[0]}"
        f" groups x {afs[0][0].shape[1]} experts x {afs[0][1]}): selections "
        f"differing from the rank kernel's {masks}")
    if any(masks.values()):
        raise SystemExit("moe: a router's selection is not the rank's")
    del afs, net
    runs, srs = phase_path_full(moe, variants, frames, warm, card, dev)
    res = {"masks_differing": masks, "pipelines": runs, "outputs": {}}
    for name, ref in (("sort/sparse", "rank_pallas/sparse"),
                      ("radix1/dense", "rank_pallas/dense"),
                      ("radix4/dense", "rank_pallas/dense"),
                      ("radix8/dense", "rank_pallas/dense"),
                      ("rank_pallas/dense_nhwc", "rank_pallas/dense")):
        exact, worst = agreement(srs[name][0], srs[ref][0])
        res["outputs"][name] = {"against": ref, "exact_fraction": exact,
                                "max_grey_diff": worst}
        log(f"  moe {name} vs {ref}: {exact * 100:.4f}% exact, max "
            f"{worst:g} grey; {runs[name]['pipeline_frames_per_sec']:.1f} vs "
            f"{runs[ref]['pipeline_frames_per_sec']:.1f} frames/s [{card}]")
        # One dispatch: the same selections, the same arithmetic. Two: the
        # expert FFNs' products differ in the last bits and a later router
        # may flip a token at a capacity boundary (phase 4b's bar).
        same = name.split("/")[1] == ref.split("/")[1]
        if (worst != 0) if same else (exact < 0.995):
            raise SystemExit(f"moe: {name} and {ref} outputs disagree")
    return res


def feedback_routes(tmp: Path, card: str, dev) -> dict:
    """15d: SRFBNet and DRFSISRNet (F=64, G=6, 4 steps, fused_squeeze) in
    frame mode through an artifact (exported at the full frames shape,
    saved, loaded), the daemon (DAEMON_REQUESTS .npy volumes) and a frame
    stream (30 pushes of 10 slices), each against ``make_pipeline``'s last
    step at the grey bar, K1 counted on each route."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from vsr_tpu_torch import export, serve
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.registry import build
    from vsr_tpu_torch.stream import make_stream

    frames = as_frames(make_volume(52, FULL_SLICES))
    x = torch.from_numpy(frames).to(dev)
    res = {}
    for net_name in ("SRFBNet", "DRFSISRNet"):
        kwargs = dict(SRFB_KWARGS, fused_squeeze=True)
        net = build("net", {"name": net_name, "kwargs": kwargs}, device=dev,
                    generator=torch.Generator().manual_seed(0))
        pipe = make_pipeline(net, FACTOR, "acdc")  # one call a volume
        reset_launches()
        want = pipe(x)[1].cpu().numpy()
        per_volume = check_launches(f"{net_name} pipeline", "concat_conv1x1",
                                    SISR_SQUEEZES)
        check_sr(f"{net_name} pipeline", want, frames.shape)
        entry = {"pipeline_launches": per_volume}
        t0 = time.perf_counter()
        program, meta = export.export_serving(net, frames.shape, FACTOR)
        file = tmp / f"{net_name}.pt2.zip"
        export.save_artifact(file, program, {**meta, "net": net_name})
        del program
        served = export.ExportedServing(file, device=dev)
        entry["export_save_load_s"] = time.perf_counter() - t0
        reset_launches()
        got = served(frames)[1].cpu().numpy()
        entry["artifact_launches"] = check_launches(
            f"{net_name} artifact", "concat_conv1x1", per_volume)
        entry["artifact"] = gate_agreement(
            f"{net_name} artifact vs make_pipeline", got, want)

        reset_launches()
        srv = serve.make_server([served], port=0, warmup=True, device=dev)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            body = npy_bytes(frames)
            with ThreadPoolExecutor(DAEMON_REQUESTS) as ex:
                outs = list(ex.map(lambda _: post(
                    f"{url}/v1/sr", body, "application/x-npy"),
                    range(DAEMON_REQUESTS)))
            with urllib.request.urlopen(f"{url}/metrics") as resp:
                text = resp.read().decode()
            calls = srv.metrics.batch_calls + 1  # + the warm-up call
            line = (f'vsr_requests_total{{endpoint="/v1/sr",status="200"}} '
                    f'{DAEMON_REQUESTS}')
            if line not in text:
                raise SystemExit(f"{net_name} daemon: /metrics does not "
                                 f"count the {DAEMON_REQUESTS} requests")
        finally:
            srv.shutdown()
            srv.server_close()
        entry["daemon"] = [gate_agreement(f"{net_name} daemon response",
                                          from_npy(out), want)
                           for out, _, _ in outs]
        entry["daemon_launches"] = check_launches(
            f"{net_name} daemon", "concat_conv1x1", per_volume * calls)
        entry["daemon_latency_ms"] = [1e3 * sec for _, sec, _ in outs]

        stream = make_stream(net, FACTOR)
        seq = frames.reshape(FULL_SLICES, T_FRAMES, HR, HR)
        reset_launches()
        pushed, lat = push_all(stream, seq)
        entry["stream_launches"] = check_launches(
            f"{net_name} stream", "concat_conv1x1", SISR_SQUEEZES * T_FRAMES)
        got = np.stack([pushed[t] for t in range(T_FRAMES)], axis=1)
        entry["stream"] = gate_agreement(
            f"{net_name} {type(stream).__name__} vs make_pipeline", got,
            want.reshape(seq.shape))
        entry["median_push_ms"] = statistics.median(lat)
        res[net_name] = entry
        log(f"  {net_name} (frame mode, the last of {SRFB_STEPS} steps): "
            f"artifact at {frames.shape} (export, save, load "
            f"{entry['export_save_load_s']:.1f} s) "
            f"{entry['artifact']['exact_fraction'] * 100:.4f}% exact, K1 "
            f"{entry['artifact_launches']} a volume; daemon "
            f"{DAEMON_REQUESTS} requests, {calls} program calls, K1 "
            f"{entry['daemon_launches']}, latency "
            f"{[round(v) for v in entry['daemon_latency_ms']]} ms; "
            f"{type(stream).__name__} {T_FRAMES} pushes, median "
            f"{entry['median_push_ms']:.2f} ms, K1 "
            f"{entry['stream_launches']}, "
            f"{entry['stream']['exact_fraction'] * 100:.4f}% exact [{card}]")
    return res


def card_and_cpu(make, x: torch.Tensor, dev, dtype=None) -> tuple:
    """A train-mode forward and squared-error backward of the seeded net
    ``make(device)`` on the card and on the CPU: (outputs, gradients) of
    each, on the CPU. ``dtype``: the nets' compute dtype."""
    out = []
    for device in (dev, torch.device("cpu")):
        net = make(device, dtype).train()
        y = net(x.to(device))
        y = y[0] if isinstance(y, tuple) else y
        y.float().square().mean().backward()
        out.append((y.detach().float().cpu(), {
            k: p.grad.cpu() for k, p in net.named_parameters()}))
    return out


def feedback_small_nets(card: str, dev) -> dict:
    """15e: small nets on the card against the CPU: SRFBNet with sub-pixel
    deconvs (f32: outputs 1e-4, gradients GRAD_SHARE of the net's largest
    entry; bf16 ``carry_f32``: within twice the CPU's own bf16 error), RBPNet
    with sub-pixel deconvs, FRVSRNet with ``remat`` (and remat on against
    off on the card); no kernel of the port runs."""
    from vsr_tpu_torch.models import FRVSRNet, RBPNet, SRFBNet

    rng = np.random.default_rng(5)

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def srfb(device, dtype):
        return SRFBNet(1, 1, 2, 16, 3, 2, subpixel_deconv=True, dtype=dtype,
                       carry_f32=dtype is not None, device=device,
                       generator=torch.Generator().manual_seed(1))

    def rbpn(device, dtype):
        return RBPNet(1, 1, 8, 16, 3, 1, 3, 2, subpixel_deconv=True,
                      device=device,
                      generator=torch.Generator().manual_seed(2))

    def frvsr(remat):
        return lambda device, dtype: FRVSRNet(
            1, 1, 2, num_resblocks=2, remat=remat, device=device,
            generator=torch.Generator().manual_seed(3))

    def held(what, runs, bar_of=None):
        (y_card, g_card), (y_cpu, g_cpu) = runs
        net_max = max(g.abs().max().item() for g in g_cpu.values())
        share = max((g_card[k] - g).abs().max().item() / net_max
                    for k, g in g_cpu.items())
        out = (y_card - y_cpu).abs().max().item()
        log(f"  {what}, card vs CPU: outputs within {out:.3g}, gradients "
            f"within {share:.3g} of the net's largest entry [{card}]")
        if out > 1e-4 or share > GRAD_SHARE:
            raise SystemExit(f"{what}: card and CPU disagree")
        return {"output_max_diff": out, "gradient_share": share}

    reset_launches()
    res = {"srfb_subpixel": held("srfb sub-pixel f32", card_and_cpu(
        srfb, tensor(2, 1, 12, 12), dev))}
    x = tensor(2, 1, 12, 12)
    (y16, g16), (c16, h16) = card_and_cpu(srfb, x, dev, torch.bfloat16)
    (_, _), (c32, h32) = card_and_cpu(srfb, x, dev)
    env_y = (c16 - c32).abs().max().item()
    env_g = max((h16[k] - g).abs().max().item() for k, g in h32.items())
    got_y = (y16 - c16).abs().max().item()
    got_g = max((g16[k] - g).abs().max().item() for k, g in h16.items())
    res["srfb_carry_f32_bf16"] = {"output": [got_y, env_y],
                                  "gradient": [got_g, env_g]}
    log(f"  srfb bf16 carry_f32, card vs CPU: outputs {got_y:.3g} (twice the "
        f"CPU's bf16 error: {2 * env_y:.3g}), gradients {got_g:.3g} "
        f"({2 * env_g:.3g}) [{card}]")
    if got_y > 2 * env_y or got_g > 2 * env_g:
        raise SystemExit("srfb bf16 carry_f32: the card's bf16 error exceeds "
                         "twice the CPU's")
    res["rbpn_subpixel"] = held("rbpn sub-pixel", card_and_cpu(
        rbpn, tensor(2, 3, 1, 12, 12), dev))
    x = tensor(2, 3, 1, 16, 16)
    res["frvsr_remat"] = held("frvsr remat", card_and_cpu(frvsr(True), x,
                                                          dev))
    (_, g_on), _ = card_and_cpu(frvsr(True), x, dev)
    (_, g_off), _ = card_and_cpu(frvsr(False), x, dev)
    share = max((g_on[k] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-12) for k, g in g_off.items())
    res["frvsr_remat"]["on_vs_off_share"] = share
    log(f"  frvsr remat on vs off on the card: gradients within {share:.3g} "
        f"of each gradient's largest entry (bar {GRAD_SHARE:g})")
    if share > GRAD_SHARE:
        raise SystemExit("frvsr: the gradients with remat on and off differ")
    check_launches("the small nets", "concat_conv1x1", 0)
    return res


def phase_feedback(tmp: Path, tree: dict, card: str, dev) -> dict:
    """Phase 15: the rest of the feedback family and the MoE routers on
    phase 7's tree (15a-15e)."""
    res, seconds = {}, {}
    for key, label, run in (
            ("drfsisr", "15a: DRFSISRNet F=64 G=6, 4 steps, trained, tested "
             "and served (K1 forward and backward)",
             lambda: feedback_drfsisr(tmp, tree, card, dev)),
            ("drf", "15b: DRFNet F=64 G=6 with experts, sub-pixel deconvs, "
             "remat (K1)", lambda: feedback_drf(card, dev)),
            ("moe", "15c: MoEEDSRNet's routers and dispatches (K3 with "
             "rank_pallas)", lambda: feedback_moe(card, dev)),
            ("routes", "15d: SRFBNet and DRFSISRNet through an artifact, the "
             "daemon and a frame stream (K1)",
             lambda: feedback_routes(tmp, card, dev)),
            ("small", "15e: small nets on the card against the CPU",
             lambda: feedback_small_nets(card, dev))):
        log(f"phase {label}")
        t0 = time.perf_counter()
        res[key] = run()
        torch.cuda.empty_cache()  # the lanes share the card (LANES)
        seconds[key] = time.perf_counter() - t0
        log(f"  phase 15{'abcde'[len(seconds) - 1]} took "
            f"{seconds[key]:.1f} s [{card}]")
    res["seconds_by_step"] = seconds
    return res


def feedback_summary(fb: dict) -> dict:
    """Phase 15's launches by kernel, for the kernels' line."""
    routes = {f"{net}_{route}": fb["routes"][net][f"{route}_launches"]
              for net in ("SRFBNet", "DRFSISRNet")
              for route in ("artifact", "daemon", "stream")}
    return {"concat_conv1x1": {
        "drfsisr_train": fb["drfsisr"]["train"]["launches"],
        "drfsisr_backward": fb["drfsisr"]["train"]["backward_launches"],
        "drfsisr_test": fb["drfsisr"]["test"]["launches"],
        "drfsisr_volume": fb["drfsisr"]["volume"]["launches"],
        "drf_experts_volume": fb["drf"]["pipelines"]["f32_experts"][
            "launches"],
        "drf_subpixel_volume": fb["drf"]["pipelines"]["f32_subpixel"][
            "launches"],
        "drf_remat_recompute": fb["drf"]["remat"]["recompute_launches"],
        **routes},
        "pairwise_rank": {name: run["launches"] for name, run in
                          fb["moe"]["pipelines"].items()},
        "seconds_by_step": fb["seconds_by_step"]}


# ======================================== presets, tune, bf16 nets (phase 16)

# 16a: the transposed convs W8A8 serves with quantize_deconvs, as sub-pixel
# banks through w8a8_conv: DRF's k6 s2 p2 projection (the feedback family
# and RBPN x2) at LR 96, and the x4 DBPN geometry, k8 s4 p2, at LR 48;
# 10 slices, 64 -> 64 channels.
DECONV_SHAPES = {"k6s2p2": (6, 2, 2, LR), "k8s4p2": (8, 4, 2, HR // 4)}
# 16b: the nets whose kernels the presets' runs carry: key -> (net, the
# test config's kwargs with the path's kernel, infer's mode flags, kernel,
# its launches per net call, the W8A8 convs of a net call under lazy
# calibration, as phase 13 counts them: EDSR's 34, DUF's 16, MoE's 34;
# DRF's preset takes a scales file, so fast serves it without W8A8).
PRESET_RUNS = {
    "edsr": ("EDSRNet", EDSR_KWARGS, [], None, 0, EDSR_W8A8_CONVS),
    "duf": ("DUFNet", dict(DUF_KWARGS, use_pallas_filter=True),
            ["--windows", str(DUF_KWARGS["num_frames"])],
            "duf_dynamic_filter", 1, 16),
    "drf": ("DRFNet", dict(DRF_KWARGS, fused_squeeze=True), ["--video"],
            "concat_conv1x1", SQUEEZES_PER_STEP * T_FRAMES, 0),
    "moe": ("MoEEDSRNet", dict(MOE_KWARGS, router_impl="rank_pallas"), [],
            "pairwise_rank", MOE_LAYERS, 34),
}
PRESET_PSNR_BAR = W8A8_PSNR_BAR  # dB: fast against the run without a preset
# The test configs' nets the tuner runs at full width (16d, --preset-table).
RBPN_KWARGS = dict(in_channels=1, out_channels=1, base_filter=64, feat=64,
                   num_stages=3, num_resblocks=5, num_frames=5,
                   upscale_factor=FACTOR)
EDVR_KWARGS = dict(in_channels=1, out_channels=1, nf=64, nframes=5,
                   groups=8, front_RBs=5, back_RBs=10, fused_tail=True)
VOL4D_KWARGS = dict(in_channels=1, out_channels=1, num_features=32,
                    num_resblocks=4, upscale_factor=FACTOR, remat=True)
# 16e: one bf16 train step of each net moved onto the precision policy, at
# its test config's widths, through DeviceEpochTrainer as tune --train
# builds it (an L1 loss, Adam), a batch of 2 LR crops of 16 x 16 from
# tune's seeded buffers (a MISR net's HR target the window's middle
# frame): net -> (kwargs, factor, --train-shape, MISR).
BF16_NETS = {
    "MoEEDSRNet": (MOE_KWARGS, FACTOR, (4, 64, 64), False),
    "DUFNet": (DUF_KWARGS, FACTOR, (4, 7, 64, 64), True),
    "EDVRNet": (EDVR_KWARGS, 4, (4, 5, 128, 128), True),
    "FRVSRNet": (dict(in_channels=1, out_channels=1, upscale_factor=4,
                      num_resblocks=10, carry_f32=True), 4, (4, 3, 128, 128),
                 False),
    "RBPNet": (RBPN_KWARGS, FACTOR, (4, 5, 64, 64), True),
    "TOFlowNet": (dict(in_channels=1, out_channels=1, num_frames=5,
                       upscale_factor=FACTOR), FACTOR, (4, 5, 64, 64), True),
    "Volume4DSRNet": (dict(VOL4D_KWARGS, carry_f32=True), FACTOR,
                      (4, 3, 4, 64, 64), False),
}
BF16_BATCH, BF16_PATCH = 2, 16
# Card vs CPU loss, relative: the larger of 1e-4 and twice the CPU's own
# bf16 error of the loss (its distance from the CPU's float32 loss). A
# batch of 2 averages too few outputs for 1e-4 alone at the configs'
# widths: MoEEDSRNet 16 x 64 moved 1.01e-4 card vs CPU, its own bf16
# error 2.8e-4.
BF16_LOSS_BAR = 1e-4


def deconv_bank_case(name: str, dev, gen) -> dict:
    """16a: one transposed conv as W8A8: the kernel on its sub-pixel bank
    against the twin (int32 accumulators and float32 / bf16 outputs
    bit-equal) and against the unfused int8 transposed conv of the same
    quantized operands in int32 (float64 on the card: exact); the kernel's
    median ms against its bound, cuDNN's float32 and bf16 transposed
    convs of the shape."""
    import torch.nn.functional as F

    from vsr_tpu_torch import quantize
    from vsr_tpu_torch.models.common import ConvTranspose
    from vsr_tpu_torch.ops import w8a8_conv as wc

    k, s, p, side = DECONV_SHAPES[name]
    mod = ConvTranspose(64, 64, k, s, p).to(dev)
    x = torch.randn(FULL_SLICES, 64, side, side, device=dev, generator=gen)
    bank = quantize.deconv_bank(mod)
    xs = float(wc.dynamic_scale(x))
    pad = bank["padding"][0]
    args = (x, bank["weight"], bank["bias"], xs, (1, 1), (pad, pad), 1)
    kw = dict(weight_scale=bank["weight_scale"])
    res = {"x": list(x.shape), "bank": list(bank["weight"].shape),
           "kernel_stride_padding": [k, s, p],
           "plan": wc.kernel_plan(x.shape, bank["weight"].shape, (1, 1),
                                  (pad, pad), 1)}
    with torch.inference_mode():
        acc = wc.w8a8_conv(*args, out_dtype=torch.int32, **kw)
        want = wc.w8a8_conv_reference(*args, out_dtype=torch.int32, **kw)
        xq = wc.quantize_activations(x, torch.tensor(xs, device=dev))
        wq, _ = wc.quantize_weight(mod.weight.transpose(0, 1))
        unfused = F.conv_transpose2d(xq.double(),
                                     wq.transpose(0, 1).double(), None, s,
                                     p).to(torch.int32)
        shuffled = F.pixel_shuffle(acc, s)
        if not (torch.equal(acc, want) and torch.equal(shuffled, unfused)):
            raise SystemExit(f"W8A8 deconv {name}: accumulators differ "
                             f"(twin {torch.equal(acc, want)}, unfused "
                             f"int8 transposed conv "
                             f"{torch.equal(shuffled, unfused)})")
        res["max_abs_err"] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            got = quantize._w8a8_deconv(mod, x.to(dtype), xs, dtype).float()
            ref = F.pixel_shuffle(wc.w8a8_conv_reference(
                x.to(dtype), *args[1:], out_dtype=dtype, **kw), s).float()
            err = (got - ref).abs()
            if dtype == torch.float32:  # phase 13a's bars
                ok = err.max().item() <= W8A8_F32_SHARE * ref.abs().max().item()
            else:
                ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                    got.abs(), ref.abs()) + 1e-30)) - 7)
                ok = bool((err <= ulp).all())
            if not ok:
                raise SystemExit(f"W8A8 deconv {name} {dtype}: the kernel's "
                                 f"output differs from its twin's by "
                                 f"{err.max().item():.3g}")
            res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
        launches = wc.w8a8_conv.launches
        res["ms"] = median_ms(lambda: wc.w8a8_conv(*args, **kw),
                              reps=SHAPE_REPS)
        res["deconv_ms"] = median_ms(
            lambda: quantize._w8a8_deconv(mod, x, xs), reps=SHAPE_REPS)
        res["plain_ms"] = median_ms(
            lambda: wc.w8a8_conv_reference(*args, **kw), reps=SHAPE_REPS)
        wc.w8a8_conv.launches = launches
        w, b = mod.weight, mod.bias
        res["cudnn_f32_ms"] = median_ms(
            lambda: F.conv_transpose2d(x, w, b, s, p), reps=SHAPE_REPS)
        xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        res["cudnn_bf16_ms"] = median_ms(
            lambda: F.conv_transpose2d(xb, wb, bb, s, p), reps=SHAPE_REPS)
    out_hr = FULL_SLICES * 64 * (side * s) ** 2
    # Bytes: x read once, the int8 bank, its scales and biases, the output
    # written once (float32). Operations: the transposed conv's own
    # multiply-adds (k / s taps a row and a column per output pixel; the
    # bank's zero taps are not work the function needs).
    n_bytes = (x.numel() * 4 + bank["weight"].numel() + 8 * bank[
        "weight"].shape[0] + out_hr * 4)
    ops = 2 * out_hr * 64 * (k // s) ** 2
    res["bytes"], res["ops"] = n_bytes, ops
    res["bound_ms"], res["bound_by"] = bound(n_bytes, ops, PEAK_INT8)
    res["int8_ops_ms"] = ops / PEAK_INT8 * 1e3
    return res


def preset_args(key: str, preset: str | None, extra: list) -> tuple:
    """The infer CLI's namespace for one run of 16b, after its ``main``
    applied the preset (``presets.apply_cli_preset``), and the notes."""
    from vsr_tpu_torch import infer
    from vsr_tpu_torch.presets import apply_cli_preset

    name, kwargs, flags = PRESET_RUNS[key][:3]
    args = infer.parse_args(["in", "out", "--net", name, "--net-kwargs",
                             json.dumps(kwargs), *flags, *extra]
                            + (["--preset", preset] if preset else []))
    return args, apply_cli_preset(args)


def preset_run(key: str, preset: str | None, frames: np.ndarray, dev,
               card: str, base: dict | None = None) -> dict:
    """One net through infer's pipeline as ``--preset`` sets it up: a
    warm-up volume (a lazy W8A8 pipeline calibrates there), then two timed
    volumes; launches per volume, gated; frames/s; PSNR against the HR
    input; against the run without a preset."""
    from vsr_tpu_torch import infer

    args, notes = preset_args(key, preset, [])
    pipe = infer.serving_pipelines(args)[1](T_FRAMES, len(frames))
    pipe(torch.from_numpy(frames).to(dev))
    reset_launches()
    times = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sr = pipe(torch.from_numpy(frames).to(dev))[1].cpu().numpy()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v // 2 for k, v in quant_launches().items()}
    check_sr(f"{key} {preset}", sr, frames.shape)
    kernel, per_call, w8a8_per_call = PRESET_RUNS[key][3:]
    calls = -(-len(frames) // args.chunk) if args.chunk and not args.video \
        else 1
    want = {kernel: per_call * calls} if kernel else {}
    if args.w8a8:
        want["w8a8_conv"] = w8a8_per_call * calls
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise SystemExit(f"{key} --preset {preset}: launches {got}, "
                         f"expected {want}")
    ms = statistics.median(times)
    res = {"preset": preset, "notes": notes, "chunk": args.chunk,
           "net_kwargs": json.loads(args.net_kwargs), "w8a8": bool(args.w8a8),
           "launches": launches, "volume_ms": ms,
           "frames_per_s": len(frames) / ms * 1e3, "psnr": psnr(sr, frames),
           "sr": sr, "scales": getattr(pipe, "act_scales", None)}
    line = (f"  {key} --preset {preset or 'none'}: {res['frames_per_s']:.1f} "
            f"frames/s, PSNR {res['psnr']:.3f} dB, chunk {args.chunk}, "
            f"W8A8 {bool(args.w8a8)}, launches {got}")
    if base is not None:
        res["speed_vs_none"] = res["frames_per_s"] / base["frames_per_s"]
        res["psnr_delta"] = res["psnr"] - base["psnr"]
        res["vs_none"] = dict(zip(("exact_fraction", "max_grey_diff"),
                                  agreement(sr, base["sr"])))
        line += (f"; {res['speed_vs_none']:.3f}x no preset, PSNR "
                 f"{res['psnr_delta']:+.4f} dB, "
                 f"{res['vs_none']['exact_fraction'] * 100:.4f}% exact")
        if preset == "tuned" and "dispatch_impl" in res["net_kwargs"]:
            # Another MoE dispatch: its expert products differ in the last
            # bits, so a later layer's router can flip a token at a
            # capacity boundary: phase 4b's bar for the two dispatches.
            if res["vs_none"]["exact_fraction"] < 0.995:
                raise SystemExit(f"{key} --preset tuned (dispatch "
                                 f"{res['net_kwargs']['dispatch_impl']}) vs "
                                 "no preset: outputs disagree")
        elif preset == "tuned":
            gate_agreement(f"{key} --preset tuned vs no preset", sr,
                           base["sr"])
        elif not abs(res["psnr_delta"]) < PRESET_PSNR_BAR:
            raise SystemExit(f"{key} --preset fast: PSNR moved "
                             f"{res['psnr_delta']:+.4f} dB (bar "
                             f"{PRESET_PSNR_BAR} dB)")
    log(line + f" [{card}]")
    return res


def presets_routes(tmp: Path, frames: np.ndarray, fast: dict, card: str,
                   dev) -> dict:
    """16b: ``export --preset fast`` (W8A8 calibrated from ``--calib``: the
    volume itself, so the scales are the lazy pipeline's) and the daemon's
    live backend with ``--preset fast`` and those scales, for EDSRNet,
    each held against the ``--preset fast`` pipeline."""
    import threading

    from vsr_tpu_torch import export, serve
    from vsr_tpu_torch.io.nifti import save_nifti
    from vsr_tpu_torch.presets import apply_cli_preset

    calib = tmp / "preset_calib"
    vol = np.moveaxis(frames.reshape(FULL_SLICES, T_FRAMES, HR, HR),
                      (0, 1), (2, 3))
    save_nifti(vol.astype(np.float32), calib / "p" / "p_4d.nii")
    name, kwargs = PRESET_RUNS["edsr"][:2]
    file = tmp / "edsr_fast.pt2.zip"
    reset_launches()
    t0 = time.perf_counter()
    export.main(["--net", name, "--net-kwargs", json.dumps(kwargs),
                 "--shape", ",".join(map(str, frames.shape)), "--preset",
                 "fast", "--calib", str(calib), "--out", str(file),
                 "--device", str(dev)])
    served = export.ExportedServing(file, device=dev)
    setup_s = time.perf_counter() - t0
    reset_launches()
    got = served(frames)[1].cpu().numpy()
    art = dict(gate_agreement("export --preset fast vs the --preset fast "
                              "pipeline", got, fast["sr"]),
               launches=quant_launches()["w8a8_conv"],
               export_save_load_s=setup_s)
    if art["launches"] != fast["launches"]["w8a8_conv"]:
        raise SystemExit(f"export --preset fast: {art['launches']} "
                         "w8a8_conv launches, expected "
                         f"{fast['launches']['w8a8_conv']}")
    log(f"  EDSR export --preset fast (--calib): "
        f"{art['exact_fraction'] * 100:.4f}% exact vs the pipeline, "
        f"{art['launches']} w8a8_conv launches a volume, export + save + "
        f"load {setup_s:.1f} s [{card}]")
    scales = tmp / "edsr_fast_scales.json"
    scales.write_text(json.dumps(fast["scales"]))
    args = serve.parse_args(["--net", name, "--net-kwargs",
                             json.dumps(kwargs), "--frames-shape",
                             ",".join(map(str, frames.shape)), "--preset",
                             "fast", "--w8a8-scales", str(scales),
                             "--device", str(dev)])
    notes = apply_cli_preset(args)
    reset_launches()
    (live,) = serve.live_from_args(args)
    srv = serve.make_server([], port=0, warmup=True, live=[live], device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body, sec, _ = post(f"http://127.0.0.1:{srv.server_address[1]}/v1/sr",
                            npy_bytes(frames), "application/x-npy")
        daemon = dict(gate_agreement("serve --preset fast vs the --preset "
                                     "fast pipeline", from_npy(body),
                                     fast["sr"]),
                      request_ms=sec * 1e3, notes=notes)
    finally:
        srv.shutdown()
        srv.server_close()
    daemon["launches"] = quant_launches()["w8a8_conv"]
    if daemon["launches"] != 2 * fast["launches"]["w8a8_conv"]:
        raise SystemExit(f"serve --preset fast: {daemon['launches']} "
                         "w8a8_conv launches (warm-up + 1 request), expected "
                         f"{2 * fast['launches']['w8a8_conv']}")
    log(f"  EDSR serve --preset fast --w8a8-scales: 1 request, "
        f"{sec * 1e3:.1f} ms, {daemon['exact_fraction'] * 100:.4f}% exact "
        f"vs the pipeline, {daemon['launches']} w8a8_conv launches (warm-up "
        f"+ request); notes {notes} [{card}]")
    return {"export": art, "daemon": daemon}


def presets_tune(tmp: Path, card: str, dev) -> dict:
    """16c / 16d: ``python -m vsr_tpu_torch.tune`` at full geometry on
    EDSRNet with a two-point chunk grid, its file through ``infer
    --preset-file``; ``tune --train`` on MoEEDSRNet and Volume4DSRNet, a
    few steps a row, no bf16 row an error."""
    from vsr_tpu_torch import infer, tune
    from vsr_tpu_torch.presets import apply_cli_preset

    file = tmp / "tuned.json"
    t0 = time.perf_counter()
    out = tune.main(["--net", "EDSRNet", "--net-kwargs",
                     json.dumps(EDSR_KWARGS), "--shape",
                     f"{FULL_SLICES * T_FRAMES},{HR},{HR}", "--chunk-grid",
                     "0,100", "--repeats", "1", "--out", str(file)])
    serve_s = time.perf_counter() - t0
    rows = out["measured"]
    if len(rows) != 4 or any("error" in r for r in rows):
        raise SystemExit(f"tune EDSRNet: rows {rows}")
    entry = out["presets"]["EDSRNet"]
    args = infer.parse_args(["in", "out", "--net", "EDSRNet", "--net-kwargs",
                             json.dumps(EDSR_KWARGS), "--preset-file",
                             str(file)])
    apply_cli_preset(args)
    got = {"chunk": args.chunk, "fused_tail": json.loads(
        args.net_kwargs).get("fused_tail")}
    want = {"chunk": entry["chunk"],
            "fused_tail": entry["net_kwargs"]["fused_tail"]}
    if got != want or args.preset != "tuned":
        raise SystemExit(f"infer --preset-file {file}: knobs {got}, the "
                         f"file's {want}")
    log(f"  tune EDSRNet at ({FULL_SLICES * T_FRAMES}, {HR}, {HR}), chunk "
        f"0 / 100 x fused_tail: {[r['volumes_per_sec'] for r in rows]} "
        f"volumes/s, best {entry} ({serve_s:.1f} s); infer --preset-file "
        f"sets {got} [{card}]")
    res = {"serving": {"rows": rows, "entry": entry, "seconds": serve_s,
                       "card": out.get("card"), "backend": out["backend"]}}
    for net, kwargs, shape, batch, patch in (
            ("MoEEDSRNet", dict(MOE_KWARGS, router_impl="rank_pallas"),
             f"32,{HR // 2},{HR // 2}", 16, 32),
            ("Volume4DSRNet", VOL4D_KWARGS, "8,3,4,64,64", 2, 32)):
        file = tmp / f"train_{net}.json"
        t0 = time.perf_counter()
        out = tune.main(["--train", "--net", net, "--net-kwargs",
                         json.dumps(kwargs), "--train-shape", shape,
                         "--batch", str(batch), "--patch", str(patch),
                         "--steps", "4", "--repeats", "1", "--out",
                         str(file)])
        bad = [r for r in out["measured"] if "error" in r]
        if bad or not any(r["dtype"].startswith("bfloat16")
                          for r in out["measured"]):
            raise SystemExit(f"tune --train {net}: rows with an error "
                             f"{bad}")
        res[net] = {"rows": out["measured"], "best": out["train_presets"],
                    "seconds": time.perf_counter() - t0}
        log(f"  tune --train {net} ({shape}, batch {batch}): "
            + ", ".join(f"{r['dtype']}/ga{r['grad_accumulation']}"
                        + (f"/{r['dispatch_impl']}" if "dispatch_impl" in r
                           else "") + f" {r['steps_per_sec']} steps/s"
                        for r in out["measured"])
            + f" ({res[net]['seconds']:.1f} s) [{card}]")
    return res


def bf16_train_step(name: str, kwargs: dict, factor: int, bufs: tuple,
                    device, dtype, draws) -> tuple:
    """One step of ``name`` through ``DeviceEpochTrainer`` (one epoch of
    one step, eager) from seeded float32 parameters: (its loss, its output
    on the CPU), the parameters float32 and finite before and after."""
    from vsr_tpu_torch.losses import L1Loss
    from vsr_tpu_torch.registry import build
    from vsr_tpu_torch.runner.device_trainer import DeviceEpochTrainer

    kw = dict(kwargs, dtype=dtype) if dtype else dict(kwargs)
    net = build("net", {"name": name, "kwargs": kw}, device=device,
                generator=torch.Generator().manual_seed(0))
    trainer = DeviceEpochTrainer(
        net=net, loss_fns=[L1Loss()], loss_weights=[1.0], metric_fns=[],
        optimizer=torch.optim.Adam(net.parameters(), lr=1e-4),
        lr_data=bufs[0], hr_data=bufs[1], batch_size=BF16_BATCH,
        patch=BF16_PATCH, ratio=factor, steps_per_epoch=1, scan_unroll=1,
        device=device)
    def float32(when):
        if not all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in trainer.net.parameters()):
            raise SystemExit(f"{name} {dtype} on {device}: parameters not "
                             f"finite float32 {when} the step")

    seen = []
    hook = trainer.net.register_forward_hook(
        lambda _m, _i, out: seen.append(
            (out[0] if isinstance(out, tuple) else out).detach().float()
            .cpu()))
    float32("before")
    loss = trainer.train_epoch(draws)["Loss"]
    float32("after")
    hook.remove()
    return loss, seen[0]


def bf16_nets_card_vs_cpu(card: str, dev) -> dict:
    """16e: one bf16 train step of each net moved onto the precision
    policy, at its test config's widths, on the card and on the CPU from
    the same seeded float32 parameters, buffers and draws: the card's loss
    within the larger of BF16_LOSS_BAR and twice the CPU's own bf16 error
    of the loss (relative to the CPU's bf16 loss), the card's output within
    twice the CPU's own bf16 error (its distance from the CPU's float32
    output), the parameters float32."""
    from vsr_tpu_torch import tune
    from vsr_tpu_torch.data.datasets import misr_target_index
    from vsr_tpu_torch.runner.device_trainer import epoch_draws
    from vsr_tpu_torch.utils.rng import RngTree

    res = {}
    cpu = torch.device("cpu")
    for name, (kwargs, factor, shape, misr) in BF16_NETS.items():
        bufs = tune._train_buffers(name, shape, factor)
        if misr:
            bufs = (bufs[0], np.ascontiguousarray(
                bufs[1][:, misr_target_index(shape[1])]))
        draws = epoch_draws(RngTree("vsr"), 1, torch.from_numpy(bufs[0]), 1,
                            BF16_BATCH, BF16_PATCH)
        runs = {(d.type, dtype): bf16_train_step(name, kwargs, factor, bufs,
                                                 d, dtype, draws)
                for d, dtype in ((dev, "bfloat16"), (cpu, "bfloat16"),
                                 (cpu, None))}
        on_card, on_cpu, f32 = (runs[(dev.type, "bfloat16")],
                                runs[("cpu", "bfloat16")], runs[("cpu", None)])
        rel = abs(on_card[0] - on_cpu[0]) / abs(on_cpu[0])
        own = abs(on_cpu[0] - f32[0]) / abs(on_cpu[0])
        bar = max(BF16_LOSS_BAR, 2 * own)
        envelope = (on_cpu[1] - f32[1]).abs().max().item()
        err = (on_card[1] - on_cpu[1]).abs().max().item()
        res[name] = {"card_loss": on_card[0], "cpu_loss": on_cpu[0],
                     "f32_cpu_loss": f32[0], "rel": rel,
                     "cpu_bf16_loss_error": own, "loss_bar": bar,
                     "output_err": err, "cpu_bf16_error": envelope}
        log(f"  {name} bf16{' carry_f32' if kwargs.get('carry_f32') else ''}"
            f" at its config's widths (batch {BF16_BATCH}, LR "
            f"{BF16_PATCH}^2): loss card {on_card[0]:.6f}, CPU "
            f"{on_cpu[0]:.6f}, relative {rel:.2e} (bar {bar:.2e}: the CPU's "
            f"own bf16 error {own:.2e}, CPU float32 {f32[0]:.6f}); output "
            f"card vs CPU {err:.3g} against the CPU's own bf16 error "
            f"{envelope:.3g}; parameters float32 [{card}]")
        if rel > bar or err > 2 * envelope:
            raise SystemExit(f"{name} bf16: card and CPU differ (loss "
                             f"{rel:.2e}, bar {bar:.2e}; output {err:.3g}, "
                             f"bar {2 * envelope:.3g})")
    return res


def phase_presets(tmp: Path, card: str, dev) -> dict:
    """Phase 16: 16a the W8A8 kernel on both deconv banks; 16b infer
    ``--preset tuned`` / ``fast`` against no preset on one 192 x 192 x 10 x
    30 volume (EDSRNet, DUFNet with K2, DRFNet with K1, MoEEDSRNet with K3)
    and ``--preset fast`` through export and the daemon; 16c / 16d the
    tuner; 16e one bf16 train step of each net moved onto the policy."""
    res: dict = {"seconds_by_step": {}}
    t0 = time.perf_counter()
    log("phase 16a: W8A8 on the transposed convs' sub-pixel banks "
        "(quantize_deconvs)")
    gen = torch.Generator(device=dev).manual_seed(16)
    res["deconv"] = {}
    for name in DECONV_SHAPES:
        row = res["deconv"][name] = deconv_bank_case(name, dev, gen)
        log(f"  {name} x {row['x']} bank {row['bank']} "
            f"{plan_text(row['plan'])}: int32 bit-equal to its twin and to "
            f"the int8 transposed conv, outputs err {row['max_abs_err']:.3g}; "
            f"kernel {row['ms']:.3f} ms (the deconv "
            f"with its shuffle {row['deconv_ms']:.3f}), bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']} (int8 operations "
            f"{row['int8_ops_ms']:.4f}), twin {row['plain_ms']:.3f}, cuDNN "
            f"transposed conv f32 {row['cudnn_f32_ms']:.3f} / bf16 "
            f"{row['cudnn_bf16_ms']:.3f} [{card}]")
    res["seconds_by_step"]["16a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 16b: infer --preset tuned / fast against no preset")
    frames = quality_volume()
    runs = res["runs"] = {}
    for key in PRESET_RUNS:
        base = preset_run(key, None, frames, dev, card)
        runs[key] = {"none": base,
                     "tuned": preset_run(key, "tuned", frames, dev, card,
                                         base),
                     "fast": preset_run(key, "fast", frames, dev, card, base)}
        torch.cuda.empty_cache()
    res["routes"] = presets_routes(tmp, frames, runs["edsr"]["fast"], card,
                                   dev)
    for by_preset in runs.values():
        for run in by_preset.values():
            run.pop("sr")
            run.pop("scales")
    res["seconds_by_step"]["16b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 16c / 16d: the tuner (serving at full geometry, --train)")
    res["tune"] = presets_tune(tmp, card, dev)
    res["seconds_by_step"]["16cd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 16e: one bf16 train step of each net moved onto the "
        "precision policy, card vs CPU")
    res["bf16_nets"] = bf16_nets_card_vs_cpu(card, dev)
    res["seconds_by_step"]["16e"] = time.perf_counter() - t0
    return res


def presets_summary(pr: dict) -> dict:
    """Phase 16's launches a volume by kernel and preset, and the W8A8
    deconv banks' rows, for the kernels line."""
    launches = {f"{key}_{preset}": {k: v for k, v in run["launches"].items()
                                     if v}
                for key, by_preset in pr["runs"].items()
                for preset, run in by_preset.items()}
    return {"launches": launches,
            "deconv": {name: {k: row[k] for k in (
                "x", "bank", "ms", "deconv_ms", "plain_ms", "bound_ms",
                "bound_by", "cudnn_f32_ms", "cudnn_bf16_ms")}
                for name, row in pr["deconv"].items()}}


# --preset-table: the sweep behind vsr_tpu_torch/presets.py's table (a
# measurement run of its own, not part of the smoke run). Each registered
# net at its test config's width: net -> (kwargs, factor, tune's mode
# flags, the W8A8 form the fast level would take ("lazy": infer's first-
# batch calibration; "scales": callback scales, the loop-body convs), the
# chunk grid).
TABLE_NETS = {
    "Bicubic": ({"upscale_factor": FACTOR}, FACTOR, [], None, "0,100"),
    "EDSRNet": (EDSR_KWARGS, FACTOR, [], "lazy", "0,100"),
    "MoEEDSRNet": (dict(MOE_KWARGS, router_impl="rank_pallas"), FACTOR, [],
                   "lazy", "0,100"),
    "SRFBNet": (SRFB_KWARGS, FACTOR, [], "scales", "0,60"),
    "DRFSISRNet": (dict(SRFB_KWARGS, fused_squeeze=True), FACTOR, [],
                   "scales", "0,60"),
    "DRFNet": (dict(DRF_KWARGS, fused_squeeze=True), FACTOR,
               ["--video-t", str(T_FRAMES)], "scales", "0"),
    "FRVSRNet": (dict(in_channels=1, out_channels=1, upscale_factor=4,
                      num_resblocks=10), 4, ["--video-t", str(T_FRAMES)],
                 "scales", "0"),
    "TOFlowNet": (dict(in_channels=1, out_channels=1, num_frames=5,
                       upscale_factor=FACTOR), FACTOR,
                  ["--windows", "5", "--seq-t", str(T_FRAMES)], "lazy",
                  "0,30,100"),
    "DUFNet": (dict(DUF_KWARGS, use_pallas_filter=True), FACTOR,
               ["--windows", "7", "--seq-t", str(T_FRAMES)], "lazy",
               "0,30,100"),
    "RBPNet": (RBPN_KWARGS, FACTOR,
               ["--windows", "5", "--seq-t", str(T_FRAMES)], "lazy",
               "0,30,100"),
    "EDVRNet": (EDVR_KWARGS, 4,
                ["--windows", "5", "--seq-t", str(T_FRAMES)], "lazy",
                "0,30,100"),
    "Volume3DSRNet": (dict(in_channels=1, out_channels=1, num_features=32,
                           num_resblocks=8, upscale_factor=FACTOR), FACTOR,
                      ["--seq-t", str(T_FRAMES)], "lazy", "0,10"),
    "Volume4DSRNet": (VOL4D_KWARGS, FACTOR, ["--seq-t", str(T_FRAMES)],
                      "scales", "0"),
}


def table_w8a8(net_name: str, kwargs: dict, factor: int, flags: list,
               form: str, entry: dict, frames: np.ndarray, dev,
               card: str) -> dict:
    """The W8A8 on / off run of one net: its tuned knobs (``entry``), on a
    low-passed 192 x 192 x 10 x 30 volume, without and with W8A8 in the
    form its fast level would take; frames/s (a warm-up volume, then the
    median of two), PSNR against the HR input."""
    from vsr_tpu_torch import quantize
    from vsr_tpu_torch.infer import (build_serving_net, make_pipeline,
                                     make_prep, resolve_volume)

    kw = dict(kwargs, **entry.get("net_kwargs", {}))
    opt = dict(zip(flags[::2], flags[1::2]))
    video_t = int(opt.get("--video-t", 0))
    windows = int(opt.get("--windows", 0))
    seq_t = int(opt.get("--seq-t", 0))
    volume = resolve_volume(net_name, seq_t=seq_t, chunk=entry["chunk"],
                            n_frames=len(frames), exc=SystemExit)
    window = (windows, seq_t, "middle") if windows else None
    mode = dict(video_t=video_t, window=window, volume=volume,
                chunk=entry["chunk"])
    res = {}
    for name in ("off", "on"):
        net = build_serving_net(net_name, kw, device=dev)
        w8a8 = False
        if name == "on" and form == "lazy":
            w8a8 = True
        elif name == "on":
            z = make_prep(factor, "acdc", video_t, window, volume)(
                torch.from_numpy(frames).to(dev))[1]
            w8a8 = quantize.calibrate_w8a8(
                net, [z[:entry["chunk"]] if entry["chunk"] else z],
                method="callback")
            del z
        pipe = make_pipeline(net, factor, "acdc", w8a8=w8a8, **mode)
        pipe(torch.from_numpy(frames).to(dev))
        reset_launches()
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            sr = pipe(torch.from_numpy(frames).to(dev))[1].cpu().numpy()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        res[name] = {"frames_per_s": len(frames) / ms * 1e3,
                     "psnr": psnr(sr, frames),
                     "w8a8_launches": quant_launches()["w8a8_conv"] // 2}
        del net, pipe
        torch.cuda.empty_cache()
    res["speed"] = res["on"]["frames_per_s"] / res["off"]["frames_per_s"]
    res["psnr_delta"] = res["on"]["psnr"] - res["off"]["psnr"]
    log(f"  {net_name} W8A8 ({form}) on / off at {entry}: "
        f"{res['on']['frames_per_s']:.1f} / {res['off']['frames_per_s']:.1f}"
        f" frames/s = {res['speed']:.3f}x, PSNR {res['on']['psnr']:.3f} / "
        f"{res['off']['psnr']:.3f} dB, {res['on']['w8a8_launches']} "
        f"w8a8_conv launches a volume [{card}]")
    return res


def phase_preset_table(tmp: Path, card: str, dev, nets: list) -> dict:
    """The preset sweep: for each net ``python -m vsr_tpu_torch.tune`` at
    (300, 192, 192) (Volume4DSRNet with and without ``hoist_tail``), then
    the W8A8 on / off run at the winning knobs."""
    from vsr_tpu_torch import tune

    frames = quality_volume()
    res = {}
    for net_name in nets:
        kwargs, factor, flags, form, grid = TABLE_NETS[net_name]
        t0 = time.perf_counter()
        variants = ([{"hoist_tail": False}, {"hoist_tail": True}]
                    if net_name == "Volume4DSRNet" else [{}])
        rows, best = [], None
        for extra in variants:
            file = tmp / f"tune_{net_name}.json"
            out = tune.main(["--net", net_name, "--net-kwargs",
                             json.dumps(dict(kwargs, **extra)), "--factor",
                             str(factor), "--shape",
                             f"{FULL_SLICES * T_FRAMES},{HR},{HR}",
                             "--chunk-grid", grid, "--repeats", "2",
                             "--out", str(file), *flags])
            bad = [r for r in out["measured"] if "error" in r]
            if bad:  # a table entry rests on the whole sweep or on none
                raise SystemExit(f"tune {net_name} {extra}: rows with an "
                                 f"error {bad}")
            rows += [dict(r, **extra) for r in out["measured"]]
            if best is None or out["best_volumes_per_sec"] > best[0]:
                entry = out["presets"][net_name]
                if extra:
                    entry.setdefault("net_kwargs", {}).update(extra)
                best = (out["best_volumes_per_sec"], entry)
            torch.cuda.empty_cache()
        row = res[net_name] = {"rows": rows, "entry": best[1],
                               "best_volumes_per_sec": best[0]}
        log(f"  tune {net_name}: " + ", ".join(
            f"{ {k: v for k, v in r.items() if k != 'volumes_per_sec'} }"
            f" {r['volumes_per_sec']}" for r in rows)
            + f"; best {best[1]} at {best[0]} volumes/s [{card}]")
        if form:
            row["w8a8"] = table_w8a8(net_name, kwargs, factor, flags, form,
                                     best[1], frames, dev, card)
            row["w8a8"]["form"] = form
        row["seconds"] = time.perf_counter() - t0
    return res


# ================================================ offline tools (phase 17)

# Raw ACDC: 4D NIfTIs of ACDC's in-plane size and 30 frames; 2 slices is the
# depth cut (ACDC has 6-18). Three training patients (an 8:2 split gives
# two to train, one to validate) and one testing patient.
ACDC_RAW_SHAPE = (216, 256, 2, 30)
ACDC_RAW = {"training": ("patient001", "patient002", "patient003"),
            "testing": ("patient101",)}
DISC_RADIUS, DISC_BEAT = 22.0, 6.0  # pixels: the beating disc's radius
# Raw DSB15: single-frame DICOMs, (split, patient, series): (frames,
# explicit VR); the 20-frame series is under preprocessing's 30 and skipped.
DSB15_FRAME = (256, 192)
DSB15_SERIES = {("train", "1", "sax_5"): (30, True),
                ("validate", "2", "sax_7"): (30, False),
                ("train", "1", "sax_6"): (20, True)}
PREPROCESS_EXACT, PREPROCESS_GREY = 0.98, 1.0  # tests/test_preprocess.py
OFFLINE_SAMPLES = 64  # dataset samples decoded natively and in Python
OFFLINE_BUDGET_S = 120.0


def beating_disc(rng: np.random.Generator, shape: tuple,
                 center: tuple[int, int]) -> np.ndarray:
    """(H, W, D, T) int16: a low-passed background per slice with a bright
    disc at ``center`` whose radius beats once over the T frames (largest
    at frame 0, smallest at frame T // 2), so that the ROI finder sees
    motion and the nets have something to learn."""
    h, w, d, t = shape
    ny, nx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    lowpass = np.exp(-(ny ** 2 + nx ** 2) / (2 * 0.03 ** 2))
    yy, xx = np.mgrid[:h, :w]
    dist = np.hypot(yy - center[0], xx - center[1])
    vol = np.empty(shape, np.float64)
    for z in range(d):
        bg = np.fft.ifft2(np.fft.fft2(rng.standard_normal((h, w)))
                          * lowpass).real
        bg = 150 + 120 * bg / np.abs(bg).max()
        for k in range(t):
            r = DISC_RADIUS + DISC_BEAT * np.cos(2 * np.pi * k / t) - 2.0 * z
            vol[..., z, k] = bg + 500 / (1 + np.exp((dist - r) / 1.5))
    return np.clip(np.round(vol), 0, None).astype(np.int16)


def _dicom_element(group: int, elem: int, vr: bytes, value: bytes,
                   explicit: bool) -> bytes:
    if not explicit:
        return struct.pack("<HHI", group, elem, len(value)) + value
    if vr in (b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"):
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def write_dicom(path: Path, pixels: np.ndarray, instance: int,
                explicit: bool) -> None:
    """One single-frame DICOM file (preamble, file meta with the transfer
    syntax, InstanceNumber, geometry, 16-bit unsigned pixels), explicit or
    implicit VR little endian."""
    rows, cols = pixels.shape
    parts = [(0x0020, 0x0013, b"IS", str(instance).encode()),
             (0x0028, 0x0010, b"US", struct.pack("<H", rows)),
             (0x0028, 0x0011, b"US", struct.pack("<H", cols)),
             (0x0028, 0x0030, b"DS", b"1.4\\1.4"),
             (0x0028, 0x0100, b"US", struct.pack("<H", 16)),
             (0x0028, 0x0103, b"US", struct.pack("<H", 0)),
             (0x7FE0, 0x0010, b"OW", pixels.astype("<u2").tobytes())]
    body = b"".join(_dicom_element(*p, explicit) for p in parts)
    syntax = b"1.2.840.10008.1.2.1" if explicit else b"1.2.840.10008.1.2\x00"
    meta = _dicom_element(0x0002, 0x0010, b"UI", syntax, True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\0" * 128 + b"DICM" + meta + body)


def write_raw_trees(root: Path, rng: np.random.Generator) -> dict:
    """The raw ACDC tree (``training/`` and ``testing/``) and the raw DSB15
    DICOM tree (file names shuffled against InstanceNumber); returns each
    ACDC patient's disc centre and each DICOM series' pixels in instance
    order."""
    from concurrent.futures import ThreadPoolExecutor

    from vsr_tpu_torch.io.nifti import save_nifti

    centres, jobs = {}, []
    for split, patients in ACDC_RAW.items():
        for i, patient in enumerate(patients):
            centre = (96 + 10 * i, 118 + 12 * i)
            centres[patient] = centre
            jobs.append((beating_disc(rng, ACDC_RAW_SHAPE, centre),
                         root / "acdc" / split / patient
                         / f"{patient}_4d.nii.gz"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: save_nifti(*job), jobs))
    series = {}
    for (split, patient, sax), (frames, explicit) in DSB15_SERIES.items():
        vol = beating_disc(rng, (*DSB15_FRAME, 1, frames), (120, 90))[:, :, 0]
        pixels = vol.astype(np.uint16)  # (H, W, T)
        series[split, patient, sax] = pixels
        order = rng.permutation(frames)
        for name_i, k in enumerate(order):
            write_dicom(root / "dsb15" / split / patient / "study" / sax
                        / f"IM-{name_i:04d}.dcm", pixels[..., k], int(k) + 1,
                        explicit)
    return {"centres": centres, "series": series}


def start_cli(module: str, *args) -> tuple:
    """``python -m <module> <args>`` started from the checkout's root, its
    log (standard error) to a file; ``finish_cli`` waits for it."""
    root = Path(__file__).resolve().parent
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m", module, *map(str, args)],
                            cwd=root, stdout=subprocess.DEVNULL, stderr=err,
                            text=True)
    return module, proc, err, time.perf_counter()


def finish_cli(handle: tuple) -> tuple[float, str]:
    """The CLI's wall seconds and log; a failed CLI fails the phase."""
    module, proc, err, t0 = handle
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    seconds = time.perf_counter() - t0
    err.seek(0)
    log_text = err.read()
    err.close()
    if proc.returncode:
        raise SystemExit(f"python -m {module} failed ({proc.returncode}):\n"
                         f"{log_text[-3000:]}")
    return seconds, log_text


def logged_timings(stderr: str) -> dict:
    """The ``Timings: {...}`` line a preprocessing CLI logs last."""
    lines = [ln for ln in stderr.splitlines() if "Timings: " in ln]
    if not lines:
        raise SystemExit(f"no Timings line in the CLI's log:\n{stderr[-2000:]}")
    return json.loads(lines[-1].split("Timings: ", 1)[1])


def check_lr_files(tree: Path) -> dict:
    """Every LR file of a processed tree against the numpy backend's
    downscale of its HR sequence, computed in memory (video files at JAX's
    bar between its backends; each frame file equal to its video's frame);
    one job a sequence and factor, on 8 threads (numpy's FFT and zlib
    release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from vsr_tpu_torch.io.nifti import load_nifti
    from vsr_tpu_torch.preprocess.pipeline import (DOWNSCALE_FACTORS,
                                                   downscale_sequence)

    def check(job):
        hr_path, f = job
        split, patient = hr_path.parts[-4], hr_path.parts[-2]
        seq = hr_path.name.split("sequence")[1][:2]
        want = downscale_sequence(load_nifti(hr_path), f, backend="numpy")
        got = load_nifti(tree / "videos" / split / "LR" / f"X{f}" / patient
                         / hr_path.name)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise SystemExit(f"{hr_path.name} x{f}: LR {got.shape} "
                             f"{got.dtype}, want {want.shape} {want.dtype}")
        same = int((got == want).sum())
        grey = float(np.abs(got.astype(np.float64) - want).max())
        if same / got.size < PREPROCESS_EXACT or grey > PREPROCESS_GREY:
            raise SystemExit(f"{split}/{patient} {hr_path.name} x{f}: the "
                             f"torch backend's LR is {same / got.size:.4f} "
                             f"exact, {grey} grey off the numpy backend's")
        frames_dir = tree / "imgs" / split / "LR" / f"X{f}" / patient
        for t in range(got.shape[-1]):
            frame = load_nifti(frames_dir / f"{patient}_2d_slice{seq}_"
                               f"frame{t + 1:02d}.nii.gz")
            if not np.array_equal(frame, got[..., t]):
                raise SystemExit(f"{frames_dir} frame {t + 1} is not its "
                                 "video's frame")
        return same, got.size, grey, 1 + got.shape[-1]

    jobs = [(p, f) for p in sorted(tree.glob("videos/*/HR/*/*.nii.gz"))
            for f in DOWNSCALE_FACTORS]
    with ThreadPoolExecutor(8) as pool:
        rows = list(pool.map(check, jobs))
    same, size = sum(r[0] for r in rows), sum(r[1] for r in rows)
    return {"files": sum(r[3] for r in rows), "exact_share": same / size,
            "worst_file_exact_share": min(r[0] / r[1] for r in rows),
            "max_grey": max(r[2] for r in rows)}


def offline_trees(tmp: Path, card: str, dev) -> dict:
    """17a-17c: the raw trees, the three CLIs, the gates on the trees, a
    numpy-backend run of one patient, the cropping."""
    import pickle

    from vsr_tpu_torch.io.nifti import load_nifti
    from vsr_tpu_torch.preprocess import acdc, cropping, pipeline

    res = {}
    t0 = time.perf_counter()
    raw = write_raw_trees(tmp / "raw", np.random.default_rng(17))
    res["raw_seconds"] = time.perf_counter() - t0
    log(f"  raw trees: ACDC {len(raw['centres'])} patients of "
        f"{ACDC_RAW_SHAPE} int16, DSB15 {len(DSB15_SERIES)} DICOM series of "
        f"{DSB15_FRAME} ({sum(v[0] for v in DSB15_SERIES.values())} files) in "
        f"{res['raw_seconds']:.1f} s")

    log("phase 17b: conversion and preprocessing (the port's CLIs; the "
        "DICOM conversion runs beside the ACDC preprocessing, the DSB15 "
        "preprocessing beside the ACDC tree's gates)")
    device = ["--device", dev.type]
    converted, proc, proc_dsb = (tmp / "dsb15_nifti", tmp / "processed",
                                 tmp / "processed_dsb15")
    acdc_cli = start_cli("vsr_tpu_torch.preprocess.acdc", tmp / "raw" / "acdc",
                         proc, "--backend", "torch", *device)
    res["dicom_seconds"], _ = finish_cli(start_cli(
        "vsr_tpu_torch.io.dicom", tmp / "raw" / "dsb15", converted))
    for (split, patient, sax), pixels in raw["series"].items():
        out = "valid" if split == "validate" else split
        got = load_nifti(converted / out / patient / sax / f"{sax}.nii.gz")
        if got.dtype != np.int16 or not np.array_equal(
                got[:, :, 0], pixels.astype(np.int16)):
            raise SystemExit(f"io.dicom: {split}/{patient}/{sax} converted "
                             f"to {got.shape} {got.dtype}, not the pixels "
                             "written")
    (converted / "test").mkdir(exist_ok=True)  # no DSB15 test series here
    secs, err = finish_cli(acdc_cli)
    res["acdc"] = dict(logged_timings(err), cli_seconds=secs)
    dsb_cli = start_cli("vsr_tpu_torch.preprocess.dsb15", converted, proc_dsb,
                        "--backend", "torch", *device)

    log("phase 17c: gates on the trees, a numpy-backend run, the cropping")
    t0 = time.perf_counter()
    res["lr_check"] = {"acdc": check_lr_files(proc)}
    secs, err = finish_cli(dsb_cli)
    res["dsb15"] = dict(logged_timings(err), cli_seconds=secs)
    hr_dsb = sorted(p.name for p in proc_dsb.glob("videos/*/HR/*/*.nii.gz"))
    if (hr_dsb != ["1_2d+1d_sequence01.nii.gz", "2_2d+1d_sequence01.nii.gz"]
            or any(proc_dsb.rglob("1_2d*sequence02*"))):
        raise SystemExit(f"preprocess.dsb15: HR sequences {hr_dsb}; the "
                         "20-frame series must be skipped")
    res["lr_check"]["dsb15"] = check_lr_files(proc_dsb)
    res["lr_check_seconds"] = time.perf_counter() - t0
    for key in ("acdc", "dsb15"):
        r = res[key]
        log(f"  preprocess.{key} --backend torch: {r['hr_frames']} HR frames "
            f"in {r['wall_seconds']:.2f} s ({r['hr_frames_per_sec']:.1f} HR "
            f"frames/s; {r['cli_seconds']:.2f} s with the process's start), "
            f"{r['downscale_seconds']:.3f} s in the downscale calls "
            f"({r['downscale_seconds'] / r['wall_seconds']:.3f} of the wall "
            f"time), {r['write_wait_seconds']:.2f} s waiting on the NIfTI "
            f"writes ({r['write_wait_seconds'] / r['wall_seconds']:.3f}) "
            f"[{card}]")

    log(f"  every LR file against the numpy backend in memory "
        f"({res['lr_check_seconds']:.2f} s with the DSB15 CLI beside): "
        f"{ {k: (v['files'], round(v['exact_share'], 6), v['max_grey']) for k, v in res['lr_check'].items()} } "
        f"(files, exact share, max grey; bar {PREPROCESS_EXACT} exact, "
        f"{PREPROCESS_GREY} grey)")
    splits = {p.parts[-2]: k for k, v in acdc.split_paths(
        tmp / "raw" / "acdc").items() for p in v}
    patient = "patient001"
    numpy_tree, writer = tmp / "processed_numpy", pipeline.SequenceWriter()
    t0 = time.perf_counter()
    with writer:
        pipeline.process_acdc_volume(
            numpy_tree, splits[patient], patient, load_nifti(
                tmp / "raw" / "acdc" / "training" / patient
                / f"{patient}_4d.nii.gz"),
            pipeline.PreprocessStats(), backend="numpy", writer=writer)
    res["numpy_one_patient"] = writer.timings(time.perf_counter() - t0)
    hr_files = sorted(p.relative_to(numpy_tree) for p in numpy_tree.glob(
        f"*/{splits[patient]}/HR/{patient}/*.nii.gz"))
    differ = [str(p) for p in hr_files
              if (numpy_tree / p).read_bytes() != (proc / p).read_bytes()]
    if len(hr_files) != 2 * (1 + T_FRAMES) or differ:
        raise SystemExit(f"{len(hr_files)} HR files of {patient}; not "
                         f"byte-equal to the numpy backend's: {differ[:4]}")
    r = res["numpy_one_patient"]
    log(f"  numpy backend, {patient} in process: {r['hr_frames']} HR frames "
        f"in {r['wall_seconds']:.2f} s ({r['hr_frames_per_sec']:.1f} HR "
        f"frames/s), {r['downscale_seconds']:.2f} s in the downscale calls "
        f"({r['downscale_seconds'] / r['wall_seconds']:.3f}); its "
        f"{len(hr_files)} HR files byte-equal to the torch run's")

    crop = tmp / "cropped"
    t0 = time.perf_counter()
    for split in ("valid", "test"):
        cropping.main([str(proc / "videos" / split / "HR"), str(crop)])
    res["crop_seconds"] = time.perf_counter() - t0
    with open(crop / "coordinates.pkl", "rb") as f:
        boxes = pickle.load(f)
    want = sorted(p for p, s in splits.items() if s in ("valid", "test"))
    if sorted(boxes) != want:
        raise SystemExit(f"coordinates.pkl holds {sorted(boxes)}, want {want}")
    (_, _, w0_crop, _) = pipeline.center_crop_multiple(ACDC_RAW_SHAPE[:2])
    reach = DISC_RADIUS + DISC_BEAT
    for p, (h0, hn, w0, wn) in boxes.items():
        cy, cx = raw["centres"][p][0], raw["centres"][p][1] - w0_crop
        if not (h0 <= cy - reach and cy + reach <= hn and w0 <= cx - reach
                and cx + reach <= wn):
            raise SystemExit(f"{p}: box {(h0, hn, w0, wn)} does not hold the "
                             f"disc (centre {(cy, cx)}, radius {reach})")
        gifs = list((crop / p).glob("*.gif"))
        if len(gifs) != ACDC_RAW_SHAPE[2]:
            raise SystemExit(f"{p}: {len(gifs)} cropped GIFs")
    res["boxes"] = boxes
    log(f"  cropping (valid, then test, merged): {boxes} in "
        f"{res['crop_seconds']:.2f} s")
    res["tree"], res["cropped"], res["splits"] = proc, crop, splits
    return res


def offline_decode(tree: Path, card: str) -> dict:
    """Decode ms per file, native against Python, on the processed videos
    (files just written: a warm read)."""
    from vsr_tpu_torch.io import native
    from vsr_tpu_torch.io.nifti import load_nifti

    paths = sorted(tree.glob("videos/**/*.nii.gz"))
    t0 = time.perf_counter()
    native.load_nifti_native(paths[0])  # builds the library at first use
    res = {"files": len(paths), "build_seconds": time.perf_counter() - t0}
    log(f"  {native.SOURCE.relative_to(Path(__file__).resolve().parent)} "
        f"-> {native.library_path().name} built and loaded in "
        f"{res['build_seconds']:.2f} s")
    for name, fn in (("python", load_nifti),
                     ("native", native.load_nifti_native)):
        t0 = time.perf_counter()
        for p in paths:
            fn(p)
        res[f"{name}_ms_per_file"] = (time.perf_counter() - t0) * 1e3 / len(paths)
    t0 = time.perf_counter()
    native.load_nifti_batch(paths, n_threads=8)
    res["native_batch_ms_per_file"] = (time.perf_counter() - t0) * 1e3 / len(paths)
    log(f"  decode of {len(paths)} video files (warm): Python "
        f"{res['python_ms_per_file']:.2f} ms a file, native "
        f"{res['native_ms_per_file']:.2f}, native batch of 8 threads "
        f"{res['native_batch_ms_per_file']:.2f} [{card}]")
    return res


def offline_test_config(tree: Path, run: Path, crop: Path, tmp: Path) -> Path:
    """``configs/test/acdc_vsr_drf_x2.yaml`` with its data, checkpoint and
    both ``coordinates_path`` entries pointed at this phase's files."""
    from vsr_tpu_torch.config import load_config, save_config

    root = Path(__file__).resolve().parent
    cfg = load_config(root / "configs" / "test" / "acdc_vsr_drf_x2.yaml")
    out = run / "predictions"
    cfg.main.saved_dir = str(out)
    cfg.main.loaded_path = str(run / "checkpoints" / "model_best.ckpt")
    cfg.dataset.kwargs.data_dir = str(tree / "videos")
    cfg.net.kwargs.update(fused_squeeze=True)
    for spec in cfg.metrics:
        if "coordinates_path" in (spec.get("kwargs") or {}):
            spec.kwargs.coordinates_path = str(crop / "coordinates.pkl")
    cfg.predictor.kwargs.saved_dir = str(out)
    path = tmp / "offline_test.yaml"
    save_config(cfg, path)
    return path


def offline_training(tmp: Path, trees: dict, card: str) -> dict:
    """17d-17e: DRFNet trained on the processed tree with ``native_decode``,
    ``async_ckpt`` and ``profile_dir``, then ``main --test`` on it."""
    import copy
    import csv

    from vsr_tpu_torch import main as port_main
    from vsr_tpu_torch.registry import build
    from vsr_tpu_torch.runner.trainers import BaseTrainer
    from vsr_tpu_torch.utils import profiling
    from vsr_tpu_torch.utils.checkpoint import load_checkpoint

    tree, res = trees["tree"], {}
    res["decode"] = offline_decode(tree, card)
    run, trace_dir = tmp / "offline_run", tmp / "offline_trace"
    cfg = training_config("acdc_vsr_drf_x2", tree, run,
                          {"fused_squeeze": True}, tmp)
    cfg.dataset.kwargs.native_decode = True
    cfg.trainer.kwargs.update(async_ckpt=True, profile_dir=str(trace_dir))

    t0 = time.perf_counter()
    on = build("dataset", cfg.dataset, type="train")
    spec = copy.deepcopy(cfg.dataset)
    spec.kwargs.native_decode = False
    off = build("dataset", spec, type="train")
    n = min(OFFLINE_SAMPLES, len(on))
    for i in range(n):
        a = on.__getitem__(i, rng=np.random.default_rng(i))
        b = off.__getitem__(i, rng=np.random.default_rng(i))
        if any(not np.array_equal(a[k], b[k]) for k in b):
            raise SystemExit(f"native_decode: sample {i} differs")
    res["samples_bit_equal"] = n
    log(f"  the first {n} training samples bit-equal with native_decode on "
        f"and off ({time.perf_counter() - t0:.2f} s)")

    seen, run_epoch = [], BaseTrainer._run_epoch

    def spy(trainer, mode, epoch):
        if mode == "validation":  # what the trace directory holds by now
            seen.append(sorted(p.name for p in trace_dir.glob("*"))
                        if trace_dir.exists() else [])
        return run_epoch(trainer, mode, epoch)

    BaseTrainer._run_epoch = spy
    try:
        trained = train_run("offline drf", cfg, card, TRAIN_T, True)
    finally:
        BaseTrainer._run_epoch = run_epoch
    stats, trainer = trained["stats"], trained["trainer"]
    res["train"] = stats
    if len(seen) != TRAIN_EPOCHS or seen[0] or len(seen[1]) != 1:
        raise SystemExit(f"profile_dir: the trace directory held {seen} at "
                         "the validation of epochs 1 and 2 (want nothing, "
                         "then one trace)")
    trace_file = trace_dir / seen[1][0]
    kernels = profiling.kernel_events(trace_file)
    k1_events = sum("concat_conv1x1_kernel" in e["name"] for e in kernels)
    res["trace"] = {"bytes": trace_file.stat().st_size,
                    "kernel_events": len(kernels), "k1_events": k1_events}
    if not k1_events:
        raise SystemExit(f"the epoch-2 trace names no K1 kernel "
                         f"({len(kernels)} kernel events)")
    log(f"  profile_dir: a trace after epoch 2 only, "
        f"{res['trace']['bytes'] / 1e6:.1f} MB, {len(kernels)} kernel "
        f"events, {k1_events} of K1's concat_conv1x1_kernel")

    # The loop's block in an async save (the snapshot) against a sync one,
    # then the last async checkpoint against the sync file of the same state.
    writer = trainer._ckpt_writer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save(tmp / "offline_async_probe.ckpt")
    async_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    trainer.wait_for_checkpoints()
    drain_ms = (time.perf_counter() - t0) * 1e3
    trainer._ckpt_writer = None
    t0 = time.perf_counter()
    trainer.save(tmp / "offline_sync.ckpt")
    sync_ms = (time.perf_counter() - t0) * 1e3
    trainer._ckpt_writer = writer
    res["save"] = {"async_block_ms": async_ms, "async_drain_ms": drain_ms,
                   "sync_ms": sync_ms}
    sync, _ = load_checkpoint(tmp / "offline_sync.ckpt")
    compared = []
    for name in (f"model_{TRAIN_EPOCHS}.ckpt", "model_best.ckpt"):
        state, aux = load_checkpoint(run / "checkpoints" / name)
        if aux["epoch"] != TRAIN_EPOCHS:
            continue
        pairs = [*((k, v, sync["net"][k]) for k, v in state["net"].items()),
                 *((f"{i}.{k}", torch.as_tensor(v), torch.as_tensor(
                     sync["optimizer"]["state"][i][k]))
                   for i, st in state["optimizer"]["state"].items()
                   for k, v in st.items())]
        bad = [k for k, a, b in pairs if not torch.equal(a, b)]
        if bad or state["optimizer"]["param_groups"] != sync["optimizer"][
                "param_groups"]:
            raise SystemExit(f"async {name} differs from a sync save of the "
                             f"same state: {bad[:5]}")
        compared.append(name)
    res["save"]["compared"] = compared
    log(f"  async_ckpt: {compared} written by the writer equal a sync save "
        f"tensor for tensor; the loop blocks {async_ms:.2f} ms in an async "
        f"save (the write then takes {drain_ms:.1f} ms on its thread) "
        f"against {sync_ms:.1f} ms in a sync one [{card}]")

    log("phase 17e: main --test on the processed test split")
    path = offline_test_config(tree, run, trees["cropped"], tmp)
    frames = ACDC_RAW_SHAPE[2] * ACDC_RAW_SHAPE[3] * len(ACDC_RAW["testing"])
    want = SQUEEZES_PER_STEP * frames
    reset_launches()
    t0 = time.perf_counter()
    port_main.main([str(path), "--test"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_launches("offline main --test", "concat_conv1x1", want)
    with open(run / "predictions" / "results.csv", newline="") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    cols = [header.index(c) for c in ("CardiacPSNR", "CardiacSSIM")]
    values = np.array([[float(r[c]) for c in cols] for r in rows])
    patients = {r[0].split("_")[0] for r in rows}
    if (len(rows) != frames or patients != set(ACDC_RAW["testing"])
            or not np.isfinite(values).all()):
        raise SystemExit(f"offline main --test: {len(rows)} rows of "
                         f"{patients}, finite Cardiac* "
                         f"{bool(np.isfinite(values).all())}")
    res["test"] = {"seconds": seconds, "frames": len(rows),
                   "launches": want, "cardiac_psnr": float(values[:, 0].mean()),
                   "cardiac_ssim": float(values[:, 1].mean())}
    log(f"  main --test: {len(rows)} rows of {sorted(patients)} in "
        f"{seconds:.2f} s, CardiacPSNR {res['test']['cardiac_psnr']:.4f} dB, "
        f"CardiacSSIM {res['test']['cardiac_ssim']:.4f}, K1 launches {want} "
        f"[{card}]")
    return res


def phase_offline(tmp: Path, card: str, dev) -> dict:
    """Phase 17: the offline tools to a tested checkpoint."""
    t0 = time.perf_counter()
    tmp.mkdir(parents=True, exist_ok=True)
    log("phase 17a: raw ACDC NIfTIs and raw DSB15 DICOMs")
    trees = offline_trees(tmp, card, dev)
    log("phase 17d: DRFNet F=64 G=6 x2 trained on the processed tree "
        "(native_decode, async_ckpt, profile_dir; K1 forward and backward)")
    res = offline_training(tmp, trees, card)
    res.update({k: v for k, v in trees.items()
                if k not in ("tree", "cropped", "splits")})
    res["boxes"] = {k: list(v) for k, v in res["boxes"].items()}
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 17 took {res['seconds']:.1f} s (budget {OFFLINE_BUDGET_S:.0f}"
        f" s) [{card}]")
    return res


def offline_summary(off: dict) -> dict:
    return {"seconds": off["seconds"],
            "hr_frames_per_sec": {"torch": off["acdc"]["hr_frames_per_sec"],
                                  "numpy": off["numpy_one_patient"][
                                      "hr_frames_per_sec"]},
            "lr_exact_share": {k: v["exact_share"]
                               for k, v in off["lr_check"].items()},
            "decode_ms_per_file": {k: off["decode"][f"{k}_ms_per_file"]
                                   for k in ("python", "native")},
            "save_ms": off["save"],
            "trace_bytes": off["trace"]["bytes"],
            "k1_launches": {"train": off["train"]["launches"],
                            "backward": off["train"]["backward_launches"],
                            "test": off["test"]["launches"]}}


# --- phase 18: data-parallel training ----------------------------------------

PAR_STEPS_DEVICE = 40   # (c): 3 eager steps, 1 capture, 37 replays
PAR_LOSS_TOL = 1e-4     # a step's loss, a mesh of one rank vs no mesh
PAR_PARAM_SHARE = 1e-3  # (b) vs (a): of each leaf's largest entry
PAR_VOLUME = (96, 96, 1, 10)  # the volume served in 18a
PAR_MODES = {"ddp": {}, "zero": {"zero_optim": True}, "fsdp": {"fsdp": True}}


def par_drf_config(tmp: Path, name: str, **trainer_kwargs) -> Path:
    """``acdc_vsr_drf_x2.yaml`` on phase 7's tree, through K1, one epoch:
    ``host_shard`` and ``drop_last`` give every world the same 7 global
    batches of 16; written to a file as a user's config is."""
    from vsr_tpu_torch.config import save_config

    cfg = training_config("acdc_vsr_drf_x2", tmp / "tree", tmp / name,
                          {"fused_squeeze": True}, tmp)
    cfg.trainer.kwargs.num_epochs = cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs.update(trainer_kwargs)
    world = trainer_kwargs.get("mesh_axes", {}).get("data", 1)
    cfg.dataloader.kwargs.update(
        train_batch_size=TRAIN_N // world, host_shard=True, drop_last=True)
    path = tmp / f"{name}.yaml"
    save_config(cfg, path)
    return path


def par_device_config(tmp: Path, name: str, **trainer_kwargs) -> Path:
    from vsr_tpu_torch.config import save_config

    cfg = device_config("acdc_sisr_edsr_x2_device", tmp / "tree", tmp / name,
                        tmp, steps_per_epoch=PAR_STEPS_DEVICE,
                        **trainer_kwargs)
    path = tmp / f"{name}.yaml"
    save_config(cfg, path)
    return path


def par_train(config: str, device_epoch: bool) -> dict:
    """One ``vsr_tpu_torch.main`` run of a config (a rank joins through
    ``main.distributed`` first when the ``VSR_*`` variables say so),
    probed: the per-step losses and step ms (CUDA events; a device epoch:
    its logged losses and the replayed step), K1's counters, this rank's
    backend and device, and the all-reduce calls made inside a CUDA graph
    capture."""
    import torch.distributed as dist

    from vsr_tpu_torch import main as port_main
    from vsr_tpu_torch.parallel import distributed

    reset_launches()
    in_capture, all_reduce = [0], dist.all_reduce

    def counted(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            in_capture[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        if device_epoch:
            with EpochClock() as clock:
                port_main.main([config])
            res = {"losses": torch.cat([g[:, 0] for g in clock.logs]).tolist(),
                   "replay_ms": clock.replay_ms(),
                   "replays": len(clock.replay_events)}
        else:
            with StepProbe() as probe:
                port_main.main([config])
            res = {"losses": torch.stack(probe.losses).tolist(),
                   "step_ms": probe.step_ms()}
    finally:
        dist.all_reduce = all_reduce
    torch.cuda.synchronize()
    fwd, dx, dw = k1_calls()
    res.update(k1={"forward": fwd, "dx": dx, "dw": dw},
               all_reduce_in_capture=in_capture[0],
               backend=distributed.backend(),
               device=str(distributed.rank_device("cuda")),
               rank=distributed.process_index(),
               world=distributed.process_count())
    return res


def rank_run(spec_path: str) -> int:
    """A process of phase 18 (``--rank-run``): each of its stages joins a
    group through the stage's ``VSR_*`` variables (at the first run's
    ``main``), runs the stage's runs and leaves the group; the results go
    into the spec's ``out``. A fatal signal prints the Python stack."""
    import faulthandler
    import os

    import torch.distributed as dist

    faulthandler.enable()
    spec = json.loads(Path(spec_path).read_text())
    results = []
    for stage in spec["stages"]:
        os.environ.update(stage["env"])
        results.append([par_train(r["config"], r["device_epoch"])
                        for r in stage["runs"]])
        dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(results))
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def identity(port: int, world: int, rank: int) -> dict:
    """The ``VSR_*`` variables of a rank of a group on ``port``."""
    return {"VSR_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "VSR_NUM_PROCESSES": str(world), "VSR_PROCESS_ID": str(rank)}


def par_processes(tmp: Path, stages: list) -> list:
    """One process of this script on the card for each list of stages
    (``{"env": the VSR_* variables, "runs": [...]}``), all started
    together (a rank waits in its group's rendezvous for its peers); every
    process must exit 0. Returns each process's results, by stage."""
    procs = []
    for i, own in enumerate(stages):
        spec = tmp / f"par_process{i}.json"
        spec.write_text(json.dumps({"stages": own,
                                    "out": str(tmp / f"par_process{i}.out")}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-run",
             str(spec)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:  # a process that failed leaves its peers waiting
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for i, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode:
            raise SystemExit(f"phase 18: process {i} exited "
                             f"{proc.returncode}:\n{out[-6000:]}")
    return [json.loads((tmp / f"par_process{i}.out").read_text())
            for i in range(len(stages))]


def par_expected_k1(steps: int, valid_frames: int) -> dict:
    """K1's calls in one DRF epoch: 12 squeezes a frame step, 5 frame steps
    a train sample batch (forward, dx, dW / db), 12 a validation frame."""
    per_step = SQUEEZES_PER_STEP * TRAIN_T * steps
    return {"forward": per_step + SQUEEZES_PER_STEP * valid_frames,
            "dx": per_step, "dw": per_step}


def par_check_losses(what: str, got: list, want: list) -> float:
    if len(got) != len(want):
        raise SystemExit(f"{what}: {len(got)} steps, the run without a mesh "
                         f"{len(want)}")
    diff = max(abs(a - b) for a, b in zip(got, want))
    if diff > PAR_LOSS_TOL:
        raise SystemExit(f"{what}: a step's loss differs by {diff:.3g} from "
                         f"the run without a mesh (> {PAR_LOSS_TOL})")
    return diff


def par_serve(tmp: Path, name: str, checkpoint: Path, src: Path) -> np.ndarray:
    """``infer --checkpoint`` on phase 18's volume, DRFNet through K1."""
    from vsr_tpu_torch import infer
    from vsr_tpu_torch.io.nifti import load_nifti

    reset_launches()
    infer.main([str(src), str(tmp / name), "--video", "--fused-tail",
                "--net", "DRFNet", "--net-kwargs",
                json.dumps(dict(DRF_KWARGS, fused_squeeze=True)),
                "--checkpoint", str(checkpoint)])
    check_launches(f"18a infer {name}", "concat_conv1x1",
                   SQUEEZES_PER_STEP * PAR_VOLUME[3])
    sr = load_nifti(tmp / name / "patient000" / "patient000_4d_sr.nii.gz")
    check_sr(f"18a infer {name}", sr, PAR_VOLUME)
    return sr


def flax_variables(net, seed: int) -> dict:
    """A flax variables tree (``{"params": ...}``) of ``net``'s structure
    (``interop``'s slot table), drawn from ``seed``: kernels uniform over
    +-1/sqrt(fan-in), every other leaf over +-0.1."""
    from vsr_tpu_torch.interop import _KERNEL_LAYOUTS, module_slots

    rng, tree = np.random.default_rng(seed), {}
    for path, tensor, transform in module_slots(net):
        shape = tuple(tensor.shape)
        if transform in _KERNEL_LAYOUTS:
            shape = _KERNEL_LAYOUTS[transform][1](shape)
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            value = rng.uniform(-bound, bound, shape)
        else:
            value = rng.uniform(-0.1, 0.1, shape)
        cursor = tree
        for part in path[:-1]:
            cursor = cursor.setdefault(part, {})
        cursor[path[-1]] = value.astype(np.float32)
    return tree


def par_checkpoints(tmp: Path, run_a: Path, card: str, dev) -> dict:
    """18a's files: the sharded checkpoint consolidated and both served;
    the sharded-v1 layout of ``vsr_tpu`` written by the port and served
    directly against the plain flax file."""
    from vsr_tpu_torch import convert
    from vsr_tpu_torch.io.nifti import save_nifti
    from vsr_tpu_torch.registry import build
    from vsr_tpu_torch.utils import checkpoint, msgpack

    main_file = run_a / "checkpoints" / "model_1.ckpt"
    shards = sorted(p.name for p in main_file.parent.glob("model_1.ckpt*"))
    if shards != ["model_1.ckpt", "model_1.ckpt.shard0"] or not (
            checkpoint.is_sharded_checkpoint(main_file)):
        raise SystemExit(f"18a: sharded_ckpt wrote {shards}")
    whole = tmp / "par_consolidated.ckpt"
    convert.main(["--consolidate", str(main_file), str(whole)])
    src = tmp / "par_volume"
    save_nifti(np.round(np.random.default_rng(18).random(PAR_VOLUME) * 255)
               .astype(np.float32), src / "patient000" / "patient000_4d.nii")
    sharded_sr = par_serve(tmp, "par_sr_sharded", main_file, src)
    whole_sr = par_serve(tmp, "par_sr_whole", whole, src)
    exact, grey = agreement(sharded_sr, whole_sr)
    if grey > 1:
        raise SystemExit(f"18a: the sharded main file and its consolidation "
                         f"serve volumes {grey} grey apart")
    res = {"files": shards, "served_exact_fraction": exact,
           "served_max_grey": grey}
    log(f"  18a: sharded_ckpt wrote {shards}; convert --consolidate; infer "
        f"--checkpoint on both: {exact * 100:.4f}% exact, max {grey:g} grey, "
        f"K1 {SQUEEZES_PER_STEP * PAR_VOLUME[3]} launches a volume each "
        f"[{card}]")

    net = build("net", {"name": "DRFNet", "kwargs": DRF_KWARGS}, device="cpu",
                generator=torch.Generator().manual_seed(0))
    variables = flax_variables(net, 18)  # {"params": {...}}
    flat = checkpoint._flatten_flax({"params": variables})
    blocks = {k: 2 for k, v in flat.items()
              if np.ndim(v) >= 2 and v.shape[-1] % 2 == 0}
    v1 = tmp / "par_flax" / "model_1.ckpt"
    for process in (0, 1):
        checkpoint.save_flax_checkpoint_sharded(
            v1, {"params": variables}, {"epoch": 1}, blocks,
            process=process, num_processes=2)
    plain = tmp / "par_flax_plain.ckpt"
    plain.write_bytes(msgpack.serialize({"state": {"params": variables},
                                         "aux": {"epoch": 1}}))
    v1_sr = par_serve(tmp, "par_sr_flax_sharded", v1, src)
    plain_sr = par_serve(tmp, "par_sr_flax_plain", plain, src)
    exact, grey = agreement(v1_sr, plain_sr)
    if grey > 1:
        raise SystemExit(f"18a: the sharded-v1 file and the plain flax file "
                         f"serve volumes {grey} grey apart")
    res.update(flax_sharded_leaves=len(blocks), flax_exact_fraction=exact,
               flax_max_grey=grey)
    log(f"  18a: a seeded DRFNet's flax variables in vsr_tpu's sharded-v1 "
        f"layout of 2 processes ({len(blocks)} leaves in 2 blocks), written "
        f"by the port: infer --checkpoint on its main file vs the plain flax "
        f"file: {exact * 100:.4f}% exact, max {grey:g} grey [{card}]")
    return res


def par_params_close(what: str, got: dict, want: dict) -> float:
    """The largest difference of a leaf over its own largest entry."""
    worst = 0.0
    for key, ref in want.items():
        scale = float(ref.abs().max()) or 1.0
        worst = max(worst, float((got[key].float() - ref.float()).abs().max())
                    / scale)
    if worst > PAR_PARAM_SHARE:
        raise SystemExit(f"{what}: parameters {worst:.3g} of a leaf's largest "
                         f"entry from run (a)'s (> {PAR_PARAM_SHARE})")
    return worst


def phase_parallel(tmp: Path, card: str, dev) -> dict:
    """Phase 18: data-parallel training (the docstring's item 18)."""
    from vsr_tpu_torch.utils import checkpoint

    res = {}
    t0 = time.perf_counter()
    steps = (TREE_SEQUENCES["train"][0] * TREE_SEQUENCES["train"][1]
             * T_FRAMES) // TRAIN_N
    log("phase 18a: DRFNet x2 (F=64, G=6, K1), the run without a mesh in "
        "this process, then one rank over NCCL with mesh_axes {data: 1} "
        "and sharded_ckpt, with the EDSR device config (18c)")
    base = par_train(str(par_drf_config(tmp, "par_base")), False)
    base_dev = par_train(str(par_device_config(tmp, "par_base_dev")), True)
    mesh1 = {"mesh_axes": {"data": 1}}
    one = [{"config": str(par_drf_config(tmp, "par_a", sharded_ckpt=True,
                                         **mesh1)), "device_epoch": False},
           {"config": str(par_device_config(tmp, "par_c", **mesh1)),
            "device_epoch": True}]
    two = [{"config": str(par_drf_config(tmp, f"par_b_{mode}",
                                         mesh_axes={"data": 2}, **kw)),
            "device_epoch": False} for mode, kw in PAR_MODES.items()]
    # Process 0 runs (a) and (c) as the one rank of an NCCL group, then
    # rank 0 of (b)'s gloo group; process 1, rank 1 of (b), waits in that
    # group's rendezvous meanwhile (one start-up fewer).
    port_one, port_two = free_port(), free_port()
    procs = par_processes(tmp, [
        [{"env": identity(port_one, 1, 0), "runs": one},
         {"env": identity(port_two, 2, 0), "runs": two}],
        [{"env": identity(port_two, 2, 1), "runs": two}]])
    (a, c), ranks = procs[0][0], [procs[0][1], procs[1][0]]
    valid_frames = TREE_SEQUENCES["valid"][0] * TREE_SEQUENCES["valid"][1] \
        * T_FRAMES
    want = par_expected_k1(steps, valid_frames)
    for what, run in (("18a without a mesh", base), ("18a DDP", a)):
        if run["k1"] != want:
            raise SystemExit(f"{what}: K1 calls {run['k1']}, expected {want}")
    if (a["backend"], a["device"], a["world"]) != ("nccl", "cuda:0", 1):
        raise SystemExit(f"18a: rank 0 on {a['backend']} / {a['device']} "
                         f"in a world of {a['world']}")
    diff = par_check_losses("18a", a["losses"], base["losses"])
    ms = {k: statistics.median(r["step_ms"][1:]) for k, r in
          (("ddp", a), ("no_mesh", base))}
    res["a"] = {"steps": len(a["losses"]), "max_loss_diff": diff,
                "losses": a["losses"], "k1_launches": a["k1"],
                "step_ms": ms["ddp"], "no_mesh_step_ms": ms["no_mesh"],
                "backend": a["backend"], "device": a["device"]}
    log(f"  rank 0: backend {a['backend']}, device {a['device']}, world "
        f"{a['world']}")
    log(f"  18a: {len(a['losses'])} steps, every step's loss within "
        f"{diff:.3g} of the run without a mesh; K1 under DDP: forward "
        f"{a['k1']['forward']}, dx {a['k1']['dx']}, dW / db {a['k1']['dw']}; "
        f"median step {ms['ddp']:.2f} ms with DDP, {ms['no_mesh']:.2f} ms "
        f"without [{card}]")
    res["a"].update(par_checkpoints(tmp, tmp / "par_a", card, dev))

    log("phase 18c: acdc_sisr_edsr_x2_device.yaml (bf16) with mesh_axes "
        "{data: 1} over NCCL")
    if (c["backend"], c["all_reduce_in_capture"]) != ("nccl", 1) or (
            c["replays"] != PAR_STEPS_DEVICE - 3):
        raise SystemExit(f"18c: backend {c['backend']}, "
                         f"{c['all_reduce_in_capture']} all-reduce calls "
                         f"inside the capture, {c['replays']} replays")
    diff_c = par_check_losses("18c", c["losses"], base_dev["losses"])
    res["c"] = {"replay_ms": c["replay_ms"],
                "no_mesh_replay_ms": base_dev["replay_ms"],
                "all_reduce_in_capture": c["all_reduce_in_capture"],
                "max_loss_diff": diff_c, "steps": len(c["losses"])}
    log(f"  18c: the gradients' all-reduce captured in the graph "
        f"({c['all_reduce_in_capture']} call inside the capture), "
        f"{c['replays']} replays, losses within {diff_c:.3g} of the run "
        f"without a mesh; replayed step {c['replay_ms']:.3f} ms with the "
        f"NCCL all-reduce, {base_dev['replay_ms']:.3f} ms without a mesh "
        f"[{card}]")

    log("phase 18b: two ranks sharing the card over gloo, CUDA tensors: "
        "data: 2, then zero_optim, then fsdp")
    want_state = checkpoint.read_port_checkpoint(
        tmp / "par_a" / "checkpoints" / "model_1.ckpt")[0]["net"]
    want_rank = par_expected_k1(steps, valid_frames // 2)
    res["b"] = {}
    for i, mode in enumerate(PAR_MODES):
        r0, r1 = ranks[0][i], ranks[1][i]
        for r in (r0, r1):
            log(f"  {mode} rank {r['rank']}: backend {r['backend']}, device "
                f"{r['device']}, world {r['world']}, K1 {r['k1']}")
            if (r["backend"], r["device"], r["world"]) != ("gloo", "cuda:0",
                                                           2):
                raise SystemExit(f"18b {mode}: rank {r['rank']} on "
                                 f"{r['backend']} / {r['device']}")
            if r["k1"] != want_rank:
                raise SystemExit(f"18b {mode}: rank {r['rank']} K1 calls "
                                 f"{r['k1']}, expected {want_rank}")
        # The global batch's loss: the mean of the ranks' halves.
        losses = [(x + y) / 2 for x, y in zip(r0["losses"], r1["losses"])]
        state = checkpoint.read_port_checkpoint(
            tmp / f"par_b_{mode}" / "checkpoints" / "model_1.ckpt")[0]["net"]
        worst = par_params_close(f"18b {mode}", state, want_state)
        loss_diff = max(abs(x - y) for x, y in zip(losses, a["losses"]))
        res["b"][mode] = {"param_share": worst, "max_loss_diff": loss_diff,
                          "step_ms": statistics.median(r0["step_ms"][1:]),
                          "k1_launches_per_rank": r0["k1"],
                          "backends": [r0["backend"], r1["backend"]],
                          "devices": [r0["device"], r1["device"]]}
        log(f"  18b {mode}: parameters within {worst:.3g} of a leaf's "
            f"largest entry of run (a)'s, the global batch's loss within "
            f"{loss_diff:.3g}, median step {res['b'][mode]['step_ms']:.2f} ms "
            f"(two ranks on one card over gloo) [{card}]")
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 18 took {res['seconds']:.1f} s [{card}]")
    return res


def parallel_summary(par: dict) -> dict:
    return {"seconds": par["seconds"],
            "a": {k: par["a"][k] for k in (
                "steps", "max_loss_diff", "k1_launches", "step_ms",
                "no_mesh_step_ms", "served_max_grey", "flax_max_grey")},
            "b": {m: {k: v[k] for k in ("param_share", "backends", "devices")}
                  for m, v in par["b"].items()},
            "c": par["c"]}


# --- phase 19: --mesh serving, the model and expert axes ---------------------

MESH_STEPS = 4            # (c): train steps of 16, with a mesh and without
MESH_LOSS_TOL = 1e-4      # (c): a step's loss, mesh vs no mesh
MESH_PARAM_SHARE = 1e-3   # (c): parameters, of each leaf's largest entry,
# or within the JAX mesh tests' own bar (tests/test_expert_parallel.py:
# rtol 5e-4, atol 1e-5): a zero-initialized expert bias moves by Adam's
# +-lr steps only, its largest entry is lr x steps (4e-4), and a gradient
# near Adam's eps moves its step by float noise (7e-7 on the card).
MESH_PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
MESH_REQUESTS = 2         # (d): requests the daemon answers
MESH_CALLS = 2            # pipeline calls a run: the first pays the start-up
MOE_MESH_KWARGS = dict(MOE_KWARGS, router_impl="rank_pallas",
                       dispatch_impl="sparse")
DRF_MESH_KWARGS = dict(DRF_KWARGS, fused_squeeze=True)


def torchrun_env(port: int, world: int, rank: int) -> dict:
    """The variables ``torchrun`` gives a rank of a group of ``world``
    ranks on this host (``parallel/distributed.initialize`` reads them)."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


class KernelShapes:
    """Records the output width F of every K1 call of the nets and the
    experts of every K3 call of the MoE layers, inside the block."""

    def __enter__(self):
        from vsr_tpu_torch.models import common, moe

        self.k1_f, self.k3_experts = set(), set()
        self._saved = (common.concat_conv1x1, moe.pairwise_rank)
        k1, k3 = self._saved

        def k1_call(xs, w, *args, **kwargs):
            self.k1_f.add(int(w.shape[0]))
            return k1(xs, w, *args, **kwargs)

        def k3_call(af):
            self.k3_experts.add(int(af.shape[1]))
            return k3(af)

        common.concat_conv1x1, moe.pairwise_rank = k1_call, k3_call
        return self

    def __exit__(self, *exc):
        from vsr_tpu_torch.models import common, moe

        common.concat_conv1x1, moe.pairwise_rank = self._saved
        return False


def launches() -> dict:
    """Every kernel's launches since ``reset_launches`` (K1's ``dx``
    launches apart)."""
    counts = {k: fn.launches for k, fn in kernel_counters().items()}
    counts["concat_conv1x1_dx"] = kernel_counters()[
        "concat_conv1x1"].backward_launches
    return counts


def mesh_of(spec: str):
    """``--mesh``'s mesh over this process's group (joined through
    ``torchrun``'s variables), or ``None`` for an empty spec."""
    if not spec:
        return None
    from vsr_tpu_torch.parallel import distributed
    from vsr_tpu_torch.parallel.mesh import make_mesh
    from vsr_tpu_torch.parallel.serving import parse_mesh_axes

    distributed.initialize(device="cuda")
    return make_mesh(parse_mesh_axes(spec))


def mesh_pipeline(net: str, frames_path: str, mesh: str = "",
                  out: str = "") -> dict:
    """``infer.make_pipeline`` of the CLI's seeded net over ``mesh``,
    called ``MESH_CALLS`` times on the frames: each call's ms (host clock,
    the card synchronized) and launches, the widths the kernels saw; the
    first call's SR frames saved to ``out`` by rank 0."""
    from vsr_tpu_torch.infer import build_serving_net, make_pipeline
    from vsr_tpu_torch.parallel import distributed

    drf = net == "DRFNet"
    grid = mesh_of(mesh)
    dev = distributed.rank_device("cuda")
    kwargs = dict(DRF_MESH_KWARGS, fused_tail=True) if drf else \
        MOE_MESH_KWARGS
    pipe = make_pipeline(build_serving_net(net, kwargs, device=dev), FACTOR,
                         "acdc", video_t=T_FRAMES if drf else 0, mesh=grid)
    frames = torch.from_numpy(np.load(frames_path)).to(dev)
    res = {"ms": [], "launches": []}
    with KernelShapes() as shapes:
        for call in range(MESH_CALLS):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            sr = pipe(frames)[1].cpu().numpy()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["launches"].append(launches())
            if call == 0 and out and distributed.is_primary():
                np.save(out, sr)
    res.update(k1_f=sorted(shapes.k1_f), k3_experts=sorted(shapes.k3_experts))
    return res


def mesh_infer(argv: list) -> dict:
    """``vsr_tpu_torch.infer.main`` on this rank: its kernel launches and
    the widths the kernels saw."""
    from vsr_tpu_torch import infer

    torch.cuda.synchronize()
    reset_launches()
    with KernelShapes() as shapes:
        infer.main(argv)
    torch.cuda.synchronize()
    return {"launches": launches(), "k1_f": sorted(shapes.k1_f),
            "k3_experts": sorted(shapes.k3_experts)}


def mesh_train(config: str, steps: int, out: str) -> dict:
    """``run_train`` of a config for ``steps`` train steps (its loop cut
    there): each step's loss and CUDA-event ms, the kernels' launches, each
    parameter's and Adam moment's shape on this rank, and the net's state
    (gathered under a mesh, a collective) saved by rank 0 to ``out``."""
    from vsr_tpu_torch.config import load_config
    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.parallel import distributed
    from vsr_tpu_torch.runner.trainers import BaseTrainer

    losses, ms = [], []

    def few_steps(trainer):
        batches = trainer._device_batches(
            trainer.train_dataloader.epoch(trainer.rng_tree, 1))
        for _, (_, inputs, targets) in zip(range(steps), batches):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            scalars, _ = trainer._train_step(inputs, targets)
            end.record()
            losses.append(scalars[0])
            ms.append((start, end))

    torch.cuda.synchronize()
    reset_launches()
    train = BaseTrainer.train
    BaseTrainer.train = few_steps
    try:
        with KernelShapes() as shapes:
            trainer = run_train(load_config(config))
    finally:
        BaseTrainer.train = train
    torch.cuda.synchronize()
    state = (trainer._dp.full_state(trainer)["net"] if trainer._dp
             is not None else trainer.net.state_dict())
    if distributed.is_primary():
        torch.save({k: v.detach().cpu() for k, v in state.items()}, out)
    names = [n for n, _ in trainer.net.named_parameters()]
    moments = {names[i]: sorted({tuple(v.shape) for v in st.values()
                                 if torch.is_tensor(v) and v.dim()})
               for i, st in trainer.optimizer.state_dict()["state"].items()}
    return {"losses": torch.stack(losses).tolist(),
            "step_ms": [s.elapsed_time(e) for s, e in ms],
            "launches": launches(), "k1_f": sorted(shapes.k1_f),
            "k3_experts": sorted(shapes.k3_experts),
            "shapes": {n: list(p.shape) for n, p in
                       trainer.net.named_parameters()},
            "moments": {n: [list(s) for s in v] for n, v in moments.items()},
            "split": sorted(getattr(trainer._dp, "split", {}))}


def mesh_daemon(argv: list, frames_path: str, out: str, requests: int
                ) -> dict:
    """``vsr_tpu_torch.serve.main`` on this rank. Rank 0's client posts the
    frames ``requests`` times, saves the last answer to ``out`` and stops
    the daemon (SIGTERM), whose shutdown reaches the follower rank; a
    follower returns the calls it ran."""
    import os
    import signal
    import threading

    from vsr_tpu_torch import serve
    from vsr_tpu_torch.parallel import distributed

    torch.cuda.synchronize()
    reset_launches()
    res = {"followed": None, "request_s": []}
    if distributed.is_primary():
        servers, make_server = [], serve.make_server

        def recording(*args, **kwargs):
            servers.append(make_server(*args, **kwargs))
            return servers[-1]

        def client():
            try:
                while not servers:
                    time.sleep(0.05)
                url = f"http://127.0.0.1:{servers[0].server_address[1]}"
                body = npy_bytes(np.load(frames_path))
                for _ in range(requests):
                    sr, seconds, _ = post(f"{url}/v1/sr", body,
                                          "application/x-npy")
                    res["request_s"].append(seconds)
                np.save(out, from_npy(sr))
            finally:
                os.kill(os.getpid(), signal.SIGTERM)

        serve.make_server = recording
        thread = threading.Thread(target=client)
        thread.start()
        try:
            serve.main(argv)
        finally:
            serve.make_server = make_server
            thread.join()
    else:
        follow = serve.follow

        def counted(live, device):
            res["followed"] = follow(live, device)
            return res["followed"]

        serve.follow = counted
        try:
            serve.main(argv)
        finally:
            serve.follow = follow
    torch.cuda.synchronize()
    res["launches"] = launches()
    return res


MESH_JOBS = {"pipeline": mesh_pipeline, "infer": mesh_infer,
             "train": mesh_train, "daemon": mesh_daemon}


def mesh_rank_run(spec_path: str) -> int:
    """A process of phase 19 (``--mesh-run``): each stage sets the
    ``torchrun`` variables of its group, runs its jobs (the first joins
    the group) and leaves the group; the results go into the spec's
    ``out``. A fatal signal prints the Python stack."""
    import faulthandler
    import os

    import torch.distributed as dist

    faulthandler.enable()
    spec = json.loads(Path(spec_path).read_text())
    results = []
    for stage in spec["stages"]:
        os.environ.update(stage["env"])
        got = []
        for job in stage["jobs"]:
            t0 = time.perf_counter()
            got.append(MESH_JOBS[job["kind"]](**job["args"]))
            got[-1]["seconds"] = time.perf_counter() - t0
        results.append(got)
        dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(results))
    return 0


def mesh_processes(tmp: Path, stages: list) -> list:
    """One ``--mesh-run`` process of this script for each list of stages,
    all started together; every process must exit 0. Returns each
    process's results, by stage and job."""
    procs = []
    for i, own in enumerate(stages):
        spec = tmp / f"mesh_process{i}.json"
        spec.write_text(json.dumps({"stages": own,
                                    "out": str(tmp / f"mesh_process{i}.out")}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-run",
             str(spec)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:  # a process that failed leaves its peer waiting
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for i, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode:
            raise SystemExit(f"phase 19: process {i} exited "
                             f"{proc.returncode}:\n{out[-6000:]}")
    return [json.loads((tmp / f"mesh_process{i}.out").read_text())
            for i in range(len(stages))]


def mesh_infer_argv(src: Path, out: Path, net: str, mesh: str) -> list:
    drf = net == "DRFNet"
    return [str(src), str(out), *(["--video", "--fused-tail"] if drf else []),
            "--net", net, "--net-kwargs",
            json.dumps(DRF_MESH_KWARGS if drf else MOE_MESH_KWARGS),
            "--mesh", mesh]


def mesh_cli_sr(out: Path) -> np.ndarray:
    """The CLI's SR volume of phase 19's slice, as (T, H, W) frames."""
    from vsr_tpu_torch.io.nifti import load_nifti

    return as_frames(load_nifti(
        out / "patient000" / "patient000_4d_sr.nii.gz"))


def mesh_train_config(tmp: Path, name: str, config: str, net_kwargs: dict,
                      **trainer_kwargs) -> Path:
    """``configs/train/<config>.yaml`` on phase 7's tree, written to a file
    as a user's config is."""
    from vsr_tpu_torch.config import save_config

    cfg = training_config(config, tmp / "tree", tmp / name, net_kwargs, tmp)
    cfg.trainer.kwargs.update(trainer_kwargs)
    path = tmp / f"{name}.yaml"
    save_config(cfg, path)
    return path


def gate_mesh(what: str, got: np.ndarray, want: np.ndarray, expert: bool
              ) -> dict:
    """The serving bars of the JAX package's mesh tests: under ``model``
    (``tests/test_tensor_parallel.py``) no pixel more than one grey apart;
    under ``expert`` (``tests/test_expert_parallel.py``) also < 1 % of the
    pixels different."""
    if got.shape != want.shape:
        raise SystemExit(f"{what}: shape {got.shape} vs {want.shape}")
    exact, worst = agreement(got, want)
    if worst > 1 or (expert and 1 - exact >= 0.01):
        raise SystemExit(f"{what}: {exact * 100:.4f}% exact, max {worst:g} "
                         "grey")
    return {"exact_fraction": exact, "max_grey_diff": worst}


def mesh_check_launches(what: str, got: dict, want: dict) -> None:
    others = {k: v for k, v in got.items() if k not in want and v}
    if {k: got[k] for k in want} != want or others:
        raise SystemExit(f"{what}: kernel launches {got}, expected {want} "
                         "and no other")


def mesh_check_training(what: str, got: list, want: dict, state: dict,
                        ref_state: dict) -> dict:
    """(c)'s gates on the two ranks' runs against the run without a mesh:
    the losses, the parameters (the worst leaf named), each split leaf and
    its Adam moments 1/2 a rank, the others whole."""
    diff = max(abs(a - b) for r in got for a, b in zip(r["losses"],
                                                       want["losses"]))
    worst, leaf, outside = 0.0, "", []
    for key, ref in ref_state.items():
        scale = float(ref.abs().max()) or 1.0
        share = float((state[key] - ref).abs().max()) / scale
        if share > worst:
            worst, leaf = share, key
        if share > MESH_PARAM_SHARE and not torch.allclose(
                state[key].float(), ref.float(), **MESH_PARAM_TOL):
            outside.append(key)
    res = {"max_loss_diff": diff, "param_share": worst, "worst_leaf": leaf,
           "worst_leaf_max": float(ref_state[leaf].abs().max()) if leaf
           else 0.0, "split_leaves": len(got[0]["split"]),
           "leaves": len(want["shapes"])}
    res["worst_leaf_abs"] = worst * (res["worst_leaf_max"] or 1.0)
    if diff > MESH_LOSS_TOL or any(len(r["losses"]) != MESH_STEPS
                                   for r in got):
        raise SystemExit(f"{what}: a step's loss differs by {diff:.3g} from "
                         f"the run without a mesh (> {MESH_LOSS_TOL})")
    if outside:
        raise SystemExit(f"{what}: parameters of {outside} beyond 1e-3 of "
                         "their largest entry and beyond rtol 5e-4 / atol "
                         "1e-5 of the run without a mesh")
    full, split = want["shapes"], set(got[0]["split"])
    if not split:
        raise SystemExit(f"{what}: no leaf is split")
    for r in got:
        for name, shape in r["shapes"].items():
            cut = [d for d, (a, b) in enumerate(zip(shape, full[name]))
                   if a != b]
            ok = (len(cut) == 1 and shape[cut[0]] * 2 == full[name][cut[0]]
                  if name in split else not cut)
            if not ok or r["moments"].get(name) != [shape]:
                raise SystemExit(f"{what}: {name} holds {shape} (moments "
                                 f"{r['moments'].get(name)}) of {full[name]}")
    return res


def phase_mesh(tmp: Path, card: str, dev) -> dict:
    """Phase 19: ``--mesh`` serving and the ``model`` / ``expert`` axes (the
    docstring's item 19). Every gate runs; the failures are raised
    together at the end."""
    from vsr_tpu_torch.io.nifti import save_nifti

    res, failed = {"a": {}, "b": {}, "c": {}}, []

    def gated(fn, *args):
        try:
            return fn(*args)
        except SystemExit as err:
            failed.append(str(err))
            log(f"  FAILED: {err}")
            return {}

    t0 = time.perf_counter()
    vol = make_volume(19, FULL_SLICES)
    paths = {"full": tmp / "mesh_full.npy", "slice": tmp / "mesh_slice.npy"}
    np.save(paths["full"], as_frames(vol))
    np.save(paths["slice"], as_frames(vol[:, :, :1]))
    src = tmp / "mesh_slice_nifti"
    save_nifti(vol[:, :, :1], src / "patient000" / "patient000_4d.nii")

    log("phase 19: the runs without a mesh in this process: make_pipeline of "
        "DRFNet x2 (F=64, G=6, K1) on a 192 x 192 x 10 x 30 volume and on "
        "its first slice, of MoE-EDSR x2 (rank_pallas, sparse, K3) on that "
        "slice; 4 steps of 16 of each training config")
    ref = {"drf": mesh_pipeline("DRFNet", str(paths["full"]),
                                out=str(tmp / "mesh_ref_drf.npy")),
           "drf_slice": mesh_pipeline("DRFNet", str(paths["slice"]),
                                      out=str(tmp / "mesh_ref_drf_slice.npy")),
           "moe": mesh_pipeline("MoEEDSRNet", str(paths["slice"]),
                                out=str(tmp / "mesh_ref_moe.npy"))}
    k1 = {"concat_conv1x1": SQUEEZES_PER_STEP * T_FRAMES}
    k3 = {"pairwise_rank": MOE_LAYERS}
    for key, want in (("drf", k1), ("drf_slice", k1), ("moe", k3)):
        for n in ref[key]["launches"]:
            gated(mesh_check_launches, f"19 {key} without a mesh", n, want)
    want_sr = {k: np.load(tmp / f"mesh_ref_{k}.npy")
               for k in ("drf", "drf_slice", "moe")}
    configs = {
        "moe": mesh_train_config(tmp, "mesh_moe_base", "acdc_sisr_moe_x2",
                                 {"router_impl": "rank_pallas"}),
        "drf": mesh_train_config(tmp, "mesh_drf_base", "acdc_vsr_drf_x2",
                                 {"fused_squeeze": True})}
    base = {k: mesh_train(str(c), MESH_STEPS, str(tmp / f"mesh_{k}_base.pt"))
            for k, c in configs.items()}
    train_k1 = SQUEEZES_PER_STEP * TRAIN_T * MESH_STEPS
    want_train = {"drf": {"concat_conv1x1": train_k1,
                          "concat_conv1x1_dx": train_k1,
                          "concat_conv1x1_dw": train_k1},
                  "moe": {"pairwise_rank": MOE_LAYERS * MESH_STEPS}}
    for key in base:
        gated(mesh_check_launches, f"19 {key} training without a mesh",
              base[key]["launches"], want_train[key])

    def pipeline_job(net, frames, mesh, out):
        return {"kind": "pipeline", "args": {
            "net": net, "frames_path": str(paths[frames]), "mesh": mesh,
            "out": str(tmp / out)}}

    def infer_job(net, mesh, out):
        return {"kind": "infer", "args": {"argv": mesh_infer_argv(
            src, tmp / out, net, mesh)}}

    one = [pipeline_job("DRFNet", "full", "data=1", "mesh_a.npy"),
           infer_job("DRFNet", "data=1", "mesh_a_cli")]
    two = [pipeline_job("DRFNet", "slice", "model=2", "mesh_b_drf.npy"),
           pipeline_job("MoEEDSRNet", "slice", "expert=2", "mesh_b_moe.npy"),
           infer_job("MoEEDSRNet", "expert=2", "mesh_b_moe_cli"),
           {"kind": "train", "args": {"config": str(mesh_train_config(
               tmp, "mesh_moe_expert", "acdc_sisr_moe_x2",
               {"router_impl": "rank_pallas"}, mesh_axes={"expert": 2})),
               "steps": MESH_STEPS, "out": str(tmp / "mesh_moe_expert.pt")}},
           {"kind": "train", "args": {"config": str(mesh_train_config(
               tmp, "mesh_drf_model", "acdc_vsr_drf_x2",
               {"fused_squeeze": True}, mesh_axes={"model": 2})),
               "steps": MESH_STEPS, "out": str(tmp / "mesh_drf_model.pt")}},
           {"kind": "daemon", "args": {
               "argv": ["--net", "MoEEDSRNet", "--net-kwargs",
                        json.dumps(MOE_MESH_KWARGS), "--frames-shape",
                        f"{T_FRAMES},{HR},{HR}", "--mesh", "expert=2",
                        "--port", "0"],
               "frames_path": str(paths["slice"]),
               "out": str(tmp / "mesh_d.npy"), "requests": MESH_REQUESTS}}]
    port_one, port_two = free_port(), free_port()
    log("phase 19a-d: process 0 as the one rank of an NCCL group (--mesh "
        "data=1), then with process 1 as two gloo ranks sharing the card")
    procs = mesh_processes(tmp, [
        [{"env": torchrun_env(port_one, 1, 0), "jobs": one},
         {"env": torchrun_env(port_two, 2, 0), "jobs": two}],
        [{"env": torchrun_env(port_two, 2, 1), "jobs": two}]])
    (a, a_cli), ranks = procs[0][0], [procs[0][1], procs[1][0]]

    # (a) one NCCL rank, --mesh data=1.
    for n in a["launches"]:
        gated(mesh_check_launches, "19a make_pipeline --mesh data=1", n, k1)
    gated(mesh_check_launches, "19a infer --mesh data=1", a_cli["launches"],
          k1)
    res["a"] = dict(
        gated(gate_mesh, "19a make_pipeline --mesh data=1",
              np.load(tmp / "mesh_a.npy"), want_sr["drf"], False),
        cli=gated(gate_mesh, "19a infer --mesh data=1",
                  mesh_cli_sr(tmp / "mesh_a_cli"), want_sr["drf_slice"],
                  False),
        k1_launches=a["launches"][-1]["concat_conv1x1"], k1_f=a["k1_f"],
        ms=a["ms"], no_mesh_ms=ref["drf"]["ms"])
    log(f"  19a: DRFNet --mesh data=1, one NCCL rank: "
        f"{res['a'].get('exact_fraction', 0) * 100:.4f}% exact, max "
        f"{res['a'].get('max_grey_diff')} grey against the run without a "
        f"mesh (the CLI on the slice: {res['a']['cli']}); K1 "
        f"{res['a']['k1_launches']} launches a volume at F = {a['k1_f']}; "
        f"pipeline {a['ms'][-1]:.1f} ms a volume warm ({a['ms'][0]:.1f} the "
        f"first call), {ref['drf']['ms'][-1]:.1f} ms without a mesh [{card}]")

    # (b) two gloo ranks: DRFNet over 'model' (make_pipeline), MoE-EDSR
    # over 'expert' (make_pipeline, then the CLI).
    for i, key, axis in ((0, "drf", "model"), (1, "moe", "expert")):
        want = k1 if key == "drf" else k3
        full = F_ if key == "drf" else MOE_KWARGS["num_experts"]
        for r, rank in enumerate(ranks):
            run = rank[i]
            clis = [rank[i + 1]["launches"]] if key == "moe" else []
            for n in (*run["launches"], *clis):
                gated(mesh_check_launches, f"19b {key} rank {r}", n, want)
            widths = run["k1_f" if key == "drf" else "k3_experts"]
            if widths != [full // 2]:
                failed.append(f"19b {key} rank {r}: the kernel saw {widths}, "
                              f"not {full // 2} of {full}")
            log(f"  19b {key} --mesh {axis}=2 rank {r}: "
                f"{'K1 F' if key == 'drf' else 'K3 experts'} {widths} of "
                f"{full}, launches a call {run['launches'][-1]}, pipeline "
                f"{run['ms'][-1]:.1f} ms warm ({run['ms'][0]:.1f} the first "
                f"call) [{card}]")
        ref_key = "drf_slice" if key == "drf" else "moe"
        res["b"][key] = dict(
            gated(gate_mesh, f"19b {key} --mesh {axis}=2",
                  np.load(tmp / f"mesh_b_{key}.npy"), want_sr[ref_key],
                  key == "moe"),
            cli=gated(gate_mesh, f"19b {key} infer --mesh {axis}=2",
                      mesh_cli_sr(tmp / f"mesh_b_{key}_cli"),
                      want_sr[ref_key], True) if key == "moe" else None,
            launches_per_rank=[r[i]["launches"][-1] for r in ranks],
            widths=ranks[0][i]["k1_f" if key == "drf" else "k3_experts"],
            ms=ranks[0][i]["ms"], no_mesh_ms=ref[ref_key]["ms"])
        log(f"  19b {key}: {res['b'][key].get('exact_fraction', 0) * 100:.4f}"
            f"% exact, max {res['b'][key].get('max_grey_diff')} grey against "
            f"the run without a mesh on the slice (CLI: "
            f"{res['b'][key]['cli']}); {ref[ref_key]['ms'][-1]:.1f} ms a "
            f"slice without a mesh [{card}]")

    # (c) training on two gloo ranks.
    for i, key, axis in ((3, "moe", "expert"), (4, "drf", "model")):
        got = [r[i] for r in ranks]
        full = F_ if key == "drf" else MOE_KWARGS["num_experts"]
        for r, run in enumerate(got):
            gated(mesh_check_launches, f"19c {key} rank {r}",
                  run["launches"], want_train[key])
            if full // 2 not in run["k1_f" if key == "drf" else
                                    "k3_experts"]:
                failed.append(f"19c {key} rank {r}: the kernel did not run "
                              f"at {full // 2} of {full}")
        gates = gated(mesh_check_training, f"19c {key} {{{axis}: 2}}", got,
                      base[key], torch.load(tmp / f"mesh_{key}_{axis}.pt"),
                      torch.load(tmp / f"mesh_{key}_base.pt"))
        ms = statistics.median(got[0]["step_ms"][1:])
        base_ms = statistics.median(base[key]["step_ms"][1:])
        res["c"][key] = dict(gates, step_ms=ms, no_mesh_step_ms=base_ms,
                             losses=got[0]["losses"],
                             no_mesh_losses=base[key]["losses"],
                             launches_per_rank=[r["launches"] for r in got])
        log(f"  19c {key} {{{axis}: 2}}: {MESH_STEPS} steps, {gates}; "
            f"launches a rank {got[0]['launches']}; median step {ms:.2f} ms "
            f"(two ranks over gloo), {base_ms:.2f} ms without a mesh [{card}]")

    # (d) the daemon.
    lead, follower = ranks[0][5], ranks[1][5]
    if follower["followed"] != MESH_REQUESTS + 1:
        failed.append(f"19d: the follower ran {follower['followed']} calls, "
                      f"not the warm-up and {MESH_REQUESTS}")
    for r, run in enumerate((lead, follower)):
        gated(mesh_check_launches, f"19d rank {r}", run["launches"],
              {"pairwise_rank": MOE_LAYERS * (MESH_REQUESTS + 1)})
    res["d"] = dict(gated(gate_mesh, "19d serve --mesh expert=2",
                          np.load(tmp / "mesh_d.npy"), want_sr["moe"], True),
                    requests=MESH_REQUESTS,
                    follower_calls=follower["followed"],
                    request_s=lead["request_s"],
                    launches_per_rank=[lead["launches"]["pairwise_rank"],
                                       follower["launches"]["pairwise_rank"]])
    log(f"  19d: serve --mesh expert=2 answered {MESH_REQUESTS} requests "
        f"({', '.join(f'{s:.2f}' for s in lead['request_s'])} s); the "
        f"follower ran {follower['followed']} calls; both ranks shut down; "
        f"K3 {res['d']['launches_per_rank']} launches a rank; "
        f"{res['d'].get('exact_fraction', 0) * 100:.4f}% exact against the "
        f"run without a mesh [{card}]")
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 19 took {res['seconds']:.1f} s [{card}]")
    if failed:
        raise SystemExit("phase 19 failed:\n" + "\n".join(failed))
    return res


def mesh_summary(mesh: dict) -> dict:
    return {"seconds": mesh["seconds"],
            "a": {k: mesh["a"][k] for k in ("max_grey_diff", "k1_launches",
                                            "ms", "no_mesh_ms")},
            "b": {k: {n: v[n] for n in ("max_grey_diff", "launches_per_rank",
                                         "ms", "no_mesh_ms")}
                  for k, v in mesh["b"].items()},
            "c": {k: {n: v[n] for n in ("max_loss_diff", "param_share",
                                         "step_ms", "no_mesh_step_ms")}
                  for k, v in mesh["c"].items()},
            "d": {n: mesh["d"][n] for n in ("follower_calls",
                                             "max_grey_diff")}}


# ==================================================================== lanes

# Phases 1-6 and 16 run first and 13 last, alone on the card and the host:
# 3, 6, 13 and 16 time the kernels, and 13 serves phase 7's and 9's
# checkpoints. Between them the other phases run in lanes: a process of
# this script each (--lane), all started together beside this process's
# phases 7, 9 and 12. A lane that trains writes phase 7a's tree for itself
# (seeded: the same files), keeps its phases in their order and hands the
# card back its cached blocks after each. 4, 12, 13, 15 and 16 serve full
# DUF, MoE and step-stacked volumes (up to 19-27 GB live, and twice that
# cached as their calls change shape), 18 and 19 run up to four processes
# of 3-6 GB each: so no two of 4, 12, 15 and 16 meet, 15 and 19 share a
# lane, 12 and 15 take turns on a file lock (CARD_LOCK), and while the
# lanes run, this process and the lanes that capture no CUDA graph hand
# back their cached blocks above GC_SHARE of the card before they allocate
# more (the allocator's garbage_collection_threshold).
LANE_PHASES = {
    "10": ("volumes", "the volumetric slice, Volume3DSRNet and Volume4DSRNet "
           "(no port kernel on these paths)",
           lambda tmp, tree, card, dev: phase_volumes(tmp, card, dev)),
    "11": ("device_epochs", "the device-epoch trainers (captured CUDA "
           "graphs), the four *_device.yaml configs, bf16 training through K1",
           lambda tmp, tree, card, dev: phase_device_epochs(tmp, card, dev)),
    "14": ("knobs", "the training knobs (grad_accumulation, grad_clip, "
           "ema_decay, qat) in both trainer families, infer --ema / --gif, "
           "SGD and Adagrad captured, QAT to W8A8",
           lambda tmp, tree, card, dev: phase_knobs(tmp, card, dev)),
    "15": ("feedback", "the feedback family (DRFSISRNet, sub-pixel deconvs, "
           "DRFNet's experts and remat) and the MoE routers (sort, radix, "
           "dense_nhwc), K1 and K3",
           lambda tmp, tree, card, dev: phase_feedback(tmp, tree, card, dev)),
    "17": ("offline", "the offline tools to a tested checkpoint (DICOM "
           "conversion, ACDC / DSB15 preprocessing on the card, cropping, "
           "DRFNet trained with native_decode, async_ckpt and profile_dir, "
           "main --test)",
           lambda tmp, tree, card, dev: phase_offline(tmp / "offline", card,
                                                      dev)),
    "18": ("parallel", "data-parallel training (main.distributed, DDP over "
           "NCCL, two ranks over gloo with ZeRO-1 and FSDP, sharded "
           "checkpoints, convert --consolidate, the device trainer's "
           "captured all-reduce), K1 under DDP",
           lambda tmp, tree, card, dev: phase_parallel(tmp, card, dev)),
    "19": ("mesh", "--mesh serving and the model / expert axes (infer --mesh "
           "data=1 over NCCL; model=2 and expert=2 on two gloo ranks sharing "
           "the card: serving, training, the daemon), K1 at F = 32 and K3 on "
           "half the experts",
           lambda tmp, tree, card, dev: phase_mesh(tmp, card, dev)),
}
TREE_PHASES = {"11", "14", "15", "18", "19"}  # those that read tmp / "tree"
# Lane -> its phases, balanced on their times alone (PERF.md section 5)
# against this process's 7, 9 and 12.
LANES = {"volumes": ("10", "11"), "offline": ("14", "17", "18"),
         "feedback": ("15", "19")}
LANE_TIMEOUT_S = 900
GC_SHARE = 0.25
# This process's cap while the lanes run: its 7, 9 and 12 hold 20.6 GB live
# at most but cached 43.5 GB under the GC alone (PERF.md, PR 17, run F5);
# at the cap the allocator hands back its free blocks before it grows.
MAIN_SHARE = 0.4
GC_LANES = {"feedback"}  # 11 and 14 capture CUDA graphs
# CPU threads of each lane's operators (OMP_NUM_THREADS), and of this
# process's while the lanes run: four processes and their children share
# the host's cores.
LANE_THREADS = 2
# Held by this process's phase 12 and the lane's phases below, one at a
# time: 12 (19 GB live) and 15 (27 GB) never meet on the card. The file
# lies in the directory of the lanes' results; a process that dies lets go.
CARD_LOCK = "card.lock"
CARD_LOCK_PHASES = {"15"}


@contextlib.contextmanager
def card_lock(path: Path, what: str, card: str):
    """Holds the file lock at ``path`` (waits for it first, and logs how
    long when it had to)."""
    import fcntl

    with open(path, "a") as f:
        t0 = time.perf_counter()
        fcntl.flock(f, fcntl.LOCK_EX)
        waited = time.perf_counter() - t0
        if waited > 0.5:
            log(f"  {what} waited {waited:.1f} s for the card lock [{card}]")
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_lane(name: str, tmp: Path, card: str, dev, lock: Path) -> dict:
    """A lane's phases in this process, each result under its key; the
    phases of CARD_LOCK_PHASES under the file lock at ``lock``."""
    tree = None
    if TREE_PHASES & set(LANES[name]):
        log("phase 7a: the synthetic processed tree")
        tree = make_training_tree(tmp / "tree", dev)
    if name in GC_LANES:
        torch.cuda.set_per_process_memory_fraction(1.0)  # turns the GC on
    out = {}
    for phase in LANES[name]:
        key, title, run = LANE_PHASES[phase]
        log(f"phase {phase}: {title}")
        with (card_lock(lock, f"phase {phase}", card)
              if phase in CARD_LOCK_PHASES else contextlib.nullcontext()):
            t0 = time.perf_counter()
            res = out[key] = run(tmp, tree, card, dev)
            if "seconds" not in res:  # 17, 18 and 19 log their own
                res["seconds"] = time.perf_counter() - t0
                log(f"  phase {phase} took {res['seconds']:.1f} s [{card}]")
            res["lane_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
            res["lane_allocated_gb"] = (torch.cuda.max_memory_allocated()
                                        / 1e9)
            log(f"  phase {phase}: {res['lane_allocated_gb']:.2f} GB "
                f"allocated, {res['lane_reserved_gb']:.2f} GB reserved at "
                "most in this process")
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def cpu_seconds() -> float:
    """User and system CPU time of this process and its waited children."""
    import resource

    return sum(sum(resource.getrusage(who)[:2]) for who in (
        resource.RUSAGE_SELF, resource.RUSAGE_CHILDREN))


class Lanes:
    """The lanes' processes, each started in a session of its own (so that
    its rank processes stop with it), its output in files under ``tmp``;
    and, while they run, the card's utilization and memory as
    ``nvidia-smi`` reads them each second, and the CPU time of this process
    and its children. This process's allocator keeps at most MAIN_SHARE
    of the card while they run."""

    def __init__(self, tmp: Path):
        import os

        self.tmp, self.procs = tmp, {}
        self.t0 = time.perf_counter()
        self.cpu0 = cpu_seconds()
        self.threads = torch.get_num_threads()
        torch.set_num_threads(LANE_THREADS)
        torch.cuda.empty_cache()
        # turns the GC on, and caps this process's cache
        torch.cuda.set_per_process_memory_fraction(MAIN_SHARE)
        env = dict(os.environ, OMP_NUM_THREADS=str(LANE_THREADS))
        with open(tmp / "smi.csv", "w") as smi:
            self.smi = subprocess.Popen(
                ["nvidia-smi", "--id=0", "--query-gpu=utilization.gpu,"
                 "memory.used", "--format=csv,noheader,nounits", "-lms",
                 "1000"], stdout=smi, stderr=subprocess.DEVNULL)
        torch.cuda.reset_peak_memory_stats()
        for name in LANES:
            with open(tmp / f"lane_{name}.out", "w") as out, \
                    open(tmp / f"lane_{name}.err", "w") as err:
                self.procs[name] = subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--lane",
                     name, "--out", str(tmp / f"lane_{name}.json")],
                    stdout=out, stderr=err, env=env, start_new_session=True)
        log("lanes started: " + ", ".join(
            f"{name} (phases {', '.join(LANES[name])})" for name in LANES))

    def finish(self, card: str) -> tuple[dict, dict]:
        """Waits for every lane, prints its output, fails if any lane
        failed; returns their results, merged, and the host's and the
        card's load while they ran."""
        import os

        results, failed = {}, []
        for name, proc in self.procs.items():
            rc = proc.wait(timeout=LANE_TIMEOUT_S)
            log(f"lane {name} (phases {', '.join(LANES[name])}) exited {rc}:")
            print((self.tmp / f"lane_{name}.out").read_text(), end="",
                  flush=True)
            print((self.tmp / f"lane_{name}.err").read_text(), end="",
                  file=sys.stderr, flush=True)
            if rc:
                failed.append(name)
            else:
                results.update(json.loads(
                    (self.tmp / f"lane_{name}.json").read_text()))
        if failed:
            raise SystemExit(f"lanes failed: {', '.join(failed)}")
        wall = time.perf_counter() - self.t0
        cpu = cpu_seconds() - self.cpu0
        self.smi.terminate()
        self.smi.wait()
        log(f"  this process: {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
            "reserved at most from its last training run through phase 12 "
            f"[{card}]")
        rows = [line.split(",") for line in
                (self.tmp / "smi.csv").read_text().splitlines()]
        rows = [(float(u), float(m)) for u, m in
                (r for r in rows if len(r) == 2)]
        load = {"seconds": wall, "cpu_seconds": cpu,
                "cores": len(os.sched_getaffinity(0)),
                "busy_cores": cpu / wall,
                "card_utilization": statistics.fmean(u for u, _ in rows)
                if rows else None,
                "card_memory_mib": max((m for _, m in rows), default=None)}
        log(f"  the lanes took {wall:.1f} s: {load['busy_cores']:.2f} of "
            f"{load['cores']} cores busy on average (this process and its "
            f"children, CPU time over wall time); the card "
            + ("not sampled" if not rows else
               f"{load['card_utilization']:.1f} % utilized on average "
               f"(nvidia-smi, {len(rows)} samples), "
               f"{load['card_memory_mib']:.0f} MiB at most") + f" [{card}]")
        return results, load

    def stop(self) -> None:
        """Kills each lane's session (whatever of it still runs) and the
        sampler, and gives this process its threads and the card back."""
        import os
        import signal

        for proc in self.procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        if self.smi.poll() is None:
            self.smi.kill()
            self.smi.wait()
        torch.set_num_threads(self.threads)
        torch.cuda.set_per_process_memory_fraction(1.0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="",
                        help="also write the full results as JSON here")
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler trace of one full volume "
                             "per serving path and of 6 train steps per "
                             "training path")
    parser.add_argument("--latency", type=int, default=0, metavar="N",
                        help="only build, export the three artifacts and "
                             f"drive each daemon with {CLIENTS} clients x N "
                             "requests (a p99 from 100 requests on), and "
                             "trace the DRF artifact against make_pipeline")
    parser.add_argument("--quantized", action="store_true",
                        help="only build and run phase 13 (quantized "
                             "serving) on seeded weights")
    parser.add_argument("--knobs", action="store_true",
                        help="only build, write phase 7's tree and run phase "
                             "14 (the training knobs)")
    parser.add_argument("--feedback", action="store_true",
                        help="only build, write phase 7's tree and run phase "
                             "15 (the feedback family and the MoE routers)")
    parser.add_argument("--presets", action="store_true",
                        help="only build and run phase 16 (W8A8 deconvs, "
                             "the serving presets, the tuner, bf16 training "
                             "of the nets moved onto the precision policy)")
    parser.add_argument("--offline", action="store_true",
                        help="only build and run phase 17 (the offline "
                             "tools to a tested checkpoint)")
    parser.add_argument("--parallel", action="store_true",
                        help="only build, write phase 7's tree and run phase "
                             "18 (data-parallel training)")
    parser.add_argument("--mesh-axes", dest="mesh_axes",
                        action="store_true",
                        help="only build, write phase 7's tree and run phase "
                             "19 (--mesh serving, the model and expert "
                             "axes)")
    parser.add_argument("--rank-run", dest="rank_run", default="",
                        help=argparse.SUPPRESS)  # a rank of phase 18
    parser.add_argument("--mesh-run", dest="mesh_run", default="",
                        help=argparse.SUPPRESS)  # a rank of phase 19
    parser.add_argument("--lane", default="", choices=["", *LANES],
                        help=argparse.SUPPRESS)  # a lane of the full run
    parser.add_argument("--preset-table", dest="preset_table", nargs="*",
                        default=None, metavar="NET",
                        help="only build and run the sweep behind "
                             "vsr_tpu_torch/presets.py's table (tune and "
                             "W8A8 on / off) for these nets (all without "
                             "names); writes it to --out")
    args = parser.parse_args()
    import os

    # Read when the allocator starts; acts once a process sets its memory
    # fraction (the lanes, GC_SHARE).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          f"garbage_collection_threshold:{GC_SHARE}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.rank_run:
        return rank_run(args.rank_run)
    if args.mesh_run:
        return mesh_rank_run(args.mesh_run)
    from vsr_tpu_torch import _build

    started = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()} limit"
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    log("phase 2: build")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    root = Path(__file__).resolve().parent
    log(f"  built {[str(p.relative_to(root)) for p in _build.sources()]} "
        f"-> {_build.library_path().name} in {build_s:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.lane:
        with tempfile.TemporaryDirectory() as tmp:
            results = run_lane(args.lane, Path(tmp), card, dev,
                               Path(args.out).with_name(CARD_LOCK))
        Path(args.out).write_text(json.dumps(results))
        return 0
    if args.latency:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "latency": phase_latency(
                Path(tmp), card, dev, args.latency)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --latency took {results['seconds']:.1f} s [{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        print(json.dumps({"latency": {k: {n: e[n] for n in (
            "requests", "p50_ms", "p99_ms", "max_ms", "volumes_per_s",
            "direct_volumes_per_s") if n in e}
            for k, e in results["latency"]["daemon"].items()}}), flush=True)
        return 0
    if args.quantized:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "quantized": phase_quantized(
                Path(tmp), card, dev)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --quantized took {results['seconds']:.1f} s "
            f"[{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        main = results["quantized"]["main"]
        print(json.dumps({"w8a8_conv": {k: main[k] for k in (
            "x", "weight", "ms", "plain_ms", "bound_ms", "library_ms",
            "cudnn_bf16_ms")}}), flush=True)
        return 0
    if args.knobs:
        with tempfile.TemporaryDirectory() as tmp:
            log("phase 7a: the synthetic processed tree")
            make_training_tree(Path(tmp) / "tree", dev)
            results = {"card": smi, "knobs": phase_knobs(Path(tmp), card,
                                                         dev)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --knobs took {results['seconds']:.1f} s [{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        knobs = results["knobs"]
        print(json.dumps({"knobs": {
            "seconds_by_step": knobs["seconds_by_step"],
            "k1_launches_per_micro_step": knobs["host_loop"]["straight"][
                "k1_launches_per_micro_step"],
            "ema_infer_launches": knobs["ema_infer"]["launches"],
            "qat_w8a8_launches": knobs["qat"]["launches"]}}), flush=True)
        return 0
    if args.presets or args.preset_table is not None:
        with tempfile.TemporaryDirectory() as tmp:
            if args.presets:
                results = {"card": smi, "presets": phase_presets(
                    Path(tmp), card, dev)}
            else:
                results = {"card": smi, "preset_table": phase_preset_table(
                    Path(tmp), card, dev, args.preset_table or list(
                        TABLE_NETS))}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke took {results['seconds']:.1f} s [{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        if args.presets:
            print(json.dumps({"presets": presets_summary(
                results["presets"])}), flush=True)
        else:
            print(json.dumps({"preset_table": {
                k: {"entry": v["entry"], "w8a8": v.get("w8a8")}
                for k, v in results["preset_table"].items()}}), flush=True)
        return 0
    if args.feedback:
        with tempfile.TemporaryDirectory() as tmp:
            log("phase 7a: the synthetic processed tree")
            tree = make_training_tree(Path(tmp) / "tree", dev)
            results = {"card": smi, "feedback": phase_feedback(
                Path(tmp), tree, card, dev)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --feedback took {results['seconds']:.1f} s "
            f"[{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        print(json.dumps({"feedback": feedback_summary(
            results["feedback"])}), flush=True)
        return 0
    if args.offline:
        with tempfile.TemporaryDirectory() as tmp:
            log("phase 17: the offline tools to a tested checkpoint")
            results = {"card": smi, "offline": phase_offline(
                Path(tmp), card, dev)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --offline took {results['seconds']:.1f} s "
            f"[{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        print(json.dumps({"offline": offline_summary(results["offline"])}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.mesh_axes:
        with tempfile.TemporaryDirectory() as tmp:
            log("phase 7a: the synthetic processed tree")
            make_training_tree(Path(tmp) / "tree", dev)
            results = {"card": smi, "mesh": phase_mesh(Path(tmp), card, dev)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --mesh-axes took {results['seconds']:.1f} s "
            f"[{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        print(json.dumps({"mesh": mesh_summary(results["mesh"])}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.parallel:
        with tempfile.TemporaryDirectory() as tmp:
            log("phase 7a: the synthetic processed tree")
            make_training_tree(Path(tmp) / "tree", dev)
            log("phase 18: data-parallel training")
            results = {"card": smi, "parallel": phase_parallel(
                Path(tmp), card, dev)}
        results["seconds"] = time.perf_counter() - started
        log(f"  chip_smoke --parallel took {results['seconds']:.1f} s "
            f"[{card}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
        print(json.dumps({"parallel": parallel_summary(
            results["parallel"])}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    log("phase 3: kernel vs twin")
    k1 = phase_kernel_squeeze(dev)
    k3 = phase_kernel_rank(dev)
    k2 = phase_kernel_duf(dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_paths(Path(tmp), card, dev)
    log("phase 5: card vs CPU")
    cpu_ref = phase_cpu_reference(dev)
    log("phase 6: K1 backward vs twin")
    k1_bwd = phase_kernel_squeeze_backward(dev)
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 16: W8A8 deconvs (quantize_deconvs), infer --preset "
            "tuned / fast with export and the daemon, the tuner, bf16 "
            "training of the seven nets moved onto the precision policy")
        t0 = time.perf_counter()
        presets = phase_presets(Path(tmp), card, dev)
        presets["seconds"] = time.perf_counter() - t0
        log(f"  phase 16 took {presets['seconds']:.1f} s [{card}]")
        lanes = Lanes(Path(tmp))
        try:
            training = phase_training(Path(tmp), card, dev)
            tree = training.pop("sequences")
            served7 = training.pop("served_checkpoint")
            log("phase 9: the MISR and FRVSR training paths, DUF and MoE "
                "training")
            sliced = phase_slice_training(Path(tmp), tree, card, dev)
            log("phase 12: the serving deployment (exported artifacts, the "
                "HTTP daemon, online streams, the checkpoint's live "
                "pipeline), K1, K2 and K3 through each")
            with card_lock(Path(tmp) / CARD_LOCK, "phase 12", card):
                t0 = time.perf_counter()
                deploy = phase_deployment(Path(tmp), card, dev, served7)
                deploy["seconds"] = time.perf_counter() - t0
                torch.cuda.empty_cache()
            log(f"  phase 12 took {deploy['seconds']:.1f} s [{card}]")
            laned, load = lanes.finish(card)
        finally:
            lanes.stop()
        volumes = laned["volumes"]
        device, knobs = laned["device_epochs"], laned["knobs"]
        feedback, offline = laned["feedback"], laned["offline"]
        parallel, mesh = laned["parallel"], laned["mesh"]
        log("phase 13: quantized serving (int8 weights; W8A8 convs on the "
            "int8 tensor cores), EDSRNet, DRFNet and DUFNet")
        t0 = time.perf_counter()
        quant = phase_quantized(Path(tmp), card, dev)
        quant["seconds"] = time.perf_counter() - t0
        log(f"  phase 13 took {quant['seconds']:.1f} s")
        results = {"card": smi, "build_seconds": build_s,
                   "kernel": {"concat_conv1x1": k1,
                              "concat_conv1x1_backward": k1_bwd,
                              "pairwise_rank": k3, "duf_dynamic_filter": k2},
                   "paths": paths, "card_vs_cpu": cpu_ref,
                   "training": training, "slice_training": sliced,
                   "volumes": volumes, "device_epochs": device,
                   "deployment": deploy, "quantized": quant,
                   "knobs": knobs, "feedback": feedback,
                   "presets": presets, "offline": offline,
                   "parallel": parallel, "mesh": mesh, "lanes": load}
        if args.profile:
            log("phase 8: torch.profiler traces")
            results["profile"] = phase_profile(dev)
            results["profile_training"] = phase_profile_training(
                Path(tmp), dev)
            results["profile_volumes"] = phase_profile_volumes(dev)
            results["profile_determinism"] = phase_profile_determinism(
                dev, card)
            make_volume_tree(Path(tmp) / "volume_tree", dev)  # lane's own
            results["profile_training_volumes"] = phase_profile_training(
                Path(tmp), dev, [(f"vol_{key}", name, {}) for key, (name, _, _)
                                 in VOL_RUNS.items()],
                Path(tmp) / "volume_tree")
    results["seconds"] = time.perf_counter() - started
    log(f"  chip_smoke took {results['seconds']:.1f} s [{card}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))

    per_step = k1["per_step"]
    qedsr, qdrf = quant["pipelines"]["edsr"], quant["pipelines"]["drf"]
    qmain = quant["main"]

    def launches(key):
        return paths[key]["cli"]["runs"]["on"]["launches"]

    pr = presets_summary(presets)

    def preset_launches(kernel):
        """Phase 16b: the kernel's launches a volume under each run."""
        return {run: n[kernel] for run, n in pr["launches"].items()
                if kernel in n}

    def routes(key):
        """A path's launches through phase 12's routes: its artifact (one
        volume), its daemon (warm-up + requests), its stream (30 pushes)."""
        return {"export_launches": deploy["artifacts"][key]["launches"],
                "serve_launches": deploy["daemon"][key]["launches"],
                "stream_launches": deploy["streams"][key]["launches"]}

    print(json.dumps({"kernels": [{
        # Per DRFNet frame step: its 12 squeezes at N = 10 slices. The twin
        # is torch.cat + the library's 1x1 conv, so it is the library call.
        "name": "concat_conv1x1", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/fused_squeeze.cu",
        "replaces": "vsr_tpu/ops/fused_squeeze.py:81",
        "launches": launches("drf"),
        # The training path (DRFNet under AcdcVSRTrainer, kernel on): forward
        # launches of its train and validation steps, and the launches that
        # compute dx in its backward.
        "train_launches": training["vsr"]["fused"]["launches"],
        "backward_launches": training["vsr"]["fused"]["backward_launches"],
        # dx, dW, db against autograd through the twin, float32, all shapes.
        "backward_max_abs_err": k1_bwd["max_abs_err"],
        # The backward of one training frame step's 12 squeezes (N = 16,
        # 32 x 32 patches), against autograd through torch.cat + the
        # library's conv + prelu.
        "backward_ms": k1_bwd["per_step"]["backward_ms"],
        "backward_dx_ms": k1_bwd["per_step"]["dx_ms"],
        "backward_library_ms": k1_bwd["per_step"]["backward_library_ms"],
        "backward_bound_ms": k1_bwd["per_step"]["bound_ms"],
        "backward_bound_by": k1_bwd["per_step"]["bound_by"],
        # The same in bf16 under float32 master weights (bf16 training),
        # against autograd through torch.cat + the library's bf16 conv +
        # prelu; dx, dW, db against the bf16 twin's.
        "bf16_backward_max_abs_err": k1_bwd["bf16_max_abs_err"],
        "bf16_backward_ms": k1_bwd["per_step"]["bf16_backward_ms"],
        "bf16_backward_library_ms":
            k1_bwd["per_step"]["bf16_backward_library_ms"],
        "bf16_backward_bound_ms": k1_bwd["per_step"]["bf16_bound_ms"],
        "bf16_backward_bound_by": k1_bwd["per_step"]["bf16_bound_by"],
        # Device-epoch training of the DRF device config through K1 (bf16,
        # one captured CUDA graph a step): launches of the forward and of
        # the dx launch in the train steps, replays included (the counters'
        # calls per step x eager steps and replays; the trace counts them
        # per replay).
        "device_train_launches": device["k1_on"]["k1_launches"]["forward"],
        "device_backward_launches": device["k1_on"]["k1_launches"]["dx"],
        "device_trace_launches_per_step":
            device["k1_on"]["profile"]["trace_launches_per_step"]["k1"],
        # SRFBNet under AcdcSISRSRFBTrainer, kernel on (48 per train step
        # and per validation frame), and main --test on its checkpoint and
        # on DRFNet's.
        "srfb_train_launches": training["srfb"]["fused"]["launches"],
        "srfb_backward_launches":
            training["srfb"]["fused"]["backward_launches"],
        "srfb_test_launches": training["test"]["srfb"]["launches"],
        "vsr_test_launches": training["test"]["vsr"]["launches"],
        **routes("drf"),
        # Phase 7's checkpoint through the daemon's live backend.
        "live_checkpoint_launches": deploy["checkpoint"]["launches"],
        "max_abs_err": k1["f32_max_abs_err"],
        "ms": per_step["f32_ms"], "plain_ms": per_step["f32_plain_ms"],
        "bound_ms": per_step["f32_bound_ms"],
        "bound_by": per_step["f32_bound_by"],
        "library_ms": per_step["f32_plain_ms"],
        "bf16_max_abs_err": k1["bf16_max_abs_err"],
        "bf16_ms": per_step["bf16_ms"],
        "bf16_plain_ms": per_step["bf16_plain_ms"],
        "bf16_bound_ms": per_step["bf16_bound_ms"],
        "bf16_bound_by": per_step["bf16_bound_by"],
        # The same squeezes with the PReLU that follows each in the kernel's
        # epilogue, against torch.cat + the library's conv + prelu.
        "prelu_ms": per_step["f32_act_ms"],
        "prelu_library_ms": per_step["f32_act_library_ms"],
        "bf16_prelu_ms": per_step["bf16_act_ms"],
        "bf16_prelu_library_ms": per_step["bf16_act_library_ms"],
        # Phase 13: DRFNet --int8 (dequantized weights) and W8A8 (the
        # squeezes stay full precision), one volume each.
        "int8_launches": qdrf["f32_int8"]["launches"]["concat_conv1x1"],
        "w8a8_launches": qdrf["f32_scales"]["launches"]["concat_conv1x1"],
        # Phase 14: DRFNet with grad_accumulation 2, grad_clip and an EMA,
        # per micro-step (forward; dx in its backward), and infer --ema on
        # its checkpoint, a volume.
        "knobs_launches_per_micro_step":
            knobs["host_loop"]["straight"]["k1_launches_per_micro_step"],
        "ema_infer_launches": knobs["ema_infer"]["launches"],
        # Phase 15: the feedback family's launches (per train step, per
        # validation pass and per volume on each route).
        "feedback_launches": feedback_summary(feedback)["concat_conv1x1"],
        # Phase 16b: DRFNet under --preset tuned / fast, a volume.
        "preset_launches": preset_launches("concat_conv1x1"),
        # Phase 17: DRFNet trained on the tree the port's own preprocessing
        # wrote (forward; dx in its backward), then main --test on it.
        "offline_train_launches": offline["train"]["launches"],
        "offline_backward_launches": offline["train"]["backward_launches"],
        "offline_test_launches": offline["test"]["launches"],
        # Phase 18: DRFNet's epoch under DDP (one rank over NCCL: forward,
        # dx in its backward), and each rank's of two sharing the card over
        # gloo (plain data axis).
        "ddp_train_launches": parallel["a"]["k1_launches"]["forward"],
        "ddp_backward_launches": parallel["a"]["k1_launches"]["dx"],
        "gloo_rank_launches":
            parallel["b"]["ddp"]["k1_launches_per_rank"]["forward"],
        # Phase 19: DRFNet under infer --mesh data=1 (one NCCL rank, a
        # volume), then each of two gloo ranks under --mesh model=2 (F = 32,
        # one slice) and training with {model: 2} (forward; dx in its
        # backward), per rank.
        "mesh_data1_launches": mesh["a"]["k1_launches"],
        "mesh_model_rank_launches": [
            r["concat_conv1x1"]
            for r in mesh["b"]["drf"]["launches_per_rank"]],
        "mesh_model_train_rank_launches": [
            r["concat_conv1x1"]
            for r in mesh["c"]["drf"]["launches_per_rank"]],
        "mesh_model_backward_rank_launches": [
            r["concat_conv1x1_dx"]
            for r in mesh["c"]["drf"]["launches_per_rank"]],
    }, {
        # K1's weight and bias gradient (the JAX package computes them in
        # XLA, inside _bwd, so the line it replaces is no Pallas kernel): one
        # training frame step's 12 squeezes, N = 16, 32 x 32 and 64 x 64,
        # float32. Launches: the DRFNet training run's, then SRFBNet's.
        "name": "concat_conv1x1_dw", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/fused_squeeze_dw.cu",
        "replaces": "vsr_tpu/ops/fused_squeeze.py:104",
        "launches": training["vsr"]["fused"]["backward_launches"],
        "srfb_launches": training["srfb"]["fused"]["backward_launches"],
        "device_launches": device["k1_on"]["k1_launches"]["dw"],
        # Phase 14's DRFNet with the knobs, per micro-step.
        "knobs_launches_per_micro_step":
            knobs["host_loop"]["straight"]["k1_launches_per_micro_step"],
        # Phase 15: DRFSISRNet's training run, DRFNet's remat steps.
        "drfsisr_launches": feedback["drfsisr"]["train"]["backward_launches"],
        # Phase 17: the DRFNet trained on the port's own processed tree.
        "offline_launches": offline["train"]["backward_launches"],
        "drf_remat_launches": feedback["drf"]["remat"]["dw_launches"],
        # Phase 18: DRFNet's epoch under DDP (one rank over NCCL).
        "ddp_launches": parallel["a"]["k1_launches"]["dw"],
        # Phase 19c: DRFNet with {model: 2}, each of two gloo ranks (F = 32).
        "mesh_model_rank_launches": [
            r["concat_conv1x1_dw"]
            for r in mesh["c"]["drf"]["launches_per_rank"]],
        # Serving has no backward: phase 12 gates these at 0.
        "export_launches": 0, "serve_launches": 0, "stream_launches": 0,
        "max_abs_err": k1_bwd["dw_max_abs_err"],
        "ms": k1_bwd["per_step"]["dw_ms"],
        "plain_ms": k1_bwd["per_step"]["dw_plain_ms"],
        "bound_ms": k1_bwd["per_step"]["dw_bound_ms"],
        "bound_by": k1_bwd["per_step"]["dw_bound_by"],
        "bytes_bound_ms": k1_bwd["per_step"]["dw_bytes_bound_ms"],
        "library_ms": k1_bwd["per_step"]["dw_library_ms"],
    }, {
        # One --chunk 100 call: x (100, 96, 96), 5x5 filters, x2.
        "name": "duf_dynamic_filter", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/duf_filter.cu",
        "replaces": "vsr_tpu/ops/pallas_duf.py:72",
        "launches": launches("duf"),
        # Phase 13: DUFNet --w8a8 (its 3D convs through w8a8_conv), a volume.
        "w8a8_launches": quant["pipelines"]["duf"]["f32_w8a8"]["launches"][
            "duf_dynamic_filter"],
        # DUF under AcdcMISRTrainer: its validation pass (one launch a
        # window, none in the train steps), then main --test on the
        # checkpoint through AcdcMISRPredictor.
        "train_launches": sliced["duf"]["launches"],
        "test_launches": sliced["duf"]["test"]["launches"],
        **routes("duf"),
        "preset_launches": preset_launches("duf_dynamic_filter"),
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        # One MoE layer of a full volume: 43 200 rows of 256 affinities.
        "name": "pairwise_rank", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/pairwise_rank.cu",
        "replaces": "vsr_tpu/ops/rank.py:68",
        "launches": launches("moe"),
        # MoE-EDSR under AcdcSISRTrainer: every MoE layer of every train
        # step and validation forward.
        "train_launches": sliced["moe"]["rank_pallas"]["launches"],
        "train_launches_per_step":
            sliced["moe"]["rank_pallas"]["launches_per_train_step"],
        **routes("moe"),
        # Phase 15c: a volume under each router and dispatch (the sort and
        # radix routers replace the rank: 0).
        "feedback_launches": feedback_summary(feedback)["pairwise_rank"],
        "preset_launches": preset_launches("pairwise_rank"),
        # Phase 19: MoE-EDSR on one slice under --mesh expert=2 (the rows of
        # 2 of 4 experts), training with {expert: 2} and the daemon's
        # warm-up and requests, per rank of two gloo ranks.
        "mesh_expert_rank_launches": [
            r["pairwise_rank"] for r in mesh["b"]["moe"]["launches_per_rank"]],
        "mesh_expert_train_rank_launches": [
            r["pairwise_rank"] for r in mesh["c"]["moe"]["launches_per_rank"]],
        "mesh_daemon_rank_launches": mesh["d"]["launches_per_rank"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }, {
        # The W8A8 convolution (the JAX package leaves the s8 x s8 -> s32
        # conv of _w8a8_conv to XLA, so the line it replaces is no Pallas
        # kernel). Launches: EDSRNet --w8a8 on one volume (the main path),
        # then its other routes. Times: the most used eligible shape (EDSR's
        # 64 -> 64 3x3 over a volume's 300 LR frames), float32 in and out,
        # static scale; library: unfold + torch._int_mm of the int8
        # operands, the yardstick cuDNN's bf16 conv of the same shape.
        "name": "w8a8_conv", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/w8a8_conv.cu",
        "replaces": "vsr_tpu/quantize.py:272",
        "launches": qedsr["f32_w8a8"]["launches"]["w8a8_conv"],
        "scales_launches": qedsr["f32_scales"]["launches"]["w8a8_conv"],
        "bf16_launches": qedsr["bf16_w8a8"]["launches"]["w8a8_conv"],
        "drf_launches": qdrf["f32_scales"]["launches"]["w8a8_conv"],
        "duf_launches": quant["pipelines"]["duf"]["f32_w8a8"]["launches"][
            "w8a8_conv"],
        "export_launches": quant["deployment"]["w8a8"]["launches"],
        "serve_launches": quant["deployment"]["daemon"]["launches"],
        # Phase 14: the EDSRNet trained with qat served --w8a8, a volume.
        "qat_launches": knobs["qat"]["launches"],
        "shapes_checked": len(quant["shapes"]),
        "max_abs_err": max(r["max_abs_err"] for r in quant["shapes"]),
        "ms": qmain["ms"], "plain_ms": qmain["plain_ms"],
        "bound_ms": qmain["bound_ms"], "bound_by": qmain["bound_by"],
        "library_ms": qmain["library_ms"],
        "bf16_ms": qmain["bf16_ms"], "bf16_bound_ms": qmain["bf16_bound_ms"],
        "cudnn_bf16_ms": qmain["cudnn_bf16_ms"],
        # Phase 16b: --preset fast (W8A8 where the table says so), a volume.
        "preset_launches": preset_launches("w8a8_conv"),
        # Phase 16a: the transposed convs' sub-pixel banks
        # (quantize_deconvs), float32 in and out, dynamic scale.
        "deconv": pr["deconv"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
