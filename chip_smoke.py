"""GPU smoke run of the PyTorch/CUDA port (next3d_tpu_torch).

Usage, from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile] [--parent DIR]

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the hand-written kernels from csrc/ (one nvcc per source, all
     started together, sm_90a);
  3. the rasterizer kernels on the head through the flagship's 4 views at
     256^2, N = 4 (16 images), each against its plain torch version on the
     card, bit for bit: K1 (binned, (u, v)), K2 (binned, zbuf; its
     pix_to_face equal to K1's), K3 (16-px tiles; equal to K1), K5 (per-face
     z-buffer, patch 32; its pixels that differ from K1's are logged). The
     binned kernels' CUDA prep is held against the torch prep (the same
     segment starts, and the same entries in each segment, rows bit-equal)
     and timed alone beside it and beside the resolve kernel, which is also
     timed on one image alone and logged with its segment lengths and
     (pixel, candidate) test counts; K5's CUDA prep is held against its
     torch prep (face rows and stripe starts of the kept faces bit-equal),
     its face kernel and decode run apart against the wrapper, and each of
     its stages is timed alone beside the wrapper and the torch prep and
     logged with its (face, pixel) test counts; then K1, K2 and K3 again on
     the seeded adversarial mesh of utils/raster_cases.py at the same
     size, bit for bit against their plain versions, K3 equal to K1 and
     K2's pix_to_face to K1's, and K5 on its own seeded case set, bit for
     bit;
  4. K4, tri-plane sampling, against its plain version: planes
     (4, 3, 32, 256, 256) at the coarse-pass points of the FFHQ camera,
     with the channels-last layout pass timed alone;
  5. K6, the 8-row block gather, at (98304, 128) with 131072 indices, in
     bf16 and f32, bit for bit;
  6. the 512^2 FFHQ forward (mapping + synthesis, port-native random init)
     at batch 1 and 4, with the kernels' launch counters;
  7. synthesis_from_identity over 3 frames with the identity cached;
  8. median img/s at batch 1 and 4;
  9. the texture variant (TriPlaneTextureGenerator) on the same config:
     forward at batch 1 and 4, K2's launches, median img/s;
 10. the flagship at batch 4 with rasterizer_impl 'pallas_binned16' (K3;
     images equal to phase 6's) and 'pallas' (K5; image within 1e-4
     mean-abs of phase 6's);
 11. with --profile only, for the flagship (after phase 8) and the texture
     variant (in phase 9): the forward's stages in ms at batch 1 and 4, and
     the device-busy share of 3 forwards from torch.profiler; after phase
     13, each training phase of one batch under torch.profiler, with its
     device time and its heaviest ops;
 12. the inference CLIs (next3d_tpu_torch/cli/main.py run) on the card, from
     a format-1 snapshot of phase 6's weights with the 512^2 config's
     G_kwargs and the head written as .obj and _kpt2d.txt files in a
     temporary directory: the generator loaded from the snapshot against
     phase 6's on phase 10's inputs (within phase 10's run-to-run spread),
     gen-samples of seeds 0-1 with 256^3 shapes, reenact over 16 jittered
     driving frames and gen-videos of a 2x2 grid over 8 frames, each
     output checked and each command's K1 and K4 launches counted; K4 at
     the shape path's chunk against its plain version; K4 raising for
     coordinates that require grad (its backward gives the planes'
     gradient only). It logs gen-samples s/seed, the sigma grid's s and
     points/s, reenact f/s with and without the frame writes and
     gen-videos f/s, each beside the card's name and power limit;
 13. training: after phase 6, K4's backward (csrc/triplane_sample.cu
     triplane_sample_backward, the planes' gradient, taps merged along runs
     of points before its float4 atomics) on four sets of points of 4
     images with planes (4, 3, 32, 256, 256): (a) phase 4's coarse points,
     (b) the same rays with jittered depths, as training draws them, (c) the
     fine pass's points of phase 6's forward at batch 4, (d) every point in
     one texel (the worst pile-up), and (a)'s points in a shuffled order
     (the same taps, each texel's hits spread over the launch: a probe of
     the atomics' contention). Each set against its plain version (index_add_
     of the 4 taps) and torch.ops.aten.grid_sampler_2d_backward, both adding
     in float64 at the kernel's sample positions, within 1e-5 of the
     largest gradient (the float32 plain
     version's and library's own gaps to them are logged), timed (CUDA
     events, and profiler device time of the wrapper and of the kernel
     alone) beside the float32 plain version and library and, with
     ``--parent DIR``, beside the K4 backward of another checkout, built and
     bound by that checkout's own ops/cuda_build.py; with the in-range taps
     and the atomics the kernel issues (ops/triplane.py merge_plain). Then
     the coordinates guard. At the end,
     ``python -m next3d_tpu_torch.cli.main train`` run in-process on the
     card at the 512^2 FFHQ config (channel_base 32768, channel_max 512,
     48+48 samples, 256^2 planes, 8XDC, neural rendering resolution 64),
     batch 4, on a toy dataset in a temporary directory (8 of phase 6's
     generator's images as PNGs, the head's .obj and landmarks per item,
     FFHQ camera labels): 17 batches (all four phases run at batch 0, and
     Dreg again at batch 16), a snapshot, and a resume from it for one more
     tick. It fails unless every loss and gradient norm is finite, G, D
     and G_ema moved from their initialization, K1, K4 and K4's backward
     launched, the snapshot loads into TriPlaneGenerator with finite
     images, and the resumed run continues cur_nimg. It logs ms a phase
     (the first batch, and the second tick's mean, warm), the warm tick's
     img/s and torch.cuda.max_memory_allocated beside the card's name and
     power limit, and a {"train": ...} line;
 14. bf16 serving (force_fp32=False, the JAX package's serving fast path):
     K4's bf16-plane instance (csrc/triplane_sample.cu, planes stored in
     bf16, float32 sums and output) at phase 4's shapes against its plain
     version within 1e-5, timed beside the float32 instance, the plain
     version and the bf16 layout pass alone; then both generators with
     force_fp32=False and the weights of phases 6 and 9: the 512^2 forward
     at batch 1 and 4 (the flagship also at 8, bench.py's default batch),
     each finite, with K4's bf16 instance launched and its float32 one not,
     against the fp32 forward on the same inputs by the bounds of
     tests/test_bf16_parity.py (image max-abs 0.05 and PSNR 45 dB,
     image_raw 0.02 and 55 dB; whether they hold is logged), and stage by
     stage at batch 1 (the texture, the static plane, the rasterized front
     and the mouth and blend StyleUNets, the planes, image_raw and image,
     and render + SR of the fp32 planes alone), failing where a stage's
     RMS gap is more than 5% of its scale (a fault, not rounding); img/s of
     the fp32 and the bf16 forward at each batch; the flagship's
     identity-cached reenact path (synthesis_from_identity) over 16
     jittered frames in fp32 and bf16, f/s, the bf16 frame 0 against the
     bf16 synthesis within 1e-4 under deterministic cuDNN. It ends with a
     {"bf16": ...} line;
 15. the train command's other configurations, at phase 13's config on its
     dataset: the augment pipe of ``--aug`` (train/augment.py, the
     reference's blit, geometric and colour transforms) at the 512^2 Dmain
     input (batch 4, 6 channels, p=0.6) on the card against the CPU on the
     same draws (within PIPE_TOL), timed with its draws, alone and with its
     gradient; the texture variant's first Gmain loss (the command's
     networks at their seed, constant noise, batch 1) on the card against
     the CPU (within TEXTURE_GMAIN_TOL); then in-process (a) ``train
     --model-version texture --aug ada``, batch 4, 17 batches (Greg, Dreg
     and the EMA run, the ADA controller moves p at 4 batches), which must
     launch K2, K4 and K4's backward and not K1, and (b) ``train
     --dataset-type video --num-frames-per-video 2`` on the flagship, 2
     clips of 2 frames a batch, 6 batches, on 2 clips of 4 of phase 13's
     frames, which must launch K1, K4 and K4's backward. Each run fails on
     a stat that is not finite or a phase that did not run, and logs its
     last tick's img/s (frames/s for clips), ms a phase (the first batch
     and the last tick), peak memory, launches and ada_p, beside the card's
     name and power limit. It ends with a {"train_variants": ...} line;
 16. checkpoint interop, at the 512^2 FFHQ config in phase 13's temporary
     directory (check_checkpoints): (a) phase 6's flagship written as a
     reference-format Next3D .pkl (persistence-wrapped modules with
     torch-tensor leaves, the reference's init_kwargs, training_set_kwargs
     and augment_pipe, and a buffer the port does not have), read by
     load_any_generator (timed), against phase 10's batch-4 forward within
     its run-to-run spread, and reenact over 16 frames and gen-samples of
     one seed from it, each launching K1 and K4; (b) an EG3D-format .pkl
     (backbone, superresolution and decoder of phase 6's G_ema, and a D):
     ``train --resume eg3d.pkl`` at phase 13's config for one tick of 4
     batches of 4, the warm-started networks checked just after the load
     (the init with the donor's leaves wherever a name and a shape match,
     D the donor's), every phase run, K4 and its backward launched, every
     stat finite; (c) a JAX-layout format-1 snapshot (optax's class names)
     of (b)'s networks and Adam states, resumed with its Adam states equal
     to the source's, for one batch; a params_G_ema-only snapshot resumed;
     (d) (b)'s TensorBoard scalars equal to its stats.jsonl. It logs the
     .pkl load time, reenact f/s from the .pkl beside phase 12's, the
     warm-started run's img/s and peak memory, beside the card's name and
     power limit, and a {"checkpoints": ...} line;
 17. metrics, at the 512^2 FFHQ config in phase 13's temporary directory
     (check_metrics), on a dataset of 64 of phase 6's flagship's images
     (write_metric_data): (a) the port's Inception-2015 graph
     (metrics/inception.py) of seeded weights on the card against the CPU
     on the same uint8 batches at 512^2 and 128^2, TF32 off (features
     within INCEPTION_FEATURE_REL of the largest, IS probabilities within
     INCEPTION_PROBS_TOL), scripted by torch.jit.script into a TorchScript
     file with the reference detector's calling convention that
     NEXT3D_INCEPTION_PATH then names, converted and attested on the card;
     the detector's img/s at batch 16 alone and with its features returned
     to the host; (b) ``calc-metrics --metrics fid256_full --batch 16``
     (fid2k_full's code on 256 generated images, registered by the
     script) on a format-1 snapshot of phase 6's flagship: a finite record
     in metric-fid256_full.jsonl, its wall time, peak memory and K1 and K4
     launches; the feature loop's img/s (320 images at batch 16) beside
     the generator's alone; KID, PR and IS over 256 generated images, each
     finite; (c) ``train --metrics fid256_full`` at phase 13's config,
     two ticks of one batch of 4 with a snapshot after the second: its
     record in metric-fid256_full.jsonl (the hook prints a failure and
     trains on, so the record decides), finite, with its launches. It ends
     with a {"metrics": ...} line.
 18. bf16 training, remat and the bench: (a) K4's bf16 backward, the
     binned kernels of csrc/triplane_backward_binned.cu (the autograd
     Function's backward for bf16 planes under grad mode), planes' gradient
     (4, 3, 256, 256, 32) bf16, on phase 13's point sets: the coarse,
     jittered and fine-pass points, one texel, and the coarse points
     shuffled; each against the plain version (the float32 plain backward
     cast to bf16) within one bf16 ulp (BF16_ULP of each value) plus 1e-5
     of the largest gradient (the two add in float32 in different orders
     before the rounding), its tile counts equal to ops/triplane.py
     bin_counts, timed (CUDA events, profiler device time, each stage's
     device time) beside the chain it replaces (the float32 backward
     kernel and a cast), the plain version and grid_sampler_2d_backward on
     the planes upcast, with its entries, duplicates, largest tile and
     chunks logged; then the coarse set through the autograd Function
     against the plain version's autograd gradient of the same bf16
     planes, with one launch;
     (b) one Gmain of phase 6's flagship at batch 4, fp32, random noise and
     depths from a device generator of one seed, with remat_synthesis off
     and on (each run twice, the second timed): the losses within
     REMAT_LOSS_REL, G's gradients within REMAT_GRAD_REL relative L2 (K4's
     backward adds with atomics, so the card gives no bit-equality; the
     spread of two runs without remat is logged beside it), each with its
     ms, peak device memory and K1 launches (the recompute adds one);
     (c) ``python3 -m next3d_tpu_torch.bench`` in subprocesses at
     NEXT3D_BENCH_ITERS=4, batch 8 (BENCH_RUNS): synthesis, reenact and
     train in bf16, train in fp32, each printing one JSON line with a
     finite, positive value; the step times, peak memory and kernel
     launches each reports on stderr are logged. It ends with a
     {"bench": ...} line.
 19. data-parallel training (next3d_tpu_torch/parallel/): (a) the train
     command's rank entry (cli/train.py run_rank) at world size 1 over
     NCCL, at phase 13's config (512^2 FFHQ flagship, batch 4), 8 batches
     in 2 ticks and a snapshot: the replica check runs at the snapshot and
     passes, rank 0 alone wrote the run directory (its files, one events
     file, a stats line a tick), every stat finite, K1, K4 and K4's
     backward launched; img/s beside phase 13's, each phase's all-reduce
     ms (Timing/<phase>/allreduce, synchronized) and its bucket's MiB,
     peak memory; (b) two ranks on the one card over gloo (NCCL refuses
     two ranks on one device), each its own process: the 512^2 flagship in
     fp32 and a 512^2 dual discriminator, global batch 4 (2 a rank), the
     parity tests' deterministic loss, Gmain, Greg, Dmain and Dreg at
     learning rate 0: each all-reduced gradient against this process's
     mean over the two halves on the same weights, within
     tests/torch_train_parity.py assert_grads_match's bounds (grads_gate;
     Greg's by its norm), each loss within 1e-4 relative and equal on both
     ranks; then run_phases at the train command's learning rates, after
     which both ranks' G, D and G_ema are bit-equal; the all-reduce ms;
     (c) ``train --gpus N`` for one card more than visible raises, naming
     both counts. It ends with a {"parallel": ...} line.
 20. the EG3D and StyleGAN3 families (check_model_families): (a)
     EG3DTriPlaneGenerator at the FFHQ 512^2 config (8XDC, 48+48 samples,
     sr_num_fp16_res 4, fp32): K4's 2 launches a forward, image /
     image_raw / image_depth against the same forward on K4's plain
     version (EG3D_PLAIN_MAX_ABS, EG3D_PLAIN_MEAN_ABS), img/s at batch 1
     and 4, peak memory; (b) SG3Generator, StyleGAN3-T at 256^2
     (SG3_T_256), fp32: img/s at batch 1 and 4, peak memory, and the
     device ms of its filtered_lrelu calls in one batch-4 forward against
     the whole forward's; (c) eqt50k_int, eqt50k_frac and eqr50k through
     the metric registry on (b)'s G, cut to EQ_SAMPLES samples at batch
     EQ_BATCH: finite PSNRs, seconds; (d) sample_cross_section at 256^2 on
     phase 6's flagship, batch 1: ms, K1's and K4's launches, sigma against
     the plain K1 and K4 (CROSS_SECTION_MAX_ABS); (e) ``train --resolution
     256`` (SuperresolutionHybrid4X) on phase 13's images resized to
     256^2, 2 batches of 4 through train_run. It ends with a
     {"model_families": ...} line.
 21. the 'tiled' and 'scatter' rasterizers (render/rasterizer.py, plain
     torch ports of the JAX package's XLA compositions, no kernel) and the
     JAX package's rasterizer selection (check_rasterizer_selection): (a)
     both on phase 3's input (16 images at 256^2; 'scatter' at
     __graft_entry__'s face chunk 9976, 'tiled' at two tile steps) on the
     card against the same calls on the CPU, pix_to_face and zbuf bit for
     bit, each against K2's pix_to_face, timed beside K2's wrapper; (b)
     the flagship and the texture variant built with each on phase 6's and
     phase 9's weights: forwards at batch 1 and 4, finite, no binned
     kernel and K4 twice a forward, img/s and peak memory, the image's gap
     to the default forward and the pixels whose face differs from K1's
     (K2's); (c) 'auto' at 1024^2 planes falls back to 'tiled' with the
     JAX rule's capacity in both generators, and the texture variant runs
     a batch-1 forward (img/s, peak memory; the flagship's StyleUNets take
     no planes above 256^2, in either package); at 96^2, which no
     generator can be built at (the backbones take powers of two), the
     selection alone. It ends with a {"rasterizers": ...} line.
 22. the full-scale gate (check_full_scale): phase 6's flagship, phase 9's
     texture variant and phase 20's EG3D against CPU twins built from the
     same seed (state_dicts equal), at batch 2 on
     tests/test_torch_full_scale.py's inputs (the head and an expression
     jittered by 0.002 from numpy seed 0), the card under deterministic
     cuDNN with TF32 off, the CPU asked for explicitly: image and
     image_raw within max-abs 2e-3 and mean-abs 1e-4, image_depth within
     4e-3 and 2e-4 (FULL_SCALE_FP32); K1's pix_to_face equal on every
     pixel (K2's logged); on the card K1 >= 1 and K4 >= 2 launches
     (flagship), K2 >= 1 and K4 >= 2 (texture variant), K4 >= 2 (EG3D), on
     the CPU none; the flagship in bf16 on the card and on the CPU, each
     against the CPU's fp32 forward: the JAX tool's bounds logged with
     their verdict (FULL_SCALE_BF16), the card's max-abs and mean-abs
     within FULL_SCALE_BF16_REL times the CPU bf16's. It ends with a
     {"full_scale": ...} line: each generator's gaps (max-abs, mean-abs,
     the 99.9% quantile, PSNR), pixels apart, launches and each side's
     seconds. Then a {"phase_s": ..., "total_s": ...} line with each
     phase's seconds.

Every kernel is timed by CUDA events beside its plain version and, where
one PyTorch call computes the same function, that call (library_ms); the
binned kernels also carry their CUDA prep's time alone (prep_ms) and K4 the
channels-last layout pass's (layout_ms, one pass serves a forward's 2
launches). Its bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its float32 operations on this run's data
over 67 TFLOP/s, the H100 SXM's published peaks. For the binned kernels
those operations are 12 a (pixel, kept face) pair inside the face's pixel
bbox (pairs_bbox); bound_ms_all_pairs keeps the first design's count, every
pixel of a tile against every candidate of its segment (pairs_all), and
pairs_culled counts the pairs that the candidates surviving the kernels'
coarse test cost. K5 counts 23 operations a (kept face, pixel) pair inside
the face's bbox and its stripe (pairs_bbox); its bound_ms_all_pairs keeps
its first design's count, every stripe pixel of each kept face
(pairs_stripe), and pairs_walked counts the pixels of the sub-tiles that
its face kernel's coarse levels keep. K5 also carries the time alone of its
CUDA prep (prep_ms), its torch prep (torch_prep_ms), its face kernel
(faces_ms) and its decode (decode_ms), each with its profiler device time
(*_device_ms), and the wrapper's device time (wrapper_device_ms).

K4's backward carries the same keys, from point set (a): its bound is the
bytes of the output gradient and the points read once and the planes'
gradient written once, its library call grid_sampler_2d_backward on the
channels-first planes, and its launches those of phase 13's first training
run. It adds device_ms, kernel_device_ms, taps, atomics, parent_ms and
parent_device_ms (null without --parent), and 'sets': each point set's
numbers.

K4's bf16 backward (K4b_bf16) carries the same keys, from phase 18 (a)'s
coarse set: its bound is the bytes of the output gradient and the points
read once and the bf16 gradient written once, its library call
grid_sampler_2d_backward on the channels-first planes upcast, its plain_ms
the plain backward and the cast, and its launches those of phase 18's bf16
train bench. It adds device_ms, kernel_device_ms (the memset left out),
stage_device_ms (each stage's mean over the profiled_calls that the trace
kept), chain_ms and
chain_device_ms (the float32 kernel and the cast it replaces), the
binning's counts (entries, duplicates, largest_tile, chunks, split_tiles),
taps, and 'sets': each point set's numbers.

K4's bf16 instance (K4bf16) carries the same keys, from phase 14: its
bound is the bf16 planes, the points and the float32 output, its launches
those of phase 14's bf16 forwards, library_ms is null (no one PyTorch call
samples bf16 planes at float32 points: F.grid_sample takes one dtype for
both, 'library' says so), and it adds float32_instance_ms, layout_ms (the
bf16 layout pass) and layout_float32_ms.

``--parent DIR`` takes another checkout inside this one, such as ``git
archive`` of the parent commit unpacked into ``build/parent`` (git-ignored).

The head is the mesh that NEXT3D_TOPOLOGY names (an .obj with UVs and a
``<name>_kpt2d.txt`` landmark file beside it) when that file exists, else
the in-repo synthetic head. The run uses no JAX. It ends with a
{"train": ...} line, a {"train_variants": ...} line, a {"bf16": ...}
line, a {"checkpoints": ...} line, a {"metrics": ...} line, a
{"bench": ...} line, a {"parallel": ...} line, a {"model_families": ...}
line, a {"rasterizers": ...} line, a {"full_scale": ...} line, the
{"phase_s": ...} line, the card line, a JSON object with one entry per
kernel (K1, K2, K4 and K4's backward with their training launches: phase
13's, and for K2 phase 15's texture run; K1, K4 and K4's backward with
phase 16's and phase 17's launches a command, phase 19 (a)'s and phase
20's by path; K4's bf16 backward with phase 18's bf16 train bench) and
the result line {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

T_START = time.time()

# the FFHQ 512^2 rendering config of __graft_entry__.py:10-18 and the
# generator's construction kwargs, as a snapshot stores them; the card's
# nvidia-smi name and power limit
from next3d_tpu_torch.bench import G_KWARGS, RENDER_KW_FFHQ, card_line

SEED = 0
CSRC = 'next3d_tpu_torch/csrc/'
LIBRARIES = ('raster_binned_uv', 'raster_binned_prep', 'triplane_sample',
             'triplane_backward_binned', 'raster_zbuffer',
             'gather_row_blocks', 'upfirdn2d')
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12   # H100 SXM float32 outside the tensor cores
# float32 operations a (pixel, candidate) pair needs in the binned kernels:
# three edge planes, c + x*gx + y*gy each
OPS_BINNED_PAIR = 12
# ... and a (face, pixel) test in K5: three edge functions with the face's
# differences hoisted (2 sub, a mul and an fma of 2 operations each), 3
# barycentric scalings and the depth (a mul and 2 fmas)
OPS_ZBUFFER_TEST = 23

# bf16 serving: the bounds of tests/test_bf16_parity.py on a bf16 forward
# against the fp32 forward (max-abs, PSNR over a [-1, 1] range)
BF16_BOUNDS = {'image': (0.05, 45.0), 'image_raw': (0.02, 55.0)}
# phase 18: one bf16 ulp relative to a value's magnitude (at most): K4's
# bf16 backward and the plain version's may round a float32 sum apart
BF16_ULP = 2.0 ** -7
# phase 18: remat on against off on the card, Gmain of the 512^2 flagship
# at batch 4 in fp32: the loss (the same forward), and G's gradient by
# relative L2. K4's backward adds with float atomics and cuDNN's backward
# algorithms need not be deterministic, so two runs without remat differ
# too, by about a tenth of this bound (phase 18 logs that spread beside
# the gap)
REMAT_LOSS_REL = 1e-5
REMAT_GRAD_REL = 1e-3
# phase 18: the bench runs (mode, NEXT3D_BENCH_BF16), each at batch 8 and
# NEXT3D_BENCH_ITERS=4, and the time limit of each
BENCH_RUNS = (('synthesis', '1'), ('reenact', '1'), ('train', '1'),
              ('train', '0'))
BENCH_TIMEOUT_S = 420
# a stage of the bf16 forward whose RMS gap to its fp32 stage is more than
# this share of the fp32 stage's largest magnitude is a fault (a wrong
# layout or weight moves it by tens of percent), not bf16's rounding (an
# RMS gap of 0.1-0.5% and a max-abs gap of 1-3% at each stage of the small
# CPU configuration, tests/test_torch_bf16.py)
BF16_STAGE_FAULT = 0.05


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(fn, reps=10):
    """The device durations in ms of each kernel (and memset) that
    ``reps`` calls of ``fn()`` ran, by name, from a torch.profiler trace
    (time the device spent idle between them is left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return times


def device_ms(fn, reps=10, kernel=None):
    """Mean device time of ``fn()`` in ms: the summed durations of the
    kernels and memsets it ran (only those whose name holds ``kernel``,
    if given)."""
    return sum(sum(ms) for name, ms in device_times(fn, reps).items()
               if kernel is None or kernel in name) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """The least time of the work on the card, and what sets it."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / PEAK_F32_FLOP_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by='bytes' if by_bytes >= by_ops else 'operations')


def load_head():
    from next3d_tpu_torch.utils.obj_io import load_lms, load_obj
    from next3d_tpu_torch.utils.synthetic_head import synthetic_head
    path = os.environ.get('NEXT3D_TOPOLOGY')
    if path and os.path.exists(path):
        log(f'head: {path}')
        return load_obj(path), load_lms(os.path.splitext(path)[0]
                                        + '_kpt2d.txt')
    log('head: in-repo synthetic head (next3d_tpu_torch/utils/'
        'synthetic_head.py)')
    return synthetic_head()


def head_batch(mesh, lms, n, device, jitter=0.002):
    """(n, 5023 + 68, 3): the neutral head, then jittered expressions."""
    import numpy as np
    v = np.concatenate([mesh.verts, lms])[None].astype(np.float32)
    rs = np.random.RandomState(SEED)
    noise = rs.randn(n, *v.shape[1:]).astype(np.float32) * jitter
    noise[0] = 0
    return torch.from_numpy(v + noise).to(device)


def ffhq_camera(n, device):
    from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                      lookat_pose)
    cam = lookat_pose(math.pi / 2, math.pi / 2, [0, 0, 0.2], radius=2.7,
                      batch_size=n, device=device)
    K = torch.from_numpy(fov_to_intrinsics(18.837)).to(device)
    return torch.cat([cam.reshape(n, 16), K.reshape(1, 9).expand(n, 9)], 1)


def binned_pairs(verts, faces, attrs, image_size, tile):
    """(pixel, candidate) pairs of every pixel of each tile with every
    candidate of its segment: the tests of the binned resolve's first
    design, which that design's bound counted."""
    from next3d_tpu_torch.ops.raster import binned_prep
    _, starts = binned_prep(verts, faces, attrs, image_size, tile)
    return int((starts[:, -1] - starts[:, 0]).sum()) * tile * tile


def bbox_pairs(verts, faces, image_size):
    """(pixel, kept face) pairs inside each kept face's pixel bbox, cut to
    the image, from the prep's corner coordinates: the per-pixel tests the
    binned resolve needs for these inputs."""
    from next3d_tpu_torch.ops.raster import face_corners
    fx, fy, _, area = face_corners(verts, faces, image_size)

    def pixels(c):
        return (torch.floor(c.amax(-1)).clamp(max=image_size - 1)
                - torch.ceil(c.amin(-1)).clamp(min=0) + 1).clamp(min=0)
    return int((pixels(fx) * pixels(fy) * (area > 1e-8)).sum())


def zbuffer_pairs(verts, faces, image_size, patch):
    """K5's (face, pixel) tests for these inputs: every stripe pixel of
    each kept face (pairs_stripe, the first design's tests), the kept
    faces' bbox pixels inside the image and their stripes (pairs_bbox, the
    bound's count) and the pixels of the sub-tiles that survive the face
    kernel's two coarse levels (pairs_walked, what the kernel tests), with
    the corner tests of each level (strip_tests, sub_tile_tests)."""
    from next3d_tpu_torch.ops.raster_zbuffer import (SUB_H, SUB_W,
                                                     cull_plain, zbuffer_prep)
    data, y0, stripe_h = zbuffer_prep(verts, faces, image_size, patch)
    x, y = data[:, 0:3], data[:, 3:6]
    cols = (torch.floor(x.amax(1)).clamp(max=image_size - 1)
            - torch.ceil(x.amin(1)).clamp(min=0) + 1).clamp(min=0)
    rows = (torch.minimum(torch.floor(y.amax(1)), y0 + stripe_h - 1.0)
            - torch.maximum(torch.ceil(y.amin(1)), y0.float()) + 1
            ).clamp(min=0)
    item, strips, subs = cull_plain(data, y0, image_size, stripe_h)
    return dict(pairs_stripe=item.numel() * stripe_h * image_size,
                pairs_bbox=int((cols * rows * (data[:, 9] > 0)).sum()),
                pairs_walked=int(subs.sum()) * SUB_W * SUB_H,
                strip_tests=strips.numel(),
                sub_tile_tests=int(strips.sum()) * (stripe_h // SUB_H))


def zbuffer_stages(want, verts, faces, image_size, patch):
    """K5's CUDA prep against the torch prep (the same faces kept, their
    face rows and stripe starts bit-equal), its face kernel and decode run
    apart against the wrapper's result ``want``, then each stage timed
    alone by CUDA events and by profiler device time: the CUDA prep, the
    torch prep, the face kernel (by events on keys it already holds, on
    the device after a refill of the keys each call) and the decode; and
    the wrapper's device time, its four launches together."""
    from next3d_tpu_torch.ops import raster_zbuffer as rz
    args = (verts, faces, image_size, patch)
    data, y0, stripe_h = rz.zbuffer_prep_cuda(*args)
    want_data, want_y0, _ = rz.zbuffer_prep(*args)
    kept = want_data[:, 9] > 0
    B, H = verts.shape[0], image_size
    keys = torch.full((B, H, H), rz.KEY_EMPTY, dtype=torch.int64,
                      device=verts.device)
    pf = torch.empty((B, H, H), dtype=torch.int32, device=verts.device)
    zbuf = torch.empty((B, H, H), dtype=torch.float32, device=verts.device)

    def faces_only():
        rz._launch_zbuffer(data, y0, keys, pf, zbuf, stripe_h, rz.FACES)

    def faces_fresh():
        keys.fill_(rz.KEY_EMPTY)
        faces_only()

    def decode():
        rz._launch_zbuffer(data, y0, keys, pf, zbuf, stripe_h, rz.DECODE)

    faces_fresh()
    decode()
    torch.cuda.synchronize()
    same = torch.equal(data[:, 9] > 0, kept) and torch.equal(
        data.permute(0, 2, 1)[kept], want_data.permute(0, 2, 1)[kept]) \
        and torch.equal(y0[kept], want_y0[kept])
    staged = torch.equal(pf, want[0]) and torch.equal(zbuf, want[1])
    out = dict(
        prep_ms=time_ms(lambda: rz.zbuffer_prep_cuda(*args)),
        prep_device_ms=device_ms(lambda: rz.zbuffer_prep_cuda(*args)),
        torch_prep_ms=time_ms(lambda: rz.zbuffer_prep(*args)),
        faces_ms=time_ms(faces_only),
        faces_device_ms=device_ms(faces_fresh, kernel='zbuffer_faces'),
        decode_ms=time_ms(decode), decode_device_ms=device_ms(decode),
        wrapper_device_ms=device_ms(lambda: rz.rasterize_zbuffer(*args)))
    log(f'K5 stages: CUDA prep equal to the torch prep on the '
        f'{int(kept.sum())} kept faces {same}, face kernel + decode equal to '
        f'the wrapper {staged}; CUDA prep {out["prep_ms"]:.4f} ms '
        f'({out["prep_device_ms"]:.4f} on the device), torch prep '
        f'{out["torch_prep_ms"]:.3f} ms, face kernel {out["faces_ms"]:.4f} '
        f'ms ({out["faces_device_ms"]:.4f}), decode {out["decode_ms"]:.4f} '
        f'ms ({out["decode_device_ms"]:.4f}), wrapper on the device '
        f'{out["wrapper_device_ms"]:.4f} ms')
    if not (same and staged):
        raise RuntimeError('K5 CUDA prep or stages disagree')
    return out


def check_rasterizers(G, v):
    """Phase 3: K1, K2, K3 and K5 on the flagship's 16-image rasterizer
    input, each bit for bit against its plain version."""
    from next3d_tpu_torch.ops import raster, raster_zbuffer
    tv, _ = G.project_views(v[:, :5023], v[:, 5023:])
    tv = tv.contiguous()
    res = G.uv_resolution
    uv_args = (tv, G.faces, G.face_uv[None], res)
    in_bytes = nbytes(tv, G.faces)
    out_img = tv.shape[0] * res * res * 4
    results = {}

    def record(name, got, want, fn, plain, n_bytes, n_ops, reps=3):
        torch.cuda.synchronize()
        mismatch = [int((a != b).sum()) for a, b in zip(got, want)]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[1:], want[1:]))
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=reps, warmup=1)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, **bound(n_bytes, n_ops))
        log(f'{name}: {tuple(tv.shape[:1])} images at {res}^2: mismatching '
            f'elements {mismatch}, max-abs {err:.3g}; wrapper {ms:.3f} ms, '
            f'plain {plain_ms:.3f} ms, bound {results[name]["bound_ms"]:.4f}'
            f' ms by {results[name]["bound_by"]}')
        if any(mismatch):
            raise RuntimeError(f'{name} disagrees with its plain version')

    def check_prep(name, args, tile, counted):
        """The CUDA prep against the torch prep, then each timed alone
        beside the resolve kernel (on all images and on the first alone);
        returns those times, the longest segment and the (pixel, candidate)
        tests that the candidates surviving the coarse test cost."""
        slab, starts = raster.binned_prep_cuda(*args, tile)
        want_slab, want_starts = raster.binned_prep(*args, tile)
        torch.cuda.synchronize()
        same_starts = torch.equal(starts, want_starts)
        same_rows = same_starts and all(
            torch.equal(a, b[:, :a.shape[1]]) for a, b in zip(
                raster.segments_in_face_order(slab, starts), want_slab))
        prep_ms = time_ms(lambda: raster.binned_prep_cuda(*args, tile))
        torch_ms = time_ms(lambda: raster.binned_prep(*args, tile))
        resolve_ms = time_ms(lambda: raster._resolve_cuda(
            slab, starts, res, tile, counted))
        resolve_one_ms = time_ms(lambda: raster._resolve_cuda(
            slab[:1], starts[:1], res, tile, counted))
        prep_device_ms = device_ms(lambda: raster.binned_prep_cuda(*args,
                                                                   tile))
        resolve_device = device_ms(lambda: raster._resolve_cuda(
            slab, starts, res, tile, counted))
        resolve_one_device = device_ms(lambda: raster._resolve_cuda(
            slab[:1], starts[:1], res, tile, counted))
        per_image = (starts[:, 1:] - starts[:, :-1]).amax(1).tolist()
        entries = int(starts[:, -1].sum())
        keep = raster.cull_plain(slab, starts, res, tile)     # (B, E, S)
        culled = int(keep.sum()) * raster.SUB_W * raster.SUB_H
        # the survivors of each (image, tile, sub-tile): one warp's chain
        pos = torch.arange(keep.shape[1], device=keep.device)
        t_of = torch.searchsorted(starts.long(), pos.expand(
            len(starts), -1).contiguous(), right=True) - 1
        per_sub = torch.zeros(starts.shape + keep.shape[-1:],
                              dtype=torch.long, device=keep.device)
        per_sub.scatter_add_(1, t_of[..., None].expand_as(keep),
                             keep.long())
        max_sub = int(per_sub[:, :-1].max())
        log(f'{name} prep: starts equal {same_starts}, segments equal '
            f'{same_rows}, {entries} entries, max tile segment '
            f'{max(per_image)}; CUDA prep {prep_ms:.3f} ms '
            f'({prep_device_ms:.3f} ms of it on the device), torch prep '
            f'{torch_ms:.3f} ms, resolve kernel {resolve_ms:.4f} ms '
            f'({resolve_device:.4f} ms on the device)')
        log(f'{name} resolve: max segment per image {per_image}; on the '
            f'device {1e6 * resolve_device / entries:.3f} ns an entry of '
            f'all {len(per_image)} images, '
            f'{1e6 * resolve_device / max(per_image):.1f} ns an entry of '
            f'the longest segment; image 0 alone {resolve_one_ms:.4f} ms '
            f'({resolve_one_device:.4f} ms on the device; max segment '
            f'{per_image[0]}); the surviving candidates cost {culled} '
            f'(pixel, candidate) tests, at most {max_sub} in one sub-tile')
        if not same_rows:
            raise RuntimeError(f'{name} CUDA prep disagrees with the torch '
                               f'prep')
        return dict(prep_ms=prep_ms, resolve_ms=resolve_ms,
                    resolve_device_ms=resolve_device,
                    resolve_one_image_ms=resolve_one_ms,
                    resolve_one_image_device_ms=resolve_one_device,
                    max_segment=max(per_image), pairs_culled=culled,
                    max_sub_tile_survivors=max_sub)

    def pair_counts(name, n_bytes, pairs_all, pairs_bbox):
        """The old and the new pair counts, and the first design's bound."""
        results[name].update(
            pairs_all=pairs_all, pairs_bbox=pairs_bbox,
            bound_ms_all_pairs=bound(n_bytes, OPS_BINNED_PAIR
                                     * pairs_all)['bound_ms'])
        log(f'{name} pairs: every tile pixel x every candidate {pairs_all}, '
            f'inside the kept faces\' bboxes {pairs_bbox}, surviving the '
            f'coarse test {results[name]["pairs_culled"]}')

    pairs_bbox = bbox_pairs(tv, G.faces, res)

    k1 = raster.rasterize_binned_uv(*uv_args)
    k1_plain = raster.rasterize_binned_uv_plain(*uv_args)
    log(f'K1 coverage {float((k1[0] >= 0).float().mean()):.3f}')
    uv_bytes = in_bytes + nbytes(G.face_uv) + 3 * out_img
    record('K1', k1, k1_plain, lambda: raster.rasterize_binned_uv(*uv_args),
           lambda: raster.rasterize_binned_uv_plain(*uv_args), uv_bytes,
           OPS_BINNED_PAIR * pairs_bbox)
    results['K1'].update(check_prep('K1', uv_args, raster.TILE,
                                    raster.rasterize_binned_uv))
    pair_counts('K1', uv_bytes, binned_pairs(*uv_args, raster.TILE),
                pairs_bbox)

    k2 = raster.rasterize_binned(tv, G.faces, res)
    record('K2', k2, raster.rasterize_binned_plain(tv, G.faces, res),
           lambda: raster.rasterize_binned(tv, G.faces, res),
           lambda: raster.rasterize_binned_plain(tv, G.faces, res),
           in_bytes + 2 * out_img, OPS_BINNED_PAIR * pairs_bbox)
    results['K2'].update(check_prep('K2', (tv, G.faces, None, res),
                                    raster.TILE, raster.rasterize_binned))
    pair_counts('K2', in_bytes + 2 * out_img,
                binned_pairs(tv, G.faces, None, res, raster.TILE), pairs_bbox)
    if not torch.equal(k2[0], k1[0]):
        raise RuntimeError('K2 pix_to_face differs from K1')

    k3 = raster.rasterize_binned_uv16(*uv_args)
    record('K3', k3, raster.rasterize_binned_uv16_plain(*uv_args),
           lambda: raster.rasterize_binned_uv16(*uv_args),
           lambda: raster.rasterize_binned_uv16_plain(*uv_args), uv_bytes,
           OPS_BINNED_PAIR * pairs_bbox)
    results['K3'].update(check_prep('K3', uv_args, raster.TILE16,
                                    raster.rasterize_binned_uv16))
    pair_counts('K3', uv_bytes, binned_pairs(*uv_args, raster.TILE16),
                pairs_bbox)
    if not all(torch.equal(a, b) for a, b in zip(k3, k1)):
        raise RuntimeError('K3 differs from K1')

    zb_args = (tv, G.faces, res, 32)
    k5 = raster_zbuffer.rasterize_zbuffer(*zb_args)
    pairs = zbuffer_pairs(*zb_args)
    record('K5', k5, raster_zbuffer.rasterize_zbuffer_plain(*zb_args),
           lambda: raster_zbuffer.rasterize_zbuffer(*zb_args),
           lambda: raster_zbuffer.rasterize_zbuffer_plain(*zb_args),
           in_bytes + 2 * out_img, OPS_ZBUFFER_TEST * pairs['pairs_bbox'])
    results['K5'].update(
        zbuffer_stages(k5, *zb_args), **pairs,
        bound_ms_all_pairs=bound(in_bytes + 2 * out_img, OPS_ZBUFFER_TEST
                                 * pairs['pairs_stripe'])['bound_ms'])
    log(f'K5 pairs: every stripe pixel of each kept face '
        f'{pairs["pairs_stripe"]}, inside the kept faces\' bboxes '
        f'{pairs["pairs_bbox"]}, walked by the face kernel '
        f'{pairs["pairs_walked"]}; corner tests {pairs["strip_tests"]} '
        f'(strips) and {pairs["sub_tile_tests"]} (sub-tiles)')
    log(f'K5 (patch 32) vs K1: {int((k5[0] != k1[0]).sum())} of '
        f'{k1[0].numel()} pixels differ in pix_to_face, coverage on '
        f'{int(((k5[0] >= 0) != (k1[0] >= 0)).sum())}')
    return results


def check_adversarial(device, n_images=16, image_size=256, n_faces=10000):
    """Phase 3, second input: K1, K2 and K3 on the seeded adversarial mesh
    (edges through pixel centres, slivers, faces across sub-tile and tile
    borders, dropped faces, depth ties) at the size of the head's input,
    each bit for bit against its plain version; K3 equal to K1 and K2's
    pix_to_face to K1's."""
    from next3d_tpu_torch.ops import raster
    from next3d_tpu_torch.utils.raster_cases import adversarial_mesh
    verts, faces, attrs = (torch.from_numpy(a).to(device) for a in
                           adversarial_mesh(n_images, image_size, n_faces,
                                            SEED))
    outs = {}
    for name, kernel, plain, args in (
            ('K1', raster.rasterize_binned_uv,
             raster.rasterize_binned_uv_plain, (verts, faces, attrs)),
            ('K2', raster.rasterize_binned, raster.rasterize_binned_plain,
             (verts, faces)),
            ('K3', raster.rasterize_binned_uv16,
             raster.rasterize_binned_uv16_plain, (verts, faces, attrs))):
        got = kernel(*args, image_size)
        want = plain(*args, image_size)
        torch.cuda.synchronize()
        mismatch = [int((a != b).sum()) for a, b in zip(got, want)]
        log(f'{name} adversarial mesh, {n_images} images at {image_size}^2, '
            f'{n_faces} faces: mismatching elements {mismatch}, coverage '
            f'{float((got[0] >= 0).float().mean()):.3f}')
        if any(mismatch):
            raise RuntimeError(f'{name} disagrees with its plain version on '
                               f'the adversarial mesh')
        outs[name] = got
    same13 = all(torch.equal(a, b) for a, b in zip(outs['K3'], outs['K1']))
    same12 = torch.equal(outs['K2'][0], outs['K1'][0])
    log(f'adversarial mesh: K3 equal to K1 {same13}, K2 pix_to_face equal to '
        f'K1 {same12}')
    if not (same13 and same12):
        raise RuntimeError('K1, K2 and K3 disagree on the adversarial mesh')


def check_zbuffer_cases(device, n_images=16, image_size=256, n_faces=10000):
    """Phase 3, third input: K5 on its seeded case set (wide, tall and
    off-image faces, slivers, snapped faces, depth ties;
    utils/raster_cases.py zbuffer_mesh) at the size of the head's input,
    patch 32, bit for bit against its plain version."""
    from next3d_tpu_torch.ops.raster_zbuffer import (rasterize_zbuffer,
                                                     rasterize_zbuffer_plain)
    from next3d_tpu_torch.utils.raster_cases import zbuffer_mesh
    verts, faces = (torch.from_numpy(a).to(device) for a in
                    zbuffer_mesh(n_images, image_size, n_faces, SEED))
    got = rasterize_zbuffer(verts, faces, image_size, 32)
    want = rasterize_zbuffer_plain(verts, faces, image_size, 32)
    torch.cuda.synchronize()
    mismatch = [int((a != b).sum()) for a, b in zip(got, want)]
    log(f'K5 case set, {n_images} images at {image_size}^2, {n_faces} faces: '
        f'mismatching elements {mismatch}, coverage '
        f'{float((got[0] >= 0).float().mean()):.3f}')
    if any(mismatch):
        raise RuntimeError('K5 disagrees with its plain version on its case '
                           'set')


def check_k4(device):
    import torch.nn.functional as F
    from next3d_tpu_torch.ops.triplane import (channels_last,
                                               project_onto_planes,
                                               triplane_sample,
                                               triplane_sample_plain)
    from next3d_tpu_torch.render.ray_sampler import sample_rays
    from next3d_tpu_torch.render.renderer import sample_stratified
    g = torch.Generator(device=device).manual_seed(SEED)
    raw = torch.randn(4, 3, 32, 256, 256, generator=g, device=device)
    planes = channels_last(raw)
    c = ffhq_camera(4, device)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 64)
    depths = sample_stratified(None, ro, 2.25, 3.3, 48)
    coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(4, -1, 3)
    got = triplane_sample(planes, coords, 1.0)
    want = triplane_sample_plain(planes, coords, 1.0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = time_ms(lambda: triplane_sample(planes, coords, 1.0))
    plain_ms = time_ms(lambda: triplane_sample_plain(planes, coords, 1.0))
    layout_ms = time_ms(lambda: channels_last(raw))
    # the one PyTorch call for the same sampling: F.grid_sample on the
    # channels-first planes at the projected points
    feats = raw.reshape(12, 32, 256, 256)
    grid = project_onto_planes(2.0 * coords)[:, None]   # box_warp 1
    library_ms = time_ms(lambda: F.grid_sample(
        feats, grid, mode='bilinear', padding_mode='zeros',
        align_corners=False))
    M = coords.shape[1]
    # 4 taps of 32 channels, a multiply and an add each, per point and plane
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, layout_ms=layout_ms,
               **bound(nbytes(planes, coords, got), 12 * M * 32 * 8))
    log(f'K4 planes (4, 3, 32, 256, 256), {M} points: max-abs {err:.3g}; '
        f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.grid_sample '
        f'{library_ms:.3f} ms, channels-last layout {layout_ms:.3f} ms, '
        f'bound {out["bound_ms"]:.4f} ms by {out["bound_by"]}')
    if not err <= 1e-5:
        raise RuntimeError('K4 disagrees with its plain version')
    return out


def parent_backward(root):
    """The K4 backward of checkout ``root`` (such as the parent commit's
    ``git archive``), built and bound by that checkout's own
    ops/cuda_build.py (its nvcc flags, build directory and C signatures):
    ``backward(grad_out, coords, box_warp, H, W)``."""
    import importlib.util
    path = os.path.join(root, 'next3d_tpu_torch', 'ops', 'cuda_build.py')
    spec = importlib.util.spec_from_file_location('parent_cuda_build', path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.load('triplane_sample')

    def backward(grad_out, coords, box_warp, H, W):
        N, _, M, C = grad_out.shape
        grad = torch.zeros(N, 3, H, W, C, device=grad_out.device)
        build.launch('triplane_sample', 'triplane_sample_backward',
                     grad_out.device, grad_out.data_ptr(), coords.data_ptr(),
                     grad.data_ptr(), N, M, H, W, C, 2.0 / box_warp)
        return grad
    return backward


def fine_points(forward):
    """The fine pass's points of one ``forward()``: the coordinates of the
    renderer's second triplane_sample call."""
    from next3d_tpu_torch.render import renderer
    seen = []
    sample = renderer.triplane_sample

    def recording(planes_cl, coordinates, box_warp):
        seen.append(coordinates)
        return sample(planes_cl, coordinates, box_warp)

    renderer.triplane_sample = recording
    try:
        forward()
    finally:
        renderer.triplane_sample = sample
    return seen[1].contiguous()


def check_k4_backward(device, fine, parent=None):
    """K4's backward on four sets of points of 4 images, planes' gradient
    (4, 3, 256, 256, 32): (a) phase 4's coarse points (midpoint depths),
    (b) the same rays with jittered depths, as training draws them, (c)
    ``fine``, the fine pass of the flagship's forward at batch 4, (d) every
    point in one texel, and (a) in a shuffled order, to probe the atomics'
    contention. Each set against its plain version and the library's
    grid_sampler_2d backward, both adding in float64 at the kernel's
    float32 sample positions, within 1e-5 of the largest gradient, timed
    (CUDA events; profiler device time of the wrapper and of the kernel
    alone) beside the float32 plain version and library (their gaps to the
    float64 result logged too) and the parent's kernel when ``parent`` is
    given, with the in-range taps and the atomics the kernel issues
    (merge_plain). Then the coordinates guard. Returns set (a)'s
    numbers, with every set's under 'sets'."""
    from next3d_tpu_torch.ops.triplane import (kernel_positions,
                                               merge_plain,
                                               project_onto_planes,
                                               triplane_sample,
                                               triplane_sample_backward,
                                               triplane_sample_backward_plain)
    from next3d_tpu_torch.render.ray_sampler import sample_rays
    from next3d_tpu_torch.render.renderer import sample_stratified
    g = torch.Generator(device=device).manual_seed(SEED)
    c = ffhq_camera(4, device)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 64)
    points = {}
    for name, gen in (('coarse', None), ('jittered', g)):
        depths = sample_stratified(gen, ro, 2.25, 3.3, 48)
        points[name] = (ro[:, :, None] + depths * rd[:, :, None]).reshape(
            4, -1, 3)
    points['fine'] = fine
    M = points['coarse'].shape[1]
    # every point of an image in one texel of each plane
    points['one_cell'] = 0.1 + 1e-3 * torch.rand(4, M, 3, generator=g,
                                                 device=device)
    # a probe of the atomics' contention: set (a)'s points in a shuffled
    # order (the same texels and taps, each texel's hits spread over the
    # launch, no cell repeated by consecutive points)
    perm = torch.randperm(M, generator=g, device=device)
    points['coarse_shuffled'] = points['coarse'][:, perm].contiguous()
    sets = {}
    for name, coords in points.items():
        M = coords.shape[1]
        grad_out = torch.randn(4, 3, M, 32, generator=g, device=device)
        args = (grad_out, coords, 1.0, 256, 256)
        got = triplane_sample_backward(*args)
        want = triplane_sample_backward_plain(grad_out.double(), *args[1:])
        want32 = triplane_sample_backward_plain(*args)
        grid = project_onto_planes(2.0 * coords)[:, None]       # box_warp 1
        # the kernel's positions as a float64 grid, which grid_sampler_2d
        # unnormalizes back to them: the library adding in float64 at the
        # kernel's taps
        ix, iy = kernel_positions(coords, 1.0, 256, 256)
        grid64 = torch.stack([(2 * ix.double() + 1) / 256 - 1,
                              (2 * iy.double() + 1) / 256 - 1],
                             -1).reshape(12, 1, M, 2)
        grad_cf = grad_out.reshape(12, M, 32).permute(0, 2, 1)[:, :, None]
        feats = {dtype: torch.zeros(12, 32, 256, 256, dtype=dtype,
                                    device=device)
                 for dtype in (torch.float32, torch.float64)}

        def library(grid=grid):
            return torch.ops.aten.grid_sampler_2d_backward(
                grad_cf.to(grid.dtype), feats[grid.dtype], grid, 0, 0, False,
                [True, False])[0].reshape(4, 3, 32, 256, 256).permute(
                    0, 1, 3, 4, 2)

        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        lib_err = float((got - library(grid64)).abs().max())
        plain32_err = float((want32 - want).abs().max())
        lib32_err = float((library() - want).abs().max())
        _, _, atomics, taps = merge_plain(*args)
        # bytes: grad_out and the points read once, the planes' gradient
        # written once; operations: a multiply and an add a channel of
        # each in-range tap
        out = dict(
            max_abs_err=err, max_abs_err_library=lib_err,
            max_abs_err_plain_f32=plain32_err,
            max_abs_err_library_f32=lib32_err, largest_gradient=scale,
            ms=time_ms(lambda: triplane_sample_backward(*args)),
            device_ms=device_ms(lambda: triplane_sample_backward(*args)),
            kernel_device_ms=device_ms(
                lambda: triplane_sample_backward(*args),
                kernel='triplane_sample_backward_kernel'),
            plain_ms=time_ms(lambda: triplane_sample_backward_plain(*args),
                             reps=3),
            library_ms=time_ms(library), taps=taps, atomics=atomics,
            parent_ms=None, parent_device_ms=None,
            **bound(nbytes(grad_out, coords, got), taps * 32 * 2))
        if parent is not None:
            # a check that the other checkout's kernel computes the same
            # function before it is timed; its error is logged, not held to
            # 1e-5 (an unmerged kernel's float32 sums stray further at the
            # one-texel pile-up)
            perr = float((parent(*args) - want).abs().max())
            if not perr <= 1e-3 * scale:
                raise RuntimeError(f'the parent\'s K4 backward disagrees on '
                                   f'{name}: {perr:.3g}')
            out.update(max_abs_err_parent=perr,
                       parent_ms=time_ms(lambda: parent(*args)),
                       parent_device_ms=device_ms(lambda: parent(*args)))
        sets[name] = out
        log(f'K4 backward, {name} points, planes\' gradient (4, 3, 256, '
            f'256, 32), {M} points an image: max-abs {err:.3g} against its '
            f'plain version in float64, {lib_err:.3g} against '
            f'grid_sampler_2d_backward in float64 at its positions, largest '
            f'gradient {scale:.3g} (the float32 plain version strays by '
            f'{plain32_err:.3g}, the float32 library by {lib32_err:.3g}); '
            f'kernel {out["ms"]:.4f} ms (device {out["device_ms"]:.4f}, '
            f'kernel alone {out["kernel_device_ms"]:.4f}), parent '
            + ('not built' if parent is None else
               f'{out["parent_ms"]:.4f} (device '
               f'{out["parent_device_ms"]:.4f}; max-abs '
               f'{out["max_abs_err_parent"]:.3g})')
            + f', plain {out["plain_ms"]:.3f} ms, grid_sampler_2d_backward '
            f'{out["library_ms"]:.3f} ms, bound {out["bound_ms"]:.4f} ms by '
            f'{out["bound_by"]}; {taps} in-range taps, {atomics} atomics')
        if not (err <= 1e-5 * scale and lib_err <= 1e-5 * scale):
            raise RuntimeError(f'K4\'s backward disagrees on {name}')
        del grad_out, got, want, want32, grid, grid64, grad_cf, feats
    with torch.enable_grad():
        try:
            triplane_sample(torch.zeros(1, 3, 8, 8, 32, device=device),
                            torch.zeros(1, 4, 3, device=device,
                                        requires_grad=True), 1.0)
        except RuntimeError as e:
            log(f'K4 with coordinates that require grad: raises ({e})')
        else:
            raise RuntimeError('K4 took coordinates that require grad')
    return dict(sets['coarse'], sets=sets)


def check_k6(device):
    """Phase 5: the gather at the shape of the TPU kernel's measurement,
    in bf16 and f32; the entry for the kernels line is bf16's."""
    from next3d_tpu_torch.ops.dma_gather import (gather_row_blocks,
                                                 gather_row_blocks_plain)
    g = torch.Generator(device=device).manual_seed(SEED)
    idx = torch.randint(0, 98304, (131072,), generator=g, device=device,
                        dtype=torch.int32)
    tables = {dt: torch.randn(98304, 128, generator=g, device=device).to(dt)
              for dt in (torch.bfloat16, torch.float32)}
    gather_row_blocks.launches = 0
    outs = {dt: gather_row_blocks(t, idx) for dt, t in tables.items()}
    torch.cuda.synchronize()
    launches = gather_row_blocks.launches
    results = {}
    for dt, table in tables.items():
        want = gather_row_blocks_plain(table, idx)
        err = float((outs[dt].float() - want.float()).abs().max())
        if not torch.equal(outs[dt], want):
            raise RuntimeError(f'K6 {dt} disagrees with its plain version')
        blocks, blk = table.view(-1, 8, 128), idx // 8
        results[dt] = dict(
            max_abs_err=err, ms=time_ms(lambda: gather_row_blocks(table, idx)),
            plain_ms=time_ms(lambda: gather_row_blocks_plain(table, idx)),
            library_ms=time_ms(lambda: blocks.index_select(0, blk)),
            **bound(nbytes(table, idx, want), 0))
        r = results[dt]
        log(f'K6 {dt} table (98304, 128), 131072 indices: exact; kernel '
            f'{r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms, index_select '
            f'{r["library_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms by '
            f'{r["bound_by"]}')
    return results[torch.bfloat16], launches


# phase 5: the FIR kernel's timed calls: (name, input shape, channels
# last, upfirdn2d's arguments): SR block1's filter after its transposed
# convolution (its input padded to 515^2 in the plain route) and the same
# filter in a backbone's 256^2 block
FIR_CALLS = (('SR block1', (8, 128, 513, 513), True, dict(padding=1, gain=4)),
             ('backbone 256^2', (8, 128, 257, 257), False,
              dict(padding=1, gain=4)))
# phase 5: StyleGAN3-R's synthesis network at its FFHQ-U 1024^2 widths
# (the StyleGAN3 repository's train.py --cfg=stylegan3-r), whose layer
# SG3_R_LAYER makes the largest FIR calls of the `any` instance: the 24-tap
# x4 up-pass (1-D, one launch) and the 12x12 radial down-pass, timed here
# at full spatial size on SG3_R_PLANES (image, channel) planes
SG3_R_1024 = dict(w_dim=512, img_resolution=1024, img_channels=3,
                  channel_base=65536, channel_max=1024, num_layers=14,
                  num_critical=2, margin_size=10, output_scale=0.25,
                  num_fp16_res=4, conv_kernel=1, use_radial_filters=True,
                  filter_size=6, lrelu_upsampling=2, conv_clamp=256)
SG3_R_LAYER, SG3_R_PLANES = 10, 2


def check_fir_any(device, g):
    """Phase 5: the FIR kernel's ``any`` instance at SG3-R's layer
    SG3_R_LAYER, full planes: its up-pass (the 1-D filter in one launch)
    and, on that pass's output, its radial down-pass, each against the
    plain version in float64 within 1e-5 of scale, one launch of ``any``
    and nothing else, timed beside the plain version and its bytes bound
    (the input read and the output written once)."""
    import importlib

    from next3d_tpu_torch.nn.stylegan3 import SG3SynthesisNetwork
    U = importlib.import_module('next3d_tpu_torch.ops.upfirdn2d')
    S = SG3SynthesisNetwork(**SG3_R_1024,
                            generator=torch.Generator().manual_seed(SEED))
    layer = getattr(S, S.layer_names[SG3_R_LAYER])
    size = getattr(S, S.layer_names[SG3_R_LAYER - 1]).out_size
    pad = layer.conv_kernel - 1
    x = torch.randn(1, SG3_R_PLANES, int(size[1]) + pad, int(size[0]) + pad,
                    generator=g, device=device)
    fu, fd = layer.up_filter.to(device), layer.down_filter.to(device)
    if fu.ndim != 1 or fd.ndim != 2:
        raise RuntimeError(f'SG3-R layer {SG3_R_LAYER}: filters '
                           f'{tuple(fu.shape)} and {tuple(fd.shape)}')
    calls = (('up', fu, dict(up=layer.up_factor, padding=layer.padding,
                             gain=layer.up_factor ** 2)),
             ('down', fd, dict(down=layer.down_factor)))
    results = {}
    for name, f, kw in calls:
        counts = U.upfirdn2d.launches_by_instance
        before = dict(counts), U.upfirdn2d.separable_one_launch
        y = U.upfirdn2d(x, f, **kw)
        torch.cuda.synchronize()
        launched = {k: v - before[0].get(k, 0) for k, v in counts.items()
                    if v != before[0].get(k, 0)}
        one_launch = U.upfirdn2d.separable_one_launch - before[1]
        want = U.upfirdn2d_plain(x.double(), f.double(), **kw)
        gap = float((y.double() - want).abs().max() / want.abs().max())
        del want
        if not gap <= 1e-5 or launched != {'any': 1} \
                or one_launch != int(f.ndim == 1):
            raise RuntimeError(f'the FIR kernel at SG3-R layer '
                               f'{SG3_R_LAYER} {name}: rel err {gap}, '
                               f'launches {launched}, one-launch 1-D '
                               f'{one_launch}')
        results[name] = dict(
            shape=list(x.shape), taps=list(f.shape), max_rel_err=gap,
            ms=time_ms(lambda: U.upfirdn2d(x, f, **kw)),
            plain_ms=time_ms(lambda: U.upfirdn2d_plain(x, f, **kw), 3),
            **bound(nbytes(x, y), 0))
        r = results[name]
        log(f'FIR any SG3-R layer {SG3_R_LAYER} {name} {tuple(x.shape)} '
            f'NCHW {"x".join(map(str, f.shape))} taps {kw}: rel err '
            f'{gap:.2g}, one launch; kernel {r["ms"]:.3f} ms, plain '
            f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms by '
            f'{r["bound_by"]}')
        x = y
    return results


def check_fir(device):
    """Phase 5: the FIR kernel (``csrc/upfirdn2d.cu``) at FIR_CALLS against
    its plain version (float64 sums) and the library call it replaces
    (``F.conv2d`` depthwise on the padded input, in the input's layout);
    the entry for the kernels line is SR block1's (its launches are
    counted on the main path's forwards), with check_fir_any's calls under
    ``any``."""
    import importlib

    import torch.nn.functional as F
    U = importlib.import_module('next3d_tpu_torch.ops.upfirdn2d')
    f = torch.from_numpy(U.setup_filter([1, 3, 3, 1])).to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    results = {}
    for name, shape, channels_last, kw in FIR_CALLS:
        x = torch.randn(shape, generator=g, device=device)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        y = U.upfirdn2d(x, f, **kw)
        want = U.upfirdn2d_plain(x.double(), f, **kw)
        gap = float((y.double() - want).abs().max() / want.abs().max())
        if not gap <= 1e-5 or U.is_channels_last(y) != channels_last:
            raise RuntimeError(f'the FIR kernel disagrees at {name}: {gap}')
        C = shape[1]
        w = (f.flip([0, 1]) * kw.get('gain', 1))[None, None].repeat(
            C, 1, 1, 1)
        padded = F.pad(x, [kw['padding']] * 4)
        results[name] = dict(
            max_rel_err=gap, ms=time_ms(lambda: U.upfirdn2d(x, f, **kw)),
            plain_ms=time_ms(lambda: U.upfirdn2d_plain(x, f, **kw), 3),
            library_ms=time_ms(lambda: F.conv2d(padded, w, groups=C), 3),
            **bound(nbytes(x, y), 0))
        r = results[name]
        log(f'FIR {name} {shape} {"NHWC" if channels_last else "NCHW"} '
            f'4x4 pad 1: rel err {gap:.2g}; kernel {r["ms"]:.3f} ms, plain '
            f'{r["plain_ms"]:.3f} ms, F.conv2d depthwise {r["library_ms"]:.3f} '
            f'ms, bound {r["bound_ms"]:.4f} ms by {r["bound_by"]}')
    return dict(results['SR block1'], any=check_fir_any(device, g))


def check_outputs(out, n):
    for key, shape in (('image', (n, 3, 512, 512)),
                       ('image_raw', (n, 3, 64, 64)),
                       ('image_depth', (n, 1, 64, 64))):
        x = out[key]
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f'{key}: shape {tuple(x.shape)} or non-finite')
    # the composite depth is clamped to the sample range, whose last
    # stratified sample lies half a bin (midpoint jitter) past ray_end
    lo, hi = RENDER_KW_FFHQ['ray_start'], RENDER_KW_FFHQ['ray_end']
    hi += (hi - lo) / (RENDER_KW_FFHQ['depth_resolution'] - 1) / 2
    d = out['image_depth']
    if not (float(d.min()) >= lo and float(d.max()) <= hi):
        raise RuntimeError(f'depth [{float(d.min())}, {float(d.max())}] '
                           f'outside [{lo}, {hi}]')


def median_ms(fn, reps=5):
    """Median synchronized wall time of ``fn()`` in ms, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def throughput(name, forward, card, batches=(1, 4)):
    """Median img/s of ``forward(n)`` at each batch: 2 warm-ups, then 5
    forwards, each ended by a synchronize. Returns {batch: img/s}."""
    rates = {}
    for n in batches:
        for _ in range(2):
            forward(n)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates[n] = n / statistics.median(times)
        log(f'{name} batch {n}: median {rates[n]:.3f} img/s (forward ms '
            f'{[round(t * 1e3, 2) for t in times]}) on {card}')
    return rates


def counted(fn, kernels):
    """Run ``fn()`` with the launch counters of ``kernels`` (a dict name ->
    wrapper) set to 0 just before; returns its result and the counts."""
    for wrapper in kernels.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in kernels.items()}


def flagship_stages(G, forward, z, c, v):
    """The flagship forward's stages, each a call on the forward's own
    inputs."""
    from next3d_tpu_torch.ops import raster
    verts, lms = G._split_v(v)
    ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
    n_tex = G.texture_backbone.num_ws
    eg3d_ws = ws[:, :n_tex]
    textures, static = G.build_identity(ws, noise_mode='const')
    images, _, lm2d = G.rasterize(verts, lms, textures)
    tv, _ = G.project_views(verts, lms)
    args = (tv.contiguous(), G.faces, G.face_uv[None], G.uv_resolution)
    slab, starts = raster.binned_prep_cuda(*args)
    res, tile = G.uv_resolution, raster.TILE
    planes = G.mix_planes_from_identity(eg3d_ws, textures, static, verts,
                                        lms, noise_mode='const')
    stages = {
        'whole forward': forward,
        'mapping': lambda: G.mapping(z, c, truncation_psi=0.7,
                                     truncation_cutoff=14),
        'texture backbone': lambda: G.texture_backbone.synthesis(
            ws[:, n_tex:], noise_mode='const'),
        'static backbone': lambda: G.backbone.synthesis(
            ws[:, :n_tex], noise_mode='const'),
        'rasterize (K1 + texture sample + fill_mouth)': lambda: G.rasterize(
            verts, lms, textures),
        '- K1 CUDA prep': lambda: raster.binned_prep_cuda(*args),
        '- K1 resolve kernel': lambda: raster._resolve_cuda(
            slab, starts, res, tile, raster.rasterize_binned_uv),
        '- K1 resolve plain': lambda: raster._resolve_plain(slab, starts,
                                                            res, tile),
        'mouth + blend StyleUNets': lambda: G._mouth_pipeline(
            images[0], lm2d, eg3d_ws, 'const', None),
        'render + SR': lambda: G._render_from_planes(
            planes, eg3d_ws, c, None, 'const', None)}
    return stages


def texture_stages(T, forward, z, c, v):
    """The texture variant's forward stages."""
    from next3d_tpu_torch.ops.raster import rasterize_binned
    from next3d_tpu_torch.render.rasterizer import \
        interpolate_face_attributes
    ws = T.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
    n_tex = T.texture_backbone.num_ws
    eg3d_ws = ws[:, :n_tex]
    textures, static = T.build_identity(ws, noise_mode='const')
    planes = T.mix_planes_from_identity(eg3d_ws, textures, static, v, None)
    tv = T.project_orth(v)
    res = T.uv_resolution
    pf, _ = rasterize_binned(tv, T.faces, res)
    return {
        'whole forward': forward,
        'mapping': lambda: T.mapping(z, c, truncation_psi=0.7,
                                     truncation_cutoff=14),
        'texture backbone': lambda: T.texture_backbone.synthesis(
            ws[:, n_tex:], noise_mode='const'),
        'static backbone': lambda: T.backbone.synthesis(
            ws[:, :n_tex], noise_mode='const'),
        'rasterize_orth (K2 + interpolation + texture sample)':
            lambda: T.rasterize_orth(v, textures),
        '- K2 (CUDA prep + kernel)': lambda: rasterize_binned(tv, T.faces,
                                                              res),
        '- interpolate_face_attributes': lambda: interpolate_face_attributes(
            tv, T.faces, T.face_uvcoords[None], pf, res),
        'render + SR': lambda: T._render_from_planes(
            planes, eg3d_ws, c, None, 'const', None)}


def profile_stages(name, stages, forward, n):
    """Phase 11: the forward split into its stages (each timed alone on the
    same inputs), and the share of wall time in which a kernel ran."""
    for stage, fn in stages.items():
        log(f'{name} stage batch {n}: {stage}: {median_ms(fn):.3f} ms')

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:             # the union of the kernels' intervals
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    busy /= 1e3
    log(f'{name} profile batch {n}, 3 forwards: wall {wall:.1f} ms, device '
        f'busy {busy:.1f} ms ({100 * busy / wall:.0f}%), {len(spans)} kernels')
    log(prof.key_averages().table(sort_by='self_cuda_time_total',
                                  row_limit=12, max_name_column_width=60))


def check_clis(G, g_kwargs, mesh, lms, device, card, kernels, ref, spread,
               inputs):
    """Phase 12: the inference CLIs from a snapshot of ``G``, built with
    ``g_kwargs``, on ``device`` (the card). ``ref`` is
    phase 10's batch-4 forward under deterministic cuDNN, ``spread`` its
    run-to-run max-abs there and ``inputs`` its (z, c, v). Returns the K1
    and K4 launches of each command and reenact's f/s without its frame
    writes."""
    import numpy as np
    from next3d_tpu_torch.cli import main as cli
    from next3d_tpu_torch.cli.common import camera_label, load_generator
    from next3d_tpu_torch.cli.gen_samples import MAX_CHUNK
    from next3d_tpu_torch.ops.triplane import (channels_last,
                                               triplane_sample,
                                               triplane_sample_plain)
    from next3d_tpu_torch.render.shape_utils import create_samples
    from next3d_tpu_torch.utils.checkpoint import save_snapshot
    from next3d_tpu_torch.utils.synthetic_head import save_head
    from next3d_tpu_torch.utils.weights import state_dict_to_params

    tmp = tempfile.mkdtemp(prefix='chip_smoke_cli_')
    try:
        obj, lms_path = save_head(os.path.join(tmp, 'head.obj'), mesh, lms)
        snap = os.path.join(tmp, 'snapshot.pkl')
        save_snapshot(snap, params_G_ema=state_dict_to_params(G.state_dict()),
                      config={'G_kwargs': g_kwargs})
        loaded = load_generator(snap, obj, device)
        torch.backends.cudnn.deterministic = True
        z, c, v = inputs
        out = loaded(z, c, v, truncation_psi=0.7, truncation_cutoff=14,
                     noise_mode='const')
        torch.backends.cudnn.deterministic = False
        err = max(float((out[k] - ref[k]).abs().max()) for k in ref)
        log(f'generator loaded from the snapshot vs phase 6\'s, batch 4, '
            f'deterministic cuDNN: max-abs {err:.3g} (run-to-run spread '
            f'{spread:.3g})')
        if not err <= spread:
            raise RuntimeError('the snapshot generator disagrees')

        launches = {}

        def command(name, argv, expect):
            stats, counts = counted(lambda: cli.run(argv + ['--device',
                                                            str(device)]),
                                    kernels)
            launches[name] = {k: counts[k] for k in ('K1', 'K4')}
            # a video is an .mp4 where imageio or OpenCV writes one, else a
            # directory of PNG frames
            expect = [os.path.splitext(p)[0] + '_frames' if p.endswith('.mp4')
                      and not os.path.exists(p) else p for p in expect]
            missing = [p for p in expect if not os.path.exists(p)
                       or (os.path.isfile(p) and os.path.getsize(p) == 0)
                       or (os.path.isdir(p) and not os.listdir(p))]
            log(f'{name}: launches {counts}; outputs {len(expect)}, missing '
                f'or empty {missing}')
            if missing or min(launches[name].values()) <= 0:
                raise RuntimeError(f'{name} wrote no output or did not run '
                                   f'K1 and K4')
            return stats

        out_s = os.path.join(tmp, 'samples')
        stats = command('gen-samples', [
            'gen-samples', '--network', snap, '--seeds', '0-1', '--outdir',
            out_s, '--shapes', 'True', '--shape-res', '256', '--obj-path',
            obj, '--lms-path', lms_path],
            [os.path.join(out_s, f'seed{s:04d}{ext}') for s in (0, 1)
             for ext in ('.png', '.mrc')])
        per_seed = stats['seconds_per_seed']
        sigma_s = stats['sigma_seconds']
        points = stats['sigma_points']
        log(f'gen-samples: {[round(t, 3) for t in per_seed]} s a seed '
            f'(3 views and the 256^3 sigma grid, writes included); sigma '
            f'grid {[round(t, 3) for t in sigma_s]} s for {points} points, '
            f'{points / min(sigma_s):.4g} points/s at best, on {card}')

        # K4 at the shape path's shape: seed 0's planes, the first chunk
        z0 = torch.from_numpy(np.random.RandomState(0).randn(
            1, loaded.z_dim).astype(np.float32)).to(device)
        head = torch.from_numpy(np.concatenate([mesh.verts, lms])[None]
                                .astype(np.float32)).to(device)
        ws = loaded.mapping(z0, torch.from_numpy(camera_label(0, 0)).to(
            device), truncation_psi=0.7, truncation_cutoff=14)
        planes = channels_last(loaded.build_planes(ws, head,
                                                   noise_mode='const')[0])
        m = min(1000000, MAX_CHUNK)
        coords = torch.from_numpy(create_samples(256)[0][:m]).to(device)[None]
        got = triplane_sample(planes, coords, 1.0)
        want = triplane_sample_plain(planes, coords, 1.0)
        k4_err = float((got - want).abs().max())
        log(f'K4 at the shape path\'s chunk, planes {tuple(planes.shape)}, '
            f'{m} points: max-abs {k4_err:.3g} against its plain version')
        if not k4_err <= 1e-5:
            raise RuntimeError('K4 disagrees at the shape path\'s chunk')
        del got, want, planes, loaded

        drive = write_drive_dir(os.path.join(tmp, 'drive'), mesh, lms)
        out_r = os.path.join(tmp, 'reenact')
        stats = command('reenact', [
            'reenact', '--network', snap, '--drive-root', drive, '--seeds',
            '0', '--outdir', out_r, '--topology-path', obj],
            [os.path.join(out_r, 'reenact_seed0000.mp4')])
        n = stats['frames']
        reenact_fps = n / stats['seconds_without_writes']
        log(f'reenact: {n} frames at 512^2, batch 1, from the first frame '
            f'to the last: {n / stats["seconds"]:.3f} f/s with the frame '
            f'writes, {reenact_fps:.3f} f/s without them, on {card}')

        out_v = os.path.join(tmp, 'video')
        stats = command('gen-videos', [
            'gen-videos', '--network', snap, '--seeds', '0-3', '--grid', '2x2',
            '--outdir', out_v, '--w-frames', '8', '--obj-path', obj,
            '--lms-path', lms_path],
            [os.path.join(out_v, 'interpolation.mp4')])
        log(f'gen-videos: {stats["frames"]} frames of a 2x2 grid (4 images '
            f'a frame, one batched call): {stats["frames"] / stats["seconds"]:.3f} '
            f'f/s with the frame writes, on {card}')

        # K4 differentiates with respect to the planes only: coordinates
        # that require grad raise
        with torch.enable_grad():
            try:
                triplane_sample(torch.zeros(1, 3, 8, 8, 32, device=device),
                                torch.zeros(1, 4, 3, device=device,
                                            requires_grad=True), 1.0)
            except RuntimeError as e:
                log(f'K4 under grad mode with coordinates that require '
                    f'grad: raises ({e})')
            else:
                raise RuntimeError('K4 took coordinates that require grad')
        return launches, reenact_fps
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_drive_dir(drive, mesh, lms, n=16):
    """A reenact driving directory in ``drive``: ``n`` jittered frames of the
    head as .obj and _kpt2d.txt files, with their camera labels in
    dataset.json."""
    from next3d_tpu_torch.cli.common import camera_label
    from next3d_tpu_torch.utils.synthetic_head import save_head

    os.makedirs(drive)
    frames = head_batch(mesh, lms, n, 'cpu').numpy()
    labels = []
    for i, f in enumerate(frames):
        stem = f'frame{i:03d}'
        save_head(os.path.join(drive, stem + '.obj'),
                  mesh._replace(verts=f[:5023]), f[5023:])
        labels.append([stem + '.png',
                       camera_label(0.02 * i, 0.0)[0].tolist()])
    with open(os.path.join(drive, 'dataset.json'), 'w') as fh:
        json.dump({'labels': labels}, fh)
    return drive


def profile_phases(opts, dataset_path, device, phases=('Gmain', 'Greg',
                                                        'Dmain', 'Dreg')):
    """With --profile: each training phase of one batch of ``opts``'s
    networks, after a warm-up batch, under torch.profiler; logs its device
    time and the ops that take the most of it."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from next3d_tpu_torch.cli.common import float32_math
    from next3d_tpu_torch.cli.train import build_training
    from next3d_tpu_torch.data.dataset import (ImageFolderDataset,
                                               make_data_iterator)
    G, D, G_ema, loss, step, _, loop = build_training(opts, device)
    data = ImageFolderDataset(dataset_path)
    host = next(make_data_iterator(data, opts['batch_size'], prefetch=0))
    gen = torch.Generator(device=device).manual_seed(SEED)
    c, v = (torch.from_numpy(x).to(device) for x in
            data.sample_conditioning(np.random.RandomState(SEED),
                                     opts['batch_size']))
    batch = {'gen_z': torch.randn(opts['batch_size'], 512, generator=gen,
                                  device=device), 'gen_c': c, 'gen_v': v,
             'real_c': torch.from_numpy(host['c']).to(device)}
    real = torch.from_numpy(host['image']).to(device)
    sched, nrr = loss.schedules(0)
    calls = {'Gmain': lambda: step.gmain(batch, gen, sched, nrr),
             'Greg': lambda: step.greg(batch, gen, 4.0, sched),
             'Dmain': lambda: step.dmain(batch, real, gen, sched, nrr),
             'Dreg': lambda: step.dreg(batch, real, 16.0, gen, sched, nrr)}
    with float32_math():
        for name in phases:
            calls[name]()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                calls[name]()
                torch.cuda.synchronize()
            busy = sum(e.time_range.end - e.time_range.start
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            log(f'train profile, {name}: device time {busy / 1e3:.1f} ms')
            log(prof.key_averages().table(sort_by='self_cuda_time_total',
                                          row_limit=10,
                                          max_name_column_width=70))
    del G, D, G_ema, loss, step


def write_train_data(G, mesh, lms, device, root):
    """Phase 13's toy dataset in ``root``: 8 of ``G``'s images written as
    PNGs, with the head's .obj and landmarks per item and FFHQ camera
    labels, and the head as ``head.obj``. Returns a dict of the paths and
    the arrays (phase 15 builds its clips from them)."""
    import numpy as np
    from next3d_tpu_torch.cli.common import camera_label, frame_uint8
    from next3d_tpu_torch.utils.synthetic_head import save_dataset, save_head

    labels = np.concatenate([camera_label(0.1 * (i - 3.5), 0.02 * i)
                             for i in range(8)])
    v = head_batch(mesh, lms, 8, device, jitter=0.003)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    z = torch.randn(8, 512, generator=g, device=device)
    images = []
    with torch.no_grad():
        for i in (0, 4):
            c = torch.from_numpy(labels[i:i + 4]).to(device)
            out = G(z[i:i + 4], c, v[i:i + 4], truncation_psi=0.7,
                    truncation_cutoff=14, noise_mode='const')
            images += [frame_uint8(im) for im in out['image']]
    data = save_dataset(os.path.join(root, 'data'), images, v.cpu().numpy(),
                        labels, mesh)
    obj, _ = save_head(os.path.join(root, 'head.obj'), mesh, lms)
    return dict(root=root, data=data, obj=obj, labels=labels, v=v, z=z,
                images=images)


def check_training(files, device, card, kernels, profile=False):
    """Phase 13: the train command on the card at the 512^2 FFHQ config,
    batch 4, on the toy dataset of ``write_train_data``. 17 batches (batch
    0 runs Gmain, Greg, Dmain and Dreg, batch 16 Dreg again, warm), a
    snapshot, then a resume from it for one more tick. Returns the K1, K4
    and K4 backward launches of the first run and its summary."""
    from next3d_tpu_torch.cli import main as cli
    from next3d_tpu_torch.cli.common import load_generator
    from next3d_tpu_torch.cli.train import build_training

    tmp, data, obj = files['root'], files['data'], files['obj']
    labels, v, z = files['labels'], files['v'], files['z']
    run1, run2 = os.path.join(tmp, 'run1'), os.path.join(tmp, 'run2')

    def argv(outdir, kimg, *extra):
        return ['train', '--outdir', outdir, '--data', data, '--batch',
                '4', '--kimg', str(kimg), '--tick', '0.036', '--snap',
                '100', '--topology-path', obj, '--device', str(device),
                '--timing-every', '1', *extra]

    parser = cli.build_parser()
    opts = vars(parser.parse_args(argv(run1, 0.068)))
    opts.pop('command')
    opts.pop('device')
    init = {name: {k: t.clone() for k, t in m.state_dict().items()}
            for name, m in zip(('G', 'D', 'G_ema'),
                               build_training(opts, 'cpu')[:3])}

    summary, result = train_run(
        'train, 17 batches of 4 at 512^2 (FFHQ, 48+48 samples, nrr 64)',
        argv(run1, 0.068), kernels, card, expect=('K1', 'K4', 'K4b'))
    launches = {k: summary['launches'][k] for k in ('K1', 'K4', 'K4b')}

    for name in ('G', 'D', 'G_ema'):
        moved = max(float((t.detach().cpu() - init[name][k]).abs().max())
                    for k, t in result[name].state_dict().items())
        log(f'{name}: largest change of a parameter {moved:.3g}')
        if not moved > 0:
            raise RuntimeError(f'{name} did not move')
    snap = os.path.join(run1, 'network-snapshot-000000.pkl')
    loaded = load_generator(snap, obj, device)
    with torch.no_grad():
        out = loaded(z[:1], torch.from_numpy(labels[:1]).to(device),
                     v[:1], noise_mode='const')
    check_outputs(out, 1)
    log('the snapshot loads into TriPlaneGenerator: finite images')
    del result, loaded, init

    resumed = cli.run(argv(run2, 0.072, '--resume', snap))
    ticks = [(r['tick'], r['kimg']) for r in resumed['ticks']]
    log(f'resumed from the snapshot: cur_nimg {resumed["cur_nimg"]}, '
        f'ticks {ticks}')
    if resumed['cur_nimg'] != 72 or ticks != [(2, 0.072)]:
        raise RuntimeError('the resumed run did not continue cur_nimg')
    del resumed
    if profile:
        profile_phases(opts, data, device)
    return launches, summary


# the pipe on the card against its CPU run on the same draws, max-abs on
# images in [-1, 1] after the colour transforms (values up to about 8):
# cuDNN's and the CPU's depthwise filters and grid_sample round apart by
# about 1e-6, the 1024-px 2x image's coordinates by about 6e-5 px
PIPE_TOL = 1e-3
# the texture variant's first Gmain loss, card against CPU, relative
TEXTURE_GMAIN_TOL = 1e-3


def check_pipe(files, device, card):
    """Phase 15: the augment pipe at the 512^2 Dmain input (batch 4, the
    image beside its upsampled raw image: 6 channels, here phase 13's
    images twice) on the card against the CPU on the same draws (p=0.6,
    drawn on the CPU), within PIPE_TOL; its time on the card, draws
    included, forward and forward + backward."""
    import numpy as np
    from next3d_tpu_torch.cli.train import PIPE_KWARGS
    from next3d_tpu_torch.train.augment import AugmentPipe

    pipe = AugmentPipe(**PIPE_KWARGS)
    img = torch.from_numpy(np.stack(files['images'][:4])).permute(
        0, 3, 1, 2).float() / 127.5 - 1
    x = torch.cat([img, img.flip(3)], 1).contiguous()
    draws = pipe.draw(x.shape, 0.6, torch.Generator().manual_seed(SEED),
                      'cpu')
    want = pipe.apply(x, draws)
    got = pipe.apply(x.to(device), {k: v.to(device) for k, v in
                                     draws.items()}).cpu()
    err = float((got - want).abs().max())
    xd = x.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ms = time_ms(lambda: pipe(xd, 0.6, gen))
    xg = xd.clone().requires_grad_()
    ms_grad = time_ms(lambda: torch.autograd.grad(
        pipe(xg, 0.6, gen).square().sum(), xg))
    log(f'augment pipe (train config, p=0.6), batch 4 x 6 x 512^2: card vs '
        f'CPU on the same draws max-abs {err:.3g} (of '
        f'{float(want.abs().max()):.3g}; tolerance {PIPE_TOL}); '
        f'{ms:.3f} ms a call with its draws, {ms_grad:.3f} ms with the '
        f'gradient, on {card}')
    if not err <= PIPE_TOL:
        raise RuntimeError('the augment pipe disagrees between card and '
                           'CPU')
    return dict(max_abs_err=err, ms=ms, ms_with_gradient=ms_grad)


def check_texture_gmain(opts, files, device):
    """Phase 15: the texture variant's first Gmain loss (the train
    command's networks at their seed, constant noise and midpoint depths,
    batch 1) on the card against the CPU, within TEXTURE_GMAIN_TOL."""
    import copy
    from next3d_tpu_torch.cli.train import build_training
    from next3d_tpu_torch.train.loss import StyleGAN2Loss

    G, D, _, loss, _, _, _ = build_training(opts, 'cpu')
    values = {}
    for dev in ('cpu', device):
        Gx, Dx = (copy.deepcopy(m).to(dev) for m in (G, D))
        lx = StyleGAN2Loss(Gx, Dx, loss.cfg, deterministic=True)
        sched, nrr = lx.schedules(0)
        batch = {'gen_z': files['z'][:1].to(dev),
                 'gen_c': torch.from_numpy(files['labels'][:1]).to(dev),
                 'gen_v': files['v'][:1].to(dev)}
        with torch.no_grad():
            value, _, _ = lx.gmain_loss(batch, None, sched, nrr)
        values[str(dev)] = float(value)
        del Gx, Dx, lx
    cpu, card = values['cpu'], values[str(device)]
    rel = abs(card - cpu) / abs(cpu)
    log(f'texture variant Gmain loss, batch 1: card {card:.7g}, CPU '
        f'{cpu:.7g}, relative {rel:.3g} (tolerance {TEXTURE_GMAIN_TOL})')
    if not rel <= TEXTURE_GMAIN_TOL:
        raise RuntimeError('the texture variant\'s Gmain disagrees between '
                           'card and CPU')
    return dict(card=card, cpu=cpu, relative=rel)


def train_run(name, argv, kernels, card, frames=1, expect=()):
    """One in-process run of the train command: its launches, finite
    stats, every phase run, the kernels of ``expect`` launched; logs and
    returns img/s (frames/s for clips) over the last tick, ms a phase (the
    first batch and the last tick's mean), peak memory and ada_p, with the
    command's result."""
    from next3d_tpu_torch.cli import main as cli

    device = torch.device('cuda', 0)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    result, counts = counted(lambda: cli.run(argv), kernels)
    seconds = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated(device) / 2 ** 30
    for r in result['ticks']:
        bad = [k for k, x in r.items() if isinstance(x, float)
               and not math.isfinite(x)]
        if bad:
            raise RuntimeError(f'{name}, tick {r["tick"]}: not finite: '
                               f'{bad}')
    phases = ('Gmain', 'Greg', 'Dmain', 'Dreg', 'G_ema')
    first, warm = result['ticks'][0], result['ticks'][-1]
    missing = [p for p in phases if f'Timing/{p}' not in first]
    idle = [k for k in expect if counts[k] <= 0]
    if missing or idle:
        raise RuntimeError(f'{name}: phases {missing} did not run, or '
                           f'kernels {idle} never launched ({counts})')
    summary = dict(
        seconds=seconds, peak_device_mem_gb=peak_gb,
        images_per_second=warm['images_per_second'] * frames,
        phase_ms_first_batch={p: 1e3 * first[f'Timing/{p}']
                              for p in phases},
        phase_ms_warm={p: 1e3 * warm[f'Timing/{p}'] for p in phases
                       if f'Timing/{p}' in warm},
        launches={k: counts[k] for k in ('K1', 'K2', 'K4', 'K4b')},
        ada_p=result['ada_p'],
        augment_p_by_tick=[r['Progress/augment'] for r in result['ticks']],
        losses={k: warm[k] for k in warm if k.startswith('Loss/')
                or k.startswith('Grad/')})
    rounded = {key: {k: round(x, 2) for k, x in summary[key].items()}
               for key in ('phase_ms_warm', 'phase_ms_first_batch')}
    log(f'{name}: {seconds:.1f} s with its set-up; last tick '
        f'{summary["images_per_second"]:.3f} '
        f'{"frames" if frames > 1 else "img"}/s; ms a phase '
        f'{rounded["phase_ms_warm"]}; batch 0 (cold) '
        f'{rounded["phase_ms_first_batch"]}; peak device memory '
        f'{peak_gb:.2f} GiB (max_memory_allocated); '
        f'launches {counts}; ada_p {summary["ada_p"]:.6g}; on {card}')
    log(f'{name}: losses and gradient norms, last tick '
        f'{ {k: round(x, 5) for k, x in summary["losses"].items()} }')
    return summary, result


def check_training_variants(files, mesh, device, card, kernels):
    """Phase 15: the train command's other configurations at phase 13's
    512^2 FFHQ config on its dataset: the augment pipe card against CPU,
    the texture variant's first Gmain loss card against CPU, then (a)
    ``--model-version texture --aug ada``, batch 4, 17 batches (Greg at
    batches 0, 4, 8, 12 and 16, Dreg at 0 and 16, the ADA controller moving
    at batches 4, 8, 12 and 16), and (b) ``--dataset-type video
    --num-frames-per-video 2`` on the flagship, 2 clips (4 frames) a batch,
    6 batches, on 2 clips of 4 of phase 13's frames each. Returns K2's
    launches in (a) and the phase's summary."""
    import numpy as np
    from next3d_tpu_torch.cli import main as cli
    from next3d_tpu_torch.utils.synthetic_head import save_clip_dataset

    root = files['root']
    pipe = check_pipe(files, device, card)

    def argv(outdir, data, batch, kimg, tick, *extra):
        return ['train', '--outdir', os.path.join(root, outdir), '--data',
                data, '--batch', str(batch), '--kimg', str(kimg), '--tick',
                str(tick), '--snap', '100', '--topology-path', files['obj'],
                '--device', str(device), '--timing-every', '1', *extra]

    texture = argv('texture_ada', files['data'], 4, 0.068, 0.036,
                   '--model-version', 'texture', '--aug', 'ada')
    opts = vars(cli.build_parser().parse_args(texture))
    opts.pop('command')
    opts.pop('device')
    gmain = check_texture_gmain(opts, files, device)
    # the same run without the pipe, for the pipe's share of a batch
    plain, _ = train_run('train --model-version texture, 17 batches of 4 '
                         'at 512^2', texture[:-2], kernels, card,
                         expect=('K2', 'K4', 'K4b'))
    a, _ = train_run('train --model-version texture --aug ada, 17 batches '
                     'of 4 at 512^2', texture, kernels, card,
                     expect=('K2', 'K4', 'K4b'))
    if a['launches']['K1'] != 0 or plain['launches']['K1'] != 0:
        raise RuntimeError('the texture variant launched K1')
    log(f'the augment pipe\'s share of a texture batch (last tick): '
        f'{1 - a["images_per_second"] / plain["images_per_second"]:.3f} '
        f'({plain["images_per_second"]:.3f} img/s without it, '
        f'{a["images_per_second"]:.3f} with it) on {card}')

    images = np.stack(files['images'])
    v = files['v'].cpu().numpy()
    clips = save_clip_dataset(os.path.join(root, 'clips'), [
        (images[i:i + 4], v[i:i + 4], files['labels'][i:i + 4])
        for i in (0, 4)], mesh)
    b, _ = train_run('train --dataset-type video --num-frames-per-video 2 '
                     '(flagship), 6 batches of 2 clips of 2 frames at 512^2',
                     argv('video', clips, 2, 0.012, 0.006, '--dataset-type',
                          'video', '--num-frames-per-video', '2'),
                     kernels, card, frames=2, expect=('K1', 'K4', 'K4b'))
    return a['launches']['K2'], dict(pipe=pipe, texture_gmain=gmain,
                                     texture=plain, texture_ada=a, video=b)


def tree_of(module):
    from next3d_tpu_torch.utils.weights import state_dict_to_params
    return state_dict_to_params(module.state_dict())


def trees_equal(got, want):
    """Whether two parameter trees have the same names and equal arrays."""
    from next3d_tpu_torch.utils.weights import params_to_state_dict
    import numpy as np
    a, b = params_to_state_dict(got), params_to_state_dict(want)
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


class ResumeProbe:
    """Wraps ``train/training_loop.py load_resume`` for the duration of a
    ``with`` block: keeps the networks' trees just before and just after
    the load, and the loop's ``step`` (its optimizers)."""

    def __enter__(self):
        from next3d_tpu_torch.train import training_loop
        self.module, self.orig = training_loop, training_loop.load_resume
        self.seen = {}

        def probe(path, G, D, G_ema, step):
            self.seen['before'] = {k: tree_of(m) for k, m in
                                   (('G', G), ('D', D), ('G_ema', G_ema))}
            out = self.orig(path, G, D, G_ema, step)
            self.seen['after'] = {k: tree_of(m) for k, m in
                                  (('G', G), ('D', D), ('G_ema', G_ema))}
            self.seen.update(step=step, networks=(G, D, G_ema), state=out)
            return out

        training_loop.load_resume = probe
        return self.seen

    def __exit__(self, *exc):
        self.module.load_resume = self.orig


def check_checkpoints(G, files, mesh, lms, device, card, kernels, ref,
                      spread, inputs, cli_reenact_fps):
    """Phase 16: checkpoint interop at the 512^2 FFHQ config, in a
    temporary directory. (a) ``G`` (phase 6's flagship) written as a
    reference-format Next3D .pkl (utils/checkpoint_cases.py: persistence-
    wrapped modules, torch-tensor leaves, the reference's init_kwargs,
    training_set_kwargs and augment_pipe, and a buffer the port does not
    have), read by load_any_generator (timed) and loaded by load_generator,
    against phase 10's ``ref`` on its ``inputs`` within its run-to-run
    ``spread``; then ``reenact`` over 16 frames and ``gen-samples`` of one
    seed from it, which must launch K1 and K4. (b) An EG3D-format .pkl
    (G_ema with ``backbone``, ``superresolution`` and ``decoder`` of
    ``G``, and a D of another seed): ``train --resume eg3d.pkl`` at phase
    13's config on its dataset, batch 4, 4 batches in one tick; just
    after the load (``load_resume``), G and G_ema equal the fresh init
    with the donor's leaves wherever a name and a shape match through
    eg3d_to_next3d, D the donor's, the optimizers empty; every phase runs,
    K4 and its backward launch, every stat finite. (c) A JAX-layout format-1
    snapshot of (b)'s networks and Adam states (optax's class names,
    utils/checkpoint_cases.py write_jax_snapshot), resumed: the loaded
    step, exp_avg and exp_avg_sq equal the source's; one batch more. Then a
    snapshot with only params_G_ema (as phase 12 writes one; (b)'s
    G_ema), resumed into (c)'s networks. (d) (b)'s TensorBoard events, read by the port's
    read_scalars, equal its stats.jsonl's numeric fields as float32.
    Returns the K1, K4 and K4 backward launches of each command and the
    phase's summary."""
    import numpy as np
    from next3d_tpu_torch.cli import main as cli
    from next3d_tpu_torch.cli.common import load_generator
    from next3d_tpu_torch.nn.discriminator import DualDiscriminator
    from next3d_tpu_torch.train.training_loop import load_resume
    from next3d_tpu_torch.train.warm_start import (copy_matching_params,
                                                   eg3d_to_next3d)
    from next3d_tpu_torch.utils import checkpoint_cases
    from next3d_tpu_torch.utils.checkpoint import (load_any_generator,
                                                   save_snapshot)
    from next3d_tpu_torch.utils.tensorboard import read_scalars
    from next3d_tpu_torch.utils.weights import params_to_state_dict

    root = os.path.join(files['root'], 'checkpoints')
    os.makedirs(root)
    obj, lms_path = files['obj'], os.path.splitext(files['obj'])[0] \
        + '_kpt2d.txt'
    summary, launches = {}, {}

    # (a) a reference-format Next3D .pkl of phase 6's flagship
    donor = tree_of(G)
    init_kwargs = dict(G_KWARGS, num_fp16_res=0, conv_clamp=None,
                       class_name='training.triplane.TriPlaneGenerator',
                       topology_path='data/demo/head_template.obj')
    pkl = os.path.join(root, 'next3d.pkl')
    t0 = time.perf_counter()
    checkpoint_cases.write_network_pkl(
        pkl, {'G': None, 'G_ema': donor, 'D': None},
        init_kwargs={'G_ema': init_kwargs},
        buffers={'G_ema': {'dense_faces': np.arange(12, dtype=np.int64)}},
        extra={'training_set_kwargs': {'resolution': 512, 'xflip': False},
               'augment_pipe': None})
    summary['pkl_write_s'] = time.perf_counter() - t0
    summary['pkl_mb'] = os.path.getsize(pkl) / 2 ** 20
    t0 = time.perf_counter()
    params, kwargs = load_any_generator(pkl)
    summary['pkl_load_s'] = time.perf_counter() - t0
    if kwargs != init_kwargs or not trees_equal(
            {k: v for k, v in params.items() if k != 'dense_faces'}, donor):
        raise RuntimeError('the .pkl read back other weights or kwargs')
    t0 = time.perf_counter()
    loaded = load_generator(pkl, obj, device)
    summary['pkl_generator_s'] = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = True
    z, c, v = inputs
    with torch.no_grad():
        out = loaded(z, c, v, truncation_psi=0.7, truncation_cutoff=14,
                     noise_mode='const')
    torch.backends.cudnn.deterministic = False
    err = max(float((out[k] - ref[k]).abs().max()) for k in ref)
    summary['pkl_vs_phase6_max_abs'] = err
    log(f'reference-format .pkl of the flagship ({summary["pkl_mb"]:.1f} '
        f'MiB, torch-tensor leaves): written in {summary["pkl_write_s"]:.2f}'
        f' s, read by load_any_generator in {summary["pkl_load_s"]:.2f} s, '
        f'generator built and loaded in {summary["pkl_generator_s"]:.2f} s;'
        f' against phase 6\'s at batch 4, deterministic cuDNN: max-abs '
        f'{err:.3g} (run-to-run spread {spread:.3g}), on {card}')
    if not err <= spread:
        raise RuntimeError('the .pkl generator disagrees with phase 6\'s')
    del loaded, out

    drive = write_drive_dir(os.path.join(root, 'drive'), mesh, lms)
    stats, counts = counted(lambda: cli.run([
        'reenact', '--network', pkl, '--drive-root', drive, '--seeds', '0',
        '--outdir', os.path.join(root, 'reenact'), '--topology-path', obj,
        '--device', str(device)]), kernels)
    launches['reenact .pkl'] = {k: counts[k] for k in ('K1', 'K4', 'K4b')}
    summary['reenact_fps'] = stats['frames'] / stats['seconds_without_writes']
    log(f'reenact from the .pkl: {stats["frames"]} frames, '
        f'{summary["reenact_fps"]:.3f} f/s without the frame writes '
        f'(phase 12, from a format-1 snapshot: {cli_reenact_fps:.3f}); '
        f'launches {counts}; on {card}')
    _, counts = counted(lambda: cli.run([
        'gen-samples', '--network', pkl, '--seeds', '0', '--outdir',
        os.path.join(root, 'samples'), '--obj-path', obj, '--lms-path',
        lms_path, '--device', str(device)]), kernels)
    launches['gen-samples .pkl'] = {k: counts[k] for k in ('K1', 'K4',
                                                           'K4b')}
    log(f'gen-samples from the .pkl, seed 0: launches {counts}')
    if not os.path.getsize(os.path.join(root, 'samples', 'seed0000.png')):
        raise RuntimeError('gen-samples from the .pkl wrote nothing')
    for name in ('reenact .pkl', 'gen-samples .pkl'):
        if min(launches[name]['K1'], launches[name]['K4']) <= 0:
            raise RuntimeError(f'{name} did not launch K1 and K4')

    # (b) an EG3D .pkl: train --resume eg3d.pkl, one tick of 4 batches
    def argv(outdir, kimg, tick, resume):
        return ['train', '--outdir', os.path.join(root, outdir), '--data',
                files['data'], '--batch', '4', '--kimg', str(kimg),
                '--tick', str(tick), '--snap', '100', '--topology-path', obj,
                '--device', str(device), '--timing-every', '1', '--resume',
                resume]

    eg3d_pkl = os.path.join(root, 'eg3d.pkl')
    opts = vars(cli.build_parser().parse_args(argv('warm', 0.016, 0.016,
                                                   eg3d_pkl)))
    D = DualDiscriminator(
        c_dim=25, img_resolution=opts['resolution'], img_channels=3,
        channel_base=opts['channel_base'], channel_max=opts['channel_max'],
        epilogue_kwargs=dict(mbstd_group_size=opts['mbstd_group']),
        generator=torch.Generator().manual_seed(SEED + 5))
    eg3d = {k: donor[k] for k in ('backbone', 'superresolution', 'decoder')}
    donor_D = tree_of(D)
    del D
    checkpoint_cases.write_network_pkl(
        eg3d_pkl, {'G': eg3d, 'G_ema': eg3d, 'D': donor_D},
        init_kwargs={'G_ema': dict(G_KWARGS, class_name='training.triplane.'
                                   'TriPlaneGenerator')})

    with ResumeProbe() as seen:
        warm, result = train_run(
            'train --resume eg3d.pkl, 4 batches of 4 at 512^2',
            argv('warm', 0.016, 0.016, eg3d_pkl), kernels, card,
            expect=('K1', 'K4', 'K4b'))
    launches['train --resume eg3d.pkl'] = warm['launches']
    before, after = seen['before'], seen['after']
    imported = eg3d_to_next3d(eg3d)
    for name in ('G', 'G_ema'):
        want = copy_matching_params(before[name], imported)
        if not trees_equal(after[name], want):
            raise RuntimeError(f'the warm start of {name} is not the init '
                               f'with the donor\'s matching leaves')
    flat, flat_imported = (params_to_state_dict(x)
                           for x in (after['G'], imported))
    seeded = sum(1 for k, x in flat.items()
                 if k.split('.')[0] in ('texture_backbone', 'mouth_backbone',
                                        'neural_blending')
                 and k in flat_imported
                 and np.array_equal(x, flat_imported[k]))
    if not trees_equal(after['D'], donor_D) or seen['state'] != {} \
            or seeded <= 0:
        raise RuntimeError('the warm start of D, the loop state or the '
                           'seeded backbones are wrong')
    summary['warm_start'] = dict(
        seeded_leaves=seeded, img_s=warm['images_per_second'],
        peak_device_mem_gb=warm['peak_device_mem_gb'],
        phase_ms_first_batch=warm['phase_ms_first_batch'],
        launches=warm['launches'])
    log(f'warm start from eg3d.pkl: {seeded} leaves of the texture, mouth '
        f'and blending networks seeded from the EG3D backbone, the rest '
        f'the init; D the donor\'s; on {card}')

    # (d) its TensorBoard scalars against its stats.jsonl
    run_dir = os.path.join(root, 'warm')
    (events,) = [f for f in os.listdir(run_dir)
                 if f.startswith('events.out.tfevents.')]
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        records = [json.loads(line) for line in f]
    want = [(int(round(r['kimg'] * 1000)) // 1000, k, float(np.float32(x)))
            for r in records for k, x in r.items()
            if isinstance(x, (int, float))]
    got = read_scalars(os.path.join(run_dir, events))
    summary['tensorboard_scalars'] = len(got)
    log(f'TensorBoard: {len(got)} scalars read back, equal to stats.jsonl: '
        f'{got == want}')
    if got != want:
        raise RuntimeError('the TensorBoard scalars differ from stats.jsonl')

    # (c) a JAX-layout snapshot of (b)'s networks and Adam states
    step = seen['step']
    Gw, Dw, G_emaw = result['G'], result['D'], result['G_ema']
    adam = {'G': checkpoint_cases.adam_moments(step.opt_G, Gw),
            'D': checkpoint_cases.adam_moments(step.opt_D, Dw)}
    jax_snap = os.path.join(root, 'jax-layout.pkl')
    g_ema_tree = tree_of(G_emaw)
    checkpoint_cases.write_jax_snapshot(
        jax_snap, params_G=tree_of(Gw), params_D=tree_of(Dw),
        params_G_ema=g_ema_tree, adam_G=adam['G'], adam_D=adam['D'],
        cur_nimg=16, ada_p=0.0)
    del result, Gw, Dw, G_emaw, step, seen
    with ResumeProbe() as seen:
        resumed, _ = train_run(
            'train --resume of a JAX-layout snapshot, 1 batch of 4',
            argv('from_jax', 0.020, 0.004, jax_snap), kernels, card,
            expect=('K1', 'K4', 'K4b'))
    launches['train --resume jax-layout.pkl'] = resumed['launches']
    step = seen['step']
    Gr, Dr, _ = seen['networks']
    moved = 0
    for opt, module, name in ((step.opt_G, Gr, 'G'), (step.opt_D, Dr, 'D')):
        count, mu, nu = adam[name]
        mu, nu = params_to_state_dict(mu), params_to_state_dict(nu)
        for pname, p in module.named_parameters():
            if p not in opt.state:
                continue
            moved += 1
            if not int(opt.state[p]['step']) > count:   # a batch ran since
                raise RuntimeError(f'{name}.{pname}: step '
                                   f'{opt.state[p]["step"]} after {count}')
    if seen['state'] != {'cur_nimg': 16, 'ada_p': 0.0} or not moved:
        raise RuntimeError(f'the JAX-layout resume read {seen["state"]}')
    # the moments as loaded, before the batch: load them again on (c)'s
    # networks and hold them to the source
    load_resume(jax_snap, Gr, Dr, seen['networks'][2], step)
    for opt, module, name in ((step.opt_G, Gr, 'G'), (step.opt_D, Dr, 'D')):
        count, mu, nu = adam[name]
        mu, nu = params_to_state_dict(mu), params_to_state_dict(nu)
        for pname, p in module.named_parameters():
            if p in opt.state and not (
                    int(opt.state[p]['step']) == count
                    and np.array_equal(opt.state[p]['exp_avg'].cpu().numpy(),
                                       mu[pname])
                    and np.array_equal(
                        opt.state[p]['exp_avg_sq'].cpu().numpy(),
                        nu[pname])):
                raise RuntimeError(f'{name}.{pname}: Adam state differs '
                                   f'from the JAX-layout snapshot\'s')
    log(f'JAX-layout snapshot resumed: cur_nimg 16, {moved} Adam states '
        f'equal to the source (step {adam["G"][0]}), one batch more at '
        f'{resumed["images_per_second"]:.3f} img/s')
    g_ema_only = os.path.join(root, 'g_ema.pkl')
    save_snapshot(g_ema_only, params_G_ema=g_ema_tree)
    state = load_resume(g_ema_only, *seen['networks'], step)
    if state != {'cur_nimg': 0} or not trees_equal(
            tree_of(seen['networks'][2]), g_ema_tree):
        raise RuntimeError('the params_G_ema-only snapshot did not resume')
    log('a params_G_ema-only snapshot resumes: G_ema loaded, cur_nimg 0')
    summary['jax_layout_resume'] = dict(
        adam_states=moved, count=adam['G'][0],
        img_s=resumed['images_per_second'])
    del seen, step, Gr, Dr, state
    return launches, summary


class LaunchCount:
    """A launch counter of a wrapper under another attribute, readable and
    resettable as ``launches`` (``counted`` reads that name): K4's bf16
    instance counts in ``triplane_sample.launches_bf16``."""

    def __init__(self, wrapper, attr):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self):
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.wrapper, self.attr, n)


def psnr(got, want):
    """PSNR in dB over a [-1, 1] range, as tests/test_bf16_parity.py."""
    mse = float(((got.float() - want.float()) ** 2).mean())
    return 10 * math.log10(4.0 / mse) if mse > 0 else math.inf


def bf16_gaps(got, want):
    """Per output: max-abs, PSNR, the fp32 output's largest magnitude, and
    whether the bounds of BF16_BOUNDS hold."""
    gaps = {}
    for key, (max_abs, min_psnr) in BF16_BOUNDS.items():
        err = float((got[key] - want[key]).abs().max())
        p = psnr(got[key], want[key])
        gaps[key] = dict(max_abs=err, psnr=p,
                         scale=float(want[key].abs().max()),
                         within=err <= max_abs and p >= min_psnr)
    return gaps


def check_k4_bf16(device):
    """Phase 14's kernel check: K4's bf16-plane instance at phase 4's
    shapes against its plain version, timed beside the float32 instance,
    the plain version and the bf16 layout pass alone."""
    from next3d_tpu_torch.ops.triplane import (channels_last,
                                               triplane_sample,
                                               triplane_sample_plain)
    from next3d_tpu_torch.render.ray_sampler import sample_rays
    from next3d_tpu_torch.render.renderer import sample_stratified
    g = torch.Generator(device=device).manual_seed(SEED)
    raw = torch.randn(4, 3, 32, 256, 256, generator=g, device=device)
    planes = channels_last(raw, torch.bfloat16)
    planes32 = channels_last(raw)
    c = ffhq_camera(4, device)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 64)
    depths = sample_stratified(None, ro, 2.25, 3.3, 48)
    coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(4, -1, 3)
    got = triplane_sample(planes, coords, 1.0)
    want = triplane_sample_plain(planes, coords, 1.0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = time_ms(lambda: triplane_sample(planes, coords, 1.0))
    f32_ms = time_ms(lambda: triplane_sample(planes32, coords, 1.0))
    plain_ms = time_ms(lambda: triplane_sample_plain(planes, coords, 1.0))
    layout_ms = time_ms(lambda: channels_last(raw, torch.bfloat16))
    layout_f32_ms = time_ms(lambda: channels_last(raw))
    M = coords.shape[1]
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               library='none: no one PyTorch call samples bf16 planes at '
               'float32 points (F.grid_sample takes one dtype for the '
               'table and the grid)',
               float32_instance_ms=f32_ms, layout_ms=layout_ms,
               layout_float32_ms=layout_f32_ms,
               **bound(nbytes(planes, coords, got), 12 * M * 32 * 8))
    log(f'K4 bf16 planes (4, 3, 256, 256, 32), {M} points: max-abs {err:.3g} '
        f'against its plain version; kernel {ms:.4f} ms, float32 instance '
        f'{f32_ms:.4f} ms, plain {plain_ms:.3f} ms, bf16 layout pass '
        f'{layout_ms:.4f} ms (float32 {layout_f32_ms:.4f}), bound '
        f'{out["bound_ms"]:.4f} ms by {out["bound_by"]}')
    if not err <= 1e-5:
        raise RuntimeError('K4 bf16 disagrees with its plain version')
    return out


def bf16_stages(G32, Gbf, z, c, v):
    """The bf16 forward against the fp32 forward stage by stage, at one
    batch: each stage's max-abs and RMS gaps and their shares of the fp32
    stage's largest magnitude (each generator from the same ws; render +
    SR also from the fp32 planes, which isolates it)."""
    ws = G32.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
    eg3d_ws = ws[:, :G32.texture_backbone.num_ws]
    verts, lms = G32._split_v(v)
    got = {}
    for key, G in (('fp32', G32), ('bf16', Gbf)):
        s = got[key] = {}
        s['texture'], s['static plane'] = G.build_identity(ws,
                                                           noise_mode='const')
        if G.blends_mouth:
            images, _, lm2d = G.rasterize(verts, lms, s['texture'])
            s['rasterized front'] = images[0]
            s['mouth + blend'] = G._mouth_pipeline(images[0], lm2d, eg3d_ws,
                                                   'const', None)
        s['planes'] = G.mix_planes_from_identity(
            eg3d_ws, s['texture'], s['static plane'], verts, lms,
            noise_mode='const')
        out = G._render_from_planes(s['planes'], eg3d_ws, c, None, 'const',
                                    None)
        s['image_raw'], s['image'] = out['image_raw'], out['image']
    out = Gbf._render_from_planes(got['fp32']['planes'], eg3d_ws, c, None,
                                  'const', None)
    got['bf16']['image_raw, bf16 render of the fp32 planes'] = \
        out['image_raw']
    got['bf16']['image, bf16 render + SR of the fp32 planes'] = out['image']
    want = got['fp32']
    want['image_raw, bf16 render of the fp32 planes'] = want['image_raw']
    want['image, bf16 render + SR of the fp32 planes'] = want['image']
    stages = {}
    for stage, x in got['bf16'].items():
        diff = x.float() - want[stage]
        err = float(diff.abs().max())
        rms = float(diff.square().mean().sqrt())
        scale = float(want[stage].abs().max())
        stages[stage] = dict(max_abs=err, rms=rms, scale=scale,
                             share=err / scale, rms_share=rms / scale)
    return stages


def check_bf16_serving(build, forward_of, models, card, kernels, inputs,
                       fp32_outs, mesh, lms, device):
    """Phase 14: the bf16 serving policy (force_fp32=False) of both
    generators, each with the weights of its fp32 generator in ``models``
    (phase 6's flagship, phase 9's texture variant), at the 512^2 FFHQ
    config: forwards at batch 1 and 4 (the flagship also at 8) against the
    fp32 forwards on the same inputs (``fp32_outs`` where phase 6 or 9 ran
    them), K4's bf16 instance launched in them and the float32 one not,
    img/s of both, and the flagship's identity-cached reenact path over 16
    jittered frames in both. Returns the kernel check, the bf16 instance's
    launches in the forwards, and a summary."""
    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
    from next3d_tpu_torch.models.triplane_texture import \
        TriPlaneTextureGenerator
    z, c, v = inputs
    k4 = check_k4_bf16(device)
    summary, launches = {}, 0
    for name, cls, batches, flame_only in (
            ('flagship', TriPlaneGenerator, (1, 4, 8), False),
            ('texture variant', TriPlaneTextureGenerator, (1, 4), True)):
        G32 = models[name]
        Gbf = build(cls, force_fp32=False)
        Gbf.load_state_dict(G32.state_dict())
        fwd32, fwd_bf = forward_of(G32, flame_only), forward_of(Gbf,
                                                                 flame_only)
        res = summary[name] = {'batches': {}}
        exceeded = False
        for n in batches:
            out, counts = counted(lambda: fwd_bf(n), kernels)
            check_outputs(out, n)
            if counts['K4bf16'] <= 0 or counts['K4'] != 0:
                raise RuntimeError(f'{name} bf16 batch {n}: K4 launches '
                                   f'{counts}; the bf16 instance must run '
                                   f'and the float32 one must not')
            launches += counts['K4bf16']
            want = fp32_outs[name].get(n) or fwd32(n)
            gaps = bf16_gaps(out, want)
            res['batches'][n] = dict(launches=counts, gaps=gaps)
            exceeded |= not all(g['within'] for g in gaps.values())
            log(f'{name} bf16 512^2 forward, batch {n}: finite, depth in the '
                f'sample range; launches {counts}; against the fp32 forward '
                + '; '.join(f'{k} max-abs {g["max_abs"]:.4g} (fp32 scale '
                            f'{g["scale"]:.4g}), PSNR {g["psnr"]:.2f} dB, '
                            f'{"within" if g["within"] else "beyond"} the '
                            f'bound {BF16_BOUNDS[k]}'
                            for k, g in gaps.items()))
            del out, want
        # the bounds are tests/test_bf16_parity.py's; where the random
        # weights' images exceed them, say where the gap grows
        stages = bf16_stages(G32, Gbf, z[1], c[1],
                             v[1][:, :5023] if flame_only else v[1])
        res['stages_batch_1'] = stages
        res['within_bounds'] = not exceeded
        for stage, s in stages.items():
            log(f'{name} bf16 against fp32 by stage, batch 1: {stage}: '
                f'max-abs {s["max_abs"]:.4g}, RMS {s["rms"]:.4g}, of scale '
                f'{s["scale"]:.4g} ({100 * s["share"]:.2f}%, RMS '
                f'{100 * s["rms_share"]:.3f}%)')
        faults = [k for k, s in stages.items()
                  if not s['rms_share'] <= BF16_STAGE_FAULT]
        if faults:
            raise RuntimeError(f'{name} bf16: stages {faults} are more than '
                               f'{BF16_STAGE_FAULT:.0%} RMS of their scale '
                               f'from fp32')
        for label, fwd in (('fp32', fwd32), ('bf16', fwd_bf)):
            res[f'{label}_img_s'] = throughput(f'{name} {label}', fwd, card,
                                               batches)

        if name == 'flagship':
            res['reenact'] = reenact_rates(G32, Gbf, z[1], c[1], mesh, lms,
                                           device, card)
        del Gbf
        torch.cuda.empty_cache()
    return k4, launches, summary


# phase 17: the port's Inception on the card against its CPU run on the
# same uint8 batch, TF32 off: features relative to the largest feature
# (the CPU tests hold the CPU graph to JAX's within 3e-7 of it), IS
# probabilities absolute
INCEPTION_FEATURE_REL = 1e-4
INCEPTION_PROBS_TOL = 1e-5
# phase 17's dataset: the flagship's own images, enough for FID's
# statistics to be finite
METRIC_IMAGES = 64
# phase 17 (b) and (c): the metric that ``calc-metrics`` and ``train
# --metrics`` compute, fid2k_full's code on fewer generated images (2,000
# took 86 s of the run's time limit)
METRIC = 'fid256_full'
METRIC_GEN_IMAGES = 256


def write_metric_data(G, mesh, lms, device, root, n=METRIC_IMAGES):
    """Phase 17's dataset in ``root``: ``n`` of ``G``'s 512^2 images (batch
    16, jittered expressions, cameras over a yaw and pitch sweep) written as
    PNGs with the head's .obj and landmarks per item, and the head as
    ``head.obj``. Returns the dataset's and the head's paths."""
    import numpy as np
    from next3d_tpu_torch.cli.common import camera_label, frame_uint8
    from next3d_tpu_torch.utils.synthetic_head import save_dataset, save_head

    labels = np.concatenate([camera_label(0.4 * (i / (n - 1) - 0.5),
                                          0.1 * ((i * 7) % n / n - 0.5))
                             for i in range(n)])
    v = head_batch(mesh, lms, n, device, jitter=0.003)
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    z = torch.randn(n, 512, generator=g, device=device)
    images = []
    with torch.no_grad():
        for i in range(0, n, 16):
            c = torch.from_numpy(labels[i:i + 16]).to(device)
            out = G(z[i:i + 16], c, v[i:i + 16], truncation_psi=0.7,
                    truncation_cutoff=14, noise_mode='const')
            images += [frame_uint8(im) for im in out['image']]
    data = save_dataset(os.path.join(root, 'metric_data'), images,
                        v.cpu().numpy(), labels, mesh)
    obj, _ = save_head(os.path.join(root, 'metric_head.obj'), mesh, lms)
    return data, obj


def check_metrics(G, files, device, card, kernels):
    """Phase 17: the metrics at the 512^2 FFHQ config on ``files`` (phase
    13's temporary directory and the data of ``write_metric_data``). (a)
    The port's Inception-2015 graph of seeded weights on the card against
    the CPU on the same uint8 batches at 512^2 (the dataset's images) and
    128^2, TF32 off; scripted to a TorchScript file with the reference
    detector's calling convention, which NEXT3D_INCEPTION_PATH names, so
    that the converter and the attestation run on the card; the
    detector's img/s alone. (b) ``calc-metrics --metrics fid256_full
    --batch 16`` (METRIC: fid2k_full's code on 256 generated images,
    registered here) on a snapshot of ``G`` and the dataset: its jsonl
    record finite, its K1 and K4 launches, wall time and peak memory; the
    feature loop's img/s and the generator's alone at batch 16; KID, PR
    and IS over 256 generated images, each finite. (c) ``train --metrics
    fid256_full`` (phase 13's config: the train command's defaults,
    batch 4) on the dataset for two ticks of one batch with a snapshot
    after the second:
    its jsonl record, not its exit, decides (the hook prints a failure and
    trains on). Returns the phase's launches and summary."""
    import numpy as np
    from next3d_tpu_torch.cli import main as cli
    from next3d_tpu_torch.cli.common import load_generator
    from next3d_tpu_torch.data.dataset import ImageFolderDataset
    from next3d_tpu_torch.metrics import inception, metric_main, metric_utils
    from next3d_tpu_torch.metrics.inception_score import compute_is
    from next3d_tpu_torch.metrics.kernel_inception_distance import \
        compute_kid
    from next3d_tpu_torch.metrics.precision_recall import compute_pr
    from next3d_tpu_torch.utils.checkpoint import save_snapshot
    from next3d_tpu_torch.utils.weights import state_dict_to_params

    tmp, data, obj = files['root'], files['metric_data'], files['metric_obj']
    summary = {}
    launches = {}
    dataset = ImageFolderDataset(data)

    # (a) the graph on the card against the CPU
    params = inception.init_params(SEED)
    cpu_model = inception.inception_of_params(params)
    card_model = inception.inception_of_params(params, device)
    batches = {512: np.stack([dataset[i][0] for i in range(8)]),
               128: np.random.RandomState(SEED).randint(
                   0, 256, (8, 3, 128, 128)).astype(np.uint8)}
    gaps = {}
    with torch.no_grad():
        for size, imgs in batches.items():
            x = torch.from_numpy(imgs)
            want_f = cpu_model(x, return_features=True)
            want_p = cpu_model(x, no_output_bias=True)
            got_f = card_model(x.to(device), return_features=True).cpu()
            got_p = card_model(x.to(device), no_output_bias=True).cpu()
            scale = float(want_f.abs().max())
            gaps[size] = dict(
                feature_max_abs=float((got_f - want_f).abs().max()),
                feature_scale=scale,
                probs_max_abs=float((got_p - want_p).abs().max()))
            log(f'Inception at {size}^2 (8 images), card vs CPU, TF32 off: '
                f'features max-abs {gaps[size]["feature_max_abs"]:.3g} of '
                f'{scale:.3g} (bound {INCEPTION_FEATURE_REL:g} of it), IS '
                f'probabilities max-abs {gaps[size]["probs_max_abs"]:.3g} '
                f'(bound {INCEPTION_PROBS_TOL:g})')
            if not (gaps[size]['feature_max_abs']
                    <= INCEPTION_FEATURE_REL * scale
                    and gaps[size]['probs_max_abs'] <= INCEPTION_PROBS_TOL):
                raise RuntimeError('the Inception graph on the card '
                                   'disagrees with the CPU')
    summary['inception_card_vs_cpu'] = gaps
    path = os.path.join(tmp, 'inception-2015-12-05.pt')
    torch.jit.script(cpu_model).save(path)
    os.environ['NEXT3D_INCEPTION_PATH'] = path
    os.environ.pop('NEXT3D_DETECTOR_IMPL', None)
    t0 = time.time()
    model = inception.converted_inception(path, str(device))
    with open(path + '.torch_parity.json') as f:
        record = json.load(f)
    log(f'scripted detector converted and attested on the card in '
        f'{time.time() - t0:.2f} s: {record}')
    if record['device'] != torch.device(device).type or \
            not record['max_abs_feature_delta'] <= record['tol']:
        raise RuntimeError('the attestation did not run on the card')
    summary['attestation'] = record
    x16 = torch.from_numpy(np.stack([dataset[i][0] for i in range(16)])
                           ).to(device)
    with torch.no_grad():
        ms = time_ms(lambda: model(x16, return_features=True), reps=5)
    detect = inception.make_detector(path, device)
    t0 = time.perf_counter()
    for _ in range(5):
        detect(x16)
    wrapper_ms = (time.perf_counter() - t0) / 5 * 1e3
    summary['detector_img_s'] = 16 / ms * 1e3
    summary['detector_with_host_copy_img_s'] = 16 / wrapper_ms * 1e3
    log(f'detector, batch 16 of 512^2 uint8: {ms:.2f} ms '
        f'({summary["detector_img_s"]:.1f} img/s); with its features '
        f'returned to the host {wrapper_ms:.2f} ms '
        f'({summary["detector_with_host_copy_img_s"]:.1f} img/s); on {card}')

    # (b) calc-metrics through the CLI: fid2k_full's code (compute_fid
    # over the whole dataset) registered on METRIC_GEN_IMAGES generated
    # images
    def fid256_full(opts):
        from next3d_tpu_torch.metrics.frechet_inception_distance import \
            compute_fid
        return {METRIC: compute_fid(opts, max_real=None,
                                    num_gen=METRIC_GEN_IMAGES)}
    metric_main.register_metric(fid256_full)
    snap = os.path.join(tmp, 'metric-snapshot.pkl')
    save_snapshot(snap, params_G_ema=state_dict_to_params(G.state_dict()),
                  config={'G_kwargs': G_KWARGS})
    run_dir = os.path.join(tmp, 'calc_metrics')
    os.makedirs(run_dir)
    argv = ['calc-metrics', '--network', snap, '--metrics', METRIC,
            '--data', data, '--topology-path', obj, '--run-dir', run_dir,
            '--batch', '16', '--device', str(device)]
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    (record,), counts = counted(lambda: cli.run(argv), kernels)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with open(os.path.join(run_dir, f'metric-{METRIC}.jsonl')) as f:
        written = [json.loads(line) for line in f]
    fid = written[-1]['results'][METRIC]
    launches[f'calc-metrics {METRIC}'] = {k: counts[k] for k in ('K1', 'K4')}
    log(f'calc-metrics --metrics {METRIC} --batch 16: {METRIC} {fid:.4f}'
        f' (metric {written[-1]["total_time"]:.1f} s, command {wall:.1f} s),'
        f' peak device memory {peak:.2f} GiB (max_memory_allocated); '
        f'launches {counts}; on {card}')
    if len(written) != 1 or not math.isfinite(fid) or \
            counts['K1'] <= 0 or counts['K4'] <= 0:
        raise RuntimeError(f'calc-metrics wrote no finite {METRIC}, or '
                           'its generator ran without K1 or K4')
    summary[METRIC] = dict(value=fid, metric_s=written[-1][
        'total_time'], command_s=wall, peak_device_mem_gb=peak)

    cli_generator = load_generator(snap, obj, device)
    opts = metric_utils.MetricOptions(generator=cli_generator,
                                      dataset=dataset, batch_size=16,
                                      device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metric_utils.compute_feature_stats_for_generator(opts, max_items=320)
    torch.cuda.synchronize()
    summary['feature_loop_img_s'] = 320 / (time.perf_counter() - t0)
    z, c, v = metric_utils.draw_conditioning(opts, np.random.RandomState(0))
    with torch.no_grad():
        def forward():
            return cli_generator.synthesis(cli_generator.mapping(z, c), c, v,
                                           noise_mode='const')['image']
        summary['generator_img_s'] = 16 / median_ms(forward) * 1e3
    log(f'feature loop, 320 images at batch 16: '
        f'{summary["feature_loop_img_s"]:.2f} img/s; the generator alone '
        f'{summary["generator_img_s"]:.2f} img/s, the detector alone '
        f'{summary["detector_img_s"]:.1f} img/s; on {card}')
    t0 = time.time()
    kid = compute_kid(opts, max_real=None, num_gen=256)
    precision, recall = compute_pr(opts, max_real=None, num_gen=256)
    is_mean, is_std = compute_is(opts, num_gen=256, num_splits=4)
    others = dict(kid=kid, precision=precision, recall=recall,
                  is_mean=is_mean, is_std=is_std)
    log(f'KID, PR and IS over 256 generated images ({time.time() - t0:.1f}'
        f' s): {others}')
    if not all(math.isfinite(x) for x in others.values()):
        raise RuntimeError('a metric is not finite')
    summary['kid_pr_is_256'] = others
    del cli_generator, opts

    # (c) train --metrics, the same metric
    out = os.path.join(tmp, 'run_metrics')
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    result, counts = counted(lambda: cli.run([
        'train', '--outdir', out, '--data', data, '--batch', '4', '--kimg',
        '0.008', '--tick', '0.004', '--snap', '1', '--topology-path', obj,
        '--device', str(device), '--metrics', METRIC]), kernels)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    path = os.path.join(out, f'metric-{METRIC}.jsonl')
    written = []
    if os.path.exists(path):
        with open(path) as f:
            written = [json.loads(line) for line in f]
    launches[f'train --metrics {METRIC}'] = {
        k: counts[k] for k in ('K1', 'K4', 'K4b')}
    log(f'train --metrics {METRIC}, 2 ticks of one batch of 4 at '
        f'512^2: {wall:.1f} s; records {written}; peak device memory '
        f'{peak:.2f} GiB; launches {counts}; on {card}')
    if result['cur_nimg'] != 8 or len(written) != 1 or \
            written[0]['snapshot_pkl'] != 'network-snapshot-000000.pkl' or \
            written[0]['cur_nimg'] != 8 or \
            not math.isfinite(written[0]['results'][METRIC]):
        raise RuntimeError(f'train --metrics wrote no finite {METRIC} '
                           'record after its snapshot')
    summary[f'train_{METRIC}'] = dict(
        value=written[0]['results'][METRIC],
        metric_s=written[0]['total_time'], command_s=wall,
        peak_device_mem_gb=peak)
    summary['launches'] = launches
    return launches, summary


def reenact_rates(G32, Gbf, z, c, mesh, lms, device, card):
    """reenact's per-frame path (synthesis_from_identity, identity built
    once) over 16 jittered frames at batch 1, fp32 and bf16: f/s from the
    start of the first frame to the end of the last. The bf16 path's first
    frame (the neutral head) is held to the bf16 synthesis under
    deterministic cuDNN."""
    frames = head_batch(mesh, lms, 16, device, jitter=0.003)
    rates = {}
    for label, G in (('fp32', G32), ('bf16', Gbf)):
        ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
        textures, static = G.build_identity(ws, noise_mode='const')

        def run():
            outs = [G.synthesis_from_identity(ws, textures, static, c,
                                              frames[f:f + 1],
                                              noise_mode='const')
                    for f in range(len(frames))]
            torch.cuda.synchronize()
            return outs

        run()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = run()
        seconds = time.perf_counter() - t0
        for out in outs:
            check_outputs(out, 1)
        rates[label] = len(frames) / seconds
        log(f'reenact path {label}: {len(frames)} frames at 512^2, batch 1, '
            f'identity cached: {rates[label]:.3f} f/s on {card}')
        if label == 'bf16':
            torch.backends.cudnn.deterministic = True
            ref = G.synthesis(ws, c, frames[:1], noise_mode='const')
            got = G.synthesis_from_identity(ws, textures, static, c,
                                            frames[:1], noise_mode='const')
            torch.backends.cudnn.deterministic = False
            err = max(float((got[k] - ref[k]).abs().max()) for k in ref)
            log(f'bf16 synthesis_from_identity frame 0 vs bf16 synthesis, '
                f'deterministic cuDNN: max-abs {err:.3g}')
            if not err <= 1e-4:
                raise RuntimeError('bf16 identity-cached synthesis disagrees')
    return rates


# phase 18 (a): the binned bf16 backward's stages, by a piece of their
# kernel's name in a profiler trace
BINNED_STAGES = (('memset', 'Memset'), ('count', 'bwd_bin_count_kernel'),
                 ('scan', 'bwd_bin_scan_kernel'),
                 ('place', 'bwd_bin_place_kernel'),
                 ('resolve', 'bwd_bin_resolve_kernel'),
                 ('merge', 'bwd_bin_merge_kernel'))


def check_k4_bf16_backward(device, fine):
    """Phase 18 (a): K4's bf16 backward, the binned kernels, on phase 13's
    point sets of 4 images ((a) coarse, (b) jittered, (c) ``fine``, the
    fine pass of the flagship's forward at batch 4, (d) one texel, and (a)
    shuffled), planes' gradient (4, 3, 256, 256, 32) bf16: each against the
    plain version within one bf16 ulp plus 1e-5 of the largest gradient,
    its tile counts against bin_counts, timed beside the chain it replaces,
    the plain version and grid_sampler_2d_backward; then set (a) through
    the autograd Function. Returns set (a)'s numbers, with every set's
    under 'sets'."""
    import numpy as np
    from next3d_tpu_torch.ops import triplane
    from next3d_tpu_torch.ops.triplane import (_backward_bf16_cuda,
                                               bin_counts, channels_last,
                                               kernel_positions, merge_plain,
                                               project_onto_planes,
                                               triplane_sample,
                                               triplane_sample_backward,
                                               triplane_sample_backward_bf16,
                                               triplane_sample_backward_plain,
                                               triplane_sample_plain)
    from next3d_tpu_torch.render.ray_sampler import sample_rays
    from next3d_tpu_torch.render.renderer import sample_stratified
    g = torch.Generator(device=device).manual_seed(SEED)
    c = ffhq_camera(4, device)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 64)
    points = {}
    for name, gen in (('coarse', None), ('jittered', g)):
        depths = sample_stratified(gen, ro, 2.25, 3.3, 48)
        points[name] = (ro[:, :, None] + depths * rd[:, :, None]).reshape(
            4, -1, 3)
    points['fine'] = fine
    M = points['coarse'].shape[1]
    points['one_cell'] = 0.1 + 1e-3 * torch.rand(4, M, 3, generator=g,
                                                 device=device)
    perm = torch.randperm(M, generator=g, device=device)
    points['coarse_shuffled'] = points['coarse'][:, perm].contiguous()
    feats = torch.zeros(12, 32, 256, 256, device=device)
    sets = {}
    for name, coords in points.items():
        M = coords.shape[1]
        grad_out = torch.randn(4, 3, M, 32, generator=g, device=device)
        args = (grad_out, coords, 1.0, 256, 256)
        got, workspace = _backward_bf16_cuda(*args)
        want = triplane_sample_backward_plain(*args).to(torch.bfloat16)
        want64 = triplane_sample_backward_plain(grad_out.double(),
                                                *args[1:])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        within = bool((err <= BF16_ULP * want.float().abs()
                       + 1e-5 * scale).all())
        err64 = float((got.double() - want64).abs().max())
        # the kernels' tile counts against the model's
        counts = bin_counts(coords, 1.0, 256, 256)
        starts = workspace[2:counts.numel() + 3].long()
        same_counts = torch.equal(starts[1:] - starts[:-1], counts)
        ix, iy = kernel_positions(coords, 1.0, 256, 256)
        pairs = int(((ix >= -1) & (ix < 256) & (iy >= -1) & (iy < 256))
                    .sum())
        _, _, _, taps = merge_plain(*args)
        grid = project_onto_planes(2.0 * coords)[:, None]       # box_warp 1
        grad_cf = grad_out.reshape(12, M, 32).permute(0, 2, 1)[:, :, None]

        def binned():
            return triplane_sample_backward_bf16(*args)

        def chain():
            return triplane_sample_backward(*args).to(torch.bfloat16)

        # in turns: chain, binned, binned, chain
        chain_ms = [time_ms(chain)]
        ms = [time_ms(binned), time_ms(binned)]
        chain_ms.append(time_ms(chain))
        # each stage (and each kernel of the chain) runs once a call: its
        # mean over the calls the trace kept (a trace of a long run can drop
        # some; 'profiled_calls' says how many it kept of 10)
        stages = device_times(binned)
        stage_ms = {stage: sum(statistics.mean(t) for k, t in stages.items()
                               if part in k)
                    for stage, part in BINNED_STAGES}
        profiled = min(len(t) for k, t in stages.items()
                       if 'bwd_bin_resolve_kernel' in k)
        out = dict(
            max_abs_err=float(err.max()), max_abs_err_float64=err64,
            largest_gradient=scale,
            differing=float((err > 0).float().mean()),
            ms=statistics.mean(ms), ms_runs=ms,
            device_ms=sum(stage_ms.values()), stage_device_ms=stage_ms,
            profiled_calls=profiled,
            kernel_device_ms=sum(t for k, t in stage_ms.items()
                                 if k != 'memset'),
            chain_ms=statistics.mean(chain_ms), chain_ms_runs=chain_ms,
            chain_device_ms=sum(statistics.mean(t)
                                for t in device_times(chain).values()),
            plain_ms=time_ms(lambda: triplane_sample_backward_plain(
                *args).to(torch.bfloat16), reps=3),
            library_ms=time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                grad_cf, feats, grid, 0, 0, False, [True, False])),
            entries=int(counts.sum()), duplicates=int(counts.sum()) - pairs,
            largest_tile=int(counts.max()), chunks=int(workspace[0]),
            split_tiles=int(workspace[1]), taps=taps,
            **bound(nbytes(grad_out, coords, got), taps * 32 * 2))
        out['faster_than_chain'] = out['ms'] < out['chain_ms']
        sets[name] = out
        log(f'K4 bf16 backward, {name} points, planes\' gradient (4, 3, 256, '
            f'256, 32) bf16, {M} points an image: max-abs {err.max():.3g} '
            f'against the plain version cast (largest {scale:.3g}; '
            f'{100 * out["differing"]:.3f}% of the values differ; '
            f'{err64:.3g} against it in float64), within one bf16 ulp + '
            f'1e-5 of the largest: {within}; tile counts equal to '
            f'bin_counts: {same_counts}; binned {out["ms"]:.4f} ms '
            f'({", ".join(f"{t:.4f}" for t in ms)}; device '
            f'{out["device_ms"]:.4f} over {profiled} profiled calls: '
            + ', '.join(f'{k} {t:.4f}' for k, t in stage_ms.items())
            + f'), the chain it replaces (float32 kernel and cast) '
            f'{out["chain_ms"]:.4f} ms ('
            f'{", ".join(f"{t:.4f}" for t in chain_ms)}; device '
            f'{out["chain_device_ms"]:.4f}), plain {out["plain_ms"]:.3f} '
            f'ms, grid_sampler_2d_backward on the planes upcast '
            f'{out["library_ms"]:.3f} ms, bound {out["bound_ms"]:.4f} ms by '
            f'{out["bound_by"]}; {out["entries"]} entries in '
            f'{counts.numel()} tiles ({out["duplicates"]} duplicates of '
            f'{pairs} (point, plane) pairs), largest tile '
            f'{out["largest_tile"]}, {out["chunks"]} chunks, '
            f'{out["split_tiles"]} split tiles; {taps} in-range taps')
        if not (within and same_counts and np.isfinite(scale)
                and scale > 0):
            raise RuntimeError(f'K4\'s bf16 backward disagrees on {name}')
        del grad_out, got, want, want64, err, grid, grad_cf, workspace

    # set (a) through the autograd Function, one launch, against the plain
    # version's autograd gradient of the same bf16 planes
    raw = torch.randn(4, 3, 32, 256, 256, generator=g, device=device)
    planes = channels_last(raw, torch.bfloat16)
    coords = points['coarse']
    grad_out = torch.randn(4, 3, coords.shape[1], 32, generator=g,
                           device=device)
    grads = []
    before = triplane.triplane_sample_backward_bf16.launches
    with torch.enable_grad():
        for sample in (triplane_sample, triplane_sample_plain):
            p = planes.clone().requires_grad_()
            sample(p, coords, 1.0).backward(grad_out)
            grads.append(p.grad)
    launches = triplane.triplane_sample_backward_bf16.launches - before
    got, want = grads
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    within = bool((err <= BF16_ULP * want.float().abs()
                   + 1e-5 * scale).all())
    log(f'K4 bf16 backward through the autograd Function, coarse points: '
        f'{got.dtype}, max-abs {err.max():.3g} against the plain version\'s '
        f'autograd gradient (largest {scale:.3g}), within: {within}; '
        f'binned launches {launches}')
    if not (got.dtype == want.dtype == torch.bfloat16 and within
            and launches == 1):
        raise RuntimeError('K4\'s bf16 backward through autograd disagrees '
                           'or did not launch the binned kernels')
    return dict(sets['coarse'], sets=sets)


def check_remat(G, mesh, lms, device, card):
    """Phase 18 (b): Gmain of the flagship ``G`` at batch 4, fp32, with
    remat_synthesis off and on, from one generator seed."""
    from next3d_tpu_torch.nn.discriminator import DualDiscriminator
    from next3d_tpu_torch.ops import raster
    from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
    from next3d_tpu_torch.train.train_step import trainable_mask
    D = DualDiscriminator(c_dim=25, img_resolution=512, img_channels=3,
                          generator=torch.Generator().manual_seed(SEED))
    D = D.to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    c = ffhq_camera(4, device)
    batch = dict(gen_z=torch.randn(4, 512, generator=g, device=device),
                 gen_c=c, gen_v=head_batch(mesh, lms, 4, device), real_c=c)
    mask = trainable_mask(G)
    params = [p for k, p in G.named_parameters() if mask[k]]

    def gmain(remat):
        loss_obj = StyleGAN2Loss(G, D, LossConfig(remat_synthesis=remat))
        sched, nrr = loss_obj.schedules(0)
        generator = torch.Generator(device=device).manual_seed(SEED + 1)
        raster.rasterize_binned_uv.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _, _ = loss_obj.gmain_loss(batch, generator, sched, nrr)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        flat = torch.cat([(gr if gr is not None else torch.zeros_like(p))
                          .reshape(-1) for gr, p in zip(grads, params)])
        return dict(loss=float(loss.detach()), grad=flat, ms=ms,
                    peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                    k1_launches=raster.rasterize_binned_uv.launches)

    runs = {}
    for remat in (False, True):
        first = gmain(remat)        # cuDNN's first calls, the allocator
        runs[remat] = gmain(remat)
        runs[remat]['first'] = first
    off, on = runs[False], runs[True]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    spread = rel(off['first']['grad'], off['grad'])
    out = dict(
        loss_off=off['loss'], loss_on=on['loss'],
        loss_rel=abs(on['loss'] - off['loss']) / abs(off['loss']),
        grad_rel=rel(on['grad'], off['grad']), grad_rel_spread_off=spread,
        ms_off=off['ms'], ms_on=on['ms'], peak_gib_off=off['peak_gib'],
        peak_gib_on=on['peak_gib'], k1_launches_off=off['k1_launches'],
        k1_launches_on=on['k1_launches'], card=card)
    log(f'remat_synthesis, flagship Gmain at batch 4 fp32 (noise and depths '
        f'from one device seed): loss off {off["loss"]:.7g}, on '
        f'{on["loss"]:.7g} (relative {out["loss_rel"]:.3g}); G\'s gradient '
        f'on vs off relative L2 {out["grad_rel"]:.3g} (off vs off '
        f'{spread:.3g}); ms off {off["ms"]:.1f}, on {on["ms"]:.1f}; peak '
        f'{off["peak_gib"]:.2f} GiB off, {on["peak_gib"]:.2f} GiB on; K1 '
        f'launches off {off["k1_launches"]}, on {on["k1_launches"]}; {card}')
    if not (out['loss_rel'] <= REMAT_LOSS_REL
            and out['grad_rel'] <= REMAT_GRAD_REL):
        raise RuntimeError('remat_synthesis changed Gmain')
    if (off['k1_launches'], on['k1_launches']) != (1, 2):
        raise RuntimeError('remat did not recompute the synthesis once')
    del D, runs, off, on
    return out


def run_bench(mode, bf16):
    """Phase 18 (c): one ``python3 -m next3d_tpu_torch.bench`` run at batch
    8 and NEXT3D_BENCH_ITERS=4; its JSON line and what it reports on
    stderr."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('NEXT3D_BENCH_')}
    env.update(NEXT3D_BENCH_MODE=mode, NEXT3D_BENCH_BF16=bf16,
               NEXT3D_BENCH_BATCH='8', NEXT3D_BENCH_ITERS='4')
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, '-m', 'next3d_tpu_torch.bench'],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.time() - t0
    tag = f'bench {mode} bf16={bf16}'
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise RuntimeError(f'{tag}: exit code {proc.returncode}')
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise RuntimeError(f'{tag}: {len(lines)} lines on stdout')
    record = json.loads(lines[0])
    value = record.get('value')
    if not (isinstance(value, (int, float)) and math.isfinite(value)
            and value > 0):
        raise RuntimeError(f'{tag}: value {value!r}')
    err = proc.stderr.splitlines()
    out = dict(line=record, wall_s=wall,
               steps=[ln for ln in err if ln.startswith('step seconds')],
               peak=[ln for ln in err if ln.startswith('peak device')],
               mfu=[ln for ln in err if 'GFLOP/img' in ln],
               launches=json.loads(next(
                   ln for ln in err if ln.startswith('kernel launches: '))
                   .split(': ', 1)[1]))
    log(f'{tag}: {lines[0]}; {out["steps"]} {out["peak"]} {out["mfu"]}; '
        f'launches {out["launches"]}; {wall:.1f} s')
    return out


def check_bench():
    """Phase 18 (c): BENCH_RUNS; each run's kernels of the path must have
    launched (K1 and K4's bf16 or float32 instance; in train also K4's
    backward of that precision)."""
    runs = {}
    for mode, bf16 in BENCH_RUNS:
        run = run_bench(mode, bf16)
        need = ['K1', 'K4bf16' if bf16 == '1' else 'K4']
        if mode == 'train':
            need.append('K4b_bf16' if bf16 == '1' else 'K4b')
        if min(run['launches'][k] for k in need) <= 0:
            raise RuntimeError(f'bench {mode} bf16={bf16} launched none of '
                               f'{need}: {run["launches"]}')
        runs[f'{mode} bf16={bf16}'] = run
    return runs


# phase 19 (b): the parity tests' loss (tests/torch_train_parity.py
# LOSS_CFG: no conditioning swap, no blur, no style mixing) with constant
# noise and midpoint depths, and the gains and learning rates of the train
# command's defaults
PARITY_LOSS = dict(gpc_reg_prob=0.0, gpc_reg_fade_kimg=0.0,
                   neural_rendering_resolution_initial=64, density_reg=0.25,
                   density_reg_p_dist=0.004, r1_gamma=4.0)
PARITY_GAINS = {'Gmain': 1.0, 'Greg': 4.0, 'Dmain': 1.0, 'Dreg': 16.0}
PARITY_LR = {'G': 0.0025, 'D': 0.002}
# Greg's gradient, a difference of two that nearly cancel, is held by its
# norm alone, as the parity tests hold it
PARITY_PER_TENSOR = {'Gmain': True, 'Greg': False, 'Dmain': True,
                     'Dreg': True}
RANKS_TIMEOUT_S = 400


def grads_gate(got, want, per_tensor):
    """tests/torch_train_parity.py assert_grads_match's gate, on tensors:
    the global norm within 1e-3 relative and, with ``per_tensor``, each
    tensor within max-abs 2e-3 of its largest value plus 1e-3 of its
    sub-network's largest. Returns (passed, worst max-abs / largest and its
    name, the norms, the names over the per-tensor gate)."""
    net_scale = {}
    for k, w in want.items():
        net = k.split('.')[0]
        net_scale[net] = max(net_scale.get(net, 0.0), float(w.abs().max()))
    worst, failed = (0.0, None), []
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        if per_tensor and not err <= 2e-3 * scale + 1e-3 * net_scale[
                k.split('.')[0]]:
            failed.append(k)
        if scale > 0 and err / scale >= worst[0]:
            worst = (err / scale, k)
    norms = [math.sqrt(sum(float(t[k].double().square().sum())
                           for k in want)) for t in (got, want)]
    return (not failed and abs(norms[0] - norms[1]) <= 1e-3 * norms[1],
            worst, norms, failed)


def parity_networks(mesh, spec):
    """Phase 19 (b)'s G and D of ``spec`` (the flagship of phase 6's seed
    and a dual discriminator of the train command's widths) on its device,
    and the parity loss."""
    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
    from next3d_tpu_torch.nn.discriminator import DualDiscriminator
    from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
    G = TriPlaneGenerator(topology_path=mesh, **spec['G_kwargs'],
                          generator=torch.Generator().manual_seed(SEED))
    D = DualDiscriminator(**spec['D_kwargs'],
                          generator=torch.Generator().manual_seed(SEED + 1))
    G, D = G.to(spec['device']), D.to(spec['device'])
    return G, D, StyleGAN2Loss(G, D, LossConfig(**PARITY_LOSS),
                               deterministic=True)


def parity_inputs(files, device):
    """Phase 19 (b)'s networks and global batch 4 of phase 13's dataset:
    latents of a seed, its labels and verts (items 4-7) for G, its images
    and labels (items 0-3) as the reals, and Greg's 1000 points an image
    with their perturbations and ray directions."""
    import numpy as np
    rs = np.random.RandomState(SEED + 3)
    initial = rs.rand(4, 1000, 3).astype(np.float32) * 2 - 1
    perturbed = initial + rs.randn(4, 1000, 3).astype(np.float32) * 0.004
    dirs = rs.randn(4, 2000, 3).astype(np.float32)
    images = np.stack(files['images'][:4]).transpose(0, 3, 1, 2)
    spec = dict(
        device=str(device), G_kwargs=G_KWARGS,
        D_kwargs=dict(c_dim=25, img_resolution=512, img_channels=3,
                      channel_base=32768, channel_max=512,
                      epilogue_kwargs=dict(mbstd_group_size=4)),
        batch=dict(gen_z=torch.from_numpy(rs.randn(4, 512).astype(
            np.float32)), gen_c=torch.from_numpy(files['labels'][4:8]),
            gen_v=files['v'][4:8].cpu(),
            real_c=torch.from_numpy(files['labels'][:4])),
        real=torch.from_numpy(images.astype(np.float32) / 127.5 - 1),
        draws=tuple(torch.from_numpy(x) for x in (initial, perturbed, dirs)))
    return spec


def parity_reference(mesh, spec, device):
    """The parent's side of phase 19 (b): each phase's loss and gradient
    (times its gain) on each half of the batch, then their mean over the
    halves, with the parity loss on the same weights; returns
    {phase: (loss, {name: gradient on the host})}."""
    from next3d_tpu_torch.train.train_step import trainable_mask
    G, D, loss = parity_networks(mesh, spec)
    sched, nrr = loss.schedules(0)
    nets = {'G': G, 'D': D}
    out = {}
    for h in (slice(0, 2), slice(2, 4)):
        batch = {k: x[h].to(device) for k, x in spec['batch'].items()}
        real = loss.prepare_real(spec['real'][h].to(device), 0.0, nrr)
        draws = [tuple(x[h].to(device) for x in spec['draws'])]
        gen = torch.Generator(device=device).manual_seed(SEED)
        phases = {
            'Gmain': ('G', lambda: loss.gmain_loss(batch, gen, sched, nrr)),
            'Greg': ('G', lambda: loss.greg_loss(batch, gen, sched, draws)),
            'Dmain': ('D', lambda: loss.dmain_loss(batch, real, gen, sched,
                                                   nrr)),
            'Dreg': ('D', lambda: loss.dreg_loss(batch, real, gen, sched))}
        for phase, (net, fn) in phases.items():
            value = fn()[0]
            mask = trainable_mask(nets[net])
            named = {k: p for k, p in nets[net].named_parameters()
                     if mask[k]}
            grads = torch.autograd.grad(value * PARITY_GAINS[phase],
                                        list(named.values()),
                                        allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(p))
                     .detach() / 2 for (k, p), g in zip(named.items(), grads)}
            if phase in out:
                prev_loss, prev = out[phase]
                out[phase] = (prev_loss + float(value.detach()) / 2,
                              {k: (prev[k] + g).cpu() for k, g in
                               grads.items()})
            else:
                out[phase] = (float(value.detach()) / 2, grads)
    del G, D, loss
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def digest(*modules):
    """A hash of the modules' state_dict bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def parallel_rank(rank, init_file, spec_path, out_dir):
    """One of phase 19 (b)'s two ranks on the one card over gloo: the four
    phases on its half of the batch with the learning rates 0 (each phase
    sees the same weights; the gradient Adam receives, all-reduced, is
    kept), then ``run_phases`` with the real learning rates and Greg's
    random points of the rank's own generator; saves the gradients (rank
    0), the stats, the all-reduce times and a hash of G, D and G_ema."""
    import copy
    from next3d_tpu_torch.parallel import dist
    from next3d_tpu_torch.train.train_step import (TrainStep,
                                                   make_optimizer,
                                                   trainable_parameters)
    from next3d_tpu_torch.train.training_loop import rank_seed
    from next3d_tpu_torch.utils.profiling import PhaseTimer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as the reference's halves (check_two_ranks)
    torch.backends.cudnn.deterministic = True
    spec = torch.load(spec_path, weights_only=False)
    device = torch.device(spec['device'])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    mesh, _ = load_head()
    G, D, loss = parity_networks(mesh, spec)
    G_ema = copy.deepcopy(G).eval()
    step = TrainStep(
        loss,
        make_optimizer(trainable_parameters(G), 0.0, 0.0, 0.99, 1e-8,
                       reg_interval=4),
        make_optimizer(trainable_parameters(D, D.frozen_paths()), 0.0, 0.0,
                       0.99, 1e-8, reg_interval=16))
    grads = []
    for opt, net in ((step.opt_G, G), (step.opt_D, D)):
        names = {p: k for k, p in net.named_parameters()}
        adam_step = opt.step

        def capture(*a, _opt=opt, _names=names, _step=adam_step, **k):
            if len(grads) < 4 and rank == 0:
                grads.append({_names[p]: p.grad.cpu() for g in
                              _opt.param_groups for p in g['params']})
            return _step(*a, **k)
        opt.step = capture

    dist.init(rank, 2, 'gloo', init_file)
    try:
        batch = {k: dist.shard_batch(x, device)
                 for k, x in spec['batch'].items()}
        real = dist.shard_batch(spec['real'], device)
        draws = [tuple(dist.shard_batch(x, device) for x in spec['draws'])]
        gen = torch.Generator(device=device).manual_seed(rank_seed(SEED,
                                                                   rank))
        sched, nrr = loss.schedules(0)
        timer = PhaseTimer(device)
        stats = {}
        stats.update(step.gmain(batch, gen, sched, nrr, timer=timer))
        stats.update(step.greg(batch, gen, PARITY_GAINS['Greg'], sched,
                               draws=draws, timer=timer))
        stats.update(step.dmain(batch, real, gen, sched, nrr, timer=timer))
        stats.update(step.dreg(batch, real, PARITY_GAINS['Dreg'], gen,
                               sched, nrr, timer=timer))
        first = timer.report()
        timer.reset()
        for opt, lr in ((step.opt_G, PARITY_LR['G']),
                        (step.opt_D, PARITY_LR['D'])):
            for group in opt.param_groups:
                group['lr'] = lr
        step.run_phases(G_ema, batch, real, gen, sched, nrr, do_greg=True,
                        do_dreg=True, ema_beta=0.5, timer=timer)
        result = dict(grads=grads, stats={k: float(v) for k, v in
                                          stats.items()},
                      allreduce_s=first, run_phases_s=timer.report(),
                      digest=digest(G, D, G_ema),
                      peak_gb=torch.cuda.max_memory_allocated(device)
                      / 2 ** 30 if device.type == 'cuda' else None)
    finally:
        dist.teardown()
    torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))


def check_parallel(files, mesh, device, card, kernels, phase13):
    """Phase 19: data-parallel training. Returns its launches (of (a)) and
    its summary."""
    summary = dict(card=card, world_size_1_nccl=check_nccl_world_1(
        files, device, card, kernels, phase13))
    launches = summary['world_size_1_nccl'].pop('launches')
    summary['two_ranks_gloo'] = check_two_ranks(files, mesh, device, card)
    summary['gpus_over_visible'] = check_gpus_raise(files)
    return launches, summary


def bucket_mib(module, stats, w_dim=0):
    """MiB of a phase's all-reduce bucket: the module's trainable
    gradients, the phase's stats and w_mean (float32)."""
    n = sum(p.numel() for p in module.parameters() if p.requires_grad)
    return (n + stats + w_dim) * 4 / 2 ** 20


def check_nccl_world_1(files, device, card, kernels, phase13):
    """Phase 19 (a): the train command's rank entry (``cli/train.py
    run_rank``) at world size 1 over NCCL, at phase 13's config: batch 4,
    two ticks of 4 batches, a snapshot after the second. The replica check
    runs at the snapshot and passes; rank 0 alone wrote the run directory.
    Logs img/s beside phase 13's, the all-reduce ms of each phase, the
    buckets' MiB and the peak memory."""
    from next3d_tpu_torch.cli import main as cli
    from next3d_tpu_torch.cli.train import run_rank
    from next3d_tpu_torch.parallel import dist

    run = os.path.join(files['root'], 'run_nccl')
    argv = ['train', '--outdir', run, '--data', files['data'], '--batch',
            '4', '--kimg', '0.032', '--tick', '0.016', '--snap', '1',
            '--topology-path', files['obj'], '--timing-every', '1']
    opts = vars(cli.build_parser().parse_args(argv))
    opts.pop('command')
    opts.pop('device')
    checks = []
    check = dist.check_replica_consistency

    def counting(*args, **kwargs):
        check(*args, **kwargs)
        checks.append(1)

    dist.check_replica_consistency = counting
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            result, counts = counted(lambda: run_rank(
                0, 1, 'nccl', os.path.join(tmp, 'rendezvous'), opts, 'cuda'),
                kernels)
    finally:
        dist.check_replica_consistency = check
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    listing = sorted(os.listdir(run))
    events = [f for f in listing if f.startswith('events.out.')]
    snap = 'network-snapshot-000000.pkl'
    want = {'training_options.json', 'stats.jsonl', 'reals.png',
            'fakes000000.png', 'fakes000000_raw.png', snap,
            snap.replace('.pkl', '.json'), *events}
    with open(os.path.join(run, 'stats.jsonl')) as f:
        lines = len(f.readlines())
    first, warm = result['ticks'][0], result['ticks'][-1]
    warm_allreduce = {p: 1e3 * warm[f'Timing/{p}/allreduce']
                      for p in ('Gmain', 'Greg', 'Dmain')
                      if f'Timing/{p}/allreduce' in warm}
    buckets = {'Gmain': bucket_mib(result['G'], 3, 512),
               'Greg': bucket_mib(result['G'], 1),
               'Dmain': bucket_mib(result['D'], 5, 512),
               'Dreg': bucket_mib(result['D'], 2)}
    out = dict(seconds=seconds, images_per_second=warm['images_per_second'],
               phase13_images_per_second=phase13['images_per_second'],
               allreduce_ms_first_tick={p: 1e3 * first[
                   f'Timing/{p}/allreduce'] for p in PARITY_GAINS},
               allreduce_ms_warm=warm_allreduce, bucket_mib=buckets,
               phase_ms_warm={p: 1e3 * warm[f'Timing/{p}'] for p in
                              ('Gmain', 'Dmain', 'G_ema')},
               peak_device_mem_gb=peak, replica_checks=len(checks),
               launches={k: counts[k] for k in ('K1', 'K4', 'K4b')})
    def rounded(d, digits=3):
        return {k: round(x, digits) for k, x in d.items()}

    log(f'phase 19 (a): train through the rank entry at world size 1 over '
        f'NCCL, 512^2 FFHQ, batch 4, 8 batches in 2 ticks: '
        f'{seconds:.1f} s with its set-up; last tick '
        f'{out["images_per_second"]:.3f} img/s (phase 13, same call: '
        f'{phase13["images_per_second"]:.3f}); all-reduce ms, first tick '
        f'{rounded(out["allreduce_ms_first_tick"])}, warm '
        f'{rounded(warm_allreduce)}; bucket MiB {rounded(buckets, 2)}; '
        f'peak device memory {peak:.2f} GiB; replica checks passed '
        f'{len(checks)}; launches {counts}; run dir {listing}; on {card}')
    if not checks:
        raise RuntimeError('phase 19 (a): the replica check never ran')
    if set(listing) != want or len(events) != 1 or lines != 2:
        raise RuntimeError(f'phase 19 (a): the run dir is not one '
                           f'writer\'s: {listing}, {lines} stats lines')
    bad = [k for t in result['ticks'] for k, x in t.items()
           if isinstance(x, float) and not math.isfinite(x)]
    idle = [k for k in ('K1', 'K4', 'K4b') if counts[k] <= 0]
    if bad or idle:
        raise RuntimeError(f'phase 19 (a): not finite {bad}, or kernels '
                           f'{idle} never launched')
    del result
    return out


def check_two_ranks(files, mesh, device, card):
    """Phase 19 (b): two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), the 512^2 flagship in fp32 at global batch 4 (2
    a rank), the parity tests' deterministic loss: each phase's all-reduced
    gradient against this process's mean over the two halves on the same
    weights (``grads_gate``), the losses within 1e-4 relative, and both
    ranks' G, D and G_ema bit-equal after ``run_phases``."""
    spec = parity_inputs(files, device)
    # the ranks and this process compute each half with cuDNN's
    # deterministic algorithms: with the default ones, which may add with
    # atomics, Dmain's worst gap ranged from 0.000106 to 0.0232 of a
    # tensor's largest gradient over five runs on H100s and failed the gate
    # once (b4.conv.weight); run-to-run noise is not what this phase checks
    torch.backends.cudnn.deterministic = True
    t0 = time.time()
    try:
        want = parity_reference(mesh, spec, device)
    finally:
        torch.backends.cudnn.deterministic = False
    ref_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, 'spec.pt')
        torch.save(spec, spec_path)
        t0 = time.time()
        context = torch.multiprocessing.spawn(
            parallel_rank, nprocs=2, join=False,
            args=(os.path.join(tmp, 'rendezvous'), spec_path, tmp))
        deadline = time.time() + RANKS_TIMEOUT_S
        while not context.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                for p in context.processes:
                    p.kill()
                raise RuntimeError('phase 19 (b): the ranks did not end')
        ranks_s = time.time() - t0
        got = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                          weights_only=False) for r in (0, 1)]
    stat = {'Gmain': 'Loss/G/loss', 'Greg': 'Loss/G/reg',
            'Dmain': 'Loss/D/loss', 'Dreg': 'Loss/D/reg'}
    out = dict(reference_s=ref_s, ranks_s=ranks_s, phases={},
               allreduce_ms={k.split('/')[1]: 1e3 * v for k, v in
                             got[0]['allreduce_s'].items()
                             if k.endswith('/allreduce')},
               allreduce_ms_rank1={k.split('/')[1]: 1e3 * v for k, v in
                                   got[1]['allreduce_s'].items()
                                   if k.endswith('/allreduce')},
               run_phases_ms={k: 1e3 * v for k, v in
                              got[0]['run_phases_s'].items()},
               peak_device_mem_gb=[r['peak_gb'] for r in got],
               replicas_bit_equal=got[0]['digest'] == got[1]['digest'])
    failed = []
    for i, phase in enumerate(PARITY_GAINS):
        want_loss, want_grads = want[phase]
        loss = got[0]['stats'][stat[phase]]
        rel = abs(loss - want_loss) / abs(want_loss)
        ok, worst, norms, over = grads_gate(got[0]['grads'][i], want_grads,
                                            PARITY_PER_TENSOR[phase])
        same = loss == got[1]['stats'][stat[phase]]
        out['phases'][phase] = dict(loss=loss, reference_loss=want_loss,
                                    loss_rel=rel, grads_pass=ok,
                                    worst=worst, norms=norms, over=over,
                                    loss_same_on_ranks=same)
        log(f'phase 19 (b) {phase}: loss {loss:.7g} vs the halves\' mean '
            f'{want_loss:.7g} (relative {rel:.3g}, tolerance 1e-4; equal on '
            f'both ranks {same}); gradient worst max-abs / largest '
            f'{worst[0]:.3g} ({worst[1]}), global norm {norms[0]:.7g} vs '
            f'{norms[1]:.7g}; gate passed {ok}')
        if not (ok and rel <= 1e-4 and same):
            failed.append(phase)
    log(f'phase 19 (b): two gloo ranks on one card, 512^2, batch 2 a rank: '
        f'all-reduce ms {out["allreduce_ms"]} (rank 1 '
        f'{out["allreduce_ms_rank1"]}), run_phases ms a phase '
        f'{ {k: round(v, 2) for k, v in out["run_phases_ms"].items()} }'
        f'; G, D, G_ema bit-equal on both ranks after run_phases '
        f'{out["replicas_bit_equal"]}; peak GiB {out["peak_device_mem_gb"]}; '
        f'reference {ref_s:.1f} s, ranks {ranks_s:.1f} s; on {card}')
    if failed or not out['replicas_bit_equal']:
        raise RuntimeError(f'phase 19 (b): phases {failed} out of bounds, '
                           f'or the replicas differ')
    return out


def check_gpus_raise(files):
    """Phase 19 (c): ``train --gpus N`` for one card more than this machine
    shows raises, naming both counts."""
    from next3d_tpu_torch.cli import main as cli
    n = torch.cuda.device_count() + 1
    argv = ['train', '--outdir', os.path.join(files['root'], 'run_gpus'),
            '--data', files['data'], '--batch', '4', '--kimg', '0.004',
            '--topology-path', files['obj'], '--device', 'cuda', '--gpus',
            str(n)]
    try:
        cli.run(argv)
    except ValueError as e:
        message = str(e)
    else:
        raise RuntimeError(f'phase 19 (c): --gpus {n} did not raise')
    log(f'phase 19 (c): train --gpus {n} on {n - 1} visible card(s) '
        f'raises: {message}')
    if f'--gpus {n}' not in message or f'{n - 1} visible' not in message:
        raise RuntimeError('phase 19 (c): the error does not name the counts')
    return message


# phase 20 (a): EG3D's 512^2 forward on K4 against the same forward on K4's
# plain version on the card, in units of the output's largest magnitude
# (max(1, scale)): K4 and its plain version differ by float32 roundoff
# (within 1e-5 at phase 4), which the decoder, the importance draw and the
# SR convolutions carry through
EG3D_PLAIN_MAX_ABS = 2e-3
EG3D_PLAIN_MEAN_ABS = 1e-4
# phase 20 (d): the cross-section's sigma on K1 and K4 against their plain
# versions (K1 bit-equal, K4 within 1e-5), in units of max(1, scale)
CROSS_SECTION_MAX_ABS = 1e-4
# phase 20 (b): StyleGAN3-T at 256^2, the SG3SynthesisNetwork defaults
# (the StyleGAN3 repository's train.py --cfg=stylegan3-t)
SG3_T_256 = dict(z_dim=512, c_dim=0, w_dim=512, img_resolution=256,
                 img_channels=3, channel_base=32768, channel_max=512,
                 num_layers=14, margin_size=10, num_fp16_res=4)
# phase 20 (c): the equivariance metrics cut to this many samples at this
# batch (the registry's runs take 50,000 at batch 4)
EQ_SAMPLES, EQ_BATCH = 64, 8


class plain_kernels:
    """Route K1 and K4 to their plain versions on the card for the
    duration (the rasterizer's and the renderer's names of the wrappers)."""

    def __enter__(self):
        from next3d_tpu_torch.ops.raster import rasterize_binned_uv_plain
        from next3d_tpu_torch.ops.triplane import triplane_sample_plain
        from next3d_tpu_torch.render import rasterizer, renderer
        self.saved = [(rasterizer, 'rasterize_binned_uv',
                       rasterizer.rasterize_binned_uv),
                      (renderer, 'triplane_sample', renderer.triplane_sample)]
        rasterizer.rasterize_binned_uv = rasterize_binned_uv_plain
        renderer.triplane_sample = triplane_sample_plain
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def gaps(got, want):
    """max-abs and mean-abs of got - want, and want's largest magnitude."""
    d = (got.float() - want.float()).abs()
    return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                scale=float(want.abs().max()))


def check_eg3d(z, c, device, card, kernels):
    """Phase 20 (a): EG3DTriPlaneGenerator at the FFHQ 512^2 config (8XDC,
    48+48 samples, sr_num_fp16_res 4, fp32), random weights of SEED: K4's
    launches a forward, image / image_raw / image_depth against the same
    forward on K4's plain version (deterministic cuDNN), img/s at batch 1
    and 4, peak memory."""
    from next3d_tpu_torch.models.triplane_eg3d import EG3DTriPlaneGenerator

    t0 = time.time()
    E = build_seeded(EG3DTriPlaneGenerator, None).to(device)
    build_s = time.time() - t0

    def forward(n):
        return E(z[n], c[n], truncation_psi=0.7, truncation_cutoff=14,
                 noise_mode='const')

    torch.cuda.reset_peak_memory_stats(device)
    out, counts = counted(lambda: forward(1), kernels)
    check_outputs(out, 1)
    if counts['K4'] != 2 or counts['K1'] or counts['K4bf16']:
        raise RuntimeError(f'EG3D forward: K4 launched {counts["K4"]} times '
                           f'(2 expected), others {counts}')
    torch.backends.cudnn.deterministic = True
    out, counts4 = counted(lambda: forward(4), kernels)
    spread = gaps(forward(4)['image'], out['image'])['max_abs']
    with plain_kernels():
        plain, plain_counts = counted(lambda: forward(4), kernels)
    torch.backends.cudnn.deterministic = False
    if plain_counts['K4']:
        raise RuntimeError('the plain forward launched K4')
    check_outputs(out, 4)
    vs_plain = {k: gaps(out[k], plain[k]) for k in out}
    bad = [k for k, g in vs_plain.items()
           if not (g['max_abs'] <= EG3D_PLAIN_MAX_ABS * max(1, g['scale'])
                   and g['mean_abs'] <= EG3D_PLAIN_MEAN_ABS
                   * max(1, g['scale']))]
    rates = throughput('EG3D 512^2', forward, card)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    log(f'phase 20 (a) EG3D {sum(p.numel() for p in E.parameters())} '
        f'parameters, built in {build_s:.1f} s; K4 launches a forward at '
        f'batch 1 {counts["K4"]}, at batch 4 {counts4["K4"]}; against K4\'s '
        f'plain version at batch 4 (deterministic cuDNN, run-to-run max-abs '
        f'{spread:.3g}; bounds max-abs {EG3D_PLAIN_MAX_ABS} and mean-abs '
        f'{EG3D_PLAIN_MEAN_ABS} times max(1, scale)): '
        + '; '.join(f'{k} max-abs {g["max_abs"]:.3g} mean-abs '
                    f'{g["mean_abs"]:.3g} scale {g["scale"]:.3g}'
                    for k, g in vs_plain.items())
        + f'; peak device memory {peak:.2f} GiB; on {card}')
    if bad:
        raise RuntimeError(f'EG3D on K4 disagrees with its plain version: '
                           f'{bad}')
    return E, dict(images_per_second=rates, peak_device_mem_gb=peak,
                   k4_launches_a_forward=counts['K4'], vs_plain=vs_plain,
                   run_to_run_max_abs=spread, build_s=build_s)


def check_sg3(device, card):
    """Phase 20 (b): SG3Generator (StyleGAN3-T) at 256^2, fp32, random
    weights of SEED: finite (N, 3, 256, 256) images, img/s at batch 1 and
    4, peak memory, and the device ms of the forward's filtered_lrelu calls
    (each replayed alone on its own inputs) against the whole forward's.
    The FIR kernel's launches by instance over the first forward at each
    batch, its counters zeroed before: every call one launch of ``any``,
    and each 1-D filter's call counted in ``separable_one_launch``.
    Returns the generator and the phase's summary."""
    from next3d_tpu_torch.nn import stylegan3
    from next3d_tpu_torch.ops.upfirdn2d import upfirdn2d

    t0 = time.time()
    S = stylegan3.SG3Generator(**SG3_T_256,
                               generator=torch.Generator().manual_seed(SEED))
    S = S.to(device).eval()
    build_s = time.time() - t0
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    zs = {n: torch.randn(n, 512, generator=g, device=device) for n in (1, 4)}

    def forward(n):
        return S(zs[n])

    torch.cuda.reset_peak_memory_stats(device)
    upfirdn2d.launches_by_instance.clear()
    upfirdn2d.separable_one_launch = 0
    for n in (1, 4):
        img = forward(n)
        if tuple(img.shape) != (n, 3, 256, 256) or \
                not bool(torch.isfinite(img).all()):
            raise RuntimeError(f'SG3 batch {n}: shape {tuple(img.shape)} '
                               f'or non-finite')
    torch.cuda.synchronize()
    fir = dict(upfirdn2d.launches_by_instance,
               separable_one_launch=upfirdn2d.separable_one_launch)
    layers = [getattr(S.synthesis, name) for name in S.synthesis.layer_names]
    separable = sum(f is not None and f.ndim == 1 for layer in layers
                    for f in (layer.up_filter, layer.down_filter))
    if fir != {'any': 2 * 2 * len(layers),
               'separable_one_launch': 2 * separable}:
        raise RuntimeError(f'SG3-T forwards at batch 1 and 4: FIR launches '
                           f'{fir}, for {2 * len(layers)} calls, '
                           f'{separable} of them 1-D, a forward')
    rates = throughput('SG3-T 256^2', forward, card)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30

    calls = []
    flrelu = stylegan3.filtered_lrelu

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return flrelu(*args, **kwargs)

    stylegan3.filtered_lrelu = record
    try:
        forward(4)
    finally:
        stylegan3.filtered_lrelu = flrelu
    share = {}
    for n in (4,):
        whole = device_ms(lambda: forward(n), reps=5)
        part = device_ms(lambda: [flrelu(*a, **k) for a, k in calls], reps=5)
        share[n] = dict(forward_device_ms=whole,
                        filtered_lrelu_device_ms=part,
                        filtered_lrelu_calls=len(calls),
                        share=part / whole if whole > 0 else None)
    log(f'phase 20 (b) SG3-T 256^2: {sum(p.numel() for p in S.parameters())} '
        f'parameters, {len(S.synthesis.layer_names)} layers, built in '
        f'{build_s:.1f} s; peak device memory {peak:.2f} GiB; batch 4: '
        f'forward {share[4]["forward_device_ms"]:.3f} ms of device time, its '
        f'{len(calls)} filtered_lrelu calls alone '
        f'{share[4]["filtered_lrelu_device_ms"]:.3f} ms '
        f'({100 * share[4]["share"]:.1f}%); FIR launches over the batch-1 '
        f'and batch-4 forwards {fir}; on {card}')
    return S, dict(images_per_second=rates, peak_device_mem_gb=peak,
                   build_s=build_s, filtered_lrelu=share, fir_launches=fir)


def check_equivariance(S, device, card):
    """Phase 20 (c): eqt50k_int, eqt50k_frac and eqr50k through the port's
    metric registry on ``S``, cut to EQ_SAMPLES samples at batch EQ_BATCH:
    finite PSNRs (random weights), the identity transform restored."""
    from next3d_tpu_torch.metrics import equivariance, metric_main

    compute = equivariance.compute_equivariance_metrics

    def cut(opts, num_samples, batch_size, **flags):
        return compute(opts, num_samples=EQ_SAMPLES, batch_size=EQ_BATCH,
                       **flags)

    out = {}
    equivariance.compute_equivariance_metrics = cut
    try:
        for name in ('eqt50k_int', 'eqt50k_frac', 'eqr50k'):
            t0 = time.time()
            record = metric_main.calc_metric(name, generator=S,
                                             device=device)
            torch.cuda.synchronize()
            out[name] = dict(psnr_db=record['results'][name],
                             seconds=time.time() - t0)
    finally:
        equivariance.compute_equivariance_metrics = compute
    log(f'phase 20 (c) equivariance on SG3-T 256^2, {EQ_SAMPLES} samples at '
        f'batch {EQ_BATCH} (random weights): '
        + '; '.join(f'{k} {v["psnr_db"]:.3f} dB in {v["seconds"]:.2f} s'
                    for k, v in out.items()) + f'; on {card}')
    bad = [k for k, v in out.items() if not math.isfinite(v['psnr_db'])]
    if bad or not torch.equal(S.synthesis.input.transform,
                              torch.eye(3, device=device)):
        raise RuntimeError(f'equivariance: not finite {bad}, or the '
                           f'transform was not restored')
    return out


def check_cross_section(G, z, c, v, card, kernels):
    """Phase 20 (d): sample_cross_section at 256^2 on the flagship, batch
    1: its ms, K1's and K4's launches, sigma against the same call on the
    plain K1 and K4."""
    from next3d_tpu_torch.render.crosssection import sample_cross_section

    ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)

    def section():
        return sample_cross_section(G, ws, v, resolution=256)

    sigma, counts = counted(section, kernels)
    with plain_kernels():
        plain, plain_counts = counted(section, kernels)
    if plain_counts['K1'] or plain_counts['K4']:
        raise RuntimeError('the plain cross-section launched a kernel')
    ms = median_ms(section)
    g = gaps(sigma, plain)
    log(f'phase 20 (d) cross-section 256^2 on the flagship, batch 1: '
        f'{ms:.3f} ms (median of 5); launches {counts}; sigma vs the plain '
        f'K1 and K4: max-abs {g["max_abs"]:.3g} (bound '
        f'{CROSS_SECTION_MAX_ABS} x max(1, {g["scale"]:.3g})), mean-abs '
        f'{g["mean_abs"]:.3g}; on {card}')
    if tuple(sigma.shape) != (256, 256) or not bool(
            torch.isfinite(sigma).all()) or counts['K1'] <= 0 \
            or counts['K4'] <= 0 or not g['max_abs'] <= \
            CROSS_SECTION_MAX_ABS * max(1, g['scale']):
        raise RuntimeError('the cross-section failed')
    return dict(ms=ms, launches={k: counts[k] for k in ('K1', 'K4')},
                vs_plain=g)


def check_train_256(files, mesh, device, card, kernels):
    """Phase 20 (e): ``train --resolution 256`` (SuperresolutionHybrid4X)
    on phase 13's dataset resized to 256^2 (2x2 means), 2 batches of 4,
    through train_run."""
    import numpy as np
    from next3d_tpu_torch.utils.synthetic_head import save_dataset

    images = [np.asarray(im, np.float32).reshape(256, 2, 256, 2, 3)
              .mean(axis=(1, 3)).round().astype(np.uint8)
              for im in files['images']]
    data = save_dataset(os.path.join(files['root'], 'data256'), images,
                        files['v'].cpu().numpy(), files['labels'], mesh)
    argv = ['train', '--outdir', os.path.join(files['root'], 'run256'),
            '--data', data, '--batch', '4', '--kimg', '0.008', '--tick',
            '0.004', '--snap', '100', '--resolution', '256',
            '--topology-path', files['obj'], '--device', str(device),
            '--timing-every', '1']
    summary, result = train_run(
        'phase 20 (e) train --resolution 256 (SR 4X), 2 batches of 4',
        argv, kernels, card, expect=('K1', 'K4', 'K4b'))
    sr = type(result['G'].superresolution).__name__
    if sr != 'SuperresolutionHybrid4X' or result['cur_nimg'] != 8:
        raise RuntimeError(f'train --resolution 256: SR {sr}, cur_nimg '
                           f'{result["cur_nimg"]}')
    del result
    return summary


def check_model_families(G, files, mesh, inputs, device, card, kernels):
    """Phase 20: the EG3D and StyleGAN3 families, the cross-section and
    ``train --resolution 256`` (check_eg3d, check_sg3, check_equivariance,
    check_cross_section, check_train_256). Returns the phase's K1, K4 and
    K4 backward launches by path, its summary and the EG3D generator."""
    z, c, v = inputs
    t0 = time.time()
    out = dict(card=card)
    with torch.no_grad():
        E, out['eg3d'] = check_eg3d(z, c, device, card, kernels)
        torch.cuda.empty_cache()
        S, out['sg3_t'] = check_sg3(device, card)
        out['equivariance'] = check_equivariance(S, device, card)
        del S
        torch.cuda.empty_cache()
        out['cross_section'] = check_cross_section(G, z[1], c[1], v[1], card,
                                                   kernels)
    out['train_256'] = check_train_256(files, mesh, device, card, kernels)
    out['wall_s'] = time.time() - t0
    launches = {
        'K1': {'cross_section': out['cross_section']['launches']['K1'],
               'train --resolution 256':
                   out['train_256']['launches']['K1']},
        'K4': {'eg3d forward': out['eg3d']['k4_launches_a_forward'],
               'cross_section': out['cross_section']['launches']['K4'],
               'train --resolution 256':
                   out['train_256']['launches']['K4']},
        'K4b': {'train --resolution 256':
                    out['train_256']['launches']['K4b']},
        'FIR': {'sg3_t forwards at batch 1 and 4':
                    out['sg3_t']['fir_launches']}}
    log(f'phase 20: {out["wall_s"]:.1f} s')
    return launches, out, E

# phase 21: the face chunk of __graft_entry__.py's configs for the scatter
# golden, the tile steps of 'tiled' timed on the card (neither changes a
# result), and the plane resolutions at which the selection falls back
SCATTER_FACE_CHUNK = 9976
TILE_CHUNKS = (32, 256)
FALLBACK_RESOLUTIONS = (1024, 96)


def _same(got, want):
    """Elements of pix_to_face and zbuf that differ between two results."""
    return tuple(int((a.cpu() != b.cpu()).sum()) for a, b in zip(got, want))


def check_rasterizer_alone(G, mesh, lms, device, card):
    """Phase 21 (a): 'tiled' and 'scatter' (render/rasterizer.py, plain
    torch) on phase 3's input, the head's 4 views of 4 jittered
    expressions (16 images) at 256^2, on CUDA tensors against the same
    functions on CPU tensors (bit for bit), each against K2's pix_to_face,
    timed (CUDA events and profiler device time) beside K2's wrapper."""
    from next3d_tpu_torch.ops import raster
    from next3d_tpu_torch.render import rasterizer

    res = G.uv_resolution
    with torch.no_grad():
        tv, _ = G.project_views(*G._split_v(head_batch(mesh, lms, 4,
                                                       device)))
    faces = G.faces
    k2 = raster.rasterize_binned(tv, faces, res)
    out = dict(images=tv.shape[0], size=res, k2=dict(
        ms=time_ms(lambda: raster.rasterize_binned(tv, faces, res)),
        device_ms=device_ms(lambda: raster.rasterize_binned(tv, faces,
                                                            res))))
    runs = {f'tiled tile_chunk {tc}': lambda v, f, tc=tc:
            rasterizer.rasterize_mesh_tiled(v, f, res, tile_chunk=tc)
            for tc in TILE_CHUNKS}
    runs[f'scatter face_chunk {SCATTER_FACE_CHUNK}'] = lambda v, f: \
        rasterizer.rasterize_mesh(v, f, res, face_chunk=SCATTER_FACE_CHUNK)
    first = None
    for name, fn in runs.items():
        got = fn(tv, faces)
        t0 = time.perf_counter()
        cpu = fn(tv.cpu(), faces.cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        differ = _same(got, cpu)
        first = got if first is None else first
        entry = dict(
            card_vs_cpu_differ=differ, vs_k2_pix_to_face_differ=_same(
                got, k2)[0], vs_tiled_differ=_same(got, first),
            covered=int((got[0] >= 0).sum()),
            ms=time_ms(lambda: fn(tv, faces), reps=5, warmup=1),
            device_ms=device_ms(lambda: fn(tv, faces), reps=3),
            cpu_ms=cpu_ms)
        out[name] = entry
        log(f'phase 21 (a) {name}, {tv.shape[0]} images at {res}^2: card '
            f'vs CPU, (pix_to_face, zbuf) elements that differ {differ}; '
            f'pixels whose face differs from K2\'s '
            f'{entry["vs_k2_pix_to_face_differ"]} of {k2[0].numel()}, '
            f'from the first tile step\'s {entry["vs_tiled_differ"]}; '
            f'{entry["ms"]:.3f} ms (device {entry["device_ms"]:.3f} ms; '
            f'CPU {cpu_ms:.1f} ms) against K2 {out["k2"]["ms"]:.3f} ms '
            f'(device {out["k2"]["device_ms"]:.4f} ms); on {card}')
        # the tile step changes no result; 'scatter' may pick the other
        # face at a float32 tie, and its zbuf rounds in another form
        if differ != (0, 0) or (name.startswith('tiled')
                                and entry['vs_tiled_differ'] != (0, 0)):
            raise RuntimeError(f'{name}: the card and the CPU disagree, or '
                               f'the tile step changed the result')
    return out


def check_impl_forwards(G, build, inputs, device, card, kernels):
    """Phase 21 (b): the flagship and the texture variant built with
    rasterizer_impl 'tiled' and 'scatter' on the default models' weights:
    a forward at batch 1 and 4, finite, launching no binned kernel and K4
    twice a forward; img/s and peak memory; the image's gap to the
    default forward at batch 4 under deterministic cuDNN (beside the
    default forward's own run-to-run spread) and the pixels whose face
    differs from the default rasterizer's (K1, or K2 for the texture
    variant) on the same projected views."""
    from next3d_tpu_torch.models.triplane_texture import \
        TriPlaneTextureGenerator
    from next3d_tpu_torch.ops import raster
    from next3d_tpu_torch.render import rasterizer

    z, c, v = inputs
    T = build(TriPlaneTextureGenerator)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, base, flame_only in (('flagship', G, False),
                                       ('texture variant', T, True)):
            def forward_of(model):
                def forward(n):
                    vn = v[n][:, :5023] if flame_only else v[n]
                    return model(z[n], c[n], vn, truncation_psi=0.7,
                                 truncation_cutoff=14, noise_mode='const')
                return forward
            ref = forward_of(base)(4)
            spread = max(float((forward_of(base)(4)[k] - ref[k]).abs().max())
                         for k in ref)
            verts = v[4][:, :5023]
            res = base.uv_resolution
            if flame_only:
                tv = base.project_orth(verts)
                pf_default = raster.rasterize_binned(tv, base.faces, res)[0]
            else:
                tv, _ = base.project_views(verts, v[4][:, 5023:])
                pf_default = raster.rasterize_binned_uv(
                    tv, base.faces, base.face_uv[None], res)[0]
            for impl in ('tiled', 'scatter'):
                Gi = build(type(base), rasterizer_impl=impl)
                Gi.load_state_dict(base.state_dict())
                if Gi.rasterizer_impl != impl:
                    raise RuntimeError(f'{impl} became {Gi.rasterizer_impl}')
                forward = forward_of(Gi)
                outs, counts = counted(lambda: {n: forward(n)
                                                for n in (1, 4)}, kernels)
                for n, o in outs.items():
                    check_outputs(o, n)
                if counts['K1'] or counts['K2'] or counts['K3'] \
                        or counts['K5'] or counts['K4'] != 4:
                    raise RuntimeError(f'{name} {impl}: launches {counts}')
                fn = rasterizer.rasterize_mesh_tiled if impl == 'tiled' \
                    else rasterizer.rasterize_mesh
                pf = fn(tv, base.faces, res)[0]
                gap = {k: float((outs[4][k] - ref[k]).abs().max())
                       for k in ('image', 'image_raw')}
                torch.backends.cudnn.deterministic = False
                torch.cuda.reset_peak_memory_stats(device)
                rates = throughput(f'{name} {impl!r}', forward, card)
                peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
                torch.backends.cudnn.deterministic = True
                entry = dict(img_s=rates, peak_device_mem_gb=peak,
                             launches=counts, max_abs_vs_default=gap,
                             default_spread=spread,
                             pix_to_face_differ=int((pf != pf_default).sum()),
                             pixels=pf.numel())
                out[f'{name} {impl}'] = entry
                log(f'phase 21 (b) {name} rasterizer_impl={impl!r}: launches '
                    f'{counts} at batch 1 and 4; image / image_raw max-abs vs '
                    f'the default {gap["image"]:.3g} / '
                    f'{gap["image_raw"]:.3g} (default run-to-run {spread:.3g}'
                    f'); {entry["pix_to_face_differ"]} of {pf.numel()} '
                    f'pixels whose face differs from the default '
                    f'rasterizer\'s; peak device memory {peak:.2f} GiB; on '
                    f'{card}')
                del Gi, outs
    finally:
        torch.backends.cudnn.deterministic = False
    del T
    return out


def check_fallback(G, build, inputs, mesh, device, card, kernels):
    """Phase 21 (c): the JAX package's selection at the plane resolutions
    where the binned kernels' limits bind. At 1024 both generators built
    with 'auto' fall back to 'tiled' (the largest face spans 27.4 px,
    above 80% of a 32-px tile) with the capacity JAX's rule gives, and the
    texture variant runs one forward at batch 1 (the flagship's StyleUNets
    take no planes above 256^2, in either package); at 96 (a 32-px tile's
    segments would exceed the JAX kernel's window) no generator can be
    built, since the StyleGAN2 backbones of both packages take powers of
    two, so the selection runs alone on the flagship's views and faces."""
    import types

    import numpy as np
    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
    from next3d_tpu_torch.models.triplane_texture import \
        TriPlaneTextureGenerator
    from next3d_tpu_torch.render.rasterizer import required_tile_capacity

    z, c, v = inputs
    out = {}
    v_flip = np.asarray(mesh.verts, np.float32) * np.asarray([1., -1., 1.])
    tv = v_flip @ G.view_tforms.cpu().numpy().transpose(0, 2, 1)
    tv = (tv + np.asarray([0.0, -0.01, -0.01])) * 5.0
    tv = tv * np.asarray([1., -1., -1.]) + np.asarray([0., 0., 10.])
    faces = G.faces.cpu().numpy()
    for res in FALLBACK_RESOLUTIONS:
        expect = ('tiled', max(448, -(-required_tile_capacity(
            tv, faces, res, 8) // 4)))
        if res & (res - 1):
            ns = types.SimpleNamespace(
                view_tforms=G.view_tforms.cpu(), faces=G.faces.cpu(),
                uv_resolution=res, rasterizer_impl='auto',
                rasterizer_tile_capacity=448, rasterizer_patch=32)
            TriPlaneGenerator._validate_rasterizer_capacity(ns, mesh.verts)
            got = {'selection alone': (ns.rasterizer_impl,
                                       ns.rasterizer_tile_capacity)}
            out[res] = dict(selection=got, expected=expect)
            log(f'phase 21 (c) at {res}^2 planes: \'auto\' selects {got} '
                f'(the backbones take powers of two)')
        else:
            got = {}
            for cls in (TriPlaneGenerator, TriPlaneTextureGenerator):
                Gi = build(cls, plane_resolution=res)
                got[cls.__name__] = (Gi.rasterizer_impl,
                                     Gi.rasterizer_tile_capacity)
            # Gi: the texture variant
            torch.cuda.reset_peak_memory_stats(device)
            with torch.no_grad():
                def forward():
                    return Gi(z[1], c[1], v[1][:, :5023], truncation_psi=0.7,
                              truncation_cutoff=14, noise_mode='const')
                o, counts = counted(forward, kernels)
                check_outputs(o, 1)
                ms = median_ms(forward, reps=3)
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            out[res] = dict(selection=got, expected=expect,
                            texture_img_s=1e3 / ms, texture_forward_ms=ms,
                            peak_device_mem_gb=peak, launches=counts)
            log(f'phase 21 (c) at {res}^2 planes: \'auto\' selects {got}; '
                f'the texture variant\'s batch-1 forward finite, {ms:.1f} ms '
                f'({1e3 / ms:.3f} img/s), peak device memory {peak:.2f} GiB, '
                f'launches {counts}; on {card}')
            del Gi, o
            if counts['K2'] or counts['K4'] != 2:
                raise RuntimeError(f'the {res}^2 fallback launched {counts}')
        if any(x != expect for x in got.values()):
            raise RuntimeError(f'at {res}^2 \'auto\' selected {got}, not '
                               f'{expect}')
    return out


def check_rasterizer_selection(G, build, mesh, lms, inputs, device, card,
                               kernels):
    """Phase 21: the 'tiled' and 'scatter' rasterizers and the selection
    (check_rasterizer_alone, check_impl_forwards, check_fallback)."""
    t0 = time.time()
    out = dict(card=card)
    with torch.no_grad():
        out['alone'] = check_rasterizer_alone(G, mesh, lms, device, card)
        out['forwards'] = check_impl_forwards(G, build, inputs, device, card,
                                              kernels)
    torch.cuda.empty_cache()
    out['fallback'] = check_fallback(G, build, inputs, mesh, device, card,
                                     kernels)
    out['wall_s'] = time.time() - t0
    log(f'phase 21: {out["wall_s"]:.1f} s')
    return out


# phase 22: the full-scale gate, the card against the port on the CPU.
# fp32 (max-abs, mean-abs): the North star's gate on image and image_raw,
# docs/full_scale_parity_report.json's on image_depth. bf16 (max-abs, least
# PSNR in dB): tools/full_scale_parity.py's bf16 row, logged with its
# verdict; what the run holds the card's bf16 to is its gap to the CPU's
# fp32 against the CPU's own bf16 gap, at most FULL_SCALE_BF16_REL times
# it in max-abs and mean-abs (tests/test_torch_train_bf16.py's multiple of
# JAX's own bf16 gap): JAX's bf16 forward exceeds the absolute bounds at
# this configuration too (tests/test_torch_full_scale.py case 5)
FULL_SCALE_FP32 = {'image': (2e-3, 1e-4), 'image_raw': (2e-3, 1e-4),
                   'image_depth': (4e-3, 2e-4)}
FULL_SCALE_BF16 = {'image': (0.08, 40.0), 'image_raw': (0.04, 45.0)}
FULL_SCALE_BF16_REL = 1.5


def build_seeded(cls, mesh, **kw):
    """``cls`` at G_KWARGS with the weights of torch.Generator seed SEED,
    on the CPU (EG3D takes no mesh)."""
    if mesh is not None:
        kw['topology_path'] = mesh
    return cls(**G_KWARGS, generator=torch.Generator().manual_seed(SEED),
               **kw).eval()


def full_scale_inputs(mesh, lms):
    """tests/test_torch_full_scale.py's inputs on the CPU: z (2, 512) and
    the jitter of the second expression from numpy seed 0, the FFHQ camera,
    v (2, 5091, 3) the head and that expression."""
    import numpy as np
    rs = np.random.RandomState(0)
    z = rs.randn(2, 512).astype(np.float32)
    v = np.concatenate([mesh.verts, lms])[None].astype(np.float32)
    jitter = rs.randn(*v.shape[1:]).astype(np.float32) * 0.002
    v = np.concatenate([v, v + jitter])
    return (torch.from_numpy(z), ffhq_camera(2, torch.device('cpu')),
            torch.from_numpy(v))


class seen_rasterizers:
    """Keep the pix_to_face of every K1 and K2 call the models make for
    the duration, on the CPU (the rasterizer's names of the wrappers,
    whose launch counters go on counting)."""

    def __enter__(self):
        from next3d_tpu_torch.render import rasterizer
        self.saved = [(name, getattr(rasterizer, name))
                      for name in ('rasterize_binned_uv', 'rasterize_binned')]
        self.pix_to_face = []

        def keep(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.pix_to_face.append(out[0].cpu())
                return out
            return wrapper
        for name, fn in self.saved:
            setattr(rasterizer, name, keep(fn))
        return self

    def __exit__(self, *exc):
        from next3d_tpu_torch.render import rasterizer
        for name, fn in self.saved:
            setattr(rasterizer, name, fn)


def full_scale_gaps(got, want, keys):
    """Per output: max-abs, mean-abs, the 99.9% quantile of the absolute
    gap and PSNR over [-1, 1] of got (any device) against want (CPU)."""
    out = {}
    for key in keys:
        d = (got[key].float().cpu() - want[key].float()).abs()
        out[key] = dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                        q999=float(torch.quantile(d.flatten().double(),
                                                  0.999)),
                        psnr=psnr(got[key].cpu(), want[key]))
    return out


def full_scale_pair(name, card_model, cpu_model, inputs, device, kernels,
                    expect):
    """One generator's forward at batch 2 on the card and on the CPU: the
    outputs, each side's launches (``expect``: a count each named kernel
    must reach on the card; the CPU launches none) and pix_to_face, and
    seconds."""
    def forward(model, dev):
        def run():
            with seen_rasterizers() as seen:
                out = model(*(x.to(dev) for x in inputs), truncation_psi=0.7,
                            truncation_cutoff=14, noise_mode='const')
            return out, seen.pix_to_face
        t0 = time.time()
        (out, pix), counts = counted(run, kernels)
        return out, pix, counts, time.time() - t0

    got, pix_card, card_counts, card_s = forward(card_model, device)
    want, pix_cpu, cpu_counts, cpu_s = forward(cpu_model, torch.device('cpu'))
    short = {k: n for k, n in expect.items() if card_counts[k] < n}
    if short or any(cpu_counts.values()):
        raise RuntimeError(f'phase 22 {name}: card launches {card_counts} '
                           f'(at least {expect} expected), CPU launches '
                           f'{cpu_counts} (none expected)')
    if len(pix_card) != len(pix_cpu):
        raise RuntimeError(f'phase 22 {name}: {len(pix_card)} rasterizer '
                           f'calls on the card, {len(pix_cpu)} on the CPU')
    apart = sum(int((a != b).sum()) for a, b in zip(pix_card, pix_cpu))
    return dict(got=got, want=want, card_launches=card_counts,
                cpu_launches=cpu_counts, card_s=card_s, cpu_s=cpu_s,
                pixels_apart=apart,
                pixels=sum(p.numel() for p in pix_cpu))


def check_full_scale(models, mesh, lms, device, card, kernels):
    """Phase 22: the forward at the FFHQ 512^2 operating point on the card
    against the port's forward on the CPU on the same weights and inputs
    (full_scale_inputs, batch 2): ``models`` maps 'flagship', 'texture
    variant', 'EG3D' to phase 6's, 9's and 20's generators on the card.
    Each gets a CPU twin built from the same seed, whose state_dict must
    equal the card model's. fp32 (TF32 off, deterministic cuDNN): image,
    image_raw, image_depth within FULL_SCALE_FP32; the rasterizers' faces
    on every pixel equal (K1 for the flagship, K2 for the texture
    variant); on the card K1 >= 1 and K4 >= 2 launches (flagship), K2 >= 1
    and K4 >= 2 (texture variant), K4 >= 2 (EG3D), on the CPU none. bf16:
    the flagship with force_fp32=False on the card and on the CPU, each
    against the CPU's fp32 forward (FULL_SCALE_BF16, FULL_SCALE_BF16_REL).
    Returns the phase's summary."""
    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator

    t0 = time.time()
    z, c, v = full_scale_inputs(mesh, lms)
    cases = {'flagship': ((z, c, v), dict(K1=1, K4=2), mesh),
             'texture variant': ((z, c, v[:, :5023]), dict(K2=1, K4=2),
                                 mesh),
             'EG3D': ((z, c), dict(K4=2), None)}
    out = dict(card=card)
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            for name, (inputs, expect, head) in cases.items():
                model = models[name]
                t1 = time.time()
                twin = build_seeded(type(model), head)
                build_s = time.time() - t1
                state = model.state_dict()
                differ = [k for k, x in twin.state_dict().items()
                          if not torch.equal(x, state[k].cpu())]
                if differ or set(state) != set(twin.state_dict()):
                    raise RuntimeError(f'phase 22 {name}: the CPU twin\'s '
                                       f'state differs at {differ[:5]}')
                r = full_scale_pair(name, model, twin, inputs, device,
                                    kernels, expect)
                gaps = full_scale_gaps(r['got'], r['want'], FULL_SCALE_FP32)
                bad = [k for k, (max_abs, mean_abs) in FULL_SCALE_FP32.items()
                       if not (gaps[k]['max_abs'] <= max_abs
                               and gaps[k]['mean_abs'] <= mean_abs)]
                if name == 'flagship':
                    fp32_cpu = r['want']
                    cpu_twin = twin
                del twin
                out[name] = dict(
                    gaps=gaps, pixels_apart=r['pixels_apart'],
                    pixels=r['pixels'], card_launches=r['card_launches'],
                    cpu_launches=r['cpu_launches'], card_s=r['card_s'],
                    cpu_s=r['cpu_s'], cpu_build_s=build_s)
                log(f'phase 22 {name} fp32, batch 2, card vs CPU: '
                    + '; '.join(f'{k} max-abs {g["max_abs"]:.3g} mean-abs '
                                f'{g["mean_abs"]:.3g} q999 {g["q999"]:.3g} '
                                f'(bound {FULL_SCALE_FP32[k]})'
                                for k, g in gaps.items())
                    + f'; {r["pixels_apart"]} of {r["pixels"]} rasterized '
                    f'pixels apart; launches card {r["card_launches"]}, CPU '
                    f'{r["cpu_launches"]}; card {r["card_s"]:.2f} s, CPU '
                    f'{r["cpu_s"]:.2f} s (twin built in {build_s:.1f} s); on '
                    f'{card}')
                if bad:
                    raise RuntimeError(f'phase 22 {name}: {bad} beyond the '
                                       f'fp32 gate')
                if name == 'flagship' and r['pixels_apart']:
                    raise RuntimeError('phase 22: K1 on the card and on the '
                                       'CPU disagree')
                del r

            t1 = time.time()
            bf16 = {}
            for side, dev in (('card', device), ('cpu', torch.device('cpu'))):
                Gbf = build_seeded(TriPlaneGenerator, mesh, force_fp32=False)
                Gbf.load_state_dict(cpu_twin.state_dict())
                Gbf = Gbf.to(dev)
                t2 = time.time()
                got, counts = counted(lambda: Gbf(
                    *(x.to(dev) for x in (z, c, v)), truncation_psi=0.7,
                    truncation_cutoff=14, noise_mode='const'), kernels)
                bf16[side] = dict(gaps=full_scale_gaps(got, fp32_cpu,
                                                       FULL_SCALE_BF16),
                                  launches=counts, s=time.time() - t2)
                del Gbf, got
            del cpu_twin
            card_gaps, cpu_gaps = bf16['card']['gaps'], bf16['cpu']['gaps']
            within = {k: card_gaps[k]['max_abs'] <= max_abs
                      and card_gaps[k]['psnr'] >= min_psnr
                      for k, (max_abs, min_psnr) in FULL_SCALE_BF16.items()}
            bad = [k for k in FULL_SCALE_BF16 for stat in ('max_abs',
                                                            'mean_abs')
                   if not card_gaps[k][stat]
                   <= FULL_SCALE_BF16_REL * cpu_gaps[k][stat]]
            out['flagship bf16'] = dict(bf16, within_bounds=within,
                                        wall_s=time.time() - t1)
            log('phase 22 flagship bf16, batch 2, against the CPU\'s fp32: '
                + '; '.join(f'{k} card max-abs {card_gaps[k]["max_abs"]:.3g}'
                            f' mean-abs {card_gaps[k]["mean_abs"]:.3g} PSNR '
                            f'{card_gaps[k]["psnr"]:.2f} dB ('
                            f'{"within" if within[k] else "beyond"} '
                            f'{FULL_SCALE_BF16[k]}), CPU bf16 max-abs '
                            f'{cpu_gaps[k]["max_abs"]:.3g} mean-abs '
                            f'{cpu_gaps[k]["mean_abs"]:.3g} PSNR '
                            f'{cpu_gaps[k]["psnr"]:.2f} dB'
                            for k in FULL_SCALE_BF16)
                + f'; launches card {bf16["card"]["launches"]}, CPU '
                f'{bf16["cpu"]["launches"]}; card {bf16["card"]["s"]:.2f} s,'
                f' CPU {bf16["cpu"]["s"]:.2f} s; on {card}')
            if bad or bf16['card']['launches']['K4bf16'] < 2 \
                    or any(bf16['cpu']['launches'].values()):
                raise RuntimeError(f'phase 22 flagship bf16: {bad} more than '
                                   f'{FULL_SCALE_BF16_REL}x the CPU bf16\'s '
                                   f'gap, or launches {bf16}')
    finally:
        torch.backends.cudnn.deterministic = False
    out['wall_s'] = time.time() - t0
    log(f'phase 22: {out["wall_s"]:.1f} s')
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='add phase 11, the per-stage profile')
    parser.add_argument('--parent', metavar='DIR',
                        help='another checkout (the parent commit) whose K4 '
                        'backward phase 13 times beside this one')
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    wall = {}
    started = [T_START]

    def finished(phase):
        """Log and keep the seconds since the last phase ended."""
        now = time.time()
        wall[phase] = round(now - started[-1], 1)
        started.append(now)
        log(f'phases {phase}: {wall[phase]} s')

    card = card_line()
    log(f'card: {card}')
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    # fp32 parity mode: the JAX package runs float32 at Precision.HIGHEST;
    # cuDNN convolutions would otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
    from next3d_tpu_torch.models.triplane_texture import \
        TriPlaneTextureGenerator
    from next3d_tpu_torch.ops import (cuda_build, dma_gather, raster,
                                      raster_zbuffer, triplane)
    from next3d_tpu_torch.ops.upfirdn2d import upfirdn2d

    t0 = time.time()
    for so in cuda_build.build_all(LIBRARIES):
        log(f'built {so.name}; nvcc says:\n'
            + so.with_suffix('.log').read_text().strip())
    parent = parent_backward(opts.parent) if opts.parent else None
    log(f'kernel build {time.time() - t0:.1f} s')
    finished('1-2')

    mesh, lms = load_head()
    head_lms = lms   # phase 10 rebinds lms to the batch's landmarks

    def build(cls, **kw):
        t0 = time.time()
        G = build_seeded(cls, mesh, **kw).to(device)
        log(f'{cls.__name__} {kw}: '
            f'{sum(p.numel() for p in G.parameters())} parameters, built in '
            f'{time.time() - t0:.1f} s')
        return G

    G = build(TriPlaneGenerator)
    kernels = {'K1': raster.rasterize_binned_uv,
               'K2': raster.rasterize_binned,
               'K3': raster.rasterize_binned_uv16,
               'K4': triplane.triplane_sample,
               'K4bf16': LaunchCount(triplane.triplane_sample,
                                     'launches_bf16'),
               'K4b': triplane.triplane_sample_backward,
               'K5': raster_zbuffer.rasterize_zbuffer,
               'K6': dma_gather.gather_row_blocks,
               'FIR': upfirdn2d}
    launches = {}

    with torch.no_grad():
        g = torch.Generator(device=device).manual_seed(SEED)
        z = {n: torch.randn(n, 512, generator=g, device=device)
             for n in (1, 4)}
        c = {n: ffhq_camera(n, device) for n in (1, 4)}
        v = {n: head_batch(mesh, lms, n, device) for n in (1, 4)}

        def forward_of(model, flame_only=False):
            def forward(n):
                vn = v[n][:, :5023] if flame_only else v[n]
                return model(z[n], c[n], vn, truncation_psi=0.7,
                             truncation_cutoff=14, noise_mode='const')
            return forward

        forward = forward_of(G)
        stats = check_rasterizers(G, head_batch(mesh, lms, 4, device))
        check_adversarial(device)
        check_zbuffer_cases(device)
        stats['K4'] = check_k4(device)
        stats['K6'], launches['K6'] = check_k6(device)
        stats['FIR'] = check_fir(device)
        finished('3-5')
        outs, counts = counted(lambda: {n: forward(n) for n in (1, 4)},
                               kernels)
        for n, out in outs.items():
            check_outputs(out, n)
        log(f'512^2 forward at batch 1 and 4: finite, depth in the sample '
            f'range; launches {counts}')
        launches.update(K1=counts['K1'], K4=counts['K4'], FIR=counts['FIR'])
        if min(launches.values()) <= 0:
            raise RuntimeError('a kernel of the main path never launched')
        fine = fine_points(lambda: forward(4))
        stats['K4b'] = check_k4_backward(device, fine, parent)

        ws = G.mapping(z[1], c[1], truncation_psi=0.7, truncation_cutoff=14)
        textures, static = G.build_identity(ws, noise_mode='const')
        frames = head_batch(mesh, lms, 3, device, jitter=0.003)
        for f in range(3):
            out = G.synthesis_from_identity(ws, textures, static, c[1],
                                            frames[f:f + 1],
                                            noise_mode='const')
            check_outputs(out, 1)
            if f == 0:
                err = max(float((out[k] - outs[1][k]).abs().max())
                          for k in out)
                log(f'synthesis_from_identity frame 0 vs synthesis: '
                    f'max-abs {err:.3g}')
                if not err <= 1e-4:
                    raise RuntimeError('identity-cached synthesis disagrees')

        throughput('flagship', forward, card)
        if opts.profile:
            for n in (1, 4):
                profile_stages('flagship', flagship_stages(
                    G, lambda: forward(n), z[n], c[n], v[n]),
                    lambda: forward(n), n)

        T = build(TriPlaneTextureGenerator)
        forward_t = forward_of(T, flame_only=True)
        outs_t, counts = counted(lambda: {n: forward_t(n) for n in (1, 4)},
                                 kernels)
        for n, out in outs_t.items():
            check_outputs(out, n)
        log(f'texture variant 512^2 forward at batch 1 and 4: finite, depth '
            f'in the sample range; launches {counts}')
        launches['K2'] = counts['K2']
        if counts['K2'] <= 0 or counts['FIR'] <= 0:
            raise RuntimeError(f'the texture variant never launched K2 or '
                               f'the FIR ({counts})')
        throughput('texture variant', forward_t, card)
        if opts.profile:
            for n in (1, 4):
                profile_stages('texture variant', texture_stages(
                    T, lambda: forward_t(n), z[n], c[n], v[n][:, :5023]),
                    lambda: forward_t(n), n)
        models = {'flagship': G, 'texture variant': T}
        fp32_outs = {'flagship': outs, 'texture variant': outs_t}

        # the default forward is not bit-reproducible on the card (cuDNN's
        # transposed convolutions may accumulate with atomics), so this
        # phase compares under cuDNN's deterministic algorithms, with the
        # default forward's own run-to-run spread beside it
        torch.backends.cudnn.deterministic = True
        ref = forward(4)
        spread = max(float((forward(4)[k] - ref[k]).abs().max()) for k in ref)
        verts, lms = G._split_v(v[4])
        tex4, _ = G.build_identity(G.mapping(
            z[4], c[4], truncation_psi=0.7, truncation_cutoff=14),
            noise_mode='const')
        ref_raster = G.rasterize(verts, lms, tex4)
        log(f'default forward at batch 4, deterministic cuDNN: run-to-run '
            f'max-abs {spread:.3g}')
        for impl, name in (('pallas_binned16', 'K3'), ('pallas', 'K5')):
            Gi = build(TriPlaneGenerator, rasterizer_impl=impl)
            Gi.load_state_dict(G.state_dict())
            out, counts = counted(lambda: forward_of(Gi)(4), kernels)
            launches[name] = counts[name]
            check_outputs(out, 4)
            diff = (out['image'] - ref['image']).abs()
            log(f"flagship rasterizer_impl='{impl}' at batch 4: launches "
                f"{counts}; image vs the default: max-abs "
                f"{float(diff.max()):.3g}, mean-abs {float(diff.mean()):.3g}")
            if counts[name] <= 0:
                raise RuntimeError(f'{impl} never launched {name}')
            if impl == 'pallas_binned16':
                # the stage the impl changes is bit-equal, and so is the
                # forward wherever the default forward reproduces itself
                images, alphas, _ = Gi.rasterize(verts, lms, tex4)
                same = all(torch.equal(a, b) for a, b in zip(
                    images + alphas, ref_raster[0] + ref_raster[1]))
                bit_equal = all(torch.equal(out[k], ref[k]) for k in out)
                log(f'pallas_binned16: rasterize stage bit-equal {same}, '
                    f'forward bit-equal {bit_equal}')
                if not same or not (bit_equal or spread > 0):
                    raise RuntimeError('pallas_binned16 changed the forward')
            elif not float(diff.mean()) <= 1e-4:
                raise RuntimeError('pallas moved the image too far')
            del Gi
        torch.backends.cudnn.deterministic = False
        finished('6-11')

        cli_launches, cli_reenact_fps = check_clis(
            G, G_KWARGS, mesh, head_lms, device, card, kernels, ref, spread,
            (z[4], c[4], v[4]))
        finished('12')

    train_tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    try:
        files = write_train_data(G, mesh, head_lms, device, train_tmp)
        train_launches, train = check_training(files, device, card, kernels,
                                               profile=opts.profile)
        launches['K4b'] = train_launches['K4b']
        finished('13')

        with torch.no_grad():
            # bench.py's default batch, for phase 14's flagship
            z[8] = torch.randn(8, 512, generator=g, device=device)
            c[8] = ffhq_camera(8, device)
            v[8] = head_batch(mesh, head_lms, 8, device)
            stats['K4bf16'], launches['K4bf16'], bf16 = check_bf16_serving(
                build, forward_of, models, card, kernels, (z, c, v),
                fp32_outs, mesh, head_lms, device)
        finished('14')
        # phase 22 holds T (and G) against their CPU twins
        del models, fp32_outs, outs, outs_t
        train_launches['K2'], variants = check_training_variants(
            files, mesh, device, card, kernels)
        finished('15')
        t0 = time.time()
        ckpt_launches, checkpoints = check_checkpoints(
            G, files, mesh, head_lms, device, card, kernels, ref, spread,
            (z[4], c[4], v[4]), cli_reenact_fps)
        checkpoints['wall_s'] = time.time() - t0
        log(f'phase 16: {checkpoints["wall_s"]:.1f} s')
        finished('16')
        t0 = time.time()
        files['metric_data'], files['metric_obj'] = write_metric_data(
            G, mesh, head_lms, device, train_tmp)
        metric_launches, metrics = check_metrics(G, files, device, card,
                                                 kernels)
        metrics['wall_s'] = time.time() - t0
        log(f'phase 17: {metrics["wall_s"]:.1f} s')
        finished('17')

        t0 = time.time()
        stats['K4b_bf16'] = check_k4_bf16_backward(device, fine)
        del fine
        remat = check_remat(G, mesh, head_lms, device, card)
        # the bench's processes take the card's memory: free this one's
        # cache
        torch.cuda.empty_cache()
        bench_runs = check_bench()
        launches['K4b_bf16'] = \
            bench_runs['train bf16=1']['launches']['K4b_bf16']
        phase18 = dict(remat=remat, runs=bench_runs, card=card,
                       wall_s=time.time() - t0)
        log(f'phase 18: {phase18["wall_s"]:.1f} s')
        finished('18')

        t0 = time.time()
        # phase 19's two ranks take the card's memory too
        torch.cuda.empty_cache()
        parallel_launches, parallel = check_parallel(
            files, mesh, device, card, kernels, train)
        parallel['wall_s'] = time.time() - t0
        log(f'phase 19: {parallel["wall_s"]:.1f} s')
        finished('19')

        torch.cuda.empty_cache()
        family_launches, families, E = check_model_families(
            G, files, mesh, (z, c, v), device, card, kernels)
        finished('20')

        torch.cuda.empty_cache()
        rasterizers = check_rasterizer_selection(
            G, build, mesh, head_lms, (z, c, v), device, card, kernels)
        finished('21')

        torch.cuda.empty_cache()
        full_scale = check_full_scale(
            {'flagship': G, 'texture variant': T, 'EG3D': E}, mesh, head_lms,
            device, card, kernels)
        finished('22')
    finally:
        shutil.rmtree(train_tmp, ignore_errors=True)

    names = {
        'K1': ('rasterize_binned_uv', 'raster_binned_uv.cu',
               'next3d_tpu/ops/pallas_raster.py:489'),
        'K2': ('rasterize_binned', 'raster_binned_uv.cu',
               'next3d_tpu/ops/pallas_raster.py:799'),
        'K3': ('rasterize_binned_uv16', 'raster_binned_uv.cu',
               'next3d_tpu/ops/pallas_raster.py:744'),
        'K4': ('triplane_sample', 'triplane_sample.cu',
               'next3d_tpu/ops/pallas_triplane.py:177'),
        # the TPU kernel is forward only; JAX trains through the XLA
        # gather of render/renderer.py:256 sample_from_planes
        'K4b': ('triplane_sample_backward', 'triplane_sample.cu',
                'next3d_tpu/ops/pallas_triplane.py:177'),
        # for bf16 planes: the points binned by plane tile, each texel
        # written once as bf16
        'K4b_bf16': ('triplane_sample_backward_bf16',
                     'triplane_backward_binned.cu',
                     'next3d_tpu/ops/pallas_triplane.py:177'),
        # the same TPU kernel on planes stored in bf16 (gather_bf16, JAX
        # render/renderer.py:50-65)
        'K4bf16': ('triplane_sample_bf16', 'triplane_sample.cu',
                   'next3d_tpu/ops/pallas_triplane.py:177'),
        'K5': ('rasterize_zbuffer', 'raster_zbuffer.cu',
               'next3d_tpu/ops/pallas_raster.py:101'),
        'K6': ('gather_row_blocks', 'gather_row_blocks.cu',
               'next3d_tpu/ops/pallas_dma_gather.py:93'),
        # the port's own kernel: the JAX package leaves the filter to XLA
        'FIR': ('upfirdn2d', 'upfirdn2d.cu', 'none')}
    line = [dict(name=f'{k} {fn}', route='cuda', source=CSRC + src,
                 replaces=replaces, launches=launches[k], **stats[k])
            for k, (fn, src, replaces) in names.items()]
    for entry in line:
        # the launches of each CLI command of phase 12 (K1 and K4 only) and
        # of phase 13's training run
        k = entry['name'].split()[0]
        if k in ('K1', 'K4'):
            entry['cli_launches'] = {cmd: n[k] for cmd, n in
                                     cli_launches.items()}
        if k in ('K1', 'K2', 'K4', 'K4b'):
            entry['train_launches'] = train_launches[k]
        if k in ('K1', 'K4', 'K4b'):
            # phase 16's commands: from a reference .pkl, and the resumes
            entry['checkpoint_launches'] = {cmd: n[k] for cmd, n in
                                            ckpt_launches.items()}
            # phase 17's commands: calc-metrics and train --metrics
            entry['metrics_launches'] = {cmd: n[k] for cmd, n in
                                         metric_launches.items() if k in n}
            # phase 19 (a): train through the rank entry over NCCL
            entry['parallel_launches'] = parallel_launches[k]
            # phase 20: EG3D's forward, the cross-section, train at 256^2
            entry['model_family_launches'] = family_launches[k]
        if k == 'FIR':
            # phase 20 (b): SG3-T's forwards, by instance, and the 1-D
            # filters' calls done in one launch
            entry['model_family_launches'] = family_launches[k]
    log(json.dumps({'train': train}))
    log(json.dumps({'train_variants': variants}))
    log(json.dumps({'bf16': bf16}))
    log(json.dumps({'checkpoints': checkpoints}))
    log(json.dumps({'metrics': metrics}))
    log(json.dumps({'bench': phase18}))
    log(json.dumps({'parallel': parallel}))
    log(json.dumps({'model_families': families}))
    log(json.dumps({'rasterizers': rasterizers}))
    log(json.dumps({'full_scale': full_scale}))
    log(json.dumps({'phase_s': wall,
                    'total_s': round(time.time() - T_START, 1)}))
    log(card)
    log(json.dumps({'kernels': line}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
