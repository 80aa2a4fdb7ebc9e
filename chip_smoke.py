#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`lossyless_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in the order they run; any failure raises and the script exits
non-zero without printing a result:

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build of every native library of the main path from the sources in the
   checkout (the attention kernels with nvcc, the rANS codec with g++, in
   parallel), with nvcc's register/shared-memory report;
3. K1 and K2 against their plain PyTorch versions on the card
   (`K1_CHECKS`, `K2_CHECKS`): the slice shapes (ViT-B/32: N=50, 12 heads
   of 64, bf16, batch 512 and the main path's 256), N = 1, 16, 17, 64
   and 65, h = 1, d = 16, 32, 48, 56, 80, 96, 112 and 128, B = 1 and 7,
   the CLIP presets' 96 px shape (N = 10 at B = 128 and 256),
   odd shapes in fp32 and bf16 (d = 20, 33, 40; N = 5, 7, 9, 33, 37, 130,
   197), an input whose data pointer is not 16-byte aligned (a view at a
   storage offset of one element: the element path), K2 at B = 1 and 7 in
   both dtypes (84 items, 8 a block: a ragged last block) and the RN50
   attention-pool shape; each K1 case on the design `k1_plan` picks
   (asserted: the TMA/wgmma tile for bf16 at N <= 64 with d a multiple of
   16 and aligned pointers, the one-pass tile for the other bf16 shapes at
   N <= 64, the row code for fp32 and N > 64), every plan's shared memory
   equal to the library's own count; then, at batch 512 and 256, K1 held
   to the attention evaluated in float64 (`float64_check`: the share of
   outputs that differ from it at most 1.5 times the plain version's, no
   output farther from it than the plain version's farthest plus one bf16
   ulp of the float64 value), the kernel's CUDA-event time, its
   device-only time from a torch.profiler trace of the same loop, its
   plain version's time and `scaled_dot_product_attention`'s (timed as a
   yardstick only), the bound and the share of the bound reached, and
   K1's designs side by side on the same inputs (the tile, the one-pass
   tile, the row code: both clocks, each checked against the plain
   version); at N = 10, B = 128 and 256 (phase 11's attention), K1 and
   K2 timed the same way and K1 held to the float64 attention on the
   TMA/wgmma tile (asserted), the check counted on independent draws
   pooled up to the slice check's 19,660,800 outputs (`FLOAT64_OUTPUTS`);
3b. K3 (entropy-bottleneck likelihood) at the training shape (128, 512),
   at odd shapes in fp32, at the banana path's (1024, 2) and (1024, 1)
   with filters (3, 3, 3), at the image path's side latent (256, 25) and
   at the STL10 path's (4096, 25) (stl10_balle's folded side latent) and
   (256, 128) (stl10_bince's z) with filters (3, 3, 3) (`K3_CHECKS`), to
   rtol 1e-5 / atol 1e-7, each on
   the design `k3_plan` picks (asserted: the fixed chain for (3,3,3,3) and
   (3,3,3), else the generic one); its backward kernel at the same shapes
   and the side latent's (128, 102) (`K3_BWD_CHECKS`), through the
   autograd wrapper, against `likelihood_backward_plain` and against
   autograd of the reference chain, to rtol 1e-4 with atol 2e-5 of each
   gradient's largest entry, on inputs where rows 0 and 1 floor under
   g = +1e9 and -1e9 (no gradient may pass the first), two calls equal bit
   for bit; both kernels' times beside their plain versions' and the
   eager backward's (autograd through the reference chain: its time and
   its device kernels), and at the banana, image and STL10 shapes with
   their bounds; the backward at the |x| tie (one channel, widths (1, 1),
   matrix0 = -30, bias0 = 1, z = 0: d(-log lik) / d matrix0 = JAX's
   1.8398e-5, rtol 1e-4, and the plain backward's, rtol 1e-5); K4
   (fused MLP
   half-block) at every `K4_CHECKS` case in bf16, to atol 2e-2 plus one
   bf16 ulp of the value: the training shape (128 x 50 tokens, width 768),
   a ragged last row tile (129 x 50), x and fc_w at a 16-byte storage
   offset, M = 21 at width 64, and widths 96 and 72; each case asserts the
   design `k4_plan` picks (wgmma for widths that are multiples of 64, else
   mma.sync) and holds the plan's shared memory to the library's count;
   K4's QuickGELU epilogue at all 65,536 bf16 inputs, bit for bit;
   then CUDA-event and device-only (torch.profiler) timings of each, of
   its plain version and, for K4, its device time by kernel, the mma.sync
   design's device time on the same inputs (through the library) and the
   op path it replaces (LayerNorm, two matmuls, elementwise: a yardstick;
   both clocks);
3c. K5a (packed, packs 2, 4, 8, 16) and K5b (head-batched) through the
   `fused_attention` wrapper under their knobs at every `K5_CHECKS` case:
   B=512, N=50, h=12, d=64, bf16; odd shapes (B=7, N=37, d=40 in fp32 and
   bf16; pack 3 at B=8, stepping down to 2; d=20 and 33 on the element
   path; an unaligned input); the tiles' edges N = 16, 17, 64 and the
   two-pass tile at N = 65 and 197; a batch whose blocks take unequal
   counts of items; d=128. Each case asserts the design `k5_plan` picks
   (K1's: the TMA/wgmma tile or the one-pass tile, for bf16 at N <= 64;
   two-pass above; the CUDA-core row code for fp32), the plan's shared
   memory against the library's count and
   the launch counter, and holds the result to its plain version and to
   K1's output (fp32 rtol/atol 1e-5, bf16 atol 2e-2); then CUDA-event and
   device-only timings of each, its plain version and
   `scaled_dot_product_attention` (both clocks), and the device time of
   the two-pass tile on the same inputs, with the bound counted from K1's
   work at every pack (the masked blocks add nothing);
3d. K6 (BatchNorm forward and backward) at the stl10_bince ResNet-18's
   stem and layer-4 shapes (channels_last bf16) and the banana MLP's
   (1024, 1024) fp32 (`K6_CHECKS`), training mode: y, dx, dscale, dbias
   and the running statistics each at most twice the eager fp32 chain's
   error against the chain in float64 (plus 1e-6 of the largest entry),
   two calls bit-equal, one launch a forward and one a backward; both
   directions' CUDA-event and device ms beside the bound by bytes (6 and
   8 B an element at bf16 x, 8 and 12 at fp32) and the eager chain's
   times and kernels; phase 14 asserts 40 forward and 40 backward
   launches a stl10_bince step;
4. the encode/decode path at full width: a seeded random CLIP ViT-B/32
   tower in bf16 with seeded entropy-bottleneck params, `compress_dataset`
   over 8 batches of 256 raw uint8 96x96 images, then `decompress_dataset`.
   The decoded features must equal the dequantize path to 1e-5 and the
   launch counters must read 11 x K1 and 1 x K2 per batch. On the first
   batch, the symbols of the kernel tower, of the plain tower (attention
   on the plain versions) and of the float64 tower (the plain tower with
   its attention in blocks 0-10 evaluated in float64, rounded at the plain
   path's points): the kernel tower's flips against the float64 tower
   must be at most `flip_bound` of the plain tower's, min(1.25 x, 2.5%);
   the kernel-vs-plain flips are printed as a record. Then a
   torch.profiler trace of 4 encode batches gives the device time by
   kernel group and the device idle share; then, as a record with no
   bound, the same encode under `HEAD_BATCH=True` (K5b in blocks 0-10):
   its symbol flips against the plain attention and K1, its img/s over the
   8 batches and K5b's device ms a batch; then, a record with no bound
   (4d), the symbols flipped on the first batch between the plain tower
   and the float64 tower and the same tower with its plain attention in
   fp32 with its sums reversed, and between those two;
5. the training path at full width: the `clip_hub` recipe with K3 and K4
   switched on (`rate.eb_use_pallas=True`,
   `encoder.arch_kwargs.mlp_impl=pallas`) through `pipeline.run.
   run_featurizer`, batch 128 of seeded random normalized 224x224 images,
   20 steps: median step ms, img/s, finite loss, rate and distortion, and
   launches per step K1 11, K2 1, K3 1, K3's backward 1, K4 11; a
   torch.profiler trace of 3 more steps (device idle share, device ms by
   kernel group, device kernels a step); then 3 steps
   twice from the same weights and noise, on the kernels and on the plain
   versions of attention, MLP and likelihood, whose logged loss, rate and
   distortion must agree to rtol 1e-2;
6. from training to serving: `save_hub` the trained rate, load it with
   `load_hub_npz` into `ClipCompressor` with the same tower weights,
   `compress_dataset` and `decompress_dataset` one batch; the decoded
   features must equal the dequantize path to 1e-5;
8. the CLIP bottleneck (`clip_bottleneck_pretrain`: the hyperprior rate,
   K3 on its side bottleneck) at full width: 20 training steps at batch
   128 (median step ms, img/s, finite loss, rate, H_q_S, H_q_ZlS and
   distortion; launches per step K1 11, K2 1, K3 1, K3's backward 1); 3
   steps from the same
   weights and noise under the default, `IMAGE_PACK=4` (K5a 11 a step, K1
   0) and `HEAD_BATCH=True` (K5b 11, K1 0), whose loss, rate and
   distortion must equal the default's to rtol 1e-2 (each step's ms is
   recorded); then, as a record with no bound, the step ms under each
   knob in 3 rounds of turns of 8 steps on one state (each round starts
   one knob later) and a torch.profiler trace of 3 steps under each knob
   (device busy ms, idle share); `run_communication`
   over 4 batches of 256 under each knob (n_bits, sender and receiver
   ms/img, the `communication` sentinel), the `HyperpriorCoder` decode
   equal to the host dequantize to 1e-5, and the side symbols and the
   main symbols given K1's side latent within 1% of K1's; a
   torch.profiler trace of 3 steps (with the device kernels a step);
9. the deployment CLI in subprocesses (`python -m
   lossyless_tpu_torch.hub.cli` through a launcher that points
   `load_reference.REFERENCE_HUB` at a temporary directory holding a
   seeded rate file in the published layout): `compress` of a .npz of
   2 x 256 raw uint8 96x96 images with `--device-preprocess 96 96`,
   `info`, `decompress`; the decoded features equal the in-process
   dequantize path to 1e-5, the printed rate equals info's file bits an
   image (payload + 32 bits of framing a record);
10. the bench in subprocesses (`python -m lossyless_tpu_torch.bench`,
   default mode and `--host-fed`, `BENCH_N_BATCHES=4`): every key of its
   JSON line, 0 < device_mfu < 1; the lines printed as a record, no
   speed bound;
11. the three-stage pipeline: `main(preset("clip_bottleneck_linear_eval"))`
   with K3 on, at full width on 4,096 synthetic 96 px images augmented
   by STL10's default chain on the card, 2 featurizer and 2 predictor
   epochs (`PIPELINE_REDUCED`): the three
   stage sentinels and results CSVs, a finite `test/pred/acc`, K1 11 and
   K2 1 a tower forward, K3 and its backward launched, the training steps
   counted on the fused epoch (the image datasets' device sampler, since
   slice 11) and on the host-fed loop; a second `main`
   skips every stage (no step, no launch); a featurizer stage killed
   after its first `save_last` resumes at that step;
12. the banana experiments (`BANANA_REDUCED` lists the cuts): `main(
   preset("banana_viz_VIC"))` at full width (batch 1024, MLPs 1024 wide
   with 2 hidden layers, BatchNorm, QuickGELU, z = 2, fp32) through the
   fused epoch (batches drawn on the card), 2 epochs of 200 steps: plain,
   then with K3 (`rate.eb_use_pallas=True`) on the full 1,024,000-sample
   host dataset, the launch counts read around that run (K3 and its
   backward launched, nothing else), whose first 3 steps' loss, rate and
   distortion must equal the plain run's to rtol 1e-2, all runs under one
   matmul precision (recorded, and checked unchanged after every run);
   then host-fed (`trainer.use_fused_epochs=False`); ms a step of fused
   and host-fed epochs on one state in turns; one fused epoch under
   torch.profiler (idle share, device kernels a step); `banana_viz_BINCE`
   (2048 x 2048 logits) under K3 for 2 epochs of 150 steps (finite loss
   and `I_q_zm`); `banana_viz_VAE` and `banana_viz_VIC_trnslt`; the
   experiment CLI's `-m loss.beta=0.05,0.2` sweep of `banana_RD` in a
   subprocess (two jobs). Every run writes the three stages' metrics
   (`test/feat/*`, `test/comm/n_bits`, `test/pred/*`), all finite;
13. the augmented-MNIST image path (`IMAGE_REDUCED` lists the cuts):
   `main(preset("mnist_vic"))` at full width (ResNet-18 with the 3x3 stem
   at 32 x 32 x 1, z = 128, `H_hyper` with its 25-channel side latent on
   K3, the CNN decoder at hid_dim 32, batch 256, bf16) through the fused
   epoch, the batches drawn and augmented (rotation, x/y translation,
   scale, shear) on the card, 2 epochs of 105 steps on 30,000 seeded
   synthetic images, the launch counts read around that run (K3 and its
   backward launched, nothing else); the same featurizer on the plain
   likelihood, whose first 3 steps' loss, rate and distortion the
   kernels' must equal to rtol 1e-2; ms a step of fused epochs and the
   host-fed loop on one state in turns; a fused epoch under
   torch.profiler (idle share, device kernels a step, device ms by group:
   convolutions, matmuls, K3, other); `mnist_stag_step1` ->
   `mnist_stag_step2` at a small depth, step 2 reading step 1's export
   through `encoder.pretrained_path`, its frozen encoder's parameters
   equal to that export bit for bit;
14. the STL10 experiments (`STL10_REDUCED` lists the cuts):
   `main(preset("stl10_bince"))` at full width (ResNet-18 with the 3x3
   stem at 96 x 96 x 3, z = 128, `H_factorized` on K3, the contrastive
   distortion at project_dim 128, batch 256, bf16) through the fused
   epoch, the anchor and its `equiv_x` positive drawn and augmented on
   the card by STL10's chain (hflip, resize_crop, color, gray), the
   launch counts read around that run (K3 and its backward launched,
   nothing else) and the peak device memory; the same featurizer on the
   plain likelihood, whose first 3 steps' loss, rate and distortion the
   kernels' must equal to rtol 1e-2; a fused epoch under torch.profiler
   (idle share, device kernels a step, device ms by group: convolutions,
   matmuls, K3, augmentation, other); `stl10_understand_VIC` (unlabelled
   STL10, targets -1; the CNN decoder at hid_dim 64 through 96 -> 128 ->
   96; K3 on the (256, 25) side latent; the probe on labelled STL10) and
   `stl10_balle` (BALLE at hid_dim 64 on 128 px, z = 8192, `H_spatial`
   with K3 at (4096, 25), batch 64) through `main` at full width (K3 and
   its backward, nothing else), `stl10_balle`'s exported featurizer
   through `SpatialHyperpriorCoder` (the decode equal to the receiver's
   dequantize of the sender's symbols to 1e-5); `stl10_rate_variation`
   and `stl10_dist_variation` at a small depth and
   `stl10_action_dist_shift` through the experiment CLI in a subprocess.
   Every run writes the three stages' metrics, all finite; the phase
   prints its wall time;
15. the SSL towers (`SSL_REDUCED` lists the cuts):
   `ssl_bottleneck_pretrain` at full width (CLIP's ModifiedResNet-50:
   width 64, (3, 4, 6, 3), 32 heads, 224 px, z = 1024, fp32, `H_hyper`
   with K3 on its (128, 204) side latent) through `run_featurizer`, its
   tower loaded through `encoder.pretrained_path` from a seeded
   OpenAI-layout fp16 `.pt`: 20 steps at batch 128 (median step ms,
   img/s, peak device memory, finite logs; launches a step asserted: K2
   1 as the attention pool, K3 1, its backward 1, K1, K4, K5a, K5b 0), a
   profile of 3 steps (idle share, device kernels a step, device ms by
   group), 3 steps from the same weights and noise on the kernels and on
   the plain K2 and K3 (loss, rate, distortion within rtol 1e-2),
   `run_communication` over 4 x 256 images with the `HyperpriorCoder`
   decode equal to the host dequantize to 1e-5; `simclr` and `swav`
   (ResNet-50, z = 2048, K3 at (128, 409)) 3 steps each from seeded
   torchvision-layout files under the `encoder.` and `module.` prefixes
   (K3 and its backward once a step, nothing else); `main(preset(
   "ssl_bottleneck_linear_eval"))` at the preset's bf16 on synthetic
   STL10 at 96 px (the pool's pe resampled 7 -> 3; K2 once a tower
   forward at N = 10; the three sentinels, a finite probe accuracy, the
   exported tower's parameters equal to the loaded weights bit for bit);
   `ssl_bottleneck_mlp_eval` through the experiment CLI; CLIP's text
   tower (`featurize_captions`, bf16, CLIP's widths) on 1,024 seeded
   token rows in batches of 256 (captions/s; 8 rows within 2e-2 of the
   largest entry of the same tower's fp32 output on the card). Phase 3
   checks and times K2 at the pool's shapes ((128, 50 / 10, 32, 64) in
   fp32 and bf16; times in fp32) and prints the ptxas line of its fp32
   16-byte instantiation; phase 3b K3 at (128, 204) and (128, 409);
16. the tower knobs and data parallelism: (a) K1 and K2 with
   `SOFTMAX_DTYPE=bfloat16` (the bf16 instantiations, `kBf16Sm`) against
   their plain versions under the same knob at every `K1_CHECKS` /
   `K2_CHECKS` case (atol 2e-2; the share of outputs that differ printed;
   K1's three designs all run), their times at ViT-B/32's width (B = 512
   and 256; K1's designs side by side) and at the RN50 pool's fp32 shape,
   beside phase 3's fp32-softmax times; phase 4's 8 x 256 images encoded
   under the bf16 softmax (its K1 and K2 launches counted: the bf16 rows'
   main path) and with the tower at `ln_dtype=bfloat16`, whose file must
   equal phase 4's byte for byte; one fine-tuning step of the ViT-B/32
   tower at batch 128 with `remat` off and on (K1, K2, K4): gradients
   equal (rtol 1e-5 / atol 1e-6), peak memory, step ms, launches a step
   (K1 and K4 22 under remat); (b) the hub over a mesh of two replicas on
   cuda:0 and over `make_mesh(0)`: phase 4's file byte for byte (where it
   differs, the flips against the float64 tower held to phase 4's bound),
   encode img/s, K1 and K2 launches; (c) `stl10_bince` and
   `banana_viz_VIC` featurizer stages at full width (`DP_REDUCED`), each
   in a subprocess as a world of one NCCL rank (torchrun's environment,
   `core.mesh.init_distributed`, the differentiable collectives run once
   on the card) and in one with no process group: every logged step
   equal bit for bit, K3 launched, ms a step of each;
17. the external datasets and the rest of the pipeline
   (`EXTERNAL_REDUCED` lists the cuts): (a) a generated COCO-layout tree
   (1,024 train and 128 val JPEGs of 320 x 240 and 480 x 640, 5 captions
   an image in `annotations/captions_{train,val}2017.json`) ingested by
   `data.ingest.ingest_coco_clip` with the text tower on the card
   (captions/s), then `main(preset("clip_bottleneck_pretrain"))` on it at
   full width, 2 epochs at batch 128 host-fed through `CocoClipDataset`
   (K1 11 and K2 1 a tower forward, K3 and its backward launched, K4 and
   K5 not), the batch stream's img/s alone, a profiled host-fed epoch
   (idle share, ms a step) and 3 steps on the kernels and on the plain
   versions (rtol 1e-2); (b) a generated kaggle tree (512 train and 128
   test 424 x 424 JPEGs, `training_solutions_rev1.csv` with 37 columns
   summing along the decision tree) ingested by `ingest_kaggle_galaxy`,
   then `python -m lossyless_tpu_torch.cli galaxy_regression` in a
   subprocess (2 featurizer epochs, the spatial coder, 2 probe epochs;
   its launches read there: K3 and its backward, nothing else), the
   kaggle submission checked (129 rows, the ingested test ids in order,
   values in [0, 1]), the spatial coder's decode equal to the
   dequantized latents (1e-5), the stream's img/s, a profiled epoch and
   the 3-step kernels-vs-plain check; (c) `pipeline.hypopt` over
   `banana_viz_VIC` (3 trials of 4 epochs, pruning): every trial runs a
   rung, a surviving trial's full run trains only the epochs after it,
   the result JSON is written; (d) the experiment CLI with
   `--profile-dir` in a subprocess: its trace names K3's forward and
   backward kernels, `device_memory_stats()` printed; (e)
   `clip_bottleneck_linear_eval` with `predictor.is_on_the_fly=True`: K1
   and K2 launch inside `fit_onfly`. Phase 3b also checks and times K3
   at galaxy's side latent (8192, 25), and at the example's z (256, 64)
   with filters (3, 3, 3, 3), forward and backward;
18. the analysis path: (a) `python -m lossyless_tpu_torch.cli
   stl10_bince --classical MODE` for jpeg, png and identity (and webp
   where PIL has it), one subprocess each, all started together, on 256
   synthetic 96 px images built on the card: each results CSV equal to
   `ClassicalCompressor.evaluate` over a CPU copy of the same batches
   (all but the two codec times), png and identity lossless; then each
   codec's host img/s, timed alone in this process once the
   subprocesses have ended; (b) `examples/minimal_code_torch.py` at its
   defaults (2,000 steps at batch 256): K3 and its backward launched
   exactly once a step and nothing else, the ms a step timed from a
   built state, one more epoch profiled (idle share, device ms by
   group), 3 steps on K3 against 3 on its plain version from the same
   weights and draws (1e-4 relative), the decoded features equal to the
   dequantize path (1e-5), the coded bits a sample, the probe where
   scikit-learn imports; (c) `banana_viz_VIC --dev` trained through the
   CLI in a subprocess, then `PretrainedAnalyser` over its checkpoint on
   the card and on the CPU: `featurize` (points away from a rounding
   tie) and `decode` equal to 1e-5 of the largest entry, the codebook and
   the traversals drawn where matplotlib imports;
7. the `kernels` JSON line (K1-K4, K3's backward, K5a, K5b; with
   `device_ms` and `bound_share`, K1/K2 also at batch 256 and at N = 10,
   K2 at the RN50 pool's shapes, K3 also at the banana, image, STL10,
   ssl and galaxy shapes, K1's design, its float64 readings and its
   designs side by side, the launches on phase 11's, 12's, 13's, 14's
   and 15's paths and on phase 17's COCO and galaxy paths
   (`launches_on_coco_path`, `launches_on_galaxy_path`; 0 where a kernel
   does not run there), K3's and its backward's on phase 18b's example
   (`launches_on_example_path`), and the registers and spills of every
   kernel;
   phase 16's bf16-softmax
   instantiations of K1 and K2 as rows of their own) and, last,
   `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository around it: with no card, or run
from a directory that holds only this file, it fails.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM data sheet: HBM rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

N_BATCHES, BATCH, RAW_HW = 8, 256, (96, 96)
SLICE = dict(N=50, heads=12, d=64)   # ViT-B/32 attention shapes
TRAIN_BATCH, TRAIN_STEPS, PROFILE_STEPS, AB_STEPS = 128, 20, 3, 3
TIME_ROUNDS, TIME_STEPS = 3, 8   # phase 8b's step times in turns
DEVICE = "cuda"   # the training and serving phases' device
NO_K5 = {"fused_attention_packed": 0, "fused_attention_headbatched": 0}
# K1's and K2's bf16-softmax instantiations: launched only under
# SOFTMAX_DTYPE=bfloat16 (phase 16a)
NO_BF16 = {"fused_attention_bf16_softmax": 0,
           "fused_attention_cls_bf16_softmax": 0}
# K6, BatchNorm's forward and backward: launched wherever a model holds a
# BatchNorm (the image encoders, the MLPs with norm_layer="batchnorm", the
# probes), none on the ViT paths
NO_K6 = {"batchnorm": 0, "batchnorm_bwd": 0}
TRAIN_OVERRIDES = ["rate.eb_use_pallas=True",
                   "encoder.arch_kwargs.mlp_impl=pallas",
                   "trainer.log_every=5"]


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, warmup: int = 5, runs: int = 25, reps: int = 10) -> float:
    """Median over `runs` of the per-call device time of `reps` calls
    enqueued back to back between two CUDA events (so the host's launch
    overhead hides behind the queue instead of inflating the time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_events(prof) -> list:
    """The device kernels and copies of a torch.profiler trace, by name.
    User-annotated ranges (`Optimizer.step#AdamW.step` and other
    `record_function` spans) are left out: their device time spans the
    kernels inside them, which are counted on their own."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def _traces(fn, match, reps: int) -> list[dict]:
    """Three torch.profiler traces of `reps` calls of `fn` after a
    warm-up: per trace, the device time per call (ms) of each CUDA kernel
    whose name contains one of `match` (every kernel where None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        traces.append({e.key: e.self_device_time_total / reps / 1e3
                       for e in device_events(prof)
                       if e.self_device_time_total
                       and (match is None or any(m in e.key for m in match))})
    return traces


def device_ms(fn, match=None, reps: int = 20):
    """Device-only time of one `fn()` from a torch.profiler trace of `reps`
    calls after a warm-up: the summed time of the CUDA kernels whose names
    contain one of `match` (all of the call's kernels where None), over
    `reps`; the median of three traces (a trace now and then loses
    events; when all three did, another set, up to three sets), None if
    none holds such kernel time."""
    for _ in range(3):
        times = [sum(t.values()) for t in _traces(fn, match, reps) if t]
        if times:
            return float(np.median(times))
    return None


def device_ms_by_kernel(fn, match, reps: int = 20) -> dict:
    """`device_ms` split by kernel: each matching kernel's median device
    ms per call over three traces (a kernel missing from a trace counts
    0 there)."""
    traces = _traces(fn, match, reps)
    names = sorted({k for t in traces for k in t})
    return {k: float(np.median([t.get(k, 0.0) for t in traces]))
            for k in names}


def bound_share(bound_ms: float, ms) -> float | None:
    return bound_ms / ms if ms else None


# Phase 3's cases: (B, N, heads, d, dtype, tolerance, options); option
# "unaligned": the inputs are views at a storage offset of one element.
K1_CHECKS = [
    (512, 50, 12, 64, "bfloat16", 2e-2, {}),
    (BATCH, 50, 12, 64, "bfloat16", 2e-2, {}),
    (1, 5, 12, 64, "float32", 1e-5, {}),
    (3, 7, 12, 64, "float32", 1e-5, {}),
    (3, 5, 4, 24, "float32", 1e-5, {}),
    (1, 7, 2, 128, "float32", 1e-5, {}),
    (2, 9, 2, 33, "float32", 1e-5, {}),          # element staging
    (2, 7, 2, 64, "float32", 1e-5, {"unaligned": True}),
    (3, 7, 3, 20, "bfloat16", 2e-2, {}),          # element staging
    (2, 9, 2, 33, "bfloat16", 2e-2, {}),          # element staging
    (7, 37, 3, 40, "bfloat16", 2e-2, {}),         # d, N not x16
    (4, 197, 12, 64, "bfloat16", 2e-2, {}),       # >48 KB smem
    (3, 1, 12, 64, "bfloat16", 2e-2, {}),         # 16-row, 64-key tile edges
    (3, 16, 12, 64, "bfloat16", 2e-2, {}),
    (3, 17, 12, 64, "bfloat16", 2e-2, {}),
    (3, 64, 12, 64, "bfloat16", 2e-2, {}),
    (3, 65, 12, 64, "bfloat16", 2e-2, {}),
    (5, 50, 1, 64, "bfloat16", 2e-2, {}),
    (3, 50, 2, 128, "bfloat16", 2e-2, {}),
    (3, 50, 2, 56, "bfloat16", 2e-2, {}),
    (3, 50, 2, 96, "bfloat16", 2e-2, {}),
    (2, 130, 2, 128, "bfloat16", 2e-2, {}),       # 226 KB smem
    (7, 50, 12, 64, "bfloat16", 2e-2, {}),
    (3, 50, 12, 64, "bfloat16", 2e-2, {"unaligned": True}),
    # the tile's head dims (one or two TMA boxes an operand), fewer items
    # than SMs, and a short sequence
    (3, 50, 4, 16, "bfloat16", 2e-2, {}),
    (3, 33, 3, 32, "bfloat16", 2e-2, {}),
    (2, 50, 2, 48, "bfloat16", 2e-2, {}),
    (2, 40, 2, 80, "bfloat16", 2e-2, {}),
    (2, 50, 2, 112, "bfloat16", 2e-2, {}),
    (1, 50, 12, 64, "bfloat16", 2e-2, {}),
    # the CLIP presets' 96 px images: 3x3 patches + the class token
    (128, 10, 12, 64, "bfloat16", 2e-2, {}),
    (256, 10, 12, 64, "bfloat16", 2e-2, {}),
]
K2_CHECKS = [
    (512, 50, 12, 64, "bfloat16", 2e-2, {}),
    (BATCH, 50, 12, 64, "bfloat16", 2e-2, {}),
    (1, 5, 12, 64, "float32", 1e-5, {}),
    (3, 7, 12, 64, "float32", 1e-5, {}),
    (64, 50, 32, 64, "float32", 1e-5, {}),        # RN50 attention pool
    (1, 50, 12, 64, "bfloat16", 2e-2, {}),
    (7, 50, 12, 64, "bfloat16", 2e-2, {}),
    (1, 50, 12, 64, "float32", 1e-5, {}),
    (7, 50, 12, 64, "float32", 1e-5, {}),
    (2, 1, 4, 64, "bfloat16", 2e-2, {}),
    (3, 197, 12, 64, "bfloat16", 2e-2, {}),
    (3, 50, 2, 128, "float32", 1e-5, {}),
    (2, 7, 3, 20, "float32", 1e-5, {}),           # 5 chunks a row
    (3, 9, 2, 33, "bfloat16", 2e-2, {}),          # element loads
    (3, 50, 12, 64, "bfloat16", 2e-2, {"unaligned": True}),
    (128, 10, 12, 64, "bfloat16", 2e-2, {}),      # the 96 px presets
    (256, 10, 12, 64, "bfloat16", 2e-2, {}),
    # the ssl presets' RN50 attention pool at batch 128: 224 px (N = 50)
    # and 96 px (N = 10), fp32 and bf16 (trainer.precision)
    (128, 50, 32, 64, "float32", 1e-5, {}),
    (128, 10, 32, 64, "float32", 1e-5, {}),
    (128, 50, 32, 64, "bfloat16", 2e-2, {}),
    (128, 10, 32, 64, "bfloat16", 2e-2, {}),
]
RN50_POOL = dict(B=128, heads=32, d=64, Ns=(50, 10))   # phase 3's K2 timing
PIPELINE_N, PIPELINE_BATCHES = 10, (128, 256)   # phase 11's attention


def _randn(g, shape, dtype, unaligned=False):
    """Seeded normal values on the card; `unaligned`: a contiguous view
    whose data pointer sits one element past a 16-byte boundary."""
    import torch

    n = int(np.prod(shape))
    flat = torch.randn(n + 1, generator=g, device="cuda").to(dtype)
    return (flat[1:] if unaligned else flat[:n]).view(*shape)


def k1_inputs(B, N, heads, d, dtype, seed, unaligned=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (_randn(g, (B, N, 3 * heads * d), dtype, unaligned),)


def k2_inputs(B, N, heads, d, dtype, seed, unaligned=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    D = heads * d
    return (_randn(g, (B, 1, D), dtype, unaligned),
            _randn(g, (B, N, 2 * D), dtype, unaligned))


def k1_design(N: int, d: int, dtype: str, aligned: bool) -> str:
    """The design phase 3 expects `k1_plan` to pick."""
    if dtype == "bfloat16" and N <= 64:
        return "wgmma" if d % 16 == 0 and aligned else "onepass"
    return "rows"


def plan_library_smem(lib, plan, N: int, d: int, dtype) -> int:
    """The library's own count of the shared memory `plan` (K1's, K5a's or
    K5b's) launches with."""
    from lossyless_tpu_torch.nn import flash_attn as fa

    if plan.design == "wgmma":
        return lib.lossyless_attention_tile_smem_bytes(d)
    if plan.design == "onepass":
        return lib.lossyless_attention_k5_onepass_smem_bytes(N, d)
    if plan.design == "rows":
        return lib.lossyless_attention_smem_bytes(N, N, d, fa.K1_WARPS)
    dt = fa._DTYPE_CODE[dtype]
    if plan.pack > 1:
        return lib.lossyless_attention_packed_smem_bytes(
            dt, plan.pack * N, d, fa.K5_WARPS)
    return lib.lossyless_attention_headbatched_smem_bytes(
        dt, N, d, plan.heads_per_pass, fa.K5_WARPS)


def bf16_ulp(x):
    """One bf16 ulp of each value of x (fp32 or fp64 tensor): 2^(e - 8)
    for |x| in [2^(e-1), 2^e); the least subnormal at 0."""
    import torch

    e = torch.frexp(x.double()).exponent
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)
    return torch.where(x == 0, torch.full_like(ulp, 2.0**-133), ulp)


def float64_check(got, plain, ref) -> dict:
    """Phase 3's bound on K1 against the attention evaluated in float64
    (`attention_float64`, `ref`), on the same inputs as its plain version
    (`plain`): the share of the kernel's outputs that differ from the
    float64 ones must be at most 1.5 times the plain version's share, and
    no kernel output may lie farther from its float64 value than the plain
    version's farthest output does, plus one bf16 ulp of that value. A
    wrong rounding point or mask moves far more outputs, by more.
    `limit_at`: the kernel's output nearest that second limit (its index,
    the float64, kernel and plain values there and the ulp); an excess of 0
    passes at equality."""
    import torch

    g, p, r = (t.double() for t in (got, plain, ref))
    share_kernel = float((got != ref).double().mean())
    share_plain = float((plain != ref).double().mean())
    far_plain = float((p - r).abs().max())
    ulp = bf16_ulp(r)
    over = (g - r).abs() - far_plain - ulp
    i = int(over.argmax())
    at = tuple(int(k) for k in torch.unravel_index(torch.tensor(i),
                                                   over.shape))
    excess = float(over.flatten()[i])
    return dict(share_kernel=share_kernel, share_plain=share_plain,
                share_bound=1.5 * share_plain, far_kernel=float(
                    (g - r).abs().max()), far_plain=far_plain,
                worst_excess_over_far_plain_plus_ulp=excess,
                limit_at=dict(index=at, float64=float(r.flatten()[i]),
                              kernel=float(g.flatten()[i]),
                              plain=float(p.flatten()[i]),
                              ulp=float(ulp.flatten()[i])),
                ok=share_kernel <= 1.5 * share_plain and excess <= 0)


def flip_bound(plain_vs_f64: float) -> float:
    """Phase 4's bound on the kernel tower's symbol flips against the
    float64 tower, from the plain tower's flips against it in the same
    run: no farther from the exact attention than the plain path (with a
    quarter's margin), and never above 2.5% (what the spread of
    summation orders supports, so that a library that moves the plain path
    itself cannot widen the check unnoticed)."""
    return min(1.25 * plain_vs_f64, 0.025)


DESIGN_KERNELS = {"wgmma": "attention_tile_kernel",
                  "onepass": "k5_onepass_kernel", "rows": "attention_kernel"}


def k1_design_runs(lib, qkv, heads: int) -> dict:
    """For each of K1's designs that takes this input (the tile, the
    one-pass tile, the row code), a function that runs it through the
    library itself, with the geometry its plan would give it, into its own
    output: for timing side by side on the same inputs, outside the
    wrapper and its launch count."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    B, N, threeD = qkv.shape
    d = threeD // (3 * heads)
    runs = {}
    for design in DESIGN_KERNELS:
        out = torch.empty((B, N, heads * d), dtype=qkv.dtype,
                          device=qkv.device)
        aligned = fa._aligned(qkv, out)
        if design == "wgmma":
            if not fa.tile_scope(B, N, d, qkv.dtype, aligned):
                continue
            plan = fa._tile_plan(B, heads, d)
        elif design == "onepass":
            if qkv.dtype != torch.bfloat16 or N > fa.K5_ONEPASS_MAX_N:
                continue
            plan = fa._onepass_plan(B, N, heads, d, fa.sixteen_byte_path(
                d, qkv.dtype.itemsize, aligned))
        else:
            plan = None

        def run(plan=plan, out=out, design=design):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            if plan is not None:
                rc = fa._launch_tile_designs(lib, qkv, out, heads, plan,
                                             fa._bf16_softmax())
            else:
                rc = lib.lossyless_fused_attention(
                    qkv.data_ptr(), out.data_ptr(), B, N, heads, d,
                    fa._DTYPE_CODE[qkv.dtype], d**-0.5, fa.K1_WARPS,
                    fa._bf16_softmax(), qkv.device.index, stream)
            fa._raise_on(rc, f"K1 {design} design")
            return out
        runs[design] = run
    return runs


def check_kernels():
    """Phase 3: K1 and K2 vs their plain versions, K1 on the design its
    plan picks, the plans' shared memory against the library's; then, at
    batch 512 and 256, K1 against the float64 attention, timings, and K1's
    designs side by side."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    lib = fa._get_lib()
    cases = {
        "fused_attention": (k1_inputs, fa.fused_attention,
                            fa.attention_plain, K1_CHECKS),
        "fused_attention_cls": (k2_inputs, fa.fused_attention_cls,
                                fa.attention_cls_plain, K2_CHECKS),
    }
    results = {}
    with torch.inference_mode():
        for name, (make, kernel, plain, shapes) in cases.items():
            errs = []
            for i, (B, N, h, d, dt, tol, opt) in enumerate(shapes):
                dtype = getattr(torch, dt)
                args = make(B, N, h, d, dtype, seed=i,
                            unaligned=opt.get("unaligned", False))
                aligned = all(a.data_ptr() % 16 == 0 for a in args)
                vec = fa.sixteen_byte_path(d, dtype.itemsize, aligned)
                got = kernel(*args, h)
                torch.cuda.synchronize()
                how = f"{'16-byte' if vec else 'element'} path"
                if name == "fused_attention_cls":
                    plan = fa.k2_plan(B, N, h, d, dtype, vec)
                    lib_smem = lib.lossyless_attention_k2_smem_bytes(
                        N, d, plan.warps)
                    how += (f", {plan.blocks} blocks of {plan.warps} warps, "
                            f"{plan.smem} B smem")
                else:
                    plan = fa.k1_plan(B, N, h, d, dtype, aligned)
                    if plan.design != k1_design(N, d, dt, aligned):
                        raise AssertionError(
                            f"K1 at B={B} N={N} d={d} {dt}: plan "
                            f"{plan.design}, expected "
                            f"{k1_design(N, d, dt, aligned)}")
                    lib_smem = plan_library_smem(lib, plan, N, d, dtype)
                    how = (f"{plan.design}, {plan.blocks} blocks of "
                           f"{plan.warps} warps, {plan.stages} stage(s), "
                           f"{plan.smem} B smem, {how}")
                if lib_smem != plan.smem:
                    raise AssertionError(
                        f"{name} plan {plan} disagrees with the "
                        f"library's {lib_smem} bytes")
                want = plain(*args, h)
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= tol
                print(f"check {name} B={B} N={N} h={h} d={d} {dt} {how}"
                      f"{' (unaligned input)' if opt.get('unaligned') else ''}"
                      f": max_abs_err={err!r} tol={tol} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at B={B} N={N} h={h} "
                                         f"d={d} {dt} {opt}")
                errs.append(err)

            for B in (512, BATCH):
                N, h, d = SLICE["N"], SLICE["heads"], SLICE["d"]
                row = time_attention(name, make, kernel, plain, B, N, h, d)
                if name == "fused_attention":
                    row.update(k1_float64_and_designs(lib, B, N, h, d))
                if B == 512:
                    results[name] = dict(max_abs_err=errs[0], **row)
                else:
                    results[name][f"at_b{B}"] = row
            # the pipeline's shape (phase 11): N = 10 at its batches, K1 on
            # the TMA/wgmma tile and held to the float64 attention
            for B in PIPELINE_BATCHES:
                h, d = SLICE["heads"], SLICE["d"]
                row = time_attention(name, make, kernel, plain, B,
                                     PIPELINE_N, h, d)
                if name == "fused_attention":
                    row.update(k1_float64_check(B, PIPELINE_N, h, d))
                results[name][f"at_n{PIPELINE_N}_b{B}"] = row
        # the ssl presets' RN50 attention pool (phase 15), fp32
        pool = RN50_POOL
        for N in pool["Ns"]:
            results["fused_attention_cls"][f"rn50_pool_n{N}_fp32"] = \
                time_attention("fused_attention_cls", k2_inputs,
                               fa.fused_attention_cls, fa.attention_cls_plain,
                               pool["B"], N, pool["heads"], pool["d"],
                               "float32")
    return results


# outputs of the float64 check at the slice shape (B=512, N=50): a check at
# a smaller shape pools independent draws up to this many outputs, so its
# share of differing outputs is counted on as large a sample (a single
# draw at B=128, N=10 holds ~60-100 of them, too few to read a 1.5x ratio
# on: scripts/k1_float64_spread.py, PERF.md §6)
FLOAT64_OUTPUTS = 512 * 50 * 768


def k1_float64_check(B, N, h, d) -> dict:
    """K1 at (B, N, h, d) bf16: the design its plan picks (asserted: the
    TMA/wgmma tile) and `float64_check`, which must pass, on draws of
    `k1_inputs` (seeds 100, 101, ...) pooled up to `FLOAT64_OUTPUTS`
    outputs; each draw's own reading is printed as a record."""
    import math

    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    design = fa.k1_plan(B, N, h, d, torch.bfloat16).design
    if design != "wgmma":
        raise AssertionError(f"K1 at B={B} N={N}: plan {design}, expected "
                             f"wgmma")
    draws = math.ceil(FLOAT64_OUTPUTS / (B * N * h * d))
    got, plain, ref, per_draw = [], [], [], []
    for i in range(draws):
        (qkv,) = k1_inputs(B, N, h, d, torch.bfloat16, seed=100 + i)
        got.append(fa.fused_attention(qkv, h))
        plain.append(fa.attention_plain(qkv, h))
        ref.append(attention_float64(qkv, h))
        one = float64_check(got[-1], plain[-1], ref[-1])
        per_draw.append({k: one[k] for k in ("share_kernel", "share_plain",
                                             "ok")})
    check = float64_check(torch.cat(got), torch.cat(plain), torch.cat(ref))
    print(f"check fused_attention B={B} N={N} vs float64 over {draws} "
          f"draws: {check} {'ok' if check['ok'] else 'FAIL'}; each draw "
          f"(a record): {per_draw}", flush=True)
    if not check["ok"]:
        raise AssertionError(f"K1 at B={B} N={N} is farther from the "
                             f"float64 attention than its bound: {check}")
    return dict(design=design, float64=check, float64_draws=draws,
                float64_per_draw=per_draw)


def k1_float64_and_designs(lib, B, N, h, d) -> dict:
    """At (B, N, h, d) bf16, on `time_attention`'s inputs: K1 (through
    its wrapper) against the attention in float64 (`float64_check`, which
    must pass), then each of K1's designs through the library: its error
    against the plain version (atol 2e-2, which must hold), its CUDA-event
    and device ms, beside the plain version's and SDPA's from
    `time_attention`."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    (qkv,) = k1_inputs(B, N, h, d, torch.bfloat16, seed=100)
    want = fa.attention_plain(qkv, h)
    check = float64_check(fa.fused_attention(qkv, h), want,
                          attention_float64(qkv, h))
    print(f"check fused_attention B={B} vs float64: {check} "
          f"{'ok' if check['ok'] else 'FAIL'}", flush=True)
    if not check["ok"]:
        raise AssertionError(f"K1 at B={B} is farther from the float64 "
                             f"attention than its bound: {check}")
    designs = {}
    for design, run in k1_design_runs(lib, qkv, h).items():
        err = (run().float() - want.float()).abs().max().item()
        if not err <= 2e-2:
            raise AssertionError(f"K1's {design} design off its plain "
                                 f"version by {err} at B={B}")
        designs[design] = dict(
            max_abs_err=err, ms=median_ms(run),
            device_ms=device_ms(run, (DESIGN_KERNELS[design],)))
    print(f"time fused_attention B={B} designs: {designs}", flush=True)
    return dict(design=fa.k1_plan(B, N, h, d, torch.bfloat16).design,
                float64=check, designs=designs)


def time_attention(name, make, kernel, plain, B, N, h, d,
                   dtype: str = "bfloat16") -> dict:
    """K1's or K2's times at (B, N, h, d) in `dtype`: the kernel's
    CUDA-event and device-only time, its plain version's, SDPA's (both
    clocks), the bound and the share of it reached."""
    import torch
    import torch.nn.functional as F

    from lossyless_tpu_torch.nn import flash_attn as fa

    dt = getattr(torch, dtype)
    size = dt.itemsize
    args = make(B, N, h, d, dt, seed=100)
    D = h * d
    if name == "fused_attention":
        (qkv,) = args
        q, k, v = (t.view(B, N, h, d).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        nbytes = qkv.numel() * size + B * N * D * size
        flops = 4 * B * h * N * N * d
        # the kernel of the design K1's plan picks: the only one it runs
        match = (DESIGN_KERNELS[fa.k1_plan(B, N, h, d, dt).design],)
    else:
        q0, kv = args
        q = q0.view(B, 1, h, d).transpose(1, 2)
        k, v = (t.view(B, N, h, d).transpose(1, 2)
                for t in kv.split(D, dim=-1))
        nbytes = q0.numel() * size + kv.numel() * size + B * D * size
        flops = 4 * B * h * N * d
        match = ("k2_attention_kernel",)
    ms = median_ms(lambda: kernel(*args, h))
    dev_ms = device_ms(lambda: kernel(*args, h), match)
    plain_ms = median_ms(lambda: plain(*args, h))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    library_ms = median_ms(sdpa)
    library_dev_ms = device_ms(sdpa)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = dict(B=B, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_share(bound_ms, dev_ms or ms),
               library_ms=library_ms, library_device_ms=library_dev_ms)
    if dtype != "bfloat16":
        row.update(N=N, heads=h, d=d, dtype=dtype)
    print(f"time {name} B={B} N={N} h={h} d={d} {dtype}: kernel {ms!r} ms "
          f"(device {dev_ms!r} ms), plain {plain_ms!r} ms, sdpa "
          f"{library_ms!r} ms (device {library_dev_ms!r} ms), bound "
          f"{bound_ms!r} ms ({bound_by}: {nbytes} bytes, {flops} flop), "
          f"share of bound {row['bound_share']!r}", flush=True)
    return row


class Knobs:
    """Set the attention variant knobs of `nn.flash_attn` for a block."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        from lossyless_tpu_torch.nn import flash_attn as fa

        self.saved = {k: getattr(fa, k) for k in self.kw}
        for k, v in self.kw.items():
            setattr(fa, k, v)

    def __exit__(self, *exc):
        from lossyless_tpu_torch.nn import flash_attn as fa

        for k, v in self.saved.items():
            setattr(fa, k, v)


K5_PACKS = (2, 4, 8, 16)
K5_MAIN_PACK = 4          # the pack phase 8 runs K5a at
# Phase 3c's cases: (B, N, heads, d, dtype, knobs, options); option
# "unaligned": the input is a view at a storage offset of one element.
K5_CHECKS = [
    *((512, 50, 12, 64, "bfloat16", dict(IMAGE_PACK=p), {})
      for p in K5_PACKS),
    (512, 50, 12, 64, "bfloat16", dict(HEAD_BATCH=True), {}),
    (7, 37, 3, 40, "float32", dict(IMAGE_PACK=7), {}),
    (7, 37, 3, 40, "float32", dict(HEAD_BATCH=True), {}),
    (8, 50, 12, 64, "bfloat16", dict(IMAGE_PACK=3), {}),   # steps down to 2
    (8, 50, 4, 24, "float32", dict(IMAGE_PACK=3), {}),
    (16, 50, 12, 64, "float32", dict(IMAGE_PACK=4), {}),
    (7, 37, 3, 40, "bfloat16", dict(IMAGE_PACK=7), {}),    # d, N not x16
    (6, 9, 2, 33, "bfloat16", dict(IMAGE_PACK=3), {}),     # element path
    (7, 37, 3, 40, "bfloat16", dict(HEAD_BATCH=True), {}),
    (3, 7, 3, 20, "bfloat16", dict(HEAD_BATCH=True), {}),  # element path
    (2, 197, 12, 64, "bfloat16", dict(HEAD_BATCH=True), {}),   # two-pass
    # the tiles' edges (N = 16, 17, 64) and the two-pass tile's
    # first N (65), under both knobs
    *((4, n, 12, 64, "bfloat16", kw, {}) for n in (16, 17, 64, 65)
      for kw in (dict(IMAGE_PACK=2), dict(HEAD_BATCH=True))),
    # 3600 items: 27 or 28 a block on the tile (pack 4 steps down to 3)
    (300, 50, 12, 64, "bfloat16", dict(HEAD_BATCH=True), {}),
    (300, 50, 12, 64, "bfloat16", dict(IMAGE_PACK=4), {}),
    (3, 50, 12, 64, "bfloat16", dict(HEAD_BATCH=True), {"unaligned": True}),
    (4, 50, 12, 64, "bfloat16", dict(IMAGE_PACK=2), {"unaligned": True}),
    (3, 50, 2, 128, "bfloat16", dict(HEAD_BATCH=True), {}),
    (4, 64, 2, 128, "bfloat16", dict(IMAGE_PACK=2), {}),
]


def k5_design(N: int, d: int, dtype: str, aligned: bool) -> str:
    """The design phase 3c expects `k5_plan` to pick: K1's at bf16 N <= 64
    (the same kernels), the two-pass tile above, the row code for fp32."""
    if dtype == "float32":
        return "fma"
    return k1_design(N, d, dtype, aligned) if N <= 64 else "twopass"


def two_pass_k5(lib, qkv, heads: int, pack: int):
    """A function that runs K5a (pack >= 2) or K5b (pack 1) on the
    two-pass tile, the design before the one-pass tile (kept for N > 64),
    through the library itself: for timing beside the one-pass tile on
    the same inputs, outside the wrappers and their launch counts."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    B, N, threeD = qkv.shape
    d = threeD // (3 * heads)
    out = torch.empty((B, N, heads * d), dtype=qkv.dtype, device=qkv.device)
    dt = fa._DTYPE_CODE[qkv.dtype]
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    if pack > 1:
        def run():
            return lib.lossyless_fused_attention_packed(
                qkv.data_ptr(), out.data_ptr(), B, N, heads, d, pack, dt,
                d**-0.5, fa.K5_WARPS, qkv.device.index, stream)
    else:
        hp = fa.k5b_pass(N, heads, d, qkv.dtype)[0]

        def run():
            return lib.lossyless_fused_attention_headbatched(
                qkv.data_ptr(), out.data_ptr(), B, N, heads, d, dt,
                d**-0.5, fa.K5_WARPS, hp, qkv.device.index, stream)

    def launch():
        fa._raise_on(run(), "two-pass K5")
        return out
    return launch


def check_k5() -> dict:
    """Phase 3c: K5a (packed) and K5b (head-batched) through the
    `fused_attention` wrapper under their knobs at every `K5_CHECKS` case,
    against their plain versions and K1's output, each on the design
    `k5_plan` picks (asserted, with its shared memory against the
    library's count); then timings at batch 512."""
    import torch
    import torch.nn.functional as F

    from lossyless_tpu_torch.nn import flash_attn as fa

    bf16, f32 = torch.bfloat16, torch.float32
    lib = fa._get_lib()
    errs = {}
    with torch.inference_mode():
        for i, (B, N, h, d, dt, kw, opt) in enumerate(K5_CHECKS):
            dtype = getattr(torch, dt)
            (qkv,) = k1_inputs(B, N, h, d, dtype, seed=200 + i,
                               unaligned=opt.get("unaligned", False))
            k1 = fa.fused_attention(qkv, h)
            with Knobs(**kw):
                variant, pack = fa.attention_variant(qkv)
                name = f"fused_attention_{variant}"
                aligned = qkv.data_ptr() % 16 == 0
                plan = fa.k5_plan(B, N, h, d, dtype, pack, aligned)
                if plan.design != k5_design(N, d, dt, aligned):
                    raise AssertionError(f"{kw} at N={N} {dt}: plan "
                                         f"{plan.design}, expected "
                                         f"{k5_design(N, d, dt, aligned)}")
                lib_smem = plan_library_smem(lib, plan, N, d, dtype)
                if lib_smem != plan.smem:
                    raise AssertionError(f"{name} plan {plan} disagrees with "
                                         f"the library's {lib_smem} bytes")
                before = fa.LAUNCHES[name]
                got = fa.fused_attention(qkv, h)
                torch.cuda.synchronize()
                if fa.LAUNCHES[name] != before + 1:
                    raise AssertionError(f"{kw} did not launch {name}")
                want = (fa.attention_packed_plain(qkv, h, pack)
                        if variant == "packed"
                        else fa.attention_headbatched_plain(qkv, h))
            g, w, k = got.float(), want.float(), k1.float()
            err = (g - w).abs().max().item()
            err_k1 = (g - k).abs().max().item()
            if dtype == f32:
                ok = bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all()
                          and ((g - k).abs() <= 1e-5 + 1e-5 * k.abs()).all())
                tol = "rtol/atol 1e-5"
            else:
                ok = err <= 2e-2 and err_k1 <= 2e-2
                tol = "atol 2e-2"
            ok = ok and bool(torch.isfinite(got).all())
            label = f"pack={pack}" if variant == "packed" else "head-batched"
            ragged = plan.items % plan.per_block
            print(f"check {name} {label} B={B} N={N} h={h} d={d} {dt} "
                  f"{plan.design} ({plan.blocks} blocks of {plan.warps} "
                  f"warps, {plan.per_block} items a block"
                  f"{f', last run {ragged}' if ragged else ''}, "
                  f"{plan.stages} stage(s), {plan.smem} B smem, "
                  f"{'16-byte' if plan.vec else 'element'} path"
                  f"{', unaligned input' if opt.get('unaligned') else ''}): "
                  f"max_abs_err={err!r} vs K1 {err_k1!r} tol={tol} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} ({kw}) disagrees at B={B} "
                                     f"N={N} d={d}")
            if B == 512:   # the slice shape's error goes in the line
                errs[variant, pack] = err

    slice_ = (512, SLICE["N"], SLICE["heads"], SLICE["d"], bf16)
    B, N, h, d = slice_[:4]
    D = h * d
    (qkv,) = k1_inputs(B, N, h, d, bf16, seed=100)
    q, k, v = (t.view(B, N, h, d).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    nbytes = qkv.numel() * 2 + B * N * D * 2
    results = {}
    with torch.inference_mode():
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        library_ms = median_ms(sdpa)
        library_dev_ms = device_ms(sdpa)
        by_pack = {}
        for kw in [dict(IMAGE_PACK=p) for p in K5_PACKS] + \
                [dict(HEAD_BATCH=True)]:
            with Knobs(**kw):
                variant, pack = fa.attention_variant(qkv)
                ms = median_ms(lambda: fa.fused_attention(qkv, h))
                dev_ms = device_ms(lambda: fa.fused_attention(qkv, h),
                                   (*DESIGN_KERNELS.values(),
                                    f"{variant}_attention"))
                design = fa.k5_plan(B, N, h, d, bf16, pack).design
            # the two-pass tile (the design before the one-pass tile, kept
            # for N > 64) on the same inputs, for comparison in one run
            two_pass = two_pass_k5(lib, qkv, h, pack)
            two_pass_err = (two_pass().float() - fa.fused_attention(
                qkv, h).float()).abs().max().item()   # no knob: K1
            if not two_pass_err <= 2e-2:
                raise AssertionError(f"two-pass {variant} off K1 by "
                                     f"{two_pass_err}")
            two_pass_ms = device_ms(two_pass, (f"{variant}_attention_mma",))
            if variant == "packed":
                plain_ms = median_ms(
                    lambda: fa.attention_packed_plain(qkv, h, pack))
            else:
                plain_ms = median_ms(
                    lambda: fa.attention_headbatched_plain(qkv, h))
            # K1's operations at every pack: the masked cross-image blocks
            # add nothing to the output, and the kernel skips them
            flops = 4 * B * h * N * N * d
            bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
            row = dict(max_abs_err=errs[(variant, pack)], design=design,
                       ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bound_share=bound_share(bound_ms, dev_ms or ms),
                       library_ms=library_ms,
                       library_device_ms=library_dev_ms,
                       two_pass_device_ms=two_pass_ms)
            label = f"pack={pack}" if variant == "packed" else "head-batched"
            print(f"time fused_attention_{variant} {label} B={B} N={N} h={h} "
                  f"d={d} bf16 {design}: kernel {ms!r} ms (device {dev_ms!r} "
                  f"ms), plain {plain_ms!r} ms, sdpa {library_ms!r} ms "
                  f"(device {library_dev_ms!r} ms), bound {bound_ms!r} ms "
                  f"({bound_by}: {nbytes} bytes, {flops} flop), share of "
                  f"bound {row['bound_share']!r}; two-pass tile (device) "
                  f"{two_pass_ms!r} ms", flush=True)
            if variant == "packed":
                by_pack[pack] = row
            else:
                results["fused_attention_headbatched"] = row
    results["fused_attention_packed"] = dict(
        by_pack[K5_MAIN_PACK], pack=K5_MAIN_PACK,
        ms_by_pack={p: r["ms"] for p, r in by_pack.items()},
        device_ms_by_pack={p: r["device_ms"] for p, r in by_pack.items()},
        two_pass_device_ms_by_pack={p: r["two_pass_device_ms"]
                                    for p, r in by_pack.items()},
        bound_ms_by_pack={p: r["bound_ms"] for p, r in by_pack.items()})
    return results


def main_path(card: str) -> dict:
    """Phase 4: compress_dataset + decompress_dataset at full width."""
    import torch

    from lossyless_tpu_torch.coding import entropy_bottleneck as eb
    from lossyless_tpu_torch.coding import rans
    from lossyless_tpu_torch.hub.compressor import ClipCompressor
    from lossyless_tpu_torch.nn import _build
    from lossyless_tpu_torch.nn import flash_attn as fa
    from lossyless_tpu_torch.nn.vit import vit_b32

    rng = np.random.default_rng(0)
    eb_params = eb.init_params(eb.EBConfig(512),
                               torch.Generator().manual_seed(0))
    scaling = rng.normal(1.5, 0.2, 512).astype(np.float32)
    biasing = rng.normal(0.0, 0.1, 512).astype(np.float32)
    images = rng.integers(0, 256, (N_BATCHES * BATCH, *RAW_HW, 3),
                          dtype=np.uint8)
    batches = [(images[i * BATCH:(i + 1) * BATCH],
                np.arange(i * BATCH, (i + 1) * BATCH))
               for i in range(N_BATCHES)]

    comp = ClipCompressor(eb_params, scaling, biasing, raw_input_hw=RAW_HW)
    comp.compress(batches[0][0])            # tower init + warm-up
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        data, labels = Path(tmp) / "z.bin", Path(tmp) / "y.npy"
        reset_launches()
        t0 = time.perf_counter()
        rate, _ = comp.compress_dataset(iter(batches), data, labels,
                                        is_info=False)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        z_hat, y = comp.decompress_dataset(data, labels, is_info=False)
        t_dec = time.perf_counter() - t0
        launches = read_launches()
        file_bytes = data.read_bytes()
    print(f"main path launches: {launches}", flush=True)

    n_layers = len(comp.model.blocks)
    # the encode path's MLPs are torch ops and it computes no likelihood
    want = {"fused_attention": (n_layers - 1) * N_BATCHES,
            "fused_attention_cls": N_BATCHES, "fused_mlp_block": 0,
            "eb_likelihood": 0, "eb_likelihood_bwd": 0, **NO_K5, **NO_BF16,
            **NO_K6}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if rans._get_lib()._name != str(_build.library_path("rans")):
        raise AssertionError("the rANS codec is not the native build")

    n = len(images)
    if z_hat.shape != (n, 512) or not np.isfinite(z_hat).all():
        raise AssertionError(f"decoded features: shape {z_hat.shape}, "
                             f"finite {np.isfinite(z_hat).all()}")
    np.testing.assert_array_equal(y, np.arange(n))
    features = np.concatenate([comp(x) for x, _ in batches])
    dec_err = float(np.abs(z_hat - features).max())
    print(f"decode vs dequantize path: max_abs_err={dec_err!r}", flush=True)
    if dec_err > 1e-5:
        raise AssertionError(f"decode round-trip off by {dec_err}")

    # the same tower with attention on the plain versions
    plain = ClipCompressor(eb_params, scaling, biasing,
                           clip_params=comp.model.state_dict(),
                           model=vit_b32(attn_impl="plain"),
                           raw_input_hw=RAW_HW)
    x0 = batches[0][0]
    s_kernel = comp.codec.decode_batch(comp.compress(x0), comp.indexes)
    s_plain = plain.codec.decode_batch(plain.compress(x0), plain.indexes)
    # the float64 tower: the plain tower with its attention in blocks 0-10
    # evaluated in float64, rounded at the plain path's points
    with PlainAttention(attention_float64):
        s_f64 = plain.codec.decode_batch(plain.compress(x0), plain.indexes)
    flips = dict(kernel_vs_float64=float((s_kernel != s_f64).mean()),
                 plain_vs_float64=float((s_plain != s_f64).mean()),
                 kernel_vs_plain=float((s_kernel != s_plain).mean()))
    limit = flip_bound(flips["plain_vs_float64"])
    ok = flips["kernel_vs_float64"] <= limit
    print(f"symbol flips of {s_kernel.size}: kernel vs float64 "
          f"{flips['kernel_vs_float64']!r}, plain vs float64 "
          f"{flips['plain_vs_float64']!r} (bound {limit!r}: "
          f"{'ok' if ok else 'FAIL'}); kernel vs plain (a record) "
          f"{flips['kernel_vs_plain']!r}", flush=True)
    if not ok:
        raise AssertionError(f"the kernel tower flips {flips} of the "
                             f"symbols, past the bound {limit}")

    result = dict(card=card, images=n, batch=BATCH, raw_hw=list(RAW_HW),
                  encode_img_per_s=n / t_enc, decode_img_per_s=n / t_dec,
                  bits_per_img=rate, symbol_flips=flips, flip_bound=limit,
                  decode_max_abs_err=dec_err)
    # what phase 16 encodes again: the same rate, images and tower seed
    PHASE4.update(comp=comp, rate=(eb_params, scaling, biasing),
                  batches=batches,
                  file_bytes=file_bytes, s_f64=s_f64, flip_bound=limit,
                  encode_img_per_s=n / t_enc)
    print(json.dumps({"main_path": result}), flush=True)
    hb = encode_head_batch_record(comp, batches, s_kernel, s_plain, card)
    summation_order_record(plain, x0, s_plain, s_f64, flips, hb, card)
    profile_encode(comp, batches[:4], card)
    return launches


def encode_head_batch_record(comp, batches, s_kernel, s_plain, card: str):
    """Phase 4c, a record with no bound: the encode path with blocks 0-10
    on K5b's tensor-core tile (`HEAD_BATCH=True`): its symbol flips against
    the plain attention and against K1 on the first batch, encode img/s
    over the same batches, and K5b's device ms a batch."""
    from lossyless_tpu_torch.nn import flash_attn as fa

    x0 = batches[0][0]
    with Knobs(HEAD_BATCH=True):
        s_hb = comp.codec.decode_batch(comp.compress(x0), comp.indexes)
        before = fa.LAUNCHES["fused_attention_headbatched"]
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            comp.compress_dataset(iter(batches), Path(tmp) / "hb.bin",
                                  is_info=False)
            t_enc = time.perf_counter() - t0
        launches = fa.LAUNCHES["fused_attention_headbatched"] - before
        k5b_ms = device_ms(lambda: comp.compress(x0),
                           ("attention_tile_kernel", "k5_onepass",
                            "headbatched_attention"), reps=5)
    n = sum(len(x) for x, _ in batches)
    record = dict(
        card=card, images=n, knob="HEAD_BATCH=True",
        symbol_flip_fraction_vs_plain=float((s_hb != s_plain).mean()),
        symbol_flip_fraction_vs_k1=float((s_hb != s_kernel).mean()),
        symbols=int(s_hb.size), encode_img_per_s=n / t_enc,
        k5b_launches_per_batch=launches / len(batches),
        k5b_device_ms_per_batch=k5b_ms)
    print(json.dumps({"encode_head_batch_record": record}), flush=True)
    return record


def attention_float64(qkv, heads: int):
    """The plain attention's function evaluated in float64, rounded where
    the plain path rounds: the logits to fp32, the probabilities and the
    output to the io dtype."""
    import torch

    B, N, threeD = qkv.shape
    D = threeD // 3
    d = D // heads
    q, k, v = (t.reshape(B, N, heads, d)
               for t in qkv.double().split(D, dim=-1))
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5).float()
    logits = logits.double()
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (p / p.sum(dim=-1, keepdim=True)).to(qkv.dtype).double()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, N, D).to(qkv.dtype)


def attention_reversed(qkv, heads: int):
    """The plain attention in fp32 with its sums in the reverse order: the
    head dim flipped in q and k, the key axis flipped in k (so in the
    logits and p) and in v."""
    import torch

    B, N, threeD = qkv.shape
    D = threeD // 3
    d = D // heads
    q, k, v = (t.reshape(B, N, heads, d)
               for t in qkv.float().split(D, dim=-1))
    q, k, v = q.flip(-1), k.flip(-1).flip(1), v.flip(1)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (p / p.sum(dim=-1, keepdim=True)).to(qkv.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, N, D).to(qkv.dtype)


class PlainAttention:
    """Inside the block, the towers' plain attention (`vit.attention_plain`,
    blocks 0-10 of an `attn_impl="plain"` tower) is `fn`."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from lossyless_tpu_torch.nn import vit

        self.saved = vit.attention_plain
        vit.attention_plain = self.fn

    def __exit__(self, *exc):
        from lossyless_tpu_torch.nn import vit

        vit.attention_plain = self.saved


def summation_order_record(plain, x0, s_plain, s_f64, flips, hb,
                           card: str):
    """Phase 4d, a record with no bound: the symbol flips between plain
    attentions that differ only in summation order, on phase 4's first
    batch and weights: the plain tower against the float64 tower (a, phase
    4's reading) and against the same tower with its plain attention in
    fp32 with its sums reversed (b), and (a) against (b); beside phase 4's
    kernel readings and phase 4c's K5b reading."""
    with PlainAttention(attention_reversed):
        s_rev = plain.codec.decode_batch(plain.compress(x0), plain.indexes)
    record = dict(
        card=card, symbols=int(s_plain.size),
        flips_plain_vs_float64=flips["plain_vs_float64"],
        flips_plain_vs_reversed=float((s_rev != s_plain).mean()),
        flips_float64_vs_reversed=float((s_f64 != s_rev).mean()),
        phase4_k1_vs_plain=flips["kernel_vs_plain"],
        phase4_k1_vs_float64=flips["kernel_vs_float64"],
        phase4c_k5b_vs_plain=hb["symbol_flip_fraction_vs_plain"])
    print(json.dumps({"summation_order_record": record}), flush=True)


def eb_params_for(C: int, filters, seed: int) -> dict:
    """Seeded entropy-bottleneck params on the card, every coefficient moved
    off its init value (the factors start at zero)."""
    import torch

    from lossyless_tpu_torch.coding import entropy_bottleneck as eb

    g = torch.Generator().manual_seed(seed)
    p = eb.init_params(eb.EBConfig(C, tuple(filters)), g)
    return {k: (v if k == "quantiles" else
                v + 0.3 * torch.randn(v.shape, generator=g)).cuda()
            for k, v in p.items()}


def mlp_inputs(B: int, N: int, D: int, seed: int, offset: bool = False):
    """x (B, N, D) bf16 and the block's weights, CLIP-init scales.
    `offset`: x and fc_w (then bf16) are views 16 bytes into their
    storage (aligned as TMA and the 16-byte loads need, but not to the
    allocator's 256 bytes)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * std + mean

    def shifted(t):   # the same values at a 16-byte storage offset
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")
        view = flat[8:].view(t.shape)
        view.copy_(t)
        return view

    H = 4 * D
    x, lns, lnb, fc_w, fc_b, pr_w, pr_b = (
        rnd(B, N, D, std=0.5).to(torch.bfloat16), rnd(D, std=0.1, mean=1),
        rnd(D, std=0.1), rnd(D, H, std=0.02), rnd(H, std=0.02),
        rnd(H, D, std=0.02), rnd(D, std=0.02))
    if offset:
        x, fc_w = shifted(x), shifted(fc_w.to(torch.bfloat16))
    return x, lns, lnb, fc_w, fc_b, pr_w, pr_b


# Phase 3b's K4 cases: (B, N, D, options), H = 4 D; option "offset": x and
# fc_w at a 16-byte storage offset (`mlp_inputs`).
K4_CHECKS = [
    (TRAIN_BATCH, 50, 768, {}),              # the slice shape
    (3, 7, 64, {}),                          # M = 21: one partial row tile
    (1, 3, 96, {}),                          # D not x64: mma.sync design
    (2, 9, 72, {}),
    (129, 50, 768, {}),                      # a ragged last 128-row tile
    (3, 50, 768, {"offset": True}),
]


def k4_design(D: int) -> str:
    """The design phase 3b expects `k4_plan` to pick (H = 4 D)."""
    return "wgmma" if D % 64 == 0 else "mma_sync"


def k4_library_smem(lib, plan, D: int) -> list[tuple[int, int]]:
    """(plan's, library's) shared memory bytes of each kernel the plan
    launches with shared memory."""
    if plan.design == "mma_sync":
        return [(plan.smem, lib.lossyless_mlp_block_smem_bytes(D))]
    return [(p.smem, lib.lossyless_mlp_block_tile_smem_bytes(p.n_tile,
                                                               p.stages))
            for p in (plan.fc, plan.proj)]


def check_k4_quick_gelu(lib) -> int:
    """K4's QuickGELU (the fc product's epilogue) at every one of the
    65,536 bf16 values against the plain version's, bit for bit (NaN
    where it is NaN): with zero fc weights the hidden is QuickGELU(fc_b),
    and fc_b holds every bf16 bit pattern. Through the library, for its
    scratch hidden; returns the values that differ (0, or it raises)."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    M, D, H = 1, 64, 1 << 16
    bf16, dev = torch.bfloat16, "cuda"
    fc_b = torch.arange(H, dtype=torch.int32, device=dev).to(
        torch.int16).view(bf16)
    ins = [torch.randn(M, D, device=dev).to(bf16),
           torch.ones(D, device=dev), torch.zeros(D, device=dev),
           torch.zeros(D, H, dtype=bf16, device=dev), fc_b,
           torch.zeros(H, D, dtype=bf16, device=dev),
           torch.zeros(D, dtype=bf16, device=dev)]
    y = torch.empty(M, D, dtype=bf16, device=dev)
    hidden = torch.empty(M, H, dtype=bf16, device=dev)
    out = torch.empty(M, D, dtype=bf16, device=dev)
    plan = fa.k4_plan(M, D, H)
    fa._raise_on(lib.lossyless_fused_mlp_block_tile(
        *(t.data_ptr() for t in ins), y.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), M, D, H, 1e-5, plan.fc.args(), plan.proj.args(),
        0, torch.cuda.current_stream().cuda_stream), "K4 QuickGELU check")
    torch.cuda.synchronize()
    got = hidden[0]
    want = fa.quick_gelu_plain(torch.zeros(H, dtype=bf16, device=dev)
                               + fc_b)
    nan = torch.isnan(want)
    bad = (torch.isnan(got) != nan) | (~nan & (got.view(torch.int16)
                                               != want.view(torch.int16)))
    n_bad = int(bad.sum())
    print(f"check K4 QuickGELU at all {H} bf16 values: {n_bad} differ "
          f"from the plain version {'ok' if not n_bad else 'FAIL'}",
          flush=True)
    if n_bad:
        i = torch.nonzero(bad)[:8, 0]
        raise AssertionError(f"K4's QuickGELU differs at {n_bad} bf16 "
                             f"inputs, e.g. {fc_b[i].tolist()} -> "
                             f"{got[i].tolist()} vs {want[i].tolist()}")
    return n_bad


def mma_sync_k4(lib, args):
    """A function that runs K4's mma.sync design (the one before the wgmma
    design, kept for the shapes the wgmma design does not take) on `args`
    through the library itself: for timing beside the wgmma design on the
    same inputs, outside the wrapper and its launch count."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    x, lns, lnb, fcw, fcb, prw, prb = args
    D, H = fcw.shape
    bf16 = torch.bfloat16
    ins = [x.reshape(-1, D).contiguous(), lns.float().contiguous(),
           lnb.float().contiguous(), *(t.to(bf16).contiguous()
                                       for t in (fcw, fcb, prw, prb))]
    out = torch.empty_like(ins[0])
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch():
        fa._raise_on(lib.lossyless_fused_mlp_block(
            *(t.data_ptr() for t in ins), out.data_ptr(), ins[0].shape[0],
            D, H, 1e-5, x.device.index, stream), "mma.sync K4")
        return out.view(x.shape)
    return launch


def op_path_mlp(x, lns, lnb, fcw, fcb, prw, prb):
    """The MLP half-block as the tower's ops compute it (`Block`, ops path):
    the yardstick K4 replaces."""
    import torch
    import torch.nn.functional as F

    dt = x.dtype
    y = F.layer_norm(x.float(), (x.shape[-1],), lns, lnb, 1e-5).to(dt)
    h = y @ fcw + fcb
    h = h * torch.sigmoid(1.702 * h)
    return x + (h @ prw + prb)


# Phase 3b's K3 cases: (B, C, filters): the training shape, odd shapes on
# the fixed and the generic chains, one element; the backward also at the
# side latent of clip_bottleneck_pretrain
K3_CHECKS = [(TRAIN_BATCH, 512, (3, 3, 3, 3)), (37, 13, (3, 3, 3)),
             (5, 130, (2, 4)), (1, 1, (3, 3, 3, 3)),
             # the banana path's z: banana_viz_VIC (z = 2), _BINCE (z = 1);
             # one 32-channel group with 30 or 31 channels empty
             (1024, 2, (3, 3, 3)), (1024, 1, (3, 3, 3)),
             # the image path's side latent: z = 128 -> 25 channels at
             # batch 256, one 32-channel group
             (256, 25, (3, 3, 3, 3)),
             # the STL10 path: stl10_balle's side latent, 64 images x 8 x 8
             # positions folded into rows (one cluster owns every row),
             # and stl10_bince's factorized z = 128 at batch 256
             (4096, 25, (3, 3, 3)), (256, 128, (3, 3, 3)),
             # the ssl path's side latent at batch 128: z = 1024 (CLIP
             # RN50) -> 204 channels, z = 2048 (SimCLR / SwAV) -> 409
             (TRAIN_BATCH, 204, (3, 3, 3)), (TRAIN_BATCH, 409, (3, 3, 3)),
             # the galaxy path's side latent: galaxy_regression's 128
             # images x 8 x 8 positions folded into rows
             (128 * 64, 25, (3, 3, 3)),
             # phase 18b's example: minimal_code_torch's z = 64 at batch
             # 256, two 32-channel groups
             (256, 64, (3, 3, 3, 3))]
BANANA_K3 = K3_CHECKS[4:6]
IMAGE_K3 = K3_CHECKS[6:7]
STL10_K3 = K3_CHECKS[7:9]
SSL_K3 = K3_CHECKS[9:11]
GALAXY_K3 = K3_CHECKS[11:12]
EXAMPLE_K3 = K3_CHECKS[12:13]
# the |x| tie (ROADMAP queue 3 item 7): one channel, widths (1, 1),
# matrix0 = -30, bias0 = 1, z = 0; JAX's d(-log lik) / d matrix0
K3_TIE_GRAD = 1.8398e-5
K3_BWD_CHECKS = K3_CHECKS[:7] + [(TRAIN_BATCH, 102, (3, 3, 3, 3))] + \
    STL10_K3 + SSL_K3 + GALAXY_K3 + EXAMPLE_K3


def k3_design(filters) -> str:
    """The design phase 3b expects `k3_plan` to pick."""
    filters = tuple(filters)
    if filters in ((3, 3, 3, 3), (3, 3, 3)):
        return f"fixed{filters}"
    return "generic"


def k3_floor_inputs(p: dict, z, g):
    """Rows 0 and 1 of z moved, on every channel that has one, to a value
    whose raw likelihood is below 1e-10 but not 0 (it floors and the
    sigmoids' slopes are not 0), with g = +1e9 on row 0 and -1e9 on row 1
    (-d log(lik) at the floor, both signs; one row: -1e9). Returns the mask
    of floored elements given g > 0."""
    import torch

    from lossyless_tpu_torch.coding import entropy_bottleneck as eb

    B, C = z.shape
    grid = torch.arange(2.0, 200.0, 0.25, device=z.device)
    lik = eb.likelihood(p, grid[:, None].expand(-1, C).contiguous())
    ok = (lik < 1e-10) & (lik > 0)
    found = ok.any(0)
    tail = grid[ok.float().argmax(0)]
    blocked = torch.zeros_like(z, dtype=torch.bool)
    rows = ((0, 1e9), (1, -1e9)) if B > 1 else ((0, -1e9),)
    for row, sign in rows:
        z[row] = torch.where(found, tail, z[row])
        g[row] = torch.where(found, torch.full_like(tail, sign), g[row])
        if sign > 0:
            blocked[row] = found
    return blocked


def k3_grads(p: dict, z, g) -> dict:
    """{"z": dz, name: grad} of K3 through its autograd wrapper (the kernel
    pair on the card)."""
    import torch

    from lossyless_tpu_torch.coding import eb_kernel

    keys = [name for _, name in eb_kernel.param_slots(p)]
    tp = {k: v.detach().requires_grad_(k in keys) for k, v in p.items()}
    tz = z.detach().requires_grad_(True)
    grads = torch.autograd.grad(eb_kernel.likelihood(tp, tz),
                                [tz] + [tp[k] for k in keys], g)
    return dict(zip(["z"] + keys, grads))


def k3_bwd_flops(widths) -> int:
    """Operations of the backward per element: both chains again, the sign
    trick and the pass-through, and back through both chains (per layer
    the tanh stage's 5 and, per matrix entry, its gradient's multiply-add
    and the input gradient's)."""
    L = len(widths) - 1
    chain = k3_chain_flops(widths)
    back = sum(4 * o * i + o + (5 * o if l < L - 1 else 0)
               for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])))
    return 2 * chain + 20 + 2 * back


def k3_chain_flops(widths) -> int:
    """Operations of one chain (per layer the products and sums of its
    matrix, its bias and, but for the last layer, the tanh stage's 3)."""
    L = len(widths) - 1
    return sum(2 * o * i + o + (3 * o if l < L - 1 else 0)
               for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])))


def check_k3() -> dict:
    """Phase 3b, K3: the forward kernel against its plain version at
    `K3_CHECKS` (rtol 1e-5 / atol 1e-7, the CPU tests'), the backward
    kernel against `likelihood_backward_plain` and against autograd of
    the reference chain at `K3_BWD_CHECKS` (rtol 1e-4, atol 2e-5 of the
    gradient's largest entry, the CPU tests'), on inputs with floored
    likelihoods under g of both signs; two backward calls equal bit for
    bit; then timings of both kernels, their plain versions and the eager
    backward they replace."""
    import torch

    from lossyless_tpu_torch.coding import eb_kernel

    results, errs, bwd_errs, bwd_abs = {}, [], [], []
    for i, (B, C, filters) in enumerate(K3_BWD_CHECKS):
        p = eb_params_for(C, filters, seed=i)
        gen = torch.Generator(device="cuda").manual_seed(i)
        z = torch.randn(B, C, generator=gen, device="cuda") * 4
        plan = eb_kernel.check_params(p, z)
        if plan.design != k3_design(filters):
            raise AssertionError(f"k3_plan picked {plan.design} for "
                                 f"{filters}, expected {k3_design(filters)}")
        if (B, C, filters) in K3_CHECKS:
            with torch.inference_mode():
                got = eb_kernel.likelihood(p, z)
                torch.cuda.synchronize()
                want = eb_kernel.likelihood_plain(p, z)
            err = (got - want).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and bool(
                ((got - want).abs() <= 1e-5 * want.abs() + 1e-7).all())
            print(f"check eb_likelihood B={B} C={C} filters={filters} fp32 "
                  f"{plan.design}: max_abs_err={err!r} tol=rtol 1e-5 atol "
                  f"1e-7 {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"eb_likelihood disagrees with its plain "
                                     f"version at B={B} C={C}")
            errs.append(err)
        g = torch.randn(B, C, generator=gen, device="cuda")
        blocked = k3_floor_inputs(p, z, g)
        got = k3_grads(p, z, g)
        again = k3_grads(p, z, g)
        torch.cuda.synchronize()
        same = all(torch.equal(got[k], again[k]) for k in got)
        dz, grads = eb_kernel.likelihood_backward_plain(p, z, g)
        plain = {"z": dz, **grads}
        dz, grads = k3_eager_backward(p, z, g, plan, True, True)
        auto = {"z": dz, **grads}
        worst = 0.0
        ok = same and bool(torch.all(got["z"][blocked] == 0))
        bwd_abs.append(max((got[k] - plain[k]).abs().max().item()
                           for k in got))
        for ref in (plain, auto):
            for k, want in ref.items():
                e = (got[k] - want).abs()
                atol = 2e-5 * want.abs().max().item()
                ok &= bool(torch.isfinite(got[k]).all()) and bool(
                    (e <= 1e-4 * want.abs() + atol).all())
                worst = max(worst, (e.max() / want.abs().max().clamp_min(
                    1e-30)).item())
        print(f"check eb_likelihood_bwd B={B} C={C} filters={filters} "
              f"{plan.design}: {int(blocked.sum())} floored under g > 0, "
              f"max err / max|grad| {worst!r} (rtol 1e-4, atol 2e-5 of the "
              f"largest entry; vs plain and autograd), bit-equal {same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"eb_likelihood_bwd disagrees at B={B} "
                                 f"C={C} (bit-equal {same})")
        bwd_errs.append(worst)

    B, C = TRAIN_BATCH, 512
    p = eb_params_for(C, (3, 3, 3, 3), seed=100)
    z = torch.randn(B, C, device="cuda") * 4
    g = torch.randn(B, C, device="cuda")
    plan = eb_kernel.check_params(p, z)
    K, w = plan.n_coeffs, plan.widths
    with torch.inference_mode():
        nbytes = 2 * B * C * 4 + C * K * 4
        flops = B * C * (2 * k3_chain_flops(w) + 10)  # two chains, sign, floor
        fwd = lambda: eb_kernel.likelihood(p, z)
        ms = median_ms(fwd)
        dev_ms = device_ms(fwd, ("eb_likelihood_kernel",))
        plain_ms = median_ms(lambda: eb_kernel.likelihood_plain(p, z))
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    results["eb_likelihood"] = dict(
        max_abs_err=errs[0], design=plan.design, warps=plan.threads // 32,
        ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_share(bound_ms, dev_ms or ms), library_ms=None)
    print(f"time eb_likelihood B={B} C={C} fp32 {plan.design}, "
          f"{plan.threads // 32} warps a block: kernel {ms!r} "
          f"ms (device {dev_ms!r} ms), plain {plain_ms!r} ms, bound "
          f"{bound_ms!r} ms ({bound_by}: {nbytes} bytes, {flops} flop)",
          flush=True)

    # the banana path's shapes: both kernels' times and bounds
    results["eb_likelihood"]["banana_shapes"] = {}
    results["eb_likelihood_bwd"] = {"banana_shapes": {}}
    for i, (Bb, Cb, fb) in enumerate(BANANA_K3):
        fwd_t, bwd_t = time_k3_at(Bb, Cb, fb, seed=200 + i)
        results["eb_likelihood"]["banana_shapes"][f"{Bb}x{Cb}"] = fwd_t
        results["eb_likelihood_bwd"]["banana_shapes"][f"{Bb}x{Cb}"] = bwd_t

    # the image path's side latent
    for i, (Bi, Ci, fi) in enumerate(IMAGE_K3):
        fwd_t, bwd_t = time_k3_at(Bi, Ci, fi, seed=300 + i)
        results["eb_likelihood"]["image_shape"] = dict(
            fwd_t, shape=f"{Bi}x{Ci}")
        results["eb_likelihood_bwd"]["image_shape"] = dict(
            bwd_t, shape=f"{Bi}x{Ci}")

    # the STL10 path's shapes
    results["eb_likelihood"]["stl10_shapes"] = {}
    results["eb_likelihood_bwd"]["stl10_shapes"] = {}
    for i, (Bs, Cs, fs) in enumerate(STL10_K3):
        fwd_t, bwd_t = time_k3_at(Bs, Cs, fs, seed=400 + i)
        results["eb_likelihood"]["stl10_shapes"][f"{Bs}x{Cs}"] = fwd_t
        results["eb_likelihood_bwd"]["stl10_shapes"][f"{Bs}x{Cs}"] = bwd_t

    # the ssl path's side latents
    results["eb_likelihood"]["ssl_shapes"] = {}
    results["eb_likelihood_bwd"]["ssl_shapes"] = {}
    for i, (Bs, Cs, fs) in enumerate(SSL_K3):
        fwd_t, bwd_t = time_k3_at(Bs, Cs, fs, seed=500 + i)
        results["eb_likelihood"]["ssl_shapes"][f"{Bs}x{Cs}"] = fwd_t
        results["eb_likelihood_bwd"]["ssl_shapes"][f"{Bs}x{Cs}"] = bwd_t

    # the galaxy path's side latent
    for i, (Bg, Cg, fg) in enumerate(GALAXY_K3):
        fwd_t, bwd_t = time_k3_at(Bg, Cg, fg, seed=600 + i)
        results["eb_likelihood"]["galaxy_shape"] = dict(
            fwd_t, shape=f"{Bg}x{Cg}")
        results["eb_likelihood_bwd"]["galaxy_shape"] = dict(
            bwd_t, shape=f"{Bg}x{Cg}")

    # the example's z
    for i, (Be, Ce, fe) in enumerate(EXAMPLE_K3):
        fwd_t, bwd_t = time_k3_at(Be, Ce, fe, seed=700 + i)
        results["eb_likelihood"]["example_shape"] = dict(
            fwd_t, shape=f"{Be}x{Ce}")
        results["eb_likelihood_bwd"]["example_shape"] = dict(
            bwd_t, shape=f"{Be}x{Ce}")
    results["eb_likelihood_bwd"]["tie"] = check_k3_tie()

    # the backward: the wrapper's launch, its plain version, and the eager
    # backward it replaces
    bwd = lambda: eb_kernel._launch_bwd(p, z, g, plan, True, True)
    eager = lambda: k3_eager_backward(p, z, g, plan, True, True)
    bytes_bwd = 3 * B * C * 4 + 2 * C * K * 4
    flops_bwd = B * C * k3_bwd_flops(w)
    b_ms = median_ms(bwd)
    b_dev = device_ms(bwd, ("eb_likelihood_bwd_kernel",))
    b_plain = median_ms(lambda: eb_kernel.likelihood_backward_plain(p, z, g))
    e_ms = median_ms(eager)
    e_kernels = device_kernel_count(eager)
    e_dev = device_ms(eager)
    b_bound, b_by = bound(bytes_bwd, flops_bwd, "float32")
    results["eb_likelihood_bwd"].update(
        max_abs_err=bwd_abs[0], max_err_over_max=bwd_errs[0],
        design=plan.design, warps=plan.bwd_threads // 32, ms=b_ms,
        device_ms=b_dev, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
        bound_share=bound_share(b_bound, b_dev or b_ms), library_ms=None,
        eager_backward_ms=e_ms, eager_backward_device_ms=e_dev,
        eager_backward_device_kernels=e_kernels)
    print(f"time eb_likelihood_bwd B={B} C={C} fp32 {plan.design}, "
          f"{plan.bwd_threads // 32} warps a block: kernel "
          f"{b_ms!r} ms (device {b_dev!r} ms), plain {b_plain!r} ms, eager "
          f"backward {e_ms!r} ms ({e_kernels} device kernels, device "
          f"{e_dev!r} ms), bound {b_bound!r} ms ({b_by}: {bytes_bwd} bytes, "
          f"{flops_bwd} flop)", flush=True)
    return results


def check_k3_tie() -> dict:
    """The backward kernel at the |x| tie: the chain rounds z - 0.5 and
    z + 0.5 to one logit, so D = 0 while the sigmoids' slopes are not 0;
    d|D| = +1 there, as JAX's, gives d(-log lik) / d matrix0 = 1.8398e-5
    (rtol 1e-4: the constant's digits), equal to the plain backward's."""
    import torch

    from lossyless_tpu_torch.coding import eb_kernel

    p = {"matrix0": torch.full((1, 1, 1), -30.0, device="cuda"),
         "bias0": torch.ones((1, 1, 1), device="cuda")}
    z = torch.zeros(1, 1, device="cuda")
    tp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    lik = eb_kernel.likelihood(tp, z)
    (got,) = torch.autograd.grad(-torch.log(lik).sum(), tp["matrix0"])
    _, plain = eb_kernel.likelihood_backward_plain(
        p, z, -1.0 / eb_kernel.likelihood_plain(p, z))
    got, plain = float(got), float(plain["matrix0"])
    ok = abs(got - K3_TIE_GRAD) <= 1e-4 * K3_TIE_GRAD and \
        abs(got - plain) <= 1e-5 * abs(plain)
    print(f"check eb_likelihood_bwd at the |x| tie: d/d matrix0 {got!r}, "
          f"plain {plain!r}, JAX {K3_TIE_GRAD} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"K3's backward at the tie gives {got}, the "
                             f"plain {plain}, JAX {K3_TIE_GRAD}")
    return dict(d_matrix0=got, plain=plain, jax=K3_TIE_GRAD)


def time_k3_at(B: int, C: int, filters, seed: int) -> tuple[dict, dict]:
    """K3's forward and backward kernels at (B, C): CUDA-event and device
    ms, their plain versions' ms, bounds."""
    import torch

    from lossyless_tpu_torch.coding import eb_kernel

    p = eb_params_for(C, filters, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(B, C, generator=gen, device="cuda") * 4
    g = torch.randn(B, C, generator=gen, device="cuda")
    plan = eb_kernel.check_params(p, z)
    K, w = plan.n_coeffs, plan.widths
    with torch.inference_mode():
        fwd = lambda: eb_kernel.likelihood(p, z)  # noqa: E731
        f_ms, f_dev = median_ms(fwd), device_ms(fwd, ("eb_likelihood_kernel",))
        f_plain = median_ms(lambda: eb_kernel.likelihood_plain(p, z))
    f_bound, f_by = bound(2 * B * C * 4 + C * K * 4,
                          B * C * (2 * k3_chain_flops(w) + 10), "float32")
    bwd = lambda: eb_kernel._launch_bwd(p, z, g, plan, True, True)  # noqa
    b_ms = median_ms(bwd)
    b_dev = device_ms(bwd, ("eb_likelihood_bwd_kernel",))
    b_plain = median_ms(lambda: eb_kernel.likelihood_backward_plain(p, z, g))
    b_bound, b_by = bound(3 * B * C * 4 + 2 * C * K * 4,
                          B * C * k3_bwd_flops(w), "float32")
    rows = []
    for ms, dev, plain_ms, bnd, by in ((f_ms, f_dev, f_plain, f_bound, f_by),
                                       (b_ms, b_dev, b_plain, b_bound, b_by)):
        rows.append(dict(design=plan.design, ms=ms, device_ms=dev,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         bound_share=bound_share(bnd, dev or ms)))
    print(f"time eb_likelihood B={B} C={C} {filters} {plan.design}: "
          f"forward {rows[0]}, backward {rows[1]}", flush=True)
    return rows[0], rows[1]


def k3_eager_backward(params: dict, z, g, plan, want_z: bool,
                      want_params: bool):
    """The backward K3 had before its backward kernel (the port's form of
    the JAX `_bwd`): recompute the reference chain with lower_bound under
    autograd and differentiate it, for the inputs that need a gradient.
    Takes and returns what `eb_kernel._launch_bwd` does."""
    import torch

    from lossyless_tpu_torch.coding import eb_kernel

    names = [k for _, k in eb_kernel.param_slots(params)]
    with torch.enable_grad():
        tz = z.detach().requires_grad_(want_z)
        tp = {k: t.detach().requires_grad_(want_params and k in names)
              for k, t in params.items()}
        inputs = ([tz] if want_z else []) + (
            [tp[k] for k in names] if want_params else [])
        grads = iter(torch.autograd.grad(eb_kernel._reference(tp, tz),
                                         inputs, g))
    dz = next(grads) if want_z else None
    return dz, ({k: next(grads) for k in names} if want_params else None)


def device_kernel_count(fn, reps: int = 5) -> float:
    """Device kernels (and copies) one `fn()` launches, from a
    torch.profiler trace of `reps` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof)) / reps


def check_k3_k4() -> dict:
    """Phase 3b: K3 and K4 vs their plain versions, then timings."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    results = check_k3()
    with torch.inference_mode():
        # K4: bf16, atol 2e-2 plus one bf16 ulp of the value (two roundings
        # of sums taken in another order can each flip an ulp)
        lib = fa._get_mlp_lib()
        errs = []
        for i, (B, N, D, opt) in enumerate(K4_CHECKS):
            args = mlp_inputs(B, N, D, seed=i, **opt)
            plan = fa.k4_plan(B * N, D, 4 * D)
            if plan.design != k4_design(D):
                raise AssertionError(f"K4 at B={B} N={N} D={D}: plan "
                                     f"{plan.design}, expected "
                                     f"{k4_design(D)}")
            smem = k4_library_smem(lib, plan, D)
            if any(ours != theirs for ours, theirs in smem):
                raise AssertionError(f"K4 plan {plan} disagrees with the "
                                     f"library's shared memory {smem}")
            before = fa.LAUNCHES["fused_mlp_block"]
            got = fa.fused_mlp_block(*args)
            torch.cuda.synchronize()
            if fa.LAUNCHES["fused_mlp_block"] != before + 1:
                raise AssertionError("fused_mlp_block did not count its "
                                     "launch")
            want = fa.mlp_block_plain(*args)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool(torch.isfinite(got).all()) and bool(
                (diff <= 2e-2 + 2 ** -7 * want.float().abs()).all())
            if plan.design == "wgmma":
                how = ", ".join(
                    f"{name} {p.grid[0]}x{p.grid[1]} tiles of 128x"
                    f"{p.n_tile} on {p.blocks} blocks ({p.stages} stages, "
                    f"{p.smem} B)"
                    for name, p in (("fc", plan.fc), ("proj", plan.proj)))
            else:
                how = f"{plan.blocks} blocks, {plan.smem} B"
            print(f"check fused_mlp_block B={B} N={N} D={D} bf16 "
                  f"{plan.design} ({how}"
                  f"{', 16-byte offset input' if opt else ''}): "
                  f"max_abs_err={err!r} tol=atol 2e-2 + 1 ulp "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"fused_mlp_block disagrees with its "
                                     f"plain version at B={B} N={N} D={D}")
            errs.append(err)
        check_k4_quick_gelu(lib)
        B, N, D = TRAIN_BATCH, 50, 768
        args = mlp_inputs(B, N, D, seed=100)
        # the ops path holds its weights in bf16, its LayerNorm params fp32
        ops_args = [*args[:3], *(a.to(torch.bfloat16) for a in args[3:])]
        M, H = B * N, 4 * D
        plan = fa.k4_plan(M, D, H)
        nbytes = 2 * M * D * 2 + 2 * D * H * 2 + (H + D) * 2 + 2 * D * 4
        flops = 4 * M * D * H
        kernel = lambda: fa.fused_mlp_block(*args)  # noqa: E731
        ms = median_ms(kernel)
        by_kernel = device_ms_by_kernel(kernel, ("mlp_block_kernel",))
        dev_ms = sum(by_kernel.values()) or None
        # the mma.sync design on the same inputs, in the same run
        mma_sync = mma_sync_k4(lib, args)
        want = fa.mlp_block_plain(*args).float()
        if not bool(((mma_sync().float() - want).abs()
                     <= 2e-2 + 2 ** -7 * want.abs()).all()):
            raise AssertionError("the mma.sync K4 disagrees with its plain "
                                 "version at the slice shape")
        mma_sync_ms = device_ms(mma_sync, ("mlp_block_kernel",))
        plain_ms = median_ms(lambda: fa.mlp_block_plain(*args))
        op_ms = median_ms(lambda: op_path_mlp(*ops_args))
        op_dev_ms = device_ms(lambda: op_path_mlp(*ops_args))
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        share = bound_share(bound_ms, dev_ms or ms)
        results["fused_mlp_block"] = dict(
            max_abs_err=errs[0], design=plan.design,
            n_tiles=dict(fc=plan.fc.n_tile, proj=plan.proj.n_tile),
            stages=dict(fc=plan.fc.stages, proj=plan.proj.stages),
            blocks=dict(fc=plan.fc.blocks, proj=plan.proj.blocks),
            ms=ms, device_ms=dev_ms, device_ms_by_kernel=by_kernel,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_share=share, library_ms=None,
            mma_sync_design_device_ms=mma_sync_ms, op_path_ms=op_ms,
            op_path_device_ms=op_dev_ms)
        print(f"time fused_mlp_block B={B} N={N} D={D} bf16 {plan.design}: "
              f"kernel {ms!r} ms (device {dev_ms!r} ms: {by_kernel}), "
              f"mma.sync design (device) {mma_sync_ms!r} ms, plain "
              f"{plain_ms!r} ms, op path {op_ms!r} ms (device {op_dev_ms!r} "
              f"ms), bound {bound_ms!r} ms ({bound_by}: {nbytes} bytes, "
              f"{flops} flop), share of bound {share!r}", flush=True)
    return results


# Phase 3d's K6 shapes: the ResNet-18 stem (and layer 1) and layer 4 of
# one view of stl10_bince (256 images of 96 px), channels_last bf16; the
# banana MLP's (1024, 1024) fp32
K6_CHECKS = [((256, 64, 96, 96), "bfloat16"), ((256, 512, 12, 12), "bfloat16"),
             ((1024, 1024), "float32")]
# the least bytes an element a call moves: forward x in and y (fp32) out,
# backward x and dy (fp32) in and dx out, at bf16 and fp32 x
K6_BYTES = {"bfloat16": (6, 8), "float32": (8, 12)}
K6_STEP_LAUNCHES = 40     # BatchNorm calls a stl10_bince step: 20 a view


def k6_inputs(shape, dtype: str, seed: int):
    """x (channels innermost) and an fp32 cotangent of its shape, seeded,
    made on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    fmt = (torch.channels_last if len(shape) == 4
           else torch.contiguous_format)

    def draw():
        t = torch.randn(shape, generator=g, device="cuda") * 1.5 + 0.3
        return t.contiguous(memory_format=fmt)

    return draw().to(getattr(torch, dtype)), draw()


def k6_module(C: int, seed: int):
    """A BatchNorm on the card with seeded parameters and statistics."""
    import torch

    from lossyless_tpu_torch.nn.layers import BatchNorm

    bn = BatchNorm(C).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        bn.scale.copy_(torch.rand(C, generator=g, device="cuda") + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g, device="cuda"))
        bn.mean.copy_(torch.randn(C, generator=g, device="cuda") * 0.2)
        bn.var.copy_(torch.rand(C, generator=g, device="cuda") + 0.5)
    return bn


def k6_run(bn, x, dy, path: str, training: bool = True) -> dict:
    """One call of `path` ("kernel": the module on the card, "eager":
    `BatchNorm.eager`) on x as it is laid out, with its backward: y, dx,
    dscale, dbias and the running statistics after it."""
    xi = x.detach().requires_grad_()
    bn.zero_grad()
    y = bn(xi, training=training) if path == "kernel" else bn.eager(
        xi, training=training)
    y.backward(dy)
    return dict(y=y.detach(), dx=xi.grad, dscale=bn.scale.grad.clone(),
                dbias=bn.bias.grad.clone(), mean=bn.mean.clone(),
                var=bn.var.clone())


def k6_float64(bn, x, dy, training: bool = True) -> dict:
    """The chain of `BatchNorm.eager` in float64, and the running
    statistics it leaves."""
    from lossyless_tpu_torch.nn import layers

    xd = x.detach().double().requires_grad_()
    s = bn.scale.detach().double().requires_grad_()
    b = bn.bias.detach().double().requires_grad_()
    rm, rv = bn.mean.double(), bn.var.double()
    if training:
        mean, var = layers._fast_stats(xd, layers._stat_dims(xd))
    else:
        mean, var = (layers._per_channel(v, xd) for v in (rm, rv))
    y = (xd - mean) * (var + bn.eps).rsqrt() * layers._per_channel(s, xd) \
        + layers._per_channel(b, xd)
    y.backward(dy.double())
    if training:
        m = layers.BN_MOMENTUM
        rm = rm * m + (1 - m) * mean.detach().reshape(-1)
        rv = rv * m + (1 - m) * var.detach().reshape(-1)
    return dict(y=y.detach(), dx=xd.grad, dscale=s.grad, dbias=b.grad,
                mean=rm, var=rv)


def check_k6() -> dict:
    """Phase 3d: K6 (BatchNorm forward and backward) at `K6_CHECKS`: each
    output's error against the float64 chain at most twice the eager fp32
    chain's (plus 1e-6 of its largest entry), two calls bit-equal, one
    launch a forward and one a backward; then the kernels' event and
    device ms a call, forward and backward, beside the bound by bytes and
    the eager chain's (`plain`) times."""
    import torch

    from lossyless_tpu_torch.nn import bn_kernel

    results = {}
    for i, (shape, dtype) in enumerate(K6_CHECKS):
        x, dy = k6_inputs(shape, dtype, seed=60 + i)
        C = shape[1]
        rows = x.numel() // C
        ref = k6_float64(k6_module(C, i), x, dy)
        before = dict(bn_kernel.LAUNCHES)
        got = [k6_run(k6_module(C, i), x, dy, "kernel") for _ in range(2)]
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in bn_kernel.LAUNCHES.items()}
        eager = k6_run(k6_module(C, i), x, dy, "eager")
        errs = {k: (float((got[0][k].double() - want).abs().max()),
                    float((eager[k].double() - want).abs().max()))
                for k, want in ref.items()}
        bad = [k for k, (ek, ee) in errs.items()
               if not ek <= 2 * ee + 1e-6 * float(ref[k].abs().max())]
        unequal = [k for k in got[0] if not torch.equal(got[0][k], got[1][k])]
        plan = bn_kernel.bn_plan(rows, C, dtype, True,
                                 bn_kernel._sm_count(x.device))
        print(f"check batchnorm {shape} {dtype} ({plan}): max abs err "
              f"(kernel, eager) against float64 {errs}; launches "
              f"{launched}; two calls bit-equal: {not unequal}", flush=True)
        if bad or unequal or launched != {"batchnorm": 2, "batchnorm_bwd": 2}:
            raise AssertionError(f"K6 at {shape} {dtype}: off float64 in "
                                 f"{bad}, unequal {unequal}, launches "
                                 f"{launched}")
        del ref, got, eager
        # timings: the forward (no graph kept) and the backward of one kept
        # graph, kernel and eager chain
        bn = k6_module(C, i)
        xi = x.detach().requires_grad_()
        params = [xi, bn.scale, bn.bias]
        timed = {}
        for path in ("kernel", "eager"):
            call = bn if path == "kernel" else bn.eager

            def fwd():
                with torch.no_grad():
                    call(x, training=True)

            y = call(xi, training=True)

            def bwd():
                torch.autograd.grad(y, params, dy, retain_graph=True)

            timed[path] = {}
            for key, fn in (("fwd", fwd), ("bwd", bwd)):
                timed[path].update({f"{key}_ms": median_ms(fn),
                                    f"{key}_kernels": device_kernel_count(fn)})
                if path == "kernel":   # and the split by kernel
                    split = device_ms_by_kernel(fn, ("lossyless_bn",))
                    timed[path][f"{key}_by_kernel"] = split
                    timed[path][f"{key}_device_ms"] = sum(split.values()) \
                        or None
                else:
                    timed[path][f"{key}_device_ms"] = device_ms(fn)
            del y
        k, e = timed["kernel"], timed["eager"]
        per_el = K6_BYTES[dtype]
        for name, key, nbytes in (("batchnorm", "fwd", per_el[0]),
                                  ("batchnorm_bwd", "bwd", per_el[1])):
            bound_ms = x.numel() * nbytes / HBM_BYTES_PER_S * 1e3
            dev = k[f"{key}_device_ms"]
            row = dict(ms=k[f"{key}_ms"], device_ms=dev,
                       device_ms_by_kernel=k[f"{key}_by_kernel"],
                       kernels_per_call=k[f"{key}_kernels"],
                       bound_ms=bound_ms, bound_by="bytes",
                       bound_share=bound_share(bound_ms, dev),
                       plain_ms=e[f"{key}_ms"],
                       plain_device_ms=e[f"{key}_device_ms"],
                       plain_kernels=e[f"{key}_kernels"],
                       max_abs_err=errs, library_ms=None)
            results.setdefault(name, {})[f"{shape}_{dtype}"] = row
            print(f"time {name} {shape} {dtype}: kernel {row['ms']!r} ms "
                  f"(device {dev!r} ms, {row['kernels_per_call']!r} "
                  f"kernels: {row['device_ms_by_kernel']}), bound "
                  f"{bound_ms!r} ms (bytes: "
                  f"{nbytes} B an element), share {row['bound_share']!r}; "
                  f"eager chain {row['plain_ms']!r} ms (device "
                  f"{row['plain_device_ms']!r} ms, "
                  f"{row['plain_kernels']!r} kernels)", flush=True)
    return results


def reset_launches():
    from lossyless_tpu_torch.coding import eb_kernel
    from lossyless_tpu_torch.nn import bn_kernel
    from lossyless_tpu_torch.nn import flash_attn as fa

    for counts in (fa.LAUNCHES, eb_kernel.LAUNCHES, bn_kernel.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    from lossyless_tpu_torch.coding import eb_kernel
    from lossyless_tpu_torch.nn import bn_kernel
    from lossyless_tpu_torch.nn import flash_attn as fa

    return {**fa.LAUNCHES, **eb_kernel.LAUNCHES, **bn_kernel.LAUNCHES}


def check_launches(launches: dict, what: str, batchnorm: bool,
                   k3: bool = True):
    """K3 and its backward launched (with `k3=False`, a plain run's: not
    launched); K6's forward and backward launched where the run trains a
    BatchNorm (`batchnorm`), else not; nothing else."""
    counted = ("eb_likelihood", "eb_likelihood_bwd", *NO_K6)
    others = {k: v for k, v in launches.items() if k not in counted and v}
    k3_ok = min(launches["eb_likelihood"], launches["eb_likelihood_bwd"]) \
        >= 1 if k3 else not (launches["eb_likelihood"]
                             or launches["eb_likelihood_bwd"])
    k6_ok = min(launches["batchnorm"], launches["batchnorm_bwd"]) >= 1 \
        if batchnorm else not any(launches[k] for k in NO_K6)
    if not (k3_ok and k6_ok) or others:
        raise AssertionError(f"{what} launches {launches}")


def count_batchnorms(model) -> int:
    """The BatchNorm modules of `model`: K6's forward launches a forward
    of it."""
    from lossyless_tpu_torch.nn.layers import BatchNorm

    return sum(isinstance(m, BatchNorm) for m in model.modules())


def k6_per_step(run_: dict) -> dict:
    """K6's launches a step of a `timed_main` run's fused epochs."""
    return {k: run_["fused_launches"][k] / run_["steps"] for k in NO_K6}


def train_images(n: int, seed: int, batch: int = TRAIN_BATCH):
    """`n` batches of `batch` seeded random CLIP-normalized 224x224
    images (NHWC) made on the card, with labels and unused aux targets."""
    import torch

    from lossyless_tpu_torch.nn.vit import CLIP_MEAN, CLIP_STD

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mean = torch.as_tensor(CLIP_MEAN, device=DEVICE)
    std = torch.as_tensor(CLIP_STD, device=DEVICE)
    out = []
    for i in range(n):
        x = torch.rand(batch, 224, 224, 3, generator=g, device=DEVICE)
        y = torch.arange(i * batch, (i + 1) * batch, device=DEVICE)
        out.append(((x - mean) / std, y, torch.zeros(batch, device=DEVICE)))
    return out


class PlainMlp:
    """Inside the block, the MLP on K4's plain version (for the A/B run)."""

    def __enter__(self):
        from lossyless_tpu_torch.nn import flash_attn as fa
        from lossyless_tpu_torch.nn import vit

        self.saved = vit.fused_mlp_block
        vit.fused_mlp_block = fa.mlp_block_plain

    def __exit__(self, *exc):
        from lossyless_tpu_torch.nn import vit

        vit.fused_mlp_block = self.saved


def train_path(card: str):
    """Phase 5: the clip_hub recipe at full width on the kernels."""
    import torch

    from lossyless_tpu_torch.pipeline import config
    from lossyless_tpu_torch.pipeline.run import run_featurizer

    cfg = config.apply_overrides(config.preset("clip_hub"), TRAIN_OVERRIDES
                                 + [f"out_dir={OUT_DIR}"])
    cfg.in_shape = (224, 224, 3)
    batches = train_images(TRAIN_STEPS + PROFILE_STEPS, seed=7)
    step_s, last = [], {}
    t_prev = [0.0]

    def on_step(step, state, logs):
        sync()
        now = time.perf_counter()
        step_s.append(now - t_prev[0])
        t_prev[0] = now
        last.update(logs)

    reset_launches()
    t_prev[0] = time.perf_counter()
    state = run_featurizer(cfg, batches[:TRAIN_STEPS],
                           total_steps=TRAIN_STEPS, on_step=on_step,
                           device=DEVICE)
    launches = read_launches()
    print(f"training path launches over {TRAIN_STEPS} steps: {launches}",
          flush=True)
    L = cfg.encoder.arch_kwargs.get("layers", 12)
    want = {"fused_attention": (L - 1) * TRAIN_STEPS,
            "fused_attention_cls": TRAIN_STEPS,
            "fused_mlp_block": (L - 1) * TRAIN_STEPS,
            "eb_likelihood": TRAIN_STEPS, "eb_likelihood_bwd": TRAIN_STEPS,
            **NO_K5, **NO_BF16, **NO_K6}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    logs = {k: float(v) for k, v in last.items()}
    if not all(np.isfinite(logs[k]) for k in ("loss", "rate", "distortion")):
        raise AssertionError(f"non-finite training logs {logs}")
    steady = step_s[2:]   # the first steps include cuBLAS and kernel set-up
    step_ms = float(np.median(steady)) * 1e3
    result = dict(card=card, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                  step_ms_median=step_ms,
                  step_ms_all=[t * 1e3 for t in step_s],
                  img_per_s=TRAIN_BATCH / (step_ms / 1e3),
                  final_logs=logs,
                  launches_per_step={k: v / TRAIN_STEPS
                                     for k, v in launches.items()})
    print(json.dumps({"training_path": result}), flush=True)

    prof = device_profile(
        lambda: run_featurizer(cfg, batches[TRAIN_STEPS:], state=state,
                               log=lambda _: None, device=DEVICE),
        card, steps=PROFILE_STEPS, batch=TRAIN_BATCH)
    print(json.dumps({"training_profile": prof}), flush=True)
    print(f"device kernels a training step (clip_hub, phase 5 trace): "
          f"{prof['device_kernels_per_step']!r}", flush=True)
    train_ab(cfg, batches[:AB_STEPS])
    return state, launches


CLIP_PLAIN = ("rate.eb_use_pallas=False",
              "encoder.arch_kwargs.attn_impl=einsum")


K3_BOTH = ("eb_likelihood", "eb_likelihood_bwd")
CLIP_KERNELS = ("fused_attention", "fused_attention_cls", *K3_BOTH)


def train_ab(cfg, batches, plain=CLIP_PLAIN,
             label="training_kernels_vs_plain",
             need=(*CLIP_KERNELS, "fused_mlp_block")) -> dict:
    """Phase 5c: 3 steps on the kernels and 3 on the plain versions (the
    `plain` overrides, the MLP on K4's plain version), from the same
    weights and the same noise; the record printed under `label`. The
    kernels run must launch each kernel of `need` at least once a step,
    the plain run nothing but K6 (BatchNorm has no plain switch), K6 as
    often in both runs."""
    import contextlib
    import copy

    from lossyless_tpu_torch.pipeline import config
    from lossyless_tpu_torch.pipeline.run import build_state, run_featurizer

    plain_cfg = config.apply_overrides(cfg, list(plain))
    runs, k6 = {}, {}
    init = None
    for name, c in (("kernels", cfg), ("plain", plain_cfg)):
        state = build_state(config.apply_precision(copy.deepcopy(c)),
                            AB_STEPS, device=DEVICE)
        if init is None:
            init = {k: v.clone() for k, v in
                    state.model.state_dict().items()}
        state.model.load_state_dict(init)
        logs = []
        reset_launches()
        with PlainMlp() if name == "plain" else contextlib.nullcontext():
            run_featurizer(c, batches, state=state, log=lambda _: None,
                           device=DEVICE, on_step=lambda s, st, lg: logs.append(
                               {k: float(lg[k]) for k in
                                ("loss", "rate", "distortion")}))
        launched = read_launches()
        k6[name] = {k: launched[k] for k in NO_K6}
        if name == "plain" and any(v for k, v in launched.items()
                                   if k not in NO_K6):
            raise AssertionError(f"the plain run launched {launched}")
        if name == "kernels":
            kernel_launches = {k: v for k, v in launched.items() if v}
            short = [k for k in need if launched[k] < len(batches)]
            if short:
                raise AssertionError(
                    f"{label}: the kernels run launched {launched}, fewer "
                    f"than one a step of {short}")
        runs[name] = logs
    if k6["kernels"] != k6["plain"]:
        raise AssertionError(f"{label}: K6 launched {k6}")
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for a, b in zip(runs["kernels"], runs["plain"]) for k in a)
    out = dict(steps=len(batches), kernels=runs["kernels"],
               plain=runs["plain"], kernels_run_launches=kernel_launches,
               k6_launches_each_run=k6["kernels"], max_rel_diff=worst,
               tolerance=1e-2)
    print(json.dumps({label: out}), flush=True)
    if not worst <= 1e-2:
        raise AssertionError(f"{label}: kernels vs plain training logs "
                             f"differ by {worst} relative")
    return out


def train_to_serve(state, card: str):
    """Phase 6: save_hub -> load_hub_npz -> ClipCompressor -> encode and
    decode one batch."""
    import copy

    from lossyless_tpu_torch.hub.compressor import ClipCompressor
    from lossyless_tpu_torch.hub.save_hub import load_hub_npz, save_hub

    (x, _, _), = train_images(1, seed=11)
    with tempfile.TemporaryDirectory() as tmp:
        out = save_hub(state.model, tmp, beta=0.05)
        files = sorted(p.name for p in out.iterdir())
        eb_params, scaling, biasing = load_hub_npz(
            out / "factorized_rate.npz")
        # the trained tower's architecture and weights (bf16 storage, as
        # the compressor keeps its tower)
        tower = state.model.p_ZlX.mapper
        comp = ClipCompressor(eb_params, scaling, biasing,
                              clip_params=tower.state_dict(),
                              model=copy.deepcopy(tower), device=DEVICE)
        data, labels = Path(tmp) / "z.bin", Path(tmp) / "y.npy"
        y = np.arange(TRAIN_BATCH)
        rate, _ = comp.compress_dataset(iter([(x, y)]), data, labels,
                                        is_info=False)
        z_hat, y_dec = comp.decompress_dataset(data, labels, is_info=False)
    features = comp(x)
    err = float(np.abs(z_hat - features).max())
    ok = (z_hat.shape == (TRAIN_BATCH, 512) and np.isfinite(z_hat).all()
          and np.array_equal(y_dec, y) and err <= 1e-5)
    print(json.dumps({"train_to_serve": dict(
        card=card, files=files, bits_per_img=rate, decode_max_abs_err=err, ok=ok)}), flush=True)
    if not ok:
        raise AssertionError(f"trained compressor round trip off by {err}")


def slice_path(card: str) -> dict:
    """Phase 8: the CLIP bottleneck with the hyperprior rate
    (`clip_bottleneck_pretrain`, K3 on the side bottleneck), trained,
    A/B'd under the attention knobs, and coded for real by the
    communication stage under each knob. Returns the launch counts of the
    whole phase and the K5a/K5b launches per step under their knobs."""
    import torch

    from lossyless_tpu_torch.compressors.rates import HyperpriorCoder
    from lossyless_tpu_torch.pipeline import config
    from lossyless_tpu_torch.pipeline.run import (build_state,
                                                  run_communication,
                                                  run_featurizer)
    from lossyless_tpu_torch.train.checkpoints import is_stage_done

    cfg = config.apply_overrides(config.preset("clip_bottleneck_pretrain"), [
        "rate.eb_use_pallas=True", "trainer.log_every=5",
        f"out_dir={OUT_DIR}"])
    cfg.in_shape = (224, 224, 3)
    batches = train_images(TRAIN_STEPS + PROFILE_STEPS, seed=17)
    L = cfg.encoder.arch_kwargs.get("layers", 12)
    reset_launches()     # the slice's main path: everything below

    # 8a. training, 20 steps on the default kernels
    step_s, last, t_prev = [], {}, [0.0]

    def on_step(step, state, logs):
        sync()
        now = time.perf_counter()
        step_s.append(now - t_prev[0])
        t_prev[0] = now
        last.update(logs)

    t_prev[0] = time.perf_counter()
    state = run_featurizer(cfg, batches[:TRAIN_STEPS],
                           total_steps=TRAIN_STEPS, on_step=on_step,
                           log=lambda _: None, device=DEVICE)
    launches = read_launches()
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    want = {"fused_attention": L - 1, "fused_attention_cls": 1,
            "eb_likelihood": 1, "eb_likelihood_bwd": 1, "fused_mlp_block": 0,
            **NO_K5, **NO_BF16, **NO_K6}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    keys = ("loss", "rate", "H_q_S", "H_q_ZlS", "distortion")
    logs = {k: float(last[k]) for k in keys}
    if not all(np.isfinite(v) for v in logs.values()):
        raise AssertionError(f"non-finite training logs {logs}")
    step_ms = float(np.median(step_s[2:])) * 1e3
    print(json.dumps({"slice_training": dict(
        card=card, preset="clip_bottleneck_pretrain",
        side_z_dim=state.model.rate_estimator.side_z_dim,
        batch=TRAIN_BATCH, steps=TRAIN_STEPS, step_ms_median=step_ms,
        step_ms_all=[t * 1e3 for t in step_s],
        img_per_s=TRAIN_BATCH / (step_ms / 1e3), final_logs=logs,
        launches_per_step=per_step)}), flush=True)

    # 8b. 3 steps from the same weights and noise under each knob
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    runs = {}
    for name, kw in KNOB_RUNS:
        ab = build_state(config.apply_precision(copy.deepcopy(cfg)),
                         AB_STEPS, device=DEVICE)
        ab.model.load_state_dict(init)
        rows, ab_ms, t_ab = [], [], [0.0]

        def on_ab_step(step, st, lg):
            sync()
            now = time.perf_counter()
            ab_ms.append((now - t_ab[0]) * 1e3)
            t_ab[0] = now
            rows.append({k: float(lg[k]) for k in keys})

        before = read_launches()
        with Knobs(**kw):
            t_ab[0] = time.perf_counter()
            run_featurizer(cfg, batches[:AB_STEPS], state=ab,
                           log=lambda _: None, device=DEVICE,
                           on_step=on_ab_step)
        after = read_launches()
        got = {k: (after[k] - before[k]) / AB_STEPS for k in after}
        attn = {"default": "fused_attention", "packed":
                "fused_attention_packed", "headbatched":
                "fused_attention_headbatched"}[name]
        wanted = {k: 0 for k in got} | {
            attn: L - 1, "fused_attention_cls": 1, "eb_likelihood": 1,
            "eb_likelihood_bwd": 1}
        if got != wanted:
            raise AssertionError(f"{name}: launches per step {got}, "
                                 f"expected {wanted}")
        runs[name] = dict(logs=rows, launches_per_step=got, step_ms=ab_ms)
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for name in ("packed", "headbatched")
                for a, b in zip(runs[name]["logs"], runs["default"]["logs"])
                for k in a)
    print(json.dumps({"slice_knob_ab": dict(
        steps=AB_STEPS, runs=runs, max_rel_diff=worst, tolerance=1e-2)}),
        flush=True)
    if not worst <= 1e-2:
        raise AssertionError(f"knob runs differ from the default by {worst}")

    # step ms under each knob, in turns on one state, each round starting
    # one knob later; then a profile under each (a record: the step is
    # host-bound, so its clock spreads from run to run)
    n_knobs = len(KNOB_RUNS)
    timed = build_state(config.apply_precision(copy.deepcopy(cfg)),
                        (TIME_ROUNDS * TIME_STEPS + PROFILE_STEPS) * n_knobs,
                        device=DEVICE)
    timed.model.load_state_dict(init)
    turns = {name: [] for name, _ in KNOB_RUNS}
    for r in range(TIME_ROUNDS):
        for name, kw in KNOB_RUNS[r % n_knobs:] + KNOB_RUNS[:r % n_knobs]:
            ts, t_turn = [], [0.0]

            def on_timed_step(step, st, lg):
                sync()
                now = time.perf_counter()
                ts.append((now - t_turn[0]) * 1e3)
                t_turn[0] = now

            with Knobs(**kw):
                t_turn[0] = time.perf_counter()
                run_featurizer(cfg, batches[:TIME_STEPS], state=timed,
                               log=lambda _: None, device=DEVICE,
                               on_step=on_timed_step)
            turns[name].append(ts)
    profiles = {}
    for name, kw in KNOB_RUNS:
        with Knobs(**kw):
            prof = device_profile(
                lambda: run_featurizer(cfg, batches[:PROFILE_STEPS],
                                       state=timed, log=lambda _: None,
                                       device=DEVICE), card)
        profiles[name] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "by_group_ms",
            "top_host_ms")}
    print(json.dumps({"slice_knob_step_ms": dict(
        card=card, rounds=TIME_ROUNDS, steps=TIME_STEPS,
        median_after_first={name: float(np.median([t for r in rs
                                                   for t in r[1:]]))
                            for name, rs in turns.items()},
        turns=turns, profile_steps=PROFILE_STEPS, profiles=profiles)}),
        flush=True)

    # 8c. the communication stage on the trained state under each knob
    comm_batches = train_images(COMM_BATCHES, seed=23, batch=COMM_BATCH)
    coder = HyperpriorCoder(state.model.rate_estimator)
    x0 = comm_batches[0][0]
    comm, symbols, z_by_knob = {}, {}, {}
    for name, kw in KNOB_RUNS:
        with Knobs(**kw):
            m = run_communication(cfg, state, comm_batches, device=DEVICE)
            z0 = state.model.encode(x0).float().cpu().numpy()
        syms = coder.encode_symbols(z0)
        symbols[name], z_by_knob[name] = syms, z0
        decoded = coder.decompress(coder.compress(z0))
        err = float(np.abs(decoded - coder.dequantize(*syms)).max())
        comm[name] = dict(
            n_bits=m["test/comm/n_bits"],
            sender_ms_per_img=m["test/comm/sender_time"] * 1e3,
            receiver_ms_per_img=m["test/comm/receiver_time"] * 1e3,
            encoder_ms_per_img=m["test/comm/encoder_time"] * 1e3,
            compress_ms_per_img=m["test/comm/compress_time"] * 1e3,
            decode_vs_dequantize_max_abs_err=err)
        if err > 1e-5 or not np.isfinite(decoded).all():
            raise AssertionError(f"{name}: decode off the host dequantize "
                                 f"by {err}")
    # symbols against K1's: the side latent's, and the main latent's given
    # K1's side information (bounded at 1%). A flipped side symbol
    # re-derives the means of its whole row, so the main symbols each
    # variant codes with its own side latent are reported, not bounded.
    z_k1, side_k1 = symbols["default"]
    for name in ("packed", "headbatched"):
        z_own, side = symbols[name]
        z_same_side, _ = coder.encode_symbols(z_by_knob[name], side_k1)
        flips = dict(side=float((side != side_k1).mean()),
                     main_given_k1_side=float((z_same_side != z_k1).mean()),
                     main_own_side=float((z_own != z_k1).mean()))
        comm[name]["symbol_flip_fraction_vs_k1"] = flips
        if max(flips["side"], flips["main_given_k1_side"]) > 0.01:
            raise AssertionError(f"{name}: symbols flip {flips}")
    sentinel = is_stage_done(cfg.stage_dir, "communication")
    print(json.dumps({"slice_communication": dict(
        card=card, batches=COMM_BATCHES, batch=COMM_BATCH, by_knob=comm,
        sentinel=sentinel)}), flush=True)
    if not sentinel:
        raise AssertionError("the communication sentinel was not written")
    slice_launches = read_launches()

    # 8d. where a training step's time goes (after the timed runs)
    prof = device_profile(
        lambda: run_featurizer(cfg, batches[TRAIN_STEPS:], state=state,
                               log=lambda _: None, device=DEVICE),
        card, steps=PROFILE_STEPS, batch=TRAIN_BATCH)
    print(json.dumps({"slice_training_profile": prof}), flush=True)
    print(f"device kernels a training step (clip_bottleneck_pretrain, phase "
          f"8d trace): {prof['device_kernels_per_step']!r}", flush=True)
    under_knob = {"fused_attention_packed": runs["packed"][
        "launches_per_step"]["fused_attention_packed"],
        "fused_attention_headbatched": runs["headbatched"][
        "launches_per_step"]["fused_attention_headbatched"]}
    return slice_launches, under_knob


KNOB_RUNS = (("default", {}), ("packed", dict(IMAGE_PACK=K5_MAIN_PACK)),
             ("headbatched", dict(HEAD_BATCH=True)))
COMM_BATCHES, COMM_BATCH = 4, 256
OUT_DIR = None     # a temporary directory for the stages' files (main)


# K1's tiles (the TMA/wgmma tile, the one-pass tile) also run K5a and K5b
# at bf16 N <= 64: under those knobs their time lands in "attention K1/K2"
KERNEL_GROUPS = {"attention K5a/K5b": ("packed_attention",
                                       "headbatched_attention"),
                 "attention K1/K2": ("attention_kernel", "attention_tile",
                                     "k5_onepass"),
                 "mlp K4": ("mlp_block_kernel",),
                 "likelihood K3": ("eb_likelihood_kernel",
                                   "eb_likelihood_bwd_kernel"),
                 # the STL10 chain's resampling (resize_crop), flips and
                 # the colour jitter's roll; its elementwise steps are in
                 # "other"
                 "augmentation": ("grid_sampler", "roll_cuda_kernel",
                                  "flip_kernel"),
                 # cuDNN's convolutions (forward, data and weight
                 # gradients) before the matmuls: both may be xmma/cutlass
                 "convolution": ("conv", "fprop", "dgrad", "wgrad",
                                 "implicit_gemm", "cudnn", "winograd"),
                 "matmul": ("gemm", "xmma", "cutlass", "nvjet", "cublas"),
                 "copies": ("memcpy", "memset")}


def device_profile(fn, card: str, **fields) -> dict:
    """Run `fn()` under torch.profiler; the device time by kernel group, the
    device idle share against the host clock around the call (which ends
    in a synchronize) and the host ops of most self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    by_name = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    busy_ms = sum(by_name.values())
    n_kernels = sum(e.count for e in kernels)   # kernels and copies
    by_group = dict.fromkeys([*KERNEL_GROUPS, "other"], 0.0)
    for name, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS.items()
                      if any(k in name.lower() for k in keys)), "other")
        by_group[group] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return dict(
        card=card, **fields, wall_ms=wall_ms,
        device_busy_ms=busy_ms if busy_ms else "not measured",
        device_kernels=n_kernels,
        device_kernels_per_step=n_kernels / fields["steps"]
        if "steps" in fields else None,
        device_idle_share=1 - busy_ms / wall_ms if busy_ms else
        "not measured", by_group_ms=by_group,
        top_kernels_ms=[[name[:80], ms] for name, ms in top],
        top_host_ms=[[e.key[:80], e.self_cpu_time_total / 1e3, e.count]
                     for e in host])


def profile_encode(comp, batches, card: str):
    """Phase 4b: where the encode time goes, from a torch.profiler trace of
    `compress_dataset` over a few batches (after the timed run, so the
    profiler's cost is not in the img/s above)."""
    with tempfile.TemporaryDirectory() as tmp:
        result = device_profile(
            lambda: comp.compress_dataset(iter(batches), Path(tmp) / "p.bin",
                                          is_info=False),
            card, images=sum(len(x) for x, _ in batches))
    print(json.dumps({"profile": result}), flush=True)


def k1_k2_kernel(fn: str) -> str | None:
    """The wrapper (K1 or K2) whose kernel a compiled function's name,
    mangled or demangled, belongs to (K1: its tile, its one-pass tile, its
    row code); None for the other kernels."""
    if "k2_attention_kernel" in fn:
        return "fused_attention_cls"
    if any(k in fn for k in ("attention_tile_kernel", "k5_onepass")) or (
            "attention_kernel" in fn and not any(
                k in fn for k in ("packed", "headbatched"))):
        return "fused_attention"
    return None


def bf16_softmax_instance(fn: str) -> bool:
    """Whether a compiled attention function (demangled) is a bf16-softmax
    instantiation: its template's last argument, `kBf16Sm`, is true."""
    import re

    m = re.search(r"_kernel<([^<>]*)>", fn)
    return bool(m) and m.group(1).split(",")[-1].strip() == "true"


def k5_kernel(fn: str, name: str) -> bool:
    """Whether a compiled function, mangled or demangled, is one of the
    kernels wrapper `name` (K5a or K5b) launches: K1's two tiles, which
    both share, or its own two-pass / fp32 kernel."""
    own = {"fused_attention_packed": "packed_attention",
           "fused_attention_headbatched": "headbatched_attention"}[name]
    return any(k in fn for k in ("attention_tile_kernel", "k5_onepass",
                                 own))


def ptxas_report(log: str) -> dict:
    """Per kernel of an `nvcc -Xptxas -v` log: registers, stack frame and
    spill bytes and static shared memory, keyed on the demangled name where
    c++filt is present."""
    import re
    import shutil

    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[fn]["stack_frame"] = int(m.group(1))
            report[fn]["spill_stores"] = int(m.group(2))
            report[fn]["spill_loads"] = int(m.group(3))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            report[fn]["static_smem"] = int(m.group(1))
    if report and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(report),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(report):
            report = dict(zip(names, report.values()))
    return report


ROOT = Path(__file__).resolve().parent

# ---------------------------------------------------------------------------
# Phase 9: the CLI, in subprocesses, on the card
# ---------------------------------------------------------------------------

CLI_IMAGES = 2 * BATCH
# points the CLI's `--beta` names at a directory: the published rate files
# are not in the checkout, and nothing is written under its `reference/`
CLI_LAUNCHER = ("import sys; from pathlib import Path; "
                "from lossyless_tpu_torch.hub import load_reference as r; "
                "r.REFERENCE_HUB = Path(sys.argv[1]); "
                "from lossyless_tpu_torch.hub.cli import main; "
                "sys.exit(main(sys.argv[2:]))")


def write_rate_file(path: Path):
    """A factorized rate in the published `factorized_rate.pt` layout (the
    keys `hub/load_reference.py` reads), from phase 4's seeded
    parameters and affine."""
    import torch

    from lossyless_tpu_torch.coding import entropy_bottleneck as eb

    rng = np.random.default_rng(0)
    params = eb.init_params(eb.EBConfig(512),
                            torch.Generator().manual_seed(0))
    sd = {"entropy_bottleneck." + (k if k == "quantiles" else f"_{k}"): v
          for k, v in params.items()}
    sd["scaling"] = torch.from_numpy(
        rng.normal(1.5, 0.2, 512).astype(np.float32))
    sd["biasing"] = torch.from_numpy(
        rng.normal(0.0, 0.1, 512).astype(np.float32))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)


def run_cli(hub: Path, *args) -> str:
    """`python -m lossyless_tpu_torch.hub.cli *args` with `--beta` names
    resolving under `hub`; its last printed line."""
    out = subprocess.run([sys.executable, "-c", CLI_LAUNCHER, str(hub),
                          *map(str, args)], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    if out.returncode:
        raise AssertionError(f"cli {args[0]} exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    return out.stdout.strip().splitlines()[-1]


def cli_path(card: str):
    """Phase 9: compress a .npz of raw 96 px images with resize and
    normalize on the card, then info, then decompress; the decoded
    features against the in-process dequantize path, the printed rate
    against info's bits."""
    import re

    from lossyless_tpu_torch.hub.compressor import load_pretrained
    from lossyless_tpu_torch.hub.load_reference import BETA_DIRS

    rng = np.random.default_rng(31)
    x = rng.integers(0, 256, (CLI_IMAGES, *RAW_HW, 3), dtype=np.uint8)
    y = np.arange(CLI_IMAGES)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        hub = tmp / "hub"
        rate_file = hub / BETA_DIRS["b005"] / "factorized_rate.pt"
        write_rate_file(rate_file)
        np.savez(tmp / "in.npz", x=x, y=y)
        data, labels, z_file = tmp / "ds.bin", tmp / "y.npy", tmp / "z.npz"
        t0 = time.perf_counter()
        compress = run_cli(hub, "compress", tmp / "in.npz", data, "--labels",
                           labels, "--device-preprocess", *RAW_HW,
                           "--batch-size", BATCH, "--device", DEVICE)
        t_compress = time.perf_counter() - t0
        info = run_cli(hub, "info", data)
        decompress = run_cli(hub, "decompress", data, z_file, "--labels",
                             labels, "--device", DEVICE)
        z = np.load(z_file)
        z_hat, y_dec = z["z"], z["y"]
        comp = load_pretrained(rate_file, raw_input_hw=RAW_HW, device=DEVICE)
        features = np.concatenate([comp(x[i:i + BATCH])
                                   for i in range(0, CLI_IMAGES, BATCH)])
    m = re.fullmatch(r"Rate: ([\d.]+) bits/img \| Encoding: ([\d.]+) "
                     r"img/sec", compress)
    mi = re.search(r"(\d+) images, ([\d.]+) payload bits/img, ([\d.]+) "
                   r"file bits/img", info)
    if not (m and mi):
        raise AssertionError(f"unexpected CLI lines {compress!r} {info!r}")
    err = float(np.abs(z_hat - features).max())
    n, payload, file_bits = int(mi.group(1)), float(mi.group(2)), \
        float(mi.group(3))
    # compress prints the file's bits an image (JAX's definition); the
    # framing adds a 32-bit length a record and a 32-bit count
    framing = file_bits - payload
    ok = (n == CLI_IMAGES and m.group(1) == mi.group(3)
          and abs(framing - 32 * (1 + 1 / n)) < 0.01
          and z_hat.shape == (CLI_IMAGES, 512) and np.isfinite(z_hat).all()
          and np.array_equal(y_dec, y) and err <= 1e-5)
    print(json.dumps({"cli_path": dict(
        card=card, images=CLI_IMAGES, raw_hw=list(RAW_HW), compress=compress,
        info=info, decompress=decompress, wall_s_compress=t_compress,
        payload_bits_per_img=payload, file_bits_per_img=file_bits,
        decode_vs_dequantize_max_abs_err=err, ok=ok)}), flush=True)
    if not ok:
        raise AssertionError(f"CLI round trip: {compress!r} {info!r} "
                             f"err {err}")


# ---------------------------------------------------------------------------
# Phase 10: the bench, in subprocesses, at a reduced window
# ---------------------------------------------------------------------------

BENCH_WINDOW = 4          # BENCH_N_BATCHES: 4 x 512 images a window
BENCH_KEYS = ("value", "value_spread", "runs", "input", "bits_per_img",
              "rate_is_synthetic", "decode_img_per_sec", "flops_per_img",
              "device_mfu", "vs_baseline")


def bench_path(card: str) -> dict:
    """Phase 10: `python -m lossyless_tpu_torch.bench` in its default mode
    and `--host-fed`; every key of its JSON line, 0 < device_mfu < 1. The
    lines are a record with no speed bound."""
    import os

    env = dict(os.environ, BENCH_N_BATCHES=str(BENCH_WINDOW))
    records = {}
    for mode, extra in (("device_resident", []), ("host_fed",
                                                  ["--host-fed"])):
        out = subprocess.run([sys.executable, "-m",
                              "lossyless_tpu_torch.bench", *extra],
                             env=env, capture_output=True, text=True,
                             timeout=600, cwd=ROOT)
        if out.returncode:
            raise AssertionError(f"bench {mode} exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        lines = out.stdout.strip().splitlines()
        rec = json.loads(lines[-1])
        want = BENCH_KEYS + (("device_capacity_img_per_sec",
                              "whole_run_img_per_sec",
                              "device_capacity_whole_run_img_per_sec")
                             if mode == "device_resident" else ())
        missing = [k for k in want if k not in rec]
        if missing or rec["rate_is_synthetic"] is not True or not \
                0 < rec["device_mfu"] < 1 or {"vs_north_star",
                                              "transfer_bound_tunnel"} & \
                set(rec):
            raise AssertionError(f"bench {mode}: missing {missing} in {rec}")
        records[mode] = dict(card=lines[-2], record=rec)
        print(json.dumps({f"bench_{mode}": records[mode]}), flush=True)
    return records


# ---------------------------------------------------------------------------
# Phase 11: the three-stage pipeline on clip_bottleneck_linear_eval
# ---------------------------------------------------------------------------

PIPELINE_OVERRIDES = ["rate.eb_use_pallas=True",
                      "data_feat.kwargs.synthetic=True",
                      "data_feat.kwargs.synthetic_n=4096",
                      "data_feat.n_epochs=2", "predictor.n_epochs=2"]
PIPELINE_REDUCED = {
    "images": "4,096 seeded synthetic STL10-shaped images (96 px, 10 "
              "classes; train/validation carved 90/10, test 4,096) in "
              "place of the STL10 files, which are not in the checkout",
    "featurizer_epochs": "2 of 10", "predictor_epochs": "2 of 20",
    "widths": "none cut: ViT-B/32 768 wide, 12 layers, 12 heads"}
RESUME_IMAGES = 1024


class CountForwards:
    """Counts the tower's forwards (each launches K1 11 and K2 once)."""

    def __enter__(self):
        from lossyless_tpu_torch.nn.vit import VisionTransformer

        self.n = 0
        self.saved = VisionTransformer.forward

        def forward(module, x):
            self.n += 1
            return self.saved(module, x)

        VisionTransformer.forward = forward
        return self

    def __exit__(self, *exc):
        from lossyless_tpu_torch.nn.vit import VisionTransformer

        VisionTransformer.forward = self.saved


class CountTrainSteps:
    """Counts training steps on both paths: the host-fed loop
    (`run.train_step`) and the fused epoch (`state.train_step`)."""

    def __enter__(self):
        from lossyless_tpu_torch.pipeline import run
        from lossyless_tpu_torch.train import state

        self.n = 0
        self.saved = state.train_step

        def step(*a, **k):
            self.n += 1
            return self.saved(*a, **k)

        run.train_step = state.train_step = step
        return self

    def __exit__(self, *exc):
        from lossyless_tpu_torch.pipeline import run
        from lossyless_tpu_torch.train import state

        run.train_step = state.train_step = self.saved


def pipeline_path(card: str) -> dict:
    """Phase 11: `main(preset("clip_bottleneck_linear_eval"))` at full
    width (featurizer with validation and checkpoints, communication,
    predictor), a second `main` that skips every stage, and a featurizer
    stage killed after its first `save_last` that resumes there. Returns
    the first `main`'s launch counts."""
    from lossyless_tpu_torch.pipeline import config, run
    from lossyless_tpu_torch.train.checkpoints import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        cfg = config.apply_overrides(
            config.preset("clip_bottleneck_linear_eval"),
            PIPELINE_OVERRIDES + [f"out_dir={tmp}/out",
                                  f"ckpt_dir={tmp}/ckpt"])
        reset_launches()
        with CountForwards() as fw, CountTrainSteps() as ts:
            t0 = time.perf_counter()
            metrics = run.main(cfg, device=DEVICE)
            sync()
            wall = time.perf_counter() - t0
        launches = read_launches()
        want = {**dict.fromkeys(launches, 0), "fused_attention": 11 * fw.n,
                "fused_attention_cls": fw.n}
        got = {k: v for k, v in launches.items()
               if not k.startswith("eb_likelihood")}
        if got != {k: want[k] for k in got} or fw.n == 0 or ts.n == 0 or \
                launches["eb_likelihood"] < 1 or \
                launches["eb_likelihood_bwd"] < 1:
            raise AssertionError(f"pipeline launches {launches} over "
                                 f"{fw.n} tower forwards, {ts.n} steps")
        stage_dir = Path(cfg.stage_dir)
        files = sorted(p.name for p in stage_dir.iterdir())
        need = [f"{s}_end.txt" for s in ("featurizer", "communication",
                                          "predictor")] + \
            [f"results_{s}.csv" for s in ("featurizer", "communication",
                                          "predictor")]
        acc = float(metrics["test/pred/acc"])
        if [f for f in need if f not in files] or not np.isfinite(acc):
            raise AssertionError(f"pipeline files {files}, acc {acc}")

        # a second main on the same directories skips every stage
        reset_launches()
        with CountTrainSteps() as ts2:
            t0 = time.perf_counter()
            again = run.main(cfg, device=DEVICE)
            wall_again = time.perf_counter() - t0
        relaunched = read_launches()
        if again or ts2.n or any(relaunched.values()):
            raise AssertionError(f"second main ran {again}, {ts2.n} steps, "
                                 f"launches {relaunched}")

        # a featurizer stage killed after its first save_last resumes there
        cfg_r = config.apply_precision(config.apply_overrides(
            cfg, [f"data_feat.kwargs.synthetic_n={RESUME_IMAGES}",
                  f"out_dir={tmp}/resume_out", f"ckpt_dir={tmp}/resume"]))

        class Killed(Exception):
            pass

        real_save = CheckpointManager.save_last

        def save_then_die(self, state, step):
            real_save(self, state, step)
            raise Killed

        first, second = [], []
        CheckpointManager.save_last = save_then_die
        try:
            run.run_featurizer_stage(copy.deepcopy(cfg_r), device=DEVICE,
                                     on_step=lambda s, *_: first.append(s),
                                     log=lambda _: None)
            raise AssertionError("the featurizer stage was not killed")
        except Killed:
            pass
        finally:
            CheckpointManager.save_last = real_save
        state, *_ = run.run_featurizer_stage(
            copy.deepcopy(cfg_r), device=DEVICE,
            on_step=lambda s, *_: second.append(s), log=lambda _: None)
        spe = len(first)
        resumed = (spe > 0 and second == list(range(spe, 2 * spe))
                   and state.step == 2 * spe)
    keep = {k: v for k, v in metrics.items() if isinstance(v, float)}
    print(json.dumps({"pipeline_path": dict(
        card=card, preset="clip_bottleneck_linear_eval",
        overrides=PIPELINE_OVERRIDES, reduced=PIPELINE_REDUCED,
        wall_s=wall, tower_forwards=fw.n, train_steps=ts.n,
        launches=launches, launches_per_tower_forward={
            k: launches[k] / fw.n for k in ("fused_attention",
                                            "fused_attention_cls")},
        stage_files=files, metrics=keep, test_pred_acc=acc,
        second_main=dict(ran=again, wall_s=wall_again, train_steps=ts2.n,
                         launches=relaunched),
        resume=dict(images=RESUME_IMAGES, steps_first_run=first,
                    steps_after_restart=second, ok=resumed))}), flush=True)
    if not resumed:
        raise AssertionError(f"resume: first run steps {first}, restart "
                             f"steps {second}")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the banana experiments
# ---------------------------------------------------------------------------

# banana_viz_VIC's recipe is 100 epochs of 1000 steps: the K3 run (the
# main path of phase 12) takes 2 of 200 (trainer.limit_train_batches) on
# the full 1,024,000-sample host dataset, and 1 of the probe's 20 epochs
BANANA_OVERRIDES = ["data_feat.n_epochs=2", "trainer.limit_train_batches=0.2",
                    "predictor.n_epochs=1", "trainer.log_every=50",
                    "rate.eb_use_pallas=True"]
# the plain and host-fed runs: the same 2 epochs of 200 steps (the same
# schedules) as whole epochs of 204,800 samples
SHORT_VIC = ["data_feat.kwargs.length=204800", "data_feat.n_epochs=2",
             "predictor.n_epochs=1", "trainer.log_every=50"]
BANANA_AB_STEPS = 3       # the logs held to the plain run, rtol 1e-2
TURN_STEPS = 100          # a turn of the fused vs host-fed A/B
PROFILE_STEPS_BANANA = 50
# banana_viz_BINCE (2048 x 2048 logits): 2 epochs of 150 steps
BINCE_OVERRIDES = ["data_feat.kwargs.length=153600", "data_feat.n_epochs=2",
                   "predictor.n_epochs=1", "trainer.log_every=50",
                   "rate.eb_use_pallas=True"]
# the other presets, and the CLI's sweep: 102,400 samples (100 steps an
# epoch), the same widths
SHORT_OVERRIDES = ["data_feat.kwargs.length=102400", "data_feat.n_epochs=1",
                   "predictor.n_epochs=1", "rate.eb_use_pallas=True"]
BANANA_REDUCED = {
    "featurizer_steps": "2 epochs of 200 steps of the recipe's 100 of "
                        "1000 (the K3 run: limit_train_batches 0.2 of the "
                        "full 1,024,000 samples; plain and host-fed runs: "
                        "204,800 samples)",
    "predictor_epochs": "1 of 20 (on 1,024,000 samples for the K3 run)",
    "banana_viz_BINCE": "2 epochs of 150 steps (153,600 samples)",
    "banana_viz_VAE, banana_viz_VIC_trnslt, the CLI's banana_RD sweep":
        "102,400 samples (1 epoch of 100 steps; the CLI's --dev: 2 of 10)",
    "widths": "none cut: batch 1024, MLPs 1024 wide with 2 hidden layers, "
              "BatchNorm, QuickGELU, z = 2 (BINCE 1), fp32",
    "data": "the featurizer's batches are drawn on the card (the fused "
            "epoch); the host dataset feeds the probe and the host-fed run"}


class CaptureEpochs:
    """Wraps `run.make_generative_epoch`: each fused epoch's stacked logs,
    its wall time (ending in a synchronize) and its steps; the kernels'
    launches inside the fused epochs, summed."""

    def __enter__(self):
        from lossyless_tpu_torch.pipeline import run

        self.logs, self.seconds, self.steps = [], [], 0
        self.launches = dict.fromkeys(read_launches(), 0)
        self.saved = run.make_generative_epoch

        def make(sample_fn, n_steps, *args):
            epoch = self.saved(sample_fn, n_steps, *args)

            def timed(state, seed):
                sync()
                before = read_launches()
                t0 = time.perf_counter()
                state, logs = epoch(state, seed)
                sync()
                self.seconds.append(time.perf_counter() - t0)
                for k, v in read_launches().items():
                    self.launches[k] += v - before[k]
                self.logs.append(logs)
                self.steps += n_steps
                return state, logs
            return timed

        run.make_generative_epoch = make
        return self

    def __exit__(self, *exc):
        from lossyless_tpu_torch.pipeline import run

        run.make_generative_epoch = self.saved


class TimeHostEpochs:
    """Wraps `run.run_featurizer` (one call an epoch on the host-fed path):
    each epoch's wall time, ending in a synchronize, and its steps."""

    def __enter__(self):
        from lossyless_tpu_torch.pipeline import run

        self.seconds, self.steps = [], 0
        self.saved = run.run_featurizer

        def timed(cfg, batches, *a, **k):
            sync()
            t0 = time.perf_counter()
            before = k["state"].step
            state = self.saved(cfg, batches, *a, **k)
            sync()
            self.seconds.append(time.perf_counter() - t0)
            self.steps += state.step - before
            return state

        run.run_featurizer = timed
        return self

    def __exit__(self, *exc):
        from lossyless_tpu_torch.pipeline import run

        run.run_featurizer = self.saved


def matmul_precision() -> dict:
    import torch

    return dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                float32_matmul_precision=torch.get_float32_matmul_precision())


MAIN_KEYS = ("test/feat/loss", "test/comm/n_bits", "test/pred/loss")


def timed_main(cfg, precision: dict, need=MAIN_KEYS) -> dict:
    """`main(cfg)` on the card with its epochs timed; the metrics (those
    of `need` finite), the wall time, ms a step (the last epoch's), the
    fused epochs' logs and the launches inside them."""
    from lossyless_tpu_torch.pipeline import run

    with CaptureEpochs() as fused, TimeHostEpochs() as host:
        t0 = time.perf_counter()
        metrics = run.main(cfg, device=DEVICE)
        sync()
        wall = time.perf_counter() - t0
    if matmul_precision() != precision:
        raise AssertionError(f"the matmul precision moved from {precision} "
                             f"to {matmul_precision()}")
    timer = fused if fused.steps else host
    per_epoch = timer.steps // max(1, len(timer.seconds))
    keep = {k: v for k, v in metrics.items() if isinstance(v, float)}
    bad = [k for k in need if not np.isfinite(keep.get(k, np.nan))]
    if bad:
        raise AssertionError(f"{cfg.experiment} main: {bad} not finite in "
                             f"{keep}")
    return dict(wall_s=wall, steps=timer.steps,
                fused=bool(fused.steps), epoch_s=timer.seconds,
                ms_per_step=timer.seconds[-1] * 1e3 / per_epoch,
                metrics=keep, logs=fused.logs,
                fused_launches=fused.launches)


def first_steps(logs: list, n: int) -> list:
    keys = ("loss", "rate", "distortion")
    return [{k: float(logs[0][k][i]) for k in keys} for i in range(n)]


def banana_state(cfg, steps: int = TURN_STEPS):
    """A fresh train state of `cfg` on the card (schedules bound to two
    epochs of `steps`) and its host dataset (the sampler draws on the
    card: the length is moot for the fused epoch)."""
    from lossyless_tpu_torch.pipeline import config, run

    cfg = config.apply_precision(copy.deepcopy(cfg))
    ds = run.instantiate_datamodule(cfg, cfg.data_feat)
    return cfg, ds, run.build_state(cfg, 2 * steps, steps,
                                    device=DEVICE)


def profile_fused_epoch(cfg, card: str,
                        steps: int = PROFILE_STEPS_BANANA) -> dict:
    """One fused epoch of `steps` of `cfg` under torch.profiler: idle
    share, device kernels a step, device ms by kernel group."""
    from lossyless_tpu_torch.train.state import make_generative_epoch

    cfg, ds, state = banana_state(cfg)
    epoch = make_generative_epoch(ds.device_sampler(
        cfg.data_feat.batch_size), steps)
    epoch(state, 0)       # set-up outside the trace
    return device_profile(lambda: epoch(state, 1), card, steps=steps,
                          batch=cfg.data_feat.batch_size)


def fused_vs_host_fed(cfg, steps: int = TURN_STEPS) -> dict:
    """ms a step of a fused epoch and of the host-fed loop on one state, in
    turns (fused, host-fed, host-fed, fused), `steps` steps a turn."""
    from lossyless_tpu_torch.pipeline import run
    from lossyless_tpu_torch.train.loggers import NoLogger
    from lossyless_tpu_torch.train.state import make_generative_epoch

    cfg, ds, state = banana_state(cfg, steps)
    bsz = cfg.data_feat.batch_size
    fused = make_generative_epoch(ds.device_sampler(bsz), steps)

    def host(turn):
        batches = itertools.islice(ds.batches(bsz, seed=turn), steps)
        run.run_featurizer(cfg, batches, state=state, device=DEVICE,
                           log=lambda _: None, logger=NoLogger())

    turns = {"fused": [], "host_fed": []}
    for turn, name in enumerate(("fused", "host_fed", "host_fed", "fused")):
        sync()
        t0 = time.perf_counter()
        if name == "fused":
            fused(state, turn)
        else:
            host(turn)
        sync()
        turns[name].append((time.perf_counter() - t0) * 1e3 / steps)
    return dict(steps_a_turn=steps, order=["fused", "host_fed",
                                                "host_fed", "fused"],
                ms_per_step=turns)


def banana_path(card: str) -> dict:
    """Phase 12: `main(preset("banana_viz_VIC"))` at full width through
    the fused epoch, plain and with K3 (`rate.eb_use_pallas=True`: the
    launches are counted on that run), the first steps' logs of the two
    held to rtol 1e-2; the K3 run host-fed (`trainer.use_fused_epochs=
    False`) beside it; a profiled fused epoch; `banana_viz_BINCE` under
    K3; `banana_viz_VAE` and `banana_viz_VIC_trnslt`; the experiment CLI's
    `-m` sweep of `banana_RD` in a subprocess. Returns the K3 run's
    launch counts."""
    from lossyless_tpu_torch.pipeline import config

    t_phase = time.perf_counter()
    precision = matmul_precision()
    out = dict(card=card, matmul_precision=precision,
               overrides=BANANA_OVERRIDES, reduced=BANANA_REDUCED)

    def record(key, value):
        """Keep a part's result and print it as it completes."""
        out[key] = value
        print(json.dumps({f"banana_path_{key}": value}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        def cfg_of(name, overrides, tag):
            return config.apply_overrides(config.preset(name), overrides + [
                f"out_dir={tmp}/{tag}/out", f"ckpt_dir={tmp}/{tag}/ckpt"])

        reset_launches()
        plain = timed_main(cfg_of("banana_viz_VIC", SHORT_VIC, "plain"),
                            precision)
        plain_launches = read_launches()
        check_launches(plain_launches, "the plain banana run",
                       batchnorm=True, k3=False)

        # the main path: K3 and its backward, K6 (the MLPs' BatchNorms),
        # nothing else
        k3_cfg = cfg_of("banana_viz_VIC", BANANA_OVERRIDES, "k3")
        reset_launches()
        kernels = timed_main(k3_cfg, precision)
        launches = read_launches()
        check_launches(launches, "banana path", batchnorm=True)
        a = first_steps(kernels.pop("logs"), BANANA_AB_STEPS)
        b = first_steps(plain.pop("logs"), BANANA_AB_STEPS)
        worst = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                    for x, y in zip(a, b) for k in x)
        record("plain", plain)
        record("kernels", kernels)
        record("launches", launches)
        record("kernels_vs_plain", dict(steps=BANANA_AB_STEPS, kernels=a,
                                        plain=b, max_rel_diff=worst,
                                        tolerance=1e-2))
        if not worst <= 1e-2:
            raise AssertionError(f"banana K3 vs plain logs differ by {worst}")

        host = timed_main(cfg_of("banana_viz_VIC", SHORT_VIC + [
            "rate.eb_use_pallas=True", "trainer.use_fused_epochs=False"],
            "host"), precision)
        host.pop("logs")
        record("host_fed", host)
        short_k3 = cfg_of("banana_viz_VIC", SHORT_VIC
                          + ["rate.eb_use_pallas=True"], "turns")
        record("fused_vs_host_fed", fused_vs_host_fed(short_k3))
        record("profile", profile_fused_epoch(short_k3, card))

        reset_launches()
        bince = timed_main(cfg_of("banana_viz_BINCE", BINCE_OVERRIDES,
                                   "bince"), precision)
        logs = bince.pop("logs")
        i_q_zm = np.concatenate([lg["I_q_zm"] for lg in logs])
        bince.update(launches=read_launches(),
                     I_q_zm_first_last=[float(i_q_zm[0]),
                                        float(i_q_zm[-1])],
                     loss_last=float(logs[-1]["loss"][-1]))
        if not (np.isfinite(i_q_zm).all() and np.isfinite(
                bince["loss_last"]) and bince["launches"]["eb_likelihood"]):
            raise AssertionError(f"banana_viz_BINCE: {bince}")
        record("bince", bince)

        for name in ("banana_viz_VAE", "banana_viz_VIC_trnslt"):
            run_ = timed_main(cfg_of(name, SHORT_OVERRIDES, name),
                               precision)
            run_.pop("logs")
            record(name, run_)

        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "lossyless_tpu_torch.cli", "banana_RD",
             "-m", "--dev", *SHORT_OVERRIDES, f"out_dir={tmp}/cli/out",
             f"ckpt_dir={tmp}/cli/ckpt", "loss.beta=0.05,0.2"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if cli.returncode:
            raise AssertionError(f"the experiment CLI exited "
                                 f"{cli.returncode}: {cli.stderr[-3000:]}")
        jobs = [json.loads(line) for line in cli.stdout.splitlines()
                if line.startswith('{"job"')]
        if [j["job"] for j in jobs] != [0, 1] or not all(
                np.isfinite(j["metrics"]["test/pred/loss"]) for j in jobs):
            raise AssertionError(f"the CLI sweep printed {cli.stdout[-2000:]}")
        record("cli_sweep", dict(wall_s=time.perf_counter() - t0,
                                 jobs=jobs))
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"banana_path": {k: out[k] for k in (
        "card", "matmul_precision", "launches", "kernels_vs_plain",
        "fused_vs_host_fed", "wall_s")}}), flush=True)
    return launches



# ---------------------------------------------------------------------------
# Phase 13: the augmented-MNIST image path
# ---------------------------------------------------------------------------

# mnist_vic's recipe is 100 epochs over MNIST's 60,000 images: here 2
# epochs of 105 steps over 30,000 seeded synthetic MNIST-shaped images
# (train 27,000 after the 10% validation carve; test 30,000), 1 of the
# probe's 20 epochs; every width as the recipe has it
IMAGE_OVERRIDES = ["rate.eb_use_pallas=True",
                   "data_feat.kwargs.synthetic=True",
                   "data_feat.kwargs.synthetic_n=30000",
                   "data_feat.n_epochs=2", "predictor.n_epochs=1",
                   "trainer.log_every=25"]
IMAGE_AB_STEPS = 3        # the logs held to the plain-K3 run, rtol 1e-2
IMAGE_TURN_STEPS = 50     # a turn of the fused vs host-fed A/B
IMAGE_PROFILE_STEPS = 20
# the staggered pair at a small depth: 1 epoch of 14 steps each
STAG_OVERRIDES = ["rate.eb_use_pallas=True",
                  "data_feat.kwargs.synthetic=True",
                  "data_feat.kwargs.synthetic_n=4096",
                  "data_feat.n_epochs=1", "predictor.n_epochs=1"]
IMAGE_REDUCED = {
    "featurizer_steps": "2 epochs of 105 steps (27,000 train images) of "
                        "the recipe's 100 epochs over MNIST's 60,000",
    "predictor_epochs": "1 of 20",
    "data": "30,000 seeded synthetic MNIST-shaped images (32 x 32 x 1, 10 "
            "classes) in place of the MNIST files, which are not in the "
            "checkout; batches drawn and augmented (rotation, x/y "
            "translation, scale, shear) on the card by the fused epoch",
    "mnist_stag_step1 -> step2": "4,096 images, 1 epoch of 14 steps each",
    "widths": "none cut: ResNet-18 (3x3 stem) at 32 x 32 x 1, z = 128, "
              "the hyperprior's 25-channel side latent on K3, the CNN "
              "decoder at hid_dim 32, batch 256, bf16"}


def image_path(card: str) -> dict:
    """Phase 13: `main(preset("mnist_vic"))` at full width with K3 on (the
    launches counted on that run: K3, K6 and their backwards, nothing
    else),
    through the fused epoch (batches drawn and augmented on the card);
    a plain-K3 run of the same featurizer whose first steps' logs the
    kernels' must equal to rtol 1e-2; the fused epoch and the host-fed
    loop in turns; a profiled fused epoch; then `mnist_stag_step1` ->
    `mnist_stag_step2`, whose frozen encoder must be step 1's export.
    Returns the K3 run's launch counts."""
    import torch

    from lossyless_tpu_torch.pipeline import config
    from lossyless_tpu_torch.train.checkpoints import load_weights

    t_phase = time.perf_counter()
    precision = matmul_precision()
    out = dict(card=card, preset="mnist_vic", overrides=IMAGE_OVERRIDES,
               reduced=IMAGE_REDUCED, matmul_precision=precision)

    def record(key, value):
        out[key] = value
        print(json.dumps({f"image_path_{key}": value}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        def cfg_of(name, overrides, tag):
            return config.apply_overrides(config.preset(name), overrides + [
                f"out_dir={tmp}/{tag}/out", f"ckpt_dir={tmp}/{tag}/ckpt"])

        k3_cfg = cfg_of("mnist_vic", IMAGE_OVERRIDES, "k3")
        reset_launches()
        kernels = timed_main(k3_cfg, precision)
        launches = read_launches()
        check_launches(launches, "image path", batchnorm=True)
        if not kernels["fused"]:
            raise AssertionError("the image path did not take the fused "
                                 "epoch")
        logs = kernels.pop("logs")
        record("kernels", kernels)
        record("launches", launches)

        reset_launches()
        plain = timed_main(cfg_of("mnist_vic", IMAGE_OVERRIDES + [
            "rate.eb_use_pallas=False", "is_only_feat=True"], "plain"),
            precision, need=("test/feat/loss",))
        check_launches(read_launches(), "the plain image run",
                       batchnorm=True, k3=False)
        a = first_steps(logs, IMAGE_AB_STEPS)
        b = first_steps(plain.pop("logs"), IMAGE_AB_STEPS)
        worst = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                    for x, y in zip(a, b) for k in x)
        record("plain", plain)
        record("kernels_vs_plain", dict(steps=IMAGE_AB_STEPS, kernels=a,
                                        plain=b, max_rel_diff=worst,
                                        tolerance=1e-2))
        if not worst <= 1e-2:
            raise AssertionError(f"image path K3 vs plain logs differ by "
                                 f"{worst}")

        record("fused_vs_host_fed", fused_vs_host_fed(k3_cfg,
                                                      IMAGE_TURN_STEPS))
        record("profile", profile_fused_epoch(k3_cfg, card,
                                              IMAGE_PROFILE_STEPS))

        # the staggered pair: step 2 reads step 1's export, frozen
        s1 = cfg_of("mnist_stag_step1", STAG_OVERRIDES, "stag")
        t0 = time.perf_counter()
        m1 = timed_main(s1, precision, need=("test/feat/loss",))
        export1 = Path(tmp) / "stag" / "ckpt" / s1.long_name / \
            "best_featurizer"
        s2 = cfg_of("mnist_stag_step2", STAG_OVERRIDES + [
            f"encoder.pretrained_path={export1}"], "stag")
        m2 = timed_main(s2, precision)
        w1 = load_weights(export1)
        w2 = load_weights(Path(s2.ckpt_dir) / s2.long_name /
                          "best_featurizer")
        # the parameters (the running statistics go on moving in train
        # mode, in JAX too)
        enc = [k for k in w2 if k.startswith("p_ZlX.mapper.")
               and not k.endswith((".mean", ".var"))]
        same = bool(enc) and all(torch.equal(w1[k], w2[k]) for k in enc)
        record("stag", dict(wall_s=time.perf_counter() - t0,
                            step1=m1["metrics"], step2=m2["metrics"],
                            encoder_tensors=len(enc),
                            encoder_equals_step1_export=same))
        if not same:
            raise AssertionError("mnist_stag_step2's encoder is not step "
                                 "1's export")
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"image_path": {k: out[k] for k in (
        "card", "matmul_precision", "launches", "kernels_vs_plain",
        "fused_vs_host_fed", "wall_s")}}), flush=True)
    return launches

# ---------------------------------------------------------------------------
# Phase 14: the STL10 experiments
# ---------------------------------------------------------------------------

STL10_SYNTH = ["data_feat.kwargs.synthetic=True",
               "data_pred.kwargs.synthetic=True"]
# stl10_bince's recipe is 20 epochs over STL10's 5,000 labelled train
# images: here 2 epochs of 14 steps over 4,096 seeded synthetic ones
# (3,686 after the 10% validation carve), 1 of the probe's 20 epochs
BINCE_STL10 = ["rate.eb_use_pallas=True", "data_feat.kwargs.synthetic=True",
               "data_feat.kwargs.synthetic_n=4096", "data_feat.n_epochs=2",
               "predictor.n_epochs=1", "trainer.log_every=7"]
# the plain-likelihood run: the same first epoch (the same draws), 4 of
# its steps, featurizer only, the evaluation cut; its schedules are bound
# to the kernel run's span (`plain_overrides`)
STL10_PLAIN = ["rate.eb_use_pallas=False", "data_feat.n_epochs=1",
               "trainer.limit_train_batches=0.3",
               "trainer.limit_eval_batches=0.1", "is_only_feat=True",
               "is_skip_comm=True"]
STL10_AB_STEPS = 3        # the logs held to the plain-K3 run, rtol 1e-2
STL10_PROFILE_STEPS = 10
# stl10_understand_VIC and stl10_balle: 100 epochs over the 100,000
# unlabelled images in the recipes; here 1 epoch over 2,048 synthetic
# ones, the probe on 1,024 labelled ones, 1 epoch
VIC_STL10 = ["rate.eb_use_pallas=True", *STL10_SYNTH,
             "data_feat.kwargs.synthetic_n=2048",
             "data_pred.kwargs.synthetic_n=1024", "data_feat.n_epochs=1",
             "predictor.n_epochs=1", "trainer.log_every=7"]
# the variants: 1,024 images, a few steps
SHORT_STL10 = ["rate.eb_use_pallas=True", *STL10_SYNTH,
               "data_feat.kwargs.synthetic_n=1024",
               "data_pred.kwargs.synthetic_n=1024", "data_feat.n_epochs=1",
               "predictor.n_epochs=1"]
STL10_REDUCED = {
    "stl10_bince": "2 epochs of 14 steps over 4,096 seeded synthetic "
                   "STL10-shaped images (96 x 96 x 3, 10 classes) of the "
                   "recipe's 20 epochs over STL10's files, which are not "
                   "in the checkout; 1 of the probe's 20 epochs",
    "stl10_understand_VIC, stl10_balle": "1 epoch (7 and 28 steps) over "
                                         "2,048 synthetic unlabelled "
                                         "images of the recipes' 100 "
                                         "over 100,000; the probe 1 "
                                         "epoch on 1,024 labelled",
    "stl10_rate_variation, stl10_dist_variation, stl10_action_dist_shift":
        "1,024 images, 1 epoch of 3 steps (the CLI's --dev: 2 epochs of "
        "1 step)",
    "data": "the featurizer's batches drawn and augmented (hflip, "
            "resize_crop, color, gray) on the card by the fused epoch",
    "widths": "none cut: ResNet-18 (3x3 stem) at 96 x 96 x 3, z = 128, "
              "batch 256, bf16 (bince: the contrastive projection at 128, "
              "K3 at (256, 128); VIC: the CNN decoder at hid_dim 64 "
              "through 96 -> 128 -> 96, H_hyper's side latent (256, 25)); "
              "BALLE at hid_dim 64 on 128 px, z = 8192 (8 x 8 x 128), "
              "H_spatial with K3 at (4096, 25), batch 64"}


def plain_overrides(steps: int) -> list:
    """`STL10_PLAIN` with the three optimizers' schedules spanning the
    kernel run's `steps` (expdecay's rate depends on the span)."""
    return STL10_PLAIN + [f"optimizer_{g}.total_steps={steps}"
                          for g in ("feat", "coder", "online")]


def check_test_metrics(metrics: dict, what: str):
    """Every `test/*` metric of a run finite (the three stages': feat,
    comm, pred)."""
    bad = {k: v for k, v in metrics.items() if k.startswith("test/")
           and not np.isfinite(v)}
    stages = {k.split("/")[1] for k in metrics if k.startswith("test/")}
    if bad or not {"feat", "comm", "pred"} <= stages:
        raise AssertionError(f"{what}: test metrics {bad or sorted(stages)}")


def spatial_communication(cfg, n: int = 256,
                          label: str = "stl10_path_spatial_coder") -> dict:
    """An `H_spatial` run's exported featurizer (`stl10_balle`'s,
    `galaxy_regression`'s) through `SpatialHyperpriorCoder` on `n` test
    images of its `data_pred`: the decoded latents against the
    receiver's dequantize of the sender's symbols (1e-5)."""
    import torch

    from lossyless_tpu_torch.compressors import rates
    from lossyless_tpu_torch.pipeline import config, run
    from lossyless_tpu_torch.train.checkpoints import load_weights

    cfg = config.apply_precision(copy.deepcopy(cfg))
    run.instantiate_datamodule(cfg, cfg.data_feat, device=DEVICE)
    state = run.build_state(cfg, 0, device=DEVICE)
    state.model.load_state_dict(load_weights(
        Path(cfg.ckpt_dir) / cfg.long_name / "best_featurizer"))
    rate = state.model.rate_estimator
    coder = rates.SpatialHyperpriorCoder(rate)
    test = run._test_dataset(cfg, cfg.data_pred, DEVICE)
    n = min(n, len(test))
    x, _, _ = next(test.batches(n, seed=0))
    with torch.no_grad():
        z = state.model.encode(x.to(DEVICE)).float().cpu().numpy()
    t0 = time.perf_counter()
    streams = coder.compress(z)
    t_comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = coder.decompress(streams)
    t_dec = time.perf_counter() - t0
    rows = rates.fold_spatial(z, rate.n_channels)
    want = rates.unfold_spatial(coder.inner.dequantize(
        *coder.inner.encode_symbols(rows)), n)
    err = float(np.abs(decoded - want).max())
    nbytes = sum(len(s) for grp in streams for s in grp)
    out = dict(images=n, messages=len(streams[0]),
               bits_per_image=8 * nbytes / n, max_abs_err=err,
               tolerance=1e-5, compress_s=t_comp, decompress_s=t_dec)
    print(json.dumps({label: out}), flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"SpatialHyperpriorCoder decodes {err} off "
                             f"the dequantized latents")
    return out


def stl10_path(card: str) -> dict:
    """Phase 14: `main(preset("stl10_bince"))` at full width with K3 on
    (the launches counted on that run: K3 and its backward, K6 40 + 40 a
    step of its fused epochs, nothing else; the peak device memory),
    through the fused epoch (the anchor and its positive drawn and
    augmented on the card by the STL10 chain);
    the same featurizer on the plain likelihood, whose first steps' logs
    the kernels' must equal to rtol 1e-2; a profiled fused epoch;
    `stl10_understand_VIC` and `stl10_balle` through `main` at full width
    (K3, K6 and their backwards, nothing else), `stl10_balle`'s communication
    through `SpatialHyperpriorCoder`; `stl10_rate_variation` and
    `stl10_dist_variation` at a small depth, `stl10_action_dist_shift`
    through the experiment CLI in a subprocess. Returns the launch counts
    of the phase's runs on the kernels."""
    import torch

    from lossyless_tpu_torch.pipeline import config

    t_phase = time.perf_counter()
    precision = matmul_precision()
    out = dict(card=card, reduced=STL10_REDUCED, matmul_precision=precision)
    total = None

    def record(key, value):
        out[key] = value
        print(json.dumps({f"stl10_path_{key}": value}), flush=True)

    def add(launches):
        nonlocal total
        total = dict(launches) if total is None else {
            k: total[k] + v for k, v in launches.items()}

    with tempfile.TemporaryDirectory() as tmp:
        def cfg_of(name, overrides, tag):
            return config.apply_overrides(config.preset(name), overrides + [
                f"out_dir={tmp}/{tag}/out", f"ckpt_dir={tmp}/{tag}/ckpt"])

        # the main path: stl10_bince
        bince_cfg = cfg_of("stl10_bince", BINCE_STL10, "bince")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        bince = timed_main(bince_cfg, precision)
        launches = read_launches()
        check_launches(launches, "stl10_bince", batchnorm=True)
        # K6 a training step, counted inside this run's fused epochs
        bn_step = k6_per_step(bince)
        if bn_step != {k: K6_STEP_LAUNCHES for k in NO_K6}:
            raise AssertionError(f"stl10_bince's fused epochs launched K6 "
                                 f"{bn_step} a step")
        check_test_metrics(bince["metrics"], "stl10_bince")
        if not bince["fused"]:
            raise AssertionError("stl10_bince did not take the fused epoch")
        bince["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        bince["launches_per_step"] = {k: v / bince["steps"]
                                      for k, v in launches.items()}
        logs = bince.pop("logs")
        record("bince", bince)
        record("bince_launches", launches)
        add(launches)

        reset_launches()
        plain = timed_main(cfg_of("stl10_bince", BINCE_STL10 + plain_overrides(
            bince["steps"]), "plain"), precision, need=("test/feat/loss",))
        check_launches(read_launches(), "the plain STL10 run",
                       batchnorm=True, k3=False)
        a = first_steps(logs, STL10_AB_STEPS)
        b = first_steps(plain.pop("logs"), STL10_AB_STEPS)
        worst = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                    for x, y in zip(a, b) for k in x)
        record("kernels_vs_plain", dict(steps=STL10_AB_STEPS, kernels=a,
                                        plain=b, max_rel_diff=worst,
                                        tolerance=1e-2))
        if not worst <= 1e-2:
            raise AssertionError(f"stl10_bince K3 vs plain logs differ by "
                                 f"{worst}")
        record("profile", profile_fused_epoch(bince_cfg, card,
                                              STL10_PROFILE_STEPS))

        for name in ("stl10_understand_VIC", "stl10_balle"):
            cfg = cfg_of(name, VIC_STL10, name)
            reset_launches()
            run_ = timed_main(cfg, precision)
            launches = read_launches()
            check_launches(launches, name, batchnorm=True)
            check_test_metrics(run_["metrics"], name)
            run_.pop("logs")
            run_["launches"] = launches
            if not run_["fused"]:
                raise AssertionError(f"{name} did not take the fused epoch")
            if name == "stl10_balle":
                run_["spatial_coder"] = spatial_communication(cfg)
            record(name, run_)
            add(launches)

        for name in ("stl10_rate_variation", "stl10_dist_variation"):
            reset_launches()
            run_ = timed_main(cfg_of(name, SHORT_STL10, name), precision)
            run_.pop("logs")
            run_["launches"] = read_launches()
            check_launches(run_["launches"], name, batchnorm=True)
            check_test_metrics(run_["metrics"], name)
            record(name, run_)
            add(run_["launches"])

        # the subprocess needs the card's memory that this process's
        # allocator still caches
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "lossyless_tpu_torch.cli",
             "stl10_action_dist_shift", "-m", "--dev", *SHORT_STL10,
             f"out_dir={tmp}/cli/out", f"ckpt_dir={tmp}/cli/ckpt"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if cli.returncode:
            raise AssertionError(f"the experiment CLI exited "
                                 f"{cli.returncode}: {cli.stderr[-3000:]}")
        jobs = [json.loads(line) for line in cli.stdout.splitlines()
                if line.startswith('{"job"')]
        if len(jobs) != 1:
            raise AssertionError(f"the CLI printed {cli.stdout[-2000:]}")
        check_test_metrics(jobs[0]["metrics"], "the CLI's job")
        record("cli", dict(preset="stl10_action_dist_shift",
                           wall_s=time.perf_counter() - t0, jobs=jobs))
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = total
    total.update({f"{k}_per_bince_step": v for k, v in bn_step.items()})
    print(json.dumps({"stl10_path": {k: out[k] for k in (
        "card", "matmul_precision", "launches", "kernels_vs_plain",
        "wall_s")}}), flush=True)
    print(f"phase 14 (STL10) wall {out['wall_s']:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# Phase 15: the SSL towers (CLIP RN50 with K2 as its pool, SimCLR / SwAV)
# ---------------------------------------------------------------------------


def _seeded(seed: int):
    """A normal draw of a shape from a CPU generator seeded with `seed`."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=0.05):
        return torch.randn(shape, generator=g) * std

    return g, r


def _bn_entries(name: str, c: int, r, g) -> dict:
    """torch BatchNorm2d's entries: weight, bias, running statistics (var
    in [0.5, 1.5]) and the batch counter torch saves beside them."""
    import torch

    return {f"{name}.weight": 1 + r(c, std=0.1), f"{name}.bias": r(c),
            f"{name}.running_mean": r(c, std=0.1),
            f"{name}.running_var": 0.5 + torch.rand(c, generator=g),
            f"{name}.num_batches_tracked": torch.tensor(100)}


def openai_rn50_state_dict(width: int = 64, layers=(3, 4, 6, 3),
                           out_dim: int = 1024, grid: int = 7,
                           seed: int = 0, prefix: str = "visual.",
                           dtype=None) -> dict:
    """A seeded OpenAI CLIP ModifiedResNet state dict (`clip.load("RN50")`
    layout: 3-conv stem, `layer{i}.{j}` bottlenecks with a `downsample.0`
    conv and `downsample.1` BatchNorm, `attnpool` over 1 + grid^2 tokens),
    under `prefix`, in `dtype` (fp16 as CLIP ships it where given)."""
    g, r = _seeded(seed)
    embed = width * 32
    sd = {}
    half = width // 2
    for i, (cin, cout) in enumerate(((3, half), (half, half), (half, width)),
                                    start=1):
        sd[f"conv{i}.weight"] = r(cout, cin, 3, 3, std=(2 / (9 * cin)) ** .5)
        sd.update(_bn_entries(f"bn{i}", cout, r, g))
    cin = width
    for i, n in enumerate(layers):
        planes = width * 2 ** i
        for j in range(n):
            t = f"layer{i + 1}.{j}"
            for k, (a, b, kk) in enumerate(((planes, cin, 1),
                                            (planes, planes, 3),
                                            (planes * 4, planes, 1)),
                                           start=1):
                sd[f"{t}.conv{k}.weight"] = r(a, b, kk, kk,
                                              std=(1 / (kk * kk * b)) ** .5)
                sd.update(_bn_entries(f"{t}.bn{k}", a, r, g))
            if j == 0:   # stride 2 or a change of width
                sd[f"{t}.downsample.0.weight"] = r(planes * 4, cin, 1, 1,
                                                   std=cin ** -.5)
                sd.update(_bn_entries(f"{t}.downsample.1", planes * 4, r, g))
            cin = planes * 4
    sd["attnpool.positional_embedding"] = r(grid * grid + 1, embed,
                                            std=embed ** -.5)
    for name, cout in (("q_proj", embed), ("k_proj", embed),
                       ("v_proj", embed), ("c_proj", out_dim)):
        sd[f"attnpool.{name}.weight"] = r(cout, embed, std=embed ** -.5)
        sd[f"attnpool.{name}.bias"] = r(cout)
    return {prefix + k: (v.to(dtype) if dtype is not None
                         and v.is_floating_point() else v)
            for k, v in sd.items()}


def torchvision_resnet50_state_dict(seed: int = 0, prefix: str = "") -> dict:
    """A seeded torchvision ResNet-50 state dict (the SimCLR / SwAV
    backbones' layout, `fc` included) under `prefix`."""
    g, r = _seeded(seed)
    sd = {"conv1.weight": r(64, 3, 7, 7, std=(2 / 147) ** .5)}
    sd.update(_bn_entries("bn1", 64, r, g))
    cin = 64
    for i, n in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** i
        for j in range(n):
            t = f"layer{i + 1}.{j}"
            for k, (a, b, kk) in enumerate(((planes, cin, 1),
                                            (planes, planes, 3),
                                            (planes * 4, planes, 1)),
                                           start=1):
                sd[f"{t}.conv{k}.weight"] = r(a, b, kk, kk,
                                              std=(1 / (kk * kk * b)) ** .5)
                sd.update(_bn_entries(f"{t}.bn{k}", a, r, g))
            if j == 0:
                sd[f"{t}.downsample.0.weight"] = r(planes * 4, cin, 1, 1,
                                                   std=cin ** -.5)
                sd.update(_bn_entries(f"{t}.downsample.1", planes * 4, r, g))
            cin = planes * 4
    sd["fc.weight"] = r(1000, 2048, std=2048 ** -.5)
    sd["fc.bias"] = r(1000)
    return {prefix + k: v for k, v in sd.items()}


def openai_clip_text_state_dict(vocab: int = 49408, context: int = 77,
                                width: int = 512, layers: int = 12,
                                out_dim: int = 512, seed: int = 0,
                                dtype=None) -> dict:
    """A seeded OpenAI CLIP text-tower state dict (`token_embedding`,
    `transformer.resblocks.{i}`, `ln_final`, `text_projection`)."""
    _, r = _seeded(seed)
    w = width
    sd = {"token_embedding.weight": r(vocab, w, std=0.02),
          "positional_embedding": r(context, w, std=0.01),
          "ln_final.weight": 1 + r(w), "ln_final.bias": r(w),
          "text_projection": r(w, out_dim, std=w ** -.5)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        sd.update({
            f"{p}.ln_1.weight": 1 + r(w), f"{p}.ln_1.bias": r(w),
            f"{p}.ln_2.weight": 1 + r(w), f"{p}.ln_2.bias": r(w),
            f"{p}.attn.in_proj_weight": r(3 * w, w, std=w ** -.5),
            f"{p}.attn.in_proj_bias": r(3 * w),
            f"{p}.attn.out_proj.weight": r(w, w, std=w ** -.5),
            f"{p}.attn.out_proj.bias": r(w),
            f"{p}.mlp.c_fc.weight": r(4 * w, w, std=w ** -.5),
            f"{p}.mlp.c_fc.bias": r(4 * w),
            f"{p}.mlp.c_proj.weight": r(w, 4 * w, std=(4 * w) ** -.5),
            f"{p}.mlp.c_proj.bias": r(w)})
    return {k: v.to(dtype) if dtype is not None else v for k, v in sd.items()}


# ssl_bottleneck_pretrain at full width (ModifiedRN50: width 64, (3, 4, 6,
# 3), 32 heads, 224 px, z = 1024) in fp32: `preset()` makes every
# non-banana preset bf16; the pool's fp32 path is the one K2 gains here
SSL_OVERRIDES = ["rate.eb_use_pallas=True", "trainer.precision=fp32",
                 "trainer.log_every=5"]
SSL_PLAIN = ["rate.eb_use_pallas=False",
             "encoder.arch_kwargs.attn_impl=einsum"]
SSL_STEPS, SSL_AB_STEPS, SSL_PROFILE_STEPS, SSL_TOWER_STEPS = 20, 3, 3, 3
SSL_SIDE = 224
# ssl_bottleneck_linear_eval through main (the preset's bf16) on
# synthetic STL10 at 96 px: the pool at N = 10, its pe resampled 7 -> 3
SSL_EVAL = ["rate.eb_use_pallas=True", "data_feat.name=stl10",
            "data_feat.kwargs.synthetic=True",
            "data_feat.kwargs.synthetic_n=4096", "data_feat.n_epochs=2",
            "predictor.n_epochs=2", "trainer.log_every=10",
            "data_pred.name=stl10"]
SSL_CLI = ["rate.eb_use_pallas=True", "data_feat.name=stl10",
           "data_feat.kwargs.synthetic=True",
           "data_feat.kwargs.synthetic_n=1024", "data_feat.n_epochs=1",
           "predictor.n_epochs=1", "data_pred.name=stl10"]
TEXT_ROWS, TEXT_BATCH, TEXT_CHECK_ROWS = 1024, 256, 8
SSL_TOWER = {}   # the seeded checkpoint's sizes (a CPU rehearsal cuts them)
SSL_REDUCED = {
    "ssl_bottleneck_pretrain": "20 steps (and 3 + 3 for the plain A/B, 3 "
                               "profiled) at batch 128 on seeded random "
                               "normalized 224 px images of the recipe's 30 "
                               "COCO epochs (COCO is not in the checkout); "
                               "fp32 (the preset's default is bf16)",
    "simclr, swav": "3 steps each of the same preset at z = 2048",
    "weights": "seeded random, in the public layouts (OpenAI RN50 fp16, "
               "torchvision ResNet-50), loaded through "
               "encoder.pretrained_path; no published checkpoint is in the "
               "checkout",
    "ssl_bottleneck_linear_eval": "data_feat and data_pred set to STL10 "
                                  "(the recipe's COCO is not in the "
                                  "checkout): 4,096 seeded synthetic 96 px "
                                  "images, 2 of 30 featurizer and 2 of 20 "
                                  "probe epochs",
    "ssl_bottleneck_mlp_eval": "the experiment CLI's --dev on 1,024 "
                               "synthetic STL10 images",
    "text tower": "1,024 seeded token rows (COCO's captions are not in the "
                  "checkout)",
    "widths": "none cut: ModifiedRN50 (width 64, (3, 4, 6, 3), 32 heads, "
              "the pool 2048 wide with 50 tokens at 224 px and 10 at 96 "
              "px, out 1024), ResNet-50 (out 2048), z = 1024 / 2048 with "
              "H_hyper's side latent (128, 204) / (128, 409); the text "
              "tower at CLIP's (vocab 49,408, context 77, width 512, 12 "
              "layers, 8 heads, bf16)"}


class CountTowerForwards:
    """Counts the ModifiedRN50 tower's forwards (each launches K2 once)."""

    def __enter__(self):
        from lossyless_tpu_torch.nn.clip_resnet import ClipResNet

        self.n, self.saved = 0, ClipResNet.forward

        def forward(module, x, **kw):
            self.n += 1
            return self.saved(module, x, **kw)

        ClipResNet.forward = forward
        return self

    def __exit__(self, *exc):
        from lossyless_tpu_torch.nn.clip_resnet import ClipResNet

        ClipResNet.forward = self.saved


def ssl_images(n: int, seed: int, batch: int = TRAIN_BATCH):
    """`train_images` at the ssl runs' side (224 px on the card)."""
    import torch

    from lossyless_tpu_torch.nn.vit import CLIP_MEAN, CLIP_STD

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mean = torch.as_tensor(CLIP_MEAN, device=DEVICE)
    std = torch.as_tensor(CLIP_STD, device=DEVICE)
    return [((torch.rand(batch, SSL_SIDE, SSL_SIDE, 3, generator=g,
                         device=DEVICE) - mean) / std,
             torch.zeros(batch, device=DEVICE),
             torch.zeros(batch, device=DEVICE)) for _ in range(n)]


def ssl_path(card: str) -> dict:
    """Phase 15: `ssl_bottleneck_pretrain` at full width with its tower
    from a seeded OpenAI-layout `.pt` (K2 as the attention pool, K3 on the
    side latent): 20 steps through `run_featurizer`, a profile, 3 steps on
    the plain K2 and K3 against the kernels', `run_communication`;
    `simclr` / `swav` from seeded torchvision-layout files; then
    `ssl_bottleneck_linear_eval` through `main` and
    `ssl_bottleneck_mlp_eval` through the experiment CLI; and the CLIP
    text tower's `featurize_captions`. Returns the launch counts of the
    phase's runs on the kernels."""
    import torch

    from lossyless_tpu_torch.compressors.rates import HyperpriorCoder
    from lossyless_tpu_torch.nn import clip_text
    from lossyless_tpu_torch.nn.pretrained import load_pretrained_encoder
    from lossyless_tpu_torch.pipeline import config, run
    from lossyless_tpu_torch.train.checkpoints import load_weights

    t_phase = time.perf_counter()
    precision = matmul_precision()
    out = dict(card=card, reduced=SSL_REDUCED, matmul_precision=precision)
    total = {}

    def record(key, value):
        out[key] = value
        print(json.dumps({f"ssl_path_{key}": value}), flush=True)

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    keys = ("loss", "rate", "H_q_S", "H_q_ZlS", "distortion")
    with tempfile.TemporaryDirectory() as tmp:
        rn50 = Path(tmp) / "RN50.pt"   # OpenAI's layout: fp16, visual.*
        torch.save(openai_rn50_state_dict(seed=31, dtype=torch.float16,
                                          **SSL_TOWER), rn50)
        cfg = config.apply_overrides(config.preset(
            "ssl_bottleneck_pretrain"), SSL_OVERRIDES + [
            f"encoder.pretrained_path={rn50}", f"out_dir={tmp}/out"])
        cfg.in_shape = (SSL_SIDE, SSL_SIDE, 3)
        batches = ssl_images(SSL_STEPS + SSL_PROFILE_STEPS, seed=41)

        # 15a. 20 steps on the kernels, the launches counted
        step_s, last, t_prev = [], {}, [0.0]

        def on_step(step, state, logs):
            sync()
            now = time.perf_counter()
            step_s.append(now - t_prev[0])
            t_prev[0] = now
            last.update(logs)

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_prev[0] = time.perf_counter()
        state = run.run_featurizer(cfg, batches[:SSL_STEPS],
                                   total_steps=SSL_STEPS, on_step=on_step,
                                   log=lambda _: None, device=DEVICE)
        launches = read_launches()
        per_step = {k: v / SSL_STEPS for k, v in launches.items()}
        # K6: a forward a BatchNorm of the frozen tower (one tower forward
        # a step, under no_grad: no backward)
        tower_bns = count_batchnorms(state.model)
        want = {**dict.fromkeys(launches, 0), "fused_attention_cls": 1,
                "eb_likelihood": 1, "eb_likelihood_bwd": 1,
                "batchnorm": tower_bns}
        if per_step != want:
            raise AssertionError(f"ssl launches per step {per_step}, "
                                 f"expected {want}")
        add(launches)
        logs = {k: float(last[k]) for k in keys}
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"non-finite ssl training logs {logs}")
        pool = state.model.p_ZlX.mapper.attnpool
        step_ms = float(np.median(step_s[2:])) * 1e3
        record("training", dict(
            preset="ssl_bottleneck_pretrain", batch=TRAIN_BATCH,
            steps=SSL_STEPS, pool_tokens=pool.positional_embedding.shape[0],
            tower_dtype=str(state.model.p_ZlX.mapper.dtype),
            side_z_dim=state.model.rate_estimator.side_z_dim,
            step_ms_median=step_ms, step_ms_all=[t * 1e3 for t in step_s],
            img_per_s=TRAIN_BATCH / (step_ms / 1e3),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            final_logs=logs, launches_per_step=per_step))

        # 15b. where a step's device time goes
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        prof = device_profile(
            lambda: run.run_featurizer(cfg, batches[SSL_STEPS:], state=state,
                                       log=lambda _: None, device=DEVICE),
            card, steps=SSL_PROFILE_STEPS, batch=TRAIN_BATCH)
        record("profile", prof)

        # 15c. 3 steps from the same weights and noise on the kernels and
        # on the plain K2 and K3
        rows = {}
        for name, extra in (("kernels", []), ("plain", SSL_PLAIN)):
            c = config.apply_precision(config.apply_overrides(cfg, extra))
            ab = run.build_state(c, SSL_AB_STEPS, device=DEVICE)
            ab.model.load_state_dict(init)
            got = []
            reset_launches()
            run.run_featurizer(c, batches[:SSL_AB_STEPS], state=ab,
                               log=lambda _: None, device=DEVICE,
                               on_step=lambda st, s, lg: got.append(
                                   {k: float(lg[k]) for k in keys}))
            n = read_launches()
            if (name == "plain") == any(v for k, v in n.items()
                                        if k not in NO_K6) or \
                    n["batchnorm"] != tower_bns * SSL_AB_STEPS or \
                    n["batchnorm_bwd"]:
                raise AssertionError(f"the {name} A/B run launched {n}")
            rows[name] = got
        worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                    for a, b in zip(rows["kernels"], rows["plain"])
                    for k in a)
        record("kernels_vs_plain", dict(steps=SSL_AB_STEPS, **rows,
                                        max_rel_diff=worst, tolerance=1e-2))
        if not worst <= 1e-2:
            raise AssertionError(f"ssl kernels vs plain logs differ by "
                                 f"{worst}")

        # 15d. the communication stage on the trained state
        comm_batches = ssl_images(COMM_BATCHES, seed=43, batch=COMM_BATCH)
        reset_launches()
        m = run.run_communication(cfg, state, comm_batches, device=DEVICE)
        add(read_launches())
        coder = HyperpriorCoder(state.model.rate_estimator)
        z0 = state.model.encode(comm_batches[0][0]).float().cpu().numpy()
        decoded = coder.decompress(coder.compress(z0))
        err = float(np.abs(decoded - coder.dequantize(
            *coder.encode_symbols(z0))).max())
        record("communication", dict(
            batches=COMM_BATCHES, batch=COMM_BATCH,
            n_bits=m["test/comm/n_bits"],
            sender_ms_per_img=m["test/comm/sender_time"] * 1e3,
            receiver_ms_per_img=m["test/comm/receiver_time"] * 1e3,
            decode_vs_dequantize_max_abs_err=err, tolerance=1e-5))
        if not err <= 1e-5 or not np.isfinite(m["test/comm/n_bits"]):
            raise AssertionError(f"ssl communication: decode off by {err}")
        del state, prof
        gc.collect()

        # 15e. simclr and swav from torchvision-layout files
        for arch, prefix in (("simclr", "encoder."), ("swav", "module.")):
            path = Path(tmp) / f"{arch}.pth"
            torch.save({"state_dict": torchvision_resnet50_state_dict(
                seed=37, prefix=prefix)}, path)
            c = config.apply_overrides(cfg, [
                f"encoder.arch={arch}", "encoder.z_dim=2048",
                "encoder.arch_kwargs={}",
                f"encoder.pretrained_path={path}"])
            got = []
            reset_launches()
            st = run.run_featurizer(c, batches[:SSL_TOWER_STEPS],
                                    log=lambda _: None, device=DEVICE,
                                    on_step=lambda s, t, lg: got.append(
                                        {k: float(lg[k]) for k in keys}))
            n = read_launches()
            per = {k: v / SSL_TOWER_STEPS for k, v in n.items()}
            if per != {**dict.fromkeys(n, 0), "eb_likelihood": 1,
                       "eb_likelihood_bwd": 1,
                       "batchnorm": count_batchnorms(st.model)}:
                raise AssertionError(f"{arch} launches per step {per}")
            if not all(np.isfinite(v) for r in got for v in r.values()):
                raise AssertionError(f"{arch}: non-finite logs {got}")
            add(n)
            record(arch, dict(prefix=prefix, steps=SSL_TOWER_STEPS,
                              side_z_dim=st.model.rate_estimator.side_z_dim,
                              logs=got, launches_per_step=per))
            del st
            gc.collect()

        # 15f. ssl_bottleneck_linear_eval through main at 96 px
        ev = config.apply_overrides(config.preset(
            "ssl_bottleneck_linear_eval"), SSL_EVAL + [
            f"encoder.pretrained_path={rn50}", f"out_dir={tmp}/eval/out",
            f"ckpt_dir={tmp}/eval/ckpt"])
        reset_launches()
        with CountTowerForwards() as fw:
            run_ = timed_main(ev, precision)
        launches = read_launches()
        if (launches["fused_attention_cls"] != fw.n or fw.n == 0
                or any(v for k, v in launches.items()
                       if not k.startswith(("eb_likelihood",
                                            "fused_attention_cls",
                                            "batchnorm")))
                or not launches["eb_likelihood_bwd"]
                or launches["batchnorm"] != tower_bns * fw.n
                or launches["batchnorm_bwd"]):
            raise AssertionError(f"linear eval launches {launches} over "
                                 f"{fw.n} tower forwards")
        check_test_metrics(run_["metrics"], "ssl_bottleneck_linear_eval")
        add(launches)
        stage = Path(ev.stage_dir)
        done = {s: (stage / f"{s}_end.txt").exists()
                for s in ("featurizer", "communication", "predictor")}
        exported = load_weights(Path(ev.ckpt_dir) / ev.long_name /
                                "best_featurizer")
        evc = config.apply_precision(copy.deepcopy(ev))
        evc.in_shape = (96, 96, 3)
        ref = run.build_state(evc, 0, device="cpu").model
        load_pretrained_encoder(evc.encoder, ref)
        ref_sd = ref.state_dict()
        names = [n for n, _ in ref.named_parameters()
                 if n.startswith("p_ZlX.")]
        same = all(torch.equal(exported[n], ref_sd[n]) for n in names)
        pool_tokens = ref.p_ZlX.mapper.attnpool.positional_embedding.shape[0]
        run_.pop("logs")
        record("linear_eval", dict(
            run_, launches=launches, tower_forwards=fw.n,
            pool_tokens=pool_tokens, tower_dtype=str(ref.p_ZlX.mapper.dtype),
            sentinels=done, tower_equals_loaded_weights=same,
            test_pred_acc=run_["metrics"].get("test/pred/acc")))
        if not all(done.values()) or not same or pool_tokens != 10:
            raise AssertionError(f"linear eval: sentinels {done}, tower "
                                 f"equal {same}, pool tokens {pool_tokens}")

        # 15g. ssl_bottleneck_mlp_eval through the experiment CLI
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "lossyless_tpu_torch.cli",
             "ssl_bottleneck_mlp_eval", "-m", "--dev", *SSL_CLI,
             f"out_dir={tmp}/cli/out", f"ckpt_dir={tmp}/cli/ckpt"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if cli.returncode:
            raise AssertionError(f"the experiment CLI exited "
                                 f"{cli.returncode}: {cli.stderr[-3000:]}")
        jobs = [json.loads(line) for line in cli.stdout.splitlines()
                if line.startswith('{"job"')]
        if len(jobs) != 1:
            raise AssertionError(f"the CLI printed {cli.stdout[-2000:]}")
        check_test_metrics(jobs[0]["metrics"], "the CLI's job")
        record("cli", dict(preset="ssl_bottleneck_mlp_eval",
                           wall_s=time.perf_counter() - t0, jobs=jobs))

    # 15h. the CLIP text tower at CLIP's widths, bf16, on the card
    sd = clip_text.convert_openai_clip_text_weights(
        openai_clip_text_state_dict(seed=47, dtype=torch.float16))
    rng = np.random.default_rng(53)
    ids = rng.integers(1, 49407, (TEXT_ROWS, 77))
    for i, end in enumerate(rng.integers(5, 77, TEXT_ROWS)):
        ids[i, end], ids[i, end + 1:] = 49407, 0
    clip_text.featurize_captions(sd, ids[:TEXT_BATCH], TEXT_BATCH,
                                 device=DEVICE)            # warm-up
    sync()
    t0 = time.perf_counter()
    emb = clip_text.featurize_captions(sd, ids, TEXT_BATCH, device=DEVICE)
    text_s = time.perf_counter() - t0
    ref = clip_text.featurize_captions(sd, ids[:TEXT_CHECK_ROWS],
                                       dtype=torch.float32, device=DEVICE)
    err = float(np.abs(emb[:TEXT_CHECK_ROWS] - ref).max())
    tol = 2e-2 * max(1.0, float(np.abs(ref).max()))
    # the call above builds the tower on the host first; its forward alone
    tower = clip_text.TextTransformer()
    tower.load_state_dict(sd)
    tower.to(DEVICE).eval()
    rows = torch.as_tensor(ids, device=DEVICE)
    with torch.no_grad():
        tower(rows[:TEXT_BATCH])
        sync()
        t0 = time.perf_counter()
        for i in range(0, TEXT_ROWS, TEXT_BATCH):
            tower(rows[i:i + TEXT_BATCH])
        sync()
    forward_s = time.perf_counter() - t0
    record("text_tower", dict(
        rows=TEXT_ROWS, batch=TEXT_BATCH, shape=list(emb.shape),
        call_captions_per_s=TEXT_ROWS / text_s, call_s=text_s,
        forward_captions_per_s=TEXT_ROWS / forward_s, forward_s=forward_s,
        bf16_vs_fp32_max_abs_err=err, tolerance=tol))
    if emb.shape != (TEXT_ROWS, 512) or not np.isfinite(emb).all() \
            or not err <= tol:
        raise AssertionError(f"text tower: shape {emb.shape}, bf16 vs fp32 "
                             f"{err} (tolerance {tol})")
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = total
    print(json.dumps({"ssl_path": {k: out[k] for k in (
        "card", "matmul_precision", "launches", "wall_s")}}), flush=True)
    print(f"phase 15 (SSL towers) wall {out['wall_s']:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# Phase 16: the tower knobs and data parallelism
# ---------------------------------------------------------------------------

PHASE4 = {}    # phase 4's rate, batches, file bytes and float64 symbols
BF16_SOFTMAX = tuple(NO_BF16)
REMAT_BATCH, REMAT_STEPS = 128, 5
# the distributed runs: featurizer stages at full width, cut in length
DP_RUNS = {
    "banana_viz_VIC": ["rate.eb_use_pallas=True", "data_feat.n_epochs=1",
                       "data_feat.kwargs.length=20480",
                       "trainer.log_every=1",
                       "trainer.limit_eval_batches=0.2"],
    "stl10_bince": ["rate.eb_use_pallas=True",
                    "data_feat.kwargs.synthetic=True",
                    "data_feat.kwargs.synthetic_n=2048",
                    "data_feat.n_epochs=1", "trainer.log_every=1",
                    "trainer.limit_eval_batches=0.2"]}
DP_REDUCED = {
    "banana_viz_VIC": "1 epoch of 20 steps (20,480 samples) of the "
                      "recipe's 100 of 1000; widths not cut (batch 1024)",
    "stl10_bince": "1 epoch of 7 steps over 2,048 seeded synthetic images "
                   "(STL10_REDUCED's widths: ResNet-18, batch 256)",
    "evaluation": "the featurizer stage only; 20% of its evaluation "
                  "batches"}


def nearer_check(name: str, case, share: float, share32: float,
                 plains_equal: bool):
    """A bf16-softmax instantiation must be nearer its plain version under
    the same knob than the fp32-softmax plain version: a strictly smaller
    share of its outputs differs (an instantiation that ignored the knob
    would sit nearer the fp32 one). Vacuous where the two plain versions
    agree bit for bit (one key: the softmax is 1 in both chains)."""
    if not plains_equal and not share < share32:
        raise AssertionError(
            f"{name} with a bf16 softmax at {case}: {share} of its outputs "
            f"differ from the bf16-softmax plain version, {share32} from "
            f"the fp32 one: the knob did not reach the kernel")


def bf16_softmax_checks(fp32: dict | None = None) -> dict:
    """Phase 16a: K1 (every design `k1_plan` picks) and K2 (bf16 and fp32
    io) with `SOFTMAX_DTYPE=bfloat16` against their plain versions under
    the same knob (atol 2e-2, the share of outputs that differ, which must
    be below the share that differ from the fp32-softmax plain version:
    `nearer_check`), at every `K1_CHECKS` / `K2_CHECKS` case; then at
    ViT-B/32's width (B = 512 and 256) and the RN50 pool's fp32 shape,
    also held by `nearer_check` (K1's row code bit-exact), the times
    beside phase 3's
    fp32-softmax times (the same bytes, the same bound), K1's designs side
    by side. `fp32`: phase 3's timings, whose device ms each row shows
    beside its own."""
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    fp32 = fp32 or {}
    lib = fa._get_lib()
    cases = {"fused_attention": (k1_inputs, fa.fused_attention,
                                 fa.attention_plain, K1_CHECKS),
             "fused_attention_cls": (k2_inputs, fa.fused_attention_cls,
                                     fa.attention_cls_plain, K2_CHECKS)}
    out = {}
    with Knobs(SOFTMAX_DTYPE=torch.bfloat16), torch.inference_mode():
        designs = set()
        for name, (make, kernel, plain, shapes) in cases.items():
            worst = 0.0
            for i, (B, N, h, d, dt, _, opt) in enumerate(shapes):
                args = make(B, N, h, d, getattr(torch, dt), seed=i,
                            unaligned=opt.get("unaligned", False))
                if name == "fused_attention":
                    designs.add(fa.k1_plan(
                        B, N, h, d, args[0].dtype,
                        all(a.data_ptr() % 16 == 0 for a in args)).design)
                got, want = kernel(*args, h), plain(*args, h)
                want32 = plain(*args, h, softmax=torch.float32)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                share = float((got != want).float().mean())
                share32 = float((got != want32).float().mean())
                if not (bool(torch.isfinite(got).all()) and err <= 2e-2):
                    raise AssertionError(
                        f"{name} with a bf16 softmax at B={B} N={N} h={h} "
                        f"d={d} {dt} {opt}: {err} off its plain version")
                nearer_check(name, (B, N, h, d, dt, opt), share, share32,
                             bool(torch.equal(want, want32)))
                worst = max(worst, err)
                print(f"check {name} bf16 softmax B={B} N={N} h={h} d={d} "
                      f"{dt}{' (unaligned input)' if opt.get('unaligned') else ''}"
                      f": max_abs_err={err!r} share_differing={share!r} "
                      f"share_differing_vs_fp32_softmax={share32!r} ok",
                      flush=True)
            out[name] = dict(max_abs_err_over_checks=worst)
        if designs != {"wgmma", "onepass", "rows"}:
            raise AssertionError(f"K1's checks ran designs {designs}")
        N, h, d = SLICE["N"], SLICE["heads"], SLICE["d"]
        for name, (make, kernel, plain, _) in cases.items():
            for B in (512, BATCH):
                row = time_attention(name, make, kernel, plain, B, N, h, d)
                args = make(B, N, h, d, torch.bfloat16, seed=100)
                got, want = kernel(*args, h), plain(*args, h)
                want32 = plain(*args, h, softmax=torch.float32)
                plains_equal = bool(torch.equal(want, want32))
                row.update(max_abs_err=(got.float() - want.float()).abs()
                           .max().item(),
                           share_differing=float((got != want).float()
                                                 .mean()),
                           share_differing_vs_fp32_softmax=float(
                               (got != want32).float().mean()))
                nearer_check(name, (B, N, h, d), row["share_differing"],
                             row["share_differing_vs_fp32_softmax"],
                             plains_equal)
                if name == "fused_attention":
                    runs = {}
                    for design, run in k1_design_runs(lib, args[0],
                                                      h).items():
                        o = run()
                        err = (o.float() - want.float()).abs().max().item()
                        if not err <= 2e-2:
                            raise AssertionError(
                                f"K1's {design} design with a bf16 softmax "
                                f"off its plain version by {err}")
                        share = float((o != want).float().mean())
                        share32 = float((o != want32).float().mean())
                        nearer_check(f"K1's {design} design", (B, N, h, d),
                                     share, share32, plains_equal)
                        # the row code sums the exps in the plain version's
                        # order: bit-exact (phase 16's first runs)
                        if design == "rows" and share:
                            raise AssertionError(
                                f"K1's row code with a bf16 softmax at "
                                f"B={B}: {share} of its outputs off its "
                                f"plain version, which it matched bit for "
                                f"bit")
                        runs[design] = dict(
                            max_abs_err=err, share_differing=share,
                            share_differing_vs_fp32_softmax=share32,
                            ms=median_ms(run),
                            device_ms=device_ms(run, (DESIGN_KERNELS[
                                design],)))
                    row["designs"] = runs
                    print(f"time fused_attention bf16 softmax B={B} "
                          f"designs: {runs}", flush=True)
                base = fp32.get(name, {})
                base = base if B == 512 else base.get(f"at_b{B}", {})
                row["fp32_softmax_device_ms"] = base.get("device_ms")
                out[name][f"b{B}"] = row
        pool = RN50_POOL
        (q0, kv) = k2_inputs(pool["B"], pool["Ns"][0], pool["heads"],
                             pool["d"], torch.float32, seed=100)
        want = fa.attention_cls_plain(q0, kv, pool["heads"])
        want32 = fa.attention_cls_plain(q0, kv, pool["heads"],
                                        softmax=torch.float32)
        got = fa.fused_attention_cls(q0, kv, pool["heads"])
        row = time_attention("fused_attention_cls", k2_inputs,
                             fa.fused_attention_cls, fa.attention_cls_plain,
                             pool["B"], pool["Ns"][0], pool["heads"],
                             pool["d"], "float32")
        row.update(max_abs_err=(got - want).abs().max().item(),
                   share_differing=float((got != want).float().mean()),
                   share_differing_vs_fp32_softmax=float(
                       (got != want32).float().mean()),
                   fp32_softmax_device_ms=fp32.get(
                       "fused_attention_cls", {}).get(
                       f"rn50_pool_n{pool['Ns'][0]}_fp32", {}).get(
                       "device_ms"))
        nearer_check("fused_attention_cls", "the RN50 pool",
                     row["share_differing"],
                     row["share_differing_vs_fp32_softmax"],
                     bool(torch.equal(want, want32)))
        out["fused_attention_cls"]["rn50_pool_fp32"] = row
    print(json.dumps({"bf16_softmax": out}), flush=True)
    return out


def encode_under_knobs(card: str) -> dict:
    """Phase 16a: phase 4's 8 x 256 raw images encoded again with the
    same seeded tower and rate, (1) under `SOFTMAX_DTYPE=bfloat16`, its
    K1 and K2 launches counted around that run (the bf16 instantiations'
    main path; its file must differ from phase 4's, else the knob did not
    reach the kernels; its symbols against phase 4's as a record) and (2)
    with the
    tower built with `ln_dtype=bfloat16`: the file must equal phase 4's
    byte for byte (flax's LayerNorm rounds only its output, which the
    bf16 tower rounds anyway)."""
    import torch

    from lossyless_tpu_torch.hub.compressor import ClipCompressor
    from lossyless_tpu_torch.nn.vit import vit_b32

    comp, rate, batches = PHASE4["comp"], PHASE4["rate"], PHASE4["batches"]
    out = {}
    x0 = batches[0][0]
    s_fp32 = comp.codec.decode_batch(comp.compress(x0), comp.indexes)
    with tempfile.TemporaryDirectory() as tmp:
        with Knobs(SOFTMAX_DTYPE=torch.bfloat16):
            s_bf16 = comp.codec.decode_batch(comp.compress(x0),
                                             comp.indexes)
            sync()
            reset_launches()
            t0 = time.perf_counter()
            comp.compress_dataset(iter(batches), Path(tmp) / "sm.bin",
                                  is_info=False)
            t_enc = time.perf_counter() - t0
            launches = read_launches()
        n_layers = len(comp.model.blocks)
        want = {BF16_SOFTMAX[0]: (n_layers - 1) * N_BATCHES,
                BF16_SOFTMAX[1]: N_BATCHES,
                "fused_attention": 0, "fused_attention_cls": 0}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"the bf16-softmax encode launched "
                                 f"{launches}, expected {want}")
        sm_bytes = (Path(tmp) / "sm.bin").read_bytes()
        ln = ClipCompressor(*rate, clip_params=comp.model.state_dict(),
                            model=vit_b32(ln_dtype=torch.bfloat16),
                            raw_input_hw=RAW_HW, device=DEVICE)
        ln.compress_dataset(iter(batches), Path(tmp) / "ln.bin",
                            is_info=False)
        ln_equal = (Path(tmp) / "ln.bin").read_bytes() == \
            PHASE4["file_bytes"]
        del ln
    out.update(bf16_softmax=dict(
        launches=launches, encode_img_per_s=len(batches) * BATCH / t_enc,
        default_encode_img_per_s=PHASE4["encode_img_per_s"],
        file_equal_to_fp32_softmax=sm_bytes == PHASE4["file_bytes"],
        symbol_flips_vs_fp32_softmax=float((s_bf16 != s_fp32).mean()),
        symbol_flips_vs_float64=float((s_bf16 != PHASE4["s_f64"]).mean())),
        ln_dtype_bf16_file_equal=ln_equal)
    print(json.dumps({"encode_under_knobs": out}), flush=True)
    if out["bf16_softmax"]["file_equal_to_fp32_softmax"]:
        raise AssertionError("the bf16-softmax encode wrote phase 4's file: "
                             "the knob did not reach K1 and K2")
    if not ln_equal:
        raise AssertionError("ln_dtype=bfloat16 changed the bf16 tower's "
                             "streams")
    return out


def remat_step(card: str) -> dict:
    """Phase 16a: one fine-tuning step (forward, backward) of the ViT-B/32
    tower (bf16 compute, fp32 parameters, K1, K2 and K4) at batch 128 with
    `remat` off and on: the gradients equal (JAX's test_vit.py
    tolerances, rtol 1e-5 / atol 1e-6), the peak memory and the median
    step time of each, and the launches a step (remat recomputes each
    block's forward: K1 and K4 22 a step, K2 2)."""
    import torch

    from lossyless_tpu_torch.nn.vit import vit_b32

    (x, _, _), = train_images(1, seed=16, batch=REMAT_BATCH)
    out, grads = {}, {}
    for remat in (False, True):
        model = vit_b32(mlp_impl="kernel", remat=remat).init_weights(
            torch.Generator().manual_seed(0)).to(DEVICE)

        def step():
            model.zero_grad(set_to_none=True)
            (model(x).float() ** 2).mean().backward()

        step()
        sync()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        step()
        sync()
        peak = torch.cuda.max_memory_allocated()
        launches = read_launches()
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            step()
            sync()
            times.append(time.perf_counter() - t0)
        grads[remat] = [p.grad.float() for p in model.parameters()]
        k = 2 if remat else 1
        want = dict(fused_attention=11 * k, fused_attention_cls=k,
                    fused_mlp_block=11 * k)
        if {n: launches[n] for n in want} != want:
            raise AssertionError(f"remat={remat}: launches {launches}, "
                                 f"expected {want}")
        out[f"remat_{remat}"] = dict(
            peak_gib=peak / 2**30, step_ms=float(np.median(times)) * 1e3,
            launches={n: launches[n] for n in want})
        del model
        torch.cuda.empty_cache()
    diff = max(float(((a - b).abs() - 1e-5 * b.abs()).max())
               for a, b in zip(grads[True], grads[False]))
    out["gradients_bit_equal"] = all(torch.equal(a, b) for a, b in
                                     zip(grads[True], grads[False]))
    out["gradient_excess_over_rtol"] = diff
    print(json.dumps({"remat_step": out}), flush=True)
    if not diff <= 1e-6:
        raise AssertionError(f"remat moved the gradients: {diff}")
    return out


def hub_mesh(card: str) -> dict:
    """Phase 16b: `compress_dataset` of phase 4's images over a mesh of two
    replicas on cuda:0 and over `make_mesh(0)` (every visible card), each
    with the same seeded tower and rate: the file against phase 4's
    (`mesh=None`) byte for byte; where they differ, the symbol-flip share
    on the first batch against phase 4's, and against the float64 tower
    held to phase 4's bound; encode img/s and the K1 and K2 launches."""
    from lossyless_tpu_torch.core.mesh import make_mesh
    from lossyless_tpu_torch.hub.compressor import ClipCompressor
    from lossyless_tpu_torch.nn.vit import vit_b32

    rate, batches = PHASE4["rate"], PHASE4["batches"]
    weights = PHASE4["comp"].model.state_dict()
    out = {}
    for label, m in (("two_replicas_cuda0",
                      make_mesh(devices=["cuda:0"] * 2)),
                     ("make_mesh_0", make_mesh(0))):
        comp = ClipCompressor(*rate, clip_params=weights, model=vit_b32(),
                              raw_input_hw=RAW_HW, mesh=m)
        comp.compress(batches[0][0])
        sync()
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            t0 = time.perf_counter()
            comp.compress_dataset(iter(batches), Path(tmp) / "m.bin",
                                  is_info=False)
            t_enc = time.perf_counter() - t0
            launches = read_launches()
            equal = (Path(tmp) / "m.bin").read_bytes() == \
                PHASE4["file_bytes"]
        row = dict(mesh_size=m.size, file_equal_to_one_device=equal,
                   encode_img_per_s=len(batches) * BATCH / t_enc,
                   one_device_encode_img_per_s=PHASE4["encode_img_per_s"],
                   launches={k: launches[k] for k in
                             ("fused_attention", "fused_attention_cls")})
        want = dict(fused_attention=11 * m.size * N_BATCHES,
                    fused_attention_cls=m.size * N_BATCHES)
        if row["launches"] != want:
            raise AssertionError(f"mesh {label}: launches {launches}, "
                                 f"expected {want}")
        if not equal:
            s = comp.codec.decode_batch(comp.compress(batches[0][0]),
                                        comp.indexes)
            row["symbol_flips_vs_float64"] = float(
                (s != PHASE4["s_f64"]).mean())
            row["flip_bound"] = PHASE4["flip_bound"]
            if row["symbol_flips_vs_float64"] > PHASE4["flip_bound"]:
                raise AssertionError(f"mesh {label}: {row}")
        out[label] = row
        del comp
    print(json.dumps({"hub_mesh": out}), flush=True)
    return out


DP_CALLS = ("global_draw", "all_reduce_sum", "all_gather_rows",
            "average_gradients", "reduce_logs")


def count_dp_calls(mesh) -> dict:
    """Wrap `core.mesh`'s data-parallel functions (every caller reaches
    them as `mesh.<name>`) to count their calls inside a data-parallel
    step; the counts, filled as the stage runs."""
    counts = dict.fromkeys(DP_CALLS, 0)

    def wrap(name):
        fn = getattr(mesh, name)

        def counted(*args, **kwargs):
            if mesh.active() is not None:
                counts[name] += 1
            return fn(*args, **kwargs)
        setattr(mesh, name, counted)

    for name in DP_CALLS:
        wrap(name)
    return counts


def dp_child(spec: str):
    """One featurizer stage in a subprocess (phase 16c): with `group`, as
    rank 0 of a world of one under torchrun's environment, joined through
    `core.mesh.init_distributed` (NCCL), which first runs the
    differentiable collectives on the card, then trains through the
    data-parallel step (`core.mesh.data_parallel` is on in a group of any
    size), its collectives' calls counted; the fused epochs' logs, the
    launches and ms a step, one JSON line."""
    import os

    import torch

    from lossyless_tpu_torch.core import mesh
    from lossyless_tpu_torch.pipeline import config, run

    global DEVICE
    spec = json.loads(spec)
    DEVICE = spec["device"]
    if spec["group"]:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost",
                          MASTER_PORT=str(mesh.free_port()))
    joined = mesh.init_distributed(DEVICE)
    info = dict(group=joined)
    if joined:
        import torch.distributed as dist

        t = torch.arange(6.0, device=DEVICE).reshape(3, 2).requires_grad_()
        s = mesh.all_reduce_sum(t)
        gathered = mesh.all_gather_rows(t)
        (s.sum() + gathered.sum()).backward()
        info.update(backend=str(dist.get_backend()),
                    world=dist.get_world_size(),
                    collectives_ok=bool(torch.equal(s, t) and torch.equal(
                        gathered, t) and torch.equal(
                        t.grad, torch.full_like(t, 2.0))))
    # the same algorithms in both runs: the comparison is of the group
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = config.apply_precision(config.apply_overrides(
        config.preset(spec["preset"]), spec["overrides"]))
    dp_calls = count_dp_calls(mesh)
    reset_launches()
    with CaptureEpochs() as fused:
        run.run_featurizer_stage(cfg, DEVICE)
    info.update(launches=read_launches(), steps=fused.steps,
                dp_calls=dp_calls,
                ms_per_step=fused.seconds[-1] * 1e3 / fused.steps,
                logs={k: [float(v) for v in vals]
                      for k, vals in fused.logs[0].items()})
    if joined:
        torch.distributed.destroy_process_group()
    print(json.dumps({"dp_child": info}), flush=True)


def dp_run(name: str, group: bool, tmp: str) -> dict:
    spec = json.dumps(dict(preset=name, group=group, device=DEVICE,
                           overrides=DP_RUNS[
        name] + [f"out_dir={tmp}/{int(group)}/out",
                 f"ckpt_dir={tmp}/{int(group)}/ck"]))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " chip_smoke.dp_child(sys.argv[2])")
    res = subprocess.run([sys.executable, "-c", code, str(ROOT), spec],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    if res.returncode != 0:
        raise AssertionError(f"{name} (group={group}) failed: "
                             f"{res.stderr[-4000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith('{"dp_child"')][-1]
    return json.loads(line)["dp_child"]


# the data-parallel calls each run must make: every step's gradient
# average and log reduction, draws; BatchNorm's statistics and the
# contrastive gather where the model has them
DP_NEEDS = {"banana_viz_VIC": ("global_draw", "average_gradients",
                               "reduce_logs"),
            "stl10_bince": DP_CALLS}


def distributed_path(card: str) -> dict:
    """Phase 16c: `stl10_bince` and `banana_viz_VIC` featurizer stages at
    full width (`DP_REDUCED`), each in a subprocess as a world of one
    NCCL rank (torchrun's environment, `init_distributed`), which trains
    through the data-parallel step (the global draws, BatchNorm's
    all-reduced statistics, the contrastive all-gather, the gradient
    average and the log reduction, each call counted: `DP_NEEDS`), and in
    one with no process group: every logged step equal bit for bit (in a
    world of one each collective is an identity and BatchNorm's mean of
    the ranks' means is the mean: no arithmetic changes; the bf16 towers
    would turn a last-bit difference into bf16 ulps within a step), the
    K3 launches and ms a step of each."""
    out = dict(card=card, reduced=DP_REDUCED)
    with tempfile.TemporaryDirectory() as tmp:
        for name in DP_RUNS:
            runs = {g: dp_run(name, g, f"{tmp}/{name}") for g in (False,
                                                               True)}
            grp, alone = runs[True], runs[False]
            backend = "nccl" if DEVICE == "cuda" else "gloo"
            if not (grp["group"] and grp["backend"] == backend
                    and grp["world"] == 1 and grp["collectives_ok"]):
                raise AssertionError(f"{name}: the group {grp}")
            steps = grp["steps"]
            calls = grp["dp_calls"]
            if not (calls["average_gradients"] == steps
                    and calls["reduce_logs"] == steps
                    and all(calls[k] for k in DP_NEEDS[name])):
                raise AssertionError(f"{name}: the group's run made the "
                                     f"data-parallel calls {calls} in "
                                     f"{steps} steps")
            if set(grp["logs"]) != set(alone["logs"]):
                raise AssertionError(f"{name}: logged {sorted(grp['logs'])}"
                                     f" vs {sorted(alone['logs'])}")
            differ = {k: (v, alone["logs"][k])
                      for k, v in grp["logs"].items()
                      if v != alone["logs"][k]}
            row = dict(steps=steps, dp_calls=calls,
                       logs_bit_equal=not differ,
                       max_abs_log_diff=max(
                           float(np.abs(np.subtract(v, alone["logs"][k]))
                                 .max()) for k, v in grp["logs"].items()),
                       k3_launches={k: grp["launches"][k] for k in
                                    ("eb_likelihood", "eb_likelihood_bwd")},
                       ms_per_step_group=grp["ms_per_step"],
                       ms_per_step_alone=alone["ms_per_step"])
            out[name] = row
            print(f"distributed {name}: {row}", flush=True)
            if differ:
                raise AssertionError(f"{name}: the data-parallel step in a "
                                     f"world of one changed the logs: "
                                     f"{differ}")
            check_launches(grp["launches"], f"{name} in a world of one",
                           batchnorm=True)
    print(json.dumps({"distributed_path": out}), flush=True)
    return out


def knobs_and_mesh_path(card: str, timings: dict) -> dict:
    """Phase 16: the knobs (16a; `timings`: phase 3's), the hub mesh
    (16b), the distributed training (16c)."""
    t0 = time.perf_counter()
    out = dict(bf16_softmax=bf16_softmax_checks(timings),
               encode=encode_under_knobs(card), remat=remat_step(card),
               hub_mesh=hub_mesh(card), distributed=distributed_path(card))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: the external datasets, galaxy_regression, hypopt, profiling
# ---------------------------------------------------------------------------

COCO_TRAIN, COCO_VAL, COCO_CAPTIONS = 1024, 128, 5
COCO_SIZES = ((320, 240), (480, 640))     # (width, height), in turn
COCO_OVERRIDES = ["rate.eb_use_pallas=True", "data_feat.n_epochs=2",
                  "trainer.log_every=4"]
GALAXY_TRAIN, GALAXY_TEST, GALAXY_SIDE = 512, 128, 424
GALAXY_OVERRIDES = ["rate.eb_use_pallas=True", "data_feat.n_epochs=2",
                    "predictor.n_epochs=2"]
GALAXY_PLAIN = ("rate.eb_use_pallas=False",)
EXTERNAL_AB_STEPS = 3     # the logs held to the plain run, rtol 1e-2
HYPOPT_OVERRIDES = ["rate.eb_use_pallas=True", "data_feat.kwargs.length=8192",
                    "data_feat.n_epochs=4", "predictor.n_epochs=1"]
HYPOPT_TRIALS = 3
PROFILE_CLI = ["banana_viz_VIC", "--dev", "rate.eb_use_pallas=True",
               "data_feat.kwargs.length=20480", "predictor.n_epochs=1"]
ONFLY_OVERRIDES = ["rate.eb_use_pallas=True", "predictor.is_on_the_fly=True",
                   "data_feat.kwargs.synthetic=True",
                   "data_feat.kwargs.synthetic_n=512", "data_feat.n_epochs=1",
                   "predictor.n_epochs=1"]
EXTERNAL_REDUCED = {
    "clip_bottleneck_pretrain": "2 of the recipe's 30 epochs over 1,024 "
                                "generated COCO-layout JPEGs (320 x 240 and "
                                "480 x 640, 5 generated captions each) in "
                                "place of COCO's 118,287, featurized by the "
                                "text tower at seeded random weights; test "
                                "on 128",
    "galaxy_regression": "2 of the recipe's 100 featurizer epochs and 2 of "
                         "the probe's 20 over 512 generated 424 x 424 "
                         "kaggle-layout JPEGs and 128 test ones in place "
                         "of Galaxy Zoo's 61,578 and 79,975",
    "hypopt": "banana_viz_VIC at full width, 3 trials of 4 epochs of 8 "
              "steps (8,192 samples), 1 probe epoch",
    "profiling": "banana_viz_VIC --dev over 20,480 samples, 1 probe epoch",
    "fit_onfly": "clip_bottleneck_linear_eval, 1 featurizer and 1 probe "
                 "epoch over 512 synthetic STL10-shaped images",
    "widths": "none cut: ViT-B/32 (768, 12 layers, 12 heads, 224 px) with "
              "H_hyper's (128, 102) side latent; BALLE at hid_dim 64 on 128 "
              "px, z = 8192 (8 x 8 x 128), H_spatial with K3 at (8192, 25), "
              "batch 128; the banana MLPs 1024 x 2"}
# the launcher of phase 17b's CLI: the experiment CLI, then the launch
# counts of its run
GALAXY_LAUNCHER = (
    "import json, sys; from lossyless_tpu_torch import cli; "
    "from lossyless_tpu_torch.coding import eb_kernel; "
    "from lossyless_tpu_torch.nn import bn_kernel, flash_attn as fa; "
    "m = cli.main(sys.argv[1:]); "
    "print(json.dumps({'galaxy_cli': {'metrics': {k: v for k, v in m.items() "
    "if isinstance(v, (int, float, str))}, 'launches': {**fa.LAUNCHES, "
    "**eb_kernel.LAUNCHES, **bn_kernel.LAUNCHES}}}))")


def _smooth_image(rng, h: int, w: int):
    """A uint8 (h, w, 3) image: a coarse random grid, bicubic-upsampled
    (JPEG keeps it small and fast to write)."""
    from PIL import Image

    coarse = rng.integers(0, 256, (max(2, h // 40), max(2, w // 40), 3),
                          dtype=np.uint8)
    return np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC))


CAPTION_WORDS = ("a", "man", "woman", "dog", "cat", "riding", "sitting",
                 "on", "the", "of", "with", "street", "table", "red", "blue",
                 "plate", "food", "bus", "train", "bike", "near", "grass",
                 "two", "people", "standing", "in", "front", "building")


def write_coco_tree(root: Path, n_train: int, n_val: int,
                    sizes=COCO_SIZES, captions: int = COCO_CAPTIONS,
                    seed: int = 0) -> Path:
    """A COCO-layout tree: `train2017/` and `val2017/` JPEGs of `sizes`
    (width, height) in turn under unique 12-digit ids, and
    `annotations/captions_{train,val}2017.json` with `captions` generated
    captions an image."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    ids = rng.choice(10 ** 6, n_train + n_val, replace=False) + 1
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    ann_id = 0
    for split, split_ids in (("train", ids[:n_train]), ("val", ids[n_train:])):
        folder = root / f"{split}2017"
        folder.mkdir(exist_ok=True)
        images, annotations = [], []
        for i, img_id in enumerate(split_ids):
            w, h = sizes[i % len(sizes)]
            name = f"{int(img_id):012d}.jpg"
            Image.fromarray(_smooth_image(rng, h, w)).save(folder / name,
                                                          quality=90)
            images.append({"id": int(img_id), "file_name": name,
                           "width": w, "height": h})
            for _ in range(captions):
                words = rng.choice(CAPTION_WORDS, int(rng.integers(6, 14)))
                annotations.append({"id": ann_id, "image_id": int(img_id),
                                    "caption": " ".join(words) + "."})
                ann_id += 1
        (root / "annotations" / f"captions_{split}2017.json").write_text(
            json.dumps({"images": images, "annotations": annotations}))
    return root


def galaxy_targets(rng, n: int) -> np.ndarray:
    """(n, 37) vote fractions that sum as Galaxy Zoo's published targets
    do along its decision tree: question 1's three answers sum to 1, each
    later question's answers to the fraction that reached it (2 from
    1.2, 3, 4 and 5 from 2.2, 6 from 1, 7 from 1.1, 8 from 6.1, 9 from
    2.1, 10 and 11 from 4.1), in the columns' order."""
    ones = np.ones(n)

    def answers(reached, k):
        return reached[:, None] * rng.dirichlet(np.ones(k), n)

    q1 = answers(ones, 3)
    q2 = answers(q1[:, 1], 2)
    q3, q4, q5 = (answers(q2[:, 1], k) for k in (2, 2, 4))
    q6 = answers(ones, 2)
    q7 = answers(q1[:, 0], 3)
    q8 = answers(q6[:, 0], 7)
    q9 = answers(q2[:, 0], 3)
    q10, q11 = (answers(q4[:, 0], k) for k in (3, 6))
    return np.concatenate([q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11], 1)


def write_kaggle_tree(root: Path, n_train: int, n_test: int,
                      side: int = GALAXY_SIDE, seed: int = 0) -> Path:
    """A Galaxy Zoo challenge tree: `images_training_rev1/<GalaxyID>.jpg`
    and `images_test_rev1/<GalaxyID>.jpg` (side x side: an elliptical
    glow on a dark sky) under unique six-digit ids, and
    `training_solutions_rev1.csv` (GalaxyID and the 37 columns,
    `galaxy_targets`)."""
    from PIL import Image

    from lossyless_tpu_torch.analysis.kaggle import GALAXY_COLUMNS

    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(100000, 1000000), n_train + n_test,
                     replace=False)
    yy, xx = np.mgrid[:side, :side] / side - 0.5
    for sub, split_ids in (("images_training_rev1", ids[:n_train]),
                           ("images_test_rev1", ids[n_train:])):
        folder = root / sub
        folder.mkdir(parents=True, exist_ok=True)
        for gid in split_ids:
            a, b = rng.uniform(0.03, 0.2, 2)
            t = rng.uniform(0, np.pi)
            u = xx * np.cos(t) + yy * np.sin(t)
            v = -xx * np.sin(t) + yy * np.cos(t)
            glow = np.exp(-(u / a) ** 2 - (v / b) ** 2)
            img = glow[..., None] * rng.uniform(0.3, 1.0, 3) * 255
            Image.fromarray(img.astype(np.uint8)).save(folder / f"{gid}.jpg",
                                                       quality=90)
    targets = galaxy_targets(rng, n_train)
    lines = [",".join(["GalaxyID"] + GALAXY_COLUMNS)]
    lines += [",".join([str(int(gid))] + [f"{v:.6f}" for v in row])
              for gid, row in zip(ids[:n_train], targets)]
    (root / "training_solutions_rev1.csv").write_text("\n".join(lines) + "\n")
    return root


def first_batches(ds, n: int, batch: int, seed: int) -> list:
    """The first `n` batches of `ds.batches(batch, seed=seed)`, kept."""
    it = ds.batches(batch, seed=seed)
    out = list(itertools.islice(it, n))
    it.close()
    return out


def stream_rate(ds, batch: int, steps: int, seed: int) -> dict:
    """The batch stream alone (decode, transfer, augmentation on the card,
    prefetched), `steps` batches: images a second, ms a batch."""
    sync()
    t0 = time.perf_counter()
    it = ds.batches(batch, seed=seed)
    for x, _, _ in itertools.islice(it, steps):
        pass
    sync()
    it.close()
    s = time.perf_counter() - t0
    return dict(batches=steps, batch=batch, img_per_s=steps * batch / s,
                ms_per_batch=s * 1e3 / steps)


def profile_host_epoch(cfg, ds, card: str, steps: int, seed: int) -> dict:
    """`steps` host-fed steps of `cfg` over `ds`'s batches (decoded and
    augmented as the run's) on a fresh state under torch.profiler: idle
    share, device kernels a step, ms a step (the profiled wall)."""
    from lossyless_tpu_torch.pipeline import config, run

    cfg = config.apply_precision(copy.deepcopy(cfg))
    bsz = cfg.data_feat.batch_size
    state = run.build_state(cfg, 2 * steps, steps, device=DEVICE)
    warm = first_batches(ds, 1, bsz, seed)   # set-up outside the trace
    run.run_featurizer(cfg, warm, state=state, device=DEVICE,
                       log=lambda _: None)

    def epoch():
        batches = ds.batches(bsz, seed=seed + 1)
        run.run_featurizer(cfg, itertools.islice(batches, steps),
                           state=state, device=DEVICE, log=lambda _: None)
        batches.close()

    prof = device_profile(epoch, card, steps=steps, batch=bsz)
    prof["ms_per_step"] = prof["wall_ms"] / steps
    return prof


def coco_path(card: str, tmp: Path) -> dict:
    """17a: a generated COCO tree ingested with the text tower on the card,
    then `main(preset("clip_bottleneck_pretrain"))` on it (the launches
    counted on that run), a profiled host-fed epoch and the 3-step
    kernels-vs-plain check."""
    from lossyless_tpu_torch.data import ingest
    from lossyless_tpu_torch.pipeline import config, run

    raw = write_coco_tree(tmp / "coco_raw", COCO_TRAIN, COCO_VAL)
    sync()
    t0 = time.perf_counter()
    for split in ("train", "test"):
        ingest.ingest_coco_clip(raw, tmp / "data", split, device=DEVICE)
    sync()
    ingest_s = time.perf_counter() - t0
    n_captions = (COCO_TRAIN + COCO_VAL) * COCO_CAPTIONS
    out = dict(ingest_s=ingest_s, captions=n_captions,
               captions_per_s=n_captions / ingest_s)

    cfg = config.apply_overrides(config.preset("clip_bottleneck_pretrain"),
                                 COCO_OVERRIDES + [
        f"data_feat.kwargs.data_dir={tmp / 'data'}",
        f"out_dir={tmp}/coco/out", f"ckpt_dir={tmp}/coco/ckpt"])
    reset_launches()
    with CountForwards() as fw:
        result = timed_main(cfg, matmul_precision(),
                            need=("test/feat/loss",))
    launches = read_launches()
    result.pop("logs")
    result.update(launches=launches, tower_forwards=fw.n,
                  launches_per_tower_forward={
                      k: launches[k] / max(1, fw.n)
                      for k in ("fused_attention", "fused_attention_cls")})
    want_zero = ("fused_mlp_block", *NO_K5, *NO_K6)
    if any(launches[k] for k in want_zero) or fw.n == 0 or \
            launches["fused_attention"] != 11 * fw.n or \
            launches["fused_attention_cls"] != fw.n or \
            min(launches["eb_likelihood"], launches["eb_likelihood_bwd"]) < 1:
        raise AssertionError(f"the COCO run's launches {launches} over "
                             f"{fw.n} tower forwards")
    out["main"] = result
    print(json.dumps({"external_path_coco_main": result}), flush=True)

    cfg_i = config.apply_precision(copy.deepcopy(cfg))
    ds = run.instantiate_datamodule(cfg_i, cfg_i.data_feat, device=DEVICE)
    out["decode"] = stream_rate(ds, TRAIN_BATCH, COCO_TRAIN // TRAIN_BATCH,
                                seed=10)
    out["profile"] = profile_host_epoch(cfg_i, ds, card,
                                        COCO_TRAIN // TRAIN_BATCH, seed=20)
    print(json.dumps({"external_path_coco_profile": out["profile"]}),
          flush=True)
    out["kernels_vs_plain"] = train_ab(
        cfg_i, first_batches(ds, EXTERNAL_AB_STEPS, TRAIN_BATCH, seed=30),
        label="external_path_coco_kernels_vs_plain", need=CLIP_KERNELS)
    return out, launches


def check_submission(path: Path, test_ids: np.ndarray) -> dict:
    """The kaggle CSV: a header and a row a test galaxy, its ids the
    ingested test ids in order, every value in [0, 1]."""
    from lossyless_tpu_torch.analysis.kaggle import GALAXY_COLUMNS

    rows = path.read_text().strip().splitlines()
    header, body = rows[0].split(","), [r.split(",") for r in rows[1:]]
    ids = np.asarray([int(r[0]) for r in body])
    values = np.asarray([[float(v) for v in r[1:]] for r in body])
    ok = (header == ["GalaxyID"] + GALAXY_COLUMNS
          and len(rows) == len(test_ids) + 1
          and np.array_equal(ids, test_ids)
          and values.shape == (len(test_ids), 37)
          and bool(((values >= 0) & (values <= 1)).all()))
    out = dict(rows=len(rows), ids_equal=bool(np.array_equal(ids, test_ids)),
               min=float(values.min()), max=float(values.max()), ok=ok)
    if not ok:
        raise AssertionError(f"the kaggle submission {out}")
    return out


def galaxy_path(card: str, tmp: Path) -> dict:
    """17b: a generated kaggle tree ingested, `galaxy_regression` through
    the experiment CLI in a subprocess (its launches counted there), the
    submission checked against the ingested ids, the spatial coder's
    decode, a profiled host-fed epoch and the 3-step kernels-vs-plain
    check."""
    import torch

    from lossyless_tpu_torch.data import ingest
    from lossyless_tpu_torch.pipeline import config, run

    raw = write_kaggle_tree(tmp / "galaxy_raw", GALAXY_TRAIN, GALAXY_TEST)
    t0 = time.perf_counter()
    root = ingest.ingest_kaggle_galaxy(raw, tmp / "data")
    ingest_s = time.perf_counter() - t0
    out = dict(ingest_s=ingest_s, ingest_img_per_s=(
        GALAXY_TRAIN + GALAXY_TEST) / ingest_s)

    data = [f"data_feat.kwargs.data_dir={tmp / 'data'}",
            f"data_pred.kwargs.data_dir={tmp / 'data'}"]
    dirs = [f"out_dir={tmp}/galaxy/out", f"ckpt_dir={tmp}/galaxy/ckpt"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-c", GALAXY_LAUNCHER, "galaxy_regression",
         "--device", DEVICE, *GALAXY_OVERRIDES, *data, *dirs],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if cli.returncode:
        raise AssertionError(f"the galaxy CLI exited {cli.returncode}: "
                             f"{cli.stderr[-3000:]}")
    rec = next(json.loads(line)["galaxy_cli"] for line in
               cli.stdout.splitlines() if line.startswith('{"galaxy_cli"'))
    rec["wall_s"] = time.perf_counter() - t0
    launches = rec["launches"]
    check_launches(launches, "galaxy_regression", batchnorm=True)
    metrics = rec["metrics"]
    check_test_metrics({k: v for k, v in metrics.items()
                        if isinstance(v, float)}, "galaxy_regression")
    if metrics.get("kaggle_submission_ids") is not None:
        raise AssertionError(f"the ingested run's ids: {metrics}")
    rec["submission"] = check_submission(
        Path(metrics["kaggle_submission"]), np.load(root / "test_ids.npy"))
    out["cli"] = rec
    print(json.dumps({"external_path_galaxy_cli": rec}), flush=True)

    cfg = config.apply_overrides(config.preset("galaxy_regression"),
                                 GALAXY_OVERRIDES + data + dirs)
    out["spatial_coder"] = spatial_communication(
        cfg, GALAXY_TEST, label="external_path_galaxy_spatial_coder")
    cfg_i = config.apply_precision(copy.deepcopy(cfg))
    ds = run.instantiate_datamodule(cfg_i, cfg_i.data_feat, device=DEVICE)
    out["decode"] = stream_rate(ds, TRAIN_BATCH,
                                GALAXY_TRAIN // TRAIN_BATCH, seed=30)
    out["profile"] = profile_host_epoch(cfg_i, ds, card,
                                        GALAXY_TRAIN // TRAIN_BATCH, seed=40)
    print(json.dumps({"external_path_galaxy_profile": out["profile"]}),
          flush=True)
    out["kernels_vs_plain"] = train_ab(
        cfg_i, first_batches(ds, EXTERNAL_AB_STEPS, TRAIN_BATCH, seed=50),
        plain=GALAXY_PLAIN, label="external_path_galaxy_kernels_vs_plain",
        need=K3_BOTH)
    return out, launches


def hypopt_path(tmp: Path) -> dict:
    """17c: `hypopt` over `banana_viz_VIC` (loss.beta log-uniform, 3
    trials, median-stop pruning): every trial runs a rung, a surviving
    trial's full run trains only the epochs after its rung (steps
    counted), the result JSON is written."""
    from lossyless_tpu_torch.pipeline import config, hypopt, run

    base = config.apply_overrides(config.preset("banana_viz_VIC"),
                                  HYPOPT_OVERRIDES + [
        f"out_dir={tmp}/hypopt/out", f"ckpt_dir={tmp}/hypopt/ckpt"])
    calls = []

    def run_fn(cfg):
        with CountTrainSteps() as ts:
            metrics = run.main(cfg, device=DEVICE)
        calls.append(dict(experiment=cfg.experiment, rung=cfg.is_only_feat,
                          epochs=cfg.data_feat.n_epochs, steps=ts.n))
        return metrics

    t0 = time.perf_counter()
    result = hypopt(base, {"loss.beta": ("log_uniform", 1e-3, 1.0)},
                    monitor="test/pred/loss", n_trials=HYPOPT_TRIALS,
                    run_fn=run_fn, prune=True,
                    out_file=str(tmp / "hypopt" / "result.json"))
    wall = time.perf_counter() - t0
    spe = 8192 // base.data_feat.batch_size
    rungs = [c for c in calls if c["rung"]]
    fulls = [c for c in calls if not c["rung"]]
    out = dict(wall_s=wall, calls=calls, best=result["best"],
               pruned=[t.get("pruned", False) for t in result["trials"]],
               result_file=(tmp / "hypopt" / "result.json").exists())
    if len(rungs) != HYPOPT_TRIALS or not fulls or not out["result_file"] \
            or any(c["steps"] != spe for c in rungs) \
            or any(c["steps"] != (c["epochs"] - 1) * spe for c in fulls):
        raise AssertionError(f"hypopt: {out}")
    print(json.dumps({"external_path_hypopt": out}), flush=True)
    return out


def profiling_path(tmp: Path) -> dict:
    """17d: the experiment CLI with `--profile-dir` in a subprocess: its
    trace exists and names K3's forward and backward kernels among its
    CUDA kernel events."""
    from lossyless_tpu_torch.core.profiling import (TRACE_FILE,
                                                    device_memory_stats)

    pdir = tmp / "profile"
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "lossyless_tpu_torch.cli", *PROFILE_CLI,
         "--device", DEVICE, "--profile-dir", str(pdir),
         f"out_dir={tmp}/prof/out", f"ckpt_dir={tmp}/prof/ckpt"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if cli.returncode:
        raise AssertionError(f"the profiled CLI exited {cli.returncode}: "
                             f"{cli.stderr[-3000:]}")
    trace = pdir / TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"] \
        if trace.exists() else []
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    fwd = sorted(k for k in kernels if "eb_likelihood_kernel" in k)
    bwd = sorted(k for k in kernels if "eb_likelihood_bwd_kernel" in k)
    out = dict(wall_s=time.perf_counter() - t0,
               trace_bytes=trace.stat().st_size if trace.exists() else 0,
               kernel_names=len(kernels), k3_forward=fwd[:2],
               k3_backward=bwd[:2],
               device_memory_stats=device_memory_stats())
    print(json.dumps({"external_path_profiling": out}), flush=True)
    if not (fwd and bwd):
        raise AssertionError(f"the trace names no K3 kernels: {out}")
    return out


def onfly_path(tmp: Path) -> dict:
    """17e: `clip_bottleneck_linear_eval` with the probe trained on the
    fly: K1 and K2 launch inside `fit_onfly`'s steps."""
    from lossyless_tpu_torch.pipeline import config, predictor, run

    cfg = config.apply_overrides(
        config.preset("clip_bottleneck_linear_eval"), ONFLY_OVERRIDES + [
            f"out_dir={tmp}/onfly/out", f"ckpt_dir={tmp}/onfly/ckpt"])
    inside = {}
    saved = predictor.PredictorTrainer.fit_onfly

    def fit_onfly(self, *a, **k):
        before = read_launches()
        result = saved(self, *a, **k)
        sync()
        inside.update({n: v - before[n] for n, v in read_launches().items()})
        return result

    predictor.PredictorTrainer.fit_onfly = fit_onfly
    try:
        reset_launches()
        t0 = time.perf_counter()
        metrics = run.main(cfg, device=DEVICE)
        wall = time.perf_counter() - t0
    finally:
        predictor.PredictorTrainer.fit_onfly = saved
    out = dict(wall_s=wall, launches=read_launches(),
               launches_in_fit_onfly=inside,
               test_pred_acc=float(metrics["test/pred/acc"]))
    print(json.dumps({"external_path_fit_onfly": out}), flush=True)
    if not inside or inside["fused_attention"] < 11 or \
            inside["fused_attention_cls"] < 1 or \
            not np.isfinite(out["test_pred_acc"]):
        raise AssertionError(f"fit_onfly: {out}")
    return out


def external_path(card: str) -> dict:
    """Phase 17: the slice on the card (17a COCO, 17b Galaxy Zoo, 17c
    hypopt, 17d --profile-dir, 17e fit_onfly). Returns the launch counts
    on the COCO and the galaxy paths."""
    t_phase = time.perf_counter()
    out = dict(card=card, reduced=EXTERNAL_REDUCED)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        out["coco"], coco = coco_path(card, tmp)
        out["coco"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["galaxy"], galaxy = galaxy_path(card, tmp)
        out["galaxy"]["wall_s"] = time.perf_counter() - t0
        out["hypopt"] = hypopt_path(tmp)
        out["profiling"] = profiling_path(tmp)
        out["fit_onfly"] = onfly_path(tmp)
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"external_path": {
        "card": card, "wall_s": out["wall_s"],
        "coco": {k: out["coco"][k] for k in ("captions_per_s", "decode",
                                             "wall_s")},
        "galaxy": {k: out["galaxy"][k] for k in ("ingest_img_per_s",
                                                 "decode", "wall_s")},
        "launches_on_coco_path": coco,
        "launches_on_galaxy_path": galaxy}}), flush=True)
    print(f"phase 17 (external datasets) wall {out['wall_s']:.1f} s",
          flush=True)
    return dict(coco=coco, galaxy=galaxy)


# ---------------------------------------------------------------------------
# Phase 18: the analysis path (the classical baselines through the CLI, the
# port's minimal_code example, PretrainedAnalyser)
# ---------------------------------------------------------------------------

# phase 14's STL10 (96 x 96 x 3) with a synthetic test split built on the
# card by the CLI
CLASSICAL_PRESET = "stl10_bince"
CLASSICAL_IMAGES = 256
CLASSICAL_OVERRIDES = ["data_feat.kwargs.synthetic=True",
                       f"data_feat.kwargs.synthetic_n={CLASSICAL_IMAGES}"]
CLASSICAL_TIMES = ("test/feat/compress_time", "test/feat/receiver_time")
# banana_viz_VIC trained briefly for the analyser: --dev (2 epochs of 10
# of the 100 steps over 102,400 samples), featurizer only
ANALYSER_OVERRIDES = ["data_feat.kwargs.length=102400",
                      "rate.eb_use_pallas=True", "is_only_feat=True"]
ANALYSER_POINTS = 4096
EXAMPLE = dict(d=64, beta=0.01, n_epochs=20)   # minimal_code_torch's main
# 18b's kernels-vs-plain check: steps, and the largest relative difference
# of a step's loss, rate or distortion (fp32 on both sides: K3 agrees
# with its plain version to 1e-5)
EXAMPLE_AB_STEPS = 3
EXAMPLE_AB_TOL = 1e-4
ANALYSIS_REDUCED = {
    "classical": f"{CLASSICAL_PRESET}'s test split: {CLASSICAL_IMAGES} "
                 "seeded synthetic STL10-shaped images (96 x 96 x 3) of "
                 "STL10's 8,000, which are not in the checkout",
    "example": "none: minimal_code_torch at its defaults (4,000 + 1,000 "
               "synthetic 64-d features, 20 epochs of 100 steps at batch "
               "256)",
    "analyser": "banana_viz_VIC under --dev on 102,400 samples (2 epochs "
                "of 10 steps of the recipe's 100 of 1000), featurizer "
                "only; widths not cut"}


def have(module: str) -> bool:
    """Whether `module` imports here (matplotlib and sklearn are not on
    every machine)."""
    import importlib

    try:
        importlib.import_module(module)
    except ImportError:
        return False
    return True


def spawn(args: list, log: Path) -> subprocess.Popen:
    """`args` in a subprocess from the repository's root, its output
    (both streams) into `log`."""
    with log.open("w") as f:
        return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT,
                                text=True, cwd=ROOT)


def finish(proc: subprocess.Popen, log: Path, what: str,
           timeout: float = 300) -> str:
    """Wait for `proc`; its output, or an error with its end."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    if proc.returncode:
        raise AssertionError(f"{what} exited {proc.returncode}: "
                             f"{text[-3000:]}")
    return text


def classical_path(tmp: Path) -> tuple[dict, list]:
    """18a: `python -m lossyless_tpu_torch.cli <preset> --classical MODE`
    for jpeg, png and identity (and webp where PIL has it), one subprocess
    each, all started together. The lossy codecs' CSVs are held to
    `ClassicalCompressor.evaluate` over a CPU copy of the same batches
    (all but the two codec times), png and identity must be lossless.
    Returns the record and the host copy of the batches."""
    from PIL import features

    modes = ["jpeg", "png", "identity"]
    if features.check("webp"):
        modes.append("webp")
    else:
        print("phase 18a: this PIL lacks WebP; webp not run", flush=True)
    procs = {m: spawn(
        [sys.executable, "-m", "lossyless_tpu_torch.cli", CLASSICAL_PRESET,
         *CLASSICAL_OVERRIDES, f"out_dir={tmp}/classical",
         f"ckpt_dir={tmp}/classical_ckpt", "--classical", m, "--device",
         DEVICE],
        tmp / f"classical_{m}.log") for m in modes}
    try:
        return check_classical(tmp, procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def check_classical(tmp: Path, procs: dict) -> tuple[dict, list]:
    """18a's checks, as each CLI subprocess of `procs` ends; the record
    and the host copy of the batches."""
    import torch

    from lossyless_tpu_torch.compressors.classical import ClassicalCompressor
    from lossyless_tpu_torch.pipeline import config, run
    from lossyless_tpu_torch.train.metrics import read_results_csv

    # the same batches in this process, on the card, then copied to the
    # host
    cfg = config.apply_overrides(config.preset(CLASSICAL_PRESET),
                                 CLASSICAL_OVERRIDES)
    run.instantiate_datamodule(cfg, cfg.data_feat, device=DEVICE)
    ds = run._test_dataset(cfg, cfg.data_feat, DEVICE)
    bs = min(cfg.data_feat.val_batch_size, len(ds))
    host = [tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in b)
            for b in run._all_batches(ds, bs, cfg.trainer.seed)]
    n = sum(len(b[0]) for b in host)
    out = dict(images=n, modes={})
    for m, p in procs.items():
        finish(p, tmp / f"classical_{m}.log", f"--classical {m}")
        csvs = sorted(tmp.glob(f"classical/**/*_classical_{m}/**/"
                               "results_featurizer.csv"))
        if len(csvs) != 1:
            raise AssertionError(f"--classical {m}: results {csvs}")
        got = read_results_csv(csvs[0])
        if m in ("png", "identity"):
            if got["test/feat/mse"] != 0 or got["test/feat/ms_ssim"] != 1:
                raise AssertionError(f"{m} is not lossless: {got}")
        else:
            want = ClassicalCompressor(mode=m).evaluate(host)
            if set(got) != set(want) or any(
                    got[k] != float(want[k]) for k in want
                    if k not in CLASSICAL_TIMES):
                raise AssertionError(f"--classical {m}: CSV {got} against "
                                     f"the CPU copy's {want}")
        out["modes"][m] = {k.split("/")[-1]: got[k] for k in (
            "test/feat/n_bits", "test/feat/bpp", "test/feat/psnr",
            "test/feat/ms_ssim")}
        print(f"phase 18a {m}: CSV checked, "
              f"{got['test/feat/bpp']:.4f} bpp", flush=True)
    return out, host


def time_codecs(host: list, out: dict):
    """18a's codec speeds: each mode of `out` encodes and decodes the host
    batches' images, one mode after another in this process with no
    subprocess running; img/s over the encode and decode times alone (host
    time, no metric)."""
    from lossyless_tpu_torch.compressors.classical import (
        ClassicalCompressor, to_uint8)

    imgs = [img for x, _, _ in host for img in to_uint8(x)]
    for m, rec in out["modes"].items():
        codec = ClassicalCompressor(mode=m)
        t_enc = t_dec = 0.0
        for img in imgs:
            t0 = time.perf_counter()
            data = codec.compress_one(img)
            t1 = time.perf_counter()
            codec.decompress_one(data, img.shape)
            t_enc += t1 - t0
            t_dec += time.perf_counter() - t1
        rec.update(compress_time=t_enc / len(imgs),
                   receiver_time=t_dec / len(imgs),
                   host_img_per_s=len(imgs) / (t_enc + t_dec))
        print(f"phase 18a {m}: {rec['host_img_per_s']:.2f} img/s of host "
              f"time (the codec's encode and decode, timed alone; "
              f"{len(imgs)} images)", flush=True)


def example_path(card: str) -> dict:
    """18b: `examples/minimal_code_torch.py` at its defaults on the card,
    step by step: K3 and its backward launched once a training step, the
    ms a step timed from the built state and sampler, the decoded features
    equal to the dequantize path, the coded bits, one more epoch under
    torch.profiler, the kernels-vs-plain check, the probe where
    scikit-learn imports."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "minimal_code_torch", ROOT / "examples" / "minimal_code_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    z_tr, y_tr, z_te, y_te = ex.featurize(EXAMPLE["d"])
    n_epochs = EXAMPLE["n_epochs"]
    steps = n_epochs * ex.STEPS_PER_EPOCH
    state, epoch_fn = ex.setup(z_tr, y_tr, beta=EXAMPLE["beta"],
                               device=DEVICE)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    state = ex.run_epochs(state, epoch_fn, n_epochs)
    sync()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    want = dict(NO_K5, **NO_BF16, eb_likelihood=steps,
                eb_likelihood_bwd=steps)
    if {k: v for k, v in launches.items() if v} != \
            {k: v for k, v in want.items() if v}:
        raise AssertionError(f"the example's {steps} steps launched "
                             f"{launches}")
    coder, _, zc_tr = ex.code(state, z_tr)
    _, streams, zc_te = ex.code(state, z_te)
    err = max(float(np.abs(zc - ex.dequantize(coder, z)).max())
              for zc, z in ((zc_tr, z_tr), (zc_te, z_te)))
    if err > 1e-5:
        raise AssertionError(f"the example's decode is {err} off the "
                             f"dequantize path")
    bits = 8 * float(np.mean([len(s) for s in streams]))
    out = dict(card=card, steps=steps, train_s=train_s,
               step_ms=1e3 * train_s / steps, launches=launches,
               decode_max_abs_err=err, bits_per_sample=bits)
    print(f"phase 18b: {bits:.2f} coded bits/sample, {out['step_ms']:.3f} "
          f"ms a step over {steps} steps ({card})", flush=True)
    # one more epoch of the trained state, profiled
    prof = device_profile(lambda: epoch_fn(state, n_epochs + 1), card,
                          steps=ex.STEPS_PER_EPOCH, batch=ex.BATCH)
    prof["ms_per_step"] = prof["wall_ms"] / ex.STEPS_PER_EPOCH
    out["profile"] = prof
    print(json.dumps({"example_path_profile": prof}), flush=True)
    out["kernels_vs_plain"] = example_ab(ex, z_tr, y_tr)
    if have("sklearn"):
        out["probe_acc_raw"], out["probe_acc_compressed"] = ex.probe(
            z_tr, y_tr, z_te, y_te, zc_tr, zc_te)
    else:
        print("phase 18b: scikit-learn is absent; the probe (step 4) not "
              "run", flush=True)
    return out


def example_ab(ex, z_tr, y_tr) -> dict:
    """18b's kernels-vs-plain check: `EXAMPLE_AB_STEPS` steps of the
    example on K3 and as many on its plain version (`eb_use_pallas=False`),
    from the same weights (the example's seeded model) and the same draws
    (epoch seed 1), fp32 matmuls on both sides. The kernels run must
    launch K3 and its backward once a step and nothing else, the plain
    run nothing; each step's loss, rate and distortion must agree to
    `EXAMPLE_AB_TOL` relative."""
    import torch

    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    runs = {}
    try:
        for name, use in (("kernels", True), ("plain", False)):
            state, epoch_fn = ex.setup(
                z_tr, y_tr, beta=EXAMPLE["beta"], device=DEVICE,
                steps_per_epoch=EXAMPLE_AB_STEPS, eb_use_pallas=use)
            reset_launches()
            _, logs = epoch_fn(state, 1)
            launched = {k: v for k, v in read_launches().items() if v}
            want = dict.fromkeys(K3_BOTH, EXAMPLE_AB_STEPS) if use else {}
            if launched != want:
                raise AssertionError(f"18b's {name} run of "
                                     f"{EXAMPLE_AB_STEPS} steps launched "
                                     f"{launched}")
            runs[name] = {k: [float(v) for v in logs[k]]
                          for k in ("loss", "rate", "distortion")}
    finally:
        torch.set_float32_matmul_precision(precision)
    worst = max(abs(a - b) / max(abs(b), 1e-12)
                for k in runs["kernels"]
                for a, b in zip(runs["kernels"][k], runs["plain"][k]))
    out = dict(steps=EXAMPLE_AB_STEPS, **runs, max_rel_diff=worst,
               tolerance=EXAMPLE_AB_TOL)
    print(json.dumps({"example_path_kernels_vs_plain": out}), flush=True)
    if not worst <= EXAMPLE_AB_TOL:
        raise AssertionError(f"18b: kernels vs plain training logs differ "
                             f"by {worst} relative")
    return out


def rel_to_largest(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference over the largest magnitude of `want`."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def analyser_dirs(tmp: Path) -> list:
    return [f"out_dir={tmp}/analyser/out", f"ckpt_dir={tmp}/analyser/ckpt"]


def train_for_analyser(tmp: Path) -> subprocess.Popen:
    """18c's run: banana_viz_VIC trained briefly through the CLI on the
    card, in a subprocess (started while 18a runs)."""
    return spawn(
        [sys.executable, "-m", "lossyless_tpu_torch.cli", "banana_viz_VIC",
         "--dev", *ANALYSER_OVERRIDES, *analyser_dirs(tmp), "--device",
         DEVICE],
        tmp / "analyser.log")


def analyser_path(tmp: Path) -> dict:
    """18c: `PretrainedAnalyser` over the checkpoint of
    `train_for_analyser`'s run, on the card and on the CPU: `featurize`
    (points away from a rounding tie) and `decode` equal to 1e-5 of the
    largest entry; the codebook and traversals where matplotlib imports.
    """
    import torch

    from lossyless_tpu_torch.analysis.pretrained import PretrainedAnalyser
    from lossyless_tpu_torch.coding import entropy_bottleneck as eb
    from lossyless_tpu_torch.pipeline import config

    dirs = analyser_dirs(tmp)
    out = {}
    cfg = config.apply_overrides(config.preset("banana_viz_VIC"),
                                 ANALYSER_OVERRIDES + dirs)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 on both sides
    try:
        card_an = PretrainedAnalyser(cfg, device=DEVICE)
        host_an = PretrainedAnalyser(cfg, device="cpu")
        pts = np.random.default_rng(60).normal(
            0, 2, (ANALYSER_POINTS, 2)).astype(np.float32)
        got = card_an.featurize(pts).cpu().numpy()
        want = host_an.featurize(pts).numpy()
        # z_hat is round(z_in - median) mapped back: a point whose z_in
        # lies within 1e-4 of a rounding tie may round either way
        rate = host_an.model.rate_estimator
        with torch.no_grad():
            z_in = (rate.affine.process_in(host_an.model.encode(
                torch.from_numpy(pts))) - eb.medians(
                    rate.entropy_bottleneck.eb_params)[None]).numpy()
        tie = np.abs(np.abs(z_in - np.floor(z_in)) - 0.5) < 1e-4
        keep = ~tie.any(axis=1)
        z = np.random.default_rng(61).normal(0, 3, (ANALYSER_POINTS, 2)
                                             ).astype(np.float32)
        dec_card, dec_host = card_an.decode(z), host_an.decode(z)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # relative to the largest entry: a decoded coordinate near 0 carries
    # the roundoff of the others' scale
    feat_err = rel_to_largest(got[keep], want[keep])
    dec_err = rel_to_largest(dec_card, dec_host)
    out.update(points=ANALYSER_POINTS, near_tie=int((~keep).sum()),
               featurize_rel_err=feat_err, decode_rel_err=dec_err,
               decode_max_abs_err=float(np.abs(dec_card - dec_host).max()),
               decode_largest=float(np.abs(dec_host).max()))
    if feat_err > 1e-5 or dec_err > 1e-5:
        raise AssertionError(f"the analyser on the card against the CPU: "
                             f"{out}")
    if have("matplotlib"):
        out["plots"] = [str(Path(p).name) for p in (
            card_an.codebook_plot(tmp / "codebook.png"),
            *card_an.latent_traversal_plot(tmp / "traversals"))]
    else:
        print("phase 18c: matplotlib is absent; the codebook and the "
              "traversals not drawn", flush=True)
    return out


def analysis_path(card: str) -> dict:
    """Phase 18: the classical baselines (18a), the example (18b) and the
    analyser (18c). Returns the example path's launch counts."""
    t_phase = time.perf_counter()
    out = dict(card=card, reduced=ANALYSIS_REDUCED, seconds={})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        banana = train_for_analyser(tmp)
        try:
            out["classical"], host = classical_path(tmp)
            out["seconds"]["18a_cli"] = time.perf_counter() - t_phase
            finish(banana, tmp / "analyser.log", "the banana CLI")
            out["seconds"]["banana_cli"] = time.perf_counter() - t_phase
        finally:
            if banana.poll() is None:
                banana.kill()
                banana.wait()
        for name, step in (
                ("18a_codecs", lambda: time_codecs(host, out["classical"])),
                ("18b", lambda: out.update(example=example_path(card))),
                ("18c", lambda: out.update(analyser=analyser_path(tmp)))):
            t0 = time.perf_counter()
            step()
            out["seconds"][name] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"analysis_path": out}), flush=True)
    print(f"phase 18 (analysis path) wall {out['wall_s']:.1f} s", flush=True)
    return out["example"]["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from lossyless_tpu_torch.nn import _build

    t_script = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    walls = {}

    def phase(name: str, fn, *args):
        """`fn(*args)`, its wall time kept under `name`."""
        t = time.perf_counter()
        result = fn(*args)
        walls[name] = time.perf_counter() - t
        print(f"phase {name}: wall {walls[name]:.1f} s", flush=True)
        return result

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {seconds} (wall {time.perf_counter() - t0:.1f} s)",
          flush=True)
    ptxas = {name: ptxas_report(_build.build_log(name))
             for name in _build.SOURCES}
    for name, kernels in ptxas.items():
        for fn, info in kernels.items():
            print(f"ptxas {name} {fn}: {info}", flush=True)
    # the RN50 pool's instantiation: K2 in fp32 on the 16-byte path
    for fn, info in ptxas["attention"].items():
        if "k2_attention_kernel<float, true, false>" in fn:
            print(f"ptxas K2 fp32 16-byte path: {info.get('registers')} "
                  f"registers, {info.get('spill_stores', 0)} bytes spill "
                  f"stores, {info.get('spill_loads', 0)} bytes spill loads, "
                  f"{info.get('stack_frame', 0)} bytes stack frame",
                  flush=True)

    walls["build"] = time.perf_counter() - t0

    global OUT_DIR
    timings = phase("3 (K1, K2)", check_kernels)
    timings.update(phase("3b (K3, K4)", check_k3_k4))
    timings.update(phase("3c (K5a, K5b)", check_k5))
    k6 = phase("3d (K6)", check_k6)
    encode_launches = phase("4 (encode)", main_path, card)
    with tempfile.TemporaryDirectory() as OUT_DIR:
        state, train_launches = phase("5 (training)", train_path, card)
        phase("6 (train to serve)", train_to_serve, state, card)
        del state
        slice_launches, under_knob = phase("8 (slice)", slice_path, card)
    missing = [k for k in ("fused_attention", "fused_attention_cls",
                           "eb_likelihood", "eb_likelihood_bwd", *NO_K5)
               if not slice_launches[k]]
    if missing:
        raise AssertionError(f"the slice path launched no {missing}")
    phase("9 (CLI)", cli_path, card)
    phase("10 (bench)", bench_path, card)
    pipeline_launches = phase("11 (pipeline)", pipeline_path, card)
    banana_launches = phase("12 (banana)", banana_path, card)
    image_launches = phase("13 (image)", image_path, card)
    stl10_launches = phase("14 (STL10)", stl10_path, card)
    ssl_launches = phase("15 (SSL)", ssl_path, card)
    knobs = phase("16 (knobs, mesh)", knobs_and_mesh_path, card, timings)
    external = phase("17 (external)", external_path, card)
    example = phase("18 (analysis)", analysis_path, card)

    attention_cu = "lossyless_tpu_torch/nn/csrc/attention.cu"
    eb_cu = "lossyless_tpu_torch/coding/csrc/eb_likelihood.cu"
    sources = {"fused_attention": attention_cu,
               "fused_attention_cls": attention_cu,
               "eb_likelihood": eb_cu, "eb_likelihood_bwd": eb_cu,
               "fused_mlp_block": "lossyless_tpu_torch/nn/csrc/mlp_block.cu",
               "fused_attention_packed": attention_cu,
               "fused_attention_headbatched": attention_cu}
    replaces = {"fused_attention": "lossyless_tpu/nn/flash_attn.py:211",
                "fused_attention_cls": "lossyless_tpu/nn/flash_attn.py:349",
                "eb_likelihood": "lossyless_tpu/coding/pallas_eb.py:117",
                "eb_likelihood_bwd": "lossyless_tpu/coding/pallas_eb.py:153",
                "fused_mlp_block": "lossyless_tpu/nn/flash_attn.py:433",
                "fused_attention_packed": "lossyless_tpu/nn/flash_attn.py:146",
                "fused_attention_headbatched":
                    "lossyless_tpu/nn/flash_attn.py:178"}
    kernels = []
    for name in sources:
        if name in NO_K5:
            # K5a/K5b: the slice path's run (8b under their knob, 8c)
            counts = dict(
                launches=slice_launches[name],
                launches_per_training_step_under_knob=under_knob[name],
                launches_on_pipeline_path=pipeline_launches[name],
                launches_on_banana_path=banana_launches[name],
                launches_on_image_path=image_launches[name],
                launches_on_stl10_path=stl10_launches[name],
                launches_on_ssl_path=ssl_launches.get(name, 0),
                launches_on_coco_path=external["coco"][name],
                launches_on_galaxy_path=external["galaxy"][name])
        else:
            # K1/K2 on the encode path, K3/K4 on the training path (K1/K2
            # run there too: launches_per_training_step)
            on_encode = name.startswith("fused_attention")
            counts = dict(
                launches=(encode_launches if on_encode
                          else train_launches)[name],
                launches_per_encode_batch=encode_launches[name] / N_BATCHES,
                launches_per_training_step=train_launches[name]
                / TRAIN_STEPS,
                launches_on_slice_path=slice_launches[name],
                launches_on_pipeline_path=pipeline_launches[name],
                launches_on_banana_path=banana_launches[name],
                launches_on_image_path=image_launches[name],
                launches_on_stl10_path=stl10_launches[name],
                launches_on_ssl_path=ssl_launches.get(name, 0),
                launches_on_coco_path=external["coco"][name],
                launches_on_galaxy_path=external["galaxy"][name])
        if name.startswith("eb_likelihood"):   # phase 18b: one a step
            counts["launches_on_example_path"] = example[name]
        row = dict(name=name, route="cuda", source=sources[name],
                   replaces=replaces[name], **counts, **timings[name])
        # registers and spills of the kernel's instantiations
        if name in ("fused_attention", "fused_attention_cls"):
            # the fp32-softmax instantiations (the bf16 ones: their rows)
            row["ptxas"] = {fn: info for fn, info in ptxas["attention"].items()
                            if k1_k2_kernel(fn) == name
                            and not bf16_softmax_instance(fn)}
        elif name in NO_K5:
            row["ptxas"] = {fn: info for fn, info in ptxas["attention"].items()
                            if k5_kernel(fn, name)}
        elif name == "fused_mlp_block":   # both designs' kernels
            row["ptxas"] = ptxas["mlp_block"]
        else:   # K3's forward or backward kernels, every design
            bwd = name == "eb_likelihood_bwd"
            row["ptxas"] = {fn: info for fn, info in
                            ptxas["eb_likelihood"].items()
                            if ("eb_likelihood_bwd_kernel" in fn) == bwd}
        kernels.append(row)
    # K6: BatchNorm's forward and backward at phase 3d's shapes, launched
    # wherever a model holds a BatchNorm; a step of stl10_bince counted in
    # phase 14's main run
    for name in NO_K6:
        kernels.append(dict(
            name=name, route="cuda",
            source="lossyless_tpu_torch/nn/csrc/batchnorm.cu",
            replaces="none (flax nn.BatchNorm, lossyless_tpu/nn/layers.py: "
                     "XLA fusions on the TPU)",
            launches_per_stl10_bince_step=stl10_launches[
                f"{name}_per_bince_step"],
            launches_on_encode_path=encode_launches[name],
            launches_on_training_path=train_launches[name],
            launches_on_slice_path=slice_launches[name],
            launches_on_pipeline_path=pipeline_launches[name],
            launches_on_banana_path=banana_launches[name],
            launches_on_image_path=image_launches[name],
            launches_on_stl10_path=stl10_launches[name],
            launches_on_ssl_path=ssl_launches.get(name, 0),
            launches_on_coco_path=external["coco"][name],
            launches_on_galaxy_path=external["galaxy"][name],
            launches_on_example_path=example[name],
            at=k6[name], ptxas={fn: info for fn, info in
                                ptxas["batchnorm"].items()}))
    # phase 16: K1's and K2's bf16-softmax instantiations, launched on the
    # encode under SOFTMAX_DTYPE=bfloat16
    bf16_launches = knobs["encode"]["bf16_softmax"]["launches"]
    for name, base in zip(BF16_SOFTMAX, ("fused_attention",
                                         "fused_attention_cls")):
        timed = knobs["bf16_softmax"][base]
        row = dict(name=name, route="cuda", source=attention_cu,
                   replaces=replaces[base] + " (SOFTMAX_DTYPE=bfloat16)",
                   launches=bf16_launches[name],
                   launches_on_coco_path=external["coco"][name],
                   launches_on_galaxy_path=external["galaxy"][name],
                   **timed["b512"])
        row["at_b256"] = timed[f"b{BATCH}"]
        row["max_abs_err_over_checks"] = timed["max_abs_err_over_checks"]
        if base == "fused_attention_cls":
            row["rn50_pool_fp32"] = timed["rn50_pool_fp32"]
        row["ptxas"] = {fn: info for fn, info in ptxas["attention"].items()
                        if k1_k2_kernel(fn) == base
                        and bf16_softmax_instance(fn)}
        kernels.append(row)
    print(json.dumps({"phase_walls_s": walls,
                      "script_s": time.perf_counter() - t_script}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    # every phase ran on the current device: one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
