#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ssad_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --bf16`` builds the kernels and runs phase 6's
bf16 checks alone, then ``bf16_alternatives``: the port's bf16
convolutions against ones that hand their f32 accumulation to the
BatchNorm, by time and by whether a row's result depends on its place in
the batch.)  It imports nothing of JAX or of the JAX package.  Phases
(each raises on failure; the script exits 0 only when all pass):

1. Print the card's name and power limit (nvidia-smi), build every CUDA
   kernel of the serving paths from ssad_tpu_torch/csrc (knn, knn_tiled,
   stem_pool, bn_act: one nvcc per source, started together) and print ptxas's
   register and spill lines and any note that it serialized wgmmas.
   Then, on the host (``stream:``), the SHA-256 of the first batch of
   ``_torch_jax_random.JaxTrainStream(0, …)`` (the JAX package's random
   stream rebuilt in numpy: indices and synthesis draws), which must equal
   ``STREAM_DIGEST`` (tests/_torch_card_fixtures.py, which
   tests/test_torch_jax_random.py holds JAX's own stream to: this
   machine's numpy gives the stream JAX gives).
2. Hold each kernel against its plain PyTorch version on the card (TF32
   off) at its paths' shapes, and time kernel, plain version and a
   library yardstick beside the card's bound; at the main shapes also
   the profiler's device µs per call and the blocks resident per SM:
   * the resident k-NN kernel (one launch: a thread-block cluster per
     query tile spreads the bank over up to 16 CTAs, each an 8×8
     register tile of IEEE f32 FMAs fed by cp.async; rank 0 merges the
     CTAs' top-k lists through distributed shared memory), max |Δ| ≤
     1e-5, at the request (8 × 700) and fit (300 × 700) shapes and more;
   * the fused stem (the 4×4 conv as an mma.sync bf16 product in 8-row
     bands kept in shared memory, four blocks per SM) at N ∈ {6728, 841,
     9, 1} patches, rtol 2⁻⁷ / atol 1e-6 (one bf16 ulp) with fewer than
     1e-3 of the elements not bit-equal;
   * the streaming bf16x3 k-NN kernel (wgmma m64n128k16 bf16 → f32 from
     two consumer warpgroups of 64 query rows, fed a 3-stage ring of
     128-byte-swizzled 64-deep slices by a TMA producer warp against
     mbarriers; each 64-deep group of products summed in a fresh
     accumulator and added to the running sum with IEEE f32 adds; the
     top-k taken straight from the accumulator registers; a grid of
     128-query tiles × bank splits chosen by ``_tiled_plan``) at the
     request (6728 × 29435) and fit (12615 × 29435) shapes, a ragged tile,
     duplicates across tiles and splits, near-duplicates at cos ≈ 1 and
     k = 1: max |Δ| ≤ 1e-5 against its plain version and ≤ 3e-5 against
     the f32 function, each case also through the bank's TiledBank (split
     once, as the served scorer holds it; the same bits required).  At
     the main shapes ``ms`` is timed against the TiledBank and
     ``ms_raw_bank`` against the raw bank; those lines also give the
     plan's splits and waves, the group depth G (from the built kernel)
     and the CTAs resident per SM;
   * the inference BatchNorm → (+ residual) → ReLU pass (16-byte loads,
     each thread's channel parameters in registers) at the widest sites
     of both trunks at the served batch, bf16, channels last: wrn50's
     6,728 × 256 × 16 × 16 with the projection's BatchNorm as residual and
     r18's 6,728 × 64 × 16 × 16 with the identity; bit-equal to its plain
     version, ms beside the bytes bound and the plain chain's ms.  Phases
     3 and 4 count its launches (17 a forward on the image path, 16 on
     the patch path).
3. Drive the image-mode serving path at full width: PeraNet/ResNet-18,
   256×256×3 inputs, 512-d embeddings, bf16 compute, seeded random
   weights in the reference layout; a 1000-row bank embedded from
   seeded synthetic images; ``cli export`` (batch 8, 70/30 fit → 700-row
   bank); the ``serve`` loader (ServedScorer on cuda + BatchingScorer)
   behind AnomalyHTTPServer on port 0; 32 POST /score requests from 4
   threads, npy and PNG bodies mixed.  Launch counts are reset just
   before and read just after.  Then: HTTP scores equal the direct
   scorer's, scores equal the plain-k-NN path's to 1e-5, the kernel ran,
   and the f32 model (cuDNN TF32 off) on the card matches the CPU port.
4. Drive the patch-mode serving path at full width: a seeded MVTec-layout
   tree of 63 train-good PNGs (50 train, 13 val); ``cli export --mode
   patch --n-normality-images 50`` (42,050 patch embeddings, 70/30 fit →
   a 29,435-row bank); the ``serve`` loader behind AnomalyHTTPServer; 16
   POST /score requests from 4 threads (half with ?heatmap=1, npy and PNG
   bodies mixed), 6,728 windows per served batch of 8.  Launch counts are
   reset just before the export and read just after the last request:
   the stem kernel ran for every normality chunk, calibration chunk and
   served batch, the tiled kernel for the fit and every such batch.  Then:
   the bank and header, the served scorer holds the bank's TiledBank
   (normalised and split once), HTTP map statistics equal the direct
   scorer's to 1e-6, the served maps equal maps rebuilt from the same
   embeddings through the plain tiled k-NN to 1e-5, every heatmap is a
   256×256 PNG, and the f32 model's patch embeddings on the card match
   the CPU port's to 1e-3.
5. The host's object masks first (``masks:``): the port's
   ``object_mask`` / ``subject_mask`` (numpy + scipy, no OpenCV) over the
   seeded 256² ``mask_corpus`` (the ten object subjects of the parity
   generator, discs on noise σ 0–10 and on a smooth texture, a border
   object, a ring, a thin bar, two objects of different and of equal
   size, a blank image, four cable images posterized with seed 0): ms
   per image, and the SHA-256 of the masks' bytes, which must equal
   ``MASK_DIGEST`` (tests/_torch_card_fixtures.py; tests/test_torch_masks.py
   holds the JAX package's OpenCV path to it on the non-cable images).
   Then drive the CutPaste pretext synthesizer (the trainer's batch maker) at
   DataConfig's batch of 96: a seeded 256² MVTec-layout tree of 12
   train-good PNGs per category (bottle, hazelnut, screw, carpet);
   ``prepare_pretext_data`` (object masks on the host), then five cases:
   bottle, hazelnut (per-image masks) and carpet (cut pool) at image
   level on 256² canvases, bottle and screw (pre-crop, per-image masks)
   in patch mode on 64² crops.  Per case:
   inputs uploaded once; draws on the host, synthesis on the card; the
   same draws through the port on the CPU (labels and images equal, bit
   for bit); one batch under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); the median
   ms per batch over 20 warm batches (CUDA events), with and without the
   draw + upload step, and images/s; the device busy share of one batch
   under the profiler.  Then ``cli qa`` in process on the card.  No
   kernel of the port lies on this path.
6. Drive two-phase training at full width: PeraNet/ResNet-18, bf16
   backbone, 256² batch 96, ``AugConfig`` defaults, bottle (its fixed-pose
   affine) from phase 5's tree (9 train, 3 val PNGs).  Launch counts are
   reset just before and read just after the main path: ``cli train``
   (1 projection + 3 fine-tune epochs, 8 steps an epoch; the bank fills
   in fine-tune epoch 2), ``cli export`` of the checkpoint without
   ``--imsize`` (the header's imsize and subject from its TrainConfig;
   the fit runs csrc/knn.cu) and a ServedScorer on 8 of the tree's
   images, whose scores must equal the plain-k-NN path's to 1e-5.  Fails
   when the bank holds fewer than 16 rows.  Then: one f32 fine-tune step
   (TF32 off) on the card against the CPU port from the same weights and
   draws (loss, logits, gradients, every parameter and running statistic,
   the filled bank and a given-mask insert; the largest |Δ| of each
   printed), at 64² batch 8 on tests/test_torch_train_cuda.py's disc
   images under the CPU parity limits, and at 256² batch 16 on the tree
   under fixed wider limits (tests/_torch_step_parity.py says
   why); at each, the card step with TF32 on, a planted fault, must break
   the limits.  Then the default dtype, bf16, layer by layer
   (``bf16_step_parity``): the CPU step records every ReLU input and
   convolution output and the cotangent at each, and the card
   step runs with each layer given the CPU's input and cotangent, at 64²
   batch 8 and at 256² batch 16 on the tree, under
   ``BF16_CARD_LIMITS`` / ``BF16_TREE_256_LIMITS``; a planted fault (the
   residual add in f32, rounded once after the ReLU) must break them; and
   the bf16 eval forward the same way (``bf16_eval_parity``): image mode
   on 8 256² images, patch mode on one image's 841 windows whose stem
   runs csrc/stem_pool.cu, each k-NN call (csrc/knn.cu, csrc/knn_tiled.cu)
   against its plain version; the per-layer readings print on lines of
   their own (``train layers bf16``, ``eval layers bf16``).  No earlier
   phase is cut for these checks.  Then one
   fill step under ``set_sync_debug_mode("error")``; and per stage
   (projection; fine-tune with the fill) the median ms per step over 10
   warm steps by CUDA events with and without the host draw + upload,
   images/s, the device busy share of one step under the profiler and
   its device µs by group (synthesis, forward, backward, optimizer,
   bank fill + insert).  No TPU kernel lies on the train step.
7. Drive evaluation at full width on phase 6's trained checkpoint (256²,
   bf16): a seeded test split beside phase 5's bottle images with MVTec
   bottle's counts (20 good; broken_large 20, broken_small 22,
   contamination 21, each with its ground-truth mask: 83 images, 5.4 M
   pixels).  Launch counts are reset just before and read just after
   ``cli evaluate`` (image level: csrc/knn.cu fits and scores on the
   checkpoint's bank), ``cli evaluate --patch-level`` (3 normality images
   → 2,523 windows, a 1,766-row bank: csrc/stem_pool.cu on every embedded
   batch, csrc/knn_tiled.cu for the fit and the scores), ``cli infer``
   and ``cli infer --patch-level``, all in process on the card; each
   kernel must run in its mode.  Then: every file the JAX evaluator writes
   exists (the t-SNE figure too), and ``inference.npz`` has the JAX keys and
   shapes.  Then the same steps through the library functions the CLI
   calls, synchronised, give the stages' times (embed, fit, score,
   Grad-CAM, pixel metrics: the on-card program by CUDA events against
   the host oracles on the same maps) and hold every kernel call of the
   path against the plain k-NN on the same inputs (1e-5): both fits'
   calibration scores (50 × 118 rows on csrc/knn.cu, 757 × 1,766 on
   csrc/knn_tiled.cu), the image scores, each 8-image batch of evaluate's
   ``score_patch_maps`` (6,728 and 2,523 windows; raw and upsampled maps)
   and infer's 69,803 windows; and the Grad-CAM maps (finite, in [0, 1], zero wherever y_hat is 0; a
   defect prediction whose saliency the ReLU cuts everywhere is zero too,
   and is counted) and the on-card metrics against the oracles (2e-4;
   AUPRO 3e-4), their ROC and PRO curves held monotone as
   tests/test_metrics_device.py holds its own (``curve_faults``; the
   trapezoid bound is for that test's untied scores).  Then
   that rule over that test's 200 problems on the card (``eval curves:``,
   ``curve_sweep``): no problem may break it.
8. Drive the other scorers and backbones.  (a) A wide_resnet50_2 PeraNet
   at its published widths (bottleneck (3, 4, 6, 3), inner width 2×,
   3,584 → 512 head; bf16, a seeded init: no pretrained weights are in
   the repository), saved with its TrainConfig, through ``cli export
   --mode patch --n-normality-images 10 --coreset 2048 --knn-k 1`` on
   phase 4's bottle tree (8,410 windows → 5,887 train rows → a 2,048-row
   bank: csrc/knn_tiled.cu) and 16 HTTP requests; launch counts reset
   just before and read just after, every tiled k-NN call recorded.
   Then: each recorded call (the fit's 2,523 calibration rows, the
   calibration summary's 3,364-window chunks, the warmup and the served
   batches of 6,728 windows) against the plain tiled k-NN on its own
   inputs (1e-5; as many calls as launches), the served maps against the
   plain tiled k-NN on the scorer's own embeddings (1e-5), the stem
   kernel against the plain stem with this model's stem (phase 2's
   tolerance), the tiled kernel at 6,728 × 2,048 (ms, device µs, plain,
   library, bound), the batch-8 ms and device µs by group, the export's
   stages (normality, the coreset selection under
   ``set_sync_debug_mode("error")``, the fit) equal to the artifact's
   bank, the peak memory, and the f32 model on 8 windows on the card
   (TF32 off) against the CPU port (1e-3).  (b) ``cli evaluate
   --patch-level --coreset 512 --knn-k 1`` on phase 7's checkpoint: a
   512-row coreset sends 6,728-window batches to csrc/knn.cu; every call
   of it, recorded, against the plain k-NN (1e-5), and its record at
   that shape.  (c) ``cli evaluate --scorer mahalanobis`` at both
   levels, ``cli export --scorer mahalanobis`` of phase 6's checkpoint
   and 8 HTTP requests; the fits and scores with TF32 on and off
   against a float64 host reference (scores relative 1e-5, mean 1e-6,
   precision 1e-4 relative; equal scores either way), and the served
   scores equal to evaluate's detector's.
9. Drive localization and the serving extras on phase 6's checkpoint and
   phase 7's test split, every k-NN and stem kernel call recorded.  (a)
   ``cli localize`` at image level (Grad-CAM) and ``--patch-level`` (3
   normality images → 2,523 windows → a 1,766-row bank: csrc/knn_tiled.cu
   on the fit and each image's 841 windows, csrc/stem_pool.cu on every
   window batch), 5 panels each; launch counts reset just before, read
   just after; wall seconds per image.  (b) The t-SNE of 339 seeded
   512-d points on the card (``evaluate``'s 256 artificial + 83 test
   embeddings; phase 7's image evaluate draws ``bottle_tsne.png``).  (c)
   The serving extras path, launch counts reset just before and read just
   after: ``cli export --dtype int8|bfloat16 --validate`` in image and
   patch mode (``--n-normality-images 3``), a float32 image artifact,
   ``cli evaluate-artifact`` of the int8 ones, then a server over the f32
   image artifact and one over the int8 patch artifact (each with the
   ``serve`` reloader), each driven by ``cli serve-bench --url`` at 4
   clients while ``/metrics`` is scraped and one ``POST /admin/reload``
   lands mid-run.  Then: every recorded call against its plain version
   on its own inputs (k-NN 1e-5; the stem at phase 2's tolerance), no
   failed or shed request, the reload answered 200, the metrics carry the
   request counters and the drift families, the artifacts' sizes and the
   int8-vs-f32 drift.
10. Serve at ``--devices 0`` (one card: one replica) through the native
   C++ front end.  (a) In process, launch counts reset just before and
   read just after, every kernel call recorded: phase 9's f32 image and
   int8 patch artifacts behind ``NativeAnomalyHTTPServer`` with the
   ``serve`` reloader, ``serve-bench --url`` at 4 clients with /metrics
   scraped and a reload mid-run, the transport's shed and protocol-error
   counts 0, every call against its plain version.  (b) ``cli serve
   --frontend native|stdlib --devices 0`` in a second process per
   artifact (it must report the front end asked for), ``serve-bench
   --url`` at 4 and 16 clients for at least 3 s each, 16 seeded images
   against the in-process scorer within KNN_TOL, SIGTERM → exit 0
   within 30 s; one ``serving native:`` line with qps, p50 and p95 per
   artifact, front end and client count, the batches' occupancy and the
   g++ build time.
11. The harness.  (a) ``cli doctor`` in a second process: exit 0, backend
   ``cuda`` with at least one device, ``_build/`` writable; the whole line
   is printed, ``native_loader.available`` (whether the card machine built
   the threaded PNG/JPEG loader) with it.  (b) ``cli profile --what
   patch`` (256², batch 8: windows → stem → PeraNet → the resident k-NN on
   a seeded 1,000-row bank) and ``--what train`` (phase 5's bottle tree,
   256², batch 96, bf16, the fine-tune step with the fill), 10 steps each
   under PyTorch's default TF32 flags; each must write a non-empty trace.
   (c) ``cli parity`` at its defaults: the synthetic trio (carpet, bottle,
   hazelnut), 256², batch 96, ResNet-18, bf16, 5 + 15 epochs, both modes,
   patch 32/stride 8, seed 0; one ``parity:`` line with each subject's and
   the mean image AUROC/F1 and pixel AUROC/IoU/AUPRO beside the JAX
   package's committed numbers on the same trio, and the train and
   evaluate seconds of each mode; it fails below a mean image AUROC of
   0.80 or a mean pixel AUROC of 0.90.  Launch counts are reset just
   before (b) and (c) and read just after each; every kernel call of both
   is recorded and held against its plain version (k-NN 1e-5, the stem at
   phase 2's tolerance).
12. Drive the multi-device path on the one card (parallel/).  (a) ``cli
   train-multi --stack 2`` over bottle and cable (phase 5's tree, 256²,
   batch 96, bf16, cut to 1 + 1 epochs of 2 steps): each checkpoint
   loaded, each history's epochs; each category's first stacked step
   against its single-category ``Trainer.train_step`` on the same draws
   and stacked data (TREE_256_LIMITS, cuDNN deterministic, bit-equal
   reported); ms per stacked step against the two single steps.  (b) The
   data-parallel step on NCCL at world size 1 (3 steps) against the
   plain trainer's, then ``cli train --data-shards 1``.  (c) Two shards
   on the one card, ``maybe_shard_engine(engine, 2, [cuda:0, cuda:0])``,
   on phase 6's weights in f32 and phase 7's test split: image level (the
   forward, the k-NN fit and scores), patch level (sharded normality,
   every 8-image batch's maps: the stem and the tiled k-NN on each
   shard) and the resident k-NN on each shard against a 1,000-row bank:
   maps and scores within 1e-5 of the unsharded engine, embeddings and
   logits within F32_MODEL_TOL of 1 + |ref| (a half batch may take other
   cuDNN algorithms).  (d) ``evaluate_categories``
   with ``category_shards=2`` on [cuda:0, cuda:0] over (a)'s checkpoints
   at patch level: pixel AUROC, IoU and AUPRO within 1e-6 of the
   sequential sweep.  Launch counts are reset just before (c)'s sharded
   runs and read just after (d)'s; every kernel call is recorded and
   held against its plain version.
13. The two composed end-to-end runs.  (a) ``readiness:`` ``cli train
   --dataset-dir --pretrained-backbone`` at full width (ResNet-18, 256²,
   batch 96, bf16) on phase 5's bottle tree with a seeded torchvision-layout
   ``.pth`` (running means N(0, 1)), cut to 1 + 3 epochs of one step, then
   ``cli evaluate`` at image level on phase 7's test split: the
   checkpoint's conv1 and a backbone running mean correlate above 0.8 with
   the file's conv1 and bn1.running_mean, ``image_auroc=`` is printed and
   the Markdown table names bottle.  (b) ``multi15:`` ``cli train-multi
   --subjects all --stack 8 --resume-dir`` in a second process on cuda:0
   over the parity generator's 15 categories at 64² (8 train-good images
   each; batch 96, 1 + 4 epochs of one step): SIGTERM at the first group
   snapshot → exit 75, a resume hint, no checkpoint; the same command →
   exit 0, the texture and fixed chunks announced with their padding
   lines, 15 checkpoints with 1 + 4 epochs of history; then ``cli
   evaluate --subjects all`` at image level on them in this process.
   Launch counts are reset just before each evaluation path and read just
   after; csrc/knn.cu must run on both, and every call is recorded and
   held against its plain version.
14. Print one JSON line of kernel records (all three kernels, with their
   launches on the training, evaluation, scorer, localize, serving
   extras, native serving, profile, parity and multi-device paths, and the
   resident k-NN's on the readiness and 15-category paths), the script's
   seconds, the card line again, and the final {"ok": true, "device": ...}
   line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import io
import json
import math
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

from _torch_card_fixtures import (  # noqa: E402  (tests/ on sys.path above)
    IMSIZE, MASK_CORPUS, MASK_DIGEST, STREAM_DIGEST, SYNTH_IMAGES, SYNTH_TREE, curve_faults,
    curve_sweep, mask_corpus_image, mask_digest, on_device_pixel_metrics, synthetic_images,
    torchvision_state_dict, write_eval_split, write_synth_tree)

#: NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
KNN_TOL = 1e-5
KNN_F32_TOL = 3e-5  # the bf16x3 function against the f32 one
F32_MODEL_TOL = 1e-4
STEM_RTOL, STEM_ATOL, STEM_MAX_FLIPPED = 2.0**-7, 1e-6, 1e-3
PATCH_F32_MODEL_TOL = 1e-3  # a one-ulp bf16 flip in the stem carries through the backbone
#: csrc/bn_act.cu launches a ResNet-18 forward: 8 basic blocks × 2, and the
#: stem's BatchNorm on the image path (the patch path's is in the stem kernel)
BN_ACT_SITES_FROM_STEM, BN_ACT_SITES_IMAGE = 16, 17
BN_ACT_SITES_WIDE_FROM_STEM = 48  # Wide-ResNet-50-2: 16 bottleneck blocks × 3
N_REQUESTS, N_THREADS = 32, 4
BATCH, BANK_ROWS = 8, 1000
#: patch mode: 63 train-good images (50 train + 13 val), 841 windows each
PATCH_IMAGES, NORMALITY_IMAGES, PATCH_REQUESTS = 63, 50, 16
WINDOWS = 841
#: synthesis: timed batches
SYNTH_TIMED = 20
SYNTH_CASES = (("bottle", False), ("hazelnut", False), ("carpet", False), ("bottle", True),
               ("screw", True))
#: training at DataConfig's batch of 96: 9 train PNGs duplicated to 774 →
#: 8 steps an epoch
TRAIN_BATCH, TRAIN_MIN_LEN, TRAIN_MIN_BANK, TRAIN_TIMED, TRAIN_PARITY_BATCH = 96, 768, 16, 10, 16
#: scorers: the wide patch path (10 normality images → 8,410 windows → 5,887
#: train rows → a 2,048-row coreset: the tiled kernel); a 512-row coreset in
#: phase 7's patch evaluate (the resident kernel at 6,728 queries)
WIDE_ARCH, WIDE_NORMALITY, WIDE_CORESET, WIDE_F32_WINDOWS = "wide_resnet50_2", 10, 2048, 8
EVAL_CORESET = 512
MAHA_REL_TOL = 1e-5
#: phase 9: panels per localize level, t-SNE points (evaluate's 256
#: artificial + 83 test embeddings), the patch exports' normality images,
#: serve-bench requests per artifact
LOCALIZE_IMAGES, TSNE_POINTS, EXTRAS_NORMALITY = 5, 339, 3
EXTRAS_IMAGE_REQUESTS, EXTRAS_PATCH_REQUESTS = 640, 320
#: phase 10: the in-process native bench's requests (image, patch), the
#: second-process benches' client counts, the images checked against the
#: in-process scorer
NATIVE_INPROC_REQUESTS, NATIVE_CLIENTS, NATIVE_CHECK_IMAGES = (320, 160), (4, 16), 16
#: phase 11: ``cli profile`` steps and patch batch; the floors of ``cli
#: parity``'s means that only a broken pipeline misses (chance is 0.5)
PROFILE_STEPS, PROFILE_BATCH = 10, 8
PARITY_IMAGE_AUROC_FLOOR, PARITY_PIXEL_AUROC_FLOOR = 0.80, 0.90
#: phase 12: train-multi's two fixed-pose subjects and its epoch length (9
#: train PNGs duplicated to 198 → 2 steps of 96), the timed steps, the
#: sharded engine's limit against the unsharded one, cable's test split
MULTI_SUBJECTS, MULTI_MIN_LEN, MULTI_TIMED, MULTI_TOL = ("bottle", "cable"), 192, 5, 1e-5
MULTI_CABLE_SPLIT = (("good", 10), ("broken_large", 10))
#: phase 13: the correlation the readiness run's checkpoint must keep with
#: the weight file (the JAX test's); the 15-category tree's size and
#: train-good images a category (a bank under 100 rows leaves ``evaluate``
#: to fit on the train split's embeddings, and the fit needs 4: 8 images
#: give 6 or 7), train-multi's batch (one step an epoch)
READINESS_CORR, MULTI15_IMSIZE, MULTI15_TRAIN, MULTI15_BATCH = 0.8, 64, 8, 96
#: the JAX package's accuracy on the same synthetic trio at the same
#: defaults (256², batch 96, ResNet-18, 5 + 15 epochs, seed 0), copied from
#: outputs/parity/parity_summary.json (accuracy only: no time of it is used)
JAX_TRIO_SOURCE = "outputs/parity/parity_summary.json"
JAX_TRIO = {
    "carpet": {"image_auroc": 1.0, "image_f1": 1.0, "pixel_auroc": 0.9918205738067627,
               "iou": 0.6129595637321472, "aupro": 0.9725207090377808},
    "bottle": {"image_auroc": 0.93, "image_f1": 0.8888888888888888,
               "pixel_auroc": 0.9890516996383667, "iou": 0.5885282158851624,
               "aupro": 0.9661177396774292},
    "hazelnut": {"image_auroc": 0.9500000000000001, "image_f1": 0.9,
                 "pixel_auroc": 0.9780007004737854, "iou": 0.5699502229690552,
                 "aupro": 0.9445184469223022},
}
JAX_TRIO_MEAN = {"image_auroc": 0.9600000000000001, "image_f1": 0.9296296296296296,
                 "pixel_auroc": 0.9862909913063049, "iou": 0.590479334195455,
                 "aupro": 0.9610522985458374}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def reference_state_dict(seed: int = 0) -> dict:
    """Random reference-layout PeraNet weights, He-scaled so eval-mode
    activations stay finite through 18 conv layers, with non-trivial BN
    running statistics."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def add_bn(prefix, c):
        sd[f"{prefix}.weight"] = t(rng.uniform(0.8, 1.2, c))
        sd[f"{prefix}.bias"] = t(rng.normal(0, 0.05, c))
        sd[f"{prefix}.running_mean"] = t(rng.normal(0, 0.1, c))
        sd[f"{prefix}.running_var"] = t(rng.uniform(0.5, 2.0, c))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    def add_conv(name, o, i, k):
        sd[f"{name}.weight"] = t(rng.normal(0, (i * k * k) ** -0.5, (o, i, k, k)))

    def add_linear(name, o, i, bias):
        sd[f"{name}.weight"] = t(rng.normal(0, i**-0.5, (o, i)))
        if bias:
            sd[f"{name}.bias"] = t(rng.normal(0, 0.05, o))

    pre = "feature_extractor"
    add_conv(f"{pre}.conv1", 64, 3, 7)
    add_bn(f"{pre}.bn1", 64)
    chans = {1: (64, 64), 2: (64, 128), 3: (128, 256), 4: (256, 512)}
    for stage, (cin, cout) in chans.items():
        for block in range(2):
            p = f"{pre}.layer{stage}.{block}"
            i = cin if block == 0 else cout
            add_conv(f"{p}.conv1", cout, i, 3)
            add_bn(f"{p}.bn1", cout)
            add_conv(f"{p}.conv2", cout, cout, 3)
            add_bn(f"{p}.bn2", cout)
            if stage > 1 and block == 0:
                add_conv(f"{p}.downsample.0", cout, i, 1)
                add_bn(f"{p}.downsample.1", cout)
    add_linear("concatenator.0", 512, 896, bias=False)
    add_bn("concatenator.1", 512)
    for i in range(3):
        add_linear(f"latent_space.{i}.0", 512, 512, bias=False)
        add_bn(f"latent_space.{i}.1", 512)
    add_linear("latent_space.3", 512, 512, bias=True)
    add_bn("latent_space.4", 512)
    add_linear("classifier", 4, 512, bias=True)
    return sd


def cuda_ms(fn, iters: int = 200, warmup: int = 10, budget_s: float = 0.3) -> float:
    """CUDA-event ms per call over back-to-back calls after a warmup; the
    count of calls is cut so that the timing takes about ``budget_s``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(3, min(iters, int(budget_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernel_us(fn, match: str, calls: int = 50) -> list:
    """The profiler's device µs of each kernel whose name holds ``match``,
    over ``calls`` back-to-back calls after a warmup."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    if not kernels:
        fail(f"the profiler saw no device time for {match!r}")
    return [e.time_range.end - e.time_range.start for e in kernels]


def device_us(fn, match: str, calls: int = 50) -> float:
    """The profiler's device time per call of the kernels whose name holds
    ``match``, over ``calls`` back-to-back calls after a warmup."""
    return sum(device_kernel_us(fn, match, calls)) / calls


def knn_bound(n: int, m: int, d: int):
    """(bound_ms, bound_by): inputs read once + output written once over
    the HBM rate, vs the f32 dot products and norms over the FP32 rate."""
    nbytes = 4 * (n * d + m * d + n)
    flops = 2 * n * m * d + 2 * (n + m) * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_knn_kernel(device):
    """Phase 2: kernel vs plain version at every listed shape."""
    import torch

    from ssad_tpu_torch.ops import knn

    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    cases = {}
    for name, n, m, d, k in (
        ("serve", 8, 700, 512, 3), ("fit", 300, 700, 512, 3), ("k1", 37, 1000, 512, 1),
    ):
        cases[name] = (randn(n, d), randn(m, d), k)
    base = randn(600, 512)
    cases["duplicates"] = (base[:16] + 1e-3 * randn(16, 512), torch.cat([base, base[:100]]), 3)
    cases["small_bank"] = (randn(8, 512), randn(20, 512), 3)

    records = {}
    for name, (q, b, k) in cases.items():
        out = knn.knn_cosine_scores_cuda(q, b, k=k)
        torch.cuda.synchronize()
        ref = knn.knn_cosine_scores_plain(q, b, k=k)
        err = float(torch.max(torch.abs(out - ref)))
        if not err <= KNN_TOL:
            fail(f"knn kernel vs plain on {name} {tuple(q.shape)}x{tuple(b.shape)}: max|d|={err}")
        qn, bn = knn.l2_normalize(q), knn.l2_normalize(b)
        rec = {
            "shape": [q.shape[0], b.shape[0], q.shape[1]], "k": k, "max_abs_err": err,
            "ms": cuda_ms(lambda: knn.knn_cosine_scores_cuda(q, b, k=k)),
            "plain_ms": cuda_ms(lambda: knn.knn_cosine_scores_plain(q, b, k=k)),
            "library_ms": cuda_ms(lambda: torch.topk(qn @ bn.T, k, dim=1)),
        }
        rec["bound_ms"], rec["bound_by"] = knn_bound(q.shape[0], b.shape[0], q.shape[1])
        if name in ("serve", "fit"):
            plan = knn._plan(q.shape[0], b.shape[0], q.shape[1])
            rec["device_us"] = device_us(lambda: knn.knn_cosine_scores_cuda(q, b, k=k), "knn_")
            rec["plan"] = plan._asdict()
            clusters = knn.knn_active_clusters(q.shape[0], b.shape[0], q.shape[1], device)
            rec["resident_clusters"] = clusters
            rec["resident_blocks_per_sm"] = clusters * plan.cluster / sms
        records[name] = rec
        print(f"knn {name}: {json.dumps(rec)}", flush=True)
    return records


def check_stem_kernel(device):
    """The fused stem kernel vs its plain version; library yardstick:
    cuDNN conv (bf16, channels_last) → affine → ReLU → max_pool2d."""
    import torch
    import torch.nn.functional as F

    from port_bench.counts import kernels
    from ssad_tpu_torch.ops import stem_pool

    gen = torch.Generator(device=device).manual_seed(1)
    k4 = 0.3 * torch.randn((4, 4, 3, 64), generator=gen, device=device)
    scale = 0.5 + torch.rand(64, generator=gen, device=device)
    bias = 0.1 * torch.randn(64, generator=gen, device=device)
    w = k4.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def library(x):
        xin = F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1)).contiguous(
            memory_format=torch.channels_last)
        y = F.conv2d(xin, w).float()
        y = torch.relu(y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1))
        return F.max_pool2d(y, 3, 2, 1).to(torch.bfloat16).permute(0, 2, 3, 1)

    records = {}
    for n in (BATCH * WINDOWS, WINDOWS, 9, 1):
        x = (2 * torch.rand((n, 32, 32, 3), generator=gen, device=device) - 1).to(torch.bfloat16)
        out = stem_pool.stem_pool_cuda(x, k4, scale, bias)
        torch.cuda.synchronize()
        ref = stem_pool.stem_pool_plain(x, k4, scale, bias)
        o, r = out.float(), ref.float()
        flipped = (o != r).float().mean().item()
        err = float(torch.max(torch.abs(o - r)))
        if tuple(out.shape) != (n, 16, 16, 64) or not flipped < STEM_MAX_FLIPPED or not bool(
            torch.allclose(o, r, rtol=STEM_RTOL, atol=STEM_ATOL)
        ):
            fail(f"stem kernel vs plain at N={n}: {flipped:.2e} of elements off, max|d|={err}")
        lib_err = float(torch.max(torch.abs(library(x).float() - r)))
        rec = {
            "shape": [n, 32, 32, 3], "max_abs_err": err, "flipped_share": flipped,
            "library_max_abs_err": lib_err,
            "ms": cuda_ms(lambda: stem_pool.stem_pool_cuda(x, k4, scale, bias)),
            "plain_ms": cuda_ms(lambda: stem_pool.stem_pool_plain(x, k4, scale, bias)),
            "library_ms": cuda_ms(lambda: library(x)),
        }
        bound_s, bound_by = kernels.bound_s(*kernels.stem(n))
        rec["bound_ms"], rec["bound_by"] = bound_s * 1e3, bound_by
        if n == BATCH * WINDOWS:
            rec["device_us"] = device_us(
                lambda: stem_pool.stem_pool_cuda(x, k4, scale, bias), "stem_pool", 20)
            rec["resident_blocks_per_sm"] = stem_pool.stem_blocks_per_sm(device)
        records[n] = rec
        print(f"stem N={n}: {json.dumps(rec)}", flush=True)
    return records


#: csrc/bn_act.cu's timed sites, bf16 and channels last at the served patch
#: batch, each with its ReLU: (name, (N, C, H, W), residual)
BN_ACT_SITES = (
    ("wrn50_layer1_proj", (BATCH * WINDOWS, 256, 16, 16), "normed"),
    ("r18_layer1", (BATCH * WINDOWS, 64, 16, 16), "identity"),
)


def bn_act_bound(shape, residual: str):
    """(bound_ms, bytes): the bf16 activation and residual read once, the
    output written once, the f32 channel vectors read once, over the HBM
    rate (a few flops a byte: the bytes bound it)."""
    n, c = math.prod(shape), shape[1]
    nbytes = 2 * n * (2 if residual == "none" else 3) + 4 * c * (6 if residual == "normed" else 3)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def check_bn_act_kernel(device):
    """The inference BatchNorm kernel vs its plain version, bit for bit, at
    the widest sites of both trunks at the served batch; kernel and plain
    ms beside the bytes bound."""
    import torch

    from ssad_tpu_torch.ops import bn_act

    gen = torch.Generator(device=device).manual_seed(2)

    def activation(shape):
        n, c, h, w = shape
        x = torch.randn((n, h, w, c), generator=gen, device=device)
        return x.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels last, as cuDNN returns it

    def affine(c):
        var = 0.5 + 1.5 * torch.rand(c, generator=gen, device=device)
        weight = 0.5 + torch.rand(c, generator=gen, device=device)
        return (0.3 * torch.randn(c, generator=gen, device=device), torch.rsqrt(var + 1e-5) * weight,
                0.2 * torch.randn(c, generator=gen, device=device))

    records = {}
    for name, shape, residual in BN_ACT_SITES:
        args = (activation(shape), affine(shape[1]), True,
                None if residual == "none" else activation(shape),
                affine(shape[1]) if residual == "normed" else None)
        out = bn_act.bn_act_cuda(*args)
        differ = bits_differ(out, bn_act.bn_act_plain(*args))
        if differ:
            fail(f"bn_act kernel vs plain at {name} {shape}: {differ} elements' bits differ")
        del out
        rec = {"shape": list(shape), "dtype": "bfloat16", "layout": "channels_last",
               "residual": residual, "relu": True,
               "ms": cuda_ms(lambda: bn_act.bn_act_cuda(*args)),
               "plain_ms": cuda_ms(lambda: bn_act.bn_act_plain(*args)),
               "device_us": device_us(lambda: bn_act.bn_act_cuda(*args), "bn_act", 20)}
        rec["bound_ms"], rec["bytes"] = bn_act_bound(shape, residual)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        records[name] = rec
        print(f"bn_act {name}: {json.dumps(rec)}", flush=True)
        del args
    return records


def bn_act_record(records, patch_launches: int, image_launches: int) -> dict:
    """The kernel's line of the records: launches on the patch and image
    paths (phases 3, 4) and the timed sites; main() adds the other paths."""
    return {"name": "bn_act", "route": "cuda", "source": "ssad_tpu_torch/csrc/bn_act.cu",
            "replaces": "none: XLA fused the BatchNorm, the residual add and the ReLU on the TPU",
            "launches": patch_launches, "image_path_launches": image_launches, "path": "patch",
            "tolerance": "bit-equal", "sites": records}


def bits_differ(a, b) -> int:
    """Elements of ``a`` and ``b`` (one float dtype and shape) whose raw
    bits differ, the sign of a zero included; two NaNs count as equal."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    ints = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
    both_nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(ints[a.dtype]) != b.view(ints[b.dtype])) & ~both_nan).sum())


@contextlib.contextmanager
def checking_bn_act():
    """Each call of the bn_act kernel wrapper held against ``bn_act_plain``
    on its own inputs when it is made, bit for bit (its inputs are not
    kept: a served batch's activations take GBs) → [(x's shape, elements
    whose bits differ)]; its ``launches`` count carries over and back."""
    from ssad_tpu_torch.ops import bn_act

    original, calls = bn_act.bn_act_cuda, []

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        key = "x".join(str(d) for d in args[0].shape)
        calls.append((key, bits_differ(out, bn_act.bn_act_plain(*args, **kw))))
        return out

    wrapper.launches = original.launches  # the wrapper's body counts on this name
    bn_act.bn_act_cuda = wrapper
    try:
        yield calls
    finally:
        original.launches = wrapper.launches
        bn_act.bn_act_cuda = original


def tiled_bound(n: int, m: int, d: int):
    """(bound_ms, bound_by): inputs read once and scores written once over
    the HBM rate, vs the three bf16 products per element pair over the
    tensor-core rate."""
    nbytes = 4 * (n * d + m * d + n)
    flops = 3 * 2 * n * m * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_tiled_kernel(device):
    """The streaming bf16x3 k-NN kernel vs its plain version and the f32
    function; library yardstick: torch.topk(q̂ @ b̂ᵀ) in f32, TF32 off."""
    import torch

    from ssad_tpu_torch.ops import knn

    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    fit_rows = NORMALITY_IMAGES * WINDOWS - round(0.3 * NORMALITY_IMAGES * WINDOWS)  # 29435
    cases = {
        "serve": (randn(BATCH * WINDOWS, 512), randn(fit_rows, 512), 3),
        "fit": (randn(NORMALITY_IMAGES * WINDOWS - fit_rows, 512), randn(fit_rows, 512), 3),
        "ragged": (randn(40, 512), randn(2500, 512), 3),
        "k1": (randn(37, 512), randn(3000, 512), 1),
    }
    base = randn(5000, 512)
    cases["duplicates"] = (base[:16] + 1e-3 * randn(16, 512), torch.cat([base, base[:300]]), 3)
    near = cases["serve"][1]  # bank rows + 1e-4 noise: best similarities at cos ≈ 1
    cases["near_duplicates"] = (near[:WINDOWS] + 1e-4 * randn(WINDOWS, 512), near, 1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    records = {}
    for name, (q, b, k) in cases.items():
        prepared = knn.prepare_tiled_bank(b)  # as the served scorer holds its bank
        out = knn.knn_cosine_scores_tiled_cuda(q, b, k=k)
        out_prepared = knn.knn_cosine_scores_tiled_cuda(q, prepared, k=k)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(out - knn.knn_cosine_scores_tiled_plain(q, b, k=k))))
        err32 = float(torch.max(torch.abs(out - knn.knn_cosine_scores_plain(q, b, k=k))))
        if not (err <= KNN_TOL and err32 <= KNN_F32_TOL):
            fail(f"tiled knn kernel vs plain on {name} {tuple(q.shape)}x{tuple(b.shape)}: "
                 f"max|d|={err} (bf16x3), {err32} (f32)")
        if not torch.equal(out, out_prepared):
            fail(f"tiled knn kernel on {name}: a raw bank and its TiledBank disagree")
        rec = {"shape": [q.shape[0], b.shape[0], q.shape[1]], "k": k, "max_abs_err": err,
               "max_abs_err_vs_f32": err32}
        if name in ("serve", "fit"):
            qn, bn = knn.l2_normalize(q), knn.l2_normalize(b)
            rec["ms"] = cuda_ms(lambda: knn.knn_cosine_scores_tiled_cuda(q, prepared, k=k))
            rec["ms_raw_bank"] = cuda_ms(lambda: knn.knn_cosine_scores_tiled_cuda(q, b, k=k))
            rec["plain_ms"] = cuda_ms(lambda: knn.knn_cosine_scores_tiled_plain(q, b, k=k),
                                      warmup=2)
            rec["library_ms"] = cuda_ms(lambda: torch.topk(qn @ bn.T, k, dim=1), warmup=2)
            rec["bound_ms"], rec["bound_by"] = tiled_bound(q.shape[0], b.shape[0], q.shape[1])
            rec["device_us"] = device_us(
                lambda: knn.knn_cosine_scores_tiled_cuda(q, prepared, k=k), "knn_tiled", 10)
            plan = knn._tiled_plan(q.shape[0], b.shape[0], prepared.hi.shape[1], sms)
            resident = knn.knn_tiled_resident_ctas(device)
            rec["plan"] = plan._asdict()
            rec["plan_waves"] = -(-plan.query_tiles * plan.splits // (sms * resident))
            rec["group_depth"] = knn.knn_tiled_group_depth()
            rec["resident_ctas_per_sm"] = resident
        records[name] = rec
        print(f"knn_tiled {name}: {json.dumps(rec)}", flush=True)
    return records


def post(port: int, body: bytes, path: str = "/score") -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"POST {path} → {resp.status}: {data[:300]!r}")
    return json.loads(data), ms


def http_fanout(port: int, bodies, paths, threads: int = N_THREADS) -> tuple:
    """POST ``bodies[i]`` to ``paths[i]`` from ``threads`` client threads
    → (responses, latencies ms, wall s); fails if a request fails or a
    thread does not finish."""
    n = len(bodies)
    results, latencies, errors = [None] * n, [None] * n, []

    def client(tid: int):
        try:
            for i in range(tid, n, threads):
                results[i], latencies[i] = post(port, bodies[i], paths[i])
        except Exception as e:  # reported by the main thread below
            errors.append(repr(e))

    workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in workers):
        fail("HTTP client threads did not finish")
    if errors:
        fail(f"HTTP requests failed: {errors[:3]}")
    return results, latencies, wall


def drive_serving_path(device, work: Path):
    """Phase 3: the full-width serving path through the user entry points.
    Returns (k-NN launches, bn_act launches)."""
    import torch
    from PIL import Image

    from ssad_tpu_torch import cli
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.data.mvtec import load_image
    from ssad_tpu_torch.evaluation.inference import InferenceEngine
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.ops import bn_act
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import knn
    from ssad_tpu_torch.serving.cli import _load_artifact_models
    from ssad_tpu_torch.serving.server import AnomalyHTTPServer, coerce_image_array
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    sd = reference_state_dict(0)
    rng = np.random.default_rng(0)

    # the checkpoint's 1000-row bank: eval-mode embeddings of seeded images
    t0 = time.perf_counter()
    model = build_model(ModelConfig())
    model.load_state_dict(sd, strict=True)
    engine = InferenceEngine(model, device)
    rows = []
    for _ in range(BANK_ROWS // 50):
        x = torch.from_numpy(synthetic_images(rng, 50)).to(device)
        rows.append(engine.predict_batch(im.normalize_imagenet(x))[1].float().cpu())
    bank_rows = torch.cat(rows).numpy()
    if bank_rows.shape != (BANK_ROWS, 512) or not np.isfinite(bank_rows).all():
        fail(f"bank embeddings: shape {bank_rows.shape}, finite={np.isfinite(bank_rows).all()}")
    models_dir = work / "models"
    save_reference_checkpoint(models_dir / "bottle" / "best_model.ckpt", sd, bank_rows)
    del engine, model
    print(f"bank: {BANK_ROWS} rows embedded + checkpoint in {time.perf_counter() - t0:.2f} s",
          flush=True)

    req_imgs = synthetic_images(rng, N_REQUESTS)
    bodies, expected_inputs = [], []
    for i, img in enumerate(req_imgs):
        buf = io.BytesIO()
        if i % 2 == 0:
            np.save(buf, img)
            expected_inputs.append(coerce_image_array(img, (IMSIZE, IMSIZE)))
        else:
            Image.fromarray((img * 255).astype(np.uint8)).save(buf, "PNG")
            expected_inputs.append(load_image(io.BytesIO(buf.getvalue()), (IMSIZE, IMSIZE)))
        bodies.append(buf.getvalue())

    # ---- the main path: counts to 0 just before, read just after ----------
    knn.knn_cosine_scores_cuda.launches = 0
    bn_act.bn_act_cuda.launches = 0
    artifact = work / "bottle_image.ssadpt"
    t0 = time.perf_counter()
    rc = cli.main(["export", "--models-dir", str(models_dir), "--subject", "bottle",
                   "--batch", str(BATCH), "--imsize", str(IMSIZE), "--out", str(artifact)])
    if rc != 0:
        fail(f"cli export returned {rc}")
    export_s = time.perf_counter() - t0
    models, warmup_s = _load_artifact_models([str(artifact)], 5.0, 256, device)
    batcher, meta = models["bottle"]
    server = AnomalyHTTPServer(models=models, port=0).start()
    try:
        results, latencies, http_s = http_fanout(server.port, bodies, ["/score"] * N_REQUESTS)
        batcher_stats = batcher.stats()
    finally:
        server.stop()
    launches = knn.knn_cosine_scores_cuda.launches
    bn_act_launches = bn_act.bn_act_cuda.launches
    # ---- end of the main path ---------------------------------------------
    print(f"main path: export {export_s:.2f} s, warmup {warmup_s:.2f} s, "
          f"{N_REQUESTS} requests in {http_s:.3f} s, batches {batcher_stats['batches']}, "
          f"knn launches {launches}, bn_act launches {bn_act_launches}", flush=True)
    if launches < 1 + batcher_stats["batches"]:
        fail(f"knn kernel launches {launches} < fit + {batcher_stats['batches']} batches")
    # every image forward: the stem's BatchNorm + ResNet-18's 16 sites
    if bn_act_launches < BN_ACT_SITES_IMAGE * batcher_stats["batches"]:
        fail(f"bn_act launches {bn_act_launches} < {BN_ACT_SITES_IMAGE} sites × "
             f"{batcher_stats['batches']} batches")
    if meta["model"]["compute_dtype"] != "bfloat16" or meta["batch"] != BATCH:
        fail(f"artifact header {meta['model']}, batch {meta['batch']}")

    scorer = batcher._fns[0]
    fit_rows = BANK_ROWS - round(0.3 * BANK_ROWS)  # the 70/30 split: 700
    if tuple(scorer.detector.bank.shape) != (fit_rows, 512):
        fail(f"fitted bank {tuple(scorer.detector.bank.shape)} != ({fit_rows}, 512)")
    http_scores = np.array([r["score"] for r in results], np.float32)
    http_labels = np.array([r["label"] for r in results])
    direct_scores, direct_labels, direct_logits = scorer(np.stack(expected_inputs))
    if direct_logits.shape != (N_REQUESTS, 4) or not np.isfinite(direct_logits).all():
        fail(f"logits {direct_logits.shape} finite={np.isfinite(direct_logits).all()}")
    http_vs_direct = float(np.max(np.abs(http_scores - direct_scores)))
    if http_vs_direct > 1e-6 or not np.array_equal(http_labels, direct_labels):
        fail(f"HTTP scores vs direct scorer: max|d|={http_vs_direct}")

    x = torch.from_numpy(np.stack(expected_inputs)).to(device)
    embs = torch.cat([
        scorer.engine.predict_batch(im.normalize_imagenet(x[lo:lo + BATCH]))[1]
        for lo in range(0, N_REQUESTS, BATCH)
    ])
    plain = knn.knn_cosine_scores_plain(embs, scorer.detector.bank, k=scorer.k).cpu().numpy()
    plain_vs_http = float(np.max(np.abs(plain - http_scores)))
    if not plain_vs_http <= KNN_TOL:
        fail(f"served scores vs plain k-NN path: max|d|={plain_vs_http}")

    # served latency: the direct scorer on one full batch, host clock
    x8 = np.stack(expected_inputs[:BATCH])
    scorer(x8)
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        scorer(x8)
        times.append((time.perf_counter() - t0) * 1e3)
    lat = np.sort(np.array(latencies))
    serving = {
        "batch8_scorer_ms_mean": float(np.mean(times)),
        "batch8_scorer_ms_p50": float(np.median(times)),
        "http_p50_ms": float(np.percentile(lat, 50)),
        "http_p95_ms": float(np.percentile(lat, 95)),
        "http_latencies_ms_sorted": lat.tolist(),
        "http_requests": N_REQUESTS, "http_threads": N_THREADS,
        "http_wall_s": http_s, "batches": batcher_stats["batches"],
        "mean_batch_occupancy": batcher_stats["mean_batch_occupancy"],
        "export_s": export_s, "warmup_s": warmup_s,
        "http_vs_direct_max_abs": http_vs_direct,
        "http_vs_direct_bit_exact": bool(np.array_equal(http_scores, direct_scores)),
        "served_vs_plain_knn_max_abs": plain_vs_http,
        "threshold": meta["threshold"],
        "anomalous": int(http_labels.sum()),
    }

    # the f32 model on the card (cuDNN TF32 off) vs the CPU port
    two = req_imgs[:2]
    outs = []
    for dev in (device, torch.device("cpu")):
        m32 = build_model(ModelConfig(compute_dtype="float32"))
        m32.load_state_dict(sd, strict=True)
        eng = InferenceEngine(m32, dev)
        logits, emb = eng.predict_batch(im.normalize_imagenet(torch.from_numpy(two).to(dev)))
        outs.append((logits.cpu().numpy(), emb.cpu().numpy()))
    (card_logits, card_emb), (cpu_logits, cpu_emb) = outs
    emb_err = float(np.max(np.abs(card_emb - cpu_emb)))
    logit_err = float(np.max(np.abs(card_logits - cpu_logits)))
    if not (emb_err <= F32_MODEL_TOL and logit_err <= F32_MODEL_TOL):
        fail(f"f32 model cuda vs cpu: embedding {emb_err}, logits {logit_err}")
    serving["f32_cuda_vs_cpu_embedding_max_abs"] = emb_err
    serving["f32_cuda_vs_cpu_logits_max_abs"] = logit_err
    print(f"serving: {json.dumps(serving)}", flush=True)
    return launches, bn_act_launches


def drive_patch_path(device, work: Path, seed: int = 1):
    """Phase 4: the full-width patch serving path through the user entry
    points; ``seed`` draws the train-good images and the requests.
    Returns ({kernel name: launches}, serving summary)."""
    import base64

    import torch
    from PIL import Image

    from ssad_tpu_torch import cli
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.data.mvtec import load_image
    from ssad_tpu_torch.evaluation.inference import InferenceEngine
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import bn_act, knn, stem_pool
    from ssad_tpu_torch.serving.cli import _load_artifact_models
    from ssad_tpu_torch.serving.server import AnomalyHTTPServer, coerce_image_array
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    sd = reference_state_dict(0)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    good = work / "mvtec" / "bottle" / "train" / "good"
    good.mkdir(parents=True)
    for i, img in enumerate(synthetic_images(rng, PATCH_IMAGES)):
        Image.fromarray((img * 255).astype(np.uint8)).save(good / f"{i:03d}.png")
    models_dir = work / "patch_models"
    save_reference_checkpoint(models_dir / "bottle" / "best_model.ckpt", sd)
    print(f"patch data: {PATCH_IMAGES} PNGs + checkpoint in {time.perf_counter() - t0:.2f} s",
          flush=True)

    req_imgs = synthetic_images(rng, PATCH_REQUESTS)
    bodies, expected_inputs = [], []
    for i, img in enumerate(req_imgs):
        buf = io.BytesIO()
        if i % 2 == 0:
            np.save(buf, img)
            expected_inputs.append(coerce_image_array(img, (IMSIZE, IMSIZE)))
        else:
            Image.fromarray((img * 255).astype(np.uint8)).save(buf, "PNG")
            expected_inputs.append(load_image(io.BytesIO(buf.getvalue()), (IMSIZE, IMSIZE)))
        bodies.append(buf.getvalue())

    # ---- the patch path: counts to 0 just before, read just after ---------
    _zero_launches()
    artifact = work / "bottle_patch.ssadpt"
    t0 = time.perf_counter()
    rc = cli.main(["export", "--models-dir", str(models_dir), "--subject", "bottle",
                   "--mode", "patch", "--dataset-dir", str(work / "mvtec"),
                   "--n-normality-images", str(NORMALITY_IMAGES), "--batch", str(BATCH),
                   "--imsize", str(IMSIZE), "--out", str(artifact)])
    if rc != 0:
        fail(f"cli export --mode patch returned {rc}")
    export_s = time.perf_counter() - t0
    models, warmup_s = _load_artifact_models([str(artifact)], 5.0, 256, device)
    batcher, meta = models["bottle"]
    server = AnomalyHTTPServer(models=models, port=0).start()
    try:
        results, latencies, http_s = http_fanout(server.port, bodies, [
            "/score?heatmap=1" if i % 4 < 2 else "/score" for i in range(PATCH_REQUESTS)])
        batcher_stats = batcher.stats()
    finally:
        server.stop()
    launches = {
        "knn_cosine_scores": knn.knn_cosine_scores_cuda.launches,
        "knn_cosine_scores_tiled": knn.knn_cosine_scores_tiled_cuda.launches,
        "stem_pool": stem_pool.stem_pool_cuda.launches,
        "bn_act": bn_act.bn_act_cuda.launches,
    }
    # ---- end of the patch path --------------------------------------------
    batches = batcher_stats["batches"]
    normality_chunks = -(-NORMALITY_IMAGES // 4)
    calibration_chunks = -(-(PATCH_IMAGES - NORMALITY_IMAGES) // 4)
    print(f"patch path: export {export_s:.2f} s, warmup {warmup_s:.2f} s, {PATCH_REQUESTS} "
          f"requests in {http_s:.3f} s, batches {batches}, launches {json.dumps(launches)}",
          flush=True)
    if launches["stem_pool"] < normality_chunks + calibration_chunks + batches:
        fail(f"stem kernel launches {launches['stem_pool']} < {normality_chunks} normality + "
             f"{calibration_chunks} calibration chunks + {batches} batches")
    if launches["knn_cosine_scores_tiled"] < 1 + calibration_chunks + batches:
        fail(f"tiled knn launches {launches['knn_cosine_scores_tiled']} < fit + "
             f"{calibration_chunks} calibration chunks + {batches} batches")
    # every forward of the path starts after the stem: 16 sites of ResNet-18
    forwards = normality_chunks + calibration_chunks + batches
    if launches["bn_act"] < BN_ACT_SITES_FROM_STEM * forwards:
        fail(f"bn_act launches {launches['bn_act']} < {BN_ACT_SITES_FROM_STEM} sites × "
             f"{forwards} forwards")

    scorer = batcher._fns[0]
    fit_rows = NORMALITY_IMAGES * WINDOWS - round(0.3 * NORMALITY_IMAGES * WINDOWS)
    if tuple(scorer.detector.bank.shape) != (fit_rows, 512) or meta["knn_impl"] != "cuda_tiled":
        fail(f"patch bank {tuple(scorer.detector.bank.shape)} != ({fit_rows}, 512) or knn_impl "
             f"{meta['knn_impl']!r}")
    served_bank = scorer.detector.scoring_bank()
    if not isinstance(served_bank, knn.TiledBank) or served_bank.shape != (fit_rows, 512):
        fail(f"the served scorer scores against {type(served_bank).__name__}, not the "
             f"bank's TiledBank split once")
    if (meta["mode"], meta["upsample_to"], meta["batch"]) != ("patch", IMSIZE, BATCH):
        fail(f"patch header {meta['mode']}, upsample_to {meta['upsample_to']}, batch {meta['batch']}")
    (direct,) = scorer(np.stack(expected_inputs))
    if direct.shape != (PATCH_REQUESTS, IMSIZE, IMSIZE) or not np.isfinite(direct).all():
        fail(f"patch maps {direct.shape}, finite={np.isfinite(direct).all()}")
    http_max = np.array([r["map_max"] for r in results])
    http_mean = np.array([r["map_mean"] for r in results])
    http_vs_direct = max(float(np.max(np.abs(http_max - direct.max(axis=(1, 2))))),
                         float(np.max(np.abs(http_mean - direct.mean(axis=(1, 2))))))
    if not http_vs_direct <= 1e-6:
        fail(f"HTTP map statistics vs direct scorer: max|d|={http_vs_direct}")
    n_heat = 0
    for r in results:
        if "heatmap_b64" in r:
            png = Image.open(io.BytesIO(base64.b64decode(r["heatmap_b64"])))
            if png.size != (IMSIZE, IMSIZE) or png.mode != "L":
                fail(f"heatmap PNG {png.size} {png.mode}")
            n_heat += 1
    if n_heat != PATCH_REQUESTS // 2:
        fail(f"{n_heat} heatmaps for {PATCH_REQUESTS // 2} ?heatmap=1 requests")

    # the served maps, rebuilt from the scorer's own patch embeddings
    # through the plain tiled k-NN: isolates the k-NN kernel
    x = torch.from_numpy(np.stack(expected_inputs)).to(device)
    rebuilt = []
    for lo in range(0, PATCH_REQUESTS, BATCH):
        _, emb, n = scorer.engine.predict_patches(im.normalize_imagenet(x[lo:lo + BATCH]))
        scores = knn.knn_cosine_scores_tiled_plain(emb, scorer.detector.bank, k=scorer.k)
        side = int(round(n ** 0.5))
        rebuilt.append(im.upsample_anomaly_maps(scores.reshape(-1, side, side), IMSIZE))
    rebuilt = torch.cat(rebuilt).cpu().numpy()
    plain_vs_served = float(np.max(np.abs(rebuilt - direct)))
    if not plain_vs_served <= KNN_TOL:
        fail(f"served maps vs plain tiled k-NN on the same embeddings: max|d|={plain_vs_served}")

    x8 = np.stack(expected_inputs[:BATCH])
    scorer(x8)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        scorer(x8)
        times.append((time.perf_counter() - t0) * 1e3)
    lat = np.sort(np.array(latencies))
    serving = {
        "patches_per_batch": BATCH * WINDOWS,
        "bank_rows": int(scorer.detector.bank.shape[0]),
        "batch8_scorer_ms_p50": float(np.median(times)),
        "batch8_scorer_ms_sorted": sorted(times),
        "http_p50_ms": float(np.percentile(lat, 50)),
        "http_p95_ms": float(np.percentile(lat, 95)),
        "http_latencies_ms_sorted": lat.tolist(),
        "http_requests": PATCH_REQUESTS, "http_threads": N_THREADS, "http_wall_s": http_s,
        "batches": batches, "mean_batch_occupancy": batcher_stats["mean_batch_occupancy"],
        "export_s": export_s, "warmup_s": warmup_s,
        "http_vs_direct_max_abs": http_vs_direct,
        "served_vs_plain_tiled_knn_max_abs": plain_vs_served,
        "map_max_range": [float(http_max.min()), float(http_max.max())],
        "threshold": meta["threshold"], "calibration_n": (meta["calibration"] or {}).get("n"),
    }

    # the f32 model's patch embeddings on the card (cuDNN TF32 off) vs the CPU port
    two = np.stack(expected_inputs[:2])
    embs = []
    for dev in (device, torch.device("cpu")):
        m32 = build_model(ModelConfig(compute_dtype="float32"))
        m32.load_state_dict(sd, strict=True)
        eng = InferenceEngine(m32, dev)
        embs.append(eng.predict_patches(im.normalize_imagenet(torch.from_numpy(two).to(dev)))[1]
                    .cpu().numpy())
    emb_err = float(np.max(np.abs(embs[0] - embs[1])))
    if embs[0].shape != (2 * WINDOWS, 512) or not emb_err <= PATCH_F32_MODEL_TOL:
        fail(f"f32 patch embeddings cuda vs cpu: shape {embs[0].shape}, max|d|={emb_err}")
    serving["f32_patch_embeddings_cuda_vs_cpu_max_abs"] = emb_err
    print(f"patch serving: {json.dumps(serving)}", flush=True)
    return launches, serving


def check_jax_stream() -> dict:
    """Phase 1b: the JAX stream's digest on this host, held to
    ``STREAM_DIGEST``."""
    import numpy
    import _torch_jax_random as jr


    t0 = time.perf_counter()
    rec = {"digest": jr.stream_digest(), "pinned": STREAM_DIGEST,
           "numpy": numpy.__version__, "ms": (time.perf_counter() - t0) * 1e3}
    print(f"stream: {json.dumps(rec)}", flush=True)
    if rec["digest"] != STREAM_DIGEST:
        fail(f"stream: digest {rec['digest']} != the pinned {STREAM_DIGEST}")
    return rec


def drive_masks() -> dict:
    """Phase 5a: the port's object masks over the 256² corpus on this
    host: ms per image (object and cable separately) and the digest, held
    to ``MASK_DIGEST``."""
    from ssad_tpu_torch.data import masks

    images = [(mask_corpus_image(name, IMSIZE), subject) for name, subject in MASK_CORPUS]
    out, ms = [], {"object": [], "cable": []}
    for img, subject in images:
        t0 = time.perf_counter()
        out.append(masks.subject_mask(img, subject))
        ms["cable" if subject == "cable" else "object"].append(
            (time.perf_counter() - t0) * 1e3)
    rec = {"images": len(images), "size": IMSIZE, "digest": mask_digest(out),
           "pinned": MASK_DIGEST,
           "ms_per_object_mask": float(np.median(ms["object"])),
           "ms_per_cable_mask": float(np.median(ms["cable"])),
           "ms_sorted": {k: sorted(v) for k, v in ms.items()},
           "mask_share": [float(m.mean()) for m in out]}
    print(f"masks: {json.dumps(rec)} ({card_line()})", flush=True)
    if rec["digest"] != MASK_DIGEST:
        fail(f"masks: digest {rec['digest']} != the pinned {MASK_DIGEST}")
    return rec


def drive_synthesis(device, work: Path) -> dict:
    """Phase 5: the pretext synthesizer at DataConfig's batch, five cases."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.core.trace import busy_us, device_events
    from ssad_tpu_torch import cli
    from ssad_tpu_torch.config import DataConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.data import synthetic as syn
    from ssad_tpu_torch.ops import image as im

    cfg = DataConfig()
    batch = cfg.batch_size
    records = {"masks": drive_masks()}
    root = work / "synth_mvtec"
    t0 = time.perf_counter()
    write_synth_tree(root)
    print(f"synth data: {len(SYNTH_TREE) * SYNTH_IMAGES} PNGs in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for subject, patch in SYNTH_CASES:
        case = f"{subject}_{'patch' if patch else 'image'}"
        t0 = time.perf_counter()
        data = mvtec.prepare_pretext_data(root, subject, imsize=cfg.imsize,
                                          val_fraction=cfg.train_val_split, seed=cfg.seed,
                                          patch_localization=patch)
        prepare_s = time.perf_counter() - t0
        spec = syn.SynthSpec(subject=subject, imsize=cfg.imsize, patch_localization=patch,
                             patch_size=cfg.patch_size)
        idx = np.random.default_rng(0).integers(0, data.train_images.shape[0], batch)
        if spec.is_non_fixed:
            host = (data.train_images[idx], data.cut_pool, data.train_masks[idx],
                    data.train_coords[idx], data.train_counts[idx])
        else:
            host = (data.train_images[idx], data.cut_pool, data.fixed_mask, data.fixed_coords,
                    np.int32(data.fixed_count))
        host = [torch.from_numpy(np.asarray(a)) for a in host]
        dev = [t.to(device) for t in host]  # the one upload of the inputs
        gen = torch.Generator().manual_seed(0)
        n_cut = data.cut_pool.shape[0]
        draws = syn.draw(spec, batch, gen, n_cut=n_cut)
        x, y, _ = syn.synthesize(spec, draws.to(device), *dev)
        torch.cuda.synchronize()
        x_cpu, y_cpu, _ = syn.synthesize(spec, draws, *host)
        side = spec.canvas[0]
        if tuple(x.shape) != (batch, side, side, 3) or not bool(torch.isfinite(x).all()):
            fail(f"synth {case}: output {tuple(x.shape)}, finite={bool(torch.isfinite(x).all())}")
        if not torch.equal(y.cpu(), y_cpu):
            fail(f"synth {case}: card and CPU labels differ from the same draws")
        diff = (im.denormalize_imagenet(x).cpu() - im.denormalize_imagenet(x_cpu)).abs()
        if not torch.equal(x.cpu(), x_cpu):
            fail(f"synth {case}: card and CPU images differ from the same draws "
                 f"(max|d| {float(diff.max())} denormalised)")

        # one batch with its inputs on the card and no host sync
        ready = syn.draw(spec, batch, gen, n_cut=n_cut).to(device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            syn.synthesize(spec, ready, *dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()

        # ms per batch: synthesis alone (draws uploaded beforehand), and
        # with the host draw and its upload
        uploaded = [syn.draw(spec, batch, gen, n_cut=n_cut).to(device) for _ in range(SYNTH_TIMED)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def timed(step):
            torch.cuda.synchronize()
            start.record()
            step()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        synth_ms = [timed(lambda d=d: syn.synthesize(spec, d, *dev)) for d in uploaded]
        full_ms = [timed(lambda: syn.synthesize(
            spec, syn.draw(spec, batch, gen, n_cut=n_cut).to(device), *dev))
            for _ in range(SYNTH_TIMED)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            syn.synthesize(spec, uploaded[0], *dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = device_events(prof)
        busy = busy_us(events)
        by_name = {}
        for name, t_start, t_end in events:
            by_name[name] = by_name.get(name, 0.0) + t_end - t_start
        rec = {
            "subject": subject, "patch_mode": patch, "canvas": side, "batch": batch,
            "prepare_s": prepare_s,
            "per_image_masks": spec.is_non_fixed,
            "label_counts": np.bincount(y.cpu().numpy(), minlength=4).tolist(),
            "cpu_max_abs": float(diff.max()),
            "ms_per_batch": float(np.median(synth_ms)),
            "ms_per_batch_with_draw": float(np.median(full_ms)),
            "images_per_s": batch / float(np.median(synth_ms)) * 1e3,
            "images_per_s_with_draw": batch / float(np.median(full_ms)) * 1e3,
            "ms_sorted": sorted(synth_ms),
            "profiled_wall_us": wall_us, "device_busy_us": busy, "busy_share": busy / wall_us,
            "device_events": len(events),
            "top_device_us": [[n[:60], us] for n, us in
                              sorted(by_name.items(), key=lambda kv: -kv[1])[:5]],
        }
        records[case] = rec
        print(f"synth {case}: {json.dumps(rec)}", flush=True)

    # the cli qa entry point on the card (its default device)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["qa", "--dataset-dir", str(root), "--subject", "bottle",
                       "--outputs-dir", str(work / "qa")])
    qa_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli qa returned {rc}")
    qa = json.loads(buf.getvalue().strip().splitlines()[-1])
    if sum(qa["label_counts"]) != cli.QA_BATCH or not Path(qa["grid"]).is_file():
        fail(f"cli qa: {qa}")
    print(f"qa: {json.dumps({**qa, 'seconds': qa_s})}", flush=True)
    return records


def train_step_parity(device, data, batch: int, limits: dict) -> dict:
    """One f32 fine-tune step on the card vs the CPU port (TF32 off), from
    the same weights and draws, held to the fixed ``limits``
    (tests/_torch_step_parity.py); then the card step again with
    TF32 on, a planted device-side fault that must break them."""
    import _torch_step_parity as sp
    import torch

    h, _ = data.imsize
    cfg = sp.step_config(data.imsize, batch)
    t0 = time.perf_counter()
    host = sp.step_record(cfg, data, "cpu")
    card = sp.step_record(cfg, data, device)
    rec = {"canvas": h, "batch": batch, **sp.step_deltas(card, host),
           "bank_rows": int(host["bank"][2]), "given_rows": int(host["given"][2])}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        planted = sp.step_deltas(sp.step_record(cfg, data, device), host)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rec["limits"], rec["tf32_on"] = limits, planted
    rec["tf32_on_beyond"], rec["seconds"] = sp.beyond(planted, limits), time.perf_counter() - t0
    print(f"train parity {h}² batch {batch}: {json.dumps(rec)}", flush=True)
    bad = sp.beyond(rec, limits)
    if bad:
        fail(f"train step card vs cpu at {h}² batch {batch} beyond its limits in {bad}")
    if not rec["tf32_on_beyond"]:
        fail(f"train step at {h}² batch {batch}: TF32 on stays within the limits")
    return rec


def bf16_step_parity(device, data, batch: int, limits) -> dict:
    """One bf16 fine-tune step on the card against the CPU port, layer by
    layer: the CPU step records every ReLU input and convolution output
    and the cotangent at each; the card step runs with each layer
    given the CPU's input and cotangent (``_torch_step_parity.pinned_record``),
    so what differs is each layer's own rounding.  Then the card step with
    a planted fault (``f32_residual_add``: the residual add in f32,
    rounded once after the ReLU), which must break ``limits``."""
    import _torch_pinning as pn
    import _torch_step_parity as sp

    h, _ = data.imsize
    cfg = sp.step_config(data.imsize, batch, "bfloat16")
    t0 = time.perf_counter()
    host, decisions = sp.reference_record(cfg, data)
    card, layers = sp.pinned_record(cfg, data, device, decisions)
    rec = {"canvas": h, "batch": batch, **sp.step_deltas(card, host), **pn.layer_deltas(layers)}
    bad_card, bad_layers = sp.pinned_record(cfg, data, device, decisions,
                                            plant=pn.f32_residual_add)
    planted = {**sp.step_deltas(bad_card, host), **pn.layer_deltas(bad_layers)}
    rec["limits"], rec["f32_residual_add"] = limits, planted
    rec["seconds"] = time.perf_counter() - t0
    rec["f32_residual_add_beyond"] = sp.beyond(planted, limits)
    print(f"train parity bf16 {h}² batch {batch}: {json.dumps(rec)}", flush=True)
    print(f"train layers bf16 {h}² batch {batch}: {json.dumps(layers)}", flush=True)
    bad = sp.beyond(rec, limits)
    if bad:
        fail(f"bf16 train step card vs cpu at {h}² batch {batch} beyond its limits in {bad}")
    if not rec["f32_residual_add_beyond"]:
        fail(f"bf16 train step at {h}² batch {batch}: the f32 residual add stays within "
             "the limits")
    return rec


def bf16_eval_parity(device, limits) -> dict:
    """The bf16 eval forward (seeded reference weights) on the card against
    the CPU port, layer by layer, each layer given the CPU's input: image
    mode on BATCH 256² images, and patch mode on one image's 841 windows,
    whose stem runs csrc/stem_pool.cu on the card (held to the plain stem
    at phase 2's tolerance; the layers after it start from the CPU's
    stem).  The embeddings then go through csrc/knn.cu (a 700-row bank) and
    csrc/knn_tiled.cu (a 2,048-row bank), each held against its plain
    version (KNN_TOL).  Then the planted residual add, which must break
    ``limits``."""
    import _torch_pinning as pn
    import _torch_step_parity as sp
    import torch

    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import knn, stem_pool
    from ssad_tpu_torch.ops.patches import extract_patches

    sd = reference_state_dict(0)
    host_model, card_model = build_model(ModelConfig()), build_model(ModelConfig())
    host_model.load_state_dict(sd)
    card_model.load_state_dict(sd)
    host_model.eval()
    card_model.to(device).eval()
    rng = np.random.default_rng(7)
    x = im.normalize_imagenet(torch.from_numpy(synthetic_images(rng, BATCH)))
    gen = torch.Generator(device=device).manual_seed(7)
    banks = {"image": knn.l2_normalize(torch.randn(700, 512, generator=gen, device=device)),
             "patch": knn.l2_normalize(torch.randn(2048, 512, generator=gen, device=device))}

    def forward(model, arg, mode):
        return model.from_stem(arg) if mode == "patch" else model(arg)

    def pinned(mode, arg_host, arg_card, plant=None):
        stem = mode == "image"
        rec = pn.Recorder(pn.relu_names(host_model, stem), pn.conv_names(host_model, stem))
        with torch.no_grad(), rec:
            ref = forward(host_model, arg_host, mode)
        pin = pn.Pinned(rec.decisions().to(device), teacher=True)
        with torch.no_grad(), plant(card_model) if plant else contextlib.nullcontext(), pin:
            got = forward(card_model, arg_card, mode)
        deltas = {k: float((got[k].cpu() - ref[k]).abs().max())
                  for k in ("latent_space", "classifier")}
        return {**deltas, **pn.layer_deltas(pin.layers())}, pin.layers(), got["latent_space"]

    out = {}
    t0 = time.perf_counter()
    # image mode
    out["image"], image_layers, emb = pinned("image", x, x.to(device))
    # patch mode: one image's windows, the stem on the card's kernel
    windows = extract_patches(x[:1].to(torch.bfloat16), 32, 8).reshape(-1, 32, 32, 3)
    affine = stem_pool.folded_stem_affine(host_model.state_dict())
    host_stem = stem_pool.stem_pool_plain(windows, *affine)
    card_stem = stem_pool.stem_pool_cuda(windows.to(device), *(t.to(device) for t in affine))
    o, r = card_stem.float().cpu(), host_stem.float()
    stem = {"windows": int(windows.shape[0]), "max_abs_err": float((o - r).abs().max()),
            "flipped_share": float((o != r).float().mean())}
    if not (stem["flipped_share"] < STEM_MAX_FLIPPED
            and bool(torch.allclose(o, r, rtol=STEM_RTOL, atol=STEM_ATOL))):
        fail(f"bf16 patch forward: the stem kernel vs plain {stem}")
    out["patch"], patch_layers, patch_emb = pinned("patch", host_stem, host_stem.to(device))
    out["patch"]["stem"] = stem
    # every k-NN call against its plain version
    knn_err = {
        "image_knn": float((knn.knn_cosine_scores_cuda(emb, banks["image"], k=3)
                            - knn.knn_cosine_scores_plain(emb, banks["image"], k=3)).abs().max()),
        "patch_knn_tiled": float((knn.knn_cosine_scores_tiled_cuda(patch_emb, banks["patch"], k=3)
                                  - knn.knn_cosine_scores_tiled_plain(patch_emb, banks["patch"],
                                                                      k=3)).abs().max())}
    out["knn_vs_plain"] = knn_err
    if not max(knn_err.values()) <= KNN_TOL:
        fail(f"bf16 forward: a k-NN kernel vs its plain version {knn_err}")
    out["f32_residual_add"] = {
        "image": pinned("image", x, x.to(device), pn.f32_residual_add)[0],
        "patch": pinned("patch", host_stem, host_stem.to(device), pn.f32_residual_add)[0]}
    out["limits"], out["seconds"] = limits, time.perf_counter() - t0
    print(f"eval parity bf16: {json.dumps(out)}", flush=True)
    print(f"eval layers bf16: {json.dumps({'image': image_layers, 'patch': patch_layers})}",
          flush=True)
    for mode in ("image", "patch"):
        bad = sp.beyond(out[mode], limits)
        if bad:
            fail(f"bf16 {mode} forward card vs cpu beyond its limits in {bad}")
        if not sp.beyond(out["f32_residual_add"][mode], limits):
            fail(f"bf16 {mode} forward: the f32 residual add stays within the limits")
    return out


@contextlib.contextmanager
def f32_result_convs(model):
    """``model``'s bf16 convolutions (each instance's ``forward``) handing
    their f32 accumulation to the BatchNorm, unrounded, as the JAX
    package's program compiled for the CPU at XLA's default excess
    precision computes them: an f32 cuDNN convolution of the bf16 values
    (exact products; TF32 as the process's flags say), the cotangent
    rounded to bf16, the input's gradient bf16, the weight's f32.  The
    alternative ``bf16_alternatives`` measures."""
    import torch
    import torch.nn.functional as F

    from ssad_tpu_torch.models.resnet import Conv2d

    class F32Result(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, stride, padding):
            xf, wf = x.float(), w.to(torch.bfloat16).float()
            ctx.save_for_backward(xf, wf)
            ctx.conv = (list(stride), list(padding))
            return F.conv2d(xf, wf, None, stride, padding)

        @staticmethod
        def backward(ctx, g):
            xf, wf = ctx.saved_tensors
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.to(torch.bfloat16).float(), xf, wf, None, *ctx.conv, [1, 1], False, [0, 0], 1,
                [True, True, False])
            return gx.to(torch.bfloat16), gw, None, None

    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    for m in convs:
        m.forward = lambda x, m=m: F32Result.apply(x, m.weight, m.stride, m.padding)
    try:
        yield
    finally:
        for m in convs:
            del m.forward


def bf16_alternatives(device, data) -> list:
    """The port's bf16 convolutions (a cuDNN bf16 convolution: the result
    rounded to bf16, as the JAX source declares it) against
    ``f32_result_convs`` with cuDNN's TF32 on and off, in the order A B C C
    B A: ms per fine-tune step with the fill at 256², batch 96 (median of
    TRAIN_TIMED warm steps, the draws uploaded beforehand), ms per eval
    forward of BATCH 256² images and of BATCH images' 6,728 windows from
    their stem (``from_stem``, the served patch path's; ``cuda_ms``), and
    the largest |Δ| of those embeddings when the batch runs in reverse
    order (a served row must not depend on its place in the batch)."""
    import torch

    from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import stem_pool
    from ssad_tpu_torch.ops.patches import extract_patches
    from ssad_tpu_torch.train.trainer import Trainer, stage_generator

    model = build_model(ModelConfig()).to(device).eval()
    model.load_state_dict(reference_state_dict(0))
    x = im.normalize_imagenet(torch.from_numpy(
        synthetic_images(np.random.default_rng(12), BATCH))).to(device)
    windows = extract_patches(x.to(torch.bfloat16), 32, 8).reshape(-1, 32, 32, 3)
    stem = stem_pool.stem_pool_plain(windows, *stem_pool.folded_stem_affine(model.state_dict()))
    cfg = TrainConfig(data=DataConfig(subject="bottle", imsize=(IMSIZE, IMSIZE),
                                      batch_size=TRAIN_BATCH, min_dataset_length=TRAIN_MIN_LEN))

    def reversed_gap(fn, inp):
        return float((fn(inp) - fn(inp.flip(0)).flip(0)).abs().max())

    ways = [("bf16_result", True, False), ("f32_result_tf32", True, True),
            ("f32_result_no_tf32", False, True)]
    out = []
    for name, tf32, f32_result in ways + ways[::-1]:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            tr = Trainer(cfg, data, device)
            with f32_result_convs(tr.model) if f32_result else contextlib.nullcontext():
                state = tr.init_state("fine_tune", seed=0)
                dd = tr.device_data("train")
                gen = stage_generator(0, 2)
                for _ in range(3):
                    state, _ = tr.train_step(state, tr.upload_draws(gen, dd), dd, True)
                ups = [tr.upload_draws(gen, dd) for _ in range(TRAIN_TIMED)]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                times = []
                for up in ups:
                    torch.cuda.synchronize()
                    start.record()
                    state, _ = tr.train_step(state, up, dd, True)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
            with f32_result_convs(model) if f32_result else contextlib.nullcontext(), \
                    torch.no_grad():
                image_ms = cuda_ms(lambda: model(x), iters=50)
                patch_ms = cuda_ms(lambda: model.from_stem(stem), iters=10)
                image_gap = reversed_gap(lambda a: model(a)["latent_space"], x)
                patch_gap = reversed_gap(lambda a: model.from_stem(a)["latent_space"], stem)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        rec = {"convolutions": name, "cudnn_tf32": tf32, "step_ms": float(np.median(times)),
               "step_ms_sorted": sorted(times), "canvas": IMSIZE, "batch": TRAIN_BATCH,
               "image_forward_ms": image_ms, "patch_forward_ms": patch_ms,
               "image_reversed_batch_max_abs": image_gap,
               "patch_reversed_batch_max_abs": patch_gap,
               "images": BATCH, "windows": int(windows.shape[0])}
        print(f"bf16 alternatives: {json.dumps(rec)}", flush=True)
        out.append(rec)
    return out


def drive_bf16_only(device, work: Path) -> None:
    """``--bf16``: phase 6's bf16 checks alone (the step layer by layer at
    64², batch 8 and 256², batch 16, the forward in both modes), then
    ``bf16_alternatives``."""
    import _torch_step_parity as sp

    from ssad_tpu_torch.data import mvtec

    root = work / "synth_mvtec"
    write_synth_tree(root)
    data = mvtec.prepare_pretext_data(root, "bottle", imsize=(IMSIZE, IMSIZE),
                                      val_fraction=0.2, seed=0)
    bf16_step_parity(device, sp.disc_data(64), 8, sp.BF16_CARD_LIMITS)
    bf16_step_parity(device, data, TRAIN_PARITY_BATCH, sp.BF16_TREE_256_LIMITS)
    bf16_eval_parity(device, sp.BF16_EVAL_LIMITS)
    bf16_alternatives(device, data)


def time_train_stage(device, trainer, stage: str) -> dict:
    """ms per step (CUDA events; median of TRAIN_TIMED warm steps) with the
    draws uploaded beforehand and with the host draw + upload, images/s,
    and one profiled step: busy share and device µs by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.core.trace import busy_us, device_events
    from ssad_tpu_torch.train.trainer import STEP_GROUPS, stage_generator

    fill = stage == "fine_tune"
    state = trainer.init_state(stage, seed=0)
    dd = trainer.device_data("train")
    gen = stage_generator(0, 2)
    for _ in range(3):
        state, _ = trainer.train_step(state, trainer.upload_draws(gen, dd), dd, fill)
    uploaded = [trainer.upload_draws(gen, dd) for _ in range(TRAIN_TIMED + 1)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(step):
        torch.cuda.synchronize()
        start.record()
        step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    holder = [state]

    def run(up):
        holder[0], _ = trainer.train_step(holder[0], up, dd, fill)

    step_ms = [timed(lambda u=u: run(u)) for u in uploaded[:TRAIN_TIMED]]
    full_ms = [timed(lambda: run(trainer.upload_draws(gen, dd))) for _ in range(TRAIN_TIMED)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(uploaded[-1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)
    busy = busy_us(kernels)
    kernel_us = sum(end_us - start_us for _, start_us, end_us in kernels)
    # the step's spans by their last word: synthesis, forward, ...
    short = {g: g.rsplit(".", 1)[1] for g in STEP_GROUPS}
    groups = {short[g]: 0.0 for g in STEP_GROUPS if fill or short[g] != "bank_fill"}
    for e in prof.events():
        if short.get(e.name) in groups and e.device_type == torch.autograd.DeviceType.CPU:
            groups[short[e.name]] += e.device_time_total
    # autograd launches the backward's kernels from its own device thread,
    # outside the step's ranges: backward is every kernel outside the others
    groups["backward"] = kernel_us - sum(v for k, v in groups.items() if k != "backward")
    batch = trainer.cfg.data.batch_size
    return {
        "stage": stage, "fill": fill, "batch": batch, "canvas": trainer.spec.canvas[0],
        "ms_per_step": float(np.median(step_ms)),
        "ms_per_step_with_draw": float(np.median(full_ms)),
        "images_per_s": batch / float(np.median(step_ms)) * 1e3,
        "images_per_s_with_draw": batch / float(np.median(full_ms)) * 1e3,
        "ms_sorted": sorted(step_ms), "ms_with_draw_sorted": sorted(full_ms),
        "profiled_wall_us": wall_us, "device_busy_us": busy, "busy_share": busy / wall_us,
        "device_kernels": len(kernels), "device_kernel_us": kernel_us,
        "device_us_by_group": groups if kernel_us > 0 else "not measured",
    }


def drive_training(device, work: Path) -> dict:
    """Phase 6: cli train → cli export → served scores, on phase 5's tree."""
    import contextlib

    import _torch_step_parity as sp
    import torch

    from ssad_tpu_torch import cli
    from ssad_tpu_torch.config import DataConfig, TrainConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.data.mvtec import load_image
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import knn
    from ssad_tpu_torch.serving.export import ServedScorer
    from ssad_tpu_torch.train.trainer import Trainer, stage_generator
    from ssad_tpu_torch.utils import filesystem as fs
    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    root, out = work / "synth_mvtec", work / "train_out"
    imgs = np.stack([load_image(p, (IMSIZE, IMSIZE))
                     for p in fs.train_good_images(root / "bottle")[:BATCH]])

    # ---- the training path: counts to 0 just before, read just after -------
    knn.knn_cosine_scores_cuda.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["train", "--dataset-dir", str(root), "--subject", "bottle",
                   "--outputs-dir", str(out), "--imsize", str(IMSIZE),
                   "--batch-size", str(TRAIN_BATCH), "--projection-epochs", "1",
                   "--fine-tune-epochs", "3", "--min-dataset-length", str(TRAIN_MIN_LEN)])
    train_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli train returned {rc}")
    ckpt = out / "bottle" / "best_model.ckpt"
    artifact = out / "bottle_image.ssadpt"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export", "--models-dir", str(out), "--subject", "bottle",
                       "--batch", str(BATCH), "--out", str(artifact)])
    export_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli export of the trained checkpoint returned {rc}")
    scorer = ServedScorer.from_file(artifact, device)
    scores, labels, logits = scorer(imgs)
    launches = knn.knn_cosine_scores_cuda.launches
    # ---- end of the training path ------------------------------------------
    _, bank, _, tcfg = load_checkpoint(ckpt)
    rows = int(bank.count) if bank is not None else 0
    history = json.loads((out / "bottle" / "history.json").read_text())
    print(f"train history: {json.dumps(history)}", flush=True)
    print(f"train checkpoint: {ckpt}, bank rows {rows}, cli train {train_s:.2f} s, "
          f"export {export_s:.2f} s, knn launches {launches}", flush=True)
    if rows < TRAIN_MIN_BANK:
        fail(f"the trained bank holds {rows} rows < {TRAIN_MIN_BANK}")
    meta = scorer.meta
    if meta["imsize"] != [IMSIZE, IMSIZE] or meta.get("subject") != "bottle" or (
            tuple(tcfg.data.imsize), tcfg.data.subject) != ((IMSIZE, IMSIZE), "bottle"):
        fail(f"export header imsize {meta['imsize']} subject {meta.get('subject')}, "
             f"TrainConfig {tcfg.data.imsize} {tcfg.data.subject}")
    if launches < 2:
        fail(f"knn kernel launches {launches} < fit + one scored batch")
    x = torch.from_numpy(imgs).to(device)
    _, emb = scorer.engine.predict_batch(im.normalize_imagenet(x))
    plain = knn.knn_cosine_scores_plain(emb, scorer.detector.bank, k=scorer.k).cpu().numpy()
    err = float(np.max(np.abs(plain - scores)))
    if scores.shape != (BATCH,) or not np.isfinite(logits).all() or not err <= KNN_TOL:
        fail(f"trained-model scores {scores.shape} vs plain k-NN path: max|d|={err}")

    cfg = DataConfig(subject="bottle", imsize=(IMSIZE, IMSIZE), batch_size=TRAIN_BATCH,
                     min_dataset_length=TRAIN_MIN_LEN)
    data = mvtec.prepare_pretext_data(root, "bottle", imsize=cfg.imsize,
                                      val_fraction=cfg.train_val_split, seed=cfg.seed)
    record = {"train_s": train_s, "export_s": export_s, "bank_rows": rows,
              "knn_launches": launches, "served_vs_plain_knn_max_abs": err,
              "fit_rows": int(scorer.detector.bank.shape[0]), "anomalous": int(labels.sum()),
              # the card test's step at the CPU limits, and full width on the tree
              "parity": [train_step_parity(device, sp.disc_data(64), 8, sp.CPU_LIMITS),
                         train_step_parity(device, data, TRAIN_PARITY_BATCH,
                                           sp.TREE_256_LIMITS)],
              # the default dtype, layer by layer: the step, then the forward
              "parity_bf16": [bf16_step_parity(device, sp.disc_data(64), 8, sp.BF16_CARD_LIMITS),
                              bf16_step_parity(device, data, TRAIN_PARITY_BATCH,
                                               sp.BF16_TREE_256_LIMITS)],
              "eval_bf16": bf16_eval_parity(device, sp.BF16_EVAL_LIMITS)}

    # one fill step with its draws uploaded, and no host sync
    trainer = Trainer(TrainConfig(data=cfg), data, device)
    state = trainer.init_state("fine_tune", seed=0)
    dd = trainer.device_data("train")
    gen = stage_generator(0, 2)
    state, _ = trainer.train_step(state, trainer.upload_draws(gen, dd), dd, True)
    uploaded = trainer.upload_draws(gen, dd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(state, uploaded, dd, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("train no-sync: one fine-tune fill step under set_sync_debug_mode('error')",
          flush=True)

    for stage in ("projection", "fine_tune"):
        rec = time_train_stage(device, trainer, stage)
        record[stage] = rec
        print(f"train {stage}: {json.dumps(rec)}", flush=True)
    return record


def _zero_launches() -> None:
    from ssad_tpu_torch.ops import bn_act, knn, stem_pool

    knn.knn_cosine_scores_cuda.launches = 0
    knn.knn_cosine_scores_tiled_cuda.launches = 0
    stem_pool.stem_pool_cuda.launches = 0
    bn_act.bn_act_cuda.launches = 0


def _eval_launches():
    from ssad_tpu_torch.ops import bn_act, knn, stem_pool

    return {"knn_cosine_scores": knn.knn_cosine_scores_cuda.launches,
            "knn_cosine_scores_tiled": knn.knn_cosine_scores_tiled_cuda.launches,
            "stem_pool": stem_pool.stem_pool_cuda.launches,
            "bn_act": bn_act.bn_act_cuda.launches}


def _run_cli(argv) -> tuple:
    """``cli.main(argv)`` in process → (its stdout lines, wall s)."""
    import contextlib

    import torch

    from ssad_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli {' '.join(argv[:1])} returned {rc}")
    return buf.getvalue().strip().splitlines(), wall


def _timed(fn):
    """(fn's result, wall ms with the card synchronised at both ends)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _metrics_against_oracles(maps, gts, what: str) -> dict:
    """The evaluator's pixel metrics (``evaluator._pixel_scores``) on the
    card against the host oracles on the same maps: the whole on-card call
    and the host oracles' (host clock, synchronised), the on-card call's
    host part (the masks' connected components and the upload), the sort
    program alone (CUDA events) and its device time by kernel (one
    profiled call); fails beyond 2e-4 (AUROC, IoU) or 3e-4 (AUPRO)."""
    import torch

    from port_bench.core.trace import busy_us, device_events
    from ssad_tpu_torch.config import EvalConfig
    from ssad_tpu_torch.evaluation import metrics_device as MD
    from ssad_tpu_torch.evaluation.evaluator import _pixel_scores

    on_card, host = EvalConfig(device_metrics=True), EvalConfig(device_metrics=False)
    _pixel_scores(on_card, maps, gts)  # warm
    dev, call_ms = _timed(lambda: _pixel_scores(on_card, maps, gts))
    inputs, inputs_ms = _timed(lambda: MD.metric_inputs(maps, gts))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    MD.metrics_program(*inputs)
    end.record()
    torch.cuda.synchronize()
    program_ms = start.elapsed_time(end)
    # the program's device time by kernel: one profiled call
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        MD.metrics_program(*inputs)
        torch.cuda.synchronize()
    events = device_events(prof)
    by_kernel = {}
    for name, t0, t1 in events:
        by_kernel[name[:60]] = by_kernel.get(name[:60], 0.0) + (t1 - t0)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    oracle, host_ms = _timed(lambda: _pixel_scores(host, maps, gts))
    # (AUROC, ROC, IoU, AUPRO, PRO curve)
    curves = curve_faults(MD.PixelMetrics(auroc=dev[0], threshold=0.0, f1=0.0, iou=dev[2],
                                          aupro=dev[3], roc=dev[1], pro=dev[4]))
    if not curves["monotone"]:
        fail(f"{what}: the on-card curves are not monotone: {curves}")
    device = {"auroc": dev[0], "iou": dev[2], "aupro": dev[3]}
    oracle = {"auroc": oracle[0], "iou": oracle[2], "aupro": oracle[3]}
    deltas = {k: abs(device[k] - v) for k, v in oracle.items()}
    bounds = {"auroc": 2e-4, "iou": 2e-4, "aupro": 3e-4}
    if any(not deltas[k] <= b for k, b in bounds.items()):
        fail(f"{what}: on-card pixel metrics vs host oracles {deltas} beyond {bounds}")
    return {"pixels": int(gts.size), "call_ms": call_ms, "inputs_ms": inputs_ms,
            "program_ms": program_ms, "program_busy_us": busy_us(events),
            "program_device_ops": len(events), "program_top_us": dict(top),
            "host_oracles_ms": host_ms, "device": device, "oracle": oracle,
            "max_abs_delta": max(deltas.values()), "curves": curves}


def _plain_knn(queries, bank, k: int):
    """The plain version of the k-NN function the dispatch picks for
    ``bank`` (an (M, D) tensor or a TiledBank)."""
    from ssad_tpu_torch.ops import knn

    if bank.shape[0] > knn.PALLAS_MAX_BANK_ROWS:
        return knn.knn_cosine_scores_tiled_plain(queries, bank, k=k)
    return knn.knn_cosine_scores_plain(queries, bank, k=k)


def _calibration_vs_plain(det, normality, seed: int, k: int) -> tuple:
    """A fitted detector's calibration scores (its validation rows against
    its bank, scored by a kernel in ``fit``) against the plain k-NN on the
    same rows, the split redrawn as ``fit`` drew it → (max |d|, [queries,
    bank rows])."""
    import torch

    m = normality.shape[0]
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(seed)).to(normality.device)
    n_val = m - det.bank.shape[0]
    if not torch.equal(normality[perm[n_val:]], det.bank):
        fail("the redrawn split is not the one the fit drew")
    plain = _plain_knn(normality[perm[:n_val]], det.bank, k)
    return float((det.calibration_scores - plain).abs().max()), [n_val, int(det.bank.shape[0])]


def eval_stages(device, root: Path, ckpt: Path) -> dict:
    """The evaluation path's stages through the library functions the CLI
    calls, on the trained checkpoint at the CLI's defaults, each
    synchronised.  Image level (evaluate and infer): ``predict_mvtec``,
    ``attach_anomaly_scores`` (fit and score), Grad-CAM per 8 images and
    the pixel metrics of its maps.  Patch level, evaluate: the fit on 3
    normality images, then per 8-image batch the embedding, the k-NN
    kernel on it and ``engine.score_patch_maps`` (what evaluate calls);
    infer: ``predict_mvtec`` and ``attach_anomaly_scores`` on all windows.
    Every kernel call of these stages is held against the plain k-NN on
    the same inputs to 1e-5: the scores, both fits' calibration scores, and
    each batch's raw and upsampled maps.  Also checks the Grad-CAM maps
    (finite, in [0, 1], zero wherever y_hat is 0) and the on-card metrics
    against the host oracles."""
    import torch

    from ssad_tpu_torch.config import DataConfig, EvalConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.models.detector import AnomalyDetector
    from ssad_tpu_torch.models.gradcam import make_gradcam_fn
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import knn
    from ssad_tpu_torch.ops.patches import grid_side

    # the CLI's defaults: --batch-size is DataConfig's
    cfg = EvalConfig(imsize=(IMSIZE, IMSIZE), batch_size=DataConfig().batch_size)
    k, seed = cfg.knn_k, cfg.seed
    engine, bank, _ = inf.load_engine(ckpt, device)
    data = mvtec.prepare_pretext_data(root, "bottle", imsize=cfg.imsize, seed=seed)
    test = mvtec.prepare_mvtec_test_data(root, "bottle", imsize=cfg.imsize)
    n = test.images.shape[0]
    out, err, shapes = {"images": n}, {}, {}

    # ---- image level: evaluate and infer ----
    outputs, out["image_embed_ms"] = _timed(
        lambda: inf.predict_mvtec(engine, test, batch_size=cfg.batch_size))
    normality = inf.normality_embeddings(engine, bank, data.train_images,
                                         batch_size=cfg.batch_size)
    (outputs, det), out["image_fit_and_score_ms"] = _timed(
        lambda: inf.attach_anomaly_scores(outputs, normality, k=k, seed=seed))
    _, out["image_score_ms"] = _timed(lambda: det.predict(outputs.embeddings))
    plain = _plain_knn(outputs.embeddings, det.bank, k)
    err["image_scores"] = float((outputs.anomaly_maps - plain).abs().max())
    shapes["image_scores"] = [n, int(det.bank.shape[0])]
    err["image_calibration"], shapes["image_calibration"] = _calibration_vs_plain(
        det, normality, seed, k)
    gradcam = make_gradcam_fn(engine.model)
    bs = max(1, min(8, cfg.batch_size))  # evaluate's Grad-CAM and patch batch
    cams, out["gradcam_ms"] = _timed(lambda: torch.cat([
        gradcam(outputs.tensor_data[lo:lo + bs], outputs.y_hat[lo:lo + bs])
        for lo in range(0, n, bs)]))
    good = outputs.y_hat == 0
    peak = cams.reshape(n, -1).amax(1)
    if (not torch.isfinite(cams).all() or float(cams.min()) < 0.0 or float(cams.max()) > 1.0
            or not bool((peak[good] == 0).all())):
        fail(f"Grad-CAM maps: finite {bool(torch.isfinite(cams).all())}, range "
             f"[{float(cams.min())}, {float(cams.max())}], a nonzero map where y_hat == 0")
    # a defect prediction whose saliency the ReLU cuts everywhere is all
    # zero too: counted, not an error
    out["gradcam_defect_maps"] = int((~good).sum())
    out["gradcam_zero_defect_maps"] = int((peak[~good] == 0).sum())
    out["gradcam_metrics"] = _metrics_against_oracles(cams, test.ground_truths, "Grad-CAM")

    # ---- patch level: evaluate (evaluator.evaluate_category's steps) ----
    def fit_patch():
        rows = inf.normality_embeddings(
            engine, None, data.train_images, batch_size=4, patch_localization=True,
            patch_dim=cfg.patch_dim, stride=cfg.stride, min_bank_rows=10**9,
            max_images=cfg.n_normality_images, seed=seed)
        return rows, AnomalyDetector(k=k).fit(rows, torch.Generator().manual_seed(seed))

    (rows, det), out["patch_fit_ms"] = _timed(fit_patch)
    err["patch_calibration"], shapes["patch_calibration"] = _calibration_vs_plain(
        det, rows, seed, k)
    tiled = knn.prepare_bank(det.bank)
    if not isinstance(tiled, knn.TiledBank):
        fail(f"the patch bank holds {det.bank.shape[0]} rows: not above "
             f"{knn.PALLAS_MAX_BANK_ROWS}, so the tiled kernel would not run")
    ms = {"patch_embed_ms": 0.0, "patch_score_ms": 0.0, "patch_score_maps_ms": 0.0}
    err["patch_batch_scores"] = err["patch_batch_maps"] = 0.0
    shapes["patch_batch_scores"], maps = [], []
    for lo in range(0, n, bs):
        raw = torch.from_numpy(np.ascontiguousarray(test.images[lo:lo + bs]))
        x = im.normalize_imagenet(raw.to(device))
        (_, emb, per), t = _timed(lambda: engine.predict_patches(x, cfg.patch_dim, cfg.stride))
        ms["patch_embed_ms"] += t
        scores, t = _timed(lambda: knn.knn_cosine_scores(emb, tiled, k=k))
        ms["patch_score_ms"] += t
        batch_maps, t = _timed(lambda: engine.score_patch_maps(
            x, tiled, dim=cfg.patch_dim, stride=cfg.stride, k=k, upsample_to=cfg.upsample_size))
        ms["patch_score_maps_ms"] += t
        plain = knn.knn_cosine_scores_tiled_plain(emb, tiled, k=k)
        side = int(round(per ** 0.5))
        plain_maps = inf.upsample(plain.reshape(x.shape[0], side, side), cfg.upsample_size)
        err["patch_batch_scores"] = max(err["patch_batch_scores"],
                                        float((scores - plain).abs().max()))
        err["patch_batch_maps"] = max(err["patch_batch_maps"],
                                      float((batch_maps - plain_maps).abs().max()))
        if [emb.shape[0], tiled.shape[0]] not in shapes["patch_batch_scores"]:
            shapes["patch_batch_scores"].append([emb.shape[0], tiled.shape[0]])
        maps.append(batch_maps)
    out.update(ms)
    out["patch_metrics"] = _metrics_against_oracles(torch.cat(maps), test.ground_truths,
                                                    "patch maps")

    # ---- patch level: infer (cli infer's calls) ----
    outputs, out["infer_patch_embed_ms"] = _timed(lambda: inf.predict_mvtec(
        engine, test, batch_size=bs, patch_localization=True, patch_dim=cfg.patch_dim,
        stride=cfg.stride))
    rows = inf.normality_embeddings(engine, None, data.train_images, patch_localization=True,
                                    patch_dim=cfg.patch_dim, stride=cfg.stride, max_images=3,
                                    seed=seed)
    per = grid_side(IMSIZE, cfg.patch_dim, cfg.stride) ** 2
    (outputs, det), out["infer_patch_fit_and_score_ms"] = _timed(lambda: inf.attach_anomaly_scores(
        outputs, rows, patch_localization=True, num_images=n, patches_per_image=per, k=k,
        seed=seed))
    plain = _plain_knn(outputs.embeddings, det.bank, k)
    err["infer_patch_scores"] = float((outputs.anomaly_maps.reshape(-1) - plain).abs().max())
    shapes["infer_patch_scores"] = [int(outputs.embeddings.shape[0]), int(det.bank.shape[0])]
    err["infer_patch_calibration"], shapes["infer_patch_calibration"] = _calibration_vs_plain(
        det, rows, seed, k)
    out["vs_plain_knn"], out["vs_plain_knn_shapes"] = err, shapes
    bad = {key: v for key, v in err.items() if not v <= KNN_TOL}
    if bad:
        fail(f"kernel calls of the evaluation path vs the plain k-NN: {bad} > {KNN_TOL} "
             f"(shapes {shapes})")
    return out


#: files the JAX evaluator writes per mode (but <subject>_tsne.png, slice 6b)
EVAL_FILES = {
    "image": ["bottle/bottle_artificial_report.txt", "bottle/bottle_image_roc.png",
              "bottle/bottle_pixel_roc.png", "bottle/bottle_pro.png", "bottle/bottle_tsne.png",
              "tables/objects_rocs.png"]
    + [f"tables/{d}/{t}.{e}" for d, e in (("csv", "csv"), ("latex", "tex"), ("markdown", "md"))
       for t in ("image_all_scores", "image_objects_scores", "artificial_all_scores")],
    "patch": ["bottle/bottle_pixel_roc.png", "bottle/bottle_pro.png",
              "tables/objects_pixel_rocs.png", "tables/objects_pros.png"]
    + [f"tables/{d}/{t}.{e}" for d, e in (("csv", "csv"), ("latex", "tex"), ("markdown", "md"))
       for t in ("patch_all_scores", "patch_objects_scores")],
}


def drive_evaluation(device, work: Path) -> dict:
    """Phase 7: cli evaluate (image, patch) and cli infer (image, patch) on
    phase 6's trained checkpoint and a seeded 83-image test split."""
    from ssad_tpu_torch.ops import knn, stem_pool

    root, models = work / "synth_mvtec", work / "train_out"
    n_test = write_eval_split(root / "bottle")
    common = ["--dataset-dir", str(root), "--models-dir", str(models),
              "--imsize", str(IMSIZE), "--seed", "0"]
    record = {"test_images": n_test}

    # ---- the evaluation path: counts to 0 just before, read just after -----
    _zero_launches()
    runs = {}
    for name, argv in (
        ("evaluate_image", ["evaluate", "--subjects", "bottle",
                            "--outputs-dir", str(work / "eval_image")]),
        ("evaluate_patch", ["evaluate", "--subjects", "bottle", "--patch-level",
                            "--outputs-dir", str(work / "eval_patch")]),
        ("infer_image", ["infer", "--subject", "bottle", "--outputs-dir", str(work / "infer_image")]),
        ("infer_patch", ["infer", "--subject", "bottle", "--patch-level",
                         "--outputs-dir", str(work / "infer_patch")]),
    ):
        before = _eval_launches()
        lines, wall = _run_cli(argv + common)
        after = _eval_launches()
        runs[name] = {"wall_s": wall, "images_per_s": n_test / wall, "stdout": lines,
                      "launches": {k: after[k] - before[k] for k in after}}
    launches = _eval_launches()
    # ---- end of the evaluation path ----------------------------------------
    card = card_line()
    for name, run in runs.items():
        print(f"eval {name}: {json.dumps(run)} ({card})", flush=True)
    need = {"evaluate_image": ["knn_cosine_scores", "bn_act"],
            "infer_image": ["knn_cosine_scores", "bn_act"],
            "evaluate_patch": ["stem_pool", "knn_cosine_scores_tiled", "bn_act"],
            "infer_patch": ["stem_pool", "knn_cosine_scores_tiled", "bn_act"]}
    for name, kernels in need.items():
        for k in kernels:
            if runs[name]["launches"][k] < 1:
                fail(f"{k} was not launched by {name}")
    if not runs["evaluate_image"]["stdout"][-1].startswith("bottle: image_auroc=") or \
            not runs["evaluate_patch"]["stdout"][-1].startswith("bottle: pixel_auroc="):
        fail(f"evaluate printed {runs['evaluate_image']['stdout']} / "
             f"{runs['evaluate_patch']['stdout']}")
    for mode in ("image", "patch"):
        missing = [f for f in EVAL_FILES[mode] if not (work / f"eval_{mode}" / f).is_file()]
        if missing:
            fail(f"evaluate ({mode}) did not write {missing}")
        info = json.loads(runs[f"infer_{mode}"]["stdout"][-1])
        with np.load(info["outputs"]) as z:
            shapes = {k: z[k].shape for k in z.files}
        windows = n_test * WINDOWS
        want = {"anomaly": (n_test, IMSIZE, IMSIZE) if mode == "patch" else (n_test,),
                "y_true": (n_test,), "y_hat": (windows,) if mode == "patch" else (n_test,),
                "threshold": ()}
        if shapes != want or info["n"] != want["y_hat"][0]:
            fail(f"infer ({mode}) wrote {shapes}, printed {info}; expected {want}")
    record.update(runs=runs, launches=launches,
                  stages=eval_stages(device, root, models / "bottle" / "best_model.ckpt"))
    print(f"eval stages: {json.dumps(record['stages'])} ({card_line()})", flush=True)
    print(f"eval launches: {json.dumps(launches)}", flush=True)
    t0 = time.perf_counter()
    sweep = curve_sweep(on_device_pixel_metrics(device))
    sweep["wall_s"] = time.perf_counter() - t0
    del sweep["aupro"]
    print(f"eval curves: {json.dumps(sweep)} ({card_line()})", flush=True)
    if sweep["failed"]:
        fail(f"the on-card curves break the monotone rule on {len(sweep['failed'])} of "
             f"{sweep['problems']} problems: {sweep}")
    record["curves"] = sweep
    return record


@contextlib.contextmanager
def recording(module, name: str):
    """Replace the kernel wrapper ``module.name`` by one that records each
    call's positional and keyword arguments (tensors cloned) and result as
    one tuple; its ``launches`` count carries over and back."""
    import torch

    original = getattr(module, name)
    calls = []

    def keep(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        calls.append(tuple(keep(a) for a in args) + tuple(keep(v) for v in kw.values())
                     + (out.detach().clone(),))
        return out

    wrapper.launches = original.launches  # the wrapper's body counts on this name
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        original.launches = wrapper.launches
        setattr(module, name, original)


def knn_shape_record(kernel, plain, bound, q, bank, raw_bank, k: int, match: str,
                     launches: int) -> dict:
    """A k-NN kernel at a main-path shape, on that path's own inputs
    (``bank`` as the path holds it, ``raw_bank`` its f32 rows): |kernel −
    plain|, kernel / plain / library ms (CUDA events), device µs per call
    (the sum over 50 calls / 50, and the least and most of the records,
    and how many records the profiler kept), bound."""
    import torch

    from ssad_tpu_torch.ops import knn

    out = kernel(q, bank, k=k)
    err = float((out - plain(q, bank, k=k)).abs().max())
    qn, bn = knn.l2_normalize(q), knn.l2_normalize(raw_bank)
    rec = {"shape": [q.shape[0], bank.shape[0], q.shape[1]], "k": k, "launches": launches,
           "max_abs_err": err, "ms": cuda_ms(lambda: kernel(q, bank, k=k)),
           "plain_ms": cuda_ms(lambda: plain(q, bank, k=k), warmup=2),
           "library_ms": cuda_ms(lambda: torch.topk(qn @ bn.T, k, dim=1), warmup=2)}
    us = device_kernel_us(lambda: kernel(q, bank, k=k), match, 50)
    rec.update(device_us=sum(us) / 50, device_us_min_max=[min(us), max(us)],
               device_records=len(us))
    rec["bound_ms"], rec["bound_by"] = bound(q.shape[0], bank.shape[0], q.shape[1])
    return rec


def served_batch_profile(scorer, x) -> dict:
    """One served batch under the profiler: wall µs, busy µs and device µs
    by group (stem kernel, tiled k-NN kernel, copies, the model and maps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.core.trace import busy_us, device_events

    scorer.score_tensor(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score_tensor(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    groups = {"stem kernel": 0.0, "tiled k-NN kernel": 0.0, "copies": 0.0, "model and maps": 0.0}
    for name, t0, t1 in events:
        key = ("stem kernel" if "stem_pool" in name else "tiled k-NN kernel" if "knn_tiled"
               in name else "copies" if "memcpy" in name.lower() or "memset" in name.lower()
               else "model and maps")
        groups[key] += t1 - t0
    busy = busy_us(events)
    return {"wall_us": wall_us, "busy_us": busy, "idle_share": 1 - busy / wall_us,
            "device_ops": len(events), "device_us_by_group": groups}


def drive_wide_patch_path(device, work: Path) -> dict:
    """Phase 8a: the patch path of a wide_resnet50_2 PeraNet at its published
    widths (bf16, seeded init) through cli export (10 normality images, a
    2,048-row coreset, k = 1) and 16 HTTP requests on phase 4's bottle tree."""
    import torch

    from ssad_tpu_torch import cli
    from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from ssad_tpu_torch.data.mvtec import load_split
    from ssad_tpu_torch.evaluation.inference import InferenceEngine, normality_embeddings
    from ssad_tpu_torch.models.detector import AnomalyDetector
    from ssad_tpu_torch.models.peranet import build_model, init_model
    from ssad_tpu_torch.ops import bn_act
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import knn, stem_pool
    from ssad_tpu_torch.ops.coreset import kcenter_greedy
    from ssad_tpu_torch.ops.patches import extract_patches
    from ssad_tpu_torch.serving.cli import _load_artifact_models
    from ssad_tpu_torch.serving.server import AnomalyHTTPServer
    from ssad_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    cfg = TrainConfig(data=DataConfig(subject="bottle", imsize=(IMSIZE, IMSIZE)),
                      model=ModelConfig(backbone=WIDE_ARCH))
    model = init_model(build_model(cfg.model), torch.Generator().manual_seed(8))
    sd = model.state_dict()
    models_dir = work / "wide_models"
    save_checkpoint(models_dir / "bottle", sd, None, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    in_features = model.concatenator[0].in_features
    del model
    rec = {"backbone": WIDE_ARCH, "parameters": n_params, "head_in_features": in_features,
           "checkpoint_s": time.perf_counter() - t0}
    rng = np.random.default_rng(9)
    imgs = synthetic_images(rng, PATCH_REQUESTS)
    bodies = []
    for img in imgs:
        buf = io.BytesIO()
        np.save(buf, img)
        bodies.append(buf.getvalue())

    # ---- the wide patch path: counts to 0 just before, read just after -----
    knn.knn_cosine_scores_tiled_cuda.launches = 0
    stem_pool.stem_pool_cuda.launches = 0
    bn_act.bn_act_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    artifact = work / "wide_patch.ssadpt"
    # every tiled k-NN call of the path is recorded: the fit's calibration,
    # the calibration summary's chunks, the warmup and the served batches
    with recording(knn, "knn_cosine_scores_tiled_cuda") as calls:
        t0 = time.perf_counter()
        rc = cli.main(["export", "--models-dir", str(models_dir), "--subject", "bottle",
                       "--mode", "patch", "--dataset-dir", str(work / "mvtec"),
                       "--n-normality-images", str(WIDE_NORMALITY), "--coreset",
                       str(WIDE_CORESET), "--knn-k", "1", "--batch", str(BATCH),
                       "--out", str(artifact)])
        if rc != 0:
            fail(f"cli export of the {WIDE_ARCH} checkpoint returned {rc}")
        rec["export_s"] = time.perf_counter() - t0
        models, rec["warmup_s"] = _load_artifact_models([str(artifact)], 5.0, 256, device)
        batcher, meta = models["bottle"]
        server = AnomalyHTTPServer(models=models, port=0).start()
        try:
            results, latencies, rec["http_wall_s"] = http_fanout(server.port, bodies, [
                "/score?heatmap=1" if i % 4 < 2 else "/score" for i in range(PATCH_REQUESTS)])
            batches = batcher.stats()["batches"]
        finally:
            server.stop()
        launches = {"knn_cosine_scores_tiled": knn.knn_cosine_scores_tiled_cuda.launches,
                    "stem_pool": stem_pool.stem_pool_cuda.launches,
                    "bn_act": bn_act.bn_act_cuda.launches}
    # ---- end of the wide patch path ----------------------------------------
    rec.update(launches=launches, batches=batches,
               peak_memory_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               http_p50_ms=float(np.percentile(latencies, 50)),
               http_p95_ms=float(np.percentile(latencies, 95)))
    scorer = batcher._fns[0]
    # each recorded call against the plain tiled k-NN on its own inputs
    errs = {}
    for q, bank, k, out in calls:
        key = f"{q.shape[0]}x{bank.shape[0]}"
        errs[key] = max(errs.get(key, 0.0), float(
            (out - knn.knn_cosine_scores_tiled_plain(q, bank, k=k)).abs().max()))
    rec["tiled_calls"], rec["tiled_vs_plain_knn"] = len(calls), errs
    if len(calls) != launches["knn_cosine_scores_tiled"]:
        fail(f"wide patch path: {len(calls)} recorded tiled k-NN calls, "
             f"{launches['knn_cosine_scores_tiled']} launches")
    if any(not v <= KNN_TOL for v in errs.values()):
        fail(f"wide patch path: tiled kernel calls vs plain tiled k-NN {errs} > {KNN_TOL}")
    del calls
    val_chunks = -(-(PATCH_IMAGES - NORMALITY_IMAGES) // 4)
    forwards = -(-WIDE_NORMALITY // 4) + val_chunks + batches
    need = {"stem_pool": forwards, "knn_cosine_scores_tiled": 1 + val_chunks + batches,
            "bn_act": BN_ACT_SITES_WIDE_FROM_STEM * forwards}
    for name, least in need.items():
        if launches[name] < least:
            fail(f"wide patch path: {name} launched {launches[name]} times < {least}")
    if (meta["model"]["backbone"], meta["knn_impl"], meta["k"], tuple(scorer.detector.bank.shape)) != (
            WIDE_ARCH, "cuda_tiled", 1, (WIDE_CORESET, 512)) or in_features != 3584:
        fail(f"wide artifact: backbone {meta['model']['backbone']}, knn_impl {meta['knn_impl']}, "
             f"k {meta['k']}, bank {tuple(scorer.detector.bank.shape)}, head in {in_features}")

    # the served maps against the plain tiled k-NN on the scorer's own
    # embeddings, and the stem kernel against the plain stem on its windows
    x = torch.from_numpy(imgs).to(device)
    (direct,) = scorer(imgs)
    http_vs_direct = max(abs(r["map_max"] - float(m.max())) for r, m in zip(results, direct))
    if not np.isfinite(direct).all() or not http_vs_direct <= 1e-6:
        fail(f"wide maps finite={np.isfinite(direct).all()}, HTTP vs direct {http_vs_direct}")
    err, stem, batch_q = 0.0, None, None
    for lo in range(0, PATCH_REQUESTS, BATCH):
        xn = im.normalize_imagenet(x[lo:lo + BATCH])
        _, emb, n = scorer.engine.predict_patches(xn)
        plain = knn.knn_cosine_scores_tiled_plain(emb, scorer.detector.bank, k=1)
        side = int(round(n ** 0.5))
        maps = im.upsample_anomaly_maps(plain.reshape(-1, side, side), IMSIZE).cpu().numpy()
        err = max(err, float(np.abs(maps - direct[lo:lo + BATCH]).max()))
        batch_q = emb
        if stem is None:
            flat = extract_patches(xn.to(torch.bfloat16), dim=32, stride=8).reshape(-1, 32, 32, 3)
            affine = scorer.engine.stem_affine()
            o = stem_pool.stem_pool_cuda(flat, *affine).float()
            r = stem_pool.stem_pool_plain(flat, *affine).float()
            stem = {"windows": int(flat.shape[0]), "max_abs_err": float((o - r).abs().max()),
                    "flipped_share": float((o != r).float().mean())}
            if not (stem["flipped_share"] < STEM_MAX_FLIPPED
                    and bool(torch.allclose(o, r, rtol=STEM_RTOL, atol=STEM_ATOL))):
                fail(f"stem kernel vs plain on the {WIDE_ARCH} stem: {stem}")
    if not err <= KNN_TOL:
        fail(f"wide served maps vs plain tiled k-NN on the same embeddings: max|d|={err}")
    rec["served_vs_plain_tiled_knn_max_abs"], rec["stem_vs_plain"] = err, stem
    rec["tiled_at_coreset"] = knn_shape_record(
        knn.knn_cosine_scores_tiled_cuda, knn.knn_cosine_scores_tiled_plain, tiled_bound,
        batch_q, scorer.detector.scoring_bank(), scorer.detector.bank, 1, "knn_tiled",
        launches["knn_cosine_scores_tiled"])
    if not rec["tiled_at_coreset"]["max_abs_err"] <= KNN_TOL:
        fail(f"tiled kernel at 6,728 x {WIDE_CORESET}: {rec['tiled_at_coreset']}")

    # served batch of 8: host clock, and device µs by group
    scorer(imgs[:BATCH])
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        scorer(imgs[:BATCH])
        times.append((time.perf_counter() - t0) * 1e3)
    rec["batch8_scorer_ms_p50"], rec["batch8_scorer_ms_sorted"] = float(np.median(times)), times
    rec["batch8_profile"] = served_batch_profile(scorer, x[:BATCH])

    # the export's stages through the library calls the CLI makes, each
    # synchronised; the selection under set_sync_debug_mode("error")
    data = load_split(work / "mvtec", "bottle", imsize=(IMSIZE, IMSIZE))
    norm, rec["normality_ms"] = _timed(lambda: normality_embeddings(
        scorer.engine, None, data.train_images, batch_size=4, min_bank_rows=10**9,
        max_images=WIDE_NORMALITY, seed=0, patch_localization=True))
    gen = torch.Generator().manual_seed(0)
    m = norm.shape[0]
    perm = torch.randperm(m, generator=gen).to(device)
    train = norm[perm[round(0.3 * m):]]
    first = int(torch.randint(0, train.shape[0], (), generator=gen))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        idx = kcenter_greedy(train, WIDE_CORESET, first=first)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    rec["coreset_rows"] = [int(train.shape[0]), WIDE_CORESET]
    rec["coreset_select_ms"] = start.elapsed_time(end)
    det, rec["fit_ms"] = _timed(lambda: AnomalyDetector(k=1).fit(
        norm, torch.Generator().manual_seed(0), coreset=WIDE_CORESET))
    if not (torch.equal(train[idx], det.bank) and torch.equal(det.bank, scorer.detector.bank)):
        fail("the coreset selected under sync checks, the library fit and the artifact's "
             "bank differ")

    # the f32 wide model on the card (TF32 off) against the CPU port on 8 windows
    windows = flat[:WIDE_F32_WINDOWS]
    embs = []
    for dev in (device, torch.device("cpu")):
        m32 = build_model(ModelConfig(backbone=WIDE_ARCH, compute_dtype="float32"))
        m32.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            out = InferenceEngine(m32, dev).patch_forward(windows.to(dev))
        embs.append(out["latent_space"].cpu().numpy())
    rec["f32_windows_cuda_vs_cpu_max_abs"] = float(np.abs(embs[0] - embs[1]).max())
    rec["f32_embedding_scale"] = float(np.abs(embs[1]).max())
    if not rec["f32_windows_cuda_vs_cpu_max_abs"] <= PATCH_F32_MODEL_TOL:
        fail(f"f32 {WIDE_ARCH} windows cuda vs cpu: {rec['f32_windows_cuda_vs_cpu_max_abs']}")
    return rec


def drive_coreset_eval(device, work: Path) -> dict:
    """Phase 8b: cli evaluate --patch-level --coreset 512 --knn-k 1 on phase
    7's checkpoint and test split: the coreset sends patch batches of 6,728
    windows to the resident k-NN kernel; every call of it against the plain
    k-NN on the same inputs."""
    from ssad_tpu_torch.ops import knn, stem_pool

    argv = ["evaluate", "--subjects", "bottle", "--patch-level", "--coreset", str(EVAL_CORESET),
            "--knn-k", "1", "--outputs-dir", str(work / "eval_coreset"),
            "--dataset-dir", str(work / "synth_mvtec"), "--models-dir", str(work / "train_out"),
            "--imsize", str(IMSIZE), "--seed", "0"]
    # ---- the coreset path: counts to 0 just before, read just after --------
    _zero_launches()
    with recording(knn, "knn_cosine_scores_cuda") as calls:
        lines, wall = _run_cli(argv)
        launches = _eval_launches()
    # ---- end of the coreset path -------------------------------------------
    errs = {}
    for q, bank, k, out in calls:
        key = f"{q.shape[0]}x{bank.shape[0]}"
        errs[key] = max(errs.get(key, 0.0),
                        float((out - knn.knn_cosine_scores_plain(q, bank, k=k)).abs().max()))
    full = [c for c in calls if c[0].shape[0] == BATCH * WINDOWS]
    rec = {"wall_s": wall, "stdout": lines, "launches": launches, "calls": len(calls),
           "vs_plain_knn": errs}
    if (launches["knn_cosine_scores"] != len(calls) or launches["knn_cosine_scores_tiled"]
            or not launches["stem_pool"] or not full or full[0][1].shape[0] != EVAL_CORESET):
        fail(f"coreset evaluate: launches {launches}, {len(calls)} recorded calls, shapes "
             f"{sorted(errs)}")
    if any(not v <= KNN_TOL for v in errs.values()):
        fail(f"coreset evaluate: knn kernel calls vs plain k-NN {errs} > {KNN_TOL}")
    q, bank, k, _ = full[0]
    rec["knn_at_coreset"] = knn_shape_record(
        knn.knn_cosine_scores_cuda, knn.knn_cosine_scores_plain, knn_bound, q, bank, bank, k,
        "knn_", launches["knn_cosine_scores"])
    return rec


def _maha_host(rows: np.ndarray, perm: np.ndarray, queries: np.ndarray,
               mean: np.ndarray, precision: np.ndarray) -> dict:
    """The Mahalanobis fit and scores in float64 on the host: the fit from
    the same split, and the scores from the port's f32 mean and precision."""
    m, d = rows.shape
    n_val = max(round(0.3 * m), 1)
    train = rows[perm[n_val:]].astype(np.float64) if m - n_val >= 2 else rows.astype(np.float64)
    mu = train.mean(axis=0)
    x = train - mu
    cov = x.T @ x / max(train.shape[0] - 1, 1)
    cov = 0.9 * cov + 0.1 * np.trace(cov) / d * np.eye(d)
    q = queries.astype(np.float64) - mean.astype(np.float64)
    scores = np.sqrt(np.maximum(np.einsum("qd,de,qe->q", q, precision.astype(np.float64), q),
                                0.0))
    return {"mean": mu, "precision": np.linalg.inv(cov), "scores": scores}


def drive_mahalanobis(device, work: Path) -> dict:
    """Phase 8c: cli evaluate --scorer mahalanobis at both levels on phase
    7's tree, the same fits and scores through the library with TF32 on and
    off against a float64 host reference, then cli export --scorer
    mahalanobis of phase 6's checkpoint served over HTTP."""
    import torch

    from ssad_tpu_torch.config import EvalConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.models.detector import MahalanobisDetector, mahalanobis_distances
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.ops import stem_pool
    from ssad_tpu_torch.serving.cli import _load_artifact_models
    from ssad_tpu_torch.serving.server import AnomalyHTTPServer

    root, models = work / "synth_mvtec", work / "train_out"
    common = ["--dataset-dir", str(root), "--models-dir", str(models), "--imsize", str(IMSIZE),
              "--seed", "0", "--subjects", "bottle", "--scorer", "mahalanobis"]
    rec = {"runs": {}}
    # ---- the Mahalanobis path: counts to 0 just before, read just after ----
    stem_pool.stem_pool_cuda.launches = 0
    for name, extra in (("evaluate_image", []), ("evaluate_patch", ["--patch-level"])):
        lines, wall = _run_cli(["evaluate", "--outputs-dir", str(work / f"maha_{name}")]
                               + extra + common)
        rec["runs"][name] = {"wall_s": wall, "stdout": lines}
    ckpt = models / "bottle" / "best_model.ckpt"
    artifact = work / "maha_image.ssadpt"
    _run_cli(["export", "--models-dir", str(models), "--subject", "bottle", "--batch",
              str(BATCH), "--scorer", "mahalanobis", "--out", str(artifact)])
    served, _ = _load_artifact_models([str(artifact)], 5.0, 256, device)
    batcher, meta = served["bottle"]
    test = mvtec.prepare_mvtec_test_data(root, "bottle", imsize=(IMSIZE, IMSIZE))
    imgs = test.images[:BATCH].astype(np.float32)
    bodies = []
    for img in imgs:
        buf = io.BytesIO()
        np.save(buf, img)
        bodies.append(buf.getvalue())
    server = AnomalyHTTPServer(models=served, port=0).start()
    try:
        results, _, _ = http_fanout(server.port, bodies, ["/score"] * BATCH)
    finally:
        server.stop()
    rec["stem_pool_launches"] = stem_pool.stem_pool_cuda.launches
    # ---- end of the Mahalanobis path ----------------------------------------
    if not rec["runs"]["evaluate_image"]["stdout"][-1].startswith("bottle: image_auroc=") or \
            not rec["runs"]["evaluate_patch"]["stdout"][-1].startswith("bottle: pixel_auroc="):
        fail(f"evaluate --scorer mahalanobis printed {rec['runs']}")
    if rec["stem_pool_launches"] < 1 or meta["scorer"] != "mahalanobis" or meta["knn_impl"]:
        fail(f"mahalanobis path: stem launches {rec['stem_pool_launches']}, header "
             f"{meta['scorer']} / {meta['knn_impl']}")

    # the fits and scores as the CLI computes them, TF32 on and off, against
    # the float64 host reference
    cfg = EvalConfig(imsize=(IMSIZE, IMSIZE))
    engine, bank, _ = inf.load_engine(ckpt, device)
    data = mvtec.prepare_pretext_data(root, "bottle", imsize=cfg.imsize, seed=0)
    outputs = inf.predict_mvtec(engine, test, batch_size=96)
    image_rows = inf.normality_embeddings(engine, bank, data.train_images, batch_size=96)
    patch_rows = inf.normality_embeddings(
        engine, None, data.train_images, batch_size=4, patch_localization=True,
        min_bank_rows=10**9, max_images=cfg.n_normality_images, seed=0)
    _, patch_q, _ = engine.predict_patches(
        im.normalize_imagenet(torch.from_numpy(test.images[:BATCH]).to(device)))
    checks = {}
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for level, rows, q in (("image", image_rows, outputs.embeddings),
                                   ("patch", patch_rows, patch_q)):
                perm = torch.randperm(rows.shape[0], generator=torch.Generator().manual_seed(0))
                det = MahalanobisDetector().fit(rows, torch.Generator().manual_seed(0))
                scores = mahalanobis_distances(q, det.mean, det.precision)
                host = _maha_host(rows.cpu().numpy(), perm.numpy(), q.cpu().numpy(),
                                  det.mean.cpu().numpy(), det.precision.cpu().numpy())
                hp = host["precision"]
                checks[f"{level}_tf32_{tf32}"] = {
                    "rows": int(rows.shape[0]), "queries": int(q.shape[0]),
                    "scores_rel": float(np.max(np.abs(scores.cpu().numpy() - host["scores"])
                                               / host["scores"])),
                    "mean_abs": float(np.abs(det.mean.cpu().numpy() - host["mean"]).max()),
                    "precision_rel": float(np.abs(det.precision.cpu().numpy() - hp).max()
                                           / np.abs(hp).max()),
                    "scores": scores}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for level in ("image", "patch"):
        on, off = checks[f"{level}_tf32_True"], checks[f"{level}_tf32_False"]
        checks[f"{level}_tf32_equal"] = bool(torch.equal(on.pop("scores"), off.pop("scores")))
    bad = {k: v for k, v in checks.items() if v is False or isinstance(v, dict) and not (
        v["scores_rel"] <= MAHA_REL_TOL and v["mean_abs"] <= 1e-6
        and v["precision_rel"] <= 1e-4)}
    if bad:
        fail(f"Mahalanobis vs the float64 host reference, TF32 on and off: {bad}")
    rec["vs_host_f64"] = checks
    rec["score_ms_6728"] = cuda_ms(lambda: mahalanobis_distances(patch_q, det.mean, det.precision))

    # the served image scores are evaluate's detector's: the same fit (its
    # normality is the bank, ≥ 100 rows), the same scores on one batch
    scorer = batcher._fns[0]
    _, det = inf.attach_anomaly_scores(outputs, image_rows, scorer="mahalanobis", seed=0)
    direct, _, _ = scorer(imgs)
    _, emb = scorer.engine.predict_batch(im.normalize_imagenet(torch.from_numpy(imgs).to(device)))
    want = det.predict(emb).cpu().numpy()
    http = np.array([r["score"] for r in results], np.float32)
    same_fit = (torch.equal(scorer.detector.mean, det.mean) and torch.equal(scorer.detector.precision, det.precision)
                and meta["threshold"] == det.threshold)
    http_rel = float(np.max(np.abs(http - direct) / direct))
    if (int(bank.count) < 100 or not same_fit or not np.array_equal(direct, want)
            or not http_rel <= 1e-6):
        fail(f"served Mahalanobis scores vs evaluate's detector: bank rows {int(bank.count)}, "
             f"same fit {same_fit}, direct max|d| {float(np.abs(direct - want).max())}, "
             f"HTTP rel {http_rel}")
    rec["served_scores"], rec["http_vs_direct_rel"] = http.tolist(), http_rel
    return rec


def drive_scorers(device, work: Path) -> dict:
    """Phase 8: the wide patch path, the coreset into the resident kernel,
    and the Mahalanobis scorer."""
    out = {}
    for name, fn in (("wide", drive_wide_patch_path), ("coreset", drive_coreset_eval),
                     ("mahalanobis", drive_mahalanobis)):
        t0 = time.perf_counter()
        out[name] = fn(device, work)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"scorers {name}: {json.dumps(out[name])} ({card_line()})", flush=True)
    return out


@contextlib.contextmanager
def recording_every_kernel():
    """Every call of the four kernel wrappers, recorded: {kernel name:
    calls} (``recording``; bn_act's checked as it is made,
    ``checking_bn_act``)."""
    from ssad_tpu_torch.ops import knn, stem_pool

    with recording(knn, "knn_cosine_scores_cuda") as resident, \
            recording(knn, "knn_cosine_scores_tiled_cuda") as tiled, \
            recording(stem_pool, "stem_pool_cuda") as stem, checking_bn_act() as bn:
        yield {"knn_cosine_scores": resident, "knn_cosine_scores_tiled": tiled,
               "stem_pool": stem, "bn_act": bn}


def held_against_plain(calls: dict, what: str) -> dict:
    """Each recorded kernel call against its plain version on its own
    inputs: the k-NN kernels within KNN_TOL, the stem at phase 2's
    tolerance, bn_act bit for bit → {kernel: {shape: largest |Δ|}} (the
    stem's also its share of elements not bit-equal; bn_act's the elements
    whose bits differ, 0)."""
    import torch

    from ssad_tpu_torch.ops import knn, stem_pool

    plains = {"knn_cosine_scores": knn.knn_cosine_scores_plain,
              "knn_cosine_scores_tiled": knn.knn_cosine_scores_tiled_plain}
    out = {}
    for name, recorded in calls.items():
        errs = {}
        for call in recorded:
            if name == "bn_act":
                key, differ = call
                errs[key] = max(errs.get(key, 0), differ)
                if differ:
                    fail(f"{what}: bn_act kernel call on {key} vs plain: {differ} elements' "
                         f"bits differ")
                continue
            if name == "stem_pool":
                x, k4, scale, bias, got = call
                want = stem_pool.stem_pool_plain(x, k4, scale, bias).float()
                got = got.float()
                key = f"{x.shape[0]}"
                flipped = float((got != want).float().mean())
                prev = errs.get(key, {"max_abs_err": 0.0, "flipped_share": 0.0})
                errs[key] = {"max_abs_err": max(prev["max_abs_err"],
                                                float((got - want).abs().max())),
                             "flipped_share": max(prev["flipped_share"], flipped)}
                if not (flipped < STEM_MAX_FLIPPED and bool(torch.allclose(
                        got, want, rtol=STEM_RTOL, atol=STEM_ATOL))):
                    fail(f"{what}: stem kernel call on {key} windows vs plain: {errs[key]}")
                continue
            q, bank, k, got = call
            key = f"{q.shape[0]}x{bank.shape[0]}"
            err = float((got - plains[name](q, bank, k=k)).abs().max())
            errs[key] = max(errs.get(key, 0.0), err)
            if not err <= KNN_TOL:
                fail(f"{what}: {name} call at {key} vs plain: {err} > {KNN_TOL}")
        out[name] = errs
    return out


def drive_localize(device, work: Path) -> dict:
    """Phase 9a: cli localize at both levels on phase 6's checkpoint and
    phase 7's test split, every kernel call recorded."""
    root, models = work / "synth_mvtec", work / "train_out"
    runs = {}
    # ---- the localize path: counts to 0 just before, read just after -------
    _zero_launches()
    with recording_every_kernel() as calls:
        for level in ("image", "patch"):
            before = _eval_launches()
            lines, wall = _run_cli(["localize", "--dataset-dir", str(root), "--models-dir",
                                    str(models), "--subject", "bottle", "--imsize", str(IMSIZE),
                                    "--outputs-dir", str(work / f"localize_{level}"),
                                    "--num-images", str(LOCALIZE_IMAGES)]
                                   + (["--patch-level"] if level == "patch" else []))
            after = _eval_launches()
            runs[level] = {"wall_s": wall, "s_per_image": wall / LOCALIZE_IMAGES,
                           "panels": len(lines),
                           "launches": {k: after[k] - before[k] for k in after}}
        launches = _eval_launches()
    # ---- end of the localize path ------------------------------------------
    for level, run in runs.items():
        panels = sorted((work / f"localize_{level}" / "bottle").glob("bottle_*_panel.png"))
        if run["panels"] != LOCALIZE_IMAGES or len(panels) != LOCALIZE_IMAGES:
            fail(f"localize {level}: printed {run['panels']} panels, wrote {len(panels)}")
    if runs["patch"]["launches"]["knn_cosine_scores_tiled"] < 1 + LOCALIZE_IMAGES or \
            runs["patch"]["launches"]["stem_pool"] < 2 + LOCALIZE_IMAGES:
        fail(f"localize --patch-level launches {runs['patch']['launches']}")
    rec = {"runs": runs, "launches": launches,
           "calls": {k: len(v) for k, v in calls.items()},
           "vs_plain": held_against_plain(calls, "localize")}
    if any(rec["calls"][k] != launches[k] for k in launches):
        fail(f"localize: recorded calls {rec['calls']} != launches {launches}")
    return rec


def drive_tsne(device) -> dict:
    """Phase 9b: the port's t-SNE of 339 seeded 512-d points on the card."""
    import torch

    from ssad_tpu_torch.evaluation.tsne import tsne

    rng = np.random.default_rng(11)
    centers = rng.normal(0, 1, (6, 512))
    labels = rng.integers(0, 6, TSNE_POINTS)
    x = torch.from_numpy((centers[labels] + rng.normal(0, 0.8, (TSNE_POINTS, 512)))
                         .astype(np.float32)).to(device)
    times, pts = [], None
    for _ in range(2):
        pts, ms = _timed(lambda: tsne(x, seed=0))
        times.append(ms)
    pts = pts.cpu().numpy()
    if pts.shape != (TSNE_POINTS, 2) or not np.isfinite(pts).all():
        fail(f"t-SNE of {TSNE_POINTS} points: shape {pts.shape}, finite {np.isfinite(pts).all()}")
    # class separation: the mean distance to a point's own class centroid
    # against the mean distance to the others'
    cents = np.stack([pts[labels == c].mean(axis=0) for c in range(6)])
    d = np.linalg.norm(pts[:, None, :] - cents[None], axis=2)
    own = float(d[np.arange(TSNE_POINTS), labels].mean())
    other = float(d[np.arange(TSNE_POINTS)[:, None], np.arange(6)[None]][
        np.arange(6)[None] != labels[:, None]].mean())
    if not own < 0.5 * other:
        fail(f"t-SNE of {TSNE_POINTS} points does not separate its 6 classes: {own} vs {other}")
    return {"points": TSNE_POINTS, "ms": times, "own_centroid_distance": own,
            "other_centroid_distance": other}


def _bench_with_reload(device, artifact: Path, requests: int, frontend: str = "stdlib",
                       devices: int = 1) -> dict:
    """A server over ``artifact`` as ``cli serve --frontend F --devices N``
    builds it (the product loaders, with the ``serve`` reloader); ``cli
    serve-bench --url`` against it at 4 clients while the main thread
    scrapes /metrics and posts one /admin/reload mid-run: once a quarter
    of the requests are in, answered while the bench still runs, and
    followed by requests that the reloaded models serve.  The native
    front end's transport must shed nothing and see no protocol error."""
    import urllib.request

    from ssad_tpu_torch import cli
    from ssad_tpu_torch.serving.cli import _load_artifact_models, _make_http_server

    def load():
        return _load_artifact_models([str(artifact)], 5.0, 256, device, devices=devices)

    models, warmup_s = load()
    server, got = _make_http_server(frontend, models=models, port=0, reloader=load,
                                    max_queue=256)
    if got != frontend:
        fail(f"{artifact.name}: asked for the {frontend} front end, got {got}")
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    out = {}

    def bench():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["rc"] = cli.main(["serve-bench", "--url", url, "--requests", str(requests),
                                  "--concurrency", "4", "--warmup", "8",
                                  "--imsize", str(IMSIZE)])
        out["report"] = json.loads(buf.getvalue().strip().splitlines()[-1])

    transport = None
    try:
        thread = threading.Thread(target=bench)
        thread.start()
        while thread.is_alive() and server.models["bottle"][0].stats()["requests"] < requests // 4:
            time.sleep(0.01)
        mid_run = thread.is_alive()
        req = urllib.request.Request(url + "/admin/reload", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            reload = {"status": r.status, "mid_run": mid_run, **json.loads(r.read().decode())}
        reload["running_after"] = thread.is_alive()
        reloaded = server.models["bottle"][0]
        at_reload = reloaded.stats()["requests"]
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        thread.join(600)
        reload["served_after"] = reloaded.stats()["requests"] - at_reload
        if frontend == "native":
            transport = server.transport_stats()
    finally:
        server.stop()
    report = out.get("report") or {}
    if out.get("rc") != 0 or report.get("ok") != requests or report.get("errors") or \
            report.get("shed"):
        fail(f"serve-bench on {artifact.name} ({frontend}): rc {out.get('rc')}, {report}")
    need = ('ssad_requests_total{model="bottle"}', "# TYPE ssad_score_drift_ks gauge",
            "# TYPE ssad_request_latency_ms summary")
    if reload["status"] != 200 or reload["reloaded"] != ["bottle"] or \
            not all(n in metrics for n in need) or not reload["mid_run"] or \
            not reload["running_after"] or reload["served_after"] < 1:
        fail(f"{artifact.name} ({frontend}): reload {reload}, metrics lines "
             f"{metrics.splitlines()[:6]}")
    if transport is not None and (transport["shed_transport"] or transport["protocol_errors"]):
        fail(f"{artifact.name}: the native transport shed or refused requests: {transport}")
    lat = report["latency_ms"]
    rec = {"qps": report["qps"], "p50_ms": lat["p50"], "p95_ms": lat["p95"],
           "requests": requests, "concurrency": 4, "wall_s": report["wall_s"],
           "reload": reload, "warmup_s": warmup_s, "frontend": frontend, "devices": devices,
           "metrics_lines": len(metrics.splitlines()),
           "mean_batch_occupancy": (report.get("server_stats") or {}).get(
               "mean_batch_occupancy")}
    if transport is not None:
        rec["transport"] = transport
    return rec


def drive_serving_extras(device, work: Path) -> dict:
    """Phase 9c: export --dtype --validate, evaluate-artifact, and
    serve-bench with /metrics and /admin/reload, every kernel call
    recorded."""
    root, models = work / "synth_mvtec", work / "train_out"
    rec = {"exports": {}, "evaluate_artifact": {}}
    # ---- the serving extras path: counts to 0 just before, read just after --
    _zero_launches()
    with recording_every_kernel() as calls:
        for mode in ("image", "patch"):
            for dtype in ("int8", "bfloat16", None):
                if dtype is None and mode == "patch":
                    continue
                name = f"{mode}_{dtype or 'float32'}"
                argv = ["export", "--models-dir", str(models), "--subject", "bottle",
                        "--mode", mode, "--batch", str(BATCH),
                        "--out", str(work / f"{name}.ssadpt")]
                if mode == "patch":
                    argv += ["--dataset-dir", str(root), "--n-normality-images",
                             str(EXTRAS_NORMALITY)]
                if dtype:
                    argv += ["--dtype", dtype, "--validate"]
                lines, wall = _run_cli(argv)
                info = json.loads(lines[-1])
                rec["exports"][name] = {"wall_s": wall, "bytes": info["bytes"],
                                        "validation": info["validation"]}
                v = info["validation"]
                if dtype and (not v["finite"] or not v["max_abs_score_drift"] < 0.05
                              or v.get("label_agreement", 1.0) < 0.9):
                    fail(f"export {name} --validate: {v}")
        for name in ("image_int8", "patch_int8"):
            lines, wall = _run_cli(["evaluate-artifact", "--artifact",
                                    str(work / f"{name}.ssadpt"), "--dataset-dir", str(root)])
            info = json.loads(lines[-1])
            info["wall_s"] = wall
            rec["evaluate_artifact"][name] = info
            keys = ("image_auroc", "f1_optimal") if name.startswith("image") else \
                ("pixel_auroc", "iou", "aupro")
            if info["n_test"] < 80 or info["dtype"] != "int8" or \
                    not all(0.0 <= info[k] <= 1.0 for k in keys):
                fail(f"evaluate-artifact {name}: {info}")
        rec["serve_bench"] = {
            "image_float32": _bench_with_reload(device, work / "image_float32.ssadpt",
                                                EXTRAS_IMAGE_REQUESTS),
            "patch_int8": _bench_with_reload(device, work / "patch_int8.ssadpt",
                                             EXTRAS_PATCH_REQUESTS)}
        launches = _eval_launches()
    # ---- end of the serving extras path -------------------------------------
    rec["launches"] = launches
    rec["calls"] = {k: len(v) for k, v in calls.items()}
    if any(rec["calls"][k] != launches[k] for k in launches):
        fail(f"serving extras: recorded calls {rec['calls']} != launches {launches}")
    rec["vs_plain"] = held_against_plain(calls, "serving extras")
    f32 = rec["exports"]["image_float32"]["bytes"]
    rec["bytes_vs_float32"] = {k: v["bytes"] / f32 for k, v in rec["exports"].items()}
    return rec


def drive_extras(device, work: Path) -> dict:
    """Phase 9: localize, t-SNE, and the serving extras."""
    out = {}
    for name, fn in (("localize", lambda: drive_localize(device, work)),
                     ("tsne", lambda: drive_tsne(device)),
                     ("serving", lambda: drive_serving_extras(device, work))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"extras {name}: {json.dumps(out[name])} ({card_line()})", flush=True)
    return out


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's own TF32 defaults inside the block (matmuls off, cuDNN
    on), the settings a ``cli serve`` process runs with."""
    import torch

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def start_server_process(artifact: Path, frontend: str, log: Path):
    """``python -m ssad_tpu_torch.cli serve --artifact A --port 0 --frontend
    F --devices 0`` from the repository root, its stderr into ``log``."""
    with open(log, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "ssad_tpu_torch.cli", "serve", "--artifact", str(artifact),
             "--port", "0", "--frontend", frontend, "--devices", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)


def read_server_line(proc, what: str, timeout_s: float = 300.0) -> dict:
    """The first JSON line a ``cli serve`` process prints (lines before it,
    the fallback's WARNING among them, are kept under ``before``)."""
    box = {"before": []}

    def read():
        for line in proc.stdout:
            try:
                box["info"] = json.loads(line)
                return
            except ValueError:
                box["before"].append(line.rstrip())

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout_s)
    if "info" not in box:
        fail(f"{what}: no JSON line from `cli serve` in {timeout_s} s "
             f"(exit {proc.poll()}, printed {box['before']})")
    return {**box["info"], "before": box["before"]}


def _url_bench(url: str, clients: int, min_wall_s: float = 3.0) -> dict:
    """``cli serve-bench --url`` at ``clients`` closed-loop clients, sized
    from a 64-request probe run so that it lasts at least ``min_wall_s``."""
    from ssad_tpu_torch import cli

    def run(n: int) -> dict:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["serve-bench", "--url", url, "--requests", str(n), "--concurrency",
                           str(clients), "--warmup", "0", "--imsize", str(IMSIZE)])
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0 or report.get("ok") != n or report.get("errors") or report.get("shed"):
            fail(f"serve-bench --url {url} at {clients} clients: rc {rc}, {report}")
        return report

    report = run(64)
    for _ in range(3):
        report = run(max(64, int(report["qps"] * (min_wall_s + 0.5)) + 1))
        if report["wall_s"] >= min_wall_s:
            break
    stats = report.get("server_stats") or {}
    return {"qps": report["qps"], "p50_ms": report["latency_ms"]["p50"],
            "p95_ms": report["latency_ms"]["p95"], "requests": report["ok"],
            "wall_s": report["wall_s"], "clients": clients,
            "mean_batch_occupancy": stats.get("mean_batch_occupancy")}


def drive_native_serving(device, work: Path) -> dict:
    """Phase 10: serving through the native C++ front end at ``--devices
    0``.  (a) In process, every kernel call recorded: phase 9's two
    artifacts behind ``NativeAnomalyHTTPServer`` with the ``serve``
    reloader, ``serve-bench --url`` at 4 clients, a reload mid-run.  (b)
    ``cli serve`` in a second process per artifact and front end: the
    bench at 4 and 16 clients, 16 seeded images against the in-process
    scorer, SIGTERM."""
    import torch

    from ssad_tpu_torch import native
    from ssad_tpu_torch.serving import native_frontend
    from ssad_tpu_torch.serving.export import load_scorer

    names = ("image_float32", "patch_int8")
    frontends = ("native", "stdlib")
    rec = {"second_process": {}}
    # the g++ build, timed here before any server process could make it
    if not native_frontend.available():
        fail("the native front end's library did not build (g++)")
    rec["build_s"] = native.build_s.get("ssadhttp")
    # (b)'s servers load while (a) runs: their start is not what is measured
    procs = {}
    try:
        for name in names:
            for frontend in frontends:
                procs[name, frontend] = start_server_process(
                    work / f"{name}.ssadpt", frontend, work / f"serve_{name}_{frontend}.log")
        # ---- (a) the native serving path: counts to 0 just before, read just after --
        _zero_launches()
        with recording_every_kernel() as calls:
            rec["in_process"] = {
                name: _bench_with_reload(device, work / f"{name}.ssadpt", requests,
                                         frontend="native", devices=0)
                for name, requests in zip(names, NATIVE_INPROC_REQUESTS)}
            launches = _eval_launches()
        # ---- end of the native serving path ----------------------------------------
        rec["launches"] = launches
        rec["calls"] = {k: len(v) for k, v in calls.items()}
        if any(rec["calls"][k] != launches[k] for k in launches):
            fail(f"native serving: recorded calls {rec['calls']} != launches {launches}")
        rec["vs_plain"] = held_against_plain(calls, "native serving")
        del calls

        # ---- (b) the server in a second process ---------------------------------------
        rng = np.random.default_rng(10)
        imgs = rng.uniform(size=(NATIVE_CHECK_IMAGES, IMSIZE, IMSIZE, 3)).astype(np.float32)
        bodies = []
        for img in imgs:
            buf = io.BytesIO()
            np.save(buf, img)
            bodies.append(buf.getvalue())
        for name in names:
            with torch_default_tf32():
                direct = load_scorer(work / f"{name}.ssadpt", device)(imgs)
            for frontend in frontends:
                proc = procs[name, frontend]
                info = read_server_line(proc, f"serve {name} --frontend {frontend}")
                if info["frontend"] != frontend or info["devices"] != 0:
                    fail(f"serve {name} --frontend {frontend}: {info}")
                url = f"http://127.0.0.1:{info['port']}"
                out = {"warmup_s": info["warmup_s"]}
                for clients in NATIVE_CLIENTS:
                    out[f"c{clients}"] = _url_bench(url, clients)
                results, _, _ = http_fanout(info["port"], bodies, ["/score"] * len(bodies))
                if name.startswith("image"):
                    got = np.array([r["score"] for r in results], np.float32)
                    want = direct[0]
                else:
                    got = np.array([[r["map_max"], r["map_mean"]] for r in results], np.float32)
                    want = np.stack([direct[0].max(axis=(1, 2)), direct[0].mean(axis=(1, 2))], 1)
                out["vs_in_process_max_abs"] = float(np.max(np.abs(got - want)))
                if not out["vs_in_process_max_abs"] <= KNN_TOL:
                    fail(f"serve {name} --frontend {frontend}: scores vs the in-process "
                         f"scorer {out['vs_in_process_max_abs']} > {KNN_TOL}")
                proc.send_signal(signal.SIGTERM)
                try:
                    out["exit"] = proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    fail(f"serve {name} --frontend {frontend} did not exit within 30 s "
                         "of SIGTERM")
                if out["exit"] != 0:
                    fail(f"serve {name} --frontend {frontend} exited {out['exit']} on SIGTERM: "
                         f"{(work / f'serve_{name}_{frontend}.log').read_text()[-2000:]}")
                rec["second_process"][f"{name}/{frontend}"] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
    keys = ("qps", "p50_ms", "p95_ms", "mean_batch_occupancy", "requests", "wall_s")
    line = {
        "second_process": {key: {**{c: {k: v[c][k] for k in keys}
                                    for c in (f"c{n}" for n in NATIVE_CLIENTS)},
                                 **{k: v[k] for k in ("vs_in_process_max_abs", "exit",
                                                      "warmup_s")}}
                           for key, v in rec["second_process"].items()},
        "in_process": {name: {k: v[k] for k in keys + ("transport",)}
                       for name, v in rec["in_process"].items()},
        "g++_build_s": rec["build_s"],
    }
    print(f"serving native: {json.dumps(line)} ({card_line()})", flush=True)
    return rec


def drive_doctor() -> dict:
    """Phase 11a: ``cli doctor`` in a second process (its device probe in a
    third): exit 0 on the card, the build directory writable."""
    proc = subprocess.run([sys.executable, "-m", "ssad_tpu_torch.cli", "doctor"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    try:
        report = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"cli doctor printed no JSON line (exit {proc.returncode}): {proc.stderr[-2000:]}")
    print(f"doctor: {json.dumps(report)} ({card_line()})", flush=True)
    backend = report.get("backend", {})
    if proc.returncode != 0 or not report.get("ok") or backend.get("platform") != "cuda" \
            or backend.get("n_devices", 0) < 1 or not report["compile_cache"]["writable"]:
        fail(f"cli doctor: exit {proc.returncode}, {report}")
    return report


def drive_profile(work: Path) -> dict:
    """Phase 11b: ``cli profile --what patch`` (256², batch 8: the stem and
    the resident k-NN on a 1,000-row bank) and ``--what train`` (phase 5's
    bottle tree, 256², batch 96, bf16, the fine-tune step with the fill),
    each PROFILE_STEPS steps, under PyTorch's default TF32 flags (a CLI
    process's); launch counts reset just before and read just after, every
    kernel call recorded and held against its plain version."""
    root = work / "synth_mvtec"
    runs = {}
    # ---- the profile path: counts to 0 just before, read just after ---------
    _zero_launches()
    with recording_every_kernel() as calls, torch_default_tf32():
        for what, flags in (("patch", ["--profile-batch", str(PROFILE_BATCH)]),
                            ("train", ["--batch-size", str(TRAIN_BATCH)])):
            before = _eval_launches()
            lines, wall = _run_cli(["profile", "--what", what, "--dataset-dir", str(root),
                                    "--subject", "bottle", "--imsize", str(IMSIZE),
                                    "--steps", str(PROFILE_STEPS), "--profile-dir",
                                    str(work / f"profile_{what}")] + flags)
            after = _eval_launches()
            runs[what] = {**json.loads(lines[-1]), "wall_s": wall,
                          "launches": {k: after[k] - before[k] for k in after}}
        launches = _eval_launches()
    # ---- end of the profile path ---------------------------------------------
    for what, run in runs.items():
        traces = list((work / f"profile_{what}").glob("*.pt.trace.json"))
        run["trace_bytes"] = sum(t.stat().st_size for t in traces)
        if run["steps"] != PROFILE_STEPS or not traces or run["trace_bytes"] == 0:
            fail(f"profile --what {what}: {run['steps']} steps, traces {traces}")
        print(f"profile {what}: {json.dumps(run)} ({card_line()})", flush=True)
    rec = {"runs": runs, "launches": launches, "calls": {k: len(v) for k, v in calls.items()},
           "vs_plain": held_against_plain(calls, "profile")}
    if any(rec["calls"][k] != launches[k] for k in launches):
        fail(f"profile: recorded calls {rec['calls']} != launches {launches}")
    if runs["patch"]["launches"]["stem_pool"] < PROFILE_STEPS + 1 or \
            runs["patch"]["launches"]["knn_cosine_scores"] < PROFILE_STEPS + 1:
        fail(f"profile --what patch launches {runs['patch']['launches']}")
    return rec


def drive_parity(work: Path) -> dict:
    """Phase 11c: ``cli parity`` at its defaults (the synthetic trio,
    256², batch 96, bf16, ResNet-18, 5 + 15 epochs, both modes, patch
    32/stride 8, seed 0) under PyTorch's default TF32 flags; launch counts
    reset just before and read just after, every kernel call recorded and
    held against its plain version; train and evaluate seconds per mode;
    the accuracy beside the JAX package's on the same trio, held to
    floors only a broken pipeline misses."""
    import torch

    from ssad_tpu_torch import parity
    from ssad_tpu_torch.evaluation import evaluator

    seconds = {"image": {"train_s": 0.0, "evaluate_s": 0.0},
               "patch": {"train_s": 0.0, "evaluate_s": 0.0}}
    train, evaluate = parity._train_subject, evaluator.evaluate_categories

    def timed(fn, key, mode_of):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[mode_of(args)][key] += time.perf_counter() - t0
            return out
        return wrapper

    parity._train_subject = timed(
        train, "train_s", lambda a: "patch" if a[0].data.patch_localization else "image")
    evaluator.evaluate_categories = timed(
        evaluate, "evaluate_s", lambda a: "patch" if a[3].patch_localization else "image")
    out = work / "parity"
    try:
        # ---- the parity path: counts to 0 just before, read just after ------
        _zero_launches()
        with recording_every_kernel() as calls, torch_default_tf32():
            _, wall = _run_cli(["parity", "--outputs-dir", str(out)])
            launches = _eval_launches()
        # ---- end of the parity path ------------------------------------------
    finally:
        parity._train_subject, evaluator.evaluate_categories = train, evaluate
    summary = json.loads((out / "parity_summary.json").read_text())
    rows = {s: {**summary["image"]["per_subject"][s], **summary["patch"]["per_subject"][s]}
            for s in parity.SYNTHETIC_SUBJECTS}
    mean = {k: v for mode in ("image", "patch") for k, v in summary[mode].items()
            if k not in ("reference", "per_subject")}
    rec = {
        "subjects": rows, "mean": mean,
        "jax_trio": {"source": JAX_TRIO_SOURCE, "subjects": JAX_TRIO, "mean": JAX_TRIO_MEAN},
        "gap_to_jax": {s: {k: rows[s][k] - JAX_TRIO[s][k] for k in rows[s]} for s in rows},
        "mean_gap_to_jax": {k: mean[k] - JAX_TRIO_MEAN[k] for k in mean},
        "seconds": seconds, "wall_s": wall,
        "floors": {"image_auroc": PARITY_IMAGE_AUROC_FLOOR,
                   "pixel_auroc": PARITY_PIXEL_AUROC_FLOOR},
        "tables": sorted(str(p.relative_to(out)) for p in out.glob("*_level/tables/*/*")),
        "launches": launches, "calls": {k: len(v) for k, v in calls.items()},
        "vs_plain": held_against_plain(calls, "parity"),
    }
    print(f"parity: {json.dumps(rec)} ({card_line()})", flush=True)
    if any(rec["calls"][k] != launches[k] for k in launches):
        fail(f"parity: recorded calls {rec['calls']} != launches {launches}")
    if not len(rec["tables"]) >= 2 * 3 * 3:  # {image,patch} × {all,textures,objects} × 3 formats
        fail(f"parity: tables {rec['tables']}")
    if not all(v > 0 for mode in seconds.values() for v in mode.values()):
        fail(f"parity: a timed stage never ran through its wrapper: {seconds}")
    if not (mean["image_auroc"] >= PARITY_IMAGE_AUROC_FLOOR
            and mean["pixel_auroc"] >= PARITY_PIXEL_AUROC_FLOOR):
        fail(f"parity: mean image AUROC {mean['image_auroc']} (floor "
             f"{PARITY_IMAGE_AUROC_FLOOR}), pixel AUROC {mean['pixel_auroc']} (floor "
             f"{PARITY_PIXEL_AUROC_FLOOR})")
    return rec


def drive_harness(work: Path) -> dict:
    """Phase 11: ``cli doctor``, ``cli profile``, ``cli parity``."""
    return {"doctor": drive_doctor(), "profile": drive_profile(work),
            "parity": drive_parity(work)}


# ---- phase 12: multi-device on one card -------------------------------------


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block, so two runs of
    one step can be held bit for bit."""
    import torch

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def _step_rec(trainer, state, metrics) -> dict:
    """A step's record in tests/_torch_step_parity.py's form (the bank twice: no
    given-mask insert here)."""
    def host(t):
        return t.detach().cpu().double()

    bank = [host(t) for t in state.bank]
    return {"loss": host(metrics["loss"]), "logits": host(metrics["logits"]),
            "state": {k: host(v) for k, v in trainer.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "grads": {n: host(p.grad) for n, p in trainer.model.named_parameters()},
            "bank": bank, "given": bank}


def _held(name: str, got: dict, want: dict) -> dict:
    """_torch_step_parity's deltas of two step records, held to TREE_256_LIMITS."""
    import _torch_step_parity as sp

    d = sp.step_deltas(got, want)
    d["bit_equal"] = all(v == 0.0 for v in d.values())
    bad = sp.beyond(d, sp.TREE_256_LIMITS)
    if bad:
        fail(f"{name}: beyond TREE_256_LIMITS in {bad}: {d}")
    return d


def _median_ms(fn, n: int = MULTI_TIMED) -> float:
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def drive_train_multi(device, work: Path) -> dict:
    """Phase 12a: ``cli train-multi --stack 2`` over bottle and cable at
    full width (cut to 1 + 1 epochs), each checkpoint loaded and each
    history read; the first stacked step of each category against the
    single-category ``Trainer.train_step`` on the same draws and stacked
    data; ms per stacked step against the two single steps (T5's shape:
    256², batch 96, bf16, the fine-tune step with the fill)."""
    import copy

    import torch

    from ssad_tpu_torch.config import DataConfig, TrainConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.parallel import category_parallel as cp
    from ssad_tpu_torch.train.trainer import Trainer

    root, out = work / "synth_mvtec", work / "multi_out"
    lines, wall = _run_cli(["train-multi", "--dataset-dir", str(root), "--subjects",
                            ",".join(MULTI_SUBJECTS), "--stack", "2", "--outputs-dir", str(out),
                            "--imsize", str(IMSIZE), "--batch-size", str(TRAIN_BATCH),
                            "--projection-epochs", "1", "--fine-tune-epochs", "1",
                            "--min-dataset-length", str(MULTI_MIN_LEN), "--quiet"])
    rec = {"wall_s": wall, "stdout": lines, "checkpoints": {}}
    x = torch.rand(2, IMSIZE, IMSIZE, 3, generator=torch.Generator().manual_seed(0))
    for s in MULTI_SUBJECTS:
        hist = json.loads((out / s / "history.json").read_text())
        engine, bank, _ = inf.load_engine(out / s / "best_model.ckpt", device)
        logits, emb = engine.predict_batch(x.to(device))
        rec["checkpoints"][s] = {
            "epochs": {k: len(v) for k, v in hist.items() if k.endswith("val_loss")},
            "bank_rows": int(bank.count) if bank is not None else 0,
            "finite": bool(torch.isfinite(emb).all() and torch.isfinite(logits).all())}
        if rec["checkpoints"][s]["epochs"] != {"projection_val_loss": 1,
                                               "fine_tune_val_loss": 1} or \
                not rec["checkpoints"][s]["finite"]:
            fail(f"train-multi {s}: {rec['checkpoints'][s]}")

    cfg = TrainConfig(data=DataConfig(imsize=(IMSIZE, IMSIZE), batch_size=TRAIN_BATCH,
                                      min_dataset_length=MULTI_MIN_LEN))
    datas = [mvtec.prepare_pretext_data(root, s, imsize=cfg.data.imsize,
                                        val_fraction=cfg.data.train_val_split, seed=0)
             for s in MULTI_SUBJECTS]
    chunk = cp._chunk_data(datas)
    trainers, states, gens, singles = [], [], [], []
    for p, data in enumerate(chunk):
        sub = TrainConfig(data=DataConfig(subject=MULTI_SUBJECTS[p], imsize=cfg.data.imsize,
                                          batch_size=TRAIN_BATCH,
                                          min_dataset_length=MULTI_MIN_LEN))
        t = Trainer(sub, data, device)
        if p:
            t.spec = trainers[0].spec
        trainers.append(t)
        states.append(t.init_state("fine_tune", generator=cp.category_generator(0, 0, p)))
        gens.append(cp.category_generator(0, 2, p))
        singles.append(copy.deepcopy((t, states[-1], gens[-1])))
    dds = [t.device_data("train") for t in trainers]
    with cudnn_deterministic():
        states, metrics = cp.stacked_step(trainers, states, gens, dds, True)
        stacked = [_step_rec(t, s, m) for t, s, m in zip(trainers, states, metrics)]
        rec["first_step_vs_single"] = {}
        for p, (t, st, g) in enumerate(singles):
            dd = t.device_data("train")
            st, m = t.train_step(st, t.upload_draws(g, dd), dd, True)
            rec["first_step_vs_single"][MULTI_SUBJECTS[p]] = _held(
                f"stacked step of {MULTI_SUBJECTS[p]} vs its single step", stacked[p],
                _step_rec(t, st, m))
    del singles
    box = {"states": states}

    def stacked_step():
        box["states"], _ = cp.stacked_step(trainers, box["states"], gens, dds, True)

    def single(p):
        def run():
            box["states"][p], _ = trainers[p].train_step(
                box["states"][p], trainers[p].upload_draws(gens[p], dds[p]), dds[p], True)
        return run

    for _ in range(2):  # warm
        stacked_step()
    rec["stacked_step_ms"] = _median_ms(stacked_step)
    rec["single_step_ms"] = [_median_ms(single(p)) for p in range(len(trainers))]
    rec["stacked_over_singles"] = rec["stacked_step_ms"] / sum(rec["single_step_ms"])
    return rec


def drive_data_shards_1(device, work: Path) -> dict:
    """Phase 12b: the data-parallel step on NCCL at world size 1 against
    the plain trainer's (same init, same draws, 3 fine-tune steps, the
    last with the fill): every all-reduce is an identity, so within
    TREE_256_LIMITS and bit-equal where cuDNN is deterministic; then ``cli
    train --data-shards 1`` through its rank."""
    import torch

    from ssad_tpu_torch.config import DataConfig, TrainConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.train.trainer import DataGroup, Trainer, stage_generator
    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    root = work / "synth_mvtec"
    cfg = TrainConfig(data=DataConfig(subject="bottle", imsize=(IMSIZE, IMSIZE),
                                      batch_size=TRAIN_BATCH, min_dataset_length=MULTI_MIN_LEN))
    data = mvtec.prepare_pretext_data(root, "bottle", imsize=cfg.data.imsize,
                                      val_fraction=cfg.data.train_val_split, seed=0)

    def steps(group):
        t = Trainer(cfg, data, device, group)
        st, gen, dd = t.init_state("fine_tune", seed=0), stage_generator(0, 2), None
        dd = t.device_data("train")
        for i in range(3):
            st, m = t.train_step(st, t.upload_draws(gen, dd), dd, i == 2)
        return _step_rec(t, st, m)

    t0 = time.perf_counter()
    with cudnn_deterministic():
        plain = steps(None)
        with dist_mod.process_group(f"127.0.0.1:{dist_mod.free_port()}", 1, 0, device):
            backend = torch.distributed.get_backend()
            dp = steps(DataGroup(None, 0, 1))
    rec = {"backend": backend, "vs_plain": _held("data-shards 1 vs the plain trainer", dp, plain),
           "bank_rows": int(plain["bank"][2]), "steps_s": time.perf_counter() - t0}
    if backend != "nccl":
        fail(f"data-shards 1 on the card ran on {backend}")
    lines, wall = _run_cli(["train", "--dataset-dir", str(root), "--subject", "bottle",
                            "--outputs-dir", str(work / "dp_out"), "--imsize", str(IMSIZE),
                            "--batch-size", str(TRAIN_BATCH), "--projection-epochs", "1",
                            "--fine-tune-epochs", "1", "--min-dataset-length", str(TRAIN_BATCH),
                            "--data-shards", "1", "--quiet"])
    _, _, _, tcfg = load_checkpoint(work / "dp_out" / "bottle" / "best_model.ckpt")
    rec.update(cli_wall_s=wall, cli_stdout=lines, mesh=[tcfg.mesh.model_axis, tcfg.mesh.data_axis])
    if rec["mesh"] != [1, 1]:
        fail(f"train --data-shards 1 saved mesh {rec['mesh']}")
    return rec


def drive_sharded_eval(device, work: Path) -> dict:
    """Phase 12c and 12d: ``maybe_shard_engine(engine, 2, [cuda:0, cuda:0])``
    on phase 6's checkpoint (in f32) and phase 7's test split (image level: the forward and
    the k-NN fit and scores; patch level: sharded normality, and every
    8-image batch's maps, the stem and the tiled k-NN on each shard; the
    resident kernel on each shard against a seeded 1,000-row bank; maps
    and scores within 1e-5, embeddings and logits within F32_MODEL_TOL
    of 1 + |ref|), then
    ``evaluate_categories(category_shards=2, devices=[cuda:0, cuda:0])``
    over 12a's checkpoints, against the unsharded engine and the
    sequential sweep.  The unsharded references run before the window;
    launch counts are reset just before the sharded runs and read just
    after, every kernel call recorded and held against its plain version."""
    import torch

    from ssad_tpu_torch.config import EvalConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.evaluation.evaluator import evaluate_categories
    from ssad_tpu_torch.models.detector import make_detector
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.parallel.infer_parallel import maybe_shard_engine
    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    root, models, multi = work / "synth_mvtec", work / "train_out", work / "multi_out"
    write_eval_split(root / "cable", seed=6, split=MULTI_CABLE_SPLIT)
    home = (torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda"
            else device)
    shard_devs = [home, home]
    # phase 6's weights in f32 (TF32 off): a half batch may take other cuDNN
    # algorithms than the whole one, and in bf16 a changed f32 sum moves
    # whole bf16 steps; the function held here is the split, not the dtype
    state_dict, bank, mcfg, _ = load_checkpoint(models / "bottle" / "best_model.ckpt")
    model = build_model(dataclasses.replace(mcfg, compute_dtype="float32"))
    model.load_state_dict(state_dict, strict=True)
    engine = inf.InferenceEngine(model, device)
    sharded = maybe_shard_engine(engine, 2, devices=shard_devs)
    imsize = (IMSIZE, IMSIZE)
    test = mvtec.prepare_mvtec_test_data(root, "bottle", imsize=imsize)
    data = mvtec.prepare_pretext_data(root, "bottle", imsize=imsize, seed=0)
    batches = [im.normalize_imagenet(torch.from_numpy(test.images[lo:lo + BATCH]).to(device))
               for lo in range(0, test.images.shape[0], BATCH)]
    resident_bank = torch.from_numpy(np.random.default_rng(7).normal(
        size=(BANK_ROWS, 512)).astype(np.float32)).to(device)

    def image_level(e):
        out = inf.predict_mvtec(e, test, batch_size=32)
        normality = inf.normality_embeddings(e, bank, data.train_images)
        out, det = inf.attach_anomaly_scores(out, normality, seed=0)
        return out.embeddings, out.raw_predictions, out.anomaly_maps

    def patch_normality(e):
        return inf.normality_embeddings(e, None, data.train_images, batch_size=4,
                                        patch_localization=True, min_bank_rows=10**9,
                                        max_images=3, seed=0)

    eval_cfg = dict(patch_localization=True, imsize=imsize, batch_size=32, seed=0)
    # ---- the references: the unsharded engine and the sequential sweep -----
    ref_image = image_level(engine)
    ref_normality = patch_normality(engine)
    det = make_detector("knn", k=3).fit(ref_normality, torch.Generator().manual_seed(0))
    ref_maps = torch.cat([engine.score_maps(x, det.score, upsample_to=IMSIZE) for x in batches])
    ref_resident = engine.score_patch_maps(batches[0], resident_bank, k=3, upsample_to=IMSIZE)
    seq = evaluate_categories(root, multi, MULTI_SUBJECTS, EvalConfig(**eval_cfg),
                              str(work / "multi_eval_seq"), device=device)
    torch.cuda.synchronize()
    # ---- the multi-device path: counts to 0 just before, read just after ----
    _zero_launches()
    t0 = time.perf_counter()
    with recording_every_kernel() as calls:
        got_image = image_level(sharded)
        t_image = time.perf_counter()
        got_normality = patch_normality(sharded)
        got_maps = torch.cat([sharded.score_maps(x, det.score, upsample_to=IMSIZE)
                              for x in batches])
        got_resident = sharded.score_patch_maps(batches[0], resident_bank, k=3,
                                                upsample_to=IMSIZE)
        torch.cuda.synchronize()
        t_patch = time.perf_counter()
        par = evaluate_categories(root, multi, MULTI_SUBJECTS,
                                  EvalConfig(**eval_cfg, category_shards=2),
                                  str(work / "multi_eval_par"), device=device,
                                  devices=shard_devs)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = _eval_launches()
    # ---- end of the multi-device path ---------------------------------------
    errs = {"image_embeddings": ref_image[0], "image_logits": ref_image[1],
            "image_scores": ref_image[2], "patch_normality": ref_normality,
            "patch_maps": ref_maps, "resident_maps": ref_resident}
    gots = {"image_embeddings": got_image[0], "image_logits": got_image[1],
            "image_scores": got_image[2], "patch_normality": got_normality,
            "patch_maps": got_maps, "resident_maps": got_resident}
    rec = {"sharded_vs_unsharded": {k: float((gots[k] - v).abs().max())
                                    for k, v in errs.items()},
           # embeddings and logits as JAX's test holds them: 1e-5 + 1e-5·|ref|
           "sharded_vs_unsharded_rel": {k: float(((gots[k] - v).abs() / (1 + v.abs())).max())
                                        for k, v in errs.items()},
           "image_s": t_image - t0, "patch_s": t_patch - t_image,
           "category_shards_s": t_end - t_patch, "launches": launches,
           "calls": {k: len(v) for k, v in calls.items()},
           "vs_plain": held_against_plain(calls, "multi-device")}
    for k, v in rec["sharded_vs_unsharded"].items():
        # the maps and scores within 1e-5; the embeddings and logits, whose
        # half batches may take other cuDNN algorithms, at the f32 model's
        # limit on the card, relative to 1 + |ref|
        limit = MULTI_TOL
        if k in ("image_embeddings", "image_logits", "patch_normality"):
            v, limit = rec["sharded_vs_unsharded_rel"][k], F32_MODEL_TOL
        if not v <= limit or gots[k].shape != errs[k].shape:
            fail(f"sharded {k} vs unsharded: {v} (limit {limit}), shapes "
                 f"{tuple(gots[k].shape)} / {tuple(errs[k].shape)}")
    # every kernel on each shard: the patch batches split in two halves
    per_shard = [c[0].shape[0] for c in calls["knn_cosine_scores_tiled"]]
    halves = [(x.shape[0] + 1) // 2 * WINDOWS for x in batches]
    rec["tiled_queries_per_call"] = per_shard
    if sorted(per_shard[:2 * len(batches)]) != sorted(h for h in halves for _ in (0, 1)):
        fail(f"the tiled k-NN did not run on each shard: {per_shard[:2 * len(batches)]}")
    if sum(1 for c in calls["knn_cosine_scores"] if c[0].shape[0] == BATCH // 2 * WINDOWS) != 2:
        fail("the resident k-NN did not run on each shard of the resident-bank batch")
    if launches["stem_pool"] < 2 * (len(batches) + 1):
        fail(f"stem kernel launches {launches['stem_pool']} < 2 shards × "
             f"{len(batches) + 1} batches")
    if any(rec["calls"][k] != launches[k] for k in launches):
        fail(f"multi-device: recorded calls {rec['calls']} != launches {launches}")
    rec["category_shards_vs_sequential"] = {
        s: {k: abs(getattr(par[s], k) - getattr(seq[s], k))
            for k in ("pixel_auroc", "iou", "aupro")} for s in MULTI_SUBJECTS}
    rec["category_metrics"] = {s: {k: getattr(par[s], k) for k in ("pixel_auroc", "iou", "aupro")}
                               for s in MULTI_SUBJECTS}
    for s, d in rec["category_shards_vs_sequential"].items():
        if not all(v <= 1e-6 for v in d.values()):
            fail(f"evaluate --category-shards 2 {s} vs the sequential sweep: {d}")
    return rec


def drive_multi_device(device, work: Path) -> dict:
    """Phase 12: train-multi, data-parallel training at world size 1 on
    NCCL, sharded evaluation and category shards, on the one card."""
    out = {}
    for name, fn in (("train_multi", drive_train_multi), ("data_shards_1", drive_data_shards_1),
                     ("sharded_eval", drive_sharded_eval)):
        t0 = time.perf_counter()
        out[name] = fn(device, work)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"multi {name}: {json.dumps(out[name])} ({card_line()})", flush=True)
    return out


# ---- phase 13: the two composed runs -----------------------------------------


def _corr(a, b) -> float:
    return float(np.corrcoef(a.float().numpy().ravel(), b.float().numpy().ravel())[0, 1])


def drive_readiness(work: Path) -> dict:
    """Phase 13a: ``cli train --dataset-dir --pretrained-backbone`` at full
    width (ResNet-18, 256², batch 96, bf16) on phase 5's bottle tree with a
    seeded torchvision-layout file, cut to 1 + 3 epochs of one step, then
    ``cli evaluate`` at image level on phase 7's test split; launch counts
    reset just before and read just after, every kernel call recorded and
    held against its plain version.  The checkpoint's conv1 and one of its
    backbone running means must correlate above READINESS_CORR with the
    file's conv1 and bn1.running_mean."""
    import torch

    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint
    from ssad_tpu_torch.utils.torch_weights import convert_resnet_state_dict

    root, models, out = work / "synth_mvtec", work / "readiness_models", work / "readiness_eval"
    pth = work / "resnet18_seeded.pth"
    torch.save(torchvision_state_dict(seed=11), pth)
    want = convert_resnet_state_dict(torch.load(pth, weights_only=True))
    # ---- the readiness path: counts to 0 just before, read just after -------
    _zero_launches()
    with recording_every_kernel() as calls:
        _, train_s = _run_cli(["train", "--dataset-dir", str(root), "--subject", "bottle",
                               "--imsize", str(IMSIZE), "--batch-size", str(TRAIN_BATCH),
                               "--min-dataset-length", str(TRAIN_BATCH),
                               "--projection-epochs", "1", "--fine-tune-epochs", "3",
                               "--pretrained-backbone", str(pth), "--outputs-dir", str(models),
                               "--quiet"])
        lines, eval_s = _run_cli(["evaluate", "--dataset-dir", str(root), "--models-dir",
                                  str(models), "--subjects", "bottle", "--imsize", str(IMSIZE),
                                  "--seed", "0", "--outputs-dir", str(out)])
        launches = _eval_launches()
    # ---- end of the readiness path -------------------------------------------
    state, _, _, cfg = load_checkpoint(models / "bottle" / "best_model.ckpt")
    mean = want["bn1.running_mean"]
    table = out / "tables" / "markdown" / "image_all_scores.md"
    rec = {"train_s": train_s, "evaluate_s": eval_s, "stdout": lines[-1:],
           "conv1_corr": _corr(state["feature_extractor.conv1.weight"], want["conv1.weight"]),
           "bn1_running_mean_corr": max(
               _corr(v, mean) for k, v in state.items()
               if k.startswith("feature_extractor.") and k.endswith("running_mean")
               and v.shape == mean.shape),
           "launches": launches, "calls": {k: len(v) for k, v in calls.items()},
           "vs_plain": held_against_plain(calls, "readiness")}
    print(f"readiness: {json.dumps(rec)} ({card_line()})", flush=True)
    if cfg.model.pretrained_backbone != str(pth) or cfg.model.compute_dtype != "bfloat16":
        fail(f"readiness: the checkpoint's ModelConfig {cfg.model}")
    if not (rec["conv1_corr"] > READINESS_CORR and rec["bn1_running_mean_corr"] > READINESS_CORR):
        fail(f"readiness: the file's weights did not reach the checkpoint: {rec}")
    if not lines[-1].startswith("bottle: image_auroc=") or "bottle" not in table.read_text():
        fail(f"readiness: evaluate printed {lines[-1:]}; table {table}")
    if launches["knn_cosine_scores"] < 1 or rec["calls"] != launches:
        fail(f"readiness: launches {launches}, recorded calls {rec['calls']}")
    return rec


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def drive_multi15(work: Path) -> dict:
    """Phase 13b: ``cli train-multi --subjects all --stack 8 --resume-dir``
    in a second process on cuda:0 over the parity generator's 15 categories
    at 64² (8 train-good, 1 good and 1 defect test image each; batch 96, 1 +
    4 epochs of one step): SIGTERM at the first group snapshot → exit 75, a
    resume hint, no checkpoint of any subject; the same command → exit 0,
    the texture and fixed chunks with their padding lines, 15 checkpoints
    with 1 + 4 epochs of history.  Then ``cli evaluate --subjects all`` at
    image level in this process on them; launch counts reset just before
    and read just after, every kernel call recorded and held against its
    plain version."""
    from ssad_tpu_torch import constants
    from ssad_tpu_torch.parity import generate_parity_dataset

    subjects = list(constants.ALL_CATEGORIES)
    tree = generate_parity_dataset(work / "mvtec15", subjects, imsize=MULTI15_IMSIZE,
                                   n_train=MULTI15_TRAIN, n_test_good=1, n_test_defect=1)
    out, resume = work / "multi15_out", work / "multi15_resume"
    cmd = [sys.executable, "-m", "ssad_tpu_torch.cli", "train-multi", "--dataset-dir", str(tree),
           "--outputs-dir", str(out), "--subjects", "all", "--imsize", str(MULTI15_IMSIZE),
           "--batch-size", str(MULTI15_BATCH), "--min-dataset-length", str(MULTI15_BATCH),
           "--projection-epochs", "1", "--fine-tune-epochs", "4", "--stack", "8",
           "--resume-dir", str(resume)]
    rec = {}
    log1 = work / "multi15_run1.log"
    t0 = time.perf_counter()
    with open(log1, "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 300
            while not list(resume.glob("multi_*/resume_snapshot.pt")):
                if proc.poll() is not None or time.time() > deadline:
                    fail(f"multi15: no group snapshot (rc {proc.poll()}):\n"
                         f"{log1.read_text()[-3000:]}")
                time.sleep(0.05)
            rec["snapshot"] = [p.parent.name for p in resume.glob("multi_*/resume_snapshot.pt")]
            rec["sigterm_at_s"] = time.perf_counter() - t0
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    run1 = log1.read_text()
    rec["run1_s"], rec["run1_rc"] = time.perf_counter() - t0, proc.returncode
    hint = _last_json(run1)
    partial = [s for s in subjects if list((out / s).glob("best_model*"))]
    if proc.returncode != 75 or not hint or hint.get("resume_dir") != str(resume) or partial:
        fail(f"multi15 drain: rc {proc.returncode}, hint {hint}, partial {partial}:\n"
             f"{run1[-3000:]}")
    log2 = work / "multi15_run2.log"
    t0 = time.perf_counter()
    with open(log2, "w") as log:
        done = subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, timeout=300)
    run2 = log2.read_text()
    rec["run2_s"], rec["run2_rc"] = time.perf_counter() - t0, done.returncode
    both = run1 + run2
    textures = "+".join(s for s in subjects if constants.is_texture(s))
    fixed = "+".join(s for s in subjects if not constants.is_texture(s)
                     and not constants.is_non_fixed_object(s))
    rec["chunks"] = [textures, fixed]
    rec["epochs"] = {}
    for s in subjects:
        hist_path = out / s / "history.json"
        hist = json.loads(hist_path.read_text()) if hist_path.is_file() else {}
        rec["epochs"][s] = [len(hist.get("projection_train_loss", [])),
                            len(hist.get("fine_tune_val_loss", []))]
    missing = [s for s in subjects if not (out / s / "best_model.ckpt").is_file()
               or rec["epochs"][s] != [1, 4]]
    if done.returncode != 0 or missing or textures not in both or fixed not in both \
            or "padding 5-category chunk to stack=8 with duplicates (3/8" not in both \
            or "padding 7-category chunk to stack=8 with duplicates (1/8" not in both:
        fail(f"multi15 resume: rc {done.returncode}, missing or short {missing}:\n{run2[-3000:]}")
    # ---- the 15-category evaluation: counts to 0 just before, read just after
    _zero_launches()
    with recording_every_kernel() as calls:
        lines, eval_s = _run_cli(["evaluate", "--dataset-dir", str(tree), "--models-dir",
                                  str(out), "--subjects", "all", "--imsize",
                                  str(MULTI15_IMSIZE), "--seed", "0", "--outputs-dir",
                                  str(work / "multi15_eval")])
        launches = _eval_launches()
    # ---- end of the 15-category evaluation ------------------------------------
    scored = [s for s in subjects if any(ln.startswith(f"{s}: image_auroc=") for ln in lines)]
    rec.update(evaluate_s=eval_s, scored=len(scored), launches=launches,
               calls={k: len(v) for k, v in calls.items()},
               vs_plain=held_against_plain(calls, "multi15"))
    print(f"multi15: {json.dumps(rec)} ({card_line()})", flush=True)
    if len(scored) != len(subjects) or launches["knn_cosine_scores"] < 1 \
            or rec["calls"] != launches:
        fail(f"multi15 evaluate: scored {scored}, launches {launches}, calls {rec['calls']}")
    return rec


def drive_composed(work: Path) -> dict:
    """Phase 13: the readiness run (13a), then the 15-category drain and
    resume (13b)."""
    out = {}
    for name, fn in (("readiness", drive_readiness), ("multi15", drive_multi15)):
        t0 = time.perf_counter()
        out[name] = fn(work)
        out[name]["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import ssad_tpu_torch
        from ssad_tpu_torch.ops import _cuda
        from ssad_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the port is not beside this script ({e}); run it from the repository root")
    if Path(ssad_tpu_torch.__file__).resolve().parent != ROOT / "ssad_tpu_torch":
        fail(f"ssad_tpu_torch was imported from {ssad_tpu_torch.__file__}, not {ROOT}")

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _cuda.build(["knn", "knn_tiled", "stem_pool", "bn_act"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _cuda.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    if "--bf16" in sys.argv[1:]:
        work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
        try:
            drive_bf16_only(device, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(card_line(), flush=True)
        return 0
    check_jax_stream()
    records = check_knn_kernel(device)
    stem_records = check_stem_kernel(device)
    tiled_records = check_tiled_kernel(device)
    bn_records = check_bn_act_kernel(device)
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    try:
        launches, image_bn_act_launches = drive_serving_path(device, work)
        patch_launches, _ = drive_patch_path(device, work)
        drive_synthesis(device, work)
        train = drive_training(device, work)
        evaluation = drive_evaluation(device, work)
        scorers = drive_scorers(device, work)
        extras = drive_extras(device, work)
        t_native = time.perf_counter()
        native = drive_native_serving(device, work)
        print(f"phase 10: {time.perf_counter() - t_native:.1f} s", flush=True)
        t_harness = time.perf_counter()
        harness = drive_harness(work)
        print(f"phase 11: {time.perf_counter() - t_harness:.1f} s", flush=True)
        t_multi = time.perf_counter()
        multi = drive_multi_device(device, work)
        print(f"phase 12: {time.perf_counter() - t_multi:.1f} s", flush=True)
        t_composed = time.perf_counter()
        composed = drive_composed(work)
        print(f"phase 13: {time.perf_counter() - t_composed:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    serve = records["serve"]
    kernels = [{
        "name": "knn_cosine_scores", "route": "cuda",
        "source": "ssad_tpu_torch/csrc/knn.cu", "replaces": "ssad_tpu/ops/knn.py:42",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records.values()),
        "ms": serve["ms"], "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"], "library_ms": serve["library_ms"],
        "shape": serve["shape"], "k": serve["k"], "path": "image",
        "device_us": serve["device_us"], "fit_device_us": records["fit"]["device_us"],
        "fit_ms": records["fit"]["ms"], "fit_library_ms": records["fit"]["library_ms"],
        "train_path_launches": train["knn_launches"],
        "eval_path_launches": evaluation["launches"]["knn_cosine_scores"],
        "scorer_path_launches": scorers["coreset"]["launches"]["knn_cosine_scores"],
        "scorer_path_shape": scorers["coreset"]["knn_at_coreset"],
        "scorer_path_vs_plain": scorers["coreset"]["vs_plain_knn"],
        "readiness_path_launches": composed["readiness"]["launches"]["knn_cosine_scores"],
        "readiness_path_vs_plain": composed["readiness"]["vs_plain"]["knn_cosine_scores"],
        "multi15_path_launches": composed["multi15"]["launches"]["knn_cosine_scores"],
        "multi15_path_vs_plain": composed["multi15"]["vs_plain"]["knn_cosine_scores"],
    }]
    tserve, tfit = tiled_records["serve"], tiled_records["fit"]
    kernels.append({
        "name": "knn_cosine_scores_tiled", "route": "cuda",
        "source": "ssad_tpu_torch/csrc/knn_tiled.cu", "replaces": "ssad_tpu/ops/knn.py:165",
        "launches": patch_launches["knn_cosine_scores_tiled"],
        "max_abs_err": max(r["max_abs_err"] for r in tiled_records.values()),
        "ms": tserve["ms"], "plain_ms": tserve["plain_ms"], "bound_ms": tserve["bound_ms"],
        "bound_by": tserve["bound_by"], "library_ms": tserve["library_ms"],
        "shape": tserve["shape"], "k": tserve["k"], "path": "patch",
        "ms_bank_form": "TiledBank (split once, as served)",
        "device_us": tserve["device_us"], "ms_raw_bank": tserve["ms_raw_bank"],
        "resident_ctas_per_sm": tserve["resident_ctas_per_sm"],
        "fit_ms": tfit["ms"], "fit_device_us": tfit["device_us"], "fit_plain_ms": tfit["plain_ms"],
        "fit_library_ms": tfit["library_ms"], "fit_bound_ms": tfit["bound_ms"],
        "eval_path_launches": evaluation["launches"]["knn_cosine_scores_tiled"],
        "scorer_path_launches": scorers["wide"]["launches"]["knn_cosine_scores_tiled"],
        "scorer_path_shape": scorers["wide"]["tiled_at_coreset"],
        "scorer_path_vs_plain": scorers["wide"]["tiled_vs_plain_knn"],
    })
    sserve = stem_records[BATCH * WINDOWS]
    kernels.append({
        "name": "stem_pool", "route": "cuda",
        "source": "ssad_tpu_torch/csrc/stem_pool.cu", "replaces": "ssad_tpu/ops/stem_pool.py:284",
        "launches": patch_launches["stem_pool"],
        "max_abs_err": max(r["max_abs_err"] for r in stem_records.values()),
        "ms": sserve["ms"], "plain_ms": sserve["plain_ms"], "bound_ms": sserve["bound_ms"],
        "bound_by": sserve["bound_by"], "library_ms": sserve["library_ms"],
        "shape": sserve["shape"], "path": "patch", "device_us": sserve["device_us"],
        "resident_blocks_per_sm": sserve["resident_blocks_per_sm"],
        "tolerance": "rtol 2^-7, atol 1e-6; < 1e-3 of elements not bit-equal",
        "flipped_share": max(r["flipped_share"] for r in stem_records.values()),
        "eval_path_launches": evaluation["launches"]["stem_pool"],
        "scorer_path_launches": (scorers["wide"]["launches"]["stem_pool"]
                                 + scorers["coreset"]["launches"]["stem_pool"]
                                 + scorers["mahalanobis"]["stem_pool_launches"]),
    })
    kernels.append(bn_act_record(bn_records, patch_launches["bn_act"], image_bn_act_launches))
    kernels[-1].update(
        eval_path_launches=evaluation["launches"]["bn_act"],
        scorer_path_launches=(scorers["wide"]["launches"]["bn_act"]
                              + scorers["coreset"]["launches"]["bn_act"]),
        readiness_path_launches=composed["readiness"]["launches"]["bn_act"],
        readiness_path_vs_plain=composed["readiness"]["vs_plain"]["bn_act"],
        multi15_path_launches=composed["multi15"]["launches"]["bn_act"],
        multi15_path_vs_plain=composed["multi15"]["vs_plain"]["bn_act"])
    for rec in kernels:
        name = rec["name"]
        rec["localize_path_launches"] = extras["localize"]["launches"][name]
        rec["localize_path_vs_plain"] = extras["localize"]["vs_plain"][name]
        rec["serving_extras_path_launches"] = extras["serving"]["launches"][name]
        rec["serving_extras_path_vs_plain"] = extras["serving"]["vs_plain"][name]
        rec["native_serving_path_launches"] = native["launches"][name]
        rec["native_serving_path_vs_plain"] = native["vs_plain"][name]
        rec["parity_path_launches"] = harness["parity"]["launches"][name]
        rec["parity_path_vs_plain"] = harness["parity"]["vs_plain"][name]
        rec["parallel_path_launches"] = multi["sharded_eval"]["launches"][name]
        rec["parallel_path_vs_plain"] = multi["sharded_eval"]["vs_plain"][name]
        if name != "knn_cosine_scores_tiled":  # patch scoring on a 1,000-row bank: resident
            rec["profile_path_launches"] = harness["profile"]["launches"][name]
            rec["profile_path_vs_plain"] = harness["profile"]["vs_plain"][name]
        if (rec["launches"] < 1 or rec.get("train_path_launches", 1) < 1
                or rec["parity_path_launches"] < 1 or rec.get("profile_path_launches", 1) < 1
                or rec["eval_path_launches"] < 1 or rec["scorer_path_launches"] < 1
                or rec["serving_extras_path_launches"] < 1
                or rec["native_serving_path_launches"] < 1
                or rec["parallel_path_launches"] < 1
                or rec.get("readiness_path_launches", 1) < 1
                or rec.get("multi15_path_launches", 1) < 1
                or (name != "knn_cosine_scores" and rec["localize_path_launches"] < 1)):
            fail(f"{rec['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
