#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (topaz_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before a result is printed:

1. Require a CUDA device; print the card's name and power limit.
2. Build every CUDA kernel of the port from csrc/ (nvcc, sm_90a, one
   process a source, all started together): disk_max.cu, gmm_em.cu and
   unet_edges.cu.
3. Hold each kernel against its plain PyTorch version on the card. The
   disk max bit-equal (random f32 and int32 maps and the maps the NMS
   rounds feed it, a score map ~90% -inf, an index map with INT32_MIN off
   the candidates and a 0/1 peak map; (512, 512) and (3, 300, 200) at r =
   0, 1, 3, 7, 14, 31, 32, 33, 60, 85, 86 (the last radius of the window
   kernel at these widths and the first of the row kernel), 96, 97, 100,
   150, and (1, 4096, 4096) at r = 0, 3, 14, 33, 85, 86, 100, 150; the
   pipeline's batched shapes (8, 512, 512) and (8, 768, 512) at r = 3 and
   14; r >= H or W at (3, 40, 50) r = 60, (70, 33) r = 100, (40, 50) r =
   120; the odd (5, 257, 129) at r = 1, 14, 33, 150), and time kernel and
   plain version at the main paths' shapes, (512, 512) and (8, 768, 512)
   at r = 14, and at (512, 512) over r = 5, 14, 30, 50, 75, 96, 100 (the
   ``by_radius`` sweep), with CUDA events (device time from a CUDA graph
   of many calls, and the eager time a call), beside the least time the
   card could take. The GMM's EM (``check_gmm_em``): the kernel against
   the plain version with float64 sums (its twin: the same float32 terms,
   summed as the kernel sums them) on one image and a batch of 8 at N =
   4096 and 262144 pixels, unweighted, with 0/1 weights (padding) and with
   histogram counts, a fit cut at num_iters = 3 and a padded batch with a
   dead frame; mu, std, pi and logp within ``GMM_EM_RTOL`` and every lane
   at the twin's step (one apart only at a float32 tie of logp - logp_cur
   with tol), each case's steps, the kernel's, the twin's and the plain
   version's ms (CUDA events) and the bound printed, and the plain version
   as the CPU path runs it (float32 sums) beside them; then ``gmm_fit``
   under ``torch.cuda.set_sync_debug_mode("error")``: one launch, no host
   sync; then 8 x 768 x 512 with 0/1 weights, one 4096^2 micrograph fit
   whole (the recompute route) and one image each side of the largest N
   whose slices a cluster of 16 keeps whole in shared memory (resident at
   it, recompute above). Every row has the kernel's plan: its cluster size,
   route, pixels a block kept and dynamic shared memory. The U-Net's edge
   kernels (``check_unet_edges``): bias and leaky ReLU, then the pool or
   the upsample into the concat, bit-equal to their plain compositions on
   2D and 3D maps, N 1 and 8, odd extents, skips of 0, 1 and 48 channels,
   inputs with +-0, +-inf and NaN; each timed (CUDA events) beside PyTorch's
   ops and its bytes bound at a 4096^2 image's and a 192^3 window's top
   level.
4. Drive the main path through the CLI a user calls: a 4096^2 synthetic
   micrograph through ``preprocess -s 8`` and
   ``extract -m resnet8_u32 -r 14 -t -6`` on the card (launch counts read
   from that run: one EM launch), then again warm, then on the CPU. Picks must be
   non-empty and identical between card and CPU (a differing pick only where
   the two scores that decided it lie within 1e-5), matched scores within
   1e-3 and the normalized micrographs within 1e-3 (f32 FFT, EM and
   convolution sum orders differ between cuFFT/cuDNN and the CPU).
5. Denoise the same 4096^2 micrograph through the CLI on the card with the
   bundled unet (``unet_L2_v0.2.1``, full width): whole image (``-s 0``)
   and in the CLI's default patches (``-s 1024 -p 500``), each cold then
   warm; every output has the input's shape, is finite and differs from
   the input. Time the U-Net forward at 4096^2 with CUDA events (the fused
   route, bit-equal to the modules' forward, which is timed beside it)
   beside its bound (convolution FLOPs from ``arch_layout`` over the f32 rate, TF32
   off) and its peak memory; for comparison only, also with
   ``cudnn.benchmark`` on, with TF32 and in bf16, none of which the port
   uses by default. Then hold card against CPU at ``--downsample 8 -s 0``
   (512^2 whole) and ``--downsample 4 -s 384 -p 128`` (1024^2 in interior
   and border patches): max abs diff within 1e-3 * std (cuDNN and the CPU
   sum float32 in other orders).
6. The batched micrograph pipeline (``MicrographPipeline``) on 24 synthetic
   MRCs from seed 0, 8 each of three camera geometries (4096 x 4096,
   5760 x 4092, 3838 x 3710) with planted particles: ``resnet8_u32``,
   ``unet`` denoise arm, ``scale=8``, ``radius=14``, ``threshold=-6``,
   ``batch_size=8``, host prep (``host_downsample``, 2 loader threads) cold
   and warm, then device prep. Prints micrographs a second, the programs'
   census (2 main buckets), the disk max's and the EM kernel's launches of
   the cold run (one EM launch a batch), picks a file and stage times a
   batch. Every file comes back with picks, scores non-increasing and a
   finite denoised image of the downsampled shape; device and host prep
   agree under the near-tie rule. One file a geometry: the pipeline against
   the port's per-image path on the card (downsample, ``normalize``, score,
   ``non_maximum_suppression``) under the near-tie rule; the pipeline on
   the card against the CPU at ``batch_size=2``, near-tie rule and denoised
   pixels within 1e-3 x std. Pipeline picks are held with scores and gaps
   within 1e-3 x max(1, |score|) (``PIPELINE_TOL``, below). The EM kernel
   against its twin on the pipeline's real inputs
   (``check_gmm_em_pipeline``): 8 micrographs of each main bucket as the
   pipeline loads them, the 512 x 512 bucket's 65536-bin histogram fit and
   one 4096^2 micrograph alone, all its pixels (``preprocess --sample 1``;
   the CLI's default fits a 1/10 sample); for each bucket
   the selected lane's mu and std of each image, card against CPU, beside
   the normalized micrograph's difference of phase 4. Then the
   batched CLI: ``normalize -s 8 --batch-size 8`` and
   ``extract -m resnet8_u32 -r 14 -t -6 --batch-size 8`` on the 24 files,
   three of them held against the ``--batch-size 1`` CLI (normalized pixels
   within 1e-3, picks under the near-tie rule).
7. Picker training: 16 synthetic 4096^2 micrographs (``make_ctf_micrograph``,
   ~60 particles each), normalized by ``normalize -s 8 --batch-size 8``; 12
   for training, 40 particles of each labeled, and 4 for testing, all
   labeled. ``train`` with the CLI defaults (resnet8, units 32, pretrained
   ``resnet8_u32``, GE-binomial, batch 256) at ``-n 60 -r 3 --num-epochs 2
   --epoch-size 100`` with the test split: epoch wall times, warm steps and
   crops a second, every row finite, test AUPRC above the pretrained
   picker's, the checkpoint loads; training launches no disk_max. Then
   ``extract -m <prefix>_epoch2.npz -r 14 -t -6`` on the test micrographs:
   picks on each, disk_max launches counted. A resumed warm epoch under
   torch.profiler gives the device's idle share; the sampler alone a batch,
   one train step alone (CUDA events) against its FLOP bound;
   ``--no-pretrained --bn on`` for 20 steps (running statistics move); and
   the default command at ``--epoch-size 5 --minibatch-size 64`` on the
   card and the CPU, five train rows within ``TRAIN_TOL``.
8. The radius search (``run_extract_targets``), on the training phase's 16
   normalized micrographs with every planted particle a target:
   ``extract -m resnet8_u32 -t -6 --targets`` with the CLI's grid (r = 5
   to 100 in steps of 5).
   One line a radius (AUPRC, RMSE, recall, wall and matching ms, greedy
   rounds, disk_max launches); it fails unless every radius ran and
   launched the kernel three times a round on maps that stayed on the card
   (no NMS call uploaded a map). Then ``-r <found>
   --only-validate`` (one line, the grid's AUPRC within 1e-3, no picks
   written); the kernel alone at (512, 512), r = 100; card against CPU on 4
   micrographs at r = 5, 15, 50, 100 (scores within ``PIPELINE_TOL`` x
   max(1, |score|), picks equal but at near-ties of that size, AUPRC within
   1e-3); ``--per-micrograph --suffix _topaz`` in the coord, star, box,
   json and csv formats on the card and the CPU, each file equal but its
   scores, held to ``PIPELINE_TOL``; ``--patch-size 128`` against
   whole-image scoring on the card (maps and picks to ``PIPELINE_TOL``).
9. The autoencoder regularizer (``run_train_ae``, phase ``train_ae``), on
   the training phase's micrographs: ``train --autoencoder 1 --ngf 32``
   from the bundled ``resnet8_u32`` (decoder of depth 3, width 63) for 2
   epochs of 50 steps with the test split: rows finite, the mean
   ``recon_error`` of the last 10 train rows below that of the first 10;
   one step alone against the picker's and the decoder's FLOP bound; five
   rows of the card against the CPU at ``--minibatch-size 64`` (the first
   two within ``TRAIN_TOL``, all within ``TRAIN_DRIFT_TOL``); ``extract -m
   <prefix>_epoch2.npz -r 14 -t -6`` on the 4 test micrographs (disk_max
   launches counted), and ``precision_recall_curve`` on those picks, whose
   AUPRC must equal ``extract --only-validate``'s within 1e-6.
10. Denoiser training and ``denoise3d`` (``run_denoise_train``,
   ``run_denoise3d``).
11. 3D picking (``run_extract3d``): a 3D resnet8 at units 32, its weights
   drawn from seed 0, saved as .npz; one 166^3 window's dilated
   convolutions timed direct and on the phase route, each (its kernels,
   the split and merge copies, the two outputs' difference); a 192 x 384 x
   384 tomogram of planted blobs scored in 32 tiles of 166^3 (wall and
   device time against the FLOP bound, peak memory; it must run
   convolutions on the phase route), ``extract.pick_volume`` at r = 8 (the CLI's
   and the benchmark's path; its picks equal the sphere-max NMS of the
   scored map, whose time its ``extract3d/nms`` span gives), then
   ``extract --dims 3 -r 8`` through the CLI (``z_coord`` column, picks
   against ``pick_volume``'s). Card against CPU on a 48 x 96 x 96 crop
   (one tile): scores within ``PIPELINE_TOL`` x max(1, |score|), picks
   equal but at near-ties, ``--targets --only-validate`` AUPRC within
   1e-3. The phase must launch no disk_max: the 3D path has no TPU kernel.
12. 3D picker training (``run_train3d``, phase ``train3d``): a 192 x 384 x
   384 tomogram of 400 blobs from seed 400, two thirds labeled, and a test
   tomogram from seed 401, all labeled; ``train --dims 3 --augment-3d
   --no-pretrained`` with the CLI's width (resnet8, units 32, GE-binomial,
   batch 256) for 2 epochs of ``TRAIN3D_EPOCH_SIZE`` steps with the test
   split: epoch walls, warm steps and crops a second, every row finite, the
   checkpoint loads; ``extract --dims 3 -r 8 --targets --only-validate``
   with it must beat the seed-0 random picker's AUPRC. The run is under
   torch.profiler, and epoch 2 gives the idle share; the sampler's draw, the
   windows cut on the card (held equal to the host gather) and the JAX
   package's host gather a batch; one step alone against its FLOP bound,
   with the peak memory and its largest operators; five rows of the card
   against the CPU without ``--augment-3d`` on a 48 x 96 x 96 crop at
   ``--minibatch-size 8``: the first two rows within ``TRAIN_TOL``, all
   within ``TRAIN_DRIFT_TOL``. No disk_max launch.
13. The coordinate tools, ``.sav`` models and ``segment`` (``run_tools``,
   phase ``tools``): four unbinned K3 micrographs of 4092 x 5760 in f32
   (seed 500, ~200 planted particles each) binned 4x by ``preprocess -s
   4``. ``resnet16_u32`` exported as ``.sav`` by the port
   (``export_picker_sav``; the load time printed), then ``extract -m
   that.sav`` and ``extract -m resnet16_u32`` on the card: identical
   picks, the .sav run's disk_max launches counted (``sav_extract``), the
   kernel bit-equal to its plain version on that path's score map.
   ``segment -m resnet16_u32`` (the bundled resnet16 at full width; the
   default alias's u64 weights are not in the repo) whole and ``-p 256``:
   ms a micrograph, the dense forward against its f32 bound, card maps
   against the CPU's on a 400^2 crop's interior (``PIPELINE_TOL`` x max(1,
   |score|)); without PIL on the machine the maps come from the library
   and the .tiff write is skipped. A 192 x 384 x 384 tomogram with a 3D
   resnet8 at units 32 (seed 0) through ``segment -p 48`` into .npy. The
   RELION handoff: ``convert -x 4 --to star --voltage 300
   --detector-pixel-size 5``, ``star_particles_threshold``, ``split``,
   ``coordinates_to_boxes`` then ``boxes_to_coordinates`` (the coordinates
   come back), and ``particle_stack --size 256 --metadata`` over the ~800
   best picks on the unbinned micrographs, without and with ``--resize 64``
   on the card and on the CPU (pixels within ``STACK_TOL``, STAR files
   equal); particles a second of each.
14. The services (``run_services``, phase ``services``): 12 synthetic MRCs
   (seed 600), 6 of 4096^2 and 6 of 5760 x 4092, with the CLI defaults
   (``resnet16_u32``, ``-s 8 -r 14 -t -6``, ``unet``). ``warmup
   --denoise-model unet --shapes 4096x4096,5760x4092 --batch-sizes 1,8``
   through the CLI (wall, programs, disk_max launches); a ``TopazService``
   behind ``make_server(port=0)`` in this process: ``/healthz`` names the
   card, the 12 files to ``/extract`` one at a time and in 3 rounds of 8
   concurrent requests (p50/p95 latency and requests a second; the largest
   batch must exceed 1; picks equal the direct pipeline's x 8 under the
   near-tie rule and ``PIPELINE_TOL``), ``/denoise`` of 4 then 8 concurrent
   4096^2 frames, each round one batch (the route it took, the peak
   memory; within 1e-3 x std of ``Denoise("unet").denoise(x,
   patch_size=0)``), ``/metrics`` against ``/healthz``; ``python -m
   topaz_tpu_torch serve --port 0`` in a subprocess (one ``/extract``, then
   SIGTERM: exit 0); ``watch DIR -o picks.txt --batch-size 8 --once
   --poll-interval 0.5`` on the 12, then on 4 new files (only they, one
   header, picks equal the pipeline's x 8; micrographs a second); last
   ``exact_non_maximum_suppression`` (the literal greedy order, no kernel)
   against ``non_maximum_suppression`` (the kernel's rounds) on the
   pipeline's 12 score maps: identical. Each of the three paths must launch
   the disk max.
15. ``-d -2`` and the sharded functions (``run_scaleout``, phase
   ``scaleout``): on one card ``-d -2`` is [cuda:0]. ``train -d -2``
   against ``-d 0`` for one epoch of 5 steps on the training phase's set
   (rows within ``TRAIN_TOL``, bit-equality printed); ``preprocess -s 8 -d
   -2`` (the batched normalization, as in the JAX CLI) within 1e-3 of
   ``--batch-size 2``, and ``extract -m resnet8_u32 -r 14 -t -6`` at ``-d
   0`` and ``-d -2`` on the slice's 4096^2 micrograph preprocessed at -d 0
   (identical picks, equal disk_max launches, those of -2 counted as
   ``scaleout``); ``denoise -m unet -s 0``
   at both (bit-identical). Over [cuda:0] x 2 and x 4: the halo dense
   scorer against whole-image scoring on the 512^2 normalized micrograph
   (within 1e-4, NMS picks through the kernel identical), the batched
   scorer on 8 x 512^2 (1e-5), the halo denoiser with ``affine`` (1e-5 x
   std) and ``unet`` at 4096^2 (root mean square within ``UNET_HALO_TOL``
   x std), with the ms of
   the halo routes beside the whole-image ones (the overhead of sharding
   on one device, not a speed-up). The entry points over the card
   repeated: ``MicrographPipeline`` over a 2 x 2 (data x space) mesh on
   4 of the pipeline's 4096^2 micrographs (halo scoring in the batch, each
   data row's NMS through the kernel, its launches counted as
   ``scaleout_mesh_pipeline``) against one device (picks within
   ``PIPELINE_TOL``, denoised within 1e-3 x std), ``Denoise("unet",
   devices=[cuda:0] x 2)`` (the halo route, equal to the halo denoiser and
   within ``UNET_HALO_TOL`` of whole-image), ``make_denoise_step`` over a
   data mesh of 2 (SGD updates within ``DENOISE_TRAIN_TOL``),
   ``segment.score_maps`` over 2 devices (1e-4) and
   ``normalize_images_batched`` over a data mesh of 2 (1e-3), each
   against its one-device route. One data-parallel SGD step over two
   copies against one step on the whole batch, for ``resnet8_u32`` and
   for a fresh ``resnet8`` with batch norm (updates within ``TRAIN_TOL``,
   running statistics too). The library's tail, card against CPU:
   ``ScaledGaussianMixture.fit`` on 4 x 512^2 (scales within 1e-5
   relative), the ``EXTRA_ARCHS`` nets at the test widths on 256^2 (1e-3),
   ``estimate_unblur_filter_gaussian`` on 512^2 (sigma and alpha within
   1e-3 relative).
16. Print the kernels line, the card line, and last the result line.

``--only PHASE ...`` runs the kernel check and those phases alone and
prints no result line (for trying a phase on the card).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RADIUS = 14
THRESHOLD = -6.0
SIZE = 4096
# the pipeline's batched score maps: 8 micrographs of a 512 x 512 and of a
# 768 x 512 bucket (4096^2 and 5760 x 4092 downsampled 8x)
BATCHED_SHAPES = [(8, 512, 512), (8, 768, 512)]
GEOMETRIES = [(4096, 4096), (5760, 4092), (3838, 3710)]
FILES_PER_GEOMETRY = 8
BATCH = 8
# picks of two pipeline runs whose GMM sums differ in order (masked bucket
# against the cropped image, cuFFT against scipy, card against CPU): an EM
# lane may stop one step apart (its tol of 1e-3 is below float32's
# resolution of a logp of ~1e5), which moves mu and std by ~1e-4 relative
# and a score s by ~1e-4 |s|; so score differences and near-tie gaps are
# held to 1e-3 in units of max(1, |s|), as the JAX package holds its own
# pipeline against the per-image path (rtol 1e-3, tests/test_pipeline.py)
PIPELINE_TOL = 1e-3
# the training phase: 12 + 4 micrographs of ~60 particles, 40 of each
# training micrograph's labeled (positive-unlabeled)
TRAIN_FILES, TEST_FILES, TRAIN_PARTICLES, TRAIN_LABELED = 12, 4, 60, 40
# card against CPU, five train rows of the same crops: each column's
# difference in units of max(|cpu value|, TRAIN_TOL_FLOOR) (cuDNN and the
# CPU sum float32 in other orders, and five Adam steps carry that forward;
# the largest measured on an H100 was 2.0e-5, the loss column's: 10x that)
TRAIN_TOL, TRAIN_TOL_FLOOR = 2e-4, 1e-2
# card against CPU, train rows of 3D training (batch 8 of 71^3) and of the
# autoencoder (batch 64): the first row (the same weights) agrees to 9.8e-6
# and the second (one update on) to 2.3e-5, but each further Adam step,
# whose first updates are +-lr whatever a gradient's size, carries the
# sum-order differences forward: row 5 differed by 2.28e-4 in 3D and by
# 1.1e-4 to 1.97e-3 with the autoencoder on an H100, where two card runs
# alone differ by 6.7e-5 (tools/profile_torch_train.py). So those phases
# hold their first TRAIN_STRICT_ROWS rows to TRAIN_TOL and every row to
# TRAIN_DRIFT_TOL, 10x the largest drift measured
TRAIN_STRICT_ROWS, TRAIN_DRIFT_TOL = 2, 2e-2
# card against CPU, denoiser training rows (train, val and best val loss) of
# the same crops and tiles, relative to the CPU's value: cuDNN and the CPU
# sum float32 in other orders and the optimizer carries it forward (the
# largest measured on an H100 was 1.19e-4, a 2D train loss: 10x that)
DENOISE_TRAIN_TOL = 1.2e-3
# the 2D denoiser training phase: 12 pairs of 4096^2 (holdout 0.1 leaves 11)
DENOISE_PAIRS = 12
# the 3D phase's tomograms, (z, y, x)
TOMO_SHAPE = (192, 384, 384)
# steps an epoch of the train3d phase (the CLI's default is 1000), and the
# train CLI's default batch
TRAIN3D_EPOCH_SIZE = 15
TRAIN_BATCH = 256
# steps an epoch of the train_ae phase
TRAIN_AE_EPOCH_SIZE = 50
# the tools phase: unbinned K3 micrographs (height x width) with planted
# particles, binned 4x for picking and segmenting; particle_stack's box
# and its --resize; about STACK_PARTICLES particles a micrograph go into
# the stack
K3_SHAPE, K3_FILES, K3_BIN = (4092, 5760), 4, 4
STACK_SIZE, STACK_RESIZE, STACK_PARTICLES = 256, 64, 200
# card against CPU, particle_stack --resize: each crop is standardized, so
# values are ~N(0, 1); cuFFT and pocketfft and two sum orders of the
# standardization differ by ~1e-6
STACK_TOL = 1e-4
# the services phase: 6 micrographs of each geometry (a 4096^2 frame and a
# K3 frame) and 4 that arrive later for watch; rounds of concurrent
# /extract requests; /denoise rounds of 4 and 8 concurrent 4096^2 frames
# (one 4096^2 U-Net forward peaks at 14.1-15.6 GiB: 4 fit in one batch, 8
# do not)
SERVICE_GEOMETRIES, SERVICE_FILES, SERVICE_ARRIVALS = [(4096, 4096), (5760, 4092)], 6, 4
SERVICE_ROUNDS, SERVICE_CONCURRENCY = 3, 8
SERVICE_DENOISE_BATCHES = (4, 8)
# the radius sweep of the kernel check, at extract's (512, 512) map: the
# radius grid's span (5..100) and the main path's r = 14
DISK_MAX_SWEEP = (5, 14, 30, 50, 75, 96, 100)
# the scaleout phase: the bundled unet through the halo denoiser (2 and 4
# row shards, a 256-row halo) against the whole-image route, the root mean
# square of the difference over the input's std. On a 1024^2 synthetic
# micrograph the JAX package's own halo route differs from its whole-image
# route by 0.012543 (tests/test_torch_parallel.py::
# test_unet_halo_bound_covers_jax, on the CPU), all of it near the image's
# top and bottom edges, where the zero apron is not the per-layer zero
# padding: so it falls as the image grows (0.008105 at 2048^2), and the
# 1024^2 value, rounded up, bounds 4096^2
UNET_HALO_TOL = 0.0126
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# the EM's bound: an H100 SXM's SMs, and the 32-bit exp2/log2 results a
# clock an SM of compute capability 9.0 (the CUDA C++ Programming Guide's
# throughput table); a posterior evaluation of the EM (csrc/gmm_em.cu) is
# five transcendental functions (two exp and a log for Z, two exp for p0
# and p1) and ~29 other float32 operations
SM_COUNT, MUFU_PER_CLOCK_SM = 132, 16
EM_MUFU_PER_EVAL, EM_F32_PER_EVAL = 5, 29
# the EM's tol (gmm_fit's default), and the kernel against its plain twin:
# the same float32 terms summed in float64 in two orders round alike but
# where a sum lies within float64 rounding of a float32 rounding boundary,
# so mu, std, pi and logp are held to 1e-5 relative, the port's contract
# with the JAX package
EM_TOL, GMM_EM_RTOL = 1e-3, 1e-5
# pixels an image of check_gmm_em's synthetic cases: a small image, and one
# of the pipeline's 512 x 512 bucket; and one of its 768 x 512 bucket
EM_SIZES = (4096, 262144)
EM_LARGE = 768 * 512


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time a call as called from Python: CUDA events around ``iters``
    eager calls. At small sizes this is the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time a call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's launch
    cost is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def disk_max_bound(shape, r: int, itemsize: int):
    """Least time for one disk max-filter: each input read once and each
    output written once, against the chord decomposition's max operations
    (2 max_w horizontal and 2r vertical maxes a pixel) at the f32 rate."""
    from topaz_tpu_torch.ops.nms import _chords_2d

    pixels = math.prod(shape)
    t_bytes = 2 * pixels * itemsize / HBM_BYTES_PER_S
    t_ops = pixels * (2 * max(_chords_2d(r)) + 2 * r) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_disk_max(shape, g, r=RADIUS, calls=200):
    """Device time a call (CUDA graph of ``calls`` calls) and eager time a
    call of kernel and plain version on a random f32 map of ``shape`` at
    radius ``r``, beside the bound."""
    import torch

    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops.nms import NEG, disk_max as plain

    x = torch.randn(shape, device="cuda", generator=g)
    times = {
        "ms": graph_ms(lambda: dm.disk_max(x, r, NEG), calls),
        "plain_ms": graph_ms(lambda: plain(x, r, NEG), 20),
        "eager_ms": cuda_ms(lambda: dm.disk_max(x, r, NEG), calls),
        "plain_eager_ms": cuda_ms(lambda: plain(x, r, NEG), 20),
    }
    times["bound_ms"], times["bound_by"] = disk_max_bound(x.shape, r, 4)
    times["share"] = times["bound_ms"] / times["ms"]
    print(f"# disk_max f32 {shape} r={r}: device time a call (CUDA graph) "
          f"kernel {times['ms']:.5f} ms, plain {times['plain_ms']:.5f} ms; eager a call "
          f"kernel {times['eager_ms']:.5f} ms, plain {times['plain_eager_ms']:.5f} ms; "
          f"bound {times['bound_ms']:.5f} ms ({times['bound_by']}), {times['share']:.4f} of it")
    return times


def disk_max_inputs(shape, g, device="cuda"):
    """The maps the NMS rounds hand the kernel, beside random ones: (label,
    tensor, init) for a random f32 map, a random int32 map, a score map
    masked to ~90% -inf, an index map (the in-plane linear index on ~5% of
    the pixels, INT32_MIN elsewhere) and a 0/1 int32 peak map."""
    import torch

    from topaz_tpu_torch.ops.nms import INT_NEG, NEG

    H, W = shape[-2:]
    u = torch.rand(shape, device=device, generator=g)
    lin = torch.arange(H * W, dtype=torch.int32, device=device).reshape(H, W).expand(shape)
    scores = torch.randn(shape, device=device, generator=g)
    return [
        ("f32", scores, NEG),
        ("i32", torch.randint(-999, 999, shape, device=device, generator=g,
                              dtype=torch.int32), INT_NEG),
        ("masked", torch.where(u < 0.9, NEG, scores), NEG),
        ("index", torch.where(u < 0.05, lin, INT_NEG).contiguous(), INT_NEG),
        ("peaks", (u < 0.01).to(torch.int32), INT_NEG),
    ]


def check_disk_max():
    """Kernel against plain version, bit-equal, on every kind of
    ``disk_max_inputs``; returns the max abs error, the times at the
    single-image and the batched main-path shapes, and the radius sweep at
    the single-image shape."""
    import torch

    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops.nms import disk_max as plain

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = 0.0
    cases = [(shape, r) for shape in [(512, 512), (3, 300, 200)]
             for r in (0, 1, 3, 7, 14, 31, 32, 33, 60, 85, 86, 96, 97, 100, 150)]
    cases += [((1, 4096, 4096), r) for r in (0, 3, 14, 33, 85, 86, 100, 150)]
    cases += [(shape, r) for shape in BATCHED_SHAPES for r in (3, 14)]
    # r >= H or r >= W, and sides that are no multiple of a tile
    cases += [((3, 40, 50), 60), ((70, 33), 100), ((40, 50), 120)]
    cases += [((5, 257, 129), r) for r in (1, 14, 33, 150)]
    for shape, r in cases:
        for label, x, init in disk_max_inputs(shape, g):
            got = dm.disk_max(x, r, init)
            torch.cuda.synchronize()
            want = plain(x, r, init)
            torch.cuda.synchronize()
            finite = torch.isfinite(want.double())
            diff = (got.double() - want.double())[finite].abs().max().item() if finite.any() else 0.0
            err = max(err, diff)
            if not torch.equal(got, want):
                fail(f"disk_max {label} {shape} r={r}: kernel differs from "
                     f"plain version (max abs diff {diff})")
        print(f"# disk_max f32/i32/masked/index/peaks {str(shape):15s} r={r:3d}: bit-equal")
    single = time_disk_max((SIZE // 8, SIZE // 8), g)
    batched = time_disk_max(BATCHED_SHAPES[-1], g)
    by_radius = [{"r": r, "shape": [SIZE // 8, SIZE // 8],
                  **time_disk_max((SIZE // 8, SIZE // 8), g, r=r)}
                 for r in DISK_MAX_SWEEP]
    return err, single, batched, by_radius


def same_bits(a, b) -> bool:
    """Equal shapes, NaN at the same places and every other value equal bit
    for bit (so -0.0 is not 0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def unet_edge_input(shape, g, specials: bool):
    """Normal float32 values with zeros of both signs, and, with
    ``specials``, +-inf and NaN sprinkled in."""
    import torch

    x = torch.randn(shape, device="cuda", generator=g)
    u = torch.rand(shape, device="cuda", generator=g)
    x[u < 0.02] = 0.0
    x[(u >= 0.02) & (u < 0.04)] = -0.0
    if specials:
        x[(u >= 0.04) & (u < 0.045)] = float("inf")
        x[(u >= 0.045) & (u < 0.05)] = float("-inf")
        x[(u >= 0.05) & (u < 0.055)] = float("nan")
    return x


def unet_edge_calls(kind, shape, g, specials: bool = False):
    """(kernel call, plain call, bytes) of one U-Net edge: ``bias_lrelu``
    on a (N, C, *S) map, ``pool`` of one, or ``up_cat`` of a (N, C1, *S)
    map upsampled to ``shape[3]`` with a skip of ``shape[2]`` channels
    (``shape`` = (N, C1, C2, S_out)); the bytes read and written once each."""
    from topaz_tpu_torch.ops import unet_edges as E

    if kind == "up_cat":
        n, c1, c2, size = shape
        h = unet_edge_input((n, c1, *(s // 2 for s in size)), g, specials)
        skip = unet_edge_input((n, c2, *size), g, specials) if c2 else None
        b = unet_edge_input((c1,), g, False)
        out = math.prod(E.up_cat_shape(h.shape, c2, size))
        return (lambda: E.bias_lrelu_up_cat(h, b, skip, size),
                lambda: E.bias_lrelu_up_cat_plain(h, b, skip, size),
                4 * (h.numel() + (skip.numel() if c2 else 0) + out))
    x = unet_edge_input(shape, g, specials)
    b = unet_edge_input((shape[1],), g, False)
    if kind == "pool":
        return (lambda: E.bias_lrelu_pool(x, b), lambda: E.bias_lrelu_pool_plain(x, b),
                4 * (x.numel() + math.prod(E.pool_shape(x.shape))))
    # in place: the kernel's call on a copy made once, so that the check
    # sees one pass; the timed calls repeat it on that copy
    y = x.clone()
    return (lambda: E.bias_lrelu_(y, b), lambda: E.bias_lrelu_plain(x, b), 8 * x.numel())


# the U-Net's edges timed: a 4096^2 image's top level (nf 48: enc1's pool,
# dec2 -> dec1's upsample of 96 channels with the one-channel input as its
# skip, dec1's 64- and 32-channel passes) and a 192^3 window's
UNET_EDGE_TIMED = [
    ("pool", (1, 48, SIZE, SIZE), "enc1 4096^2"),
    ("up_cat", (1, 96, 1, (SIZE, SIZE)), "dec2 -> dec1 4096^2"),
    ("bias_lrelu", (1, 64, SIZE, SIZE), "dec1.0 4096^2"),
    ("bias_lrelu", (1, 32, SIZE, SIZE), "dec1.2 4096^2"),
    ("pool", (1, 48, 192, 192, 192), "enc1 192^3"),
    ("up_cat", (1, 96, 1, (192, 192, 192)), "dec2 -> dec1 192^3"),
    ("bias_lrelu", (1, 64, 192, 192, 192), "dec1.0 192^3"),
]


def check_unet_edges():
    """The U-Net's edge kernels against their plain compositions, bit for
    bit: 2D and 3D, N 1 and 8, even and odd extents, skips of 0, 1 and 48
    channels, inputs with +-0, +-inf and NaN, and each timed shape; then
    each timed (CUDA events, 20 eager calls) beside the plain composition
    (``library_ms``: PyTorch's ops, as the modules run them) and the bytes
    bound. Returns the timed rows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(k, (n, 6, *s)) for k in ("bias_lrelu", "pool") for n in (1, 8)
             for s in ((64, 96), (33, 47), (16, 12, 20), (9, 14, 11))]
    cases += [("up_cat", (n, 7, c2, s)) for n in (1, 8) for c2 in (0, 1, 48)
              for s in ((64, 96), (33, 47), (16, 12, 20), (9, 14, 11))]
    for kind, shape in cases:
        kernel, plain, _ = unet_edge_calls(kind, shape, g, specials=True)
        if not same_bits(kernel(), plain()):
            fail(f"unet_edges {kind} {shape}: kernel differs from its plain composition")
    print(f"# unet_edges: {len(cases)} cases bit-equal to the plain compositions "
          f"(+-0, +-inf, NaN; even and odd extents; 2D and 3D)")
    rows = []
    for kind, shape, label in UNET_EDGE_TIMED:
        kernel, plain, nbytes = unet_edge_calls(kind, shape, g)
        # no NaN here: the bits compared through views, with no copies
        if not torch.equal(kernel().view(torch.int32), plain().view(torch.int32)):
            fail(f"unet_edges {kind} {label}: kernel differs from its plain composition")
        row = {"kind": kind, "label": label, "shape": [list(v) if isinstance(v, tuple) else v
                                                       for v in shape],
               "ms": cuda_ms(kernel, 20), "library_ms": cuda_ms(plain, 20),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        row["share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"# unet_edges {kind} {label}: kernel {row['ms']:.4f} ms, PyTorch's ops "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} "
              f"GB at 3.35 TB/s), {row['share']:.3f} of it")
        del kernel, plain
        torch.cuda.empty_cache()
    return rows


# the EM kernel's and the U-Net edge kernels' launches on each path, read
# in the same windows as the disk max's (reset_launches / read_launches)
GMM_LAUNCHES = {}
UNET_EDGE_LAUNCHES = {}
# the normalized micrograph's card-vs-CPU max abs diff of phase slice
NORMALIZED_ERR = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    from topaz_tpu_torch.ops import disk_max as dm, gmm, unet_edges

    dm.launches = 0
    gmm.launches = 0
    unet_edges.launches = 0


def read_launches(path: str) -> int:
    """Every kernel's launches since ``reset_launches``, just after a path
    ran: the EM kernel's go to GMM_LAUNCHES[path], the U-Net edge kernels'
    to UNET_EDGE_LAUNCHES[path], the disk max's are returned."""
    from topaz_tpu_torch.ops import disk_max as dm, gmm, unet_edges

    GMM_LAUNCHES[path] = gmm.launches
    UNET_EDGE_LAUNCHES[path] = unet_edges.launches
    return dm.launches


def require_edge_launches(path: str) -> None:
    """Fail unless ``path``, which runs the U-Net in float32 on the card
    with no autograd graph, launched the edge kernels (a path that fell back
    to the modules launches none)."""
    if not UNET_EDGE_LAUNCHES.get(path):
        fail(f"{path}: the U-Net's edge kernels launched {UNET_EDGE_LAUNCHES.get(path)} "
             f"times; its forwards took the modules' route")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def em_bound(xb, wb, steps):
    """Least time of one EM fit on the card, ms, and what bounds it: the
    larger of reading x and w once (the outputs are B x L x 7 words) and
    of the posterior evaluations this run's lanes needed, one a pixel of
    nonzero weight and lane at the init and at each step they took, each
    EM_MUFU_PER_EVAL transcendental functions at the MUFU rate and
    EM_F32_PER_EVAL other float32 operations at the f32 rate."""
    import torch

    B, N = xb.shape
    L = steps.shape[-1]
    nbytes = xb.numel() * 4 * (1 if wb is None else 2) + B * L * 7 * 4
    pixels = (torch.full((B,), N, device=xb.device) if wb is None
              else torch.count_nonzero(wb, dim=-1))
    evals = float(torch.sum(pixels[:, None].double() * (steps.double() + 1)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    mufu_per_s = SM_COUNT * MUFU_PER_CLOCK_SM * max_sm_clock_hz()
    t_ops = max(evals * EM_MUFU_PER_EVAL / mufu_per_s, evals * EM_F32_PER_EVAL / F32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def em_compare(kern, ksteps, twin, tsteps, history):
    """The kernel's fit against its plain twin's (``_gmm_fit_plain`` with
    float64 sums) on the same inputs, lane by lane. A lane stops at the
    twin's step, or one step apart only at a tie: where the twin's logp -
    logp_cur at the earlier of the two steps lies within one float32 ulp of
    that step's logp of tol; a tie lane's values are then held to the
    twin's state after the kernel's step. Returns the largest relative
    differences of mu (both components), std, pi and logp, the largest
    absolute difference of any finite output, the tie lanes and the lanes
    that break the rule, as (image, lane, kernel steps, twin steps)."""
    import numpy as np

    names = ("logp", "mu0", "var", "mu1", "var", "pi")
    k = {n: v.double().cpu().numpy() for n, v in zip(names, kern)}
    t = {n: v.double().cpu().numpy() for n, v in zip(names, twin)}
    ks, ts = ksteps.cpu().numpy(), tsteps.cpu().numpy()
    hist = [{key: v.cpu().numpy() for key, v in h.items()} for h in history]
    ties, bad = [], []
    for b, l in zip(*np.nonzero(ks != ts)):
        lane = (int(b), int(l), int(ks[b, l]), int(ts[b, l]))
        m = min(ks[b, l], ts[b, l])
        h = hist[m - 1] if 1 <= m <= len(hist) else None
        if abs(int(ks[b, l]) - int(ts[b, l])) != 1 or h is None or not h["running"][b, l]:
            bad.append(lane)
            continue
        logp = np.float32(h["logp"][b, l])
        if abs(np.float32(h["gain"][b, l]) - np.float32(EM_TOL)) > np.spacing(abs(logp)):
            bad.append(lane)
            continue
        ties.append(lane)
        # the twin's state after the kernel's step, where the loop ran it
        after = hist[ks[b, l] - 1] if ks[b, l] <= len(hist) else None
        if after is None:
            bad.append(lane)
            continue
        for n in ("logp", "mu0", "var", "mu1", "pi"):
            t[n][b, l] = after[n][b, l]

    def rel(a, b):
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.abs(a - b) / np.abs(b)
        d = np.where((a == b) | (np.isnan(a) & np.isnan(b)), 0.0, d)
        return float(np.max(np.where(np.isnan(d), np.inf, d)))

    errs = {"mu": max(rel(k["mu0"], t["mu0"]), rel(k["mu1"], t["mu1"])),
            "std": rel(np.sqrt(k["var"]), np.sqrt(t["var"])),
            "pi": rel(k["pi"], t["pi"]), "logp": rel(k["logp"], t["logp"])}
    both = [(k[n], t[n]) for n in ("logp", "mu0", "var", "mu1", "pi")]
    max_abs = max(float(np.max(np.abs(a - b), initial=0.0, where=np.isfinite(a - b)))
                  for a, b in both)
    return errs, max_abs, ties, bad


def em_inputs(fit, *args, **kw):
    """The lane inputs a call of ``fit`` (``norm_fit`` or ``norm_fit_hist``)
    hands the EM: (xb, wb, n, pi, split) as the plain version and the kernel
    take them, and the EM's alpha, beta, scale and num_iters. The call runs
    as it would (one kernel launch on the card)."""
    from topaz_tpu_torch.ops import gmm

    seen = {}
    real = gmm.gmm_fit

    def spy(x, pi, split, alpha=0.5, beta=0.5, scale=1.0, tol=EM_TOL, num_iters=100,
            w=None, n=None):
        seen["inputs"] = gmm._fit_inputs(x, pi, split, w, n)
        seen["opts"] = (alpha, beta, scale, num_iters)
        return real(x, pi, split, alpha=alpha, beta=beta, scale=scale, tol=tol,
                    num_iters=num_iters, w=w, n=n)

    gmm.gmm_fit = spy
    try:
        fit(*args, **kw)
    finally:
        gmm.gmm_fit = real
    return seen["inputs"], seen["opts"]


def em_case(tag, inputs, opts):
    """One EM case on the card: the kernel against its plain twin (the rule
    of ``em_compare``, mu/std/pi/logp within GMM_EM_RTOL), and the plain
    version as the CPU path runs it (float32 sums) beside them, with the
    kernel's, the twin's and the plain version's ms and the bound. Fails on
    any difference the rule does not allow."""
    import torch

    from topaz_tpu_torch.ops import gmm

    xb, wb, n, pi, split = inputs
    alpha, beta, scale, num_iters = opts
    args = (xb, wb, n, pi, split, alpha, beta, scale, EM_TOL, num_iters)
    plan = gmm._device_plan(torch.cuda.current_device(), xb.shape[0], pi.shape[-1], xb.shape[1],
                            wb is not None)
    kern, ksteps = gmm._gmm_fit_kernel(*args)
    torch.cuda.synchronize()
    history = []
    twin, tsteps = gmm._gmm_fit_plain(*args, acc=torch.float64, history=history)
    history = [dict(zip(("gain", "logp", "running", "mu0", "var", "mu1", "pi"), h))
               for h in history]
    plain, psteps = gmm._gmm_fit_plain(*args)
    errs, max_abs, ties, bad = em_compare(kern, ksteps, twin, tsteps, history)
    f32_errs, _, _, _ = em_compare(kern, ksteps, plain, psteps, [])
    weights = ("none" if wb is None else "0/1" if bool(((wb == 0) | (wb == 1)).all())
               else "counts")
    row = {"tag": tag, "shape": [xb.shape[0], xb.shape[1], pi.shape[-1]], "weights": weights,
           "num_iters": num_iters, "cluster": plan.cluster, "route": plan.route,
           "kept": plan.kept, "smem": plan.smem, "errs": errs, "max_abs_err": max_abs,
           "ties": ties,
           "steps_kernel": ksteps.cpu().tolist(), "steps_twin": tsteps.cpu().tolist(),
           "plain_f32_errs": f32_errs,
           "plain_f32_steps_differ": int((psteps != ksteps).sum())}
    row["ms"] = cuda_ms(lambda: gmm._gmm_fit_kernel(*args), 5, warmup=1)
    row["twin_ms"] = cuda_ms(lambda: gmm._gmm_fit_plain(*args, acc=torch.float64), 1, warmup=0)
    row["plain_ms"] = cuda_ms(lambda: gmm._gmm_fit_plain(*args), 1, warmup=0)
    row["bound_ms"], row["bound_by"] = em_bound(xb, wb, ksteps)
    print(f"# gmm_em {tag} {tuple(row['shape'])} w={row['weights']} num_iters={num_iters}, "
          f"C={plan.cluster} {plan.route} ({plan.kept} of {plan.slice} pixels a block kept, "
          f"{plan.smem} B of shared memory): max rel diff to the twin "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; steps kernel {row['steps_kernel']}, twin {row['steps_twin']}, ties {ties}"
          + f"; plain (f32 sums): {row['plain_f32_steps_differ']} lanes stop elsewhere, "
          + ", ".join(f"{k} {v:.3e}" for k, v in f32_errs.items())
          + f"; kernel {row['ms']:.3f} ms, twin {row['twin_ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if bad or max(errs.values()) > GMM_EM_RTOL:
        fail(f"gmm_em {tag}: kernel differs from its plain twin: {errs}, lanes {bad}")
    return row


def em_mixture(rng, B, N, valid=None, dead=None, device="cuda"):
    """(B, N) float32 pixels of two Gaussians (means 1 and 3, std 0.6, a
    high-intensity share drawn per image) on ``device``; with ``valid``, 0/1
    weights keeping each image's first valid[b] pixels and junk (50) in
    the rest, else None; image ``dead`` constant (2.5) on its valid
    pixels."""
    import numpy as np
    import torch

    share = rng.uniform(0.1, 0.6, (B, 1))
    x = np.where(rng.random((B, N)) < share, rng.normal(3.0, 0.6, (B, N)),
                 rng.normal(1.0, 0.6, (B, N))).astype(np.float32)
    w = None
    if valid is not None:
        w = (np.arange(N)[None] < np.asarray(valid)[:, None]).astype(np.float32)
        x = np.where(w > 0, x, np.float32(50.0))
    if dead is not None:
        x[dead] = 2.5 if w is None else np.where(w[dead] > 0, 2.5, 50.0)
    return tuple(None if a is None else torch.from_numpy(a).to(device) for a in (x, w))


def check_gmm_em():
    """The EM kernel against its plain twin on the card: one image and a
    batch of 8 at each of EM_SIZES pixels, unweighted, with 0/1 weights (a
    padded bucket) and with histogram counts (``norm_fit_hist``'s bins);
    a fit cut at num_iters = 3 (every lane runs to it); a padded batch with
    a dead frame. Then ``gmm_fit`` under torch.cuda.set_sync_debug_mode
    ("error"): one launch and no host sync in the fit. Then, with a seed of
    their own, the pipeline's 8 x 768 x 512 bucket with 0/1 weights, one
    4096^2 micrograph fit whole (the recompute route) and one image on each
    side of the largest N whose slices the largest cluster keeps whole in
    shared memory (the resident route at it, the recompute route above).
    Each row has the kernel's plan (cluster size, route, pixels a block
    kept, dynamic shared memory). Returns the rows."""
    import numpy as np
    import torch

    from topaz_tpu_torch.ops import gmm

    rng = np.random.default_rng(SEED + 15)
    rows = []
    for B in (1, 8):
        for N in EM_SIZES:
            x, _ = em_mixture(rng, B, N)
            rows.append(em_case("unweighted", *em_inputs(gmm.norm_fit, x)))
            valid = rng.integers(N // 2, N + 1, B)
            x, w = em_mixture(rng, B, N, valid)
            rows.append(em_case("0/1 weights", *em_inputs(gmm.norm_fit, x, w=w)))
            x, _ = em_mixture(rng, B, 4 * N)
            rows.append(em_case("counts", *em_inputs(gmm.norm_fit_hist, x, bins=N)))
    N = EM_SIZES[0]
    x, w = em_mixture(rng, 8, N, rng.integers(N // 2, N + 1, 8))
    rows.append(em_case("num_iters", *em_inputs(gmm.norm_fit, x, w=w, num_iters=3)))
    if any(s != 3 for lane in rows[-1]["steps_kernel"] for s in lane):
        fail(f"gmm_em num_iters=3: lanes stopped at {rows[-1]['steps_kernel']}")
    x, w = em_mixture(rng, 8, N, rng.integers(N // 2, N + 1, 8), dead=3)
    rows.append(em_case("dead frame", *em_inputs(gmm.norm_fit, x, w=w)))
    if rows[-1]["steps_kernel"][3] != [100] * 11:
        fail(f"gmm_em dead frame: its lanes stopped at {rows[-1]['steps_kernel'][3]}")

    # the fit as the pipeline calls it, with sync debugging set to raise
    N = EM_SIZES[-1]
    x, w = em_mixture(rng, 8, N, rng.integers(N // 2, N + 1, 8))
    (xb, wb, n, pi, split), (alpha, beta, scale, num_iters) = em_inputs(gmm.norm_fit, x, w=w)
    torch.cuda.synchronize()
    before = gmm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gmm.gmm_fit(xb, pi, split, alpha=alpha, beta=beta, scale=scale,
                          num_iters=num_iters, w=wb, n=n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if gmm.launches - before != 1 or not all(torch.isfinite(v).all() for v in out):
        fail(f"gmm_fit: {gmm.launches - before} launches, finite "
             f"{[bool(torch.isfinite(v).all()) for v in out]}")
    print("# gmm_fit on the card under set_sync_debug_mode('error'): one launch, no host sync")

    # the pipeline's 768 x 512 bucket, one micrograph fit whole at 4096^2
    # (no plan keeps all its slices), and both sides of the largest N whose
    # slices the largest cluster keeps whole
    rng = np.random.default_rng(SEED + 16)
    N = EM_LARGE
    x, w = em_mixture(rng, 8, N, rng.integers(N // 2, N + 1, 8))
    rows.append(em_case("0/1 weights", *em_inputs(gmm.norm_fit, x, w=w)))
    x, _ = em_mixture(rng, 1, SIZE * SIZE)
    rows.append(em_case("unweighted, whole 4096^2", *em_inputs(gmm.norm_fit, x)))
    if rows[-1]["route"] != "recompute":
        fail(f"gmm_em at 4096^2: route {rows[-1]['route']}")
    limit = gmm.MAX_CLUSTER * (gmm._smem_limit(torch.cuda.current_device()) // 8)
    for N, route in ((limit, "resident"), (limit + 1, "recompute")):
        x, _ = em_mixture(rng, 1, N)
        rows.append(em_case(f"unweighted, {'at' if N == limit else 'above'} the resident limit",
                            *em_inputs(gmm.norm_fit, x)))
        if rows[-1]["route"] != route:
            fail(f"gmm_em at N = {N}: route {rows[-1]['route']}, not {route}")
    return rows


def selected_card_vs_cpu(name, x, w):
    """Each image's selected lane of the masked ``norm_fit`` (the
    pipeline's) on the card against the CPU path's own ``norm_fit`` of the
    image (all 11 EM lanes and the single-component lane, the plain
    version's float32 sums, as JAX's; an image a call, ~2x faster than the
    batch on the host): the largest relative differences of mu and std over
    the batch, printed beside the normalized micrograph's card-vs-CPU
    difference of phase ``slice``, and the images whose CPU selection is
    not the card's. Lanes that stop a step apart on the two, and near-tied
    lanes that select differently, move them."""
    import torch

    from topaz_tpu_torch.ops import gmm

    card = gmm.norm_fit(x, w=w)
    start = time.perf_counter()
    fits = [gmm.norm_fit(x[b:b + 1].cpu(), w=w[b:b + 1].cpu()) for b in range(x.shape[0])]
    cpu = [torch.cat(v) for v in zip(*fits)]
    cpu_s = time.perf_counter() - start
    want = [v.double().cpu() for v in card[:2]]
    got = [v.double() for v in cpu[:2]]
    diff = {k: float(((a - b).abs() / b.abs()).max()) for k, a, b in zip(("mu", "std"), want, got)}
    other = int((torch.argmax(cpu[7], dim=-1) != torch.argmax(card[7], dim=-1).cpu()).sum())
    print(f"# gmm_em pipeline {name}: the selected lane, card vs cpu, {x.shape[0]} images: max "
          f"rel diff mu {diff['mu']:.3e}, std {diff['std']:.3e}; {other} images select another "
          f"lane on the cpu, whose fit took {cpu_s:.1f} s (the normalized micrograph of phase "
          f"slice: max abs diff {NORMALIZED_ERR.get('slice', 'not run')})")
    if not all(math.isfinite(v) for v in diff.values()):
        fail(f"gmm_em pipeline {name}: selected lane card vs cpu {diff}")
    return {**diff, "images_selecting_another_lane": other, "cpu_s": cpu_s}


def pipeline_em_inputs(paths):
    """The pipeline's real EM inputs on the card, as the pipeline loads the
    files (host prep): {name: (x, w)} for a batch of 8 of each main bucket,
    (B, N) pixels and 0/1 validity weights, and "single": the first 4096^2
    micrograph of the 512 x 512 bucket alone, (1, N), with no weights."""
    import numpy as np
    import torch

    from topaz_tpu_torch.pipeline import MicrographPipeline, _image_shape
    from topaz_tpu_torch.utils.batching import valid_mask

    pipe = MicrographPipeline(model="resnet8_u32", scale=8, radius=RADIUS,
                              threshold=THRESHOLD, host_downsample=True, num_workers=2)
    by_bucket = {}
    for p in paths:
        ds = pipe._ds_shape(_image_shape(p))
        by_bucket.setdefault(pipe._bucket_for(ds), []).append((p, ds))
    out = {}
    for bucket, items in sorted(by_bucket.items()):
        if len(items) < BATCH:
            continue
        items = items[:BATCH]
        x = torch.from_numpy(np.stack([pipe._load_one(p, bucket) for p, _ in items])).cuda()
        valid = torch.tensor([ds for _, ds in items]).cuda()
        w = valid_mask(bucket, valid).float().reshape(BATCH, -1)
        out[f"bucket_{bucket[0]}x{bucket[1]}"] = (x.reshape(BATCH, -1), w)
        if bucket == (SIZE // 8, SIZE // 8):
            path = next(p for p, ds in by_bucket[bucket] if ds == bucket)
            one = torch.from_numpy(pipe._load_one(path, bucket)).cuda().reshape(1, -1)
            out["single"] = (one, None)
    return out


def check_gmm_em_pipeline(paths):
    """The EM kernel against its plain twin on the pipeline's real inputs
    (``pipeline_em_inputs``): a batch of 8 of each main bucket, fit as its
    batch function fits it (masked ``norm_fit``), the 512 x 512 bucket's
    histogram fit (``norm_fit_hist``, 65536 bins, as the pipeline runs with
    ``bins``) and the first 4096^2 micrograph alone, unmasked, all its
    pixels (``preprocess --sample 1``); with each bucket's selected lanes
    card vs CPU
    (``selected_card_vs_cpu``). Returns {name: row}."""
    from topaz_tpu_torch.ops import gmm

    rows = {}
    for name, (x, w) in pipeline_em_inputs(paths).items():
        if name == "single":
            rows[name] = em_case("preprocess, one micrograph", *em_inputs(gmm.norm_fit, x))
            continue
        rows[name] = em_case(f"pipeline {name}", *em_inputs(gmm.norm_fit, x, w=w))
        rows[name]["selected_card_vs_cpu"] = selected_card_vs_cpu(name, x, w)
        if name == f"bucket_{SIZE // 8}x{SIZE // 8}":
            rows["hist"] = em_case(f"pipeline {name}, 65536 bins",
                                   *em_inputs(gmm.norm_fit_hist, x, bins=65536, w=w))
    if len(rows) != 4 or "hist" not in rows or "single" not in rows:
        fail(f"gmm_em on the pipeline's buckets: got {sorted(rows)}")
    return rows


def read_picks(path):
    picks = {}
    with open(path) as f:
        next(f)
        for line in f:
            _, x, y, s = line.rstrip("\n").split("\t")
            picks[(int(x), int(y))] = float(s)
    return picks


def compare_picks(card, cpu, tie=1e-5, labels=("card", "cpu"), relative=False,
                  radius=RADIUS, threshold=THRESHOLD):
    """Differing picks are allowed only where the two deciding scores lie
    within ``tie``: the pick of one run against a pick of the other run
    inside the NMS ``radius``, or against the ``threshold``. Picks are keyed
    by their coordinates, (x, y) or (x, y, z). Returns the largest score
    difference of the common picks. ``relative`` measures each difference
    in units of max(1, |score|)."""
    def diff(a, b):
        return abs(a - b) / (max(1.0, abs(a)) if relative else 1.0)

    for mine, other, label in ((card, cpu, labels[0]), (cpu, card, labels[1])):
        for p in sorted(set(mine) - set(other)):
            near = [q for q in other if sum((a - b) ** 2 for a, b in zip(p, q)) <= radius ** 2]
            gap = min([diff(mine[p], threshold)] + [diff(mine[p], other[q]) for q in near])
            print(f"# pick {p} only in the {label} run: score {mine[p]}, "
                  f"closest deciding score gap {gap}")
            if gap > tie:
                fail(f"pick {p} of the {label} run is not a near-tie (gap {gap})")
    common = set(card) & set(cpu)
    return max((diff(card[p], cpu[p]) for p in common), default=0.0)


def run_slice(workdir: str):
    """preprocess -> extract through the CLI on the card (cold, then warm)
    and on the CPU; returns the disk_max launches of the cold card run."""
    import numpy as np
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.ops.nms import _greedy_rounds, disk_max as plain
    from topaz_tpu_torch.extract import score_images
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    x, _ = make_ctf_micrograph(np.random.default_rng(SEED), size=SIZE, n_particles=60)
    raw = os.path.join(workdir, "raw.mrc")
    mrc.write(raw, x)

    def stages(device: str, tag: str):
        proc = os.path.join(workdir, f"proc_{tag}")
        picks = os.path.join(workdir, f"picks_{tag}.txt")
        t0 = time.perf_counter()
        cli(["preprocess", "-s", "8", "-o", proc, "-d", device, raw])
        t1 = time.perf_counter()
        cli(["extract", "-m", "resnet8_u32", "-r", str(RADIUS), "-t", str(THRESHOLD),
             "-o", picks, "-d", device, os.path.join(proc, "raw.mrc")])
        if device != "cpu":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"# {tag}: preprocess {t1 - t0:.3f} s, extract {t2 - t1:.3f} s")
        return os.path.join(proc, "raw.mrc"), picks

    reset_launches()
    proc_card, picks_card = stages("0", "card_cold")
    launches = read_launches("extract")
    stages("0", "card_warm")
    proc_cpu, picks_cpu = stages("cpu", "cpu")

    # greedy rounds of this micrograph, counted through the plain filter
    calls = [0]

    def counted(x, init):
        calls[0] += 1
        return plain(x, RADIUS, init)

    _, score = next(score_images("resnet8_u32", [proc_card], device="cuda"))
    _greedy_rounds(score.contiguous(), THRESHOLD, counted)
    rounds = calls[0] // 3
    print(f"# greedy rounds {rounds}, disk_max launches on the card run {launches}, "
          f"gmm_em {GMM_LAUNCHES['extract']}")
    if rounds < 1 or launches < 3 * rounds:
        fail(f"disk_max launched {launches} times for {rounds} greedy rounds "
             f"(expected at least {3 * rounds})")
    if GMM_LAUNCHES["extract"] != 1:
        fail(f"gmm_em launched {GMM_LAUNCHES['extract']} times for one micrograph's fit")

    a, b = mrc.read(proc_card)[0], mrc.read(proc_cpu)[0]
    img_err = float(np.abs(a.astype(np.float64) - b).max())
    NORMALIZED_ERR["slice"] = img_err
    print(f"# normalized micrograph {a.shape}: card vs cpu max abs diff {img_err}")
    if a.shape != (SIZE // 8, SIZE // 8) or not np.isfinite(a).all() or img_err > 1e-3:
        fail(f"normalized micrograph: shape {a.shape}, max abs diff {img_err}")

    card, cpu = read_picks(picks_card), read_picks(picks_cpu)
    print(f"# picks: card {len(card)}, cpu {len(cpu)}")
    if not card or not all(math.isfinite(s) for s in card.values()):
        fail("no finite picks on the card run")
    score_err = compare_picks(card, cpu)
    print(f"# matched pick scores: card vs cpu max abs diff {score_err}")
    if score_err > 1e-3:
        fail(f"pick scores differ by {score_err}")
    return launches


def unet_flops(shape, layout, levels: int = 5) -> int:
    """FLOPs of one U-Net forward on one (H, W) image or (D, H, W) volume:
    2 k^dims cin cout a pixel for every convolution, at the pyramid level it
    runs (encoder i at level i - 1, decoder d at level d - 1; pooling floors
    odd sizes). Pooling, upsampling, bias and activations are left out."""
    sizes = [tuple(shape)]
    for _ in range(levels):
        sizes.append(tuple(n // 2 for n in sizes[-1]))
    total = 0
    for mod, convs in layout.items():
        n = math.prod(sizes[int(mod[3:]) - 1])
        total += sum(2 * k ** len(shape) * cin * cout * n for k, cin, cout in convs.values())
    return total


def denoise_step_flops(shape, meta, batch: int) -> int:
    """FLOPs of one denoiser train step on ``batch`` crops of ``shape``: the
    forward's convolutions, and twice that for the backward (input and
    weight gradients) less the first convolution's input gradient."""
    from topaz_tpu_torch.models.denoise import arch_layout

    layout = arch_layout(meta["arch"], meta["nf"], meta["base_width"], meta["top_width"])
    forward = unet_flops(shape, layout)
    k, cin, cout = layout["enc1"]["0"]
    first = 2 * k ** len(shape) * cin * cout * math.prod(shape)
    return batch * (3 * forward - first)


def time_unet_forward():
    """Device time of the unet forward on one 4096^2 image, TF32 off as the
    port runs it (the fused route: its edge kernels' launches counted, its
    output bit-equal to the modules' forward, which is timed beside it),
    beside its FLOP bound and its peak memory; then the same forward with
    cudnn.benchmark on, with TF32 and in bf16, for comparison."""
    import torch

    from topaz_tpu_torch.device import exact_numerics
    from topaz_tpu_torch.models.denoise import arch_layout
    from topaz_tpu_torch.models.denoise_factory import load_denoiser

    model = load_denoiser("unet-v0.2.1", device="cuda")
    m = model.meta
    flops = unet_flops((SIZE, SIZE), arch_layout(m["arch"], m["nf"], m["base_width"],
                                                 m["top_width"]))
    bound_ms = max(flops / F32_OPS_PER_S, 2 * 4 * SIZE * SIZE / HBM_BYTES_PER_S) * 1e3
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((1, 1, SIZE, SIZE), device="cuda", generator=g)
    with torch.inference_mode():
        reset_launches()
        fused = model(x)
        read_launches("forward")
        require_edge_launches("forward")
        if not torch.equal(fused, model._plain(x)):
            fail("unet forward: the fused route differs from the modules' forward")
        del fused
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(lambda: model._plain(x), iters=5, warmup=1)
        plain_peak = torch.cuda.max_memory_allocated()
        print(f"# unet forward f32 (TF32 off) {SIZE}x{SIZE}: {ms:.3f} ms a call (CUDA "
              f"events, 5 calls; {UNET_EDGE_LAUNCHES['forward']} edge launches); bound "
              f"{bound_ms:.3f} ms ({flops / 1e12:.4f} TFLOP at {F32_OPS_PER_S / 1e12:.0f} "
              f"TFLOP/s), {bound_ms / ms:.3f} of it; peak memory {peak / 2**30:.3f} GiB; "
              f"the modules' forward {plain_ms:.3f} ms, peak {plain_peak / 2**30:.3f} GiB, "
              f"the same bits")
        if not ms > 0 or peak <= x.numel() * 4:
            fail(f"unet forward timing: {ms} ms, peak memory {peak} B")
        try:
            torch.backends.cudnn.benchmark = True
            bench_ms = cuda_ms(lambda: model(x), iters=5, warmup=2)
        finally:
            torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(lambda: model(x), iters=5, warmup=2)
        finally:
            exact_numerics()
        half = model.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: half(xb), iters=5, warmup=2)
    print(f"# unet forward {SIZE}x{SIZE}, not the port's default: f32 with "
          f"cudnn.benchmark {bench_ms:.3f} ms, TF32 {tf32_ms:.3f} ms, bf16 {bf16_ms:.3f} ms")


def run_denoise(workdir: str):
    """denoise -m unet through the CLI on the card at 4096^2, whole image
    and in the default patches, cold then warm; then card against CPU at
    512^2 and 1024^2. Of the port's kernels the denoise path launches the
    U-Net's edge kernels, and no other; returns the disk max's launches."""
    import numpy as np
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc

    raw = os.path.join(workdir, "raw.mrc")
    x = mrc.read(raw)[0]

    def denoise(device: str, tag: str, flags):
        out = os.path.join(workdir, f"denoised_{tag}")
        t0 = time.perf_counter()
        cli(["denoise", "-m", "unet", "-d", device, "-o", out, raw] + flags)
        if device != "cpu":
            torch.cuda.synchronize()
        print(f"# denoise {tag} ({' '.join(flags) or 'defaults -s 1024 -p 500'}): "
              f"{time.perf_counter() - t0:.3f} s")
        return mrc.read(os.path.join(out, "raw.mrc"))[0]

    n = gmm_n = 0
    for tag, flags in (("whole", ["-s", "0"]), ("patched", [])):
        reset_launches()
        for run in ("cold", "warm"):
            y = denoise("0", f"card_{tag}_{run}", flags)
            if y.shape != x.shape or not np.isfinite(y).all() or np.array_equal(y, x):
                fail(f"denoise {tag} {run}: shape {y.shape}, finite "
                     f"{np.isfinite(y).all()}, equal to the input {np.array_equal(y, x)}")
        n += read_launches(f"denoise_{tag}")
        gmm_n += GMM_LAUNCHES[f"denoise_{tag}"]
    GMM_LAUNCHES["denoise"] = gmm_n
    print(f"# denoise path: unet_edges launches {UNET_EDGE_LAUNCHES['denoise_whole']} whole "
          f"image, {UNET_EDGE_LAUNCHES['denoise_patched']} patched (cold and warm each); "
          f"disk_max {n}, gmm_em {gmm_n}")
    for tag in ("whole", "patched"):
        require_edge_launches(f"denoise_{tag}")
    time_unet_forward()
    for factor, flags in ((8, ["-s", "0"]), (4, ["-s", "384", "-p", "128"])):
        side = SIZE // factor
        flags = ["--downsample", str(factor)] + flags
        card = denoise("0", f"card_{side}", flags)
        cpu = denoise("cpu", f"cpu_{side}", flags)
        err = float(np.abs(card.astype(np.float64) - cpu).max())
        print(f"# denoise {side}^2 card vs cpu: max abs diff {err}, "
              f"{err / cpu.std():.3e} of the output's std")
        if card.shape != (side, side) or not np.isfinite(card).all() or err > 1e-3 * cpu.std():
            fail(f"denoise {side}^2: shape {card.shape}, card vs cpu max abs diff {err}")
    return n


def write_micrographs(workdir: str, rng, geometries, per_geometry: int, prefix: str = "mic"):
    """Gaussian-noise MRCs with 40 planted particles each (a local 3 sigma
    dip, radius ~24 px raw), geometries taken in turn, named
    ``<prefix>NN.mrc``."""
    import numpy as np

    from topaz_tpu_torch.io import mrc

    w = 96
    yy, xx = np.mgrid[-w:w, -w:w].astype(np.float32)
    blob = 3.0 * np.exp(-(yy ** 2 + xx ** 2) / (2 * 24.0 ** 2))
    paths = []
    for i in range(per_geometry * len(geometries)):
        h, wd = geometries[i % len(geometries)]
        x = rng.standard_normal((h, wd), dtype=np.float32)
        my, mx = (min(300, max(w, d // 4)) for d in (h, wd))
        for cy, cx in zip(rng.integers(my, h - my, size=40), rng.integers(mx, wd - mx, size=40)):
            x[cy - w:cy + w, cx - w:cx + w] -= blob
        paths.append(os.path.join(workdir, f"{prefix}{i:02d}.mrc"))
        mrc.write(paths[-1], x)
    return paths


def run_pipeline_pass(pipe, paths, tag: str, batch_size: int = BATCH):
    """One pass of ``pipe.process`` over ``paths``; returns {path: (scores,
    coords, denoised)} and prints the wall time and micrographs a second."""
    import torch

    from topaz_tpu_torch.utils import profiling

    profiling.reset()
    t0 = time.perf_counter()
    out = {}
    for path, scores, coords, den in pipe.process(paths, batch_size=batch_size):
        out[path] = (scores, coords, den)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"# pipeline {tag}: {len(out)} micrographs in {dt:.3f} s, "
          f"{len(out) / dt:.3f} micrographs/s; programs {pipe.num_programs}")
    for name, t in profiling.timings().items():
        print(f"#   stage {name}: {t['count']} spans, mean {t['mean_ms']:.3f} ms, "
              f"total {t['total_s']:.3f} s")
    return out


def picks_of(scores, coords):
    return {tuple(int(v) for v in c): float(s) for s, c in zip(scores, coords)}


def run_pipeline(workdir: str):
    """The batched pipeline over 24 micrographs of three geometries on the
    card: host prep cold and warm, then device prep; returns the disk_max
    launches of the cold run and the files."""
    import numpy as np

    from topaz_tpu_torch.pipeline import MicrographPipeline, _image_shape

    t0 = time.perf_counter()
    paths = write_micrographs(workdir, np.random.default_rng(SEED), GEOMETRIES,
                              FILES_PER_GEOMETRY)
    print(f"# pipeline: wrote {len(paths)} MRCs {GEOMETRIES} in "
          f"{time.perf_counter() - t0:.3f} s")
    kw = dict(model="resnet8_u32", denoise_model="unet", scale=8, radius=RADIUS,
              threshold=THRESHOLD, num_workers=2)
    os.environ["TOPAZ_TIMINGS"] = "1"  # stage times a batch include the device's
    try:
        host = MicrographPipeline(host_downsample=True, **kw)
        reset_launches()
        cold = run_pipeline_pass(host, paths, "host prep, cold")
        launches = read_launches("pipeline")
        warm = run_pipeline_pass(host, paths, "host prep, warm")
        device = MicrographPipeline(host_downsample=False, **kw)
        run_pipeline_pass(device, paths, "device prep, cold")
        dev = run_pipeline_pass(device, paths, "device prep, warm")
    finally:
        del os.environ["TOPAZ_TIMINGS"]
    n_batches = sum(-(-FILES_PER_GEOMETRY * n // BATCH) for n in (2, 1))
    print(f"# pipeline: disk_max launches in the cold run {launches}, gmm_em "
          f"{GMM_LAUNCHES['pipeline']} ({n_batches} batches of {BATCH}), unet_edges "
          f"{UNET_EDGE_LAUNCHES['pipeline']}")
    require_edge_launches("pipeline")
    if launches < 3 * n_batches or launches % 3:
        fail(f"pipeline: disk_max launched {launches} times for {n_batches} batches")
    if GMM_LAUNCHES["pipeline"] != n_batches:
        fail(f"pipeline: gmm_em launched {GMM_LAUNCHES['pipeline']} times for "
             f"{n_batches} batches (one fit a batch)")
    if host.num_programs != {"main": 2, "prep": 0} or device.num_programs["main"] != 2:
        fail(f"pipeline programs: host {host.num_programs}, device {device.num_programs}")

    counts, prep_err = [], 0.0
    for path in paths:
        if path not in cold or path not in warm or path not in dev:
            fail(f"pipeline: {path} did not come back")
        h, w = _image_shape(path)
        scores, coords, den = warm[path]
        counts.append(len(scores))
        if not len(scores) or np.any(np.diff(scores) > 0):
            fail(f"pipeline: {path}: {len(scores)} picks, scores non-increasing "
                 f"{bool(np.all(np.diff(scores) <= 0))}")
        if den.shape != (int(h / 8), int(w / 8)) or not np.isfinite(den).all():
            fail(f"pipeline: {path}: denoised shape {den.shape}, finite "
                 f"{np.isfinite(den).all()}")
        if not np.array_equal(coords, cold[path][1]):
            fail(f"pipeline: {path}: warm picks differ from cold picks")
        prep_err = max(prep_err, compare_picks(picks_of(*dev[path][:2]),
                                               picks_of(scores, coords), tie=PIPELINE_TOL, relative=True,
                                               labels=("device prep", "host prep")))
    print(f"# pipeline: picks a file {counts}; device vs host prep matched scores "
          f"max diff {prep_err} x max(1, |score|)")
    if prep_err > PIPELINE_TOL:
        fail(f"pipeline device vs host prep: scores differ by {prep_err}")
    return launches, paths, dev


def hold_pipeline(paths, dev):
    """One file a geometry: the device-prep pipeline's picks against the
    port's per-image path on the card; then the pipeline on the card
    against the CPU at batch 2."""
    import numpy as np
    import torch

    from topaz_tpu_torch.io.image import load_image
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.ops.fourier import downsample
    from topaz_tpu_torch.ops.gmm import normalize
    from topaz_tpu_torch.ops.nms import non_maximum_suppression
    from topaz_tpu_torch.pipeline import MicrographPipeline

    some = paths[:len(GEOMETRIES)]
    picker = load_picker("resnet8_u32", device="cuda")
    err = 0.0
    for path in some:
        small = downsample(load_image(path), 8, device="cuda").cpu().numpy()
        x, _ = normalize(small, sample=1, device="cuda")
        with torch.inference_mode():
            score = picker(torch.from_numpy(x).cuda()[None])[0]
        s, c = non_maximum_suppression(score, RADIUS, threshold=THRESHOLD, device="cuda")
        err = max(err, compare_picks(picks_of(*dev[path][:2]), picks_of(s, c),
                                     tie=PIPELINE_TOL, relative=True, labels=("pipeline", "per-image")))
    print(f"# pipeline vs per-image path on the card ({len(some)} files): matched "
          f"scores max diff {err} x max(1, |score|)")
    if err > PIPELINE_TOL:
        fail(f"pipeline vs per-image: scores differ by {err}")

    kw = dict(model="resnet8_u32", denoise_model="unet", scale=8, radius=RADIUS,
              threshold=THRESHOLD, host_downsample=True, num_workers=2)
    card = run_pipeline_pass(MicrographPipeline(**kw), some, "card, batch 2", batch_size=2)
    cpu = run_pipeline_pass(MicrographPipeline(device="cpu", **kw), some, "cpu, batch 2",
                            batch_size=2)
    err, den_err = 0.0, 0.0
    for path in some:
        err = max(err, compare_picks(picks_of(*card[path][:2]), picks_of(*cpu[path][:2]),
                                     tie=PIPELINE_TOL, relative=True))
        a, b = card[path][2], cpu[path][2]
        den_err = max(den_err, float(np.abs(a.astype(np.float64) - b).max() / b.std()))
    print(f"# pipeline card vs cpu: matched scores max diff {err} x max(1, |score|), "
          f"denoised max abs diff {den_err:.3e} x std")
    if err > 1e-3 or den_err > 1e-3:
        fail(f"pipeline card vs cpu: scores {err}, denoised {den_err} x std")


def run_batched_cli(workdir: str, paths):
    """``normalize -s 8 --batch-size 8`` and ``extract --batch-size 8`` on
    the card, three files held against the ``--batch-size 1`` CLI."""
    import numpy as np

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc

    def run(tag, batch, files, sample):
        proc = os.path.join(workdir, f"proc_{tag}")
        picks = os.path.join(workdir, f"picks_{tag}.txt")
        t0 = time.perf_counter()
        cli(["normalize", "-s", "8", "--batch-size", str(batch), "-o", proc, "-d", "0"]
            + sample + files)
        t1 = time.perf_counter()
        cli(["extract", "-m", "resnet8_u32", "-r", str(RADIUS), "-t", str(THRESHOLD),
             "--batch-size", str(batch), "-o", picks, "-d", "0"]
            + [os.path.join(proc, os.path.basename(p)) for p in files])
        t2 = time.perf_counter()
        print(f"# CLI {tag} ({len(files)} files): normalize {t1 - t0:.3f} s, "
              f"extract {t2 - t1:.3f} s")
        return proc, read_table(picks)

    proc8, table8 = run("batch8", BATCH, paths, [])
    some = paths[:len(GEOMETRIES)]
    proc1, table1 = run("batch1", 1, some, ["--sample", "1"])
    if sorted(table8) != sorted(os.path.splitext(os.path.basename(p))[0] for p in paths):
        fail(f"batched extract: {len(table8)} of {len(paths)} micrographs have picks")
    img_err, err = 0.0, 0.0
    for path in some:
        name = os.path.basename(path)
        a = mrc.read(os.path.join(proc8, name))[0]
        b = mrc.read(os.path.join(proc1, name))[0]
        if a.shape != b.shape:
            fail(f"batched normalize {name}: shape {a.shape}, per-image {b.shape}")
        img_err = max(img_err, float(np.abs(a.astype(np.float64) - b).max()))
        stem = os.path.splitext(name)[0]
        err = max(err, compare_picks(table8[stem], table1[stem], tie=PIPELINE_TOL, relative=True,
                                     labels=("batch 8", "batch 1")))
    print(f"# CLI batch 8 vs batch 1 ({len(some)} files): normalized max abs diff "
          f"{img_err}, matched pick scores max diff {err} x max(1, |score|)")
    if img_err > 1e-3 or err > 1e-3:
        fail(f"batched CLI: normalized {img_err}, scores {err}")


def read_table(path):
    """{image_name: {(x, y): score}} of an extract table."""
    picks = {}
    with open(path) as f:
        next(f)
        for line in f:
            name, x, y, s = line.rstrip("\n").split("\t")
            picks.setdefault(name, {})[(int(x), int(y))] = float(s)
    return picks


def write_training_set(workdir: str, n_train: int = TRAIN_FILES, n_test: int = TEST_FILES,
                       size: int = SIZE, n_particles: int = TRAIN_PARTICLES,
                       n_labeled: int = TRAIN_LABELED, device: str = "0"):
    """Synthetic ``size``^2 micrographs (``make_ctf_micrograph``, seed SEED +
    100 + i, ``n_particles`` each), normalized by ``normalize -s 8
    --batch-size 8``, with image lists and coordinate files of the centers
    / 8. The training files label the first ``n_labeled`` particles of each
    micrograph (positive-unlabeled, so that ``-n n_particles`` gives pi above
    the observed fraction and GE-binomial stays GE-binomial); the test
    files label all, and ``all_targets`` holds every particle of every
    micrograph."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    raw = os.path.join(workdir, "train_raw")
    os.makedirs(raw)

    def make(i):
        x, centers = make_ctf_micrograph(np.random.default_rng(SEED + 100 + i), size=size,
                                         n_particles=n_particles)
        path = os.path.join(raw, f"mic{i:02d}.mrc")
        mrc.write(path, x)
        return path, centers

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        made = list(ex.map(make, range(n_train + n_test)))
    t1 = time.perf_counter()
    proc = os.path.join(workdir, "train_proc")
    cli(["normalize", "-s", "8", "--batch-size", "8", "-o", proc, "-d", device]
        + [p for p, _ in made])
    print(f"# training set: {len(made)} micrographs {size}^2 written in {t1 - t0:.3f} s, "
          f"normalized (-s 8 --batch-size 8) in {time.perf_counter() - t1:.3f} s; "
          f"particles a micrograph {[len(c) for _, c in made]}")
    files = {"all_targets": os.path.join(workdir, "all_targets.txt")}
    with open(files["all_targets"], "w") as f:
        print("image_name\tx_coord\ty_coord", file=f)
        for path, centers in made:
            name = os.path.splitext(os.path.basename(path))[0]
            for y, x in centers:
                print(f"{name}\t{round(x / 8)}\t{round(y / 8)}", file=f)
    for split, part, labeled in (("train", made[:n_train], n_labeled),
                                 ("test", made[n_train:], n_particles)):
        images = os.path.join(workdir, f"{split}_images.txt")
        targets = os.path.join(workdir, f"{split}_targets.txt")
        with open(images, "w") as fi, open(targets, "w") as ft:
            print("image_name\tpath", file=fi)
            print("image_name\tx_coord\ty_coord", file=ft)
            for path, centers in part:
                name = os.path.splitext(os.path.basename(path))[0]
                print(f"{name}\t{os.path.join(proc, name + '.mrc')}", file=fi)
                for y, x in centers[:labeled]:
                    print(f"{name}\t{round(x / 8)}\t{round(y / 8)}", file=ft)
        files[split] = (images, targets)
    return files


def read_log(path):
    """(header, rows) of a training log; '-' cells are None."""
    with open(path) as f:
        lines = f.read().strip().split("\n")
    rows = [[None if v == "-" else (float(v) if i > 2 else v)
             for i, v in enumerate(line.split("\t"))] for line in lines[1:]]
    return lines[0].split("\t"), rows


def check_log(path, n_train_rows: int, tag: str):
    """Every number of a training log finite, and the train row count."""
    header, rows = read_log(path)
    train = [r for r in rows if r[2] == "train"]
    bad = [r for r in rows for v in r[3:] if v is not None and not math.isfinite(v)]
    if len(train) != n_train_rows or bad:
        fail(f"{tag}: {len(train)} train rows (expected {n_train_rows}), not finite: {bad[:3]}")
    return header, rows


def train_step_flops(spec, batch: int) -> int:
    """FLOPs of one train step on ``batch`` crops of the receptive field:
    2 k^dims cin cout a pixel (voxel) for every convolution of the strided
    forward at the size it runs (VALID; resnet skip projections, the 1x1
    head), and twice that for the backward, less the first convolution's
    input gradient. Pooling, batchnorm, activations and the update are left
    out."""
    from topaz_tpu_torch.models.layers import ConvSpec, PoolSpec, ResidSpec

    d = spec.dims
    n, total, first = spec.width, 0, None
    for s in spec.features:
        if isinstance(s, ConvSpec):
            out = (n - (s.kernel - 1) * s.dilation - 1) // s.stride + 1
            f = 2 * s.kernel ** d * s.nin * s.nout * out ** d
            first = f if first is None else first
        elif isinstance(s, ResidSpec):
            h = n - 2
            out = (h - 2 * s.dilation - 1) // s.stride + 1
            f = 2 * 3 ** d * (s.nin * s.nhidden * h ** d + s.nhidden * s.nout * out ** d)
            if s.nin != s.nout:
                f += 2 * s.nin * s.nout * out ** d
            first = f if first is None else first
        elif isinstance(s, PoolSpec):
            out, f = (n + 2 * s.padding - s.kernel) // s.stride + 1, 0
        else:
            continue
        total, n = total + f, out
    total += 2 * spec.latent_dim * n ** d
    return batch * (3 * total - first)


def generator_flops(depth: int, ngf: int, nin: int, batch: int) -> int:
    """FLOPs of the autoencoder's decoder in one train step on ``batch``
    latents of ``nin`` channels: each transposed convolution scatters 2 k^2
    cin cout a pixel of its input; the backward doubles it (the latent's
    gradient flows on into the picker), so 3x the forward. Batchnorm and
    activations are left out."""
    from topaz_tpu_torch.models.generative import layer_spec_for

    widths = [nin] + [ngf * 2 ** depth // 2 ** i for i in range(depth + 1)] + [1]
    n, total = 1, 0
    for (k, stride, pad), cin, cout in zip(layer_spec_for(depth), widths[:-1], widths[1:]):
        total += 2 * k * k * cin * cout * n * n
        n = (n - 1) * stride - 2 * pad + k
    return 3 * batch * total


def device_busy(prof, span: str, count: int = 1):
    """(busy, wall, {name: time}) in us within the last profiler span
    ``span`` of a torch.profiler trace that holds ``count`` of them: busy is
    the union of the device's kernel, copy and memset intervals (the
    device-side copies of the ``record_function`` spans and the
    synchronization records, which span whole windows and waits, are left
    out)."""
    import torch

    windows = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.name == span and e.device_type == torch.autograd.DeviceType.CPU)
    if len(windows) != count:
        fail(f"profiler: {len(windows)} spans named {span}, expected {count}")
    w0, w1 = windows[-1]
    spans = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
             and getattr(e, "is_user_annotation", False)} | {span}
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in spans and "sync" not in e.name.lower()
              and e.time_range.end > w0 and e.time_range.start < w1]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    busy, end = 0.0, w0
    for a, b in sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                       for e in events):
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    return busy, w1 - w0, by_name


def run_training(workdir: str, files, epoch_size: int = 100, device: str = "0"):
    """``train`` with the CLI defaults (resnet8, units 32, pretrained
    resnet8_u32, GE-binomial, batch 256) for 2 epochs on the card, test
    split, checkpoints and log; then ``extract`` with the epoch-2
    checkpoint on the test micrographs. Returns the disk_max launches of
    the training and of the extract run, the run's argument list and its
    checkpoint prefix."""
    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io.coordinates import read_coordinates
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.training import evaluate_model
    from topaz_tpu_torch.utils import profiling

    dev = "cpu" if device == "cpu" else "cuda"
    (train_images, train_targets), (test_images, test_targets) = files["train"], files["test"]
    with open(test_images) as f:
        test_paths = [line.split("\t")[1].strip() for line in list(f)[1:]]
    auprc0 = evaluate_model(load_picker("resnet8_u32", device=dev), test_paths,
                            read_coordinates(test_targets), radius=3)[4]
    print(f"# train: test AUPRC of the pretrained resnet8_u32 before training {auprc0}")

    prefix = os.path.join(workdir, "train", "model")
    log = os.path.join(workdir, "train", "log.tsv")
    argv = ["train", "--train-images", train_images, "--train-targets", train_targets,
            "--test-images", test_images, "--test-targets", test_targets,
            "-n", str(TRAIN_PARTICLES), "-r", "3", "--num-epochs", "2",
            "--epoch-size", str(epoch_size), "-d", device]
    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    cli(argv + ["--save-prefix", prefix, "-o", log])
    wall = time.perf_counter() - t0
    train_launches = read_launches("train")
    epochs = profiling.samples("train_epoch")
    evals = profiling.samples("train_evaluate")
    print(f"# train: 2 epochs of {epoch_size} steps, batch 256, in {wall:.3f} s; epoch wall "
          f"{', '.join(f'{t:.3f}' for t in epochs)} s, test evaluation "
          f"{', '.join(f'{t:.3f}' for t in evals)} s; warm epoch {epoch_size / epochs[-1]:.3f} "
          f"steps/s, {256 * epoch_size / epochs[-1]:.1f} crops/s; disk_max launches "
          f"{train_launches}")
    header, rows = check_log(log, 2 * epoch_size, "train")
    tests = [r for r in rows if r[2] == "test"]
    auprc = tests[-1][header.index("auprc")]
    print(f"# train: method columns {header[3:]}; test rows {tests}")
    if "ge_penalty" not in header:
        fail(f"train: GE-binomial fell back to PN (header {header})")
    if not auprc > auprc0:
        fail(f"train: test AUPRC after epoch 2 {auprc} does not exceed {auprc0} before training")
    if train_launches:
        fail(f"train: the training path launched disk_max {train_launches} times")

    ckpt = prefix + "_epoch2.npz"
    model = load_picker(ckpt, device=dev)
    if model.spec.width != 71 or dict(model.spec.config)["units"] != 32:
        fail(f"train: checkpoint {ckpt} holds {model.spec}")

    picks = os.path.join(workdir, "train", "picks.txt")
    reset_launches()
    t0 = time.perf_counter()
    cli(["extract", "-m", ckpt, "-r", str(RADIUS), "-t", str(THRESHOLD), "-o", picks,
         "-d", device] + test_paths)
    extract_launches = read_launches("train_extract")
    table = read_table(picks)
    counts = [len(table.get(os.path.splitext(os.path.basename(p))[0], {})) for p in test_paths]
    print(f"# train_extract: extract -m {os.path.basename(ckpt)} -r {RADIUS} -t {THRESHOLD} on "
          f"{len(test_paths)} test micrographs in {time.perf_counter() - t0:.3f} s: picks a "
          f"micrograph {counts}, disk_max launches {extract_launches}")
    if min(counts) < 1 or (device != "cpu" and extract_launches < 3 * len(test_paths)):
        fail(f"train_extract: picks {counts}, disk_max launches {extract_launches}")
    return train_launches, extract_launches, argv, prefix, epochs[-1]


def time_training(workdir: str, files, argv, prefix: str, epoch_s: float, epoch_size: int = 100):
    """On the card: a warm third epoch (``--resume``) under torch.profiler
    for the device's idle share; the sampler alone a batch; one train step
    alone (CUDA events, the host's queueing time, the device's busy time)
    beside the step's FLOP bound, and, for comparison only, with
    cudnn.benchmark on."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io.coordinates import read_coordinates
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.train.data import CropSampler
    from topaz_tpu_torch.train.methods import make_loss_fn
    from topaz_tpu_torch.train.trainer import init_train_state, make_train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli(argv[:argv.index("--num-epochs")] + argv[argv.index("--num-epochs") + 2:]
            + ["--num-epochs", "3", "--resume", prefix + "_train_state.npz",
               "--save-prefix", prefix + "_resumed", "-o", prefix + "_resumed.tsv"])
    busy_us, wall_us, by_name = device_busy(prof, "train_epoch")
    idle = 1 - busy_us / wall_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    check_log(prefix + "_resumed.tsv", epoch_size, "train, resumed epoch 3")

    (train_images, train_targets) = files["train"]
    with open(train_images) as f:
        paths = [line.split("\t")[1].strip() for line in list(f)[1:]]
    sampler = CropSampler(paths, read_coordinates(train_targets), 71, radius=3, seed=1)
    for _ in range(3):
        sampler.sample_batch(256, 16)
    t0 = time.perf_counter()
    for _ in range(20):
        sampler.sample_batch(256, 256)
    gather_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        crops, labels = sampler.sample_batch(256, int(sampler.rng.binomial(256, 0.0625)))
    sample_ms = (time.perf_counter() - t0) / 20 * 1e3

    model = load_picker("resnet8_u32", device="cuda")
    state = init_train_state(model, 0.0155)
    step = make_train_step(make_loss_fn("GE-binomial", 0.0155)[0])
    x, y = torch.from_numpy(crops).cuda(), torch.from_numpy(labels).cuda()
    step_ms = cuda_ms(lambda: step(state, x, y), iters=20, warmup=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step(state, x, y)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("train_steps"):
            for _ in range(20):
                step(state, x, y)
            torch.cuda.synchronize()
    step_busy_us = device_busy(prof, "train_steps")[0] / 20
    try:  # for comparison only: the port leaves cudnn.benchmark off
        torch.backends.cudnn.benchmark = True
        bench_ms = cuda_ms(lambda: step(state, x, y), iters=20, warmup=5)
    finally:
        torch.backends.cudnn.benchmark = False
    flops = train_step_flops(model.spec, 256)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    est_idle = 1 - epoch_size * step_busy_us / 1e3 / (epoch_s * 1e3)
    print(f"# train: sampler alone {sample_ms:.3f} ms a batch of 256 (host, native gather; "
          f"{gather_ms:.3f} ms with no negatives to draw); train step alone {step_ms:.3f} ms a "
          f"step (CUDA events around 20 eager steps), host {host_ms:.3f} ms a step to queue, "
          f"device busy {step_busy_us / 1e3:.3f} ms a step (torch.profiler, 20 steps); "
          f"bound {bound_ms:.3f} ms ({flops / 1e9:.3f} GFLOP at {F32_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s), {bound_ms / (step_busy_us / 1e3):.3f} of the device time; for "
          f"comparison only, with cudnn.benchmark on {bench_ms:.3f} ms a step")
    print(f"# train: warm epoch under torch.profiler (resumed epoch 3, whose host also "
          f"records the profile): wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / epoch_size:.3f} ms a step), idle share "
          f"{idle:.4f}; 1 - steps x step alone / epoch wall of epoch 2: {est_idle:.4f}; "
          f"device time by name (ms): {[(n[:60], round(t / 1e3, 3)) for n, t in top]}")
    if not (0 <= idle <= 1 and step_ms > 0 and np.isfinite(sample_ms)):
        fail(f"train timings: idle {idle}, step {step_ms} ms, sampler {sample_ms} ms")


def train_card_vs_cpu(workdir: str, argv, tag: str, n_rows: int = 5,
                      strict_rows: int = 5):
    """The training command ``argv`` (one epoch of ``n_rows`` steps, no test
    split) on the card and on the CPU: the samplers draw the same crops, so
    the first ``strict_rows`` train rows agree column by column within
    TRAIN_TOL, and the others within TRAIN_DRIFT_TOL."""
    from topaz_tpu_torch.cli.main import main as cli

    logs = {}
    for device in ("0", "cpu"):
        logs[device] = os.path.join(workdir, f"{tag}_{device}.tsv")
        t0 = time.perf_counter()
        cli(argv + ["-d", device, "-o", logs[device]])
        print(f"# {tag} card vs cpu: -d {device} took {time.perf_counter() - t0:.3f} s")
    header, card = check_log(logs["0"], n_rows, f"{tag} on the card")
    _, cpu = check_log(logs["cpu"], n_rows, f"{tag} on the cpu")
    worst, by_row = {}, []
    for a, b in zip(card, cpu):
        diffs = [abs(u - v) / max(abs(v), TRAIN_TOL_FLOOR) for u, v in zip(a[3:-1], b[3:-1])]
        by_row.append(max(diffs))
        for name, d in zip(header[3:-1], diffs):
            worst[name] = max(worst.get(name, 0.0), d)
    print(f"# {tag} card vs cpu, {n_rows} rows: largest difference a column, in units of "
          f"max(|cpu|, {TRAIN_TOL_FLOOR}): {worst}; a row: {[f'{d:.3e}' for d in by_row]}")
    if max(by_row[:strict_rows]) > TRAIN_TOL or max(by_row) > TRAIN_DRIFT_TOL:
        fail(f"{tag} card vs cpu: rows differ by {by_row} (tolerance {TRAIN_TOL} for the "
             f"first {strict_rows}, {TRAIN_DRIFT_TOL} for all)")


def train_bn(workdir: str, files, device: str = "0"):
    """``--no-pretrained --bn on`` for one epoch of 20 steps: finite rows,
    and batchnorm's running statistics moved from their start (0, 1)."""
    import numpy as np

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.models.factory import load_picker, picker_to_numpy

    (train_images, train_targets) = files["train"]
    prefix = os.path.join(workdir, "train_bn", "model")
    log = prefix + ".tsv"
    t0 = time.perf_counter()
    cli(["train", "--train-images", train_images, "--train-targets", train_targets,
         "-n", str(TRAIN_PARTICLES), "-r", "3", "--num-epochs", "1", "--epoch-size", "20",
         "--no-pretrained", "--bn", "on", "-d", device, "--save-prefix", prefix, "-o", log])
    check_log(log, 20, "train --no-pretrained --bn on")
    _, state = picker_to_numpy(load_picker(prefix + "_epoch1.npz", device="cpu"))
    moved = [min(float(np.abs(s["mean"]).max()), float(np.abs(s["var"] - 1).max()))
             for layer in state["features"].values() for s in layer.values()]
    print(f"# train --no-pretrained --bn on, 20 steps in {time.perf_counter() - t0:.3f} s: "
          f"{len(moved)} batchnorms, smallest move of their running statistics {min(moved)}")
    if not moved or min(moved) <= 0:
        fail(f"train --bn on: running statistics did not move ({moved})")


def cli_captured(argv):
    """The port's CLI with stdout and stderr captured: (stdout, stderr).
    The epoch rows are echoed as comment lines."""
    from topaz_tpu_torch.cli.main import main as cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli(argv)
    for line in out.getvalue().replace("\r", "\n").splitlines():
        if line.strip():
            print(f"#   | {line}")
    return out.getvalue(), err.getvalue()


def denoise_rows(text):
    """(train, val, best val) loss of each epoch row of a training run."""
    rows = [line.split("\t") for line in text.replace("\r", "\n").split("\n")
            if line.startswith("# [")]
    return [[float(v) for v in r[1:]] for r in rows]


def rows_diff(card, cpu, tag: str) -> float:
    """Largest difference of two runs' rows, relative to the CPU's value."""
    if len(card) != len(cpu) or not card:
        fail(f"{tag}: {len(card)} card rows, {len(cpu)} cpu rows")
    return max(abs(a - b) / max(abs(b), 1e-12) for ra, rb in zip(card, cpu)
               for a, b in zip(ra, rb))


def write_denoise_pairs(workdir: str, n: int, size: int, tag: str):
    """``n`` noise2noise pairs of ``size``^2 in ``<tag>_A/`` and ``<tag>_B/``
    (one clean ``make_ctf_micrograph`` image a pair, seed SEED + 200 + i,
    plus two independent Gaussian draws of twice its std) and one held-out
    noisy micrograph; returns (dir A, dir B, held-out path, its clean image)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    dirs = [os.path.join(workdir, f"{tag}_{half}") for half in "AB"]
    for d in dirs:
        os.makedirs(d)

    def make(i):
        rng = np.random.default_rng(SEED + 200 + i)
        clean, _ = make_ctf_micrograph(rng, size=size, n_particles=size // 64, white=0.0,
                                       pink=0.0)
        sigma = 2 * float(clean.std())
        noisy = [clean + rng.standard_normal(clean.shape, dtype=np.float32) * sigma
                 for _ in dirs]
        if i == n:  # the held-out micrograph
            path = os.path.join(workdir, f"{tag}_heldout.mrc")
            mrc.write(path, noisy[0])
            return path, clean
        for d, x in zip(dirs, noisy):
            mrc.write(os.path.join(d, f"mic{i:02d}.mrc"), x)
        return None

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        heldout, clean = list(ex.map(make, range(n + 1)))[-1]
    print(f"# {tag}: {n} pairs of {size}^2 and a held-out micrograph written in "
          f"{time.perf_counter() - t0:.3f} s")
    return dirs[0], dirs[1], heldout, clean


def check_denoiser_checkpoints(prefix: str, dims: int):
    """Every ``<prefix>_epoch*.npz`` loads in the port with ``arch_layout``'s
    keys and shapes; returns their names."""
    import glob

    from topaz_tpu_torch.models.denoise import arch_layout
    from topaz_tpu_torch.models.denoise_factory import denoiser_to_numpy, load_denoiser

    paths = sorted(glob.glob(prefix + "_epoch*.npz"))
    if not paths:
        fail(f"no checkpoint {prefix}_epoch*.npz")
    for path in paths:
        meta, params = denoiser_to_numpy(load_denoiser(path, device="cpu"))
        layout = arch_layout(meta["arch"], meta["nf"], meta["base_width"], meta["top_width"])
        got = {(m, i): params[m][i]["w"].shape for m in params for i in params[m]}
        want = {(m, i): (k,) * dims + (cin, cout) for m, convs in layout.items()
                for i, (k, cin, cout) in convs.items()}
        if got != want or meta["dims"] != dims:
            fail(f"{path}: meta {meta}, shapes differ from arch_layout")
    return [os.path.basename(p) for p in paths]


def run_denoise_train(workdir: str):
    """Phase 9: ``denoise -a -b`` at full width on 12 pairs of 4096^2, its
    gates and timings; card against CPU on 4 pairs of 1024^2. Returns the
    disk_max launches of the training run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from topaz_tpu_torch.denoise import (Denoise, make_denoise_optimizer, make_denoise_step)
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.train.denoise_data import make_paired_images_samplers
    from topaz_tpu_torch.utils import profiling

    dir_a, dir_b, heldout, clean = write_denoise_pairs(workdir, DENOISE_PAIRS, SIZE, "n2n")
    x = mrc.read(heldout)[0]
    before = Denoise("unet", device="cuda").denoise(x, 1024, 500).cpu().numpy()

    prefix, out = os.path.join(workdir, "n2n", "P"), os.path.join(workdir, "n2n", "out")
    epochs, steps = 6, -(-(DENOISE_PAIRS - int(0.1 * DENOISE_PAIRS)) // 4)
    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    text, _ = cli_captured(["denoise", "-a", dir_a, "-b", dir_b, "--arch", "unet", "-c", "800",
                            "--batch-size", "4", "--num-epochs", str(epochs), "--save-prefix",
                            prefix, "-d", "0", "-o", out, heldout])
    wall = time.perf_counter() - t0
    launches = read_launches("denoise_train")
    rows = denoise_rows(text)
    walls = profiling.samples("denoise_train_epoch")
    if len(rows) != epochs or not all(math.isfinite(v) for r in rows for v in r):
        fail(f"denoise training: rows {rows}")
    names = check_denoiser_checkpoints(prefix, dims=2)
    y = mrc.read(os.path.join(out, os.path.basename(heldout)))[0]
    if y.shape != x.shape or not np.isfinite(y).all() or np.array_equal(y, x):
        fail(f"denoise after training: shape {y.shape}, finite {np.isfinite(y).all()}")
    if launches:
        fail(f"denoise training launched disk_max {launches} times")
    warm = sum(walls[1:]) / len(walls[1:])
    mse = {k: float(np.mean((v.astype(np.float64) - clean) ** 2))
           for k, v in (("input", x), ("bundled unet", before), ("trained", y))}
    print(f"# denoise train: {epochs} epochs of {steps} steps (batch 4 of 800^2) in {wall:.3f} s "
          f"(data read and standardized in epoch 1); epoch wall "
          f"{', '.join(f'{t:.3f}' for t in walls)} s; warm {steps / warm:.3f} steps/s, "
          f"{4 * steps / warm:.3f} crops/s (epoch wall with its validation batch); "
          f"checkpoints {names}; disk_max launches {launches}")
    print(f"# denoise train: mean squared error to the clean image (information only): "
          f"{mse}")

    # one step alone, its bound and peak memory
    den = Denoise("unet", device="cuda")
    step = make_denoise_step(den.model, make_denoise_optimizer(den.model))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    src = torch.randn((4, 800, 800), device="cuda", generator=g)
    tgt = src + torch.randn((4, 800, 800), device="cuda", generator=g)
    step(src, tgt, 2.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(src, tgt, 2.0), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    flops = denoise_step_flops((800, 800), den.meta, 4)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    print(f"# denoise train step alone (unet nf {den.meta['nf']}, 4 x 800^2, L2, adagrad): "
          f"{step_ms:.3f} ms a step (CUDA events, 10 steps); bound {bound_ms:.3f} ms "
          f"({flops / 1e12:.4f} TFLOP at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s), "
          f"{bound_ms / step_ms:.3f} of it; peak memory {peak / 2**30:.3f} GiB")
    del den, step, src, tgt

    # the device's idle share of a warm epoch: the trained model, the
    # samplers' file cache filled first
    train_s, val_s = make_paired_images_samplers(dir_a, dir_b, crop=800)
    for _ in train_s.batches(4):
        pass
    for _ in val_s.batches(4):
        pass
    den = Denoise(os.path.join(os.path.dirname(prefix), names[-1]), device="cuda")
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            den.train(train_s, val_s, batch_size=4, num_epochs=1)
    busy_us, wall_us, by_name = device_busy(prof, "denoise_train_epoch")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"# denoise train: warm epoch under torch.profiler ({steps} steps and the "
          f"validation batch): wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.4f}; device time by name (ms): "
          f"{[(n[:60], round(t / 1e3, 3)) for n, t in top]}")

    # card against CPU
    a, b, small, _ = write_denoise_pairs(workdir, 4, SIZE // 4, "n2n_small")
    rows = {}
    for device in ("0", "cpu"):
        t0 = time.perf_counter()
        text, _ = cli_captured(["denoise", "-a", a, "-b", b, "--arch", "unet", "-c", "128",
                                "--batch-size", "4", "--num-epochs", "2", "-d", device])
        rows[device] = denoise_rows(text)
        print(f"# denoise train card vs cpu: -d {device} took {time.perf_counter() - t0:.3f} s")
    diff = rows_diff(rows["0"], rows["cpu"], "denoise train card vs cpu")
    print(f"# denoise train card vs cpu, 2 rows of {SIZE // 4}^2 pairs at -c 128: largest "
          f"difference {diff:.3e} of the cpu value (tolerance {DENOISE_TRAIN_TOL})")
    if diff > DENOISE_TRAIN_TOL:
        fail(f"denoise train card vs cpu: rows differ by {diff}")
    return launches


def write_tomograms(workdir: str, shape, tag: str, n_blobs: int = 400, seed: int = SEED + 300):
    """An even/odd pair of synthetic tomograms of ``shape``: random
    Gaussian blobs (radius 3-10 voxels, from ``seed``) plus independent
    unit noise in each half; returns ((even path, odd path), the blobs'
    centres as (z, y, x) rows)."""
    import numpy as np

    from topaz_tpu_torch.io import mrc

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    clean = np.zeros(shape, np.float32)
    centers = []
    for _ in range(n_blobs):
        r = rng.uniform(3, 10)
        w = int(2 * r)
        c = [int(rng.integers(0, n)) for n in shape]
        centers.append(c)
        sl = tuple(slice(max(0, ci - w), min(n, ci + w + 1)) for ci, n in zip(c, shape))
        grid = np.ogrid[tuple(slice(s.start - ci, s.stop - ci) for s, ci in zip(sl, c))]
        clean[sl] += 2.0 * np.exp(-sum(gi.astype(np.float32) ** 2 for gi in grid) / (2 * r * r))
    paths = []
    for half in ("even", "odd"):
        paths.append(os.path.join(workdir, f"{tag}_{half}.mrc"))
        mrc.write(paths[-1], clean + rng.standard_normal(shape, dtype=np.float32))
    print(f"# {tag}: even/odd tomograms {shape} written in {time.perf_counter() - t0:.3f} s")
    return paths, np.array(centers)


def run_denoise3d(workdir: str):
    """Phase 10: ``denoise3d -a -b`` at full width, then tomogram denoising
    on both routes; card against CPU on a 64^3 pair. Returns the disk_max
    launches of the phase's training and denoising."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from topaz_tpu_torch.denoise import Denoise3D, make_denoise_optimizer, make_denoise_step
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models.denoise import arch_layout
    from topaz_tpu_torch.utils import profiling

    (even, odd), _ = write_tomograms(workdir, TOMO_SHAPE, "tomo")
    prefix, out = os.path.join(workdir, "tomo", "P3"), os.path.join(workdir, "tomo", "out")
    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    text, _ = cli_captured(["denoise3d", "-a", even, "-b", odd, "-c", "96", "--N-train", "40",
                            "--N-test", "10", "--batch-size", "10", "--num-epochs", "2",
                            "--save-prefix", prefix, "-d", "0"])
    train_wall = time.perf_counter() - t0
    rows = denoise_rows(text)
    if len(rows) != 2 or not all(math.isfinite(v) for r in rows for v in r):
        fail(f"denoise3d training: rows {rows}")
    names = check_denoiser_checkpoints(prefix, dims=3)
    walls = profiling.samples("denoise_train_epoch")
    print(f"# denoise3d train: 2 epochs of 4 steps (batch 10 of 96^3) in {train_wall:.3f} s; "
          f"epoch wall {', '.join(f'{t:.3f}' for t in walls)} s; checkpoints {names}")

    tomo = mrc.read(even)[0]
    voxels = tomo.size
    ckpt = prefix + "_epoch2.npz"
    results = {}
    for tag, flags in (("defaults -s 96 -p 48", ["-s", "96", "-p", "48"]),
                       ("--auto-patch", ["--auto-patch"])):
        outdir = os.path.join(out, tag.split()[0].strip("-"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, err = cli_captured(["denoise3d", "-m", ckpt, "-o", outdir, "-d", "0", even] + flags)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        y = mrc.read(os.path.join(outdir, os.path.basename(even)))[0]
        resident = [line for line in err.splitlines() if "device-resident" in line]
        print(f"# denoise3d {tag}: {dt:.3f} s for {TOMO_SHAPE}, {voxels / dt:.4e} voxels/s; "
              f"route {resident[0].lstrip('# ') if resident else 'streaming'}; "
              f"peak memory {peak / 2**30:.3f} GiB")
        if not resident or "OOM" in err:
            fail(f"denoise3d {tag}: the resident route did not run to its end:\n{err[-2000:]}")
        if y.shape != tomo.shape or not np.isfinite(y).all() or np.array_equal(y, tomo):
            fail(f"denoise3d {tag}: shape {y.shape}, finite {np.isfinite(y).all()}")
        results[tag] = y
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli_captured(["denoise3d", "-m", ckpt, "-o", os.path.join(out, "profiled"), "-d", "0",
                      even])
    busy_us, wall_us, _ = device_busy(prof, "denoise3d_volume")
    print(f"# denoise3d defaults, warm, under torch.profiler: volume wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}")
    launches = read_launches("denoise3d")
    print(f"# denoise3d: unet_edges launches {UNET_EDGE_LAUNCHES['denoise3d']} (training "
          f"takes the modules' route, denoising the fused one)")
    if launches:
        fail(f"denoise3d launched disk_max {launches} times")
    require_edge_launches("denoise3d")

    den = Denoise3D(ckpt, device="cuda")
    resident = results["defaults -s 96 -p 48"]
    for batch in (1, 4):
        t0 = time.perf_counter()
        y = den.denoise(tomo, 96, 48, batch_size=batch, verbose=False, device_resident=False)
        dt = time.perf_counter() - t0
        err = float(np.abs(y.astype(np.float64) - resident).max() / resident.std())
        print(f"# denoise3d streaming route, batch {batch}: {dt:.3f} s, {voxels / dt:.4e} "
              f"voxels/s; against the resident route max abs diff {err:.3e} x std")
        if den.last_route != "streaming" or err > 1e-4:
            fail(f"denoise3d streaming batch {batch}: {err} x std from the resident route")

    # the train step and one 192^3 patch's forward alone, against their bounds
    meta = den.meta
    layout = arch_layout(meta["arch"], meta["nf"], meta["base_width"], meta["top_width"])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    patch = torch.randn((1, 1, 192, 192, 192), device="cuda", generator=g)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = cuda_ms(lambda: den.model(patch), iters=3, warmup=1)
        fwd_peak = torch.cuda.max_memory_allocated()
    fwd_flops = unet_flops((192,) * 3, layout)
    fwd_bound = fwd_flops / F32_OPS_PER_S * 1e3
    train = Denoise3D.from_arch("unet", device="cuda")
    step = make_denoise_step(train.model, make_denoise_optimizer(train.model))
    src = torch.randn((10, 96, 96, 96), device="cuda", generator=g)
    tgt = src + torch.randn((10, 96, 96, 96), device="cuda", generator=g)
    step(src, tgt, 2.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(src, tgt, 2.0), iters=3, warmup=1)
    step_peak = torch.cuda.max_memory_allocated()
    step_flops = denoise_step_flops((96,) * 3, meta, 10)
    step_bound = step_flops / F32_OPS_PER_S * 1e3
    print(f"# denoise3d forward of one 192^3 patch alone: {fwd_ms:.3f} ms (CUDA events, 3 "
          f"calls); bound {fwd_bound:.3f} ms ({fwd_flops / 1e12:.4f} TFLOP at "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s), {fwd_bound / fwd_ms:.3f} of it; peak memory "
          f"{fwd_peak / 2**30:.3f} GiB")
    print(f"# denoise3d train step alone (unet nf {meta['nf']}, 10 x 96^3, L2, adagrad): "
          f"{step_ms:.3f} ms (CUDA events, 3 steps); bound {step_bound:.3f} ms "
          f"({step_flops / 1e12:.4f} TFLOP), {step_bound / step_ms:.3f} of it; peak memory "
          f"{step_peak / 2**30:.3f} GiB")
    del train, step, src, tgt, patch, den

    # card against CPU on a 64^3 pair at full width
    (e64, o64), _ = write_tomograms(workdir, (64, 64, 64), "tomo64", n_blobs=8)
    rows, ys = {}, {}
    for device in ("0", "cpu"):
        t0 = time.perf_counter()
        text, _ = cli_captured(["denoise3d", "-a", e64, "-b", o64, "-c", "32", "--N-train", "4",
                                "--N-test", "2", "--batch-size", "2", "--num-epochs", "1",
                                "--save-prefix", os.path.join(workdir, f"t64_{device}", "P"),
                                "-d", device])
        rows[device] = denoise_rows(text)
        outdir = os.path.join(workdir, f"t64_{device}", "out")
        cli_captured(["denoise3d", "-m", os.path.join(workdir, "t64_0", "P_epoch1.npz"),
                      "-s", "32", "-p", "16", "-o", outdir, "-d", device, e64])
        ys[device] = mrc.read(os.path.join(outdir, os.path.basename(e64)))[0]
        print(f"# denoise3d card vs cpu: -d {device} took {time.perf_counter() - t0:.3f} s")
    diff = rows_diff(rows["0"], rows["cpu"], "denoise3d card vs cpu")
    err = float(np.abs(ys["0"].astype(np.float64) - ys["cpu"]).max() / ys["cpu"].std())
    print(f"# denoise3d card vs cpu, 64^3: rows largest difference {diff:.3e} of the cpu value "
          f"(tolerance {DENOISE_TRAIN_TOL}); -s 32 -p 16 denoised max abs diff {err:.3e} x std")
    if diff > DENOISE_TRAIN_TOL or err > 1e-3:
        fail(f"denoise3d card vs cpu: rows {diff}, denoised {err} x std")
    return launches


def picker_dense_flops(spec, window) -> int:
    """FLOPs of one dense (filled) picker forward on one VALID window of
    ``window`` (the tile plus its halo): 2 k^dims cin cout a voxel for
    every convolution at the size it runs (stride 1, dilation times the
    accumulated stride; resnet skip projections; the 1x1 head). Pooling,
    batchnorm and activations are left out."""
    from topaz_tpu_torch.models.layers import ConvSpec, PoolSpec, ResidSpec

    dims, n, acc, total = len(window), list(window), 1, 0
    for s in spec.features:
        if isinstance(s, ConvSpec):
            n = [m - (s.kernel - 1) * s.dilation * acc for m in n]
            total += 2 * s.kernel ** dims * s.nin * s.nout * math.prod(n)
        elif isinstance(s, ResidSpec):
            n = [m - 2 * acc for m in n]
            total += 2 * 3 ** dims * s.nin * s.nhidden * math.prod(n)
            n = [m - 2 * s.dilation * acc for m in n]
            total += 2 * 3 ** dims * s.nhidden * s.nout * math.prod(n)
            if s.nin != s.nout:
                total += 2 * s.nin * s.nout * math.prod(n)
        elif isinstance(s, PoolSpec):
            n = [m + 2 * s.padding * acc - (s.kernel - 1) * acc for m in n]
        else:
            continue
        acc *= s.stride
    return total + 2 * spec.latent_dim * math.prod(n)


def validation_lines(text):
    """{radius: (auprc, rmse, recall, targets)} of extract's '# radius=' lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# radius="):
            f = dict(kv.split("=") for kv in line[2:].split(", "))
            out[int(f["radius"])] = (float(f["auprc"]), float(f["rmse"]), int(f["recall"]),
                                     int(f["targets"]))
    return out


def compare_files(a_path, b_path, tol, tag):
    """Two pick files of the same format token by token: numbers with a
    '.' or an exponent (the scores) within ``tol`` x max(1, |b|), every
    other token equal. Returns the largest score difference."""
    import re

    with open(a_path) as f, open(b_path) as g:
        a, b = f.read(), g.read()
    split = re.compile(r"([\t,:{}\"\n\[\] ]+)")
    ta, tb = split.split(a), split.split(b)
    if len(ta) != len(tb):
        fail(f"{tag}: {len(ta)} tokens against {len(tb)}")
    worst = 0.0
    for x, y in zip(ta, tb):
        if x == y:
            continue
        try:
            if not any(c in y for c in ".eE"):
                raise ValueError
            d = abs(float(x) - float(y)) / max(1.0, abs(float(y)))
        except ValueError:
            fail(f"{tag}: token {x!r} against {y!r}")
        worst = max(worst, d)
        if d > tol:
            fail(f"{tag}: score {x} against {y}")
    return worst


def run_extract_targets(workdir: str, files):
    """Phase 11: ``extract -m resnet8_u32 --targets`` with the CLI's radius
    grid (5..100 step 5) over the training phase's 16 normalized 512^2
    micrographs, every planted particle a target; then ``-r <found>
    --only-validate``; card against CPU at four radii; ``--per-micrograph``
    in the five formats and ``--patch-size 128``, card against CPU or
    whole-image scoring. Returns the disk_max launches of the grid run and
    the r = 100 kernel timing."""
    import torch

    from topaz_tpu_torch import extract as ex
    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io.coordinates import read_coordinates
    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops import nms

    proc = os.path.join(workdir, "train_proc")
    paths = sorted(os.path.join(proc, n) for n in os.listdir(proc) if n.endswith(".mrc"))
    targets = files["all_targets"]
    table = read_coordinates(targets)
    print(f"# extract_targets: {len(paths)} micrographs, {len(table)} targets")

    # one record a radius, through the module's own entry points
    records, match_s = [], [0.0]
    auprc_fn, match_fn = ex.extract_auprc, ex.match_coordinates

    def timed_match(*a, **k):
        t0 = time.perf_counter()
        out = match_fn(*a, **k)
        match_s[0] += time.perf_counter() - t0
        return out

    def recorded(targets_, scores, radius, *a, **k):
        torch.cuda.synchronize()
        launches, rounds, matching = dm.launches, nms.rounds, match_s[0]
        t0 = time.perf_counter()
        out = auprc_fn(targets_, scores, radius, *a, **k)
        torch.cuda.synchronize()
        records.append({"radius": radius, "ms": (time.perf_counter() - t0) * 1e3,
                        "match_ms": (match_s[0] - matching) * 1e3,
                        "launches": dm.launches - launches, "rounds": nms.rounds - rounds,
                        "devices": sorted({str(s.device) for s in scores.values()}),
                        "auprc": out[0], "rmse": out[1], "recall": out[2], "targets": out[3]})
        return out

    ex.extract_auprc, ex.match_coordinates = recorded, timed_match
    try:
        picks = os.path.join(workdir, "picks_targets.txt")
        reset_launches()
        nms.rounds = nms.uploads = 0
        t0 = time.perf_counter()
        text, err = cli_captured(["extract", "-m", "resnet8_u32", "-t", str(THRESHOLD),
                                  "--targets", targets, "-o", picks, "-d", "0"] + paths)
        wall = time.perf_counter() - t0
        launches, map_uploads = read_launches("extract_targets"), nms.uploads
        grid = list(records)
        records.clear()
        found = max(grid, key=lambda r: (r["auprc"], -r["radius"]))["radius"]
        val_out = os.path.join(workdir, "picks_validate.txt")
        text_v, _ = cli_captured(["extract", "-m", "resnet8_u32", "-t", str(THRESHOLD),
                                  "--targets", targets, "-r", str(found), "--only-validate",
                                  "-o", val_out, "-d", "0"] + paths)
    finally:
        ex.extract_auprc, ex.match_coordinates = auprc_fn, match_fn

    for r in grid:
        print(f"# extract_targets r={r['radius']:3d}: auprc {r['auprc']:.6f}, rmse "
              f"{r['rmse']:.4f}, recall {r['recall']}/{r['targets']}, wall {r['ms']:.3f} ms "
              f"(matching {r['match_ms']:.3f} ms), greedy rounds {r['rounds']}, disk_max "
              f"launches {r['launches']}")
    total_ms = sum(r["ms"] for r in grid)
    print(f"# extract_targets: grid of {len(grid)} radii {total_ms:.3f} ms (matching "
          f"{sum(r['match_ms'] for r in grid):.3f} ms); CLI wall {wall:.3f} s; found radius "
          f"{found}; disk_max launches {launches}; score maps uploaded again by NMS "
          f"{map_uploads}")
    lines = validation_lines(text)
    if [r["radius"] for r in grid] != list(range(5, 101, 5)) or sorted(lines) != list(
            range(5, 101, 5)):
        fail(f"extract_targets: radii run {[r['radius'] for r in grid]}, lines {sorted(lines)}")
    card = str(ex.resolve_device(0))
    for r in grid:
        if r["rounds"] < 1 or r["launches"] != 3 * r["rounds"] or r["devices"] != [card]:
            fail(f"extract_targets r={r['radius']}: {r['launches']} disk_max launches for "
                 f"{r['rounds']} rounds, maps on {r['devices']}")
        if r["targets"] != len(table) or not 0 <= r["auprc"] <= 1:
            fail(f"extract_targets r={r['radius']}: {r}")
    if map_uploads:
        fail(f"extract_targets: NMS uploaded {map_uploads} score maps again")
    if f"Optimal radius found: {found} " not in err:
        fail(f"extract_targets: the CLI did not report radius {found}:\n{err[-500:]}")
    grid_picks = read_table(picks)
    if sum(len(v) for v in grid_picks.values()) < len(paths):
        fail(f"extract_targets: {sum(len(v) for v in grid_picks.values())} picks at r={found}")
    val = validation_lines(text_v)
    at_found = next(r for r in grid if r["radius"] == found)
    if list(val) != [found] or abs(val[found][0] - at_found["auprc"]) > 1e-3 or os.path.exists(
            val_out):
        fail(f"extract_targets --only-validate: lines {val}, grid {at_found}")

    # the grid's last and costliest radius, 100, at the maps' shape
    r100 = time_disk_max((SIZE // 8, SIZE // 8), torch.Generator(device="cuda").manual_seed(SEED),
                         r=100, calls=20)

    # card against CPU on 4 micrographs at 4 radii
    some = paths[:4]
    maps = {dev: dict((ex.image_name(p), s) for p, s in ex.score_images(
        "resnet8_u32", some, device=dev)) for dev in ("cuda", "cpu")}
    score_err = max(float(((maps["cuda"][n].cpu() - maps["cpu"][n]).abs()
                           / maps["cpu"][n].abs().clamp(min=1)).max()) for n in maps["cpu"])
    print(f"# extract_targets card vs cpu, {len(some)} score maps: max diff {score_err:.3e} x "
          f"max(1, |score|)")
    if score_err > PIPELINE_TOL:
        fail(f"extract_targets card vs cpu: scores differ by {score_err}")
    for r in (5, 15, 50, 100):
        t0 = time.perf_counter()
        card = ex.extract_auprc(table, maps["cuda"], r, THRESHOLD, device="cuda")
        t1 = time.perf_counter()
        cpu = ex.extract_auprc(table, maps["cpu"], r, THRESHOLD, device="cpu")
        t2 = time.perf_counter()
        err = 0.0
        for n in maps["cpu"]:
            a = picks_of(*nms.non_maximum_suppression(maps["cuda"][n], r, THRESHOLD, "cuda"))
            b = picks_of(*nms.non_maximum_suppression(maps["cpu"][n], r, THRESHOLD, "cpu"))
            err = max(err, compare_picks(a, b, tie=PIPELINE_TOL, relative=True, radius=r))
        print(f"# extract_targets card vs cpu r={r}: auprc {card[0]:.6f} / {cpu[0]:.6f}, recall "
              f"{card[2]} / {cpu[2]}, matched pick scores max diff {err:.3e} x max(1, |score|); "
              f"{(t1 - t0) * 1e3:.3f} / {(t2 - t1) * 1e3:.3f} ms")
        if abs(card[0] - cpu[0]) > 1e-3 or err > PIPELINE_TOL:
            fail(f"extract_targets card vs cpu r={r}: auprc {card[0]} / {cpu[0]}, scores {err}")

    # --per-micrograph in every format, card against CPU
    worst = 0.0
    for fmt in ("coord", "star", "box", "json", "csv"):
        for device in ("0", "cpu"):
            out = os.path.join(workdir, f"per_micrograph_{device}", fmt)
            os.makedirs(out)
            cli(["extract", "-m", "resnet8_u32", "-t", str(THRESHOLD), "-r", str(found),
                 "--per-micrograph", "--suffix", "_topaz", "--format", fmt, "-o", out,
                 "-d", device] + some)
        for p in some:
            name = f"{ex.image_name(p)}_topaz.{fmt}"
            worst = max(worst, compare_files(
                os.path.join(workdir, "per_micrograph_0", fmt, name),
                os.path.join(workdir, "per_micrograph_cpu", fmt, name), PIPELINE_TOL,
                f"--per-micrograph {name}"))
    print(f"# extract_targets --per-micrograph coord/star/box/json/csv, {len(some)} files each: "
          f"card equal to cpu but the scores, max diff {worst:.3e} x max(1, |score|)")

    # --patch-size 128 against whole-image scoring on the card
    patched = dict((ex.image_name(p), s) for p, s in ex.score_images(
        "resnet8_u32", some, patch_size=128, device="cuda"))
    patch_err = max(float(((patched[n] - maps["cuda"][n]).abs()
                           / maps["cuda"][n].abs().clamp(min=1)).max()) for n in patched)
    out = os.path.join(workdir, "picks_p128.txt")
    t0 = time.perf_counter()
    cli(["extract", "-m", "resnet8_u32", "-t", str(THRESHOLD), "-r", str(found), "-p", "128",
         "-o", out, "-d", "0"] + paths)
    dt = time.perf_counter() - t0
    p128 = read_table(out)
    err = max(compare_picks(p128.get(n, {}), grid_picks.get(n, {}), tie=PIPELINE_TOL,
                            relative=True, radius=found, labels=("-p 128", "whole"))
              for n in set(p128) | set(grid_picks))
    print(f"# extract_targets -p 128: score maps against whole-image scoring max diff "
          f"{patch_err:.3e} x max(1, |score|); CLI on {len(paths)} micrographs {dt:.3f} s, "
          f"matched pick scores max diff {err:.3e}")
    if patch_err > PIPELINE_TOL or err > PIPELINE_TOL:
        fail(f"extract_targets -p 128: maps {patch_err}, picks {err}")
    return launches, {"r": 100, "shape": [SIZE // 8, SIZE // 8], **r100}


def time_phase_convs(model=None, window: int = 166, reps: int = 5):
    """One tile's dilated convolutions (the 3D resnet8 at units 32 on a
    ``window``^3 window, batch 1, as ``extract3d`` scores it) each timed
    both ways with CUDA events, the mean of ``reps`` calls: direct
    (``F.conv3d`` at its dilation) and on the phase route
    (``layers.phase_conv3d``), with the phase route's split and merge
    copies alone, the rate each reaches of the f32 peak, the kernels that
    take most of each route's device time (torch.profiler), the largest
    difference of the two outputs relative to the output's largest value
    and the route ``conv_nd`` takes. Returns the rows."""
    import torch
    import torch.nn.functional as F

    from topaz_tpu_torch.models import layers
    from topaz_tpu_torch.models.factory import new_picker

    if model is None:
        model = new_picker("resnet8", units=32, bn=True, dims=3, seed=SEED, device="cuda")
    calls, direct = [], layers.conv_nd

    def record(x, w, b=None, stride=1, dilation=1):
        if dilation > 1:
            calls.append((x, w, b, dilation))
        return direct(x, w, b, stride=stride, dilation=dilation)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    layers.conv_nd = record
    try:
        with torch.inference_mode():
            model(torch.randn((1,) + (window,) * 3, device="cuda", generator=g), pad=False)
    finally:
        layers.conv_nd = direct

    def top_kernels(fn):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        total = sum(t for t, _ in rows) or 1
        return [f"{name[:90]} {t / total:.2f}" for t, name in rows[:2]]

    out_rows, total = [], {"direct": 0.0, "phase": 0.0, "copies": 0.0, "routed": 0.0}
    with torch.inference_mode():
        for i, (x, w, b, d) in enumerate(calls):
            want = F.conv3d(x, w, b, dilation=d)
            got = layers.phase_conv3d(x, w, b, d)
            err = float((got - want).abs().max() / want.abs().max())
            n, c = x.shape[:2]
            q = [-(-s // d) for s in x.shape[2:]]
            xs = x.new_zeros((n, d, d, d, c, *q))
            ys = F.conv3d(xs.view(n * d ** 3, c, *q), w, b)
            ys = ys.view(n, d, d, d, *ys.shape[1:])
            y = torch.empty_like(want)
            ms = {"direct": cuda_ms(lambda: F.conv3d(x, w, b, dilation=d), reps, warmup=1),
                  "phase": cuda_ms(lambda: layers.phase_conv3d(x, w, b, d), reps, warmup=1),
                  "split": cuda_ms(lambda: layers._phase_copy(x, xs, d, split=True), reps, warmup=1),
                  "merge": cuda_ms(lambda: layers._phase_copy(y, ys, d, split=False), reps, warmup=1)}
            flops = 2 * w[0].numel() * w.shape[0] * want[0, 0].numel() * n
            kernels = {k: top_kernels(fn) for k, fn in (
                ("direct", lambda: F.conv3d(x, w, b, dilation=d)),
                ("phase", lambda: layers.phase_conv3d(x, w, b, d)))}
            row = {"conv": i, "cin": c, "cout": w.shape[0], "k": w.shape[2], "d": d,
                   "in": list(x.shape[2:]), "tflop": flops / 1e12, "ms": ms,
                   "peak_share": {k: flops / (ms[k] * 1e-3) / F32_OPS_PER_S
                                  for k in ("direct", "phase")},
                   "kernels": kernels, "max_rel_diff": err,
                   "route": "phase" if layers.phase_route(x, w, b, 1, d) else "direct"}
            out_rows.append(row)
            total["direct"] += ms["direct"]
            total["phase"] += ms["phase"]
            total["copies"] += ms["split"] + ms["merge"]
            total["routed"] += ms[row["route"]]
            print(f"# phase conv {i} ({row['route']} route): {c}->{w.shape[0]} k{w.shape[2]} d{d} "
                  f"in {tuple(x.shape[2:])}: "
                  f"direct {ms['direct']:.3f} ms ({row['peak_share']['direct']:.3f} of peak), "
                  f"phase {ms['phase']:.3f} ms ({row['peak_share']['phase']:.3f}; split "
                  f"{ms['split']:.3f}, merge {ms['merge']:.3f}), max rel diff {err:.2e}; "
                  f"direct {kernels['direct']}; phase {kernels['phase']}")
            del xs, ys, y, want, got
    print(f"# dilated convs of one {window}^3 tile: all direct {total['direct']:.3f} ms, all on "
          f"phases {total['phase']:.3f} ms ({total['copies']:.3f} of it split and merge copies), "
          f"each on its route {total['routed']:.3f} ms")
    return out_rows


def run_extract3d(workdir: str):
    """Phase 12: a 3D resnet8 at units 32 (random weights from a seed) saved
    as .npz and run by ``extract --dims 3`` on a 192 x 384 x 384 tomogram
    of planted blobs: one tile's dilated convolutions timed direct and on
    the phase route (``time_phase_convs``), dense scoring (32 tiles of
    166^3) alone against its FLOP bound, failing unless it ran convolutions
    on the phase route (``layers.phase_convs``), ``extract.pick_volume`` (the CLI's path; its sphere-max NMS
    from its span) against NMS of the scored map, the CLI against
    ``pick_volume``'s picks; card against CPU on one
    tile's volume, ``--targets --only-validate`` included. Returns the
    disk_max launches of the phase (the 3D path has no TPU kernel)."""
    import numpy as np
    import torch

    from topaz_tpu_torch import extract as ex
    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models import layers
    from topaz_tpu_torch.models.factory import new_picker, save_picker
    from topaz_tpu_torch.models.tiling import classify_patches_3d
    from topaz_tpu_torch.ops import nms
    from topaz_tpu_torch.utils import profiling

    (tomo, _), centers = write_tomograms(workdir, TOMO_SHAPE, "pick3d")
    model = new_picker("resnet8", units=32, dims=3, seed=SEED, device="cuda")
    ckpt = os.path.join(workdir, "picker3d.npz")
    save_picker(ckpt, model)
    time_phase_convs(model)
    reset_launches()
    phase_convs = layers.phase_convs

    vol = mrc.read(tomo)[0]
    tile = 96
    window = tile + 2 * (model.spec.width // 2)
    tiles = math.prod(-(-n // tile) for n in vol.shape)
    flops = tiles * picker_dense_flops(model.spec, (window,) * 3)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    classify_patches_3d(model, vol[:tile, :tile, :tile])  # cuDNN's first call at this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    score = classify_patches_3d(model, vol)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    print(f"# extract3d dense scoring {TOMO_SHAPE} ({tiles} tiles of {window}^3, batch 1): wall "
          f"{wall_ms:.3f} ms, device {device_ms:.3f} ms (CUDA events); bound {bound_ms:.3f} ms "
          f"({flops / 1e12:.4f} TFLOP at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s), "
          f"{bound_ms / device_ms:.3f} of it; peak memory {peak / 2**30:.3f} GiB")
    if tuple(score.shape) != vol.shape or not bool(torch.isfinite(score).all()):
        fail(f"extract3d: score map {tuple(score.shape)}, finite {bool(torch.isfinite(score).all())}")
    phase_convs = layers.phase_convs - phase_convs
    print(f"# extract3d dense scoring: {phase_convs} phase convolutions "
          f"({phase_convs / (tiles + 1):.1f} a tile), direct dilated ones counted "
          f"{layers.direct_dilated_convs} in this process")
    if not phase_convs:
        fail("extract3d: the card's 3D dense scoring ran no convolution on the phase route")

    # a threshold that keeps the top 1/1000 of the voxels active
    threshold = float(torch.topk(score.reshape(-1), score.numel() // 1000).values[-1])
    rounds = nms.rounds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, c = ex.pick_volume(model, vol, 8, threshold)  # the path extract --dims 3 takes
    pick_ms = (time.perf_counter() - t0) * 1e3
    nms_ms = profiling.samples("extract3d/nms")[-1] * 1e3
    print(f"# extract3d pick_volume r=8: {pick_ms:.3f} ms, of it the sphere-max NMS "
          f"{nms_ms:.3f} ms (its span, synchronised each round), {nms.rounds - rounds} greedy "
          f"rounds, {len(s)} picks above {threshold!r}")
    s_map, c_map = nms.non_maximum_suppression_3d(score, 8, threshold=threshold, device="cuda")
    if not (np.array_equal(s, s_map) and np.array_equal(c, c_map)):
        fail(f"extract3d: pick_volume's {len(s)} picks differ from NMS of the scored map's "
             f"{len(s_map)}")

    picks = os.path.join(workdir, "picks3d.txt")
    t0 = time.perf_counter()
    cli(["extract", "--dims", "3", "-m", ckpt, "-r", "8", "-t", repr(threshold), "-o", picks,
         "-d", "0", tomo])
    dt = time.perf_counter() - t0
    with open(picks) as f:
        header = next(f).rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    got = {tuple(int(v) for v in r[1:4]): float(r[4]) for r in rows}
    err = compare_picks(got, picks_of(s, c), tie=PIPELINE_TOL, relative=True, radius=8,
                        threshold=threshold, labels=("CLI", "pick_volume"))
    print(f"# extract3d: extract --dims 3 -r 8 CLI {dt:.3f} s, {len(rows)} picks; against "
          f"pick_volume's max score diff {err:.3e}")
    in_range = all(0 <= x < vol.shape[2] and 0 <= y < vol.shape[1] and 0 <= z < vol.shape[0]
                   for x, y, z in got)
    if (header != ["image_name", "x_coord", "y_coord", "z_coord", "score"] or not rows
            or not in_range or not all(math.isfinite(v) for v in got.values())):
        fail(f"extract3d: header {header}, {len(rows)} picks, coordinates in range {in_range}")

    # card against CPU on one tile's volume
    crop = os.path.join(workdir, "crop.mrc")
    mrc.write(crop, np.ascontiguousarray(vol[:48, :96, :96]))
    crop_targets = os.path.join(workdir, "crop_targets.txt")
    with open(crop_targets, "w") as f:
        print("image_name\tx_coord\ty_coord\tz_coord", file=f)
        for z, y, x in centers:
            if z < 48 and y < 96 and x < 96:
                print(f"crop\t{x}\t{y}\t{z}", file=f)
    maps, vals = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        maps[device] = next(ex.score_images(ckpt, [crop], device=device))[1]
        text, _ = cli_captured(["extract", "--dims", "3", "-m", ckpt, "-r", "8", "-t",
                                repr(threshold), "--targets", crop_targets, "--only-validate",
                                "-d", "0" if device == "cuda" else "cpu", crop])
        vals[device] = validation_lines(text)[8]
        print(f"# extract3d card vs cpu: {device} scoring and --only-validate "
              f"{time.perf_counter() - t0:.3f} s")
    a, b = maps["cuda"].cpu(), maps["cpu"]
    score_err = float(((a - b).abs() / b.abs().clamp(min=1)).max())
    pick_err = compare_picks(
        picks_of(*nms.non_maximum_suppression_3d(maps["cuda"], 8, threshold=threshold)),
        picks_of(*nms.non_maximum_suppression_3d(b, 8, threshold=threshold, device="cpu")),
        tie=PIPELINE_TOL, relative=True, radius=8, threshold=threshold)
    print(f"# extract3d card vs cpu, 48 x 96 x 96: scores max diff {score_err:.3e} x max(1, "
          f"|score|), matched picks {pick_err:.3e}; --targets --only-validate auprc "
          f"{vals['cuda'][0]:.6f} / {vals['cpu'][0]:.6f} ({vals['cpu'][3]} targets)")
    if score_err > PIPELINE_TOL or pick_err > PIPELINE_TOL or abs(
            vals["cuda"][0] - vals["cpu"][0]) > 1e-3 or vals["cuda"][3] < 1:
        fail(f"extract3d card vs cpu: scores {score_err}, picks {pick_err}, validation {vals}")
    launches = read_launches("extract3d")
    if launches:
        fail(f"extract3d launched disk_max {launches} times (the 3D path has no TPU kernel)")
    return launches


def write_tomogram_split(workdir: str, split: str, seed: int, labeled: float):
    """One synthetic TOMO_SHAPE tomogram of 400 blobs from ``seed`` (the
    even half of ``write_tomograms``) with an image list and a target list
    of the first ``labeled`` fraction of its blobs, (x, y, z) voxels:
    ((images, targets), tomogram path, all blob centres (z, y, x),
    the labeled count)."""
    (tomo, _), centers = write_tomograms(workdir, TOMO_SHAPE, split, seed=seed)
    name = os.path.splitext(os.path.basename(tomo))[0]
    n_labeled = int(round(len(centers) * labeled))
    images = os.path.join(workdir, f"{split}_images.txt")
    targets = os.path.join(workdir, f"{split}_targets.txt")
    with open(images, "w") as fi, open(targets, "w") as ft:
        print(f"image_name\tpath\n{name}\t{tomo}", file=fi)
        print("image_name\tx_coord\ty_coord\tz_coord", file=ft)
        for z, y, x in centers[:n_labeled]:
            print(f"{name}\t{x}\t{y}\t{z}", file=ft)
    return (images, targets), tomo, centers, n_labeled


def validate3d(ckpt: str, targets: str, tomo: str) -> float:
    """AUPRC of ``extract --dims 3 -r 8 --targets --only-validate`` (the
    CLI's default threshold) with the picker ``ckpt`` on ``tomo``."""
    text, _ = cli_captured(["extract", "--dims", "3", "-r", "8", "-m", ckpt, "--targets",
                            targets, "--only-validate", "-d", "0", tomo])
    return validation_lines(text)[8][0]


def run_train3d(workdir: str):
    """Phase ``train3d``: ``train --dims 3 --augment-3d --no-pretrained`` at
    the CLI's width (resnet8, units 32, GE-binomial, batch TRAIN_BATCH) on a
    192 x 384 x 384 tomogram of 400 blobs, two thirds labeled, with a test
    tomogram of all 400 labeled, for 2 epochs of TRAIN3D_EPOCH_SIZE steps;
    the trained picker's validation AUPRC against the seed-0 random
    picker's; epoch 2's idle share (the run is under torch.profiler); the
    sampler, the window gather and one step alone, the peak memory; card
    against CPU without ``--augment-3d`` on a 48 x 96 x 96 crop
    (``TRAIN_STRICT_ROWS``). Returns the phase's disk_max
    launches (none: 3D training has no TPU kernel)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.io.coordinates import read_coordinates
    from topaz_tpu_torch.models.factory import load_picker, new_picker, save_picker
    from topaz_tpu_torch.train.data import CropSampler, ResidentVolumes
    from topaz_tpu_torch.train.methods import make_loss_fn
    from topaz_tpu_torch.train.trainer import init_train_state, make_train_step
    from topaz_tpu_torch.utils import profiling

    reset_launches()
    (train_images, train_targets), train_tomo, centers, n_labeled = write_tomogram_split(
        workdir, "train3d", SEED + 400, 2 / 3)
    (test_images, test_targets), test_tomo, _, _ = write_tomogram_split(
        workdir, "test3d", SEED + 401, 1.0)
    random_ckpt = os.path.join(workdir, "random3d.npz")
    save_picker(random_ckpt, new_picker("resnet8", units=32, dims=3, seed=SEED, device="cuda"))
    auprc0 = validate3d(random_ckpt, test_targets, test_tomo)

    prefix = os.path.join(workdir, "train3d", "model")
    log = prefix + ".tsv"
    epoch_size = TRAIN3D_EPOCH_SIZE
    argv = ["train", "--dims", "3", "--augment-3d", "--no-pretrained",
            "--train-images", train_images, "--train-targets", train_targets,
            "-n", str(len(centers)), "-r", "3", "--epoch-size", str(epoch_size), "-d", "0"]
    test_split = ["--test-images", test_images, "--test-targets", test_targets]
    profiling.reset()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli(argv + test_split + ["--num-epochs", "2", "--save-prefix", prefix, "-o", log])
    wall = time.perf_counter() - t0
    epochs = profiling.samples("train_epoch")
    evals = profiling.samples("train_evaluate")
    print(f"# train3d: 2 epochs of {epoch_size} steps, batch {TRAIN_BATCH}, {n_labeled} of "
          f"{len(centers)} blobs labeled, under torch.profiler, in {wall:.3f} s; epoch wall "
          f"{', '.join(f'{t:.3f}' for t in epochs)} s, test evaluation "
          f"{', '.join(f'{t:.3f}' for t in evals)} s; warm epoch {epoch_size / epochs[-1]:.3f} "
          f"steps/s, {TRAIN_BATCH * epoch_size / epochs[-1]:.1f} crops/s")
    header, rows = check_log(log, 2 * epoch_size, "train3d")
    print(f"# train3d: method columns {header[3:]}; test rows "
          f"{[r for r in rows if r[2] == 'test']}")
    ckpt = prefix + "_epoch2.npz"
    model = load_picker(ckpt, device="cuda")
    if (model.spec.dims, model.spec.width, dict(model.spec.config)["units"]) != (3, 71, 32):
        fail(f"train3d: checkpoint {ckpt} holds {model.spec}")
    auprc = validate3d(ckpt, test_targets, test_tomo)
    print(f"# train3d: extract --dims 3 -r 8 --targets --only-validate on the test tomogram: "
          f"AUPRC {auprc} trained, {auprc0} with the seed-{SEED} random picker")
    if not auprc > auprc0:
        fail(f"train3d: the trained picker's AUPRC {auprc} does not exceed the random "
             f"picker's {auprc0}")

    busy_us, wall_us, by_name = device_busy(prof, "train_epoch", count=2)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]

    # the sampler's draw, the JAX package's host gather, the windows cut on
    # the card, and one step alone
    sampler = CropSampler([train_tomo], read_coordinates(train_targets), 71, radius=3,
                          rotate=True, seed=1, dims=3)
    volumes = ResidentVolumes(sampler, "cuda")
    t0 = time.perf_counter()
    for _ in range(20):
        pos = sampler.sample_positions(TRAIN_BATCH, TRAIN_BATCH // 16)
    draw_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(2):
        host_crops, _ = sampler.sample_batch(TRAIN_BATCH, TRAIN_BATCH // 16)
    host_ms = (time.perf_counter() - t0) / 2 * 1e3
    gather_ms = cuda_ms(lambda: volumes.gather(*pos[:4]), iters=10)
    crops, labels = volumes.gather(*pos[:4]), torch.from_numpy(pos[4]).cuda()
    if not np.array_equal(crops.cpu().numpy(), sampler._gather_crops_3d(*pos[:4])):
        fail("train3d: the windows cut on the card differ from the host gather")
    del host_crops
    state = init_train_state(new_picker("resnet8", units=32, dims=3, seed=SEED, device="cuda"),
                             0.0006)
    step = make_train_step(make_loss_fn("GE-binomial", 0.0006)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, crops, labels), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    flops = train_step_flops(state.model.spec, TRAIN_BATCH)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, crops, labels)
        torch.cuda.synchronize()
    ops = [(e.key, round(e.self_device_time_total / 1e3, 3), e.input_shapes[:3])
           for e in sorted(prof.key_averages(group_by_input_shape=True),
                           key=lambda e: -e.self_device_time_total)[:3]]
    print(f"# train3d: sampler {draw_ms:.3f} ms a batch of {TRAIN_BATCH} to draw the positions "
          f"(host); "
          f"windows of {tuple(crops.shape[1:])} cut on the card from the resident tomogram "
          f"(the route training takes, {volumes.nbytes / 2**20:.1f} MiB on the card) "
          f"{gather_ms:.3f} ms a batch (CUDA events), the JAX package's host gather "
          f"{host_ms:.3f} ms a batch; one step alone (--augment-3d) {step_ms:.3f} ms (CUDA "
          f"events around 3 steps), bound {bound_ms:.3f} ms ({flops / 1e12:.4f} TFLOP at "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s), {bound_ms / step_ms:.3f} of it; peak memory "
          f"{peak / 2**30:.3f} GiB; the step's largest operators (device ms, input shapes): "
          f"{ops}")
    print(f"# train3d: warm epoch (epoch 2) under torch.profiler: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e3 / epoch_size:.3f} ms a step), idle share {1 - busy_us / wall_us:.4f}; "
          f"device time by name (ms): {[(n[:60], round(t / 1e3, 3)) for n, t in top]}")
    del state, crops, volumes
    torch.cuda.empty_cache()

    # card against CPU without --augment-3d on a 48 x 96 x 96 crop
    crop_dir = os.path.join(workdir, "crop3d")
    os.makedirs(crop_dir)
    mrc.write(os.path.join(crop_dir, "crop.mrc"),
              np.ascontiguousarray(mrc.read(train_tomo)[0][:48, :96, :96]))
    inside = [i for i, (z, y, x) in enumerate(centers) if z < 48 and y < 96 and x < 96]
    crop_targets = os.path.join(crop_dir, "targets.txt")
    with open(crop_targets, "w") as f:
        print("image_name\tx_coord\ty_coord\tz_coord", file=f)
        for i in inside:
            if i < n_labeled:
                z, y, x = centers[i]
                print(f"crop\t{x}\t{y}\t{z}", file=f)
    train_card_vs_cpu(workdir, [
        "train", "--dims", "3", "--no-pretrained", "--train-images", crop_dir,
        "--train-targets", crop_targets, "-n", str(len(inside)), "-r", "3",
        "--num-epochs", "1", "--epoch-size", "5", "--minibatch-size", "8"], "train3d",
        strict_rows=TRAIN_STRICT_ROWS)
    launches = read_launches("train3d")
    if launches:
        fail(f"train3d launched disk_max {launches} times (3D training has no TPU kernel)")
    return launches


def run_train_ae(workdir: str, files):
    """Phase ``train_ae``: ``train --autoencoder 1 --ngf 32`` from the
    bundled resnet8_u32 (CLI defaults otherwise; decoder of depth 3, width
    63) for 2 epochs of 50 steps on the training phase's micrographs, test
    split on; the reconstruction error must fall; one step alone against
    the picker's and the decoder's FLOP bound; card against CPU; then
    ``extract`` with its checkpoint and ``precision_recall_curve`` on the
    picks, whose AUPRC must equal ``extract --only-validate``'s within 1e-6.
    Returns the extract run's disk_max launches."""
    import numpy as np
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io.coordinates import read_coordinates
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.models.generative import init_generator
    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.train.data import CropSampler
    from topaz_tpu_torch.train.methods import make_loss_fn
    from topaz_tpu_torch.train.trainer import init_train_state, make_train_step
    from topaz_tpu_torch.utils import profiling

    (train_images, train_targets), (test_images, test_targets) = files["train"], files["test"]
    with open(test_images) as f:
        test_paths = [line.split("\t")[1].strip() for line in list(f)[1:]]
    prefix = os.path.join(workdir, "train_ae", "model")
    log = prefix + ".tsv"
    argv = ["train", "--train-images", train_images, "--train-targets", train_targets,
            "-n", str(TRAIN_PARTICLES), "-r", "3", "--autoencoder", "1", "--ngf", "32"]
    reset_launches()
    profiling.reset()
    t0 = time.perf_counter()
    epoch_size = TRAIN_AE_EPOCH_SIZE
    cli(argv + ["--test-images", test_images, "--test-targets", test_targets, "--num-epochs",
                "2", "--epoch-size", str(epoch_size), "-d", "0", "--save-prefix", prefix,
                "-o", log])
    wall = time.perf_counter() - t0
    epochs = profiling.samples("train_epoch")
    header, rows = check_log(log, 2 * epoch_size, "train_ae")
    recon = [r[header.index("recon_error")] for r in rows if r[2] == "train"]
    first, last = float(np.mean(recon[:10])), float(np.mean(recon[-10:]))
    print(f"# train_ae: 2 epochs of {epoch_size} steps, batch {TRAIN_BATCH}, in {wall:.3f} s; "
          f"epoch wall {', '.join(f'{t:.3f}' for t in epochs)} s; warm epoch "
          f"{epoch_size / epochs[-1]:.3f} steps/s, {TRAIN_BATCH * epoch_size / epochs[-1]:.1f} "
          f"crops/s; columns {header[3:]}; "
          f"recon_error mean of the "
          f"first 10 train rows {first}, of the last 10 {last}; test rows "
          f"{[r for r in rows if r[2] == 'test']}; disk_max launches {dm.launches}")
    if not last < first:
        fail(f"train_ae: recon_error did not fall ({first} -> {last})")
    if dm.launches:
        fail(f"train_ae: training launched disk_max {dm.launches} times")

    # one step alone against the picker's and the decoder's FLOPs
    with open(train_images) as f:
        paths = [line.split("\t")[1].strip() for line in list(f)[1:]]
    sampler = CropSampler(paths, read_coordinates(train_targets), 71, radius=3, seed=1)
    crops, labels = (torch.from_numpy(a).cuda()
                     for a in sampler.sample_batch(TRAIN_BATCH, TRAIN_BATCH // 16))
    model = load_picker("resnet8_u32", device="cuda")
    decoder = init_generator(model.spec.latent_dim, torch.Generator().manual_seed(1), units=32,
                             depth=3).cuda()
    state = init_train_state(model, 0.0155, decoder=decoder)
    step = make_train_step(make_loss_fn("GE-binomial", 0.0155)[0], autoencoder=1.0)
    step_ms = cuda_ms(lambda: step(state, crops, labels), iters=20, warmup=5)
    picker_flops = train_step_flops(model.spec, TRAIN_BATCH)
    decoder_flops = generator_flops(3, 32, model.spec.latent_dim, TRAIN_BATCH)
    flops = picker_flops + decoder_flops
    bound_ms = flops / F32_OPS_PER_S * 1e3
    print(f"# train_ae: one step alone {step_ms:.3f} ms (CUDA events around 20 eager steps), "
          f"bound {bound_ms:.3f} ms ({flops / 1e9:.3f} GFLOP: picker "
          f"{picker_flops / 1e9:.3f}, decoder {decoder_flops / 1e9:.3f}), "
          f"{bound_ms / step_ms:.3f} of it")

    train_card_vs_cpu(workdir, argv + ["--num-epochs", "1", "--epoch-size", "5",
                                       "--minibatch-size", "64"], "train_ae",
                      strict_rows=TRAIN_STRICT_ROWS)

    ckpt = prefix + "_epoch2.npz"
    picks = os.path.join(workdir, "train_ae", "picks.txt")
    reset_launches()
    cli(["extract", "-m", ckpt, "-r", str(RADIUS), "-t", str(THRESHOLD), "-o", picks,
         "-d", "0"] + test_paths)
    launches = read_launches("train_ae")
    text, _ = cli_captured(["precision_recall_curve", "--predicted", picks, "--targets",
                            test_targets, "-r", str(RADIUS)])
    prc = float(text.split("auprc=")[1].split(",")[0])
    text, _ = cli_captured(["extract", "-m", ckpt, "-r", str(RADIUS), "-t", str(THRESHOLD),
                            "--targets", test_targets, "--only-validate", "-d", "0"]
                           + test_paths)
    validated = validation_lines(text)[RADIUS][0]
    print(f"# train_ae: extract -m {os.path.basename(ckpt)} -r {RADIUS} -t {THRESHOLD} on "
          f"{len(test_paths)} test micrographs: {len(read_table(picks))} with picks, disk_max "
          f"launches {launches}; precision_recall_curve AUPRC {prc!r}, extract --only-validate "
          f"{validated!r}")
    if launches < 3 * len(test_paths) or abs(prc - validated) > 1e-6:
        fail(f"train_ae: launches {launches}, precision_recall_curve {prc} against "
             f"--only-validate {validated}")
    return launches


def write_k3_micrographs(workdir: str, n: int = K3_FILES, per: int = STACK_PARTICLES,
                         seed: int = SEED + 500):
    """``n`` unbinned micrographs of K3_SHAPE (f32 Gaussian noise with
    ``per`` planted particles each, a 3 sigma dip of radius ~24 px) in
    ``raw/``; returns their paths."""
    import numpy as np

    from topaz_tpu_torch.io import mrc

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(workdir, "raw"))
    w = 72
    yy, xx = np.mgrid[-w:w, -w:w].astype(np.float32)
    blob = 3.0 * np.exp(-(yy ** 2 + xx ** 2) / (2 * 24.0 ** 2))
    paths = []
    h, wd = K3_SHAPE
    for i in range(n):
        x = rng.standard_normal(K3_SHAPE, dtype=np.float32)
        for cy, cx in zip(rng.integers(w, h - w, size=per), rng.integers(w, wd - w, size=per)):
            x[cy - w:cy + w, cx - w:cx + w] -= blob
        paths.append(os.path.join(workdir, "raw", f"k3_{i}.mrc"))
        mrc.write(paths[-1], x)
    print(f"# tools: {n} micrographs {K3_SHAPE} written in {time.perf_counter() - t0:.3f} s")
    return paths


def read_table_rows(path):
    """(header, rows) of a tab-separated table."""
    with open(path) as f:
        header = next(f).rstrip("\n").split("\t")
        return header, [line.rstrip("\n").split("\t") for line in f if line.strip()]


def run_sav_extract(workdir: str, binned):
    """``extract -m <resnet16_u32 exported as .sav>`` against ``extract -m
    resnet16_u32`` on the binned micrographs: identical picks; the disk_max
    launches of the .sav run; the kernel bit-equal to its plain version on
    one of its score maps; the .sav load time. Returns (launches, the .sav
    run's pick table)."""
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.extract import score_images
    from topaz_tpu_torch.models.convert import export_picker_sav
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops.nms import NEG, disk_max as plain

    sav = os.path.join(workdir, "resnet16_u32.sav")
    t0 = time.perf_counter()
    export_picker_sav(sav, "resnet16_u32")
    export_s = time.perf_counter() - t0
    loads = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = load_picker(sav, device="cuda")
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0) * 1e3)
    print(f"# tools: resnet16_u32 exported as .sav in {export_s:.3f} s "
          f"({os.path.getsize(sav)} bytes); load_picker(.sav) onto the card "
          f"{loads[0]:.3f} ms cold, {loads[1]:.3f} / {loads[2]:.3f} ms warm")
    picks = {}
    for model_arg, tag in ((sav, "sav"), ("resnet16_u32", "alias")):
        picks[tag] = os.path.join(workdir, f"picks_{tag}.txt")
        if tag == "sav":
            reset_launches()
        t0 = time.perf_counter()
        cli(["extract", "-m", model_arg, "-r", str(RADIUS), "-t", str(THRESHOLD),
             "-o", picks[tag], "-d", "0"] + binned)
        torch.cuda.synchronize()
        if tag == "sav":
            launches = read_launches("sav_extract")
        print(f"# tools: extract -m {os.path.basename(model_arg)} on {len(binned)} binned "
              f"micrographs: {time.perf_counter() - t0:.3f} s")
    sav_rows, alias_rows = (read_table_rows(picks[t])[1] for t in ("sav", "alias"))
    if sav_rows != alias_rows or len(sav_rows) < len(binned):
        fail(f"extract -m .sav gave {len(sav_rows)} picks, -m resnet16_u32 {len(alias_rows)}; "
             f"identical: {sav_rows == alias_rows}")
    if launches < 3 * len(binned):
        fail(f"extract -m .sav launched disk_max {launches} times for {len(binned)} micrographs")
    print(f"# tools: extract -m .sav and -m resnet16_u32: {len(sav_rows)} picks, identical; "
          f"disk_max launches of the .sav run {launches}")
    _, score = next(score_images(sav, binned[:1], device="cuda"))
    got = dm.disk_max(score.contiguous(), RADIUS, NEG)
    want = plain(score.contiguous(), RADIUS, NEG)
    if not torch.equal(got, want):
        fail(f"disk_max on the .sav path's score map {tuple(score.shape)} differs from plain")
    print(f"# tools: disk_max on the .sav path's score map {tuple(score.shape)} r={RADIUS}: "
          f"bit-equal to the plain version")
    return launches, picks["sav"]


def run_segment(workdir: str, binned):
    """``segment -m resnet16_u32`` (the bundled resnet16 at full width) on the
    binned micrographs, whole and ``-p 256``; ms a micrograph and the share
    of its f32 bound; card maps against the port's CPU map of one
    micrograph; then one 192 x 384 x 384 tomogram with a 3D resnet8 at units
    32 (seed 0) through ``segment -p 48``, written as .npy. Without PIL on
    this machine the 2D maps come from the library function and the .tiff
    write is skipped."""
    import importlib.util

    import numpy as np
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models.factory import load_picker, new_picker, save_picker
    from topaz_tpu_torch.models.tiling import classify_patches_3d
    from topaz_tpu_torch.segment import score_maps

    have_pil = importlib.util.find_spec("PIL") is not None
    maps = {}
    for patch in (None, 256):
        tag = "whole" if patch is None else f"-p {patch}"
        out = os.path.join(workdir, f"seg_{'whole' if patch is None else patch}")
        argv = ["segment", "-m", "resnet16_u32", "-o", out, "-d", "0"] + (
            ["-p", str(patch)] if patch else [])
        walls = []
        for _ in range(2):  # cold, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if have_pil:
                cli(argv + binned)
                from PIL import Image

                got = {}
                for path in binned:
                    name = os.path.splitext(os.path.basename(path))[0]
                    with Image.open(os.path.join(out, name + ".tiff")) as im:
                        got[name] = np.array(im)
            else:
                got = {os.path.splitext(os.path.basename(p))[0]: m
                       for p, m in score_maps("resnet16_u32", binned, patch_size=patch,
                                              device="cuda")}
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / len(binned))
        maps[tag] = got
        print(f"# tools: segment {tag} ({'CLI, .tiff' if have_pil else 'library; no PIL on '
              'this machine, the .tiff write was skipped'}): {walls[0]:.3f} ms a micrograph "
              f"cold, {walls[1]:.3f} ms warm")
    # the dense forward alone against its bound
    model = load_picker("resnet16_u32", device="cuda")
    x = torch.from_numpy(np.array(mrc.read(binned[0])[0], dtype=np.float32)).cuda()[None]
    pad = model.spec.width // 2
    flops = picker_dense_flops(model.spec, (x.shape[1] + 2 * pad, x.shape[2] + 2 * pad))
    bound_ms = flops / F32_OPS_PER_S * 1e3
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: model(x), 10)
    print(f"# tools: segment resnet16_u32 dense forward {tuple(x.shape[1:])}: device "
          f"{device_ms:.3f} ms a micrograph (CUDA events, eager); bound {bound_ms:.3f} ms "
          f"({flops / 1e12:.4f} TFLOP at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s), "
          f"{bound_ms / device_ms:.3f} of it")
    # card against CPU on a 400^2 crop: the dense picker is shift-equivariant,
    # so away from the crop's edges (pad = width // 2) its map is the full map's
    shapes = {os.path.splitext(os.path.basename(p))[0]: mrc.read(p)[0].shape for p in binned}
    name = os.path.splitext(os.path.basename(binned[0]))[0]
    h, w = shapes[name]
    y0, x0, n = h // 4, w // 4, min(400, h // 2, w // 2)
    crop = os.path.join(workdir, "crop.mrc")
    mrc.write(crop, mrc.read(binned[0])[0][y0:y0 + n, x0:x0 + n])
    t0 = time.perf_counter()
    cpu = next(score_maps("resnet16_u32", [crop], device="cpu"))[1][pad:n - pad, pad:n - pad]
    cpu_s = time.perf_counter() - t0
    for tag, got in maps.items():
        if sorted(got) != sorted(shapes) or not all(
                got[k].shape == shapes[k] and np.isfinite(got[k]).all() for k in got):
            fail(f"segment {tag}: maps {sorted(got)}")
        card = got[name][y0 + pad:y0 + n - pad, x0 + pad:x0 + n - pad]
        err = float((np.abs(card - cpu) / np.maximum(1, np.abs(cpu))).max())
        print(f"# tools: segment {tag} card vs cpu on a {n}^2 crop's interior {cpu.shape} "
              f"(cpu {cpu_s:.3f} s): max diff {err:.3e} x max(1, |score|)")
        if err > PIPELINE_TOL:
            fail(f"segment {tag}: card against CPU {err}")

    (tomo, _), _ = write_tomograms(workdir, TOMO_SHAPE, "seg3d")
    ckpt = os.path.join(workdir, "picker3d.npz")
    save_picker(ckpt, new_picker("resnet8", units=32, dims=3, seed=SEED, device="cuda"))
    out = os.path.join(workdir, "seg3d")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli(["segment", "-m", ckpt, "-p", "48", "-o", out, "-d", "0", tomo])
    dt = time.perf_counter() - t0
    got = np.load(os.path.join(out, "seg3d_even.npy"))
    want = classify_patches_3d(load_picker(ckpt, device="cuda"), mrc.read(tomo)[0],
                               96).cpu().numpy()
    err = float((np.abs(got - want) / np.maximum(1, np.abs(want))).max())
    print(f"# tools: segment -p 48 (tiles of 96^3) of a {TOMO_SHAPE} tomogram, 3D resnet8 "
          f"units 32: {dt:.3f} s, .npy {got.shape}; against classify_patches_3d max diff "
          f"{err:.3e} x max(1, |score|)")
    if got.shape != TOMO_SHAPE or not np.isfinite(got).all() or err > PIPELINE_TOL:
        fail(f"segment 3D: {got.shape}, finite {np.isfinite(got).all()}, library {err}")


def run_handoff(workdir: str, raw, picks):
    """The RELION handoff on the .sav run's picks: ``convert -x 4 --to
    star`` with microscope columns, ``star_particles_threshold``, ``split``,
    ``coordinates_to_boxes`` then ``boxes_to_coordinates`` (the
    coordinates come back), ``particle_stack --size 256`` with ``--metadata``
    and without, then with ``--resize 64`` on the card and on the CPU, held
    within STACK_TOL."""
    import glob

    import numpy as np

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc

    def timed(argv):
        t0 = time.perf_counter()
        cli(argv)
        return time.perf_counter() - t0

    _, rows = read_table_rows(picks)
    scores = sorted((float(r[3]) for r in rows), reverse=True)
    threshold = scores[min(len(scores), STACK_PARTICLES * len(raw)) - 1]
    star = os.path.join(workdir, "picks.star")
    steps = {"convert": timed(["convert", "-x", str(K3_BIN), "--to", "star", "--voltage", "300",
                               "--detector-pixel-size", "5", "-o", star, picks])}
    kept = os.path.join(workdir, "kept.star")
    steps["star_particles_threshold"] = timed(["star_particles_threshold", "-t",
                                               repr(threshold), "-o", kept, star])
    os.makedirs(os.path.join(workdir, "split"))
    steps["split"] = timed(["split", kept, "-o", os.path.join(workdir, "split")])
    unbinned = os.path.join(workdir, "unbinned.txt")
    steps["convert --to coord"] = timed(["convert", "-x", str(K3_BIN), "-t", repr(threshold),
                                         "--to", "coord", "-o", unbinned, picks])
    boxes = os.path.join(workdir, "boxes")
    steps["coordinates_to_boxes"] = timed(["coordinates_to_boxes", unbinned, "--destdir", boxes,
                                           "--boxsize", str(STACK_SIZE)])
    back = os.path.join(workdir, "back.txt")
    steps["boxes_to_coordinates"] = timed(["boxes_to_coordinates", "-o", back]
                                          + sorted(glob.glob(os.path.join(boxes, "*.box"))))
    _, want = read_table_rows(unbinned)
    _, got = read_table_rows(back)
    n = len(want)
    split_files = sorted(os.listdir(os.path.join(workdir, "split")))
    with open(kept) as f:
        kept_rows = [line for line in f
                     if line.strip() and not line.startswith(("data_", "loop_", "_"))]
    if (sorted(r[:3] for r in got) != sorted(r[:3] for r in want) or len(kept_rows) != n
            or split_files != [f"k3_{i}.star" for i in range(len(raw))]):
        fail(f"handoff: {n} picks kept, {len(kept_rows)} in the STAR file, {len(got)} back "
             f"from the boxes, split files {split_files}")
    with open(star) as f:
        text = f.read()
    if "_rlnVoltage" not in text or "_rlnDetectorPixelSize" not in text:
        fail("handoff: convert --to star wrote no microscope columns")
    print(f"# tools: handoff of {n} picks (threshold {threshold!r}): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
          + "; the boxes give back the coordinates")

    meta = os.path.join(workdir, "meta.star")
    with open(meta, "w") as f:
        print("data_\nloop_\n_rlnMicrographName #1\n_rlnDetectorPixelSize #2\n"
              "_rlnVoltage #3\n_rlnSphericalAberration #4", file=f)
        for i in range(len(raw)):
            print(f"k3_{i}.mrc\t5.0\t300\t2.7", file=f)
    root = os.path.dirname(raw[0])
    stacks = {}
    for tag, extra in (("full", []), ("resize card", ["--resize", str(STACK_RESIZE), "-d", "0"]),
                       ("resize cpu", ["--resize", str(STACK_RESIZE), "-d", "cpu"])):
        # one name in its own directory: the STAR file's ImageName holds it
        os.makedirs(os.path.join(workdir, tag.replace(" ", "_")))
        out = os.path.join(workdir, tag.replace(" ", "_"), "stack.mrcs")
        dt = timed(["particle_stack", unbinned, "-o", out, "--image-root", root, "--size",
                    str(STACK_SIZE), "--metadata", meta] + extra)
        stack = mrc.read(out)[0]
        with open(os.path.splitext(out)[0] + ".star") as f:
            stacks[tag] = (stack, f.read())
        side = STACK_RESIZE if extra else STACK_SIZE
        # a crop is standardized over its part inside the micrograph and
        # zero outside, so only a resized crop (standardized again) has std 1
        std = stack.reshape(len(stack), -1).std(axis=1)
        print(f"# tools: particle_stack --size {STACK_SIZE} {tag}: {n} particles in {dt:.3f} s, "
              f"{n / dt:.1f} particles/s; crop std {std.min():.4f}-{std.max():.4f}")
        if stack.shape != (n, side, side) or not np.isfinite(stack).all() or std.max() > 1.001 \
                or np.median(std) < 0.999 or (extra and std.min() < 0.999):
            fail(f"particle_stack {tag}: {stack.shape}, crop std {std.min()}-{std.max()}")
    card, cpu = stacks["resize card"], stacks["resize cpu"]
    err = float(np.abs(card[0].astype(np.float64) - cpu[0]).max())
    print(f"# tools: particle_stack --resize {STACK_RESIZE} card vs cpu: max abs diff {err:.3e}; "
          f"STAR files equal {card[1] == cpu[1]}")
    if err > STACK_TOL or card[1] != cpu[1] or f"\t{5.0 * (STACK_SIZE / STACK_RESIZE)!r}\t" \
            not in card[1]:
        fail(f"particle_stack --resize card against CPU: {err}, STAR files equal "
             f"{card[1] == cpu[1]}")


def run_tools(workdir: str):
    """Phase ``tools``: 4 unbinned K3 micrographs binned 4x by ``preprocess
    -s 4``; ``.sav`` -> extract; ``segment`` in 2D and 3D; the RELION
    handoff through the coordinate tools and ``particle_stack``. Returns
    the disk_max launches of ``extract -m x.sav``."""
    from topaz_tpu_torch.cli.main import main as cli

    raw = write_k3_micrographs(workdir)
    binned_dir = os.path.join(workdir, "binned")
    t0 = time.perf_counter()
    cli(["preprocess", "-s", str(K3_BIN), "-o", binned_dir, "-d", "0"] + raw)
    print(f"# tools: preprocess -s {K3_BIN} of {len(raw)} micrographs: "
          f"{time.perf_counter() - t0:.3f} s")
    binned = [os.path.join(binned_dir, os.path.basename(p)) for p in raw]
    launches, picks = run_sav_extract(workdir, binned)
    run_segment(workdir, binned)
    run_handoff(workdir, raw, picks)
    return launches


def http_post(url: str, body: bytes, timeout: float = 600):
    """POST an MRC body; returns (status, response bytes)."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/x-mrc"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def http_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def concurrent_requests(fn, items):
    """``fn(item)`` in a thread each, all started together; returns (results,
    latencies in s, wall s). Fails on any error or a request left hanging."""
    import threading

    results, lat, errors = [None] * len(items), [0.0] * len(items), []

    def run(i):
        t0 = time.perf_counter()
        try:
            results[i] = fn(items[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{items[i]}: {type(e).__name__}: {e}")
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"concurrent requests: {errors or 'a request did not return'}")
    return results, lat, wall


def latency_line(tag: str, lat, wall: float):
    import numpy as np

    p50, p95 = np.percentile(lat, [50, 95])
    print(f"# services: {tag}: {len(lat)} requests in {wall:.3f} s, {len(lat) / wall:.3f} "
          f"requests/s, latency p50 {p50 * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms")


def served_picks(resp):
    return {(p["x"], p["y"]): p["score"] for p in resp["picks"]}


def scaled(picks, factor: int):
    return {(x * factor, y * factor): s for (x, y), s in picks.items()}


def run_services(workdir: str, device: str = "0"):
    """Phase ``services``: warmup, serve (in this process, then the CLI in
    a subprocess) and watch on synthetic micrographs with the CLI defaults
    (resnet16_u32, ``-s 8 -r 14 -t -6``, unet); then exact greedy NMS
    against the kernel's rounds on the pipeline's score maps. Returns the
    disk_max launches of the warmup, serve and watch paths."""
    import queue
    import re
    import signal
    import threading
    import urllib.request

    import numpy as np
    import torch

    import topaz_tpu_torch.pipeline as pipeline_mod
    from topaz_tpu_torch.denoise import Denoise
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.ops.nms import exact_non_maximum_suppression, non_maximum_suppression
    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.serve import TopazService, make_server

    cuda = device != "cpu"
    svc_device = int(device) if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    launches = {}
    frames = os.path.join(workdir, "frames")
    os.makedirs(frames)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 600)
    paths = write_micrographs(frames, rng, SERVICE_GEOMETRIES, SERVICE_FILES)
    print(f"# services: wrote {len(paths)} MRCs {SERVICE_GEOMETRIES} in "
          f"{time.perf_counter() - t0:.3f} s")
    factor = 8
    pipe_kw = dict(model="resnet16_u32", scale=factor, radius=RADIUS, threshold=THRESHOLD,
                   device=svc_device)

    # 1. warmup through the CLI in this process
    shapes = ",".join(f"{h}x{w}" for h, w in SERVICE_GEOMETRIES)
    reset_launches()
    t0 = time.perf_counter()
    _, err = cli_captured(["warmup", "--denoise-model", "unet", "--shapes", shapes,
                           "--batch-sizes", "1,8", "-d", device])
    sync()
    launches["warmup"] = read_launches("warmup")
    wall = time.perf_counter() - t0
    for line in err.splitlines():
        if line.startswith("# warmup"):
            print(f"#   | {line}")
    done = re.search(r"warmup: (\d+) programs run once", err)
    n_programs = int(done.group(1)) if done else 0
    print(f"# services: warmup {wall:.3f} s, {n_programs} programs, disk_max launches "
          f"{launches['warmup']}, gmm_em {GMM_LAUNCHES['warmup']}, unet_edges "
          f"{UNET_EDGE_LAUNCHES['warmup']}")
    # on the CPU (a rehearsal) the plain versions run: no launches
    if n_programs != 3 * len(SERVICE_GEOMETRIES) or (cuda and min(
            launches["warmup"], GMM_LAUNCHES["warmup"]) <= 0):
        fail(f"warmup: {n_programs} programs, {launches['warmup']} disk_max and "
             f"{GMM_LAUNCHES['warmup']} gmm_em launches")
    if cuda:
        require_edge_launches("warmup")

    # 2. the service in this process, as serve runs it (the CLI's defaults)
    bodies = {}
    for p in paths:
        with open(p, "rb") as f:
            bodies[p] = f.read()
    service = TopazService(denoise_model="unet", device=svc_device)
    server = make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def extract(p):
        return json.loads(http_post(base + "/extract", bodies[p])[1])

    try:
        health = http_json(base + "/healthz")
        want = torch.cuda.get_device_name(service.device) if cuda else "cpu"
        print(f"# services: /healthz device {health['device']} ({health['device_name']})")
        if health["device_name"] != want:
            fail(f"/healthz names {health['device_name']!r}, the card is {want!r}")
        reset_launches()
        serial, lat = {}, []
        t_all = time.perf_counter()
        for p in paths:
            t0 = time.perf_counter()
            serial[p] = extract(p)
            lat.append(time.perf_counter() - t0)
        latency_line("/extract one at a time", lat, time.perf_counter() - t_all)
        rounds = []
        for k in range(SERVICE_ROUNDS):
            items = [paths[(SERVICE_CONCURRENCY * k + j) % len(paths)]
                     for j in range(SERVICE_CONCURRENCY)]
            res, lat, wall = concurrent_requests(extract, items)
            latency_line(f"/extract round {k + 1}, {SERVICE_CONCURRENCY} concurrent", lat, wall)
            rounds.append(dict(zip(items, res)))
        sync()
        launches["serve"] = read_launches("serve")
        print(f"# services: /extract: {service.n_batches} device batches, largest "
              f"{service.max_batch_seen}; disk_max launches {launches['serve']}, gmm_em "
              f"{GMM_LAUNCHES['serve']}")
        if service.max_batch_seen <= 1 or (cuda and min(
                launches["serve"], GMM_LAUNCHES["serve"]) <= 0):
            fail(f"serve: largest batch {service.max_batch_seen}, "
                 f"{launches['serve']} disk_max and {GMM_LAUNCHES['serve']} gmm_em launches")

        # the direct pipeline on the same files; its score maps are kept
        maps, nms_batched = [], pipeline_mod.nms_topk_batched

        def keep(scores, r, t, k):
            maps.append(scores.clone())
            return nms_batched(scores, r, t, k)

        pipeline_mod.nms_topk_batched = keep
        try:
            direct = {p: picks_of(s, c) for p, s, c in pipeline_mod.MicrographPipeline(
                **pipe_kw).process(paths, batch_size=BATCH)}
        finally:
            pipeline_mod.nms_topk_batched = nms_batched
        err = conc = 0.0
        for p in paths:
            got = served_picks(serial[p])
            if not got:
                fail(f"serve: no picks for {p}")
            err = max(err, compare_picks(got, scaled(direct[p], factor), tie=PIPELINE_TOL,
                                         relative=True, labels=("served", "pipeline"),
                                         radius=RADIUS * factor))
            for rnd in rounds:
                if p in rnd:
                    conc = max(conc, compare_picks(
                        served_picks(rnd[p]), got, tie=PIPELINE_TOL, relative=True,
                        labels=("served in a round", "served alone"), radius=RADIUS * factor))
        print(f"# services: served picks ({sum(len(served_picks(serial[p])) for p in paths)}) "
              f"vs the pipeline x {factor}: matched scores max diff {err} x max(1, |score|); "
              f"concurrent vs alone {conc}")
        if err > PIPELINE_TOL or conc > PIPELINE_TOL:
            fail(f"served picks: {err} against the pipeline, {conc} concurrent vs alone")

        # /denoise of 4, then 8, concurrent full frames of the first geometry
        den_paths = paths[::len(SERVICE_GEOMETRIES)]
        reference = Denoise("unet", device=svc_device)
        refs = {}
        service.batch_window = 10.0  # each round in one batch, of its size
        reset_launches()
        for n in SERVICE_DENOISE_BATCHES:
            service.max_batch = n
            items = [den_paths[j % len(den_paths)] for j in range(n)]
            before = service.n_denoise_batches
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            res, lat, wall = concurrent_requests(
                lambda p: http_post(base + "/denoise", bodies[p])[1], items)
            sync()
            peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
            h, w = SERVICE_GEOMETRIES[0]
            latency_line(f"/denoise {n} concurrent {h}x{w}", lat, wall)
            route = service._denoiser.last_route
            print(f"# services: /denoise {n}: one batch of {service.max_denoise_batch_seen}, "
                  f"route {route} (frames: the batch ran out of device memory and went one "
                  f"frame at a time), peak {peak:.3f} GiB")
            if service.n_denoise_batches != before + 1 or service.max_denoise_batch_seen != n:
                fail(f"/denoise {n}: {service.n_denoise_batches - before} batches, largest "
                     f"{service.max_denoise_batch_seen}")
            rel = 0.0
            for p, body in zip(items, res):
                y = mrc.parse(body)[0]
                if p not in refs:
                    x = mrc.read(p)[0]
                    refs[p] = reference.denoise(x, patch_size=0).cpu().numpy()
                ref = refs[p]
                if y.shape != ref.shape or not np.isfinite(y).all():
                    fail(f"/denoise {p}: shape {y.shape}, finite {np.isfinite(y).all()}")
                rel = max(rel, float(np.abs(y.astype(np.float64) - ref).max() / ref.std()))
            print(f"# services: /denoise {n} vs Denoise('unet').denoise(x, patch_size=0): "
                  f"max abs diff {rel:.3e} x std")
            if rel > 1e-3:
                fail(f"/denoise {n}: {rel} x std from the library call")
        service.batch_window, service.max_batch = 0.02, 8
        read_launches("serve_denoise")
        print(f"# services: /denoise rounds and their library references: unet_edges "
              f"launches {UNET_EDGE_LAUNCHES['serve_denoise']}")
        if cuda:
            require_edge_launches("serve_denoise")

        health = http_json(base + "/healthz")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
        sample = {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
                  if ln and not ln.startswith("#")}
        pairs = {"extract_requests_total": "extracted", "denoise_requests_total": "denoised",
                 "device_batches_total": "device_batches", "largest_batch": "largest_batch",
                 "denoise_batches_total": "denoise_batches",
                 "largest_denoise_batch": "largest_denoise_batch",
                 "device_timeouts_total": "device_timeouts",
                 "worker_restarts_total": "worker_restarts"}
        off = {m: (sample[f"topaz_{m}"], health[k]) for m, k in pairs.items()
               if sample[f"topaz_{m}"] != health[k]}
        n_extract = len(paths) + SERVICE_ROUNDS * SERVICE_CONCURRENCY
        count = sample['topaz_request_duration_seconds_count{kind="extract"}']
        print(f"# services: /metrics agrees with /healthz on {len(pairs) - len(off)} of "
              f"{len(pairs)} numbers; {health['extracted']} extracted, {health['denoised']} "
              f"denoised, {count:.0f} extract latencies")
        if off or health["extracted"] != n_extract or count != n_extract \
                or health["denoised"] != sum(SERVICE_DENOISE_BATCHES):
            fail(f"/metrics vs /healthz: {off}; extracted {health['extracted']}")
    finally:
        server.shutdown()
        server.server_close()
        service.close()

    # 3. the serve CLI in a subprocess: one /extract, then SIGTERM
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "topaz_tpu_torch", "serve", "--port", "0",
                             "-d", device], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()

    def drain():
        for line in proc.stderr:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=drain, daemon=True).start()
    try:
        port, deadline = None, time.monotonic() + 300
        while port is None:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                fail("serve CLI: no 'listening on' line within 300 s")
            if line is None:
                fail(f"serve CLI exited with {proc.wait()} before listening")
            found = re.search(r"listening on http://[^:]+:(\d+)", line)
            port = int(found.group(1)) if found else None
        t_listen = time.perf_counter() - t0
        t1 = time.perf_counter()
        resp = json.loads(http_post(f"http://127.0.0.1:{port}/extract", bodies[paths[0]])[1])
        t_first = time.perf_counter() - t1
        err = compare_picks(served_picks(resp), served_picks(serial[paths[0]]), tie=PIPELINE_TOL,
                            relative=True, labels=("serve CLI", "in-process service"),
                            radius=RADIUS * factor)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"# services: serve CLI listening after {t_listen:.3f} s, first /extract "
          f"{t_first:.3f} s ({resp['count']} picks, {err} x max(1, |score|) from the "
          f"in-process service); SIGTERM -> exit {rc}")
    if rc != 0 or resp["count"] <= 0 or err > PIPELINE_TOL:
        fail(f"serve CLI: exit {rc}, {resp['count']} picks, {err}")

    # 4. watch --once through the CLI on the backlog, then on new arrivals
    out = os.path.join(workdir, "watch", "picks.txt")
    argv = ["watch", frames, "-o", out, "--batch-size", str(BATCH), "--once",
            "--poll-interval", "0.5", "-d", device]
    reset_launches()
    t0 = time.perf_counter()
    cli(argv)
    sync()
    dt1 = time.perf_counter() - t0
    with open(out) as f:
        n_first = len(f.read().splitlines())
    new = write_micrographs(frames, np.random.default_rng(SEED + 601), SERVICE_GEOMETRIES,
                            SERVICE_ARRIVALS // len(SERVICE_GEOMETRIES), prefix="late")
    t0 = time.perf_counter()
    cli(argv)
    sync()
    dt2 = time.perf_counter() - t0
    launches["watch"] = read_launches("watch")
    with open(out) as f:
        lines_out = f.read().splitlines()

    def stems(ps):
        return {os.path.splitext(os.path.basename(p))[0] for p in ps}

    headers = sum(ln.startswith("image_name\t") for ln in lines_out)
    first = {ln.split("\t")[0] for ln in lines_out[1:n_first]}
    second = {ln.split("\t")[0] for ln in lines_out[n_first:]}
    if headers != 1 or first != stems(paths) or second != stems(new):
        fail(f"watch: {headers} headers; first run {sorted(first)}, second {sorted(second)}")
    direct.update({p: picks_of(s, c) for p, s, c in pipeline_mod.MicrographPipeline(
        **pipe_kw).process(new, batch_size=BATCH)})
    table = read_table(out)
    err = 0.0
    for p in paths + new:
        stem = os.path.splitext(os.path.basename(p))[0]
        err = max(err, compare_picks(table[stem], scaled(direct[p], factor), tie=PIPELINE_TOL,
                                     relative=True, labels=("watch", "pipeline"),
                                     radius=RADIUS * factor))
    print(f"# services: watch --once: {len(paths)} micrographs in {dt1:.3f} s "
          f"({len(paths) / dt1:.3f} micrographs/s, one 0.5 s poll interval and the pipeline's "
          f"construction included), then {len(new)} new in {dt2:.3f} s "
          f"({len(new) / dt2:.3f}/s), only they; one header; disk_max launches "
          f"{launches['watch']}, gmm_em {GMM_LAUNCHES['watch']}; picks vs the pipeline x "
          f"{factor}: {err} x max(1, |score|)")
    if err > PIPELINE_TOL or (cuda and min(launches["watch"], GMM_LAUNCHES["watch"]) <= 0):
        fail(f"watch: picks {err} from the pipeline, {launches['watch']} disk_max and "
             f"{GMM_LAUNCHES['watch']} gmm_em launches")

    # 5. exact greedy NMS against the kernel's rounds on the pipeline's maps
    t0 = time.perf_counter()
    n_maps = n_picks = 0
    prev = None
    for batch in maps:
        for m in batch:
            if prev is not None and torch.equal(m, prev):
                continue  # a batch's last map repeated to fill it
            prev = m
            rs, rc_ = non_maximum_suppression(m, RADIUS, threshold=THRESHOLD, device=svc_device)
            es, ec = exact_non_maximum_suppression(m, RADIUS, threshold=THRESHOLD,
                                                   device=svc_device)
            if not (np.array_equal(rs, es) and np.array_equal(rc_, ec)):
                active = m[m > THRESHOLD]
                fail(f"exact NMS: {len(es)} picks, the kernel's rounds {len(rs)}; equal "
                     f"active scores: {active.numel() - torch.unique(active).numel()}")
            n_maps += 1
            n_picks += len(es)
    sync()
    print(f"# services: exact greedy NMS identical to the kernel's rounds on {n_maps} score "
          f"maps of the pipeline ({n_picks} picks) in {time.perf_counter() - t0:.3f} s")
    if n_maps != len(paths):
        fail(f"exact NMS: {n_maps} maps for {len(paths)} micrographs")
    return launches


def shard_devices(n: int):
    """The one card repeated ``n`` times: the sharded paths' device lists."""
    import torch

    return [torch.device("cuda:0")] * n


def run_scaleout(workdir: str):
    """``-d -2`` and the sharded functions on the one card. ``preprocess
    -s 8 -d -2`` (the batched normalization, as in the JAX CLI) within
    1e-3 of ``--batch-size 2``, and ``extract -m resnet8_u32 -r 14 -t -6`` at ``-d
    0`` and ``-d -2`` on one file (identical picks and disk_max launches;
    -2 is [cuda:0] here);
    ``denoise -m unet -s 0`` at both (bit-identical). Over [cuda:0] * 2 and
    * 4: the halo dense scorer against whole-image scoring (maps within
    1e-4, NMS picks through the kernel identical), the batched scorer on 8
    x 512^2 (1e-5), the halo denoiser with ``affine`` (1e-5 x std) and with
    ``unet`` at 4096^2 (root mean square within ``UNET_HALO_TOL`` x std),
    with the ms of each
    against the whole-image route. Then the library's tail, card against
    CPU: ``ScaledGaussianMixture.fit`` (scales within 1e-5 relative), each
    ``EXTRA_ARCHS`` net at the test widths on 256^2 (1e-3) and
    ``estimate_unblur_filter_gaussian`` on 512^2 (sigma and alpha within
    1e-3 relative). Returns the disk_max launches of ``extract -d -2``."""
    import numpy as np
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.denoise import Denoise
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models.denoise_factory import load_denoiser
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.ops.nms import non_maximum_suppression
    from topaz_tpu_torch.parallel import mesh as pmesh
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    t_phase = time.perf_counter()
    x, _ = make_ctf_micrograph(np.random.default_rng(SEED), size=SIZE, n_particles=60)
    raw = os.path.join(workdir, "raw.mrc")
    mrc.write(raw, x)

    # 1. picking and denoising through the CLI at -d 0 and -d -2. preprocess
    # -d -2 takes the batched normalization at one image a batch (as the
    # JAX CLI does), so it is held against --batch-size 2 at -d 0 within
    # 1e-3, the normalized micrograph's tolerance in run_slice (a batch of 2
    # sums the EM's moments in another order, and a lane may stop a step
    # apart); both extracts read -d 0's file
    procs = {}
    for tag, flags in (("0", ["-d", "0"]), ("-2", ["-d", "-2"]),
                       ("batch", ["-d", "0", "--batch-size", "2"])):
        procs[tag] = os.path.join(workdir, f"proc{tag}")
        cli(["preprocess", "-s", "8", "-o", procs[tag]] + flags + [raw])
    norm, norm2, normb = (mrc.read(os.path.join(procs[t], "raw.mrc"))[0]
                          for t in ("0", "-2", "batch"))
    norm_err = float(np.abs(norm2.astype(np.float64) - normb).max())
    if norm2.shape != normb.shape or norm_err > 1e-3:
        fail(f"preprocess -d -2 differs from --batch-size 2 by {norm_err}")
    runs = {}
    for flag in ("0", "-2"):
        picks = os.path.join(workdir, f"picks{flag}.txt")
        reset_launches()
        cli(["extract", "-m", "resnet8_u32", "-r", str(RADIUS), "-t", str(THRESHOLD),
             "-o", picks, "-d", flag, os.path.join(procs["0"], "raw.mrc")])
        torch.cuda.synchronize()
        n = read_launches("scaleout" if flag == "-2" else "scaleout_d0")
        out = os.path.join(workdir, f"den{flag}")
        reset_launches()
        cli(["denoise", "-m", "unet", "-s", "0", "-d", flag, "-o", out, raw])
        torch.cuda.synchronize()
        read_launches("scaleout_denoise" if flag == "-2" else "scaleout_denoise_d0")
        runs[flag] = (read_picks(picks), n, mrc.read(os.path.join(out, "raw.mrc"))[0])
    (p0, n0, d0), (p2, n2, d2) = runs["0"], runs["-2"]
    print(f"# scaleout: preprocess -d -2 against --batch-size 2: max abs diff {norm_err}; "
          f"extract -d -2 {len(p2)} "
          f"picks, disk_max launches {n2} (-d 0: {len(p0)}, {n0}); denoise -d -2 "
          f"bit-identical to -d 0: {np.array_equal(d2, d0)}, unet_edges launches "
          f"{UNET_EDGE_LAUNCHES['scaleout_denoise']} (-d 0: "
          f"{UNET_EDGE_LAUNCHES['scaleout_denoise_d0']})")
    if not p2 or p2 != p0 or n2 != n0 or n2 < 3:
        fail(f"extract -d -2: {len(p2)} picks, {n2} launches against -d 0's {len(p0)}, "
             f"{n0}; identical {p2 == p0}")
    if not np.array_equal(d2, d0):
        fail(f"denoise -d -2 differs from -d 0 by {np.abs(d2 - d0).max()}")
    require_edge_launches("scaleout_denoise")
    require_edge_launches("scaleout_denoise_d0")

    # 2. the sharded functions over the card repeated
    picker = load_picker("resnet8_u32", device="cuda")
    img = torch.from_numpy(np.array(norm, dtype=np.float32)).cuda()
    with torch.inference_mode():
        whole = picker(img[None])[0]
    whole_ms = cuda_ms(lambda: picker(img[None]), 10)
    want_picks = non_maximum_suppression(whole, RADIUS, threshold=THRESHOLD, device="cuda")
    rng = np.random.default_rng(SEED + 700)
    batch = torch.from_numpy(rng.normal(size=(8,) + tuple(norm.shape)).astype(np.float32)).cuda()
    with torch.inference_mode():
        batch_want = picker(batch)
    affine = load_denoiser("affine", device="cuda")
    den = Denoise("unet", device="cuda")
    xt = torch.from_numpy(x).cuda()
    mu, sd = xt.mean(), torch.std(xt, correction=0)
    with torch.inference_mode():
        affine_want = affine(((xt - mu) / sd)[None, None])[0, 0] * sd + mu
        unet_want = den.denoise(xt, patch_size=0)
    unet_ms = cuda_ms(lambda: den.denoise(xt, patch_size=0), 3, warmup=1)
    x_std = float(x.std())
    for n in (2, 4):
        devs = shard_devices(n)
        halo = pmesh.make_halo_dense_scorer(picker, pmesh.make_mesh(1, n, devs))
        got = halo(img)
        err = float((got - whole).abs().max())
        got_picks = non_maximum_suppression(got, RADIUS, threshold=THRESHOLD, device="cuda")
        same = (np.array_equal(got_picks[1], want_picks[1])
                and np.allclose(got_picks[0], want_picks[0], rtol=0, atol=1e-4))
        halo_ms = cuda_ms(lambda: halo(img), 10)
        scorer = pmesh.make_batched_scorer(picker, pmesh.make_mesh(n, 1, devs))
        berr = float((scorer(batch) - batch_want).abs().max())
        ahalo = pmesh.make_halo_denoiser(affine, pmesh.make_mesh(1, n, devs), halo=256)
        aerr = float((ahalo(xt) - affine_want).abs().max())
        uhalo = pmesh.make_halo_denoiser(den.model, pmesh.make_mesh(1, n, devs), halo=256)
        udiff = (uhalo(xt) - unet_want) / x_std
        uerr, umax = float(udiff.square().mean().sqrt()), float(udiff.abs().max())
        uhalo_ms = cuda_ms(lambda: uhalo(xt), 3, warmup=1)
        print(f"# scaleout [cuda:0] x {n}: halo scorer {norm.shape} max abs diff {err} "
              f"(picks identical {same}, {len(got_picks[0])}); batched scorer 8 x "
              f"{norm.shape} {berr}; halo denoiser affine {aerr / x_std:.3e} x std, unet "
              f"{SIZE}^2 root mean square {uerr:.4e} x std (bound {UNET_HALO_TOL}), largest "
              f"{umax:.4e} x std")
        print(f"# scaleout [cuda:0] x {n}: overhead of sharding on one device: halo scorer "
              f"{halo_ms:.3f} ms against whole-image {whole_ms:.3f} ms; halo denoiser unet "
              f"{uhalo_ms:.3f} ms against whole-image {unet_ms:.3f} ms")
        if err > 1e-4 or not same or berr > 1e-5 or aerr > 1e-5 * x_std or uerr > UNET_HALO_TOL:
            fail(f"sharded functions over {n}: halo scorer {err} (picks identical {same}), "
                 f"batched scorer {berr}, affine {aerr}, unet root mean square {uerr} x std")
    del den, affine_want, uhalo, ahalo
    torch.cuda.empty_cache()
    n_mesh = check_mesh_entry_points(workdir, xt, unet_want, x_std, os.path.join(procs["0"],
                                                                                "raw.mrc"))
    del unet_want
    torch.cuda.empty_cache()
    check_dp_step()
    check_tail()
    print(f"# scaleout phase (without train -d -2): {time.perf_counter() - t_phase:.1f} s")
    return n2, n_mesh


def check_mesh_entry_points(workdir: str, xt, unet_want, x_std: float, normalized: str):
    """The entry points that take device lists, over the card repeated,
    each against its one-device route: the pipeline over a 2 x 2 mesh, the
    whole-image denoiser, the denoiser's train step, halo segmentation and
    the batched normalization. Returns the disk_max launches of the mesh
    pipeline's pass."""
    import numpy as np
    import torch

    from topaz_tpu_torch.denoise import (Denoise, make_denoise_optimizer, make_denoise_step)
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models.denoise_factory import load_denoiser
    from topaz_tpu_torch.parallel import mesh as pmesh
    from topaz_tpu_torch.pipeline import MicrographPipeline
    from topaz_tpu_torch.preprocess import normalize_images_batched
    from topaz_tpu_torch.segment import score_maps

    paths = write_micrographs(workdir, np.random.default_rng(SEED), [(SIZE, SIZE)], 4,
                              prefix="so")
    kw = dict(model="resnet8_u32", denoise_model="unet", scale=8, radius=RADIUS,
              threshold=THRESHOLD, host_downsample=True, num_workers=2)
    one = run_pipeline_pass(MicrographPipeline(**kw), paths, "scaleout, one device",
                            batch_size=4)
    pipe = MicrographPipeline(mesh=pmesh.make_mesh(2, 2, shard_devices(4)), **kw)
    reset_launches()
    meshed = run_pipeline_pass(pipe, paths, "scaleout, [cuda:0] x 4 as 2 x 2", batch_size=4)
    torch.cuda.synchronize()
    n_mesh = read_launches("scaleout_mesh_pipeline")
    perr, derr = 0.0, 0.0
    for path in paths:
        perr = max(perr, compare_picks(picks_of(*meshed[path][:2]), picks_of(*one[path][:2]),
                                       tie=PIPELINE_TOL, relative=True,
                                       labels=("2 x 2 mesh", "one device")))
        a, b = meshed[path][2], one[path][2]
        derr = max(derr, float(np.abs(a.astype(np.float64) - b).max() / b.std()))
    print(f"# scaleout: pipeline over a 2 x 2 mesh against one device, 4 x {SIZE}^2: "
          f"matched scores max diff {perr} x max(1, |score|), denoised {derr:.3e} x std; "
          f"disk_max launches {n_mesh}")
    if n_mesh < 3 or n_mesh % 3 or perr > PIPELINE_TOL or derr > 1e-3:
        fail(f"pipeline over a mesh: {n_mesh} disk_max launches, picks {perr}, "
             f"denoised {derr} x std")

    den = Denoise("unet", device="cuda", devices=shard_devices(2))
    got = den.denoise(xt, patch_size=0)
    halo = pmesh.make_halo_denoiser(den.model, pmesh.make_mesh(1, 2, shard_devices(2)),
                                    halo=256)(xt)
    rms = float(((got - unet_want) / x_std).square().mean().sqrt())
    same = bool(torch.equal(got, halo))
    print(f"# scaleout: Denoise('unet', devices=[cuda:0] x 2) {SIZE}^2: halo route "
          f"{len(den._halo_fns) == 1}, equal to the halo denoiser {same}, root mean square "
          f"{rms:.4e} x std from whole-image (bound {UNET_HALO_TOL})")
    if len(den._halo_fns) != 1 or not same or rms > UNET_HALO_TOL:
        fail(f"Denoise over 2 devices: halo route {len(den._halo_fns)}, equal {same}, "
             f"root mean square {rms}")
    del den, got, halo
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 750)
    src, tgt = (torch.from_numpy(rng.normal(size=(4, 256, 256)).astype(np.float32)).cuda()
                for _ in range(2))
    updates = []
    for mesh in (None, pmesh.make_mesh(2, 1, shard_devices(2))):
        model = load_denoiser("unet", device="cuda")
        before = [p.detach().clone() for p in model.parameters()]
        step = make_denoise_step(model, make_denoise_optimizer(model, "sgd", lr=1.0), "L2",
                                 mesh=mesh)
        step(src, tgt, 0.0)
        updates.append([p.detach() - b for p, b in zip(model.parameters(), before)])
    scale = max(float(u.abs().max()) for u in updates[0])
    uerr = max(float((a - b).abs().max()) for a, b in zip(*updates)) / scale
    print(f"# scaleout: denoiser SGD step over a data mesh of 2 against one device, 4 x "
          f"256^2: updates differ by {uerr:.3e} of the largest ({scale:.3e})")
    if not scale > 0 or uerr > DENOISE_TRAIN_TOL:
        fail(f"denoiser step over a mesh: updates differ by {uerr} of the largest")

    maps = [next(score_maps("resnet8_u32", [normalized], devices=d))[1]
            for d in (shard_devices(1), shard_devices(2))]
    serr = float(np.abs(maps[1] - maps[0]).max())
    print(f"# scaleout: segment score map over [cuda:0] x 2 against one device: max abs "
          f"diff {serr}")
    if maps[1].shape != maps[0].shape or serr > 1e-4:
        fail(f"segment over 2 devices: score maps differ by {serr}")

    outs = {}
    for tag, mesh in (("one", None), ("mesh", pmesh.make_mesh(2, 1, shard_devices(2)))):
        outs[tag] = os.path.join(workdir, f"norm_{tag}")
        normalize_images_batched(paths, outs[tag], scale=8, batch_size=2, device="cuda",
                                 mesh=mesh)
    nerr = max(float(np.abs(mrc.read(os.path.join(outs["mesh"], os.path.basename(p)))[0]
                            .astype(np.float64)
                            - mrc.read(os.path.join(outs["one"], os.path.basename(p)))[0]).max())
               for p in paths)
    print(f"# scaleout: normalize_images_batched over a data mesh of 2 against one device, "
          f"4 x {SIZE}^2 at -s 8: max abs diff {nerr}")
    if nerr > 1e-3:
        fail(f"batched normalization over a mesh differs by {nerr}")
    return n_mesh


def check_dp_step():
    """One data-parallel step over two copies on the card against one step
    on the concatenated batch, SGD so that the update is linear in the
    gradient, for ``resnet8_u32`` and for a fresh ``resnet8`` with batch
    norm (its statistics over both shards): the largest difference of the
    updates, and of the running statistics, within ``TRAIN_TOL`` of the
    largest update (of the largest statistic)."""
    import numpy as np
    import torch

    from topaz_tpu_torch.models.factory import load_picker, new_picker
    from topaz_tpu_torch.parallel import mesh as pmesh
    from topaz_tpu_torch.train.methods import make_loss_fn
    from topaz_tpu_torch.train.trainer import init_train_state, make_train_step

    rng = np.random.default_rng(SEED + 800)
    crops = torch.from_numpy(rng.normal(size=(64, 71, 71)).astype(np.float32)).cuda()
    labels = torch.from_numpy((np.arange(64) % 4 == 0).astype(np.float32)).cuda()
    loss_fn = make_loss_fn("GE-binomial", 0.05)[0]
    builds = {"resnet8_u32": lambda: load_picker("resnet8_u32", device="cuda"),
              "resnet8 --bn on": lambda: new_picker("resnet8", bn=True, seed=0, device="cuda")}
    for name, build in builds.items():
        after, stats = [], []
        for mesh in (None, pmesh.make_mesh(2, 1, shard_devices(2))):
            model = build()
            before = [p.detach().clone() for p in model.parameters()]
            state = init_train_state(model, 0.05, lr=1.0, optim="sgd")
            make_train_step(loss_fn, mesh=mesh)(state, crops, labels)
            after.append([p.detach() - b for p, b in zip(model.parameters(), before)])
            stats.append([b.detach().clone() for b in model.buffers()])
        scale = max(float(u.abs().max()) for u in after[0])
        err = max(float((a - b).abs().max()) for a, b in zip(after[1], after[0])) / scale
        serr = max([float((a - b).abs().max() / b.abs().max()) for a, b in zip(*stats)],
                   default=0.0)
        print(f"# scaleout: DP step of {name} over [cuda:0] x 2 against one step on the batch "
              f"of 64: updates differ by {err:.3e} of the largest update ({scale:.3e}); "
              f"{len(stats[0])} batch-norm buffers, {serr:.3e} relative")
        if not scale > 0 or err > TRAIN_TOL or serr > TRAIN_TOL:
            fail(f"DP train step of {name}: updates differ by {err} of the largest, "
                 f"running statistics by {serr} (tolerance {TRAIN_TOL})")


def check_tail():
    """The library's tail on the card against the CPU: ScaledGaussianMixture
    on 4 images of 512^2, the EXTRA_ARCHS nets at the test widths on 256^2,
    the Gaussian unblur filter on 512^2."""
    import numpy as np
    import torch

    from topaz_tpu_torch.models import extras
    from topaz_tpu_torch.ops.filters import estimate_unblur_filter_gaussian
    from topaz_tpu_torch.transform import ScaledGaussianMixture

    rng = np.random.default_rng(SEED + 900)
    images = []
    for s in (0.8, 1.0, 1.2, 1.5):
        comp = rng.random((512, 512)) < 0.3
        images.append((np.where(comp, rng.normal(4.0, 0.3, (512, 512)),
                                rng.normal(1.0, 0.3, (512, 512))) * s).astype(np.float32))
    scales = {}
    for dev in ("cuda", "cpu"):
        sgm = ScaledGaussianMixture(ncomponents=2, device=dev)
        t0 = time.perf_counter()
        scale, _ = sgm.fit(images, random=np.random.RandomState(1))
        scales[dev] = scale.cpu().numpy().astype(np.float64)
        print(f"# scaleout: ScaledGaussianMixture.fit 4 x 512^2 on {dev}: "
              f"{time.perf_counter() - t0:.3f} s, scales {scales[dev]}")
    serr = float(np.max(np.abs(scales["cuda"] / scales["cpu"] - 1)))
    if serr > 1e-5:
        fail(f"ScaledGaussianMixture: card scales differ from the CPU's by {serr} relative")

    nets = {"msdensenet": lambda: extras.MultiscaleDenseNet(base_units=8, ng=6, num_blocks=2),
            "densenet": lambda: extras.DenseNet(init_units=8, ng=4, bn_size=2, fc_units=16,
                                                num_layers=3),
            "rmsnet": lambda: extras.RMSNet(units=[4, 4, 4, 6, 6, 6, 6, 6, 6, 8, 8, 8]),
            "rmsnet7": lambda: extras.RMSNet7(units=[8, 8, 12, 12, 16]),
            "rmsnet10": lambda: extras.RMSNet10(units=[8, 8, 12, 12, 16]),
            "pyramidnet": lambda: extras.PyramidNet(base_units=8, scales=[2, 4, 8])}
    xin = torch.from_numpy(rng.normal(size=(1, 1, 256, 256)).astype(np.float32))
    worst = {}
    for name, build in nets.items():
        model = extras.init_extras_(build(), torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            cpu = model(xin)
            card = model.cuda()(xin.cuda()).cpu()
        worst[name] = float((card - cpu).abs().max())
    print(f"# scaleout: EXTRA_ARCHS on 256^2, card against CPU max abs diff {worst}")
    if max(worst.values()) > 1e-3:
        fail(f"EXTRA_ARCHS card against CPU: {worst}")

    y = rng.normal(size=(512, 512)).astype(np.float32)
    y = y + 0.5 * np.roll(y, 1, axis=0) + 0.5 * np.roll(y, 1, axis=1)
    fits = {dev: estimate_unblur_filter_gaussian(y, device=dev)[1:3] for dev in ("cuda", "cpu")}
    ferr = max(abs(a / b - 1) for a, b in zip(fits["cuda"], fits["cpu"]))
    print(f"# scaleout: estimate_unblur_filter_gaussian 512^2 (sigma, alpha) card "
          f"{fits['cuda']} cpu {fits['cpu']}, {ferr:.3e} relative")
    if ferr > 1e-3:
        fail(f"estimate_unblur_filter_gaussian: card against CPU {ferr} relative")


def train_scaleout(workdir: str, files):
    """``train -d -2`` against ``-d 0`` for one epoch of 5 steps on the
    training phase's set: -2 is [cuda:0] on one card, so the rows are the
    same computation; each column's difference in units of max(|value|,
    TRAIN_TOL_FLOOR) within TRAIN_TOL, and whether they are bit-equal."""
    from topaz_tpu_torch.cli.main import main as cli

    train_images, train_targets = files["train"]
    argv = ["train", "--train-images", train_images, "--train-targets", train_targets,
            "-n", str(TRAIN_PARTICLES), "-r", "3", "--num-epochs", "1", "--epoch-size", "5"]
    rows = {}
    for flag in ("0", "-2"):
        log = os.path.join(workdir, f"scaleout_train{flag}.tsv")
        t0 = time.perf_counter()
        cli(argv + ["-d", flag, "-o", log])
        print(f"# scaleout: train -d {flag} took {time.perf_counter() - t0:.3f} s")
        rows[flag] = check_log(log, 5, f"train -d {flag}")[1]
    worst = max(abs(u - v) / max(abs(v), TRAIN_TOL_FLOOR)
                for a, b in zip(rows["-2"], rows["0"]) for u, v in zip(a[3:-1], b[3:-1]))
    print(f"# scaleout: train -d -2 rows against -d 0: bit-equal {rows['-2'] == rows['0']}, "
          f"largest difference {worst:.3e}")
    if worst > TRAIN_TOL:
        fail(f"train -d -2 rows differ from -d 0's by {worst}")


# the phases after the kernel check, in order; ``--only`` runs some of them
PHASES = ("slice", "denoise", "pipeline", "training", "extract_targets", "train_ae",
          "denoise_train", "denoise3d", "extract3d", "train3d", "tools",
          "services", "scaleout")


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    parser.add_argument("--only", nargs="+", choices=PHASES, default=PHASES,
                        help="run only these phases after the kernel check (default: all; "
                             "the result line needs all)")
    only = set(parser.parse_args().only)

    def want(phase):
        return phase in only

    sys.path.insert(0, REPO)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device available")
    try:
        import topaz_tpu_torch
        from topaz_tpu_torch._build import build_libraries
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if os.path.dirname(os.path.abspath(topaz_tpu_torch.__file__)) != os.path.join(
            REPO, "topaz_tpu_torch"):
        fail(f"topaz_tpu_torch was imported from {topaz_tpu_torch.__file__}, "
             f"not from beside this script")
    card = card_line()
    print(f"# card: {card}")

    t = time.perf_counter()
    build_libraries(["disk_max", "gmm_em", "unet_edges"])
    print(f"# kernels built in {time.perf_counter() - t:.2f} s")

    err, single, batched, by_radius = check_disk_max()
    edge_rows = check_unet_edges()
    t = time.perf_counter()
    em_rows, em_buckets = check_gmm_em(), {}
    print(f"# gmm_em check: {time.perf_counter() - t:.1f} s")
    launches = dict.fromkeys(PHASES + ("train_extract", "warmup", "serve", "watch",
                                       "scaleout_mesh_pipeline"))
    r100 = None
    if want("slice") or want("denoise"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["slice"] = run_slice(workdir)
            print(f"# slice phase: {time.perf_counter() - t:.1f} s")
            if want("denoise"):
                t = time.perf_counter()
                launches["denoise"] = run_denoise(workdir)
                print(f"# denoise phase: {time.perf_counter() - t:.1f} s")
    if want("pipeline"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["pipeline"], paths, dev = run_pipeline(workdir)
            hold_pipeline(paths, dev)
            t_em = time.perf_counter()
            em_buckets = check_gmm_em_pipeline(paths)
            t_em = time.perf_counter() - t_em
            run_batched_cli(workdir, paths)
            print(f"# pipeline phase: {time.perf_counter() - t:.1f} s ({t_em:.1f} s of it "
                  f"check_gmm_em_pipeline)")
    if want("training") or want("extract_targets") or want("train_ae") or want("scaleout"):
        with tempfile.TemporaryDirectory() as workdir:
            files = write_training_set(workdir)
            if want("scaleout"):
                train_scaleout(workdir, files)
            if want("training"):
                t = time.perf_counter()
                launches["training"], launches["train_extract"], argv, prefix, epoch_s = (
                    run_training(workdir, files))
                time_training(workdir, files, argv, prefix, epoch_s)
                train_bn(workdir, files)
                (train_images, train_targets) = files["train"]
                train_card_vs_cpu(workdir, [
                    "train", "--train-images", train_images, "--train-targets", train_targets,
                    "-n", str(TRAIN_PARTICLES), "-r", "3", "--num-epochs", "1",
                    "--epoch-size", "5", "--minibatch-size", "64"], "train")
                print(f"# training phase: {time.perf_counter() - t:.1f} s")
            if want("extract_targets"):
                t = time.perf_counter()
                launches["extract_targets"], r100 = run_extract_targets(workdir, files)
                print(f"# extract_targets phase: {time.perf_counter() - t:.1f} s")
            if want("train_ae"):
                t = time.perf_counter()
                launches["train_ae"] = run_train_ae(workdir, files)
                print(f"# train_ae phase: {time.perf_counter() - t:.1f} s")
    if want("denoise_train"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["denoise_train"] = run_denoise_train(workdir)
            print(f"# denoiser training phase: {time.perf_counter() - t:.1f} s")
    if want("denoise3d"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["denoise3d"] = run_denoise3d(workdir)
            print(f"# denoise3d phase: {time.perf_counter() - t:.1f} s")
    if want("extract3d"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["extract3d"] = run_extract3d(workdir)
            print(f"# extract3d phase: {time.perf_counter() - t:.1f} s")
    if want("train3d"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["train3d"] = run_train3d(workdir)
            print(f"# train3d phase: {time.perf_counter() - t:.1f} s")
    if want("tools"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["tools"] = run_tools(workdir)
            print(f"# tools phase: {time.perf_counter() - t:.1f} s")
    if want("services"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches.update(run_services(workdir))
            print(f"# services phase: {time.perf_counter() - t:.1f} s")
    if want("scaleout"):
        with tempfile.TemporaryDirectory() as workdir:
            t = time.perf_counter()
            launches["scaleout"], launches["scaleout_mesh_pipeline"] = run_scaleout(workdir)
            print(f"# scaleout phase: {time.perf_counter() - t:.1f} s")
    if "jax" in sys.modules or "topaz_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")

    # the batched pipeline is the main path of the slices: its launches and
    # the time at its larger bucket's shape lead; extract's single-image
    # shape keeps its numbers under "single", the radius grid's r = 100
    # (timed in that phase) under "r100", and the sweep over r at that shape
    # under "by_radius"
    kernels = [{
        "name": "disk_max", "route": "cuda",
        "source": "topaz_tpu_torch/csrc/disk_max.cu",
        "replaces": "topaz_tpu/ops/nms_pallas.py:35",
        "launches": launches["pipeline"],
        "launches_by_path": {"pipeline": launches["pipeline"], "extract": launches["slice"],
                             "denoise": launches["denoise"], "train": launches["training"],
                             "train_extract": launches["train_extract"],
                             "denoise_train": launches["denoise_train"],
                             "denoise3d": launches["denoise3d"],
                             "extract_targets": launches["extract_targets"],
                             "extract3d": launches["extract3d"],
                             "train3d": launches["train3d"], "train_ae": launches["train_ae"],
                             "sav_extract": launches["tools"], "warmup": launches["warmup"],
                             "serve": launches["serve"], "watch": launches["watch"],
                             "scaleout": launches["scaleout"],
                             "scaleout_mesh_pipeline": launches["scaleout_mesh_pipeline"]},
        "max_abs_err": err, "shape": list(BATCHED_SHAPES[-1]), "r": RADIUS,
        "ms": batched["ms"], "plain_ms": batched["plain_ms"],
        "eager_ms": batched["eager_ms"], "plain_eager_ms": batched["plain_eager_ms"],
        "bound_ms": batched["bound_ms"], "bound_by": batched["bound_by"], "library_ms": None,
        "single": {"shape": [SIZE // 8, SIZE // 8], **single},
        "r100": r100, "by_radius": by_radius,
    }]
    # the EM: the pipeline's 512 x 512 bucket leads (the synthetic padded
    # batch of 8 x 512^2 when the pipeline phase did not run); the other
    # real inputs and every synthetic case follow
    em_main = em_buckets.get("bucket_512x512") or next(
        r for r in em_rows if r["tag"] == "0/1 weights" and r["shape"] == [8, 262144, 11])
    brief = ("shape", "weights", "num_iters", "cluster", "route", "kept", "smem", "ms",
             "twin_ms", "plain_ms", "bound_ms", "bound_by", "errs", "max_abs_err", "ties")
    kernels.append({
        "name": "gmm_em", "route": "cuda",
        "source": "topaz_tpu_torch/csrc/gmm_em.cu",
        "replaces": "topaz_tpu/ops/gmm.py:169",
        "launches": GMM_LAUNCHES.get("pipeline"),
        "launches_by_path": {path: GMM_LAUNCHES.get(key) for path, key in (
            ("pipeline", "pipeline"), ("extract", "extract"), ("denoise", "denoise"),
            ("train", "train"), ("train_extract", "train_extract"),
            ("denoise_train", "denoise_train"), ("denoise3d", "denoise3d"),
            ("extract_targets", "extract_targets"), ("extract3d", "extract3d"),
            ("train3d", "train3d"), ("train_ae", "train_ae"), ("sav_extract", "sav_extract"),
            ("warmup", "warmup"), ("serve", "serve"), ("watch", "watch"),
            ("scaleout", "scaleout"), ("scaleout_mesh_pipeline", "scaleout_mesh_pipeline"))},
        "max_abs_err": max(r["max_abs_err"] for r in em_rows + list(em_buckets.values())),
        "shape": em_main["shape"], "cluster": em_main["cluster"], "route": em_main["route"],
        "ms": em_main["ms"], "plain_ms": em_main["plain_ms"],
        "twin_ms": em_main["twin_ms"], "bound_ms": em_main["bound_ms"],
        "bound_by": em_main["bound_by"], "library_ms": None,
        "real": {name: {k: r[k] for k in brief + ("selected_card_vs_cpu",) if k in r}
                 for name, r in em_buckets.items()},
        "cases": [{"tag": r["tag"], **{k: r[k] for k in brief}} for r in em_rows],
    })
    kernels.append({
        "name": "unet_edges", "route": "cuda", "source": "topaz_tpu_torch/csrc/unet_edges.cu",
        "replaces": None, "launches": UNET_EDGE_LAUNCHES.get("denoise_whole"),
        "launches_per_forward": UNET_EDGE_LAUNCHES.get("forward"),
        "launches_by_path": {path: UNET_EDGE_LAUNCHES.get(path) for path in (
            "denoise_whole", "denoise_patched", "pipeline", "denoise3d", "denoise_train",
            "train3d", "warmup", "serve", "serve_denoise", "watch", "scaleout_denoise",
            "scaleout_denoise_d0", "scaleout_mesh_pipeline")},
        "ms": edge_rows[0]["ms"], "library_ms": edge_rows[0]["library_ms"],
        "bound_ms": edge_rows[0]["bound_ms"], "bound_by": "bytes", "cases": edge_rows,
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    if only != set(PHASES):
        print(f"# --only {' '.join(sorted(only))}: a partial run prints no result line")
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
