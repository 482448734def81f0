#!/usr/bin/env python3
"""Drive the PyTorch port's serving (with Grad-CAM, hot reload and the
exported artifact, for all four model families), curation, benchmark,
training, sweep, final-training, batch-prediction, native-decode,
fidelity, monitor, data-parallel and tensor-parallel paths once on one
NVIDIA GPU.

  python3 chip_smoke.py                       # every phase, one card
  python3 chip_smoke.py --phases device,build,kernels
  python3 chip_smoke.py --phases device,build,explain
  python3 chip_smoke.py --phases device,build,families
  python3 chip_smoke.py --phases device,build,train
  python3 chip_smoke.py --phases device,build,families_train
  python3 chip_smoke.py --phases device,build,hyperopt
  python3 chip_smoke.py --phases device,build,final
  python3 chip_smoke.py --phases device,build,decode,fidelity,monitor
  python3 chip_smoke.py --phases device,build,profile
  python3 chip_smoke.py --phases device,build,step_spread
  python3 chip_smoke.py --phases device,build,parallel

Phases, each printing one JSON line:

1. device   — the card (nvidia-smi name and power limit, torch's name).
2. build    — nvcc builds every kernel of irp_tpu_torch/csrc/, one
              process per source, all started together (seconds, ptxas
              register/shared-memory report), while g++ builds the host
              JPEG decoder csrc/decode.cpp (seconds, whether it loads; the
              build log's tail on an earlier line when it does not).
3. kernels  — each kernel's wrapper on the card at the shapes its path
              gives it, timed with CUDA events (median of cold-L2 bursts)
              beside its bound, its plain PyTorch version and a PyTorch
              yardstick call: the columns of PERF.md's kernel table.
              eval_preprocess at B=64, 256 -> 224 bf16; identity
              bottleneck at ResNet50's three shapes, B=32 (yardstick the
              unfused cuDNN block); pairwise_topk on one row block of
              each kNN of the curation path (K3_SHAPES; yardstick
              torch.topk(torch.cdist(...)), two calls; its operation
              bound M N (2D + 1) at the 67 TFLOP/s float32 rate);
              copy_floor at the bottleneck's three shapes (yardstick
              torch.relu), whose time each bottleneck case also shows;
              frozen_epilogue at its 10 sites of a ResNet50/224 forward
              (EPILOGUE_SITES) at B=32 and 256 beside its bytes bound and
              the unfused sequence there (inference BN with its casts,
              ReLU, add, max-pool: parent_ms); batch_norm_train at the 10
              train-mode BatchNorms of ResNet50/224's layer4 (BN_SITES)
              at B=32 and 256, forward and backward, beside the bytes
              bound of the function and of the two-pass design
              (bound_ms_two_pass), and the formula as PyTorch ops with
              autograd's backward (parent_ms).  On the tensors it times,
              each kernel is held against its plain version at these
              shapes and batches (K2 0 bf16 ulp; K1 K1_TOL; K4, E and
              BN's normalisation bit for bit; K3 K3_AGREEMENT and
              K3_TOL; BN's moments, running buffers and gradients at
              BN_MOMENT_TOL and BN_GRAD_FACTOR), and the phase fails if
              one is out of its bar or faults.  The gpu-marked tests
              (tests/test_torch_kernels_card.py and
              tests/test_torch_train_card.py) hold the same bars there
              and at the edges of each kernel's tiling.
4. serve    — ResNet50/224 (10 classes, hidden 512, random weights from a
              seed) saved as .npz, loaded by load_predictor with
              fused_frozen_blocks='auto' and served by make_server;
              concurrent JPEG requests over HTTP.  Every
              response must be 200 with probabilities summing to 1 and
              agree with an unfused predictor on the card, the launch
              counters must show the kernels on that path (K2 once a
              batch, K1 and the frozen epilogue 10 times, the train-mode
              BatchNorm op never), and a float32
              CPU forward must agree on a small input; a predictor loaded
              with no fused flag (the serving default, 'off') must launch
              K1 0 times.  Prints images/s of predict_probs at batch 64
              and 256 and the /stats latency.
5. explain  — the rest of serving at the same ResNet50/224 ('auto', random
              weights from the seed and from seed + 1, as .npz): (a)
              Grad-CAM at batch 8 (K2 once, K1 and the frozen epilogue 10
              times a batch by the counters) against an unfused float32
              Grad-CAM on the card (map max|diff| <= EXPLAIN_CAM_TOL,
              logits within 2^-5, argmax equal) and a float32 CPU one (maps within 1e-4); (b)
              the .irpx exported on the card at batch 256 with the ladder
              (64, 256): its seconds and member bytes, its probabilities
              bit-equal to the live predictor's at 64 and 256, K2 once and
              K1 10 times in its forward and in its explain program, which
              is bit-equal to the live Grad-CAM; images/s of the artifact
              and the live predictor in turns; the same artifact moved to
              the CPU equal to a CPU predictor with K1 'on'; (c) a daemon
              with a reload loader, through ServingClient: 4 clients x 16
              /explain while 8 clients post /predict (every answer 200
              with a PNG, K2 once and K1 10 times per dispatch and per
              explain), then /reload to the seed + 1 weights under the 8
              clients (no failed request, generation 1, probabilities then
              equal to a predictor loaded from those weights); (d) the
              same daemon reloaded to the .irpx (generation 2) answers
              /explain and /predict, K2 once and K1 10 times each.
              Prints Grad-CAM ms per batch, /explain p50/p99, export and
              reload seconds.
6. families — the other model families served at full width (224 crop
              from 256x256, 10 classes, MLP head 512, bf16, random weights
              from the seed): ViT-B/16, ConvNeXt-Tiny and EfficientNet-B0,
              each (a) saved as a flax-layout .npz and loaded by
              load_predictor, whose inferred config must give the family
              and variant, and as a torchvision-layout .pth, whose
              probabilities must equal the .npz's; (b) predict_probs at
              batch 64 and 256 (K2 once a batch, K1 never by the
              counters); (c) its bf16 probabilities against the card's f32
              forward (FAMILY_PROB_TOL), and the card's f32 logits against
              the CPU's on two images (1e-3, TF32 off); (d) Grad-CAM at
              batch 8 (K2 once, K1 never; the map within FAMILY_CAM_TOL of
              the f32 map, the card's and the CPU's f32 maps within 1e-4);
              (e) the .irpx at batch 64 with its explain program, exported
              on the card, its probabilities and maps bit-equal to the live
              predictor's.  Then images/s of predict_probs of the three and
              ResNet50 (the serve phase's, K1 'auto') in turns, forward and
              backward, at 64 and 256; and one daemon on the ViT-B/16
              .npz: 2 rounds of 64 JPEG /predict and 8 /explain from 8
              client threads, every answer 200, /healthz family vit with no
              depth, K2 once per dispatch and K1 never.
7. curation — embedding outlier detection at the Animals-10 scale:
              26,179 synthetic 256x256 images (10 classes, each a smooth
              pattern plus noise, 1% planted with another class's
              pattern) through extract_features (ResNet50/224 bf16, batch
              64, the curation CLI's ModelConfig), create_embeddings
              (PCA-50, supervised UMAP) and detect_outliers (per class and
              global LOF), on the card.  Gates: bf16 features within 2^-5
              of a float32 forward; kNN over the kernel against kNN over
              the plain version at the UMAP kNN (PCA-50: >= 99.9% equal
              indices, distances within 1e-4 relative) and at the global
              and class-0 LOF kNNs on the 2-D embedding (>= 99.9% equal
              indices, squared distances within 1e-5 * max(|x_i|^2 +
              |x_j|^2)); the LOBPCG spectral path; a finite embedding;
              the outlier counts; and the launch counters
              (eval_preprocess once per batch, pairwise_topk once per kNN
              row block).  Prints images/s of extract_features, seconds
              per stage and the share of planted images flagged.
8. bench    — python -m irp_tpu_torch.tools.bench_fused_block: the fused
              block beside its bound, the unfused block, the copy floor
              and torch.relu at B=256.
              Gates: the bottleneck's max|kernel - plain| / max|plain|
              from the tool's run within 2^-6 at each shape, and the
              copy floor bit for bit against clamp_min(0) on one B=256
              input per shape.
9. train    — fit, the fine-tune, at ResNet50/224 bf16 with K1 on
              ('auto'), medium augmentation, adam on OneCycle with class
              weights, batch 32, 2 epochs of 32 steps on 2,048 synthetic
              class-pattern images, eval on 512 each epoch.  Gates: finite
              losses and epoch 2's mean loss below epoch 1's; K1 and the
              frozen epilogue launched 10 times per train and eval
              forward, the train-mode BatchNorm op 10 times per train
              forward (layer4's), K2 once per eval batch; one step at
              random init
              and one from the fit's weights, the same draws, with K1
              and the folded prefix against cuDNN within twice a bf16
              step's measured drift from the f32 step (K1_STEP_TOL; from
              the fit's weights the largest over the step_spread phase's
              readings); the f32 'highest' step on
              the card against the CPU's (CARD_CPU_*_TOL).  Prints train
              images/s at batch 32 with K1 on and off.
10. families_train — training ViT-B/16, ConvNeXt-Tiny and EfficientNet-B0
              at full width (224 crop from 256x256, 10 classes, MLP head
              512, bf16, the variant's stochastic depth and default
              trainable stages, random weights from the seed).  Per
              family: (a) fit, 2 epochs of 16 steps at batch 32 on 1,024
              class-pattern images, eval on 256 each epoch; gates: finite
              losses, epoch 2's mean loss below epoch 1's, K2 once per
              eval batch and K1 never, the train-mode BatchNorm op
              FT_BN_PER_FORWARD times per train forward (EfficientNet-B0's
              4, ViT's and ConvNeXt's 0), every frozen parameter bit-equal
              to its init and every trainable one changed, EfficientNet's
              frozen stages' BN statistics bit-equal; (b) one step at
              batch 8 on given augmentation, stochastic-depth and dropout
              draws: the card's f32 'highest' step (TF32 off) against the
              CPU's on the CPU run's ReLU masks (CARD_CPU_*_TOL per
              tensor; gradients that vanish but for rounding held below
              FT_VANISHING), the free reading beside, and the bf16 step's
              drift from the f32 step (FT_BF16_STEP_TOL).  Then (c)
              ViT-B/16's f32 step at batch 64 with blocks 8-11 trainable,
              remat off and on: the same loss (1e-6 relative) and a lower
              peak; (d) train images/s of train_step at batch 32 and 256,
              ResNet50 (K1 'auto') and the three in turns, and the
              device's idle share at batch 32; (e) on EfficientNet-B0,
              hyperopt_cli --family efficientnet --quick (1 trial x 2
              folds over 1,024 JPEGs), final_cli --family efficientnet (2
              epochs over a one-trial study) and predict_cli --shards over
              its 1,024 test JPEGs: the trial COMPLETE, the five
              artifacts, the .npz loaded as EfficientNet-B0, >= 99.5% of
              predict_cli's labels equal to the test evaluation's, K2 once
              per eval batch and K1 never in each, the BatchNorm op 4 per
              train forward (0 in predict_cli); (f) a ViT-B/16 .pth
              (export_torch_pth) through fit's pretrained_path: eval
              logits bit-equal to the source model's before any step.
11. hyperopt — the k-fold sweep, ResNet50/224 bf16, 10 classes: (a) 12
              WebDataset shards of 3,072 synthetic 256x256 JPEGs written
              from the seed by the port's ShardWriter, then
              hyperopt_cli.main --quick (B=16, 2 epochs) with 3 trials x 3
              folds and the CLI's defaults (K1 'off'), the study and the
              tracking runs in a temporary directory; (b) the same study
              resumed through run_kfold_optimization with
              fused_frozen_blocks='auto' for one more trial; (c) the fold
              pool at N = 26,179 (images made on the card, 27 shards of
              ids, no decode): its upload and select_fold for 3 folds.
              Gates: 4 trials in the database and the resume's "Loaded
              existing study with 3 previous trials"; all 4 trials
              COMPLETE, each value finite; recommended_epochs in each
              complete run's tracking params; K2 once per eval batch
              and K1 10 per forward in (b), 0 in (a); the train-mode
              BatchNorm op 10 per train forward in both; one pool upload
              per run (upload_bytes = N x 196,608 + 4 N) and no per-fit
              upload; each fold's prefix labels equal to
              subset_by_shards's as a multiset.  Prints
              seconds per trial and per fold-fit, the pool's upload and
              select_fold times, and peak memory.
12. final   — final training, test evaluation and batch prediction,
              ResNet50/224 bf16, 10 classes, random init: 12 train
              shards (3,072 images) and 4 test shards (1,024 images of
              the same classes, another seed) written by the port's
              ShardWriter, a one-trial study (batch 32, lr 1e-3, wd 1e-4,
              dropout 0.3, medium aug) whose tracking run holds
              recommended_epochs 6 (FINAL_EPOCHS says why not 2).  (a)
              final_cli at its defaults (K1 'off', 'hbm') with
              --checkpoint-dir; (b) train_final_model with K1 'auto'
              resumed from (a)'s directory after its newest checkpoint is
              removed; (c) predict_cli --shards with (a)'s
              final_model.npz at batch 256 with --fused-frozen-blocks auto
              (--classes: the shards' labels are class names).  Gates: rc 0, final_epochs, test accuracy
              >= 90% and the report's equal to it, the confusion matrix's
              sum, the five artifacts (PNGs open); K2 once per test batch
              and K1 0 in (a); one epoch and K1 10 per train and eval
              forward in (b), test accuracy >= 90%; the train-mode
              BatchNorm op 10 per train forward in (a) and (b), 0 in (c);
              in (c) >= 99.5% of
              labels equal to (a)'s evaluation, accuracy within 0.5
              points, K2 4 and K1 40, and the .pth and .npz predictors'
              probabilities bit-equal on one batch.  Prints the fit's
              seconds and train images/s, the test evaluation's seconds
              and images/s, predict_cli's images/s and peak memory.
13. decode  — the native JPEG decoder where it built on this host: (a)
              against PIL on 256 JPEGs of 64-640 px sides, one in eight
              grayscale and one in eight progressive (within 1/255, all
              decoded; seconds and images/s of each); (b) a non-image and a
              PNG flagged, the PNG filled by PIL in decode_blobs; (c)
              build_cache over 4 shards of 256 JPEGs (150-500 px) with
              use_native against PIL (keys equal, within 1/255; seconds and
              images/s); (d) predict_cli --shards over them at batch 256
              (ResNet50/224, the default 'off'), --decoder auto and pil
              in turns, 3 runs each: images/s, >= 99.5% of labels equal,
              K2 4 and K1 0 a run.  Where the decoder did not build, none
              of it runs: the phase prints why and checks that 'auto'
              decodes with PIL there.
14. fidelity — fidelity_cli on the card at 224 px in f32 ('highest', TF32
              off, unfused, eval-form BN) for ResNet50, ViT-B/16,
              ConvNeXt-Tiny and EfficientNet-B0, seed-0 weights, 64
              samples of one shard: each exits 0 (max |logit diff| to the
              torchvision-layout executor <= 1e-3), K2 once and K1 never.
15. monitor — device_memory_stats on the card (in-use, peak and limit GB)
              and a profile_trace around one predict batch, whose Chrome
              trace must name K2's kernel.
16. parallel — data parallelism at ResNet50/224 bf16 'auto' (10 classes,
              hidden 512, random weights from the seed): (1) fit, 2 epochs
              of 4 steps at B=32 with eval on 128, over an NCCL process
              group of one rank on cuda:0 against the same fit without a
              group (bit-equal: PAR_TOL's world-1 bars are 0), K1 and K2
              launches equal; (2) two processes of this script
              (--two-rank-worker), ranks 0 and 1 over gloo sharing cuda:0
              (NCCL refuses two ranks on one device), at global B=64, 32
              a rank: fit in stream mode (Adam, 2 x 4 steps, eval on
              128) and one SGD train_step with mixup 0.4 and class
              weights on a given global batch (sorted by label: the ranks
              hold different classes) and draws, each in bfloat16 and in
              float32 ('highest', unfused), against one process at B=64
              on the same global batch and draws (rows ordered so that
              its reversed batch pairs within each half): the ranks'
              weights bit-equal; the SGD step's loss, layer4/head update
              and BN running-statistic gaps within PAR_TOL or PAR_FLOOR_X
              times the gap of the reference run again (the card's
              run-to-run floor), and the same step with a fault planted
              in the ranks (PAR_FAULTS: each rank's own BN moments; in
              f32 also each rank's own loss denominator, gradients
              averaged) outside that limit; the fits' gaps printed, not
              gated; each rank's step ms printed as a host figure; (3)
              two replicas (replicate_predictor on [cuda:0, cuda:0]) behind
              make_server, 2 rounds of 64 JPEGs from 8 clients: no failed
              request, both replicas dispatched (/stats per_replica), the
              answers equal to the single predictor's to the 6 decimals
              HTTP carries and each replica's probabilities bit-equal, K2
              once and K1 10 times a batch; images/s of rounds in turns
              with the one-replica daemon; (4) a local mesh [cuda:0,
              cuda:0]: Predictor(mesh=) at batch 256 and
              extract_features(mesh=) at 64 over 1,024 images against the
              unsharded paths (within PAR_PRED_TOL), K2 once per part, and
              predict_cli --data-parallel on the card's default mesh (one
              device) writing the CSV the run without it writes; (5) 2
              quick trials (k = 2, 512 JPEGs) on two sweep workers
              sharing cuda:0 and in sequence: every trial COMPLETE or
              PRUNED, the pools released, wall seconds of each in turns
              (sequential, two workers, two workers, sequential); (6) the
              model axis (tensor parallelism): the two ranks of (2) again
              as a data=1 x model=2 mesh, the head and every ViT and
              ConvNeXt block Megatron-split over them: ViT-B/16 and
              ConvNeXt-Tiny at 224 (_family_model's weights), the eval
              forward of 32 images in f32 'highest' and in bf16, and one
              f32 SGD step of ViT-B/16 with mixup and class weights,
              against one process on the same inputs (TP_TOL, or
              TP_FLOOR_X times the one-process rerun), the ranks
              bit-equal, the step with each of TP_FAULTS planted (g with
              an all-reduce backward; the gradients summed over the
              world) past that limit; ResNet50 with its head split: fit
              (2 x 4 steps at B=64, eval on 128, K1 'auto') then
              train_final_model (one epoch), the ranks' histories and
              models bit-equal and whole, world rank 0 alone writing,
              its final .npz through load_predictor equal to the
              gathered model bit for bit, K1 and K2 launched on each
              rank; each rank's forward and step ms printed as host
              figures.
17. profile — only when named in --phases: torch.profiler over batches
              of 64 through predict_probs (device time by kernel group,
              the device's idle share), and one train step at B=32 split
              by CUDA events into augmentation, frozen forward (K1),
              layer4 forward, head and loss, backward and optimizer, with
              its own trace.
18. step_spread — only when named in --phases: K1_STEP_TOL's readings
              over STEP_SPREAD_SEEDS seeds x STEP_SPREAD_BATCHES batches:
              per seed the train phase's fit, then at random init and
              from the fit's weights one bf16 step each of 'auto', the
              parent's path (K1 alone, the stem and blocks 0 unfolded)
              and 'off', and the f32 step; each one's gaps from f32 and
              from 'off', per state the median and largest.

Then the card's nvidia-smi line, one JSON object with every kernel's
numbers (launches summed over the paths that ran it; K1's and K4's
B=256 times from the bench phase under "b256", the epilogue's and the
train-mode BatchNorm's from the kernels phase), and last {"ok":
true, "device": {...}}.  Exits non-zero, with no result, when there is no
CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import csv
import functools
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

# the port, from the checkout this script sits in; without it this raises
# before anything runs.  gpu_ms: median device time over cold-L2 bursts;
# bound: the least time for given bytes and operations on the H100 SXM.
from irp_tpu_torch.tools.bench_fused_block import (bound, gpu_ms, k1_bound,
                                                   n_sets)

PEAK_FP32_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
PHASES = ("device", "build", "kernels", "serve", "explain", "families",
          "curation", "bench", "train", "families_train", "hyperopt",
          "final", "decode", "fidelity", "monitor", "parallel")
EXTRA_PHASES = ("profile", "step_spread")  # run only when named
# (name, H, W, C, M, blocks per ResNet50 forward)
BOTTLENECK_SHAPES = (("layer1", 56, 56, 256, 64, 2),
                     ("layer2", 28, 28, 512, 128, 3),
                     ("layer3", 14, 14, 1024, 256, 5))
# Each kernel's bar against its plain version, here and in the gpu tests.
# K1: max|kernel - plain| / max|plain|.  K3: share of equal indices, and
# squared distances over max(|a_i|^2 + |b_j|^2): both sum |a|^2 + |b|^2 -
# 2ab in f32 in different orders, so near ties may swap.  BN: moments
# over E|x| and E[x^2] per channel, and each gradient's error against
# f64 over the plain backward's own f32 error.  K2 is 0 bf16 ulp; K4, E
# and BN's normalisation are bit for bit.
K1_TOL = 2.0 ** -6
K3_AGREEMENT, K3_TOL = 0.999, 1e-5
BN_MOMENT_TOL, BN_GRAD_FACTOR = 1e-5, 2.0
# (site, H, W, C, kind): the frozen epilogue's 10 passes in one ResNet50/224
# forward, y's NHWC shape per image: the stem's pooled pass, then in each
# frozen block 0 (layers 1-3) conv1's and conv2's relu(y + b) and the
# tail's relu(y + r + (b + b_r)); timed at the smoke's B=32 and the
# benchmark cell's B=256
EPILOGUE_SITES = (("stem", 112, 112, 64, "pool"),) + tuple(
    (f"{layer}.0.{part}", n, n, ch, kind)
    for layer, hw, m, s in (("layer1", 56, 64, 1), ("layer2", 56, 128, 2),
                            ("layer3", 28, 256, 2))
    for part, n, ch, kind in (("conv1", hw, m, "relu"),
                              ("conv2", hw // s, m, "relu"),
                              ("tail", hw // s, 4 * m, "tail")))
EPILOGUE_BATCHES = (32, 256)
# (site, C, H, W): the train-mode BatchNorm's 10 maps in ResNet50/224's
# layer4 (block 0's bn1 before the stride, then 7x7), timed at the smoke's
# B=32 and the benchmark cell's B=256
BN_SITES = (("layer4.0.bn1", 512, 14, 14), ("layer4.0.bn2", 512, 7, 7),
            ("layer4.0.bn3", 2048, 7, 7),
            ("layer4.0.downsample.1", 2048, 7, 7)) + tuple(
    (f"layer4.{j}.bn{k}", 2048 if k == 3 else 512, 7, 7)
    for j in (1, 2) for k in (1, 2, 3))
# Served probabilities against the unfused predictor, and each bf16
# forward against the float32 one.  At the head's init scale each bf16
# forward drifts up to about 0.008 from the float32 forward on the card
# (unfused 0.0076, fused 0.0083), so two of them can differ by twice that.
PROB_TOL = 2e-2
# max|fused - unfused| / max|unfused| over the logits: two bf16 forwards
# that round at different points through 50 layers
LOGIT_TOL = 2.0 ** -5
N_REQUESTS = 64  # JPEG requests per round of the serve phase
N_CLIENTS = 8  # concurrent client threads sending them
# the curation kNN's row block against every point of the dataset:
# Animals-10 after ingest has 26,179 images
K3_ROWS, N_IMAGES = 1024, 26_179
N_CLASSES = 10
PLANTED_SHARE = 0.01  # images carrying another class's pattern
FEATURE_BATCH = 64
# bf16 features against the float32 forward, max|diff| / max|f32|
FEATURE_TOL = 2.0 ** -5


def emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


# -- phases -----------------------------------------------------------------

def phase_device(out: dict) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out["smi"] = smi
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build(out: dict) -> None:
    from irp_tpu_torch import _kernels
    from irp_tpu_torch.data import jpeg

    # g++ builds the host decoder while nvcc builds the kernels
    decoder = {}

    def build_decoder():
        t0 = time.perf_counter()
        decoder["loads"] = jpeg.native_decoder_available()
        decoder["seconds"] = round(time.perf_counter() - t0, 3)

    thread = threading.Thread(target=build_decoder)
    thread.start()
    seconds = _kernels.build_all()
    report = {}
    for name in _kernels.SOURCES:
        _kernels.load(name)
        report[name] = [ln.strip() for ln in _kernels.build_log(name)
                        .splitlines() if "registers" in ln or "spill" in ln
                        or "smem" in ln]
    thread.join()
    if not decoder["loads"]:
        print("build: the native JPEG decoder (irp_tpu_torch/csrc/"
              "decode.cpp) did not build or load on this host; its build "
              "log ends:\n" + jpeg.build_log_tail(), flush=True)
    out["decoder_loads"] = decoder["loads"]
    emit({"phase": "build", "seconds": round(seconds, 3), "ptxas": report,
          "native_decoder": {"source": "irp_tpu_torch/csrc/decode.cpp",
                             "route": "host C++ (g++), not a kernel",
                             **decoder}})


def _k2_entry(gen) -> dict:
    from irp_tpu_torch.ops.cuda_image import (eval_preprocess,
                                              eval_preprocess_plain)

    b, s, o = 64, 256, 224
    sets = [torch.randint(0, 256, (b, s, s, 3), generator=gen,
                          dtype=torch.uint8).cuda() for _ in range(4)]
    got, want = eval_preprocess(sets[0], o), eval_preprocess_plain(sets[0], o)
    # equal bf16 values: 0 ulp apart
    equal = bool(torch.equal(got, want))
    n_bytes = b * o * o * 3 * (1 + 2)
    bound_ms, bound_by = bound(n_bytes, 2 * b * o * o * 3)
    return {
        "name": "eval_preprocess", "route": "cuda",
        "source": "irp_tpu_torch/csrc/eval_preprocess.cu",
        "replaces": "irp_tpu/ops/pallas_image.py:79",
        "shape": f"({b},{s},{s},3) u8 -> ({b},{o},{o},3) bf16",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "tolerance": "0 bf16 ulp", "ok": equal,
        "ms": gpu_ms([lambda x=x: eval_preprocess(x, o) for x in sets]),
        "plain_ms": gpu_ms([lambda x=x: eval_preprocess_plain(x, o)
                            for x in sets]),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _k1_case(gen, name, h, w, c, m, b=32):
    from irp_tpu_torch.ops.cuda_resnet import (fused_identity_bottleneck,
                                               reference_identity_bottleneck)
    from irp_tpu_torch.tools.bench_fused_block import random_identity_block

    # one random identity block; BN stats perturbed so the folding matters
    block = random_identity_block(c, m, gen)
    # folded once, as the Predictor caches them for the serve path
    weights = block.folded_weights()
    set_bytes = 2 * b * h * w * c * 2
    xs = [torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16).cuda()
          for _ in range(n_sets(set_bytes))]
    got = fused_identity_bottleneck(xs[0], *weights).float()
    want = reference_identity_bottleneck(xs[0], *weights).float()
    rel = float((got - want).abs().max() / want.abs().max())
    bound_ms, bound_by = k1_bound(b, h, w, c, m)

    def unfused_call(x):
        with torch.inference_mode():
            block(x.permute(0, 3, 1, 2), fused=False)

    return {
        "name": name, "shape": f"B={b} H={h} W={w} C={c} M={m}",
        "rel_err": rel, "ok": rel <= K1_TOL,
        "ms": gpu_ms([lambda x=x: fused_identity_bottleneck(x, *weights)
                      for x in xs]),
        "plain_ms": gpu_ms([lambda x=x: reference_identity_bottleneck(
            x, *weights) for x in xs]),
        "unfused_block_ms": gpu_ms([lambda x=x: unfused_call(x)
                                    for x in xs]),
        "bound_ms": bound_ms, "bound_by": bound_by}


# (name, M, N, D, k): one row block of each kNN of the curation path: the
# UMAP kNN on PCA-50, the global LOF kNN on the 2-D embedding and a
# per-class LOF kNN (a class of ~2,618 of the 26,179 images)
K3_SHAPES = (("umap", K3_ROWS, N_IMAGES, 50, 15),
             ("lof_global", K3_ROWS, N_IMAGES, 2, 75),
             ("lof_class", K3_ROWS, 2618, 2, 30))


def _k3_case(gen, name, m, n, d, k) -> dict:
    """pairwise_topk on one kNN row block: rows 0..m-1 of n points against
    all of them, itself left out (self_offset 0), at width d padded to a
    multiple of 4 as knn pads it."""
    import torch.nn.functional as F

    from irp_tpu_torch.ops.cuda_image import pairwise_topk, pairwise_topk_plain

    # the plain version is the f32 cuBLAS product: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    dp = -(-d // 4) * 4
    set_bytes = (n * d + n) * 4 + m * n * 4  # an (M, N) f32 tile included
    sets = []
    for _ in range(n_sets(set_bytes)):
        b = torch.randn(n, d, generator=gen).cuda()
        b_sq = (b * b).sum(dim=1)
        bp = F.pad(b, (0, dp - d)).contiguous()
        sets.append((bp[:m], bp, b_sq[:m], b_sq, b[:m], b))
    ap, bp, a_sq, b_sq, a, b = sets[0]
    got = pairwise_topk(ap, bp, k, a_sq, b_sq, self_offset=0)
    want = pairwise_topk_plain(ap, bp, k, a_sq, b_sq, self_offset=0)
    share = float((got[1] == want[1]).float().mean())
    gap = float((got[0] - want[0]).abs().max()
                / ((a * a).sum(1).max() + (b * b).sum(1).max()))
    n_bytes = (m * d + n * d + m + n) * 4 + m * k * 8
    bound_ms, bound_by = bound(n_bytes, m * n * (2 * d + 1), PEAK_FP32_FLOPS)
    return {
        "case": name, "shape": f"({m},{d}) x ({n},{d}) f32, k={k}",
        "index_agreement": share, "sq_dist_gap_over_scale": gap,
        "ok": share >= K3_AGREEMENT and gap <= K3_TOL,
        "ms": gpu_ms([lambda s=s: pairwise_topk(s[0], s[1], k, s[2], s[3],
                                                self_offset=0)
                      for s in sets]),
        "plain_ms": gpu_ms([lambda s=s: pairwise_topk_plain(
            s[0], s[1], k, s[2], s[3], self_offset=0) for s in sets]),
        # two PyTorch calls: no single one computes a kNN
        "library_ms": gpu_ms([lambda s=s: torch.topk(torch.cdist(
            s[4], s[5], compute_mode="use_mm_for_euclid_dist"), k,
            largest=False) for s in sets]),
        "library": "torch.topk(torch.cdist(a, b), k, largest=False)",
        "bound_ms": bound_ms, "bound_by": bound_by}


def _k4_case(gen, h, w, c, b=32) -> dict:
    """copy_floor (relu copy) at one bottleneck shape."""
    from irp_tpu_torch.ops.cuda_resnet import relu_copy, relu_copy_plain

    set_bytes = 2 * b * h * w * c * 2
    xs = [torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16).cuda()
          for _ in range(n_sets(set_bytes))]
    bit_equal = bool(torch.equal(relu_copy(xs[0]).view(torch.int16),
                                 relu_copy_plain(xs[0]).view(torch.int16)))
    bound_ms, bound_by = bound(set_bytes, b * h * w * c)
    return {
        "shape": f"({b},{h},{w},{c}) bf16", "bit_equal": bit_equal,
        "ok": bit_equal,
        "ms": gpu_ms([lambda x=x: relu_copy(x) for x in xs]),
        "plain_ms": gpu_ms([lambda x=x: relu_copy_plain(x) for x in xs]),
        "library_ms": gpu_ms([lambda x=x: torch.relu(x) for x in xs]),
        "bound_ms": bound_ms, "bound_by": bound_by}


def _epilogue_case(gen, site, h, w, c, kind, b) -> dict:
    """The frozen epilogue at one site at batch ``b``: the wrapper bit for
    bit against its plain version on the same card tensors; device times
    (:func:`gpu_ms`, cold L2) of the kernel, its plain version and the
    unfused sequence at the site (inference BN with its casts, then ReLU,
    the residual add or the max-pool); the bound from the bytes the
    kernel reads and writes."""
    import torch.nn.functional as F

    from irp_tpu_torch.models.resnet import BatchNorm2d
    from irp_tpu_torch.ops.cuda_resnet import (frozen_epilogue,
                                               frozen_epilogue_plain)

    pool, tail = kind == "pool", kind == "tail"

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    set_bytes = b * h * w * c * 2 * (2 if tail else 1)
    sets = [((rand(b, h, w, c) * 3).to(torch.bfloat16),
             (rand(b, h, w, c) * 3).to(torch.bfloat16) if tail else None)
            for _ in range(n_sets(set_bytes))]
    bias = rand(c)
    b_r = rand(c) if tail else None
    bns = [BatchNorm2d(c, torch.bfloat16, frozen=True).cuda().eval()
           for _ in range(2)]
    y, r = sets[0]
    got = frozen_epilogue(y, bias, r, b_r, pool)
    want = frozen_epilogue_plain(y, bias, r, b_r, pool)
    bit_equal = got.shape == want.shape and bool(torch.equal(
        got.view(torch.int16), want.view(torch.int16)))

    def parent(y, r):
        with torch.inference_mode():
            z = bns[0](y.permute(0, 3, 1, 2))
            if tail:
                z = z + bns[1](r.permute(0, 3, 1, 2))
            z = F.relu(z)
            return F.max_pool2d(z, 3, 2, 1) if pool else z

    n_bytes = set_bytes + got.numel() * 2 + 4 * c * (2 if tail else 1)
    bound_ms, bound_by = bound(n_bytes, 0)
    return {
        "site": site, "shape": f"({b},{h},{w},{c}) bf16", "kind": kind,
        "bit_equal": bit_equal, "ok": bit_equal, "bytes": n_bytes,
        "ms": gpu_ms([lambda y=y, r=r: frozen_epilogue(y, bias, r, b_r, pool)
                      for y, r in sets]),
        "plain_ms": gpu_ms([lambda y=y, r=r: frozen_epilogue_plain(
            y, bias, r, b_r, pool) for y, r in sets]),
        "parent_ms": gpu_ms([lambda y=y, r=r: parent(y, r)
                             for y, r in sets]),
        "bound_ms": bound_ms, "bound_by": bound_by}


def _epilogue_entry(seed: int) -> dict:
    """The frozen epilogue's kernel entry: its 10 sites of one ResNet50
    forward (EPILOGUE_SITES) at each of EPILOGUE_BATCHES, each site's
    times and bytes summed per forward; the entry's own figures are the
    smoke's batch, ``b256`` the benchmark cell's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = ("ms", "plain_ms", "parent_ms", "bound_ms", "bytes")
    forwards = {}
    for b in EPILOGUE_BATCHES:
        cases = [_epilogue_case(gen, *site, b) for site in EPILOGUE_SITES]
        for cs in cases:
            emit({"phase": "kernels", "kernel": "frozen_epilogue",
                  "case": cs})
        forwards[b] = {"cases": cases, **{
            key: sum(cs[key] for cs in cases) for key in keys}}
    smoke = forwards[EPILOGUE_BATCHES[0]]
    return {"name": "frozen_epilogue", "route": "cuda",
            "source": "irp_tpu_torch/csrc/frozen_epilogue.cu",
            "replaces": None,
            "note": "the port's own: the JAX package has no kernel here "
                    "(XLA fuses these BNs); parent_ms is the port's "
                    "unfused sequence at the same sites",
            "shape": "the 10 sites of one ResNet50/224 forward at "
                     f"B={EPILOGUE_BATCHES[0]}",
            "tolerance": "bit for bit",
            "ok": all(cs["ok"] for f in forwards.values()
                      for cs in f["cases"]),
            "cases": smoke["cases"], "bound_by": "bytes",
            "library_ms": None, **{key: smoke[key] for key in keys},
            "b256": {key: forwards[256][key] for key in keys}}


def _rel_err(got, want) -> float:
    """Norm of ``got - want`` over the norm of ``want``, in f64."""
    want = want.double()
    return float((got.double() - want).norm()
                 / want.norm().clamp_min(1e-300))


def _bn_case(gen, site, c, h, w, b) -> dict:
    """The train-mode BatchNorm op at one site at batch ``b``: each of its
    four kernels against its plain version on the same card tensors
    (``bn_fw_stats``'s moments and the running buffers it moves or holds,
    ``bn_fw_normalize`` given the plain moments, ``bn_bw_reduce`` and
    ``bn_bw_dx``'s dx, dweight and dbias against the plain backward in
    f64 given the kernel's moments); device times
    (:func:`gpu_ms`, cold L2) of the kernels forward (moments and
    normalisation) and backward (sums and dx), of the plain versions, and
    of the parent's formula as PyTorch ops (forward with autograd's graph,
    then its backward); the bound from the bytes the function moves (x
    read and y written; dy and x read and dx written), and the two-pass
    design's (x read twice; dy and x read twice)."""
    from irp_tpu_torch.models.layers import at_least_f32
    from irp_tpu_torch.ops import cuda_batch_norm as bn

    eps, momentum = 1e-5, 0.1

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def bf16(t):
        return t.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    numel = b * c * h * w
    sets = [(bf16(rand(b, c, h, w) * 1.5 + 0.3), bf16(rand(b, c, h, w)))
            for _ in range(n_sets(numel * 4))]
    weight = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = rand(c)
    running = (rand(c), torch.rand(c, generator=gen, device="cuda") + 0.5)
    x, dy = sets[0]
    xf = x.float()
    _, plain = bn.batch_norm_train_plain(x, weight, bias, eps)
    moved, held, want = ([t.clone() for t in running] for _ in range(3))
    moments = bn._stats_cuda(x, *moved, momentum, True)
    bn._stats_cuda(x, *held, momentum, False)
    bn.update_running_stats(*want, moments[0], moments[1], momentum)
    dims = (0, 2, 3)
    moment_err = max(
        float(((moments[0] - plain[0]).abs() / xf.abs().mean(dims)).max()),
        float(((moments[1] - plain[1]).abs() / (xf * xf).mean(dims)).max()))
    buffers_ok = (all(map(torch.equal, moved, want))
                  and all(map(torch.equal, held, running)))
    y = bn._normalize_cuda(x, plain, weight, bias, eps)
    y_plain = bn.normalize_plain(xf, plain[0], plain[1], weight, bias, eps)
    bit_equal = bool(torch.equal(y.view(torch.int16),
                                 y_plain.to(torch.bfloat16).view(torch.int16)))
    f64 = bn.batch_norm_train_backward_plain(
        dy, x.double(), moments.double(), weight.double(), eps)
    # each gradient's error against f64 over the plain backward's own
    grad_err = max(_rel_err(g, r) / max(_rel_err(p, r), 1e-300)
                   for g, p, r in zip(
                       bn._backward_cuda(dy, x, moments, weight, eps, True),
                       bn.batch_norm_train_backward_plain(
                           dy, x, moments, weight, eps), f64))
    del f64
    saved = [bn._forward_cuda(x, weight, bias, *running, momentum, eps, True)
             for x, _ in sets]

    def parent(x):
        xf = at_least_f32(x.detach().requires_grad_(True))
        mean, ex2 = bn.batch_moments(xf)
        var_raw = ex2 - mean * mean
        bn.update_running_stats(*running, mean, var_raw, momentum)
        return bn.normalize_plain(
            xf, mean, var_raw, weight.detach().requires_grad_(True),
            bias.detach().requires_grad_(True), eps).to(torch.bfloat16)

    # bytes the function moves (each tensor once) and the two-pass design
    fw_bytes, bw_bytes = 2 * numel * 2 + 8 * c * 4, 3 * numel * 2 + 8 * c * 4
    fw_two, bw_two = 3 * numel * 2 + 8 * c * 4, 5 * numel * 2 + 8 * c * 4
    ms_fw = gpu_ms([lambda x=x: bn._forward_cuda(
        x, weight, bias, *running, momentum, eps, True) for x, _ in sets])
    ms_bw = gpu_ms([lambda dy=dy, s=s: bn._backward_cuda(
        dy, s[0], s[2], weight, eps, True) for (_, dy), s in zip(sets, saved)])
    plain_fw = gpu_ms([lambda x=x: bn.batch_norm_train_plain(
        x, weight, bias, eps) for x, _ in sets])
    plain_bw = gpu_ms([
        lambda x=x, dy=dy, s=s: bn.batch_norm_train_backward_plain(
            dy, x, s[2], weight, eps) for (x, dy), s in zip(sets, saved)])
    parent_fw = gpu_ms([lambda x=x: parent(x) for x, _ in sets])
    parent_fb = gpu_ms([lambda x=x, dy=dy: parent(x).backward(dy)
                        for x, dy in sets])
    bound_ms, bound_by = bound(fw_bytes + bw_bytes, 0)
    return {
        "site": site, "shape": f"({b},{c},{h},{w}) bf16 channels_last",
        "moment_err": moment_err, "buffers_ok": buffers_ok,
        "bit_equal": bit_equal, "grad_err_over_plain": grad_err,
        "ok": (moment_err <= BN_MOMENT_TOL and buffers_ok and bit_equal
               and grad_err <= BN_GRAD_FACTOR),
        "bytes": fw_bytes + bw_bytes, "bytes_two_pass": fw_two + bw_two,
        "ms": ms_fw + ms_bw, "ms_forward": ms_fw, "ms_backward": ms_bw,
        "plain_ms": plain_fw + plain_bw, "parent_ms": parent_fb,
        "parent_ms_forward": parent_fw,
        "bound_ms": bound_ms, "bound_ms_forward": bound(fw_bytes, 0)[0],
        "bound_ms_backward": bound(bw_bytes, 0)[0],
        "bound_ms_two_pass": bound(fw_two + bw_two, 0)[0],
        "bound_by": bound_by}


def _bn_entry(seed: int) -> dict:
    """The train-mode BatchNorm's kernel entry: its 10 sites of one
    ResNet50 layer4 (BN_SITES) at each of EPILOGUE_BATCHES, each site's
    times and bytes summed per forward and backward; the entry's own
    figures are the smoke's batch, ``b256`` the benchmark cell's."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    keys = ("ms", "ms_forward", "ms_backward", "plain_ms", "parent_ms",
            "parent_ms_forward", "bound_ms", "bound_ms_forward",
            "bound_ms_backward", "bound_ms_two_pass", "bytes",
            "bytes_two_pass")
    steps = {}
    for b in EPILOGUE_BATCHES:
        cases = [_bn_case(gen, *site, b) for site in BN_SITES]
        for cs in cases:
            emit({"phase": "kernels", "kernel": "batch_norm_train",
                  "case": cs})
        steps[b] = {"cases": cases, **{
            key: sum(cs[key] for cs in cases) for key in keys}}
    smoke = steps[EPILOGUE_BATCHES[0]]
    return {"name": "batch_norm_train", "route": "cuda",
            "source": "irp_tpu_torch/csrc/bn_train.cu", "replaces": None,
            "note": "the port's own: the JAX package has no kernel here "
                    "(XLA fuses and differentiates this BN); parent_ms is "
                    "the port's formula as PyTorch ops, forward and "
                    "autograd's backward, at the same sites",
            "shape": "the 10 train-mode BNs of one ResNet50/224 layer4 at "
                     f"B={EPILOGUE_BATCHES[0]}, forward and backward",
            "tolerance": f"moments within {BN_MOMENT_TOL:g} of E|x| and "
                         "E[x^2]; running buffers and normalisation bit for "
                         f"bit; dx, dweight, dbias within {BN_GRAD_FACTOR:g} "
                         "times the plain backward's f32 error of f64",
            "ok": all(cs["ok"] for f in steps.values() for cs in f["cases"]),
            "max_grad_err_over_plain": max(
                cs["grad_err_over_plain"] for f in steps.values()
                for cs in f["cases"]),
            "cases": smoke["cases"], "bound_by": "bytes",
            "library_ms": None, **{key: smoke[key] for key in keys},
            "b256": {key: steps[256][key] for key in keys}}


def _per_forward(cases, keys) -> dict:
    """Sum of the cases' times weighted by blocks per ResNet50 forward."""
    out = {key: sum(cs[key] * cs["per_forward"] for cs in cases)
           for key in keys}
    out["bound_by"] = ("bytes" if all(cs["bound_by"] == "bytes"
                                      for cs in cases) else "operations")
    return out


def phase_kernels(out: dict, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    k2 = _k2_entry(gen)
    emit({"phase": "kernels", "kernel": k2})
    k1_cases, k4_cases = [], []
    for name, h, w, c, m, per_fwd in BOTTLENECK_SHAPES:
        k4_case = _k4_case(gen, h, w, c)
        k4_case.update(name=name, per_forward=per_fwd)
        emit({"phase": "kernels", "kernel": "copy_floor", "case": k4_case})
        k4_cases.append(k4_case)
        case = _k1_case(gen, name, h, w, c, m)
        case.update(per_forward=per_fwd, copy_floor_ms=k4_case["ms"])
        emit({"phase": "kernels", "kernel": "identity_bottleneck",
              "case": case})
        k1_cases.append(case)
    # one entry per kernel: the bottleneck's work is one ResNet50 forward's
    # 10 launches at B=32 (2 x layer1, 3 x layer2, 5 x layer3), and the
    # copy floor's the same 10 shapes
    k1 = {"name": "identity_bottleneck", "route": "cuda",
          "source": "irp_tpu_torch/csrc/identity_bottleneck.cu",
          "replaces": "irp_tpu/ops/pallas_resnet.py:140",
          "shape": "10 blocks of one ResNet50 forward at B=32",
          "max_rel_err": max(cs["rel_err"] for cs in k1_cases),
          "tolerance": "max|kernel-plain|/max|plain| <= 2^-6",
          "ok": all(cs["ok"] for cs in k1_cases), "cases": k1_cases,
          **_per_forward(k1_cases, ("ms", "plain_ms", "bound_ms",
                                    "unfused_block_ms", "copy_floor_ms"))}
    # the unfused cuDNN block is the yardstick PyTorch call
    k1["library_ms"] = k1.pop("unfused_block_ms")
    k4 = {"name": "copy_floor", "route": "cuda",
          "source": "irp_tpu_torch/csrc/copy_floor.cu",
          "replaces": "tools/bench_fused_block.py:63",
          "shape": "the 10 bottleneck shapes of one ResNet50 forward at B=32",
          "tolerance": "bit for bit", "ok": all(cs["ok"] for cs in k4_cases),
          "cases": k4_cases,
          **_per_forward(k4_cases, ("ms", "plain_ms", "bound_ms",
                                    "library_ms"))}
    k3_cases = []
    for name, m, n, d, k in K3_SHAPES:
        case = _k3_case(gen, name, m, n, d, k)
        emit({"phase": "kernels", "kernel": "pairwise_topk", "case": case})
        k3_cases.append(case)
    # the kernel's entry is one row block of the UMAP kNN (D = 50)
    k3 = {"name": "pairwise_topk", "route": "cuda",
          "source": "irp_tpu_torch/csrc/pairwise_topk.cu",
          "replaces": "irp_tpu/ops/pallas_image.py:123",
          "note": "fuses the top-k that both packages' knn apply to that "
                  "kernel's output",
          "tolerance": ">= 99.9% equal indices, squared distances within "
                       "1e-5 * max(|a_i|^2+|b_j|^2)",
          "ok": all(cs["ok"] for cs in k3_cases), "cases": k3_cases,
          **{key: k3_cases[0][key] for key in (
              "shape", "ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by")}}
    e = _epilogue_entry(seed)
    bnt = _bn_entry(seed)
    for k in (k1, k3, k4, e, bnt):
        emit({"phase": "kernels", "kernel": {
            key: v for key, v in k.items() if key != "cases"}})
    kernels = (k2, k1, k3, k4, e, bnt)
    out["kernels"] = {k["name"]: k for k in kernels}
    bad = [k["name"] for k in kernels if not k["ok"]]
    if bad:
        raise RuntimeError(f"kernels out of tolerance: {bad}")


def _random_state_dict(seed: int) -> dict:
    """ResNet50/224 classifier (10 classes, hidden 512) from a seeded
    generator, BN affine and running stats perturbed, as the port's
    state_dict."""
    from irp_tpu_torch.config import ModelConfig
    from irp_tpu_torch.models.classifier import init_classifier

    gen = torch.Generator().manual_seed(seed)
    cfg = ModelConfig(depth=50, num_classes=10, image_size=224,
                      hidden_dim=512)
    model = init_classifier(cfg, gen, device="cpu")
    sd = model.state_dict()
    for key, t in sd.items():
        if key.endswith("running_mean"):
            t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
        elif key.endswith("running_var"):
            t.copy_(0.5 + torch.rand(t.shape, generator=gen))
        elif "bn" in key or "downsample.1" in key:
            if key.endswith("weight"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif key.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return sd


def _random_variables(seed: int):
    """:func:`_random_state_dict` as a {'params', 'batch_stats'} tree."""
    from irp_tpu_torch.models.convert import state_dict_to_jax_variables

    return state_dict_to_jax_variables(_random_state_dict(seed))


def _jpegs(seed: int, n: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    blobs = []
    for i in range(n):
        # smooth random images (upsampled noise) at varied sizes
        side = int(rng.integers(200, 400))
        small = rng.integers(0, 256, (side // 8, side // 8, 3), np.uint8)
        img = Image.fromarray(small).resize((side, side), Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        blobs.append(buf.getvalue())
    return blobs


def _post(url: str, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _logits(pred, images: np.ndarray) -> np.ndarray:
    """The predictor's model on its own preprocessing, logits to host."""
    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

    cfg = pred.model.config
    dtype = getattr(torch, cfg.compute_dtype)
    with torch.inference_mode():
        x = eval_preprocess_batch(torch.from_numpy(images).to(pred.device),
                                  cfg.image_size, dtype)
        return pred.model(x.permute(0, 3, 1, 2)).float().cpu().numpy()


def _cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` runs of ``fn`` (after one warm run: cuDNN's
    algorithm choice), CUDA events; ``fn`` ends on the host (its outputs
    copied back)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _images_per_s(pred, images: np.ndarray, reps: int = 5) -> float:
    return images.shape[0] / (_cuda_ms(lambda: pred.predict_probs(images),
                                       reps) / 1e3)


def phase_serve(out: dict, seed: int) -> None:
    from irp_tpu_torch.data.pipeline import decode_blobs
    from irp_tpu_torch.infer import load_predictor, serving_buckets
    from irp_tpu_torch.serve import latency_percentiles, make_server
    from irp_tpu_torch.train.checkpoint import save_weights_npz

    variables = _random_variables(seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/resnet50_224.npz"
        save_weights_npz(path, variables["params"], variables["batch_stats"],
                         meta={"image_size": 224})
        pred = load_predictor(path, batch_size=64,
                              pad_buckets=serving_buckets("auto", 64),
                              fused_frozen_blocks="auto")
        f32_cfg = _f32(pred.model.config)
        unfused = load_predictor(path, batch_size=64,
                                 fused_frozen_blocks="off")
        f32 = load_predictor(path, batch_size=64, cfg=f32_cfg)
        big = load_predictor(path, batch_size=256,
                             fused_frozen_blocks="auto")
        cpu = load_predictor(path, batch_size=2, device="cpu", cfg=f32_cfg)
        default = load_predictor(path, batch_size=64)  # no fused flag
    server = make_server(pred, port=0, window_ms=5.0)
    for n in pred.pad_buckets:  # warm every served batch size
        pred.predict_probs(np.zeros((n, 256, 256, 3), np.uint8))
    torch.cuda.synchronize()
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    blobs = _jpegs(seed, N_REQUESTS)
    rounds = []

    def run_round():
        results = [None] * N_REQUESTS
        latency = [None] * N_REQUESTS
        errors = []

        def client(idx: int) -> None:
            for i in range(idx, N_REQUESTS, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    if i % 2:
                        body = json.dumps({"instances": [
                            base64.b64encode(blobs[i]).decode()]}).encode()
                        results[i] = _post(f"{url}/predict?topk=10", body,
                                           "application/json")
                    else:
                        results[i] = _post(f"{url}/predict?topk=10",
                                           blobs[i], "image/jpeg")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"request {i}: {e!r}")
                latency[i] = (time.perf_counter() - t_req) * 1e3

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        if errors or any(r is None for r in results):
            raise RuntimeError(f"requests failed: {errors[:5]}")
        if any(status != 200 for status, _ in results):
            raise RuntimeError("a request did not answer 200")
        rounds.append({"wall_s": round(wall, 3),
                       "client_latency_ms": latency_percentiles(latency)})
        return results

    # the main path: counts from 0 just before, read just after; two
    # rounds of requests, the first right after start, then a steady one
    _zero_launch_counts()
    results = run_round()
    run_round()
    launches = _launch_counts()
    with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    server.stop()

    served = np.zeros((N_REQUESTS, 10), np.float32)
    for i, (_, body) in enumerate(results):
        for item in body["predictions"][0]["topk"]:
            served[i, item["label"]] = item["prob"]
    prob_sums = served.sum(axis=1)
    images = decode_blobs(blobs)
    p_unfused = unfused.predict_probs(images)  # cuDNN blocks, on the card
    p_f32 = f32.predict_probs(images)  # float32, no TF32, on the card
    logits_fused, logits_unfused = _logits(pred, images), _logits(unfused,
                                                                    images)
    logit_rel = float(np.abs(logits_fused - logits_unfused).max()
                      / np.abs(logits_unfused).max())
    diff = float(np.abs(served - p_unfused).max())
    drift_fused = float(np.abs(served - p_f32).max())
    drift_unfused = float(np.abs(p_unfused - p_f32).max())
    top1_agree = int((served.argmax(1) == p_unfused.argmax(1)).sum())
    top2 = np.sort(p_unfused, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 2 * PROB_TOL
    top1_decisive_ok = bool(np.all(served.argmax(1)[decisive]
                                   == p_unfused.argmax(1)[decisive]))
    cpu_diff = float(np.abs(cpu.predict_probs(images[:2])
                            - p_f32[:2]).max())
    # the serving default is the JAX package's unfused forward: K1 only
    # where a caller asks for it
    _zero_launch_counts()
    default.predict_probs(images)
    torch.cuda.synchronize()
    default_launches = _launch_counts()
    batches = stats["batches"]
    checks = {
        "all_200": True,
        "prob_sums_1": bool(np.all(np.abs(prob_sums - 1) < 1e-4)),
        "finite": bool(np.all(np.isfinite(served))),
        "max_abs_dprob_vs_unfused_le_2e-2": diff <= PROB_TOL,
        "max_abs_dprob_fused_vs_f32_le_2e-2": drift_fused <= PROB_TOL,
        "max_abs_dprob_unfused_vs_f32_le_2e-2": drift_unfused <= PROB_TOL,
        "logit_rel_err_vs_unfused_le_2^-5": logit_rel <= LOGIT_TOL,
        "top1_agrees_where_margin_gt_4e-2": top1_decisive_ok,
        "k2_once_per_batch": launches["eval_preprocess"] == batches,
        "k1_ten_per_forward": launches["identity_bottleneck"]
        == 10 * batches,
        "epilogue_ten_per_forward": launches["frozen_epilogue"]
        == 10 * batches,
        "bn_train_never_in_serving": launches["batch_norm_train"] == 0,
        "card_f32_vs_cpu_f32_le_1e-3": cpu_diff <= 1e-3,
        "no_flag_load_predictor_k1_zero": (
            default.model.config.fused_frozen_blocks == "off"
            and default_launches == _launches(1, 0)),
    }
    rng = np.random.default_rng(seed + 1)
    ips = {}
    for bsz, p in ((64, pred), (256, big)):
        batch = rng.integers(0, 256, (bsz, 256, 256, 3), np.uint8)
        ips[str(bsz)] = _images_per_s(p, batch)
    out["launches"]["serve"] = launches
    emit({"phase": "serve", "model": "ResNet50/224, 10 classes, hidden 512",
          "device": health["device"], "requests": 2 * N_REQUESTS,
          "clients": N_CLIENTS, "rounds": rounds, "batches": batches,
          "mean_batch_fill": stats["mean_batch_fill"],
          "latency_ms": stats.get("latency_ms"), "launches": launches,
          "max_abs_dprob_fused_vs_unfused": diff,
          "logit_rel_err_fused_vs_unfused": logit_rel,
          "max_abs_dprob_fused_vs_f32": drift_fused,
          "max_abs_dprob_unfused_vs_f32": drift_unfused,
          "max_abs_dprob_card_f32_vs_cpu_f32": cpu_diff,
          "top1_agree": f"{top1_agree}/{N_REQUESTS}",
          "decisive_images": int(decisive.sum()),
          "no_flag_load_predictor_launches": default_launches,
          "images_per_s_predict_probs": ips, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"serve checks failed: {failed}")


EXPLAIN_BATCH = 8  # the daemon's Grad-CAM batch, min(8, batch size)
# Grad-CAM maps of bf16 forwards against the float32 one, max|diff| of
# maps normalized to [0, 1]: the unfused bf16 map drifted 0.0745 from the
# f32 map and the fused one 0.0434 (seed 0's 8 images, H100 80GB HBM3 at
# 700 W), so a bf16 map may lie twice the larger drift from it
EXPLAIN_CAM_TOL = 0.15
EXPLAIN_CPU_TOL = 1e-4  # card f32 against CPU f32 Grad-CAM
EXPORT_BATCHES = (64, 256)  # the .irpx's ladder: the daemon's and bulk
N_EXPLAIN_CLIENTS, N_EXPLAINS = 4, 16  # explain clients x requests each


def _launch_counts() -> dict:
    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.ops.cuda_image import eval_preprocess
    from irp_tpu_torch.ops.cuda_resnet import (frozen_epilogue,
                                               fused_identity_bottleneck)

    return {"eval_preprocess": eval_preprocess.launches,
            "identity_bottleneck": fused_identity_bottleneck.launches,
            "frozen_epilogue": frozen_epilogue.launches,
            "batch_norm_train": batch_norm_train.launches}


def _launches(eval_preprocess: int, k1: int, epilogue=None,
              bn_train: int = 0) -> dict:
    """A :func:`_launch_counts` dict: K2's, K1's, the epilogue's (K1's
    when not given) and the train-mode BatchNorm op's forwards."""
    return {"eval_preprocess": eval_preprocess, "identity_bottleneck": k1,
            "frozen_epilogue": k1 if epilogue is None else epilogue,
            "batch_norm_train": bn_train}


def _zero_launch_counts() -> None:
    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.ops.cuda_image import eval_preprocess
    from irp_tpu_torch.ops.cuda_resnet import (frozen_epilogue,
                                               fused_identity_bottleneck)

    eval_preprocess.launches = 0
    fused_identity_bottleneck.launches = 0
    frozen_epilogue.launches = 0
    batch_norm_train.launches = 0
    batch_norm_train.backward_launches = 0


def _prob_rows(rows) -> np.ndarray:
    """A /predict answer's top-k lists (all classes) as a (N, 10) array."""
    out = np.zeros((len(rows), N_CLASSES), np.float64)
    for i, row in enumerate(rows):
        for item in row["topk"]:
            out[i, item["label"]] = item["prob"]
    return out


def _traffic(url: str, stop: threading.Event, images, errors: list,
             answered: list) -> threading.Thread:
    """A /predict client sending ``images`` in turn until ``stop``."""
    from irp_tpu_torch.client import ServingClient

    def run():
        c = ServingClient(url, timeout_s=120)
        i = 0
        while not stop.is_set():
            try:
                c.predict(images[i % len(images)], topk=1)
                answered.append(1)
            except Exception as e:  # noqa: BLE001 — counted as a failure
                errors.append(repr(e))
            i += 1

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def phase_explain(out: dict, seed: int) -> None:
    """Grad-CAM, the exported .irpx and the daemon's /explain and /reload
    at ResNet50/224 (10 classes, hidden 512, bf16, 'auto')."""
    with tempfile.TemporaryDirectory() as tmp:
        _explain_phase(out, seed, tmp)


def _explain_phase(out: dict, seed: int, tmp: str) -> None:
    import zipfile

    from irp_tpu_torch.client import ServingClient
    from irp_tpu_torch.data.pipeline import decode_blobs
    from irp_tpu_torch.explain import GradCAM
    from irp_tpu_torch.export import export_predictor, read_export_meta
    from irp_tpu_torch.infer import load_predictor, serving_buckets
    from irp_tpu_torch.serve import make_server
    from irp_tpu_torch.train.checkpoint import save_weights_npz

    paths = []
    for s in (seed, seed + 1):
        variables = _random_variables(s)
        paths.append(save_weights_npz(f"{tmp}/resnet50_224_seed{s}.npz",
                                      variables["params"],
                                      variables["batch_stats"],
                                      meta={"image_size": 224}))
    npz, npz1 = paths
    buckets = serving_buckets("auto", 64)
    pred = load_predictor(npz, batch_size=64, pad_buckets=buckets,
                          fused_frozen_blocks="auto")
    cfg = pred.model.config
    blobs = _jpegs(seed + 2, 64)
    images = decode_blobs(blobs)
    eight = images[:EXPLAIN_BATCH]
    checks, report = {}, {}

    # (a) Grad-CAM at batch 8 through K2 and K1, against float32
    gc = GradCAM(pred, batch_size=EXPLAIN_BATCH)
    _zero_launch_counts()
    cams, logits = gc.explain(eight)
    torch.cuda.synchronize()
    gc_launches = _launch_counts()
    checks["gradcam_k2_once_k1_ten_per_batch"] = gc_launches == _launches(
        1, 10)
    f32 = load_predictor(npz, batch_size=64, cfg=_f32(cfg))
    unfused = load_predictor(npz, batch_size=64, fused_frozen_blocks="off")
    cams32, logits32 = GradCAM(f32, batch_size=EXPLAIN_BATCH).explain(eight)
    cams_u, _ = GradCAM(unfused, batch_size=EXPLAIN_BATCH).explain(eight)
    cam_drift = float(np.abs(cams - cams32).max())
    cam_drift_unfused = float(np.abs(cams_u - cams32).max())
    logit_rel = float(np.abs(logits - logits32).max()
                      / np.abs(logits32).max())
    cpu = load_predictor(npz, batch_size=2, device="cpu", cfg=_f32(cfg))
    cams_cpu, _ = GradCAM(cpu).explain(eight[:2])
    cams32_2, _ = GradCAM(f32, batch_size=2).explain(eight[:2])
    cpu_diff = float(np.abs(cams_cpu - cams32_2).max())
    checks.update({
        "cams_finite_in_0_1": bool(np.isfinite(cams).all() and cams.min() >= 0
                                   and cams.max() <= 1),
        "cam_bf16_vs_f32_le_tol": cam_drift <= EXPLAIN_CAM_TOL,
        "cam_unfused_bf16_vs_f32_le_tol":
        cam_drift_unfused <= EXPLAIN_CAM_TOL,
        "logit_rel_err_vs_f32_le_2^-5": logit_rel <= LOGIT_TOL,
        "argmax_equal_f32": bool(np.array_equal(logits.argmax(1),
                                                logits32.argmax(1))),
        "card_f32_vs_cpu_f32_cam_le_1e-4": cpu_diff <= EXPLAIN_CPU_TOL})
    report["gradcam"] = {
        "batch": EXPLAIN_BATCH, "launches": gc_launches,
        "ms_per_batch": _cuda_ms(lambda: gc.explain(eight)),
        "max_abs_dcam_vs_f32": cam_drift,
        "max_abs_dcam_unfused_vs_f32": cam_drift_unfused,
        "logit_rel_err_vs_f32": logit_rel,
        "max_abs_dcam_card_f32_vs_cpu_f32": cpu_diff}
    emit({"phase": "explain", "part": "gradcam", **report["gradcam"]})

    # (b) the .irpx, exported on the card
    live = load_predictor(npz, batch_size=EXPORT_BATCHES[-1],
                          pad_buckets=EXPORT_BATCHES,
                          fused_frozen_blocks="auto")
    irpx = f"{tmp}/resnet50_224.irpx"
    t0 = time.perf_counter()
    export_predictor(live, irpx)
    export_s = time.perf_counter() - t0
    with zipfile.ZipFile(irpx) as zf:
        members = {i.filename: i.file_size for i in zf.infolist()}
    meta = read_export_meta(irpx)
    t0 = time.perf_counter()
    art = load_predictor(irpx)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 3)
    equal = {}
    for n in EXPORT_BATCHES:
        batch = rng.integers(0, 256, (n, 256, 256, 3), np.uint8)
        equal[str(n)] = bool(np.array_equal(art.predict_probs(batch),
                                            live.predict_probs(batch)))
    _zero_launch_counts()
    art.predict_probs(images)
    torch.cuda.synchronize()
    art_launches = _launch_counts()
    cls = np.array([-1, 3, -1, 0, 9, -1, 5, -1], np.int32)
    _zero_launch_counts()
    baked = GradCAM(art).explain(eight, cls)
    torch.cuda.synchronize()
    baked_launches = _launch_counts()
    live_cam = GradCAM(live, batch_size=EXPLAIN_BATCH).explain(eight, cls)
    ips = {}
    for n in EXPORT_BATCHES:
        batch = rng.integers(0, 256, (n, 256, 256, 3), np.uint8)
        turns = [_images_per_s(p, batch) for p in (live, art, art, live)]
        ips[str(n)] = {"live": (turns[0] + turns[3]) / 2,
                       "irpx": (turns[1] + turns[2]) / 2,
                       "turns_live_irpx_irpx_live": turns}
    # the card's artifact on the CPU: its programs move there and run the
    # ops' plain versions, as a CPU predictor with K1 'on' does
    art_cpu = load_predictor(irpx, device="cpu")
    cpu_on = load_predictor(npz, batch_size=2, device="cpu",
                            fused_frozen_blocks="on")
    cpu_equal = all(bool(np.array_equal(a, b)) for a, b in zip(
        GradCAM(art_cpu).explain(eight[:2]),
        GradCAM(cpu_on, batch_size=EXPLAIN_BATCH).explain(eight[:2])))
    checks.update({
        "export_resolves_auto_to_on": meta["fused_frozen_blocks"] == "on",
        "irpx_probs_bit_equal_64_256": all(equal.values()),
        "irpx_forward_k2_once_k1_ten": art_launches == _launches(1, 10),
        "irpx_explain_k2_once_k1_ten": baked_launches == _launches(1, 10),
        "irpx_explain_bit_equal_live": all(
            bool(np.array_equal(a, b)) for a, b in zip(baked, live_cam)),
        "irpx_on_cpu_equals_cpu_predictor": cpu_equal})
    report["export"] = {
        "seconds": export_s, "load_seconds": load_s, "bytes": members,
        "fused_frozen_blocks": meta["fused_frozen_blocks"],
        "bit_equal": equal, "forward_launches": art_launches,
        "explain_launches": baked_launches, "images_per_s": ips}
    emit({"phase": "explain", "part": "export", **report["export"]})

    # (c) the daemon with reload, through ServingClient: explains under
    # /predict traffic, then a reload under the same traffic
    def loader(path):
        # serve_cli's loader (--fused-frozen-blocks auto): an .irpx brings
        # its own ladder and fused mode
        return load_predictor(path, batch_size=64, pad_buckets=(
            None if path.endswith(".irpx") else buckets),
            fused_frozen_blocks="auto")

    server = make_server(pred, port=0, window_ms=5.0, loader=loader,
                         weights_path=npz,
                         max_concurrent_explains=N_EXPLAIN_CLIENTS)
    for n in buckets:
        pred.predict_probs(np.zeros((n, 256, 256, 3), np.uint8))
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    client = ServingClient(url, timeout_s=120)
    client.wait_until_ready(timeout_s=60)
    errors, answered, bad_explains = [], [], []

    def explainer(k):
        c = ServingClient(url, timeout_s=120)
        for i in range(N_EXPLAINS):
            path = f"{tmp}/overlay_{k}_{i}.png"
            try:
                c.explain(blobs[(k * N_EXPLAINS + i) % 64], overlay_path=path)
                if not _png_opens(path):
                    bad_explains.append(f"{k}/{i}: no PNG")
            except Exception as e:  # noqa: BLE001 — reported below
                bad_explains.append(f"{k}/{i}: {e!r}")

    def under_traffic(fn):
        """``fn()`` while N_CLIENTS threads post /predict; all joined."""
        stop = threading.Event()
        clients = [_traffic(url, stop, blobs[8:], errors, answered)
                   for _ in range(N_CLIENTS)]
        try:
            return fn()
        finally:
            stop.set()
            for t in clients:
                t.join(120)

    def explains():
        threads = [threading.Thread(target=explainer, args=(k,))
                   for k in range(N_EXPLAIN_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)

    def reload():
        t0 = time.perf_counter()
        result = client.reload(npz1, timeout_s=600)
        seconds = time.perf_counter() - t0
        time.sleep(1.0)  # traffic on the new weights
        return result, seconds

    try:
        _zero_launch_counts()
        under_traffic(explains)
        stats = client.stats()
        serve_launches = _launch_counts()
        answered_before = len(answered)
        reloaded, reload_s = under_traffic(reload)
        # alone, each check request pads to the 1-image bucket, as the
        # direct predictor's call does
        served = _prob_rows([client.predict(b, topk=N_CLASSES)[0]
                             for b in blobs[:4]])
        seed1 = loader(npz1)
        want = np.array([[round(float(v), 6) for v in
                          seed1.predict_probs(images[i:i + 1])[0]]
                         for i in range(4)])
        reload_exact = bool(np.array_equal(served, want))
        health = client.healthz()
        # (d) the same daemon, reloaded to the .irpx: /explain through its
        # baked program, /predict through its b64 program
        to_irpx = client.reload(irpx, timeout_s=600)
        _zero_launch_counts()
        ex = client.explain(blobs[0], overlay_path=f"{tmp}/irpx_overlay.png")
        [p] = client.predict(blobs[0], topk=N_CLASSES)
        irpx_launches = _launch_counts()
        irpx_ok = (to_irpx["generation"] == 2 and server.batcher.predictor
                   .exported and _png_opens(f"{tmp}/irpx_overlay.png")
                   and ex["label"] == p["label"])
    finally:
        server.stop()
    n_explains = N_EXPLAIN_CLIENTS * N_EXPLAINS
    # one forward per /predict dispatch and per /explain (a batch of 8)
    dispatches = stats["batches"] + stats["explain"]["requests"]
    checks.update({
        "explains_all_200_png": not bad_explains,
        "explain_requests_counted": stats["explain"]["requests"]
        == n_explains,
        "daemon_k2_once_k1_ten_per_batch": serve_launches == _launches(
            dispatches, 10 * dispatches),
        "reload_no_failed_predict": not errors
        and len(answered) > answered_before > 0,
        "reload_generation_1": reloaded["generation"] == 1
        and health["generation"] == 1,
        "reload_probs_equal_seed1_predictor": reload_exact})
    report["daemon"] = {
        "explain_requests": n_explains, "predict_answered": answered_before,
        "predict_answered_during_reload": len(answered) - answered_before,
        "predict_batches": stats["batches"],
        "explain_latency_ms": stats["explain"].get("latency_ms"),
        "predict_latency_ms": stats.get("latency_ms"),
        "launches": serve_launches, "reload_seconds": reload_s,
        "failed": (errors + bad_explains)[:5]}
    emit({"phase": "explain", "part": "daemon", **report["daemon"]})

    checks.update({
        "irpx_daemon_explain_and_predict": bool(irpx_ok),
        "irpx_daemon_k2_once_k1_ten_each": irpx_launches == _launches(
            2, 20)})
    out["launches"]["explain"] = {
        key: (gc_launches[key] + art_launches[key] + baked_launches[key]
              + serve_launches[key] + irpx_launches[key])
        for key in gc_launches}
    emit({"phase": "explain", "model": "ResNet50/224, 10 classes, hidden 512",
          "launches": out["launches"]["explain"], "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"explain checks failed: {failed}")


# The families phase: one model of each other family at full width, as
# (family, variant).  Each serves as the ResNet50 of the serve phase does.
FAMILY_MODELS = (("vit", "b_16"), ("convnext", "tiny"),
                 ("efficientnet", "b0"))
FAMILY_BATCHES = (64, 256)  # predict_probs images/s, as the serve phase
FAMILY_EXPORT_BATCH = 64
# bf16 against the card's f32 forward (no TF32), per family: the largest
# |dprob| over seed 0's 64 images and the Grad-CAM map's max|diff| over
# its first 8, each bar twice the drift measured on an H100 80GB HBM3 at
# 700 W (|dprob| ViT 0.00314, ConvNeXt 0.00255, EfficientNet 9.9e-5;
# maps 0.2205, 0.1700, 0.0243; PERF.md §2)
FAMILY_PROB_TOL = {"vit": 6.3e-3, "convnext": 5.2e-3, "efficientnet": 2.0e-4}
FAMILY_CAM_TOL = {"vit": 0.45, "convnext": 0.34, "efficientnet": 0.049}
FAMILY_CPU_LOGIT_TOL = 1e-3  # f32 card vs CPU logits: the fidelity bar
N_FAMILY_EXPLAINS = 8  # /explain requests to the ViT daemon, one a client


def _family_model(family: str, variant: str, seed: int):
    """The family's classifier at full width (224 crop, 10 classes, MLP
    head 512, bf16) with weights from a seeded generator: flax's
    initializers, then the norms' scales and shifts, BatchNorm's running
    statistics, ConvNeXt's layer scales and ViT's class token drawn
    away from their init values (so that each layer does work)."""
    from irp_tpu_torch.cli.model_args import model_config_for_family
    from irp_tpu_torch.models.classifier import Classifier

    cfg = model_config_for_family(
        family, vit_variant=variant, efficientnet_variant=variant,
        convnext_variant=variant, num_classes=N_CLASSES, image_size=224,
        hidden_dim=512)
    gen = torch.Generator().manual_seed(seed)
    model = Classifier(cfg)
    model.init_weights(gen)
    norms = {name for name, m in model.named_modules()
             if isinstance(m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d))}
    with torch.no_grad():
        for key, t in model.state_dict().items():
            owner, _, leaf = key.rpartition(".")
            if leaf == "running_mean":
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif leaf == "layer_scale":
                t.copy_(0.1 + 0.4 * torch.rand(t.shape, generator=gen))
            elif leaf == "class_token":
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
            elif owner in norms and leaf == "weight":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif owner in norms and leaf == "bias":
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return model.eval()


def _architecture(cfg) -> dict:
    """The fields of a config that fix a family's forward."""
    keys = {"vit": ("patch_size", "embed_dim", "num_layers", "mlp_dim",
                    "num_heads"),
            "efficientnet": ("width_mult", "depth_mult"),
            "convnext": ("convnext_dims", "convnext_depths")}[cfg.family]
    return {k: getattr(cfg, k) for k in ("family", "image_size",
                                         "num_classes", "hidden_dim", *keys)}


def phase_families(out: dict, seed: int) -> None:
    """ViT-B/16, ConvNeXt-Tiny and EfficientNet-B0 served through
    load_predictor, Grad-CAM and the .irpx, then a ViT daemon."""
    with tempfile.TemporaryDirectory() as tmp:
        _families_phase(out, seed, tmp)


def _family_run(family: str, variant: str, seed: int, tmp: str,
                images: np.ndarray, launches: dict) -> tuple:
    """One family: .npz and .pth, predict_probs, bf16 drift, card vs CPU,
    Grad-CAM and the .irpx; its launches are added to ``launches``.
    Returns (report, checks, .npz path, predictors by batch, a batch of
    each size)."""
    from irp_tpu_torch.explain import GradCAM
    from irp_tpu_torch.export import export_predictor, read_export_meta
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.models.convert import state_dict_to_jax_variables
    from irp_tpu_torch.train.checkpoint import (export_torch_pth,
                                                save_weights_npz)

    model = _family_model(family, variant, seed)
    cfg = model.config
    variables = state_dict_to_jax_variables(model.state_dict())
    npz = save_weights_npz(f"{tmp}/{family}_{variant}.npz",
                           variables["params"], variables["batch_stats"],
                           meta={"image_size": cfg.image_size})
    pth = export_torch_pth(f"{tmp}/{family}_{variant}.pth", model)
    del model
    checks, report = {}, {"model": f"{family} {variant}, 224, 10 classes, "
                                   "hidden 512, bf16"}
    preds = {b: load_predictor(npz, batch_size=b) for b in FAMILY_BATCHES}
    pred = preds[FAMILY_BATCHES[0]]
    got = _architecture(pred.model.config)
    checks["npz_infers_family_and_variant"] = got == _architecture(cfg)
    from_pth = load_predictor(pth, batch_size=FAMILY_BATCHES[0],
                              image_size=cfg.image_size)
    checks["pth_probs_equal_npz"] = bool(np.array_equal(
        from_pth.predict_probs(images), pred.predict_probs(images)))
    del from_pth

    # predict_probs on the card: K2 once a batch, K1 never
    rng = np.random.default_rng(seed + 5)
    batches = {b: rng.integers(0, 256, (b, 256, 256, 3), np.uint8)
               for b in FAMILY_BATCHES}
    for b, p in preds.items():
        p.predict_probs(batches[b])  # warm (cuDNN's algorithm choice)
    torch.cuda.synchronize()
    _zero_launch_counts()
    for b, p in preds.items():
        p.predict_probs(batches[b])
    torch.cuda.synchronize()
    counts = _launch_counts()
    checks["predict_k2_once_per_batch_k1_never"] = counts == _launches(
        len(FAMILY_BATCHES), 0)
    _add_launches(launches, counts)

    # bf16 against the card's f32 forward, and the card's f32 against the
    # CPU's f32 on two images (TF32 off: 'highest' and cuBLAS's default)
    assert not torch.backends.cuda.matmul.allow_tf32
    f32 = load_predictor(npz, batch_size=FAMILY_BATCHES[0], cfg=_f32(cfg))
    p_bf16, p_f32 = pred.predict_probs(images), f32.predict_probs(images)
    drift = float(np.abs(p_bf16 - p_f32).max())
    cpu = load_predictor(npz, batch_size=2, device="cpu", cfg=_f32(cfg))
    cpu_logit_diff = float(np.abs(_logits(cpu, images[:2])
                                  - _logits(f32, images[:2])).max())
    checks.update({
        "probs_finite_sum_1": bool(np.isfinite(p_bf16).all() and np.all(
            np.abs(p_bf16.sum(1) - 1) < 1e-4)),
        "bf16_vs_f32_prob_le_tol": drift <= FAMILY_PROB_TOL[family],
        "card_f32_vs_cpu_f32_logits_le_1e-3":
        cpu_logit_diff <= FAMILY_CPU_LOGIT_TOL})

    # Grad-CAM at batch 8
    eight = images[:EXPLAIN_BATCH]
    gc = GradCAM(pred, batch_size=EXPLAIN_BATCH)
    gc.explain(eight)
    torch.cuda.synchronize()
    _zero_launch_counts()
    cams, logits = gc.explain(eight)
    torch.cuda.synchronize()
    gc_counts = _launch_counts()
    _add_launches(launches, gc_counts)
    cams32, _ = GradCAM(f32, batch_size=EXPLAIN_BATCH).explain(eight)
    cam_drift = float(np.abs(cams - cams32).max())
    cams_cpu, _ = GradCAM(cpu).explain(eight[:2])
    cams32_2, _ = GradCAM(f32, batch_size=2).explain(eight[:2])
    cam_cpu_diff = float(np.abs(cams_cpu - cams32_2).max())
    checks.update({
        "gradcam_k2_once_k1_never": gc_counts == _launches(1, 0),
        "cams_finite_in_0_1": bool(np.isfinite(cams).all()
                                   and cams.min() >= 0 and cams.max() <= 1),
        "cam_bf16_vs_f32_le_tol": cam_drift <= FAMILY_CAM_TOL[family],
        "card_f32_vs_cpu_f32_cam_le_1e-4": cam_cpu_diff <= EXPLAIN_CPU_TOL})
    del f32, cpu

    # the .irpx at batch 64 with its explain program, on the card
    irpx = f"{tmp}/{family}_{variant}.irpx"
    t0 = time.perf_counter()
    export_predictor(pred, irpx, gradcam_batch_size=EXPLAIN_BATCH)
    export_s = time.perf_counter() - t0
    meta = read_export_meta(irpx)
    art = load_predictor(irpx)
    _zero_launch_counts()
    art_probs = art.predict_probs(images)
    art_cams = GradCAM(art).explain(eight)
    torch.cuda.synchronize()
    art_counts = _launch_counts()
    _add_launches(launches, art_counts)
    live_cams = gc.explain(eight)
    checks.update({
        "irpx_family_unfused": meta["model_config"]["family"] == family
        and meta["fused_frozen_blocks"] == "off",
        "irpx_probs_bit_equal_live": bool(np.array_equal(
            art_probs, pred.predict_probs(images))),
        "irpx_explain_bit_equal_live": all(
            bool(np.array_equal(a, b)) for a, b in zip(art_cams, live_cams)),
        "irpx_k2_once_each_k1_never": art_counts == _launches(2, 0)})
    report.update({
        "prob_drift_bf16_vs_f32": drift,
        "logit_diff_card_f32_vs_cpu_f32": cpu_logit_diff,
        "gradcam_ms_per_batch_8": _cuda_ms(lambda: gc.explain(eight)),
        "cam_drift_bf16_vs_f32": cam_drift,
        "cam_diff_card_f32_vs_cpu_f32": cam_cpu_diff,
        "export_seconds": export_s,
        "launches": {"predict": counts, "gradcam": gc_counts,
                     "irpx": art_counts}})
    return report, checks, npz, preds, batches


def _add_launches(total: dict, counts: dict) -> None:
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n


def _families_phase(out: dict, seed: int, tmp: str) -> None:
    from irp_tpu_torch.client import ServingClient
    from irp_tpu_torch.data.pipeline import decode_blobs
    from irp_tpu_torch.infer import load_predictor, serving_buckets
    from irp_tpu_torch.serve import make_server
    from irp_tpu_torch.train.checkpoint import save_weights_npz

    blobs = _jpegs(seed + 2, 64)
    images = decode_blobs(blobs)
    launches: dict = {}
    checks, timed, npzs = {}, {}, {}
    for family, variant in FAMILY_MODELS:
        t0 = time.perf_counter()
        report, fam_checks, npzs[family], preds, batches = _family_run(
            family, variant, seed, tmp, images, launches)
        timed[family] = (preds, batches)
        report["seconds"] = time.perf_counter() - t0
        checks.update({f"{family}_{k}": v for k, v in fam_checks.items()})
        emit({"phase": "families", "family": family, **report,
              "checks": fam_checks})

    # images/s of the four families in turns (ResNet50 as the serve
    # phase's, K1 'auto'), forward then backward, at each batch
    variables = _random_variables(seed)
    resnet = f"{tmp}/resnet50_224.npz"
    save_weights_npz(resnet, variables["params"], variables["batch_stats"],
                     meta={"image_size": 224})
    timed["resnet50"] = ({b: load_predictor(resnet, batch_size=b,
                                            fused_frozen_blocks="auto")
                          for b in FAMILY_BATCHES},
                         next(iter(timed.values()))[1])
    order = ["resnet50"] + [f for f, _ in FAMILY_MODELS]
    ips = {name: {} for name in order}
    for b in FAMILY_BATCHES:
        for name in order + order[::-1]:
            preds, batches = timed[name]
            ips[name].setdefault(str(b), []).append(
                _images_per_s(preds[b], batches[b]))
    del timed
    emit({"phase": "families", "part": "images_per_s_in_turns",
          "order": order + order[::-1], "images_per_s": ips})

    # one daemon: the ViT-B/16 .npz, 2 rounds of 64 /predict and 8
    # /explain from 8 client threads
    pred = load_predictor(npzs["vit"], batch_size=64,
                          pad_buckets=serving_buckets("auto", 64))
    for n in pred.pad_buckets:
        pred.predict_probs(np.zeros((n, 256, 256, 3), np.uint8))
    server = make_server(pred, port=0, window_ms=5.0,
                         max_concurrent_explains=N_FAMILY_EXPLAINS)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    errors, bad = [], []

    def client(k: int) -> None:
        c = ServingClient(url, timeout_s=120)
        try:
            for i in range(k, N_REQUESTS, N_CLIENTS):
                c.predict(blobs[i], topk=1)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"predict {k}: {e!r}")

    def explainer(k: int) -> None:
        path = f"{tmp}/vit_overlay_{k}.png"
        try:
            ServingClient(url, timeout_s=120).explain(blobs[k],
                                                      overlay_path=path)
            if not _png_opens(path):
                bad.append(f"explain {k}: no PNG")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"explain {k}: {e!r}")

    def run(target, n):
        threads = [threading.Thread(target=target, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)

    try:
        ServingClient(url).wait_until_ready(timeout_s=60)
        _zero_launch_counts()
        t0 = time.perf_counter()
        run(client, N_CLIENTS)
        run(client, N_CLIENTS)
        run(explainer, N_FAMILY_EXPLAINS)
        wall = time.perf_counter() - t0
        daemon_counts = _launch_counts()
        client_ = ServingClient(url)
        stats, health = client_.stats(), client_.healthz()
    finally:
        server.stop()
    _add_launches(launches, daemon_counts)
    dispatches = stats["batches"] + stats["explain"]["requests"]
    checks.update({
        "daemon_all_200": not errors and not bad,
        "daemon_requests_counted": stats["requests"] == 2 * N_REQUESTS
        and stats["explain"]["requests"] == N_FAMILY_EXPLAINS,
        "daemon_k2_once_per_dispatch_k1_never": daemon_counts == _launches(
            dispatches, 0),
        "healthz_vit_without_depth": health["model"]["family"] == "vit"
        and "depth" not in health["model"]})
    out["launches"]["families"] = launches
    emit({"phase": "families", "part": "daemon", "model": "vit b_16",
          "wall_s": wall, "predict_batches": stats["batches"],
          "mean_batch_fill": stats["mean_batch_fill"],
          "latency_ms": stats.get("latency_ms"),
          "explain_latency_ms": stats["explain"].get("latency_ms"),
          "launches": daemon_counts, "failed": (errors + bad)[:5]})
    emit({"phase": "families", "launches": launches, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"families checks failed: {failed}")


def _curation_images(seed: int, n: int, patterns_seed=None):
    """n synthetic 256x256 uint8 images made on the card: N_CLASSES smooth
    base patterns (8x8 noise upsampled), each image its class's pattern
    plus a brightness offset and pixel noise; PLANTED_SHARE of them carry
    another class's pattern under their label.  The patterns are the first
    draw of the generator seeded with ``seed``, or with ``patterns_seed``
    when given: another set of images of the same classes.  Returns host
    (images, labels, planted)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    gp = g if patterns_seed is None else torch.Generator(
        device="cuda").manual_seed(patterns_seed)
    small = torch.rand(N_CLASSES, 3, 8, 8, generator=gp, device="cuda") * 255
    bases = F.interpolate(small, size=(256, 256), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    labels = torch.randint(0, N_CLASSES, (n,), generator=g, device="cuda")
    planted = torch.rand(n, generator=g, device="cuda") < PLANTED_SHARE
    shift = torch.randint(1, N_CLASSES, (n,), generator=g, device="cuda")
    pattern = torch.where(planted, (labels + shift) % N_CLASSES, labels)
    images = torch.empty((n, 256, 256, 3), dtype=torch.uint8, device="cuda")
    for start in range(0, n, 1024):
        stop = min(start + 1024, n)
        offset = (torch.rand(stop - start, 1, 1, 1, generator=g,
                             device="cuda") - 0.5) * 40
        noise = torch.randn(stop - start, 256, 256, 3, generator=g,
                            device="cuda") * 24
        images[start:stop] = (bases[pattern[start:stop]] + offset + noise
                              ).clamp(0, 255).to(torch.uint8)
    return (images.cpu().numpy(), labels.to(torch.int32).cpu().numpy(),
            planted.cpu().numpy())


def _separation(emb: np.ndarray, labels: np.ndarray) -> float:
    """Mean distance between class centres over the mean distance of a
    point to its class centre."""
    classes = np.unique(labels)
    centres = np.stack([emb[labels == c].mean(axis=0) for c in classes])
    within = np.mean([np.linalg.norm(emb[labels == c] - centres[i],
                                     axis=1).mean()
                      for i, c in enumerate(classes)])
    between = np.mean([np.linalg.norm(centres[i] - centres[j])
                       for i in range(len(classes))
                       for j in range(i + 1, len(classes))])
    return float(between / within)


def _knn_against_plain(outliers, x: np.ndarray, k: int) -> dict:
    """outliers.knn(x, k) on the card over the kernel, and again with the
    kernel's plain version (cuBLAS f32, no TF32) patched in.  Returns the
    share of equal neighbour indices, the largest relative gap between
    the j-th distances, and the largest gap between the j-th squared
    distances over max(|x_i|^2 + |x_j|^2): both lists are sorted, so each
    of their j-th values moves by no more than the largest gap between
    the two distance matrices, which the kernel's tolerance bounds by
    1e-5 of that scale.  In 2-D, near neighbours are close against |x|,
    so that absolute form is the one that applies there."""
    from unittest import mock

    from irp_tpu_torch.ops.cuda_image import pairwise_topk_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    i_k, d_k = outliers.knn(x, k, device="cuda")
    with mock.patch.object(outliers, "pairwise_topk", pairwise_topk_plain):
        i_p, d_p = outliers.knn(x, k, device="cuda")
    d_k, d_p = d_k.astype(np.float64), d_p.astype(np.float64)
    scale = 2.0 * float((np.asarray(x, np.float64) ** 2).sum(axis=1).max())
    return {"n": len(x), "k": k,
            "index_agreement": float((i_k == i_p).mean()),
            "dist_max_rel": float((np.abs(d_k - d_p)
                                   / np.maximum(d_p, 1e-30)).max()),
            "sq_dist_gap_over_scale": float(np.abs(d_k ** 2 - d_p ** 2).max()
                                            / scale)}


def phase_curation(out: dict, seed: int) -> None:
    """Embedding outlier detection (the curation CLI's --outliers stage)
    over N_IMAGES synthetic images on the card."""
    import dataclasses

    from irp_tpu_torch.config import ModelConfig
    from irp_tpu_torch.data import outliers
    from irp_tpu_torch.data.pipeline import CachedDataset
    from irp_tpu_torch.ops.cuda_image import eval_preprocess, pairwise_topk

    t0 = time.perf_counter()
    images, labels, planted = _curation_images(seed, N_IMAGES)
    cached = CachedDataset(images=images, labels=labels,
                           keys=[f"img{i}" for i in range(N_IMAGES)],
                           class_names=tuple(f"class{c}"
                                             for c in range(N_CLASSES)))
    state_dict = _random_state_dict(seed)
    cfg = ModelConfig()  # the curation CLI's: ResNet50/224 bf16, 'off'
    setup_s = time.perf_counter() - t0
    timings: dict = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the main path: counts from 0 just before, read just after
    eval_preprocess.launches = 0
    pairwise_topk.launches = 0
    t0 = time.perf_counter()
    start.record()
    feats, labels_out, _ = outliers.extract_features(
        cached, cfg, batch_size=FEATURE_BATCH, state_dict=state_dict,
        device="cuda", timings=timings)
    end.record()
    end.synchronize()
    emb, proj = outliers.create_embeddings(feats, labels_out, device="cuda",
                                           timings=timings)
    spectral_path = outliers.last_spectral_path
    cmask, gmask, _ = outliers.detect_outliers(emb, labels_out,
                                               device="cuda",
                                               timings=timings)
    total_s = time.perf_counter() - t0
    launches = {"eval_preprocess": eval_preprocess.launches,
                "pairwise_topk": pairwise_topk.launches}
    out["launches"]["curation"] = launches

    n = N_IMAGES
    class_sizes = np.bincount(labels, minlength=N_CLASSES)
    want_class = sum(int(round(0.05 * s)) for s in class_sizes if s >= 3)
    want_global = int(round(0.03 * n))
    blocks = math.ceil(n / K3_ROWS)
    want_k3 = 2 * blocks + sum(math.ceil(s / K3_ROWS) for s in class_sizes
                               if s >= 3)
    # gate: bf16 features against the float32 forward (no TF32) on the card
    sub = CachedDataset(images=images[:256], labels=labels[:256],
                        keys=cached.keys[:256],
                        class_names=cached.class_names)
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  precision="highest")
    f32, _, _ = outliers.extract_features(sub, f32_cfg,
                                          batch_size=FEATURE_BATCH,
                                          state_dict=state_dict,
                                          device="cuda")
    feat_rel = float(np.abs(feats[:256] - f32).max() / np.abs(f32).max())
    # gates: kNN over the kernel against kNN over the plain version, at
    # the UMAP kNN (PCA-50) and at two of the LOF kNNs on the embedding:
    # the global one and class 0's, each with a ragged last row block
    knn_umap = _knn_against_plain(outliers, proj, 15)
    sel = np.nonzero(labels_out == 0)[0]
    knn_lof = {"global": _knn_against_plain(outliers, emb, min(75, n - 1)),
               "class0": _knn_against_plain(outliers, emb[sel],
                                            min(30, len(sel) - 1))}
    flagged = cmask | gmask
    checks = {
        "features_bf16_vs_f32_le_2^-5": feat_rel <= FEATURE_TOL,
        "knn_indices_agree_ge_99.9%": knn_umap["index_agreement"] >= 0.999,
        "knn_distances_rel_le_1e-4": knn_umap["dist_max_rel"] <= 1e-4,
        **{f"lof_knn_{name}_indices_agree_ge_99.9%":
           r["index_agreement"] >= 0.999 for name, r in knn_lof.items()},
        **{f"lof_knn_{name}_sq_dist_gap_le_1e-5_scale":
           r["sq_dist_gap_over_scale"] <= 1e-5 for name, r in knn_lof.items()},
        "spectral_path_lobpcg": spectral_path == "lobpcg",
        "embedding_finite": bool(np.isfinite(emb).all()),
        "embedding_shape": emb.shape == (n, 2),
        "features_finite": bool(np.isfinite(feats).all()),
        "class_outliers_count": int(cmask.sum()) == want_class,
        "global_outliers_count": int(gmask.sum()) == want_global,
        "k2_once_per_batch": launches["eval_preprocess"]
        == math.ceil(n / FEATURE_BATCH),
        "k3_once_per_knn_block": launches["pairwise_topk"] == want_k3,
    }
    emit({"phase": "curation", "images": n, "classes": N_CLASSES,
          "planted": int(planted.sum()),
          "model": "ResNet50/224 bf16, batch 64, random weights",
          "setup_s": setup_s,
          "extract_features_images_per_s": n / (start.elapsed_time(end)
                                                / 1e3),
          "stage_s": timings, "total_s": total_s,
          "spectral_path": spectral_path, "launches": launches,
          "expected_launches": {"eval_preprocess": math.ceil(
              n / FEATURE_BATCH), "pairwise_topk": want_k3},
          "features_rel_err_bf16_vs_f32": feat_rel,
          "knn_umap_vs_plain": knn_umap, "knn_lof_vs_plain": knn_lof,
          "class_outliers": int(cmask.sum()),
          "global_outliers": int(gmask.sum()),
          "planted_flagged_share": float(flagged[planted].mean()),
          "unplanted_flagged_share": float(flagged[~planted].mean()),
          "embedding_separation": _separation(emb, labels),
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"curation checks failed: {failed}")


def phase_bench(out: dict, seed: int) -> None:
    """The bench tool as a user runs it, B=256.  Its kernels are held
    against their plain versions at that size too: the bottleneck's
    max|kernel - plain| / max|plain| from the tool's run within 2^-6, and
    the copy floor bit for bit against clamp_min(0) on one B=256 input per
    shape, made after the launch counts are read."""
    from irp_tpu_torch.ops.cuda_resnet import (fused_identity_bottleneck,
                                               relu_copy, relu_copy_plain)
    from irp_tpu_torch.tools import bench_fused_block

    fused_identity_bottleneck.launches = 0
    relu_copy.launches = 0
    results = bench_fused_block.main([])
    launches = {"identity_bottleneck": fused_identity_bottleneck.launches,
                "copy_floor": relu_copy.launches}
    out["launches"]["bench"] = launches
    gen = torch.Generator(device="cuda").manual_seed(seed)
    checks = {"kernels_launched": all(launches.values())}
    for r in results:
        r["rel_err"] = r["maxdiff"] / r["max_abs_plain"]
        x = torch.randn(r["B"], r["H"], r["W"], r["C"], generator=gen,
                        device="cuda").to(torch.bfloat16)
        r["copy_floor_bit_equal"] = bool(torch.equal(
            relu_copy(x).view(torch.int16),
            relu_copy_plain(x).view(torch.int16)))
        del x
        checks[f"{r['shape']}_bottleneck_rel_err_le_2^-6"] = (
            r["rel_err"] <= K1_TOL)
        checks[f"{r['shape']}_copy_floor_bit_equal"] = (
            r["copy_floor_bit_equal"])
    out["bench"] = results
    emit({"phase": "bench", "shapes": results, "launches": launches,
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"bench checks failed: {failed}")


# the train phase: ResNet50/224 fine-tunes on synthetic class-pattern
# images made on the card, 2,048 to train on and 512 to validate
N_TRAIN, N_VAL = 2048, 512
TRAIN_BATCH = 32  # the main run's, and its train images/s
TRAIN_IMAGE_SIZE = 224
# the step-level gates run from the same weights and draws: at random
# init (_random_state_dict) and, for K1, also from the fit's weights.
# The card's f32 'highest' step against the CPU's, at random init, B=8 and
# 32: loss relative gap and each trainable tensor's max|g_card - g_cpu|
# over its own max|g_cpu|, with the card's ReLUs held to the CPU run's
# masks.  Free, the two steps part by up to 3.5e-2 of layer4's max|g|:
# at random init layer4's gradients nearly cancel over the batch's
# positions, and the one to three ReLU elements that f32 rounding puts on
# the other side of 0 move them that far, on either device
# (tools/step_conditioning.py).  The same bars hold the card's float64
# step (compute_dtype 'float64') against the CPU's.
CARD_CPU_LOSS_TOL, CARD_CPU_GRAD_TOL = 1e-4, 1e-3
CARD_CPU_BATCHES = (8, 32)
# Every op of layer4 and the head in the card's f32 step (conv, BN,
# linear: forward, weight, bias and input gradients), recomputed in
# float64 from its own f32 operands: max|f32 - f64| over max|f64|.
# Measured 3.963e-6 to 6.188e-6 on the card in three runs (B=8 and 32;
# NVIDIA H100 80GB HBM3, 700.00 W); TF32 rounds each operand to 2^-11,
# about 5e-4.
F32_OP_TOL = 1e-4
# The card's f32 augmentation against the CPU's on the same uint8 batch and
# draws, max abs gap in normalized units: the crop's source coordinates
# part by an f32 ulp, times the pixel slope (measured 8.8e-5).
AUG_TOL = 1e-3
# 'auto' (K1 and the folded stem and blocks 0) against cuDNN ('off'), one
# bf16 step at B=32: the loss's relative gap and max|g_auto - g_off| over
# max|g_off| within layer4 and within the head.  Each bar is twice the
# drift of a bf16 step from the f32 step, measured the same way (NVIDIA
# H100 80GB HBM3, 700.00 W): two steps each no farther from f32 part by
# at most that.  At random init, from seed 0's cuDNN step: loss 6.236e-4,
# layer4 0.4289, head 3.609e-2.  From the fit's weights one reading is
# not enough: the bars twice seed 0's (2.03e-2, 0.108, 3.77e-2) failed
# the parent's own path (K1 alone) on 7 of the step_spread phase's 9
# readings (3 seeds x 3 batches), which part from cuDNN by up to loss
# 2.280e-2, layer4 0.2010, head 3.004e-2.  There the largest drift of
# the parent's two bf16 paths (K1 alone, cuDNN) from the f32 step over
# those 9 readings sets them: loss 2.290e-2, layer4 0.2083, head
# 3.492e-2 (medians 5.7e-3 to 6.1e-3, 0.104 to 0.114, 9.2e-3 to
# 1.66e-2).  'auto' reads up to 2.283e-2, 0.1933 and 3.433e-2 from cuDNN
# there, and drifts from f32 by up to 1.769e-2, 0.1974, 2.652e-2.
K1_STEP_TOL = {
    "random_init": {"loss": 1.25e-3, "layer4": 0.86, "head": 7.2e-2},
    "fit_weights": {"loss": 4.58e-2, "layer4": 0.417, "head": 6.98e-2}}
# the step_spread phase: its seeds (--seed and the next ones) and the
# train batches read at each state
STEP_SPREAD_SEEDS, STEP_SPREAD_BATCHES = 3, 3
# train images/s: fits of TRAIN_TIMED_EPOCHS timed epochs (after one
# untimed, cuDNN's algorithm search) per batch, K1 on and off in turns
# (on, off, off, on, ...), TRAIN_PAIRS fits of each
TRAIN_TIMED_EPOCHS, TRAIN_PAIRS = 3, 3


def _train_sets(seed: int, n_train: int = N_TRAIN, n_val: int = N_VAL):
    """(train, val, info): n_train + n_val synthetic images from the seed
    (made on the card as the curation phase makes them), class weights
    n / (k * count) as the curation CLI's dataset analysis gives them."""
    from irp_tpu_torch.config import DatasetInfo
    from irp_tpu_torch.data.pipeline import CachedDataset

    images, labels, _ = _curation_images(seed + 5, n_train + n_val)
    names = tuple(f"class{c}" for c in range(N_CLASSES))

    def subset(sl):
        return CachedDataset(images=images[sl], labels=labels[sl],
                             keys=[f"img{i}" for i in range(
                                 *sl.indices(len(labels)))],
                             class_names=names)

    train, val = subset(slice(0, n_train)), subset(slice(n_train, None))
    counts = np.bincount(train.labels, minlength=N_CLASSES)
    info = DatasetInfo(num_classes=N_CLASSES, class_names=names,
                       class_weights=tuple(float(n_train / (N_CLASSES * c))
                                           for c in counts),
                       class_counts=tuple(int(c) for c in counts),
                       total_samples=n_train)
    return train, val, info


def _train_model_cfg(**kw):
    from irp_tpu_torch.config import ModelConfig

    return ModelConfig(depth=50, num_classes=N_CLASSES,
                       image_size=TRAIN_IMAGE_SIZE, hidden_dim=512, **kw)


def _augmented(images, labels, draws, device, dtype=torch.float32):
    """The step's augmentation (medium, no mixing) of a host uint8 batch on
    ``device``: (x NHWC, labels)."""
    from irp_tpu_torch.train.step import StepConfig, augment_mix

    scfg = StepConfig(intensity="medium", out_size=TRAIN_IMAGE_SIZE,
                      compute_dtype=dtype, dropout_rate=0.0)
    x, y, _, _ = augment_mix(torch.from_numpy(images).to(device),
                             torch.from_numpy(labels).long().to(device),
                             scfg, draws.to(device), None)
    return x, y


def _op_hooks(model, cap: dict) -> list:
    """Hooks that keep each layer4 and head op's f32 operands: input,
    output and their gradients."""
    from irp_tpu_torch.models.classifier import Linear
    from irp_tpu_torch.models.resnet import BatchNorm2d, Conv2d

    hooks = []
    for name, mod in model.named_modules():
        if not (name.startswith(("backbone.layer4", "classifier"))
                and isinstance(mod, (Conv2d, BatchNorm2d, Linear))):
            continue

        def fwd(mod, inp, out, name=name):
            cap[name] = {"x": inp[0].detach(), "y": out.detach()}

        def bwd(mod, gin, gout, name=name):
            cap[name]["gy"] = gout[0]
            cap[name]["gx"] = gin[0]
        hooks += [mod.register_forward_hook(fwd),
                  mod.register_full_backward_hook(bwd)]
    return hooks


def _op_errors(model, cap: dict) -> dict:
    """Each captured op recomputed in float64 from its own f32 operands:
    max|f32 - f64| / max|f64| of its output and of its weight, bias and
    input gradients; returns the worst op and value."""
    import torch.nn.functional as F

    from irp_tpu_torch.models.resnet import BatchNorm2d, Conv2d

    def rel(got, want):
        want = want.detach()
        return float((got.double() - want).abs().max()
                     / want.abs().max().clamp_min(1e-300))

    mods = dict(model.named_modules())
    worst = (0.0, None)
    for name, c in cap.items():
        mod = mods[name]
        x = c["x"].double().requires_grad_(c["gx"] is not None)
        w = mod.weight.detach().double().requires_grad_()
        b = (None if mod.bias is None
             else mod.bias.detach().double().requires_grad_())
        if isinstance(mod, Conv2d):
            y = F.conv2d(x, w, None, mod.stride, mod.padding, 1, mod.groups)
        elif isinstance(mod, BatchNorm2d):
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0)
            y = ((x - mean[:, None, None])
                 * (torch.rsqrt(var + mod.eps) * w)[:, None, None]
                 + b[:, None, None])
        else:
            y = F.linear(x, w, b)
        y.backward(c["gy"].double())
        errs = {"output": rel(c["y"], y), "weight": rel(mod.weight.grad,
                                                        w.grad)}
        if b is not None:
            errs["bias"] = rel(mod.bias.grad, b.grad)
        if c["gx"] is not None:
            errs["input"] = rel(c["gx"], x.grad)
        for kind, e in errs.items():
            if e > worst[0]:
                worst = (e, f"{name} {kind}")
    return {"max_rel": worst[0], "worst": worst[1], "ops": len(cap)}


def _one_step_grads(cfg, state_dict, x, y, class_weights, device,
                    op_check: bool = False, unfold: bool = False):
    """Loss and trainable gradients (host float64) of one train step
    (dropout 0) of a model with ``state_dict`` on ``device`` from the
    augmented batch ``x``; with ``op_check`` also :func:`_op_errors` of
    its layer4 and head ops; with ``unfold`` the frozen prefix as the
    parent commit ran it (K1 alone: the stem and blocks 0 unfolded)."""
    from irp_tpu_torch.models.classifier import get_classifier
    from irp_tpu_torch.models.resnet import FoldCache
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.step import StepConfig, loss_and_grads

    model = get_classifier(cfg, device=device)
    model.load_state_dict(state_dict)
    if unfold:
        for m in model.backbone.modules():
            if isinstance(m, FoldCache) and not getattr(m, "fusable", False):
                m.foldable = False
    set_mode(model, True)
    dtype = getattr(torch, cfg.compute_dtype)
    scfg = StepConfig(intensity="medium", out_size=cfg.image_size,
                      compute_dtype=dtype, dropout_rate=0.0)
    cap: dict = {}
    hooks = _op_hooks(model, cap) if op_check else []
    with warnings.catch_warnings():
        # layer4's first convs take the frozen prefix's output: no input
        # gradient, which the full backward hook warns of
        warnings.filterwarnings("ignore", "Full backward hook is firing")
        loss, _ = loss_and_grads(model, x.to(device, dtype), y.to(device),
                                 scfg,
                                 torch.tensor(class_weights, device=device))
    for h in hooks:
        h.remove()
    grads = {n: p.grad.double().cpu().numpy()
             for n, p in model.named_parameters() if p.requires_grad}
    if op_check:
        return float(loss), grads, _op_errors(model, cap)
    return float(loss), grads


def _grad_gap(got: tuple, want: tuple) -> dict:
    """Gaps of one step (loss, grads) from another: the loss's relative
    gap; max|got - want| over the largest |want| within layer4 and within
    the head; and per tensor, over that tensor's own max|want|, the
    largest (``per_tensor``) and where (``worst``)."""
    g, w = got[1], want[1]

    def group(names):
        scale = max(float(np.abs(w[n]).max()) for n in names)
        return (max(float(np.abs(g[n] - w[n]).max()) for n in names)
                / max(scale, 1e-300))

    per = {n: float(np.abs(g[n] - w[n]).max())
           / max(float(np.abs(w[n]).max()), 1e-300) for n in w}
    worst = max(per, key=per.get)
    return {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
            "layer4": group([n for n in w if ".layer4." in f".{n}"]),
            "head": group([n for n in w if n.startswith("classifier")]),
            "per_tensor": per[worst], "worst": worst}


def _k1_vs_cudnn(model_cfg, state_dict, x, y, cw) -> dict:
    """One bf16 step, K1 ('auto') and cuDNN ('off'), and the f32 step, from
    the same weights and batch: K1's gaps from cuDNN and cuDNN's drift
    from f32 (:func:`_grad_gap`)."""
    import dataclasses

    steps = {name: _one_step_grads(cfg, state_dict, x, y, cw, "cuda")
             for name, cfg in (("auto", model_cfg),
                               ("off", dataclasses.replace(
                                   model_cfg, fused_frozen_blocks="off")),
                               ("f32", _f32(model_cfg)))}
    finite = all(np.isfinite(g).all() for s in steps.values()
                 for g in s[1].values())
    return {"k1_vs_cudnn": _grad_gap(steps["auto"], steps["off"]),
            "bf16_vs_f32_drift": _grad_gap(steps["off"], steps["f32"]),
            "finite": finite}


def phase_step_spread(out: dict, seed: int) -> None:
    """K1_STEP_TOL's readings over seeds and batches.  Per seed (``seed``
    and the next STEP_SPREAD_SEEDS - 1) the train phase's fit, then at
    random init and from the fit's weights, on each of the first
    STEP_SPREAD_BATCHES train batches (the first's draws at ``seed`` are
    the train phase's own), one bf16 step of 'auto', of the parent's
    path (K1 alone) and of 'off', and the f32 step: the gaps
    (:func:`_grad_gap`) of each from f32 and of 'auto' and K1 alone from
    'off'; per state the median and the largest."""
    import dataclasses

    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.ops.preprocess import sample_augment_draws
    from irp_tpu_torch.train import fit

    b = TRAIN_BATCH
    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    paths = {"auto": (cfg, False), "k1only": (cfg, True),
             "off": (dataclasses.replace(cfg, fused_frozen_blocks="off"),
                     False), "f32": (_f32(cfg), False)}
    pairs = (("auto", "f32"), ("k1only", "f32"), ("off", "f32"),
             ("auto", "off"), ("k1only", "off"))
    keys = ("loss_rel", "layer4", "head")
    rows = []
    for s in range(seed, seed + STEP_SPREAD_SEEDS):
        train, val, info = _train_sets(s)
        res = fit(train, val, info, cfg, TrainConfig(
            batch_size=b, max_epochs=2, patience=99, seed=s,
            eval_samples=min(512, N_VAL)))
        fit_sd = {k: v.detach().cpu().clone()
                  for k, v in res.state.model.state_dict().items()}
        cw = info.class_weights
        for state, sd in (("random_init", _random_state_dict(s)),
                          ("fit_weights", fit_sd)):
            for i in range(STEP_SPREAD_BATCHES):
                draws = sample_augment_draws(
                    torch.Generator().manual_seed(s * 100 + i), b, 256, 256,
                    "medium")
                x, y = _augmented(train.images[b * i:b * (i + 1)],
                                  train.labels[b * i:b * (i + 1)], draws,
                                  "cuda")
                steps = {name: _one_step_grads(c, sd, x, y, cw, "cuda",
                                               unfold=unfold)
                         for name, (c, unfold) in paths.items()}
                row = {"seed": s, "state": state, "batch": i}
                for a, c in pairs:
                    gap = _grad_gap(steps[a], steps[c])
                    row[f"{a}_vs_{c}"] = {k: gap[k] for k in keys}
                emit({"phase": "step_spread", **row})
                rows.append(row)
    summary = {}
    for state in ("random_init", "fit_weights"):
        for a, c in pairs:
            for k in keys:
                v = [r[f"{a}_vs_{c}"][k] for r in rows if r["state"] == state]
                summary[f"{state}.{a}_vs_{c}.{k}"] = {
                    "median": statistics.median(v), "max": max(v),
                    "n": len(v)}
    out["step_spread"] = summary
    emit({"phase": "step_spread", "summary": summary})


def _train_throughput(train, val, info, batch: int, seed: int) -> dict:
    """Train images/s of fit at ``batch``, K1 on ('auto') and off: per
    timed epoch (CUDA events around the epoch, eval excluded) of
    TRAIN_PAIRS fits of each, run in turns; the median, least and most."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.train import fit

    cfg = TrainConfig(batch_size=batch, max_epochs=1 + TRAIN_TIMED_EPOCHS,
                      patience=99, seed=seed, train_samples_per_epoch=N_TRAIN,
                      eval_samples=batch)
    per_epoch = {"on": [], "off": []}
    order = [("on", "off"), ("off", "on")] * ((TRAIN_PAIRS + 1) // 2)
    for pair in order[:TRAIN_PAIRS]:
        for k1 in pair:
            mcfg = _train_model_cfg(
                fused_frozen_blocks="auto" if k1 == "on" else "off")
            res = fit(train, val, info, mcfg, cfg)
            per_epoch[k1] += [res.steps_per_epoch * batch / (ms / 1e3)
                              for ms in res.history["train_ms"][1:]]
    out = {"steps_per_epoch": res.steps_per_epoch,
           "timed_epochs_per_fit": TRAIN_TIMED_EPOCHS}
    for k1, v in per_epoch.items():
        out[f"k1_{k1}"] = {"median": statistics.median(v), "min": min(v),
                           "max": max(v), "epochs": len(v)}
    out["on_over_off"] = out["k1_on"]["median"] / out["k1_off"]["median"]
    return out


def phase_train(out: dict, seed: int) -> None:
    """The fine-tune: fit at ResNet50/224, bf16, K1 on ('auto'), medium
    augmentation, batch 32, adam on the OneCycle schedule with class
    weights, 2 epochs of 32 steps with eval on 512 images each, on the
    card; then the step-level gates at random init and from the fit's
    weights, and train images/s."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.ops.preprocess import sample_augment_draws
    from irp_tpu_torch.tools.step_conditioning import relu_masks
    from irp_tpu_torch.train import fit

    t0 = time.perf_counter()
    train, val, info = _train_sets(seed)
    model_cfg = _train_model_cfg(fused_frozen_blocks="auto")
    train_cfg = TrainConfig(batch_size=TRAIN_BATCH, max_epochs=2,
                            patience=99, seed=seed,
                            eval_samples=min(512, N_VAL))
    setup_s = time.perf_counter() - t0
    # the main path: counts from 0 just before, read just after
    _zero_launch_counts()
    t0 = time.perf_counter()
    res = fit(train, val, info, model_cfg, train_cfg)
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    out["launches"]["train"] = launches
    h = res.history
    steps = res.steps_per_epoch
    eval_batches = math.ceil(train_cfg.eval_samples / train_cfg.batch_size)
    want_k1 = 10 * train_cfg.max_epochs * (steps + eval_batches)
    want_k2 = train_cfg.max_epochs * eval_batches
    want_bn = 10 * train_cfg.max_epochs * steps  # layer4's, train forwards

    t0 = time.perf_counter()
    cw = info.class_weights
    init_sd = _random_state_dict(seed)
    fit_sd = {k: v.detach().cpu().clone()
              for k, v in res.state.model.state_dict().items()}
    f32_cfg, f64_cfg = _f32(model_cfg), _f64(model_cfg)
    # K1 against cuDNN, at random init and from the fit's weights
    b = TRAIN_BATCH
    x, y = _augmented(train.images[:b], train.labels[:b],
                      sample_augment_draws(torch.Generator().manual_seed(seed),
                                           b, 256, 256, "medium"), "cuda")
    k1 = {state: _k1_vs_cudnn(model_cfg, sd, x, y, cw)
          for state, sd in (("random_init", init_sd), ("fit_weights",
                                                         fit_sd))}
    # at random init: the card's f32 step against the CPU's on the same
    # ReLU masks and in float64, the card's f32 ops against float64, and
    # the free f32 readings beside them
    card_cpu = {}
    for n in CARD_CPU_BATCHES:
        draws = sample_augment_draws(torch.Generator().manual_seed(seed + 1),
                                     n, 256, 256, "medium")
        imgs, labs = train.images[:n], train.labels[:n]
        x_cpu, y_cpu = _augmented(imgs, labs, draws, "cpu")
        x_card, _ = _augmented(imgs, labs, draws, "cuda")
        aug = float((x_card.cpu() - x_cpu).abs().max())
        f64 = {dev: _one_step_grads(f64_cfg, init_sd, x_cpu, y_cpu, cw, dev)
               for dev in ("cuda", "cpu")}
        masks = {"cpu": [], "cuda": []}
        with relu_masks(masks["cpu"], record=True):
            cpu32 = _one_step_grads(f32_cfg, init_sd, x_cpu, y_cpu, cw, "cpu")
        with relu_masks(masks["cuda"], record=True):
            *card32, ops = _one_step_grads(f32_cfg, init_sd, x_cpu, y_cpu,
                                           cw, "cuda", op_check=True)
        # the card's f32 step on the CPU's ReLU masks: where rounding puts
        # a pre-activation on the other side of 0, the step's gradients
        # jump (tools/step_conditioning.py)
        with relu_masks(masks["cpu"], record=False):
            held = _one_step_grads(f32_cfg, init_sd, x_cpu, y_cpu, cw, "cuda")
        card_cpu[n] = {
            "augment_max_abs": aug,
            "f32_card_vs_cpu_on_cpu_masks": _grad_gap(held, cpu32),
            "f32_ops_vs_f64": ops,
            "f64_card_vs_cpu": _grad_gap(f64["cuda"], f64["cpu"]),
            "f32_card_vs_cpu": _grad_gap(tuple(card32), cpu32),
            "relu_elements_masked_differently": sum(
                int((a.cpu() != b).sum())
                for a, b in zip(masks["cuda"], masks["cpu"])),
            "f32_card_vs_f64": _grad_gap(tuple(card32), f64["cpu"]),
            "f32_cpu_vs_f64": _grad_gap(cpu32, f64["cpu"])}
    gates_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ips = {f"b{TRAIN_BATCH}": _train_throughput(train, val, info,
                                                TRAIN_BATCH, seed)}
    ips_s = time.perf_counter() - t0
    checks = {
        "losses_finite": bool(np.isfinite(h["train_loss"]).all()
                              and np.isfinite(h["val_loss"]).all()),
        "loss_falls": h["train_loss"][1] < h["train_loss"][0],
        "k1_ten_per_forward": launches["identity_bottleneck"] == want_k1,
        "epilogue_ten_per_forward": launches["frozen_epilogue"] == want_k1,
        "k2_once_per_eval_batch": launches["eval_preprocess"] == want_k2,
        "bn_train_ten_per_train_forward": launches["batch_norm_train"]
        == want_bn,
    }
    for state, r in k1.items():
        checks[f"{state}_grads_finite"] = r["finite"]
        gap = r["k1_vs_cudnn"]
        for key, bar in K1_STEP_TOL[state].items():
            val = gap["loss_rel" if key == "loss" else key]
            checks[f"{state}_k1_vs_cudnn_{key}"] = val <= bar
    for n, r in card_cpu.items():
        checks[f"b{n}_augment_card_vs_cpu"] = r["augment_max_abs"] <= AUG_TOL
        for name in ("f32_card_vs_cpu_on_cpu_masks", "f64_card_vs_cpu"):
            checks[f"b{n}_{name}_loss"] = (r[name]["loss_rel"]
                                           <= CARD_CPU_LOSS_TOL)
            checks[f"b{n}_{name}_grads_per_tensor"] = (
                r[name]["per_tensor"] <= CARD_CPU_GRAD_TOL)
        checks[f"b{n}_f32_ops_vs_f64"] = (r["f32_ops_vs_f64"]["max_rel"]
                                          <= F32_OP_TOL)
    emit({"phase": "train",
          "model": "ResNet50/224 bf16, K1 'auto', 10 classes, hidden 512",
          "recipe": "medium aug, adam + coupled L2, onecycle, class weights",
          "batch": train_cfg.batch_size, "epochs": train_cfg.max_epochs,
          "steps_per_epoch": steps, "train_images": N_TRAIN,
          "val_images": N_VAL, "setup_s": setup_s, "fit_s": fit_s,
          "gates_s": gates_s, "throughput_s": ips_s,
          "history": h, "best_val_acc": res.best_val_acc,
          "launches": launches,
          "expected_launches": _launches(want_k2, want_k1,
                                         bn_train=want_bn),
          "step_k1_vs_cudnn": k1, "step_card_vs_cpu_random_init": card_cpu,
          "train_images_per_s": ips, "checks": checks})
    out["train_images_per_s"] = ips
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"train checks failed: {failed}")


# The families_train phase: ViT-B/16, ConvNeXt-Tiny and EfficientNet-B0
# trained at full width (the families phase's FAMILY_MODELS), each with its
# variant's stochastic depth and default trainable stages, from seeded
# random weights.
FT_TRAIN, FT_VAL = 1024, 256  # class-pattern images; eval on FT_VAL
FT_BATCH, FT_EPOCHS, FT_STEPS = 32, 2, 16  # the short fit
FT_STEP_BATCH = 8  # the card-vs-CPU step on given draws
FT_REMAT_BATCH = 64
# ViT-B/16's blocks 8-11 train in the remat check: with one trainable
# block the recompute holds what the stored activations held
FT_REMAT_STAGES = ("block8", "block9", "block10", "block11", "ln")
FT_IPS_STEPS = {32: 10, 256: 5}  # timed steps per turn after FT_WARMUP
FT_WARMUP = 3
FT_IDLE_STEPS = 5  # profiled B=32 steps per model for the idle share
FT_SWEEP_TRAIN_SHARDS = 4  # 1,024 JPEGs for the sweep and the final run
FT_FINAL_EPOCHS = 2
# train-mode BatchNorms a train forward runs through the op, at the
# families' default trainable stages: EfficientNet-B0's last block (its
# expansion and depthwise BNs, 1152 channels; its projection's, 320) and
# its head conv's (1280); ViT and ConvNeXt have none
FT_BN_PER_FORWARD = {"vit": 0, "convnext": 0, "efficientnet": 4}
# and ResNet50's at its default trainable stage, layer4
RESNET50_BN_PER_FORWARD = 10
# A gradient that vanishes but for rounding (a BN's bias whose output
# reaches the loss only through a BatchNorm collecting statistics, as
# EfficientNet's stage7_block0 project BN before the top BN) is held to
# vanish on the card too: below this share of the step's largest.
FT_VANISHING = 1e-5
# The bf16 step's drift from the f32 step on the card, per family: the
# loss's relative gap and the worst tensor's max|g_bf16 - g_f32| over its
# own max|g_f32|, each bar twice the first reading on an H100 80GB HBM3
# at 700 W (loss ViT 1.202e-3, ConvNeXt 7.873e-4, EfficientNet 5.546e-5;
# worst tensor 0.1663 (ViT's last ln_2 weight), 0.2057 and 0.5837 (the
# head's first weight); PERF.md §6)
FT_BF16_STEP_TOL = {"vit": {"loss": 2.40e-3, "per_tensor": 0.333},
                    "convnext": {"loss": 1.57e-3, "per_tensor": 0.411},
                    "efficientnet": {"loss": 1.11e-4, "per_tensor": 1.17}}


def _ft_cfg(family: str, variant: str, **kw):
    """The family's ModelConfig at full width: its variant's recipe
    (stochastic depth, head dropout, default trainable stages), 224 crop,
    10 classes, MLP head 512, bf16."""
    from irp_tpu_torch.cli.model_args import model_config_for_family

    return model_config_for_family(
        family, vit_variant=variant, efficientnet_variant=variant,
        convnext_variant=variant, num_classes=N_CLASSES, image_size=224,
        hidden_dim=512, **kw)


def _ft_counts() -> dict:
    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.ops.cuda_image import eval_preprocess
    from irp_tpu_torch.ops.cuda_resnet import fused_identity_bottleneck

    return {"eval_preprocess": eval_preprocess.launches,
            "identity_bottleneck": fused_identity_bottleneck.launches,
            "batch_norm_train": batch_norm_train.launches}


def _ft_fit(family, variant, seed, train, val, info) -> tuple:
    """(a) fit for FT_EPOCHS epochs of FT_STEPS steps at FT_BATCH, eval on
    FT_VAL each epoch, launches counted from 0; frozen parameters (and
    the frozen stages' BN statistics) against the init bit for bit."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.models.classifier import init_classifier
    from irp_tpu_torch.train import fit

    cfg = _ft_cfg(family, variant)
    tcfg = TrainConfig(batch_size=FT_BATCH, max_epochs=FT_EPOCHS,
                       patience=99, seed=seed,
                       train_samples_per_epoch=FT_STEPS * FT_BATCH,
                       eval_samples=FT_VAL)
    # fit draws its init from the same seed on the CPU
    init = init_classifier(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    init_sd = {k: v.clone() for k, v in init.state_dict().items()}
    frozen_bn = {f"{name}.{buf}" for name, m in init.named_modules()
                 if getattr(m, "frozen", False)
                 for buf in ("running_mean", "running_var")}
    trainable = {n for n, p in init.named_parameters() if p.requires_grad}
    _zero_launch_counts()
    t0 = time.perf_counter()
    res = fit(train, val, info, cfg, tcfg)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _ft_counts()
    after = {k: v.detach().cpu() for k, v in
             res.state.model.state_dict().items()}
    params = [n for n, _ in init.named_parameters()]
    h = res.history
    eval_batches = math.ceil(FT_VAL / FT_BATCH)
    report = {
        "config": _architecture(cfg) | {
            "stochastic_depth": cfg.stochastic_depth,
            "dropout_rate": cfg.dropout_rate,
            "trainable_stages": list(cfg.trainable_stages),
            "sd_blocks": len(init.sd_probs())},
        "fit_s": fit_s, "history": h, "best_val_acc": res.best_val_acc,
        "train_images_per_s": [FT_STEPS * FT_BATCH / (ms / 1e3)
                               for ms in h["train_ms"]],
        "trainable_tensors": len(trainable),
        "frozen_tensors": len(params) - len(trainable),
        "frozen_bn_buffers": len(frozen_bn), "launches": launches,
        "expected_launches": {"eval_preprocess": FT_EPOCHS * eval_batches,
                              "identity_bottleneck": 0,
                              "batch_norm_train": FT_EPOCHS * FT_STEPS
                              * FT_BN_PER_FORWARD[family]}}
    checks = {
        "losses_finite": bool(np.isfinite(h["train_loss"]).all()
                              and np.isfinite(h["val_loss"]).all()),
        "loss_falls": h["train_loss"][1] < h["train_loss"][0],
        "k2_once_per_eval_batch_k1_never":
            launches == report["expected_launches"],
        "frozen_params_unchanged": all(
            torch.equal(after[n], init_sd[n]) for n in params
            if n not in trainable),
        "trainable_params_changed": all(
            not torch.equal(after[n], init_sd[n]) for n in trainable)}
    if family == "efficientnet":
        checks["frozen_bn_stats_unchanged"] = bool(frozen_bn) and all(
            torch.equal(after[k], init_sd[k]) for k in frozen_bn)
    return report, checks, init_sd


def _ft_step(cfg, sd, x, y, cw, masks, device, relu=None):
    """Loss and trainable gradients (host float64) of one train step of a
    model with weights ``sd`` on ``device`` from the augmented batch
    ``x`` and the given (stochastic-depth, head dropout) masks; ``relu``:
    a ``relu_masks`` context to run the step in."""
    import contextlib

    from irp_tpu_torch.models.classifier import get_classifier
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.step import StepConfig, loss_and_grads

    model = get_classifier(cfg, device=device)
    model.load_state_dict(sd)
    set_mode(model, True)
    dtype = getattr(torch, cfg.compute_dtype)
    scfg = StepConfig(out_size=cfg.image_size, compute_dtype=dtype,
                      dropout_rate=cfg.dropout_rate)
    sd_masks = {k: m.to(device) for k, m in masks[0].items()}
    head = tuple(m.to(device) for m in masks[1])
    with relu or contextlib.nullcontext():
        loss, _ = loss_and_grads(model, x.to(device, dtype), y.to(device),
                                 scfg, torch.tensor(cw, device=device),
                                 dropout_masks=head, sd_masks=sd_masks)
    return float(loss), {n: p.grad.double().cpu().numpy()
                         for n, p in model.named_parameters()
                         if p.requires_grad}


def _ft_gap(got: tuple, want: tuple) -> dict:
    """The loss's relative gap and, per tensor, max|got - want| over that
    tensor's max|want| (the worst, and where), tensors whose gradient
    vanishes held to FT_VANISHING of the step's largest."""
    g, w = got[1], want[1]
    largest = max(float(np.abs(t).max()) for t in w.values())
    noise = FT_VANISHING * largest
    per, vanishing = {}, {}
    for n in w:
        scale = float(np.abs(w[n]).max())
        if scale <= noise:
            vanishing[n] = float(np.abs(g[n]).max()) / largest
        else:
            per[n] = float(np.abs(g[n] - w[n]).max()) / scale
    worst = max(per, key=per.get)
    return {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
            "per_tensor": per[worst], "worst": worst,
            "vanishing_tensors": len(vanishing),
            "vanishing_max_share": max(vanishing.values(), default=0.0)}


def _ft_card_vs_cpu(family, variant, sd, train, info, seed) -> tuple:
    """(b) one step at FT_STEP_BATCH on given augmentation, stochastic-
    depth and dropout draws: the card's f32 'highest' step (TF32 off)
    against the CPU's on the CPU run's ReLU masks (and free), and the
    card's bf16 step against its f32 step."""
    from irp_tpu_torch.models.classifier import Classifier
    from irp_tpu_torch.models.layers import sample_sd_masks
    from irp_tpu_torch.ops.preprocess import sample_augment_draws
    from irp_tpu_torch.tools.step_conditioning import relu_masks

    cfg = _ft_cfg(family, variant)
    n = FT_STEP_BATCH
    gen = torch.Generator().manual_seed(seed + 1)
    # ConvNeXt's layer scales start at 1e-6, which leaves its blocks'
    # gradients 1e-6 of the head's: drawn in [0.1, 0.5] they weigh in
    sd = {k: (0.1 + 0.4 * torch.rand(v.shape, generator=gen)
              if k.endswith("layer_scale") else v) for k, v in sd.items()}
    draws = sample_augment_draws(gen, n, 256, 256, "medium")
    x, y = _augmented(train.images[:n], train.labels[:n], draws, "cpu")
    probe = Classifier(cfg)
    keep = 1.0 - cfg.dropout_rate
    masks = (sample_sd_masks(probe.sd_probs(), n, gen),
             (torch.rand(n, probe.backbone.num_features, generator=gen)
              < keep,
              torch.rand(n, cfg.hidden_dim, generator=gen) < keep))
    cw = info.class_weights
    f32 = _f32(cfg)
    recorded = {"cpu": [], "cuda": []}
    cpu = _ft_step(f32, sd, x, y, cw, masks, "cpu",
                   relu_masks(recorded["cpu"], record=True))
    card = _ft_step(f32, sd, x, y, cw, masks, "cuda",
                    relu_masks(recorded["cuda"], record=True))
    held = _ft_step(f32, sd, x, y, cw, masks, "cuda",
                    relu_masks(recorded["cpu"], record=False))
    bf16 = _ft_step(cfg, sd, x, y, cw, masks, "cuda")
    report = {
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "sd_masks_dropped": {k: int((~m).sum()) for k, m in
                             masks[0].items()},
        "f32_card_vs_cpu_on_cpu_masks": _ft_gap(held, cpu),
        "f32_card_vs_cpu_free": _ft_gap(card, cpu),
        "relu_elements_masked_differently": sum(
            int((a.cpu() != b).sum())
            for a, b in zip(recorded["cuda"], recorded["cpu"])),
        "bf16_vs_f32_card": _ft_gap(bf16, card)}
    on_masks = report["f32_card_vs_cpu_on_cpu_masks"]
    drift = report["bf16_vs_f32_card"]
    tol = FT_BF16_STEP_TOL[family]
    checks = {
        "tf32_off": not torch.backends.cuda.matmul.allow_tf32,
        "f32_card_vs_cpu_loss": on_masks["loss_rel"] <= CARD_CPU_LOSS_TOL,
        "f32_card_vs_cpu_grads_per_tensor":
            on_masks["per_tensor"] <= CARD_CPU_GRAD_TOL,
        "f32_card_vs_cpu_vanishing":
            on_masks["vanishing_max_share"] <= FT_VANISHING,
        "bf16_step_finite": all(np.isfinite(g).all()
                                for g in bf16[1].values())
        and math.isfinite(bf16[0])}
    checks["bf16_vs_f32_loss"] = drift["loss_rel"] <= tol["loss"]
    checks["bf16_vs_f32_per_tensor"] = (drift["per_tensor"]
                                        <= tol["per_tensor"])
    return report, checks


def _ft_remat(sd, seed) -> tuple:
    """(c) ViT-B/16's f32 step at FT_REMAT_BATCH with blocks 8-11
    trainable, remat off and on: the loss and the peak allocated memory
    above the step's inputs."""
    import dataclasses

    from irp_tpu_torch.models.classifier import get_classifier
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.step import StepConfig, loss_and_grads

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(FT_REMAT_BATCH, 224, 224, 3, device="cuda",
                    generator=gen)
    y = torch.randint(0, N_CLASSES, (FT_REMAT_BATCH,), device="cuda",
                      generator=gen)
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(
            _f32(_ft_cfg("vit", "b_16")), dropout_rate=0.0,
            trainable_stages=FT_REMAT_STAGES, remat_trainable_blocks=remat)
        model = get_classifier(cfg, device="cuda")
        model.load_state_dict(sd)
        set_mode(model, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _ = loss_and_grads(model, x, y, StepConfig(
            compute_dtype=torch.float32, dropout_rate=0.0))
        torch.cuda.synchronize()
        runs["on" if remat else "off"] = {
            "loss": float(loss),
            "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20}
        del model
        torch.cuda.empty_cache()
    report = {"batch": FT_REMAT_BATCH, "trainable": list(FT_REMAT_STAGES),
              **runs, "loss_rel": abs(runs["on"]["loss"]
                                      - runs["off"]["loss"])
              / abs(runs["off"]["loss"])}
    checks = {"remat_loss_equal": report["loss_rel"] <= 1e-6,
              "remat_lowers_peak": runs["on"]["peak_mb"]
              < runs["off"]["peak_mb"]}
    return report, checks


def _ft_images_per_s(models: dict, train, info, seed) -> dict:
    """(d) train images/s of train_step at each batch of FT_IPS_STEPS, the
    models in turns (the order, then back), CUDA events around the timed
    steps after FT_WARMUP; then the device's idle share over
    FT_IDLE_STEPS profiled steps at batch 32."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.models.classifier import init_classifier
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, train_step

    cw = torch.tensor(info.class_weights, device="cuda")
    states = {}
    for name, cfg in models.items():
        model = init_classifier(cfg, torch.Generator().manual_seed(seed))
        states[name] = (create_train_state(model, TrainConfig(), cfg, 100),
                        StepConfig(intensity="medium", out_size=224,
                                   compute_dtype=torch.bfloat16,
                                   dropout_rate=cfg.dropout_rate))
    order = list(models)
    ips = {name: {} for name in order}
    idle = {}
    for b, steps in FT_IPS_STEPS.items():
        images = torch.from_numpy(train.images[:b]).cuda()
        labels = torch.from_numpy(train.labels[:b]).long().cuda()
        for name in order + order[::-1]:
            state, scfg = states[name]
            gen = torch.Generator(device="cuda").manual_seed(seed)
            mix_rng = np.random.default_rng(seed)

            def step():
                train_step(state, images, labels, scfg, cw, gen, mix_rng)

            for _ in range(FT_WARMUP):
                step()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                step()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            ips[name].setdefault(str(b), []).append(steps * b / (ms / 1e3))
            if b == 32 and name not in idle:
                prof = _profiled(step, FT_IDLE_STEPS)
                idle[name] = {k: prof[k] for k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "kernels")}
    return {"order": order + order[::-1], "images_per_s": ips,
            "b32_idle": idle}


def _ft_clis(seed, tmp) -> tuple:
    """(e) the CLIs on EfficientNet-B0: hyperopt_cli --family
    efficientnet --quick (1 trial x 2 folds) over FT_SWEEP_TRAIN_SHARDS
    shards, final_cli --family efficientnet over the one-trial study of
    _final_world (FT_FINAL_EPOCHS epochs), predict_cli --shards over the
    test shards with its final_model.npz; launches from 0 per run."""
    import contextlib
    import csv

    from irp_tpu_torch import tracking
    from irp_tpu_torch.cli import final_cli, hyperopt_cli, predict_cli
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.kfold import create_stratified_kfolds
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.hyperopt.study import create_study
    from irp_tpu_torch.infer import load_predictor

    family = ["--family", "efficientnet", "--efficientnet-variant", "b0"]
    world = _final_world(tmp, seed, FT_FINAL_EPOCHS,
                         train_shards=FT_SWEEP_TRAIN_SHARDS)
    data, uri, cache = world["data"], world["uri"], f"{tmp}/cache"
    runs, checks = {"write_shards_s": world["write_s"]}, {}

    # the sweep
    n_of = {s: HPO_PER_SHARD for s in world["train"]}
    folds = create_stratified_kfolds(world["train"], k=2, seed=seed)
    db = f"{tmp}/sweep.db"
    _zero_launch_counts()
    t0 = time.perf_counter()
    with _SweepProbe() as probe:
        rc = hyperopt_cli.main([
            "--data-dir", data, "--quick", "--n-trials", "1",
            "--k-folds", "2", "--first-fold-min-acc", "0", "--storage", db,
            "--study-name", "families_train", "--cache-dir", cache,
            "--seed", str(seed), *family])
    trials = create_study("families_train", db).get_trials()
    runs["sweep"] = {
        "seconds": time.perf_counter() - t0, "rc": rc,
        "launches": _ft_counts(),
        "expected_launches": _sweep_launches(
            folds, 1, batch=16, eval_samples=512, train_samples=1024,
            epochs=2, n_samples_of=n_of,
            bn_per_forward=FT_BN_PER_FORWARD["efficientnet"])
        | {"identity_bottleneck": 0},
        "trials": [(t.state, t.value) for t in trials], **probe.summary()}
    checks["sweep_rc_0"] = rc == 0
    checks["sweep_trial_complete"] = (
        len(trials) == 1 and trials[0].state == "COMPLETE"
        and math.isfinite(trials[0].value))

    # the final run over _final_world's one-trial study
    ckpt = f"{tmp}/ckpt"
    tracking.set_tracking_uri(uri)
    n_test = FINAL_TEST_SHARDS * HPO_PER_SHARD
    _zero_launch_counts()
    t0 = time.perf_counter()
    with _FinalProbe() as probe:
        rc = final_cli.main(["--data-dir", data, "--storage", world["db"],
                             "--study-name", "smoke_final",
                             "--cache-dir", cache, "--checkpoint-dir", ckpt,
                             *family])
    res = probe.results[0]
    final_fit = probe.fits[0][1]
    client = tracking.TrackingClient(uri)
    artifacts = client.list_artifacts(res.run_id)
    npz = client.artifact_path(res.run_id, "final_model.npz")
    pred = load_predictor(npz, batch_size=256)
    card = pred.model.config
    runs["final"] = {
        "seconds": time.perf_counter() - t0, "rc": rc,
        "launches": _ft_counts(),
        "expected_launches": {
            "eval_preprocess": math.ceil(n_test / FINAL_BATCH),
            "identity_bottleneck": 0,
            "batch_norm_train": FT_BN_PER_FORWARD["efficientnet"]
            * len(final_fit.history["train_ms"])
            * final_fit.steps_per_epoch},
        **probe.summary(n_test), "artifacts": artifacts,
        "model": {"family": card.family, "width_mult": card.width_mult,
                  "depth_mult": card.depth_mult,
                  "num_classes": card.num_classes,
                  "image_size": card.image_size}}
    checks["final_rc_0"] = rc == 0
    checks["final_epochs"] = runs["final"]["epochs"] == FT_FINAL_EPOCHS
    checks["final_artifacts"] = sorted(artifacts) == list(FINAL_ARTIFACTS)
    checks["final_model_is_efficientnet_b0"] = (
        card.family == "efficientnet"
        and (card.width_mult, card.depth_mult) == (1.0, 1.0))

    # batch prediction with the final .npz
    info = analyze_webdataset(world["train"])
    test_cached = build_cache(world["test"], info.class_names,
                              cache_dir=cache)
    preds_csv = f"{tmp}/preds.csv"
    printed = io.StringIO()
    _zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = predict_cli.main([
            "--weights", npz, "--shards", f"{data}/test-*.tar",
            "--batch-size", "256", "--classes", ",".join(info.class_names),
            "--out", preds_csv])
    seconds = time.perf_counter() - t0
    launches = _ft_counts()
    summary = json.loads(printed.getvalue().strip().splitlines()[-1])
    with open(preds_csv) as f:
        labels = {row["key"]: int(row["label"]) for row in csv.DictReader(f)}
    evaluated = dict(zip(test_cached.keys, probe.evals[0][1].preds.tolist()))
    agree = (sum(labels.get(k) == v for k, v in evaluated.items())
             / len(evaluated))
    runs["predict"] = {
        "seconds": seconds, "rc": rc,
        "imgs_per_sec": summary.get("imgs_per_sec"),
        "label_agreement_with_eval": agree, "launches": launches,
        "expected_launches": {"eval_preprocess": math.ceil(n_test / 256),
                              "identity_bottleneck": 0,
                              "batch_norm_train": 0}}
    checks["predict_rc_0"] = rc == 0
    checks["predict_agreement"] = agree >= PREDICT_AGREEMENT
    for name in ("sweep", "final", "predict"):
        checks[f"{name}_launches"] = (runs[name]["launches"]
                                      == runs[name]["expected_launches"])
    return runs, checks


def _ft_pretrained(seed, train, val, info, tmp) -> tuple:
    """(f) a torchvision-layout .pth of seeded ViT-B/16 weights (the
    families phase's model), written by export_torch_pth, through fit's
    pretrained_path: before the first step (0 epochs) the merged model's
    eval logits equal the source model's bit for bit."""
    import dataclasses
    import os

    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.train import fit
    from irp_tpu_torch.train.checkpoint import export_torch_pth
    from irp_tpu_torch.train.step import eval_step

    # in the memory format fit's model has, so that both forwards are one
    # program
    source = _family_model("vit", "b_16", seed + 3).to(
        "cuda", memory_format=torch.channels_last)
    path = export_torch_pth(f"{tmp}/vit_b_16.pth", source)
    cfg = dataclasses.replace(_ft_cfg("vit", "b_16"), pretrained_path=path)
    res = fit(train, val, info, cfg, TrainConfig(
        batch_size=FT_BATCH, max_epochs=0, seed=seed, eval_samples=FT_VAL))
    batch = torch.from_numpy(val.images[:FT_BATCH]).cuda()
    got = eval_step(res.state.model.eval(), batch)
    want = eval_step(source.eval(), batch)
    return ({"pth": os.path.basename(path),
             "logits_max_abs": float(want.abs().max())},
            {"pretrained_logits_bit_equal": bool(torch.equal(got, want))})


def phase_families_train(out: dict, seed: int) -> None:
    """Training of ViT-B/16, ConvNeXt-Tiny and EfficientNet-B0 on the card:
    (a) fit per family with launch and freezing gates; (b) the card's f32
    step against the CPU's on given draws, and the bf16 step's drift;
    (c) ViT-B/16's remat; (d) train images/s in turns with ResNet50 and
    the idle share at batch 32; (e) the sweep, final and predict CLIs on
    EfficientNet-B0; (f) a ViT-B/16 .pth through fit's pretrained_path."""
    t_phase = time.perf_counter()
    train, val, info = _train_sets(seed, FT_TRAIN, FT_VAL)
    checks, report = {}, {"fits": {}, "steps": {}}
    launches = {"eval_preprocess": 0, "identity_bottleneck": 0,
                "batch_norm_train": 0}
    init_sd = {}
    for family, variant in FAMILY_MODELS:
        t0 = time.perf_counter()
        fit_report, fit_checks, init_sd[family] = _ft_fit(
            family, variant, seed, train, val, info)
        _add_launches(launches, fit_report["launches"])
        step_report, step_checks = _ft_card_vs_cpu(
            family, variant, init_sd[family], train, info, seed)
        report["fits"][family] = fit_report
        report["steps"][family] = step_report
        checks.update({f"{family}_{k}": v for k, v in
                       {**fit_checks, **step_checks}.items()})
        emit({"phase": "families_train", "family": family,
              "variant": variant, "seconds": time.perf_counter() - t0,
              "fit": fit_report, "step_b8": step_report,
              "checks": {**fit_checks, **step_checks}})
    t0 = time.perf_counter()
    remat, remat_checks = _ft_remat(init_sd["vit"], seed)
    remat["seconds"] = time.perf_counter() - t0
    checks.update(remat_checks)
    emit({"phase": "families_train", "part": "remat_vit_b_16", **remat,
          "checks": remat_checks})
    t0 = time.perf_counter()
    models = {"resnet50": _train_model_cfg(fused_frozen_blocks="auto")}
    models.update({f"{f}_{v}": _ft_cfg(f, v) for f, v in FAMILY_MODELS})
    ips = _ft_images_per_s(models, train, info, seed)
    ips["seconds"] = time.perf_counter() - t0
    emit({"phase": "families_train", "part": "train_images_per_s", **ips})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli_runs, cli_checks = _ft_clis(seed, tmp)
        cli_runs["seconds"] = time.perf_counter() - t0
        for name in ("sweep", "final", "predict"):
            _add_launches(launches, cli_runs[name]["launches"])
        checks.update({f"cli_{k}": v for k, v in cli_checks.items()})
        emit({"phase": "families_train", "part": "clis_efficientnet_b0",
              **cli_runs, "checks": cli_checks})
        pre, pre_checks = _ft_pretrained(seed, train, val, info, tmp)
        checks.update(pre_checks)
    out["launches"]["families_train"] = launches
    seconds = time.perf_counter() - t_phase
    emit({"phase": "families_train", "seconds": seconds,
          "pretrained": pre, "launches": launches, "checks": checks})
    out["families_train"] = {"seconds": seconds,
                             "images_per_s": ips["images_per_s"]}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"families_train checks failed: {failed}")


# the sweep: synthetic JPEG shards at 256 px, 10 classes
HPO_SHARDS, HPO_PER_SHARD = 12, 256  # 3,072 images
HPO_TRIALS, HPO_K = 3, 3  # then one more trial resumed with K1 on
# the fold pool at the reference dataset's size, in 27 shards of ids
POOL_N, POOL_SHARDS = 26_179, 27


def _write_shards(seed: int, root: str, prefix: str = "train",
                  n_shards: int = HPO_SHARDS, patterns_seed=None) -> list:
    """n_shards x HPO_PER_SHARD class-pattern JPEGs (the curation phase's
    images, made on the card from the seed; ``patterns_seed`` as in
    _curation_images) as WebDataset shards ``<prefix>-*.tar`` through the
    port's ShardWriter."""
    from PIL import Image

    from irp_tpu_torch.data.tar import ShardWriter

    n = n_shards * HPO_PER_SHARD
    images, labels, _ = _curation_images(seed + 7, n, patterns_seed)
    writer = ShardWriter(root, prefix, HPO_PER_SHARD)
    with writer:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(images[i]).save(buf, format="JPEG", quality=90)
            name = f"class{int(labels[i])}"
            key = f"{name}_{i:06d}"
            writer.write({"__key__": key, "jpg": buf.getvalue(), "cls": name,
                          "json": {"class": name, "id": key}})
    return writer.shard_paths


class _SweepProbe:
    """Counts and times what one sweep runs, by wrapping the names the
    objective and the runner call: each trial, each fold-fit (and its
    train epochs' device time, from its history), each pool
    built (its upload time and bytes) and each select_fold (its time, and
    whether the prefix's labels are the fold subset's as a multiset).
    The wrappers are taken off on exit."""

    def __init__(self):
        self.trial_s, self.fit_s, self.pools = [], [], []
        self.train_s = []  # the train epochs' time within each fold-fit
        self.select_ms, self.prefix_ok, self.per_fit_uploads = [], [], 0

    def __enter__(self):
        from irp_tpu_torch.data import pipeline
        from irp_tpu_torch.hyperopt import objective, runner

        fit_mod = sys.modules["irp_tpu_torch.train.fit"]
        probe = self

        def timed(fn, sink):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    result = fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    sink.append(time.perf_counter() - t0)
                if hasattr(result, "history"):  # a fold-fit's train epochs
                    probe.train_s.append(sum(result.history["train_ms"])
                                         / 1e3)
                return result
            return run

        def pool(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = pipeline.HBMFoldPool(*a, **kw)
            torch.cuda.synchronize()
            probe.pools.append({"upload_s": time.perf_counter() - t0,
                                "upload_bytes": p.upload_bytes,
                                "n": p.local_count})
            return p

        select = pipeline.HBMFoldPool.select_fold

        def select_fold(pool_self, shards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            view = select(pool_self, shards)
            torch.cuda.synchronize()
            probe.select_ms.append((time.perf_counter() - t0) * 1e3)
            got = np.sort(pool_self.labels[:view.local_count].cpu().numpy())
            want = np.sort(pool_self._cached.subset_by_shards(
                shards, with_images=False).labels)
            probe.prefix_ok.append(bool(np.array_equal(got, want)))
            return view

        dataset = fit_mod.HBMDataset

        def per_fit(*a, **kw):
            probe.per_fit_uploads += 1
            return dataset(*a, **kw)

        self._undo = []
        for owner, name, new in (
                (runner, "objective_kfold",
                 timed(runner.objective_kfold, self.trial_s)),
                (objective, "fit", timed(objective.fit, self.fit_s)),
                (objective, "HBMFoldPool", pool),
                (pipeline.HBMFoldPool, "select_fold", select_fold),
                (fit_mod, "HBMDataset", per_fit)):
            self._undo.append((owner, name, getattr(owner, name)))
            setattr(owner, name, new)
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)

    def summary(self) -> dict:
        return {"trials": len(self.trial_s), "trial_s": self.trial_s,
                "fold_fits": len(self.fit_s), "fold_fit_s": self.fit_s,
                "fold_fit_train_epochs_s": self.train_s,
                "pools": self.pools, "select_fold_ms": self.select_ms,
                "prefix_labels_equal_subset": self.prefix_ok,
                "per_fit_uploads": self.per_fit_uploads}


def _sweep_launches(folds, n_fits_per_fold, batch, eval_samples,
                    train_samples, epochs, n_samples_of,
                    bn_per_forward: int) -> dict:
    """The launches a sweep's fold-fits make: K2 once per eval batch, K1
    10 per train and eval forward when it is on, and the train-mode
    BatchNorm op ``bn_per_forward`` per train forward."""
    k2 = k1_forwards = train_forwards = 0
    for val in folds:
        n_val = sum(n_samples_of[s] for s in val)
        n_train = sum(n_samples_of.values()) - n_val
        eval_batches = math.ceil(min(n_val, eval_samples) / batch)
        steps = min(n_train // batch, max(train_samples // batch, 1))
        k2 += n_fits_per_fold * epochs * eval_batches
        k1_forwards += n_fits_per_fold * epochs * (steps + eval_batches)
        train_forwards += n_fits_per_fold * epochs * steps
    return {"eval_preprocess": k2, "identity_bottleneck": 10 * k1_forwards,
            "batch_norm_train": bn_per_forward * train_forwards}


def phase_hyperopt(out: dict, seed: int) -> None:
    """The k-fold sweep on the card: (a) hyperopt_cli --quick, 3 trials x
    3 folds over 12 JPEG shards of 3,072 images, ResNet50/224 bf16 at the
    CLI's defaults (K1 'off'); (b) the same study resumed through
    run_kfold_optimization with fused_frozen_blocks='auto' for one more
    trial; (c) the fold pool at N = 26,179 (images made on the card, 27
    shards of ids, no decode): upload and select_fold for each of 3
    folds."""
    import contextlib
    import dataclasses

    from irp_tpu_torch import tracking
    from irp_tpu_torch.cli import hyperopt_cli
    from irp_tpu_torch.config import HyperoptConfig, ModelConfig
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.kfold import create_stratified_kfolds
    from irp_tpu_torch.data.pipeline import CachedDataset, build_cache
    from irp_tpu_torch.hyperopt.objective import HyperoptContext, quick_space
    from irp_tpu_torch.hyperopt.runner import run_kfold_optimization
    from irp_tpu_torch.hyperopt.study import create_study
    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.ops.cuda_image import eval_preprocess
    from irp_tpu_torch.ops.cuda_resnet import fused_identity_bottleneck

    checks, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        shards = _write_shards(seed, f"{tmp}/shards")
        report["write_shards_s"] = time.perf_counter() - t0
        db, cache = f"{tmp}/study.db", f"{tmp}/cache"
        uri = f"{tmp}/mlruns"
        tracking.set_tracking_uri(uri)
        n_of = {s: HPO_PER_SHARD for s in shards}
        folds = create_stratified_kfolds(shards, k=HPO_K, seed=seed)
        # quick space: batch 16, 2 epochs; the context's caps 1024 / 512
        expect = functools.partial(_sweep_launches, folds, batch=16,
                                   eval_samples=512, train_samples=1024,
                                   epochs=2, n_samples_of=n_of,
                                   bn_per_forward=RESNET50_BN_PER_FORWARD)

        # (a) the CLI, K1 off
        eval_preprocess.launches = 0
        fused_identity_bottleneck.launches = 0
        batch_norm_train.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _SweepProbe() as probe:
            rc = hyperopt_cli.main([
                "--data-dir", f"{tmp}/shards", "--quick",
                "--n-trials", str(HPO_TRIALS), "--k-folds", str(HPO_K),
                "--first-fold-min-acc", "0", "--storage", db,
                "--study-name", "smoke", "--cache-dir", cache,
                "--seed", str(seed)])
        runs = {"cli": {"seconds": time.perf_counter() - t0, "rc": rc,
                        "launches": {
                            "eval_preprocess": eval_preprocess.launches,
                            "identity_bottleneck":
                                fused_identity_bottleneck.launches,
                            "batch_norm_train": batch_norm_train.launches},
                        "expected_launches": dict(
                            expect(n_fits_per_fold=HPO_TRIALS),
                            identity_bottleneck=0),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        **probe.summary()}}

        # (b) resumed with K1 on
        info = analyze_webdataset(shards)
        cached = build_cache(shards, info.class_names, cache_dir=cache)
        hcfg = HyperoptConfig(k_folds=HPO_K, first_fold_min_acc=0.0,
                              storage=db, study_name="smoke", seed=seed)
        ctx = HyperoptContext(
            cached=cached, info=info, hcfg=hcfg,
            model_base=ModelConfig(num_classes=info.num_classes,
                                   fused_frozen_blocks="auto"),
            space_fn=quick_space)
        printed = io.StringIO()
        eval_preprocess.launches = 0
        fused_identity_bottleneck.launches = 0
        batch_norm_train.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _SweepProbe() as probe, contextlib.redirect_stdout(printed):
            run_kfold_optimization(ctx, n_trials=1)
        runs["resumed_k1"] = {
            "seconds": time.perf_counter() - t0,
            "launches": {"eval_preprocess": eval_preprocess.launches,
                         "identity_bottleneck":
                             fused_identity_bottleneck.launches,
                         "batch_norm_train": batch_norm_train.launches},
            "expected_launches": expect(n_fits_per_fold=1),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            **probe.summary()}
        trials = create_study("smoke", db).get_trials()
        client = tracking.TrackingClient(uri)
        complete = [t for t in trials if t.state == "COMPLETE"]
        report["trials"] = [{"number": t.number, "state": t.state,
                             "value": t.value, "params": t.params}
                            for t in trials]
        checks["cli_rc_0"] = runs["cli"]["rc"] == 0
        checks["four_trials"] = len(trials) == HPO_TRIALS + 1
        # an error after a trial's last fit (the t-bound, the user attrs,
        # the tracking writes) leaves it FAILED with its launches counted
        checks["all_trials_complete"] = ([t.state for t in trials]
                                         == ["COMPLETE"] * (HPO_TRIALS + 1))
        checks["resume_loaded_3"] = ("Loaded existing study with 3 previous "
                                     "trials" in printed.getvalue())
        checks["complete_values_finite"] = bool(complete) and all(
            math.isfinite(t.value) for t in complete)
        checks["recommended_epochs_logged"] = all(
            "tracking_run_id" in t.user_attrs and "recommended_epochs"
            in client.get_run(t.user_attrs["tracking_run_id"])["params"]
            for t in complete)
        image_bytes = len(cached) * 256 * 256 * 3
        for name, r in runs.items():
            checks[f"{name}_launches"] = (r["launches"]
                                          == r["expected_launches"])
            checks[f"{name}_pool_uploaded_once"] = (
                len(r["pools"]) == 1 and r["per_fit_uploads"] == 0
                and r["pools"][0]["upload_bytes"]
                == image_bytes + len(cached) * 4)
            checks[f"{name}_prefix_labels"] = (
                len(r["prefix_labels_equal_subset"]) == r["fold_fits"]
                and all(r["prefix_labels_equal_subset"]))
        out["launches"]["hyperopt"] = {
            key: sum(r["launches"][key] for r in runs.values())
            for key in ("eval_preprocess", "identity_bottleneck",
                        "batch_norm_train")}
        del ctx, cached

    # (c) the pool at the reference dataset's size
    images, labels, _ = _curation_images(seed + 11, POOL_N)
    paths = tuple(f"pool-{i:06d}.tar" for i in range(POOL_SHARDS))
    shard_ids = (np.arange(POOL_N) * POOL_SHARDS // POOL_N).astype(np.int32)
    names = tuple(f"class{c}" for c in range(N_CLASSES))
    big = CachedDataset(images=images, labels=labels,
                        keys=[f"img{i}" for i in range(POOL_N)],
                        class_names=names, shard_ids=shard_ids,
                        shard_paths=paths)
    hist = {p: collections.Counter(names[c] for c in labels[shard_ids == i])
            for i, p in enumerate(paths)}
    big_folds = create_stratified_kfolds(list(paths), k=HPO_K, seed=seed,
                                         histograms=hist)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pool_report = {}
    with _SweepProbe() as probe:
        from irp_tpu_torch.hyperopt import objective

        pool = objective.HBMFoldPool(big, "cuda", seed=seed)
        reshuffle_ms = []
        for f in range(HPO_K):
            view = pool.select_fold([p for i, fold in enumerate(big_folds)
                                     if i != f for p in fold])
            # what fit() does to the view once an epoch
            t0 = time.perf_counter()
            view.local_reshuffle(seed + f)
            torch.cuda.synchronize()
            reshuffle_ms.append((time.perf_counter() - t0) * 1e3)
        pool_report = {"n": POOL_N, "shards": POOL_SHARDS,
                       "upload_s": probe.pools[0]["upload_s"],
                       "upload_bytes": pool.upload_bytes,
                       "upload_gb_per_s": pool.upload_bytes
                       / probe.pools[0]["upload_s"] / 1e9,
                       "select_fold_ms": probe.select_ms,
                       "local_reshuffle_ms": reshuffle_ms,
                       "prefix_labels_equal_subset": probe.prefix_ok,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        pool.release()
    del pool, view, big, images
    checks["pool_upload_bytes"] = (pool_report["upload_bytes"]
                                   == POOL_N * 196_608 + POOL_N * 4)
    checks["pool_prefix_labels"] = (len(probe.prefix_ok) == HPO_K
                                    and all(probe.prefix_ok))
    emit({"phase": "hyperopt",
          "model": "ResNet50/224 bf16, 10 classes, hidden 512",
          "sweep": f"{HPO_TRIALS} + 1 trials x {HPO_K} folds, quick space "
                   "(2 epochs, batch 16, low aug), caps 1024 / 512",
          "images": HPO_SHARDS * HPO_PER_SHARD, "shards": HPO_SHARDS,
          **report, "runs": runs, "pool": pool_report, "checks": checks})
    out["hyperopt"] = {"runs": runs, "pool": pool_report}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"hyperopt checks failed: {failed}")


# the final run: a one-trial study over 12 train shards and 4 test shards.
# 6 epochs, not 2: the final stage steps its OneCycle once per epoch over
# max(epochs, 4) steps, so a 2-epoch run ends at the peak lr, and layer4's
# BN running statistics trail its weights.  On the card the 2-epoch
# weights read 65.82% in eval form (K1 off; 72.75% in f32, 99.02% with K1
# on) and 99.12% once those statistics are recomputed over the train set;
# at 6 epochs 99.12% either way (python -m irp_tpu_torch.tools.final_bn_check)
FINAL_TEST_SHARDS = 4  # 1,024 test images of the train shards' classes
FINAL_BATCH, FINAL_EPOCHS = 32, 6
FINAL_PARAMS = {"learning_rate": 1e-3, "weight_decay": 1e-4,
                "dropout_rate": 0.3, "batch_size": FINAL_BATCH,
                "augmentation_intensity": "medium"}
FINAL_ARTIFACTS = ("confusion_matrix.png", "correct_classifications.png",
                   "final_model.npz", "final_model.pth",
                   "incorrect_classifications.png")
FINAL_MIN_ACC = 90.0  # percent, on the test set
PREDICT_AGREEMENT = 0.995  # share of predict_cli labels equal to the eval's
PREDICT_ACC_GAP = 0.5  # points between predict_cli's accuracy and the eval's


class _FinalProbe:
    """Captures and times what one final run does, by wrapping the names
    train/final.py calls: the fit (host clock, synchronized, and its
    result), the test evaluation (its time and EvalResult), the confusion
    matrix and the FinalResult.  The wrappers are taken off on exit."""

    def __init__(self):
        self.fits, self.evals, self.cms, self.results = [], [], [], []

    def __enter__(self):
        from irp_tpu_torch.train import final as final_mod

        def timed(fn, sink):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(*a, **kw)
                torch.cuda.synchronize()
                sink.append((time.perf_counter() - t0, result))
                return result
            return run

        def keep(fn, sink):
            def run(*a, **kw):
                result = fn(*a, **kw)
                sink.append(result)
                return result
            return run

        self._undo = []
        for name, new in (
                ("fit", timed(final_mod.fit, self.fits)),
                ("evaluate_full", timed(final_mod.evaluate_full,
                                        self.evals)),
                ("confusion_matrix", keep(final_mod.confusion_matrix,
                                          self.cms)),
                ("train_final_model", keep(final_mod.train_final_model,
                                           self.results))):
            self._undo.append((final_mod, name, getattr(final_mod, name)))
            setattr(final_mod, name, new)
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)

    def summary(self, n_test: int) -> dict:
        fit_s, fit = self.fits[0]
        eval_s, _ = self.evals[0]
        per_epoch = fit.steps_per_epoch * FINAL_BATCH
        return {"fit_s": fit_s, "epochs": len(fit.history["train_ms"]),
                "train_ms": fit.history["train_ms"],
                "train_images_per_s": [per_epoch / (ms / 1e3)
                                       for ms in fit.history["train_ms"]],
                "train_loss": fit.history["train_loss"],
                "test_eval_s": eval_s,
                "test_images_per_s": n_test / eval_s,
                "test_acc": self.results[0].test_acc,
                "test_loss": self.results[0].test_loss}


def _png_opens(path: str) -> bool:
    from PIL import Image

    with Image.open(path) as im:
        im.load()
        return im.format == "PNG"


def _final_world(tmp: str, seed: int, epochs: int,
                 train_shards: int = HPO_SHARDS) -> dict:
    """The final phase's inputs under ``tmp``: ``train_shards`` train
    shards and FINAL_TEST_SHARDS test shards of the same classes (another
    seed), a
    tracking store whose sweep run holds ``recommended_epochs = epochs``,
    and a study database with one COMPLETE trial of FINAL_PARAMS joined
    to that run."""
    from irp_tpu_torch import tracking
    from irp_tpu_torch.hyperopt.study import create_study

    data = f"{tmp}/shards"
    t0 = time.perf_counter()
    train_shards = _write_shards(seed, data, n_shards=train_shards)
    # the test set: the train shards' class patterns, other images
    test_shards = _write_shards(seed + 1, data, "test", FINAL_TEST_SHARDS,
                                patterns_seed=seed + 7)
    write_s = time.perf_counter() - t0
    uri = f"{tmp}/mlruns"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("animals10")
    with tracking.start_run(run_name="optuna_trial_0_kfold") as run:
        run.log_params({"recommended_epochs": epochs})
        sweep_run = run.info.run_id
    db = f"{tmp}/study.db"
    study = create_study("smoke_final", db)
    trial = study.ask()
    for k, v in FINAL_PARAMS.items():
        if isinstance(v, float):
            trial.suggest_float(k, v, v)
        else:
            trial.suggest_categorical(k, [v])
    trial.set_user_attr("tracking_run_id", sweep_run)
    study.tell(trial, "COMPLETE", 99.0)
    return {"data": data, "db": db, "uri": uri, "train": train_shards,
            "test": test_shards, "write_s": write_s}


def phase_final(out: dict, seed: int) -> None:
    """Final training, full test evaluation and batch prediction on the
    card, ResNet50/224 bf16, 10 classes, random init from the seed: (a)
    final_cli at its defaults (K1 'off', 'hbm') with --checkpoint-dir
    over a one-trial study (batch 32, lr 1e-3, wd 1e-4, dropout 0.3,
    medium aug; recommended_epochs 6 in its tracking run), 12 train shards
    (3,072 images) and 4 test shards (1,024 images of the same classes,
    another seed); (b) train_final_model with K1 'auto' resumed from (a)'s
    directory after its newest checkpoint is removed; (c) predict_cli
    --shards over the test shards with (a)'s final_model.npz at batch
    256, and the .pth and .npz predictors on one batch."""
    import contextlib
    import csv
    import os

    from irp_tpu_torch import tracking
    from irp_tpu_torch.cli import final_cli, predict_cli
    from irp_tpu_torch.config import ModelConfig
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.hyperopt.study import create_study
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.ops.cuda_image import eval_preprocess
    from irp_tpu_torch.ops.cuda_resnet import fused_identity_bottleneck
    from irp_tpu_torch.train import final as final_mod

    def zero():
        eval_preprocess.launches = 0
        fused_identity_bottleneck.launches = 0
        batch_norm_train.launches = 0
        torch.cuda.reset_peak_memory_stats()

    def counts():
        return {"eval_preprocess": eval_preprocess.launches,
                "identity_bottleneck": fused_identity_bottleneck.launches,
                "batch_norm_train": batch_norm_train.launches}

    checks, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/ckpt"
        world = _final_world(tmp, seed, FINAL_EPOCHS)
        data, db, uri = world["data"], world["db"], world["uri"]
        train_shards, test_shards = world["train"], world["test"]
        n_test = FINAL_TEST_SHARDS * HPO_PER_SHARD

        # (a) the CLI at its defaults
        zero()
        t0 = time.perf_counter()
        with _FinalProbe() as probe:
            rc = final_cli.main(["--data-dir", data, "--storage", db,
                                 "--study-name", "smoke_final",
                                 "--cache-dir", f"{tmp}/cache",
                                 "--checkpoint-dir", ckpt])
        res_a = probe.results[0]
        eval_a = probe.evals[0][1]
        fit_a = probe.fits[0][1]
        client = tracking.TrackingClient(uri)
        run_a = client.get_run(res_a.run_id)
        artifacts = client.list_artifacts(res_a.run_id)
        runs["cli"] = {"seconds": time.perf_counter() - t0, "rc": rc,
                       "launches": counts(),
                       "expected_launches": {
                           "eval_preprocess": math.ceil(n_test
                                                        / FINAL_BATCH),
                           "identity_bottleneck": 0,
                           "batch_norm_train": RESNET50_BN_PER_FORWARD
                           * len(fit_a.history["train_ms"])
                           * fit_a.steps_per_epoch},
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       **probe.summary(n_test),
                       "final_epochs": run_a["params"].get("final_epochs"),
                       "report_accuracy": res_a.report["accuracy"],
                       "confusion_matrix_sum": int(probe.cms[0].sum()),
                       "artifacts": artifacts}
        checks["cli_rc_0"] = rc == 0
        checks["cli_final_epochs"] = (
            runs["cli"]["final_epochs"] == str(FINAL_EPOCHS)
            and runs["cli"]["epochs"] == FINAL_EPOCHS)
        checks["cli_test_acc"] = res_a.test_acc >= FINAL_MIN_ACC
        checks["cli_report_accuracy"] = math.isclose(
            res_a.report["accuracy"] * 100.0, res_a.test_acc,
            rel_tol=1e-12)
        checks["cli_confusion_matrix_sum"] = (
            runs["cli"]["confusion_matrix_sum"] == n_test)
        checks["cli_artifacts"] = sorted(artifacts) == list(FINAL_ARTIFACTS)
        checks["cli_pngs_open"] = all(
            _png_opens(client.artifact_path(res_a.run_id, a))
            for a in artifacts if a.endswith(".png"))

        # (b) resumed for the last epoch with K1 on
        newest = max(f for f in os.listdir(ckpt) if f.startswith("step_"))
        os.remove(os.path.join(ckpt, newest))
        info = analyze_webdataset(train_shards)
        train_cached = build_cache(train_shards, info.class_names,
                                   cache_dir=f"{tmp}/cache")
        test_cached = build_cache(test_shards, info.class_names,
                                  cache_dir=f"{tmp}/cache")
        steps = len(train_cached) // FINAL_BATCH
        zero()
        t0 = time.perf_counter()
        with _FinalProbe() as probe:
            res_b = final_mod.train_final_model(
                create_study("smoke_final", db), train_cached, test_cached,
                info, model_base=ModelConfig(num_classes=info.num_classes,
                                             fused_frozen_blocks="auto"),
                checkpoint_dir=ckpt, resume=True, verbose=False)
        runs["resumed_k1"] = {
            "seconds": time.perf_counter() - t0, "removed": newest,
            "launches": counts(),
            "expected_launches": {
                "eval_preprocess": math.ceil(n_test / FINAL_BATCH),
                "identity_bottleneck": 10 * (steps + math.ceil(
                    n_test / FINAL_BATCH)),
                "batch_norm_train": RESNET50_BN_PER_FORWARD * steps},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            **probe.summary(n_test)}
        checks["resumed_one_epoch"] = runs["resumed_k1"]["epochs"] == 1
        checks["resumed_test_acc"] = res_b.test_acc >= FINAL_MIN_ACC
        for name, r in runs.items():
            checks[f"{name}_launches"] = (r["launches"]
                                          == r["expected_launches"])

        # (c) batch prediction with (a)'s artifacts
        npz = client.artifact_path(res_a.run_id, "final_model.npz")
        pth = client.artifact_path(res_a.run_id, "final_model.pth")
        preds_csv = f"{tmp}/preds.csv"
        printed = io.StringIO()
        zero()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc_c = predict_cli.main([
                "--weights", npz, "--shards", f"{data}/test-*.tar",
                "--batch-size", "256", "--classes",
                ",".join(info.class_names), "--out", preds_csv,
                "--fused-frozen-blocks", "auto"])
        seconds_c = time.perf_counter() - t0
        launches_c = counts()
        summary = json.loads(printed.getvalue().strip().splitlines()[-1])
        with open(preds_csv) as f:
            labels_c = {row["key"]: int(row["label"])
                        for row in csv.DictReader(f)}
        eval_labels = dict(zip(test_cached.keys, eval_a.preds.tolist()))
        agree = (sum(labels_c.get(k) == v for k, v in eval_labels.items())
                 / len(eval_labels))
        batch = np.asarray(test_cached.images[:256])
        p_npz = load_predictor(npz).predict_probs(batch)
        p_pth = load_predictor(pth).predict_probs(batch)
        runs["predict"] = {
            "seconds": seconds_c, "rc": rc_c, "summary": summary,
            "imgs_per_sec": summary.get("imgs_per_sec"),
            "label_agreement_with_eval": agree,
            "launches": launches_c,
            "expected_launches": {"eval_preprocess": math.ceil(n_test / 256),
                                  "identity_bottleneck": 10 * math.ceil(
                                      n_test / 256),
                                  "batch_norm_train": 0},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pth_npz_probs_equal": bool(np.array_equal(p_npz, p_pth))}
        checks["predict_rc_0"] = rc_c == 0
        checks["predict_agreement"] = agree >= PREDICT_AGREEMENT
        checks["predict_accuracy"] = (
            "accuracy" in summary
            and abs(100.0 * summary["accuracy"] - res_a.test_acc)
            <= PREDICT_ACC_GAP)
        checks["predict_launches"] = (launches_c
                                      == runs["predict"]["expected_launches"])
        checks["pth_npz_probs_equal"] = runs["predict"]["pth_npz_probs_equal"]
        out["launches"]["final"] = {
            key: sum(r["launches"][key] for r in runs.values())
            for key in ("eval_preprocess", "identity_bottleneck",
                        "batch_norm_train")}
        del train_cached, test_cached
    emit({"phase": "final",
          "model": "ResNet50/224 bf16, 10 classes, hidden 512, random init",
          "study": "one COMPLETE trial: " + json.dumps(FINAL_PARAMS)
                   + f", recommended_epochs {FINAL_EPOCHS}",
          "train_images": HPO_SHARDS * HPO_PER_SHARD, "test_images": n_test,
          "write_shards_s": world["write_s"],
          "runs": runs, "checks": checks})
    out["final"] = runs
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"final checks failed: {failed}")


# -- native decode, fidelity, monitor ----------------------------------------

DECODE_N = 256  # mixed JPEGs held against PIL
DECODE_SHARDS, DECODE_PER_SHARD = 4, 256  # build_cache and predict_cli
DECODE_TURNS = 3  # predict_cli runs per decoder, in turns
DECODE_AGREEMENT = 0.995  # labels equal between the two decoders' runs
# fidelity_cli on the card, every family at 224 px in f32 (seed-0 weights)
FIDELITY_MODELS = (("resnet50", ["--family", "resnet", "--depth", "50"]),
                   ("vit_b_16", ["--family", "vit", "--vit-variant",
                                 "b_16"]),
                   ("convnext_tiny", ["--family", "convnext",
                                      "--convnext-variant", "tiny"]),
                   ("efficientnet_b0", ["--family", "efficientnet",
                                        "--efficientnet-variant", "b0"]))
FIDELITY_SAMPLES = 64
K2_KERNEL_NAME = "eval_preprocess_kernel"  # csrc/eval_preprocess.cu


def _mixed_jpegs(seed: int, n: int, sizes=(64, 641)) -> list:
    """n JPEGs of sides drawn from ``sizes``: smooth noise, one in eight
    grayscale, one in eight progressive, the rest baseline RGB at
    quality 70-95."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(sizes[0], sizes[1], 2))
        small = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        img = np.repeat(np.repeat(small, 16, axis=0), 16, axis=1)[:h, :w]
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
        pil = Image.fromarray(img.astype(np.uint8))
        kw = {"quality": int(rng.integers(70, 96))}
        if i % 8 == 1:
            pil = pil.convert("L")
        elif i % 8 == 2:
            kw["progressive"] = True
        buf = io.BytesIO()
        pil.save(buf, format="JPEG", **kw)
        out.append(buf.getvalue())
    return out


def _jpeg_shards(seed: int, root: str, n_shards: int, per_shard: int,
                 sizes) -> list:
    """WebDataset shards of :func:`_mixed_jpegs` under N_CLASSES class
    names, through the port's ShardWriter."""
    from irp_tpu_torch.data.tar import ShardWriter

    blobs = _mixed_jpegs(seed, n_shards * per_shard, sizes)
    labels = np.random.default_rng(seed + 1).integers(0, N_CLASSES,
                                                      len(blobs))
    writer = ShardWriter(root, "test", per_shard)
    with writer:
        for i, (blob, label) in enumerate(zip(blobs, labels)):
            name = f"class{int(label)}"
            writer.write({"__key__": f"{name}_{i:06d}", "jpg": blob,
                          "cls": name, "json": {"class": name}})
    return writer.shard_paths


def phase_decode(out: dict, seed: int) -> None:
    """The native decoder against PIL, build_cache native against PIL,
    predict_cli --decoder auto against pil in turns; nothing of it where
    the decoder did not build on this host (the reason is printed)."""
    from irp_tpu_torch.data import jpeg
    from irp_tpu_torch.data.pipeline import decode_blobs

    if not jpeg.native_decoder_available():
        tail = jpeg.build_log_tail(6)
        print("decode: the native JPEG decoder is unavailable on this host, "
              "so no native decode ran: native against PIL, build_cache "
              "native against PIL and predict_cli --decoder auto against "
              "pil were NOT run.  decoder='auto' decodes with PIL here.  "
              "Build log tail:\n" + tail, flush=True)
        blobs = _mixed_jpegs(seed, 8)
        auto_is_pil = bool(np.array_equal(
            decode_blobs(blobs, 256), decode_blobs(blobs, 256,
                                                   decoder="pil")))
        # a failed build is left on disk, so that later processes do not
        # run the compiler again
        recorded = os.path.exists(jpeg.library_path()[:-3] + ".failed")
        emit({"phase": "decode", "native_decoder": False,
              "reason": tail.splitlines()[-3:],
              "not_run": ["native_vs_pil", "build_cache_native_vs_pil",
                          "predict_cli_auto_vs_pil"],
              "auto_decodes_with_pil_here": auto_is_pil,
              "failed_build_recorded": recorded})
        if not auto_is_pil:
            raise RuntimeError("decode: 'auto' differs from PIL without the "
                               "native decoder")
        if not recorded and "IRP_DECODER_LIB" not in os.environ:
            raise RuntimeError("decode: the failed build left no .failed "
                               "file")
        return
    with tempfile.TemporaryDirectory() as tmp:
        _decode_phase(out, seed, tmp)


def _decode_phase(out: dict, seed: int, tmp: str) -> None:
    from PIL import Image

    from irp_tpu_torch.cli import predict_cli
    from irp_tpu_torch.data import jpeg
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import (build_cache, decode_blobs,
                                             decode_to_rgb256)
    from irp_tpu_torch.train.checkpoint import save_weights_npz

    checks, report = {}, {}
    # (a) native against PIL on mixed sizes, grayscale and progressive
    blobs = _mixed_jpegs(seed, DECODE_N)
    t0 = time.perf_counter()
    native, ok = jpeg.decode_batch_native(blobs, 256)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pil = np.stack([decode_to_rgb256(b) for b in blobs])
    pil_s = time.perf_counter() - t0
    diff = int(np.abs(native.astype(int) - pil.astype(int)).max())
    checks["native_all_decoded"] = bool(ok.all())
    checks["native_within_1_of_pil"] = diff <= 1
    report["native_vs_pil"] = {
        "images": DECODE_N, "max_abs_diff_u8": diff,
        "share_of_pixels_differing": float((native != pil).mean()),
        "native_s": native_s, "pil_s": pil_s,
        "native_images_per_s": DECODE_N / native_s,
        "pil_images_per_s": DECODE_N / pil_s}
    # (b) corrupt blobs are flagged, and decode_blobs fills them by PIL
    png = io.BytesIO()
    Image.fromarray(pil[0]).save(png, format="PNG")
    mixed = [blobs[0], b"not an image", png.getvalue(), blobs[3]]
    _, ok_mixed = jpeg.decode_batch_native(mixed, 256)
    checks["corrupt_flagged"] = ok_mixed.tolist() == [True, False, False,
                                                      True]
    filled = decode_blobs([blobs[0], png.getvalue(), blobs[3]], 256)
    checks["png_filled_by_pil"] = bool(np.array_equal(
        filled[1], decode_to_rgb256(png.getvalue())))
    emit({"phase": "decode", "part": "native_vs_pil",
          **report["native_vs_pil"], "corrupt_flags": ok_mixed.tolist()})

    # (c) build_cache over a few shards, native against PIL
    shards = _jpeg_shards(seed + 1, f"{tmp}/data", DECODE_SHARDS,
                          DECODE_PER_SHARD, (150, 500))
    names = analyze_webdataset(shards).class_names
    n = DECODE_SHARDS * DECODE_PER_SHARD
    t0 = time.perf_counter()
    nat = build_cache(shards, names, use_native=True)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = build_cache(shards, names, use_native=False)
    ref_s = time.perf_counter() - t0
    cache_diff = int(np.abs(nat.images.astype(int)
                            - ref.images.astype(int)).max())
    checks["cache_keys_equal"] = nat.keys == ref.keys and len(nat) == n
    checks["cache_within_1"] = cache_diff <= 1
    report["build_cache"] = {
        "images": n, "native_s": nat_s, "pil_s": ref_s,
        "native_images_per_s": n / nat_s, "pil_images_per_s": n / ref_s,
        "max_abs_diff_u8": cache_diff}
    emit({"phase": "decode", "part": "build_cache", **report["build_cache"]})
    del nat, ref

    # (d) predict_cli --shards at batch 256, auto and pil in turns
    variables = _random_variables(seed)
    npz = save_weights_npz(f"{tmp}/resnet50_224.npz", variables["params"],
                           variables["batch_stats"],
                           meta={"image_size": 224})
    runs = {"auto": [], "pil": []}
    labels = {}
    for i in range(DECODE_TURNS):
        for dec in (("auto", "pil") if i % 2 == 0 else ("pil", "auto")):
            preds_csv = f"{tmp}/preds_{dec}.csv"
            printed = io.StringIO()
            _zero_launch_counts()
            with contextlib.redirect_stdout(printed):
                rc = predict_cli.main([
                    "--weights", npz, "--shards", f"{tmp}/data/test-*.tar",
                    "--batch-size", "256", "--classes", ",".join(
                        f"class{k}" for k in range(N_CLASSES)),
                    "--decoder", dec, "--out", preds_csv])
            launches = _launch_counts()
            summary = json.loads(printed.getvalue().strip().splitlines()[-1])
            with open(preds_csv) as f:
                labels[dec] = {row["key"]: int(row["label"])
                               for row in csv.DictReader(f)}
            runs[dec].append({"rc": rc, "images_per_s":
                              summary["imgs_per_sec"],
                              "launches": launches})
    agree = (sum(labels["auto"][k] == v for k, v in labels["pil"].items())
             / len(labels["pil"]))
    want = {"eval_preprocess": math.ceil(n / 256), "identity_bottleneck": 0}
    checks["predict_rc_0"] = all(r["rc"] == 0 for v in runs.values()
                                 for r in v)
    checks["predict_labels_agree"] = agree >= DECODE_AGREEMENT
    checks["predict_k2_per_batch_k1_zero"] = all(
        r["launches"] == want for v in runs.values() for r in v)
    out["launches"]["decode"] = {
        key: sum(r["launches"][key] for v in runs.values() for r in v)
        for key in want}
    report["predict_cli"] = {
        "images": n, "batch": 256, "turns": DECODE_TURNS,
        "images_per_s": {dec: [r["images_per_s"] for r in v]
                         for dec, v in runs.items()},
        "label_agreement": agree, "launches_per_run": want}
    emit({"phase": "decode", "part": "predict_cli", **report["predict_cli"],
          "checks": checks})
    out["decode"] = report
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"decode checks failed: {failed}")


def phase_fidelity(out: dict, seed: int) -> None:
    """fidelity_cli on the card for the four families: the port's f32
    classifier against the torchvision-layout executor of the same
    seed-0 weights, within 1e-3."""
    import re

    from irp_tpu_torch.cli import fidelity_cli

    checks, results = {}, {}
    totals = {"eval_preprocess": 0, "identity_bottleneck": 0}
    with tempfile.TemporaryDirectory() as tmp:
        _jpeg_shards(seed + 5, tmp, 1, FIDELITY_SAMPLES, (150, 500))
        for name, flags in FIDELITY_MODELS:
            printed = io.StringIO()
            _zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = fidelity_cli.main([
                    "--shards", f"{tmp}/test-*.tar", "--samples",
                    str(FIDELITY_SAMPLES), "--num-classes", str(N_CLASSES),
                    *flags])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = _launch_counts()
            line = printed.getvalue().strip().splitlines()[-1]
            m = re.search(r"samples: (\d+)  max \|logit diff\|: (\S+)  "
                          r"top-1 agreement: (\S+)%", line)
            results[name] = {
                "rc": rc, "samples": int(m.group(1)) if m else None,
                "max_abs_logit_diff": float(m.group(2)) if m else None,
                "top1_agreement_pct": float(m.group(3)) if m else None,
                "seconds": seconds, "launches": launches, "line": line}
            checks[f"{name}_rc_0_le_1e-3"] = rc == 0
            checks[f"{name}_{FIDELITY_SAMPLES}_samples"] = (
                m is not None and int(m.group(1)) == FIDELITY_SAMPLES)
            checks[f"{name}_k2_once_k1_zero"] = launches == _launches(1, 0)
            for key in totals:
                totals[key] += launches[key]
            emit({"phase": "fidelity", "model": name, **results[name]})
    out["launches"]["fidelity"] = totals
    emit({"phase": "fidelity", "image_size": 224, "dtype": "float32",
          "weights": "random, seed 0", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"fidelity checks failed: {failed}")


def phase_monitor(out: dict, seed: int) -> None:
    """device_memory_stats on the card, and a profile_trace around one
    predict batch that names K2's kernel."""
    from irp_tpu_torch.infer import make_predictor
    from irp_tpu_torch.utils.monitor import device_memory_stats, profile_trace

    pred = make_predictor(_random_variables(seed), batch_size=64)
    batch = np.random.default_rng(seed).integers(0, 256, (64, 256, 256, 3),
                                                 np.uint8)
    pred.predict_probs(batch)  # warm
    stats = device_memory_stats()
    entry = stats.get("cuda:0", {})
    checks = {
        "one_entry_per_card": len(stats) == torch.cuda.device_count(),
        "in_use_peak_limit": set(entry) == {"gb_in_use", "peak_gb_in_use",
                                            "gb_limit"},
        "in_use_le_peak_le_limit": bool(entry) and 0 < entry["gb_in_use"]
        <= entry["peak_gb_in_use"] <= entry["gb_limit"]}
    with tempfile.TemporaryDirectory() as tmp:
        _zero_launch_counts()
        with profile_trace(tmp):
            pred.predict_probs(batch)
        launches = _launch_counts()
        files = os.listdir(tmp)
        events = []
        if len(files) == 1:
            with open(os.path.join(tmp, files[0])) as f:
                events = json.load(f).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k2 = [k for k in kernels if K2_KERNEL_NAME in k]
    checks["trace_written"] = len(files) == 1
    checks["trace_names_k2"] = len(k2) == 1
    checks["k2_once_k1_zero"] = launches == _launches(1, 0)
    out["launches"]["monitor"] = launches
    emit({"phase": "monitor", "device_memory_stats": stats,
          "trace_events": len(events), "trace_kernels": len(kernels),
          "trace_k2": k2, "first_kernels": kernels[:2],
          "launches": launches, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"monitor checks failed: {failed}")


_PROFILE_GROUPS = (
    ("identity_bottleneck (K1)", ("identity_bottleneck",)),
    ("eval_preprocess (K2)", ("eval_preprocess",)),
    ("copies", ("memcpy", "memset")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw")),
    ("convs and matmuls (cuDNN, cuBLAS)", ("xmma", "cutlass", "gemm", "conv",
                                           "cudnn", "implicit", "wgrad")),
)


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in _PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, pooling, reductions)"


def _device_time(prof, wall_us: float, reps: int) -> dict:
    """Device time of a torch.profiler trace over ``reps`` repetitions:
    device kernels and copies per repetition, busy ms per repetition (the
    union of their spans), the idle
    share of the host wall time, ms per repetition by kernel group and the
    top kernels by name."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    groups: dict = {}
    by_name: dict = {}
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        dur = end - start
        group = _profile_group(name)
        groups[group] = groups.get(group, 0.0) + dur
        by_name[name] = by_name.get(name, 0.0) + dur
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_us / reps / 1e3,
            "kernels": len(spans) / reps,
            "device_busy_ms": busy / reps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ms_by_group": {
                g: t / reps / 1e3 for g, t in sorted(groups.items(),
                                                      key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:120], t / reps / 1e3] for n, t in top]}


def _profiled(fn, reps: int) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` after a synchronize,
    behind monitor.profile_session's discarded warm-up step (the tracer
    can drop a session's first kernels late in a long process)."""
    from irp_tpu_torch.utils.monitor import profile_session

    torch.cuda.synchronize()
    with profile_session() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _device_time(prof, wall_us, reps)


TRAIN_SPLIT = ("augment", "frozen_forward_k1", "layer4_forward",
               "head_forward_and_loss", "backward_layer4_and_head",
               "optimizer")


def _train_step_profile(seed: int, batch: int, reps: int = 3) -> dict:
    """One fit train step (train/step.py::train_step) at ResNet50/224,
    bf16, K1 'auto', medium aug, adam: CUDA events recorded by hooks at the
    boundaries of its parts (TRAIN_SPLIT): the classifier's forward
    pre-hook (augmentation done), layer4's (the frozen forward done), the
    head's first dropout's (layer4 and the pool done), the classifier's
    backward pre-hook (the loss done), the optimizer's step pre-hook (the
    backward done); then torch.profiler over unhooked train_step calls for
    the device's busy time and idle share."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.models.classifier import get_classifier
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, train_step

    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    model = get_classifier(cfg)
    model.load_state_dict(_random_state_dict(seed))
    set_mode(model, True)
    state = create_train_state(model, TrainConfig(batch_size=batch), cfg, 8)
    images, labels, _ = _curation_images(seed + 7, batch)
    images = torch.from_numpy(images).cuda()
    labels = torch.from_numpy(labels).long().cuda()
    cw = torch.ones(N_CLASSES, device="cuda")
    scfg = StepConfig(intensity="medium", out_size=224,
                      compute_dtype=torch.bfloat16,
                      dropout_rate=cfg.dropout_rate)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def step():
        train_step(state, images, labels, scfg, cw, gen)

    for _ in range(2):  # warm (cuDNN algorithm search)
        step()
    marks: list = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    hooks = [model.register_forward_pre_hook(mark),
             model.backbone.layer4[0].register_forward_pre_hook(mark),
             model.classifier[0].register_forward_pre_hook(mark),
             model.register_full_backward_pre_hook(mark),
             state.optimizer.torch_opt.register_step_pre_hook(mark)]
    split = {name: [] for name in TRAIN_SPLIT}
    for _ in range(reps):
        marks.clear()
        mark()
        with warnings.catch_warnings():
            # the classifier's input has no gradient, which the backward
            # pre-hook warns of
            warnings.filterwarnings("ignore", "Full backward hook")
            step()
        mark()
        torch.cuda.synchronize()
        if len(marks) != len(TRAIN_SPLIT) + 1:
            raise RuntimeError(f"train step split: {len(marks) - 2} of "
                               f"{len(TRAIN_SPLIT) - 1} hooks fired")
        for i, name in enumerate(TRAIN_SPLIT):
            split[name].append(marks[i].elapsed_time(marks[i + 1]))
    for h in hooks:
        h.remove()
    split_ms = {name: statistics.median(v) for name, v in split.items()}
    return {"batch": batch, "reps": reps, "split_ms": split_ms,
            "split_total_ms": sum(split_ms.values()),
            **_profiled(step, reps)}


def phase_profile(out: dict, seed: int, batch: int = 64, reps: int = 5
                  ) -> None:
    """Where the device time goes: torch.profiler over ``reps`` batches of
    ``predict_probs`` (device time by kernel group, the device's idle
    share), and one fit train step at the train phase's batch, split by
    CUDA events into its parts, with its own trace."""
    from irp_tpu_torch.infer import make_predictor

    pred = make_predictor(_random_variables(seed), batch_size=batch,
                          image_size=224, fused_frozen_blocks="auto")
    images = np.random.default_rng(seed + 2).integers(
        0, 256, (batch, 256, 256, 3), np.uint8)
    for _ in range(2):
        pred.predict_probs(images)
    serve = _profiled(lambda: pred.predict_probs(images), reps)
    emit({"phase": "profile", "path": "serve predict_probs", "batch": batch,
          "reps": reps, **serve})
    emit({"phase": "profile", "path": "train step",
          **_train_step_profile(seed, TRAIN_BATCH)})


def _f32(cfg):
    import dataclasses

    return dataclasses.replace(cfg, compute_dtype="float32",
                               precision="highest",
                               fused_frozen_blocks="off")


def _f64(cfg):
    import dataclasses

    return dataclasses.replace(_f32(cfg), compute_dtype="float64")


# The parallel phase (data parallelism, ROADMAP A14a): ResNet50/224 bf16,
# K1 'auto', 10 classes, hidden 512, weights random from the seed.
PAR_STEPS, PAR_EPOCHS = 4, 2  # each compared fit; step ms from its last
# epoch (its first carries the process's warm-up)
PAR_TRAIN, PAR_VAL = 1024, 128  # class-pattern images of those fits
PAR_B1, PAR_B2 = 32, 64  # world 1's batch; the two ranks' global batch
PAR_MIXUP = 0.4  # the gated SGD step's mixup
PAR_N = 1024  # images through the local mesh's Predictor and extraction
PAR_SWEEP_SHARDS, PAR_SWEEP_TRIALS, PAR_SWEEP_K = 2, 2, 2  # 512 JPEGs
PAR_TIMEOUT_S = 600  # each rank process of the two-rank runs
# Gaps of a compared run from its reference: the losses' relative gap
# ('loss'); the parameter updates' relative L2 gap over layer4 and the
# head, |(got - init) - (want - init)| / |want - init| ('update');
# max|got - want| / max|want| over layer4's BN running statistics
# ('bn').  Each reference runs twice, and the rerun's gap from the first
# is the card's own run-to-run floor.  A gated run passes when each gap
# is within PAR_FLOOR_X times its floor or within its bar in PAR_TOL,
# whichever is larger.
#
# World 1 (an NCCL group of one rank against no group) is bit-equal, so
# its bars are 0.  The two-rank fits are Adam's: its first steps move
# each weight by about lr whatever its gradient's size, so rounding that
# turns a near-0 gradient over flips a whole update, and their gaps are
# of the size of their rerun floor; they are printed, not gated.  The
# gate is one SGD step (its update is linear in the gradients) with
# mixup and class weights on a global batch sorted by label, so that the
# ranks hold different classes.  Every run plants faults in the ranks'
# step (PAR_FAULTS: 'bn', each rank's own BN moments; 'denom', each
# rank's own loss denominator with the gradients averaged) and fails
# unless each planted run's largest gap ratio (gap / limit) exceeds 1.
# One step, not several: a later step's forward carries the first
# update's rounding; three steps read f32 gaps 8-55x their rerun floor,
# and the denominator fault's update gap only 10x the clean run's.
# Readings of one step (NVIDIA H100 80GB HBM3, 700.00 W, seed 0; the
# runs are named in PERF.md section 6; loss / update / BN): f32
# clean 1.72e-7 / 0.00204 / 8.52e-7 on a floor of 0 / 1.41e-6 / 0, the
# BN fault 2.76e-4 / 0.315 / 0.0286, the denominator fault 3.73e-4 /
# 0.0290 / 8.52e-7; bf16 clean 4.47e-4 / 0.143 / 6.50e-4 on a floor of
# 0, the BN fault 3.15e-4 / 0.314 / 0.0295, the denominator fault
# 1.07e-4 / 0.146 / 6.50e-4, which bf16's own rounding between B=32
# and B=64 hides, so bf16 plants only the BN fault.  Each bar lies
# between the clean reading and the nearest planted one (f32 loss 58x /
# 28x, update 3.9x / 3.6x, BN 117x / 286x; bf16 BN 6.2x / 7.4x) or,
# where no fault moves that gap, at 2.1-4.5x the clean reading.
PAR_FLOOR_X = 3.0
PAR_TOL = {"world1": {"loss": 0.0, "update": 0.0, "bn": 0.0},
           "step_float32": {"loss": 1e-5, "update": 8e-3, "bn": 1e-4},
           "step_bfloat16": {"loss": 2e-3, "update": 0.3, "bn": 4e-3}}
PAR_DTYPES = ("float32", "bfloat16")
PAR_FAULTS = {"float32": ("bn", "denom"), "bfloat16": ("bn",)}
PAR_PRED_TOL = 2.0 ** -5  # sharded against unsharded, max|diff| / max|ref|


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cpu_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def _par_gaps(got: dict, want: dict, init: dict, got_loss,
              want_loss) -> dict:
    """Gaps of a run from its reference (PAR_TOL's comment says which)."""
    stats = ("running_mean", "running_var")
    params = [k for k in want if k.startswith(("backbone.layer4",
                                               "classifier."))
              and not k.endswith(stats + ("num_batches_tracked",))]
    d_got = torch.cat([(got[k] - init[k]).double().ravel() for k in params])
    d_want = torch.cat([(want[k] - init[k]).double().ravel()
                        for k in params])
    bn = max(float((got[k].double() - want[k].double()).abs().max()
                   / want[k].double().abs().max())
             for k in want if k.startswith("backbone.layer4")
             and k.endswith(stats))
    g, w = np.asarray(got_loss, float), np.asarray(want_loss, float)
    return {"loss": float(np.max(np.abs(g - w) / np.abs(w))),
            "update": float((d_got - d_want).norm() / d_want.norm()),
            "bn": bn}


def _par_init(seed: int) -> dict:
    """The seed's initial weights, as fit and the step runs draw them."""
    from irp_tpu_torch.models.classifier import init_classifier

    return _cpu_state(init_classifier(_train_model_cfg(),
                                      torch.Generator().manual_seed(seed),
                                      device="cpu"))


def _par_world1(seed: int, train, val, info) -> dict:
    """fit at B=32 without a group, the same fit over an NCCL process
    group of one rank on cuda:0, and the fit without a group again (the
    floor)."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.parallel import distributed
    from irp_tpu_torch.parallel.mesh import make_mesh
    from irp_tpu_torch.train import fit

    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    tc = TrainConfig(batch_size=PAR_B1, max_epochs=PAR_EPOCHS, patience=99,
                     seed=seed, steps_per_epoch_override=PAR_STEPS,
                     eval_samples=PAR_VAL)
    runs = {}
    for name in ("no_group", "nccl_world1", "no_group_again"):
        mesh = None
        if name == "nccl_world1":
            distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                                   device="cuda:0")
            mesh = make_mesh()
        before = _launch_counts()
        t0 = time.perf_counter()
        try:
            res = fit(train, val, info, cfg, tc, mesh=mesh)
            torch.cuda.synchronize()
            backend = (torch.distributed.get_backend() if mesh is not None
                       else None)
        finally:
            if mesh is not None:
                distributed.shutdown()
        after = _launch_counts()
        runs[name] = {
            "seconds": time.perf_counter() - t0, "backend": backend,
            "history": res.history, "state": _cpu_state(res.state.model),
            "launches": {k: after[k] - before[k] for k in after}}
    init = _par_init(seed)

    def gaps(name):
        a, b = runs[name], runs["no_group"]
        return _par_gaps(a["state"], b["state"], init,
                         a["history"]["train_loss"] + a["history"]["val_loss"],
                         b["history"]["train_loss"] + b["history"]["val_loss"])

    return {"gaps": gaps("nccl_world1"), "floor": gaps("no_group_again"),
            "backend": runs["nccl_world1"]["backend"],
            "launches": {k: v["launches"] for k, v in runs.items()},
            "seconds": {k: v["seconds"] for k, v in runs.items()},
            "train_loss": {k: v["history"]["train_loss"]
                           for k, v in runs.items()},
            "step_ms": {k: v["history"]["train_ms"][-1] / PAR_STEPS
                        for k, v in runs.items()}}


def _par_pairing_order(b: int) -> torch.Tensor:
    """The row order under which one process's reversed batch pairs rows
    as two ranks' reversed halves do: positions r and b-1-r hold a row
    and its partner within its half."""
    h, q = b // 2, b // 4
    return torch.cat([torch.arange(0, q), torch.arange(h, h + q),
                      torch.arange(h + q, b), torch.arange(q, h)])


@contextlib.contextmanager
def _par_fault(fault: str, model, mesh):
    """A planted fault of data parallelism, for the gate to catch: 'bn',
    each rank's own BN moments; 'denom', each rank's own loss
    denominator with the gradients averaged (a plain DDP mean); 'none',
    the program as it is."""
    from irp_tpu_torch.models.resnet import sync_batch_stats
    from irp_tpu_torch.train import step

    if fault == "bn":
        sync_batch_stats(model, None)
        yield
        return
    if fault != "denom":
        yield
        return
    own = step._denominator

    def per_rank(labels, class_weights, m):
        return own(labels, class_weights, None) * m.size

    step._denominator = per_rank
    try:
        yield
    finally:
        step._denominator = own


def _par_step(seed: int, mesh, train, info, dtype: str,
              fault: str = "none") -> dict:
    """One SGD train_step with mixup and class weights on a given global
    batch (sorted by label, so the ranks hold different classes) and
    given global draws; on a rank of ``mesh`` its rows, or with ``mesh``
    None the whole batch in the order _par_pairing_order gives, draws
    with it."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.models.classifier import init_classifier
    from irp_tpu_torch.models.resnet import sync_batch_stats
    from irp_tpu_torch.ops.mix import sample_mix_draws
    from irp_tpu_torch.ops.preprocess import sample_augment_draws
    from irp_tpu_torch.parallel.mesh import shard_variables
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, train_step

    dev = torch.device("cuda:0")
    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    mcfg = cfg if dtype == "bfloat16" else _f32(cfg)
    model = init_classifier(mcfg, torch.Generator().manual_seed(seed),
                            device=dev)
    if mesh is not None:
        [model] = shard_variables(mesh, model)
        sync_batch_stats(model, mesh.group)
    set_mode(model, True)
    state = create_train_state(
        model, TrainConfig(seed=seed, optimizer="sgd", learning_rate=0.1,
                           schedule="constant"), mcfg)
    scfg = StepConfig(intensity="medium", out_size=TRAIN_IMAGE_SIZE,
                      compute_dtype=getattr(torch, dtype),
                      mixup_alpha=PAR_MIXUP, dropout_rate=mcfg.dropout_rate)
    rows = np.argsort(train.labels[:PAR_B2], kind="stable")
    images = torch.from_numpy(train.images[rows]).to(dev)
    labels = torch.from_numpy(train.labels[rows]).long().to(dev)
    draws = sample_augment_draws(torch.Generator().manual_seed(seed),
                                 PAR_B2, 256, 256, "medium").to(dev)
    mix = sample_mix_draws(np.random.default_rng(seed), PAR_MIXUP, 0.0,
                           TRAIN_IMAGE_SIZE, TRAIN_IMAGE_SIZE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    drop = tuple(torch.rand((PAR_B2, w), generator=gen, device=dev)
                 < 1.0 - mcfg.dropout_rate
                 for w in (model.backbone.num_features, mcfg.hidden_dim))
    if mesh is not None:
        [mine] = mesh.rows(PAR_B2)
        images, labels = images[mine], labels[mine]
    else:
        order = _par_pairing_order(PAR_B2).to(dev)
        images, labels = images[order], labels[order]
        draws = draws.rows(order)
        drop = tuple(m[order] for m in drop)
    cw = torch.tensor(info.class_weights, dtype=torch.float32, device=dev)
    with _par_fault(fault, model, mesh):
        m = train_step(state, images, labels, scfg, cw, aug_draws=draws,
                       mix_draws=mix, dropout_masks=drop, mesh=mesh)
    return {"losses": [float(m["loss"])], "state": _cpu_state(model)}


def _par_runs(seed: int, mesh) -> dict:
    """The two-rank runs, on a rank of ``mesh`` (a process mesh of two
    ranks on cuda:0) or, with ``mesh`` None, in one process on the whole
    global batch: fit in stream mode at global B=64, PAR_STEPS steps a
    epoch, eval on PAR_VAL, then _par_step, each in bfloat16 (K1
    'auto') and float32 ('highest', unfused); on a rank, _par_step
    again with each of PAR_FAULTS planted.  The launches are
    the fits' and the unplanted steps'."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.train import fit

    dev = torch.device("cuda:0")
    train, val, info = _train_sets(seed, PAR_TRAIN, PAR_VAL)
    out = {}
    _zero_launch_counts()
    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    tc = TrainConfig(batch_size=PAR_B2, max_epochs=PAR_EPOCHS, patience=99,
                     seed=seed, steps_per_epoch_override=PAR_STEPS,
                     eval_samples=PAR_VAL)
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        res = fit(train, val, info, cfg if dtype == "bfloat16" else _f32(cfg),
                  tc, mode="stream", mesh=mesh, device=dev)
        torch.cuda.synchronize()
        out[f"fit_{dtype}"] = {
            "seconds": time.perf_counter() - t0, "history": res.history,
            "step_ms": res.history["train_ms"][-1] / PAR_STEPS,
            "state": _cpu_state(res.state.model)}
    for dtype in PAR_DTYPES:
        out[f"step_{dtype}"] = _par_step(seed, mesh, train, info, dtype)
    torch.cuda.synchronize()
    out["launches"] = _launch_counts()
    if mesh is not None:
        for dtype in PAR_DTYPES:
            for fault in PAR_FAULTS[dtype]:
                out[f"step_{dtype}_{fault}"] = _par_step(
                    seed, mesh, train, info, dtype, fault)
    return out


# The model axis (tensor parallelism, ROADMAP A14b) on the same two ranks,
# as a data=1 x model=2 mesh: ViT-B/16 and ConvNeXt-Tiny at 224 (10
# classes, hidden 512, _family_model's weights), every block and the head
# Megatron-split over the two ranks; ResNet50/224 with its head split.
TP_B = 32  # the ViT and ConvNeXt forwards' and the ViT step's batch
TP_DTYPES = ("float32", "bfloat16")
TP_FAULTS = ("g_backward", "world_grads")
# Gaps of a two-rank run from the one-process run on the same inputs:
# the forwards' max|got - want| / max|want| over the logits ('logits');
# the ViT step's loss ('loss', relative) and trainable update ('update':
# |(got - init) - (want - init)| / |want - init| over the last block, the
# final LayerNorm and the head).  A gated reading passes within
# TP_FLOOR_X times its floor (the one-process run again) or its bar,
# whichever is larger; each planted fault's update gap must exceed it.
# Readings (NVIDIA H100 80GB HBM3, 700.00 W, seed 0; PERF.md section 6):
# every floor 0 (one process reruns bit for bit); forwards f32 / bf16
# ViT-B/16 2.09e-6 / 0.0197, ConvNeXt-Tiny 7.11e-7 / 0.00739 (each row
# layer's two partials rounded to bf16 before their f32 sum); the step
# loss 0, update 1.80e-6; planted g_backward 1.51, world_grads 1.00 in
# update (loss 0: both act in the backward only).  The f32 forward bars
# are the JAX tests' 1e-5 (4.8x and 14x the readings); bf16's and the
# step's sit at about 2x and 5.6x theirs, 1e5x below the faults.
TP_FLOOR_X = 3.0
TP_TOL = {"vit_float32": {"logits": 1e-5}, "vit_bfloat16": {"logits": 4e-2},
          "convnext_float32": {"logits": 1e-5},
          "convnext_bfloat16": {"logits": 1.5e-2},
          "step": {"loss": 1e-6, "update": 1e-5}}


@functools.lru_cache(maxsize=2)
def _tp_reference(family: str, seed: int):
    """_family_model's ViT-B/16 or ConvNeXt-Tiny on the CPU (made once a
    process)."""
    return _family_model(family, "b_16" if family == "vit" else "tiny",
                         seed)


def _tp_model(family: str, seed: int, dtype: str, device, mesh):
    """ViT-B/16 or ConvNeXt-Tiny from _family_model's weights in
    ``dtype`` (f32: 'highest'), on ``device``, split over ``mesh``'s
    model axis when a mesh is given."""
    import dataclasses

    from irp_tpu_torch.models.classifier import Classifier
    from irp_tpu_torch.parallel.mesh import shard_variables

    ref = _tp_reference(family, seed)
    cfg = ref.config if dtype == "bfloat16" else dataclasses.replace(
        ref.config, compute_dtype="float32", precision="highest")
    model = Classifier(cfg)
    model.load_state_dict(ref.state_dict())
    model = model.to(device=device, memory_format=torch.channels_last)
    if mesh is not None:
        [model] = shard_variables(mesh, model)
    return model.eval()


def _tp_forward(seed: int, mesh, family: str, dtype: str) -> dict:
    """The eval forward of TP_B normalized images; logits and the
    forward's ms (host clock around a synchronized call, after a warm
    one)."""
    dev = torch.device("cuda:0")
    model = _tp_model(family, seed, dtype, dev, mesh)
    size = model.config.image_size
    x = torch.randn((TP_B, 3, size, size), generator=torch.Generator()
                    .manual_seed(seed + 11)).to(dev)
    x = x.to(memory_format=torch.channels_last)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(x)
        torch.cuda.synchronize()
    return {"logits": logits.float().cpu(),
            "ms": (time.perf_counter() - t0) * 1e3}


@contextlib.contextmanager
def _tp_fault(fault: str, mesh):
    """A planted fault of tensor parallelism, for the gate to catch:
    'g_backward', the row layers' reduce with an all-reduce backward
    (the gradients upstream of each row layer times the model axis);
    'world_grads', the gradients summed over the world instead of the
    data group; 'none', the program as it is."""
    from irp_tpu_torch.parallel import distributed, tensor
    from irp_tpu_torch.train import step

    saved = {"reduce": tensor.reduce_from_model,
             "grads": step.all_reduce_grads}
    if fault == "g_backward":
        tensor.reduce_from_model = distributed.all_reduce_sum_autograd
    elif fault == "world_grads":
        step.all_reduce_grads = lambda params, group: saved["grads"](
            params, mesh.world_group)
    try:
        yield
    finally:
        tensor.reduce_from_model = saved["reduce"]
        step.all_reduce_grads = saved["grads"]


def _tp_step(seed: int, mesh, train, info, fault: str = "none") -> dict:
    """One f32 ('highest') SGD train_step of ViT-B/16 with mixup and
    class weights on a given global batch of TP_B and given draws; the
    loss, the whole trainable weights after it (gathered over the model
    axis), the step's ms (host clock, synchronized)."""
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.ops.mix import sample_mix_draws
    from irp_tpu_torch.ops.preprocess import sample_augment_draws
    from irp_tpu_torch.parallel.mesh import gather_variables
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, train_step

    dev = torch.device("cuda:0")
    model = _tp_model("vit", seed, "float32", dev, mesh)
    set_mode(model, True)
    state = create_train_state(
        model, TrainConfig(seed=seed, optimizer="sgd", learning_rate=0.1,
                           schedule="constant"), model.config)
    size, src = model.config.image_size, train.images.shape[1]
    scfg = StepConfig(intensity="medium", out_size=size,
                      compute_dtype=torch.float32, mixup_alpha=PAR_MIXUP)
    images = torch.from_numpy(train.images[:TP_B]).to(dev)
    labels = torch.from_numpy(train.labels[:TP_B]).long().to(dev)
    draws = sample_augment_draws(torch.Generator().manual_seed(seed), TP_B,
                                 src, src, "medium").to(dev)
    mix = sample_mix_draws(np.random.default_rng(seed), PAR_MIXUP, 0.0, size,
                           size)
    cw = torch.tensor(info.class_weights, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _tp_fault(fault, mesh):
        m = train_step(state, images, labels, scfg, cw, aug_draws=draws,
                       mix_draws=mix, mesh=mesh)
        loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    whole = (gather_variables(mesh, model) if mesh is not None
             else model.state_dict())
    keep = [n for n, p in model.named_parameters() if p.requires_grad]
    return {"losses": [loss], "ms": ms,
            "state": {k: whole[k].detach().cpu().clone() for k in keep}}


def _tp_gaps(got: dict, want: dict, init: dict) -> dict:
    """The ViT step's 'loss' and 'update' gaps (TP_TOL's comment)."""
    keys = sorted(want["state"])
    d_got = torch.cat([(got["state"][k] - init[k]).double().ravel()
                       for k in keys])
    d_want = torch.cat([(want["state"][k] - init[k]).double().ravel()
                        for k in keys])
    g, w = got["losses"][0], want["losses"][0]
    return {"loss": abs(g - w) / abs(w),
            "update": float((d_got - d_want).norm() / d_want.norm())}


def _tp_fit_final(seed: int, mesh, work: str, rank: int) -> dict:
    """On a rank of the 1 x 2 mesh: ResNet50/224 bf16 'auto' with its
    head split, fit (Adam, PAR_EPOCHS x PAR_STEPS steps at B=64, eval on
    PAR_VAL, resident) then train_final_model on the whole train set
    (one epoch, checkpoints in the rank's own directory); the launches
    of both, whether the final .npz loads (load_predictor, this process)
    to the gathered model bit for bit."""
    from types import SimpleNamespace

    from irp_tpu_torch import tracking
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.train import fit
    from irp_tpu_torch.train.final import train_final_model

    train, val, info = _train_sets(seed, PAR_TRAIN, PAR_VAL)
    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    tc = TrainConfig(batch_size=PAR_B2, max_epochs=PAR_EPOCHS, patience=99,
                     seed=seed, steps_per_epoch_override=PAR_STEPS,
                     eval_samples=PAR_VAL)
    tracking.set_tracking_uri(f"{work}/tp_mlruns{rank}")
    _zero_launch_counts()
    t0 = time.perf_counter()
    res = fit(train, val, info, cfg, tc, mesh=mesh, device="cuda:0")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # recommended_epochs: 0.8 x max_epochs, rounded down: one epoch
    best = SimpleNamespace(params={**FINAL_PARAMS, "batch_size": PAR_B2,
                                   "max_epochs": 2}, user_attrs={})
    study = SimpleNamespace(best_trial=best, get_trials=lambda: [best])
    ckpt = f"{work}/tp_ckpt{rank}"
    t0 = time.perf_counter()
    final = train_final_model(study, train, val, info, model_base=cfg,
                              train_base=tc, device="cuda:0",
                              checkpoint_dir=ckpt, experiment="tp_final",
                              verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t0
    launches = _launch_counts()
    whole = {k: v.detach().cpu() for k, v in
             final.state.model.state_dict().items()}
    npz_equal = None
    if rank == 0:
        pred = load_predictor(f"{ckpt}/final_model.npz", cfg=cfg,
                              device="cuda:0")
        loaded = pred.model.state_dict()
        npz_equal = all(torch.equal(loaded[k].cpu(), t)
                        for k, t in whole.items()
                        if not k.endswith("num_batches_tracked"))
    return {"history": res.history, "fit_s": fit_s, "final_s": final_s,
            "step_ms": res.history["train_ms"][-1] / PAR_STEPS,
            "fit_state": _cpu_state(res.state.model), "final_state": whole,
            "final_acc": final.test_acc, "final_loss": final.test_loss,
            "final_run": final.run_id, "npz_equal": npz_equal,
            "wrote": os.path.exists(f"{ckpt}/final_model.npz"),
            "launches": launches}


def _tp_runs(seed: int, mesh, work: str = None, rank: int = 0) -> dict:
    """The model-axis runs on a rank of ``mesh`` (data=1 x model=2 over
    the two ranks on cuda:0) or, with ``mesh`` None, in one process: the
    ViT-B/16 and ConvNeXt-Tiny forwards in TP_DTYPES and the ViT step;
    on a rank also the step with each of TP_FAULTS planted, then the
    ResNet50 fit and final run."""
    train, _, info = _train_sets(seed, PAR_TRAIN, PAR_VAL)
    out = {}
    t0 = time.perf_counter()
    for family in ("vit", "convnext"):
        for dtype in TP_DTYPES:
            out[f"{family}_{dtype}"] = _tp_forward(seed, mesh, family, dtype)
    out["step"] = _tp_step(seed, mesh, train, info)
    if mesh is not None:
        for fault in TP_FAULTS:
            out[f"step_{fault}"] = _tp_step(seed, mesh, train, info, fault)
        out["resnet50"] = _tp_fit_final(seed, mesh, work, rank)
    out["seconds"] = time.perf_counter() - t0
    return out


def _two_rank_worker(rank: int, port: int, work: str, seed: int) -> None:
    """One rank of the two-rank runs: a gloo group of two processes that
    share cuda:0 (NCCL refuses two ranks on one device)."""
    from irp_tpu_torch.parallel import distributed
    from irp_tpu_torch.parallel.mesh import make_mesh

    from irp_tpu_torch.config import MeshConfig

    distributed.initialize(f"localhost:{port}", 2, rank, device="cuda:0",
                           backend="gloo")
    try:
        out = _par_runs(seed, make_mesh())
        out["backend"] = torch.distributed.get_backend()
        out["tp"] = _tp_runs(seed, make_mesh(MeshConfig(data=1, model=2)),
                             work, rank)
    finally:
        distributed.shutdown()
    torch.save(out, f"{work}/rank{rank}.pt")


def _par_two_ranks(seed: int, work: str) -> dict:
    """Two processes of this script, ranks 0 and 1 over gloo on cuda:0,
    then the one-process reference at the global batch, twice (the
    floor)."""
    port = _free_port()
    t0 = time.perf_counter()
    logs = [open(f"{work}/rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--two-rank-worker",
         str(r), "--port", str(port), "--work", work, "--seed", str(seed)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=PAR_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"{work}/rank{r}.log") as f:
                tail = f.read()[-3000:]
            print(tail, file=sys.stderr, flush=True)
            raise RuntimeError(f"rank {r} exited {p.returncode}")
    ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False)
             for r in range(2)]
    t0 = time.perf_counter()
    ref = _par_runs(seed, None)
    ref_s = time.perf_counter() - t0
    again = _par_runs(seed, None)  # the floor
    init = _par_init(seed)
    report = {"backend": ranks[0]["backend"], "ranks_wall_s": ranks_s,
              "reference_wall_s": ref_s, "gaps": {}, "floor": {},
              "planted": {}, "ranks_bit_equal": {},
              "step_ms": {name: {r: run[f"fit_{dtype}"]["step_ms"]
                                 for r, run in (("rank0", ranks[0]),
                                                ("rank1", ranks[1]),
                                                ("one_process", ref))}
                          for name, dtype in (("bf16", "bfloat16"),
                                              ("f32", "float32"))},
              "launches": {"rank0": ranks[0]["launches"],
                           "rank1": ranks[1]["launches"],
                           "one_process": ref["launches"]}}

    def losses(run, key):
        if key.startswith("fit"):
            return run[key]["history"]["train_loss"] + \
                run[key]["history"]["val_loss"]
        return run[key]["losses"]

    def gaps(run, key, ref_key):
        return _par_gaps(run[key]["state"], ref[ref_key]["state"], init,
                         losses(run, key), losses(ref, ref_key))

    runs = [f"fit_{d}" for d in ("bfloat16", "float32")] + \
        [f"step_{d}" for d in PAR_DTYPES]
    for key in runs:
        report["gaps"][key] = gaps(ranks[0], key, key)
        report["floor"][key] = gaps(again, key, key)
        report["ranks_bit_equal"][key] = all(
            torch.equal(t, ranks[1][key]["state"][n])
            for n, t in ranks[0][key]["state"].items())
    for dtype in PAR_DTYPES:
        for fault in PAR_FAULTS[dtype]:
            report["planted"][f"step_{dtype}_{fault}"] = gaps(
                ranks[0], f"step_{dtype}_{fault}", f"step_{dtype}")
    report["tp"] = _tp_report(seed, [r["tp"] for r in ranks])
    return report


def _tp_checks(tp: dict) -> dict:
    """The model axis's gates (TP_TOL's comment); records each planted
    fault's update gap over its limit in ``tp``."""
    checks, ratios = {}, {}
    for key, ok in tp["ranks_bit_equal"].items():
        checks[f"tp_{key}_ranks_bit_equal"] = ok
    for key, bars in TP_TOL.items():
        limit = {name: max(TP_FLOOR_X * tp["floor"][key][name], bar)
                 for name, bar in bars.items()}
        for name in limit:
            checks[f"tp_{key}_{name}"] = tp["gaps"][key][name] <= limit[name]
        if key == "step":
            for fault in TP_FAULTS:
                ratios[fault] = tp["planted"][fault]["update"] / \
                    limit["update"]
                checks[f"tp_step_planted_{fault}_caught"] = \
                    ratios[fault] > 1.0
    tp["planted_gap_over_limit"] = ratios
    for k, v in tp["resnet50"]["checks"].items():
        checks[f"tp_resnet50_{k}"] = bool(v)
    return checks


def _tp_report(seed: int, ranks: list) -> dict:
    """The model axis's two ranks against one process on the same inputs,
    twice (the second run is the floor)."""
    t0 = time.perf_counter()
    ref = _tp_runs(seed, None)
    again = _tp_runs(seed, None)
    r0, r1 = ranks
    report = {"ranks_wall_s": [r["seconds"] for r in ranks],
              "reference_wall_s": time.perf_counter() - t0, "gaps": {},
              "floor": {}, "planted": {}, "ranks_bit_equal": {}, "ms": {}}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for family in ("vit", "convnext"):
        for dtype in TP_DTYPES:
            key = f"{family}_{dtype}"
            want = ref[key]["logits"]
            report["gaps"][key] = {"logits": rel(r0[key]["logits"], want)}
            report["floor"][key] = {"logits": rel(again[key]["logits"],
                                                  want)}
            report["ranks_bit_equal"][key] = torch.equal(
                r0[key]["logits"], r1[key]["logits"])
            report["ms"][f"{key}_forward"] = {
                "rank0": r0[key]["ms"], "rank1": r1[key]["ms"],
                "one_process": ref[key]["ms"]}
    init = _cpu_state(_tp_reference("vit", seed))
    report["gaps"]["step"] = _tp_gaps(r0["step"], ref["step"], init)
    report["floor"]["step"] = _tp_gaps(again["step"], ref["step"], init)
    for fault in TP_FAULTS:
        report["planted"][fault] = _tp_gaps(r0[f"step_{fault}"],
                                            ref["step"], init)
    report["ranks_bit_equal"]["step"] = all(
        torch.equal(t, r1["step"]["state"][k])
        for k, t in r0["step"]["state"].items())
    report["ms"]["vit_step"] = {"rank0": r0["step"]["ms"],
                                "rank1": r1["step"]["ms"],
                                "one_process": ref["step"]["ms"]}
    n0, n1 = r0["resnet50"], r1["resnet50"]
    whole = _par_init(seed)
    report["resnet50"] = {
        "history": n0["history"], "fit_s": [n0["fit_s"], n1["fit_s"]],
        "final_s": [n0["final_s"], n1["final_s"]],
        "final_acc": n0["final_acc"], "final_loss": n0["final_loss"],
        "launches": {"rank0": n0["launches"], "rank1": n1["launches"]},
        "checks": {
            "histories_equal": all(
                n0["history"][k] == n1["history"][k]
                for k in ("train_loss", "train_acc", "val_loss", "val_acc")),
            "losses_finite": all(math.isfinite(v) for v in
                                 n0["history"]["train_loss"]
                                 + n0["history"]["val_loss"]
                                 + [n0["final_loss"]]),
            "fit_models_whole_and_bit_equal": all(
                t.shape == whole[k].shape
                and torch.equal(t, n1["fit_state"][k])
                for k, t in n0["fit_state"].items()),
            "final_models_bit_equal": all(
                torch.equal(t, n1["final_state"][k])
                for k, t in n0["final_state"].items()),
            "final_npz_equals_gathered_model": bool(n0["npz_equal"]),
            "only_world_rank_0_wrote": n0["wrote"] and not n1["wrote"]
            and n0["final_run"] is not None and n1["final_run"] is None,
            "k1_and_k2_launched_on_each_rank": all(
                v > 0 for n in (n0, n1) for v in n["launches"].values())}}
    report["ms"]["resnet50_fit_step"] = {"rank0": n0["step_ms"],
                                         "rank1": n1["step_ms"]}
    return report


def _http_round(url: str, blobs: list, errors: list):
    """N_CLIENTS threads post ``blobs`` as JPEG bodies; (results, wall s)."""
    results = [None] * len(blobs)

    def client(idx: int) -> None:
        for i in range(idx, len(blobs), N_CLIENTS):
            try:
                results[i] = _post(f"{url}/predict?topk={N_CLASSES}",
                                   blobs[i], "image/jpeg")
            except Exception as e:  # noqa: BLE001 — counted as failed
                errors.append(f"request {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return results, time.perf_counter() - t0


def _par_replicas(path: str, seed: int) -> dict:
    """replicate_predictor on [cuda:0, cuda:0] behind make_server: 2
    rounds of N_REQUESTS JPEGs from N_CLIENTS clients; then images/s of
    rounds in turns with the one-replica daemon."""
    from irp_tpu_torch.data.pipeline import decode_blobs
    from irp_tpu_torch.infer import load_predictor, replicate_predictor
    from irp_tpu_torch.serve import make_server

    pred = load_predictor(path, batch_size=64, fused_frozen_blocks="auto")
    replicas = replicate_predictor(pred, devices=["cuda:0", "cuda:0"])
    blobs = _jpegs(seed + 3, N_REQUESTS)
    errors, rounds, per_s = [], [], {"replicas": [], "one": []}

    def serve(served):
        server = make_server(served, port=0, window_ms=5.0)
        for p in server.batcher.predictors:
            p.predict_probs(np.zeros((64, 256, 256, 3), np.uint8))
        torch.cuda.synchronize()
        server.start()
        return server, f"http://127.0.0.1:{server.port}"

    server, url = serve(replicas)
    before = _launch_counts()
    for _ in range(2):
        results, wall = _http_round(url, blobs, errors)
        rounds.append(results)
        per_s["replicas"].append(N_REQUESTS / wall)
    after = _launch_counts()
    with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    server.stop()
    launches = {k: after[k] - before[k] for k in after}
    # images/s in turns: one replica, two, two, one
    for label in ("one", "replicas", "replicas", "one"):
        server, url = serve(replicas if label == "replicas" else pred)
        _, wall = _http_round(url, blobs, errors)
        per_s[label].append(N_REQUESTS / wall)
        server.stop()
    images = decode_blobs(blobs)
    want = pred.predict_probs(images)
    want_rows = [[round(float(x), 6) for x in row] for row in want]
    served_equal = True
    for results in rounds:
        for i, res in enumerate(results):
            if res is None or res[0] != 200:
                served_equal = False
                continue
            got = [0.0] * N_CLASSES
            for item in res[1]["predictions"][0]["topk"]:
                got[item["label"]] = item["prob"]
            served_equal &= got == want_rows[i]
    direct = [bool(np.array_equal(r.predict_probs(images), want))
              for r in replicas]
    per = stats["per_replica"]
    return {"requests": 2 * N_REQUESTS, "clients": N_CLIENTS,
            "failed": len(errors), "errors": errors[:5],
            "per_replica": per, "batches": stats["batches"],
            "launches": launches, "images_per_s_in_turns": per_s,
            "checks": {
                "no_failed_request": not errors and all(
                    r is not None and r[0] == 200
                    for res in rounds for r in res),
                "both_replicas_dispatched": len(per) == 2 and all(
                    p["batches"] > 0 for p in per),
                "served_equal_single_predictor_6_decimals": served_equal,
                "replicas_bit_equal_single_predictor": all(direct),
                "k2_once_per_batch": launches["eval_preprocess"]
                == stats["batches"],
                "k1_ten_per_batch": launches["identity_bottleneck"]
                == 10 * stats["batches"]}}


def _par_local_mesh(path: str, state_dict: dict, seed: int,
                    tmp: str) -> dict:
    """A local mesh of [cuda:0, cuda:0]: Predictor(mesh=) and
    extract_features(mesh=) at N = PAR_N against the unsharded paths;
    predict_cli --data-parallel on the card's default mesh against the
    run without it."""
    from irp_tpu_torch.cli import predict_cli
    from irp_tpu_torch.data.outliers import extract_features
    from irp_tpu_torch.data.pipeline import CachedDataset
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(seed + 4)
    images = rng.integers(0, 256, (PAR_N, 256, 256, 3), np.uint8)
    single = load_predictor(path, batch_size=256,
                            fused_frozen_blocks="auto")
    sharded = load_predictor(path, batch_size=256,
                             fused_frozen_blocks="auto", mesh=mesh)
    report, launches = {}, {}
    before = _launch_counts()
    p_sh = sharded.predict_probs(images)
    torch.cuda.synchronize()
    after = _launch_counts()
    launches["predictor"] = {k: after[k] - before[k] for k in after}
    p_one = single.predict_probs(images)
    report["predictor_max_abs_dprob"] = float(np.abs(p_sh - p_one).max())
    cached = CachedDataset(images=images, labels=np.zeros(PAR_N, np.int32),
                           keys=[str(i) for i in range(PAR_N)],
                           class_names=tuple(f"class{c}"
                                             for c in range(N_CLASSES)))
    cfg = _train_model_cfg(fused_frozen_blocks="auto")
    before = _launch_counts()
    f_sh, _, keys = extract_features(cached, cfg, batch_size=FEATURE_BATCH,
                                     state_dict=state_dict, mesh=mesh)
    torch.cuda.synchronize()
    after = _launch_counts()
    launches["extract_features"] = {k: after[k] - before[k] for k in after}
    f_one, _, _ = extract_features(cached, cfg, batch_size=FEATURE_BATCH,
                                   state_dict=state_dict, device="cuda")
    report["features_rel_err"] = float(np.abs(f_sh - f_one).max()
                                       / np.abs(f_one).max())
    # predict_cli on the card's default mesh (every local card: one)
    img_dir = f"{tmp}/images"
    os.makedirs(img_dir)
    for i, blob in enumerate(_jpegs(seed + 5, 256)):
        with open(f"{img_dir}/img{i:04d}.jpg", "wb") as f:
            f.write(blob)
    rows, rcs = {}, {}
    for flag in ((), ("--data-parallel",)):
        csv_path = f"{tmp}/preds{len(flag)}.csv"
        with contextlib.redirect_stdout(io.StringIO()):
            rcs[bool(flag)] = predict_cli.main([
                "--weights", path, "--images", img_dir, "--out", csv_path,
                "--batch-size", "64", "--fused-frozen-blocks", "auto",
                *flag])
        with open(csv_path) as f:
            rows[bool(flag)] = list(csv.DictReader(f))
    report.update(launches=launches, default_mesh_devices=len(
        make_mesh().devices))
    report["checks"] = {
        "predictor_within_tol": report["predictor_max_abs_dprob"]
        <= PAR_PRED_TOL,
        "features_within_tol": report["features_rel_err"] <= PAR_PRED_TOL,
        "feature_keys_in_order": keys == cached.keys,
        "predictor_k2_once_per_part": launches["predictor"][
            "eval_preprocess"] == 2 * PAR_N // 256,
        "extract_k2_once_per_part": launches["extract_features"][
            "eval_preprocess"] == 2 * PAR_N // FEATURE_BATCH,
        "predict_cli_rc_0": rcs[False] == 0 and rcs[True] == 0,
        "predict_cli_data_parallel_csv_equal": rows[False] == rows[True]
        and len(rows[True]) == 256}
    return report


def _par_sweep(seed: int, tmp: str) -> dict:
    """run_parallel_trials through the runner: PAR_SWEEP_TRIALS quick
    trials (hyperopt_cli --quick's space, k = PAR_SWEEP_K) on two workers
    sharing cuda:0 and in sequence, in turns (sequential, two, two,
    sequential), each a study of its own."""
    import dataclasses

    from irp_tpu_torch import tracking
    from irp_tpu_torch.config import HyperoptConfig, ModelConfig
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.hyperopt.objective import HyperoptContext, quick_space
    from irp_tpu_torch.hyperopt.runner import run_kfold_optimization

    shards = _write_shards(seed, f"{tmp}/shards", n_shards=PAR_SWEEP_SHARDS)
    tracking.set_tracking_uri(f"{tmp}/mlruns")
    tracking.set_experiment("parallel_sweep")
    info = analyze_webdataset(shards)
    cached = build_cache(shards, info.class_names, cache_dir=f"{tmp}/cache")
    hcfg = HyperoptConfig(n_trials=PAR_SWEEP_TRIALS, k_folds=PAR_SWEEP_K,
                          first_fold_min_acc=0.0, storage=f"{tmp}/s.db",
                          study_name="parallel", seed=seed)
    report = {"wall_s": {"sequential": [], "two_workers": []},
              "launches": dict.fromkeys(_launch_counts(), 0)}
    studies, released = [], []
    for turn, name in enumerate(("sequential", "two_workers", "two_workers",
                                 "sequential")):
        workers = 2 if name == "two_workers" else None
        ctx = HyperoptContext(
            cached=cached, info=info,
            hcfg=dataclasses.replace(hcfg, study_name=f"{name}{turn}"),
            model_base=ModelConfig(num_classes=info.num_classes),
            device="cuda", space_fn=quick_space)
        before = _launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            studies.append(run_kfold_optimization(
                ctx, n_trials=PAR_SWEEP_TRIALS, verbose=True,
                parallel_workers=workers,
                devices=["cuda:0", "cuda:0"] if workers else None))
        torch.cuda.synchronize()
        report["wall_s"][name].append(time.perf_counter() - t0)
        if workers:  # the parallel path's launches
            after = _launch_counts()
            _add_launches(report["launches"],
                          {k: after[k] - before[k] for k in after})
        released.append(ctx._hbm_pool is None)
    trials = [t for s in studies for t in s.get_trials()]
    report["states"] = [t.state for t in trials]
    report["values"] = [t.value for t in trials]
    report["checks"] = {
        "trials_complete_or_pruned": all(
            len(s.get_trials()) == PAR_SWEEP_TRIALS for s in studies)
        and set(report["states"]) <= {"COMPLETE", "PRUNED"},
        "complete_values_finite": all(
            np.isfinite(t.value) for t in trials if t.state == "COMPLETE"),
        "pools_released": all(released)}
    return report


def phase_parallel(out: dict, seed: int) -> None:
    """Data parallelism (A14a) on the card at ResNet50/224 bf16 'auto':
    (1) fit at B=32 over an NCCL group of one rank against the same fit
    without a group; (2) two processes of this script over gloo sharing
    cuda:0 at global B=64 against one process at B=64; (3) two replicas on
    cuda:0 behind make_server; (4) a local mesh of [cuda:0, cuda:0] under
    Predictor and extract_features, and predict_cli --data-parallel; (5)
    two sweep workers sharing cuda:0 beside a sequential sweep."""
    from irp_tpu_torch.train.checkpoint import save_weights_npz

    report, checks = {}, {}
    train, val, info = _train_sets(seed, PAR_TRAIN, PAR_VAL)
    t0 = time.perf_counter()
    w1 = _par_world1(seed, train, val, info)
    report["world1_s"] = time.perf_counter() - t0
    report["world1"] = w1
    checks["world1_backend_nccl"] = w1["backend"] == "nccl"
    checks["world1_launches_equal_no_group"] = (
        w1["launches"]["nccl_world1"] == w1["launches"]["no_group"])
    for key, bar in PAR_TOL["world1"].items():
        checks[f"world1_{key}"] = w1["gaps"][key] <= max(
            PAR_FLOOR_X * w1["floor"][key], bar)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        two = _par_two_ranks(seed, tmp)
        report["two_ranks_s"] = time.perf_counter() - t0
    report["two_ranks"] = two
    checks["two_ranks_backend_gloo"] = two["backend"] == "gloo"
    for key, ok in two["ranks_bit_equal"].items():
        checks[f"two_ranks_{key}_ranks_bit_equal"] = ok
    for key in two["gaps"]:
        if key.startswith("fit"):  # Adam's: printed, not gated
            checks[f"two_ranks_{key}_finite"] = all(
                math.isfinite(v) for v in two["gaps"][key].values())
    ratios = {}
    for dtype in PAR_DTYPES:
        key = f"step_{dtype}"
        limit = {name: max(PAR_FLOOR_X * two["floor"][key][name], bar)
                 for name, bar in PAR_TOL[key].items()}
        for name in limit:
            checks[f"two_ranks_{key}_{name}"] = \
                two["gaps"][key][name] <= limit[name]
        for fault in PAR_FAULTS[dtype]:
            planted = two["planted"][f"{key}_{fault}"]
            ratios[f"{key}_{fault}"] = max(
                planted[name] / limit[name] for name in limit)
            checks[f"two_ranks_{key}_planted_{fault}_caught"] = \
                ratios[f"{key}_{fault}"] > 1.0
    two["planted_gap_over_limit"] = ratios
    checks.update(_tp_checks(two["tp"]))
    variables = _random_variables(seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/resnet50_224.npz"
        save_weights_npz(path, variables["params"], variables["batch_stats"],
                         meta={"image_size": 224})
        t0 = time.perf_counter()
        report["replicas"] = _par_replicas(path, seed)
        report["replicas_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["local_mesh"] = _par_local_mesh(
            path, _random_state_dict(seed), seed, tmp)
        report["local_mesh_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        report["sweep"] = _par_sweep(seed, tmp)
        report["sweep_s"] = time.perf_counter() - t0
    for part in ("replicas", "local_mesh", "sweep"):
        for k, v in report[part]["checks"].items():
            checks[f"{part}_{k}"] = bool(v)
    # the data-parallel runs alone: not their references without a group
    # or mesh, nor the sequential sweep, nor the planted faults' runs
    launches = dict.fromkeys(_launch_counts(), 0)
    for counts in (w1["launches"]["nccl_world1"], two["launches"]["rank0"],
                   two["launches"]["rank1"],
                   two["tp"]["resnet50"]["launches"]["rank0"],
                   two["tp"]["resnet50"]["launches"]["rank1"],
                   report["replicas"]["launches"],
                   report["local_mesh"]["launches"]["predictor"],
                   report["local_mesh"]["launches"]["extract_features"],
                   report["sweep"]["launches"]):
        _add_launches(launches, counts)
    out["launches"]["parallel"] = launches
    checks["k1_and_k2_launched"] = all(v > 0 for v in launches.values())
    emit({"phase": "parallel",
          "model": "ResNet50/224 bf16, K1 'auto', 10 classes, hidden 512",
          "launches": launches, **report, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"parallel checks failed: {failed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    # the parallel phase starts this script as each rank of its two-rank
    # runs with these
    ap.add_argument("--two-rank-worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.two_rank_worker is not None:
        _two_rank_worker(args.two_rank_worker, args.port, args.work,
                         args.seed)
        return 0
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    out: dict = {"launches": {}}
    phase_device(out)
    if "build" in phases:
        phase_build(out)
    if "kernels" in phases:
        phase_kernels(out, args.seed)
    if "serve" in phases:
        phase_serve(out, args.seed)
    if "explain" in phases:
        phase_explain(out, args.seed)
    if "families" in phases:
        phase_families(out, args.seed)
    if "curation" in phases:
        phase_curation(out, args.seed)
    if "bench" in phases:
        phase_bench(out, args.seed)
    if "train" in phases:
        phase_train(out, args.seed)
    if "families_train" in phases:
        phase_families_train(out, args.seed)
    if "hyperopt" in phases:
        phase_hyperopt(out, args.seed)
    if "final" in phases:
        phase_final(out, args.seed)
    if "decode" in phases:
        phase_decode(out, args.seed)
    if "fidelity" in phases:
        phase_fidelity(out, args.seed)
    if "monitor" in phases:
        phase_monitor(out, args.seed)
    if "parallel" in phases:
        phase_parallel(out, args.seed)
    if "profile" in phases:
        phase_profile(out, args.seed)
    if "step_spread" in phases:
        phase_step_spread(out, args.seed)
    # the bench phase's B=256 times, beside each kernel's yardstick call
    b256 = {"identity_bottleneck": [
        {"shape": r["shape"], "ms": r["fused_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["unfused_ms"],
         "copy_floor_ms": r["copy_floor_ms"]} for r in out.get("bench", [])],
        "copy_floor": [
        {"shape": r["shape"], "ms": r["copy_floor_ms"],
         "library_ms": r["relu_ms"]} for r in out.get("bench", [])]}
    kernels = []
    for name, entry in out.get("kernels", {}).items():
        at256 = b256.get(name) or entry.get("b256")
        by_path = {path: counts[name]
                   for path, counts in out["launches"].items()
                   if name in counts}
        kernels.append({
            "name": name, "route": entry["route"], "source": entry["source"],
            "replaces": entry["replaces"],
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path,
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
            **({"parent_ms": entry["parent_ms"]} if "parent_ms" in entry
               else {}),
            **({"b256": at256} if at256 else {})})
    print(out["smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
