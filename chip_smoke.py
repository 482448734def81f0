#!/usr/bin/env python3
"""Drive the PyTorch port's serving, curation and benchmark paths once on
one NVIDIA GPU.

  python3 chip_smoke.py                       # every phase, one card
  python3 chip_smoke.py --phases device,build,kernels
  python3 chip_smoke.py --phases device,build,profile

Phases, each printing one JSON line:

1. device   — the card (nvidia-smi name and power limit, torch's name).
2. build    — nvcc builds every kernel of irp_tpu_torch/csrc/, one
              process per source, all started together (seconds, ptxas
              register/shared-memory report).
3. kernels  — each kernel's wrapper on the card at the shapes its path
              gives it, held against its plain PyTorch version on the
              same inputs, and timed with CUDA events beside its bound,
              the plain version and a PyTorch yardstick call:
              eval_preprocess (<= 1 bf16 ulp); identity bottleneck
              (max|kernel - plain| / max|plain| <= 2^-6; yardstick the
              unfused cuDNN block); pairwise_dist at 1024 x 26,179 rows,
              D = 50 and D = 2 (max|kernel - plain| <= 1e-5 *
              max(|a_i|^2 + |b_j|^2), plain in cuBLAS f32 with TF32 off;
              yardstick torch.cdist; its operation bound at the 67 TFLOP/s
              float32 rate, not the bf16 tensor-core rate); copy_floor at
              the bottleneck's three shapes (bit for bit; yardstick
              torch.relu), whose time each bottleneck case also shows.
4. serve    — ResNet50/224 (10 classes, hidden 512, random weights from a
              seed) saved as .npz, loaded by load_predictor and served by
              make_server; concurrent JPEG requests over HTTP.  Every
              response must be 200 with probabilities summing to 1 and
              agree with an unfused predictor on the card, the launch
              counters must show the kernels on that path, and a float32
              CPU forward must agree on a small input.  Prints images/s of
              predict_probs at batch 64 and 256 and the /stats latency.
5. curation — embedding outlier detection at the Animals-10 scale:
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
              (eval_preprocess once per batch, pairwise_dist once per kNN
              row block).  Prints images/s of extract_features, seconds
              per stage and the share of planted images flagged.
6. bench    — python -m irp_tpu_torch.tools.bench_fused_block: the fused
              block, the unfused block and the copy floor at B=256.
              Gates: the bottleneck's max|kernel - plain| / max|plain|
              from the tool's run within 2^-6 at each shape, and the
              copy floor bit for bit against clamp_min(0) on one B=256
              input per shape.
7. profile  — only when named in --phases: torch.profiler over batches
              of 64 through predict_probs; device time by kernel group and
              the device's idle share.

Then the card's nvidia-smi line, one JSON object with every kernel's
numbers (launches summed over the paths that ran it), and last {"ok":
true, "device": {...}}.  Exits non-zero, with no result, when there is no
CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# the port, from the checkout this script sits in; without it this raises
# before anything runs.  gpu_ms: median device time over cold-L2 bursts.
from irp_tpu_torch.tools.bench_fused_block import gpu_ms, n_sets

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
PHASES = ("device", "build", "kernels", "serve", "curation", "bench")
EXTRA_PHASES = ("profile",)  # run only when named in --phases
# (name, H, W, C, M, blocks per ResNet50 forward)
BOTTLENECK_SHAPES = (("layer1", 56, 56, 256, 64, 2),
                     ("layer2", 28, 28, 512, 128, 3),
                     ("layer3", 14, 14, 1024, 256, 5))
K1_TOL = 2.0 ** -6
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


def bound(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """The least time (ms) for the work: bytes over the memory rate or
    operations over ``peak_flops``, whichever is larger, and which."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of bf16's last place at |want|."""
    want = want.float()
    diff = (got.float() - want).abs()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((diff / ulp).max())


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

    seconds = _kernels.build_all()
    report = {}
    for name in _kernels.SOURCES:
        _kernels.load(name)
        report[name] = [ln.strip() for ln in _kernels.build_log(name)
                        .splitlines() if "registers" in ln or "spill" in ln
                        or "smem" in ln]
    emit({"phase": "build", "seconds": round(seconds, 3), "ptxas": report})


def _k2_entry(gen) -> dict:
    from irp_tpu_torch.ops.cuda_image import (eval_preprocess,
                                              eval_preprocess_plain)

    b, s, o = 64, 256, 224
    sets = [torch.randint(0, 256, (b, s, s, 3), generator=gen,
                          dtype=torch.uint8).cuda() for _ in range(4)]
    got = eval_preprocess(sets[0], o)
    want = eval_preprocess_plain(sets[0], o)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got, want)
    err = float((got.float() - want.float()).abs().max())
    n_bytes = b * o * o * 3 * (1 + 2)
    bound_ms, bound_by = bound(n_bytes, 2 * b * o * o * 3)
    entry = {
        "name": "eval_preprocess", "route": "cuda",
        "source": "irp_tpu_torch/csrc/eval_preprocess.cu",
        "replaces": "irp_tpu/ops/pallas_image.py:79",
        "shape": f"({b},{s},{s},3) u8 -> ({b},{o},{o},3) bf16",
        "max_abs_err": err, "max_bf16_ulps": ulps, "tolerance": "1 bf16 ulp",
        "ms": gpu_ms([lambda x=x: eval_preprocess(x, o) for x in sets]),
        "plain_ms": gpu_ms([lambda x=x: eval_preprocess_plain(x, o)
                            for x in sets]),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ok": ulps <= 1.0}
    return entry


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
    got = fused_identity_bottleneck(xs[0], *weights)
    want = reference_identity_bottleneck(xs[0], *weights)
    with torch.inference_mode():
        x_nchw = xs[0].permute(0, 3, 1, 2)
        unfused = block(x_nchw, fused=False).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    rel = float((got.float() - want.float()).abs().max()) / scale
    rel_unfused = float((got.float() - unfused.float()).abs().max()) / scale
    w_bytes = (c * m + 9 * m * m + m * c) * 2 + (2 * m + c) * 4
    flops = 2 * b * h * w * (c * m + 9 * m * m + m * c)
    bound_ms, bound_by = bound(set_bytes + w_bytes, flops)

    def unfused_call(x):
        with torch.inference_mode():
            block(x.permute(0, 3, 1, 2), fused=False)

    return {
        "name": name, "shape": f"B={b} H={h} W={w} C={c} M={m}",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "rel_err": rel, "rel_err_vs_unfused_block": rel_unfused,
        "ms": gpu_ms([lambda x=x: fused_identity_bottleneck(x, *weights)
                      for x in xs]),
        "plain_ms": gpu_ms([lambda x=x: reference_identity_bottleneck(
            x, *weights) for x in xs]),
        "unfused_block_ms": gpu_ms([lambda x=x: unfused_call(x)
                                    for x in xs]),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "ok": rel <= K1_TOL}


def _k3_case(gen, d: int) -> dict:
    """pairwise_dist on one kNN row block (1024 rows against 26,179
    points) at width d."""
    from irp_tpu_torch.ops.cuda_image import (pairwise_dist,
                                              pairwise_dist_plain)

    m, n = K3_ROWS, N_IMAGES
    # the plain version is the f32 cuBLAS product: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    set_bytes = (m * d + n * d + m + n) * 4 + m * n * 4
    sets = []
    for _ in range(n_sets(set_bytes)):
        a = torch.randn(m, d, generator=gen).cuda()
        b = torch.randn(n, d, generator=gen).cuda()
        sets.append((a, b, (a * a).sum(dim=1), (b * b).sum(dim=1)))
    a, b, a_sq, b_sq = sets[0]
    got = pairwise_dist(a, b, a_sq, b_sq)
    want = pairwise_dist_plain(a, b, a_sq, b_sq)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # both sum |a|^2 + |b|^2 - 2ab in f32 in different orders: the
    # difference is a few ulps of the largest term, not of the result
    scale = float(a_sq.max() + b_sq.max())
    bound_ms, bound_by = bound(set_bytes, 2 * m * n * d, PEAK_FP32_FLOPS)
    return {
        "shape": f"({m},{d}) x ({n},{d}) f32 -> ({m},{n})",
        "max_abs_err": err, "max_err_over_scale": err / scale,
        "ms": gpu_ms([lambda s=s: pairwise_dist(*s) for s in sets]),
        "plain_ms": gpu_ms([lambda s=s: pairwise_dist_plain(*s)
                            for s in sets]),
        "library_ms": gpu_ms([lambda s=s: torch.cdist(
            s[0], s[1], compute_mode="use_mm_for_euclid_dist")
            for s in sets]),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "ok": err <= 1e-5 * scale}


def _k4_case(gen, h, w, c, b=32) -> dict:
    """copy_floor (relu copy) at one bottleneck shape."""
    from irp_tpu_torch.ops.cuda_resnet import relu_copy, relu_copy_plain

    set_bytes = 2 * b * h * w * c * 2
    xs = [torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16).cuda()
          for _ in range(n_sets(set_bytes))]
    got = relu_copy(xs[0])
    want = relu_copy_plain(xs[0])
    torch.cuda.synchronize()
    bits_equal = bool(torch.equal(got.view(torch.int16),
                                  want.view(torch.int16)))
    bound_ms, bound_by = bound(set_bytes, b * h * w * c)
    return {
        "shape": f"({b},{h},{w},{c}) bf16",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "bit_equal": bits_equal,
        "ms": gpu_ms([lambda x=x: relu_copy(x) for x in xs]),
        "plain_ms": gpu_ms([lambda x=x: relu_copy_plain(x) for x in xs]),
        "library_ms": gpu_ms([lambda x=x: torch.relu(x) for x in xs]),
        "bound_ms": bound_ms, "bound_by": bound_by, "ok": bits_equal}


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
          "max_abs_err": max(cs["max_abs_err"] for cs in k1_cases),
          "max_rel_err": max(cs["rel_err"] for cs in k1_cases),
          "tolerance": "max|kernel-plain|/max|plain| <= 2^-6",
          "ok": all(cs["ok"] for cs in k1_cases),
          "cases": k1_cases,
          **_per_forward(k1_cases, ("ms", "plain_ms", "bound_ms",
                                    "unfused_block_ms", "copy_floor_ms"))}
    # the unfused cuDNN block is the yardstick PyTorch call
    k1["library_ms"] = k1.pop("unfused_block_ms")
    k4 = {"name": "copy_floor", "route": "cuda",
          "source": "irp_tpu_torch/csrc/copy_floor.cu",
          "replaces": "tools/bench_fused_block.py:63",
          "shape": "the 10 bottleneck shapes of one ResNet50 forward at B=32",
          "max_abs_err": max(cs["max_abs_err"] for cs in k4_cases),
          "tolerance": "bit for bit", "ok": all(cs["ok"] for cs in k4_cases),
          "cases": k4_cases,
          **_per_forward(k4_cases, ("ms", "plain_ms", "bound_ms",
                                    "library_ms"))}
    k3_cases = []
    for d in (50, 2):
        case = _k3_case(gen, d)
        emit({"phase": "kernels", "kernel": "pairwise_dist", "case": case})
        k3_cases.append(case)
    # the kernel's entry is one row block of the UMAP kNN (D = 50)
    k3 = {"name": "pairwise_dist", "route": "cuda",
          "source": "irp_tpu_torch/csrc/pairwise_dist.cu",
          "replaces": "irp_tpu/ops/pallas_image.py:123",
          "tolerance": "max|kernel-plain| <= 1e-5 * max(|a_i|^2+|b_j|^2)",
          "ok": all(cs["ok"] for cs in k3_cases), "cases": k3_cases,
          "max_abs_err": max(cs["max_abs_err"] for cs in k3_cases),
          **{key: k3_cases[0][key] for key in (
              "shape", "ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by")}}
    kernels = (k2, k1, k3, k4)
    for k in (k1, k3, k4):
        emit({"phase": "kernels", "kernel": {key: v for key, v in k.items()
                                             if key != "cases"}})
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


def _images_per_s(pred, images: np.ndarray, reps: int = 5) -> float:
    pred.predict_probs(images)  # warm (cuDNN algorithm choice)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pred.predict_probs(images)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return images.shape[0] / (statistics.median(times) / 1e3)


def phase_serve(out: dict, seed: int) -> None:
    from irp_tpu_torch.data.pipeline import decode_blobs
    from irp_tpu_torch.infer import load_predictor, serving_buckets
    from irp_tpu_torch.ops.cuda_image import eval_preprocess
    from irp_tpu_torch.ops.cuda_resnet import fused_identity_bottleneck
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
    eval_preprocess.launches = 0
    fused_identity_bottleneck.launches = 0
    results = run_round()
    run_round()
    launches = {"eval_preprocess": eval_preprocess.launches,
                "identity_bottleneck": fused_identity_bottleneck.launches}
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
        "card_f32_vs_cpu_f32_le_1e-3": cpu_diff <= 1e-3,
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
          "images_per_s_predict_probs": ips, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"serve checks failed: {failed}")


def _curation_images(seed: int, n: int):
    """n synthetic 256x256 uint8 images made on the card: N_CLASSES smooth
    base patterns (8x8 noise upsampled), each image its class's pattern
    plus a brightness offset and pixel noise; PLANTED_SHARE of them carry
    another class's pattern under their label.  Returns host (images,
    labels, planted)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    small = torch.rand(N_CLASSES, 3, 8, 8, generator=g, device="cuda") * 255
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

    from irp_tpu_torch.ops.cuda_image import pairwise_dist_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    i_k, d_k = outliers.knn(x, k, device="cuda")
    with mock.patch.object(outliers, "pairwise_dist", pairwise_dist_plain):
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
    from irp_tpu_torch.ops.cuda_image import eval_preprocess, pairwise_dist

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
    pairwise_dist.launches = 0
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
                "pairwise_dist": pairwise_dist.launches}
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
        "k3_once_per_knn_block": launches["pairwise_dist"] == want_k3,
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
              n / FEATURE_BATCH), "pairwise_dist": want_k3},
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
    emit({"phase": "bench", "shapes": results, "launches": launches,
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"bench checks failed: {failed}")


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


def phase_profile(out: dict, seed: int, batch: int = 64, reps: int = 5
                  ) -> None:
    """Where the device time of ``predict_probs`` goes: a torch.profiler
    trace of ``reps`` batches, device time summed by kernel group and the
    device's idle share of the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from irp_tpu_torch.infer import make_predictor

    pred = make_predictor(_random_variables(seed), batch_size=batch,
                          image_size=224, fused_frozen_blocks="auto")
    images = np.random.default_rng(seed + 2).integers(
        0, 256, (batch, 256, 256, 3), np.uint8)
    for _ in range(2):
        pred.predict_probs(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict_probs(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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
    emit({"phase": "profile", "batch": batch, "reps": reps,
          "wall_ms_per_batch": wall_us / reps / 1e3,
          "device_busy_ms_per_batch": busy / reps / 1e3,
          "device_idle_share": 1.0 - busy / wall_us,
          "device_ms_per_batch_by_group": {
              g: t / reps / 1e3 for g, t in sorted(groups.items(),
                                                    key=lambda kv: -kv[1])},
          "top_kernels_ms_per_batch": [[n[:120], t / reps / 1e3]
                                       for n, t in top]})


def _f32(cfg):
    import dataclasses

    return dataclasses.replace(cfg, compute_dtype="float32",
                               precision="highest",
                               fused_frozen_blocks="off")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
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
    if "curation" in phases:
        phase_curation(out, args.seed)
    if "bench" in phases:
        phase_bench(out, args.seed)
    if "profile" in phases:
        phase_profile(out, args.seed)
    kernels = []
    for name, entry in out.get("kernels", {}).items():
        by_path = {path: counts[name]
                   for path, counts in out["launches"].items()
                   if name in counts}
        kernels.append({
            "name": name, "route": entry["route"], "source": entry["source"],
            "replaces": entry["replaces"],
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path,
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"]})
    print(out["smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
