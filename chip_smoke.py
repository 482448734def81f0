#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

  python3 chip_smoke.py                       # every phase, one card
  python3 chip_smoke.py --phases device,build,kernels
  python3 chip_smoke.py --phases device,build,profile

Phases, each printing one JSON line:

1. device  — the card (nvidia-smi name and power limit, torch's name).
2. build   — nvcc builds every kernel of irp_tpu_torch/csrc/ (seconds,
             ptxas register/shared-memory report).
3. kernels — each kernel's wrapper on the card at the shapes the serving
             path gives it, held against its plain PyTorch version on the
             same inputs (eval_preprocess: <= 1 bf16 ulp; identity
             bottleneck: max|kernel - plain| / max|plain| <= 2^-6), and
             timed with CUDA events beside its bound, the plain version
             and, for the bottleneck, the unfused cuDNN block.
4. serve   — ResNet50/224 (10 classes, hidden 512, random weights from a
             seed) saved as .npz, loaded by load_predictor and served by
             make_server; concurrent JPEG requests over HTTP.  Every
             response must be 200 with probabilities summing to 1 and
             agree with an unfused predictor on the card, the launch
             counters must show the kernels on that path, and a float32
             CPU forward must agree on a small input.  Prints images/s of
             predict_probs at batch 64 and 256 and the /stats latency.
5. profile — only when named in --phases: torch.profiler over batches
             of 64 through predict_probs; device time by kernel group and
             the device's idle share.

Then the card's nvidia-smi line, one JSON object with every kernel's
numbers, and last {"ok": true, "device": {...}}.  Exits non-zero, with no
result, when there is no CUDA device or any phase fails.
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

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
PHASES = ("device", "build", "kernels", "serve")
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


def emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_ms(calls, reps: int = 10) -> float:
    """Median device time of one call, over ``reps`` bursts that run every
    call once.  Each call works on its own buffers, so a burst touches
    more than the 50 MB L2 and every call finds its inputs cold.  A sleep
    kernel ahead of each burst lets the host enqueue the whole burst
    before the card reaches it, so host overhead is not timed."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / len(calls))
    return statistics.median(per_call)


def n_sets(set_bytes: int) -> int:
    return max(2, math.ceil(128e6 / set_bytes))


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
    from irp_tpu_torch.models.resnet import Bottleneck
    from irp_tpu_torch.ops.cuda_resnet import (fused_identity_bottleneck,
                                               reference_identity_bottleneck)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    # one random identity block; BN stats perturbed so the folding matters
    block = Bottleneck(c, m, 1, torch.bfloat16, True, fusable=True)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.reset_parameters_from(gen)
        for bn in (block.bn1, block.bn2, block.bn3):
            f = bn.num_features
            bn.weight.copy_(0.5 + torch.rand(f, generator=gen))
            bn.bias.copy_(rand(f, scale=0.1))
            bn.running_mean.copy_(rand(f, scale=0.1))
            bn.running_var.copy_(0.5 + torch.rand(f, generator=gen))
    block = block.cuda().to(memory_format=torch.channels_last).eval()
    # folded once, as the Predictor caches them for the serve path
    weights = block.folded_weights()
    set_bytes = 2 * b * h * w * c * 2
    xs = [rand(b, h, w, c).to(torch.bfloat16).cuda()
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


def phase_kernels(out: dict, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    k2 = _k2_entry(gen)
    emit({"phase": "kernels", "kernel": k2})
    cases = []
    for name, h, w, c, m, per_fwd in BOTTLENECK_SHAPES:
        case = _k1_case(gen, name, h, w, c, m)
        case["per_forward"] = per_fwd
        emit({"phase": "kernels", "kernel": "identity_bottleneck",
              "case": case})
        cases.append(case)
    # one entry per kernel: the bottleneck's work is one ResNet50 forward's
    # 10 launches at B=32 (2 x layer1, 3 x layer2, 5 x layer3)
    k1 = {"name": "identity_bottleneck", "route": "cuda",
          "source": "irp_tpu_torch/csrc/identity_bottleneck.cu",
          "replaces": "irp_tpu/ops/pallas_resnet.py:140",
          "shape": "10 blocks of one ResNet50 forward at B=32",
          "max_abs_err": max(cs["max_abs_err"] for cs in cases),
          "max_rel_err": max(cs["rel_err"] for cs in cases),
          "tolerance": "max|kernel-plain|/max|plain| <= 2^-6",
          "ok": all(cs["ok"] for cs in cases),
          "cases": cases}
    for key in ("ms", "plain_ms", "bound_ms", "unfused_block_ms"):
        k1[key] = sum(cs[key] * cs["per_forward"] for cs in cases)
    k1["bound_by"] = ("bytes" if all(cs["bound_by"] == "bytes"
                                     for cs in cases) else "operations")
    # the unfused cuDNN block is the yardstick PyTorch call
    k1["library_ms"] = k1.pop("unfused_block_ms")
    out["kernels"] = {"eval_preprocess": k2, "identity_bottleneck": k1}
    bad = [k["name"] for k in (k2, k1) if not k["ok"]]
    if bad:
        raise RuntimeError(f"kernels out of tolerance: {bad}")


def _random_variables(seed: int):
    """ResNet50/224 classifier from a seeded generator, BN affine and
    running stats perturbed, as a {'params', 'batch_stats'} tree."""
    from irp_tpu_torch.config import ModelConfig
    from irp_tpu_torch.models.classifier import init_classifier
    from irp_tpu_torch.models.convert import state_dict_to_jax_variables

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
    return state_dict_to_jax_variables(sd)


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
    out["launches"] = launches
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
    # the port itself, from the checkout this script sits in; without it
    # this raises before any phase runs
    import irp_tpu_torch  # noqa: F401
    out: dict = {}
    phase_device(out)
    if "build" in phases:
        phase_build(out)
    if "kernels" in phases:
        phase_kernels(out, args.seed)
    if "serve" in phases:
        phase_serve(out, args.seed)
    if "profile" in phases:
        phase_profile(out, args.seed)
    kernels = []
    for name, entry in out.get("kernels", {}).items():
        kernels.append({
            "name": name, "route": entry["route"], "source": entry["source"],
            "replaces": entry["replaces"],
            "launches": out.get("launches", {}).get(name),
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
