"""Embedding-based outlier detection: features -> PCA -> UMAP -> LOF (the
JAX package's ``data/outliers.py``).

- **Feature extraction**: the headless ResNet forward, batched on the
  card, with preprocessing through the eval-preprocess kernel.  The
  dataset is uploaded once when it fits in free device memory, else
  streamed batch by batch.
- **PCA**: 50 components via ``torch.linalg.svd`` on the device.
- **Supervised UMAP**: kNN through the fused distance + top-k kernel
  (``ops/cuda_image.py::pairwise_topk``); the fuzzy
  simplicial set, its categorical label intersection and the smooth-kNN
  calibration on host numpy/scipy (the same code as the JAX package);
  spectral init with ``torch.lobpcg`` on the sparse graph; the
  attract/repulse negative-sampling SGD layout with ``index_add_``.
- **LOF**: local outlier factor from kNN distances; per class (30, 0.05)
  and global (75, 0.03).
- **Reporting/cleaning**: results frame, UMAP/outlier scatter plots,
  per-class stats, sample grids, clean-set writer.  pandas and matplotlib
  are imported only by these functions.

Every function that touches a tensor takes ``device``: CUDA unless the
caller asks for the CPU.  ``timings``, where a function takes it, is a
dict that receives the host seconds of each stage it runs (added to any
value already there).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data.pipeline import CachedDataset
from irp_tpu_torch.ops.cuda_image import pairwise_topk

# the device-resident feature path uploads the dataset only when it takes
# at most this share of the free device memory (the rest holds the model,
# the activations of one batch and the features)
RESIDENT_SHARE = 0.5


@contextlib.contextmanager
def _stage(timings: Optional[dict], name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Feature extraction (batched, on device)
# ---------------------------------------------------------------------------


def extract_features(cached: CachedDataset, model_cfg: ModelConfig = None,
                     batch_size: int = 64, state_dict=None,
                     verbose: bool = False, mesh=None, device=None,
                     resident: Optional[bool] = None,
                     timings: Optional[dict] = None):
    """Headless ResNet features for every cached image, batched on the
    device.  Returns (features (N, F) f32 numpy, labels (N,), keys).

    ``state_dict``: the port's weights (``backbone.*``, ``classifier.*``;
    e.g. after :func:`~irp_tpu_torch.models.convert.merge_pretrained`);
    None draws them from ``torch.Generator().manual_seed(0)``.
    ``resident``: upload the dataset once (True) or copy one batch at a
    time (False); None chooses before uploading, by comparing the
    dataset's bytes with the free device memory (always resident on the
    CPU, where it is a view).  Every batch has ``batch_size`` rows: the
    tail batch is padded by repeating its own rows, as the JAX package
    pads it, and the pad rows are dropped.

    ``mesh`` (``parallel/mesh.py``; ``batch_size`` must split over its
    data axis): a local mesh splits every batch over its devices, one
    forward per part; over a process mesh each rank computes its rows of
    the JAX package's ``HBMEvalSet`` layout and the ranks' features are
    summed into one zero-filled (N, F) buffer (``all_reduce``), so every
    rank returns all of them in the original order.
    """
    from irp_tpu_torch.models.classifier import Classifier, init_classifier
    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch
    from irp_tpu_torch.parallel.mesh import (Mesh, batch_sharding,
                                             replicated, shard_variables)

    dev = resolve_device(device if mesh is None else mesh.device)
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by data "
                         f"axis size {mesh.size}")
    model_cfg = model_cfg or ModelConfig()
    if state_dict is None:
        model = init_classifier(model_cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    else:
        model = Classifier(model_cfg)
        model.load_state_dict(state_dict)
    local = mesh if mesh is not None and not mesh.is_process \
        else Mesh([dev])
    models = dict(zip(replicated(local), shard_variables(local, model)))
    for m in models.values():
        m.eval()
        m.backbone.cache_folded_weights()
    model = models[dev]
    dtype = getattr(torch, model_cfg.compute_dtype)
    size = model_cfg.image_size
    n = len(cached)
    labels, keys = np.asarray(cached.labels), list(cached.keys)
    if n == 0:
        return np.zeros((0, model.backbone.num_features), np.float32), \
            labels, keys

    def features(batch):
        """One padded batch's features, split over the local mesh."""
        parts = [models[d].features(eval_preprocess_batch(
            batch[rows].to(d), size, dtype).permute(0, 3, 1, 2))
            for d, rows in batch_sharding(local)(batch.shape[0])]
        return torch.cat([p.to(dev) for p in parts])

    if mesh is not None and mesh.is_process:
        return _extract_sharded(cached, mesh, batch_size, features, dev,
                                timings), labels, keys
    if resident is None:
        resident = (dev.type == "cpu" or cached.images.nbytes
                    <= RESIDENT_SHARE * torch.cuda.mem_get_info(dev)[0])
    with _stage(timings, "upload"):
        data = (torch.from_numpy(np.ascontiguousarray(cached.images)).to(dev)
                if resident else None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with _stage(timings, "features"), torch.inference_mode():
        feats = torch.empty((n, model.backbone.num_features),
                            dtype=torch.float32, device=dev)
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            idx = np.resize(np.arange(start, stop), batch_size)
            if resident:
                batch = (data[start:stop] if stop - start == batch_size
                         else data[torch.from_numpy(idx).to(dev)])
            else:
                batch = torch.from_numpy(
                    np.ascontiguousarray(cached.images[idx])).to(dev)
            feats[start:stop] = features(batch)[:stop - start]
            if verbose and (start // batch_size) % 20 == 0:
                print(f"features: {stop}/{n}")
        out = feats.cpu().numpy()
    return out, labels, keys


def _extract_sharded(cached, mesh, batch_size: int, features, dev,
                     timings) -> np.ndarray:
    """extract_features over a process mesh: this rank's windows of the
    (D, steps x B/D) layout, gathered in (steps, D, B/D) order on every
    rank, then put back in the set's order."""
    from irp_tpu_torch.parallel.mesh import gather_rows

    n, d, r = len(cached), mesh.size, mesh.index
    bl = batch_size // d
    steps = -(-n // batch_size)
    order = np.arange(steps * batch_size) % n
    mine = order[r * steps * bl:(r + 1) * steps * bl]
    with _stage(timings, "features"), torch.inference_mode():
        local = torch.cat([features(torch.from_numpy(np.ascontiguousarray(
            cached.images[mine[s * bl:(s + 1) * bl]])).to(dev))
            for s in range(steps)])
        pos = (np.arange(steps)[:, None] * batch_size + r * bl
               + np.arange(bl)[None, :]).reshape(-1)
        full = gather_rows(mesh, local, steps * batch_size, pos)
        flat = full.reshape(steps, d, bl, -1).transpose(0, 1).reshape(
            steps * batch_size, -1).cpu().numpy()
    out = np.empty((n, flat.shape[1]), np.float32)
    out[order] = flat
    return out


# ---------------------------------------------------------------------------
# PCA (device SVD)
# ---------------------------------------------------------------------------


def pca(features: np.ndarray, n_components: int = 50, device=None):
    """PCA via SVD on the device.  Returns (projected, components, mean)
    as numpy."""
    x = torch.as_tensor(np.asarray(features, np.float32),
                        device=resolve_device(device))
    mu = x.mean(dim=0, keepdim=True)
    xc = x - mu
    # economical SVD; components = rows of Vt
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    comps = vt[:n_components]
    proj = xc @ comps.T
    return proj.cpu().numpy(), comps.cpu().numpy(), mu.cpu().numpy()


# ---------------------------------------------------------------------------
# kNN (blocked fused distance + top-k through the kernel)
# ---------------------------------------------------------------------------


def knn(x: np.ndarray, k: int, block: int = 1024, device=None):
    """Exact kNN (excluding self): returns (indices (N,k) int32, dists
    (N,k) float32).

    Each block of ``block`` rows takes its k nearest points, itself left
    out, from :func:`pairwise_topk` (the fused distance + top-k kernel on
    the card).  Equal distances come out lower index first, as the JAX
    package's ``lax.top_k`` orders them.
    """
    dev = resolve_device(device)
    # row blocks must be contiguous for the kernel, whatever x's order
    xd = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
    n, d = xd.shape
    if n < 2:
        return (np.zeros((n, 0), np.int32), np.zeros((n, 0), np.float32))
    k = min(k, n - 1)  # no more neighbours than other points
    sq = (xd * xd).sum(dim=1)
    if dev.type == "cuda" and d % 4:
        # the kernel reads 16-byte rows: pad once with zero columns, which
        # change no distance
        xd = torch.nn.functional.pad(xd, (0, 4 - d % 4))
    idxs = torch.empty((n, k), dtype=torch.int32, device=dev)
    dists = torch.empty((n, k), dtype=torch.float32, device=dev)
    for start in range(0, n, block):
        stop = min(start + block, n)
        top, idx = pairwise_topk(xd[start:stop], xd, k, sq[start:stop], sq,
                                 self_offset=start)
        idxs[start:stop] = idx
        dists[start:stop] = top.clamp_min(0.0).sqrt()
    return idxs.cpu().numpy(), dists.cpu().numpy()


# ---------------------------------------------------------------------------
# UMAP (from scratch)
# ---------------------------------------------------------------------------


def _smooth_knn(dists: np.ndarray, n_iter: int = 64,
                local_connectivity: float = 1.0):
    """Per-point (rho, sigma) calibration: binary search so that
    sum(exp(-(d - rho)/sigma)) = log2(k) (UMAP's smooth_knn_dist)."""
    n, k = dists.shape
    target = np.log2(k)
    rho = dists[:, max(int(local_connectivity) - 1, 0)].copy()
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    sigma = np.ones(n)
    for _ in range(n_iter):
        val = np.exp(-(np.maximum(dists - rho[:, None], 0.0)
                       / sigma[:, None])).sum(axis=1)
        too_big = val > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(np.isinf(hi), sigma * 2.0, (lo + hi) / 2.0)
    sigma = np.maximum(sigma, 1e-3 * np.maximum(dists.mean(axis=1), 1e-8))
    return rho, sigma


def fuzzy_simplicial_set(knn_idx: np.ndarray, knn_dist: np.ndarray):
    """Symmetrized fuzzy graph: w = w1 + w2 - w1*w2.  Returns COO arrays
    (rows, cols, weights)."""
    import scipy.sparse as sp

    n, k = knn_idx.shape
    rho, sigma = _smooth_knn(knn_dist)
    w = np.exp(-(np.maximum(knn_dist - rho[:, None], 0.0) / sigma[:, None]))
    rows = np.repeat(np.arange(n), k)
    cols = knn_idx.reshape(-1)
    vals = w.reshape(-1)
    g = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    gt = g.T.tocsr()
    sym = g + gt - g.multiply(gt)
    sym = sym.tocoo()
    return sym.row.astype(np.int32), sym.col.astype(np.int32), \
        sym.data.astype(np.float32)


def categorical_intersection(rows, cols, vals, labels: np.ndarray,
                             target_weight: float = 0.5):
    """Supervised UMAP: downweight edges between different-label points
    (umap-learn's categorical_simplicial_set_intersection with
    unknown_dist/far_dist derived from target_weight)."""
    far_dist = 2.5 if target_weight < 1.0 else 1e12
    scale = np.exp(-far_dist * target_weight / max(1 - target_weight, 1e-3))
    same = labels[rows] == labels[cols]
    return np.where(same, vals, vals * scale).astype(np.float32)


# which solver the most recent spectral_init call actually used
# ("lobpcg" | "eigsh" | "random"), so that a caller can see a downgrade
# of the device path
last_spectral_path: Optional[str] = None


def spectral_init(rows, cols, vals, n: int, dim: int = 2,
                  seed: int = 42, use_device: bool = True,
                  device=None) -> np.ndarray:
    """Normalized-Laplacian spectral embedding init (UMAP default).

    Device path: the smallest eigenvectors of L = I - D^-1/2 G D^-1/2 are
    the LARGEST of A = I + S, found with ``torch.lobpcg`` on A as a sparse
    tensor on the device, from the same numpy start block as the JAX
    package.  On any failure it warns and falls back to scipy eigsh, then
    to random init.
    """
    global last_spectral_path
    deg = np.zeros(n, np.float64)
    np.add.at(deg, rows, vals)
    d_inv = 1.0 / np.sqrt(np.maximum(deg, 1e-8))
    s_vals = (d_inv[rows] * vals * d_inv[cols]).astype(np.float32)
    k = dim + 1

    if use_device:
        dev = resolve_device(device)
        try:
            diag = np.arange(n)
            index = torch.from_numpy(np.stack([
                np.concatenate([np.asarray(rows, np.int64), diag]),
                np.concatenate([np.asarray(cols, np.int64), diag])]))
            values = torch.from_numpy(np.concatenate(
                [s_vals, np.ones(n, np.float32)]))
            x0 = torch.from_numpy(np.random.default_rng(seed).normal(
                0, 1.0, (n, k)).astype(np.float32))
            # the sparse tensors made here and inside lobpcg are checked
            with torch.sparse.check_sparse_tensor_invariants():
                a = torch.sparse_coo_tensor(index.to(dev), values.to(dev),
                                            (n, n)).coalesce()
                w, vecs = torch.lobpcg(a, k=k, X=x0.to(dev), niter=200,
                                       largest=True)
            lam = 2.0 - w.cpu().numpy()  # eigenvalues of L
            order = np.argsort(lam)
            emb = vecs.cpu().numpy()[:, order[1:k]]
            emb = emb / max(np.abs(emb).max(), 1e-12) * 10.0
            last_spectral_path = "lobpcg"
            return emb.astype(np.float32)
        except Exception as e:  # noqa: BLE001 — fall through to host solver
            import warnings

            warnings.warn(f"spectral_init: device LOBPCG path failed "
                          f"({e!r}); falling back to scipy eigsh",
                          RuntimeWarning, stacklevel=2)

    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    g = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    d_inv_m = sp.diags(d_inv)
    lap = sp.identity(n) - d_inv_m @ g @ d_inv_m
    try:
        _, vecs = spl.eigsh(lap, k=k, sigma=0.0, which="LM",
                            maxiter=2000)
        emb = vecs[:, 1:k]
        last_spectral_path = "eigsh"
    except Exception:  # noqa: BLE001 — fall back to random init
        emb = np.random.default_rng(seed).normal(0, 1e-2, (n, dim))
        last_spectral_path = "random"
    emb = emb / max(np.abs(emb).max(), 1e-12) * 10.0
    return emb.astype(np.float32)


def optimize_layout(emb: np.ndarray, rows, cols, vals, n_epochs: int = 200,
                    lr: float = 1.0, negative_rate: int = 5,
                    a: float = 1.577, b: float = 0.895, seed: int = 42,
                    min_dist_clip: float = 4.0, device=None,
                    negatives: Optional[np.ndarray] = None) -> np.ndarray:
    """UMAP's attract/repulse SGD, vectorized per epoch on the device.

    Each epoch moves every edge's endpoints together (weight-scaled
    attraction) and then runs ``negative_rate`` rounds of repulsion from
    one random point per edge; updates are scatter-adds (``index_add_``:
    rows, then cols, then each negative round).  a, b are the curve
    params for min_dist=0.1 (umap default).

    The negative samples come from a ``torch.Generator`` on the device
    seeded with ``seed``, one (E,) draw per (epoch, round); ``negatives``
    ((n_epochs, negative_rate, E) ints) supplies them instead.  On the
    card the scatter-adds use atomics, so the result varies in the last
    bits from run to run.
    """
    dev = resolve_device(device)
    n = emb.shape[0]
    e_rows = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    e_cols = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    vals = np.asarray(vals, np.float32)
    e_w = torch.as_tensor(vals / max(vals.max(), 1e-12), device=dev)[:, None]
    n_edges = e_rows.shape[0]
    if negatives is not None:
        negatives = torch.as_tensor(np.asarray(negatives, np.int64),
                                    device=dev)
        if tuple(negatives.shape) != (n_epochs, negative_rate, n_edges):
            raise ValueError(f"negatives must be ({n_epochs}, "
                             f"{negative_rate}, {n_edges}), got "
                             f"{tuple(negatives.shape)}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.tensor(np.ascontiguousarray(emb, np.float32), device=dev)

    def powb(d2, p):
        return d2.clamp_min(1e-8).pow(p)

    for i in range(n_epochs):
        alpha = lr * (1.0 - i / n_epochs)
        diff = out[e_rows] - out[e_cols]
        d2 = (diff * diff).sum(dim=1)
        # d phi_attr / d d2 with phi = log(1 + a d^(2b))
        coef = (-2.0 * a * b * powb(d2, b - 1.0)) / (1.0 + a * powb(d2, b))
        g = (coef[:, None] * diff).clamp(-min_dist_clip, min_dist_clip) * e_w
        out.index_add_(0, e_rows, alpha * g)
        out.index_add_(0, e_cols, -alpha * g)
        for j in range(negative_rate):
            neg = (negatives[i, j] if negatives is not None else
                   torch.randint(0, n, (n_edges,), generator=gen,
                                 device=dev))
            diff = out[e_rows] - out[neg]
            d2 = (diff * diff).sum(dim=1)
            coef = (2.0 * b) / ((0.001 + d2) * (1.0 + a * powb(d2, b)))
            g = ((coef[:, None] * diff).clamp(-min_dist_clip, min_dist_clip)
                 * e_w)
            out.index_add_(0, e_rows, alpha * g)
    return out.cpu().numpy()


def umap_2d(features: np.ndarray, labels: Optional[np.ndarray] = None,
            n_neighbors: int = 15, target_weight: float = 0.5,
            n_epochs: int = 200, seed: int = 42,
            verbose: bool = False, device=None,
            timings: Optional[dict] = None) -> np.ndarray:
    """Supervised 2-D UMAP."""
    with _stage(timings, "knn"):
        idx, dist = knn(features, k=n_neighbors, device=device)
    if verbose:
        print("knn done")
    with _stage(timings, "fuzzy_set"):
        rows, cols, vals = fuzzy_simplicial_set(idx, dist)
        if labels is not None:
            vals = categorical_intersection(rows, cols, vals,
                                            np.asarray(labels), target_weight)
    with _stage(timings, "spectral_init"):
        emb = spectral_init(rows, cols, vals, len(features), seed=seed,
                            device=device)
    if verbose:
        print("spectral init done")
    with _stage(timings, "layout"):
        return optimize_layout(emb, rows, cols, vals, n_epochs=n_epochs,
                               seed=seed, device=device)


def create_embeddings(features: np.ndarray, labels: np.ndarray,
                      n_pca: int = 50, n_neighbors: int = 15,
                      target_weight: float = 0.5, seed: int = 42,
                      verbose: bool = False, device=None,
                      timings: Optional[dict] = None):
    """PCA(50) then supervised UMAP(2).  Returns (embedding_2d,
    pca_projection)."""
    with _stage(timings, "pca"):
        proj, _, _ = pca(features, n_pca, device=device)
    emb = umap_2d(proj, labels, n_neighbors=n_neighbors,
                  target_weight=target_weight, seed=seed, verbose=verbose,
                  device=device, timings=timings)
    return emb, proj


# ---------------------------------------------------------------------------
# LOF
# ---------------------------------------------------------------------------


def local_outlier_factor(x: np.ndarray, n_neighbors: int = 20,
                         device=None):
    """LOF scores (sklearn-compatible definition): reach-dist -> lrd ->
    mean ratio of neighbor lrd to own lrd."""
    n = len(x)
    k = min(n_neighbors, n - 1)
    if k < 1:
        return np.ones(n)
    idx, dist = knn(x, k, device=device)
    k_dist = dist[:, -1]  # distance to k-th neighbor
    # reach_dist(a,b) = max(k_dist(b), d(a,b))
    reach = np.maximum(k_dist[idx], dist)
    lrd = 1.0 / np.maximum(reach.mean(axis=1), 1e-12)
    lof = (lrd[idx].mean(axis=1)) / np.maximum(lrd, 1e-12)
    return lof


def detect_outliers(embedding: np.ndarray, labels: np.ndarray,
                    per_class_neighbors: int = 30,
                    per_class_contamination: float = 0.05,
                    global_neighbors: int = 75,
                    global_contamination: float = 0.03, device=None,
                    timings: Optional[dict] = None):
    """Per-class + global LOF flags on the 2-D embedding.  Returns
    (class_outlier_mask, global_outlier_mask, scores dict)."""
    labels = np.asarray(labels)
    n = len(embedding)
    class_mask = np.zeros(n, bool)
    class_scores = np.ones(n)
    with _stage(timings, "lof"):
        for c in np.unique(labels):
            sel = np.nonzero(labels == c)[0]
            if len(sel) < 3:
                continue
            scores = local_outlier_factor(embedding[sel],
                                          min(per_class_neighbors,
                                              len(sel) - 1), device=device)
            class_scores[sel] = scores
            n_out = max(int(round(per_class_contamination * len(sel))), 0)
            if n_out:
                worst = sel[np.argsort(-scores)[:n_out]]
                class_mask[worst] = True
        g_scores = local_outlier_factor(embedding,
                                        min(global_neighbors, n - 1),
                                        device=device)
    global_mask = np.zeros(n, bool)
    n_out = max(int(round(global_contamination * n)), 0)
    if n_out:
        global_mask[np.argsort(-g_scores)[:n_out]] = True
    return class_mask, global_mask, {"class": class_scores,
                                     "global": g_scores}


def create_results_dataframe(embedding, labels, class_names, keys,
                             class_mask, global_mask):
    """x/y/label/key/outlier flags frame."""
    import pandas as pd

    labels = np.asarray(labels)
    return pd.DataFrame({
        "x": embedding[:, 0],
        "y": embedding[:, 1],
        "label": labels,
        "class_name": [class_names[l] for l in labels],
        "key": keys,
        "class_outlier": class_mask,
        "global_outlier": global_mask,
        "is_outlier": class_mask | global_mask,
    })


# ---------------------------------------------------------------------------
# Visualization + clean-set writer
# ---------------------------------------------------------------------------


def plot_umap(df, path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(9, 7))
    for name, sub in df.groupby("class_name"):
        plt.scatter(sub.x, sub.y, s=4, label=name, alpha=0.6)
    plt.legend(markerscale=3, fontsize=8)
    plt.title("Supervised UMAP embedding")
    plt.tight_layout(); plt.savefig(path); plt.close()
    return path


def plot_outliers(df, path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(9, 7))
    inl = df[~df.is_outlier]
    out = df[df.is_outlier]
    plt.scatter(inl.x, inl.y, s=4, c="tab:gray", alpha=0.4,
                label="inlier")
    plt.scatter(out.x, out.y, s=10, c="tab:red", label="outlier")
    plt.legend()
    plt.title("LOF outliers on UMAP embedding")
    plt.tight_layout(); plt.savefig(path); plt.close()
    return path


def display_outlier_stats(df) -> "object":
    """Per-class outlier stats table (printed + returned)."""
    stats = df.groupby("class_name").agg(
        total=("is_outlier", "size"),
        outliers=("is_outlier", "sum"))
    stats["pct"] = 100.0 * stats["outliers"] / stats["total"]
    print(stats.to_string())
    return stats


def display_outlier_samples(df, cached: CachedDataset, path: str,
                            max_samples: int = 16) -> str:
    """Grid of sample outlier images."""
    from irp_tpu_torch.utils.viz import plot_image_grid

    out_idx = np.nonzero(df.is_outlier.values)[0][:max_samples]
    images = [np.asarray(cached.images[i]) for i in out_idx]
    titles = [df.class_name.iloc[i] for i in out_idx]
    return plot_image_grid(images, titles, path,
                           suptitle="Sample outliers")


def create_clean_dataset(df, src_root: str, dest_root: str,
                         verbose: bool = True) -> int:
    """Copy non-outlier source images to the clean directory, from the
    frame's 'path' column where it has one."""
    os.makedirs(dest_root, exist_ok=True)
    copied = 0
    for _, row in df[~df.is_outlier].iterrows():
        src = row.get("path")
        if src is None or not os.path.exists(str(src)):
            continue
        dst_dir = os.path.join(dest_root, row.class_name)
        os.makedirs(dst_dir, exist_ok=True)
        shutil.copy2(src, os.path.join(dst_dir, os.path.basename(src)))
        copied += 1
    if verbose:
        kept = int((~df.is_outlier).sum())
        print(f"Clean dataset: copied {copied}/{kept} non-outliers "
              f"({int(df.is_outlier.sum())} outliers dropped)")
    return copied


def print_summary(df) -> None:
    total = len(df)
    n_class = int(df.class_outlier.sum())
    n_global = int(df.global_outlier.sum())
    n_any = int(df.is_outlier.sum())
    print(f"Outlier detection summary: {total} samples, "
          f"{n_class} class-level, {n_global} global, {n_any} total "
          f"({100.0 * n_any / max(total, 1):.2f}%)")
