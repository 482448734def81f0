"""The port's HBMFoldPool against the JAX package's on a one-device CPU
mesh with the same seed: the same fold prefixes index for index, the
same reshuffles, stale views refused, one upload per sweep, the OOM
fallbacks, and ``fit(hbm_train=view)`` reading the samples in the order a
fit over the same set reads them.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from irp_tpu.config import MeshConfig
from irp_tpu.data import pipeline as jax_pipeline
from irp_tpu.parallel.mesh import make_mesh
from irp_tpu_torch.config import HyperoptConfig, ModelConfig, TrainConfig
from irp_tpu_torch.data.analyze import analyze_webdataset
from irp_tpu_torch.data.pipeline import HBMFoldPool, build_cache
from irp_tpu_torch.hyperopt import objective as objective_mod
from irp_tpu_torch.hyperopt.objective import HyperoptContext, quick_space
from irp_tpu_torch.hyperopt.runner import run_kfold_optimization
from irp_tpu_torch import tracking
from irp_tpu_torch.train import step as step_mod
from tests.synth import make_synthetic_shards

# the module, not the function that irp_tpu_torch.train exports
fit_mod = importlib.import_module("irp_tpu_torch.train.fit")
torch.set_num_threads(1)
SIZE = 48


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool_shards")
    meta = make_synthetic_shards(str(root), num_classes=3, per_class=16,
                                 samples_per_shard=8, seed=3, size=SIZE)
    info = analyze_webdataset(meta["shards"])
    cached = build_cache(meta["shards"], info.class_names, size=SIZE)
    jcached = jax_pipeline.build_cache(meta["shards"], info.class_names,
                                       size=SIZE)
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    return cached, jcached, info, mesh, meta["shards"]


def _folds(shards, k):
    return [shards[i::k] for i in range(k)]


def _train(folds, f):
    return [s for i, fold in enumerate(folds) if i != f for s in fold]


def _prefix(pool, view):
    """(cache indices, labels on the device) of the view's prefix."""
    lt = view.local_count
    labels = np.asarray(pool.labels).reshape(-1)[:lt]
    slots = pool._slot_sample
    return (slots if slots.ndim == 1 else slots[0])[:lt].copy(), labels


@pytest.mark.parametrize("seed", [0, 5])
def test_fold_prefixes_equal_jax_index_for_index(setup, seed):
    cached, jcached, _, mesh, shards = setup
    pool = HBMFoldPool(cached, "cpu", seed=seed)
    jpool = jax_pipeline.HBMFoldPool(jcached, mesh, seed=seed)
    assert pool.upload_bytes == jpool.upload_bytes
    np.testing.assert_array_equal(pool._slot_sample, jpool._slot_sample[0])
    folds = _folds(shards, 3)
    for f in range(3):
        view = pool.select_fold(_train(folds, f))
        jview = jpool.select_fold(_train(folds, f))
        assert view.local_count == jview.local_count
        assert jpool.last_dropped == 0
        idx, labels = _prefix(pool, view)
        jidx, jlabels = _prefix(jpool, jview)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(labels, jlabels)
        assert [cached.keys[i] for i in idx] == [jcached.keys[i]
                                                for i in jidx]
        # the device tensors hold those samples' pixels
        np.testing.assert_array_equal(
            pool.images[:view.local_count].numpy(), cached.images[idx])
        subset = cached.subset_by_shards(_train(folds, f))
        assert sorted(labels.tolist()) == sorted(subset.labels.tolist())
        view.local_reshuffle(11 + f)
        jview.local_reshuffle(11 + f)
        np.testing.assert_array_equal(pool._slot_sample,
                                      jpool._slot_sample[0])
        np.testing.assert_array_equal(
            pool.images.numpy(), cached.images[pool._slot_sample])


def test_reselect_and_reshuffle_keep_the_fold_and_stale_views_raise(setup):
    cached, _, _, _, shards = setup
    pool = HBMFoldPool(cached, "cpu", seed=1)
    folds = _folds(shards, 3)
    t0 = _train(folds, 0)
    view = pool.select_fold(t0)
    before = sorted(_prefix(pool, view)[0].tolist())
    view.local_reshuffle(7)
    idx, labels = _prefix(pool, view)
    assert sorted(idx.tolist()) == before
    np.testing.assert_array_equal(labels, cached.labels[idx])
    np.testing.assert_array_equal(
        pool.images[:view.local_count].numpy(), cached.images[idx])
    view2 = pool.select_fold(_train(folds, 1))
    for read in (lambda: view.images, lambda: view.labels,
                 lambda: view.window(0, 4), lambda: view.local_reshuffle(1)):
        with pytest.raises(RuntimeError, match="stale"):
            read()
    view3 = pool.select_fold(t0)
    assert sorted(_prefix(pool, view3)[0].tolist()) == before
    pool.release()
    with pytest.raises(RuntimeError, match="stale"):
        _ = view3.images
    del view2


def _ctx(cached, info, tmp_path, tag, **kw):
    return HyperoptContext(
        cached=cached, info=info,
        hcfg=HyperoptConfig(n_trials=2, k_folds=2, first_fold_min_acc=0.0,
                            storage=str(tmp_path / f"{tag}.db")),
        model_base=ModelConfig(depth=18, num_classes=info.num_classes,
                               image_size=40, compute_dtype="float32"),
        device="cpu", space_fn=quick_space, train_samples_per_epoch=32,
        eval_samples=16, **kw)


def test_a_sweep_uploads_the_set_once(setup, tmp_path, monkeypatch):
    cached, _, info, _, _ = setup
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    pools, per_fit = [], []
    real_pool, real_dataset = objective_mod.HBMFoldPool, fit_mod.HBMDataset

    def counting_pool(*a, **kw):
        pools.append(1)
        return real_pool(*a, **kw)

    def counting_dataset(*a, **kw):
        per_fit.append(1)
        return real_dataset(*a, **kw)

    monkeypatch.setattr(objective_mod, "HBMFoldPool", counting_pool)
    monkeypatch.setattr(fit_mod, "HBMDataset", counting_dataset)
    n = len(cached)
    ctx = _ctx(cached, info, tmp_path, "pooled")
    study = run_kfold_optimization(ctx, n_trials=1, verbose=False)
    assert study.best_value is not None
    assert (len(pools), len(per_fit)) == (1, 0)
    assert ctx._hbm_pool is None  # released at the end of the sweep
    assert ctx.hbm_pool_stats["upload_bytes"] == n * SIZE * SIZE * 3 + n * 4
    pools.clear()
    ctx = _ctx(cached, info, tmp_path, "unpooled", reuse_hbm_pool=False)
    run_kfold_optimization(ctx, n_trials=1, verbose=False)
    assert (len(pools), len(per_fit)) == (0, 2)


class _Result:
    def __init__(self, acc):
        self.best_val_acc = acc


def _stub_fit(calls, fail_first_with=None):
    """A fit that records whether it got a pool view, reports two epochs
    and optionally raises on its first call."""

    def stub(train_cached, val_cached, info, model_cfg, train_cfg,
             on_epoch_end=None, hbm_train=None, **kw):
        calls.append(hbm_train is not None)
        if hbm_train is None:
            assert train_cached.images is not None
        else:
            assert train_cached.images is None
            assert hbm_train.local_count == len(train_cached)
        if fail_first_with is not None and len(calls) == 1:
            raise fail_first_with
        for epoch, acc in enumerate((50.0, 60.0 + len(calls))):
            on_epoch_end(epoch, acc)
        return _Result(60.0 + len(calls))

    return stub


@pytest.mark.parametrize("where", ["select_fold", "pool_build"])
def test_a_pool_oom_falls_back_to_per_fit_uploads(setup, tmp_path,
                                                  monkeypatch, where):
    cached, _, info, _, _ = setup
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    calls, tried = [], []

    def oom(*a, **kw):
        tried.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 5.15 GiB")

    if where == "select_fold":
        monkeypatch.setattr(HBMFoldPool, "select_fold", oom)
    else:
        monkeypatch.setattr(objective_mod, "HBMFoldPool", oom)
    monkeypatch.setattr(objective_mod, "fit", _stub_fit(calls))
    ctx = _ctx(cached, info, tmp_path, f"oom_{where}")
    with pytest.warns(UserWarning, match="ran out of memory.*per-fit "
                      "uploads serve the rest of the sweep"):
        study = run_kfold_optimization(ctx, n_trials=2, verbose=False)
    assert len(tried) == 1, "the pool is given up after its first OOM"
    assert ctx.reuse_hbm_pool is False and ctx._hbm_pool is None
    assert calls == [False] * 4
    assert [t.state for t in study.get_trials()] == ["COMPLETE"] * 2


def test_a_fit_oom_with_the_pool_resident_releases_and_retries(
        setup, tmp_path, monkeypatch):
    cached, _, info, _, _ = setup
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    calls, released = [], []
    real_release = HBMFoldPool.release

    def release(self):
        released.append(1)
        real_release(self)

    monkeypatch.setattr(HBMFoldPool, "release", release)
    monkeypatch.setattr(objective_mod, "fit", _stub_fit(
        calls, RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")))
    ctx = _ctx(cached, info, tmp_path, "fit_oom")
    with pytest.warns(UserWarning, match="releasing the pool"):
        study = run_kfold_optimization(ctx, n_trials=2, verbose=False)
    assert calls[0] is True and all(c is False for c in calls[1:])
    assert len(calls) == 5 and released == [1]
    assert ctx.reuse_hbm_pool is False and ctx._hbm_pool is None
    trials = study.get_trials()
    assert [t.state for t in trials] == ["COMPLETE"] * 2
    # the failed attempt's epochs were dropped: each epoch has k entries
    assert trials[0].intermediate_values == {0: 50.0, 1: 62.0}


def test_other_runtime_errors_are_not_taken_for_oom(setup, tmp_path,
                                                    monkeypatch):
    cached, _, info, _, _ = setup
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    calls = []
    monkeypatch.setattr(objective_mod, "fit", _stub_fit(
        calls, RuntimeError("shape mismatch")))
    ctx = _ctx(cached, info, tmp_path, "not_oom")
    study = run_kfold_optimization(ctx, n_trials=1, verbose=False)
    assert study.get_trials()[0].state == "FAILED"
    assert ctx.reuse_hbm_pool is True


def test_fit_on_a_fold_view_reads_the_samples_as_a_fit_on_the_set(
        setup, monkeypatch):
    """fit(hbm_train=view) against fit over a CachedDataset whose
    build-time permutation puts the same samples in the same order: the
    same batches step by step over two epochs (so one per-epoch
    reshuffle) and the same weights after."""
    cached, _, info, _, shards = setup
    pool = HBMFoldPool(cached, "cpu", seed=2)
    train_shards = _train(_folds(shards, 2), 0)
    view = pool.select_fold(train_shards)
    prefix = pool._slot_sample[:view.local_count].copy()
    seed = 3
    # HBMDataset(set, seed) holds set[rng(seed).permutation(n)]: lay the
    # set out so that this is the view's prefix
    perm = np.random.default_rng(seed).permutation(len(prefix))
    order = np.empty_like(prefix)
    order[perm] = prefix
    fields = dict(labels=cached.labels[order],
                  keys=[cached.keys[i] for i in order],
                  class_names=cached.class_names)
    full = type(cached)(images=cached.images[order], **fields)
    meta = type(cached)(images=None, **fields)
    val = cached.subset_by_shards(_folds(shards, 2)[0])
    model_cfg = ModelConfig(depth=18, num_classes=info.num_classes,
                            image_size=40, compute_dtype="float32")
    train_cfg = TrainConfig(batch_size=8, max_epochs=2, patience=9,
                            train_samples_per_epoch=24, eval_samples=8,
                            seed=seed, aug_intensity="low")
    seen = {}
    real_step = step_mod.train_step

    def recording_step(state, images, labels, *a, **kw):
        seen[key].append((images.sum(dim=(1, 2, 3)).tolist(),
                          labels.tolist()))
        return real_step(state, images, labels, *a, **kw)

    monkeypatch.setattr(step_mod, "train_step", recording_step)
    results = {}
    for key, kw in (("view", dict(hbm_train=view)), ("set", {})):
        seen[key] = []
        results[key] = fit_mod.fit(meta if key == "view" else full, val,
                                   info, model_cfg, train_cfg,
                                   device="cpu", **kw)
    assert len(seen["view"]) == 6
    assert seen["view"] == seen["set"]
    for (n, a), b in zip(
            results["view"].state.model.state_dict().items(),
            results["set"].state.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with pytest.raises(ValueError, match="hbm_train requires"):
        fit_mod.fit(meta, val, info, model_cfg, train_cfg, device="cpu",
                    mode="stream", hbm_train=view)
    with pytest.raises(ValueError, match="metadata-only"):
        fit_mod.fit(meta, val, info, model_cfg, train_cfg, device="cpu")
