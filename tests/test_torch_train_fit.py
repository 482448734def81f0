"""``fit`` of the port end to end on the CPU (``train/fit.py``,
``train/loop.py``, ``train/checkpoint.py``, ``data/pipeline.py``).

- A tiny fit on tests/synth.py shards (decoded by the port's own tar
  reader and PIL decode) converges: the loss falls and validation accuracy
  is well above chance.
- A run stopped after two of four epochs and resumed from its checkpoint
  ends bit-equal to an uninterrupted one (the JAX package holds itself to
  the same in tests/test_resume.py), for adam with EMA.
- The full-state checkpoint round-trips the optimizer moments, the step
  count and both EMAs.
- The stream path trains; ``resolve_fit_mode`` counts the reshuffle's
  second copy; the resident data plane sees the JAX package's order.
"""

import dataclasses

import jax
import numpy as np
import torch

from irp_tpu.data.pipeline import CachedDataset as JaxCachedDataset
from irp_tpu.data.pipeline import HBMEvalSet as JaxHBMEvalSet
from irp_tpu.data.pipeline import HBMDataset as JaxHBMDataset
from irp_tpu.parallel.mesh import make_mesh
from irp_tpu_torch.config import DatasetInfo, ModelConfig, TrainConfig
from irp_tpu_torch.data.pipeline import (CachedDataset, HBMDataset,
                                         HBMEvalSet, decode_to_rgb256)
from irp_tpu_torch.data.tar import iter_samples
from irp_tpu_torch.train import fit
from irp_tpu_torch.train.checkpoint import (latest_checkpoint,
                                            restore_checkpoint,
                                            save_checkpoint)
from irp_tpu_torch.train.fit import resolve_fit_mode

from tests.synth import make_synthetic_shards
from tests.torch_jax_train import uint8_images

torch.set_num_threads(1)


def _from_shards(paths, class_names, size=40):
    images, labels, keys = [], [], []
    index = {n: i for i, n in enumerate(class_names)}
    for sample in iter_samples(list(paths)):
        images.append(decode_to_rgb256(sample["jpg"], size))
        labels.append(index[sample["cls"].decode()])
        keys.append(sample["__key__"])
    return CachedDataset(np.stack(images), np.asarray(labels, np.int32),
                         keys, tuple(class_names))


def _info(cached):
    counts = np.bincount(cached.labels, minlength=len(cached.class_names))
    n, k = len(cached), len(counts)
    return DatasetInfo(num_classes=k, class_names=cached.class_names,
                       class_weights=tuple(float(n / (k * c))
                                           for c in counts),
                       class_counts=tuple(int(c) for c in counts),
                       total_samples=n)


def test_tiny_fit_on_synthetic_shards_converges(tmp_path):
    train = make_synthetic_shards(str(tmp_path / "train"), num_classes=3,
                                  per_class=16, samples_per_shard=16,
                                  seed=0, size=48)
    val = make_synthetic_shards(str(tmp_path / "val"), num_classes=3,
                                per_class=8, samples_per_shard=24, seed=1,
                                size=48, prefix="val")
    train_c = _from_shards(train["shards"], train["class_names"])
    val_c = _from_shards(val["shards"], val["class_names"])
    model_cfg = ModelConfig(depth=18, num_classes=3, image_size=32,
                            compute_dtype="float32")
    train_cfg = TrainConfig(batch_size=16, max_epochs=4, patience=99,
                            learning_rate=1e-3, aug_intensity="medium",
                            seed=3)
    res = fit(train_c, val_c, _info(train_c), model_cfg, train_cfg,
              device="cpu")
    h = res.history
    assert all(np.isfinite(h["train_loss"]))
    assert h["train_loss"][-1] < h["train_loss"][0]
    assert res.best_val_acc >= 80.0, h
    assert len(h["train_ms"]) == 4 and res.steps_per_epoch == 3
    assert res.device == torch.device("cpu")
    # the returned model is in eval form with the best weights
    assert not res.state.model.training


def _random_dataset(n=32, classes=3, size=40):
    images = uint8_images(9, n, size)
    labels = (np.arange(n) % classes).astype(np.int32)
    names = tuple(f"c{i}" for i in range(classes))
    cached = CachedDataset(images, labels, [str(i) for i in range(n)], names)
    return cached, _info(cached)


RESUME_MODEL = ModelConfig(depth=18, num_classes=3, image_size=32,
                           compute_dtype="float32")
RESUME_TRAIN = TrainConfig(learning_rate=1e-3, weight_decay=1e-4,
                           batch_size=16, max_epochs=4, patience=99,
                           aug_intensity="medium", ema_decay=0.9,
                           train_samples_per_epoch=None, seed=7)


def test_resumed_fit_is_bit_equal_to_an_uninterrupted_one(tmp_path):
    cached, info = _random_dataset()
    full = fit(cached, None, info, RESUME_MODEL, RESUME_TRAIN, device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")

    def crash_after_two(epoch, val_acc, state=None):
        save_checkpoint(ckpt_dir, state, step=epoch)
        return epoch >= 1

    fit(cached, None, info, RESUME_MODEL, RESUME_TRAIN, device="cpu",
        on_epoch_end=crash_after_two)
    path, start = latest_checkpoint(ckpt_dir)
    assert start == 2
    resumed = fit(cached, None, info, RESUME_MODEL, RESUME_TRAIN,
                  device="cpu", restore_from=path, start_epoch=start)
    a = full.state.model.state_dict()
    b = resumed.state.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert full.state.step == resumed.state.step == 8
    assert resumed.history["train_loss"] == full.history["train_loss"][2:]


def test_checkpoint_roundtrips_optimizer_and_ema(tmp_path):
    cached, info = _random_dataset(n=16)
    for opt in ("adam", "sgd"):
        one = dataclasses.replace(RESUME_TRAIN, max_epochs=1, optimizer=opt)
        res = fit(cached, None, info, RESUME_MODEL, one, device="cpu")
        path = save_checkpoint(str(tmp_path / opt), res.state)
        assert latest_checkpoint(str(tmp_path / opt)) == (path, 2)
        fresh = fit(cached, None, info, RESUME_MODEL,
                    dataclasses.replace(one, max_epochs=0), device="cpu")
        assert fresh.state.step == 0
        restore_checkpoint(path, fresh.state)
        assert fresh.state.step == res.state.step == 1
        want, got = res.state.state_dict(), fresh.state.state_dict()
        for k, t in want["model"].items():
            assert torch.equal(got["model"][k], t), k
        for kind, tensors in want["optimizer"]["moments"].items():
            for n, t in tensors.items():
                assert torch.equal(got["optimizer"]["moments"][kind][n], t)
        for n, t in want["optimizer"]["ema"].items():
            assert torch.equal(got["optimizer"]["ema"][n], t)
        for n, t in want["ema_batch_stats"].items():
            assert torch.equal(got["ema_batch_stats"][n], t)
    assert latest_checkpoint(str(tmp_path / "none")) == (None, 0)


def test_stream_mode_and_accumulation_train():
    cached, info = _random_dataset()
    cfg = dataclasses.replace(RESUME_TRAIN, max_epochs=1, ema_decay=0.0,
                              grad_accum_steps=2, mixup_alpha=0.4,
                              cutmix_alpha=1.0, label_smoothing=0.1)
    res = fit(cached, cached, info, RESUME_MODEL, cfg, mode="stream",
              device="cpu")
    assert np.isfinite(res.history["train_loss"][0])
    assert np.isfinite(res.history["val_loss"][0])
    assert res.state.step == 2


def test_resolve_fit_mode_counts_the_reshuffle_copy():
    cached, _ = _random_dataset(n=10, size=40)
    per_img = 40 * 40 * 3
    cfg = TrainConfig(batch_size=4, eval_samples=None)
    # train twice (reshuffle) + the eval set padded to 12
    need = 2 * 10 * per_img + 12 * per_img
    assert resolve_fit_mode(cached, cached, cfg, "cpu", headroom=1.0,
                            budget_bytes=need) == "hbm"
    assert resolve_fit_mode(cached, cached, cfg, "cpu", headroom=1.0,
                            budget_bytes=need - 1) == "stream"
    no_shuffle = dataclasses.replace(cfg, hbm_reshuffle=False)
    assert resolve_fit_mode(cached, cached, no_shuffle, "cpu", headroom=1.0,
                            budget_bytes=need - 1) == "hbm"
    assert resolve_fit_mode(cached, cached, cfg, "cpu") == "hbm"


def test_resident_sets_match_the_jax_package():
    cached, _ = _random_dataset(n=30)
    jcached = JaxCachedDataset(images=cached.images, labels=cached.labels,
                               keys=cached.keys,
                               class_names=cached.class_names)
    mesh = make_mesh(devices=jax.devices()[:1])
    jhbm = JaxHBMDataset(jcached, mesh, shuffle_seed=3)
    thbm = HBMDataset(cached, "cpu", shuffle_seed=3)
    for seed in (11, 12):
        jhbm.local_reshuffle(seed)
        thbm.local_reshuffle(seed)
    np.testing.assert_array_equal(thbm.images.numpy(),
                                  np.asarray(jhbm.images)[0])
    np.testing.assert_array_equal(thbm.labels.numpy(),
                                  np.asarray(jhbm.labels)[0])
    jeval = JaxHBMEvalSet(jcached, mesh, 8, max_samples=20)
    teval = HBMEvalSet(cached, "cpu", 8, max_samples=20)
    np.testing.assert_array_equal(teval.images.numpy(),
                                  np.asarray(jeval.images)[0])
    np.testing.assert_array_equal(teval.offsets, jeval.offsets)
    logits = np.random.default_rng(0).normal(size=(teval.steps, 8, 3))
    np.testing.assert_array_equal(teval.scatter_logits(logits),
                                  jeval.scatter_logits(logits))
