"""The port's data parallelism in two real processes over gloo on
localhost (tests/torch_dist_child.py, one rank each, the CPU), held
against the JAX package on a data=2 mesh of the 8 virtual CPU devices,
as tests/test_distributed_multiprocess.py drives the JAX package.

- The process group: ``process_index``/``process_count``, disjoint
  ``host_shards``, an all-reduce and the process mesh.
- One data-parallel train step at global B=8 (4 a rank), ResNet18/56
  f32 'highest', class weights on, rank 0's rows all class 0 and rank
  1's classes 1 and 2 (so a rank's own BN moments or loss denominator
  would show): against ``make_hbm_train_step`` on
  ``make_mesh(MeshConfig(data=2, model=1))`` with the JAX package's
  draws fed in, SGD at lr 1 (the update is minus the gradient).  The
  loss within 1e-5 relative, every trainable tensor's update within
  2e-5 of its max |update| (measured up to 1.1e-5: f32 reduction order
  and the rounding of new - old; the single-process step test holds
  1e-4), layer4's BN statistics within 1e-5 relative, the two ranks'
  weights bit-equal.  Without mixing,
  with mixup (shard-local partner) and with ``grad_accum_steps=2``; the
  per-rank semantics (each rank's own BN moments and denominator,
  gradients averaged as DDP does) miss the JAX step by over 100x that
  bar.
- Over a gloo group of one rank, in this process, the data-parallel
  step is the groupless step bit for bit, with dropout (and, for
  EfficientNet, stochastic depth) drawn for the global batch from the
  same generator as the model draws them, or given, and with
  accumulation.
- ``fit(mesh=)`` with validation, ``train_final_model(mesh=)`` and
  sharded ``extract_features``: both ranks stop on the same epoch with
  the same validation accuracy and end with bit-equal weights, only
  rank 0 logs and writes checkpoints and a tracking run, and the
  sharded features equal the unsharded ones.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from irp_tpu.config import MeshConfig as JaxMeshConfig
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.config import TrainConfig as JaxTrainConfig
from irp_tpu.models.classifier import get_classifier as jax_get
from irp_tpu.parallel import distributed as jax_distributed
from irp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from irp_tpu.parallel.mesh import shard_variables as jax_shard
from irp_tpu.train.state import create_train_state as jax_state
from irp_tpu.train.step import make_hbm_train_step
from irp_tpu_torch.config import ModelConfig, TrainConfig
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.models.convert import flax_param_name
from irp_tpu_torch.models.resnet import sync_batch_stats
from irp_tpu_torch.parallel import distributed
from irp_tpu_torch.parallel.mesh import make_mesh
from irp_tpu_torch.train.loop import set_mode
from irp_tpu_torch.train.state import create_train_state
from irp_tpu_torch.train.step import StepConfig, train_step
from irp_tpu_torch.tracking import TrackingClient
from irp_tpu_torch.ops.mix import MixDraws

from tests.torch_jax_train import (jax_augment_draws, perturbed_variables,
                                   torch_model, uint8_images)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_dist_child.py")
CLASS_WEIGHTS = np.asarray([0.7, 1.6, 1.1], np.float32)
# rank 0's rows all class 0, rank 1's classes 1 and 2
LABELS = np.asarray([0, 0, 0, 0, 1, 2, 1, 2], np.int32)
# measured (CPU, f32): loss 2.2e-7 / 1.1e-7 / 7.8e-7 relative and updates
# 9.4e-6 / 1.1e-5 / 8.6e-6 of max |update| (plain / mixup / accum)
LOSS_TOL = 1e-5
UPDATE_TOL = 2e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(task: str, root: str, inputs=None) -> list:
    """Both ranks of ``task``; their outputs, rank by rank."""
    if inputs is not None:
        torch.save(inputs, os.path.join(root, f"in_{task}.pt"))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, CHILD, task, str(r), port,
                               root], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    return [torch.load(os.path.join(root, f"out_{task}_{r}.pt"),
                       weights_only=False) for r in range(2)]


def test_process_group_basics(tmp_path):
    outs = _run("basics", str(tmp_path))
    shards = [f"s{i:02d}.tar" for i in range(10)]
    for r, out in enumerate(outs):
        assert (out["index"], out["count"]) == (r, 2)
        # the JAX package's round robin, given the same index and count
        assert out["shards"] == jax_distributed.host_shards(shards, r, 2)
        assert out["total"] == 3.0
        assert (out["mesh_size"], out["mesh_index"]) == (2, r)
        assert out["rows"] == str([slice(4 * r, 4 * r + 4)])
    assert not set(outs[0]["shards"]) & set(outs[1]["shards"])
    assert sorted(outs[0]["shards"] + outs[1]["shards"]) == shards


def _cfg():
    return JaxModelConfig(depth=18, num_classes=3, image_size=56,
                          compute_dtype="float32", precision="highest",
                          dropout_rate=0.0)


def _named(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name, layout = flax_param_name([k.key for k in path])
        out[name] = np.array(layout(np.asarray(leaf)))
    return out


def _jax_mix_draws(key, alpha):
    """ops/mix.py::mix_batch's mixup draw from its key."""
    _, k_mix, _, _ = jax.random.split(key, 4)
    return MixDraws(lam_mixup=float(jax.random.beta(k_mix, alpha, alpha)))


def _jax_step(cfg, variables, images, labels, key, tc, mixup, accum):
    mesh = jax_make_mesh(JaxMeshConfig(data=2, model=1),
                         devices=jax.devices()[:2])
    state = jax_state(jax_get(cfg), jax_shard(mesh, jax.tree_util.tree_map(
        jnp.asarray, variables)), JaxTrainConfig(**tc), cfg, 1)
    step = make_hbm_train_step(mesh, 4, jnp.asarray(CLASS_WEIGHTS),
                               "medium", out_size=56,
                               compute_dtype=jnp.float32,
                               mixup_alpha=mixup, grad_accum=accum)
    data = jax.device_put(images.reshape((2, 4) + images.shape[1:]),
                          NamedSharding(mesh, P("data")))
    labs = jax.device_put(labels.reshape(2, 4),
                          NamedSharding(mesh, P("data")))
    new_state, metrics = step(state, data, labs, jnp.int32(0), key, 0.0)
    return (float(metrics["loss"]), float(metrics["accuracy"]),
            _named(new_state.params),
            jax.tree_util.tree_map(np.asarray, new_state.batch_stats))


@pytest.mark.parametrize("mixup,accum", [(0.0, 1), (0.4, 1), (0.0, 2)])
def test_data_parallel_step_matches_jax(tmp_path, mixup, accum):
    cfg = _cfg()
    variables = perturbed_variables(cfg, 6)
    images = uint8_images(9, 8, 64)
    key = jax.random.PRNGKey(17)
    tc = dict(optimizer="sgd", schedule="constant", learning_rate=1.0,
              weight_decay=0.0, grad_accum_steps=accum, batch_size=8)
    want_loss, want_acc, want, stats = _jax_step(
        cfg, variables, images, LABELS, key, tc, mixup, accum)
    if mixup:
        aug_key, mix_key, _ = jax.random.split(key, 3)
        mix = _jax_mix_draws(mix_key, mixup)
    else:
        aug_key, _ = jax.random.split(key)
        mix = None
    model = torch_model(cfg, variables)
    old = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    outs = _run("step", str(tmp_path), {
        "cfg": dataclasses.asdict(cfg), "state_dict": model.state_dict(),
        "train": tc, "images": torch.from_numpy(images),
        "labels": torch.from_numpy(LABELS),
        "class_weights": torch.from_numpy(CLASS_WEIGHTS),
        "aug_draws": jax_augment_draws(aug_key, "medium", 8, 64, 64),
        "mix_draws": mix, "mixup": mixup, "accum": accum,
        "naive": accum == 1})
    for name, t in outs[0]["state_dict"].items():
        assert torch.equal(t, outs[1]["state_dict"][name]), name
    got = outs[0]
    assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
    assert got["accuracy"] == pytest.approx(want_acc)
    trained = 0
    worst = 0.0
    for name, p in model.named_parameters():
        update = want[name] - old[name]
        if not p.requires_grad:
            assert not np.any(update), name
            continue
        rel = (np.abs(got["state_dict"][name].numpy() - old[name] - update)
               .max() / np.abs(update).max())
        worst = max(worst, rel)
        trained += 1
    assert trained > 0 and worst <= UPDATE_TOL, worst
    blk = stats["backbone"]["layer4_block1"]["bn2"]
    for field, buf in (("mean", "running_mean"), ("var", "running_var")):
        a = got["state_dict"][f"backbone.layer4.1.bn2.{buf}"].numpy()
        assert np.abs(a - blk[field]).max() <= LOSS_TOL * np.abs(
            blk[field]).max(), buf
    if accum == 1:
        # the per-rank semantics are far outside the bar
        naive = max(np.abs(-got["naive_grads"][n].numpy() - (
            want[n] - old[n])).max() / np.abs(want[n] - old[n]).max()
            for n in got["naive_grads"])
        assert naive > 100 * UPDATE_TOL, naive


_WORLD1_MODELS = {
    "resnet": (ModelConfig(depth=18, num_classes=3, image_size=56,
                           hidden_dim=16, compute_dtype="float32",
                           dropout_rate=0.3), 64),
    "efficientnet": (ModelConfig(family="efficientnet", width_mult=0.5,
                                 depth_mult=0.5, num_classes=3,
                                 hidden_dim=16, image_size=32,
                                 compute_dtype="float32", dropout_rate=0.2,
                                 stochastic_depth=0.2), 40)}


@pytest.mark.parametrize("family", sorted(_WORLD1_MODELS))
@pytest.mark.parametrize("accum", [1, 2])
def test_world1_group_step_equals_the_groupless_step(family, accum):
    cfg, size = _WORLD1_MODELS[family]
    images = torch.from_numpy(uint8_images(3, 8, size))
    labels = torch.from_numpy(LABELS).long()
    cw = torch.from_numpy(CLASS_WEIGHTS)
    scfg = StepConfig(intensity="medium", out_size=cfg.image_size,
                      compute_dtype=torch.float32, grad_accum=accum,
                      dropout_rate=cfg.dropout_rate)
    feats = init_classifier(cfg, device="cpu").backbone.num_features
    rng = torch.Generator().manual_seed(9)
    rows = 8 // accum
    given = [(torch.rand((rows, feats), generator=rng) < 0.8,
              torch.rand((rows, 16), generator=rng) < 0.8)
             for _ in range(accum)]
    given = given if accum > 1 else given[0]

    def run(mesh, masks):
        model = init_classifier(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        set_mode(model, True)
        if mesh is not None:
            sync_batch_stats(model, mesh.group)
        state = create_train_state(model, TrainConfig(
            grad_accum_steps=accum, batch_size=8), cfg, 1)
        m = train_step(state, images, labels, scfg, cw,
                       torch.Generator().manual_seed(5),
                       dropout_masks=masks, mesh=mesh)
        return float(m["loss"]), model.state_dict()

    distributed.initialize(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        mesh = make_mesh()
        assert mesh.is_process and mesh.size == 1
        for masks in (None, given):
            want_loss, want = run(None, masks)
            loss, got = run(mesh, masks)
            assert loss == want_loss
            for name, t in want.items():
                assert torch.equal(got[name], t), name
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()


def test_fit_final_and_extraction_over_two_ranks(tmp_path):
    cfg = dataclasses.replace(_cfg(), precision="default")
    images = uint8_images(11, 40, 64)
    labels = (np.arange(40) % 3).astype(np.int32)
    counts = np.bincount(labels[:32], minlength=3)
    info = dict(num_classes=3, class_names=("a", "b", "c"),
                class_weights=tuple(float(32 / (3 * c)) for c in counts),
                class_counts=tuple(int(c) for c in counts),
                total_samples=32)
    feature_model = torch_model(cfg, perturbed_variables(cfg, 8))
    tc = dict(optimizer="adam", learning_rate=1e-3, batch_size=8,
              max_epochs=2, patience=1, train_samples_per_epoch=None,
              eval_samples=None, aug_intensity="low", seed=3)
    outs = _run("fit", str(tmp_path), {
        "cfg": dataclasses.asdict(cfg), "train": tc, "mode": "hbm",
        "dir": str(tmp_path), "class_names": ["a", "b", "c"],
        "train_images": images[:32], "train_labels": labels[:32],
        "val_images": images[32:], "val_labels": labels[32:],
        "info": info, "feature_weights": feature_model.state_dict(),
        "final_params": {"learning_rate": 1e-3, "weight_decay": 1e-4,
                         "batch_size": 8, "max_epochs": 3,
                         "dropout_rate": 0.0,
                         "augmentation_intensity": "low"}})
    h0, h1 = outs[0]["history"], outs[1]["history"]
    assert len(h0["val_acc"]) == len(h1["val_acc"]) >= 1
    assert h0["val_acc"] == h1["val_acc"] and h0["val_loss"] == h1["val_loss"]
    assert h0["train_loss"] == h1["train_loss"]
    assert outs[0]["best"] == outs[1]["best"]
    # rank 0 logged every epoch's validation accuracy, rank 1 nothing
    assert outs[0]["val_acc_logged"] == h0["val_acc"]
    assert outs[1]["val_acc_logged"] == []
    for name, t in outs[0]["final_state"].items():
        assert torch.equal(t, outs[1]["final_state"][name]), name
    assert outs[0]["final_acc"] == outs[1]["final_acc"]
    assert outs[0]["final_run"] and outs[1]["final_run"] is None
    ckpt0, ckpt1 = tmp_path / "ckpt0", tmp_path / "ckpt1"
    assert (ckpt0 / "final_model.npz").exists()
    assert not ckpt1.exists()
    # the final run's tracking run: rank 0's only
    assert len(TrackingClient(str(tmp_path / "mlruns0")).search_runs(
        "dp_final")) == 1
    assert TrackingClient(str(tmp_path / "mlruns1")).get_experiment_by_name(
        "dp_final") is None
    for out in outs:
        np.testing.assert_allclose(out["features"],
                                   outs[0]["features_single"], rtol=0,
                                   atol=1e-5)
