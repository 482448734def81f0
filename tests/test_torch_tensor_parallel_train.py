"""The port's tensor-parallel train step in real gloo ranks
(tests/torch_dist_child.py, one rank each, the CPU) against the JAX
package's ``make_hbm_train_step`` on the same (data, model) mesh of the
8 virtual CPU devices, with the JAX package's draws fed in.

One SGD step at lr 1 (the update is minus the gradient), f32, class
weights on, the global batch of 8 sorted so that the data indices hold
different classes; ResNet18/56 (head TP, layer4 trainable) and the tiny
ViT (every block TP, the last block and the final LayerNorm trainable),
weights with nonzero biases; over 1 x 2 (2 ranks) and 2 x 2 (4 ranks)
meshes, with mixup on and with ``grad_accum_steps=2``.  The bars are
tests/test_torch_distributed.py's: the loss within 1e-5 relative, every
trainable tensor's update within 2e-5 of its max |update|, BN statistics
within 1e-5 relative; every rank ends with the same whole weights, bit
for bit.

Each step runs again with a fault planted in the ranks (``_planted`` in
tests/torch_dist_child.py): *g* with an all-reduce backward (gradients
upstream of a row layer times M), *f* without its backward reduce (the
replicated layers upstream of a column layer get one shard's share), the
row bias added before the reduce (M biases), and the gradients summed
over the world instead of the data group.  Each misses the update bar by
at least 10x.

On the 1 x 2 ViT case the step also runs with dropout 0.3 drawn from a
seeded generator, against the port's one-process step from the same
generator (the masks are the whole hidden width's, sliced to the rank's
columns, so the draws do not depend on M), and with remat of the
trainable block (its recompute repeats the model group's collectives),
against the plain TP step.
"""

import dataclasses

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
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from irp_tpu.parallel.mesh import shard_variables as jax_shard
from irp_tpu.train.state import create_train_state as jax_state
from irp_tpu.train.step import make_hbm_train_step
from irp_tpu_torch.config import ModelConfig, TrainConfig
from irp_tpu_torch.models.convert import (flax_tree_to_named,
                                          jax_variables_to_state_dict)
from irp_tpu_torch.models.classifier import get_classifier
from irp_tpu_torch.ops.mix import MixDraws
from irp_tpu_torch.train.loop import set_mode
from irp_tpu_torch.train.state import create_train_state
from irp_tpu_torch.train.step import StepConfig, train_step

from tests.torch_dist_child import launch
from tests.torch_jax_train import (jax_augment_draws, perturbed_variables,
                                   uint8_images)

torch.set_num_threads(1)
CLASS_WEIGHTS = np.asarray([0.7, 1.6, 1.1], np.float32)
LABELS = np.asarray([0, 0, 0, 0, 1, 2, 1, 2], np.int32)  # sorted by data index
LOSS_TOL = 1e-5  # tests/test_torch_distributed.py's bars
UPDATE_TOL = 2e-5
FAULT_X = 10.0  # a planted fault misses UPDATE_TOL by at least this
FAULTS = ("g_backward", "f_forward_only", "bias_first", "world_grads")
GEN_SEED = 5
FAMILIES = {
    "resnet": (JaxModelConfig(depth=18, num_classes=3, image_size=56,
                              hidden_dim=16, compute_dtype="float32",
                              precision="highest", dropout_rate=0.0), 64),
    "vit": (JaxModelConfig(family="vit", patch_size=8, embed_dim=128,
                           num_layers=2, mlp_dim=256, num_classes=3,
                           hidden_dim=32, image_size=32, dropout_rate=0.0,
                           compute_dtype="float32", precision="highest"),
            40)}


def _variables(family):
    """Numpy variables with nonzero biases everywhere a fault could hide
    behind a 0: ResNet18's BN perturbed and its head's biases redrawn;
    the ViT's every leaf redrawn as tests/torch_jax_families.py draws
    them (kernels at 1/sqrt(fan-in), LayerNorm scales near 1: at a flat
    0.05 a block's weight gradients are of the size of f32 rounding)."""
    cfg, _ = FAMILIES[family]
    rng = np.random.RandomState(11)
    if family == "resnet":
        v = jax.tree_util.tree_map(np.copy, perturbed_variables(cfg, 6))
        for dense in ("head_dense1", "head_dense2"):
            b = v["params"][dense]["bias"]
            v["params"][dense]["bias"] = rng.normal(0, 0.05, b.shape).astype(
                np.float32)
        return v
    _, v = jax_init(cfg, jax.random.PRNGKey(0), cfg.image_size)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":  # signal-preserving: std 1 / sqrt(fan-in)
            std = float(np.prod(a.shape[:-1])) ** -0.5
        elif name in ("class_token", "pos_embedding"):
            std = 0.5
        else:
            std = 0.05
        out = rng.normal(0.0, std, a.shape)
        return (out + (name == "scale")).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, v)


def _jax_step(cfg, variables, images, key, tc, mixup, accum, data):
    mesh = jax_make_mesh(JaxMeshConfig(data=data, model=2),
                         devices=jax.devices()[:2 * data])
    state = jax_state(jax_get(cfg), jax_shard(mesh, jax.tree_util.tree_map(
        jnp.asarray, variables)), JaxTrainConfig(**tc), cfg, 1)
    b = 8 // data
    step = make_hbm_train_step(mesh, b, jnp.asarray(CLASS_WEIGHTS), "medium",
                               out_size=cfg.image_size,
                               compute_dtype=jnp.float32, mixup_alpha=mixup,
                               grad_accum=accum)
    spec = NamedSharding(mesh, P("data"))
    new_state, metrics = step(
        state, jax.device_put(images.reshape((data, b) + images.shape[1:]),
                              spec),
        jax.device_put(LABELS.reshape(data, b), spec), jnp.int32(0), key,
        0.0)
    stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
    return (float(metrics["loss"]), float(metrics["accuracy"]),
            {k: v.numpy() for k, v in flax_tree_to_named(
                jax.tree_util.tree_map(np.asarray, new_state.params)).items()},
            stats)


def _draws(key, mixup, size):
    if mixup:
        aug_key, mix_key, _ = jax.random.split(key, 3)
        _, k_mix, _, _ = jax.random.split(mix_key, 4)
        mix = MixDraws(lam_mixup=float(jax.random.beta(k_mix, mixup,
                                                       mixup)))
    else:
        aug_key, _ = jax.random.split(key)
        mix = None
    return jax_augment_draws(aug_key, "medium", 8, size, size), mix


def _port_step(cfg, state_dict, images, draws, mix, mixup, accum,
               dropout_rate):
    """The port's one-process step on the whole batch, dropout drawn from
    the seeded generator as the ranks draw it."""
    pcfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(cfg)),
                               dropout_rate=dropout_rate)
    model = get_classifier(pcfg, device="cpu")
    model.load_state_dict(state_dict)
    set_mode(model, True)
    state = create_train_state(model, TrainConfig(
        optimizer="sgd", schedule="constant", learning_rate=1.0,
        weight_decay=0.0, grad_accum_steps=accum, batch_size=8), pcfg, 1)
    scfg = StepConfig(intensity="medium", out_size=cfg.image_size,
                      compute_dtype=torch.float32, mixup_alpha=mixup,
                      grad_accum=accum, dropout_rate=dropout_rate)
    m = train_step(state, torch.from_numpy(images),
                   torch.from_numpy(LABELS).long(), scfg,
                   torch.from_numpy(CLASS_WEIGHTS),
                   torch.Generator().manual_seed(GEN_SEED), aug_draws=draws,
                   mix_draws=mix)
    return float(m["loss"]), model.state_dict()


CASES = [("resnet", 2, 0.0, 1), ("vit", 2, 0.4, 1), ("resnet", 4, 0.4, 1),
         ("vit", 4, 0.0, 2)]
BN = ("backbone.layer4.1.bn2.running_mean", "backbone.layer4.1.bn2.running_var")


@pytest.mark.parametrize("family,world,mixup,accum", CASES,
                         ids=[f"{f}-{w // 2}x2-mixup{m}-accum{a}"
                              for f, w, m, a in CASES])
def test_tensor_parallel_step_matches_jax(tmp_path, family, world, mixup,
                                          accum):
    cfg, size = FAMILIES[family]
    data = world // 2
    variables = _variables(family)
    images = uint8_images(9, 8, size)
    key = jax.random.PRNGKey(17)
    tc = dict(optimizer="sgd", schedule="constant", learning_rate=1.0,
              weight_decay=0.0, grad_accum_steps=accum, batch_size=8)
    want_loss, want_acc, want, stats = _jax_step(
        cfg, variables, images, key, tc, mixup, accum, data)
    draws, mix = _draws(key, mixup, size)
    state_dict = jax_variables_to_state_dict(variables, cfg.depth)
    model = get_classifier(ModelConfig(**dataclasses.asdict(cfg)),
                           device="cpu")
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert trainable and all(np.array_equal(want[n], state_dict[n].numpy())
                             for n in frozen)
    extra = (family, world) == ("vit", 2)
    if extra:  # the port's one-process step, dropout from the generator
        one_loss, one = _port_step(cfg, state_dict, images, draws, mix,
                                   mixup, accum, 0.3)
    bn_keys = BN if family == "resnet" else ()
    outs = launch("tp_step", str(tmp_path), {
        "cfg": dataclasses.asdict(cfg), "state_dict": state_dict,
        "train": tc, "images": torch.from_numpy(images),
        "labels": torch.from_numpy(LABELS),
        "class_weights": torch.from_numpy(CLASS_WEIGHTS),
        "aug_draws": draws, "mix_draws": mix, "mixup": mixup,
        "accum": accum, "faults": FAULTS, "generator_seed": GEN_SEED,
        "trainable": trainable, "bn_keys": bn_keys,
        "want": {n: torch.from_numpy(want[n]) for n in trainable},
        "want_dropout": ({n: one[n] for n in trainable} if extra
                         else None)}, world=world)
    got = outs[0]["clean"]
    for out in outs[1:]:  # the planted faults' ranks may part
        for run in set(out) - set(FAULTS):
            assert out[run]["digest"] == outs[0][run]["digest"], run
    assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
    assert got["accuracy"] == pytest.approx(want_acc)
    assert got["frozen_unchanged"]
    assert got["gap"] <= UPDATE_TOL, got["gap"]
    if family == "resnet":
        blk = stats["backbone"]["layer4_block1"]["bn2"]
        for field, key in zip(("mean", "var"), BN):
            a = got["bn"][key].numpy()
            assert np.abs(a - blk[field]).max() <= LOSS_TOL * np.abs(
                blk[field]).max(), key
    for fault in FAULTS:
        miss = outs[0][fault]["gap"]
        assert miss >= FAULT_X * UPDATE_TOL, (fault, miss)
    if not extra:
        return
    # dropout drawn by the ranks from the generator = the one-process draws
    drop = outs[0]["dropout"]
    assert abs(drop["loss"] - one_loss) <= LOSS_TOL * abs(one_loss)
    assert drop["gap"] <= UPDATE_TOL
    assert drop["loss"] != got["loss"]  # the masks did drop
    # remat repeats the collectives in the recompute: the plain step
    assert outs[0]["remat"]["loss"] == got["loss"]
    assert outs[0]["remat"]["gap"] <= 1e-6
