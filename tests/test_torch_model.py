"""Port parity: ResNet + MLP-head classifier (irp_tpu_torch/models/) against
the JAX package's Classifier, with the JAX variables carried across by
jax_variables_to_state_dict.

f32 logits are held at the repo's fidelity bar (max |diff| <= 1e-3,
run_fidelity.py); the fused bf16 path at the JAX package's own fused-vs-
unfused bar (rtol/atol 0.05, tests/test_pallas_resnet.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.train.checkpoint import export_torch_pth
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import Classifier, get_classifier
from irp_tpu_torch.models.convert import (jax_variables_to_state_dict,
                                          state_dict_to_jax_variables)

torch.set_num_threads(1)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed_variables(cfg: JaxModelConfig, seed: int):
    """JAX init_classifier variables with BN affine and running stats
    perturbed from a numpy seed (identity BN would hide layout bugs)."""
    _, variables = jax_init(cfg, jax.random.PRNGKey(seed),
                            image_size=cfg.image_size)
    variables = _numpy_tree(variables)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name:
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "bn" in name and "'scale'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "bn" in name and "'bias'" in name:
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _jax_logits(cfg: JaxModelConfig, variables, x_nhwc):
    from irp_tpu.models.classifier import get_classifier as jax_get

    model = jax_get(cfg)
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return np.asarray(fwd(variables, jnp.asarray(x_nhwc)))


def _torch_model(cfg: JaxModelConfig, variables) -> Classifier:
    model = get_classifier(ModelConfig(**dataclasses.asdict(cfg)),
                           device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg.depth))
    return model.eval()


def _torch_logits(model, x_nhwc):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.inference_mode():
        return model(x.contiguous(memory_format=torch.channels_last)).numpy()


def _inputs(seed, size, n=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("depth,size", [(18, 56), (50, 64)])
def test_f32_logits_match_jax(depth, size):
    cfg = JaxModelConfig(depth=depth, num_classes=5, image_size=size,
                         hidden_dim=32, compute_dtype="float32",
                         precision="highest")
    variables = _perturbed_variables(cfg, depth)
    x = _inputs(depth, size)
    want = _jax_logits(cfg, variables, x)
    got = _torch_logits(_torch_model(cfg, variables), x)
    assert got.shape == want.shape == (2, 5)
    assert np.abs(got - want).max() <= 1e-3


@pytest.fixture(scope="module")
def fused_pair():
    """ResNet50/64 bf16 variables + the JAX logits with the fused kernel
    forced on (Pallas interpret mode on the CPU)."""
    cfg = JaxModelConfig(depth=50, num_classes=3, image_size=64,
                         fused_frozen_blocks="on")
    variables = _perturbed_variables(cfg, 7)
    x = _inputs(7, 64)
    return cfg, variables, x, _jax_logits(cfg, variables, x)


def test_bf16_fused_logits_match_jax_fused(fused_pair):
    cfg, variables, x, want = fused_pair
    model = _torch_model(cfg, variables)
    assert model.backbone.fuse_active(torch.zeros(1))  # 'on' on the CPU
    got = _torch_logits(model, x)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_fused_and_unfused_share_the_state_dict(fused_pair):
    cfg, variables, x, _ = fused_pair
    on = _torch_model(cfg, variables)
    off = _torch_model(dataclasses.replace(cfg, fused_frozen_blocks="off"),
                       variables)
    assert {k: v.shape for k, v in on.state_dict().items()} == \
        {k: v.shape for k, v in off.state_dict().items()}
    fusable = [name for name, mod in on.named_modules()
               if getattr(mod, "fusable", False)]
    # the 10 frozen identity bottlenecks of layers 1-3
    assert len(fusable) == 10
    np.testing.assert_allclose(_torch_logits(on, x), _torch_logits(off, x),
                               rtol=0.05, atol=0.05)


def test_cached_folded_weights_match_and_are_dropped(fused_pair):
    """cache_folded_weights() gives the same fused logits as folding per
    call; train() and load_state_dict drop the cache."""
    cfg, variables, x, _ = fused_pair
    model = _torch_model(cfg, variables)
    blocks = [m for m in model.modules() if getattr(m, "fusable", False)]
    per_call = _torch_logits(model, x)
    model.backbone.cache_folded_weights()
    assert all(b._folded is not None for b in blocks)
    np.testing.assert_array_equal(_torch_logits(model, x), per_call)
    model.train()
    assert all(b._folded is None for b in blocks)
    model.eval().backbone.cache_folded_weights()
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg.depth))
    assert all(b._folded is None for b in blocks)


def test_export_torch_pth_loads_strict(tmp_path):
    cfg = JaxModelConfig(depth=18, num_classes=4, image_size=56,
                         hidden_dim=16, compute_dtype="float32")
    variables = _perturbed_variables(cfg, 3)
    path = export_torch_pth(str(tmp_path / "m.pth"), variables["params"],
                            variables["batch_stats"], depth=18)
    model = get_classifier(ModelConfig(**dataclasses.asdict(cfg)),
                           device="cpu")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    converted = _torch_model(cfg, variables)
    x = _inputs(3, 56)
    np.testing.assert_array_equal(_torch_logits(model.eval(), x),
                                  _torch_logits(converted, x))


def test_state_dict_round_trip_is_exact():
    cfg = JaxModelConfig(depth=50, num_classes=3, image_size=64,
                         hidden_dim=8)
    variables = _perturbed_variables(cfg, 5)
    back = state_dict_to_jax_variables(
        jax_variables_to_state_dict(variables, 50))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_model_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    assert ours == theirs


def test_frozen_bn_stays_in_inference_form_under_train():
    """bn_stats_mode='trainable_only': frozen stages ignore .train(); with
    every stage frozen and dropout 0, train() and eval() agree."""
    cfg = ModelConfig(depth=18, num_classes=3, image_size=32, hidden_dim=8,
                      compute_dtype="float32", head_only=True,
                      dropout_rate=0.0)
    gen = torch.Generator().manual_seed(0)
    model = Classifier(cfg)
    model.init_weights(gen)
    x = torch.randn(4, 3, 32, 32, generator=gen)
    stats = model.backbone.bn1.running_mean.clone()
    with torch.no_grad():
        eval_logits = model.eval()(x)
        train_logits = model.train()(x)
    torch.testing.assert_close(train_logits, eval_logits)
    torch.testing.assert_close(model.backbone.bn1.running_mean, stats)
    all_mode = Classifier(dataclasses.replace(cfg, bn_stats_mode="all"))
    assert not any(getattr(m, "frozen", True) for m in all_mode.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("family", ["vit", "efficientnet", "convnext"])
def test_families_train_mode_forward_and_backward(family):
    """The other families train: in train mode the forward draws its
    stochastic-depth and dropout masks from the generator, reproducibly,
    and the backward reaches exactly the trainable parameters (the family's
    default stages and the head); the eval form is unchanged by it."""
    small = {"vit": dict(patch_size=8, embed_dim=64, num_layers=2,
                         mlp_dim=128),
             "efficientnet": dict(width_mult=0.5, depth_mult=0.5),
             "convnext": dict(convnext_dims=(8, 16, 24, 32),
                              convnext_depths=(1, 1, 1, 1))}[family]
    model = Classifier(ModelConfig(family=family, image_size=32,
                                   compute_dtype="float32",
                                   bn_stats_mode="all", **small))
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        eval_logits = model.eval()(x)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    runs = []
    for _ in range(2):
        model.load_state_dict(state)
        logits = model(x, generator=torch.Generator().manual_seed(2))
        runs.append(logits.detach())
    assert runs[0].shape == (2, 10) and torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], eval_logits)  # masks and batch stats
    logits.sum().backward()
    grads = {n for n, p in model.named_parameters() if p.grad is not None}
    assert grads == {n for n, p in model.named_parameters()
                     if p.requires_grad}
    assert any(n.startswith("classifier.") for n in grads)
    assert any(n.startswith("backbone.") for n in grads)
    model.load_state_dict(state)
    with torch.no_grad():
        assert torch.equal(model.eval()(x), eval_logits)