"""Train-mode BatchNorm of the port against flax's (the JAX package's
ResNet uses flax ``nn.BatchNorm``, momentum 0.9 in flax's convention).

flax moves ``ra_var`` toward the biased batch variance E[x^2] - E[x]^2;
``F.batch_norm`` in train mode moves ``running_var`` toward the unbiased
one (n / (n - 1) larger).  With n = 16 values per channel that is a
relative gap of 0.1 / 15 in one update, far above the bars here.

- One layer, the same input: output and running stats within 1e-6 of the
  largest magnitude of each tensor.
- Every BatchNorm of a ResNet18 in one train-mode forward, each given the
  input the port's layer saw (captured by a hook) and run through flax's
  layer with the same parameters and statistics: the stats the port wrote
  within 1e-6 relative in 'trainable_only' (layer4's five layers) and the
  layers that update them are the JAX package's (layer4 only, or all).
  In 'all' the stem and layer1-3 reduce up to 4096 values a channel, and
  E[x^2] - E[x]^2 summed in two f32 orders differs by up to 1.06e-6 of the
  variance (layer2.0.bn1), so the bar there is 2e-6.
- The whole forward from the same weights: the stats within 1e-6 relative
  for 'trainable_only'; for 'all' every layer's input already differs by
  the f32 summation order of the convolutions before it (up to 17 convs
  deep), and the bar is 4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import get_classifier as jax_get
from irp_tpu_torch.models.convert import state_dict_to_jax_variables
from irp_tpu_torch.models.resnet import BatchNorm2d

from tests.torch_jax_train import perturbed_variables, torch_model

torch.set_num_threads(1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flax_bn(x_nhwc, scale, bias, mean, var):
    """flax's BatchNorm in train mode as the JAX package's ResNet builds
    it: (output, new mean, new var)."""
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32, param_dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean),
                                 "var": jnp.asarray(var)}}
    y, mut = bn.apply(variables, jnp.asarray(x_nhwc),
                      mutable=["batch_stats"])
    return (np.asarray(y), np.asarray(mut["batch_stats"]["mean"]),
            np.asarray(mut["batch_stats"]["var"]))


def test_batchnorm_layer_train_step_matches_flax():
    rng = np.random.default_rng(0)
    c = 8
    x = rng.normal(0.3, 1.5, (4, 2, 2, c)).astype(np.float32)  # n = 16
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    y_want, mean_want, var_want = _flax_bn(x, scale, bias, mean, var)

    bn = BatchNorm2d(c, torch.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    y = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(y.detach().permute(0, 2, 3, 1).numpy(), y_want) <= 1e-6
    assert _rel(bn.running_mean.numpy(), mean_want) <= 1e-6
    assert _rel(bn.running_var.numpy(), var_want) <= 1e-6
    # eval form reads the updated stats and changes nothing
    before = bn.running_var.clone()
    bn.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(bn.running_var, before)


def _cfg(mode: str) -> JaxModelConfig:
    return JaxModelConfig(depth=18, num_classes=3, image_size=64,
                          compute_dtype="float32", precision="highest",
                          bn_stats_mode=mode)


def _inputs():
    return np.random.default_rng(2).uniform(
        -1, 1, (4, 64, 64, 3)).astype(np.float32)


def _port_forward(cfg, variables, x, hook=None):
    model = torch_model(cfg, variables).train()
    handles = []
    if hook is not None:
        handles = [m.register_forward_pre_hook(hook(name))
                   for name, m in model.named_modules()
                   if isinstance(m, BatchNorm2d)]
    with torch.no_grad():  # the head's dropout does not touch BN stats
        model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    for h in handles:
        h.remove()
    return model


@pytest.mark.parametrize("mode,tol", [("trainable_only", 1e-6),
                                      ("all", 2e-6)])
def test_every_batchnorm_updates_as_flax_given_its_input(mode, tol):
    cfg = _cfg(mode)
    variables = perturbed_variables(cfg, 0)
    before = {k: v.clone() for k, v in
              torch_model(cfg, variables).state_dict().items()}
    seen = {}

    def hook(name):
        def capture(module, args):
            seen[name] = (args[0].detach().float().permute(0, 2, 3, 1)
                          .numpy().copy(), module.training and
                          not module.frozen)
        return capture

    model = _port_forward(cfg, variables, _inputs(), hook)
    sd = model.state_dict()
    updated = sorted(n for n, (_, upd) in seen.items() if upd)
    if mode == "trainable_only":
        assert updated and all(n.startswith("backbone.layer4.")
                               for n in updated)
    else:
        assert len(updated) == len(seen)
    for name, (x_in, upd) in seen.items():
        mean_b, var_b = (before[f"{name}.running_mean"].numpy(),
                         before[f"{name}.running_var"].numpy())
        if not upd:
            assert torch.equal(sd[f"{name}.running_var"],
                               before[f"{name}.running_var"])
            continue
        _, mean_w, var_w = _flax_bn(
            x_in, before[f"{name}.weight"].numpy(),
            before[f"{name}.bias"].numpy(), mean_b, var_b)
        assert _rel(sd[f"{name}.running_mean"].numpy(), mean_w) <= tol, name
        assert _rel(sd[f"{name}.running_var"].numpy(), var_w) <= tol, name


@pytest.mark.parametrize("mode,tol", [("trainable_only", 1e-6),
                                      ("all", 4e-6)])
def test_running_stats_after_train_forward_match_jax(mode, tol):
    cfg = _cfg(mode)
    variables = perturbed_variables(cfg, 0)
    x = _inputs()
    _, mutated = jax_get(cfg).apply(
        variables, jnp.asarray(x), train=True, dropout_rate=0.0,
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    want = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    got = state_dict_to_jax_variables(
        _port_forward(cfg, variables, x).state_dict())["batch_stats"]
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    changed = 0
    for (path, g), w, b in zip(flat_got, flat_want,
                               jax.tree_util.tree_leaves(
                                   variables["batch_stats"])):
        assert _rel(g, w) <= tol, jax.tree_util.keystr(path)
        changed += int(not np.array_equal(w, b))
    # layer4's 5 BN layers (x2 stats) or all 20
    assert changed == (10 if mode == "trainable_only" else 40)
