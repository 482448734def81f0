"""Losses, schedules, the trainable mask and the optimizers of the port
against the JAX package's (``models/classifier.py``, ``ops/schedules.py``,
``train/state.py``).

Bars: losses within 1e-6 (f32); the lr at every step of a schedule within
1e-6 of its peak (both compute in float32; where the curve's last leg
cancels against its end value the two compilers' roundings differ by an
ulp of that value, 1.5e-6 of a 4e-5 lr at step 0);
parameters after six optimizer steps from the same gradients within 1e-6
of optax's, for adam, adamw and sgd, with the EMA on; the
optimizer state carried across by ``optax_state_to_optimizer_state``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.config import TrainConfig as JaxTrainConfig
from irp_tpu.models.classifier import (
    mixed_weighted_cross_entropy as jax_mixed_ce,
    weighted_cross_entropy as jax_ce)
from irp_tpu.ops import schedules as jsched
from irp_tpu.train import state as jstate
from irp_tpu_torch.config import ModelConfig, TrainConfig
from irp_tpu_torch.models.classifier import (mixed_weighted_cross_entropy,
                                             weighted_cross_entropy)
from irp_tpu_torch.models.convert import (flax_param_name,
                                          optax_state_to_optimizer_state)
from irp_tpu_torch.ops import schedules as tsched
from irp_tpu_torch.train import state as tstate

from tests.torch_jax_train import perturbed_variables, torch_model

torch.set_num_threads(1)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("denom", [None, 20.0])
def test_weighted_cross_entropy_matches_jax(weighted, smoothing, denom):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (16, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 16).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, 5).astype(np.float32) if weighted else None
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), cw,
                        smoothing, denom=denom))
    got = float(weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if cw is None else torch.from_numpy(cw), smoothing,
        denom=denom))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    lam = 0.3
    want = float(jax_mixed_ce(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(labels[::-1].copy()),
                              jnp.float32(lam), cw, smoothing, denom, denom))
    got = float(mixed_weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(labels[::-1].copy()), lam,
        None if cw is None else torch.from_numpy(cw), smoothing, denom,
        denom))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("total", [4, 7, 64, 480])
def test_schedules_match_jax_at_every_step(total):
    pairs = [(1e-3, jsched.onecycle_cosine(1e-3, total),
              tsched.onecycle_cosine(1e-3, total)),
             (2e-3, jsched.cosine_anneal(2e-3, total),
              tsched.cosine_anneal(2e-3, total)),
             (5e-4, jsched.constant(5e-4), tsched.constant(5e-4))]
    counts = np.arange(total + 3)
    for peak, jfn, tfn in pairs:
        want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(counts)))
        got = np.array([tfn(int(c)) for c in counts], np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)


@pytest.mark.parametrize("schedule", ["onecycle", "cosine", "constant"])
def test_epoch_mode_schedule_shape_matches_jax(schedule):
    want = jstate._schedule_shape(schedule, 5, 7, "epoch")
    got = tstate._schedule_shape(schedule, 5, 7, "epoch")
    for count in range(40):
        assert abs(got(count) - float(want(count))) <= 1e-6


@pytest.mark.parametrize("stages,head_only", [(("layer4",), False),
                                              (("layer3", "layer4"), False),
                                              (("layer4",), True)])
def test_trainable_mask_matches_jax(stages, head_only):
    jcfg = JaxModelConfig(depth=18, num_classes=3, image_size=32,
                          compute_dtype="float32", trainable_stages=stages,
                          head_only=head_only)
    variables = perturbed_variables(jcfg, 0)
    mask = jstate.trainable_mask(variables["params"], jcfg)
    want = {flax_param_name([p.key for p in path])[0]: bool(m) for path, m
            in jax.tree_util.tree_leaves_with_path(mask)}
    model = torch_model(jcfg, variables)
    got = tstate.trainable_mask(model, ModelConfig(**dataclasses.asdict(
        jcfg)))
    assert got == want
    # the module marks the same set for autograd
    assert {n: p.requires_grad for n, p in model.named_parameters()} == want


def _flat_grads(params, rng):
    return jax.tree_util.tree_map(
        lambda p: rng.normal(0, 1e-2, p.shape).astype(np.float32), params)


@pytest.mark.parametrize("kind,schedule", [("adam", "onecycle"),
                                           ("adamw", "cosine"),
                                           ("sgd", "onecycle")])
def test_optimizer_from_the_same_grads_matches_optax(kind, schedule):
    # layer1 and the head train: 0.15M parameters of ResNet18's 11M
    jcfg = JaxModelConfig(depth=18, num_classes=3, image_size=32,
                          compute_dtype="float32",
                          trainable_stages=("layer1",))
    jtc = JaxTrainConfig(optimizer=kind, schedule=schedule,
                         learning_rate=3e-3, weight_decay=1e-2,
                         max_epochs=2, ema_decay=0.9)
    variables = perturbed_variables(jcfg, 0)
    tx = jstate.make_optimizer(jtc, jcfg, 3)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = jstate.set_opt_hyperparams(tx.init(params), 3e-3, 1e-2)
    model = torch_model(jcfg, variables)
    opt = tstate.make_optimizer(model, TrainConfig(**dataclasses.asdict(jtc)),
                                ModelConfig(**dataclasses.asdict(jcfg)), 3)
    rng = np.random.default_rng(1)
    update = jax.jit(tx.update)
    for _ in range(6):
        grads = _flat_grads(variables["params"], rng)
        updates, opt_state = update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            name, layout = flax_param_name([p.key for p in path])
            if name in opt.params:
                opt.params[name].grad = torch.from_numpy(
                    np.array(layout(g)))
        opt.step()
    sd = model.state_dict()
    for path, p in jax.tree_util.tree_leaves_with_path(params):
        name, layout = flax_param_name([k.key for k in path])
        np.testing.assert_allclose(sd[name].numpy(),
                                   np.array(layout(np.asarray(p))),
                                   rtol=0, atol=1e-6, err_msg=name)
    # the state carried across from optax equals the port's own
    carried = optax_state_to_optimizer_state(
        jax.tree_util.tree_map(np.asarray, opt_state))
    own = opt.state_dict()
    assert carried["count"] == own["count"] == 6
    assert carried["learning_rate"] == pytest.approx(3e-3)
    assert set(carried["moments"]) == set(own["moments"])
    for kind_, tensors in own["moments"].items():
        assert set(carried["moments"][kind_]) == set(tensors)
        for n, t in tensors.items():
            torch.testing.assert_close(carried["moments"][kind_][n], t,
                                       rtol=0, atol=1e-6)
    for n, t in own["ema"].items():
        torch.testing.assert_close(carried["ema"][n], t, rtol=0, atol=1e-6)
    # and loads into a fresh optimizer
    fresh = tstate.make_optimizer(
        torch_model(jcfg, variables), TrainConfig(**dataclasses.asdict(jtc)),
        ModelConfig(**dataclasses.asdict(jcfg)), 3)
    fresh.load_state_dict(carried)
    assert fresh.count == 6


def test_bn_stats_ema_and_eval_view():
    jcfg = JaxModelConfig(depth=18, num_classes=3, image_size=32,
                          compute_dtype="float32")
    model = torch_model(jcfg, perturbed_variables(jcfg, 0))
    tc = TrainConfig(ema_decay=0.5, optimizer="sgd", schedule="constant",
                     learning_rate=0.1, weight_decay=0.0)
    state = tstate.create_train_state(
        model, tc, ModelConfig(**dataclasses.asdict(jcfg)), 1)
    name = "backbone.layer4.0.bn1.running_mean"
    ema0 = state.ema_batch_stats[name].clone()
    live = dict(model.named_buffers())[name]
    with torch.no_grad():
        live.add_(1.0)
    state.with_batch_stats()
    torch.testing.assert_close(state.ema_batch_stats[name], ema0 + 0.5)
    # frozen BN stats are not tracked; the trainable ones are
    assert all(n.startswith("backbone.layer4.")
               for n in state.ema_batch_stats)
    p = state.optimizer.params["classifier.4.bias"]
    p.grad = torch.ones_like(p)
    before = p.detach().clone()
    state.apply_gradients()
    torch.testing.assert_close(p.detach(), before - 0.1)
    torch.testing.assert_close(state.optimizer.ema["classifier.4.bias"],
                               before - 0.05)
    with state.eval_view() as m:
        torch.testing.assert_close(dict(m.named_parameters())[
            "classifier.4.bias"].detach(), before - 0.05)
    torch.testing.assert_close(p.detach(), before - 0.1)


def _optimizer(kind, device="cpu"):
    jcfg = JaxModelConfig(depth=18, num_classes=3, image_size=32,
                          compute_dtype="float32",
                          trainable_stages=("layer4",))
    model = torch_model(jcfg, perturbed_variables(jcfg, 0)).to(device)
    tc = TrainConfig(optimizer=kind, schedule="onecycle", learning_rate=3e-3,
                     weight_decay=1e-2, max_epochs=2, ema_decay=0.9)
    return model, tstate.make_optimizer(
        model, tc, ModelConfig(**dataclasses.asdict(jcfg)), 3)


def _grad_steps(opt, rng, n):
    for _ in range(n):
        for p in opt.params.values():
            p.grad = torch.from_numpy(
                rng.normal(0, 1e-2, tuple(p.shape)).astype(np.float32)).to(
                    p.device)
        opt.step()


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_optimizer_state_round_trip_resumes_bit_exact(kind):
    """The moments live in the torch optimizer's state (exp_avg /
    exp_avg_sq / momentum_buffer); a fresh optimizer loaded from a
    mid-run state_dict continues bit for bit as the uninterrupted one."""
    model, opt = _optimizer(kind)
    _grad_steps(opt, np.random.default_rng(0), 3)
    slots = ("momentum_buffer",) if kind == "sgd" else ("exp_avg",
                                                        "exp_avg_sq")
    p = next(iter(opt.params.values()))
    for slot, view in zip(slots, opt.moments.values()):
        assert torch.equal(opt.torch_opt.state[p][slot],
                           next(iter(view.values())))
    saved = opt.state_dict()
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    _grad_steps(opt, np.random.default_rng(1), 3)
    model2, opt2 = _optimizer(kind)
    model2.load_state_dict(weights)
    opt2.load_state_dict(saved)
    _grad_steps(opt2, np.random.default_rng(1), 3)
    assert opt2.count == opt.count == 6
    for (n, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), n
    for n, t in opt.ema.items():
        assert torch.equal(t, opt2.ema[n]), n

