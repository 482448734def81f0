"""Training ViT, EfficientNet and ConvNeXt in the port against the JAX
package, at the JAX tests' small configurations
(``tests/torch_jax_families.py``), f32 ``precision='highest'``, with the
weights carried across by ``convert`` and stochastic depth and dropout
above 0.

The JAX package draws its stochastic-depth and dropout masks inside
``apply`` (``jax.random.bernoulli`` under ``make_rng('dropout')``); the
JAX programs here record each mask in call order (the blocks in forward
order, then the head's two) while they trace, return them as outputs,
and the port is given those masks (``sd_masks``, ``dropout_masks``).

- (a) the train-mode forward: logits within 1e-4 (F32_TOL);
- (b) one step: loss within 1e-5 relative, each trainable tensor's
  gradient within 1e-4 of its max|g|, the set of tensors with gradients
  equal to ``trainable_mask``'s True leaves, EfficientNet's BN
  statistics within 1e-5 relative under 'trainable_only' and 'all';
- (c) ``grad_accum_steps=2`` through SGD at lr 1, at the same bars;
- (d) ``requires_grad`` by name equal to ``trainable_mask``;
- (e) each block's drop probability equal to the JAX module's (the two
  families scale differently), the sampler's keep frequency within 4
  sigma of 1 - p, survivors scaled by 1/keep;
- (f) remat: the step equals the plain step to 1e-6, each trainable
  block runs twice;
- (g) three SGD epoch-steps against ``make_hbm_epoch_step`` on one device
  (stochastic depth and dropout 0): parameters within 1e-5;
- (h) a tiny ``fit`` on tests/synth.py shards: the loss falls, and a run
  resumed from its checkpoint is bit-equal to an uninterrupted one;
- and ``models/convert.py`` for every family: ``merge_pretrained`` of a
  JAX-exported ``.pth``, ``flax_param_name`` over every parameter path,
  ``optax_state_to_optimizer_state`` after one update.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irp_tpu.config import TrainConfig as JaxTrainConfig
from irp_tpu.data.pipeline import CachedDataset as JaxCachedDataset
from irp_tpu.data.pipeline import EpochSampler as JaxEpochSampler
from irp_tpu.data.pipeline import HBMDataset as JaxHBMDataset
from irp_tpu.models.classifier import get_classifier as jax_get
from irp_tpu.models.classifier import weighted_cross_entropy as jax_ce
from irp_tpu.parallel.mesh import make_mesh
from irp_tpu.train import state as jstate
from irp_tpu.train.step import _loss_and_updates, make_hbm_epoch_step
from irp_tpu_torch.config import DatasetInfo, TrainConfig
from irp_tpu_torch.data.pipeline import (CachedDataset, EpochSampler,
                                         HBMDataset)
from irp_tpu_torch.models.classifier import Classifier
from irp_tpu_torch.models.convert import (flax_param_name,
                                          flax_tree_to_named,
                                          jax_variables_to_state_dict,
                                          load_torch_checkpoint,
                                          merge_pretrained,
                                          optax_state_to_optimizer_state)
from irp_tpu_torch.models.layers import sample_sd_masks, stochastic_depth
from irp_tpu_torch.train import fit
from irp_tpu_torch.train import state as tstate
from irp_tpu_torch.train.checkpoint import (latest_checkpoint,
                                            save_checkpoint)
from irp_tpu_torch.train.loop import set_mode
from irp_tpu_torch.train.step import (StepConfig, loss_and_grads,
                                      train_step)

from tests import torch_jax_families as fam
from tests.torch_jax_train import jax_step_draws, uint8_images

torch.set_num_threads(1)

FAMILIES = ("vit", "efficientnet", "convnext")
# trainable stages that put blocks with stochastic depth on both sides of
# the cut (and ViT's cut after block 0)
STAGES = {"vit": ("block1", "block2", "ln"),
          "efficientnet": ("stage5", "stage6", "stage7", "top"),
          "convnext": ("stage3", "stage4", "ln")}
CLASS_WEIGHTS = np.asarray([0.7, 1.6, 1.1, 0.9, 1.3], np.float32)
B = 8
# A gradient that is 0 but for rounding: the bias of a BN whose output
# reaches the loss only through a BatchNorm that normalizes it away
# (EfficientNet's stage5_block0 project BN: a per-channel shift passes
# stage5_block1's residual into stage6's expand conv and its batch
# statistics) is 1e-7 of the largest gradient in either package; such a
# tensor is held to vanish below this share of the largest gradient.
VANISHING = 1e-5


def train_cfg(family, bn_stats_mode="trainable_only", **kw):
    """The family's small f32 config with stochastic depth 0.5, dropout
    0.3 and :data:`STAGES` trainable."""
    return dataclasses.replace(
        fam.CONFIGS[family], stochastic_depth=0.5, dropout_rate=0.3,
        trainable_stages=STAGES[family], bn_stats_mode=bn_stats_mode, **kw)


@contextlib.contextmanager
def recording_bernoulli(record: list):
    """While active, every ``jax.random.bernoulli`` result is appended to
    ``record`` (inside a traced program: the traced mask)."""
    orig = jax.random.bernoulli

    def bern(key, p=0.5, shape=None, **kw):
        mask = orig(key, p, shape, **kw)
        record.append(mask)
        return mask

    jax.random.bernoulli = bern
    try:
        yield
    finally:
        jax.random.bernoulli = orig


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def train_variables(family: str, calibration: str = "inputs"):
    """The family's test weights (``fam.jax_variables``); for EfficientNet
    with each BatchNorm's running statistics set to the batch statistics
    of its input on a calibration batch of the data it will see
    (``calibration``: 'inputs', :func:`inputs`' normal images, or
    'dataset', center crops of :func:`_dataset`'s), as a trained
    network's are.

    With the drawn statistics (means N(0, 0.05), variances near 1 while
    the inputs vary by far less), the frozen BNs' outputs are nearly
    constant per channel: at the first BN that uses batch statistics
    after the cut, mean^2 / var reaches 6.6e3, where the E[x^2] - E[x]^2
    variance both packages compute (flax's fast variance) loses about 13
    of f32's 24 bits, and two summation orders part by 2e-4 in the
    logits."""
    variables = fam.jax_variables(family)
    if family != "efficientnet":
        return variables
    from irp_tpu.models.efficientnet import bn_constants

    cfg = dataclasses.replace(fam.CONFIGS[family], bn_stats_mode="all",
                              trainable_stages=("stem",))
    model = jax_get(cfg)
    if calibration == "inputs":
        x = inputs(5, 16)[0]
    else:
        from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

        x = eval_preprocess_batch(torch.from_numpy(_dataset()[1].images[:16]),
                                  fam.SIZE, torch.float32).numpy()
    _, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(jnp_tree(variables), x)
    _, momentum = bn_constants(cfg.width_mult, cfg.depth_mult)
    # new = m * old + (1 - m) * batch
    batch = jax.tree_util.tree_map(
        lambda new, old: ((np.asarray(new, np.float64) - momentum * old)
                          / (1.0 - momentum)).astype(np.float32),
        mutated["batch_stats"], variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": batch}


def inputs(seed: int = 0, b: int = B):
    x = fam.images(seed, n=b)
    labels = (np.arange(b) % 5).astype(np.int32)
    return x, labels


@functools.lru_cache(maxsize=None)
def _jax_step_fn(cfg):
    model = jax_get(cfg)

    def step(params, stats, x, labels, key, cw):
        def loss_fn(p):
            record = []
            with recording_bernoulli(record):
                logits, mutated = model.apply(
                    {"params": p, "batch_stats": stats}, x, train=True,
                    mutable=["batch_stats"], rngs={"dropout": key})
            return jax_ce(logits, labels, cw), (logits, mutated, record)

        (loss, (logits, mutated, record)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return loss, logits, grads, mutated.get("batch_stats", {}), record

    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def jax_step(cfg, seed: int = 0, b: int = B, key_seed: int = 11):
    """The JAX package's f32 train-mode forward and backward on
    :func:`inputs` with class weights: numpy (loss, logits, grads, new
    batch_stats, masks in draw order)."""
    variables = train_variables(cfg.family)
    x, labels = inputs(seed, b)
    out = _jax_step_fn(cfg)(jnp_tree(variables["params"]),
                            jnp_tree(variables["batch_stats"]), x, labels,
                            jax.random.PRNGKey(key_seed),
                            jnp.asarray(CLASS_WEIGHTS))
    return jax.tree_util.tree_map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _jax_masks_fn(cfg):
    model = jax_get(cfg)

    def masks(params, stats, x, key):
        record = []
        with recording_bernoulli(record):
            model.apply({"params": params, "batch_stats": stats}, x,
                        train=True, mutable=["batch_stats"],
                        rngs={"dropout": key})
        return record

    return jax.jit(masks)


def port_masks(model, record):
    """The JAX draws as the port's (sd_masks, dropout_masks)."""
    names = list(model.sd_probs())
    assert len(record) == len(names) + 2
    sd = {n: torch.from_numpy(np.asarray(m).reshape(-1).copy())
          for n, m in zip(names, record)}
    head = tuple(torch.from_numpy(np.asarray(m).copy())
                 for m in record[-2:])
    return sd, head


def port_train_model(cfg, variables=None):
    model = fam.port_model(cfg, variables or train_variables(cfg.family))
    set_mode(model, True)
    return model


def step_config(cfg, accum=1):
    return StepConfig(compute_dtype=torch.float32, grad_accum=accum,
                      dropout_rate=cfg.dropout_rate)


def port_step(cfg, record, seed=0, b=B, model=None):
    """The port's forward and backward on the same inputs and masks:
    (model, loss, logits)."""
    model = model or port_train_model(cfg)
    x, labels = inputs(seed, b)
    sd, head = port_masks(model, record)
    # the logits' forward must not move BN's statistics: the step's does
    stats = {n: t.clone() for n, t in model.named_buffers()}
    with torch.no_grad():
        logits = model(fam.nchw(x), cfg.dropout_rate, head, None, sd)
        for n, t in model.named_buffers():
            t.copy_(stats[n])
    model.zero_grad()
    loss, _ = loss_and_grads(model, torch.from_numpy(x),
                             torch.from_numpy(labels), step_config(cfg),
                             torch.from_numpy(CLASS_WEIGHTS), None, None,
                             None, head, sd)
    return model, float(loss), logits.detach().numpy()


def trainable_names(cfg):
    """The JAX ``trainable_mask``'s True leaves as port names."""
    variables = fam.jax_variables(cfg.family)
    mask = jstate.trainable_mask(variables["params"], cfg)
    out = {}
    for path, m in jax.tree_util.tree_leaves_with_path(mask):
        name, _ = flax_param_name([p.key for p in path], cfg.family)
        out[name] = out.get(name, False) or bool(m)
    return out


def check_stats(model, want_stats, family):
    """Every BN's running statistics against the JAX batch_stats, within
    1e-5 relative; returns how many moved from their start."""
    sd = model.state_dict()
    start = jax_variables_to_state_dict(train_variables(family))
    moved = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_stats):
        keys = [k.key for k in path]
        name, _ = flax_param_name(keys[:-1] + ["scale"], family)
        buf = name[:-len("weight")] + ("running_mean" if keys[-1] == "mean"
                                        else "running_var")
        a, b = sd[buf].numpy(), np.asarray(leaf)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), buf
        moved += int(not np.array_equal(b, start[buf].numpy()))
    return moved


# -- (a) the train-mode forward ----------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_train_forward_matches_jax(family):
    cfg = train_cfg(family)
    _, want, _, _, record = jax_step(cfg)
    _, _, got = port_step(cfg, record)
    assert np.abs(want).max() > 1e-2
    assert fam.max_diff(got, want) <= fam.F32_TOL
    if family != "vit":  # some branches dropped, some kept
        sd = np.concatenate([np.ravel(m) for m in record[:-2]])
        assert sd.any() and not sd.all()
    # .eval() is the eval form: no masks drawn or applied
    model = port_train_model(cfg).eval()
    with torch.no_grad():
        ev = model(fam.nchw(inputs()[0])).numpy()
    assert fam.max_diff(ev, fam.jax_apply(cfg, train_variables(family),
                                          inputs()[0])) <= fam.F32_TOL


# -- (b) one f32 step ----------------------------------------------------------

STEP_CASES = [("vit", "trainable_only"), ("efficientnet", "trainable_only"),
              ("efficientnet", "all"), ("convnext", "trainable_only")]


@pytest.mark.parametrize("family,bn_stats_mode", STEP_CASES)
def test_one_f32_step_matches_jax(family, bn_stats_mode):
    cfg = train_cfg(family, bn_stats_mode)
    want_loss, _, want_grads, want_stats, record = jax_step(cfg)
    model, loss, _ = port_step(cfg, record)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = {n: t.numpy() for n, t in flax_tree_to_named(want_grads).items()}
    mask = trainable_names(cfg)
    with_grad = {n for n, p in model.named_parameters()
                 if p.grad is not None}
    assert with_grad == {n for n, m in mask.items() if m}
    noise = VANISHING * max(np.abs(g).max() for g in want.values())
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        scale = np.abs(want[name]).max()
        if scale <= noise:  # a gradient that vanishes vanishes in both
            assert np.abs(p.grad.numpy()).max() <= noise, name
            continue
        assert np.abs(p.grad.numpy() - want[name]).max() <= 1e-4 * scale, \
            name
    if family == "efficientnet":
        moved = check_stats(model, want_stats, family)
        n_bn = len([m for m in model.modules()
                    if isinstance(m, torch.nn.BatchNorm2d)])
        frozen = len([m for m in model.modules()
                      if getattr(m, "frozen", False)])
        # 'all': every BN collects statistics; 'trainable_only': those
        # after the cut, and the frozen ones stay where they were
        assert (frozen == 0) == (bn_stats_mode == "all")
        assert moved == 2 * (n_bn - frozen)


# -- (c) gradient accumulation -------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_accumulated_step_matches_jax(family):
    """grad_accum_steps=2: SGD at lr 1 (constant, no decay, first step)
    turns the update into minus the accumulated gradient.  The JAX step
    draws each micro-batch's masks under fold_in(key, c)."""
    cfg = train_cfg(family, "all")
    variables = train_variables(family)
    tc = dict(optimizer="sgd", schedule="constant", learning_rate=1.0,
              weight_decay=0.0, grad_accum_steps=2)
    x, labels = inputs(1, 2 * B)
    key = jax.random.PRNGKey(12)
    state = jstate.create_train_state(jax_get(cfg), jnp_tree(variables),
                                      JaxTrainConfig(**tc), cfg, 1)
    new_state, metrics = jax.jit(lambda s, x, y: _loss_and_updates(
        s, x, y, key, jnp.asarray(CLASS_WEIGHTS), grad_accum=2))(
        state, x, labels)
    model = port_train_model(cfg)
    sd_masks, head_masks = [], []
    for c in range(2):
        record = _jax_masks_fn(cfg)(
            jnp_tree(variables["params"]),
            jnp_tree(variables["batch_stats"]), x[c * B:(c + 1) * B],
            jax.random.fold_in(key, c))
        sd, head = port_masks(model, record)
        sd_masks.append(sd)
        head_masks.append(head)
    ts = tstate.create_train_state(model, TrainConfig(**tc),
                                   fam.port_config(cfg), 1)
    ts.optimizer.zero_grad()
    loss, _ = loss_and_grads(model, torch.from_numpy(x),
                             torch.from_numpy(labels), step_config(cfg, 2),
                             torch.from_numpy(CLASS_WEIGHTS),
                             dropout_masks=head_masks, sd_masks=sd_masks)
    ts.apply_gradients()
    want_loss = float(metrics["loss"])
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    old = {n: t.numpy() for n, t in
           flax_tree_to_named(variables["params"]).items()}
    new = {n: t.numpy() for n, t in flax_tree_to_named(
        jax.tree_util.tree_map(np.asarray, new_state.params)).items()}
    got = model.state_dict()
    noise = VANISHING * max(np.abs(new[n] - old[n]).max() for n in new)
    for name, p in model.named_parameters():
        step = new[name] - old[name]
        delta = got[name].numpy() - old[name]
        if not p.requires_grad:
            assert not np.any(step), name
            assert not np.any(delta), name
        elif np.abs(step).max() <= noise:
            assert np.abs(delta).max() <= noise, name
        else:
            assert np.abs(delta - step).max() <= 1e-4 * np.abs(step).max(), \
                name
    check_stats(model, jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats), family)


# -- (d) freezing --------------------------------------------------------------

FREEZING = [("vit", None, False), ("vit", ("embed", "block0"), False),
            ("vit", ("ln",), False), ("vit", None, True),
            ("efficientnet", None, False),
            ("efficientnet", ("stem", "stage3"), False),
            ("efficientnet", ("stage2", "top"), False),
            ("efficientnet", None, True), ("convnext", None, False),
            ("convnext", ("stage2", "stage3"), False),
            ("convnext", ("stem", "ln"), False), ("convnext", None, True)]


@pytest.mark.parametrize("family,stages,head_only", FREEZING)
def test_requires_grad_equals_trainable_mask(family, stages, head_only):
    """None: the family's default (the untouched ('layer4',))."""
    cfg = dataclasses.replace(fam.CONFIGS[family], head_only=head_only,
                              trainable_stages=stages or ("layer4",))
    want = trainable_names(cfg)
    model = Classifier(fam.port_config(cfg))
    assert {n: p.requires_grad for n, p in model.named_parameters()} == want
    assert tstate.trainable_mask(model, fam.port_config(cfg)) == want
    opt = tstate.make_optimizer(model, TrainConfig(), fam.port_config(cfg), 1)
    assert set(opt.params) == {n for n, m in want.items() if m}


# -- (e) the law of stochastic depth -------------------------------------------

def _jax_sd_probs(cfg):
    """{block name: sd_prob} of the blocks whose JAX stochastic depth
    draws in train mode, by patching the family's ``_stochastic_depth``
    to record them while ``apply`` is traced."""
    from irp_tpu.models import convnext as jcnx
    from irp_tpu.models import efficientnet as jeff

    cls = {"efficientnet": jeff.MBConv, "convnext": jcnx.CNBlock}[cfg.family]
    seen = {}
    orig = cls._stochastic_depth

    def record(self, y, train):
        if train and self.sd_prob > 0:
            seen[self.name] = self.sd_prob
        return orig(self, y, train)

    cls._stochastic_depth = record
    try:
        jax.eval_shape(lambda: jax_get(cfg).init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((2, fam.SIZE, fam.SIZE, 3)), train=True))
    finally:
        cls._stochastic_depth = orig
    return seen


@pytest.mark.parametrize("family", ["efficientnet", "convnext"])
def test_stochastic_depth_law(family):
    cfg = dataclasses.replace(train_cfg(family), depth_mult=1.0,
                              convnext_depths=(2, 2, 3, 2))
    model = Classifier(fam.port_config(cfg))
    probs = model.sd_probs()
    want = _jax_sd_probs(cfg)
    assert list(probs) == list(want)
    assert all(abs(probs[n] - want[n]) <= 1e-12 for n in want)
    n = 40_000
    masks = sample_sd_masks(probs, n, torch.Generator().manual_seed(3))
    for name, p in probs.items():
        keep = 1.0 - p
        sigma = (keep * p / n) ** 0.5
        assert abs(float(masks[name].float().mean()) - keep) <= 4 * sigma
    name, p = next(iter(probs.items()))
    y = torch.ones(n, 2, 3, 3)
    out = stochastic_depth(y, masks[name], 1.0 - p)
    kept = masks[name]
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / (1 - p)))


# -- (f) remat -----------------------------------------------------------------

def _trainable_block(model, family):
    bb = model.backbone
    if family == "vit":
        return bb.encoder.layers[-1]
    return bb.features[-2][-1] if family == "efficientnet" \
        else bb.features[-1][-1]


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_step_equals_the_plain_step(family):
    cfg = train_cfg(family, "all")
    record = jax_step(cfg)[-1]
    out = {}
    for remat in (False, True):
        model = port_train_model(dataclasses.replace(
            cfg, remat_trainable_blocks=remat))
        calls = []
        _trainable_block(model, family).register_forward_pre_hook(
            lambda *_: calls.append(1))
        model, loss, _ = port_step(cfg, record, model=model)
        # port_step runs one extra forward for the logits it returns
        out[remat] = (loss, {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None},
                      {n: b.clone() for n, b in model.named_buffers()
                       if "running" in n}, len(calls) - 1)
    (l0, g0, b0, c0), (l1, g1, b1, c1) = out[False], out[True]
    assert (c0, c1) == (1, 2)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert g1.keys() == g0.keys() and g0
    for name, g in g0.items():
        scale = float(g.abs().max()) or 1.0
        assert float((g1[name] - g).abs().max()) <= 1e-6 * scale, name
    for name, b in b0.items():
        scale = float(b.abs().max()) or 1.0
        assert float((b1[name] - b).abs().max()) <= 1e-6 * scale, name


# -- (g) three SGD epoch-steps -------------------------------------------------

def _dataset(n=48, size=40):
    images = uint8_images(5, n, size)
    labels = (np.arange(n) % 5).astype(np.int32)
    keys = [str(i) for i in range(n)]
    names = tuple("abcde")
    return (JaxCachedDataset(images=images, labels=labels, keys=keys,
                             class_names=names),
            CachedDataset(images, labels, keys, names))


@pytest.mark.parametrize("family", FAMILIES)
def test_three_sgd_epoch_steps_match_jax(family):
    # the family's default trainable stages, as the ResNet test trains
    # its default layer4
    cfg = dataclasses.replace(train_cfg(family), stochastic_depth=0.0,
                              dropout_rate=0.0, trainable_stages=("layer4",))
    variables = train_variables(family, "dataset")
    tc = dict(optimizer="sgd", schedule="onecycle", learning_rate=0.05,
              weight_decay=1e-4, batch_size=16, max_epochs=3)
    jcached, tcached = _dataset()
    mesh = make_mesh(devices=jax.devices()[:1])
    jhbm = JaxHBMDataset(jcached, mesh, shuffle_seed=7)
    thbm = HBMDataset(tcached, "cpu", shuffle_seed=7)
    jsamp = JaxEpochSampler(jhbm, 16, seed=7)
    tsamp = EpochSampler(thbm, 16, seed=7)
    state = jstate.create_train_state(jax_get(cfg), jnp_tree(variables),
                                      JaxTrainConfig(**tc), cfg, 3)
    epoch = make_hbm_epoch_step(mesh, 16, jnp.asarray(CLASS_WEIGHTS), "low",
                                out_size=fam.SIZE, compute_dtype=jnp.float32,
                                aug_work_dtype=jnp.float32)
    model = port_train_model(cfg, variables)
    ts = tstate.create_train_state(model, TrainConfig(**tc),
                                   fam.port_config(cfg), 3)
    scfg = StepConfig(intensity="low", out_size=fam.SIZE,
                      compute_dtype=torch.float32, dropout_rate=0.0)
    cw = torch.from_numpy(CLASS_WEIGHTS)
    for e in range(3):
        if e > 0:
            jhbm.local_reshuffle(100 + e)
            thbm.local_reshuffle(100 + e)
        offsets = jsamp.epoch_offsets(3)
        np.testing.assert_array_equal(tsamp.epoch_offsets(3), offsets)
        ekey = jax.random.PRNGKey(20 + e)
        state, metrics = epoch(state, jhbm.images, jhbm.labels,
                               jnp.asarray(offsets), ekey, 0.0)
        for i, off in enumerate(offsets):
            draws = jax_step_draws(jax.random.fold_in(ekey, i), "low", 16,
                                   40, 40)
            images, labels = thbm.window(int(off), 16)
            m = train_step(ts, images, labels, scfg, cw, aug_draws=draws)
            want = float(metrics["loss"][i])
            assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want)
    want = {n: t.numpy() for n, t in flax_tree_to_named(
        jax.tree_util.tree_map(np.asarray, state.params)).items()}
    for name, t in model.state_dict().items():
        if name in want:
            assert np.abs(t.numpy() - want[name]).max() <= 1e-5, name


# -- (h) fit -------------------------------------------------------------------

def _shard_sets(tmp_path):
    from irp_tpu_torch.data.pipeline import decode_to_rgb256
    from irp_tpu_torch.data.tar import iter_samples

    from tests.synth import make_synthetic_shards

    spec = make_synthetic_shards(str(tmp_path / "train"), num_classes=3,
                                 per_class=16, samples_per_shard=16, seed=0,
                                 size=48)
    images, labels = [], []
    index = {n: i for i, n in enumerate(spec["class_names"])}
    for sample in iter_samples(list(spec["shards"])):
        images.append(decode_to_rgb256(sample["jpg"], 40))
        labels.append(index[sample["cls"].decode()])
    cached = CachedDataset(np.stack(images), np.asarray(labels, np.int32),
                           [str(i) for i in range(len(labels))],
                           tuple(spec["class_names"]))
    counts = np.bincount(cached.labels, minlength=3)
    info = DatasetInfo(num_classes=3, class_names=cached.class_names,
                       class_weights=tuple(float(len(cached) / (3 * c))
                                           for c in counts),
                       class_counts=tuple(int(c) for c in counts),
                       total_samples=len(cached))
    return cached, info


@pytest.mark.parametrize("family", FAMILIES)
def test_tiny_fit_trains_and_resumes_bit_exact(family, tmp_path):
    cached, info = _shard_sets(tmp_path)
    model_cfg = fam.port_config(dataclasses.replace(
        train_cfg(family), num_classes=3, dropout_rate=0.1,
        trainable_stages=("layer4",)))
    train = TrainConfig(learning_rate=2e-3, batch_size=16, max_epochs=4,
                        patience=99, aug_intensity="medium", ema_decay=0.9,
                        seed=7)
    full = fit(cached, None, info, model_cfg, train, device="cpu")
    h = full.history["train_loss"]
    assert np.isfinite(h).all() and h[-1] < h[0], h
    ckpt = str(tmp_path / "ckpt")

    def crash_after_two(epoch, val_acc, state=None):
        save_checkpoint(ckpt, state, step=epoch)
        return epoch >= 1

    fit(cached, None, info, model_cfg, train, device="cpu",
        on_epoch_end=crash_after_two)
    path, start = latest_checkpoint(ckpt)
    assert start == 2
    resumed = fit(cached, None, info, model_cfg, train, device="cpu",
                  restore_from=path, start_epoch=start)
    a, b = full.state.model.state_dict(), resumed.state.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.history["train_loss"] == h[2:]
    # the trained model's .npz and .pth score alike in both packages'
    # load_predictor (f32)
    from irp_tpu.infer import load_predictor as jax_load_predictor
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.train.checkpoint import (export_torch_pth,
                                                save_model_npz)

    jcfg = dataclasses.replace(train_cfg(family), num_classes=3,
                               dropout_rate=0.1, trainable_stages=("layer4",))
    src = cached.images[:4]
    for path in (save_model_npz(str(tmp_path / "m.npz"), full.state.model,
                                meta={"image_size": fam.SIZE}),
                 export_torch_pth(str(tmp_path / "m.pth"),
                                  full.state.model)):
        want = jax_load_predictor(path, cfg=jcfg,
                                  batch_size=4).predict_probs(src)
        got = load_predictor(path, cfg=fam.port_config(jcfg), batch_size=4,
                             device="cpu").predict_probs(src)
        assert fam.max_diff(got, want) <= fam.F32_TOL, path


# -- models/convert.py ---------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_merge_pretrained_pth_matches_jax(family, tmp_path):
    """The JAX package's export_torch_pth of seed-1 weights merged over
    seed-0 weights, in both packages: logits within 1e-4; torchvision's
    own head keys and a missing ``backbone.`` prefix are skipped as the
    JAX package skips them."""
    from irp_tpu.models.convert import merge_pretrained as jax_merge
    from irp_tpu.models.convert import torch_state_dict_to_variables
    from irp_tpu.train.checkpoint import export_torch_pth

    cfg = fam.CONFIGS[family]
    src, dst = fam.jax_variables(family, 1), fam.jax_variables(family, 0)
    path = export_torch_pth(str(tmp_path / "w.pth"), src["params"],
                            src["batch_stats"])
    sd = load_torch_checkpoint(path)
    merged = jax_merge(dst, torch_state_dict_to_variables(sd))
    x = fam.images(3)
    want = fam.jax_apply(cfg, merged, x)
    model = merge_pretrained(fam.port_model(cfg, dst), sd)
    got = fam.torch_out(model, fam.nchw(x))
    assert fam.max_diff(got, want) <= fam.F32_TOL
    assert fam.max_diff(got, fam.jax_apply(cfg, dst, x)) > 1e-3
    # a torchvision backbone: no prefix, its own head
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.") and k != "backbone.ln.weight"
                and k != "backbone.ln.bias"}
    if family == "vit":
        own_head = {"heads.head.weight": torch.zeros(1000, 64)}
    elif family == "efficientnet":
        own_head = {"classifier.1.weight": torch.zeros(1000, 640)}
    else:  # classifier.0 is ConvNeXt's post-pool LayerNorm
        own_head = {"classifier.0.weight": sd["backbone.ln.weight"],
                    "classifier.0.bias": sd["backbone.ln.bias"],
                    "classifier.2.weight": torch.zeros(1000, 32)}
    tv = {**backbone, **own_head}
    model = merge_pretrained(fam.port_model(cfg, dst), tv)
    jmerged = jax_merge(dst, torch_state_dict_to_variables(tv))
    assert fam.max_diff(fam.torch_out(model, fam.nchw(x)),
                        fam.jax_apply(cfg, jmerged, x)) <= fam.F32_TOL
    with pytest.raises(KeyError):
        merge_pretrained(model, {"not.a.key": torch.zeros(1)})


@pytest.mark.parametrize("family", FAMILIES)
def test_flax_param_name_covers_every_parameter(family):
    variables = fam.jax_variables(family)
    want = jax_variables_to_state_dict(variables)
    got = flax_tree_to_named(variables["params"])
    params = {n for n, _ in Classifier(fam.port_config(
        fam.CONFIGS[family])).named_parameters()}
    assert set(got) == params
    assert all(torch.equal(got[n], want[n]) for n in got)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["params"]):
        name, layout = flax_param_name([p.key for p in path], family)
        assert name in params
        assert np.asarray(layout(leaf)).size == leaf.size


@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("family", FAMILIES)
def test_optax_state_carries_a_family_across(family, kind):
    """One update from the JAX step's gradients in the JAX package and
    from the port's own (b) gradients in the port: the JAX optimizer
    state carried across equals the port's (adam's moments; SGD's trace
    and the EMA, which adam's first sign-like step would make
    discontinuous where a gradient is near 0)."""
    cfg = train_cfg(family)
    _, _, grads, _, record = jax_step(cfg)
    variables = train_variables(family)
    jtc = JaxTrainConfig(optimizer=kind, schedule="cosine",
                         learning_rate=3e-3, weight_decay=1e-2, max_epochs=2,
                         ema_decay=0.9 if kind == "sgd" else 0.0)
    state = jstate.create_train_state(jax_get(cfg), jnp_tree(variables),
                                      jtc, cfg, 3)
    state = jax.jit(lambda s, g: s.apply_gradients(g))(state,
                                                       jnp_tree(grads))
    model, _, _ = port_step(cfg, record)
    ts = tstate.create_train_state(model, TrainConfig(**dataclasses.asdict(
        jtc)), fam.port_config(cfg), 3)
    ts.apply_gradients()
    carried = optax_state_to_optimizer_state(
        jax.tree_util.tree_map(np.asarray, state.opt_state))
    own = ts.optimizer.state_dict()
    assert carried["count"] == own["count"] == 1
    kinds = {"trace"} if kind == "sgd" else {"mu", "nu"}
    assert set(carried["moments"]) == set(own["moments"]) == kinds
    for slot, tensors in own["moments"].items():
        assert set(carried["moments"][slot]) == set(tensors)
        # the moments carry (b)'s gradient gaps: 1e-4 of the tensor's
        # scale (nu is g^2: twice that), or the vanishing share of the
        # largest where a gradient is 0 but for rounding (beside a
        # weight-decay term both packages add alike)
        noise = VANISHING * max(float(t.abs().max())
                                for t in tensors.values())
        for n, t in tensors.items():
            scale = float(t.abs().max())
            gap = float((carried["moments"][slot][n] - t).abs().max())
            bar = (2e-4 if slot == "nu" else 1e-4) * scale + noise
            assert gap <= bar, (slot, n)
    if kind == "sgd":
        assert set(carried["ema"]) == set(own["ema"])
        for n, t in own["ema"].items():
            torch.testing.assert_close(carried["ema"][n], t, rtol=0,
                                       atol=1e-6)
    fresh = tstate.make_optimizer(port_train_model(cfg), TrainConfig(
        **dataclasses.asdict(jtc)), fam.port_config(cfg), 3)
    fresh.load_state_dict(carried)
    assert fresh.count == 1
