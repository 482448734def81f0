"""Shared helpers of the training-slice parity tests
(tests/test_torch_train_*): the JAX package's random draws, recomputed from its key by its own splits,
as the port's draw arguments; and tiny models and datasets that both
packages build from one numpy seed."""

import dataclasses
import functools

import jax
import numpy as np
import torch

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.ops.preprocess import _sample_rrc_boxes
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import get_classifier
from irp_tpu_torch.models.convert import jax_variables_to_state_dict

# (crop scale, jitter b/c/s, hue) per intensity, as augment_batch_fused
# passes them
_JAX_LAWS = {"medium": ((0.8, 1.0), 0.1, 0.0), "high": ((0.7, 1.0), 0.2, 0.1)}


def jax_augment_draws(key, intensity: str, b: int, h: int,
                      w: int):
    """The draws ``irp_tpu.ops.preprocess.augment_batch_fused(images, key,
    intensity, ...)`` makes, by the same splits and calls, as the port's
    ``AugmentDraws``."""
    from irp_tpu_torch.ops.preprocess import AugmentDraws

    k_h, k_v, k_crop, k_jit, k_rot = jax.random.split(key, 5)

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype))

    draws = AugmentDraws(hflip=t(jax.random.bernoulli(k_h, shape=(b,))))
    if intensity == "low":
        return draws
    scale, jit, hue = _JAX_LAWS[intensity]
    if intensity == "high":
        draws.vflip = t(jax.random.bernoulli(k_v, p=0.2, shape=(b,)))
    tops, lefts, ch, cw = _sample_rrc_boxes(k_crop, b, h, w, scale)
    draws.tops, draws.lefts = t(tops, np.float32), t(lefts, np.float32)
    draws.heights, draws.widths = t(ch, np.float32), t(cw, np.float32)
    kb, kc, ks, kh = jax.random.split(k_jit, 4)
    lo, hi = max(0.0, 1 - jit), 1 + jit
    draws.brightness = t(jax.random.uniform(kb, (b, 1, 1, 1), minval=lo,
                                            maxval=hi).reshape(b))
    draws.contrast = t(jax.random.uniform(kc, (b, 1, 1, 1), minval=lo,
                                          maxval=hi).reshape(b))
    draws.saturation = t(jax.random.uniform(ks, (b, 1, 1, 1), minval=lo,
                                            maxval=hi).reshape(b))
    if hue > 0:
        draws.hue = t(jax.random.uniform(kh, (b, 1, 1), minval=-hue,
                                         maxval=hue).reshape(b))
        draws.angles = t(jax.random.uniform(k_rot, (b,), minval=-15.0,
                                            maxval=15.0))
    return draws


def jax_step_draws(key, intensity: str, b: int, h: int, w: int):
    """The augmentation draws of one JAX train step without mixing
    (``train/step.py::_augment_mix`` splits its key in two: augmentation,
    dropout)."""
    aug_key, _ = jax.random.split(key)
    return jax_augment_draws(aug_key, intensity, b, h, w)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=8)
def perturbed_variables(cfg: JaxModelConfig, seed: int):
    """JAX init_classifier variables with BN affine and running stats
    perturbed from a numpy seed, as numpy (cached: callers copy before
    they change anything)."""
    _, variables = jax_init(cfg, jax.random.PRNGKey(seed),
                            image_size=cfg.image_size)
    variables = numpy_tree(variables)
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


def torch_model(cfg: JaxModelConfig, variables):
    """The port's Classifier for a JAX config, with the JAX variables."""
    model = get_classifier(ModelConfig(**dataclasses.asdict(cfg)),
                           device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg.depth))
    return model


def uint8_images(seed: int, n: int, size: int) -> np.ndarray:
    """Smooth random uint8 images (upsampled noise plus pixel noise)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (n, size // 8 + 1, size // 8 + 1, 3))
    big = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)[:, :size, :size]
    noise = rng.normal(0, 20, big.shape)
    return np.clip(big + noise, 0, 255).astype(np.uint8)
