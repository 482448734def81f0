"""Port parity: batched inference (irp_tpu_torch/infer.py) and the .npz
artifact format (irp_tpu_torch/train/checkpoint.py) against the JAX
package's predictor and checkpoint code.

The JAX package writes the artifacts; the port loads them on the CPU and
must score the same uint8 batch to the same softmax (1e-3 in f32).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from irp_tpu import infer as jax_infer
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.train import checkpoint as jax_ckpt
from irp_tpu_torch import infer
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.parallel.mesh import make_mesh
from irp_tpu_torch.train import checkpoint

torch.set_num_threads(1)

CFG = JaxModelConfig(depth=18, num_classes=3, image_size=64, hidden_dim=16,
                     compute_dtype="float32", precision="highest")


def _port_cfg(cfg: JaxModelConfig) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(variables, npz path, pth path) written by the JAX package."""
    root = tmp_path_factory.mktemp("weights")
    _, variables = jax_init(CFG, jax.random.PRNGKey(0), image_size=64)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    npz = jax_ckpt.save_weights_npz(str(root / "w.npz"), variables["params"],
                                    stats, meta={"image_size": 64})
    pth = jax_ckpt.export_torch_pth(str(root / "w.pth"), variables["params"],
                                    stats, depth=18)
    return variables, npz, pth


def _batch(seed, n=5, size=80):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


@pytest.mark.parametrize("tta", [False, True])
def test_npz_predictor_matches_jax(artifacts, tta):
    _, npz, _ = artifacts
    kwargs = dict(batch_size=4, pad_buckets=(1, 2, 4), tta=tta)
    want = jax_infer.load_predictor(npz, cfg=CFG, **kwargs)
    got = infer.load_predictor(npz, cfg=_port_cfg(CFG), device="cpu",
                               **kwargs)
    images = _batch(1)  # 5 images: a full chunk of 4 + a ragged tail of 1
    p_want = want.predict_probs(images)
    p_got = got.predict_probs(images)
    assert p_got.shape == (5, 3) and p_got.dtype == np.float32
    assert np.abs(p_got - p_want).max() <= 1e-3
    np.testing.assert_allclose(p_got.sum(axis=1), 1.0, atol=1e-5)


def test_inferred_config_from_npz_meta(artifacts):
    """No cfg: depth, head widths and the crop (npz metadata) come from the
    artifact; compute stays bf16 as in the JAX package."""
    _, npz, _ = artifacts
    want = jax_infer.load_predictor(npz, batch_size=8)
    got = infer.load_predictor(npz, batch_size=8, device="cpu")
    cfg = got.model.config
    assert (cfg.depth, cfg.num_classes, cfg.hidden_dim, cfg.image_size,
            cfg.compute_dtype) == (18, 3, 16, 64, "bfloat16")
    images = _batch(2, n=3)
    np.testing.assert_allclose(got.predict_probs(images),
                               want.predict_probs(images), atol=0.05)


def test_pth_predictor_matches_npz_predictor(artifacts):
    _, npz, pth = artifacts
    a = infer.load_predictor(npz, cfg=_port_cfg(CFG), device="cpu")
    b = infer.load_predictor(pth, cfg=_port_cfg(CFG), device="cpu")
    images = _batch(3, n=2)
    np.testing.assert_array_equal(a.predict_probs(images),
                                  b.predict_probs(images))


@pytest.mark.parametrize("cfg", [
    JaxModelConfig(depth=50), JaxModelConfig(depth=101, num_classes=7),
    JaxModelConfig(depth=50, groups=32, width_per_group=4, hidden_dim=64),
    JaxModelConfig(depth=34, num_classes=4)])
def test_infer_model_config_matches_jax(cfg):
    """Architecture recovered from parameter shapes alone."""
    from irp_tpu.models.classifier import get_classifier as jax_get

    shapes = jax.eval_shape(
        lambda: jax_get(cfg).init({"params": jax.random.PRNGKey(0)},
                                  jax.numpy.zeros((1, 64, 64, 3)),
                                  train=False))["params"]
    want = jax_infer.infer_model_config(shapes, image_size=96)
    got = infer.infer_model_config(shapes, image_size=96)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_class_name_and_image_size_errors(artifacts):
    _, npz, _ = artifacts
    with pytest.raises(ValueError, match="class names"):
        infer.load_predictor(npz, class_names=["a", "b"], device="cpu")
    pred = infer.load_predictor(npz, device="cpu")
    with pytest.raises(ValueError, match="eval crop"):
        pred.predict_probs(np.zeros((1, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        pred.predict_probs(np.zeros((1, 64, 64), np.uint8))
    with pytest.raises(ValueError, match="pad_buckets"):
        infer.load_predictor(npz, batch_size=4, pad_buckets=(1, 2),
                             device="cpu")


def test_no_card_means_no_silent_cpu(artifacts):
    _, npz, _ = artifacts
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.load_predictor(npz)


def test_later_slice_features_raise(artifacts, tmp_path):
    """A file that is not an .irpx is refused by name; the features of
    the parallelism slice load: ``mesh=`` a local mesh, and
    ``replicate_predictor``'s replicas, which score as the predictor
    does (tests/test_torch_replicas.py holds them further)."""
    _, npz, _ = artifacts
    bad = tmp_path / "m.irpx"
    bad.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not a readable irpx"):
        infer.load_predictor(str(bad), device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    single = infer.load_predictor(npz, device="cpu", batch_size=4)
    sharded = infer.load_predictor(
        npz, mesh=make_mesh(devices=["cpu", "cpu"]), device="cpu",
        batch_size=4)
    assert sharded.mesh.size == 2 and sharded.batch_size == 4
    np.testing.assert_allclose(sharded.predict_probs(images),
                               single.predict_probs(images), atol=1e-6)
    replicas = infer.replicate_predictor(single, devices=["cpu", "cpu"])
    assert len(replicas) == 2
    for r in replicas:
        np.testing.assert_array_equal(r.predict_probs(images),
                                      single.predict_probs(images))


def test_npz_round_trips_between_packages(artifacts, tmp_path):
    variables, npz, _ = artifacts
    params, stats, meta = checkpoint.load_weights_npz(npz, with_meta=True)
    assert meta == {"image_size": 64}
    assert checkpoint.load_weights_meta(npz) == {"image_size": 64}
    out = checkpoint.save_weights_npz(str(tmp_path / "again.npz"), params,
                                      stats, meta={"image_size": 64})
    p2, s2, m2 = jax_ckpt.load_weights_npz(out, with_meta=True)
    assert m2 == {"image_size": 64}
    for tree, want in ((p2, variables["params"]),
                       (s2, variables["batch_stats"])):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(flat[path], leaf)


def test_bucket_helpers_and_softmax_match_jax():
    for n in (1, 5, 64, 100):
        assert infer.power_of_two_buckets(n) == \
            jax_infer.power_of_two_buckets(n)
    for spec, bsz, n_data in (("auto", 64, 1), ("1,8,64", 64, 1),
                              ("auto", 8, 2)):
        assert infer.serving_buckets(spec, bsz, n_data) == \
            jax_infer.serving_buckets(spec, bsz, n_data)
    logits = np.random.default_rng(4).normal(size=(3, 5)) * 10
    np.testing.assert_array_equal(infer.softmax_np(logits),
                                  jax_infer.softmax_np(logits))


def test_load_class_names(tmp_path):
    path = tmp_path / "c.json"
    path.write_text('{"class_names": ["cat", "dog"]}')
    assert infer.load_class_names(str(path)) == ["cat", "dog"]
    assert infer.load_class_names("a, b,c") == ["a", "b", "c"]
