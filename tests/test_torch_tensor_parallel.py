"""The model axis of the port's mesh (``irp_tpu_torch/parallel/``):
layout, coordinates and the tensor-parallel forward, against the JAX
package on the 8 virtual CPU devices.

- ``param_shardings`` gives the JAX rules' entries under the torchvision
  keys: every JAX ``PartitionSpec`` of ResNet18, the tiny ViT and the tiny
  ConvNeXt, carried to its ``state_dict`` key by ``flax_param_name``
  (q, k and v each to the packed ``in_proj``), is the port's sharded dim
  (a flax kernel is the transpose of torch's weight); EfficientNet shards
  its head alone.  The packed ``in_proj`` slice takes each rank's rows of
  q, k and v (whole heads), not one contiguous block.
- Coordinates: rank r of a D x 2 process mesh sits at (r // 2, r % 2)
  (the JAX package's ``reshape(data, model)``); sums over its model,
  data and world groups; world rank 0 alone leads; a mesh that does not
  span the ranks is refused; ``global_batch_for``.  (A local 2-D mesh's
  devices and the leader of a 2-D mesh: tests/test_torch_parallel_mesh.py.)
- The forward over a 1 x 2 mesh of two gloo ranks (tests/torch_dist_child.py)
  of the tiny ViT (tests/test_vit.py:300's: embed 128, mlp 256, 2
  layers, 2 heads, 32 px, weights ``_randomized``), the tiny ConvNeXt and
  ResNet18/56 with its head equals the JAX package's unsharded forward
  and its data=4 x model=2 forward within 1e-5 in f32 (the JAX tests'
  bar); both ranks' logits are bit-equal, the gathered weights are the
  whole ones, and layouts that do not split raise naming the tensor.
- ``Predictor`` and ``extract_features`` on a local 2 x 2 mesh equal the
  unsharded paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irp_tpu.config import MeshConfig as JaxMeshConfig
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from irp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from irp_tpu.parallel.mesh import param_shardings as jax_param_shardings
from irp_tpu.parallel.mesh import shard_variables as jax_shard
from irp_tpu_torch import infer
from irp_tpu_torch.config import MeshConfig, ModelConfig
from irp_tpu_torch.data import pipeline
from irp_tpu_torch.data.outliers import extract_features
from irp_tpu_torch.models.classifier import Classifier, init_classifier
from irp_tpu_torch.models.convert import (flax_param_name,
                                          jax_variables_to_state_dict)
from irp_tpu_torch.parallel import distributed
from irp_tpu_torch.parallel.mesh import make_mesh, param_shardings
from irp_tpu_torch.parallel.tensor import shard_index

from tests.torch_dist_child import launch
from tests.torch_jax_train import perturbed_variables

torch.set_num_threads(1)
FWD_TOL = 1e-5  # tests/test_vit.py:298 and tests/test_convnext.py:336
CPU4 = ["cpu"] * 4
VIT = JaxModelConfig(family="vit", patch_size=8, embed_dim=128,
                     num_layers=2, mlp_dim=256, num_classes=5, hidden_dim=32,
                     image_size=32, dropout_rate=0.0,
                     compute_dtype="float32")
CNX = JaxModelConfig(family="convnext", convnext_dims=(8, 16, 24, 32),
                     convnext_depths=(1, 1, 2, 1), num_classes=5,
                     hidden_dim=32, image_size=32, dropout_rate=0.0,
                     stochastic_depth=0.0, compute_dtype="float32")
RESNET = JaxModelConfig(depth=18, num_classes=3, image_size=56,
                        hidden_dim=16, compute_dtype="float32",
                        precision="highest", dropout_rate=0.0)
EFF = JaxModelConfig(family="efficientnet", width_mult=0.5, depth_mult=0.5,
                     num_classes=3, hidden_dim=16, image_size=32,
                     compute_dtype="float32")


def _randomized(variables, seed=0, scale=0.05):
    """tests/test_vit.py's: normal draws for every leaf."""
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(rng.normal(0.0, scale, a.shape), np.float32)
               for a in leaves])


def _variables(name):
    """(JAX config, numpy variables) of a forward case, as the JAX
    package's own TP tests draw them (ResNet18: BN perturbed and the
    head's biases redrawn, so that they are not 0)."""
    if name == "resnet":
        v = jax.tree_util.tree_map(np.copy, perturbed_variables(RESNET, 3))
        rng = np.random.RandomState(4)
        for dense in ("head_dense1", "head_dense2"):
            bias = v["params"][dense]["bias"]
            v["params"][dense]["bias"] = rng.normal(
                0.0, 0.05, bias.shape).astype(np.float32)
        return RESNET, v
    cfg = VIT if name == "vit" else CNX
    seed = 7 if name == "vit" else 0
    _, v = jax_init(cfg, jax.random.PRNGKey(0), image_size=32)
    return cfg, jax.tree_util.tree_map(np.asarray, _randomized(v, seed))


# -- layout ------------------------------------------------------------------

def _spec_dim(spec, kernel: bool):
    """The torch dim a JAX spec shards (a flax kernel is the transpose of
    torch's (out, in) weight), or None."""
    spec = tuple(spec)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    return (1 - dim) if kernel and len(spec) == 2 else dim


@pytest.mark.parametrize("cfg", [RESNET, VIT, CNX],
                         ids=["resnet18", "vit", "convnext"])
def test_param_shardings_equal_the_jax_rules(cfg):
    jmesh = jax_make_mesh(JaxMeshConfig(data=4, model=2))
    _, variables = jax_init(cfg, jax.random.PRNGKey(0), cfg.image_size)
    specs = jax_param_shardings(jmesh, variables)["params"]
    model = Classifier(ModelConfig(**dataclasses.asdict(cfg)))
    mesh = make_mesh(MeshConfig(data=4, model=2), devices=["cpu"] * 8)
    got = param_shardings(mesh, model)
    assert set(got) == set(model.state_dict())
    want = {}
    for path, sharding in jax.tree_util.tree_leaves_with_path(specs):
        keys = [k.key for k in path]
        name, _ = flax_param_name(keys, cfg.family)
        dim = _spec_dim(sharding.spec, keys[-1] == "kernel")
        assert want.setdefault(name, dim) == dim, name  # q, k, v agree
    for name, dim in want.items():
        assert got[name] == dim, name
    assert {k for k, d in got.items() if d is not None} == {
        k for k, d in want.items() if d is not None}
    # the entries tests/test_train_e2e.py:43, test_vit.py:278 and
    # test_convnext.py:314 check, under the torchvision keys
    assert got["classifier.1.weight"] == 0 and got["classifier.1.bias"] == 0
    assert got["classifier.4.weight"] == 1
    assert got["classifier.4.bias"] is None
    if cfg.family == "resnet":
        assert got["backbone.conv1.weight"] is None
    if cfg.family == "vit":
        blk = "backbone.encoder.layers.encoder_layer_0."
        assert got[blk + "self_attention.in_proj_weight"] == 0
        assert got[blk + "self_attention.in_proj_bias"] == 0
        assert got[blk + "self_attention.out_proj.weight"] == 1
        assert got[blk + "self_attention.out_proj.bias"] is None
        assert got[blk + "mlp.0.weight"] == 0
        assert got[blk + "mlp.3.weight"] == 1
        assert got[blk + "ln_1.weight"] is None
        assert got["backbone.encoder.pos_embedding"] is None
    if cfg.family == "convnext":
        assert got["backbone.features.7.0.block.3.weight"] == 0
        assert got["backbone.features.7.0.block.5.weight"] == 1
        assert got["backbone.features.7.0.layer_scale"] is None


def test_efficientnet_shards_its_head_alone():
    model = Classifier(ModelConfig(**dataclasses.asdict(EFF)))
    got = param_shardings(make_mesh(MeshConfig(model=2), devices=CPU4),
                          model)
    assert {k for k, d in got.items() if d is not None} == {
        "classifier.1.weight", "classifier.1.bias", "classifier.4.weight"}


@pytest.mark.parametrize("parts,index,packs,want", [
    (2, 0, 1, [0, 1, 2]), (2, 1, 1, [3, 4, 5]),
    (2, 0, 3, [0, 2, 4]), (2, 1, 3, [1, 3, 5]),
    (3, 2, 2, [2, 5])])
def test_shard_index_takes_each_packed_block(parts, index, packs, want):
    assert shard_index(6, parts, index, packs).tolist() == want


def test_packed_in_proj_slice_is_whole_heads():
    """Rank m's rows of the packed (3E, E) in_proj are q's, k's and v's
    rows [mE/M, (m+1)E/M), not rows [m 3E/M, (m+1) 3E/M) (that would mix
    q with k)."""
    e, parts = 8, 2
    for m in range(parts):
        rows = shard_index(3 * e, parts, m, 3).tolist()
        want = [j * e + r for j in range(3)
                for r in range(m * e // parts, (m + 1) * e // parts)]
        assert rows == want
        assert rows != list(range(m * 3 * e // parts,
                                  (m + 1) * 3 * e // parts))


# -- coordinates -------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_process_mesh_coordinates_and_groups(tmp_path, world):
    outs = launch("tp_basics", str(tmp_path), world=world)
    data = world // 2
    for r, out in enumerate(outs):
        i, j = divmod(r, 2)  # np.array(devices).reshape(data, model)
        assert (out["rank"], out["index"], out["model_index"]) == (r, i, j)
        assert (out["size"], out["model_size"]) == (data, 2)
        assert out["shape"] == {"data": data, "model": 2}
        assert out["leader"] == (r == 0)
        assert out["sums"]["model"] == 2 ** (2 * i) + 2 ** (2 * i + 1)
        assert out["sums"]["data"] == sum(2 ** (2 * k + j)
                                          for k in range(data))
        assert out["sums"]["world"] == 2 ** world - 1
        b = 8 // data  # the rows of the data index
        assert out["rows"] == str([slice(i * b, (i + 1) * b)])
        assert "spans every rank" in out["refused"]
        assert out["global_batch"] == 4 * world


def test_global_batch_for_without_a_group():
    assert not distributed.is_initialized()
    n = max(torch.cuda.device_count(), 1)
    assert distributed.global_batch_for(32) == 32 * n


# -- the tensor-parallel forward against the JAX package ---------------------

@pytest.fixture(scope="module")
def forward_run(tmp_path_factory):
    cases, want = {}, {}
    jmesh = jax_make_mesh(JaxMeshConfig(data=4, model=2))
    for name in ("vit", "convnext", "resnet"):
        cfg, variables = _variables(name)
        x = np.random.RandomState(8).normal(
            size=(4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        model, _ = jax_init(cfg, jax.random.PRNGKey(0), cfg.image_size)
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        fwd = jax.jit(lambda v, a, m=model: m.apply(v, a, train=False))
        base = np.asarray(fwd(jv, jnp.asarray(x)))
        sharded = np.asarray(fwd(
            jax_shard(jmesh, jv),
            jax.device_put(jnp.asarray(x), jax_batch_sharding(jmesh))))
        want[name] = (base, sharded)
        cases[name] = {"cfg": dataclasses.asdict(cfg), "x": x,
                       "state_dict": jax_variables_to_state_dict(
                           variables, cfg.depth)}
    odd_heads = dataclasses.replace(VIT, embed_dim=96, num_heads=3,
                                    mlp_dim=192)
    bad = {"heads": dataclasses.asdict(odd_heads),
           "hidden": dataclasses.asdict(dataclasses.replace(
               RESNET, hidden_dim=15))}
    outs = launch("tp_forward", str(tmp_path_factory.mktemp("tp_fwd")),
                  {"models": cases, "bad": bad})
    return cases, want, outs


@pytest.mark.parametrize("name", ["vit", "convnext", "resnet"])
def test_tp_forward_equals_jax(forward_run, name):
    cases, want, outs = forward_run
    base, sharded = want[name]
    got = [out[name] for out in outs]
    assert torch.equal(got[0]["logits"], got[1]["logits"])
    logits = got[0]["logits"].numpy()
    np.testing.assert_allclose(logits, base, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(logits, sharded, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got[0]["whole_logits"].numpy(), base,
                               rtol=0, atol=FWD_TOL)
    for out in got:
        assert out["gathered_whole"] and out["unsharded_equal"]


@pytest.mark.parametrize("name", ["vit", "convnext", "resnet"])
def test_tp_slices_follow_param_shardings(forward_run, name):
    cases, _, outs = forward_run
    sd = cases[name]["state_dict"]
    dims = param_shardings(None, Classifier(ModelConfig(**cases[name]["cfg"])))
    for key, t in sd.items():
        want = list(t.shape)
        if dims[key] is not None:
            want[dims[key]] //= 2
        assert list(outs[0][name]["shapes"][key]) == want, key


def test_layouts_that_do_not_split_raise_naming_the_tensor(forward_run):
    _, _, outs = forward_run
    errors = outs[0]["errors"]
    assert "encoder_layer_0.self_attention" in errors["heads"]
    assert "3 heads" in errors["heads"]
    assert "classifier.1.weight" in errors["hidden"]


# -- a local 2 x 2 mesh: the model axis replicates ---------------------------

CFG = ModelConfig(depth=18, num_classes=3, image_size=56, hidden_dim=16,
                  compute_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    return init_classifier(CFG, torch.Generator().manual_seed(3),
                           device="cpu").state_dict()


def _predictor(weights, **kw):
    model = init_classifier(CFG, device="cpu")
    model.load_state_dict(weights)
    return infer.Predictor(model=model, device="cpu", **kw)


def test_predictor_on_a_local_2x2_mesh_equals_single(weights):
    images = np.random.default_rng(1).integers(0, 256, (11, 64, 64, 3),
                                               dtype=np.uint8)
    mesh = make_mesh(MeshConfig(data=2, model=2), devices=CPU4)
    pred = _predictor(weights, batch_size=8, mesh=mesh)
    assert pred.batch_size == 8 and len(pred._models) == 1
    np.testing.assert_allclose(
        pred.predict_probs(images),
        _predictor(weights, batch_size=8).predict_probs(images),
        rtol=1e-5, atol=1e-6)


def test_extract_features_on_a_local_2x2_mesh_equals_unsharded(weights):
    images = np.random.default_rng(4).integers(0, 256, (7, 64, 64, 3),
                                               dtype=np.uint8)
    cached = pipeline.CachedDataset(images=images,
                                    labels=np.arange(7) % 3,
                                    keys=[str(i) for i in range(7)],
                                    class_names=("a", "b", "c"))
    want, _, _ = extract_features(cached, CFG, batch_size=4,
                                  state_dict=weights, device="cpu")
    got, _, keys = extract_features(
        cached, CFG, batch_size=4, state_dict=weights,
        mesh=make_mesh(MeshConfig(data=2, model=2), devices=CPU4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert keys == cached.keys
