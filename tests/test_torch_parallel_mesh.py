"""The port's mesh (``irp_tpu_torch/parallel/``) and the data axis of its
resident sets, mixing and inference, against the JAX package on the 8
virtual CPU devices.

- ``MeshConfig.axis_sizes`` and ``host_shards`` equal the JAX package's
  over a grid of cases.  The 2-D layout: a local mesh of D x M devices
  keeps the first device of each model row as its data axis (the JAX
  package's ``reshape(data, model)``) and refuses too few devices; of a
  process mesh's D x M ranks, world rank 0 alone leads.
- A local mesh repeats the CPU (``torch.device`` has no distinct CPU
  devices): ``Predictor(mesh=)`` and ``extract_features(mesh=)`` on
  ``[cpu, cpu]`` equal the unsharded paths (1e-6, the JAX package's
  test_infer.py bar); batch sizes round to the mesh, and a pad bucket
  that does not split is refused.
- The resident sets over a data axis of 2 (``HBMDataset``,
  ``HBMEvalSet``, ``EpochSampler``, ``HBMFoldPool``/``HBMFoldView``)
  hold, rank by rank, the rows of the JAX package's (2, N/2) layouts;
  each rank is a process mesh here in name only (its sets use no
  collective).  The shard-local mixing partner and the stream path's
  rows likewise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from irp_tpu.config import MeshConfig as JaxMeshConfig
from irp_tpu.data import pipeline as jax_pipeline
from irp_tpu.ops.mix import _partner as jax_partner
from irp_tpu.parallel import distributed as jax_distributed
from irp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from irp_tpu_torch import infer
from irp_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from irp_tpu_torch.data import pipeline
from irp_tpu_torch.data.outliers import extract_features
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.ops.mix import _partner
from irp_tpu_torch.parallel import distributed
from irp_tpu_torch.parallel.mesh import (Mesh, batch_sharding, make_mesh,
                                         replicated, shard_variables)
from irp_tpu_torch.train.fit import fit

torch.set_num_threads(1)
CFG = ModelConfig(depth=18, num_classes=3, image_size=56, hidden_dim=16,
                  compute_dtype="float32")
CPU2 = ["cpu", "cpu"]


def _rank(r: int, d: int = 2) -> Mesh:
    """Rank r of a d-rank process mesh, as the resident sets see it."""
    return Mesh(["cpu"], group=object(), index=r, size=d)


@pytest.mark.parametrize("data,model", [(-1, 1), (1, 1), (2, 1), (4, 1),
                                        (-1, 2), (3, 2), (8, 1)])
def test_axis_sizes_equal_jax(data, model):
    for n in range(1, 9):
        assert (MeshConfig(data, model).axis_sizes(n)
                == JaxMeshConfig(data, model).axis_sizes(n))


def test_host_shards_equal_jax():
    for n_shards in (0, 1, 5, 10, 13):
        shards = [f"train-{i:06d}.tar" for i in range(n_shards)][::-1]
        for count in (1, 2, 3, 4):
            parts = []
            for index in range(count):
                got = distributed.host_shards(shards, index, count)
                assert got == jax_distributed.host_shards(shards, index,
                                                          count)
                parts += got
            assert sorted(parts) == sorted(shards)
    assert distributed.host_shards(["b", "a"]) == ["a", "b"]  # one process
    assert (distributed.process_index(), distributed.process_count()) \
        == (0, 1)


@pytest.mark.parametrize("data,model,n,want", [
    (2, 2, 4, [0, 2]), (-1, 2, 4, [0, 2]), (1, 2, 4, [0]),
    (-1, 4, 8, [0, 4]), (3, 1, 4, [0, 1, 2])])
def test_local_2d_mesh_data_devices(data, model, n, want):
    devices = [torch.device("cpu", i) for i in range(n)]
    mesh = make_mesh(MeshConfig(data=data, model=model), devices=devices)
    assert [d.index for d in mesh.devices] == want
    assert mesh.shape == {"data": len(want), "model": model}
    assert mesh.is_leader and not mesh.is_process
    assert not mesh.tensor_parallel


@pytest.mark.parametrize("data,model", [(5, 1), (3, 2), (1, 8)])
def test_local_2d_mesh_refuses_too_few_devices(data, model):
    with pytest.raises(ValueError, match=f"needs {data * model} devices"):
        make_mesh(MeshConfig(data=data, model=model), devices=["cpu"] * 4)


@pytest.mark.parametrize("rank,leader", [(0, True), (1, False), (2, False),
                                         (3, False)])
def test_only_world_rank_zero_leads(rank, leader):
    i, j = divmod(rank, 2)
    mesh = Mesh(["cpu"], group=object(), index=i, size=2,
                model_group=object(), model_index=j, model_size=2)
    assert mesh.rank == rank and mesh.is_leader == leader
    # the data index alone would make rank 1 (data 0) a second leader
    assert (mesh.index == 0) == (rank in (0, 1))


def test_local_mesh():
    mesh = make_mesh(devices=CPU2)
    assert mesh.shape == {"data": 2, "model": 1} and not mesh.is_process
    assert mesh.rows(6) == [slice(0, 3), slice(3, 6)]
    assert batch_sharding(mesh)(4) == [(torch.device("cpu"), slice(0, 2)),
                                       (torch.device("cpu"), slice(2, 4))]
    assert replicated(mesh) == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="split"):
        mesh.rows(5)
    assert make_mesh(MeshConfig(data=1), devices=CPU2).size == 1
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_mesh(MeshConfig(data=3), devices=CPU2)
    # as the JAX package cuts the device list to the data axis
    assert jax_make_mesh(JaxMeshConfig(data=1),
                         devices=jax.devices()[:2]).shape["data"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    model = init_classifier(CFG, torch.Generator().manual_seed(0),
                            device="cpu")
    [copy] = shard_variables(mesh, model)  # one copy per distinct device
    assert copy is model


def test_fit_on_a_local_mesh_of_two_devices_raises():
    cached = pipeline.CachedDataset(
        images=np.zeros((4, 64, 64, 3), np.uint8),
        labels=np.zeros(4, np.int32), keys=list("abcd"), class_names=("a",))
    with pytest.raises(ValueError, match="torchrun"):
        fit(cached, None, None, CFG, TrainConfig(batch_size=2),
            mesh=make_mesh(devices=CPU2))


@pytest.fixture(scope="module")
def weights():
    model = init_classifier(CFG, torch.Generator().manual_seed(3),
                            device="cpu")
    return model.state_dict()


def _predictor(weights, **kw):
    model = init_classifier(CFG, device="cpu")
    model.load_state_dict(weights)
    return infer.Predictor(model=model, device="cpu", **kw)


def test_sharded_predictor_equals_single(weights):
    images = np.random.default_rng(1).integers(0, 256, (11, 64, 64, 3),
                                               dtype=np.uint8)
    want = _predictor(weights, batch_size=8).predict_probs(images)
    for tta in (False, True):
        pred = _predictor(weights, batch_size=8, tta=tta,
                          mesh=make_mesh(devices=CPU2))
        assert pred.batch_size == 8 and pred.device.type == "cpu"
        ref = _predictor(weights, batch_size=8, tta=tta)
        np.testing.assert_allclose(pred.predict_probs(images),
                                   ref.predict_probs(images), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        _predictor(weights, batch_size=8,
                   mesh=make_mesh(devices=CPU2)).predict_probs(images),
        want, rtol=1e-5, atol=1e-6)
    assert infer.predictor_device(
        _predictor(weights, mesh=make_mesh(devices=CPU2))) is None


def test_sharded_predictor_rounds_and_refuses_buckets(weights):
    mesh = make_mesh(devices=CPU2)
    assert _predictor(weights, batch_size=5, mesh=mesh).batch_size == 4
    assert _predictor(weights, batch_size=1, mesh=mesh).batch_size == 2
    with pytest.raises(ValueError, match="split evenly"):
        _predictor(weights, batch_size=8, pad_buckets=(1, 2, 8), mesh=mesh)
    pred = _predictor(weights, batch_size=8, pad_buckets=(2, 4, 8),
                      mesh=mesh)
    images = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    np.testing.assert_allclose(
        pred.predict_probs(images),
        _predictor(weights, batch_size=8).predict_probs(images),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="local mesh"):
        _predictor(weights, mesh=_rank(0))


def test_sharded_extract_features_equals_unsharded(weights):
    images = np.random.default_rng(4).integers(0, 256, (7, 64, 64, 3),
                                               dtype=np.uint8)
    cached = pipeline.CachedDataset(images=images,
                                    labels=np.arange(7) % 3,
                                    keys=[str(i) for i in range(7)],
                                    class_names=("a", "b", "c"))
    want, _, _ = extract_features(cached, CFG, batch_size=4,
                                  state_dict=weights, device="cpu")
    got, labels, keys = extract_features(cached, CFG, batch_size=4,
                                         state_dict=weights,
                                         mesh=make_mesh(devices=CPU2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert keys == cached.keys and list(labels) == list(cached.labels)


def _cached(n=21, size=16, shards=5):
    rng = np.random.default_rng(n)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = (np.arange(n) % 3).astype(np.int32)
    keys = [str(i) for i in range(n)]
    sids = (np.arange(n) * shards // n).astype(np.int32)
    paths = tuple(f"/s/train-{i:06d}.tar" for i in range(shards))
    names = ("a", "b", "c")
    return (pipeline.CachedDataset(images, labels, keys, names, sids, paths),
            jax_pipeline.CachedDataset(images, labels, keys, names, sids,
                                       paths))


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])


def test_hbm_dataset_rows_equal_jax(jmesh):
    cached, jcached = _cached()
    jhbm = jax_pipeline.HBMDataset(jcached, jmesh, shuffle_seed=5)
    ranks = [pipeline.HBMDataset(cached, "cpu", 5, mesh=_rank(r))
             for r in range(2)]
    for step in range(3):
        if step:
            jhbm.local_reshuffle(40 + step)
            for h in ranks:
                h.local_reshuffle(40 + step)
        jimages, jlabels = np.asarray(jhbm.images), np.asarray(jhbm.labels)
        for r, h in enumerate(ranks):
            assert h.local_count == jhbm.local_count == 11
            np.testing.assert_array_equal(h.images.numpy(), jimages[r])
            np.testing.assert_array_equal(h.labels.numpy(), jlabels[r])
    jsamp = jax_pipeline.EpochSampler(jhbm, 8, seed=2)
    samp = pipeline.EpochSampler(ranks[1], 8, seed=2)
    assert samp.per_device == jsamp.per_device == 4
    assert samp.steps_per_epoch == jsamp.steps_per_epoch
    np.testing.assert_array_equal(samp.epoch_offsets(5),
                                  jsamp.epoch_offsets(5))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.EpochSampler(ranks[0], 7)
    with pytest.raises(ValueError, match="process mesh"):
        pipeline.HBMDataset(cached, "cpu", mesh=make_mesh(devices=CPU2))


def test_hbm_eval_set_rows_and_scatter_equal_jax(jmesh):
    cached, jcached = _cached(n=13)
    jev = jax_pipeline.HBMEvalSet(jcached, jmesh, 4, max_samples=11)
    ranks = [pipeline.HBMEvalSet(cached, "cpu", 4, 11, mesh=_rank(r))
             for r in range(2)]
    jimages = np.asarray(jev.images)
    for r, ev in enumerate(ranks):
        np.testing.assert_array_equal(ev.images.numpy(), jimages[r])
        np.testing.assert_array_equal(ev.offsets, jev.offsets)
    logits = np.random.default_rng(0).normal(
        size=(jev.steps, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(ranks[0].scatter_logits(logits),
                                  jev.scatter_logits(logits))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.HBMEvalSet(cached, "cpu", 5, mesh=_rank(0))


@pytest.mark.parametrize("seed", [0, 3])
def test_fold_pool_rows_equal_jax(jmesh, seed):
    cached, jcached = _cached(n=23, shards=6)
    jpool = jax_pipeline.HBMFoldPool(jcached, jmesh, seed=seed)
    ranks = [pipeline.HBMFoldPool(cached, "cpu", seed=seed, mesh=_rank(r))
             for r in range(2)]
    folds = [list(cached.shard_paths[:4]), list(cached.shard_paths[2:])]
    for fold in folds:
        jview = jpool.select_fold(fold)
        views = [p.select_fold(fold) for p in ranks]
        assert ranks[0].last_dropped == jpool.last_dropped
        for r, (pool, view) in enumerate(zip(ranks, views)):
            assert view.local_count == jview.local_count
            np.testing.assert_array_equal(pool._slot_sample,
                                          jpool._slot_sample[r])
            np.testing.assert_array_equal(pool.images.numpy(),
                                          np.asarray(jpool.images)[r])
        jview.local_reshuffle(7)
        for view in views:
            view.local_reshuffle(7)
        for r, pool in enumerate(ranks):
            np.testing.assert_array_equal(pool.labels.numpy(),
                                          np.asarray(jpool.labels)[r])
    assert ranks[0].upload_bytes == jpool.upload_bytes // 2


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partner_is_shard_local_as_jax(shards):
    """Each rank's local flip is the JAX package's pairing of its shard."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    want = np.asarray(jax_partner(jnp.asarray(x), shards))
    b = 8 // shards
    for r in range(shards):
        np.testing.assert_array_equal(
            _partner(torch.from_numpy(x[r * b:(r + 1) * b])).numpy(),
            want[r * b:(r + 1) * b])


def test_stream_prefetch_takes_the_rank_rows():
    batches = [(np.arange(8 * 2).reshape(8, 2) + 100 * i,
                np.arange(8) + i, 8) for i in range(3)]
    for r in range(2):
        got = list(pipeline.prefetch_to_device(iter(batches), "cpu",
                                               mesh=_rank(r)))
        for (x, y, n), (gx, gy, gn) in zip(batches, got):
            np.testing.assert_array_equal(gx.numpy(), x[4 * r:4 * r + 4])
            np.testing.assert_array_equal(gy.numpy(), y[4 * r:4 * r + 4])
            assert gn == n
