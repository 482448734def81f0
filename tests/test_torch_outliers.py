"""Port parity: embedding outlier detection (irp_tpu_torch/data/outliers.py,
Classifier.features, models/convert.py's checkpoint merge) against the
JAX package's data/outliers.py on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
Where the JAX package draws random numbers (the layout's negative
samples), the test repeats its draws and feeds them to the port.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.data import outliers as jax_outliers
from irp_tpu.data.pipeline import CachedDataset as JaxCachedDataset
from irp_tpu.models import convert as jax_convert
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data import outliers
from irp_tpu_torch.data.pipeline import CachedDataset
from irp_tpu_torch.models import convert
from irp_tpu_torch.models.classifier import Classifier

torch.set_num_threads(1)

CFG = JaxModelConfig(depth=18, num_classes=3, image_size=56, hidden_dim=16,
                     compute_dtype="float32", precision="highest")
FEATURE_TOL = 1e-3  # the repo's f32 fidelity bar (BASELINE.json)


def _blobs(rng, n_per=50, centers=((0, 0), (8, 8), (-8, 8)), dim=8):
    xs, ys = [], []
    for i, c in enumerate(centers):
        mu = np.zeros(dim)
        mu[0], mu[1] = c
        xs.append(rng.normal(0, 0.6, (n_per, dim)) + mu)
        ys.append(np.full(n_per, i))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def _graph(seed=4, n_per=30, k=8):
    """A supervised fuzzy graph of three blobs, from the JAX package."""
    x, y = _blobs(np.random.default_rng(seed), n_per=n_per)
    idx, dist = jax_outliers.knn(x, k)
    rows, cols, vals = jax_outliers.fuzzy_simplicial_set(idx, dist)
    vals = jax_outliers.categorical_intersection(rows, cols, vals, y, 0.5)
    return x, y, rows, cols, vals


def test_pca_matches_jax():
    x = np.random.default_rng(0).normal(size=(120, 30)).astype(np.float32)
    want, want_comps, want_mu = jax_outliers.pca(x, 5)
    got, comps, mu = outliers.pca(x, 5, device="cpu")
    assert got.shape == want.shape == (120, 5) and comps.shape == (5, 30)
    np.testing.assert_allclose(mu, want_mu, rtol=0, atol=1e-6)
    for i in range(5):  # the same axis up to sign
        cos = abs(np.dot(got[:, i], want[:, i])
                  / (np.linalg.norm(got[:, i]) * np.linalg.norm(want[:, i])))
        assert cos > 0.9999, (i, cos)


def test_graph_stages_match_jax():
    """The host numpy stages from the same kNN input: the same code, so
    equal to 1e-6."""
    x, y = _blobs(np.random.default_rng(1), n_per=25)
    idx, dist = jax_outliers.knn(x, 10)
    for got, want in zip(outliers._smooth_knn(dist),
                         jax_outliers._smooth_knn(dist)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got = outliers.fuzzy_simplicial_set(idx, dist)
    want = jax_outliers.fuzzy_simplicial_set(idx, dist)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        outliers.categorical_intersection(*got, y, 0.5),
        jax_outliers.categorical_intersection(*want, y, 0.5),
        rtol=1e-6, atol=1e-6)


def _principal_cosines(a, b):
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def test_spectral_init_matches_jax_device_path():
    """torch.lobpcg on the CPU against the JAX package's LOBPCG, from the
    same start block: the same bottom-of-spectrum subspace, compared by
    principal angles (rotation and sign free)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    n, k = 300, 8
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    vals = rng.uniform(0.1, 1.0, n * k).astype(np.float32)
    g = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    g = (g + g.T).tocoo()
    r, c, v = (g.row.astype(np.int32), g.col.astype(np.int32),
               g.data.astype(np.float32))
    want = jax_outliers.spectral_init(r, c, v, n, dim=2, use_device=True)
    assert jax_outliers.last_spectral_path == "lobpcg"
    got = outliers.spectral_init(r, c, v, n, dim=2, device="cpu")
    assert outliers.last_spectral_path == "lobpcg"
    assert got.shape == want.shape == (n, 2) and got.dtype == np.float32
    assert np.abs(got).max() == pytest.approx(10.0)
    assert _principal_cosines(got, want).min() > 0.99


def test_spectral_init_host_path_matches_jax():
    _, _, rows, cols, vals = _graph()
    n = 90
    want = jax_outliers.spectral_init(rows, cols, vals, n, use_device=False)
    got = outliers.spectral_init(rows, cols, vals, n, use_device=False)
    assert outliers.last_spectral_path == "eigsh"
    assert _principal_cosines(got, want).min() > 0.99


def _jax_negatives(seed, n_epochs, negative_rate, n_edges, n):
    """The negative samples optimize_layout draws, in its split order."""
    key = jax.random.PRNGKey(seed)
    out = np.zeros((n_epochs, negative_rate, n_edges), np.int64)
    for i in range(n_epochs):
        key, _ = jax.random.split(key)
        for j in range(negative_rate):
            key, k2 = jax.random.split(key)
            out[i, j] = np.asarray(jax.random.randint(k2, (n_edges,), 0, n))
    return out


def test_optimize_layout_matches_jax_with_its_negatives():
    """Five epochs from the same init with JAX's negative samples.  The
    repulsion's 1 / (0.001 + d^2) magnifies last-bit differences (pow and
    the scatter-add order) by about 10^3 whenever a sample lands near its
    point, so the run starts from a jittered grid of spacing 3 with
    lr 0.5: every point still moves by several units."""
    x, _, rows, cols, vals = _graph()
    n = len(x)
    grid = np.stack(np.meshgrid(np.arange(10), np.arange(9)), -1)
    jitter = np.random.default_rng(0).uniform(-0.5, 0.5, (n, 2))
    init = (3.0 * grid.reshape(-1, 2)[:n] + jitter).astype(np.float32)
    epochs = 5
    want = jax_outliers.optimize_layout(init, rows, cols, vals,
                                        n_epochs=epochs, lr=0.5, seed=11)
    negatives = _jax_negatives(11, epochs, 5, len(rows), n)
    got = outliers.optimize_layout(init, rows, cols, vals, n_epochs=epochs,
                                   lr=0.5, seed=11, device="cpu",
                                   negatives=negatives)
    assert np.abs(want - init).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="negatives"):
        outliers.optimize_layout(init, rows, cols, vals, n_epochs=epochs,
                                 device="cpu", negatives=negatives[:1])


def test_optimize_layout_own_draws_are_seeded():
    x, _, rows, cols, vals = _graph()
    init = np.random.default_rng(3).normal(0, 3, (len(x), 2)
                                           ).astype(np.float32)
    a = outliers.optimize_layout(init, rows, cols, vals, n_epochs=3,
                                 seed=5, device="cpu")
    b = outliers.optimize_layout(init, rows, cols, vals, n_epochs=3,
                                 seed=5, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and not np.array_equal(a, init)


def test_lof_and_detect_outliers_match_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0, 1, (100, 2)),
                        [[8.0, 8.0]]]).astype(np.float32)
    np.testing.assert_allclose(outliers.local_outlier_factor(x, 20,
                                                             device="cpu"),
                               jax_outliers.local_outlier_factor(x, 20),
                               rtol=1e-5)
    y = np.array([0] * 50 + [1] * 51)
    kw = dict(per_class_neighbors=20, global_neighbors=40)
    got = outliers.detect_outliers(x, y, device="cpu", **kw)
    want = jax_outliers.detect_outliers(x, y, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2]["global"], want[2]["global"],
                               rtol=1e-5)


def _variables():
    """JAX ResNet18/56 variables, BN running stats perturbed."""
    _, variables = jax_init(CFG, jax.random.PRNGKey(0), image_size=56)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _cached(n=13, seed=11):
    rng = np.random.default_rng(seed)
    fields = dict(images=rng.integers(0, 255, (n, 64, 64, 3), np.uint8),
                  labels=rng.integers(0, 3, n).astype(np.int32),
                  keys=[str(i) for i in range(n)], class_names=("a", "b",
                                                                "c"))
    return JaxCachedDataset(**fields), CachedDataset(**fields)


@pytest.mark.parametrize("resident", [True, False])
def test_extract_features_matches_jax(resident):
    """Both the uploaded-once and the streamed path, with a ragged tail
    batch (13 = 8 + 5)."""
    variables = _variables()
    jax_cached, cached = _cached()
    want, want_labels, want_keys = jax_outliers.extract_features(
        jax_cached, CFG, batch_size=8, variables=variables)
    got, labels, keys = outliers.extract_features(
        cached, ModelConfig(**dataclasses.asdict(CFG)), batch_size=8,
        state_dict=convert.jax_variables_to_state_dict(variables, 18),
        device="cpu", resident=resident)
    assert got.shape == want.shape == (13, 512) and got.dtype == np.float32
    assert keys == want_keys and (labels == want_labels).all()
    assert np.abs(got - want).max() <= FEATURE_TOL


def test_extract_features_guards():
    _, cached = _cached(n=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        outliers.extract_features(cached, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            outliers.extract_features(cached)


def _backbone_pth(path, seed=0):
    """A torchvision-layout ResNet18 backbone checkpoint (fc.* and
    num_batches_tracked included) with random values."""
    model = Classifier(ModelConfig(**dataclasses.asdict(CFG)))
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, t in model.backbone.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(7)
        elif key.endswith("running_var"):
            sd[key] = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            sd[key] = torch.randn(t.shape, generator=gen) * 0.1
    sd["fc.weight"] = torch.randn(1000, 512, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def test_merge_pretrained_matches_jax(tmp_path):
    path = str(tmp_path / "backbone.pth")
    _backbone_pth(path)
    variables = _variables()
    jax_vars = jax_convert.merge_pretrained(
        variables, jax_convert.load_torch_checkpoint(path))
    jax_cached, cached = _cached(n=6)
    want, _, _ = jax_outliers.extract_features(jax_cached, CFG, batch_size=8,
                                               variables=jax_vars)
    model = Classifier(ModelConfig(**dataclasses.asdict(CFG)))
    model.load_state_dict(convert.jax_variables_to_state_dict(variables, 18))
    head = model.classifier[1].weight.detach().clone()
    assert convert.merge_pretrained(
        model, convert.load_torch_checkpoint(path)) is model
    assert torch.equal(model.classifier[1].weight, head)  # head kept
    got, _, _ = outliers.extract_features(
        cached, model.config, batch_size=8, state_dict=model.state_dict(),
        device="cpu")
    assert np.abs(got - want).max() <= FEATURE_TOL


def test_checkpoint_forms_and_merge_errors(tmp_path):
    sd = _backbone_pth(str(tmp_path / "bare.pth"))
    torch.save({"state_dict": {f"backbone.{k}": v for k, v in sd.items()}},
               str(tmp_path / "wrapped.pth"))
    bare = convert.load_torch_checkpoint(str(tmp_path / "bare.pth"))
    wrapped = convert.load_torch_checkpoint(str(tmp_path / "wrapped.pth"))
    a = convert.merge_pretrained(
        Classifier(ModelConfig(**dataclasses.asdict(CFG))), bare)
    b = convert.merge_pretrained(
        Classifier(ModelConfig(**dataclasses.asdict(CFG))), wrapped)
    for key, value in a.backbone.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, b.backbone.state_dict()[key]), key
    model = Classifier(ModelConfig(**dataclasses.asdict(CFG)))
    before = model.backbone.conv1.weight.detach().clone()
    with pytest.raises(KeyError, match="layer9"):
        convert.merge_pretrained(model, {"conv1.weight": sd["conv1.weight"],
                                         "layer9.0.conv1.weight":
                                         torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.merge_pretrained(model, {"conv1.weight":
                                         torch.zeros(64, 3, 3, 3)})
    assert torch.equal(model.backbone.conv1.weight, before)  # untouched


def test_features_is_the_eval_form_backbone():
    model = Classifier(ModelConfig(**dataclasses.asdict(CFG)))
    model.load_state_dict(convert.jax_variables_to_state_dict(_variables(),
                                                              18))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 56, 56)).astype(np.float32))
    model.train()
    got = model.features(x)
    assert model.training and got.dtype == torch.float32
    model.eval()
    with torch.no_grad():
        assert torch.equal(got.detach(), model.backbone(x).float())


def test_the_slice_matches_jax_end_to_end():
    """Blobs with one planted outlier through both packages'
    create_embeddings and detect_outliers: the kNN and fuzzy graphs agree,
    and both flag the planted point."""
    x, y = _blobs(np.random.default_rng(5), n_per=60)
    x = np.concatenate([x, [[25.0] + [0.0] * 7]]).astype(np.float32)
    y = np.concatenate([y, [0]])
    timings = {}
    emb, proj = outliers.create_embeddings(x, y, device="cpu",
                                           timings=timings)
    assert outliers.last_spectral_path == "lobpcg"
    assert set(timings) == {"pca", "knn", "fuzzy_set", "spectral_init",
                            "layout"}
    want_emb, want_proj = jax_outliers.create_embeddings(x, y)
    assert emb.shape == want_emb.shape == (len(x), 2)
    assert np.isfinite(emb).all()
    # each package's kNN on its own PCA projection: the two SVDs agree to
    # a few f32 ulps of the features, so distances to 1e-4 relative
    i_got, d_got = outliers.knn(proj, 15, device="cpu")
    i_want, d_want = jax_outliers.knn(want_proj, 15)
    np.testing.assert_array_equal(i_got, i_want)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-4, atol=1e-5)
    for g, w in zip(outliers.fuzzy_simplicial_set(i_got, d_got),
                    jax_outliers.fuzzy_simplicial_set(i_want, d_want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    class_mask, global_mask, _ = outliers.detect_outliers(
        emb, y, device="cpu", timings=timings)
    assert "lof" in timings
    want_class, want_global, _ = jax_outliers.detect_outliers(want_emb, y)
    assert class_mask[-1] or global_mask[-1]
    assert want_class[-1] or want_global[-1]
    assert class_mask.sum() == want_class.sum()
    assert global_mask.sum() == want_global.sum()
