"""Serving replicas (``infer.replicate_predictor``, ``serve.MicroBatcher``
over a list) and the CLIs' parallelism flags, on the CPU, as
tests/test_infer.py and tests/test_serve.py hold the JAX package's.

- Replicas on ``[cpu, cpu]`` (torch has one CPU device, so both share
  it, as two replicas on one card do) score bit-equal to the predictor,
  TTA included; every ``ValueError`` of ``replicate_predictor``.
- A batcher over two replicas answers concurrent requests with the
  predictor's probabilities, both replicas dispatching (``/stats``
  ``per_replica``), and a reload swaps both.
- The exit-2 rules of ``serve_cli --replicas/--data-parallel``.
"""

import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.train import checkpoint as jax_ckpt
from irp_tpu_torch import infer
from irp_tpu_torch.cli import serve_cli
from irp_tpu_torch.parallel.mesh import make_mesh
from irp_tpu_torch.serve import MicroBatcher, make_server

torch.set_num_threads(1)
CFG = JaxModelConfig(depth=18, num_classes=3, image_size=56, hidden_dim=16,
                     compute_dtype="float32")
NAMES = ["a", "b", "c"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Two .npz files of the JAX package's, from two seeds."""
    root = tmp_path_factory.mktemp("replicas")
    paths = []
    for seed in (1, 2):
        _, variables = jax_init(CFG, jax.random.PRNGKey(seed),
                                image_size=56)
        variables = jax.tree_util.tree_map(np.asarray, variables)
        paths.append(jax_ckpt.save_weights_npz(
            str(root / f"w{seed}.npz"), variables["params"],
            variables["batch_stats"], meta={"image_size": 56}))
    return paths


def _images(seed, n=5):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _load(path, **kw):
    kw.setdefault("batch_size", 4)
    return infer.load_predictor(path, class_names=NAMES, device="cpu", **kw)


@pytest.mark.parametrize("tta", [False, True])
def test_replicas_score_as_the_predictor(weights, tta):
    base = _load(weights[0], tta=tta)
    want = base.predict_probs(_images(0))
    replicas = infer.replicate_predictor(base, devices=["cpu", "cpu"])
    assert len(replicas) == 2
    assert replicas[0].model is replicas[1].model  # one device, one copy
    for rep in replicas:
        assert rep.tta == tta and rep.class_names == NAMES
        assert infer.predictor_device(rep) == torch.device("cpu")
        np.testing.assert_array_equal(rep.predict_probs(_images(0)), want)
    [one] = infer.replicate_predictor(base)  # default: the CPU, once
    np.testing.assert_array_equal(one.predict_probs(_images(0)), want)


def test_replicate_predictor_refusals(weights):
    base = _load(weights[0])
    with pytest.raises(ValueError, match="already mesh-sharded"):
        infer.replicate_predictor(_load(weights[0],
                                        mesh=make_mesh(devices=["cpu"])))
    exported = infer.Predictor(model=base.model, device="cpu",
                               _program=lambda x: x, source_size=256)
    with pytest.raises(ValueError, match="exported"):
        infer.replicate_predictor(exported)
    with pytest.raises(ValueError, match="not both"):
        infer.replicate_predictor(base, devices=["cpu"], n=1)
    with pytest.raises(ValueError, match="empty"):
        infer.replicate_predictor(base, devices=[])
    for n in (0, 2):
        with pytest.raises(ValueError, match="replicas but"):
            infer.replicate_predictor(base, n=n)
    with pytest.raises(ValueError, match="share batch_size"):
        MicroBatcher([base, _load(weights[0], batch_size=8)],
                     autostart=False)


class _Slow:
    """A replica whose forward takes a while, so that concurrent
    requests spread over the dispatch threads."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def predict_probs(self, images):
        time.sleep(0.05)
        return self.inner.predict_probs(images)


def _get(server, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=30) as r:
        return json.loads(r.read())


def test_two_replicas_serve_concurrent_requests_and_reload(weights):
    base = _load(weights[0])
    replicas = [_Slow(p) for p in infer.replicate_predictor(
        base, devices=["cpu", "cpu"])]
    server = make_server(replicas, port=0, window_ms=1.0,
                         loader=lambda p: _load(p))
    server.start()
    try:
        images = [_images(10 + i, n=1) for i in range(16)]
        want = base.predict_probs(np.concatenate(images))
        got, errors = [None] * 16, []

        def client(i):
            try:
                got[i] = server.batcher.submit(images[i], timeout=60)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors
        np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-5,
                                   atol=1e-6)
        stats = _get(server, "/stats")
        per = stats["per_replica"]
        assert len(per) == 2 and all(r["batches"] > 0 for r in per)
        assert sum(r["images"] for r in per) == 16
        assert _get(server, "/healthz")["replicas"] == 2
        out = server.reload_weights(weights[1])
        assert out["replicas"] == 2 and out["generation"] == 1
        news = server.batcher.predictors
        assert len(news) == 2 and news[0].model is news[1].model
        want2 = _load(weights[1]).predict_probs(images[0])
        np.testing.assert_array_equal(
            server.batcher.submit(images[0], timeout=60), want2)
        assert all(p.class_names == NAMES for p in news)
    finally:
        server.stop()


@pytest.mark.parametrize("argv,err", [
    (["--replicas", "1", "--data-parallel"], "alternative strategies"),
    (["--replicas", "two"], "'auto' or an integer"),
    (["--replicas", "0"], "needs that many local devices"),
    (["--replicas", "2"], "needs that many local devices"),
])
def test_serve_cli_parallel_flags_exit_2(weights, capsys, argv, err):
    assert serve_cli.main(["--weights", weights[0], "--cpu", *argv]) == 2
    assert err in capsys.readouterr().err


def test_serve_cli_refuses_to_replicate_or_split_an_irpx(tmp_path, capsys):
    fake = str(tmp_path / "m.irpx")
    assert serve_cli.main(["--weights", fake, "--cpu", "--replicas",
                           "1"]) == 2
    assert "baked" in capsys.readouterr().err
    with open(fake, "wb") as f:
        f.write(b"not a zip")
    assert serve_cli.main(["--weights", fake, "--cpu",
                           "--data-parallel"]) == 2
    assert "cannot take a mesh" in capsys.readouterr().err


def test_loaders_take_a_mesh(weights):
    mesh = make_mesh(devices=["cpu", "cpu"])
    pred = _load(weights[0], mesh=mesh)
    assert pred.mesh is mesh
    made = infer.make_predictor(_npz_variables(weights[0]),
                                class_names=NAMES, image_size=56,
                                batch_size=4, mesh=mesh)
    assert made.mesh is mesh and made.model.config == pred.model.config
    np.testing.assert_allclose(made.predict_probs(_images(3)),
                               pred.predict_probs(_images(3)), rtol=1e-6,
                               atol=1e-7)


def _npz_variables(path):
    from irp_tpu_torch.train.checkpoint import load_weights_npz

    params, stats = load_weights_npz(path)
    return {"params": params, "batch_stats": stats}
