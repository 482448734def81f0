"""The port's daemon beyond /predict (irp_tpu_torch/serve.py): ``POST
/explain`` and ``POST /reload``, on the CPU over a real socket, as
tests/test_serve.py and tests/test_client.py hold the JAX package's.

- /explain: an overlay PNG on the eval crop and the prediction, equal to
  the JAX package's Grad-CAM scores on the same weights; 400 on a bad
  class; 503 while ``max_concurrent_explains`` are running; a TTA model's
  explanations report the flip-averaged scores /predict serves.
- /reload: 400 on a corrupt artifact with the old model serving on, a
  class-name mismatch refused, ``generation`` counted, every served bucket
  warmed before the swap, and no failed /predict from 8 threads while the
  weights change, after which the scores are the new weights' exactly.
"""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu import explain as jax_explain
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.infer import make_predictor as jax_make_predictor
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu_torch import infer
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.serve import make_server
from irp_tpu_torch.train.checkpoint import save_model_npz

torch.set_num_threads(1)
TINY = JaxModelConfig(depth=18, num_classes=3, image_size=64, hidden_dim=16,
                      compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(TINY))
NAMES = ["cat", "dog", "fox"]


def _png(seed, size=96):
    arr = np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                               np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue(), arr


def _post(srv, path, body, ctype="image/png"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=body, headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                timeout=30) as r:
        body = r.read()
    return json.loads(body) if path != "/metrics" else body.decode()


def _npz(path, seed, cfg=CFG):
    model = init_classifier(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    return save_model_npz(str(path), model, meta={"image_size": 64})


@pytest.fixture(scope="module")
def pair():
    """The same JAX-initialized weights (positive head, as
    tests/test_explain.py) in both packages."""
    _, variables = jax_init(TINY, jax.random.PRNGKey(0), image_size=64)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(1)
    params = variables["params"]
    for name in ("head_dense1", "head_dense2"):
        k = params[name]["kernel"]
        params[name] = {"kernel": (np.abs(rng.normal(size=k.shape))
                                   * 0.1).astype(np.float32),
                        "bias": np.zeros_like(params[name]["bias"])}
    ours = infer.make_predictor(variables, class_names=NAMES, cfg=CFG,
                                batch_size=4, device="cpu")
    theirs = jax_make_predictor(variables, class_names=NAMES, cfg=TINY,
                                batch_size=4)
    return ours, theirs


@pytest.fixture(scope="module")
def server(pair):
    srv = make_server(pair[0], port=0, window_ms=5.0)
    srv.start()
    yield srv
    srv.stop()


def test_explain_endpoint_scores_as_jax(server, pair):
    body, _ = _png(3)
    code, out = _post(server, "/explain?topk=3", body)
    assert code == 200 and out["n"] == 1
    (ex,) = out["explanations"]
    assert ex["label_name"] in NAMES and ex["explained_class"] == ex["label"]
    png = base64.b64decode(ex["cam_png_b64"])
    assert png[:4] == b"\x89PNG"
    assert np.asarray(Image.open(io.BytesIO(png))).shape == (64, 64, 3)
    from irp_tpu_torch.data.pipeline import decode_blobs

    _, logits = jax_explain.GradCAM(pair[1], batch_size=4).explain(
        decode_blobs([body]))
    want = np.exp(logits - logits.max()) / np.exp(logits - logits.max()).sum()
    got = {t["label"]: t["prob"] for t in ex["topk"]}
    for label, prob in got.items():
        assert abs(prob - float(want[0, label])) <= 1e-4


def test_explain_class_and_validation(server):
    body, _ = _png(4)
    code, out = _post(server, "/explain?class=1", body)
    assert code == 200 and out["explanations"][0]["explained_class"] == 1
    stats = _get(server, "/stats")
    assert stats["explain"]["requests"] >= 1
    assert stats["explain"]["latency_ms"]["p50"] > 0
    metrics = _get(server, "/metrics")
    assert "irp_explain_requests_total" in metrics
    assert "irp_explain_latency_ms_p50" in metrics
    assert "irp_reloads_total 0" in metrics
    # /predict does not read 'class'
    assert _post(server, "/predict?class=cat", body)[0] == 200
    assert _post(server, "/explain?class=7", body)[0] == 400
    assert _post(server, "/explain?class=x", body)[0] == 400
    assert _post(server, "/explain", b"not an image")[0] == 400


def test_explain_answers_503_when_saturated(server):
    slots = server._explain_slots
    assert slots.acquire(blocking=False) and slots.acquire(blocking=False)
    try:
        code, out = _post(server, "/explain", _png(5)[0])
        assert code == 503 and "saturated" in out["error"]
    finally:
        slots.release()
        slots.release()
    assert _post(server, "/explain", _png(5)[0])[0] == 200


def test_explain_reports_tta_scores(pair):
    ours = pair[0]
    tta = infer.Predictor(model=ours.model, class_names=NAMES, batch_size=8,
                          tta=True, device="cpu")
    srv = make_server(tta, port=0)
    srv.start()
    try:
        body, _ = _png(21)
        _, pred = _post(srv, "/predict?topk=3", body)
        _, exp = _post(srv, "/explain?topk=3", body)
        p, e = pred["predictions"][0], exp["explanations"][0]
        assert e["label"] == p["label"] == e["explained_class"]
        assert e["topk"] == p["topk"]
        assert srv.gradcam().tta_scorer.batch_size == 8
    finally:
        srv.stop()


def _load(path):
    return infer.load_predictor(path, batch_size=4, pad_buckets=(1, 2, 4),
                                device="cpu")


def test_reload_failures_keep_the_old_model(tmp_path):
    w0 = _npz(tmp_path / "w0.npz", 0)
    four = _npz(tmp_path / "four.npz", 1,
                dataclasses.replace(CFG, num_classes=4))
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(b"PK\x03\x04 not really a zip")
    srv = make_server(_load(w0), port=0, class_names=NAMES,
                      loader=_load, weights_path=w0)
    srv.start()
    try:
        body, _ = _png(6)
        _, before = _post(srv, "/predict?topk=3", body)
        for path, match in ((str(corrupt), "reload failed"),
                            (str(tmp_path / "missing.npz"), "reload failed"),
                            (four, "do not fit")):
            code, out = _post(srv, "/reload", json.dumps(
                {"weights": path}).encode(), "application/json")
            assert code == 400 and match in out["error"]
            assert out["generation"] == 0
        assert _post(srv, "/reload", b'{"w": 1}', "application/json")[0] \
            == 400
        _, after = _post(srv, "/predict?topk=3", body)
        assert after["predictions"] == before["predictions"]
        health = _get(srv, "/healthz")
        assert health["generation"] == 0 and health["weights"] == w0
    finally:
        srv.stop()


def test_reload_warms_every_bucket_before_the_swap(tmp_path):
    w0 = _npz(tmp_path / "w0.npz", 0)
    warmed = []

    def loader(path):
        p = _load(path)
        orig = p.predict_probs
        p.predict_probs = lambda x: (warmed.append(int(x.shape[0])),
                                     orig(x))[1]
        return p

    srv = make_server(_load(w0), port=0, loader=loader)
    try:
        out = srv.reload_weights(w0)
        assert warmed == [1, 2, 4] and out["generation"] == 1
        assert out["class_names"] is None
    finally:
        srv.server_close()
        srv.batcher.stop()


def test_reload_under_8_predict_clients(tmp_path):
    """No /predict fails while the weights change twice; afterwards the
    served scores equal a predictor loaded straight from the new weights,
    and the served names follow the rules (kept when they fit)."""
    w0, w1 = _npz(tmp_path / "w0.npz", 0), _npz(tmp_path / "w1.npz", 1)
    srv = make_server(_load(w0), port=0, class_names=NAMES,
                      loader=_load, weights_path=w0, window_ms=2.0)
    srv.start()
    body, _ = _png(7)
    stop = threading.Event()
    codes, errors = [], []

    def client():
        while not stop.is_set():
            try:
                codes.append(_post(srv, "/predict", body)[0])
            except Exception as e:  # noqa: BLE001 — counted as a failure
                errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for gen, path in ((1, w1), (2, w0), (3, w1)):
            code, out = _post(srv, "/reload", json.dumps(
                {"weights": path}).encode(), "application/json")
            assert code == 200 and out["generation"] == gen
            assert out["class_names"] == NAMES
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors and codes and set(codes) == {200}
        _, served = _post(srv, "/predict?topk=3", body)
        from irp_tpu_torch.data.pipeline import decode_blobs

        want = _load(w1).predict_probs(decode_blobs([body]))
        got = {t["label"]: t["prob"] for t in served["predictions"][0]["topk"]}
        for label, prob in got.items():
            assert prob == round(float(want[0, label]), 6)
        health = _get(srv, "/healthz")
        assert health["generation"] == 3 and health["weights"] == w1
        assert "irp_reloads_total 3" in _get(srv, "/metrics")
        assert srv.gradcam().predictor is srv.batcher.predictor
    finally:
        srv.stop()
