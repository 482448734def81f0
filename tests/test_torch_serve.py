"""Port parity: the online daemon (irp_tpu_torch/serve.py, cli/serve_cli.py)
on the CPU against the JAX package's predictor, over a real socket.
"""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.data.pipeline import decode_to_rgb256 as jax_decode
from irp_tpu.infer import make_predictor as jax_make_predictor
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data.pipeline import decode_blobs
from irp_tpu_torch.infer import make_predictor
from irp_tpu_torch.serve import MicroBatcher, make_server
from tests.torch_native import needs_native_decoder

torch.set_num_threads(1)

CFG = JaxModelConfig(depth=18, num_classes=3, image_size=64, hidden_dim=16,
                     compute_dtype="float32", precision="highest")
NAMES = ["cat", "dog", "fox"]


@pytest.fixture(scope="module")
def predictors():
    _, variables = jax_init(CFG, jax.random.PRNGKey(1), image_size=64)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    ours = make_predictor(variables, class_names=NAMES,
                          cfg=ModelConfig(**dataclasses.asdict(CFG)),
                          batch_size=4, device="cpu")
    theirs = jax_make_predictor(variables, class_names=NAMES, cfg=CFG,
                                batch_size=4)
    return ours, theirs


@pytest.fixture(scope="module")
def server(predictors):
    srv = make_server(predictors[0], port=0, window_ms=20.0)
    srv.start()
    yield srv
    srv.stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=30) as r:
        return r.status, r.read()


def _post(server, path, body, ctype):
    req = urllib.request.Request(_url(server, path), data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jpeg(seed, size=96):
    arr = np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                               np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def test_predict_matches_jax_predictor(server, predictors):
    blobs = [_jpeg(0), _jpeg(1)]
    code_raw, raw = _post(server, "/predict?topk=3", blobs[0], "image/jpeg")
    body = json.dumps({"instances": [base64.b64encode(b).decode()
                                     for b in blobs]}).encode()
    code_json, js = _post(server, "/predict?topk=3", body,
                          "application/json")
    assert code_raw == code_json == 200
    assert raw["n"] == 1 and js["n"] == 2
    images = decode_blobs(blobs)
    want = predictors[1].predict_probs(images)
    for i, row in enumerate([raw["predictions"][0]] + js["predictions"]):
        want_row = want[0 if i == 0 else i - 1]
        order = np.argsort(-want_row)
        assert [t["label"] for t in row["topk"]] == list(order)
        assert row["label_name"] == NAMES[order[0]]
        got = np.array([t["prob"] for t in row["topk"]])
        assert np.abs(got - want_row[order]).max() <= 1e-3


def test_decode_matches_jax_decoder():
    """'pil' against the JAX package's PIL decoder."""
    blob = _jpeg(5, size=130)
    np.testing.assert_array_equal(decode_blobs([blob], decoder="pil")[0],
                                  jax_decode(blob))


@needs_native_decoder
def test_decode_auto_matches_jax_decode_blobs():
    """'auto', the daemon's default (native, PIL for what it cannot
    decode), against the JAX package's ``decode_blobs``."""
    from irp_tpu.data.pipeline import decode_blobs as jax_decode_blobs

    blob = _jpeg(5, size=130)
    np.testing.assert_array_equal(decode_blobs([blob]),
                                  jax_decode_blobs([blob]))


def test_healthz_stats_metrics(server):
    _post(server, "/predict", _jpeg(2), "image/jpeg")
    code, body = _get(server, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert health["model"] == {"family": "resnet", "depth": 18,
                               "num_classes": 3, "image_size": 64,
                               "class_names": NAMES}
    assert health["device"] == "cpu"
    code, body = _get(server, "/stats")
    stats = json.loads(body)
    assert code == 200 and stats["requests"] >= 1 and stats["batches"] >= 1
    assert set(stats["latency_ms"]) == {"p50", "p90", "p99"}
    code, body = _get(server, "/metrics")
    text = body.decode()
    assert code == 200 and "irp_requests_total" in text
    assert 'irp_model_info{family="resnet",depth="18"' in text


@pytest.mark.parametrize("path", ["/explain", "/reload"])
def test_later_slice_routes_answer_501(server, path):
    """The routes that answered 501 before Grad-CAM and reload were
    ported: /explain now explains, and /reload without a loader is 403."""
    if path == "/explain":
        code, body = _post(server, path, _jpeg(3), "image/jpeg")
        assert code == 200 and body["explanations"][0]["label_name"] in NAMES
    else:
        code, body = _post(server, path, b'{"weights": "w.npz"}',
                           "application/json")
        assert code == 403 and "--allow-reload" in body["error"]


def test_bad_requests(server):
    assert _post(server, "/predict", b"not an image", "image/jpeg")[0] == 400
    assert _post(server, "/nope", b"x", "image/jpeg")[0] == 404
    assert _post(server, "/predict", b'{"instances": 3}',
                 "application/json")[0] == 400


class _GatedPredictor:
    """A predictor whose first forward blocks until released: a dispatch
    stuck on the device."""

    def __init__(self, inner):
        self.inner = inner
        self.batch_size = 4
        self.model = inner.model
        self.num_classes = inner.num_classes
        self.gate = threading.Event()
        self.calls = 0

    def predict_probs(self, images):
        self.calls += 1
        self.gate.wait(30)
        return self.inner.predict_probs(images)


def test_stop_then_start_keeps_one_dispatcher(predictors):
    """A stop() whose join times out, then start(): the stuck thread must
    exit once it wakes, leaving exactly one dispatcher.  Threads that were
    alive before are told apart by object, not by ``ident``: an ident is
    reused once its thread exits, so a new dispatcher may carry the ident
    of an earlier test's thread that exits meanwhile."""
    gated = _GatedPredictor(predictors[0])
    others = set(threading.enumerate())

    def dispatchers():
        return [t for t in threading.enumerate() if t.is_alive()
                and t.name == "irp-torch-microbatch"
                and t not in others]

    batcher = MicroBatcher(gated, window_ms=1.0)
    img = decode_blobs([_jpeg(4)])
    stuck = batcher.submit_async(img)
    deadline = time.monotonic() + 10
    while gated.calls == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    batcher.stop(timeout=0.05)
    batcher.start()
    gated.gate.set()
    assert stuck.wait(30).shape == (1, 3)
    assert batcher.submit(img, timeout=30).shape == (1, 3)
    deadline = time.monotonic() + 10
    while len(dispatchers()) > 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(dispatchers()) == 1
    batcher.stop()
    assert not dispatchers()


def test_cli_rejects_unported_flags_and_missing_card(tmp_path):
    from irp_tpu_torch.cli.serve_cli import main

    weights = str(tmp_path / "missing.npz")
    for flag in (["--replicas", "2"], ["--data-parallel"]):
        assert main(["--weights", weights, "--cpu", *flag]) == 2
    # --allow-reload is ported: the missing file is what refuses it
    assert main(["--weights", weights, "--cpu", "--allow-reload"]) == 2
    assert main(["--weights", str(tmp_path / "w.bin"), "--cpu"]) == 2
    if not torch.cuda.is_available():
        assert main(["--weights", weights]) == 2
