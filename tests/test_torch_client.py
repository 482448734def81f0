"""The port's client (irp_tpu_torch/client.py) against the port's daemon on
the CPU, as tests/test_client.py drives the JAX package's pair.

The port's client takes an ndarray by ``isinstance``, so that a subclass
defined outside numpy (here, in this module) is encoded; the JAX client
detects arrays by their type's module name and refuses it
(irp_tpu/client.py:53, ROADMAP Queue 3: not copied).
"""

import io
import os
import socket
import sys
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu import client as jax_client
from irp_tpu_torch import client, infer
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data.pipeline import decode_blobs
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.serve import make_server
from irp_tpu_torch.train.checkpoint import save_model_npz

torch.set_num_threads(1)
CFG = ModelConfig(depth=18, num_classes=3, image_size=64, hidden_dim=16,
                  compute_dtype="float32")
NAMES = ["cat", "dog", "fox"]


class Pixels(np.ndarray):
    """An ndarray subclass from outside numpy."""


def _load(path):
    return infer.load_predictor(path, class_names=NAMES, batch_size=4,
                                device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("client")
    paths = []
    for seed in (0, 1):
        model = init_classifier(CFG, torch.Generator().manual_seed(seed),
                                device="cpu")
        paths.append(save_model_npz(str(root / f"w{seed}.npz"), model,
                                    meta={"image_size": 64}))
    srv = make_server(_load(paths[0]), port=0, loader=_load,
                      weights_path=paths[0])
    srv.start()
    yield {"root": root, "weights": paths, "server": srv,
           "client": client.ServingClient(f"http://127.0.0.1:{srv.port}")}
    srv.stop()


def _array(seed, size=80):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                np.uint8)


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def test_predict_takes_bytes_paths_arrays_and_lists(world):
    c = world["client"]
    assert c.wait_until_ready(timeout_s=30)["status"] == "ok"
    assert c.healthz()["model"]["class_names"] == NAMES
    arr = _array(2)
    path = world["root"] / "img.png"
    path.write_bytes(_png_bytes(arr))
    want = _load(world["weights"][0]).predict_probs(
        decode_blobs([_png_bytes(arr)]))
    for image in (_png_bytes(arr), str(path), path, arr):
        [pred] = c.predict(image, topk=3)
        assert pred["label"] == int(want.argmax())
        assert pred["label_name"] == NAMES[pred["label"]]
        for item in pred["topk"]:
            assert item["prob"] == round(float(want[0, item["label"]]), 6)
    batch = c.predict([arr, _array(3), str(path)])
    assert len(batch) == 3 and batch[0] == batch[2]
    assert c.predict([]) == []
    with pytest.raises(TypeError, match="unsupported"):
        c.predict(3.5)
    with pytest.raises(ValueError, match=r"\(H,W,3\)"):
        c.predict(np.zeros((4, 4), np.uint8)[None])


def test_explain_stats_metrics(world, tmp_path):
    c = world["client"]
    out = tmp_path / "cam.png"
    ex = c.explain(_array(4), class_idx=2, topk=2, overlay_path=str(out))
    assert ex["explained_class"] == 2 and len(ex["topk"]) == 2
    assert ex["overlay_png"] == out.read_bytes()
    assert Image.open(out).size == (64, 64)
    assert c.stats()["explain"]["requests"] >= 1
    assert "irp_explain_images_total" in c.metrics_text()
    with pytest.raises(client.ServingError) as err:
        c.explain(_array(4), class_idx=9)
    assert err.value.status == 400 and "class" in err.value.message


def test_reload_through_the_client(world):
    c, srv = world["client"], world["server"]
    arr = _array(5)
    w0, w1 = world["weights"]
    before = c.predict(arr, topk=3)
    result = c.reload(w1, timeout_s=120)
    assert result["generation"] == 1 and result["class_names"] == NAMES
    want = _load(w1).predict_probs(decode_blobs([_png_bytes(arr)]))
    [after] = c.predict(arr, topk=3)
    for item in after["topk"]:
        assert item["prob"] == round(float(want[0, item["label"]]), 6)
    with pytest.raises(client.ServingError) as err:
        c.reload(str(world["root"] / "missing.npz"), timeout_s=30)
    assert err.value.status == 400
    assert c.healthz()["generation"] == 1
    assert c.reload(w0, timeout_s=120)["generation"] == 2
    assert c.predict(arr, topk=3) == before
    assert "irp_reloads_total 2" in c.metrics_text()
    assert srv.batcher.predictor.class_names == NAMES


def test_reload_disabled_is_403(world):
    srv = make_server(_load(world["weights"][0]), port=0)
    srv.start()
    try:
        c = client.ServingClient(f"http://127.0.0.1:{srv.port}")
        with pytest.raises(client.ServingError) as err:
            c.reload(world["weights"][1], timeout_s=30)
        assert err.value.status == 403
        assert "--allow-reload" in err.value.message
    finally:
        srv.stop()


def test_an_ndarray_subclass_is_encoded_where_the_jax_client_refuses(world):
    arr = _array(6).view(Pixels)
    assert type(arr).__module__ == __name__
    assert client._encode_image(arr) == _png_bytes(np.asarray(arr))
    [pred] = world["client"].predict(arr)
    [plain] = world["client"].predict(np.asarray(arr))
    assert pred == plain
    with pytest.raises(TypeError, match="unsupported image type"):
        jax_client._encode_image(arr)


def test_wait_until_ready_times_out_on_a_closed_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    c = client.ServingClient(f"http://127.0.0.1:{port}", timeout_s=1)
    with pytest.raises(TimeoutError, match="not ready"):
        c.wait_until_ready(timeout_s=0.3, poll_s=0.1)


def test_bytes_and_paths_need_no_numpy(tmp_path):
    """The client module and its bytes/path encoding import no numpy."""
    path = tmp_path / "x.bin"
    path.write_bytes(b"abc")
    code = ("import sys, importlib.util\n"
            "spec = importlib.util.spec_from_file_location('c', sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert mod._encode_image(b'xy') == b'xy'\n"
            "assert mod._encode_image(sys.argv[2]) == b'abc'\n"
            "assert 'numpy' not in sys.modules\n")
    src = os.path.join(os.path.dirname(client.__file__), "client.py")
    subprocess.run([sys.executable, "-c", code, src, str(path)], check=True,
                   timeout=60)



def test_serve_cli_serves_an_irpx_and_reloads(world, tmp_path):
    """serve_cli --weights m.irpx --allow-reload: the artifact answers
    /predict as its .npz does and /explain from its baked program, then
    /reload swaps in live weights; SIGTERM drains to exit 0."""
    import signal

    from irp_tpu_torch.export import export_predictor

    w0, w1 = world["weights"]
    irpx = export_predictor(infer.load_predictor(w0, batch_size=2,
                                                 device="cpu"),
                            str(tmp_path / "m.irpx"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "irp_tpu_torch.cli.serve_cli", "--weights",
         irpx, "--cpu", "--port", "0", "--allow-reload", "--batch-size", "2",
         "--classes", ",".join(NAMES)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving on "):
                url = line.split()[2]
                break
        assert url is not None and "POST /reload" in line
        c = client.ServingClient(url, timeout_s=120)
        arr = _array(7)
        [pred] = c.predict(arr, topk=3)
        want = infer.load_predictor(w0, batch_size=2, device="cpu")
        want = want.predict_probs(decode_blobs([_png_bytes(arr)]))
        for item in pred["topk"]:
            assert item["prob"] == round(float(want[0, item["label"]]), 6)
        assert pred["label_name"] == NAMES[pred["label"]]
        ex = c.explain(arr)
        assert ex["overlay_png"][:4] == b"\x89PNG"
        assert ex["label"] == pred["label"]
        assert c.reload(w1, timeout_s=120)["generation"] == 1
        assert c.healthz()["weights"] == w1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        finally:
            proc.kill()
    assert rc == 0
