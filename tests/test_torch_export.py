"""The port's ``.irpx`` (irp_tpu_torch/export.py), the K1 and K2 custom
ops it holds, and predict_cli's ``--export*`` flags, on the CPU.

- ``torch.library.opcheck`` on the ops (K1, K2 and the frozen prefix's
  epilogue).
- A depth-50 export with K1 'on' holds exactly 10 K1 nodes, 10 epilogue
  nodes and 1 K2 node in its forward and in its explain program.
- An artifact of ResNet18 at a 64 crop, float32, loads through
  ``load_predictor`` and scores bit-equal to the live predictor at every
  rung of its ladder; its baked explain program equals the live
  Grad-CAM; 'auto' on the CPU is written as 'off'.
- A program moved to another device runs there.
- ``--export-no-gradcam`` refuses Grad-CAM with the JAX package's exit
  code (predict_cli 2) and HTTP status (500 mentioning re-export).
- A JAX-made ``.irpx`` (``irp_tpu.export.export_predictor`` on the CPU,
  as tests/test_export.py makes it) is refused, naming its format.
"""

import collections
import dataclasses
import io
import json
import os
import urllib.error
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu import export as jax_export
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.infer import make_predictor as jax_make_predictor
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu_torch import export, infer
from irp_tpu_torch.cli import predict_cli
from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from irp_tpu_torch.explain import GradCAM
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.parallel.mesh import make_mesh
from irp_tpu_torch.serve import make_server

torch.set_num_threads(1)
NAMES = ["cat", "dog", "fox"]
TINY = ModelConfig(depth=18, num_classes=3, image_size=64, hidden_dim=16,
                   compute_dtype="float32")


def _predictor(cfg, batch_size, pad_buckets=None, seed=0, tta=False):
    model = init_classifier(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    return infer.Predictor(model=model, class_names=NAMES,
                           batch_size=batch_size, pad_buckets=pad_buckets,
                           tta=tta, device="cpu")


def _images(n, size=256, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """ResNet18/64 f32 at batch 4 with the ladder (1, 2, 4) and the
    explain program at batch 2, exported on the CPU."""
    root = tmp_path_factory.mktemp("export")
    live = _predictor(TINY, 4, pad_buckets=(1, 2, 4))
    path = export.export_predictor(live, str(root / "m.irpx"),
                                   gradcam_batch_size=2)
    return live, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_both_ops(dtype):
    images = torch.from_numpy(_images(2, 80))
    torch.library.opcheck(
        torch.ops.irp_tpu_torch.eval_preprocess.default,
        (images, 64, list(IMAGENET_MEAN), list(IMAGENET_STD), dtype))
    rng = np.random.default_rng(1)
    c, m = 64, 16
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
            for s in ((2, 5, 5, c), (c, m), (m,), (3, 3, m, m), (m,), (m, c),
                      (c,))]
    args = [t.to(dtype) if i in (0, 1, 3, 5) else t
            for i, t in enumerate(args)]
    torch.library.opcheck(torch.ops.irp_tpu_torch.identity_bottleneck.default,
                          tuple(args))
    y, r = (torch.from_numpy(rng.normal(size=(2, 7, 5, 16)).astype(
        np.float32)).to(dtype) for _ in range(2))
    b, b_r = (torch.from_numpy(rng.normal(size=16).astype(np.float32))
              for _ in range(2))
    for args in ((y, b, None, None, False), (y, b, r, b_r, False),
                 (y, b, None, None, True)):
        torch.library.opcheck(torch.ops.irp_tpu_torch.frozen_epilogue.default,
                              args)


def _ops(blob: bytes) -> collections.Counter:
    ep = torch.export.load(io.BytesIO(blob))
    return collections.Counter(str(n.target) for n in ep.graph.nodes
                               if n.op == "call_function")


def test_depth50_fused_export_holds_the_ops(tmp_path):
    cfg = ModelConfig(depth=50, num_classes=3, image_size=64, hidden_dim=16,
                      fused_frozen_blocks="on")
    live = _predictor(cfg, 2)
    path = export.export_predictor(live, str(tmp_path / "m50.irpx"),
                                   source_size=64)
    meta = export.read_export_meta(path)
    assert meta["fused_frozen_blocks"] == "on"
    assert meta["runtime"] == "torch" and meta["exported_on"] == "cpu"
    with zipfile.ZipFile(path) as zf:
        for member in ("program.pt2", "explain.pt2"):
            ops = _ops(zf.read(member))
            assert ops["irp_tpu_torch.identity_bottleneck.default"] == 10
            assert ops["irp_tpu_torch.frozen_epilogue.default"] == 10
            assert ops["irp_tpu_torch.eval_preprocess.default"] == 1
            assert ops["aten._assert_tensor_metadata.default"] == 0
    loaded = infer.load_predictor(path, device="cpu")
    assert loaded.model.config.fused_frozen_blocks == "on"
    images = _images(3, 64, seed=2)
    np.testing.assert_array_equal(loaded.predict_probs(images),
                                  live.predict_probs(images))


def test_artifact_scores_bit_equal_per_bucket(artifact):
    live, path = artifact
    loaded = infer.load_predictor(path, device="cpu")
    assert loaded.exported and loaded.source_size == 256
    assert loaded.batch_size == 4 and loaded.pad_buckets == (1, 2, 4)
    assert loaded.class_names == NAMES
    assert loaded.model.config.fused_frozen_blocks == "off"  # 'auto', CPU
    with zipfile.ZipFile(path) as zf:
        members = {i.filename: i.file_size for i in zf.infolist()}
    assert set(members) == {"meta.json", "program.pt2", "program.b1.pt2",
                            "program.b2.pt2", "explain.pt2", "weights.npz"}
    # the programs hold graphs; the weights ride once, in weights.npz
    assert max(v for k, v in members.items() if k.endswith(".pt2")) \
        < members["weights.npz"] / 10
    for n in (1, 2, 3, 4, 5, 9):  # rungs 1, 2, 4 and full batches
        images = _images(n, seed=n)
        np.testing.assert_array_equal(loaded.predict_probs(images),
                                      live.predict_probs(images))
    with pytest.raises(ValueError, match="exactly 256x256"):
        loaded.predict_probs(_images(1, 240))
    with pytest.raises(ValueError, match="re-export"):
        export.export_predictor(loaded, path + ".again")


def test_baked_explain_equals_live_gradcam(artifact):
    live, path = artifact
    loaded = infer.load_predictor(path, device="cpu")
    images = _images(3, seed=11)
    cls = np.array([-1, 2, 0], np.int32)
    got = GradCAM(loaded).explain(images, cls)
    want = GradCAM(live, batch_size=2).explain(images, cls)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="batch_size=2"):
        GradCAM(loaded, batch_size=8)


def test_program_runs_on_another_device(artifact):
    """A program exported on the CPU, moved to the meta device (the move
    an artifact makes between the CPU and the card), runs there: no
    device is baked into its graph."""
    live, path = artifact
    weights = {k: v.to("meta") for k, v in
               export.program_inputs(live.model, False).items()}
    with zipfile.ZipFile(path) as zf:
        call = export._load_program(zf.read("program.b2.pt2"),
                                    torch.device("meta"), weights)
    out = call(torch.empty((2, 256, 256, 3), dtype=torch.uint8,
                           device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 3)


def test_load_refusals(artifact, tmp_path):
    _, path = artifact
    with pytest.raises(ValueError, match="pad_buckets"):
        infer.load_predictor(path, pad_buckets=(1, 4), device="cpu")
    with pytest.raises(ValueError, match="without TTA"):
        infer.load_predictor(path, tta=True, device="cpu")
    with pytest.raises(ValueError, match="cannot take a mesh"):
        infer.load_predictor(path, mesh=make_mesh(devices=["cpu"]),
                             device="cpu")
    newer = tmp_path / "newer.irpx"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(newer, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename == "meta.json":
                meta = json.loads(data)
                meta["format_version"] = export.FORMAT_VERSION + 1
                data = json.dumps(meta).encode()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="newer"):
        infer.load_predictor(str(newer), device="cpu")


def test_tta_is_baked(tmp_path):
    live = _predictor(TINY, 2, tta=True)
    path = export.export_predictor(live, str(tmp_path / "tta.irpx"),
                                   gradcam=False)
    loaded = infer.load_predictor(path, tta=True, device="cpu")
    assert loaded.tta
    images = _images(2, seed=5)
    np.testing.assert_array_equal(loaded.predict_probs(images),
                                  live.predict_probs(images))


def test_jax_made_irpx_is_refused_by_name(tmp_path):
    cfg = JaxModelConfig(depth=18, num_classes=3, image_size=64,
                         hidden_dim=16, compute_dtype="float32")
    _, variables = jax_init(cfg, jax.random.PRNGKey(0), image_size=64)
    theirs = jax_make_predictor(variables, cfg=cfg, batch_size=2)
    path = jax_export.export_predictor(theirs, str(tmp_path / "jax.irpx"),
                                       platforms=("cpu",), gradcam=False)
    assert "program.shlo" in zipfile.ZipFile(path).namelist()
    with pytest.raises(ValueError, match="JAX package's StableHLO"):
        infer.load_predictor(path, device="cpu")
    assert export.tta_preflight_error(path, "x").count("StableHLO") == 1


def _jpegs(root, n):
    rng = np.random.default_rng(9)
    os.makedirs(root)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (300, 300, 3), np.uint8)).save(
            os.path.join(root, f"img{i}.png"))
    return str(root)


def test_predict_cli_export_and_no_gradcam(tmp_path, capsys):
    """--export writes an artifact that --weights scores as the .npz does;
    --export-no-gradcam's artifact refuses --gradcam (exit 2) and the
    daemon's /explain (500, naming re-export)."""
    from irp_tpu_torch.train.checkpoint import save_model_npz

    live = _predictor(TINY, 4)
    npz = save_model_npz(str(tmp_path / "w.npz"), live.model,
                         meta={"image_size": 64})
    images = _jpegs(tmp_path / "images", 3)
    for name, extra in (("full.irpx", []),
                        ("lean.irpx", ["--export-no-gradcam"])):
        capsys.readouterr()
        assert predict_cli.main(["--weights", npz, "--export",
                                 str(tmp_path / name), "--batch-size", "2",
                                 "--export-batch-buckets", "auto", "--cpu",
                                 *extra]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["pad_buckets"] == [1, 2]
        assert summary["gradcam_batch_size"] == (None if extra else 2)
        assert summary["fused_frozen_blocks"] == "off"
    base = ["--images", images, "--cpu", "--classes", ",".join(NAMES)]
    outs = {}
    for name in ("w.npz", "full.irpx"):
        out = str(tmp_path / f"{name}.csv")
        assert predict_cli.main(["--weights", str(tmp_path / name),
                                 "--batch-size", "2", "--out", out,
                                 *base]) == 0
        with open(out) as f:
            outs[name] = f.read()
    assert outs["w.npz"] == outs["full.irpx"]
    assert predict_cli.main(["--weights", str(tmp_path / "full.irpx"),
                             "--gradcam", str(tmp_path / "cams"),
                             *base]) == 0
    assert len(os.listdir(tmp_path / "cams")) == 3
    capsys.readouterr()
    assert predict_cli.main(["--weights", str(tmp_path / "lean.irpx"),
                             "--gradcam", str(tmp_path / "none"),
                             *base]) == 2
    assert "no Grad-CAM program" in capsys.readouterr().err
    for argv, match in (
            (["--weights", str(tmp_path / "full.irpx"), "--export",
              str(tmp_path / "again.irpx")], "already an exported"),
            (["--weights", str(tmp_path / "full.irpx"), "--tta", *base],
             "without TTA"),
            (["--weights", npz, "--export", str(tmp_path / "x.irpx"),
              "--export-batch-buckets", "3,5"], "ending at")):
        capsys.readouterr()
        assert predict_cli.main([*argv, "--cpu"]) == 2
        assert match in capsys.readouterr().err
    lean = infer.load_predictor(str(tmp_path / "lean.irpx"), device="cpu")
    srv = make_server(lean, port=0)
    srv.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(_images(1)[0]).save(buf, "PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/explain", data=buf.getvalue(),
            headers={"Content-Type": "image/png"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 500
        assert "re-export" in json.loads(err.value.read())["error"]
    finally:
        srv.stop()


def test_model_config_round_trips(artifact):
    _, path = artifact
    meta = export.read_export_meta(path)
    cfg = export._model_config(meta)
    assert cfg == dataclasses.replace(TINY, fused_frozen_blocks="off")
