"""Shared helpers of tests/test_torch_vit.py, test_torch_efficientnet.py and
test_torch_convnext.py: the JAX tests' small configurations, seeded weights
carried from the JAX classifier into the port, and jitted JAX surfaces.

Each family's JAX classifier's variable tree comes from ``model.init`` with
a seeded key (through ``jax.eval_shape``: compiling EfficientNet's init
alone takes most of a minute on one core), and its leaves are drawn with
numpy from a seed, as the JAX package's own family tests do
(zero-initialized class tokens, LayerNorm biases and layer scales would
hide a transposed or misplaced weight): kernels at 1/sqrt(fan-in), so
that a signal crosses the whole net (at a flat 0.05 EfficientNet's map
no longer depends on its input), scales near 1, layer scales in [0.1,
0.5], BatchNorm variances positive.  JAX runs jitted on the CPU; the
port runs on the CPU with one thread.
"""

import dataclasses
import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import torch

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import get_classifier as jax_get_classifier
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import Classifier
from irp_tpu_torch.models.convert import jax_variables_to_state_dict

# tests/test_vit.py:31, tests/test_efficientnet.py:42,
# tests/test_convnext.py:36
SIZE = 32
CONFIGS = {
    "vit": JaxModelConfig(family="vit", patch_size=8, embed_dim=64,
                          num_layers=3, mlp_dim=128, num_classes=5,
                          hidden_dim=32, image_size=SIZE, dropout_rate=0.0,
                          compute_dtype="float32", precision="highest"),
    "efficientnet": JaxModelConfig(family="efficientnet", width_mult=0.5,
                                   depth_mult=0.5, num_classes=5,
                                   hidden_dim=32, image_size=SIZE,
                                   dropout_rate=0.0, stochastic_depth=0.0,
                                   compute_dtype="float32",
                                   precision="highest"),
    "convnext": JaxModelConfig(family="convnext",
                               convnext_dims=(8, 16, 24, 32),
                               convnext_depths=(1, 1, 2, 1), num_classes=5,
                               hidden_dim=32, image_size=SIZE,
                               dropout_rate=0.0, stochastic_depth=0.0,
                               compute_dtype="float32",
                               precision="highest"),
}
F32_TOL = 1e-4  # f32 logits and surfaces against the flax f32/highest ones
CAM_TOL = 1e-4  # Grad-CAM maps and logits against irp_tpu.explain's


def bf16(cfg):
    """The config at the serving default: bf16 compute, default
    precision."""
    return dataclasses.replace(cfg, compute_dtype="bfloat16",
                               precision="default")


def port_config(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def jax_variables(family: str, seed: int = 0):
    """The family's small JAX classifier initialized from ``seed``, its
    leaves redrawn with numpy from ``seed``: numpy {'params',
    'batch_stats'}."""
    cfg = CONFIGS[family]
    model = jax_get_classifier(cfg)
    # the tree of model.init from the seed's key (traced, not compiled:
    # every leaf is redrawn below)
    variables = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, SIZE, SIZE, 3)),
        train=False))
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":  # signal-preserving: std 1 / sqrt(fan-in)
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, a.shape)
        if name == "scale":
            return 1.0 + rng.normal(0.0, 0.1, a.shape)
        if name == "layer_scale":
            return rng.uniform(0.1, 0.5, a.shape)
        if name == "var":
            return 0.5 + rng.uniform(size=a.shape)
        if name in ("class_token", "pos_embedding"):
            return rng.normal(0.0, 0.5, a.shape)
        return rng.normal(0.0, 0.05, a.shape)  # biases, BN means

    return {coll: jax.tree_util.tree_map_with_path(
        lambda p, a: leaf(p, a).astype(np.float32), variables.get(coll, {}))
        for coll in ("params", "batch_stats")}


def port_model(cfg, variables) -> Classifier:
    """The port's eval-mode CPU classifier of ``cfg`` (a JAX config) with
    ``variables`` carried across."""
    model = Classifier(port_config(cfg))
    model.load_state_dict(jax_variables_to_state_dict(variables))
    return model.to(memory_format=torch.channels_last).eval()


def images(seed: int, n: int = 3, size: int = SIZE) -> np.ndarray:
    """Normalized-range float32 NHWC inputs."""
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def sources(seed: int, n: int = 3, size: int = 40) -> np.ndarray:
    """uint8 (n, size, size, 3) sources for the eval crop."""
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def blocky_sources(seed: int, n: int, size: int) -> np.ndarray:
    """uint8 sources made of 4x4 flat blocks of random colour plus a
    little noise: regions that differ, so that a Grad-CAM map varies
    across the image by more than float rounding (on pixel noise alone a
    small random net's map is flat to 1e-6, and the min-max normalization
    turns that rounding into the whole [0, 1] range)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 4, 4, 3)).astype(np.float32)
    img = np.repeat(np.repeat(blocks, -(-size // 4), 1), -(-size // 4), 2)
    img = img[:, :size, :size] + rng.normal(0.0, 8.0, (n, size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _jitted(cfg, method):
    model = jax_get_classifier(cfg)
    if method is None:
        return jax.jit(lambda v, x: model.apply(v, x, train=False))
    return jax.jit(lambda v, x: model.apply(v, x, method=method))


def jax_apply(cfg, variables, x, method=None) -> np.ndarray:
    """``model.apply`` (eval form, or the named ``method``), jitted."""
    v = {"params": variables["params"]}
    if variables["batch_stats"]:
        v["batch_stats"] = variables["batch_stats"]
    return np.asarray(_jitted(cfg, method)(v, x), np.float32)


def torch_out(fn, *args) -> np.ndarray:
    with torch.no_grad():
        return fn(*args).float().numpy()


def max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def get_text(url: str) -> str:
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def model_info_line(text: str) -> str:
    """The ``irp_model_info`` sample of a /metrics page, without the
    port's extra ``device`` label."""
    [line] = [ln for ln in text.splitlines()
              if ln.startswith("irp_model_info{")]
    return line.replace(',device="cpu"', "")


# -- checks every family's test file runs -----------------------------------

@functools.lru_cache(maxsize=None)
def jax_surfaces(family: str) -> dict:
    """The f32 JAX classifier's logits and surfaces on ``images(1)``, from
    one jitted program (one compile instead of one per method)."""
    cfg = CONFIGS[family]
    model = jax_get_classifier(cfg)

    @jax.jit
    def run(v, x):
        out = {"logits": model.apply(v, x, train=False),
               "features": model.apply(v, x, method="features"),
               "spatial": model.apply(v, x, method="spatial_features")}
        out["head_from_spatial"] = model.apply(v, out["spatial"],
                                               method="head_from_spatial")
        if family == "vit":
            out["tokens"] = model.apply(v, x, method="vit_tokens")
            out["logits_from_tokens"] = model.apply(
                v, out["tokens"], method="vit_logits_from_tokens")
        return out

    variables = jax_variables(family)
    v = {"params": variables["params"]}
    if variables["batch_stats"]:
        v["batch_stats"] = variables["batch_stats"]
    return {k: np.asarray(a, np.float32)
            for k, a in run(v, images(1)).items()}


def check_f32_logits(family: str) -> None:
    cfg, variables = CONFIGS[family], jax_variables(family)
    want = jax_surfaces(family)["logits"]
    got = torch_out(port_model(cfg, variables), nchw(images(1)))
    assert np.abs(want).max() > 1e-2  # the logits are not all ~0
    assert max_diff(got, want) <= F32_TOL


def check_bf16_logits(family: str, tol: float) -> None:
    """bf16 logits within ``tol`` x max|logit| of the flax bf16 forward's
    (two bf16 forwards that round at different points)."""
    cfg, variables = bf16(CONFIGS[family]), jax_variables(family)
    x = images(2)
    want = jax_apply(cfg, variables, x)
    got = torch_out(port_model(cfg, variables), nchw(x))
    assert max_diff(got, want) <= tol * np.abs(want).max()


def check_surfaces(family: str) -> dict:
    """features, spatial_features and head_from_spatial against the JAX
    methods; head_from_spatial(spatial_features(x)) == forward(x) bit for
    bit in the port.  Returns the JAX surfaces."""
    cfg, variables = CONFIGS[family], jax_variables(family)
    model = port_model(cfg, variables)
    want = jax_surfaces(family)
    x = nchw(images(1))
    assert max_diff(torch_out(model.features, x), want["features"]) \
        <= F32_TOL
    spatial = torch_out(model.spatial_features, x)
    assert max_diff(spatial.transpose(0, 2, 3, 1), want["spatial"]) \
        <= F32_TOL
    # the JAX map through the port's head_from_spatial
    head = torch_out(model.head_from_spatial, torch.from_numpy(
        want["spatial"].transpose(0, 3, 1, 2).copy()))
    assert max_diff(head, want["head_from_spatial"]) <= F32_TOL
    if family != "vit":  # ViT's logits read the CLS token, not this grid
        own = torch_out(model.head_from_spatial, torch.from_numpy(spatial))
        assert np.array_equal(own, torch_out(model, x))
    return want


def check_round_trip(family: str) -> None:
    """jax -> port -> jax and port -> jax -> port, bit for bit."""
    from irp_tpu_torch.models.convert import state_dict_to_jax_variables

    variables = jax_variables(family)
    back = state_dict_to_jax_variables(jax_variables_to_state_dict(
        variables))
    leaves = jax.tree_util.tree_leaves_with_path
    want = {jax.tree_util.keystr(p): a for p, a in leaves(variables)}
    got = {jax.tree_util.keystr(p): a for p, a in leaves(back)}
    assert want.keys() == got.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    model = port_model(CONFIGS[family], variables)
    sd = model.state_dict()
    again = jax_variables_to_state_dict(state_dict_to_jax_variables(sd))
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    assert sd.keys() == again.keys()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def check_torch_ref_pth(family: str, ref, tmp_path,
                        named: bool = True) -> None:
    """A torchvision-layout ``.pth`` of the JAX package's torch fixture
    ``ref`` (an ``irp_tpu.models.torch_ref`` classifier) loads through
    ``load_predictor`` and gives ``ref``'s f32 logits; its bf16 predictor
    (the config inferred from the weights, or given when they are no
    ``named`` variant) scores as the ``.npz`` of the same weights."""
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch
    from irp_tpu_torch.train.checkpoint import save_model_npz

    cfg = CONFIGS[family]
    path = str(tmp_path / f"{family}.pth")
    torch.save(ref.state_dict(), path)
    pred = load_predictor(path, cfg=port_config(cfg), batch_size=2,
                          device="cpu")
    src = sources(4)
    x = eval_preprocess_batch(torch.from_numpy(src), SIZE,
                              torch.float32).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref.eval()(x.contiguous()).numpy()
    assert max_diff(torch_out(pred.model, x), want) <= F32_TOL
    given = None if named else port_config(bf16(cfg))
    served = load_predictor(path, cfg=given, batch_size=2, device="cpu",
                            image_size=SIZE)
    assert served.model.config.family == family
    npz = save_model_npz(str(tmp_path / f"{family}.npz"), pred.model,
                         meta={"image_size": SIZE})
    assert np.array_equal(served.predict_probs(src), load_predictor(
        npz, cfg=given, batch_size=2, device="cpu").predict_probs(src))


def check_infer_config(family: str, jax_tree, image_size: int = SIZE):
    """The port's infer_model_config against the JAX package's on the
    same tree (arrays or shapes)."""
    from irp_tpu.infer import infer_model_config as jax_infer
    from irp_tpu_torch.infer import infer_model_config

    want = dataclasses.asdict(jax_infer(jax_tree, image_size=image_size))
    got = dataclasses.asdict(infer_model_config(jax_tree,
                                                image_size=image_size))
    assert got == want
    assert got["family"] == family
    return got


def check_refusals(family: str) -> None:
    """'on' refused with the JAX package's message; 'auto' builds unfused;
    the train-mode forward runs (logits and a backward into the trainable
    stages), and switching back to ``.eval()`` gives the eval form's
    logits unchanged (once the BN statistics the train forward moved are
    put back)."""
    import pytest

    from irp_tpu.models.classifier import init_classifier as jax_init

    cfg = dataclasses.replace(CONFIGS[family], fused_frozen_blocks="on")
    with pytest.raises(ValueError) as want:
        jax_init(cfg, jax.random.PRNGKey(0), image_size=SIZE)
    with pytest.raises(ValueError) as got:
        Classifier(port_config(cfg))
    assert str(got.value) == str(want.value)
    model = port_model(dataclasses.replace(CONFIGS[family],
                                           fused_frozen_blocks="auto"),
                       jax_variables(family))
    x = nchw(images(5))
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        before = model(x)
    logits = model.train()(x, generator=torch.Generator().manual_seed(0))
    assert logits.shape == (3, 5) and torch.isfinite(logits).all()
    logits.sum().backward()
    assert all(p.grad is not None for p in model.parameters()
               if p.requires_grad)
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(buffers[n])
        assert torch.equal(model.eval()(x), before)


@functools.lru_cache(maxsize=None)
def _cam_fn(cfg, size):
    from irp_tpu.explain import _build_cam_fn

    return _build_cam_fn(jax_get_classifier(cfg), size)


def positive_head(variables):
    """``variables`` with |head weights| and zero head biases
    (tests/test_explain.py's fixture): positive channel weights, so that
    the maps of the CNN families' post-activation maps are not all
    zero."""
    params = dict(variables["params"])
    for name in ("head_dense1", "head_dense2"):
        params[name] = {"kernel": np.abs(params[name]["kernel"]) * 2.0,
                        "bias": np.zeros_like(params[name]["bias"])}
    return {"params": params, "batch_stats": variables["batch_stats"]}


def check_gradcam(family: str, class_idx, size: int = SIZE) -> None:
    """The live predictor's Grad-CAM against irp_tpu.explain's program on
    the same weights (with a positive head) and sources, at a ``size``
    crop (the CNN families need 64 px for a 2x2 map: at 32 px their map
    is one pixel and every normalized CAM is 0): maps and logits within
    CAM_TOL."""
    from irp_tpu_torch.explain import GradCAM
    from irp_tpu_torch.infer import make_predictor

    cfg = dataclasses.replace(CONFIGS[family], image_size=size)
    variables = positive_head(jax_variables(family))
    src = blocky_sources(6, n=4, size=size + 8)
    cls = (np.full((4,), -1, np.int32) if class_idx is None
           else np.asarray(class_idx, np.int32))
    fn = _cam_fn(cfg, size)
    want_cams, want_logits = (np.asarray(a) for a in fn(
        variables["params"], variables["batch_stats"], src, cls))
    pred = make_predictor(variables, cfg=port_config(cfg), batch_size=4,
                          device="cpu")
    cams, logits = GradCAM(pred).explain(src, class_idx)
    assert cams.shape == (4, size, size)
    assert (want_cams.reshape(4, -1).max(1) > 0.5).all()  # not all zero
    assert max_diff(cams, want_cams) <= CAM_TOL
    assert max_diff(logits, want_logits) <= CAM_TOL


def check_irpx(family: str, tmp_path) -> None:
    """A CPU .irpx of the family serves the live predictor's
    probabilities and Grad-CAM bit for bit, and predict_cli reads it."""
    from irp_tpu_torch.explain import GradCAM
    from irp_tpu_torch.export import export_predictor, read_export_meta
    from irp_tpu_torch.infer import load_predictor, make_predictor

    cfg = bf16(CONFIGS[family])
    live = make_predictor(jax_variables(family), cfg=port_config(cfg),
                          batch_size=2, device="cpu")
    path = export_predictor(live, str(tmp_path / f"{family}.irpx"),
                            source_size=40)
    meta = read_export_meta(path)
    assert meta["model_config"]["family"] == family
    assert meta["fused_frozen_blocks"] == "off"
    art = load_predictor(path, device="cpu")
    assert art.exported and art.model.config == dataclasses.replace(
        live.model.config, fused_frozen_blocks="off")
    src = sources(7, n=3)
    assert np.array_equal(art.predict_probs(src), live.predict_probs(src))
    for a, b in zip(GradCAM(art).explain(src, [1, -1, 0]),
                    GradCAM(live).explain(src, [1, -1, 0])):
        assert np.array_equal(a, b)


def check_health_and_metrics(family: str) -> None:
    """/healthz's model card and /metrics' irp_model_info of the port's
    daemon equal the JAX daemon's: the family, and a depth only for
    ResNet."""
    from irp_tpu.infer import make_predictor as jax_make_predictor
    from irp_tpu.serve import make_server as jax_make_server
    from irp_tpu_torch.infer import make_predictor
    from irp_tpu_torch.serve import make_server

    cfg, variables = CONFIGS[family], jax_variables(family)
    names = [f"c{i}" for i in range(cfg.num_classes)]
    servers = [
        make_server(make_predictor(variables, class_names=names,
                                   cfg=port_config(cfg), batch_size=2,
                                   device="cpu"), port=0),
        jax_make_server(jax_make_predictor(variables, class_names=names,
                                           cfg=cfg, batch_size=2), port=0)]
    try:
        pages = []
        for srv in servers:
            srv.start()
            url = f"http://127.0.0.1:{srv.port}"
            pages.append((get_json(f"{url}/healthz")["model"],
                          model_info_line(get_text(f"{url}/metrics"))))
    finally:
        for srv in servers:
            srv.stop()
    (card, info), (jax_card, jax_info) = pages
    assert card == jax_card and card["family"] == family
    assert "depth" not in card and "depth=" not in info
    assert info == jax_info


def check_freezing(port_fn, jax_fn, family: str, stages, head_only=False):
    """A freezing helper of the port against the JAX package's on one
    stage tuple: the same result, or a ValueError with the same message;
    resolve_trainable_stages likewise."""
    import pytest

    from irp_tpu.models.classifier import (
        resolve_trainable_stages as jax_resolve)
    from irp_tpu_torch.models.classifier import resolve_trainable_stages

    cfg = dataclasses.replace(CONFIGS[family], trainable_stages=stages,
                              head_only=head_only)
    assert resolve_trainable_stages(port_config(cfg)) == jax_resolve(cfg)
    resolved = jax_resolve(cfg)
    try:
        want = jax_fn(cfg, resolved)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_fn(port_config(cfg), resolved)
        assert str(got.value) == str(e)
        return
    assert port_fn(port_config(cfg), resolved) == want


def check_predict_cli(family: str, tmp_path) -> None:
    """predict_cli scores a folder of images from the family's ``.npz``
    (config inferred from the weights) as the port's predictor does, and
    that within bf16 of the JAX package's predictor on the decoded
    images; it writes one Grad-CAM overlay per image."""
    import csv
    import os

    from PIL import Image

    from irp_tpu.infer import make_predictor as jax_make_predictor
    from irp_tpu_torch.cli import predict_cli
    from irp_tpu_torch.data.pipeline import decode_blobs
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.train.checkpoint import save_weights_npz

    cfg, variables = bf16(CONFIGS[family]), jax_variables(family)
    npz = save_weights_npz(str(tmp_path / f"{family}.npz"),
                           variables["params"], variables["batch_stats"],
                           meta={"image_size": SIZE})
    root = tmp_path / "images"
    os.makedirs(root)
    paths = []
    for i, img in enumerate(blocky_sources(11, 3, 64)):
        paths.append(str(root / f"img{i}.png"))
        Image.fromarray(img).save(paths[-1])
    out = str(tmp_path / "preds.csv")
    base = ["--weights", npz, "--images", str(root), "--cpu",
            "--batch-size", "2"]
    assert predict_cli.main([*base, "--out", out, "--topk", "5"]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    paths = sorted(paths)
    ours = load_predictor(npz, batch_size=2, device="cpu").predict_paths(
        paths)
    assert [r["key"] for r in rows] == paths
    assert [int(r["label"]) for r in rows] == list(ours.labels)
    assert [r["prob"] for r in rows] == [
        f"{p[i]:.6f}" for p, i in zip(ours.probs, ours.labels)]
    want = jax_make_predictor(variables, cfg=cfg, batch_size=2) \
        .predict_probs(decode_blobs([open(p, "rb").read() for p in paths]))
    # two bf16 forwards: probabilities within 2e-2 (chip_smoke's bar),
    # labels equal where the top two are more than twice that apart
    assert max_diff(ours.probs, want) <= 2e-2
    top2 = np.sort(want, axis=1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 4e-2
    assert decisive.any()
    assert (ours.labels == want.argmax(1))[decisive].all()
    assert predict_cli.main([*base, "--gradcam",
                             str(tmp_path / "cams")]) == 0
    assert len(os.listdir(tmp_path / "cams")) == 3


def check_model_config_for_family(family: str, variant: str) -> None:
    """cli/model_args.py's ModelConfig for a (family, variant) equals the
    JAX package's."""
    from irp_tpu.cli.model_args import model_config_for_family as jax_mcf
    from irp_tpu_torch.cli.model_args import model_config_for_family

    kw = {f"{family}_variant": variant, "num_classes": 7,
          "image_size": 96}
    assert dataclasses.asdict(model_config_for_family(family, **kw)) == \
        dataclasses.asdict(jax_mcf(family, **kw))


# the small configs' widths, laid under a CLI's family config
_WIDTHS = {"vit": ("patch_size", "embed_dim", "num_layers", "mlp_dim",
                   "num_heads", "hidden_dim"),
           "efficientnet": ("width_mult", "depth_mult", "hidden_dim"),
           "convnext": ("convnext_dims", "convnext_depths", "hidden_dim")}


def check_training_cli(family: str, cli: str, tmp_path, monkeypatch):
    """``hyperopt_cli --family`` (--quick, one trial, two folds, adamw on
    the cosine schedule with label smoothing) on tests/synth.py shards at
    32 px on the CPU, then, for 'final_cli', ``final_cli --family`` on
    its study (EMA, two micro-batches, mixup and CutMix): every fit gets
    the family's config and the recipe flags; the trial COMPLETE with a
    finite value and ``recommended_epochs`` in its tracking run; the
    final ``.npz`` served by ``load_predictor`` as the family.  The
    variant's config keeps its recipe (stochastic depth, dropout,
    trainable stages) at the small configs' widths."""
    import os

    from irp_tpu_torch import tracking
    from irp_tpu_torch.cli import final_cli, hyperopt_cli, model_args
    from irp_tpu_torch.hyperopt import objective, runner
    from irp_tpu_torch.infer import load_predictor
    from irp_tpu_torch.train import final

    from tests.synth import make_synthetic_shards

    small = CONFIGS[family]
    widths = {k: getattr(small, k) for k in _WIDTHS[family]}
    real = model_args.model_config_for_family

    def tiny(fam_, **kw):
        return dataclasses.replace(real(fam_, **kw), **widths)

    monkeypatch.setattr(model_args, "model_config_for_family", tiny)
    fits = []

    def recorded(module):
        real_fit = module.fit

        def fit(*a, **kw):
            fits.append((a[3], a[4]))  # model_cfg, train_cfg
            return real_fit(*a, **kw)
        monkeypatch.setattr(module, "fit", fit)

    recorded(objective)
    recorded(final)
    data = str(tmp_path / "data")
    # two folds of 24 train images: above the quick space's batch of 16
    make_synthetic_shards(data, num_classes=3, per_class=16,
                          samples_per_shard=12, seed=0, size=48)
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    db = str(tmp_path / "study.db")
    base = ["--data-dir", data, "--cpu", "--family", family, "--storage",
            db, "--study-name", "tiny", "--cache-dir",
            str(tmp_path / "cache"), "--image-size", str(SIZE)]
    assert hyperopt_cli.main(base + [
        "--quick", "--n-trials", "1", "--k-folds", "2", "--seed", "0",
        "--optimizer", "adamw", "--schedule", "cosine",
        "--label-smoothing", "0.1"]) == 0
    assert len(fits) == 2
    for model_cfg, train_cfg in fits:
        assert model_cfg.family == family
        assert model_cfg.stochastic_depth == tiny(family).stochastic_depth
        assert (train_cfg.optimizer, train_cfg.schedule,
                train_cfg.label_smoothing) == ("adamw", "cosine", 0.1)
    [trial] = runner.create_study("tiny", db).get_trials()
    assert trial.state == "COMPLETE" and np.isfinite(trial.value)
    run = tracking.TrackingClient().get_run(
        trial.user_attrs["tracking_run_id"])
    assert run["params"]["recommended_epochs"] in ("1", "2")
    if cli == "hyperopt_cli":
        return
    make_synthetic_shards(data, num_classes=3, per_class=4,
                          samples_per_shard=12, seed=1, size=48,
                          prefix="test")
    ckpt = str(tmp_path / "ckpt")
    assert final_cli.main(base + [
        "--checkpoint-dir", ckpt, "--ema-decay", "0.9", "--grad-accum", "2",
        "--mixup-alpha", "0.2", "--cutmix-alpha", "1.0"]) == 0
    model_cfg, train_cfg = fits[-1]
    assert model_cfg.family == family
    assert (train_cfg.ema_decay, train_cfg.grad_accum_steps,
            train_cfg.mixup_alpha, train_cfg.cutmix_alpha) == (
        0.9, 2, 0.2, 1.0)
    npz = os.path.join(ckpt, "final_model.npz")
    pred = load_predictor(npz, cfg=port_config(bf16(dataclasses.replace(
        small, num_classes=3))), batch_size=2, device="cpu")
    assert pred.model.config.family == family
    probs = pred.predict_probs(sources(8, n=2, size=48))
    assert probs.shape == (2, 3) and np.isfinite(probs).all()
