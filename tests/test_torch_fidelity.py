"""The fidelity harness of the port (``cli/fidelity_cli.py``) and its
torchvision-layout executors (``models/torch_ref.py``).

- The port's copy of ``torch_ref`` runs bit for bit as the JAX package's
  on the same state_dict and input, for every family.
- The port's classifier in f32 ('highest', unfused, eval-form BN) matches
  its executor within 1e-3 at the module level, as
  ``tests/test_fidelity.py`` holds the Flax classifier: ResNet-18,
  ResNeXt-50 32x4d and wide ResNet-50-2 at 56 px, and one narrow ViT,
  ConvNeXt and EfficientNet.
- ``fidelity_cli --cpu`` runs end to end on synthetic shards at 224 px,
  its classifier's logits equal the JAX CLI's Flax logits on the same
  weights within 1e-4, and ``--tolerance 0`` exits 2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import irp_tpu.models
from irp_tpu.models import torch_ref as jax_torch_ref
from irp_tpu_torch.cli import fidelity_cli
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models import torch_ref
from irp_tpu_torch.models.classifier import Classifier
from tests import torch_jax_families as fam
from tests.synth import make_synthetic_shards

torch.set_num_threads(1)
SIZE = 56
RESNETS = {
    "resnet18": dict(depth=18),
    "resnext50_32x4d": dict(depth=50, groups=32, width_per_group=4),
    "wide_resnet50_2": dict(depth=50, width_per_group=128),
}


def _config(name: str) -> ModelConfig:
    if name in RESNETS:
        return ModelConfig(**RESNETS[name], num_classes=10,
                           image_size=SIZE, dropout_rate=0.0,
                           compute_dtype="float32", precision="highest",
                           bn_stats_mode="all")
    return fam.port_config(fam.CONFIGS[name])


def _model(name: str, seed: int = 0) -> Classifier:
    """The port's eval-mode f32 classifier of ``name``, weights drawn from
    ``seed`` and every BN's statistics and affine moved off their init."""
    cfg = _config(name)
    if name not in RESNETS:
        return fam.port_model(fam.CONFIGS[name], fam.jax_variables(name))
    model = Classifier(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
    return model.eval()


def _executor(cfg, module, monkeypatch):
    """fidelity_cli's executor of ``cfg`` built from ``module`` (the port's
    torch_ref, or the JAX package's)."""
    import irp_tpu_torch.models as port_models

    with monkeypatch.context() as m:
        m.setattr(port_models, "torch_ref", module)
        return fidelity_cli.reference_executor(cfg)


def _loaded(ref, model):
    missing, unexpected = ref.load_state_dict(
        {k: v.float() for k, v in model.state_dict().items()}, strict=False)
    assert not unexpected, unexpected
    assert all("num_batches_tracked" in k for k in missing), missing
    return ref.eval()


def _inputs(cfg, n: int = 2) -> torch.Tensor:
    x = np.random.default_rng(3).normal(
        size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["resnet18", "vit", "convnext",
                                  "efficientnet"])
def test_torch_ref_copy_is_bit_equal_to_the_jax_copy(name, monkeypatch):
    model = _model(name)
    cfg = model.config
    x = _inputs(cfg).contiguous()
    with torch.no_grad():
        got = _loaded(_executor(cfg, torch_ref, monkeypatch), model)(x)
        want = _loaded(_executor(cfg, jax_torch_ref, monkeypatch), model)(x)
    assert type(got) is torch.Tensor and got.shape == (2, cfg.num_classes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(RESNETS) + ["vit", "convnext",
                                                  "efficientnet"])
def test_classifier_matches_its_torch_ref_within_1e_3(name):
    model = _model(name)
    cfg = model.config
    assert (cfg.compute_dtype, cfg.precision, cfg.fused_frozen_blocks) == (
        "float32", "highest", "off")
    x = _inputs(cfg)
    with torch.no_grad():
        ours = model(x.contiguous(memory_format=torch.channels_last))
        theirs = _loaded(fidelity_cli.reference_executor(cfg), model)(
            x.contiguous())
    diff = float((ours - theirs).abs().max())
    assert diff < 1e-3, f"max |port - torch_ref| = {diff}"
    assert float(theirs.abs().max()) > 1e-2  # logits that carry signal


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """Synthetic 224 px test shards and a ResNet-18 .pth (the port's
    seeded weights with moved BN statistics, torchvision keys)."""
    from irp_tpu_torch.train.checkpoint import export_torch_pth

    root = tmp_path_factory.mktemp("fidelity")
    make_synthetic_shards(str(root), num_classes=2, per_class=4,
                          samples_per_shard=8, seed=0, size=224,
                          prefix="test")
    model = _model("resnet18", seed=5)
    cfg = dataclasses.replace(model.config, num_classes=2, image_size=224)
    resized = Classifier(cfg)
    sd = model.state_dict()
    own = resized.state_dict()
    sd = {k: v if v.shape == own[k].shape else own[k]
          for k, v in sd.items()}  # the 2-class head keeps its init
    resized.load_state_dict(sd)
    pth = export_torch_pth(str(root / "r18.pth"), resized)
    return {"shards": str(root / "test-*.tar"), "pth": pth}


def _cli_args(world, *extra):
    return ["--shards", world["shards"], "--samples", "4", "--depth", "18",
            "--num-classes", "2", "--checkpoint", world["pth"], "--cpu",
            *extra]


def test_cli_runs_and_matches_the_jax_cli_logits(cli_world, monkeypatch,
                                                 capsys):
    import run_fidelity

    seen = {}
    compare = fidelity_cli.compare_logits

    def spy(model, images):
        seen["config"] = model.config
        seen["images"] = images
        seen["out"] = compare(model, images)
        return seen["out"]

    monkeypatch.setattr(fidelity_cli, "compare_logits", spy)
    assert fidelity_cli.main(_cli_args(cli_world)) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("samples: 4  max |logit diff|: ")
    assert line.endswith("tolerance: 0.001  -> PASS")
    cfg = seen["config"]
    assert (cfg.image_size, cfg.compute_dtype, cfg.precision,
            cfg.fused_frozen_blocks, cfg.bn_stats_mode, cfg.dropout_rate) \
        == (224, "float32", "highest", "off", "all", 0.0)
    ours, theirs, bad = seen["out"]
    assert not bad and ours.shape == (4, 2)
    assert np.abs(ours - theirs).max() < 1e-3

    # the JAX CLI on the same shards and weights: its Flax logits, read
    # off the model it builds
    flax_logits = []
    init = irp_tpu.models.init_classifier

    class Recorder:
        def __init__(self, model):
            self.model = model

        def apply(self, *args, **kw):
            out = self.model.apply(*args, **kw)
            flax_logits.append(np.asarray(out))
            return out

    def recording_init(*args, **kw):
        model, variables = init(*args, **kw)
        return Recorder(model), variables

    monkeypatch.setattr(irp_tpu.models, "init_classifier", recording_init)
    assert run_fidelity.main(_cli_args(cli_world)) == 0
    (want,) = flax_logits
    assert np.abs(ours - want).max() <= 1e-4


def test_cli_tolerance_zero_exits_2(cli_world, capsys):
    assert fidelity_cli.main(_cli_args(cli_world, "--tolerance", "0")) == 2
    assert capsys.readouterr().out.strip().endswith("-> FAIL")


def test_cli_without_shards_exits_1(tmp_path, capsys):
    assert fidelity_cli.main(["--shards", str(tmp_path / "none-*.tar"),
                              "--cpu"]) == 1
    assert "no shards match" in capsys.readouterr().err
