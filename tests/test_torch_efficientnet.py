"""Port parity: the EfficientNet family (irp_tpu_torch/models/efficientnet.py,
its classifier, convert, infer, Grad-CAM, .irpx and daemon surfaces) against
the JAX package's irp_tpu/models/efficientnet.py on the CPU.

Sizes are tests/test_efficientnet.py's: width and depth 0.5 (stem 16
channels, stage blocks 1,1,1,2,2,2,1), 32 px, 5 classes, hidden 32
(tests/torch_jax_families.py).  f32 logits and surfaces within 1e-4 of the
flax f32/'highest' forward, bf16 logits within 2^-5 of the largest flax
bf16 logit; Grad-CAM maps and logits within 1e-4 of irp_tpu.explain's
program at a 64 px crop (a 2x2 map); the B0-B7 ladder recovered from
full-size shapes as the JAX package recovers it.
"""

import dataclasses

import jax
import pytest
import torch

import torch_jax_families as fam
from irp_tpu.models import classifier as jax_classifier
from irp_tpu.models import efficientnet as jax_eff
from irp_tpu.models.classifier import get_classifier as jax_get_classifier
from irp_tpu.models.torch_ref import TorchEfficientNetClassifier
from irp_tpu_torch.models import classifier
from irp_tpu_torch.models import efficientnet as eff

torch.set_num_threads(1)
FAMILY = "efficientnet"
CFG = fam.CONFIGS[FAMILY]
BF16_TOL = 2.0 ** -5


def test_f32_logits_match_jax():
    fam.check_f32_logits(FAMILY)


def test_bf16_logits_match_jax():
    fam.check_bf16_logits(FAMILY, BF16_TOL)


def test_surfaces_match_jax():
    fam.check_surfaces(FAMILY)


def test_weights_round_trip_bit_for_bit():
    fam.check_round_trip(FAMILY)


def test_torch_ref_pth_loads_with_its_logits(tmp_path):
    torch.manual_seed(0)
    ref = TorchEfficientNetClassifier(num_classes=5, hidden=32,
                                      width_mult=0.5, depth_mult=0.5)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    fam.check_torch_ref_pth(FAMILY, ref, tmp_path, named=False)


def test_tables_match_jax():
    """The variant table, the scaled settings, the top width and the BN
    constants (eps 1e-3 for B5-B7) of every variant; make_divisible."""
    assert eff.EFFICIENTNET_VARIANTS == jax_eff.EFFICIENTNET_VARIANTS
    for v in eff.EFFICIENTNET_VARIANTS.values():
        wm, dm = v["width_mult"], v["depth_mult"]
        assert eff.scaled_setting(wm, dm) == jax_eff.scaled_setting(wm, dm)
        assert eff.top_channels(wm) == jax_eff.top_channels(wm)
        assert eff.bn_constants(wm, dm) == jax_eff.bn_constants(wm, dm)
    assert [eff.make_divisible(v) for v in (3, 12.8, 33.6, 100.0)] == [
        jax_eff.make_divisible(v) for v in (3, 12.8, 33.6, 100.0)]


@pytest.mark.parametrize("variant", sorted(eff.EFFICIENTNET_VARIANTS))
def test_infer_model_config_matches_jax(variant):
    """B0-B7 by shapes at full width and depth (jax.eval_shape, traced at
    32 px: the weights' shapes do not depend on the input size)."""
    jcfg = jax_eff.efficientnet_model_config(variant, num_classes=10,
                                             image_size=32)
    assert dataclasses.asdict(eff.efficientnet_model_config(
        variant, num_classes=10, image_size=32)) == dataclasses.asdict(jcfg)
    model = jax_get_classifier(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 32, 32, 3)),
        train=False))["params"]
    got = fam.check_infer_config(FAMILY, shapes)
    assert (got["width_mult"], got["depth_mult"]) == (jcfg.width_mult,
                                                       jcfg.depth_mult)


def test_infer_model_config_small_and_unnamed():
    """The test config (0.5, 0.5) is no named variant: both packages
    refuse it with the same message; with its cfg given it loads."""
    params = fam.jax_variables(FAMILY)["params"]
    from irp_tpu.infer import infer_model_config as jax_infer
    from irp_tpu_torch.infer import infer_model_config

    with pytest.raises(ValueError) as want:
        jax_infer(params)
    with pytest.raises(ValueError) as got:
        infer_model_config(params)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stages,head_only", [
    (("layer4",), False), (("stage7", "top"), False), (("stage3",), False),
    (("stem", "stage7"), False), (("top",), False), ((), True),
    (("stage8",), False), (("stage0",), False), (("block1",), False)])
def test_freezing_matches_jax(stages, head_only):
    fam.check_freezing(classifier._efficientnet_freezing,
                       jax_classifier._efficientnet_freezing, FAMILY, stages,
                       head_only)


def test_fused_on_refused_and_train_mode_runs():
    fam.check_refusals(FAMILY)


@pytest.mark.parametrize("class_idx", [None, [0, 4, -1, 2]],
                         ids=["argmax", "chosen"])
def test_gradcam_matches_jax(class_idx):
    fam.check_gradcam(FAMILY, class_idx, size=64)


def test_irpx_serves_the_live_predictor_bit_for_bit(tmp_path):
    fam.check_irpx(FAMILY, tmp_path)


def test_healthz_and_metrics_match_jax():
    fam.check_health_and_metrics(FAMILY)


@pytest.mark.parametrize("cli", ["hyperopt_cli", "final_cli"])
def test_training_clis_train_the_family(cli, tmp_path, monkeypatch):
    fam.check_training_cli(FAMILY, cli, tmp_path, monkeypatch)


@pytest.mark.parametrize("variant", ["b0", "b7"])
def test_model_config_for_family_matches_jax(variant):
    fam.check_model_config_for_family(FAMILY, variant)


def test_other_features_families_are_refused_as_in_jax():
    """A torchvision state_dict under features. that is neither MBConv nor
    ConvNeXt (here VGG's keys) is refused with the JAX package's message;
    a torchvision efficientnet_b0 state_dict's own 1000-way head is
    skipped."""
    from irp_tpu.models.convert import torch_state_dict_to_variables
    from irp_tpu_torch.models.convert import state_dict_to_jax_variables

    vgg = {"features.0.weight": torch.zeros(64, 3, 3, 3),
           "features.0.bias": torch.zeros(64),
           "classifier.0.weight": torch.zeros(10, 64)}
    with pytest.raises(ValueError) as want:
        torch_state_dict_to_variables(vgg)
    with pytest.raises(ValueError) as got:
        state_dict_to_jax_variables(vgg)
    assert str(got.value) == str(want.value)
    model = fam.port_model(CFG, fam.jax_variables(FAMILY))
    sd = {k[len("backbone."):]: v for k, v in model.state_dict().items()
          if k.startswith("backbone.")}
    sd["classifier.1.weight"] = torch.zeros(1000, 640)
    sd["classifier.1.bias"] = torch.zeros(1000)
    got = state_dict_to_jax_variables(sd)
    assert "head_dense1" not in got["params"]
    want = torch_state_dict_to_variables(sd)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool((a == b).all()), got, want))
