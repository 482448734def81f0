"""Port parity: the ConvNeXt family (irp_tpu_torch/models/convnext.py, its
classifier, convert, infer, Grad-CAM, .irpx and daemon surfaces) against
the JAX package's irp_tpu/models/convnext.py on the CPU.

Sizes are tests/test_convnext.py's: dims (8, 16, 24, 32), depths (1, 1, 2,
1), 32 px, 5 classes, hidden 32 (tests/torch_jax_families.py).  f32 logits
and surfaces within 1e-4 of the flax f32/'highest' forward, bf16 logits
within 2^-5 of the largest flax bf16 logit; Grad-CAM maps and logits, whose
derivative goes back through the post-pool LayerNorm, within 1e-4 of
irp_tpu.explain's program at a 64 px crop (a 2x2 map).
"""

import dataclasses

import jax
import pytest
import torch

import torch_jax_families as fam
from irp_tpu.models import classifier as jax_classifier
from irp_tpu.models import convnext as jax_cnx
from irp_tpu.models.classifier import get_classifier as jax_get_classifier
from irp_tpu.models.torch_ref import TorchConvNeXtClassifier
from irp_tpu_torch.explain import head_logits_and_grad
from irp_tpu_torch.models import classifier
from irp_tpu_torch.models import convnext as cnx

torch.set_num_threads(1)
FAMILY = "convnext"
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
    ref = TorchConvNeXtClassifier(num_classes=5, hidden=32,
                                  dims=(8, 16, 24, 32), depths=(1, 1, 2, 1))
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if name.endswith("layer_scale"):
                p.uniform_(0.1, 0.5)
            elif p.ndim == 1 and "classifier" not in name:
                p.add_(torch.randn(p.shape) * 0.1)
    fam.check_torch_ref_pth(FAMILY, ref, tmp_path)


def test_torchvision_classifier_0_is_the_final_layer_norm():
    """torchvision keeps the post-pool LayerNorm at classifier.0 and its
    own Linear at classifier.2: the first loads as the port's
    backbone.ln, the second is skipped, as in the JAX package."""
    from irp_tpu.models.convert import torch_state_dict_to_variables
    from irp_tpu_torch.models.convert import state_dict_to_jax_variables

    model = fam.port_model(CFG, fam.jax_variables(FAMILY))
    sd = {k[len("backbone."):]: v for k, v in model.state_dict().items()
          if k.startswith("backbone.")}
    sd["classifier.0.weight"] = sd.pop("ln.weight")
    sd["classifier.0.bias"] = sd.pop("ln.bias")
    sd["classifier.2.weight"] = torch.zeros(1000, 32)
    sd["classifier.2.bias"] = torch.zeros(1000)
    got = state_dict_to_jax_variables(sd)
    want = torch_state_dict_to_variables(sd)
    assert "head_dense1" not in got["params"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool((a == b).all()), got, want))


def test_tables_match_jax():
    assert cnx.CONVNEXT_VARIANTS == jax_cnx.CONVNEXT_VARIANTS


@pytest.mark.parametrize("variant", sorted(cnx.CONVNEXT_VARIANTS))
def test_infer_model_config_matches_jax(variant):
    """Each torchvision size by shapes at full width (jax.eval_shape at
    32 px), and the small test config."""
    jcfg = jax_cnx.convnext_model_config(variant, num_classes=10,
                                         image_size=32)
    assert dataclasses.asdict(cnx.convnext_model_config(
        variant, num_classes=10, image_size=32)) == dataclasses.asdict(jcfg)
    model = jax_get_classifier(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 32, 32, 3)),
        train=False))["params"]
    got = fam.check_infer_config(FAMILY, shapes)
    assert (got["convnext_dims"], got["convnext_depths"]) == (
        jcfg.convnext_dims, jcfg.convnext_depths)
    fam.check_infer_config(FAMILY, fam.jax_variables(FAMILY)["params"])


@pytest.mark.parametrize("stages,head_only", [
    (("layer4",), False), (("stage4", "ln"), False), (("stage2",), False),
    (("stem",), False), (("ln",), False), ((), True), (("stage5",), False),
    (("block1",), False)])
def test_freezing_matches_jax(stages, head_only):
    fam.check_freezing(classifier._convnext_freezing,
                       jax_classifier._convnext_freezing, FAMILY, stages,
                       head_only)


def test_fused_on_refused_and_train_mode_runs():
    fam.check_refusals(FAMILY)


def test_head_grad_through_layer_norm_matches_autograd():
    """The closed-form derivative of the selected logit by the pooled map
    (pool -> final LayerNorm -> head) equals torch.autograd's."""
    model = fam.port_model(CFG, fam.jax_variables(FAMILY))
    acts = model.spatial_features(fam.nchw(fam.images(10))).detach()
    cls = torch.tensor([2, -1, 0])
    pooled = acts.mean(dim=(2, 3)).requires_grad_(True)
    logits = model.head_eval(model.backbone.ln(pooled))
    target = torch.where(cls < 0, logits.argmax(-1), cls)
    (want,) = torch.autograd.grad(logits.gather(1, target[:, None]).sum(),
                                  pooled)
    with torch.no_grad():
        _, got = head_logits_and_grad(model, acts, cls)
    assert float((got - want).abs().max()) <= 1e-5


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


def test_predict_cli_scores_and_explains_the_npz(tmp_path):
    fam.check_predict_cli(FAMILY, tmp_path)


@pytest.mark.parametrize("variant", ["tiny", "large"])
def test_model_config_for_family_matches_jax(variant):
    fam.check_model_config_for_family(FAMILY, variant)
