"""Port parity: the ViT family (irp_tpu_torch/models/vit.py, its classifier,
convert, infer, Grad-CAM, .irpx and daemon surfaces) against the JAX
package's irp_tpu/models/vit.py on the CPU.

Sizes are tests/test_vit.py's: patch 8, embed 64, 3 layers, mlp 128, 32 px,
5 classes, hidden 32 (tests/torch_jax_families.py).  f32 logits and
surfaces within 1e-4 of the flax f32/'highest' forward, bf16 logits within
2^-6 of the largest flax bf16 logit; the hand-written VJP of the last block
within 1e-5 of torch.autograd and 1e-4 of jax.vjp; Grad-CAM maps and logits
within 1e-4 of irp_tpu.explain's program.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_jax_families as fam
from irp_tpu.models import classifier as jax_classifier
from irp_tpu.models.classifier import get_classifier as jax_get_classifier
from irp_tpu.models.torch_ref import TorchViTClassifier
from irp_tpu.models.vit import VIT_VARIANTS as JAX_VIT_VARIANTS
from irp_tpu.models.vit import vit_model_config as jax_vit_config
from irp_tpu_torch.explain import vit_logits_and_token_grad
from irp_tpu_torch.models import classifier
from irp_tpu_torch.models.vit import VIT_VARIANTS, vit_model_config

torch.set_num_threads(1)
FAMILY = "vit"
CFG = fam.CONFIGS[FAMILY]
BF16_TOL = 2.0 ** -6


def test_f32_logits_match_jax():
    fam.check_f32_logits(FAMILY)


def test_bf16_logits_match_jax():
    fam.check_bf16_logits(FAMILY, BF16_TOL)


def test_surfaces_match_jax():
    """features, the patch grid, head_from_spatial, and the Grad-CAM token
    surface: vit_tokens and vit_logits_from_tokens, whose composition is
    the forward bit for bit."""
    want = fam.check_surfaces(FAMILY)
    model = fam.port_model(CFG, fam.jax_variables(FAMILY))
    x = fam.nchw(fam.images(1))
    tokens = fam.torch_out(model.vit_tokens, x)
    assert tokens.shape == (3, 17, 64)
    assert fam.max_diff(tokens, want["tokens"]) <= fam.F32_TOL
    logits = fam.torch_out(model.vit_logits_from_tokens,
                           torch.from_numpy(want["tokens"].copy()))
    assert fam.max_diff(logits, want["logits_from_tokens"]) <= fam.F32_TOL
    own = fam.torch_out(model.vit_logits_from_tokens,
                        torch.from_numpy(tokens))
    assert np.array_equal(own, fam.torch_out(model, x))


def test_weights_round_trip_bit_for_bit():
    fam.check_round_trip(FAMILY)


def test_torch_ref_pth_loads_with_its_logits(tmp_path):
    torch.manual_seed(0)
    ref = TorchViTClassifier(num_classes=5, hidden=32, patch_size=8,
                             embed_dim=64, num_layers=3, num_heads=1,
                             mlp_dim=128, image_size=32)
    with torch.no_grad():
        ref.backbone.class_token.normal_(0.0, 0.5)
        for m in ref.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
    fam.check_torch_ref_pth(FAMILY, ref, tmp_path)


def _jax_shapes(cfg):
    model = jax_get_classifier(cfg)
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        jax.numpy.zeros((1, cfg.image_size, cfg.image_size, 3)),
        train=False))["params"]


@pytest.mark.parametrize("variant", sorted(VIT_VARIANTS))
def test_infer_model_config_matches_jax(variant):
    """Each torchvision size, by shapes at full size (jax.eval_shape), and
    the small test config; the variant tables equal."""
    assert VIT_VARIANTS == JAX_VIT_VARIANTS
    jcfg = jax_vit_config(variant, num_classes=10, image_size=224)
    assert dataclasses.asdict(vit_model_config(
        variant, num_classes=10, image_size=224)) == dataclasses.asdict(jcfg)
    got = fam.check_infer_config(FAMILY, _jax_shapes(jcfg), image_size=64)
    assert (got["patch_size"], got["embed_dim"], got["num_layers"],
            got["mlp_dim"], got["image_size"]) == (
        jcfg.patch_size, jcfg.embed_dim, jcfg.num_layers, jcfg.mlp_dim, 224)
    fam.check_infer_config(FAMILY, fam.jax_variables(FAMILY)["params"])


@pytest.mark.parametrize("stages,head_only", [
    (("layer4",), False), (("block2", "ln"), False), (("block0",), False),
    (("embed", "block2"), False), (("ln",), False), ((), True),
    (("block3",), False), (("block-1",), False), (("stage1",), False)])
def test_freezing_matches_jax(stages, head_only):
    fam.check_freezing(classifier._vit_frozen_prefix,
                       jax_classifier._vit_frozen_prefix, FAMILY, stages,
                       head_only)


def test_fused_on_refused_and_train_mode_runs():
    fam.check_refusals(FAMILY)


@pytest.mark.parametrize("class_idx", [None, [0, 4, -1, 2]],
                         ids=["argmax", "chosen"])
def test_gradcam_matches_jax(class_idx):
    fam.check_gradcam(FAMILY, class_idx)


def _tokens_and_targets():
    variables = fam.jax_variables(FAMILY)
    model = fam.port_model(CFG, variables)
    tokens = fam.torch_out(model.vit_tokens, fam.nchw(fam.images(9)))
    return variables, model, tokens, torch.tensor([-1, 3, 1])


def test_hand_written_vjp_matches_autograd():
    _, model, tokens, cls = _tokens_and_targets()
    t = torch.from_numpy(tokens).requires_grad_(True)
    logits = model.vit_logits_from_tokens(t)
    target = torch.where(cls < 0, logits.argmax(-1), cls)
    (want,) = torch.autograd.grad(logits.gather(1, target[:, None]).sum(), t)
    with torch.inference_mode():
        got_logits, got = vit_logits_and_token_grad(
            model, torch.from_numpy(tokens), cls)
    assert torch.equal(got_logits, logits.detach())
    assert float(want.abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-5


def test_hand_written_vjp_matches_jax_vjp():
    variables, model, tokens, cls = _tokens_and_targets()
    jmodel = jax_get_classifier(CFG)

    @jax.jit
    def vjp(params, a, cls):
        logits, back = jax.vjp(lambda t: jmodel.apply(
            {"params": params}, t, method="vit_logits_from_tokens"), a)
        target = jax.numpy.where(cls < 0, logits.argmax(-1), cls)
        return back(jax.nn.one_hot(target, logits.shape[-1]))[0]

    want = vjp(variables["params"], tokens, cls.numpy())
    with torch.inference_mode():
        _, got = vit_logits_and_token_grad(model, torch.from_numpy(tokens),
                                           cls)
    assert fam.max_diff(got.numpy(), want) <= 1e-4


def test_irpx_serves_the_live_predictor_bit_for_bit(tmp_path):
    fam.check_irpx(FAMILY, tmp_path)


def test_healthz_and_metrics_match_jax():
    fam.check_health_and_metrics(FAMILY)


@pytest.mark.parametrize("cli", ["hyperopt_cli", "final_cli"])
def test_training_clis_train_the_family(cli, tmp_path, monkeypatch):
    fam.check_training_cli(FAMILY, cli, tmp_path, monkeypatch)


def test_predict_cli_scores_and_explains_the_npz(tmp_path):
    fam.check_predict_cli(FAMILY, tmp_path)


@pytest.mark.parametrize("variant", ["b_16", "h_14"])
def test_model_config_for_family_matches_jax(variant):
    fam.check_model_config_for_family(FAMILY, variant)
