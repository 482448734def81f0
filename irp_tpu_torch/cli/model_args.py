"""Shared --family/--depth/--*-variant and training-recipe flags of the
training CLIs (the JAX package's ``cli/model_args.py``).

The flags are the JAX package's, so a command line carries over:
``--family resnet --depth 50``, ``--family vit --vit-variant b_16``,
``--family efficientnet --efficientnet-variant b0`` or ``--family
convnext --convnext-variant tiny`` (the variant tables of
``models/vit.py``, ``models/efficientnet.py``, ``models/convnext.py``).
Every family serves and trains; the recipe flags
(:func:`add_train_recipe_args`: mixup, CutMix, label smoothing, EMA, the
optimizer, the schedule, gradient accumulation) reach each family's run
through :func:`build_train_base`.
"""

from __future__ import annotations


def add_model_family_args(parser) -> None:
    parser.add_argument("--family",
                        choices=("resnet", "vit", "efficientnet",
                                 "convnext"),
                        default="resnet",
                        help="backbone family (default: resnet)")
    parser.add_argument("--depth", type=int, default=50,
                        help="ResNet depth 18/34/50/101/152 "
                             "(--family resnet only)")
    parser.add_argument("--vit-variant", default="b_16",
                        help="torchvision ViT size: b_16/b_32/l_16/l_32/"
                             "h_14 (--family vit only)")
    parser.add_argument("--efficientnet-variant", default="b0",
                        help="torchvision EfficientNet size: b0..b7 "
                             "(--family efficientnet only)")
    parser.add_argument("--convnext-variant", default="tiny",
                        help="torchvision ConvNeXt size: tiny/small/base/"
                             "large (--family convnext only)")


def model_config_for_family(family: str, *, depth: int = 50,
                            vit_variant: str = "b_16",
                            efficientnet_variant: str = "b0",
                            convnext_variant: str = "tiny", **overrides):
    """ModelConfig for a (family, variant) pair: the one construction
    point of the CLIs."""
    from irp_tpu_torch.config import ModelConfig

    if family == "vit":
        from irp_tpu_torch.models.vit import vit_model_config

        return vit_model_config(vit_variant, **overrides)
    if family == "efficientnet":
        from irp_tpu_torch.models.efficientnet import (
            efficientnet_model_config)

        return efficientnet_model_config(efficientnet_variant, **overrides)
    if family == "convnext":
        from irp_tpu_torch.models.convnext import convnext_model_config

        return convnext_model_config(convnext_variant, **overrides)
    return ModelConfig(depth=depth, **overrides)


def build_model_base(args, num_classes: int):
    """ModelConfig from parsed family args + the dataset's class count."""
    return model_config_for_family(
        args.family, depth=args.depth, vit_variant=args.vit_variant,
        efficientnet_variant=args.efficientnet_variant,
        convnext_variant=args.convnext_variant, num_classes=num_classes,
        image_size=args.image_size, pretrained_path=args.pretrained)


def add_train_recipe_args(parser) -> None:
    """Sweep-wide recipe knobs the search does not search (all off by
    default)."""
    parser.add_argument("--mixup-alpha", type=float, default=0.0,
                        help="Beta(a,a) mixup in the train step; 0 = off")
    parser.add_argument("--cutmix-alpha", type=float, default=0.0,
                        help="CutMix Beta(a,a); 0 = off. With both "
                             "alphas set, a per-step fair coin picks "
                             "the transform")
    parser.add_argument("--label-smoothing", type=float, default=0.0,
                        help="cross-entropy label smoothing; 0 = off")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="exponential moving average of the weights; "
                             "val/best/returned weights use it. 0 = off")
    parser.add_argument("--optimizer", choices=("adam", "adamw", "sgd"),
                        default="adam",
                        help="'adam' with coupled L2 (torch Adam), 'adamw' "
                             "decoupled decay, 'sgd' momentum 0.9")
    parser.add_argument("--schedule",
                        choices=("onecycle", "cosine", "constant"),
                        default="onecycle",
                        help="lr curve: OneCycleLR(cos), plain cosine "
                             "decay, or constant")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="micro-batches per optimizer step (the exact "
                             "full-batch gradient); 1 = off")


def build_train_base(args):
    """TrainConfig recipe base from parsed args; the searched
    hyperparameters are laid over it per trial."""
    from irp_tpu_torch.config import TrainConfig

    return TrainConfig(mixup_alpha=args.mixup_alpha,
                       cutmix_alpha=args.cutmix_alpha,
                       label_smoothing=args.label_smoothing,
                       ema_decay=args.ema_decay,
                       grad_accum_steps=args.grad_accum,
                       optimizer=args.optimizer,
                       schedule=args.schedule)
