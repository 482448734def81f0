"""Shared --family/--depth/--*-variant and training-recipe flags of the
training CLIs (the JAX package's ``cli/model_args.py``).

The flags are the JAX package's, so a command line carries over.  Only
``--family resnet`` runs in the port: the other families raise
``NotImplementedError`` (ROADMAP A13).
"""

from __future__ import annotations


def add_model_family_args(parser) -> None:
    parser.add_argument("--family",
                        choices=("resnet", "vit", "efficientnet",
                                 "convnext"),
                        default="resnet",
                        help="backbone family (default: resnet; the others "
                             "are not ported yet)")
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


def model_config_for_family(family: str, *, depth: int = 50, **overrides):
    """ModelConfig for a family; the families other than resnet raise."""
    from irp_tpu_torch.config import ModelConfig

    if family != "resnet":
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP.md, Queue 1, "
            f"A13: the other model families)")
    return ModelConfig(depth=depth, **overrides)


def build_model_base(args, num_classes: int):
    """ModelConfig from parsed family args + the dataset's class count."""
    return model_config_for_family(
        args.family, depth=args.depth, num_classes=num_classes,
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
