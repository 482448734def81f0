"""Hand-written PyTorch ResNet + ViT + EfficientNet + ConvNeXt executors
under torchvision's module names, for the fidelity CLI and its tests: the
port's own copy of the JAX package's ``models/torch_ref.py``.

torchvision is not a dependency; these minimal modules reproduce
torchvision.models.resnet (v1.5 stride placement),
torchvision.models.vision_transformer (pre-LN blocks, eps=1e-6, exact
GELU, CLS pooling), torchvision.models.efficientnet (MBConv + SE), and
torchvision.models.convnext (CNBlocks + layer scale) exactly, with the
same state_dict keys, so a port model's state_dict (torchvision keys,
``train/checkpoint.py::export_torch_pth``) runs here as it is and its
logits can be held against the port's forward at the 1e-3 eval-fidelity
bar (``cli/fidelity_cli.py``).
"""

from collections import OrderedDict
from functools import partial

import torch
import torch.nn as nn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, layers, num_classes=1000, groups=1,
                 width_per_group=64):
        super().__init__()
        if block.expansion == 1 and (groups != 1 or width_per_group != 64):
            # match torchvision: BasicBlock has no grouped/widened form
            raise ValueError(
                "BasicBlock only supports groups=1 and base_width=64")
        self.inplanes = 64
        self.groups = groups
        self.base_width = width_per_group
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2)
        self.layer3 = self._make_layer(block, 256, layers[2], 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 2)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Identity()  # headless (reference model.py:27)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1,
                          stride, bias=False),
                nn.BatchNorm2d(planes * block.expansion))
        kwargs = ({} if block.expansion == 1 else
                  dict(groups=self.groups, base_width=self.base_width))
        layers = [block(self.inplanes, planes, stride, downsample, **kwargs)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kwargs))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x)
        return torch.flatten(x, 1)


class TorchAnimalClassifier(nn.Module):
    """The reference AnimalClassifier shape (reference model.py:9-41)."""

    def __init__(self, depth=50, num_classes=10, hidden=512, groups=1,
                 width_per_group=64):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        block = Bottleneck if depth >= 50 else BasicBlock
        self.backbone = ResNet(block, layers, groups=groups,
                               width_per_group=width_per_group)
        feat = 512 * block.expansion
        self.classifier = nn.Sequential(
            nn.Dropout(0.0), nn.Linear(feat, hidden), nn.ReLU(),
            nn.Dropout(0.0), nn.Linear(hidden, num_classes))

    def forward(self, x):
        return self.classifier(self.backbone(x))


class _SqueezeExcitation(nn.Module):
    """torchvision.ops.SqueezeExcitation with SiLU activation (the
    efficientnet configuration): avgpool -> fc1 1x1 -> SiLU -> fc2 1x1 ->
    sigmoid scale."""

    def __init__(self, input_channels, squeeze_channels):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc1 = nn.Conv2d(input_channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, input_channels, 1)
        self.activation = nn.SiLU(inplace=True)
        self.scale_activation = nn.Sigmoid()

    def forward(self, x):
        s = self.fc2(self.activation(self.fc1(self.avgpool(x))))
        return x * self.scale_activation(s)


def _cna(in_ch, out_ch, kernel, stride, groups, norm_layer, activation):
    """torchvision Conv2dNormActivation: conv (no bias) + BN + activation
    — submodule indices 0/1/2 so state_dict keys line up."""
    layers = [nn.Conv2d(in_ch, out_ch, kernel, stride,
                        (kernel - 1) // 2, groups=groups, bias=False),
              norm_layer(out_ch)]
    if activation is not None:
        layers.append(activation(inplace=True))
    return nn.Sequential(*layers)


class _MBConv(nn.Module):
    """torchvision MBConv (expand -> depthwise -> SE -> project) with the
    exact ``block.{i}`` submodule layout."""

    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride,
                 sd_prob, norm_layer):
        super().__init__()
        from irp_tpu_torch.models.efficientnet import make_divisible

        self.use_res = stride == 1 and in_ch == out_ch
        self.sd_prob = sd_prob
        expanded = (make_divisible(in_ch * expand_ratio)
                    if expand_ratio != 1 else in_ch)
        layers = []
        if expand_ratio != 1:
            layers.append(_cna(in_ch, expanded, 1, 1, 1, norm_layer,
                               nn.SiLU))
        layers.append(_cna(expanded, expanded, kernel, stride, expanded,
                           norm_layer, nn.SiLU))
        layers.append(_SqueezeExcitation(expanded, max(1, in_ch // 4)))
        layers.append(_cna(expanded, out_ch, 1, 1, 1, norm_layer, None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        y = self.block(x)
        if self.use_res:
            if self.training and self.sd_prob > 0.0:
                keep = 1.0 - self.sd_prob
                mask = torch.empty(x.shape[0], 1, 1, 1,
                                   device=x.device).bernoulli_(keep)
                y = y * mask / keep
            y = y + x
        return y


class TorchEfficientNet(nn.Module):
    """Headless torchvision-layout EfficientNet (globally-pooled feature).

    State_dict keys match torchvision.models.efficientnet_b* exactly
    (features.0.{0,1} stem, features.{1..7}.{j}.block.{k} MBConv stages,
    features.8.{0,1} head conv); the classifier is omitted (the port's
    Classifier supplies its own MLP head, reference model.py:27-36).
    """

    def __init__(self, width_mult=1.0, depth_mult=1.0,
                 stochastic_depth_prob=0.2):
        super().__init__()
        from irp_tpu_torch.models.efficientnet import (bn_constants,
                                                       scaled_setting,
                                                       top_channels)

        eps, flax_momentum = bn_constants(width_mult, depth_mult)
        norm_layer = partial(nn.BatchNorm2d, eps=eps,
                             momentum=round(1.0 - flax_momentum, 6))
        setting = scaled_setting(width_mult, depth_mult)
        total_blocks = sum(s[5] for s in setting)

        features = [_cna(3, setting[0][3], 3, 2, 1, norm_layer, nn.SiLU)]
        block_id = 0
        for expand, kernel, stride, in_ch, out_ch, layers in setting:
            stage = []
            for j in range(layers):
                sd = stochastic_depth_prob * block_id / total_blocks
                stage.append(_MBConv(in_ch if j == 0 else out_ch, out_ch,
                                     expand, kernel,
                                     stride if j == 0 else 1, sd,
                                     norm_layer))
                block_id += 1
            features.append(nn.Sequential(*stage))
        features.append(_cna(setting[-1][4], top_channels(width_mult), 1, 1,
                             1, norm_layer, nn.SiLU))
        self.features = nn.Sequential(*features)
        self.avgpool = nn.AdaptiveAvgPool2d(1)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return torch.flatten(x, 1)


class TorchEfficientNetClassifier(nn.Module):
    """EfficientNet backbone + the reference's MLP head shape
    (model.py:30-36)."""

    def __init__(self, num_classes=10, hidden=512, width_mult=1.0,
                 depth_mult=1.0, stochastic_depth_prob=0.2):
        super().__init__()
        from irp_tpu_torch.models.efficientnet import top_channels

        self.backbone = TorchEfficientNet(width_mult, depth_mult,
                                          stochastic_depth_prob)
        self.classifier = nn.Sequential(
            nn.Dropout(0.0), nn.Linear(top_channels(width_mult), hidden),
            nn.ReLU(), nn.Dropout(0.0), nn.Linear(hidden, num_classes))

    def forward(self, x):
        return self.classifier(self.backbone(x))


class _LayerNorm2d(nn.LayerNorm):
    """torchvision.models.convnext.LayerNorm2d: LN over channels of an
    NCHW tensor via a permute sandwich."""

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = super().forward(x)
        return x.permute(0, 3, 1, 2)


class _Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(self.dims)


class _CNBlock(nn.Module):
    """torchvision CNBlock with the exact ``block.{i}`` submodule layout
    (0 dw conv / 2 LayerNorm / 3 Linear / 5 Linear) + layer_scale."""

    def __init__(self, dim, sd_prob):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim, bias=True),
            _Permute([0, 2, 3, 1]),
            nn.LayerNorm(dim, eps=1e-6),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            _Permute([0, 3, 1, 2]),
        )
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))
        self.sd_prob = sd_prob

    def forward(self, x):
        y = self.layer_scale * self.block(x)
        if self.training and self.sd_prob > 0.0:
            keep = 1.0 - self.sd_prob
            mask = torch.empty(x.shape[0], 1, 1, 1,
                               device=x.device).bernoulli_(keep)
            y = y * mask / keep
        return x + y


class TorchConvNeXt(nn.Module):
    """Headless torchvision-layout ConvNeXt (pooled + LN'd feature).

    State_dict keys match torchvision.models.convnext_* exactly for the
    features.* tree (features.0.{0,1} stem, features.{1,3,5,7}.{j} CNBlock
    stages, features.{2,4,6}.{0,1} downsamples); the post-pool LayerNorm
    lives at ``ln`` (torchvision keeps it at classifier.0 — the port's
    converter accepts both) and the classifier is omitted (the port's
    Classifier supplies its own MLP head, reference model.py:27-36).
    """

    def __init__(self, dims=(96, 192, 384, 768), depths=(3, 3, 9, 3),
                 stochastic_depth_prob=0.1):
        super().__init__()
        total = sum(depths)
        features = [nn.Sequential(
            nn.Conv2d(3, dims[0], 4, 4, 0, bias=True),
            _LayerNorm2d(dims[0], eps=1e-6))]
        block_id = 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            if i > 0:
                features.append(nn.Sequential(
                    _LayerNorm2d(dims[i - 1], eps=1e-6),
                    nn.Conv2d(dims[i - 1], dim, 2, 2, 0, bias=True)))
            stage = []
            for _ in range(depth):
                sd = (stochastic_depth_prob * block_id
                      / max(total - 1.0, 1.0))
                stage.append(_CNBlock(dim, sd))
                block_id += 1
            features.append(nn.Sequential(*stage))
        self.features = nn.Sequential(*features)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.ln = nn.LayerNorm(dims[-1], eps=1e-6)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.ln(torch.flatten(x, 1))


class TorchConvNeXtClassifier(nn.Module):
    """ConvNeXt backbone + the reference's MLP head shape
    (model.py:30-36)."""

    def __init__(self, num_classes=10, hidden=512,
                 dims=(96, 192, 384, 768), depths=(3, 3, 9, 3),
                 stochastic_depth_prob=0.1):
        super().__init__()
        self.backbone = TorchConvNeXt(dims, depths, stochastic_depth_prob)
        self.classifier = nn.Sequential(
            nn.Dropout(0.0), nn.Linear(dims[-1], hidden), nn.ReLU(),
            nn.Dropout(0.0), nn.Linear(hidden, num_classes))

    def forward(self, x):
        return self.classifier(self.backbone(x))


class _ViTEncoderBlock(nn.Module):
    """torchvision EncoderBlock: pre-LN attention + pre-LN MLP, with
    torchvision's exact submodule names (ln_1 / self_attention / ln_2 /
    mlp.{0,3}) so state_dicts interchange."""

    def __init__(self, embed_dim, num_heads, mlp_dim):
        super().__init__()
        norm = partial(nn.LayerNorm, eps=1e-6)
        self.ln_1 = norm(embed_dim)
        self.self_attention = nn.MultiheadAttention(embed_dim, num_heads,
                                                    batch_first=True)
        self.ln_2 = norm(embed_dim)
        # torchvision MLPBlock is a Sequential: 0=Linear 1=GELU 2=Dropout
        # 3=Linear 4=Dropout -> keys mlp.0.* and mlp.3.*
        self.mlp = nn.Sequential(
            nn.Linear(embed_dim, mlp_dim), nn.GELU(), nn.Dropout(0.0),
            nn.Linear(mlp_dim, embed_dim), nn.Dropout(0.0))

    def forward(self, x):
        y = self.ln_1(x)
        y, _ = self.self_attention(y, y, y, need_weights=False)
        x = x + y
        return x + self.mlp(self.ln_2(x))


class _ViTEncoder(nn.Module):
    def __init__(self, seq_length, num_layers, embed_dim, num_heads,
                 mlp_dim):
        super().__init__()
        self.pos_embedding = nn.Parameter(
            torch.empty(1, seq_length, embed_dim).normal_(std=0.02))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}",
             _ViTEncoderBlock(embed_dim, num_heads, mlp_dim))
            for i in range(num_layers)))
        self.ln = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        return self.ln(self.layers(x + self.pos_embedding))


class TorchViT(nn.Module):
    """Headless torchvision-layout VisionTransformer (CLS-token feature).

    State_dict keys match torchvision.models.vit_b_16 et al. (class_token,
    conv_proj.*, encoder.pos_embedding, encoder.layers.encoder_layer_i.*,
    encoder.ln.*); the classification ``heads`` is omitted (the port's
    Classifier supplies its own MLP head, as the reference does for
    ResNet, reference model.py:27-36).
    """

    def __init__(self, patch_size=16, embed_dim=768, num_layers=12,
                 num_heads=12, mlp_dim=3072, image_size=224):
        super().__init__()
        self.patch_size = patch_size
        self.conv_proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        seq_length = (image_size // patch_size) ** 2 + 1
        self.encoder = _ViTEncoder(seq_length, num_layers, embed_dim,
                                   num_heads, mlp_dim)

    def forward(self, x):
        n = x.shape[0]
        x = self.conv_proj(x)                      # (n, E, gh, gw)
        x = x.reshape(n, x.shape[1], -1).permute(0, 2, 1)  # (n, S-1, E)
        cls = self.class_token.expand(n, -1, -1)
        x = torch.cat([cls, x], dim=1)
        return self.encoder(x)[:, 0]


class TorchViTClassifier(nn.Module):
    """ViT backbone + the reference's MLP head shape (model.py:30-36)."""

    def __init__(self, num_classes=10, hidden=512, patch_size=16,
                 embed_dim=768, num_layers=12, num_heads=12, mlp_dim=3072,
                 image_size=224):
        super().__init__()
        self.backbone = TorchViT(patch_size, embed_dim, num_layers,
                                 num_heads, mlp_dim, image_size)
        self.classifier = nn.Sequential(
            nn.Dropout(0.0), nn.Linear(embed_dim, hidden), nn.ReLU(),
            nn.Dropout(0.0), nn.Linear(hidden, num_classes))

    def forward(self, x):
        return self.classifier(self.backbone(x))
