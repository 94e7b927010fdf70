"""The stereo disparity network — port of the JAX package's
``models/stereo.py``: AANet's adaptive aggregation (reference
``network/aggregation.py:313-467``, ``network/deform.py:94-231``), the
StereoNet and semantic-guided refinements, and ``StereoDCSS``, the RODSNet
joint disparity + segmentation model. ``build_stereo_model`` is its factory.

Tensors inside are NCHW in ``channels_last`` memory; the outputs are JAX's
keys in its NHWC layout. The trunk, aggregation and heads run in the dtype
of the model (``dtype``: bf16 on the card); the soft-argmin and the
disparities are float32.

Module names are the reference's where the JAX package's converters read
them (``convert_reference_adaptive_aggregation``: ``fusions.{f}.branches.
{i}.{b}.{conv1,bn1,conv2,bn2,conv3,bn3}`` with ``conv2`` the deformable
conv, ``fusions.{f}.fuse_layers.{i}.{j}[.{k}].{0,1}``, ``final_conv.{i}``);
the two refinements here have no reference converter and keep JAX's names.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cost_volume import cost_volume, cost_volume_pyramid, soft_argmin_disparity
from ..ops.deform_conv import DeformConv2d
from ..ops.input_pipeline import image_hw, to_nhwc
from ..ops.interpolate import resize_bilinear
from .blocks import BNReluConv, Conv2d, batch_norm, conv_kxk, init_weights, to_channels_last
from .weathernet import _DTYPES, check_device, feature_extractor, nhwc


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def upsample_disp(disp: torch.Tensor, hw) -> torch.Tensor:
    """(B, h, w) float32 disparity → (B, 1, H, W): bilinear, its values
    scaled by the width ratio (the reference's upsample-and-scale rule)."""
    d = resize_bilinear(disp[..., None].float(), hw) * (hw[1] / disp.shape[-1])
    return nchw(d)


class DeformSimpleBottleneck(nn.Module):
    """conv1×1 → deformable 3×3 → conv1×1 residual block (reference
    ``network/deform.py:94-231``); JAX's ``mdconv`` is the reference's
    ``conv2``."""

    def __init__(self, in_planes: int, planes: int, mdconv_dilation: int = 2,
                 deformable_groups: int = 2, deform_impl: str = "gather"):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = DeformConv2d(planes, planes, 3, stride=1, padding=mdconv_dilation,
                                  dilation=mdconv_dilation, deformable_groups=deformable_groups,
                                  impl=deform_impl)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, planes, 1, bias=False)
        self.bn3 = batch_norm(planes)
        self.downsample = Conv2d(in_planes, planes, 1, bias=False) if in_planes != planes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class SimpleBottleneck(nn.Module):
    """conv1×1 → conv3×3 → conv1×1 residual block without expansion
    (reference ``network/deform.py:137-178``)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = Conv2d(planes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv_kxk(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, planes, 1, bias=False)
        self.bn3 = batch_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + x)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, act: bool = False) -> nn.Sequential:
    layers = [Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False),
              batch_norm(cout)]
    if act:
        layers.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*layers)


class AdaptiveAggregationModule(nn.Module):
    """One AANet fusion (reference ``aggregation.py:313-403``): per-scale
    bottleneck stacks (ISA), then at more than one scale the cross-scale
    exchange (CSA). Scale i has ``max_disp // 2**i`` channels.

    - fuse i < j (coarse → fine): 1×1 conv + BN, resized bilinearly to the
      target's size;
    - fuse i > j (fine → coarse): i − j stride-2 3×3 conv + BN, a
      LeakyReLU(0.2) between them (not after the last);
    - each fused output gets a LeakyReLU(0.2)."""

    def __init__(self, max_disp: int, num_scales: int, num_output_branches: int,
                 num_blocks: int = 1, simple_bottleneck: bool = False,
                 deformable_groups: int = 2, mdconv_dilation: int = 2,
                 deform_impl: str = "gather"):
        super().__init__()
        self.num_scales, self.num_output_branches = num_scales, num_output_branches
        ch = [max_disp // (2 ** i) for i in range(num_scales)]
        self.branches = nn.ModuleList()
        for i in range(num_scales):
            blocks = [SimpleBottleneck(ch[i]) if simple_bottleneck else
                      DeformSimpleBottleneck(ch[i], ch[i], mdconv_dilation=mdconv_dilation,
                                             deformable_groups=deformable_groups,
                                             deform_impl=deform_impl)
                      for _ in range(num_blocks)]
            self.branches.append(nn.Sequential(*blocks))
        self.fuse_layers = nn.ModuleList()
        if num_scales == 1:   # without fusions (aggregation.py:382-384)
            return
        for i in range(num_output_branches):
            row = nn.ModuleList()
            for j in range(num_scales):
                if i == j:
                    row.append(nn.Identity())
                elif i < j:
                    row.append(_conv_bn(ch[j], ch[i], 1))
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(ch[j], ch[i] if k == i - j - 1 else ch[j], 3, stride=2,
                                 act=k < i - j - 1) for k in range(i - j)]))
            self.fuse_layers.append(row)

    def forward(self, x: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        x = [branch(v) for branch, v in zip(self.branches, x)]
        if self.num_scales == 1:
            return x
        fused = []
        for i in range(self.num_output_branches):
            acc = self.fuse_layers[i][0](x[0])
            for j in range(1, self.num_scales):
                exchange = self.fuse_layers[i][j](x[j])
                if exchange.shape[-2:] != acc.shape[-2:]:
                    exchange = nchw(resize_bilinear(nhwc(exchange), tuple(acc.shape[-2:])))
                acc = acc + exchange
            fused.append(F.leaky_relu(acc, 0.2))
        return fused


class AdaptiveAggregation(nn.Module):
    """Stacked fusions and a 1×1 ``final_conv`` a scale (reference
    ``aggregation.py:406-467``) over a pyramid of (B, D_i, H_i, W_i)
    correlation volumes, D_i = ``max_disp // 2**i``. The last
    ``num_deform_blocks`` fusions use deformable bottlenecks, the earlier
    ones simple bottlenecks."""

    def __init__(self, max_disp: int, num_scales: int = 3, num_fusions: int = 6,
                 num_stage_blocks: int = 1, num_deform_blocks: int = 2,
                 mdconv_dilation: int = 2, deformable_groups: int = 2,
                 intermediate_supervision: bool = True, deform_impl: str = "gather"):
        super().__init__()
        self.fusions = nn.ModuleList()
        for f in range(num_fusions):
            last = f == num_fusions - 1
            num_out = num_scales if intermediate_supervision or not last else 1
            self.fusions.append(AdaptiveAggregationModule(
                max_disp, num_scales, num_out, num_blocks=num_stage_blocks,
                simple_bottleneck=f < num_fusions - num_deform_blocks,
                deformable_groups=deformable_groups, mdconv_dilation=mdconv_dilation,
                deform_impl=deform_impl))
        n_final = num_scales if intermediate_supervision else 1
        self.final_conv = nn.ModuleList(
            Conv2d(max_disp // (2 ** i), max_disp // (2 ** i), 1, bias=True)
            for i in range(n_final))

    def forward(self, volumes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        vols = list(volumes)
        for fusion in self.fusions:
            vols = fusion(vols)
        return [conv(v) for conv, v in zip(self.final_conv, vols)]


def _image_concat(d: torch.Tensor, img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The upsampled disparity beside the raw NHWC image, in ``dtype``."""
    return torch.cat([d, nchw(img.float())], dim=1).to(dtype).contiguous(
        memory_format=torch.channels_last)


class StereoNetRefinement(nn.Module):
    """Edge-aware residual refinement (reference ``refinement.py:20-79``):
    the upsampled disparity beside the raw image → conv → dilated residual
    blocks → a residual disparity."""

    def __init__(self, channels: int = 32, dilations: Sequence[int] = (1, 2, 4, 8, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dilations = dtype, tuple(dilations)
        self.conv_in = conv_kxk(4, channels, 3)
        for i, dil in enumerate(self.dilations):
            setattr(self, f"res{i}_conv1", conv_kxk(channels, channels, 3, dilation=dil))
            setattr(self, f"res{i}_bn", batch_norm(channels))
        self.conv_out = conv_kxk(channels, 1, 3, bias=True)

    def forward(self, disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """(B, h, w) disparity and the (B, H, W, 3) image → (B, H, W)."""
        d = upsample_disp(disp, img.shape[1:3])
        x = self.conv_in(_image_concat(d, img, self.dtype))
        for i in range(len(self.dilations)):
            r = getattr(self, f"res{i}_conv1")(torch.relu(x))
            x = x + getattr(self, f"res{i}_bn")(r)
        delta = self.conv_out(torch.relu(x))
        return torch.relu(d + delta.float())[:, 0]


class SemanticGuidedRefinement(nn.Module):
    """Disparity refinement guided by the semantic features through a
    squeeze-excite gate (reference ``Refine_disp_sem`` family). The 1×1
    ``sem_proj`` runs before the full-resolution resize, as in JAX."""

    def __init__(self, sem_features: int = 128, channels: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.sem_proj = Conv2d(sem_features, channels, 1, bias=False)
        self.conv_in = conv_kxk(4, channels, 3)
        self.se_fc1 = nn.Linear(channels, channels)
        self.se_fc2 = nn.Linear(channels, channels)
        for i, dil in enumerate((1, 2, 4, 1)):
            setattr(self, f"res{i}_conv", conv_kxk(channels, channels, 3, dilation=dil))
            setattr(self, f"res{i}_bn", batch_norm(channels))
        self.conv_out = conv_kxk(channels, 1, 3, bias=True)

    def forward(self, disp: torch.Tensor, img: torch.Tensor,
                sem_feat: torch.Tensor) -> torch.Tensor:
        """(B, h, w) disparity, the (B, H, W, 3) image and the (B, C, h, w)
        semantic features → (B, H, W)."""
        hw = tuple(img.shape[1:3])
        d = upsample_disp(disp, hw)
        sem = self.sem_proj(sem_feat.to(self.dtype))
        sem = nchw(resize_bilinear(nhwc(sem), hw))
        x = self.conv_in(_image_concat(d, img, self.dtype))
        gate = sem.mean(dim=(2, 3))
        gate = torch.relu(F.linear(gate, self.se_fc1.weight.to(gate.dtype),
                                   self.se_fc1.bias.to(gate.dtype)))
        gate = torch.sigmoid(F.linear(gate, self.se_fc2.weight.to(gate.dtype),
                                      self.se_fc2.bias.to(gate.dtype)))
        x = torch.relu(x) * gate[:, :, None, None] + sem
        for i in range(4):
            r = getattr(self, f"res{i}_conv")(torch.relu(x))
            x = x + getattr(self, f"res{i}_bn")(r)
        delta = self.conv_out(torch.relu(x))
        return torch.relu(d + delta.float())[:, 0]


class StereoDCSS(nn.Module):
    """Joint disparity + semantics (the RODSNet configuration; JAX
    ``StereoDCSS``): one pass of the pyramid trunk over both views stacked
    on the batch axis, a cost volume at 1/4 resolution (``max_disp // 4``
    disparities), an aggregation, soft-argmin, a refinement, and with
    ``train_semantic`` the ``segmentation`` head on the left view. Images
    are pixels in NHWC, planar or s2d layout
    (``ops/input_pipeline.py::to_nhwc``).

    The aggregation: ``adaptive`` on the correlation volume; the 3-D ones
    on the difference volume (``stereonet``: similarities) or the concat
    volume (``psmnet_basic``, ``psmnet_hg``: costs upsampled ×4 to full
    resolution, the last of ``psmnet_hg``'s list; ``gcnet``: costs at
    twice the volume's resolution). The refinement, as JAX routes it:
    ``semantic`` with ``train_semantic`` → ``SemanticGuidedRefinement``;
    ``stereodrnet`` and ``hourglass`` → the warp-error refinements, given
    both views; a ``SemRefine`` variant (``REFINE_NEW_VARIANTS``) →
    ``SemRefine``; anything else, ``semantic`` without ``train_semantic``
    included, → ``StereoNetRefinement``. ``fuse_stem`` (eval only) runs
    the trunk's and ``SemRefine``'s stems through K2
    (``ops/stem.py::fused_stem_pool``)."""

    def __init__(self, max_disp: int = 192, num_classes: int = 19, num_scales: int = 1,
                 backbone: str = "resnet18", aggregation_type: str = "adaptive",
                 refinement_type: str = "semantic", train_semantic: bool = True,
                 deform_impl: str = "window", fuse_stem: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from .stereo_extras import REFINE_NEW_VARIANTS, make_aggregation, make_refinement

        if backbone not in ("resnet18", "resnet34", "efficientnetb0"):
            raise NotImplementedError(f"stereo backbone {backbone}")
        self.max_disp, self.train_semantic = max_disp, train_semantic
        self.aggregation_type, self.refinement_type = aggregation_type, refinement_type
        self.dtype = dtype
        self.feature_extractor = feature_extractor(backbone, fuse_stem, efficient=False,
                                                   dtype=dtype)
        if aggregation_type == "adaptive":
            # JAX's StereoDCSS aggregates one scale whatever num_scales says
            self.aggregation = make_aggregation(aggregation_type, max_disp // 4, num_scales=1,
                                                num_fusions=3, num_deform_blocks=2,
                                                deform_impl=deform_impl)
        else:   # the difference volume has the 128 trunk channels, the concat one 256
            self.aggregation = make_aggregation(
                aggregation_type, max_disp, in_features=128 if aggregation_type == "stereonet"
                else 256)
        if train_semantic:
            self.segmentation = BNReluConv(128, num_classes, k=1, bias=True)
        if refinement_type == "semantic" and train_semantic:
            self.refinement = SemanticGuidedRefinement(128, dtype=dtype)
        elif refinement_type in ("stereodrnet", "hourglass"):
            self.refinement = make_refinement(refinement_type, dtype=dtype)
        elif refinement_type in REFINE_NEW_VARIANTS:
            # JAX feeds every variant the (B, h, w) disparity: one channel
            self.refinement = make_refinement(refinement_type, dtype=dtype,
                                              disp_in_channels=1, fuse_stem=fuse_stem)
        else:
            self.refinement = StereoNetRefinement(dtype=dtype)

    def aggregate(self, left_feat: torch.Tensor, right_feat: torch.Tensor) -> torch.Tensor:
        """The soft-argmin disparity (B, h', w') float32 of the aggregated
        volume, in the pixels of its resolution (1/4 for ``adaptive`` and
        ``stereonet``, 1/2 for ``gcnet``, full for the PSMNets)."""
        d = self.max_disp // 4
        if self.aggregation_type == "adaptive":
            vols = cost_volume_pyramid([left_feat], [right_feat], d, "correlation")
            return soft_argmin_disparity(self.aggregation(vols)[0])
        stereonet = self.aggregation_type == "stereonet"
        vol = cost_volume(left_feat, right_feat, d, "difference" if stereonet else "concat")
        out = self.aggregation(vol)
        if isinstance(out, list):   # psmnet_hg: the last classifier's
            out = out[-1]
        return soft_argmin_disparity(out, match_similarity=stereonet)

    def disparity(self, left: torch.Tensor, right: torch.Tensor):
        """(outputs, left features): the ``disp_pyramid`` and ``disp`` (and
        a ``SemRefine``'s ``sem_refined``) outputs, and the left view's
        (B, 128, h, w) trunk features; the seg head does not run."""
        from .stereo_extras import HourglassRefinement, SemRefine, StereoDRNetRefinement

        feat, _ = self.feature_extractor(torch.cat([left, right], dim=0))
        left_feat, right_feat = feat.chunk(2, dim=0)
        disp_low = self.aggregate(left_feat, right_feat)
        out: Dict[str, object] = {"disp_pyramid": [disp_low]}
        if isinstance(self.refinement, SemRefine):
            # SemRefine's stem reads the raw image in any layout
            out["disp"], out["sem_refined"] = self.refinement(disp_low, left, left_feat)
        elif isinstance(self.refinement, SemanticGuidedRefinement):
            out["disp"] = self.refinement(disp_low, to_nhwc(left), left_feat)
        elif isinstance(self.refinement, (StereoDRNetRefinement, HourglassRefinement)):
            out["disp"] = self.refinement(disp_low, to_nhwc(left), to_nhwc(right))
        else:
            out["disp"] = self.refinement(disp_low, to_nhwc(left))
        return out, left_feat

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, object]:
        out, left_feat = self.disparity(left, right)
        if self.train_semantic:
            out["seg_beforeup"] = self.segmentation.nhwc_logits(left_feat)
            out["seg"] = resize_bilinear(out["seg_beforeup"], image_hw(left))
        out["fine_feat"] = out["fine_feat0"] = nhwc(left_feat)
        return out


def stereo_kwargs(cfg) -> Dict[str, object]:
    """``StereoDCSS``'s arguments from a config (or a namespace) that holds
    ``max_disp``, ``num_classes``, ``backbone``, ``aggregation_type``,
    ``refinement_type``, ``train_semantic``, ``deform_impl`` and
    ``compute_dtype``; ``fuse_stem`` is taken where it has one."""
    return dict(max_disp=cfg.max_disp, num_classes=cfg.num_classes, backbone=cfg.backbone,
                aggregation_type=cfg.aggregation_type, refinement_type=cfg.refinement_type,
                train_semantic=cfg.train_semantic, deform_impl=cfg.deform_impl,
                fuse_stem=getattr(cfg, "fuse_stem", True), dtype=_DTYPES[cfg.compute_dtype])


def build_stereo_model(cfg=None, device="cuda", seed: int = 0, **kwargs) -> StereoDCSS:
    """``StereoDCSS`` from ``cfg`` (``stereo_kwargs``) or from keyword
    arguments (``StereoDCSS``'s, ``dtype`` as a name or a torch dtype).
    Weights are drawn from a ``torch.Generator`` seeded by ``seed`` as
    ``init_weights`` draws them; the offset convs stay at zero. The model
    is returned in eval mode, ``channels_last`` (``channels_last_3d`` for
    the 3-D convs). Runs on the card unless ``device`` asks for the CPU."""
    device = check_device(device, "build_stereo_model")
    kw = stereo_kwargs(cfg) if cfg is not None else {}
    kw.update(kwargs)
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = _DTYPES[kw["dtype"]]
    model = StereoDCSS(**kw)
    if device.type != "meta":
        init_weights(model, torch.Generator().manual_seed(seed))
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                m.reset_offsets()
    if kw.get("dtype") == torch.float64:   # weathernet._DTYPES
        model.double()
    return to_channels_last(model.to(device)).eval()

