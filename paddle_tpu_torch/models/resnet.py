"""ResNet family (the JAX package's ``models/resnet.py``): ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and the constructors ``resnet18`` ...
``wide_resnet101_2``.

NCHW by default; ``data_format="NHWC"`` runs the trunk channels-last
(an NCHW input is transposed once at entry). ``stem_space_to_depth``
repacks 2x2 pixel blocks into channels and runs the stem as the
numerically equal 4x4/s1 conv built from the same 7x7 weight.
``fused_bn=True`` sends a bottleneck block in training, NHWC, without
``use_global_stats``, through ``_forward_fused``: the 1x1 convs run as
the matrix-product kernels of ``kernels.fused_resnet`` that give their
output's BN statistics in the same pass (conv1, conv3, downsample) and
apply the previous BN + ReLU while reading their input (conv3). The 3x3
of a stride-1, ungrouped block runs through the fused 3x3 kernels
(``bn_relu_conv3x3_bn_stats``: bn1's apply + ReLU, the conv and bn2's
statistics in one pass) exactly where the JAX package routes it: with
``_PALLAS3X3`` True, its default, and ``conv3x3_vmem_ok`` for the
block's shape. Any other 3x3 runs through the ordinary conv with
``bn_apply_relu`` and ``bn_moments`` around it, as does every 3x3 with
``_PALLAS3X3`` False (the JAX package's
``experiments/fused_bn_ablate.py`` configuration).

``recompute_stages`` names stages (1-4) whose blocks each run as a
recompute region (``distributed.parallel.recompute``, policy "full")
inside ``jit.TrainStep``, as in the JAX package, where they engage only
under the step's trace; an eager forward runs the normal path, so the
running statistics keep moving there.

Every constructor takes ``device`` (the first card unless
``device="cpu"``; without a card it raises), ``dtype`` and a
``torch.Generator`` for the initial weights.
"""
from __future__ import annotations

from torch import nn

from ..core import device as device_mod
from ..distributed.parallel.recompute import recompute
from ..nn import functional as F
from ..nn.container import Sequential
from ..kernels.fused_resnet import conv3x3_vmem_ok
from ..nn.functional import fused_conv as FC
from ..nn.layers_common import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                                Linear, MaxPool2D, ReLU, in_train_step)

# route the 3x3 of a fused stride-1 block through the fused 3x3 kernels
# (True, the JAX package's default) or the ordinary conv (False)
_PALLAS3X3 = True


def _stride0(conv):
    s = conv.stride
    return s[0] if isinstance(s, (tuple, list)) else s


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 data_format="NCHW", *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        bn = dict(data_format=data_format, device=device, dtype=dtype)
        df = dict(bn, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **df)
        self.bn1 = BatchNorm2D(planes, **bn)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **df)
        self.bn2 = BatchNorm2D(planes, **bn)
        self.downsample = downsample
        self.relu = ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, data_format="NCHW",
                 fused_bn=False, *, device=None, dtype=None, generator=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        bn = dict(data_format=data_format, device=device, dtype=dtype)
        df = dict(bn, generator=generator)
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **df)
        self.bn1 = BatchNorm2D(width, **bn)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False, **df)
        self.bn2 = BatchNorm2D(width, **bn)
        self.conv3 = Conv2D(width, planes * 4, 1, bias_attr=False, **df)
        self.bn3 = BatchNorm2D(planes * 4, **bn)
        self.downsample = downsample
        self.relu = ReLU()
        self.data_format = data_format
        self.fused_bn = fused_bn

    def forward(self, x):
        if (self.fused_bn and self.training and self.data_format == "NHWC"
                and not self.bn1.use_global_stats):
            return self._forward_fused(x)
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def _forward_fused(self, x):
        """Training-mode fused path (NHWC): conv1, conv3 and the
        downsample give their output's BN statistics in the pass that
        computes them, conv3 applies bn2 + ReLU while reading its input,
        and the closing applies run in centered form (only ``bn_fold``'s
        scale is consumed, so the gamma gradient has no cancelling
        subtraction). Running statistics update as in the unfused
        path."""
        y1, m1, v1 = FC.conv1x1_bn_stats(x, self.conv1.weight)
        self.bn1._update_running(m1, v1)
        s1, t1 = FC.bn_fold(self.bn1.weight, self.bn1.bias, m1, v1,
                            self.bn1.epsilon)
        _, h, w, c = y1.shape
        if (_PALLAS3X3 and _stride0(self.conv2) == 1
                and self.conv2.groups == 1
                and conv3x3_vmem_ok(h, w, c, self.conv2.weight.shape[0],
                                    y1.element_size())):
            # bn1-apply + relu + 3x3 conv + bn2 stats in one kernel
            y2, m2, v2 = FC.bn_relu_conv3x3_bn_stats(y1, s1, t1,
                                                     self.conv2.weight)
        else:
            y2 = self.conv2(FC.bn_apply_relu(y1, s1, t1))
            m2, v2 = FC.bn_moments(y2)
        self.bn2._update_running(m2, v2)
        s2, t2 = FC.bn_fold(self.bn2.weight, self.bn2.bias, m2, v2,
                            self.bn2.epsilon)
        y3, m3, v3 = FC.bn_relu_conv1x1_bn_stats(y2, s2, t2,
                                                 self.conv3.weight)
        self.bn3._update_running(m3, v3)
        s3, _ = FC.bn_fold(self.bn3.weight, self.bn3.bias, m3, v3,
                           self.bn3.epsilon)
        if self.downsample is not None:
            dsconv, dsbn = self.downsample[0], self.downsample[1]
            yd, md, vd = FC.conv1x1_bn_stats(x, dsconv.weight,
                                             stride=_stride0(dsconv))
            dsbn._update_running(md, vd)
            sd, _ = FC.bn_fold(dsbn.weight, dsbn.bias, md, vd, dsbn.epsilon)
            identity = FC.bn_center_apply(yd, md, sd, dsbn.bias)
        else:
            identity = x
        return FC.bn_center_apply_relu_add(y3, m3, s3, self.bn3.bias,
                                           identity)


class ResNet(nn.Module):
    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 groups=1, width_per_group=64, data_format="NCHW",
                 stem_space_to_depth=False, fused_bn=False,
                 recompute_stages=(), *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if not issubclass(block, BottleneckBlock) and \
                (groups != 1 or width_per_group != 64):
            raise ValueError(
                "groups/width_per_group require BottleneckBlock "
                "(resnet50+); BasicBlock variants do not support them")
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, "
                             f"got {data_format!r}")
        self.recompute_stages = tuple(recompute_stages)
        bad = [s for s in self.recompute_stages if s not in (1, 2, 3, 4)]
        if bad:
            raise ValueError(
                f"recompute_stages entries must be stage numbers 1-4 "
                f"(1-indexed: layer1..layer4), got {bad}")
        dev = device_mod.resolve(device)
        self._mk = dict(device=dev, dtype=dtype, generator=generator)
        self.inplanes = 64
        self.groups = groups
        self.base_width = width_per_group
        self.data_format = data_format
        self.stem_space_to_depth = stem_space_to_depth
        self.fused_bn = fused_bn and issubclass(block, BottleneckBlock)
        df = dict(data_format=data_format, **self._mk)
        bn = dict(data_format=data_format, device=dev, dtype=dtype)
        self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                            **df)
        self.bn1 = BatchNorm2D(64, **bn)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1, data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._mk)
        self.num_classes = num_classes

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        df = dict(data_format=self.data_format, **self._mk)
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **df),
                BatchNorm2D(planes * block.expansion,
                            data_format=self.data_format,
                            device=self._mk["device"],
                            dtype=self._mk["dtype"]))
        kw = dict(df)
        if issubclass(block, BottleneckBlock):
            kw.update(groups=self.groups, base_width=self.base_width,
                      fused_bn=self.fused_bn)
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return Sequential(*layers)

    def _stem_s2d(self, x):
        """Space-to-depth stem: 2x2 pixel blocks repacked into channels
        (C 3 -> 12) and the numerically equal 4x4/s1 conv built from the
        same 7x7 weight (zero-padded to 8x8 at the front). Weights stay
        in the 7x7 layout, so checkpoints are unaffected."""
        w = self.conv1.weight                               # [O, 3, 7, 7]
        o = w.shape[0]
        wp = F.pad(w, [1, 0, 1, 0], data_format="NCHW")     # [O, 3, 8, 8]
        wp = wp.reshape(o, 3, 4, 2, 4, 2)                   # O I mh rh mw rw
        wp = wp.permute(0, 3, 5, 1, 2, 4).reshape(o, 12, 4, 4)
        if self.data_format == "NHWC":
            n, h, wd, c = x.shape
        else:
            n, c, h, wd = x.shape
        if h % 2 or wd % 2:
            raise ValueError(
                f"stem_space_to_depth requires even input H/W, got "
                f"{h}x{wd}; use the default stem for odd sizes")
        if self.data_format == "NHWC":
            xp = x.reshape(n, h // 2, 2, wd // 2, 2, c)
            xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, wd // 2,
                                                      4 * c)
        else:
            xp = x.reshape(n, c, h // 2, 2, wd // 2, 2)
            xp = xp.permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2,
                                                      wd // 2)
        return F.conv2d(xp, wp, bias=self.conv1.bias, stride=1,
                        padding=[2, 1, 2, 1], data_format=self.data_format)

    def forward(self, x):
        if self.data_format == "NHWC" and x.shape[-1] != 3:
            # accept NCHW input; one transpose at entry
            if x.shape[1] != 3:
                raise ValueError(
                    f"NHWC ResNet expects input [N,H,W,3] or NCHW "
                    f"[N,3,H,W]; got shape {list(x.shape)}")
            x = x.permute(0, 2, 3, 1).contiguous()
        stem = self._stem_s2d(x) if self.stem_space_to_depth \
            else self.conv1(x)
        return self._trunk(self.maxpool(self.relu(self.bn1(stem))))

    def _trunk(self, x):
        if self.training and self.recompute_stages and in_train_step():
            stages = (self.layer1, self.layer2, self.layer3, self.layer4)
            for i, stage in enumerate(stages, 1):
                if i in self.recompute_stages:
                    for blk in stage:
                        x = recompute(blk, x)
                else:
                    x = stage(x)
        else:
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


_CFGS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (BottleneckBlock, [3, 4, 6, 3]),
    101: (BottleneckBlock, [3, 4, 23, 3]),
    152: (BottleneckBlock, [3, 8, 36, 3]),
}


def resnet18(**kw):
    return ResNet(*_CFGS[18], **kw)


def resnet34(**kw):
    return ResNet(*_CFGS[34], **kw)


def resnet50(**kw):
    return ResNet(*_CFGS[50], **kw)


def resnet101(**kw):
    return ResNet(*_CFGS[101], **kw)


def resnet152(**kw):
    return ResNet(*_CFGS[152], **kw)


def resnext50_32x4d(**kw):
    return ResNet(*_CFGS[50], groups=32, width_per_group=4, **kw)


def resnext101_32x4d(**kw):
    return ResNet(*_CFGS[101], groups=32, width_per_group=4, **kw)


def resnext101_64x4d(**kw):
    return ResNet(*_CFGS[101], groups=64, width_per_group=4, **kw)


def resnext152_64x4d(**kw):
    return ResNet(*_CFGS[152], groups=64, width_per_group=4, **kw)


def wide_resnet50_2(**kw):
    return ResNet(*_CFGS[50], width_per_group=128, **kw)


def wide_resnet101_2(**kw):
    return ResNet(*_CFGS[101], width_per_group=128, **kw)
