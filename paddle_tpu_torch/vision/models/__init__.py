from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Large,
                        MobileNetV3Small, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     resnext101_32x4d, wide_resnet50_2, wide_resnet101_2)
from .vit import VisionTransformer, vit_b_16, vit_l_16

__all__ = ["BasicBlock", "BottleneckBlock", "MobileNetV1", "MobileNetV2",
           "MobileNetV3Large", "MobileNetV3Small", "ResNet",
           "VisionTransformer", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_large", "mobilenet_v3_small", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x4d", "vit_b_16", "vit_l_16",
           "wide_resnet50_2", "wide_resnet101_2"]
