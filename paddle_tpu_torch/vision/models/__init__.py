from .densenet import (AlexNet, DenseNet, ShuffleNetV2, SqueezeNet, VGG,
                       alexnet, densenet121, densenet161, densenet169,
                       densenet201, densenet264, shufflenet_v2_x1_0,
                       squeezenet1_0, squeezenet1_1, vgg11, vgg13, vgg16,
                       vgg19)
from .inception import GoogLeNet, InceptionV3, LeNet, googlenet, inception_v3
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Large,
                        MobileNetV3Small, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     resnext101_32x4d, wide_resnet50_2, wide_resnet101_2)
from .vit import VisionTransformer, vit_b_16, vit_l_16

__all__ = ["AlexNet", "BasicBlock", "BottleneckBlock", "DenseNet",
           "GoogLeNet", "InceptionV3", "LeNet", "MobileNetV1", "MobileNetV2",
           "MobileNetV3Large", "MobileNetV3Small", "ResNet", "ShuffleNetV2",
           "SqueezeNet", "VGG", "VisionTransformer", "alexnet",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "densenet264", "googlenet", "inception_v3", "mobilenet_v1",
           "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x4d", "shufflenet_v2_x1_0",
           "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg13", "vgg16",
           "vgg19", "vit_b_16", "vit_l_16", "wide_resnet50_2",
           "wide_resnet101_2"]
