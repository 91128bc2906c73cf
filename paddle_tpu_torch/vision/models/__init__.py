"""Vision models (port of the reference's ``vision/models``): the ResNet
family, LeNet, AlexNet, VGG, MobileNet V1/V2/V3, SqueezeNet, DenseNet,
GoogLeNet, Inception v3 and ShuffleNetV2, each with the reference's layer
tree and names (a state dict crosses between the packages through numpy)
and the port's keyword-only ``device``/``generator``."""

from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,  # noqa: F401
                     resnext50_32x4d, resnext101_64x4d, wide_resnet50_2, wide_resnet101_2)
from .lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa: F401
                        mobilenet_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161, densenet169,  # noqa: F401
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_25,  # noqa: F401
                           shufflenet_v2_x0_33, shufflenet_v2_x0_5,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                           shufflenet_v2_x2_0, shufflenet_v2_swish)
from .mobilenetv3 import (MobileNetV3Small, MobileNetV3Large,  # noqa: F401
                          mobilenet_v3_small, mobilenet_v3_large)
