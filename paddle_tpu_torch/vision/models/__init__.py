"""Vision models (port of the reference's ``vision/models``): the ResNet
family.  The rest of the zoo waits for ROADMAP A9."""

from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,  # noqa: F401
                     resnext50_32x4d, resnext101_64x4d, wide_resnet50_2, wide_resnet101_2)
