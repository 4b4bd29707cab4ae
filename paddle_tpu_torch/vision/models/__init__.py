"""Vision model zoo (counterpart of paddle_tpu/vision/models/): LeNet,
ResNet, VGG and MobileNetV1 / V2.  SSD comes with ``vision.ops``."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        mobilenet_v1, mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

# the reference's module-name aliases
from . import mobilenet as mobilenetv1  # noqa: F401,E402
from . import mobilenet as mobilenetv2  # noqa: F401,E402
