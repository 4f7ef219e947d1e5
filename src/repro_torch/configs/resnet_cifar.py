"""The paper's own architectures: CIFAR ResNet-8/32/56 (Table IV)."""
from repro_torch.models.resnet import ResNetConfig


def r8(num_classes=10):
    return ResNetConfig(depth=8, num_classes=num_classes)


def r32(num_classes=10):
    return ResNetConfig(depth=32, num_classes=num_classes)


def r56(num_classes=100):
    return ResNetConfig(depth=56, num_classes=num_classes)
