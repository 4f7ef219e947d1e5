"""Model configurations of the port."""
from repro_torch.configs.resnet_cifar import r8, r32, r56
