"""Model configurations of the port."""
from repro_torch.configs.resnet_cifar import r8, r32, r56
from repro_torch.configs.registry import ArchSpec, get_arch, list_archs
from repro_torch.configs.shapes import SHAPES, InputShape
