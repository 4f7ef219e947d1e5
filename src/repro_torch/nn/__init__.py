"""Functional layers of the port: ``<layer>_init(gen, ...)`` returns a dict
of tensors, ``<layer>_apply(params, x, ...)`` a new tensor. BatchNorm keeps
its running statistics in a separate ``state`` dict."""
from repro_torch.nn.init import (he_normal, lecun_normal, ones,
                                 uniform_scaling, zeros)
from repro_torch.nn.conv import conv2d_init, conv2d_apply
from repro_torch.nn.linear import dense_init, dense_apply
from repro_torch.nn.norm import (batchnorm_init, batchnorm_apply,
                                 batchnorm_act_apply)
