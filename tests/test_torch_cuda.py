"""The port's kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no card. On a machine with
one (and no JAX, which tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: permute bitwise; bn_act 1 ulp of the working type; xent
1e-5 relative (f32 math) forward, 1e-5 relative or 1 bf16 ulp backward.
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.bn_act import ops as bn_ops, ref as bn_ref
from repro_torch.kernels.collector_permute import ops as perm_ops
from repro_torch.kernels.softmax_xent import ops as xent_ops

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _within(got, want, rel):
    d = (got.double() - want.double()).abs()
    return bool((d <= rel * want.double().abs()
                 + torch.finfo(want.dtype).tiny).all())


@pytest.mark.parametrize("rows,feat", [(800, (32, 32, 16)), (37, (5, 7, 3))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_collector_permute_kernel(dev, rows, feat, dtype):
    x = torch.randn((rows,) + feat, device=dev).to(dtype).requires_grad_()
    perm = torch.randperm(rows, device=dev)
    before = K.LAUNCHES["collector_permute"]
    out = perm_ops.collector_permute(x, perm)
    (g,) = torch.autograd.grad(out, x, torch.ones_like(out) * 2)
    assert K.LAUNCHES["collector_permute"] == before + 2   # fwd + bwd
    assert torch.equal(out, x.detach()[perm])
    assert torch.equal(g, torch.full_like(g, 2))


@pytest.mark.parametrize("g,rows,c,relu", [(1, 51200, 64, True),
                                           (100, 8192, 16, True),
                                           (3, 1001, 5, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_act_kernel(dev, g, rows, c, relu, dtype):
    x = torch.randn(g, rows, c, device=dev).to(dtype)
    a = torch.rand(g, c, device=dev) + 0.5
    b = torch.randn(g, c, device=dev)
    before = K.LAUNCHES["bn_act"]
    y = bn_ops.bn_act(x, a, b, relu=relu)
    assert K.LAUNCHES["bn_act"] == before + 1
    assert _within(y, bn_ref.bn_act(x, a, b, relu=relu),
                   torch.finfo(dtype).eps)


@pytest.mark.parametrize("rows,v", [(800, 100), (37, 13)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_xent_kernels(dev, rows, v, dtype):
    x = (3 * torch.randn(rows, v, device=dev)).to(dtype).requires_grad_()
    lab = torch.randint(0, v, (rows,), device=dev)
    lab[::5] = -100
    before = (K.LAUNCHES["xent_fwd"], K.LAUNCHES["xent_bwd"])
    loss = xent_ops.softmax_xent(x, lab)
    (g,) = torch.autograd.grad(loss, x)
    assert (K.LAUNCHES["xent_fwd"], K.LAUNCHES["xent_bwd"]) == (
        before[0] + 1, before[1] + 1)
    x_cpu = x.detach().cpu()
    want = xent_ops.softmax_xent(x_cpu.requires_grad_(), lab.cpu())
    (g_cpu,) = torch.autograd.grad(want, x_cpu)
    assert abs(float(loss) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    rel = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
    d = (g.cpu().double() - g_cpu.double()).abs()
    assert bool((d <= rel * g_cpu.double().abs() + 1e-7).all())
