"""The port's kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no card. On a machine with
one (and no JAX, which tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: permute and the bucket gathers (K4a/K4b) bitwise; the
quantize/dequantize gathers (K5a/K5b) bitwise in bytes, scales and
values; bn_act 1 ulp of the working type; the BatchNorm training op's
moments within 1e-5 of float64 moments, its fold and running update
bitwise the plain expressions, its dx within one rounding of the stored
dtype of the plain version, dscale and dbias within 1e-5 of float64 sums
of their terms' magnitudes, and the op against the autograd chain it
replaces at the cells' shapes, with less device memory held; xent 1e-5
relative (f32 math) forward, 1e-5 relative or 1 ulp of bf16 / f16 backward, also at the
shared geometry's edges (V 127-129, 16,385), above the one-block width
(V 50,257), on the rows that straddle element 2**31 of a 131,073 x 16,384
bf16 logits tensor, and under CUDA-graph replay of the backward. The
sharded epoch at world size 1 (NCCL) equals the dense single-device epoch
within 1e-5.
rmsnorm (K6) 1e-5 in f32 and 1 bf16 ulp; flash attention (K7) 2e-3 in f32
and 2e-2 in bf16 (tests/test_kernels.py's bounds), bf16 D 256 served by
the spill-free Hopper kernel and equal to itself under CUDA-graph replay,
a 2-layer f32 prefill through K7 within 2e-3 of the plain attention path,
and a 2-layer bf16 gemma-7b prefill through K7 at D 256 within 2e-2 of max
|logit| of the plain path. The sLSTM scan
(K8) 3e-4 of its plain version (tests/test_kernels.py's kernel-to-ref
bound) on the fuzz grid, strided inputs (views of one fused projection)
and its launch plan's edges (B 1 and 5, S 1, a ragged last slice, two
launches, Dh 1, slices of more than 32 units), the plan's CPU mirror of a
block's shared memory equal to the C side's, and a CUDA-graph
replay of it equal to the eager call; a 1-group
f32 xLSTM prefill through K8 within 2e-3 of the plain sLSTM path
(tests/test_kernels.py's bound for the same comparison).
"""
import ctypes

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.bn_act import kernel as bn_k
from repro_torch.kernels.bn_act import ops as bn_ops, ref as bn_ref
from repro_torch.kernels.collector_permute import kernel as perm_k
from repro_torch.kernels.collector_permute import ops as perm_ops
from repro_torch.kernels.collector_permute import ref as perm_ref
from repro_torch.kernels.flash_attention import kernel as flash_k
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.quant_permute import ops as quant_ops
from repro_torch.kernels.quant_permute import ref as quant_ref
from repro_torch.kernels.slstm_scan import kernel as slstm_k
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan import ref as slstm_ref
from repro_torch.kernels.softmax_xent import kernel as xent_k
from repro_torch.kernels.softmax_xent import ops as xent_ops
from repro_torch.kernels.softmax_xent import ref as xent_ref

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernels_run(fn):
    """Names of the K7 kernels that ``fn()`` ran on the card (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.key for e in prof.key_averages() if "flash_fwd" in e.key]


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
    nbytes = K.BYTES["collector_permute"]
    out = perm_ops.collector_permute(x, perm)
    (g,) = torch.autograd.grad(out, x, torch.ones_like(out) * 2)
    assert K.LAUNCHES["collector_permute"] == before + 2   # fwd + bwd
    row = x[0].numel() * x.element_size()
    assert K.BYTES["collector_permute"] == nbytes + 2 * perm_k.gather_bytes(
        rows, row, 8)
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
    nbytes = K.BYTES["bn_act"]
    y = bn_ops.bn_act(x, a, b, relu=relu)
    assert K.LAUNCHES["bn_act"] == before + 1
    assert K.BYTES["bn_act"] == nbytes + bn_k.bn_act_bytes(
        x.numel(), x.element_size(), g, c)
    assert _within(y, bn_ref.bn_act(x, a, b, relu=relu),
                   torch.finfo(dtype).eps)


# the cells' BatchNorm shapes (ResNet-56, pool 12,800: the server's three
# stages and the 100 clients' stem) and ragged ones
BN_SHAPES = [(1, 12800 * 1024, 16), (1, 12800 * 256, 32), (1, 12800 * 64, 64),
             (100, 128 * 1024, 16), (3, 1001, 5), (2, 37, 24)]


def _bn_world(dev, g, rows, c, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(g, rows, c, device=dev, generator=gen) * 2
         + 0.5).to(dtype)
    vec = [torch.rand(g, c, device=dev, generator=gen) + 0.5
           for _ in range(4)]                       # scale bias mean var
    return x, vec, torch.full((g,), 3.0, device=dev)


@pytest.mark.parametrize("g,rows,c", BN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_moments_kernel(dev, g, rows, c, dtype):
    """The moments against float64 moments of the same input; the fold and
    the running update bitwise the plain expressions of the kernel's own
    moments (IEEE division and square root on both sides); one launch of
    ``bn_moments`` counted with its byte function, none of ``bn_act``."""
    x, (scale, bias, mean, var), count = _bn_world(dev, g, rows, c, dtype)
    launches, nbytes = dict(K.LAUNCHES), dict(K.BYTES)
    stats, new = bn_k.bn_moments(x, scale, bias, mean, var, count,
                                 momentum=0.9, eps=1e-5, training=True)
    parts = bn_k.stat_geometry(g, rows, c, x.element_size(), True,
                               bn_k._sms(dev.index or 0))[2]
    assert K.LAUNCHES["bn_moments"] == launches["bn_moments"] + 1
    assert K.BYTES["bn_moments"] == nbytes["bn_moments"] + \
        bn_k.bn_moments_bytes(x.numel(), x.element_size(), g, c, parts, True)
    assert K.LAUNCHES["bn_act"] == launches["bn_act"]
    assert K.BYTES["bn_act"] == nbytes["bn_act"]
    v64, m64 = torch.var_mean(x.double(), dim=1, correction=0)
    mu, v, a, b, rstd = stats
    assert float(((mu.double() - m64).abs() / v64.sqrt()).max()) < 1e-5
    assert float(((v.double() - v64).abs() / v64).max()) < 1e-5
    sd = torch.sqrt(v + 1e-5)
    assert torch.equal(a, scale / sd)
    assert torch.equal(b, bias - mu * a)
    assert torch.equal(rstd, 1.0 / sd)
    assert torch.equal(new[0], 0.9 * mean + (1 - 0.9) * mu)
    assert torch.equal(new[1], 0.9 * var + (1 - 0.9) * v)
    assert torch.equal(new[2], count + 1.0)
    stats2, none = bn_k.bn_moments(x, scale, bias, mean, var, count,
                                   momentum=0.9, eps=1e-5, training=False)
    assert none is None and torch.equal(stats2, stats)    # shape alone
    assert K.BYTES["bn_moments"] == nbytes["bn_moments"] + sum(
        bn_k.bn_moments_bytes(x.numel(), x.element_size(), g, c, parts, t)
        for t in (True, False))


@pytest.mark.parametrize("g,rows,c", BN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
def test_bn_grad_kernel(dev, g, rows, c, dtype, relu):
    """``dx`` against the plain version on the same moments, within one
    rounding of the stored dtype (the two take their sums in other
    orders); ``dscale`` and ``dbias`` against float64 sums; the ReLU mask
    is K2's y > 0; one launch of ``bn_grad`` counted with its bytes."""
    x, (scale, bias, mean, var), count = _bn_world(dev, g, rows, c, dtype, 1)
    stats, _ = bn_k.bn_moments(x, scale, bias, mean, var, count,
                               momentum=0.9, eps=1e-5, training=False)
    gy = torch.randn(x.shape, device=dev).to(dtype)
    launches, nbytes = dict(K.LAUNCHES), dict(K.BYTES)
    dx, dscale, dbias = bn_k.bn_grad(gy, x, stats, relu=relu)
    parts = bn_k.stat_geometry(g, rows, c, x.element_size(), True,
                               bn_k._sms(dev.index or 0))[2]
    assert K.LAUNCHES["bn_grad"] == launches["bn_grad"] + 1
    assert K.BYTES["bn_grad"] == nbytes["bn_grad"] + bn_k.bn_grad_bytes(
        x.numel(), x.element_size(), g, c, parts)
    assert K.LAUNCHES["bn_act"] == launches["bn_act"]
    assert K.BYTES["bn_act"] == nbytes["bn_act"]
    want_dx, _, _ = bn_ref.bn_grad(gy, x, stats, relu=relu)
    err = (dx.double() - want_dx.double()).abs()
    scale_dx = float(want_dx.double().abs().max())
    assert bool((err <= torch.finfo(dtype).eps * want_dx.double().abs()
                 + 1e-5 * scale_dx).all())
    y = bn_k.bn_act(x, stats[2], stats[3], relu=relu)
    gm = torch.where(y > 0, gy, 0).double() if relu else gy.double()
    d = x.double() - stats[0].double()[:, None]
    for got, terms in ((dbias, gm), (dscale / stats[4], gm * d)):
        want = terms.sum(dim=1)
        assert bool(((got.double() - want).abs()
                     <= 1e-5 * terms.abs().sum(dim=1) + 1e-30).all())


@pytest.mark.parametrize("g,rows,c", [(1, 12800 * 1024, 16),
                                      (100, 128 * 1024, 16),
                                      (1, 12800 * 64, 64)])
def test_bn_train_op_against_the_autograd_chain(dev, g, rows, c):
    """A training BatchNorm through ``batchnorm_act_apply(use_kernel=True)``
    against the same call on the plain chain: y and the running state
    within one bf16 / f32 rounding of the moments, the gradients close; one
    launch of each of ``bn_moments``, ``bn_act`` (K2) and ``bn_grad``; and
    less device memory held for the forward + backward."""
    from repro_torch.nn import norm
    x, (scale, bias, mean, var), count = _bn_world(dev, g, rows, c,
                                                   torch.bfloat16, 2)
    if g == 1:
        x, scale, bias, mean, var, count = (
            x[0].reshape(-1, 32, 32, c), scale[0], bias[0], mean[0], var[0],
            count[0])
    else:
        x = x.reshape(g, -1, 32, 32, c)
    gy = torch.randn(x.shape, device=dev).to(torch.bfloat16)

    def run(use_kernel):
        p = {"scale": scale.clone().requires_grad_(),
             "bias": bias.clone().requires_grad_()}
        xx = x.clone().requires_grad_()
        st = {"mean": mean, "var": var, "count": count}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.reset_launches()
        y, new = norm.batchnorm_act_apply(p, st, xx, training=True,
                                          use_kernel=use_kernel)
        y.backward(gy)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return (y.detach(), new, xx.grad, p["scale"].grad, p["bias"].grad,
                dict(K.LAUNCHES), peak)

    old, new = run(False), run(True)
    assert new[5]["bn_moments"] == new[5]["bn_act"] == \
        new[5]["bn_grad"] == 1
    assert old[5]["bn_moments"] == old[5]["bn_grad"] == 0
    assert new[6] < old[6], (new[6], old[6])
    # the two take their moments in other orders (about 1e-6 apart), which
    # moves a rounding or a ReLU edge of values of size 10 at most
    ulp = torch.finfo(torch.bfloat16).eps
    assert bool(((new[0].float() - old[0].float()).abs()
                 <= ulp * old[0].float().abs() + 1e-4).all())
    for key in ("mean", "var"):
        assert torch.allclose(new[1][key], old[1][key], rtol=1e-5,
                              atol=1e-6)
    assert torch.equal(new[1]["count"], old[1]["count"])
    for i in (2, 3, 4):
        scale_i = float(old[i].float().abs().max())
        assert float((new[i].float() - old[i].float()).abs().max()) \
            <= 2 * ulp * scale_i, i


def test_bn_valid_rows_keep_the_plain_code(dev):
    """A row mask (elastic participation) keeps the plain statistics: no
    ``bn_moments`` or ``bn_grad`` launch, K2 as before."""
    from repro_torch.nn import norm
    x, (scale, bias, mean, var), count = _bn_world(dev, 1, 4 * 64, 16,
                                                   torch.bfloat16)
    x = x[0].reshape(4, 8, 8, 16).requires_grad_()
    st = {"mean": mean[0], "var": var[0], "count": count[0]}
    K.reset_launches()
    y, _ = norm.batchnorm_act_apply(
        {"scale": scale[0], "bias": bias[0]}, st, x, training=True,
        use_kernel=True, valid=torch.tensor([True, False, True, True],
                                            device=dev))
    y.float().sum().backward()
    assert K.LAUNCHES["bn_moments"] == K.LAUNCHES["bn_grad"] == 0
    assert K.LAUNCHES["bn_act"] == 1


@pytest.mark.parametrize("rows,v", [(800, 100), (37, 13)] + [
    (rows, v) for rows in (1, 33, 1000) for v in (13, 100, 1000)] + [
    (3, 50257), (64, 50257),
    # the shared geometry's edges: 4 rows a warp up to 128 classes, one
    # row a program past it, column blocks past MAX_V
    (33, 127), (33, 128), (33, 129), (5, 16385)])
@pytest.mark.parametrize("dtype", DTYPES + [torch.float16])
def test_softmax_xent_kernels(dev, rows, v, dtype):
    x = (3 * torch.randn(rows, v, device=dev)).to(dtype).requires_grad_()
    lab = torch.randint(0, v, (rows,), device=dev)
    lab[::5] = -100
    before = (K.LAUNCHES["xent_fwd"], K.LAUNCHES["xent_bwd"])
    nbytes = (K.BYTES["xent_fwd"], K.BYTES["xent_bwd"])
    loss = xent_ops.softmax_xent(x, lab)
    (g,) = torch.autograd.grad(loss, x)
    assert (K.LAUNCHES["xent_fwd"], K.LAUNCHES["xent_bwd"]) == (
        before[0] + 1, before[1] + 1)
    # K3f reads the logits and int64 labels, writes f32 nll and lse; K3b
    # reads both and f32 lse and row scale, writes the logits' gradient
    logits = x.numel() * x.element_size()
    per_row = rows * (8 + 2 * 4)
    assert (K.BYTES["xent_fwd"], K.BYTES["xent_bwd"]) == (
        nbytes[0] + logits + per_row, nbytes[1] + 2 * logits + per_row)
    x_cpu = x.detach().cpu()
    want = xent_ops.softmax_xent(x_cpu.requires_grad_(), lab.cpu())
    (g_cpu,) = torch.autograd.grad(want, x_cpu)
    assert abs(float(loss) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    rel = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
    d = (g.cpu().double() - g_cpu.double()).abs()
    assert bool((d <= rel * g_cpu.double().abs() + 1e-7).all())


def test_softmax_xent_rows_past_2_31_elements(dev):
    """131,073 rows of 16,384 bf16 logits (~4.3 GB each for x and dx): row
    131,072 starts at element 2**31, where 32-bit row offsets wrap. Both
    kernels on the rows around it (and the first) against the plain
    version computed on those rows only."""
    r, v = 131073, 16384
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(r, v, device=dev, dtype=torch.bfloat16, generator=gen)
    lab = torch.randint(0, v, (r,), device=dev, generator=gen)
    g = torch.rand(r, device=dev, generator=gen)
    nll, lse = xent_k.xent_fwd(x, lab)
    dx = xent_k.xent_bwd(x, lab, lse, g)
    for rows in (slice(0, 2), slice(131070, 131073)):
        nll_p, lse_p = xent_ref.xent_fwd(x[rows], lab[rows])
        assert torch.allclose(nll[rows], nll_p, rtol=1e-5, atol=1e-5)
        assert torch.allclose(lse[rows], lse_p, rtol=1e-5, atol=1e-5)
        want = xent_ref.xent_bwd(x[rows], lab[rows], lse[rows], g[rows])
        assert _within(dx[rows], want, torch.finfo(torch.bfloat16).eps)


@pytest.mark.parametrize("rows,v,dtype", [
    (800, 100, torch.bfloat16), (33, 129, torch.float32),
    (64, 50257, torch.bfloat16)])
def test_xent_bwd_cuda_graph_replay(dev, rows, v, dtype):
    """K3b captured in a CUDA graph (one launch counted at capture), then
    replayed on new values written into the captured inputs: equal to the
    plain version on those values."""
    gen = torch.Generator(device=dev).manual_seed(rows + v)

    def fill():
        x.copy_(3 * torch.randn(rows, v, device=dev, generator=gen))
        lab.copy_(torch.randint(0, v, (rows,), device=dev, generator=gen))
        g.copy_(torch.rand(rows, device=dev, generator=gen) / rows)
        lse.copy_(xent_ref.xent_fwd(x, lab)[1])

    x = torch.empty(rows, v, device=dev, dtype=dtype)
    lab = torch.empty(rows, device=dev, dtype=torch.int64)
    g, lse = (torch.empty(rows, device=dev) for _ in range(2))
    fill()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xent_k.xent_bwd(x, lab, lse, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = K.LAUNCHES["xent_bwd"]
    with torch.cuda.graph(graph):
        dx = xent_k.xent_bwd(x, lab, lse, g)
    assert K.LAUNCHES["xent_bwd"] == before + 1
    rel = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
    for _ in range(2):
        fill()
        graph.replay()
        torch.cuda.synchronize()
        assert K.LAUNCHES["xent_bwd"] == before + 1
        assert _within(dx, xent_ref.xent_bwd(x, lab, lse, g), rel)


@pytest.mark.parametrize("rows,feat,sc", [
    (800, (32, 32, 16), (1, 800)), (37, (5, 7, 3), (8, 5)),
    # a slack-buffered plan of the pool (880 rows from 800), 32-byte rows
    (800, (32, 32, 16), (4, 220)), (37, (4, 4), (3, 20))])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_bucket_gather_kernels(dev, rows, feat, sc, dtype, idx_dtype):
    x = torch.randn((rows,) + feat, device=dev).to(dtype)
    idx = torch.randint(0, rows, sc, device=dev, dtype=idx_dtype)
    before = (K.LAUNCHES["bucket_permute"], K.LAUNCHES["unbucket_permute"])
    out = perm_ops.bucket_gather(x, idx)
    assert torch.equal(out, perm_ref.bucket_permute(x, idx))
    # receive side: the flat block plus the zero pad row
    flat = torch.cat([out, torch.zeros_like(out[:1])])
    ridx = torch.randint(0, flat.shape[0], (rows,), device=dev,
                         dtype=idx_dtype)
    back = perm_ops.unbucket_gather(flat, ridx)
    assert torch.equal(back, perm_ref.unbucket_permute(flat, ridx))
    assert (K.LAUNCHES["bucket_permute"], K.LAUNCHES["unbucket_permute"]) \
        == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("rows,d,sc", [(800, 16384, (1, 800)),
                                       (37, 105, (8, 5)), (9, 13, (3, 3))])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wire", ["int8", "float8_e4m3"])
def test_quant_gather_kernels(dev, rows, d, sc, dtype, wire):
    x = (3 * torch.randn(rows, d, device=dev)).to(dtype)
    x[0] = 0
    idx = torch.randint(0, rows, sc, device=dev, dtype=torch.int32)
    before = (K.LAUNCHES["quant_bucket_permute"],
              K.LAUNCHES["dequant_unbucket_permute"])
    q, s = quant_ops.quant_bucket_permute(x, idx, wire_dtype=wire)
    q_p, s_p = quant_ref.quant_bucket_permute(x, idx, wire)
    assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
    assert torch.equal(s.view(torch.int32), s_p.view(torch.int32))
    payload = quant_ops.quant_bucket_permute_packed(x, idx, wire_dtype=wire)
    assert torch.equal(payload[:, :d].view(torch.uint8), q.view(torch.uint8))
    flat = torch.cat([payload, torch.zeros_like(payload[:1])])
    ridx = torch.randint(0, flat.shape[0], (rows,), device=dev)
    out = quant_ops.dequant_unbucket_permute_packed(flat, ridx,
                                                    out_dtype=dtype)
    from repro_torch.core.wire import unpack_scales
    want = quant_ref.dequant_unbucket_permute(
        flat[:, :d], unpack_scales(flat[:, d:]), ridx, dtype)
    assert torch.equal(out, want)
    assert (K.LAUNCHES["quant_bucket_permute"],
            K.LAUNCHES["dequant_unbucket_permute"]) == (before[0] + 2,
                                                        before[1] + 1)


def test_sharded_epoch_world1_matches_dense(dev):
    """``sfpl_epoch_sharded`` on a world-size-1 NCCL group through K4a/K4b
    against ``sfpl_round`` with the dense gather, same init and
    permutations: within 1e-5 (f32, ResNet-8 width 8, 8 clients)."""
    import dataclasses
    from repro_torch.core import engine as E, engine_dist as ED, round as RD
    from repro_torch.data import (make_synthetic_cifar,
                                  partition_positive_labels)
    from repro_torch.models import resnet as R
    from repro_torch.optim import sgd_momentum
    n, b = 8, 8
    cfg = R.ResNetConfig(depth=8, num_classes=n, width=8)
    g = torch.Generator().manual_seed(0)
    tx, ty, _, _ = make_synthetic_cifar(g, num_classes=n,
                                        train_per_class=2 * b,
                                        test_per_class=1, hw=8, device=dev)
    data = partition_positive_labels(tx, ty, n)
    opt = sgd_momentum(0.05, momentum=0.9, weight_decay=5e-4)
    st = E.init_dcml_state(g, lambda k: R.init(k, cfg), n, opt, opt)
    split = E.make_resnet_split(cfg)
    torch.backends.cudnn.allow_tf32 = False
    group = ED.init_data_group(dev)
    try:
        K.reset_launches()
        _, l_mesh = ED.sfpl_epoch_sharded(
            torch.Generator().manual_seed(3), st, data, split, opt, opt,
            group=group, num_clients=n, batch_size=b, device=dev)
        assert K.LAUNCHES["bucket_permute"] > 0
        assert K.LAUNCHES["unbucket_permute"] > 0
        coll = group.collector(n)
        gen = torch.Generator().manual_seed(3)
        perms = [coll.make_perm(gen, n * b, dev) for _ in range(2)]

        @dataclasses.dataclass(frozen=True)
        class Given(RD.DenseTake):
            it: object = None

            def make_perm(self, gen, n, device=None):
                return next(self.it)
        _, l_dense = RD.sfpl_round(None, st, data, split, opt, opt,
                                   num_clients=n, batch_size=b,
                                   collector=Given(n, it=iter(perms)),
                                   device=dev)
    finally:
        ED.close_data_group()
    assert float((l_mesh - l_dense).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape,offset", [((37, 100), 0.0), ((33, 300), 1.0),
                                          ((1, 8), 0.0), ((4, 7, 96), 1.0),
                                          ((2048, 4096), 0.0),
                                          ((8192, 128), 0.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel(dev, shape, offset, dtype):
    x = torch.randn(shape, device=dev).to(dtype)
    scale = torch.randn(shape[-1], device=dev) * 0.1 + 1.0
    before = K.LAUNCHES["rmsnorm"]
    y = rms_ops.rmsnorm(x, scale, scale_offset=offset)
    assert K.LAUNCHES["rmsnorm"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    want = rms_ref.rmsnorm_ref(x, scale, scale_offset=offset)
    if dtype == torch.float32:
        assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    else:
        assert _within(y, want, torch.finfo(dtype).eps)


@pytest.mark.parametrize("b,s,hk,d,causal,window", [
    (1, 16, (4, 2), 32, True, None), (2, 64, (4, 4), 64, False, None),
    (1, 100, (8, 1), 32, True, 16), (2, 128, (4, 2), 64, True, None),
    (1, 100, (4, 4), 64, False, 16), (2, 100, (8, 1), 128, True, None),
    (1, 1000, (32, 8), 128, True, None), (1, 300, (4, 2), 128, True, 64),
    # the Hopper kernel's tile edges (128 q rows, 128 keys) at D 128, and
    # a window that spans two kv tiles
    (1, 127, (8, 2), 128, True, None), (2, 128, (8, 2), 128, False, None),
    (1, 129, (8, 1), 128, True, None), (1, 255, (4, 4), 128, False, 64),
    (1, 400, (8, 2), 128, True, 200),
    # head_dim 256 (the Hopper kernel's 64-key K / V tiles): gemma-7b's
    # MHA, recurrentgemma-9b's MQA and its 2048 window across many tiles
    (1, 300, (4, 4), 256, True, None), (2, 100, (4, 1), 256, True, None),
    (1, 129, (2, 2), 256, False, None), (1, 2500, (4, 1), 256, True, 2048),
    # ragged S around the 64-key tiles and the 128-row q tiles at D 256
    (1, 63, (4, 4), 256, True, None), (2, 64, (4, 1), 256, False, None),
    (1, 65, (4, 4), 256, True, 40), (2, 127, (4, 1), 256, True, None),
    (1, 128, (4, 4), 256, False, 40), (1, 129, (4, 1), 256, True, 40)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(dev, b, s, hk, d, causal, window, dtype):
    h, k = hk
    q, kk, v = (torch.randn(b, s, n, d, device=dev).to(dtype)
                for n in (h, k, k))
    before = K.LAUNCHES["flash_attention"]
    out, names = _kernels_run(lambda: flash_ops.flash_attention(
        q, kk, v, causal=causal, window=window))
    assert K.LAUNCHES["flash_attention"] == before + 1
    if dtype == torch.bfloat16 and d >= 64:      # D 64, 128, 256
        assert names == [n for n in names if f"flash_fwd_hopper<{d}>" in n]
        assert names and flash_k.kernel_for(d, dtype) == "hopper"
    want = flash_ref.attention_ref(q, kk, v, causal=causal, window=window)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("scale", [-0.2, 0.0])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_attention_any_scale(dev, scale, d):
    """The Hopper kernel (D 64, 128, 256) takes its row max on the raw scores,
    so the wrapper moves a negative scale into q; scale 0 is uniform
    attention over the live keys."""
    q, k, v = (torch.randn(2, 200, n, d, device=dev).to(torch.bfloat16)
               for n in (4, 2, 2))
    out, names = _kernels_run(lambda: flash_ops.flash_attention(
        q, k, v, causal=True, window=64, scale=scale))
    kind = "flash_fwd_hopper" if d >= 64 else "flash_fwd_kernel"
    assert names and all(kind in n for n in names), names
    want = flash_ref.attention_ref(q, k, v, causal=True, window=64,
                                   scale=scale)
    assert torch.allclose(out.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_reads_strided_views(dev, d):
    """q, k, v as views of one fused projection (no copy), like a packed
    qkv: the kernel reads them through their strides."""
    qkv = torch.randn(2, 77, 4 + 2 + 2, d, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out, names = _kernels_run(lambda: flash_ops.flash_attention(
        q, k, v, causal=True))
    assert names and all("flash_fwd_hopper" in n for n in names), names
    want = flash_ref.attention_ref(q, k, v, causal=True)
    assert torch.allclose(out.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_d256_is_served_by_the_hopper_kernel(dev):
    """bf16 at D 256 runs flash_fwd_hopper<256> (the profile names it):
    spill-free (no local memory), its 197,704 bytes of dynamic shared
    memory, one CTA an SM; the library's mma.sync entry refuses bf16 D 256
    (that kernel exists only in the measurement build)."""
    res = flash_k.resources(256)
    assert res["kernel"] == "hopper" and res["local_bytes"] == 0
    assert res["smem_dynamic"] == 197704 and res["ctas_per_sm"] == 1
    for d in (64, 128):
        assert flash_k.resources(d)["local_bytes"] == 0
    q, k, v = (torch.randn(1, 200, n, 256, device=dev).to(torch.bfloat16)
               for n in (4, 4, 4))
    _, names = _kernels_run(lambda: flash_ops.flash_attention(
        q, k, v, causal=True))
    assert names and all("flash_fwd_hopper<256>" in n for n in names), names
    o = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, o)
                                      for st in t.stride()[:3]))
    err = flash_k._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), 1, 200, 200, 4, 4, 256,
                        ctypes.addressof(strides), 0.0625, 1, 0, 1,
                        torch.cuda.current_stream().cuda_stream)
    assert err == 1                     # cudaErrorInvalidValue


def test_flash_attention_d256_in_a_cuda_graph(dev):
    """The D 256 Hopper kernel captured in a CUDA graph and replayed gives
    the eager call's output bit for bit (its tensor maps are encoded at
    capture and stay valid for the same tensors)."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(2, 333, n, 256, device=dev, generator=g)
               .to(torch.bfloat16) for n in (8, 2, 2))
    want = flash_ops.flash_attention(q, k, v, causal=True, window=100)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_ops.flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_ops.flash_attention(q, k, v, causal=True, window=100)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_gemma_prefill_through_the_kernel_matches_plain_bf16(dev):
    """gemma-7b's layers at full width (d 3072, 16 heads of 256, GeGLU
    24,576), 2 of them and a 1,000-token vocab, bf16 compute: the prefill's
    logits through K7 at D 256 against the plain attention path, within
    2e-2 of max |logit| (test_torch_lm.py's bf16 bound)."""
    import dataclasses
    from repro_torch.configs import get_arch
    spec = get_arch("gemma-7b")
    cfg = spec.make_config(num_layers=2, vocab_size=1000)
    params = spec.model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), device=dev)
    K.reset_launches()
    with torch.inference_mode():
        got, _ = spec.model.forward(params, {"tokens": toks},
                                    dataclasses.replace(
                                        cfg, attention_impl="kernel"))
        assert K.LAUNCHES["flash_attention"] == cfg.num_layers
        want, _ = spec.model.forward(params, {"tokens": toks}, cfg)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_prefill_through_the_kernel_matches_plain(dev):
    """qwen3-8b's layout at 2 layers and reduced width, f32: the prefill
    with attention through K7 against the plain attention path."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_arch("qwen3-8b")
    cfg = spec.make_config(num_layers=2, d_model=512, num_heads=8,
                           num_kv_heads=2, d_ff=1024, vocab_size=1000,
                           compute_dtype="float32")
    params = spec.model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=dev)
    K.reset_launches()
    with torch.inference_mode():
        got = make_prefill_step(spec, dataclasses.replace(
            cfg, attention_impl="kernel"))(params, {"tokens": toks})
        assert K.LAUNCHES["flash_attention"] == cfg.num_layers
        want = make_prefill_step(spec, cfg)(params, {"tokens": toks})
    assert torch.allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("s", [4, 20, 64, 70])
@pytest.mark.parametrize("hd", [(2, 8), (4, 16), (1, 32), (2, 64)])
def test_slstm_scan_kernel(dev, b, s, hd):
    h, dh = hd
    g = torch.Generator(device=dev).manual_seed(b * 31 + s)
    pres = [torch.randn(b, s, h, dh, device=dev, generator=g)
            for _ in range(4)]
    R = torch.randn(4, h, dh, dh, device=dev, generator=g) * 0.3
    before = K.LAUNCHES["slstm_scan"]
    out = slstm_ops.slstm_scan(*pres, R)
    assert K.LAUNCHES["slstm_scan"] == before + 1
    want, _ = slstm_ref.slstm_scan_ref(*pres, R, slstm_ref.initial_state(
        b, h, dh, dev))
    assert out.dtype == torch.float32 and out.shape == pres[0].shape
    assert torch.allclose(out, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("b,s,h,dh", [(3, 33, 2, 64), (5, 9, 4, 512),
                                     (3, 40, 4, 512)])
def test_slstm_scan_kernel_strided(dev, b, s, h, dh):
    """The four preactivations as views of one fused projection (no copy),
    at a small head and at the model's Dh 512."""
    g = torch.Generator(device=dev).manual_seed(b)
    fused = torch.randn(b, s, h, 4 * dh, device=dev, generator=g)
    pres = [fused[..., k * dh:(k + 1) * dh] for k in range(4)]
    R = torch.randn(4, h, dh, dh, device=dev, generator=g) * dh ** -0.5
    out = slstm_k.slstm_scan(*pres, R)
    want, _ = slstm_ref.slstm_scan_ref(*pres, R, slstm_ref.initial_state(
        b, h, dh, dev))
    assert torch.allclose(out, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("edge,b,s,h,dh", [
    ("B 1", 1, 64, 4, 512), ("B 5", 5, 64, 4, 512), ("S 1", 4, 1, 4, 512),
    ("ragged last slice", 4, 40, 4, 509), ("two launches", 2, 40, 12, 512),
    ("Dh 1", 2, 9, 3, 1), ("wide slices", 4, 9, 40, 128)])
def test_slstm_scan_kernel_plan_edges(dev, edge, b, s, h, dh):
    """The launch plan's edges, within 3e-4: one or five batch rows at the
    model's width, one step, a last slice narrower than the rest, a plan of
    two launches, one unit a head, and slices so wide (more than 32 units,
    4 rows a block) that a block's 4 x 4 units partial-sum totals outnumber
    its threads."""
    pl = slstm_k.card_plan(b, h, dh)
    if edge == "ragged last slice":
        assert dh % pl.units
    if edge == "two launches":
        assert len(pl.launches) == 2
    if edge == "wide slices":
        assert pl.rows >= 4 and 16 * pl.units > slstm_k.THREADS
    g = torch.Generator(device=dev).manual_seed(b * 7 + s)
    pres = [torch.randn(b, s, h, dh, device=dev, generator=g)
            for _ in range(4)]
    R = torch.randn(4, h, dh, dh, device=dev, generator=g) * dh ** -0.5
    before = K.LAUNCHES["slstm_scan"]
    out = slstm_ops.slstm_scan(*pres, R)
    assert K.LAUNCHES["slstm_scan"] == before + 1
    want, _ = slstm_ref.slstm_scan_ref(*pres, R, slstm_ref.initial_state(
        b, h, dh, dev))
    assert torch.allclose(out, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("dh", [1, 8, 100, 128, 509, 512])
def test_slstm_scan_smem_mirror_matches_c(dev, dh):
    """kernel.smem_bytes, which the plan's CPU tests use, equals the C
    side's layout (sfpl_slstm_scan_smem), which the card's plan uses, at
    every slice width and batch grouping the kernel takes."""
    for units in range(1, min(dh, slstm_k.THREADS // 4) + 1):
        for rows in (1, 2, 3, 4, 5, 8, 16, slstm_k.THREADS // units):
            if rows * units <= slstm_k.THREADS:
                assert slstm_k.smem_of(dh, units, rows) == \
                    slstm_k.smem_bytes(dh, units, rows), (dh, units, rows)


def test_slstm_scan_c_entry_rejects_short_shared_memory(dev):
    """The C entry refuses a launch whose dynamic shared memory is smaller
    than its layout needs (cudaErrorInvalidValue, 1), before launching."""
    import ctypes
    lib = slstm_k._lib()
    need = slstm_k.smem_of(512, 16, 4)
    strides = (ctypes.c_int64 * 12)(*([512] * 12))
    args = [None] * 7 + [4, 8, 4, 512, ctypes.addressof(strides), 4, 16, 32,
                         0, 4]
    assert lib.sfpl_slstm_scan(*args, need - 4, None) == 1


def test_slstm_scan_kernel_in_a_cuda_graph(dev):
    """Captured in a CUDA graph and replayed, the launch starts from a
    fresh exchange ring each time and gives the eager result."""
    g = torch.Generator(device=dev).manual_seed(5)
    pres = [torch.randn(2, 30, 4, 512, device=dev, generator=g)
            for _ in range(4)]
    R = torch.randn(4, 4, 512, 512, device=dev, generator=g) * 512 ** -0.5
    want = slstm_k.slstm_scan(*pres, R)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        slstm_k.slstm_scan(*pres, R)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = slstm_k.slstm_scan(*pres, R)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_slstm_scan_kernel_rejects_what_it_does_not_take(dev):
    x = torch.zeros(1, 3, 1, 8, device=dev)
    R = torch.zeros(4, 1, 8, 8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        slstm_k.slstm_scan(x.double(), x, x, x, R)
    with pytest.raises(ValueError, match="Dh"):
        big = torch.zeros(1, 3, 1, 1024, device=dev)
        slstm_k.slstm_scan(big, big, big, big,
                           torch.zeros(4, 1, 1024, 1024, device=dev))
    with pytest.raises(ValueError, match="R"):
        slstm_k.slstm_scan(x, x, x, x, R[:, :, :4])


def test_xlstm_prefill_through_the_kernel_matches_plain(dev):
    """xlstm-1.3b's layout at one group (7 mLSTM, 1 sLSTM) and reduced
    width, f32: the prefill with the sLSTM through K8 against the plain
    sLSTM path, every position."""
    import dataclasses
    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_arch("xlstm-1.3b")
    cfg = spec.make_config(num_layers=8, d_model=256, vocab_size=1000,
                           chunk_len=64, compute_dtype="float32")
    params = spec.model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=dev)
    K.reset_launches()
    with torch.inference_mode():
        got, _ = spec.model.forward(params, {"tokens": toks},
                                    dataclasses.replace(cfg,
                                                        slstm_impl="kernel"))
        assert K.LAUNCHES["slstm_scan"] == 1
        want, _ = spec.model.forward(params, {"tokens": toks}, cfg)
    assert torch.allclose(got, want, rtol=2e-3, atol=2e-3)
