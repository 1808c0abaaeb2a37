"""Card-only tests of the BN kernels' data-parallel mode: the sums without
their finishing step, the fused finishing kernels (finish + normalise, finish
+ dx), zero-row sums, and one BatchNorm layer on two ranks that share the
card over gloo.

They need an NVIDIA GPU and ``nvcc``; here they skip. On the card:

    python -m pytest tests/test_torch_port_ddp_cuda.py -m cuda -q --noconftest
"""

import ctypes

import pytest
import torch

from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.models.resnet import ResNet
from s2anet_tpu_torch.ops import moments as mo
from s2anet_tpu_torch.parallel import mesh
from test_torch_port_ddp import WORLD, join_world, start_world

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def r50_bn_shapes(batch: int = 8, size: int = 1024):
    """``[N, H, W, C]`` of the 53 BatchNorm inputs of an R-50 train step, in
    order (a forward on the meta device)."""
    net = ResNet("resnet50").to("meta").eval()
    shapes = []
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(
                lambda mod, inp: shapes.append(tuple(inp[0].permute(0, 2, 3, 1).shape)))
    with torch.no_grad():
        net(torch.empty(batch, 3, size, size, device="meta"))
    return shapes


@pytest.mark.parametrize("prefix", [0, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_finish_kernels_equal_one_launch_path(dev, dtype, prefix):
    """At the 53 R-50 1024^2 batch-8 shapes, with the statistics on the first
    ``prefix`` images (0: another rank's; the forward then takes the whole
    batch's sums): the sums alone, then s2a_bn_apply_finish and
    s2a_bn_dx_finish (stat_rows = prefix*H*W), give the bits of the
    one-launch sums and finishing followed by s2a_bn_apply and s2a_bn_dx on
    the two row ranges (the sums take the same grid, so the same additions in
    the same order): statistics, running statistics, count, y, dgamma, dbeta
    and dx; one launch of each fused kernel a call, and none of the others."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = r50_bn_shapes()
    assert len(shapes) == 53
    fused = (mo.APPLY_FINISH, mo.DX_FINISH, mo.APPLY, mo.DX)
    for shape in shapes:
        b, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(dtype)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        weight = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = torch.randn(c, generator=gen, device=dev)
        k = prefix or b
        n, stat_rows = k * h * w, prefix * h * w
        runs = []
        for split in (False, True):
            rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
            tracked = torch.tensor(5, device=dev)
            before = [kern.launches for kern in fused]
            if split:
                y, stats = mo.bn_apply_finish(x, mo.moment_sums(x[:k]), n, weight, bias, rm, rv,
                                              tracked, 1e-5, 0.9)
                dx, dgamma, dbeta = mo.bn_dx_finish(g, x, mo.pair_sums(g, x), n, stats[0],
                                                    stats[2], stats[3], stat_rows)
                assert [kern.launches - n0 for kern, n0 in zip(fused, before)] == [1, 1, 0, 0]
            else:
                stats = mo.bn_stats(x[:k], weight, rm, rv, tracked, 1e-5, 0.9)
                y = mo.bn_apply(x, stats[0], stats[3], bias)
                dgamma, dbeta, a, bb = mo.bn_grad(g, x, stats[0], stats[2], n)
                dx = torch.empty_like(x)
                if prefix:
                    mo.bn_dx(g[:prefix], x[:prefix], stats[0], stats[3], a, bb, out=dx[:prefix])
                zero = torch.zeros_like(a)
                mo.bn_dx(g[prefix:], x[prefix:], stats[0], stats[3], zero, zero,
                         out=dx[prefix:])
            runs.append(tuple(stats) + (rm, rv, tracked, y, dgamma, dbeta, dx))
        torch.cuda.synchronize()
        for a, bb in zip(*runs):
            assert torch.equal(a, bb), shape
        assert int(runs[1][6]) == 6


def test_zero_row_sums_are_zeros(dev):
    """No rows: the wrappers give zero sums without a launch; the entry
    points write zeros into the output (no garbage to all-reduce) and
    refuse to finish over no rows; the fused finishing wrappers refuse n <=
    0, sums off the input's card and stat_rows past the rows, and over no
    rows still write the statistics."""
    x = torch.randn(2, 4, 4, 64, device=dev).bfloat16()
    g = torch.randn_like(x)
    n_m, n_p = mo.MOMENTS.launches, mo.PAIR.launches
    assert torch.equal(mo.moment_sums(x[:0]), torch.zeros(2, 64, device=dev))
    assert torch.equal(mo.pair_sums(g[:0], x[:0]), torch.zeros(2, 64, device=dev))
    assert (mo.MOMENTS.launches, mo.PAIR.launches) == (n_m, n_p)
    stream = torch.cuda.current_stream().cuda_stream
    for kernel, args in ((mo.MOMENTS, lambda out, gamma: (
            x.data_ptr(), out.data_ptr(), None, None, 0, 64, 8, 1, gamma, None, None, None,
            1e-5, 0.9, 0.1, stream)),
                         (mo.PAIR, lambda out, mean: (
            g.data_ptr(), x.data_ptr(), out.data_ptr(), None, None, 0, 64, 8, 1, mean, None,
            1, stream))):
        out = torch.full((2, 64), float("nan"), device=dev)
        kernel(*args(out, None))
        torch.cuda.synchronize()
        assert torch.equal(out, torch.zeros_like(out)), kernel.symbol
        with pytest.raises(RuntimeError, match="cudaError"):
            kernel(*args(torch.empty(6, 64, device=dev), ctypes.c_void_p(out.data_ptr())))
    sums = torch.zeros(2, 64, device=dev)
    vec = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="n = 0"):
        mo.bn_dx_finish_cuda(g, x, sums, 0, vec, vec, vec, 0)
    with pytest.raises(ValueError, match="sums must be on cuda"):
        mo.bn_dx_finish_cuda(g, x, sums.cpu(), 4, vec, vec, vec, 0)
    with pytest.raises(ValueError, match="stat_rows = 33"):
        mo.bn_dx_finish_cuda(g, x, sums, 4, vec, vec, vec, 33)
    # rows = 0: the fused kernels still launch and write the statistics
    run = (torch.zeros(64, device=dev), torch.ones(64, device=dev), torch.tensor(0, device=dev))
    y, stats = mo.bn_apply_finish_cuda(x[:0], torch.ones(2, 64, device=dev), 4, vec, vec, *run,
                                       1e-5, 0.9)
    torch.cuda.synchronize()
    assert y.shape == (0, 4, 4, 64) and int(run[2]) == 1
    assert torch.equal(stats[0], torch.full((64,), 0.25, device=dev))


BN_SHAPE = (4, 64, 24, 20)  # global batch 4, 2 a rank


def _bn_case():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(BN_SHAPE, generator=gen) * 2 + 1
    g = torch.randn(BN_SHAPE, generator=gen)
    w = torch.rand(BN_SHAPE[1], generator=gen) + 0.5
    return x, g, w


def _bn_step(x, g, w, k, dev):
    bn = BatchNorm2d(BN_SHAPE[1], stats_images=k).to(dev).train()
    with torch.no_grad():
        bn.weight.copy_(w)
    x = x.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_()
    y = bn(x)
    y.backward(g.to(dev).contiguous(memory_format=torch.channels_last))
    return [t.detach().cpu() for t in (y, x.grad, bn.weight.grad, bn.bias.grad,
                                       bn.running_mean, bn.running_var)]


def _card_world(rank, store, out):
    dev = mesh.init_group("cuda", f"file://{store}", rank, WORLD)
    torch.backends.cudnn.allow_tf32 = False
    b = BN_SHAPE[0] // WORLD
    x, g, w = _bn_case()
    part = slice(rank * b, (rank + 1) * b)
    res = {}
    for k in (0, 1, 3):
        kernels = (mo.APPLY_FINISH, mo.DX_FINISH, mo.MOMENTS, mo.APPLY, mo.DX)
        before = [kern.launches for kern in kernels]
        res[k] = _bn_step(x[part], g[part], w, k, dev)
        res[k].append(tuple(kern.launches - n0 for kern, n0 in zip(kernels, before)))
    torch.save(res, out / f"card.{rank}.pt")
    mesh.shutdown()


@pytest.fixture(scope="module")
def card_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = tmp_path_factory.mktemp("ddp_card")
    join_world(start_world(_card_world, str(out / "store"), out), timeout=240)
    return [torch.load(out / f"card.{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("k", [0, 1, 3])
def test_bn_layer_two_ranks_on_one_card(dev, card_world, k):
    """Two ranks share the card over gloo: one BatchNorm2d in float32,
    forward and backward, against one process on the four images, within
    1e-5 of the largest value; both ranks launch each fused finishing
    kernel once, the sums kernel once (zero rows on rank 1 at k = 1: no
    launch) and neither s2a_bn_apply nor s2a_bn_dx."""
    ranks = [w[k] for w in card_world]
    x, g, w = _bn_case()
    want = _bn_step(x, g, w, k, dev)
    for i, name in enumerate(("y", "dx")):
        got = torch.cat([r[i] for r in ranks])
        assert (got - want[i]).abs().max() <= 1e-5 * want[i].abs().max(), name
    for i in range(2, 6):
        assert torch.equal(ranks[0][i], ranks[1][i])
        assert (ranks[0][i] - want[i]).abs().max() <= 1e-5 * want[i].abs().max(), i
    assert ranks[0][6] == (1, 1, 1, 0, 0)
    assert ranks[1][6] == (1, 1, 0 if k == 1 else 1, 0, 0)
