"""The CUDA norm kernels against their plain versions, on the card.

Needs a CUDA card and nvcc; skips without a card. It imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

f32 within rtol 1e-4, atol 1e-4 (summation order); bf16 within atol 3e-2,
rtol 2**-7 (one bf16 ulp).
"""

import pytest
import torch

from munit_tpu_torch.kernels import norms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256, 256, 64), (2, 64, 64, 256),
                                   (3, 12, 20, 24)])
def test_kernels_against_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    b, _, _, c = shape
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to("cuda", dt)
    g2, b2 = (torch.randn(b, c, generator=gen).cuda() for _ in range(2))
    g1, b1 = torch.rand(c, generator=gen).cuda(), torch.randn(c, generator=gen).cuda()
    rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (2**-7, 3e-2)
    for relu in (False, True):
        pairs = [(norms.instance_norm(x, relu), norms.instance_norm_plain(x, relu)),
                 (norms.adain(x, g2, b2, relu), norms.adain_plain(x, g2, b2, relu)),
                 (norms.whole_layer_norm(x, g1, b1, relu),
                  norms.whole_layer_norm_plain(x, g1, b1, relu))]
        torch.cuda.synchronize()
        for got, want in pairs:
            assert got.dtype == dt
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)


@pytest.mark.cuda
def test_kernels_count_launches_and_check_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(1)
    n = 2 * 16 * 16 * 12
    # a 4-byte offset into the storage narrows the vectors to one channel
    flat = torch.randn(n + 1, generator=gen).cuda()
    x = flat[1:].view(2, 16, 16, 12)
    assert x.data_ptr() % 16 == 4
    norms.reset_launches()
    torch.testing.assert_close(norms.instance_norm(x, True),
                               norms.instance_norm_plain(x, True),
                               rtol=1e-4, atol=1e-4)
    assert norms.launches["instance_norm"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        norms.instance_norm(x.transpose(1, 2))
    with pytest.raises(TypeError, match="dtype"):
        norms.instance_norm(x.half())
    assert norms.launches["instance_norm"] == 1


def _grads(fn, x, affine, dy):
    """(y, dx, dgamma, dbeta) of fn through autograd."""
    x = x.detach().requires_grad_(True)
    affine = [a.detach().requires_grad_(True) for a in affine]
    y = fn(x, *affine)
    grads = torch.autograd.grad(y, [x, *affine], dy)
    return (y, *grads)


@pytest.mark.cuda
def test_norm_outputs_carry_a_grad_fn_on_card():
    """A norm's output on the card is part of the autograd graph: its
    gradient reaches x through the backward kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 8, 8, 16), generator=gen).cuda().requires_grad_(True)
    norms.reset_launches()
    y = norms.instance_norm(x, True)
    assert y.grad_fn is not None
    (y * torch.randn_like(y)).sum().backward()
    assert x.grad is not None and x.grad.abs().sum().item() > 0
    assert norms.launches["instance_norm_bwd"] == 1


def gap_inputs(shape, gen):
    """x, AdaIN's (B, C) and the LN's (C,) gamma, beta, drawn so that every
    pre-activation x̂ gamma + beta stays 0.3 |gamma| or more away from 0:
    x is ±(1 + |N(0, 1)|) around an offset, so |x̂| >= ~0.5, and beta /
    gamma is within ±0.2. A recomputed ReLU mask then cannot flip on a
    last-ulp difference of the statistics."""
    b, _, _, c = shape
    x = torch.randn(shape, generator=gen)
    x = torch.sign(x) * (1 + x.abs()) + 0.5

    def affine(*s):
        sign = torch.where(torch.rand(s, generator=gen) < 0.5, -1.0, 1.0)
        g = sign * (0.5 + torch.rand(s, generator=gen))
        return g, g * (torch.rand(s, generator=gen) * 0.4 - 0.2)

    g2, b2 = affine(b, c)
    g1, b1 = affine(c)
    g1 = g1.abs()                       # the LN's gamma is U[0, 1) at init
    b1 = g1 * (b1 / g1.abs())
    return x, g2, b2, g1, b1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256, 256, 64), (2, 64, 64, 256),
                                   (3, 12, 20, 24)])
def test_backward_kernels_against_plain_on_card(shape, dtype):
    """dx, dgamma, dbeta of the kernels against the plain closed-form
    backward, with a non-contiguous dy (an NCHW-contiguous tensor seen as
    NHWC). f32 within rtol 1e-4 and 1e-4 of the gradient's largest value
    (summation order); bf16 within two bf16 ulps of it (x, dy and dx are
    bf16; the math is f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    b, h, w, c = shape
    x, g2, b2, g1, b1 = (t.cuda() for t in gap_inputs(shape, gen))
    x = x.to(dt)
    dy = torch.randn((b, c, h, w), generator=gen).to("cuda", dt)
    dy = dy.permute(0, 2, 3, 1)
    assert not dy.is_contiguous()
    for relu in (False, True):
        norms.reset_launches()
        cases = [
            (_grads(lambda x: norms.instance_norm(x, relu), x, [], dy),
             (norms.instance_norm_backward_plain(x, dy, relu),)),
            (_grads(lambda x, g, bt: norms.adain(x, g, bt, relu), x,
                    [g2, b2], dy),
             norms.adain_backward_plain(x, g2, b2, dy, relu)),
            (_grads(lambda x, g, bt: norms.whole_layer_norm(x, g, bt, relu),
                    x, [g1, b1], dy),
             norms.whole_layer_norm_backward_plain(x, g1, b1, dy, relu))]
        torch.cuda.synchronize()
        assert norms.launches["instance_norm_bwd"] == 1
        assert norms.launches["adain_bwd"] == 1
        assert norms.launches["whole_layer_norm_bwd"] == 1
        assert sum(norms.dy_copies.values()) == 3
        for (y, *got), want in cases:
            assert y.grad_fn is not None and got[0].dtype == dt
            for g, wv in zip(got, want):
                scale = wv.float().abs().max().item()
                tol = 1e-4 if dt == torch.float32 else 2 * 2**-8
                torch.testing.assert_close(g.float(), wv.float(),
                                           rtol=tol, atol=tol * scale)


@pytest.mark.cuda
def test_pool_gradients_on_card_match_the_cpu():
    """The discriminator's and classifier's pools take the same input
    gradient on the card as on the CPU (CUDA's channels-last avg_pool2d
    backward did not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from munit_tpu_torch.core import ops
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 33, 20, 8), generator=gen, dtype=torch.float64)
    for fn in (ops.avg_pool_3x3_s2, lambda t: ops.max_pool(t, 2, 2),
               lambda t: ops.window_avg_pool(t, 16)):
        grads = []
        for dev in ("cpu", "cuda"):
            xx = x.to(dev).requires_grad_(True)
            y = fn(xx)
            dy = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape) % 7
            grads.append(torch.autograd.grad(y, xx, dy.to(dev))[0].cpu())
        torch.testing.assert_close(grads[1], grads[0], rtol=1e-12, atol=1e-12)
