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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (3, 12, 20, 24),
                                   (1, 7, 5, 3)])
def test_moments_kernels_against_plain_on_card(shape, dtype):
    """sample_sums (alone and with b) and sample_affine (ReLU on and off)
    against their plain versions; the odd shapes take the narrow vectors.
    Sums within 1e-5 of the summed magnitudes (float32 order); the apply
    f32 within 1e-5, bf16 within one bf16 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from munit_tpu_torch.kernels import moments
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    b, _, _, c = shape
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to("cuda", dt)
    y = torch.randn(shape, generator=gen).to("cuda", dt)
    moments.reset_launches()
    for other in (None, y):
        got = moments.sample_sums(x, other)
        want = moments.sample_sums_plain(x, other)
        bf = x.float() if other is None else other.float()
        scale = torch.stack([x.float().abs().flatten(1).sum(1),
                             (x.float() * bf).abs().flatten(1).sum(1)], 1)
        assert ((got - want).abs() <= 1e-5 * scale).all()
    mean = torch.randn(b, generator=gen).cuda()
    inv = (torch.rand(b, generator=gen) + 0.5).cuda()
    gamma, beta = torch.rand(c, generator=gen).cuda(), torch.randn(c, generator=gen).cuda()
    rtol, atol = (1e-5, 1e-5) if dt == torch.float32 else (2**-7, 3e-2)
    for relu in (False, True):
        got = moments.sample_affine(x, mean, inv, gamma, beta, relu)
        want = moments.sample_affine_plain(x, mean, inv, gamma, beta, relu)
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
    assert moments.launches == {"sample_sums": 2, "sample_affine": 2}
    with pytest.raises(ValueError, match="contiguous"):
        moments.sample_sums(x.transpose(1, 2))


@pytest.mark.cuda
def test_segmenter_resize_and_pool_gradients_on_card_match_the_cpu():
    """The segmenter's bilinear upsample and stem max pool take the same
    input gradient on the card as on the CPU (both run on contiguous NCHW
    copies; CUDA's channels-last pool backward was wrong before)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from munit_tpu_torch.core import ops
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 9, 7, 19), generator=gen, dtype=torch.float64)
    for fn in (lambda t: ops.resize_bilinear(t, (72, 56)),
               lambda t: ops.max_pool(t, 3, 2, 1)):
        grads = []
        for dev in ("cpu", "cuda"):
            xx = x.to(dev).requires_grad_(True)
            y = fn(xx)
            dy = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape) % 5
            grads.append(torch.autograd.grad(y, xx, dy.to(dev))[0].cpu())
        torch.testing.assert_close(grads[1], grads[0], rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_semantic_gradient_reaches_the_generator_on_card():
    """The semantic loss alone, through the frozen segmenter on the card:
    its gradient reaches the decoders and content encoders, none reaches
    the segmenter, and it matches the CPU's within 2e-2 relative L2 per
    leaf (TF32 off; chip_smoke.py's GRAD_TOL). Both take the CPU's
    pseudo-labels: a label that flips between the two decides a pixel's
    whole CE term."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from munit_tpu_torch.config import validate
    from munit_tpu_torch.nn.blocks import ConvBlock
    from munit_tpu_torch.train.trainer import MUNITTrainer
    from torch_port_util import small_train_spec, train_batch
    torch.backends.cudnn.allow_tf32 = False
    conf = validate(small_train_spec(semantic_w=3))
    grads, targets = [], None
    for dev in ("cpu", "cuda"):
        tr = MUNITTrainer(conf, dev)
        tr.init(torch.Generator().manual_seed(0))
        x_a, x_b, m_a, m_b = (torch.from_numpy(t).to(dev)
                              for t in train_batch(0))
        if targets is None:
            targets = tr._semantic_targets(x_a, x_b)
        fw = tr._gen_forward(x_a, x_b)
        loss = tr._semantic_loss_pair(fw["x_ab"], fw["x_ba"],
                                      [t.to(dev) for t in targets], m_a, m_b)
        params = tr.gen_params()
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        grads.append({k: v for k, v in zip(params, g) if v is not None})
        assert not any(p.requires_grad for p in tr.segmenter.parameters())
    cpu, card = grads
    assert set(card) == set(cpu)
    assert any(k.startswith("dec1") for k in card)
    assert any(k.startswith("enc2_content") for k in card)
    # conv biases an instance norm or AdaIN removes: exact gradient 0
    zero = {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}
    scale = max(w.abs().max().item() for w in cpu.values())
    for k, w in cpu.items():
        if k in zero:
            assert card[k].abs().max().item() <= 1e-5 * scale, k
            continue
        e = (card[k].cpu().double() - w.double()).norm() / w.double().norm()
        assert e <= 2e-2, (k, float(e))
