"""The CUDA norm kernels against their plain versions, on the card.

Needs a CUDA card and nvcc; skips without a card. It imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

f32 within rtol 1e-4, atol 1e-4 (summation order); bf16 within atol 3e-2,
rtol 2**-7 (one bf16 ulp).
"""

import faulthandler

import pytest
import torch

from munit_tpu_torch.kernels import norms

# Seconds one grid-design test may take before its process is ended with a
# traceback: a grid barrier that waits on a block that never runs would
# otherwise hang the card until the run's own limit.
GRID_TEST_SECONDS = 180


@pytest.fixture
def deadline():
    faulthandler.dump_traceback_later(GRID_TEST_SECONDS, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


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


def _wide_affine(g, b):
    """gamma and beta as column slices of one wider (B, 4C) tensor, as the
    generator slices them from the style MLP's output."""
    c = g.shape[1]
    wide = torch.empty((g.shape[0], 4 * c), device=g.device)
    wide[:, c:2 * c], wide[:, :c] = g, b
    return wide[:, c:2 * c], wide[:, :c]


def _check_designs(x, g2, b2, dy, relu, dt):
    """IN and AdaIN through the cluster design against the plain forward
    and closed-form backward, the split design against the same, and two
    cluster runs bitwise equal."""
    rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (2**-7, 3e-2)
    tol = 1e-4 if dt == torch.float32 else 2 * 2**-8
    for name, aff in (("instance_norm", [None, None]), ("adain", [g2, b2])):
        plain = (norms.instance_norm_plain(x, relu) if name == "instance_norm"
                 else norms.adain_plain(x, g2, b2, relu))
        grads_plain = (
            (norms.instance_norm_backward_plain(x, dy, relu),)
            if name == "instance_norm"
            else norms.adain_backward_plain(x, g2, b2, dy, relu))
        runs = {}
        for design in ("cluster", "cluster again", "split"):
            split = design == "split"
            y, stats = norms._launch(name, x, *aff, relu, False, split=split)
            grads = norms._launch_backward(name, x, stats, *aff, dy, relu,
                                           False, split=split)
            runs[design] = (y, stats, *grads)
            torch.cuda.synchronize()
            assert y.dtype == dt and grads[0].dtype == dt
            torch.testing.assert_close(y.float(), plain.float(), rtol=rtol,
                                       atol=atol)
            for got, want in zip(grads, grads_plain):
                scale = want.float().abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol * scale)
        for a, b in zip(runs["cluster"], runs["cluster again"]):
            assert a is None or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 2, 8, 16])
def test_cluster_kernels_against_plain_on_card(b, dtype):
    """IN and AdaIN at the decoders' (B, 64, 64, 256), every batch the path
    runs, ReLU on and off, gamma and beta strided slices of a wider tensor:
    the cluster design (one launch each way) against the plain forward and
    closed-form backward, the split design forced at the same shape against
    the same, and two runs bitwise equal. The wrapper's autograd path takes
    the cluster design and launches once each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(7)
    shape = (b, 64, 64, 256)
    x, g2, b2, _, _ = (t.cuda() for t in gap_inputs(shape, gen))
    x = x.to(dt)
    g2, b2 = _wide_affine(g2, b2)
    assert g2.stride() == (4 * 256, 1)
    dy = torch.randn(shape, generator=gen).to("cuda", dt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tiles in (1, 2):
        assert norms.cluster_plan(b, 64 * 64, 256, x.element_size(),
                                  x.data_ptr(), sms, tiles) is not None
    for relu in (False, True):
        _check_designs(x, g2, b2, dy, relu, dt)
        norms.reset_launches()
        y, *got = _grads(lambda x, g, bt: norms.adain(x, g, bt, relu), x,
                         [g2, b2], dy)
        torch.cuda.synchronize()
        assert norms.launches["adain"] == 1 and norms.launches["adain_bwd"] == 1
        for g, want in zip(got, norms.adain_backward_plain(x, g2, b2, dy,
                                                           relu)):
            tol = 1e-4 if dt == torch.float32 else 2 * 2**-8
            torch.testing.assert_close(g.float(), want.float(), rtol=tol,
                                       atol=tol * want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 5, 40), (3, 12, 20, 24)])
def test_cluster_kernels_ragged_on_card(shape, dtype):
    """A ragged last block of rows (H*W = 35 over the cluster) and channel
    counts that the group does not divide, both designs, ReLU on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    x, g2, b2, _, _ = (t.cuda() for t in gap_inputs(shape, gen))
    g2, b2 = _wide_affine(g2, b2)
    dy = torch.randn(shape, generator=gen).to("cuda", dt)
    for relu in (False, True):
        _check_designs(x.to(dt), g2, b2, dy, relu, dt)


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


def _norm_cases(x, g2, b2, g1, b1):
    """(name, affine, whole) of the three norms on x."""
    return (("instance_norm", [None, None], False), ("adain", [g2, b2], False),
            ("whole_layer_norm", [g1, b1], True))


def _check_grid(x, g2, b2, g1, b1, dy, relu, dt, names=None):
    """IN, AdaIN and the LN (or those of ``names``) through the grid
    design, forward and backward, against the plain forward and closed-form
    backward; the split design forced at the same shape against the same;
    two grid runs bitwise equal; one grid launch per call each way."""
    b, h, w, c = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (2**-7, 3e-2)
    tol = 1e-4 if dt == torch.float32 else 2 * 2**-8
    for name, aff, whole in _norm_cases(x, g2, b2, g1, b1):
        if names is not None and name not in names:
            continue
        for tiles in (1, 2):
            assert isinstance(norms.choose(b, h * w, c, x.element_size(),
                                           x.data_ptr(), sms, tiles, whole),
                              norms.GridPlan), (name, tiles)
        plain = norms._plain_forward(name, x, *aff, relu)
        grads_plain = norms._plain_backward(name, x, *aff, dy, relu)
        runs = {}
        for design in ("grid", "grid again", "split"):
            split = design == "split"
            norms.reset_launches()
            y, stats = norms._launch(name, x, *aff, relu, whole, split=split)
            grads = norms._launch_backward(name, x, stats, *aff, dy, relu,
                                           whole, split=split)
            torch.cuda.synchronize()
            want = "split" if split else "grid"
            assert norms.design_launches[name][want] == 1
            assert norms.design_launches[name + "_bwd"][want] == 1
            assert norms.launches[name] == norms.launches[name + "_bwd"] == 1
            runs[design] = (y, stats, *grads)
            assert y.dtype == dt and grads[0].dtype == dt
            torch.testing.assert_close(y.float(), plain.float(), rtol=rtol,
                                       atol=atol)
            for got, want_g in zip(grads, grads_plain):
                if want_g is None:
                    assert got is None
                    continue
                scale = want_g.float().abs().max().item()
                torch.testing.assert_close(got.float(), want_g.float(),
                                           rtol=tol, atol=tol * scale)
        for a, b_ in zip(runs["grid"], runs["grid again"]):
            assert a is None or torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 2, 8, 16])
@pytest.mark.parametrize("hwc", [(128, 128, 128), (256, 256, 64)])
def test_grid_kernels_against_plain_on_card(hwc, b, dtype, deadline):
    """IN, AdaIN and the LN at the path's 128^2 and 256^2 shapes, every batch
    the path runs (2B for the wide decodes; from batch 8 on, and at batch 2
    backward, more than the blocks keep on chip), ReLU on and off, AdaIN's
    gamma and beta strided slices of a wider tensor: the grid design (one
    launch each way) against the plain versions, the split design forced
    at the same shape against the same, two runs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(9)
    shape = (b, *hwc)
    x, g2, b2, g1, b1 = (t.cuda() for t in gap_inputs(shape, gen))
    g2, b2 = _wide_affine(g2, b2)
    dy = torch.randn(shape, generator=gen).to("cuda", dt)
    for relu in (False, True):
        _check_grid(x.to(dt), g2, b2, g1, b1, dy, relu, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 129, 131, 40), (2, 97, 211, 24),
                                   (300, 4, 4, 8)])
def test_grid_kernels_ragged_on_card(shape, dtype, deadline):
    """Ragged rows over the segments, channel counts below 16-byte groups of
    a block's threads, and more samples than blocks (each block takes
    several whole samples; the LN only: IN and AdaIN take the cluster
    design there), both designs, ReLU on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(10)
    x, g2, b2, g1, b1 = (t.cuda() for t in gap_inputs(shape, gen))
    g2, b2 = _wide_affine(g2, b2)
    dy = torch.randn(shape, generator=gen).to("cuda", dt)
    b, h, w, c = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # where IN and AdaIN run the cluster design, the LN alone is the grid's
    names = (("whole_layer_norm",)
             if norms.cluster_plan(b, h * w, c, 4, 0, sms) is not None
             else None)
    for relu in (False, True):
        _check_grid(x.to(dt), g2, b2, g1, b1, dy, relu, dt, names)


@pytest.mark.cuda
def test_grid_norms_run_one_device_kernel_per_call(deadline):
    """Through the public wrappers and autograd, as the generator calls
    them: one IN at (1, 128, 128, 128) and one LN at (2, 256, 256, 64), each
    one device kernel forward and one backward (no memset, no copy: dy is
    contiguous), the grid kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(11)
    cases = []
    for shape, name in (((1, 128, 128, 128), "instance_norm"),
                        ((2, 256, 256, 64), "whole_layer_norm")):
        x, _, _, g1, b1 = (t.cuda() for t in gap_inputs(shape, gen))
        x.requires_grad_(True)
        aff = [] if name == "instance_norm" else [g1.requires_grad_(True),
                                                  b1.requires_grad_(True)]
        dy = torch.randn(shape, generator=gen).cuda()
        cases.append((name, x, aff, dy))
    for name, x, aff, dy in cases:
        fn = getattr(norms, name)
        fn(x, *aff, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as fwd:
            y = fn(x, *aff, True)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as bwd:
            torch.autograd.grad(y, [x, *aff], dy)
            torch.cuda.synchronize()
        for prof, kernel in ((fwd, "norm_grid_fwd"), (bwd, "norm_grid_bwd")):
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            assert len(kernels) == 1 and kernel in kernels[0], (name, kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("instance_norm", (1, 256, 256, 64)), ("instance_norm", (2, 64, 64, 256)),
    ("adain", (2, 64, 64, 256)), ("whole_layer_norm", (2, 128, 128, 128))])
def test_bf16_wrappers_as_bf16_training_calls_them_on_card(name, shape):
    """The wrappers as bf16 training calls them: a bf16 x, f32 gamma and
    beta (AdaIN's as column slices of the style MLP's f32 output), a
    contiguous bf16 dy. Forward and backward against the plain versions
    (one bf16 ulp forward, two of the largest value backward), dx bf16 and
    the affine gradients f32, one launch each way counted on a bf16 x, no
    dy copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(4)
    x, g2, b2, g1, b1 = gap_inputs(shape, gen)
    x = x.to("cuda", torch.bfloat16)
    g2, b2 = _wide_affine(g2.cuda(), b2.cuda())
    g1, b1 = g1.cuda(), b1.cuda()
    dy = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    affine = {"instance_norm": [], "adain": [g2, b2],
              "whole_layer_norm": [g1, b1]}[name]
    fn = getattr(norms, name)
    norms.reset_launches()
    y, *got = _grads(lambda x, *a: fn(x, *a, True), x, affine, dy)
    torch.cuda.synchronize()
    plain = getattr(norms, name + "_plain")(x, *affine, True)
    want = norms._plain_backward(name, x, *(affine or [None, None]), dy, True)
    assert y.dtype == got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    torch.testing.assert_close(y.float(), plain.float(), rtol=2**-7,
                               atol=3e-2)
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=2 * 2**-8,
                                   atol=2 * 2**-8 * scale)
    for key in (name, name + "_bwd"):
        assert norms.launches[key] == norms.bf16_launches[key] == 1, key
    assert norms.dy_copies[name] == 0


@pytest.mark.cuda
def test_bf16_fused_step_on_card_matches_the_cpu():
    """One bf16 fused step (bf16 conv operands and images) at small width,
    card against the CPU: every gradient f32, every norm launch on a bf16
    x; the gradients nearer the CPU's bf16 mode than the CPU's f32 one (a
    bf16 run's rounding moves ReLU masks and L1 signs, so no per-leaf bound
    holds between two summation orders: PERF.md); the fused step's losses
    within 2e-2 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from munit_tpu_torch.config import validate
    from munit_tpu_torch.core import ops
    from munit_tpu_torch.train.trainer import MUNITTrainer
    from torch_port_util import small_train_spec, train_batch
    conf = validate(small_train_spec())
    batch = [torch.from_numpy(t) for t in train_batch(1)]
    grads, losses = {}, {}
    try:
        for dev, mode in (("cpu", None), ("cpu", torch.bfloat16),
                          ("cuda", torch.bfloat16)):
            ops.set_conv_compute(mode)
            tr = MUNITTrainer(conf, dev)
            tr.init(torch.Generator().manual_seed(0))
            x_a, x_b, m_a, m_b = (t.to(dev) for t in batch)
            if mode is not None:
                x_a, x_b = x_a.bfloat16(), x_b.bfloat16()
            norms.reset_launches()
            gd, gg = tr.dis_gen_grads(x_a, x_b, m_a, m_b)
            g = {k: v.cpu() for k, v in {**gd, **gg}.items()}
            assert all(v.dtype == torch.float32 for v in g.values())
            grads[(dev, mode)] = g
            losses[(dev, mode)] = {k: float(v) for k, v in
                                   tr.dis_gen_update(x_a, x_b, m_a,
                                                     m_b).items()}
            if dev == "cuda":
                assert norms.launches == norms.bf16_launches
                assert norms.launches["adain_bwd"] > 0
    finally:
        ops.set_conv_compute(None)
    card = grads[("cuda", torch.bfloat16)]

    def dist(other):
        num = sum(float((card[k] - other[k]).double().square().sum())
                  for k in card)
        return (num / sum(float(other[k].double().square().sum())
                          for k in card)) ** 0.5

    assert dist(grads[("cpu", torch.bfloat16)]) < dist(grads[("cpu", None)])
    for k, v in losses[("cpu", torch.bfloat16)].items():
        assert abs(losses[("cuda", torch.bfloat16)][k] - v) <= 2e-2 * max(
            abs(v), 1e-3), k
