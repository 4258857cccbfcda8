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
