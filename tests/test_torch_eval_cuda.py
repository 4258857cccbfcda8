"""The evaluation path on the card against the CPU: InceptionV3 in float32
with TF32 off whatever the conv numerics and the TF32 flags say (and the
flags given back), Newton-Schulz, and FID's translate+pool with its norm
kernels.

Needs a CUDA card; skips without one. It imports no JAX, so it runs on the
card's machine: ``python -m pytest tests/test_torch_eval_cuda.py
--noconftest -q``.
"""

import pytest
import torch

from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.eval import fid
from munit_tpu_torch.eval.inception import InceptionV3, pool_and_logits
from munit_tpu_torch.kernels import norms
from munit_tpu_torch.nn.generator import GenBundle

POOL_TOL = 1e-4     # of the largest magnitude


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _close(got, want, tol):
    err = (got.cpu() - want).abs().max()
    assert err <= tol * want.abs().max(), err


@pytest.mark.cuda
def test_inception_card_is_f32_without_tf32():
    _card()
    cpu = InceptionV3().init(torch.Generator().manual_seed(0)).frozen_on(
        "cpu")
    card = InceptionV3()
    card.load_state_dict(cpu.state_dict())
    card = card.frozen_on("cuda")
    x = torch.rand((2, 96, 96, 3), generator=torch.Generator().manual_seed(1))
    x = x * 2 - 1
    with torch.no_grad():
        want = pool_and_logits(cpu, x)
        ops.set_conv_compute(torch.bfloat16)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = pool_and_logits(card, x.cuda())
            assert torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            ops.set_conv_compute(None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, POOL_TOL)


@pytest.mark.cuda
def test_newton_schulz_card_matches_cpu():
    _card()
    g = torch.Generator().manual_seed(2)
    a = torch.randn((512, 256), generator=g)
    a = a.T @ a / 512
    want = fid.sqrt_newton_schulz(a)
    got = fid.sqrt_newton_schulz(a.cuda())
    _close(got, want, 1e-4)


@pytest.mark.cuda
def test_fid_translation_launches_the_norm_kernels():
    _card()
    conf = validate({"gen_state": 1, "guided": 1, "new_size": 64,
                     "gen": {"dim": 16, "mlp_dim": 32, "style_dim": 8,
                             "n_downsample": 2, "n_res": 2}})
    cpu = GenBundle(conf, "cpu")
    cpu.init(torch.Generator().manual_seed(3))
    card = GenBundle(conf, "cuda")
    card.load_state_dict(cpu.state_dict())
    x_a, x_b = (torch.rand((2, 64, 64, 3), generator=torch.Generator()
                           .manual_seed(s)) * 2 - 1 for s in (4, 5))
    norms.reset_launches()
    with torch.no_grad():
        got = fid.guided_a2b(card, x_a.cuda(), x_b.cuda())
        want = fid.guided_a2b(cpu, x_a, x_b)
    # one launch a wrapper call, each call over the batch of 2
    assert {k: v for k, v in norms.launches.items() if v} == {
        "instance_norm": 7, "adain": 4, "whole_layer_norm": 2}
    assert (got.cpu() - want).abs().max() <= 1e-3
