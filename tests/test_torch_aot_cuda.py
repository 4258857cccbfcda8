"""The norms' registered operators and a deployment artifact on the card.

Needs a CUDA card; skips without one. It imports no JAX, so it runs on the
card's machine: ``python -m pytest tests/test_torch_aot_cuda.py
--noconftest -q``.

- Each ``munit_tpu_torch::`` operator launches its kernel on a CUDA tensor
  (one launch, counted) and agrees with the plain version.
- An artifact traced on the card at small width translates at batch 1 and
  3 bit for bit as the eager generator (TF32 off), each dispatch through
  the kernels: 7 IN, 4 AdaIN and 2 LN launches.
"""

import pytest
import torch

from munit_tpu_torch.core import ops
from munit_tpu_torch.io import aot
from munit_tpu_torch.kernels import norms
from munit_tpu_torch.nn.generator import GenBundle

GEN = dict(dim=16, mlp_dim=32, style_dim=8, activ="relu", n_downsample=2,
           n_res=2, pad_type="reflect")
SIZE = 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", norms.NAMES)
def test_operator_launches_the_kernel(name):
    _card()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 16, 64), generator=g)
    gamma, beta = ((torch.randn((2, 64), generator=g),
                    torch.randn((2, 64), generator=g)) if name == "adain"
                   else (torch.rand((64,), generator=g),
                         torch.randn((64,), generator=g)))
    if name == "instance_norm":
        gamma = beta = None
    op = getattr(torch.ops.munit_tpu_torch, name)
    card = [None if t is None else t.cuda() for t in (x, gamma, beta)]
    norms.reset_launches()
    with torch.no_grad():
        got = (op(card[0], True) if gamma is None
               else op(*card, True))
    torch.cuda.synchronize()
    assert norms.launches[name] == 1
    want = norms._plain_forward(name, x, gamma, beta, True)
    assert (got.cpu() - want).abs().max() < 1e-4


@pytest.mark.cuda
def test_artifact_on_the_card(tmp_path):
    _card()
    conf = {"gen_state": 1, "input_dim_a": 3, "gen": GEN}
    gen = GenBundle(conf, "cuda")
    gen.init(torch.Generator().manual_seed(1))
    path = str(tmp_path / "a.pt2.zip")
    ops.set_conv_compute(None)
    aot.save_artifact(path, gen.module, SIZE, GEN["style_dim"], ("cuda",))
    art = aot.load_artifact(path, "cuda")
    g = torch.Generator().manual_seed(2)
    x = (torch.rand((3, SIZE, SIZE, 3), generator=g) * 2 - 1).cuda()
    with torch.no_grad(), ops.exact_f32():
        s = gen.encode_style(x[:1], 2)
        assert torch.equal(art.encode_style(x[:1]), s)
        for b in (1, 3):
            want = gen.decode(gen.encode_content(x[:b], 1),
                              s.expand(b, -1), 2)
            norms.reset_launches()
            got = art.translate(x[:b], s)
            torch.cuda.synchronize()
            assert {k: norms.launches[k] for k in norms.NAMES} == {
                "instance_norm": 7, "adain": 4, "whole_layer_norm": 2}
            assert torch.equal(got, want)
