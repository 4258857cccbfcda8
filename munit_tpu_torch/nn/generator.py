"""MUNIT generators as ``nn.Module``s on NHWC tensors.

Counterparts of ``munit_tpu/nn/generator.py`` (reference networks.py), in
plain math: the JAX package's space-to-depth stems and lane-packed decoder
tail are exact rewrites for the TPU and have no counterpart here. The style
MLP's output is split into per-layer (gamma, beta) pairs and passed down the
decoder call, as in the JAX package.

Style codes are (B, style_dim). Submodule indices follow the reference
``state_dict`` layout (``enc_style.model.{i}``, ``dec2.model.0.model.{j}``),
with paramless placeholders where the reference has a pool or an upsample.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from munit_tpu_torch.core import init as winit
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.blocks import (AdainPair, ConvBlock, LayerNormParams,
                                       MLP, ResBlocks)


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return ops.global_avg_pool(x)


class Upsample(nn.Module):
    def forward(self, x):
        return ops.upsample_nearest(x, 2)


class StyleEncoder(nn.Module):
    """networks.py:442-477. 7x7 s1 → 2 doubling 4x4 s2 → (n_downsample-2)
    non-doubling 4x4 s2 → global average pool → 1x1 conv → (B, style_dim)."""

    def __init__(self, n_downsample: int, input_dim: int, dim: int,
                 style_dim: int, activ: str = "relu",
                 pad_type: str = "reflect"):
        super().__init__()
        layers = [ConvBlock(input_dim, dim, 7, 1, 3, "none", activ, pad_type)]
        for _ in range(2):
            layers.append(ConvBlock(dim, 2 * dim, 4, 2, 1, "none", activ,
                                    pad_type))
            dim *= 2
        for _ in range(n_downsample - 2):
            layers.append(ConvBlock(dim, dim, 4, 2, 1, "none", activ, pad_type))
        layers += [GlobalAvgPool(), nn.Conv2d(dim, style_dim, 1)]
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model[:-1]:
            x = layer(x)
        out = self.model[-1]
        x = ops.conv2d(x, out.weight, out.bias)
        return x.reshape(x.shape[0], -1)


class ContentEncoder(nn.Module):
    """networks.py:480-512. 7x7 s1 IN → n_downsample doubling 4x4 s2 IN →
    n_res IN res blocks. Output (B, H/2^n, W/2^n, dim*2^n)."""

    def __init__(self, n_downsample: int, n_res: int, input_dim: int,
                 dim: int, activ: str = "relu", pad_type: str = "reflect"):
        super().__init__()
        layers = [ConvBlock(input_dim, dim, 7, 1, 3, "in", activ, pad_type)]
        for _ in range(n_downsample):
            layers.append(ConvBlock(dim, 2 * dim, 4, 2, 1, "in", activ,
                                    pad_type))
            dim *= 2
        layers.append(ResBlocks(n_res, dim, "in", activ, pad_type))
        self.model = nn.ModuleList(layers)
        self.output_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model:
            x = layer(x)
        return x


class Decoder(nn.Module):
    """networks.py:515-563. n_res res blocks (AdaIN, or IN with ``res_norm
    "in"``: UNIT's decoder) → n_upsample × [2x nearest upsample, 5x5 conv +
    whole-tensor LN + act] → 7x7 conv + tanh."""

    def __init__(self, n_upsample: int, n_res: int, dim: int, output_dim: int,
                 activ: str = "relu", pad_type: str = "reflect",
                 res_norm: str = "adain"):
        super().__init__()
        if res_norm not in ("adain", "in"):
            raise ValueError(f"res_norm must be adain or in, got {res_norm!r}")
        self.dim, self.n_res, self.res_norm = dim, n_res, res_norm
        layers = [ResBlocks(n_res, dim, res_norm, activ, pad_type)]
        for _ in range(n_upsample):
            layers += [Upsample(),
                       ConvBlock(dim, dim // 2, 5, 1, 2, "ln", activ, pad_type)]
            dim //= 2
        layers.append(ConvBlock(dim, output_dim, 7, 1, 3, "none", "tanh",
                                pad_type))
        self.model = nn.ModuleList(layers)

    @property
    def num_adain_params(self) -> int:
        # 2 AdaIN layers per res block, 2*dim parameters each
        return self.n_res * 2 * 2 * self.dim if self.res_norm == "adain" else 0

    def split_adain_params(self, adain_params: torch.Tensor) -> List[AdainPair]:
        """Split the MLP output (B, num_adain) into per-layer (gamma, beta).
        Per AdaIN layer the first ``dim`` entries are the shift (beta, the
        reference's "mean") and the next ``dim`` the scale (gamma, its
        "std"), in the reference's order (networks.py:230-239)."""
        d = self.dim
        return [(adain_params[:, off + d:off + 2 * d],
                 adain_params[:, off:off + d])
                for off in range(0, self.n_res * 4 * d, 2 * d)]

    def forward(self, x: torch.Tensor,
                adain_params: Optional[torch.Tensor] = None) -> torch.Tensor:
        pairs = (self.split_adain_params(adain_params)
                 if self.res_norm == "adain" else None)
        x = self.model[0](x, pairs)
        for layer in self.model[1:]:
            x = layer(x)
        return x


class AdaINGen(nn.Module):
    """Upstream MUNIT's single-domain auto-encoder (networks.py:170-254):
    its own style encoder, content encoder, decoder and MLP. Two of them,
    one per domain, are the ``gen_state: 0`` generator (``AdaINGenPair``).
    Keys follow the reference ``enc_style.*``, ``enc_content.*``, ``dec.*``,
    ``mlp.*`` layout."""

    def __init__(self, input_dim: int, dim: int, style_dim: int,
                 n_downsample: int, n_res: int, mlp_dim: int,
                 activ: str = "relu", pad_type: str = "reflect"):
        super().__init__()
        self.enc_style = StyleEncoder(4, input_dim, dim, style_dim, activ,
                                      pad_type)
        self.enc_content = ContentEncoder(n_downsample, n_res, input_dim, dim,
                                          activ, pad_type)
        self.dec = Decoder(n_downsample, n_res, self.enc_content.output_dim,
                           input_dim, activ, pad_type)
        self.mlp = MLP(style_dim, self.dec.num_adain_params, mlp_dim, 3, activ)

    def encode(self, images: torch.Tensor):
        return self.enc_content(images), self.enc_style(images)

    def decode(self, content: torch.Tensor,
               style: torch.Tensor) -> torch.Tensor:
        return self.dec(content, self.mlp(style))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.decode(*self.encode(images))


class VAEGen(nn.Module):
    """UNIT's VAE generator (networks.py:391-434), inference only
    (docs/PARITY.md #13): a content encoder and a decoder with IN res
    blocks, no style. Keys follow the reference ``enc.*``, ``dec.*``
    layout (``munit_tpu/io/torch_import.py::convert_vae_gen_state_dict``)."""

    def __init__(self, input_dim: int, dim: int, n_downsample: int,
                 n_res: int, activ: str = "relu", pad_type: str = "reflect"):
        super().__init__()
        self.enc = ContentEncoder(n_downsample, n_res, input_dim, dim, activ,
                                  pad_type)
        self.dec = Decoder(n_downsample, n_res, self.enc.output_dim,
                           input_dim, activ, pad_type, res_norm="in")

    def encode(self, images: torch.Tensor, generator: torch.Generator):
        """(hiddens, noise): the noise N(0, I) of the hiddens' shape, drawn
        from ``generator`` on its device."""
        hiddens = self.enc(images)
        noise = torch.randn(hiddens.shape, generator=generator,
                            device=generator.device, dtype=hiddens.dtype)
        return hiddens, noise.to(hiddens.device)

    def decode(self, hiddens: torch.Tensor) -> torch.Tensor:
        return self.dec(hiddens)


class AdaINGenPair(nn.Module):
    """The ``gen_state: 0`` generator: an ``AdaINGen`` per domain, ``a``
    (domain 1) and ``b`` (domain 2), with the dual generator's interface.
    Its ``state_dict`` keys are ``a.*`` and ``b.*``: the reference
    checkpoint's {"a": sd, "b": sd}, each with the ``.`` joined."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.a = AdaINGen(*args, **kwargs)
        self.b = AdaINGen(*args, **kwargs)

    def net(self, domain: int) -> AdaINGen:
        return self.a if domain == 1 else self.b

    def encode_style(self, images: torch.Tensor, domain: int) -> torch.Tensor:
        return self.net(domain).enc_style(images)

    def encode_content(self, images: torch.Tensor, domain: int) -> torch.Tensor:
        return self.net(domain).enc_content(images)

    def encode(self, images: torch.Tensor, domain: int):
        return self.net(domain).encode(images)

    def decode(self, content: torch.Tensor, style: torch.Tensor,
               domain: int) -> torch.Tensor:
        return self.net(domain).decode(content, style)


class AdaINGenDual(nn.Module):
    """The fork's default generator (gen_state=1; networks.py:262-388): one
    shared style encoder, per-domain content encoders, decoders and MLPs.
    ``domain`` is 1 or 2."""

    def __init__(self, input_dim: int, dim: int, style_dim: int,
                 n_downsample: int, n_res: int, mlp_dim: int,
                 activ: str = "relu", pad_type: str = "reflect"):
        super().__init__()
        self.enc_style = StyleEncoder(4, input_dim, dim, style_dim, activ,
                                      pad_type)
        self.enc1_content = ContentEncoder(n_downsample, n_res, input_dim, dim,
                                           activ, pad_type)
        self.enc2_content = ContentEncoder(n_downsample, n_res, input_dim, dim,
                                           activ, pad_type)
        content_dim = self.enc1_content.output_dim
        self.dec1 = Decoder(n_downsample, n_res, content_dim, input_dim, activ,
                            pad_type)
        self.dec2 = Decoder(n_downsample, n_res, content_dim, input_dim, activ,
                            pad_type)
        n_adain = self.dec1.num_adain_params
        self.mlp1 = MLP(style_dim, n_adain, mlp_dim, 3, activ)
        self.mlp2 = MLP(style_dim, n_adain, mlp_dim, 3, activ)

    def encode_style(self, images: torch.Tensor, domain=None) -> torch.Tensor:
        """The shared style encoder, whichever the domain."""
        return self.enc_style(images)

    def encode_content(self, images: torch.Tensor, domain: int) -> torch.Tensor:
        return (self.enc1_content if domain == 1 else self.enc2_content)(images)

    def encode(self, images: torch.Tensor, domain: int):
        return self.encode_content(images, domain), self.enc_style(images)

    def get_adain_params(self, style: torch.Tensor, domain: int):
        return (self.mlp1 if domain == 1 else self.mlp2)(style)

    def decode(self, content: torch.Tensor, style: torch.Tensor,
               domain: int) -> torch.Tensor:
        dec = self.dec1 if domain == 1 else self.dec2
        return dec(content, self.get_adain_params(style, domain))

    def forward(self, images: torch.Tensor, domain: int = 1) -> torch.Tensor:
        content, style = self.encode(images, domain)
        return self.decode(content, style, domain)


class GenBundle:
    """The generator of a config, on one device (``train/trainer.py::
    GenBundle`` of the JAX package): ``gen_state: 1``, the fork's dual
    generator (``AdaINGenDual``), or ``gen_state: 0``, upstream MUNIT's two
    auto-encoders (``AdaINGenPair``).

    ``encode(x, domain)`` returns (content, style) as the JAX package does;
    ``encode_content`` and ``encode_style`` run one half, as a jitted JAX
    caller gets when it drops the other. ``encode_style(x, domain)`` runs
    the domain's own style encoder with ``gen_state: 0`` and the shared one
    with ``gen_state: 1``, where ``domain`` may be left out. The JAX
    trainer's ``wide: 1`` calls (its default at 256 px with the dual
    generator: ``style_encode`` of both domains at once,
    ``content_encode_pair``, ``decode_domain``) are these methods on
    concatenated batches.

    Serving builds it frozen (no parameter takes a gradient, eval mode);
    ``trainable=True`` leaves the parameters to the trainer's gradients."""

    def __init__(self, conf: Dict, device="cuda", trainable: bool = False):
        if conf["gen_state"] not in (0, 1):
            raise ValueError(f"gen_state must be 0 or 1, got "
                             f"{conf['gen_state']!r}")
        g = conf["gen"]
        self.gen_state = conf["gen_state"]
        self.device = torch.device(device)
        self.init_name = conf.get("init", "kaiming")
        net = AdaINGenDual if self.gen_state == 1 else AdaINGenPair
        self.module = net(
            conf["input_dim_a"], g["dim"], g["style_dim"], g["n_downsample"],
            g["n_res"], g["mlp_dim"], g["activ"], g["pad_type"])
        self.module.requires_grad_(trainable).train(trainable)
        self.module.to(device=self.device, memory_format=torch.channels_last)

    def init(self, generator: torch.Generator) -> None:
        """Seeded reference init: kaiming weights, zero biases, U[0,1)
        LayerNorm gammas and zero betas."""
        kaiming = winit.by_name(self.init_name)
        for m in self.module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                kaiming(m.weight, generator)
                winit.zeros(m.bias)
            elif isinstance(m, LayerNormParams):
                winit.uniform01(m.gamma, generator)
                winit.zeros(m.beta)

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        self.module.load_state_dict(sd)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.module.state_dict()

    def encode_style(self, x: torch.Tensor, domain=None) -> torch.Tensor:
        if domain is None and self.gen_state == 0:
            raise ValueError("gen_state 0 has a style encoder per domain: "
                             "give the domain")
        return self.module.encode_style(x, domain)

    def encode_content(self, x: torch.Tensor, domain: int) -> torch.Tensor:
        return self.module.encode_content(x, domain)

    def encode(self, x: torch.Tensor, domain: int):
        return self.module.encode(x, domain)

    def decode(self, c: torch.Tensor, s: torch.Tensor,
               domain: int) -> torch.Tensor:
        return self.module.decode(c, s, domain)
