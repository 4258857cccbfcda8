"""Generator weights into the port's reference-layout ``state_dict``.

- ``from_jax_params``: the JAX package's dual-generator param pytree (numpy
  or JAX arrays) → ``state_dict``. The port's own copy of the logic of
  ``munit_tpu/io/torch_import.py::export_gen_state_dict``, without the
  AdaIN dummy buffers, which the port's modules do not hold.
- ``load_reference_checkpoint``: a reference ``gen_*.pt`` (``{"2": sd}``) or
  an ``.npz`` with ``sd::``-prefixed entries (``tests/fixtures/
  golden_gen.npz``) → ``state_dict``.

Transforms: conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in),
``ln_gamma``/``ln_beta`` → ``norm.gamma``/``norm.beta``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _conv(p: dict, key: str, sd: dict, bare: bool = False) -> None:
    mid = "" if bare else ".conv"
    sd[f"{key}{mid}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    sd[f"{key}{mid}.bias"] = np.asarray(p["bias"])
    if "ln_gamma" in p:
        sd[f"{key}.norm.gamma"] = np.asarray(p["ln_gamma"])
        sd[f"{key}.norm.beta"] = np.asarray(p["ln_beta"])


def _res(p: dict, prefix: str, sd: dict) -> None:
    for j in range(len(p)):
        for c in range(2):
            _conv(p[f"block_{j}"][f"conv_{c}"],
                  f"{prefix}.model.{j}.model.{c}", sd)


def from_jax_params(tree) -> StateDict:
    """Dual-generator (gen_state 1) JAX params → the port's state_dict.
    Depths (downsamplings, res blocks, MLP blocks) are read off the tree."""
    sd: dict = {}
    style = tree["enc_style"]
    n_conv = len(style) - 1                       # layer_* and out_conv
    for i in range(n_conv):
        _conv(style[f"layer_{i}"], f"enc_style.model.{i}", sd)
    # model.{n_conv} is the paramless global average pool
    _conv(style["out_conv"], f"enc_style.model.{n_conv + 1}", sd, bare=True)
    for name in ("enc1_content", "enc2_content"):
        p = tree[name]
        nd = len(p) - 2                           # layer_0..layer_nd, res
        for i in range(nd + 1):
            _conv(p[f"layer_{i}"], f"{name}.model.{i}", sd)
        _res(p["res"], f"{name}.model.{nd + 1}", sd)
    for name in ("dec1", "dec2"):
        p = tree[name]
        nu = len(p) - 2                           # res, up_*, out_conv
        _res(p["res"], f"{name}.model.0", sd)
        for i in range(nu):                       # model.{2i+1}: upsample
            _conv(p[f"up_{i}"], f"{name}.model.{2 * i + 2}", sd)
        _conv(p["out_conv"], f"{name}.model.{2 * nu + 1}", sd)
    for name in ("mlp1", "mlp2"):
        p = tree[name]
        for i in range(len(p)):
            sd[f"{name}.model.{i}.fc.weight"] = np.asarray(p[f"fc_{i}"]["kernel"]).T
            sd[f"{name}.model.{i}.fc.bias"] = np.asarray(p[f"fc_{i}"]["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def drop_adain_buffers(sd: dict) -> dict:
    """Drop the reference's dummy norm running-stat buffers (AdaIN layers,
    and InstanceNorm layers of old checkpoints): nothing reads them."""
    return {k: v for k, v in sd.items()
            if not k.endswith(("norm.running_mean", "norm.running_var"))}


def load_reference_checkpoint(path: str) -> StateDict:
    """A reference ``gen_*.pt`` ({"2": sd}) or an ``.npz`` of ``sd::``
    entries → the port's state_dict (CPU tensors)."""
    if str(path).endswith(".npz"):
        with np.load(path) as blob:
            sd = {k[4:]: torch.from_numpy(blob[k]) for k in blob.files
                  if k.startswith("sd::")}
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if "2" not in blob:
            raise ValueError(f"{path}: expected a dual-generator checkpoint "
                             "{'2': state_dict} (gen_state: 1)")
        sd = blob["2"]
    return drop_adain_buffers(sd)
