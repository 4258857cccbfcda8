"""Weights into the port's reference-layout ``state_dict``s.

- ``from_jax_params``: the JAX package's dual-generator param pytree (numpy
  or JAX arrays) → ``state_dict``. The port's own copy of the logic of
  ``munit_tpu/io/torch_import.py::export_gen_state_dict``, without the
  AdaIN dummy buffers, which the port's modules do not hold.
- ``from_jax_dis``: an ``MsImageDis`` param tree → ``cnns.{s}.{i}`` keys
  (``export_dis_state_dict``'s layout).
- ``from_jax_classifier``: a ``DomainClassifier`` param tree and its
  ``batch_stats`` → the reference ``domainClassifier`` keys (the inverse of
  ``convert_domain_classifier_state_dict``).

- ``from_jax_resnet34_8s``: the frozen segmenter's ``{params,
  batch_stats}`` → the reference ``resnet34_8s.*`` keys (the inverse of
  ``convert_resnet34_8s_state_dict``).

Every transform is linear (transposes and renames), so the same functions
carry a JAX gradient tree into the port's names and layout.
- ``load_reference_checkpoint``: a reference ``gen_*.pt`` (``{"2": sd}``) or
  an ``.npz`` with ``sd::``-prefixed entries (``tests/fixtures/
  golden_gen.npz``) → ``state_dict``.
- ``load_segmenter_checkpoint``: the reference segmenter ``.pth`` (a bare
  ``resnet34_8s.*`` state dict) or an ``sd::`` ``.npz`` → ``state_dict``.

Transforms: conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in),
``ln_gamma``/``ln_beta`` → ``norm.gamma``/``norm.beta``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from munit_tpu_torch.nn.resnet import LAYERS_8S

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
    return _tensors(sd)


def from_jax_dis(tree) -> StateDict:
    """MsImageDis params (``cnn_{s}.layer_{i}``, ``cnn_{s}.out_conv``) →
    ``cnns.{s}.{i}.conv.*`` and the bare logit conv ``cnns.{s}.{n_layer}.*``.
    Scales and layers are read off the tree."""
    sd: dict = {}
    for s in range(len(tree)):
        cnn = tree[f"cnn_{s}"]
        n_layer = len(cnn) - 1
        for i in range(n_layer):
            _conv(cnn[f"layer_{i}"], f"cnns.{s}.{i}", sd)
        _conv(cnn["out_conv"], f"cnns.{s}.{n_layer}", sd, bare=True)
    return _tensors(sd)


def from_jax_classifier(params, stats=None) -> StateDict:
    """DomainClassifier params (and, if given, its ``batch_stats``) → the
    reference keys: ``BasicBlock{1,2}.{conv1,conv2}.weight``,
    ``.{bn1,bn2}.*``, ``.downsample.{0.weight,1.*}``, ``fc.*``."""
    sd: dict = {}

    def hwio(a):
        return np.transpose(np.asarray(a), (3, 2, 0, 1))

    for j in (1, 2):
        p = params[f"block{j}"]
        pre = f"BasicBlock{j}"
        sd[f"{pre}.conv1.weight"] = hwio(p["conv1"])
        sd[f"{pre}.conv2.weight"] = hwio(p["conv2"])
        sd[f"{pre}.downsample.0.weight"] = hwio(p["down_conv"])
        for name, key in (("bn1", "bn1"), ("bn2", "bn2"),
                          ("down_bn", "downsample.1")):
            sd[f"{pre}.{key}.weight"] = np.asarray(p[name]["scale"])
            sd[f"{pre}.{key}.bias"] = np.asarray(p[name]["bias"])
            if stats is not None:
                st = stats[f"block{j}"][name]
                sd[f"{pre}.{key}.running_mean"] = np.asarray(st["mean"])
                sd[f"{pre}.{key}.running_var"] = np.asarray(st["var"])
    sd["fc.weight"] = np.asarray(params["fc_kernel"]).T
    sd["fc.bias"] = np.asarray(params["fc_bias"])
    return _tensors(sd)


def from_jax_resnet34_8s(variables) -> StateDict:
    """ResNet34_8s ``{params, batch_stats}`` → ``resnet34_8s.*`` keys:
    conv kernels HWIO → OIHW, ``_FrozenBN`` scale/bias/mean/var →
    weight/bias/running_mean/running_var, scopes ``layer{i}_{j}`` →
    ``layer{i}.{j}``, ``down_conv``/``down_bn`` → ``downsample.{0,1}``."""
    params, stats = variables["params"], variables["batch_stats"]
    p = "resnet34_8s."
    sd: dict = {}

    def oihw(a):
        return np.transpose(np.asarray(a), (3, 2, 0, 1))

    def bn(key, prm, st):
        sd[f"{key}.weight"] = np.asarray(prm["scale"])
        sd[f"{key}.bias"] = np.asarray(prm["bias"])
        sd[f"{key}.running_mean"] = np.asarray(st["mean"])
        sd[f"{key}.running_var"] = np.asarray(st["var"])

    sd[p + "conv1.weight"] = oihw(params["conv1"])
    bn(p + "bn1", params["bn1"], stats["bn1"])
    for li, (_, blocks, _, _) in enumerate(LAYERS_8S):
        for bi in range(blocks):
            scope, key = f"layer{li + 1}_{bi}", f"{p}layer{li + 1}.{bi}"
            blk, bst = params[scope], stats[scope]
            sd[f"{key}.conv1.weight"] = oihw(blk["conv1"])
            sd[f"{key}.conv2.weight"] = oihw(blk["conv2"])
            bn(f"{key}.bn1", blk["bn1"], bst["bn1"])
            bn(f"{key}.bn2", blk["bn2"], bst["bn2"])
            if "down_conv" in blk:
                sd[f"{key}.downsample.0.weight"] = oihw(blk["down_conv"])
                bn(f"{key}.downsample.1", blk["down_bn"], bst["down_bn"])
    sd[p + "fc.weight"] = oihw(params["fc_kernel"])
    sd[p + "fc.bias"] = np.asarray(params["fc_bias"])
    return _tensors(sd)


def _tensors(sd: dict) -> StateDict:
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


def load_segmenter_checkpoint(path: str) -> StateDict:
    """The reference's Cityscapes ResNet34-8s ``.pth`` (a state dict of
    ``resnet34_8s.*`` keys, ``semantic_ckpt_path`` in the config) or an
    ``.npz`` of ``sd::`` entries → the port's segmenter state_dict (CPU
    tensors). BatchNorm2d's ``num_batches_tracked`` counters are dropped:
    the frozen net never updates its statistics."""
    if str(path).endswith(".npz"):
        with np.load(path) as blob:
            sd = {k[4:]: torch.from_numpy(blob[k]) for k in blob.files
                  if k.startswith("sd::")}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    if not sd or not all(k.startswith("resnet34_8s.") for k in sd):
        raise ValueError(f"{path}: expected a state dict of resnet34_8s.* "
                         "keys (the reference's Resnet34_8s)")
    return sd
