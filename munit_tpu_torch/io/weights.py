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
- ``to_jax_params``: the inverse of ``from_jax_params``.
- ``load_reference_checkpoint``: a reference ``gen_*.pt`` (``{"2": sd}``),
  an ``.npz`` with ``sd::``-prefixed entries (``tests/fixtures/
  golden_gen.npz``) or the JAX package's packed inference ``.npz``
  (``load_packed_params``) → ``state_dict``.
- ``load_segmenter_checkpoint``: the reference segmenter ``.pth`` (a bare
  ``resnet34_8s.*`` state dict) or an ``sd::`` ``.npz`` → ``state_dict``.

Transforms: conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in),
``ln_gamma``/``ln_beta`` → ``norm.gamma``/``norm.beta``.
"""

from __future__ import annotations

import json
import re
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


def _gen_layout(n_style: int, n_down: int, n_res: int, n_up: int,
                n_mlp: int) -> list:
    """(JAX tree path, port key prefix, conv) of every parameter group of
    the dual generator: a conv group keeps its kernel and bias under
    ``<prefix>.conv.*`` (and a LayerNorm's under ``<prefix>.norm.*``), a
    bare one under ``<prefix>.*``."""
    def res(net, prefix):
        return [((net, "res", f"block_{j}", f"conv_{c}"),
                 f"{prefix}.model.{j}.model.{c}", True)
                for j in range(n_res) for c in range(2)]

    out = [(("enc_style", f"layer_{i}"), f"enc_style.model.{i}", True)
           for i in range(n_style)]
    # enc_style.model.{n_style} is the paramless global average pool
    out.append((("enc_style", "out_conv"), f"enc_style.model.{n_style + 1}",
                False))
    for net in ("enc1_content", "enc2_content"):
        out += [((net, f"layer_{i}"), f"{net}.model.{i}", True)
                for i in range(n_down + 1)]
        out += res(net, f"{net}.model.{n_down + 1}")
    for net in ("dec1", "dec2"):
        out += res(net, f"{net}.model.0")
        # dec.model.{2i + 1} is the paramless upsample
        out += [((net, f"up_{i}"), f"{net}.model.{2 * i + 2}", True)
                for i in range(n_up)]
        out.append(((net, "out_conv"), f"{net}.model.{2 * n_up + 1}", True))
    for net in ("mlp1", "mlp2"):
        out += [((net, f"fc_{i}"), f"{net}.model.{i}.fc", False)
                for i in range(n_mlp)]
    return out


_LEAVES = {"kernel": "weight", "bias": "bias", "ln_gamma": "gamma",
           "ln_beta": "beta"}


def _port_key(prefix: str, conv: bool, leaf: str) -> str:
    if leaf.startswith("ln_"):
        return f"{prefix}.norm.{_LEAVES[leaf]}"
    return f"{prefix}{'.conv' if conv else ''}.{_LEAVES[leaf]}"


def _to_port(a) -> np.ndarray:
    """JAX kernel layout → torch: HWIO → OIHW, (in, out) → (out, in)."""
    a = np.asarray(a)
    return np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T


def _to_jax(a) -> np.ndarray:
    a = np.asarray(a)
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T


def from_jax_params(tree) -> StateDict:
    """Dual-generator (gen_state 1) JAX params → the port's state_dict.
    Depths (downsamplings, res blocks, MLP blocks) are read off the tree."""
    layout = _gen_layout(len(tree["enc_style"]) - 1,
                         len(tree["enc1_content"]) - 2,
                         len(tree["enc1_content"]["res"]),
                         len(tree["dec1"]) - 2, len(tree["mlp1"]))
    sd: dict = {}
    for path, prefix, conv in layout:
        node = tree
        for part in path:
            node = node[part]
        for leaf, v in node.items():
            sd[_port_key(prefix, conv, leaf)] = (
                _to_port(v) if leaf == "kernel" else np.asarray(v))
    return _tensors(sd)


def to_jax_params(sd) -> dict:
    """The port's dual-generator state_dict → the JAX package's param tree
    (nested dicts of float32 numpy arrays): the inverse of
    ``from_jax_params``. Depths are read off the keys."""
    def count(pattern):
        return sum(1 for k in sd if re.fullmatch(pattern, k))

    n_down = count(r"enc1_content\.model\.\d+\.conv\.weight") - 1
    layout = _gen_layout(
        count(r"enc_style\.model\.\d+\.conv\.weight"), n_down,
        count(rf"enc1_content\.model\.{n_down + 1}\.model\.\d+\.model\.0"
              r"\.conv\.weight"),
        count(r"dec1\.model\.\d+\.norm\.gamma"),
        count(r"mlp1\.model\.\d+\.fc\.weight"))
    tree: dict = {}
    for path, prefix, conv in layout:
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        for leaf in _LEAVES:
            key = _port_key(prefix, conv, leaf)
            if key in sd:
                v = np.asarray(torch.as_tensor(sd[key]).detach().cpu().float())
                node[leaf] = np.ascontiguousarray(
                    _to_jax(v) if leaf == "kernel" else v)
    return tree


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


# The JAX package's packed inference file (``munit_tpu/io/checkpoint.py::
# save_inference_params``): a ``__manifest__`` entry (the uint8 bytes of a
# JSON object {"magic", "keys"}) maps each "/"-joined param path to its array
# ``a<i>`` and the type it was stored in: "bfloat16" as the uint16 bits,
# "int8" with a float32 scale per last-axis channel, else as it is.
PACKED_MAGIC = "munit_tpu-inference-v1"


def load_packed_params(path: str) -> dict:
    """A packed inference ``.npz`` → the JAX param tree, dequantized to
    float32 numpy arrays (``load_inference_params`` of the JAX package)."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        if manifest.get("magic") != PACKED_MAGIC:
            raise ValueError(f"{path}: manifest magic "
                             f"{manifest.get('magic')!r}, expected "
                             f"{PACKED_MAGIC!r}")
        tree: dict = {}
        for key, ent in manifest["keys"].items():
            v = z[ent["name"]]
            if ent["dtype"] == "bfloat16":
                v = (v.astype(np.uint32) << 16).view(np.float32)
            elif ent["dtype"] == "int8":
                v = v.astype(np.float32) * z[ent["scale"]]
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(v, np.float32)
    return tree


def _load_npz(path: str) -> StateDict:
    """An ``.npz`` of ``sd::`` entries or a packed inference file →
    state_dict; anything else raises, naming both formats."""
    with np.load(path) as blob:
        files = blob.files
        sd = {k[4:]: torch.from_numpy(blob[k]) for k in files
              if k.startswith("sd::")}
    if sd:
        return sd
    if "__manifest__" in files:
        return from_jax_params(load_packed_params(path))
    raise ValueError(
        f"{path}: neither an .npz of 'sd::' state_dict entries nor a packed "
        f"inference file (a '__manifest__' with magic {PACKED_MAGIC!r}, "
        "from munit_tpu's save_inference_params)")


def load_reference_checkpoint(path: str) -> StateDict:
    """A reference ``gen_*.pt`` ({"2": sd}), an ``.npz`` of ``sd::``
    entries or the JAX package's packed inference ``.npz`` (bf16 or int8
    weights, dequantized to float32) → the port's state_dict (CPU
    tensors)."""
    if str(path).endswith(".npz"):
        sd = _load_npz(path)
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
