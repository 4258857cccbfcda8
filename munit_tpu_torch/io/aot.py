"""Ahead-of-time deployment artifacts through ``torch.export``: the port's
counterpart of ``munit_tpu/io/aot.py``.

The guided translation is traced once per device with the generator's
weights inside the program, saved, and served by a process that needs
neither the model code nor the config: loading imports torch and the
port's operator library (``munit_tpu_torch.kernels``, whose import
registers the norms' operators), never ``munit_tpu_torch.nn``, ``.config``,
``.cli`` or ``.train``.

Artifact format — one zip file (suffix ``.pt2.zip`` by convention):

  meta.json                   {"format": 1, "new_size", "style_dim",
                               "devices", "conv_dtype", "quant",
                               "quant_scales", "created_by":
                               "munit_tpu_torch"}
  <device>/encode_style.pt2   torch.export.save: style image (branch 2) →
                              style code
  <device>/translate.pt2      torch.export.save: content encode (branch 1)
                              and guided decode (branch 2), test.py:117-120

Both programs take a symbolic batch (``torch.export.Dim``), so one artifact
serves every batch; height and width are static, as in the JAX package.
Each device's programs are traced on that device (``devices``): a program
holds what its device's code path traces (the int8 product's padding on the
card), so a program runs only where it was traced, and loading on a device
the artifact has no program for raises. Each norm call is one node of the
``munit_tpu_torch`` operators, which dispatch to the kernel on the card and
to the plain version on the CPU.

Conv numerics: ``ops.set_conv_compute`` is read while tracing, so a
``bfloat16`` artifact holds its casts; ``torch.export`` records no TF32
flag, so ``Translator`` runs every call with TF32 off (``ops.exact_f32``),
the numerics of the port's inference CLIs and of the JAX package's
``Precision.HIGHEST``. ``quant_scales`` (a record pass's per-site maxima,
usually x1.1) puts static W8A8 convs into the translate program, each
site's scale a constant, in the record pass's site order.
"""

from __future__ import annotations

import copy
import io
import json
import os
import warnings
import zipfile
from collections import Counter
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import norms  # noqa: F401  registers the ops

FORMAT = 1
DEVICES = ("cpu", "cuda")
# the example batch of a trace: not 1, which torch.export would specialise
_EXAMPLE_BATCH = 2


class _EncodeStyle(nn.Module):
    """Branch 2's style code of a style image."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, style_img):
        return self.net.encode_style(style_img, 2)


class _Translate(nn.Module):
    """Branch 1's content, decoded with a style code by branch 2; with
    ``scales``, the convs that the int8 rule takes in static W8A8."""

    def __init__(self, net: nn.Module, scales: Optional[Sequence[float]]):
        super().__init__()
        self.net = net
        self.scales = None if scales is None else list(scales)

    def forward(self, x_a, s_b):
        with ops.conv_quant(self.scales is not None, scales=self.scales):
            return self.net.decode(self.net.encode_content(x_a, 1), s_b, 2)


def _check_device(device: str) -> None:
    if device not in DEVICES:
        raise ValueError(f"no programs for device {device!r}; "
                         f"choose from {DEVICES}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda program is traced on a card, and no CUDA "
                           "card is visible")


def _used_parameters(program) -> set:
    """Names of the parameters and buffers that a program's graph reads."""
    sig = program.graph_signature
    lifted = {**sig.inputs_to_parameters, **sig.inputs_to_buffers}
    return {lifted[n.name] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in lifted and n.users}


def _prune(module: nn.Module, used: set, prefix: str = "") -> nn.Module:
    """``module`` with each submodule none of whose parameters ``used``
    names replaced by an empty module, in place."""
    for name, child in list(module.named_children()):
        path = prefix + name
        names = {f"{path}.{k}" for k, _ in child.named_parameters()}
        if names and not names & used:
            setattr(module, name, nn.Module())
        else:
            _prune(child, used, path + ".")
    return module


def _export(wrapper: nn.Module, args, dynamic_shapes):
    """The program of ``wrapper``, traced twice: the second time with only
    the submodules the first trace read, so that the program carries only
    their weights (a branch reads a third of the dual generator's)."""
    first = torch.export.export(wrapper, args, dynamic_shapes=dynamic_shapes)
    pruned = _prune(copy.deepcopy(wrapper), _used_parameters(first))
    return torch.export.export(pruned, args, dynamic_shapes=dynamic_shapes)


def export_translator(module: nn.Module, image_size: int, style_dim: int,
                      device: str = "cuda",
                      quant_scales: Optional[Sequence[float]] = None):
    """Trace (encode_style, translate) on ``device`` with a symbolic batch.

    ``module`` is a generator (``GenBundle.module``: the dual generator or
    the two auto-encoders) on any device; a copy of it is moved to
    ``device``. Returns {"encode_style": ExportedProgram, "translate":
    ExportedProgram}."""
    _check_device(device)
    net = copy.deepcopy(module).to(device).requires_grad_(False).eval()
    batch = torch.export.Dim("batch", min=1)
    x = torch.zeros((_EXAMPLE_BATCH, image_size, image_size, 3),
                    device=device)
    s = torch.zeros((_EXAMPLE_BATCH, style_dim), device=device)
    with torch.no_grad():
        enc = _export(_EncodeStyle(net), (x,), ({0: batch},))
        tr = _export(_Translate(net, quant_scales), (x, s),
                     ({0: batch}, {0: batch}))
    return {"encode_style": enc, "translate": tr}


def graph_ops(program) -> Counter:
    """The count of each operator a program's graph calls, by name (e.g.
    ``munit_tpu_torch.instance_norm.default``, ``aten._int_mm.default``)."""
    return Counter(str(n.target) for n in program.graph.nodes
                   if n.op == "call_function")


def save_artifact(path: str, module: nn.Module, image_size: int,
                  style_dim: int, devices: Sequence[str] = ("cuda",),
                  conv_dtype: str = "float32",
                  quant_scales: Optional[Sequence[float]] = None) -> dict:
    """Trace the programs on each of ``devices`` and write the artifact zip
    to ``path``; returns {device: export_translator's programs}.

    ``conv_dtype`` is recorded metadata: the caller sets
    ``ops.set_conv_compute`` before the call, and the traces read it."""
    devices = list(dict.fromkeys(devices))
    for device in devices:
        _check_device(device)
    programs = {d: export_translator(module, image_size, style_dim, d,
                                     quant_scales) for d in devices}
    meta = {
        "format": FORMAT,
        "new_size": image_size,
        "style_dim": style_dim,
        "devices": devices,
        "conv_dtype": conv_dtype,
        "quant": "int8-static" if quant_scales is not None else "none",
        "quant_scales": None if quant_scales is None else list(quant_scales),
        "created_by": "munit_tpu_torch",
    }
    tmp = path + ".tmp"
    # the programs are zip archives already: stored, not deflated
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for device, progs in programs.items():
            for name, program in progs.items():
                buf = io.BytesIO()
                with warnings.catch_warnings():
                    # the channels-last conv weights are not contiguous, so
                    # the writer cannot tell that each covers its storage; it
                    # stores each with its strides, and loads it back whole
                    warnings.filterwarnings(
                        "ignore", message="No complete tensor found")
                    torch.export.save(program, buf)
                z.writestr(f"{device}/{name}.pt2", buf.getvalue())
    os.replace(tmp, path)
    return programs


def on_device(program, device):
    """``program`` with its weights and every device its graph names on
    ``device``: moving the loaded module (``.to``) moves only its weights,
    and a factory op would still create its tensor on the traced card."""
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(program, torch.device(device))


class Translator:
    """A loaded artifact on one device: guided translation without the
    model code.

    ``encode_style(img (b, S, S, 3) in [-1, 1]) -> style code``
    ``translate(x (b, S, S, 3), s) -> (b, S, S, 3) in [-1, 1]``

    Both take any batch. ``translate`` broadcasts a batch-1 style code to
    the content batch (one pre-encoded exemplar, many requests). Calls run
    in inference mode with TF32 off."""

    def __init__(self, meta: Dict, device, programs: Dict):
        self.meta = meta
        self.new_size = meta["new_size"]
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index not in (None, 0):
            # the programs load on the card they were traced on
            programs = {k: on_device(p, self.device)
                        for k, p in programs.items()}
        self._encode_style = programs["encode_style"].module()
        self._translate = programs["translate"].module()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def encode_style(self, style_img) -> torch.Tensor:
        with torch.inference_mode(), ops.exact_f32():
            return self._encode_style(self._tensor(style_img))

    def translate(self, x, s) -> torch.Tensor:
        x, s = self._tensor(x), self._tensor(s)
        if s.shape[0] == 1 and x.shape[0] != 1:
            s = s.expand(x.shape[0], *s.shape[1:]).contiguous()
        with torch.inference_mode(), ops.exact_f32():
            return self._translate(x, s)


def load_artifact(path: str, device="cuda") -> Translator:
    """The artifact's programs for ``device`` ("cuda" or "cpu"); raises on
    a format this build does not read and on a device the artifact has no
    program for."""
    device = torch.device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"unsupported artifact format {meta.get('format')}"
                             f" (this build reads format {FORMAT})")
        if device.type not in meta["devices"]:
            raise ValueError(f"{path} holds programs for "
                             f"{meta['devices']}, none for {device.type}: "
                             "export it for that device")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible for the artifact's "
                               "cuda programs")
        programs = {name: torch.export.load(io.BytesIO(
            z.read(f"{device.type}/{name}.pt2")))
            for name in ("encode_style", "translate")}
    return Translator(meta, device, programs)
