"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed in the reference ``state_dict``
layout, so the JAX package (through ``convert_gen_state_dict``) and the port
run the same numbers: torch and jax.random give different draws per seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from munit_tpu_torch.io.weights import (from_jax_classifier, from_jax_dis,
                                        from_jax_params)
from munit_tpu_torch.nn.generator import AdaINGenDual

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU tensors run fastest on one torch thread, and far slower on
    many beside JAX's own thread pool in the same process (a 32 px train
    step: 1 s on one thread, 26 s on eight). Import this fixture into a test
    module to run that module's torch ops on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL_GEN = dict(dim=16, mlp_dim=32, style_dim=8, activ="relu",
                 n_downsample=2, n_res=2, pad_type="reflect")
# tests/torch_mirror.py::small_dis_params
SMALL_DIS = dict(dim=16, norm="none", activ="lrelu", n_layer=3,
                 gan_type="lsgan", num_scales=2, pad_type="reflect")
CROP = 32


def small_train_spec(**over) -> dict:
    """A config_256-shaped training spec at small width and 32 px: masked
    cycle loss, the sim/real classifier fool term at adv_lambda 6 and its
    own step (dfeat_lambda 1), no semantic loss. Both packages validate
    it."""
    spec = {
        "gen_state": 1, "guided": 1, "recon_mask": 1, "semantic_w": 0,
        "batch_size": 2, "display_size": 2, "optimizer": "adam",
        "crop_image_height": CROP, "crop_image_width": CROP,
        "new_size": CROP, "gen": dict(SMALL_GEN), "dis": dict(SMALL_DIS),
        "ratio_disc_gen": 2,
        "adaptation": {"adv_lambda": 6, "dfeat_lambda": 1,
                       "classif_frequency": 2},
    }
    spec.update(over)
    return spec


def train_batch(seed: int = 0, b: int = 2):
    """(x_a, x_b, mask_a, mask_b) as float32 numpy, NHWC."""
    rng = np.random.RandomState(seed)
    x_a, x_b = (rng.uniform(-1, 1, (b, CROP, CROP, 3)).astype(np.float32)
                for _ in range(2))
    m_a, m_b = ((rng.rand(b, CROP, CROP, 1) > 0.7).astype(np.float32)
                for _ in range(2))
    return x_a, x_b, m_a, m_b


def load_jax_state(trainer, state) -> None:
    """Copy a JAX ``MUNITTrainer.state``'s nets into a port trainer."""
    trainer.gen.load_state_dict(from_jax_params(state["gen"]))
    trainer.dis_a.load_state_dict(from_jax_dis(state["dis_a"]))
    trainer.dis_b.load_state_dict(from_jax_dis(state["dis_b"]))
    for d in ("a", "b"):
        getattr(trainer, f"classifier_sr_{d}").load_state_dict(
            from_jax_classifier(state[f"classifier_sr_{d}"],
                                state[f"classifier_sr_{d}_stats"]))


def jax_net_params(state) -> dict:
    """The JAX state's trainable nets in the port trainer's names:
    {"gen": ..., "dis": ..., "classifier": ...} of numpy arrays."""
    out = {"gen": from_jax_params(state["gen"]),
           "dis": {f"{d}.{k}": v for d in ("a", "b")
                   for k, v in from_jax_dis(state[f"dis_{d}"]).items()},
           "classifier": {f"{d}.{k}": v for d in ("a", "b")
                          for k, v in from_jax_classifier(
                              state[f"classifier_sr_{d}"],
                              state[f"classifier_sr_{d}_stats"]).items()}}
    return {n: {k: v.numpy() for k, v in d.items()} for n, d in out.items()}


def jax_steps(jtr, batch, iters: int) -> list:
    """bench.py's one_iter on a JAX ``MUNITTrainer`` for ``iters``
    iterations over (x_a, x_b, mask_a, mask_b); metrics as floats."""
    x_a, x_b, m_a, m_b = batch
    conf, ad = jtr.conf, jtr.conf["adaptation"]
    out = []
    for it in range(iters):
        jtr.iterations = it
        if (it + 1) % conf["ratio_disc_gen"] == 0:
            m = jtr.dis_gen_update(x_a, x_b, m_a, m_b)
        else:
            m = jtr.dis_update(x_a, x_b)
        if (it + 1) % ad["classif_frequency"] == 0:
            m = dict(m, **jtr.domain_classifier_sr_update(
                x_a, x_b, domain_synth=False, lamb=ad["dfeat_lambda"]))
        out.append({k: float(v) for k, v in m.items()})
    return out


def port_module(gen: dict, input_dim: int = 3) -> AdaINGenDual:
    return AdaINGenDual(input_dim, gen["dim"], gen["style_dim"],
                        gen["n_downsample"], gen["n_res"], gen["mlp_dim"],
                        gen["activ"], gen["pad_type"])


def ref_layout_weights(gen: dict, seed: int = 0) -> dict:
    """Kaiming-scaled weights, small random biases, U[0,1) LayerNorm gammas:
    every parameter of the dual generator, as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(port_module(gen).state_dict().items()):
        shape = tuple(v.shape)
        if k.endswith("norm.gamma"):
            a = rng.rand(*shape)
        elif k.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        else:  # conv / linear biases, LayerNorm betas
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def seg_ref_weights(seed: int = 0) -> dict:
    """Every parameter and buffer of the frozen ResNet34-8s in the
    reference ``resnet34_8s.*`` layout, as float32 numpy arrays: convs
    N(0, 1/fan_in), the logit conv N(0, 0.01) (the JAX init's), BN scales
    U[0.5, 1.5), shifts and running means N(0, 0.1), running variances
    U[0.5, 1.5) (tests/test_resnet_seg.py's statistics). The logits stay
    of order 1-10, so near-ties between classes are rare."""
    from munit_tpu_torch.nn.resnet import ResNet34_8s
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(ResNet34_8s().state_dict().items()):
        shape = tuple(v.shape)
        if k.endswith("fc.weight"):
            a = rng.randn(*shape) * 0.01
        elif len(shape) == 4:
            a = rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[1:]))
        elif k.endswith(("running_var", "bn1.weight", "bn2.weight",
                         "downsample.1.weight")):
            a = rng.uniform(0.5, 1.5, shape)
        else:                   # BN shifts and running means, the fc bias
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out
