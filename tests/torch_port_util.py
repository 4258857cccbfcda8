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


@pytest.fixture(scope="module")
def one_blas_thread():
    """numpy's BLAS and LAPACK on one thread: more threads barely speed up a
    2048² ``scipy.linalg.sqrtm`` (each FID of fewer images than
    dimensions), and a full thread pool in each of the suite's workers
    oversubscribes the host's cores. Import this fixture into a module and
    request it."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1):
        yield


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


def _pair(convert, tree):
    return {f"{d}.{k}": v for d in ("a", "b")
            for k, v in convert(tree[d]).items()}


def port_state(state, iterations):
    """A JAX trainer's state (numpy) with the generator, the two
    discriminators and the two sim/real classifiers as a port
    ``state_dict()``, without ``styles``: the nets with their statistics
    and the three optimizers."""
    nets = {"gen": from_jax_params(state["gen"])}
    for d in ("a", "b"):
        nets[f"dis_{d}"] = from_jax_dis(state[f"dis_{d}"])
        nets[f"classifier_sr_{d}"] = from_jax_classifier(
            state[f"classifier_sr_{d}"], state[f"classifier_sr_{d}_stats"])
    convert = {"gen": from_jax_params,
               "dis": lambda t: _pair(from_jax_dis, t),
               "classif_sr": lambda t: _pair(from_jax_classifier, t)}
    opt = {}
    for name, fn in convert.items():
        o = state[f"{name}_opt"]
        opt[name] = {"count": int(o.count), "has_copy": bool(o.has_copy),
                     **{f: fn(getattr(o, f))
                        for f in ("mu", "nu", "params_copy")}}
    return {"iterations": iterations, "nets": nets, "opt": opt}


def net_groups(nets):
    """``port_state``'s (or a port ``state_dict()``'s) nets as numpy copies
    per net of ``update_errors``: gen, dis and classifier, the a and b
    halves of a pair under one name."""
    out = {"gen": nets["gen"],
           "dis": {f"{d}.{k}": v for d in ("a", "b")
                   for k, v in nets[f"dis_{d}"].items()},
           "classifier": {f"{d}.{k}": v for d in ("a", "b")
                          for k, v in nets[f"classifier_sr_{d}"].items()}}
    return {n: {k: v.detach().numpy().copy() for k, v in d.items()}
            for n, d in out.items()}


def jax_draws(state, kind, bsz, style_dim):
    """The float32 styles a JAX step draws from ``state["rng"]``, in its
    order (the fused step: the dis step's pair, then the gen step's), as
    torch tensors."""
    import jax
    rng = state["rng"]
    if kind == "dis_gen":
        mid, d1, d2 = jax.random.split(rng, 3)
        _, g1, g2 = jax.random.split(mid, 3)
        keys = (d1, d2, g1, g2)
    else:
        _, k1, k2 = jax.random.split(rng, 3)
        keys = (k1, k2)
    return [torch.from_numpy(np.array(jax.random.normal(k, (bsz, style_dim))))
            for k in keys]


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


def vgg_ref_weights(seed: int = 0) -> dict:
    """Kaiming-scaled conv weights and small biases of VGG16 to relu5_3 in
    the reference ``Vgg16``'s keys, float32 numpy."""
    from munit_tpu_torch.nn.vgg import Vgg16
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(Vgg16().state_dict().items()):
        shape = tuple(v.shape)
        scale = (np.sqrt(2.0 / np.prod(shape[1:])) if k.endswith("weight")
                 else 0.1)
        out[k] = (rng.randn(*shape) * scale).astype(np.float32)
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


def _frozen_net_weights(module, rng) -> dict:
    """Kaiming-scaled convs, an N(0, 0.01) fc, and batch norms near the
    identity (scales and running variances U[0.8, 1.2), shifts and running
    means N(0, 0.05)): activations stay of order 1 through a deep frozen
    net, and every statistic's place in the layout shows."""
    out = {}
    for k, v in sorted(module.state_dict().items()):
        shape = tuple(v.shape)
        if k.startswith("fc."):
            a = rng.randn(*shape) * 0.01
        elif len(shape) == 4:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith(("running_var", ".weight")):
            a = rng.uniform(0.8, 1.2, shape)
        else:                   # BN shifts and running means
            a = rng.randn(*shape) * 0.05
        out[k] = a.astype(np.float32)
    return out


def inception_ref_weights(seed: int = 0) -> dict:
    """Every parameter and buffer of InceptionV3 in torchvision's
    ``inception_v3`` layout, float32 numpy (``_frozen_net_weights``)."""
    from munit_tpu_torch.eval.inception import InceptionV3
    return _frozen_net_weights(InceptionV3(), np.random.RandomState(seed))


def resnet18_ref_weights(seed: int = 0) -> dict:
    """The flood classifier's torchvision ``resnet18`` layout (2-way fc),
    float32 numpy (``_frozen_net_weights``)."""
    from munit_tpu_torch.nn.resnet18 import FloodClassifier
    return _frozen_net_weights(FloodClassifier(), np.random.RandomState(seed))


def save_torch(sd: dict, path) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


# --------------------------------------------- updates held against JAX's

# An update is held to JAX's within 1e-2 lr. The packages' gradients
# differ by ~1e-3 relative where float32 rounding moves one ReLU input
# across the kink (the synthetic fused step: one in each package, against
# a float64 port), which Adam passes on: at 1e-3 lr, 9 % of the
# generator's weights are past it there, at 1e-2 lr at most 0.4 % of any
# net's (the weights whose gradient is rounding noise, moved by ±lr at
# random). A dropped or reversed update is past it in most weights.
UPDATE_RTOL = 1e-2       # of lr, per update
UPDATE_SHARE = 0.01      # weights allowed past it, per net
MOVED = 0.1              # median |update| of an updated net, in lr


def _past(b, v, g, k, lr):
    """Weights whose update (g - b) differs from JAX's (v - b) by more than
    k (UPDATE_RTOL lr + one float32 ulp of the weight)."""
    gap = np.abs((g - b) - (v - b))   # exact (Sterbenz)
    ulp = np.spacing(np.maximum(np.abs(b), np.abs(v)))
    return gap > k * (UPDATE_RTOL * lr + ulp), gap


def past_in_both(before, want, got, other, lr):
    """Per net, the fraction of its weights whose update parts from JAX's
    (as ``update_errors`` counts) in both ``got`` and ``other``: two runs
    of the port, at two precisions, from one state."""
    out = {}
    for net, w in want.items():
        both = [(_past(before[net][key], v, got[net][key], 1, lr)[0]
                 & _past(before[net][key], v, other[net][key], 1, lr)[0]
                 ).ravel() for key, v in w.items() if "running" not in key]
        out[net] = float(np.concatenate(both).mean())
    return out


def update_errors(before, want, got, lr, updates):
    """Per net, from its weights before, JAX's after and the port's after
    ({net: {name: numpy array}}) over ``updates[net]`` updates at ``lr``: ``share``,
    the fraction of its weights whose update differs from JAX's by more
    than UPDATE_RTOL lr per update plus one float32 ulp of the weight per
    update (rounding of the stored sum); ``worst``, the largest difference
    in lr per update; ``moved``, the median |update| of the port's weights
    in lr per update; ``still``, the largest |update| of either package;
    ``stats``, the running statistics' largest error over rtol 1e-4, atol
    1e-6."""
    out = {}
    for net, w in want.items():
        k = max(updates.get(net, 0), 1)
        past, moved, worst, still, stats = [], [], 0.0, 0.0, 0.0
        for key, v in w.items():
            if "running" in key:
                d = np.abs(got[net][key] - v)
                stats = max(stats, float(
                    (d / (1e-6 + 1e-4 * np.abs(v))).max()))
                continue
            b = before[net][key]
            d_jax, d_port = v - b, got[net][key] - b
            over, gap = _past(b, v, got[net][key], k, lr)
            past.append(over.ravel())
            moved.append(np.abs(d_port).ravel())
            worst = max(worst, float(gap.max()))
            still = max(still, float(np.abs(d_port).max()),
                        float(np.abs(d_jax).max()))
        moved = float(np.median(np.concatenate(moved)))
        out[net] = {"share": float(np.concatenate(past).mean()),
                    "worst": worst / (lr * k), "moved": moved / (lr * k),
                    "still": still, "stats": stats}
    return out


def check_update(e, updated, label):
    """One net's ``update_errors``: held to JAX's update if a step
    ``updated`` it, else not moved at all."""
    assert e["stats"] <= 1.0, (label, e)
    if updated:
        assert e["share"] <= UPDATE_SHARE, (label, e)
        assert e["worst"] <= 2.0, (label, e)
        assert e["moved"] >= MOVED, (label, e)
    else:
        assert e["still"] == 0.0, (label, e)
