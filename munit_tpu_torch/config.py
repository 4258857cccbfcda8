"""YAML config loading for the PyTorch port.

The port's own copy of the parts of ``munit_tpu/config.py`` that inference,
the training steps and the training loop need: the YAML load, the defaults
of the generator, discriminator, optimizer, loss-weight, adaptation, loop
and data keys, and their checks.
Unknown keys are preserved, as the reference passes sub-dicts wholesale into
model constructors (reference utils.py:743-758).
"""

from __future__ import annotations

import copy
import warnings
from typing import Any, Dict

import yaml

# Values are configs/config_256.yaml's where that file defines them.
_DEFAULTS: Dict[str, Any] = {
    "image_save_iter": 1000,
    "image_display_iter": 500,
    "display_size": 8,
    "snapshot_save_iter": 5000,
    "log_iter": 1,
    "max_iter": 1000000,
    "batch_size": 1,
    # K > 1: each step's gradients are the mean over K sequential
    # micro-batches of batch_size / K (munit_tpu/config.py:30-42)
    "grad_accum": 1,
    # with grad_accum > 1: 1 = one forward a micro-batch serves both of the
    # fused step's gradients, its adversarial terms against the D before
    # the update; 0 = the exact two-phase step
    "accum_shared_fwd": 0,
    # with grad_accum > 1: 1 = chunk the discriminator's gradients too
    # (exact either way)
    "accum_chunk_dis": 0,
    "weight_decay": 0.0001,
    "beta1": 0.5,
    "beta2": 0.999,
    "init": "kaiming",
    "lr": 0.0001,
    "lr_policy": "step",
    "step_size": 100000,
    "gamma": 0.5,
    "gan_w": 3,
    "recon_x_w": 12,
    "recon_s_w": 1,
    "recon_c_w": 2,
    "recon_x_cyc_w": 12,
    "vgg_w": 0,
    "semantic_w": 0,
    "recon_mask": 0,
    "domain_adv_w": 0,
    "synthetic_frequency": -1,
    "recon_synth_w": 0,
    "synthetic_seg_gt": 0,
    "classifier_frequency": 100000,
    "optimizer": "adam",          # utils.py:755-757 default injection
    "gen_state": 0,
    "guided": 0,
    "ratio_disc_gen": 1,
    "batch_size_fid": 1,
    "eval_fid": 0,
    "inception_moment_path": None,
    "inception_ckpt_path": None,  # InceptionV3 weights (any of its formats)
    "semantic_ckpt_path": None,   # the frozen segmenter's .pth
    "input_dim_a": 3,
    "input_dim_b": 3,
    "num_workers": 8,
    "new_size": 256,
    "crop_image_height": 256,
    "crop_image_width": 256,
    "adaptation": {
        "full_adaptation": 0,
        "output_classifier_lambda": 0,
        "output_adv_lambda": 0,
        "output_classif_freq": 1,
        "adv_lambda": 0,
        "dfeat_lambda": 0,
        "classif_frequency": 15,
        "sem_seg_lambda": 0,
    },
    "gen": {
        "dim": 64,
        "mlp_dim": 256,
        "style_dim": 16,
        "activ": "relu",
        "n_downsample": 2,
        "n_res": 4,
        "pad_type": "reflect",
    },
    "dis": {
        "dim": 64,
        "norm": "none",
        "activ": "lrelu",
        "n_layer": 4,
        "gan_type": "lsgan",
        "num_scales": 3,
        "pad_type": "reflect",
    },
}

_REQUIRED_TYPES = {"gen_state": int, "guided": int, "new_size": int,
                   "input_dim_a": int, "batch_size": int, "lr": (int, float),
                   "max_iter": int,
                   "ratio_disc_gen": int, "crop_image_height": int,
                   "crop_image_width": int}


def _merge(defaults: Dict[str, Any], user: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(defaults)
    for k, v in user.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def validate(conf: Dict[str, Any]) -> Dict[str, Any]:
    conf = _merge(_DEFAULTS, conf)
    for key, typ in _REQUIRED_TYPES.items():
        if not isinstance(conf[key], typ):
            raise TypeError(f"config key '{key}' must be {typ}, got "
                            f"{type(conf[key]).__name__}: {conf[key]!r}")
    if conf["gen_state"] not in (0, 1):
        raise ValueError(f"gen_state must be 0 or 1, got {conf['gen_state']}")
    if conf["guided"] not in (0, 1):
        raise ValueError(f"guided must be 0 or 1, got {conf['guided']}")
    if conf["dis"]["gan_type"] not in ("lsgan", "nsgan"):
        raise ValueError(f"Unsupported GAN type: {conf['dis']['gan_type']}")
    if conf["lr_policy"] not in ("constant", "step"):
        raise NotImplementedError(
            f"learning rate policy [{conf['lr_policy']}] is not implemented")
    ga = conf["grad_accum"]
    if not isinstance(ga, int) or ga < 1:
        raise ValueError(f"grad_accum must be a positive int, got {ga!r}")
    if conf["batch_size"] % ga:
        raise ValueError(
            f"batch_size ({conf['batch_size']}) must be divisible by "
            f"grad_accum ({ga})")
    if dis_pyramid_floor(conf) < 1:
        # a warning here (translation never builds the discriminator); the
        # trainer raises
        warnings.warn(pyramid_message(conf), stacklevel=2)
    return conf


def dis_pyramid_floor(conf: Dict[str, Any]) -> int:
    """Output size of the discriminator's smallest scale: the crop after
    num_scales - 1 AvgPool2d(3, 2, 1) and n_layer Conv2d(4, 2, 1). Below 1
    its logit map is empty and every GAN loss is the NaN mean of nothing."""
    s = min(conf["crop_image_height"], conf["crop_image_width"])
    for _ in range(conf["dis"]["num_scales"] - 1):
        s = (s - 1) // 2 + 1
    for _ in range(conf["dis"]["n_layer"]):
        s = (s - 2) // 2 + 1
    return s


def pyramid_message(conf: Dict[str, Any]) -> str:
    return (f"dis pyramid collapses to a zero-size logit map: crop "
            f"{conf['crop_image_height']}x{conf['crop_image_width']} with "
            f"num_scales={conf['dis']['num_scales']}, "
            f"n_layer={conf['dis']['n_layer']} leaves the smallest scale "
            f"with no output pixels (GAN losses would be NaN). Use a larger "
            f"crop or fewer scales/layers.")


def get_config(path: str) -> Dict[str, Any]:
    """Load and validate a YAML config (reference get_config)."""
    with open(path) as f:
        conf = yaml.safe_load(f)
    return validate(conf or {})


def flatten_opts(conf: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested config for the logged parameters
    (utils.py:1395-1435)."""
    out = {}
    for k, v in conf.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_opts(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out
