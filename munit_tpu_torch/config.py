"""YAML config loading for the PyTorch port.

The port's own copy of the parts of ``munit_tpu/config.py`` that inference
needs: the YAML load, the defaults of the generator keys, and their checks.
Unknown keys are preserved, as the reference passes sub-dicts wholesale into
model constructors (reference utils.py:743-758).
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import yaml

# Values are configs/config_256.yaml's where that file defines them.
_DEFAULTS: Dict[str, Any] = {
    "init": "kaiming",
    "gen_state": 0,
    "guided": 0,
    "input_dim_a": 3,
    "input_dim_b": 3,
    "new_size": 256,
    "gen": {
        "dim": 64,
        "mlp_dim": 256,
        "style_dim": 16,
        "activ": "relu",
        "n_downsample": 2,
        "n_res": 4,
        "pad_type": "reflect",
    },
}

_REQUIRED_TYPES = {"gen_state": int, "guided": int, "new_size": int,
                   "input_dim_a": int}


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
    return conf


def get_config(path: str) -> Dict[str, Any]:
    """Load and validate a YAML config (reference get_config)."""
    with open(path) as f:
        conf = yaml.safe_load(f)
    return validate(conf or {})
