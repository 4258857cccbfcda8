"""Run-directory helpers: the port's copy of ``munit_tpu/utils/misc.py``
(prepare_sub_folder, get_model_list utils.py:887-908)."""

from __future__ import annotations

import os
import subprocess
from typing import Optional


def prepare_sub_folder(output_directory: str):
    image_directory = os.path.join(output_directory, "images")
    checkpoint_directory = os.path.join(output_directory, "checkpoints")
    os.makedirs(image_directory, exist_ok=True)
    os.makedirs(checkpoint_directory, exist_ok=True)
    return checkpoint_directory, image_directory


def get_git_revision_hash() -> Optional[str]:
    """The checkout's git hash for run provenance (utils.py:1438-1444);
    None outside a git checkout."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.abspath(__file__))).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def get_model_list(dirname: str, key: str) -> Optional[str]:
    """Lexicographically-last checkpoint file containing ``key``."""
    if not os.path.exists(dirname):
        return None
    models = [os.path.join(dirname, f) for f in os.listdir(dirname)
              if os.path.isfile(os.path.join(dirname, f)) and key in f]
    if not models:
        return None
    return sorted(models)[-1]
