"""ImageNet-1k class names for the sampling CLIs' printouts, port of
``mapdit_tpu/utils/class_names.py``: the 1000-entry table ships as package
data (``imagenet_classes.json``); an index without a name prints as
``class <index>``."""

from __future__ import annotations

import functools
import json
import os
from typing import Dict

_JSON_PATH = os.path.join(os.path.dirname(__file__), "imagenet_classes.json")


@functools.lru_cache(maxsize=1)
def _mapping() -> Dict[int, str]:
    with open(_JSON_PATH) as f:
        return {int(k): v for k, v in json.load(f).items()}


def class_name(idx: int) -> str:
    return _mapping().get(idx, f"class {idx}")
