"""JSON (de)serialization helpers that tolerate numpy scalar/array types.

Capability parity with ref: dinounet/utilities/json_export.py:7.
"""

import json
import os
from typing import Any

import numpy as np


def recursive_fix_for_json_export(obj: Any) -> Any:
    """Convert numpy types / tuples into JSON-serializable python types."""
    if isinstance(obj, dict):
        return {_fix_key(k): recursive_fix_for_json_export(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [recursive_fix_for_json_export(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return recursive_fix_for_json_export(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def _fix_key(k):
    if isinstance(k, (np.integer,)):
        return int(k)
    if isinstance(k, (np.floating,)):
        return float(k)
    return k


def save_json(obj: Any, path: str, sort_keys: bool = True, indent: int = 4) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(recursive_fix_for_json_export(obj), f, sort_keys=sort_keys, indent=indent)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
