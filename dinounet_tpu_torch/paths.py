"""Dataset and results folders from the environment.

The reference's contract (ref: dinounet/paths.py:21-23), as the JAX package's
``paths.py`` keeps it: ``nnUNet_raw``, ``nnUNet_preprocessed`` and
``nnUNet_results`` name the three folders.
"""

import os


def _get(name: str) -> str:
    p = os.environ.get(name)
    if p is None:
        raise RuntimeError(f"{name} is not defined: set the {name} environment "
                           "variable to its folder")
    return p


def nnUNet_raw() -> str:
    return _get("nnUNet_raw")


def nnUNet_preprocessed() -> str:
    return _get("nnUNet_preprocessed")


def nnUNet_results() -> str:
    return _get("nnUNet_results")
