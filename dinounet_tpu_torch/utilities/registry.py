"""Explicit name->object registries.

The reference resolves classes from strings scattered through plans.json via
``pydoc.locate`` and a filesystem walk (``recursive_find_python_class``,
ref: dinounet/utilities/find_class_by_name.py:7, get_network_from_plans.py:9).
We keep plans.json byte-compatible (the torch class-path strings stay in the
file as the public contract) but resolve them through explicit registries so
the mapping is auditable.
"""

from typing import Any, Callable, Dict


# Modules of this package that register built-ins on import: the
# preprocessor, the resampling functions, the image readers, the planners
# and the trainers.
_REGISTRATION_MODULES = (
    "dinounet_tpu_torch.preprocessing.preprocessor",
    "dinounet_tpu_torch.preprocessing.resampling",
    "dinounet_tpu_torch.imageio.reader_writer_registry",
    "dinounet_tpu_torch.planning.planner",
    "dinounet_tpu_torch.planning.resenc_planner",
    "dinounet_tpu_torch.training.trainer",
    "dinounet_tpu_torch.training.trainer_variants",
    "dinounet_tpu_torch.training.dinounet_trainer",
)


def _ensure_registered() -> None:
    """Import every module that registers built-ins (idempotent)."""
    import importlib

    for mod in _REGISTRATION_MODULES:
        importlib.import_module(mod)


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, *names: str) -> Callable:
        def deco(obj):
            for n in names:
                self._items[n] = obj
            return obj

        return deco

    def add(self, name: str, obj: Any) -> None:
        self._items[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._items:
            _ensure_registered()
        if name not in self._items:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Registered: {sorted(self._items)}"
            )
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def keys(self):
        return self._items.keys()


# plans.json 'architecture' op strings (torch class paths kept for byte-compat)
# -> semantic op names consumed by the model constructors.
OP_NAME_ALIASES = {
    # conv
    "torch.nn.modules.conv.Conv2d": "conv2d",
    "torch.nn.modules.conv.Conv3d": "conv3d",
    "torch.nn.Conv2d": "conv2d",
    "torch.nn.Conv3d": "conv3d",
    # norms
    "torch.nn.modules.instancenorm.InstanceNorm2d": "instancenorm",
    "torch.nn.modules.instancenorm.InstanceNorm3d": "instancenorm",
    "torch.nn.modules.batchnorm.BatchNorm2d": "batchnorm",
    "torch.nn.modules.batchnorm.BatchNorm3d": "batchnorm",
    "torch.nn.InstanceNorm2d": "instancenorm",
    "torch.nn.BatchNorm2d": "batchnorm",
    # nonlinearities
    "torch.nn.LeakyReLU": "leaky_relu",
    "torch.nn.modules.activation.LeakyReLU": "leaky_relu",
    "torch.nn.ReLU": "relu",
    "torch.nn.modules.activation.ReLU": "relu",
    "torch.nn.GELU": "gelu",
    # dropout
    "torch.nn.modules.dropout.Dropout2d": "dropout",
    "torch.nn.Dropout2d": "dropout",
}


def resolve_op_name(op) -> str:
    """Map a plans.json op string (or None) to a semantic op name."""
    if op is None:
        return "none"
    if op in OP_NAME_ALIASES:
        return OP_NAME_ALIASES[op]
    if op in set(OP_NAME_ALIASES.values()):
        return op
    raise KeyError(f"Unknown architecture op string: {op!r}")


trainers = Registry("trainer")
preprocessors = Registry("preprocessor")
planners = Registry("experiment planner")
image_readers = Registry("image reader/writer")
label_managers = Registry("label manager")
resampling_fns = Registry("resampling function")
