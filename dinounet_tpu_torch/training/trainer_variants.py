"""Trainer variants: no deep supervision, and the fixed-epoch family.

Counterpart of ``dinounet_tpu/training/trainer_variants.py`` (ref:
nnUNetTrainerNoDeepSupervision.py:6 and nnUNetTrainer_Xepochs.py).
"""

from dinounet_tpu_torch.training.trainer import nnUNetTrainer
from dinounet_tpu_torch.utilities import registry


@registry.trainers.register("nnUNetTrainerNoDeepSupervision")
class nnUNetTrainerNoDeepSupervision(nnUNetTrainer):
    def __init__(self, plans, configuration, fold, dataset_json,
                 unpack_dataset: bool = True, device=None):
        super().__init__(plans, configuration, fold, dataset_json, unpack_dataset, device)
        self.enable_deep_supervision = False


def _make_epochs_variant(n: int):
    class _Trainer(nnUNetTrainer):
        def __init__(self, plans, configuration, fold, dataset_json,
                     unpack_dataset: bool = True, device=None):
            super().__init__(plans, configuration, fold, dataset_json,
                             unpack_dataset, device)
            self.num_epochs = n

    _Trainer.__name__ = f"nnUNetTrainer_{n}epoch" + ("" if n == 1 else "s")
    _Trainer.__qualname__ = _Trainer.__name__
    registry.trainers.add(_Trainer.__name__, _Trainer)
    return _Trainer


nnUNetTrainer_1epoch = _make_epochs_variant(1)
nnUNetTrainer_5epochs = _make_epochs_variant(5)
nnUNetTrainer_10epochs = _make_epochs_variant(10)
nnUNetTrainer_20epochs = _make_epochs_variant(20)
nnUNetTrainer_50epochs = _make_epochs_variant(50)
nnUNetTrainer_100epochs = _make_epochs_variant(100)
nnUNetTrainer_250epochs = _make_epochs_variant(250)
nnUNetTrainer_500epochs = _make_epochs_variant(500)
nnUNetTrainer_2000epochs = _make_epochs_variant(2000)
nnUNetTrainer_4000epochs = _make_epochs_variant(4000)
nnUNetTrainer_8000epochs = _make_epochs_variant(8000)
