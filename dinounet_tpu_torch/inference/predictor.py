"""nnUNetPredictor for the serving slice: array prediction with fold
ensembling and mirror TTA on one device.

Counterpart of ``dinounet_tpu/inference/predictor.py``: ``manual_initialization``
(network, plans, one state_dict per fold), ``predict_sliding_window_return_logits``
and ``predict_logits_from_preprocessed_data`` (fold-averaged fp16 logits, the
reference's output contract). Each fold's weights are loaded into the one
network in turn, as the reference's predictor does. Loading a trained model
folder, the file iterators, preprocessing, export and the 3-D predictor are
not ported yet.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dinounet_tpu_torch.inference.sliding_window import (
    TilePredictor2d, check_accum_budget, finalize_sliding_window_logits,
    predict_sliding_window_return_logits, prepare_sliding_window_volume)
from dinounet_tpu_torch.utilities.plans_handler import (ConfigurationManager,
                                                        PlansManager)


class nnUNetPredictor:
    def __init__(self, tile_step_size: float = 0.5, use_gaussian: bool = True,
                 use_mirroring: bool = True, device="cuda",
                 tile_batch: int = 8):
        self.tile_step_size = tile_step_size
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.device = torch.device(device)
        self.tile_batch = tile_batch

        self.plans_manager: Optional[PlansManager] = None
        self.configuration_manager: Optional[ConfigurationManager] = None
        self.dataset_json: Optional[dict] = None
        self.trainer_name: Optional[str] = None
        self.network: Optional[nn.Module] = None
        self.list_of_parameters: List[dict] = []  # one state_dict per fold
        self.allowed_mirroring_axes: Optional[Tuple[int, ...]] = None
        self.label_manager = None

    def manual_initialization(self, network: nn.Module, plans_manager: PlansManager,
                              configuration_manager: ConfigurationManager,
                              parameters: Optional[List[dict]], dataset_json: dict,
                              trainer_name: str,
                              inference_allowed_mirroring_axes: Optional[Tuple[int, ...]]):
        """`parameters`: one state_dict per fold (None: the network's own)."""
        self.plans_manager = plans_manager
        self.configuration_manager = configuration_manager
        self.network = network.to(self.device).eval()
        self.list_of_parameters = (parameters if parameters is not None
                                   else [network.state_dict()])
        self.dataset_json = dataset_json
        self.trainer_name = trainer_name
        self.allowed_mirroring_axes = inference_allowed_mirroring_axes
        self.label_manager = plans_manager.get_label_manager(dataset_json)

    @property
    def _mirror_axes(self) -> Optional[Sequence[int]]:
        return self.allowed_mirroring_axes if self.use_mirroring else None

    def _load(self, params: dict) -> None:
        self.network.load_state_dict(params)

    def predict_sliding_window_return_logits(self, data: np.ndarray,
                                             parameters: Optional[dict] = None
                                             ) -> np.ndarray:
        """fp32 logits (K, Z, Y, X) of one fold (default: the first)."""
        self._load(parameters if parameters is not None else self.list_of_parameters[0])
        return predict_sliding_window_return_logits(
            self.network, np.asarray(data), tuple(self.configuration_manager.patch_size),
            self.label_manager.num_segmentation_heads,
            tile_step_size=self.tile_step_size, mirror_axes=self._mirror_axes,
            tile_batch=self.tile_batch, use_gaussian=self.use_gaussian,
            device=self.device)

    def predict_logits_from_preprocessed_data(self, data: np.ndarray) -> np.ndarray:
        """Fold-averaged logits (K, Z, Y, X) in fp16. The volume is uploaded
        once, the folds' logits are summed in one fp32 accumulator on the
        device, and one fp16 copy comes back to the host."""
        patch_size = tuple(self.configuration_manager.patch_size)
        num_classes = self.label_manager.num_segmentation_heads
        volume, offsets, revert = prepare_sliding_window_volume(
            np.asarray(data), patch_size, self.tile_step_size, self.device)
        check_accum_budget((volume.shape[0],) + tuple(volume.shape[2:]), num_classes)
        predictor = TilePredictor2d(self.network, patch_size, num_classes,
                                    self.tile_batch, self._mirror_axes,
                                    self.use_gaussian)
        accum_sum = weights = None
        for params in self.list_of_parameters:
            self._load(params)
            accum, weights = predictor.predict(volume, offsets, weights)
            accum_sum = accum if accum_sum is None else accum_sum + accum
        n = len(self.list_of_parameters)
        return finalize_sliding_window_logits(accum_sum, weights * n, revert,
                                              out_dtype=torch.float16)
