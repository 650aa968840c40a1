"""ResEncUNetPlanner: experiment planner for the residual-encoder U-Net.

Capability parity with ref:
dinounet/experiment_planning/experiment_planners/resencUNet_planner.py:14-51:
same planning pipeline as ExperimentPlanner with the ResidualEncoderUNet
architecture, its own VRAM reference points, deeper encoder block counts, and
a data identifier that reuses the default plans' preprocessed data for the
2d/3d_fullres configurations; the port's ``nnUNetTrainer`` trains the
``ResidualEncoderUNet`` these plans name (``models/residual_unet.py``).

JAX-free copy of ``dinounet_tpu/planning/resenc_planner.py``, with the
reference's presets by memory target (nnU-Net's residual encoder presets):
``nnUNetPlannerResEncM`` (8 GB, ``nnUNetResEncUNetMPlans``) and
``nnUNetPlannerResEncL`` (24 GB, ``nnUNetResEncUNetLPlans``).
"""

from typing import List, Optional, Tuple, Union

from dinounet_tpu_torch.planning.planner import ExperimentPlanner
from dinounet_tpu_torch.utilities import registry


@registry.planners.register("ResEncUNetPlanner")
class ResEncUNetPlanner(ExperimentPlanner):
    def __init__(self, dataset_name_or_id: Union[str, int],
                 gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetPlans",
                 overwrite_target_spacing: Union[List[float], Tuple[float, ...]] = None,
                 force_target_shape: Union[List[int], Tuple[int, ...]] = None,
                 max_batch_size: int = 32,
                 force_n_stages: Optional[int] = None,
                 suppress_transpose: bool = False):
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, overwrite_target_spacing,
                         force_target_shape, max_batch_size, force_n_stages,
                         suppress_transpose)
        self.UNet_class_name = (
            "dynamic_network_architectures.architectures.unet.ResidualEncoderUNet")
        # ref resencUNet_planner.py:25-29
        self.UNet_reference_val_3d = 680000000
        self.UNet_reference_val_2d = 135000000
        self.UNet_blocks_per_stage_encoder = (1, 3, 4, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6)
        self.UNet_blocks_per_stage_decoder = (1,) * 12

    def generate_data_identifier(self, configuration_name: str) -> str:
        """2d/3d_fullres reuse the default planner's preprocessed data
        (ref resencUNet_planner.py:31-40)."""
        if configuration_name in ("2d", "3d_fullres"):
            return "nnUNetPlans_" + configuration_name
        return self.plans_identifier + "_" + configuration_name


@registry.planners.register("nnUNetPlannerResEncM")
class nnUNetPlannerResEncM(ResEncUNetPlanner):
    """The residual encoder planned for an 8 GB memory target."""

    def __init__(self, dataset_name_or_id: Union[str, int],
                 gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetMPlans", **kwargs):
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, **kwargs)


@registry.planners.register("nnUNetPlannerResEncL")
class nnUNetPlannerResEncL(ResEncUNetPlanner):
    """The residual encoder planned for a 24 GB memory target."""

    def __init__(self, dataset_name_or_id: Union[str, int],
                 gpu_memory_target_in_gb: float = 24,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetLPlans", **kwargs):
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, **kwargs)
