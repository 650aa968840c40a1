"""plans.json access layer.

Byte-compatible with the reference's plans.json format (the public experiment
contract), including per-configuration ``inherits_from`` resolution with cycle
detection. Mirrors the property surface of
ref: dinounet/utilities/plans_handling/plans_handler.py:31-356, with the
string->class lookups routed through explicit registries instead of pydoc.
"""

from functools import lru_cache
from typing import List, Union

from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.label_handling import LabelManager


class ConfigurationManager:
    def __init__(self, configuration_dict: dict):
        self.configuration = configuration_dict

    def __repr__(self):
        return self.configuration.__repr__()

    @property
    def data_identifier(self) -> str:
        return self.configuration["data_identifier"]

    @property
    def preprocessor_name(self) -> str:
        return self.configuration["preprocessor_name"]

    @property
    def preprocessor_class(self):
        return registry.preprocessors.get(self.preprocessor_name)

    @property
    def batch_size(self) -> int:
        return self.configuration["batch_size"]

    @property
    def patch_size(self) -> List[int]:
        return self.configuration["patch_size"]

    @property
    def median_image_size_in_voxels(self) -> List[int]:
        return self.configuration["median_image_size_in_voxels"]

    @property
    def spacing(self) -> List[float]:
        return self.configuration["spacing"]

    @property
    def normalization_schemes(self) -> List[str]:
        return self.configuration["normalization_schemes"]

    @property
    def use_mask_for_norm(self) -> List[bool]:
        return self.configuration["use_mask_for_norm"]

    @property
    def network_arch_class_name(self) -> str:
        return self.configuration["architecture"]["network_class_name"]

    @property
    def network_arch_init_kwargs(self) -> dict:
        return self.configuration["architecture"]["arch_kwargs"]

    @property
    def network_arch_init_kwargs_req_import(self):
        return self.configuration["architecture"]["_kw_requires_import"]

    @property
    def pool_op_kernel_sizes(self):
        return self.configuration["architecture"]["arch_kwargs"]["strides"]

    @property
    def conv_kernel_sizes(self):
        return self.configuration["architecture"]["arch_kwargs"]["kernel_sizes"]

    @property
    def n_conv_per_stage_encoder(self):
        return self.configuration["architecture"]["arch_kwargs"]["n_conv_per_stage"]

    @property
    def n_conv_per_stage_decoder(self):
        return self.configuration["architecture"]["arch_kwargs"]["n_conv_per_stage_decoder"]

    @property
    def features_per_stage(self):
        return self.configuration["architecture"]["arch_kwargs"]["features_per_stage"]

    @property
    def resampling_fn_data(self):
        fn = registry.resampling_fns.get(self.configuration["resampling_fn_data"])
        kwargs = self.configuration["resampling_fn_data_kwargs"]
        return lambda data, new_shape, cur_spacing, new_spacing: fn(
            data, new_shape, cur_spacing, new_spacing, **kwargs
        )

    @property
    def resampling_fn_probabilities(self):
        fn = registry.resampling_fns.get(self.configuration["resampling_fn_probabilities"])
        kwargs = self.configuration["resampling_fn_probabilities_kwargs"]
        return lambda data, new_shape, cur_spacing, new_spacing: fn(
            data, new_shape, cur_spacing, new_spacing, **kwargs
        )

    @property
    def resampling_fn_seg(self):
        fn = registry.resampling_fns.get(self.configuration["resampling_fn_seg"])
        kwargs = self.configuration["resampling_fn_seg_kwargs"]
        return lambda seg, new_shape, cur_spacing, new_spacing: fn(
            seg, new_shape, cur_spacing, new_spacing, **kwargs
        )

    @property
    def batch_dice(self) -> bool:
        return self.configuration["batch_dice"]

    @property
    def next_stage_names(self) -> Union[List[str], None]:
        ret = self.configuration.get("next_stage")
        if ret is not None and isinstance(ret, str):
            ret = [ret]
        return ret

    @property
    def previous_stage_name(self) -> Union[str, None]:
        return self.configuration.get("previous_stage")


class PlansManager:
    def __init__(self, plans_file_or_dict: Union[str, dict]):
        self.plans = (
            plans_file_or_dict
            if isinstance(plans_file_or_dict, dict)
            else load_json(plans_file_or_dict)
        )

    def __repr__(self):
        return self.plans.__repr__()

    def _internal_resolve_configuration_inheritance(
        self, configuration_name: str, visited: tuple = ()
    ) -> dict:
        if configuration_name in visited:
            raise RuntimeError(
                f"Circular 'inherits_from' dependency: {' -> '.join(visited)} -> {configuration_name}"
            )
        if configuration_name not in self.plans["configurations"]:
            raise ValueError(
                f"Requested configuration {configuration_name} not found in plans. "
                f"Available: {list(self.plans['configurations'].keys())}"
            )
        configuration = dict(self.plans["configurations"][configuration_name])
        if "inherits_from" in configuration:
            parent_name = configuration["inherits_from"]
            base = self._internal_resolve_configuration_inheritance(
                parent_name, visited + (configuration_name,)
            )
            del configuration["inherits_from"]
            base = dict(base)
            base.update(configuration)
            configuration = base
        return configuration

    @lru_cache(maxsize=10)
    def get_configuration(self, configuration_name: str) -> ConfigurationManager:
        return ConfigurationManager(
            self._internal_resolve_configuration_inheritance(configuration_name)
        )

    @property
    def dataset_name(self) -> str:
        return self.plans["dataset_name"]

    @property
    def plans_name(self) -> str:
        return self.plans["plans_name"]

    @property
    def original_median_spacing_after_transp(self) -> List[float]:
        return self.plans["original_median_spacing_after_transp"]

    @property
    def original_median_shape_after_transp(self) -> List[float]:
        return self.plans["original_median_shape_after_transp"]

    @property
    def image_reader_writer_class(self):
        return registry.image_readers.get(self.plans["image_reader_writer"])

    @property
    def transpose_forward(self) -> List[int]:
        return self.plans["transpose_forward"]

    @property
    def transpose_backward(self) -> List[int]:
        return self.plans["transpose_backward"]

    @property
    def available_configurations(self) -> List[str]:
        return list(self.plans["configurations"].keys())

    @property
    def experiment_planner_name(self) -> str:
        return self.plans["experiment_planner_used"]

    @property
    def experiment_planner_class(self):
        return registry.planners.get(self.experiment_planner_name)

    def get_label_manager(self, dataset_json: dict, **kwargs) -> LabelManager:
        return LabelManager(
            label_dict=dataset_json["labels"],
            regions_class_order=dataset_json.get("regions_class_order"),
            **kwargs,
        )

    @property
    def foreground_intensity_properties_per_channel(self) -> dict:
        if "foreground_intensity_properties_per_channel" not in self.plans:
            if "foreground_intensity_properties_by_modality" in self.plans:
                return self.plans["foreground_intensity_properties_by_modality"]
        return self.plans["foreground_intensity_properties_per_channel"]
