"""Prediction export: logits -> resample back -> segmentation -> un-crop ->
un-transpose -> write.

Capability parity with ref: dinounet/inference/export_prediction.py:15-146.

JAX-free copy of ``dinounet_tpu/inference/export.py``.
"""

import os
import pickle
from typing import Optional, Union

import numpy as np

from dinounet_tpu_torch.utilities.label_handling import LabelManager
from dinounet_tpu_torch.utilities.plans_handler import ConfigurationManager, PlansManager


def convert_predicted_logits_to_segmentation_with_correct_shape(
    predicted_logits: np.ndarray, plans_manager: PlansManager,
    configuration_manager: ConfigurationManager, label_manager: LabelManager,
    properties_dict: dict, return_probabilities: bool = False,
):
    """ref export_prediction.py:15-68."""
    # resample to original (cropped) shape
    current_spacing = (
        configuration_manager.spacing
        if len(configuration_manager.spacing)
        == len(properties_dict["shape_after_cropping_and_before_resampling"])
        else [properties_dict["spacing"][0], *configuration_manager.spacing]
    )
    target_spacing = [properties_dict["spacing"][i] for i in plans_manager.transpose_forward]
    predicted_logits = configuration_manager.resampling_fn_probabilities(
        predicted_logits,
        properties_dict["shape_after_cropping_and_before_resampling"],
        current_spacing,
        target_spacing,
    )
    predicted_probabilities = label_manager.apply_inference_nonlin(predicted_logits)
    del predicted_logits
    segmentation = label_manager.convert_probabilities_to_segmentation(predicted_probabilities)

    # paste into pre-crop bbox
    segmentation_reverted_cropping = np.zeros(
        properties_dict["shape_before_cropping"],
        dtype=np.uint8 if len(label_manager.foreground_labels) < 255 else np.uint16,
    )
    slicer = tuple(slice(b[0], b[1]) for b in properties_dict["bbox_used_for_cropping"])
    segmentation_reverted_cropping[slicer] = segmentation
    del segmentation

    # revert transpose
    segmentation_reverted_cropping = segmentation_reverted_cropping.transpose(
        plans_manager.transpose_backward
    )
    if return_probabilities:
        predicted_probabilities = label_manager.revert_cropping_on_probabilities(
            predicted_probabilities,
            properties_dict["bbox_used_for_cropping"],
            properties_dict["shape_before_cropping"],
        )
        predicted_probabilities = predicted_probabilities.transpose(
            [0] + [i + 1 for i in plans_manager.transpose_backward]
        )
        return segmentation_reverted_cropping, predicted_probabilities
    return segmentation_reverted_cropping


def export_prediction_from_logits(
    predicted_array_or_file: np.ndarray, properties_dict: dict,
    configuration_manager: ConfigurationManager, plans_manager: PlansManager,
    dataset_json: dict, output_file_truncated: str, save_probabilities: bool = False,
):
    """ref export_prediction.py:71-113."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    ret = convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_array_or_file, plans_manager, configuration_manager, label_manager,
        properties_dict, return_probabilities=save_probabilities,
    )
    if save_probabilities:
        segmentation_final, probabilities_final = ret
        np.savez_compressed(output_file_truncated + ".npz", probabilities=probabilities_final)
        with open(output_file_truncated + ".pkl", "wb") as f:
            pickle.dump(properties_dict, f)
    else:
        segmentation_final = ret

    rw = plans_manager.image_reader_writer_class()
    rw.write_seg(
        segmentation_final, output_file_truncated + dataset_json["file_ending"],
        properties_dict,
    )


def resample_and_save(
    predicted: np.ndarray, target_shape, output_file: str,
    plans_manager: PlansManager, configuration_manager: ConfigurationManager,
    properties_dict: dict, dataset_json: dict,
):
    """Cascade: resample softmax to the next stage's resolution and save the
    argmax seg as npz (ref export_prediction.py:116-145)."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    current_spacing = (
        configuration_manager.spacing
        if len(configuration_manager.spacing) == len(target_shape)
        else [properties_dict["spacing"][0], *configuration_manager.spacing]
    )
    target_spacing = (
        configuration_manager.spacing if len(configuration_manager.spacing) == len(target_shape)
        else [properties_dict["spacing"][0], *configuration_manager.spacing]
    )
    predicted_resampled = configuration_manager.resampling_fn_probabilities(
        predicted, target_shape, current_spacing, target_spacing
    )
    segmentation = label_manager.convert_logits_to_segmentation(predicted_resampled)
    np.savez_compressed(output_file, seg=segmentation.astype(np.uint8))
