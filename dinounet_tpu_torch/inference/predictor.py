"""nnUNetPredictor: prediction of cases from files or arrays by a 2-D or 3-D
network, with fold ensembling and mirror TTA on one device.

Counterpart of ``dinounet_tpu/inference/predictor.py`` (ref: dinounet/
inference/predict_from_raw_data.py:38-871):
  * ``initialize_from_trained_model_folder`` maps the port's ``torch.save``
    checkpoints of the folds (each fold's weights stay views of its file,
    not copies in host memory), looks the trainer up by name and builds its
    network on the predictor's device with deep supervision off, through
    the trainer's own ``build_network`` (the ViT-7B's is built on the device
    with its backbone's matrices in bf16); ``manual_initialization`` takes a
    network, the plans and one state_dict per fold (the trainer's final
    validation uses it). Each fold's weights are loaded into the one network
    in turn, as the reference's predictor does, and not again while they
    are the ones it holds;
  * ``predict_sliding_window_return_logits``, its ``_with_target`` form and
    ``predict_logits_from_preprocessed_data`` (fold-averaged fp16 logits, the
    reference's output contract). A 3-D network's tile batch is a quarter of
    ``tile_batch`` (at least 1), as in the JAX package. Past the device
    budget of the accumulators the folds add into one host buffer pair
    (``sliding_window.py``);
  * ``predict_single_npy_array``, the array iterators and
    ``predict_from_files``: preprocessing runs ahead of the device in a
    bounded thread pool (``data_iterators``) and export (resampling and
    writing) behind it in a second one. The pools hold numpy work only; the
    device's work runs on the calling thread;
  * a cascade stage's previous-stage segmentations (an array per case, or
    ``<folder>/<case><file_ending>`` from files): preprocessed as the
    case's segmentation and appended to its data as one-hot channels;
  * the CLIs ``predict_entry_point`` and ``predict_entry_point_modelfolder``
    (``-prev_stage_predictions`` for a cascade stage).

Several cards predict as several processes, each given its part of the
cases: ``num_parts`` / ``part_id`` (the CLI's ``-num_parts`` / ``-part_id``)
take every ``num_parts``-th case from ``part_id`` on (JAX
``predictor.py:147,160``, ref :167-205). The JAX package's sharding of one
process's tile batches over a device mesh (``predictor.py:309-328``) has no
counterpart: one process drives one card.
"""

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from dinounet_tpu_torch.inference.data_iterators import (preprocessing_iterator_fromfiles,
                                                        preprocessing_iterator_fromnpy)
from dinounet_tpu_torch.inference.export import (
    convert_predicted_logits_to_segmentation_with_correct_shape,
    export_prediction_from_logits)
from dinounet_tpu_torch.inference.sliding_window import (
    TilePredictor, finalize_sliding_window_logits, over_accum_budget,
    predict_sliding_window_return_logits, prepare_sliding_window_volume)
from dinounet_tpu_torch.planning.dataset_utils import create_lists_from_splitted_dataset_folder
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json, save_json
from dinounet_tpu_torch.utilities.label_handling import (convert_labelmap_to_one_hot,
                                                        determine_num_input_channels)
from dinounet_tpu_torch.utilities.plans_handler import (ConfigurationManager,
                                                        PlansManager)


class nnUNetPredictor:
    def __init__(self, tile_step_size: float = 0.5, use_gaussian: bool = True,
                 use_mirroring: bool = True, device="cuda",
                 tile_batch: int = 8, verbose: bool = False,
                 verbose_preprocessing: bool = False):
        self.tile_step_size = tile_step_size
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.device = torch.device(device)
        self.tile_batch = tile_batch
        self.verbose = verbose
        self.verbose_preprocessing = verbose_preprocessing

        self.plans_manager: Optional[PlansManager] = None
        self.configuration_manager: Optional[ConfigurationManager] = None
        self.dataset_json: Optional[dict] = None
        self.trainer_name: Optional[str] = None
        self.network: Optional[nn.Module] = None
        self.list_of_parameters: List[dict] = []  # one state_dict per fold
        self._loaded = None  # (network, the state_dict it was given last)
        self.allowed_mirroring_axes: Optional[Tuple[int, ...]] = None
        self.label_manager = None

    # ---------------------------------------------------------- initialization

    def initialize_from_trained_model_folder(self, model_training_output_dir: str,
                                             use_folds: Union[Tuple, List, str, None],
                                             checkpoint_name: str = "checkpoint_final.pth"):
        """The folds' checkpoints of a trained model folder, mapped; the
        network is the trainer's, built on the predictor's device with deep
        supervision off (ref :67-130). A fold's checkpoint may be any form
        that ``training/checkpointing.py::load_checkpoint`` reads: the
        port's file or sharded directory, or the JAX package's pickled file
        or orbax directory (a model folder trained on a TPU). A JAX fold is
        read into a host copy of the built network's tensors, each in the
        network's dtype (a 7B's backbone in bf16, never a whole fp32 copy);
        the trainer and configuration come from the first fold's keys
        without its tensors (a JAX pickle is read for them, then again)."""
        from dinounet_tpu_torch.training.checkpointing import (JAX_FORMATS, checkpoint_format,
                                                               load_checkpoint,
                                                               load_checkpoint_meta)

        if use_folds is None:
            use_folds = self.auto_detect_available_folds(model_training_output_dir,
                                                         checkpoint_name)
        dataset_json = load_json(os.path.join(model_training_output_dir, "dataset.json"))
        plans_manager = PlansManager(load_json(
            os.path.join(model_training_output_dir, "plans.json")))
        if isinstance(use_folds, str):
            use_folds = [use_folds]
        paths = [os.path.join(model_training_output_dir,
                              f"fold_{int(f) if f != 'all' else f}", checkpoint_name)
                 for f in use_folds]
        meta = load_checkpoint_meta(paths[0])
        trainer_name = meta["trainer_name"]
        configuration_name = meta["init_args"]["configuration"]
        mirroring_axes = meta.get("inference_allowed_mirroring_axes")

        configuration_manager = plans_manager.get_configuration(configuration_name)
        num_input_channels = determine_num_input_channels(
            plans_manager, configuration_manager, dataset_json)
        network = registry.trainers.get(trainer_name).build_network(
            self.device, configuration_manager, num_input_channels,
            plans_manager.get_label_manager(dataset_json).num_segmentation_heads,
            enable_deep_supervision=False)
        parameters = []
        for path in paths:
            template = None
            if checkpoint_format(path) in JAX_FORMATS:
                template = {k: torch.empty_like(v, device="cpu")
                            for k, v in network.state_dict().items()}
            parameters.append(load_checkpoint(path, network_template=template)[
                "network_weights"])
        self.manual_initialization(network, plans_manager, configuration_manager,
                                   parameters, dataset_json, trainer_name,
                                   mirroring_axes)

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
        self._loaded = None
        self.dataset_json = dataset_json
        self.trainer_name = trainer_name
        self.allowed_mirroring_axes = inference_allowed_mirroring_axes
        self.label_manager = plans_manager.get_label_manager(dataset_json)

    @staticmethod
    def auto_detect_available_folds(model_training_output_dir: str,
                                    checkpoint_name: str) -> List[int]:
        """The folds with a checkpoint of that name: a file, or a sharded
        directory (a model-axis run's, the port's or the JAX package's)."""
        fold_folders = [
            f for f in os.listdir(model_training_output_dir)
            if f.startswith("fold_") and f != "fold_all"
            and os.path.exists(os.path.join(model_training_output_dir, f, checkpoint_name))
        ]
        if not fold_folders:
            raise RuntimeError(f"No fold checkpoints in {model_training_output_dir}")
        return sorted(int(f.split("_")[-1]) for f in fold_folders)

    # --------------------------------------------------------- file management

    def _manage_input_and_output_lists(
            self, list_of_lists_or_source_folder,
            output_folder_or_list_of_truncated_output_files,
            folder_with_segs_from_prev_stage: Optional[str] = None,
            overwrite: bool = True, part_id: int = 0, num_parts: int = 1,
            save_probabilities: bool = False):
        """Input cases, output names and each case's previous-stage
        segmentation file (None without a folder) of part `part_id` of
        `num_parts` (every num_parts-th case from part_id on); with
        overwrite off, the cases whose outputs exist are dropped (ref
        :167-205)."""
        if not 0 <= part_id < num_parts:
            raise ValueError(f"part_id {part_id} is not a part of {num_parts}")
        file_ending = self.dataset_json["file_ending"]
        if isinstance(list_of_lists_or_source_folder, str):
            list_of_lists_or_source_folder = create_lists_from_splitted_dataset_folder(
                list_of_lists_or_source_folder, file_ending)
        list_of_lists = list(list_of_lists_or_source_folder)[part_id::num_parts]
        caseids = [os.path.basename(i[0])[: -(len(file_ending) + 5)]
                   for i in list_of_lists]

        if isinstance(output_folder_or_list_of_truncated_output_files, str):
            output_filename_truncated = [
                os.path.join(output_folder_or_list_of_truncated_output_files, c)
                for c in caseids]
        elif output_folder_or_list_of_truncated_output_files is None:
            output_filename_truncated = None
        else:
            output_filename_truncated = list(
                output_folder_or_list_of_truncated_output_files)[part_id::num_parts]
        seg_from_prev_stage_files = [
            None if folder_with_segs_from_prev_stage is None
            else os.path.join(folder_with_segs_from_prev_stage, c + file_ending)
            for c in caseids]

        if not overwrite and output_filename_truncated is not None:
            keep = [i for i, o in enumerate(output_filename_truncated)
                    if not (os.path.isfile(o + file_ending) and (
                        not save_probabilities or os.path.isfile(o + ".npz")))]
            output_filename_truncated = [output_filename_truncated[i] for i in keep]
            list_of_lists = [list_of_lists[i] for i in keep]
            seg_from_prev_stage_files = [seg_from_prev_stage_files[i] for i in keep]
        return list_of_lists, output_filename_truncated, seg_from_prev_stage_files

    @property
    def _mirror_axes(self) -> Optional[Sequence[int]]:
        return self.allowed_mirroring_axes if self.use_mirroring else None

    def _load(self, params: dict) -> None:
        """Load a fold's state_dict into the network, unless the network
        holds it already (the 7B's weights are 15 GB to copy a case)."""
        if self._loaded is None or self._loaded[0] is not self.network \
                or self._loaded[1] is not params:
            self.network.load_state_dict(params)
            self._loaded = (self.network, params)

    @property
    def _tile_batch(self) -> int:
        """3-D tiles are ~patch_size[0] times bigger than 2-D ones: a quarter
        of the batch (JAX ``predictor.py:243-246``)."""
        if len(self.configuration_manager.patch_size) == 2:
            return self.tile_batch
        return max(1, self.tile_batch // 4)

    def predict_sliding_window_return_logits(self, data: np.ndarray,
                                             parameters: Optional[dict] = None
                                             ) -> np.ndarray:
        """fp32 logits (K, Z, Y, X) of one fold (default: the first)."""
        return self._one_fold(data, parameters, None)

    def predict_sliding_window_return_logits_with_target(
            self, data: np.ndarray, target_mask: np.ndarray,
            parameters: Optional[dict] = None) -> np.ndarray:
        """The `*_with_target` entry point (ref predict_from_raw_data.py:
        728-776): for a network whose forward takes (image, mask), the mask
        volume (C_t, Z, Y, X) tiled and mirrored beside the image. fp32
        logits (K, Z, Y, X) of one fold (default: the first)."""
        return self._one_fold(data, parameters, np.asarray(target_mask))

    def _one_fold(self, data, parameters, target_mask) -> np.ndarray:
        self._load(parameters if parameters is not None else self.list_of_parameters[0])
        return predict_sliding_window_return_logits(
            self.network, np.asarray(data), tuple(self.configuration_manager.patch_size),
            self.label_manager.num_segmentation_heads,
            tile_step_size=self.tile_step_size, mirror_axes=self._mirror_axes,
            tile_batch=self._tile_batch, use_gaussian=self.use_gaussian,
            device=self.device, target_mask=target_mask)

    def predict_logits_from_preprocessed_data(self, data: np.ndarray) -> np.ndarray:
        """Fold-averaged logits (K, Z, Y, X) in fp16. The volume is uploaded
        once, the folds' logits are summed in one fp32 accumulator on the
        device (past the budget, on the host), and one fp16 copy comes back
        to the host."""
        patch_size = tuple(self.configuration_manager.patch_size)
        num_classes = self.label_manager.num_segmentation_heads
        volume, offsets, revert = prepare_sliding_window_volume(
            np.asarray(data), patch_size, self.tile_step_size, self.device)
        predictor = TilePredictor(self.network, patch_size, num_classes,
                                  self._tile_batch, self._mirror_axes,
                                  self.use_gaussian)
        on_host = over_accum_budget(volume, patch_size, num_classes)
        if on_host and self.verbose:
            print("sliding window: accumulators over the device budget; "
                  "accumulating on the host")
        accum_sum = weights = None
        for params in self.list_of_parameters:
            self._load(params)
            if on_host:
                accum_sum, weights = predictor.predict_host(volume, offsets,
                                                            accum_sum, weights)
            else:
                accum, weights = predictor.predict(volume, offsets, weights)
                accum_sum = accum if accum_sum is None else accum_sum + accum
        n = len(self.list_of_parameters)
        return finalize_sliding_window_logits(accum_sum, weights * n, revert, patch_size,
                                              out_dtype=torch.float16)

    # ------------------------------------------------------ arrays and files

    def predict_single_npy_array(self, input_image: np.ndarray, image_properties: dict,
                                 segmentation_previous_stage: np.ndarray = None,
                                 output_file_truncated: str = None,
                                 save_or_return_probabilities: bool = False):
        """Preprocess, predict and export one case given as an array
        (ref :429-464); a cascade stage's previous-stage segmentation
        (*spatial) is preprocessed as the case's segmentation and appended
        as one-hot channels. With `output_file_truncated` the result is
        written and None returned; else the segmentation (and the
        probabilities)."""
        preprocessor = self.configuration_manager.preprocessor_class(verbose=self.verbose)
        data, seg = preprocessor.run_case_npy(
            input_image,
            None if segmentation_previous_stage is None else segmentation_previous_stage[None],
            image_properties, self.plans_manager, self.configuration_manager,
            self.dataset_json)
        if segmentation_previous_stage is not None:
            data = np.vstack((data, convert_labelmap_to_one_hot(
                seg[0], self.label_manager.foreground_labels, data.dtype)))
        logits = self.predict_logits_from_preprocessed_data(data)
        if output_file_truncated is not None:
            export_prediction_from_logits(
                logits, image_properties, self.configuration_manager,
                self.plans_manager, self.dataset_json, output_file_truncated,
                save_or_return_probabilities)
            return None
        return convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, self.plans_manager, self.configuration_manager, self.label_manager,
            image_properties, return_probabilities=save_or_return_probabilities)

    def get_data_iterator_from_raw_npy_data(
            self, image_or_list_of_images,
            segs_from_prev_stage_or_list_of_segs_from_prev_stage,
            properties_or_list_of_properties, truncated_ofname,
            num_processes: int = 3):
        """Preprocessing iterator over in-memory arrays (ref :291-328): yields
        {'data', 'data_properties', 'ofile'}, preprocessed a bounded number
        of cases ahead in a thread pool (``data_iterators``); a case's
        previous-stage segmentation (*spatial), where given, becomes one-hot
        channels."""
        images = image_or_list_of_images
        if not isinstance(images, list):
            images = [images]
        segs_prev = segs_from_prev_stage_or_list_of_segs_from_prev_stage
        if not isinstance(segs_prev, list):
            segs_prev = [segs_prev] * len(images)
        segs_prev = [None if s is None else s[None] for s in segs_prev]
        props = properties_or_list_of_properties
        if isinstance(props, dict):
            props = [props] * len(images)
        if truncated_ofname is None or isinstance(truncated_ofname, str):
            truncated_ofname = [truncated_ofname] * len(images)
        return preprocessing_iterator_fromnpy(
            images, segs_prev, props, truncated_ofname, self.plans_manager, self.dataset_json,
            self.configuration_manager, num_processes, verbose=self.verbose_preprocessing)

    def predict_from_data_iterator(self, data_iterator, save_probabilities: bool = False,
                                   num_processes_segmentation_export: int = 3):
        """Predict every item of an iterator of {'data', 'data_properties',
        'ofile'} (ref :348-427): with an 'ofile' the case is written and its
        name returned, else its segmentation (and probabilities). The device
        predicts on this thread; export runs behind in a thread pool, at
        most twice its workers' cases (the reference's busy-wait
        backpressure)."""
        def export(logits, properties, ofile):
            if ofile is None:
                return convert_predicted_logits_to_segmentation_with_correct_shape(
                    logits, self.plans_manager, self.configuration_manager,
                    self.label_manager, properties,
                    return_probabilities=save_probabilities)
            export_prediction_from_logits(
                logits, properties, self.configuration_manager, self.plans_manager,
                self.dataset_json, ofile, save_probabilities)
            return ofile

        n_export = max(1, num_processes_segmentation_export)
        ret, exports = [], deque()
        with ThreadPoolExecutor(max_workers=n_export) as pool:
            for item in data_iterator:
                data = item["data"]
                if isinstance(data, str):  # a spilled .npy file (ref :364-367)
                    path = data
                    data = np.load(path)
                    os.remove(path)
                logits = self.predict_logits_from_preprocessed_data(data)
                exports.append(pool.submit(export, logits, item["data_properties"],
                                           item.get("ofile")))
                while len(exports) > 2 * n_export:
                    ret.append(exports.popleft().result())
            while exports:
                ret.append(exports.popleft().result())
        return ret

    def predict_from_list_of_npy_arrays(
            self, image_or_list_of_images,
            segs_from_prev_stage_or_list_of_segs_from_prev_stage,
            properties_or_list_of_properties, truncated_ofname,
            num_processes: int = 3, save_probabilities: bool = False,
            num_processes_segmentation_export: int = 3):
        """ref :330-346."""
        iterator = self.get_data_iterator_from_raw_npy_data(
            image_or_list_of_images,
            segs_from_prev_stage_or_list_of_segs_from_prev_stage,
            properties_or_list_of_properties, truncated_ofname, num_processes)
        return self.predict_from_data_iterator(iterator, save_probabilities,
                                               num_processes_segmentation_export)

    def predict_from_files(self, list_of_lists_or_source_folder,
                           output_folder_or_list_of_truncated_output_files,
                           save_probabilities: bool = False, overwrite: bool = True,
                           num_processes_preprocessing: int = 3,
                           num_processes_segmentation_export: int = 3,
                           folder_with_segs_from_prev_stage: Optional[str] = None,
                           num_parts: int = 1, part_id: int = 0):
        """Predict raw image files (ref :207-346): preprocessing runs up to
        `num_processes_preprocessing` + 1 cases ahead of the device in a
        thread pool, export behind it (``predict_from_data_iterator``). A
        cascade stage reads each case's previous-stage segmentation from
        `folder_with_segs_from_prev_stage`."""
        list_of_lists, output_files, seg_prev = self._manage_input_and_output_lists(
            list_of_lists_or_source_folder,
            output_folder_or_list_of_truncated_output_files,
            folder_with_segs_from_prev_stage, overwrite, part_id, num_parts,
            save_probabilities)
        if isinstance(output_folder_or_list_of_truncated_output_files, str):
            out = output_folder_or_list_of_truncated_output_files
            os.makedirs(out, exist_ok=True)
            # the prediction's set-up beside it (ref :246-255)
            save_json(self.dataset_json, os.path.join(out, "dataset.json"))
            save_json(self.plans_manager.plans, os.path.join(out, "plans.json"))
        if not list_of_lists:
            return []
        iterator = preprocessing_iterator_fromfiles(
            list_of_lists, seg_prev, output_files, self.plans_manager, self.dataset_json,
            self.configuration_manager, max(1, num_processes_preprocessing),
            verbose=self.verbose_preprocessing)
        return self.predict_from_data_iterator(iterator, save_probabilities,
                                               num_processes_segmentation_export)


def _predict_parser(model_folder_flag: bool):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-i", type=str, required=True, help="input folder")
    parser.add_argument("-o", type=str, required=True, help="output folder")
    if model_folder_flag:
        parser.add_argument("-m", type=str, required=True,
                            help="trained model folder (.../Trainer__plans__config)")
    else:
        parser.add_argument("-d", type=str, required=True, help="dataset name or id")
        parser.add_argument("-p", type=str, default="nnUNetPlans")
        parser.add_argument("-tr", type=str, default="nnUNetTrainer")
        parser.add_argument("-c", type=str, required=True, help="configuration")
    parser.add_argument("-f", nargs="+", type=str, default=(0, 1, 2, 3, 4))
    parser.add_argument("-step_size", type=float, default=0.5)
    parser.add_argument("--disable_tta", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--save_probabilities", action="store_true")
    parser.add_argument("--continue_prediction", action="store_true")
    parser.add_argument("-chk", type=str, default="checkpoint_final.pth")
    parser.add_argument("-npp", type=int, default=3)
    parser.add_argument("-nps", type=int, default=3)
    parser.add_argument("-prev_stage_predictions", type=str, default=None)
    if not model_folder_flag:
        parser.add_argument("-num_parts", type=int, default=1)
        parser.add_argument("-part_id", type=int, default=0)
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device: cuda (the default), cuda:N or cpu")
    return parser


def _predict_from_args(args, model_folder: str, num_parts: int = 1, part_id: int = 0):
    folds = [f if f == "all" else int(f) for f in args.f]
    predictor = nnUNetPredictor(tile_step_size=args.step_size, use_gaussian=True,
                                use_mirroring=not args.disable_tta, device=args.device,
                                verbose=args.verbose)
    predictor.initialize_from_trained_model_folder(model_folder, folds, args.chk)
    predictor.predict_from_files(
        args.i, args.o, save_probabilities=args.save_probabilities,
        overwrite=not args.continue_prediction,
        num_processes_preprocessing=args.npp,
        num_processes_segmentation_export=args.nps,
        folder_with_segs_from_prev_stage=args.prev_stage_predictions,
        num_parts=num_parts, part_id=part_id)


def predict_entry_point():
    """Prediction CLI (ref predict_from_raw_data.py:779-870, nnUNetv2_predict)."""
    from dinounet_tpu_torch.utilities.misc import (
        convert_identifier_to_trained_model_output_folder, maybe_convert_to_dataset_name)

    args = _predict_parser(False).parse_args()
    model_folder = convert_identifier_to_trained_model_output_folder(
        maybe_convert_to_dataset_name(args.d), args.tr, args.p, args.c)
    _predict_from_args(args, model_folder, args.num_parts, args.part_id)


def predict_entry_point_modelfolder():
    """Prediction CLI taking the trained model folder itself (ref
    predict_from_raw_data.py:779-871), for when nnUNet_results is not set."""
    args = _predict_parser(True).parse_args()
    _predict_from_args(args, args.m)


if __name__ == "__main__":
    import sys as _sys

    # `python -m dinounet_tpu_torch.inference.predictor from-folder ...` is the
    # explicit-model-folder CLI
    if len(_sys.argv) > 1 and _sys.argv[1] == "from-folder":
        _sys.argv = [_sys.argv[0]] + _sys.argv[2:]
        predict_entry_point_modelfolder()
    else:
        predict_entry_point()
