"""Pick the best trained configuration (incl. pairwise ensembles) by CV Dice.

Capability parity with ref: dinounet/evaluation/find_best_configuration.py:
81-298: accumulate each model's cross-validation predictions, optionally
ensemble every pair, score all by mean foreground Dice, determine
postprocessing for the winner, write inference_information.json /
inference_instructions.txt, and return the info dict.

JAX-free copy of ``dinounet_tpu/evaluation/find_best_configuration.py``; the
commands it writes name the port's modules.
"""

import argparse
import os
from copy import deepcopy
from typing import List, Tuple, Union

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import default_num_processes
from dinounet_tpu_torch.ensembling.ensemble import ensemble_crossvalidations
from dinounet_tpu_torch.evaluation.accumulate_cv_results import accumulate_cv_results
from dinounet_tpu_torch.evaluation.metrics import (
    compute_metrics_on_folder,
    load_summary_json,
)
from dinounet_tpu_torch.postprocessing.remove_connected_components import (
    determine_postprocessing,
)
from dinounet_tpu_torch.utilities.json_export import load_json, save_json
from dinounet_tpu_torch.utilities.misc import (
    convert_identifier_to_trained_model_output_folder,
    maybe_convert_to_dataset_name,
)
from dinounet_tpu_torch.utilities.plans_handler import PlansManager

# ref find_best_configuration.py:19-23
default_trained_models = (
    {"plans": "nnUNetPlans", "configuration": "2d", "trainer": "nnUNetTrainer"},
    {"plans": "nnUNetPlans", "configuration": "3d_fullres", "trainer": "nnUNetTrainer"},
    {"plans": "nnUNetPlans", "configuration": "3d_lowres", "trainer": "nnUNetTrainer"},
    {"plans": "nnUNetPlans", "configuration": "3d_cascade_fullres",
     "trainer": "nnUNetTrainer"},
)


def folds_tuple_to_string(folds: Union[List[int], Tuple[int, ...]]) -> str:
    """ref file_path_utilities.py:82-86."""
    return "_".join(str(f) for f in folds)


def get_ensemble_name(model1_folder: str, model2_folder: str, folds) -> str:
    """ref file_path_utilities.py:64-67."""
    return ("ensemble___" + os.path.basename(model1_folder) + "___"
            + os.path.basename(model2_folder) + "___" + folds_tuple_to_string(folds))


def convert_identifier_to_trainer_plans_config(identifier: str):
    """ref file_path_utilities.py:15-16."""
    return os.path.basename(identifier).split("__")


def _output_folder(dataset_name_or_id, m: dict) -> str:
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    return convert_identifier_to_trained_model_output_folder(
        dataset_name, m["trainer"], m["plans"], m["configuration"])


def filter_available_models(model_dict, dataset_name_or_id):
    """ref find_best_configuration.py:26-50: drop configurations absent from
    the plans; hard-fail on missing trained-model folders."""
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    valid = []
    for trained_model in model_dict:
        plans_file = os.path.join(paths.nnUNet_preprocessed(), dataset_name,
                                  trained_model["plans"] + ".json")
        plans_manager = PlansManager(load_json(plans_file))
        if trained_model["configuration"] not in plans_manager.available_configurations:
            print(f"Configuration {trained_model['configuration']} not found in "
                  f"plans {trained_model['plans']} ({plans_file}).")
            continue
        expected = _output_folder(dataset_name_or_id, trained_model)
        if not os.path.isdir(expected):
            raise RuntimeError(
                f"Trained model {trained_model} does not have an output folder. "
                f"Expected: {expected}. Please run the training for this model! "
                f"(don't forget --npz if you want to ensemble multiple configurations)")
        valid.append(trained_model)
    return valid


def generate_inference_command(dataset_name_or_id, configuration_name: str,
                               plans_identifier: str = "nnUNetPlans",
                               trainer_name: str = "nnUNetTrainer",
                               folds=(0, 1, 2, 3, 4),
                               folder_with_segs_from_prev_stage: str = None,
                               input_folder: str = "INPUT_FOLDER",
                               output_folder: str = "OUTPUT_FOLDER",
                               save_npz: bool = False) -> str:
    """ref find_best_configuration.py:53-80 (command text mirrors the nnU-Net
    CLI; here it is `python -m dinounet_tpu_torch.inference.predictor`)."""
    command = ""
    trained_model_folder = convert_identifier_to_trained_model_output_folder(
        maybe_convert_to_dataset_name(dataset_name_or_id), trainer_name,
        plans_identifier, configuration_name)
    plans_manager = PlansManager(
        load_json(os.path.join(trained_model_folder, "plans.json")))
    configuration_manager = plans_manager.get_configuration(configuration_name)
    if configuration_manager.previous_stage_name is not None:
        prev = configuration_manager.previous_stage_name
        command += generate_inference_command(
            dataset_name_or_id, prev, plans_identifier, trainer_name, folds,
            None, output_folder="OUTPUT_FOLDER_PREV_STAGE") + "\n"
        folder_with_segs_from_prev_stage = "OUTPUT_FOLDER_PREV_STAGE"

    fold_str = " ".join(str(f) for f in folds)
    command += (f"python -m dinounet_tpu_torch.inference.predictor -d {dataset_name_or_id} "
                f"-i {input_folder} -o {output_folder} -f {fold_str} "
                f"-tr {trainer_name} -c {configuration_name} -p {plans_identifier}")
    if folder_with_segs_from_prev_stage is not None:
        command += f" -prev_stage_predictions {folder_with_segs_from_prev_stage}"
    if save_npz:
        command += " --save_probabilities"
    return command


def find_best_configuration(dataset_name_or_id,
                            allowed_trained_models=default_trained_models,
                            allow_ensembling: bool = True,
                            num_processes: int = default_num_processes,
                            overwrite: bool = True,
                            folds=(0, 1, 2, 3, 4),
                            strict: bool = False) -> dict:
    """ref find_best_configuration.py:81-240."""
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    all_results = {}

    allowed_trained_models = filter_available_models(
        deepcopy(list(allowed_trained_models)), dataset_name_or_id)

    for m in allowed_trained_models:
        output_folder = _output_folder(dataset_name_or_id, m)
        if not os.path.isdir(output_folder) and strict:
            raise RuntimeError(
                f"{dataset_name}: missing output folder for plans {m['plans']} "
                f"configuration {m['configuration']}. Train all requested folds first!")
        identifier = os.path.basename(output_folder)
        merged = os.path.join(
            output_folder, f"crossval_results_folds_{folds_tuple_to_string(folds)}")
        accumulate_cv_results(output_folder, merged, folds, num_processes, overwrite)
        all_results[identifier] = {
            "source": merged,
            "result": load_summary_json(
                os.path.join(merged, "summary.json"))["foreground_mean"]["Dice"],
        }

    if allow_ensembling:
        for i in range(len(allowed_trained_models)):
            for j in range(i + 1, len(allowed_trained_models)):
                m1, m2 = allowed_trained_models[i], allowed_trained_models[j]
                folder1 = _output_folder(dataset_name_or_id, m1)
                folder2 = _output_folder(dataset_name_or_id, m2)
                identifier = get_ensemble_name(folder1, folder2, folds)
                ensemble_folder = os.path.join(
                    paths.nnUNet_results(), dataset_name, "ensembles", identifier)
                ensemble_crossvalidations([folder1, folder2], ensemble_folder,
                                          folds, num_processes)

                plans_manager = PlansManager(
                    load_json(os.path.join(folder1, "plans.json")))
                dataset_json = load_json(os.path.join(folder1, "dataset.json"))
                label_manager = plans_manager.get_label_manager(dataset_json)
                rw = plans_manager.image_reader_writer_class()
                compute_metrics_on_folder(
                    os.path.join(paths.nnUNet_preprocessed(), dataset_name,
                                 "gt_segmentations"),
                    ensemble_folder,
                    os.path.join(ensemble_folder, "summary.json"),
                    rw, dataset_json["file_ending"],
                    label_manager.foreground_regions if label_manager.has_regions
                    else label_manager.foreground_labels,
                    label_manager.ignore_label, num_processes)
                all_results[identifier] = {
                    "source": ensemble_folder,
                    "result": load_summary_json(os.path.join(
                        ensemble_folder, "summary.json"))["foreground_mean"]["Dice"],
                }

    best_score = max(v["result"] for v in all_results.values())
    best_key = [k for k in all_results if all_results[k]["result"] == best_score][0]

    print("\n***All results:***")
    for k, v in all_results.items():
        print(f"{k}: {v['result']}")
    print(f"\n*Best*: {best_key}: {all_results[best_key]['result']}\n")

    print("***Determining postprocessing for best model/ensemble***")
    determine_postprocessing(
        all_results[best_key]["source"],
        os.path.join(paths.nnUNet_preprocessed(), dataset_name, "gt_segmentations"),
        plans_file_or_dict=os.path.join(all_results[best_key]["source"], "plans.json"),
        dataset_json_file_or_dict=os.path.join(all_results[best_key]["source"],
                                               "dataset.json"),
        num_processes=num_processes, keep_postprocessed_files=True)

    return_dict = {
        "folds": list(folds),
        "dataset_name_or_id": dataset_name_or_id,
        "considered_models": allowed_trained_models,
        "ensembling_allowed": allow_ensembling,
        "all_results": {k: v["result"] for k, v in all_results.items()},
        "best_model_or_ensemble": {
            "result_on_crossval_pre_pp": all_results[best_key]["result"],
            "result_on_crossval_post_pp": load_json(os.path.join(
                all_results[best_key]["source"], "postprocessed", "summary.json"
            ))["foreground_mean"]["Dice"],
            "postprocessing_file": os.path.join(all_results[best_key]["source"],
                                                "postprocessing.pkl"),
            "some_plans_file": os.path.join(all_results[best_key]["source"],
                                            "plans.json"),
            "selected_model_or_models": [],
        },
    }
    if best_key.startswith("ensemble___"):
        _, m1, m2, _ = best_key.split("___")
        members = [m1, m2]
    else:
        members = [best_key]
    for member in members:
        tr, pl, c = convert_identifier_to_trainer_plans_config(member)
        return_dict["best_model_or_ensemble"]["selected_model_or_models"].append(
            {"configuration": c, "trainer": tr, "plans_identifier": pl})

    save_json(return_dict, os.path.join(paths.nnUNet_results(), dataset_name,
                                        "inference_information.json"))
    print_inference_instructions(
        return_dict, instructions_file=os.path.join(
            paths.nnUNet_results(), dataset_name, "inference_instructions.txt"))
    return return_dict


def print_inference_instructions(inference_info_dict: dict,
                                 instructions_file: str = None) -> None:
    """ref find_best_configuration.py:242-298."""
    handle = open(instructions_file, "w") if instructions_file is not None else None

    def emit(s: str):
        print(s)
        if handle is not None:
            handle.write(s + "\n")

    try:
        emit("***Run inference like this:***\n")
        info = inference_info_dict["best_model_or_ensemble"]
        dataset = inference_info_dict["dataset_name_or_id"]
        if len(info["selected_model_or_models"]) > 1:
            emit("An ensemble won! What a surprise! Run the following commands to run "
                 "predictions with the ensemble members:\n")
        for m in info["selected_model_or_models"]:
            emit(generate_inference_command(
                dataset, m["configuration"], m["plans_identifier"], m["trainer"],
                inference_info_dict["folds"],
                save_npz=len(info["selected_model_or_models"]) > 1))
        if len(info["selected_model_or_models"]) > 1:
            emit("\nThe run ensembling with:\n")
            emit("python -m dinounet_tpu_torch.ensembling.ensemble -i FOLDER1 FOLDER2 "
                 "-o OUTPUT_FOLDER -np 8")
        emit("\n***Once inference is completed, run postprocessing like this:***\n")
        emit("python -m dinounet_tpu_torch.postprocessing.remove_connected_components "
             f"-i FOLDER_WITH_PREDICTIONS -o OUTPUT_FOLDER "
             f"-pp_pkl_file {info['postprocessing_file']} -np 8 "
             f"-plans_json {info['some_plans_file']}")
    finally:
        if handle is not None:
            handle.close()


def main():
    """CLI (ref find_best_configuration.py:300-330, nnUNetv2_find_best_configuration)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_name_or_id", type=str)
    parser.add_argument("-p", nargs="+", default=["nnUNetPlans"],
                        help="plans identifiers")
    parser.add_argument("-c", nargs="+",
                        default=["2d", "3d_fullres", "3d_lowres", "3d_cascade_fullres"],
                        help="configurations")
    parser.add_argument("-tr", nargs="+", default=["nnUNetTrainer"], help="trainers")
    parser.add_argument("-np", type=int, default=default_num_processes)
    parser.add_argument("-f", nargs="+", type=int, default=(0, 1, 2, 3, 4))
    parser.add_argument("--disable_ensembling", action="store_true")
    parser.add_argument("--no_overwrite", action="store_true")
    args = parser.parse_args()

    models = [{"plans": p, "configuration": c, "trainer": t}
              for p in args.p for c in args.c for t in args.tr]
    find_best_configuration(
        args.dataset_name_or_id, models,
        allow_ensembling=not args.disable_ensembling, num_processes=args.np,
        overwrite=not args.no_overwrite, folds=args.f)


if __name__ == "__main__":
    main()


# reference name for the CLI (ref find_best_configuration.py:271)
find_best_configuration_entry_point = main


def accumulate_crossval_results_entry_point():
    """Merge the fold validations of one configuration and evaluate them
    (ref find_best_configuration.py:300-325, nnUNetv2_accumulate_crossval_results)."""
    parser = argparse.ArgumentParser(
        "Copies all predicted segmentations from the individual folds into "
        "one joint folder and evaluates them")
    parser.add_argument("dataset_name_or_id", type=str)
    parser.add_argument("-c", type=str, required=True, help="configuration")
    parser.add_argument("-o", type=str, default=None, help="output folder")
    parser.add_argument("-f", nargs="+", type=int, default=(0, 1, 2, 3, 4))
    parser.add_argument("-p", type=str, default="nnUNetPlans")
    parser.add_argument("-tr", type=str, default="nnUNetTrainer")
    args = parser.parse_args()

    from dinounet_tpu_torch.evaluation.accumulate_cv_results import accumulate_cv_results
    from dinounet_tpu_torch.utilities.misc import (
        convert_identifier_to_trained_model_output_folder,
        maybe_convert_to_dataset_name,
    )

    dataset_name = maybe_convert_to_dataset_name(args.dataset_name_or_id)
    trained_model_folder = convert_identifier_to_trained_model_output_folder(
        dataset_name, args.tr, args.p, args.c)
    merged = args.o or os.path.join(
        trained_model_folder,
        f"crossval_results_folds_{folds_tuple_to_string(args.f)}")
    accumulate_cv_results(trained_model_folder, merged, args.f)
