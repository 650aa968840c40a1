"""Plan-and-preprocess orchestration.

Capability parity with ref: dinounet/experiment_planning/plan_and_preprocess_api.py
(:17-152): fingerprint extraction, experiment planning, preprocessing over
configurations, and the gt_segmentations copy used by evaluation; and the
four CLI entries (ref plan_and_preprocess_entrypoints.py): plan and
preprocess, extract the fingerprint, plan the experiment, preprocess.

JAX-free copy of ``dinounet_tpu/planning/plan_and_preprocess_api.py``: the
same fingerprints, plans files and preprocessed cases, bit for bit.
"""

import os
import shutil
from typing import List, Optional, Tuple, Union

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.planning.dataset_utils import get_filenames_of_train_images_and_targets
from dinounet_tpu_torch.planning.fingerprint import DatasetFingerprintExtractor
from dinounet_tpu_torch.planning.planner import ExperimentPlanner
from dinounet_tpu_torch.planning.verify import verify_dataset_integrity
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def extract_fingerprint_dataset(dataset_id: Union[int, str],
                                fingerprint_extractor_class=DatasetFingerprintExtractor,
                                num_processes: int = 8, check_dataset_integrity: bool = False,
                                clean: bool = True, verbose: bool = True) -> dict:
    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    if check_dataset_integrity:
        verify_dataset_integrity(os.path.join(paths.nnUNet_raw(), dataset_name), num_processes)
    fpe = fingerprint_extractor_class(dataset_id, num_processes, verbose=verbose)
    return fpe.run(overwrite_existing=clean)


def extract_fingerprints(dataset_ids: List[int], num_processes: int = 8,
                         check_dataset_integrity: bool = False, clean: bool = True,
                         verbose: bool = True):
    for d in dataset_ids:
        extract_fingerprint_dataset(
            d, num_processes=num_processes, check_dataset_integrity=check_dataset_integrity,
            clean=clean, verbose=verbose,
        )


def plan_experiment_dataset(dataset_id: Union[int, str],
                            experiment_planner_class=ExperimentPlanner,
                            gpu_memory_target_in_gb: Optional[float] = None,
                            preprocess_class_name: str = "DefaultPreprocessor",
                            overwrite_target_spacing=None,
                            overwrite_plans_name: Optional[str] = None,
                            force_target_shape=None, max_batch_size: int = 32,
                            force_n_stages: Optional[int] = None) -> Tuple[dict, str]:
    kwargs = {}
    if overwrite_plans_name is not None:
        kwargs["plans_name"] = overwrite_plans_name
    if gpu_memory_target_in_gb is not None:  # else the planner's own (8 GB; 24 ResEncL)
        kwargs["gpu_memory_target_in_gb"] = gpu_memory_target_in_gb
    planner = experiment_planner_class(
        dataset_id, preprocessor_name=preprocess_class_name,
        overwrite_target_spacing=(
            [float(i) for i in overwrite_target_spacing]
            if overwrite_target_spacing is not None else None
        ),
        force_target_shape=force_target_shape, max_batch_size=max_batch_size,
        force_n_stages=force_n_stages, **kwargs,
    )
    plans = planner.plan_experiment()
    return plans, planner.plans_identifier


def plan_experiments(dataset_ids: List[int], **kwargs):
    plans_identifier = None
    for d in dataset_ids:
        _, plans_identifier = plan_experiment_dataset(d, **kwargs)
    return plans_identifier


def preprocess_dataset(dataset_id: Union[int, str], plans_identifier: str = "nnUNetPlans",
                       configurations=("2d", "3d_fullres", "3d_lowres"),
                       num_processes=(8, 4, 8), verbose: bool = False) -> None:
    if isinstance(num_processes, int):
        num_processes = [num_processes]
    num_processes = list(num_processes)
    if len(num_processes) == 1:
        num_processes = num_processes * len(configurations)
    if len(num_processes) != len(configurations):
        raise RuntimeError(
            "num_processes must have length 1 or match the number of configurations"
        )

    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    plans_file = os.path.join(paths.nnUNet_preprocessed(), dataset_name,
                              plans_identifier + ".json")
    plans_manager = PlansManager(plans_file)
    for n, c in zip(num_processes, configurations):
        if c not in plans_manager.available_configurations:
            print(f"INFO: Configuration {c} not found in plans; skipping.")
            continue
        configuration_manager = plans_manager.get_configuration(c)
        preprocessor = configuration_manager.preprocessor_class(verbose=verbose)
        preprocessor.run(dataset_id, c, plans_identifier, num_processes=n)

    # copy gt segmentations for later evaluation (ref :134-142)
    gt_folder = os.path.join(paths.nnUNet_preprocessed(), dataset_name, "gt_segmentations")
    os.makedirs(gt_folder, exist_ok=True)
    dataset_json = load_json(os.path.join(paths.nnUNet_raw(), dataset_name, "dataset.json"))
    dataset = get_filenames_of_train_images_and_targets(
        os.path.join(paths.nnUNet_raw(), dataset_name), dataset_json
    )
    for k in dataset:
        dst = os.path.join(gt_folder, k + dataset_json["file_ending"])
        src = dataset[k]["label"]
        if not os.path.isfile(dst) or os.path.getmtime(src) > os.path.getmtime(dst):
            shutil.copy(src, dst)


def preprocess(dataset_ids: List[int], plans_identifier: str = "nnUNetPlans",
               configurations=("2d", "3d_fullres", "3d_lowres"),
               num_processes=(8, 4, 8), verbose: bool = False):
    for d in dataset_ids:
        preprocess_dataset(d, plans_identifier, configurations, num_processes, verbose)


def plan_and_preprocess_entry():
    """CLI (ref experiment_planning/plan_and_preprocess_entrypoints.py,
    nnUNetv2_plan_and_preprocess)."""
    import argparse

    import dinounet_tpu_torch.planning  # noqa: F401  (registers planners)
    from dinounet_tpu_torch.utilities import registry

    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", type=int, required=True, help="dataset ids")
    parser.add_argument("-fpe", type=str, default="DatasetFingerprintExtractor")
    parser.add_argument("-npfp", type=int, default=8,
                        help="processes for fingerprint extraction")
    parser.add_argument("--verify_dataset_integrity", action="store_true")
    parser.add_argument("--no_pp", action="store_true",
                        help="only fingerprint + plan, skip preprocessing")
    parser.add_argument("--clean", action="store_true",
                        help="re-extract the fingerprint even if one exists")
    parser.add_argument("-pl", type=str, default="ExperimentPlanner",
                        help="experiment planner class name")
    parser.add_argument("-gpu_memory_target", type=float, default=None,
                        help="GB the plans target (default: the planner's own)")
    parser.add_argument("-preprocessor_name", type=str, default="DefaultPreprocessor")
    parser.add_argument("-overwrite_target_spacing", nargs="+", default=None)
    parser.add_argument("-overwrite_plans_name", type=str, default=None)
    parser.add_argument("-c", nargs="+", type=str,
                        default=["2d", "3d_fullres", "3d_lowres"])
    parser.add_argument("-np", nargs="+", type=int, default=None)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    if args.fpe != "DatasetFingerprintExtractor":
        raise SystemExit(f"unknown fingerprint extractor {args.fpe!r} "
                         "(only DatasetFingerprintExtractor is built in)")
    extract_fingerprints(args.d, num_processes=args.npfp,
                         check_dataset_integrity=args.verify_dataset_integrity,
                         clean=args.clean, verbose=args.verbose)
    planner_class = registry.planners.get(args.pl)
    plans_identifier = plan_experiments(
        args.d, experiment_planner_class=planner_class,
        gpu_memory_target_in_gb=args.gpu_memory_target,
        preprocess_class_name=args.preprocessor_name,
        overwrite_target_spacing=args.overwrite_target_spacing,
        overwrite_plans_name=args.overwrite_plans_name,
    )
    if not args.no_pp:
        default_np = {"2d": 8, "3d_fullres": 4, "3d_lowres": 8}
        num_processes = args.np or [default_np.get(c, 4) for c in args.c]
        preprocess(args.d, plans_identifier, args.c, num_processes, args.verbose)



def extract_fingerprint_entry():
    """CLI (ref plan_and_preprocess_entrypoints.py:5-27,
    nnUNetv2_extract_fingerprint)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", type=int, required=True, help="dataset ids")
    parser.add_argument("-fpe", type=str, default="DatasetFingerprintExtractor")
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("--verify_dataset_integrity", action="store_true")
    parser.add_argument("--clean", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    args, _ = parser.parse_known_args()
    if args.fpe != "DatasetFingerprintExtractor":
        raise SystemExit(f"unknown fingerprint extractor {args.fpe!r} "
                         "(only DatasetFingerprintExtractor is built in)")
    extract_fingerprints(args.d, num_processes=args.np,
                         check_dataset_integrity=args.verify_dataset_integrity,
                         clean=args.clean, verbose=args.verbose)


def plan_experiment_entry():
    """CLI (ref plan_and_preprocess_entrypoints.py:30-66,
    nnUNetv2_plan_experiment)."""
    import argparse

    import dinounet_tpu_torch.planning  # noqa: F401  (registers planners)
    from dinounet_tpu_torch.utilities import registry

    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", type=int, required=True, help="dataset ids")
    parser.add_argument("-pl", type=str, default="ExperimentPlanner")
    parser.add_argument("-gpu_memory_target", type=float, default=None,
                        help="GB the plans target (default: the planner's own)")
    parser.add_argument("-preprocessor_name", type=str, default="DefaultPreprocessor")
    parser.add_argument("-overwrite_target_spacing", nargs="+", default=None)
    parser.add_argument("-overwrite_plans_name", type=str, default=None)
    args, _ = parser.parse_known_args()
    plan_experiments(
        args.d, experiment_planner_class=registry.planners.get(args.pl),
        gpu_memory_target_in_gb=args.gpu_memory_target,
        preprocess_class_name=args.preprocessor_name,
        overwrite_target_spacing=args.overwrite_target_spacing,
        overwrite_plans_name=args.overwrite_plans_name)


def preprocess_entry():
    """CLI (ref plan_and_preprocess_entrypoints.py:69-114, nnUNetv2_preprocess)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", type=int, required=True, help="dataset ids")
    parser.add_argument("-plans_name", type=str, default="nnUNetPlans")
    parser.add_argument("-c", nargs="+", type=str,
                        default=["2d", "3d_fullres", "3d_lowres"])
    parser.add_argument("-np", nargs="+", type=int, default=None)
    parser.add_argument("--verbose", action="store_true")
    args, _ = parser.parse_known_args()
    default_np = {"2d": 8, "3d_fullres": 4, "3d_lowres": 8}
    num_processes = args.np or [default_np.get(c, 4) for c in args.c]
    preprocess(args.d, args.plans_name, args.c, num_processes, args.verbose)


if __name__ == "__main__":
    plan_and_preprocess_entry()
