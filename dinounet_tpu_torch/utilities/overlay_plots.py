"""Image+segmentation overlay PNGs for dataset inspection.

Capability parity with ref: dinounet/utilities/overlay_plots.py:53-180:
color-cycle overlays of the most-foreground slice of each case, from raw files
or preprocessed .npz cases, fanned out over a thread pool (the reference uses
a spawn pool; the work is numpy + matplotlib imsave, thread-friendly).

JAX-free copy of ``dinounet_tpu/utilities/overlay_plots.py``; matplotlib is
imported only where a PNG is written.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import default_num_processes
from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_dataset_json,
)
from dinounet_tpu_torch.planning.dataset_utils import (
    get_filenames_of_train_images_and_targets,
)
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name

color_cycle = (
    "000000", "4363d8", "f58231", "3cb44b", "e6194B", "911eb4", "ffe119",
    "bfef45", "42d4f4", "f032e6", "000075", "9A6324", "808000", "800000",
    "469990",
)


def hex_to_rgb(h: str) -> Tuple[int, int, int]:
    assert len(h) == 6
    return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))


def generate_overlay(input_image: np.ndarray, segmentation: np.ndarray,
                     mapping: Optional[dict] = None,
                     colors: Tuple[str, ...] = color_cycle,
                     overlay_intensity: float = 0.6) -> np.ndarray:
    """2-D greyscale (or HxWx1) image + same-shape label map -> uint8 RGB."""
    image = np.copy(input_image).astype(np.float64)
    if image.ndim == 2:
        image = np.tile(image[:, :, None], (1, 1, 3))
    elif image.ndim == 3 and image.shape[2] == 1:
        image = np.tile(image, (1, 1, 3))
    else:
        raise RuntimeError(f"only 2D (grey) images are supported, got {image.shape}")

    image -= image.min()
    mx = image.max()
    if mx > 0:
        image = image / mx * 255

    if mapping is None:
        uniques = np.sort(np.unique(segmentation))
        mapping = {int(i): c for c, i in enumerate(uniques)}
    for label, cidx in mapping.items():
        image[segmentation == label] += (
            overlay_intensity * np.array(hex_to_rgb(colors[cidx % len(colors)])))

    mx = image.max()
    if mx > 0:
        image = image / mx * 255
    return image.astype(np.uint8)


def select_slice_to_plot(image: np.ndarray, segmentation: np.ndarray) -> int:
    """Slice with the most foreground voxels (any label)."""
    return int(np.argmax((segmentation != 0).sum((1, 2))))


def select_slice_to_plot2(image: np.ndarray, segmentation: np.ndarray) -> int:
    """Slice with the highest mean per-class foreground fraction (ref :113-127)."""
    classes = [i for i in np.sort(np.unique(segmentation)) if i != 0]
    if not classes:
        return image.shape[0] // 2
    fg_per_slice = np.zeros((image.shape[0], len(classes)))
    for i, c in enumerate(classes):
        fg = (segmentation == c).sum((1, 2)).astype(np.float64)
        total = fg.sum()
        fg_per_slice[:, i] = fg / total if total > 0 else 0
    return int(np.argmax(fg_per_slice.mean(1)))


def plot_overlay(image_file: str, segmentation_file: str,
                 image_reader_writer: BaseReaderWriter, output_file: str,
                 overlay_intensity: float = 0.6) -> None:
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    image, _ = image_reader_writer.read_images((image_file,))
    image = image[0]
    seg, _ = image_reader_writer.read_seg(segmentation_file)
    seg = seg[0]
    assert image.shape == seg.shape, (
        f"image and seg shapes differ: {image_file} vs {segmentation_file}")
    sl = select_slice_to_plot2(image, seg)
    plt.imsave(output_file,
               generate_overlay(image[sl], seg[sl],
                                overlay_intensity=overlay_intensity))


def plot_overlay_preprocessed(case_file: str, output_file: str,
                              overlay_intensity: float = 0.6,
                              channel_idx: int = 0) -> None:
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    with np.load(case_file) as npz:
        data = npz["data"]
        seg = npz["seg"][0]
    assert channel_idx < data.shape[0]
    image = data[channel_idx]
    seg = np.where(seg < 0, 0, seg)
    sl = select_slice_to_plot2(image, seg)
    plt.imsave(output_file,
               generate_overlay(image[sl], seg[sl],
                                overlay_intensity=overlay_intensity))


def generate_overlays_from_raw(dataset_name_or_id, output_folder: str,
                               num_processes: int = default_num_processes,
                               overlay_intensity: float = 0.6) -> None:
    """ref :183-205 (thread pool instead of spawn pool)."""
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    folder = os.path.join(paths.nnUNet_raw(), dataset_name)
    dataset_json = load_json(os.path.join(folder, "dataset.json"))
    dataset = get_filenames_of_train_images_and_targets(folder, dataset_json)
    rw = determine_reader_writer_from_dataset_json(dataset_json)()

    os.makedirs(output_folder, exist_ok=True)
    jobs = [(v["images"][0], v["label"], rw,
             os.path.join(output_folder, k + ".png"), overlay_intensity)
            for k, v in dataset.items()]
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        list(pool.map(lambda j: plot_overlay(*j), jobs))


def generate_overlays_from_preprocessed(dataset_name_or_id, output_folder: str,
                                        num_processes: int = default_num_processes,
                                        plans_identifier: str = "nnUNetPlans",
                                        configuration: str = "3d_fullres",
                                        overlay_intensity: float = 0.6,
                                        channel_idx: int = 0) -> None:
    """ref :208-235."""
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    folder = os.path.join(paths.nnUNet_preprocessed(), dataset_name)
    plans_manager = PlansManager(
        load_json(os.path.join(folder, plans_identifier + ".json")))
    cfg = plans_manager.get_configuration(configuration)
    data_folder = os.path.join(folder, cfg.data_identifier)
    if not os.path.isdir(data_folder):
        raise RuntimeError("run preprocessing for this configuration first")
    case_files = sorted(f for f in os.listdir(data_folder) if f.endswith(".npz"))

    os.makedirs(output_folder, exist_ok=True)
    jobs = [(os.path.join(data_folder, f),
             os.path.join(output_folder, f[:-4] + ".png"), overlay_intensity,
             channel_idx)
            for f in case_files]
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        list(pool.map(lambda j: plot_overlay_preprocessed(*j), jobs))


def entry_point_plot_overlay_pngs():
    """CLI (ref :238-262, nnUNetv2_plot_overlay_pngs)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_name_or_id", type=str)
    parser.add_argument("-o", type=str, required=True, help="output folder")
    parser.add_argument("-np", type=int, default=default_num_processes)
    parser.add_argument("-channel_idx", type=int, default=0)
    parser.add_argument("--use_raw", action="store_true")
    parser.add_argument("-p", type=str, default="nnUNetPlans")
    parser.add_argument("-c", type=str, default="3d_fullres")
    parser.add_argument("-overlay_intensity", type=float, default=0.6)
    args = parser.parse_args()
    if args.use_raw:
        generate_overlays_from_raw(args.dataset_name_or_id, args.o,
                                   num_processes=args.np,
                                   overlay_intensity=args.overlay_intensity)
    else:
        generate_overlays_from_preprocessed(
            args.dataset_name_or_id, args.o, num_processes=args.np,
            plans_identifier=args.p, configuration=args.c,
            overlay_intensity=args.overlay_intensity,
            channel_idx=args.channel_idx)


if __name__ == "__main__":
    entry_point_plot_overlay_pngs()


# reference CLI name (ref utilities/overlay_plots.py:243)
entry_point_generate_overlay = entry_point_plot_overlay_pngs
