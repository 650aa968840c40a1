"""Preprocessing iterators for inference — the reference's public generator API.

Capability parity with ref: dinounet/inference/data_iterators.py:17-230
(`preprocessing_iterator_fromfiles` / `preprocessing_iterator_fromnpy`): yield
{'data', 'data_properties', 'ofile'} per case, preprocessed ahead of the
consumer by background workers with bounded buffering and dead-worker
detection.

Redesign: the reference spawns one PROCESS per worker with size-1
Manager queues (its numpy preprocessing holds the GIL). Here workers are
threads — numpy/scipy release the GIL for the heavy math — feeding one bounded
queue; a sentinel-or-exception protocol replaces the done/abort event pair.
The predictor uses the same machinery internally; these functions are the
standalone composable surface for users who build their own loops (the
reference documents that pattern in inference/readme.md).

JAX-free copy of ``dinounet_tpu/inference/data_iterators.py``.
"""

from typing import List, Union

import numpy as np

from dinounet_tpu_torch.utilities.label_handling import convert_labelmap_to_one_hot
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


class _WorkerFailed(Exception):
    pass


def _iterate(jobs, worker_fn, num_workers: int, buffer: int):
    """Run worker_fn(job) across a thread pool, yielding results in job order
    with at most `buffer` finished items ahead of the consumer."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    jobs = deque(jobs)
    if not jobs:
        return
    n_workers = max(1, min(num_workers, len(jobs)))
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        inflight = deque()
        while jobs and len(inflight) < n_workers + buffer:
            inflight.append(pool.submit(worker_fn, jobs.popleft()))
        while inflight:
            fut = inflight.popleft()  # jobs submitted and yielded in order
            try:
                item = fut.result()
            except Exception as e:  # a dead worker aborts the iteration
                raise _WorkerFailed(
                    "Background preprocessing worker died. Look for the "
                    "error message above (or reduce workers if RAM was "
                    "exhausted).") from e
            while jobs and len(inflight) < n_workers + buffer:
                inflight.append(pool.submit(worker_fn, jobs.popleft()))
            yield item


def preprocessing_iterator_fromfiles(
        list_of_lists: List[List[str]],
        list_of_segs_from_prev_stage_files: Union[None, List[str]],
        output_filenames_truncated: Union[None, List[str]],
        plans_manager: PlansManager,
        dataset_json: dict,
        configuration_manager,
        num_processes: int = 3,
        pin_memory: bool = False,  # accepted for API parity; unused
        verbose: bool = False):
    """ref data_iterators.py:61-119. Yields {'data' (np float32 (C, Z, Y, X),
    prev-stage seg one-hot appended for cascades), 'data_properties', 'ofile'}."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    preprocessor = configuration_manager.preprocessor_class(verbose=verbose)

    def prep(job):
        image_files, seg_file, ofile = job
        data, seg, props = preprocessor.run_case(
            image_files, seg_file, plans_manager, configuration_manager,
            dataset_json)
        if seg_file is not None:
            onehot = convert_labelmap_to_one_hot(
                seg[0], label_manager.foreground_labels, data.dtype)
            data = np.vstack((data, onehot))
        return {"data": np.ascontiguousarray(data, dtype=np.float32),
                "data_properties": props, "ofile": ofile}

    n = len(list_of_lists)
    segs = list_of_segs_from_prev_stage_files or [None] * n
    ofiles = output_filenames_truncated or [None] * n
    yield from _iterate(zip(list_of_lists, segs, ofiles), prep,
                        num_processes, buffer=1)


def preprocessing_iterator_fromnpy(
        list_of_images: List[np.ndarray],
        list_of_segs_from_prev_stage: Union[None, List[np.ndarray]],
        list_of_image_properties: List[dict],
        truncated_ofnames: Union[None, List[str]],
        plans_manager: PlansManager,
        dataset_json: dict,
        configuration_manager,
        num_processes: int = 3,
        pin_memory: bool = False,
        verbose: bool = False):
    """ref data_iterators.py:121-230 equivalent for in-memory arrays."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    preprocessor = configuration_manager.preprocessor_class(verbose=verbose)

    def prep(job):
        img, seg_prev, props, ofile = job
        props = dict(props)
        data, seg = preprocessor.run_case_npy(
            np.copy(img), np.copy(seg_prev) if seg_prev is not None else None,
            props, plans_manager, configuration_manager, dataset_json)
        if seg_prev is not None:
            onehot = convert_labelmap_to_one_hot(
                seg[0], label_manager.foreground_labels, data.dtype)
            data = np.vstack((data, onehot))
        return {"data": np.ascontiguousarray(data, dtype=np.float32),
                "data_properties": props, "ofile": ofile}

    n = len(list_of_images)
    segs = list_of_segs_from_prev_stage or [None] * n
    ofiles = truncated_ofnames or [None] * n
    yield from _iterate(zip(list_of_images, segs, list_of_image_properties,
                            ofiles), prep, num_processes, buffer=1)
