"""Usage examples for the prediction API (ref: dinounet/inference/examples.py).

Not executed by tests — copy/paste starting points mirroring the reference's
demo file, adapted to this framework's entry points. Strings only: the
port's counterpart of ``dinounet_tpu/inference/examples.py``.
"""

EXAMPLE_PREDICT_FROM_FILES = """
import os
from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch import paths

predictor = nnUNetPredictor(
    tile_step_size=0.5,
    use_gaussian=True,
    use_mirroring=True,
    device='cuda',
)
predictor.initialize_from_trained_model_folder(
    os.path.join(paths.nnUNet_results(),
                 'Dataset004_Hippocampus/DinoUNetTrainer_s__nnUNetPlans__2d'),
    use_folds=(0, 1, 2, 3, 4),
    checkpoint_name='checkpoint_final.pth',
)
predictor.predict_from_files(
    'INPUT_FOLDER', 'OUTPUT_FOLDER',
    save_probabilities=False, overwrite=False,
    num_processes_preprocessing=2, num_processes_segmentation_export=2,
)
"""

EXAMPLE_PREDICT_SINGLE_NPY = """
import numpy as np
from dinounet_tpu_torch.imageio.nifti import NiftiIO

img, props = NiftiIO().read_images(['case_0000.nii.gz'])
seg = predictor.predict_single_npy_array(img, props, None, None, False)
"""

EXAMPLE_CASCADE = """
# stage 1: predict with the lowres model into OUTPUT_LOWRES (as above), then:
predictor.predict_from_files(
    'INPUT_FOLDER', 'OUTPUT_CASCADE',
    folder_with_segs_from_prev_stage='OUTPUT_LOWRES',
)
"""

if __name__ == "__main__":
    print(EXAMPLE_PREDICT_FROM_FILES)
    print(EXAMPLE_PREDICT_SINGLE_NPY)
    print(EXAMPLE_CASCADE)
