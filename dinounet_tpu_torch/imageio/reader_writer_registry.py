"""File-ending -> reader/writer resolution.

Capability parity with ref: dinounet/imageio/reader_writer_registry.py:14-79.
The torch-stack class names (SimpleITKIO, NibabelIO, ...) stay valid aliases in
plans/dataset jsons; they resolve to the self-contained implementations here.

JAX-free copy of ``dinounet_tpu/imageio/reader_writer_registry.py``.
"""

from typing import Optional, Type

from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.imageio.natural_image import NaturalImage2DIO
from dinounet_tpu_torch.imageio.nifti import NiftiIO
from dinounet_tpu_torch.imageio.sitk_formats import SimpleITKIO, SitkFormatsIO
from dinounet_tpu_torch.imageio.tiff import Tiff3DIO
from dinounet_tpu_torch.utilities import registry

# native names
registry.image_readers.add("NiftiIO", NiftiIO)
registry.image_readers.add("NaturalImage2DIO", NaturalImage2DIO)
registry.image_readers.add("Tiff3DIO", Tiff3DIO)
registry.image_readers.add("SitkFormatsIO", SitkFormatsIO)
# reference aliases kept for plans/dataset.json compatibility; SimpleITKIO
# covers the reference's full ending set (.nii.gz/.nii/.nrrd/.mha) by
# per-extension delegation (ref simpleitk_reader_writer.py:23-27)
registry.image_readers.add("SimpleITKIO", SimpleITKIO)
registry.image_readers.add("NibabelIO", NiftiIO)
registry.image_readers.add("NibabelIOWithReorient", NiftiIO)

LIST_OF_IO_CLASSES = [NiftiIO, NaturalImage2DIO, Tiff3DIO, SitkFormatsIO]


def determine_reader_writer_from_dataset_json(
    dataset_json: dict, example_file: Optional[str] = None,
) -> Type[BaseReaderWriter]:
    if dataset_json.get("overwrite_image_reader_writer") not in (None, "None"):
        name = dataset_json["overwrite_image_reader_writer"]
        if name in registry.image_readers:
            return registry.image_readers.get(name)
    file_ending = dataset_json.get("file_ending")
    return determine_reader_writer_from_file_ending(file_ending, example_file)


def determine_reader_writer_from_file_ending(
    file_ending: str, example_file: Optional[str] = None,
) -> Type[BaseReaderWriter]:
    candidates = [
        cls for cls in LIST_OF_IO_CLASSES if file_ending in cls.supported_file_endings
    ]
    if not candidates:
        raise RuntimeError(f"No reader/writer supports file ending {file_ending}")
    if example_file is not None and len(candidates) > 1:
        for cls in candidates:
            try:
                cls().read_images((example_file,))
                return cls
            except Exception:
                continue
    return candidates[0]
