"""Pure-Python NRRD (.nrrd) and MetaImage (.mha) readers/writers.

Capability parity with the reference's SimpleITKIO
(ref: dinounet/imageio/simpleitk_reader_writer.py:22-130), which reads
.nii.gz/.nrrd/.mha through the SimpleITK C++ library. SimpleITK is not in
this image; both formats are simple text-header + raw/deflate-payload
containers, so they are parsed directly here.

Geometry conventions mirror SimpleITK so properties dicts are
interchangeable with the reference's:

- arrays come back index-ordered (z, y, x) (sitk.GetArrayFromImage order);
  both formats store the FIRST listed axis fastest-varying, i.e. the buffer
  reshapes to sizes[::-1] row-major;
- ``properties['sitk_stuff']`` carries (x, y, z)-ordered spacing/origin and
  the row-major 3x3 direction matrix exactly as sitk.GetSpacing/GetOrigin/
  GetDirection would return them;
- ``properties['spacing']`` is the nnU-Net (z, y, x) spacing (the
  reference's ``list(spacing)[::-1]`` with abs), 2-D encoded as
  ``(999 * max_spacing, y, x)`` per the base contract.

NRRD: teem format spec (http://teem.sourceforge.net/nrrd/format.html) —
``NRRD000X`` magic, ``field: value`` header lines terminated by a blank
line, payload raw or gzip. MetaImage: ITK MetaIO — ``Key = Value`` lines
terminated by ``ElementDataFile = LOCAL``, payload raw or zlib-deflate.

JAX-free copy of ``dinounet_tpu/imageio/sitk_formats.py``.
"""

import gzip
import os
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np

from dinounet_tpu_torch.imageio.base import BaseReaderWriter

# ---------------------------------------------------------------- NRRD

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "signed short int": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16,
    "unsigned short int": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "long long int": np.int64,
    "signed long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NRRD_TYPE_NAMES = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


def _parse_vector(s: str) -> Optional[np.ndarray]:
    s = s.strip()
    if s == "none":
        return None
    assert s.startswith("(") and s.endswith(")"), f"bad NRRD vector: {s!r}"
    return np.array([float(v) for v in s[1:-1].split(",")])


def _split_vectors(s: str) -> List[Optional[np.ndarray]]:
    """Split 'none (a,b,c) (d,e,f)' into per-axis vectors."""
    out, depth, cur = [], 0, ""
    for ch in s.strip():
        if ch == "(":
            depth += 1
        if ch == ")":
            depth -= 1
        if ch.isspace() and depth == 0:
            if cur:
                out.append(cur)
                cur = ""
        else:
            cur += ch
    if cur:
        out.append(cur)
    return [_parse_vector(v) for v in out]


def read_nrrd(fname: str) -> Tuple[np.ndarray, dict]:
    """-> (array indexed slowest-axis-first i.e. sizes[::-1], header dict)."""
    with open(fname, "rb") as f:
        blob = f.read()
    nl = blob.index(b"\n")
    magic = blob[:nl].strip()
    if not magic.startswith(b"NRRD"):
        raise RuntimeError(f"{fname}: not a NRRD file (magic {magic!r})")
    # header = lines up to the first blank line
    end = blob.index(b"\n\n") if b"\n\n" in blob else None
    if end is None:
        raise RuntimeError(f"{fname}: NRRD header not terminated")
    fields = {}
    for line in blob[nl + 1:end].decode("ascii", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":=" in line:  # key/value metadata — ignored
            continue
        k, _, v = line.partition(":")
        fields[k.strip().lower()] = v.strip()
    if "data file" in fields or "datafile" in fields:
        raise RuntimeError(f"{fname}: detached-header NRRD (.nhdr) is not "
                           "supported; use inline .nrrd")
    sizes = [int(v) for v in fields["sizes"].split()]
    dtype = np.dtype(_NRRD_TYPES[fields["type"].lower()])
    if dtype.itemsize > 1:
        endian = fields.get("endian", "little")
        dtype = dtype.newbyteorder("<" if endian == "little" else ">")
    enc = fields.get("encoding", "raw").lower()
    payload = blob[end + 2:]
    if enc in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif enc not in ("raw",):
        raise RuntimeError(f"{fname}: unsupported NRRD encoding {enc!r}")
    n = int(np.prod(sizes))
    arr = np.frombuffer(payload[:n * dtype.itemsize], dtype=dtype)
    if arr.size != n:
        raise RuntimeError(f"{fname}: payload has {arr.size} elements, "
                           f"sizes say {n}")
    # first listed axis fastest -> C-order reshape over reversed sizes
    arr = arr.reshape(sizes[::-1])

    dirs = _split_vectors(fields["space directions"]) \
        if "space directions" in fields else [None] * len(sizes)
    origin = _parse_vector(fields["space origin"]) \
        if "space origin" in fields else None
    spacings = fields.get("spacings")
    if spacings is not None:
        spacings = [None if v == "nan" else float(v)
                    for v in spacings.split()]
    header = {"sizes": sizes, "dirs": dirs, "origin": origin,
              "spacings": spacings}
    return arr, header


def write_nrrd(fname: str, arr: np.ndarray, spacing_xyz, origin_xyz=None,
               direction=None, compressed: bool = True) -> None:
    """arr indexed (z, y, x) (or (y, x) for 2-D); spacing/origin in
    (x, y, z) order; direction row-major 3x3 (or 2x2) as sitk returns it."""
    nd = arr.ndim
    sizes = list(arr.shape[::-1])
    spacing_xyz = list(spacing_xyz)[:nd]
    if direction is None:
        direction = np.eye(nd).ravel()
    d = np.asarray(direction, np.float64).reshape(nd, nd)
    # sitk direction is row-major with columns = axis cosines; NRRD's
    # per-axis space direction = column i * spacing i
    vecs = [tuple(d[:, i] * spacing_xyz[i]) for i in range(nd)]
    if origin_xyz is None:
        origin_xyz = (0.0,) * nd
    space = "left-posterior-superior" if nd == 3 else "right-anterior"
    lines = [
        "NRRD0005",
        "# produced by dinounet_tpu_torch.imageio.sitk_formats",
        f"type: {_NRRD_TYPE_NAMES[arr.dtype.newbyteorder('=')]}",
        f"dimension: {nd}",
        f"space: {space}",
        "sizes: " + " ".join(str(s) for s in sizes),
        "space directions: " + " ".join(
            "(" + ",".join(f"{v:.17g}" for v in vec) + ")" for vec in vecs),
        "kinds: " + " ".join(["domain"] * nd),
        "endian: little",
        f"encoding: {'gzip' if compressed else 'raw'}",
        "space origin: (" + ",".join(
            f"{float(v):.17g}" for v in list(origin_xyz)[:nd]) + ")",
    ]
    payload = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes()
    if compressed:
        payload = gzip.compress(payload, 6)
    with open(fname, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(payload)


# ---------------------------------------------------------------- MetaImage

_MET_TYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_TYPE_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read_mha(fname: str) -> Tuple[np.ndarray, dict]:
    """-> (array indexed slowest-axis-first, header dict)."""
    with open(fname, "rb") as f:
        blob = f.read()
    fields = {}
    pos = 0
    while True:
        nl = blob.index(b"\n", pos)
        line = blob[pos:nl].decode("ascii", "replace").strip()
        pos = nl + 1
        k, _, v = line.partition("=")
        k, v = k.strip(), v.strip()
        fields[k.lower()] = v
        if k.lower() == "elementdatafile":
            if v.upper() != "LOCAL":
                raise RuntimeError(f"{fname}: detached MetaImage data file "
                                   "is not supported; use inline .mha")
            break
    nd = int(fields["ndims"])
    sizes = [int(v) for v in fields["dimsize"].split()]
    assert len(sizes) == nd, (sizes, nd)
    dtype = np.dtype(_MET_TYPES[fields["elementtype"].upper()])
    if dtype.itemsize > 1:
        msb = fields.get("binarydatabyteordermsb",
                         fields.get("elementbyteordermsb", "false"))
        dtype = dtype.newbyteorder(">" if msb.lower() == "true" else "<")
    nch = int(fields.get("elementnumberofchannels", 1))
    payload = blob[pos:]
    if fields.get("compresseddata", "false").lower() == "true":
        payload = zlib.decompress(payload)
    n = int(np.prod(sizes)) * nch
    arr = np.frombuffer(payload[:n * dtype.itemsize], dtype=dtype)
    if arr.size != n:
        raise RuntimeError(f"{fname}: payload has {arr.size} elements, "
                           f"DimSize says {n}")
    shape = sizes[::-1] + ([nch] if nch > 1 else [])
    if nch > 1:
        # channels are fastest-varying in MetaIO
        arr = arr.reshape([*sizes[::-1], nch])
    else:
        arr = arr.reshape(shape)
    header = {
        "sizes": sizes,
        "spacing": [float(v) for v in fields.get(
            "elementspacing", fields.get("elementsize",
                                         " ".join(["1"] * nd))).split()],
        "origin": [float(v) for v in fields.get(
            "offset", fields.get("origin", fields.get(
                "position", " ".join(["0"] * nd)))).split()],
        "direction": [float(v) for v in fields.get(
            "transformmatrix", fields.get("orientation", " ".join(
                str(float(i == j)) for i in range(nd)
                for j in range(nd)))).split()],
        "channels": nch,
    }
    return arr, header


def write_mha(fname: str, arr: np.ndarray, spacing_xyz, origin_xyz=None,
              direction=None, compressed: bool = True) -> None:
    nd = arr.ndim
    sizes = list(arr.shape[::-1])
    if direction is None:
        direction = np.eye(nd).ravel()
    if origin_xyz is None:
        origin_xyz = (0.0,) * nd
    payload = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes()
    if compressed:
        raw_len = len(payload)
        payload = zlib.compress(payload, 6)
    lines = [
        "ObjectType = Image",
        f"NDims = {nd}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        lines.append(f"CompressedDataSize = {len(payload)}")
        del raw_len
    lines += [
        "TransformMatrix = " + " ".join(
            f"{float(v):.17g}" for v in np.asarray(direction).ravel()),
        "Offset = " + " ".join(
            f"{float(v):.17g}" for v in list(origin_xyz)[:nd]),
        "ElementSpacing = " + " ".join(
            f"{float(v):.17g}" for v in list(spacing_xyz)[:nd]),
        "DimSize = " + " ".join(str(s) for s in sizes),
        f"ElementType = {_MET_TYPE_NAMES[arr.dtype.newbyteorder('=')]}",
        "ElementDataFile = LOCAL",
    ]
    with open(fname, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(payload)


# ---------------------------------------------------------------- IO classes

def _geometry_from_nrrd(header: dict, nd_data: int):
    """-> ((x,y,z) spacing, origin, row-major direction, spatial_nd)."""
    dirs = header["dirs"]
    spatial = [i for i, v in enumerate(dirs) if v is not None]
    if not spatial:  # no space directions field: fall back to spacings/unit
        spatial = list(range(nd_data))
        sp = header.get("spacings") or [1.0] * nd_data
        spacing = [abs(float(s or 1.0)) for s in sp]
        nd = len(spatial)
        return spacing, [0.0] * nd, np.eye(nd).ravel().tolist(), spatial
    nd = len(spatial)
    spacing, cols = [], []
    for i in spatial:
        v = np.asarray(dirs[i], np.float64)[:nd]
        norm = float(np.linalg.norm(v))
        spacing.append(norm if norm > 0 else 1.0)
        cols.append(v / norm if norm > 0 else np.eye(nd)[:, len(cols)])
    direction = np.stack(cols, axis=1).ravel().tolist()  # row-major, sitk
    origin = header["origin"]
    origin = ([float(v) for v in origin[:nd]] if origin is not None
              else [0.0] * nd)
    return spacing, origin, direction, spatial


class SitkFormatsIO(BaseReaderWriter):
    """NRRD/MetaImage reader-writer with SimpleITKIO-compatible properties
    (ref: dinounet/imageio/simpleitk_reader_writer.py:22-130)."""

    supported_file_endings = [".nrrd", ".mha"]

    @staticmethod
    def _read_one(fname: str):
        """-> (npy (z, y, x) or (c, z, y, x), (x,y,z) spacing, origin,
        direction)."""
        ext = os.path.splitext(fname)[1].lower()
        if ext == ".nrrd":
            arr, header = read_nrrd(fname)
            spacing, origin, direction, spatial = _geometry_from_nrrd(
                header, arr.ndim)
            if len(spatial) != arr.ndim:
                # exactly one non-spatial axis = channels; move it first.
                # axis k of the listed sizes is axis (ndim-1-k) of arr
                non_spatial = [i for i in range(arr.ndim) if i not in spatial]
                if len(non_spatial) != 1:
                    raise RuntimeError(
                        f"{fname}: unsupported NRRD axis structure")
                arr = np.moveaxis(arr, arr.ndim - 1 - non_spatial[0], 0)
        elif ext == ".mha":
            arr, header = read_mha(fname)
            spacing = [abs(float(v)) for v in header["spacing"]]
            origin = header["origin"]
            direction = header["direction"]
            if header["channels"] > 1:
                arr = np.moveaxis(arr, -1, 0)
        else:
            raise RuntimeError(f"unsupported file ending: {fname}")
        return arr, tuple(spacing), tuple(origin), tuple(direction)

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        images, spacings, origins, directions, nn_spacings = [], [], [], [], []
        for f in image_fnames:
            npy, spacing, origin, direction = self._read_one(f)
            spacings.append(spacing)
            origins.append(origin)
            directions.append(direction)
            if npy.ndim == 2:
                npy = npy[None, None]
                nn_spacings.append(
                    (max(spacing) * 999, *list(spacing)[::-1]))
            elif npy.ndim == 3:
                npy = npy[None]
                nn_spacings.append(list(spacing)[::-1])
            elif npy.ndim == 4:
                nn_spacings.append(list(spacing)[::-1])
            else:
                raise RuntimeError(
                    f"unexpected number of dimensions {npy.ndim} in {f}")
            nn_spacings[-1] = [abs(float(v)) for v in nn_spacings[-1]]
            images.append(npy.astype(np.float32, copy=False))
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(
                f"input images have mismatched shapes: "
                f"{[i.shape for i in images]} ({list(image_fnames)})")
        if not self._check_all_same([list(s) for s in spacings]):
            raise RuntimeError(
                f"input images have mismatched spacings: {spacings} "
                f"({list(image_fnames)})")
        stacked = np.vstack(images)
        properties = {
            "sitk_stuff": {
                "spacing": spacings[0],
                "origin": origins[0],
                "direction": directions[0],
            },
            "spacing": nn_spacings[0],
        }
        return stacked.astype(np.float32, copy=False), properties

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images((seg_fname,))

    def write_seg(self, seg: np.ndarray, output_fname: str,
                  properties: dict) -> None:
        assert seg.ndim == 3, ("segmentation must be 3d; provide 2d as "
                               "shape (1, x, y)")
        stuff = properties.get("sitk_stuff")
        if stuff is None:
            # source was read by a different IO (e.g. NIfTI): reconstruct
            # (x, y, z) geometry from the nnU-Net (z, y, x) spacing
            sp = [float(v) for v in properties["spacing"]][::-1]
            if sp and sp[-1] > 900:  # 2-D dummy spacing
                sp = sp[:-1]
            stuff = {"spacing": tuple(sp), "origin": (0.0,) * len(sp),
                     "direction": tuple(np.eye(len(sp)).ravel())}
        nd = len(stuff["spacing"])
        assert 1 < nd < 4, nd
        arr = seg[0] if nd == 2 else seg
        arr = arr.astype(np.uint8 if seg.max() < 255 else np.uint16)
        writer = write_nrrd if output_fname.lower().endswith(".nrrd") \
            else write_mha
        writer(output_fname, arr, stuff["spacing"], stuff["origin"],
               stuff["direction"], compressed=True)


class SimpleITKIO(BaseReaderWriter):
    """Name-compatible stand-in for the reference's SimpleITKIO: one class
    covering .nii.gz/.nii/.nrrd/.mha by delegating per file extension
    (NIfTI -> imageio.nifti.NiftiIO, NRRD/MetaImage -> SitkFormatsIO)."""

    supported_file_endings = [".nii.gz", ".nii", ".nrrd", ".mha"]

    @staticmethod
    def _io_for(fname: str) -> BaseReaderWriter:
        low = fname.lower()
        if low.endswith(".nrrd") or low.endswith(".mha"):
            return SitkFormatsIO()
        from dinounet_tpu_torch.imageio.nifti import NiftiIO

        return NiftiIO()

    def read_images(self, image_fnames):
        return self._io_for(image_fnames[0]).read_images(image_fnames)

    def read_seg(self, seg_fname: str):
        return self._io_for(seg_fname).read_seg(seg_fname)

    def write_seg(self, seg, output_fname: str, properties: dict) -> None:
        # route on the TARGET extension; fall back to the source format's
        # properties when they disagree (sitk_stuff vs nifti_header)
        io = self._io_for(output_fname)
        io.write_seg(seg, output_fname, properties)
