"""Self-contained NIfTI-1/NIfTI-2 reader/writer (no nibabel/SimpleITK in this image).

Covers the capability of ref: dinounet/imageio/simpleitk_reader_writer.py:22 and
nibabel_reader_writer.py:24,100 for .nii/.nii.gz: header parsing (dim, datatype,
pixdim, scl slope/intercept, vox_offset, qform/sform) for **both NIfTI-1 (348-byte)
and NIfTI-2 (540-byte) headers in either byte order**,
**reorientation to the closest canonical (RAS) axis order** — the capability of
the reference's NibabelIOWithReorient (ref nibabel_reader_writer.py:100-160),
so mixed-orientation datasets land in one consistent (z, y, x) frame with
correctly-assigned per-axis spacing — and round-trip writing that restores the
original orientation and header geometry (the written segmentation overlays the
source image voxel-for-voxel, like the reference's write path which saves with
the original affine). Segmentations written against a NIfTI-2 source keep the
NIfTI-2 format and byte order; fresh volumes are written as little-endian NIfTI-1.

Array contract (nnU-Net convention, ref base_reader_writer.py:22-106):
(c, z, y, x) with spacing aligned to (z, y, x).

JAX-free copy of ``dinounet_tpu/imageio/nifti.py``, except that ``.nii.gz``
files are written at zlib level 1, nibabel's default (the reference's
NibabelIO), where the JAX package's writer takes gzip's 9: the same volume
when read, written many times faster (a noisy 256^3 segmentation 0.08 s
against 6.4 s on one core) in a file about twice as large.
"""

import gzip
import struct
from typing import List, Optional, Tuple, Union

import numpy as np

from dinounet_tpu_torch.imageio.base import BaseReaderWriter

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR1_SIZE = 348
_HDR2_SIZE = 540

# Field layout per header version: (offset, struct format). Formats use
# lowercase struct codes; endianness char is prepended at parse time.
_LAYOUT = {
    1: {
        "dim": (40, "8h"),
        "datatype": (70, "h"),
        "bitpix": (72, "h"),
        "pixdim": (76, "8f"),
        "vox_offset": (108, "f"),
        "scl_slope": (112, "f"),
        "scl_inter": (116, "f"),
        "qform_code": (252, "h"),
        "sform_code": (254, "h"),
        "quatern": (256, "3f"),
        "qoffset": (268, "3f"),
        "srow_x": (280, "4f"),
        "srow_y": (296, "4f"),
        "srow_z": (312, "4f"),
        "magic": (344, 4),
        "default_vox_offset": 352,
    },
    2: {
        "dim": (16, "8q"),
        "datatype": (12, "h"),
        "bitpix": (14, "h"),
        "pixdim": (104, "8d"),
        "vox_offset": (168, "q"),
        "scl_slope": (176, "d"),
        "scl_inter": (184, "d"),
        "qform_code": (344, "i"),
        "sform_code": (348, "i"),
        "quatern": (352, "3d"),
        "qoffset": (376, "3d"),
        "srow_x": (400, "4d"),
        "srow_y": (432, "4d"),
        "srow_z": (464, "4d"),
        "magic": (4, 8),
        "default_vox_offset": 544,
    },
}


def _open(fname: str, mode: str = "rb"):
    if fname.endswith(".gz"):
        return gzip.open(fname, mode, compresslevel=1)
    return open(fname, mode)


def _detect(hdr: bytes, fname: str = "<bytes>") -> Tuple[str, int]:
    """Detect (endianness, nifti version) from sizeof_hdr (348 or 540)."""
    for en in ("<", ">"):
        size = struct.unpack_from(en + "i", hdr, 0)[0]
        if size == _HDR1_SIZE:
            return en, 1
        if size == _HDR2_SIZE:
            return en, 2
    raise RuntimeError(
        f"{fname}: not a NIfTI file (sizeof_hdr is neither 348 nor 540 "
        f"in either byte order)")


def _header_endianness(hdr: bytes, fname: str = "<bytes>") -> str:
    return _detect(hdr, fname)[0]


def _parse_fields(hdr: bytes, fname: str = "<bytes>") -> dict:
    """Parse the geometry/data fields shared by NIfTI-1 and NIfTI-2 into a
    version-independent dict."""
    en, ver = _detect(hdr, fname)
    lay = _LAYOUT[ver]

    def get(name):
        off, fmt = lay[name]
        vals = struct.unpack_from(en + fmt, hdr, off)
        return vals[0] if len(vals) == 1 else vals

    moff, mlen = lay["magic"]
    magic = hdr[moff: moff + mlen]
    want = (b"n+1", b"ni1") if ver == 1 else (b"n+2", b"ni2")
    if magic[:3] not in want:
        raise RuntimeError(f"{fname}: bad NIfTI-{ver} magic {magic!r}")
    return {
        "endianness": en,
        "version": ver,
        "dim": tuple(int(d) for d in get("dim")),
        "datatype": int(get("datatype")),
        "pixdim": tuple(float(p) for p in get("pixdim")),
        "vox_offset": int(get("vox_offset")),
        "scl_slope": float(get("scl_slope")),
        "scl_inter": float(get("scl_inter")),
        "qform_code": int(get("qform_code")),
        "sform_code": int(get("sform_code")),
        "quatern": tuple(float(q) for q in get("quatern")),
        "qoffset": tuple(float(q) for q in get("qoffset")),
        "srows": (get("srow_x"), get("srow_y"), get("srow_z")),
    }


def _parse_affine(fields: dict) -> np.ndarray:
    """Voxel-index (i,j,k) -> world RAS (x,y,z) 4x4 affine from sform (code>0),
    else qform (quaternion), else the pixdim diagonal (NIfTI §3 fallback)."""
    pixdim = fields["pixdim"]
    if fields["sform_code"] > 0:
        A = np.eye(4)
        for i in range(3):
            A[i, :] = fields["srows"][i]
        return A
    if fields["qform_code"] > 0:
        b, c, d = fields["quatern"]
        ox, oy, oz = fields["qoffset"]
        a2 = 1.0 - (b * b + c * c + d * d)
        a = np.sqrt(max(a2, 0.0))
        R = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        scales = np.array([abs(pixdim[1]), abs(pixdim[2]), qfac * abs(pixdim[3])])
        A = np.eye(4)
        A[:3, :3] = R * scales[None, :]
        A[:3, 3] = (ox, oy, oz)
        return A
    A = np.eye(4)
    for j in range(3):
        A[j, j] = abs(pixdim[1 + j]) or 1.0
    return A


def _closest_canonical_ops(affine: np.ndarray):
    """Greedy io_orientation (as in nibabel): for each voxel axis j, the
    dominant world axis and its sign. Returns (perm_f, signs, spacing_f) where
    perm_f[w] = voxel axis whose direction is world axis w, signs[j] = +-1 for
    voxel axis j, and spacing_f[j] = voxel size along voxel axis j."""
    R = affine[:3, :3].astype(np.float64)
    spacing_f = np.linalg.norm(R, axis=0)
    Q = R.copy()
    world_of = [0, 1, 2]
    sign_of = [1, 1, 1]
    for _ in range(3):
        w, j = np.unravel_index(np.argmax(np.abs(Q)), Q.shape)
        world_of[j] = int(w)
        sign_of[j] = 1 if Q[w, j] >= 0 else -1
        Q[w, :] = 0.0
        Q[:, j] = 0.0
    perm_f = [0, 1, 2]
    for j, w in enumerate(world_of):
        perm_f[w] = j
    return tuple(perm_f), tuple(sign_of), spacing_f


def reorient_to_canonical(arr: np.ndarray, perm_f, signs) -> np.ndarray:
    """Reorder an (..., z, y, x) array so its voxel axes align with RAS
    (+x rightward ... stored as the usual reversed (z, y, x) C order)."""
    lead = arr.ndim - 3
    ax = list(range(lead)) + [lead + 2, lead + 1, lead + 0]
    a = arr.transpose(ax)  # fortran spatial order (..., i, j, k)
    for j in range(3):
        if signs[j] < 0:
            a = np.flip(a, axis=lead + j)
    a = a.transpose(list(range(lead)) + [lead + p for p in perm_f])
    return a.transpose(ax)


def reorient_from_canonical(arr: np.ndarray, perm_f, signs) -> np.ndarray:
    """Inverse of reorient_to_canonical."""
    lead = arr.ndim - 3
    ax = list(range(lead)) + [lead + 2, lead + 1, lead + 0]
    a = arr.transpose(ax)
    inv = [0, 0, 0]
    for w, p in enumerate(perm_f):
        inv[p] = w
    a = a.transpose(list(range(lead)) + [lead + inv[j] for j in range(3)])
    for j in range(3):
        if signs[j] < 0:
            a = np.flip(a, axis=lead + j)
    return a.transpose(ax)


def read_nifti(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (array with axes as stored on disk reversed to C-order (z, y, x),
    header dict incl. raw bytes, endianness, version, and the parsed affine).
    Handles NIfTI-1 and NIfTI-2 in either byte order; data is returned in
    native byte order."""
    with _open(fname) as f:
        raw = f.read()
    fields = _parse_fields(raw[:_HDR2_SIZE], fname)
    en, ver = fields["endianness"], fields["version"]
    hdr = raw[: _HDR1_SIZE if ver == 1 else _HDR2_SIZE]
    dim = fields["dim"]
    ndim = dim[0]
    shape_f = dim[1: 1 + ndim]  # Fortran-order shape (x, y, z, [t])
    datatype = fields["datatype"]
    pixdim = fields["pixdim"]
    vox_offset = fields["vox_offset"]
    scl_slope = fields["scl_slope"]
    scl_inter = fields["scl_inter"]
    if datatype not in _DTYPES:
        raise RuntimeError(f"{fname}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(en)

    count = int(np.prod(shape_f))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    if en == ">":
        data = data.astype(data.dtype.newbyteorder("="))
    # Fortran-ordered on disk; reshape with reversed axes to get C-order (…z, y, x)
    arr = data.reshape(shape_f[::-1])
    if np.isfinite(scl_slope) and np.isfinite(scl_inter) and (
            scl_slope not in (0.0, 1.0) or scl_inter != 0.0):
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr * slope + scl_inter

    header = {
        "raw_header": hdr,
        "endianness": en,
        "version": ver,
        "shape_fortran": tuple(int(s) for s in shape_f),
        "pixdim": pixdim,
        "datatype": datatype,
        "affine": _parse_affine(fields),
    }
    return arr, header


def _build_header(shape_f, spacing_xyz, dtype: np.dtype,
                  template: Optional[bytes] = None) -> bytes:
    """Minimal valid NIfTI header; reuses geometry (qform/sform, byte order,
    header version) from `template` if given, else little-endian NIfTI-1."""
    en, ver = _detect(template) if template is not None else ("<", 1)
    lay = _LAYOUT[ver]
    hdr = bytearray(template) if template is not None else bytearray(_HDR1_SIZE)
    if template is None:
        struct.pack_into(en + "i", hdr, 0, _HDR1_SIZE)
        hdr[38] = ord("r")  # dim_info irrelevant; regular
        # sform: identity scaled by spacing
        struct.pack_into(en + "h", hdr, 254, 1)  # sform_code = 1
        srows = (
            [float(spacing_xyz[0]), 0, 0, 0],
            [0, float(spacing_xyz[1]), 0, 0],
            [0, 0, float(spacing_xyz[2]) if len(spacing_xyz) > 2 else 1.0, 0],
        )
        for i, row in enumerate(srows):
            struct.pack_into(en + "4f", hdr, 280 + 16 * i, *row)
        hdr[344:348] = b"n+1\x00"
    ndim = len(shape_f)
    dim = [ndim] + [int(s) for s in shape_f] + [1] * (7 - ndim)
    struct.pack_into(en + lay["dim"][1], hdr, lay["dim"][0], *dim)
    code = _DTYPE_CODES[np.dtype(dtype)]
    struct.pack_into(en + lay["datatype"][1], hdr, lay["datatype"][0], code)
    struct.pack_into(en + lay["bitpix"][1], hdr, lay["bitpix"][0],
                     np.dtype(dtype).itemsize * 8)
    # preserve the template's qfac (pixdim[0]): a qform-only source with
    # qfac=-1 keeps its k-axis handedness — overwriting with +1 would flip
    # the quaternion-derived affine's third column
    qfac = 1.0
    if template is not None:
        tpl_qfac = struct.unpack_from(
            en + lay["pixdim"][1][-1], template, lay["pixdim"][0])[0]
        if tpl_qfac < 0:
            qfac = -1.0
    pixdim = [qfac] + [float(s) for s in spacing_xyz] + [1.0] * (7 - len(spacing_xyz))
    struct.pack_into(en + lay["pixdim"][1], hdr, lay["pixdim"][0], *pixdim[:8])
    off_fmt = lay["vox_offset"][1]
    off_val = lay["default_vox_offset"]
    struct.pack_into(en + off_fmt, hdr, lay["vox_offset"][0],
                     float(off_val) if off_fmt == "f" else off_val)
    struct.pack_into(en + lay["scl_slope"][1], hdr, lay["scl_slope"][0], 1.0)
    struct.pack_into(en + lay["scl_inter"][1], hdr, lay["scl_inter"][0], 0.0)
    return bytes(hdr)


def write_nifti(fname: str, arr: np.ndarray, spacing_xyz,
                template_header: Optional[bytes] = None):
    """arr is C-ordered (…, z, y, x); stored Fortran-ordered (x fastest).
    With a template header the data is written in the template's byte order
    and header version (NIfTI-1 or NIfTI-2)."""
    shape_f = arr.shape[::-1]
    hdr = _build_header(shape_f, spacing_xyz, arr.dtype, template_header)
    en = _header_endianness(hdr)
    out = np.ascontiguousarray(arr)
    if en == ">":
        out = out.astype(out.dtype.newbyteorder(">"))
    with _open(fname, "wb") as f:
        f.write(hdr)
        f.write(b"\x00" * 4)  # extension flag
        f.write(out.tobytes())


class NiftiIO(BaseReaderWriter):
    """nnU-Net-convention NIfTI IO with reorient-to-closest-canonical (see
    module docstring). Set class attr `reorient=False` for raw disk order."""

    supported_file_endings = [".nii.gz", ".nii"]
    reorient = True

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]) -> Tuple[np.ndarray, dict]:
        images, spacings, headers = [], [], []
        orientations = []
        for f in image_fnames:
            arr, hdr = read_nifti(f)
            pixdim = hdr["pixdim"]
            perm_f, signs = (0, 1, 2), (1, 1, 1)
            if arr.ndim == 2:
                sp = (max(abs(pixdim[1]), abs(pixdim[2])) * 999.0,
                      float(abs(pixdim[2])), float(abs(pixdim[1])))
                images.append(arr[None, None])
            elif arr.ndim in (3, 4):
                a = arr if arr.ndim == 4 else arr[None]
                if self.reorient:
                    perm_f, signs, spacing_f = _closest_canonical_ops(hdr["affine"])
                    a = reorient_to_canonical(a, perm_f, signs)
                    # canonical voxel axis w has the size of voxel axis perm_f[w];
                    # spacing listed (z, y, x) = world (S, A, R)
                    sp = (float(spacing_f[perm_f[2]]),
                          float(spacing_f[perm_f[1]]),
                          float(spacing_f[perm_f[0]]))
                else:
                    sp = (float(abs(pixdim[3])), float(abs(pixdim[2])),
                          float(abs(pixdim[1])))
                images.append(a)
            else:
                raise RuntimeError(f"Unexpected ndim {arr.ndim} in {f}")
            spacings.append(tuple(abs(s) for s in sp))
            headers.append(hdr)
            orientations.append((perm_f, signs))

        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Input images have mismatched shapes: {[i.shape for i in images]}")
        if not self._check_all_same_spacing(spacings):
            raise RuntimeError(f"Input images have mismatched spacings: {spacings}")
        if not self._check_all_same(orientations):
            raise RuntimeError(
                f"Input channels have mismatched orientations: {orientations}")

        stacked = np.vstack(images).astype(np.float32)
        props = {
            "spacing": list(spacings[0]),
            "nifti_header": headers[0]["raw_header"],
            "nifti_orientation": orientations[0],
        }
        return stacked, props

    def _check_all_same_spacing(self, spacings, tol=1e-4):
        ref = spacings[0]
        return all(len(s) == len(ref) and
                   all(abs(a - b) <= tol * max(1.0, abs(b)) for a, b in zip(s, ref))
                   for s in spacings)

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images((seg_fname,))

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3, "segmentation must be 3d; provide 2d as shape (1, x, y)"
        spacing = properties["spacing"]
        spacing_xyz = [float(spacing[2]), float(spacing[1]), float(spacing[0])]
        template = properties.get("nifti_header")
        arr = seg
        perm_f, signs = properties.get("nifti_orientation", ((0, 1, 2), (1, 1, 1)))
        tpl_ndim = None
        if template is not None:
            tpl_fields = _parse_fields(template)
            tpl_ndim = tpl_fields["dim"][0]
        if tpl_ndim == 2:
            # 2d sources were read as (1, x, y); orientation n/a
            arr = seg[0]
            spacing_xyz = spacing_xyz[:2]
        elif any(s < 0 for s in signs) or tuple(perm_f) != (0, 1, 2):
            # restore the source voxel order so the template's qform/sform
            # (kept verbatim) still describes the written array
            arr = reorient_from_canonical(arr, perm_f, signs)
            if template is not None:
                pixdim = tpl_fields["pixdim"]
                spacing_xyz = [abs(pixdim[1]), abs(pixdim[2]), abs(pixdim[3])]
        write_nifti(
            output_fname, np.ascontiguousarray(
                arr.astype(np.uint8 if seg.max() < 255 else np.uint16)),
            spacing_xyz, template_header=template,
        )
