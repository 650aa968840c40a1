"""Weight bridges into this port's state_dict names.

The port's names are the reference torch model's, the ones the JAX
package's torch -> flax converters read, so a published DINOv3 checkpoint's
backbone keys are already the port's (below
``encoder.dinov3_adapter.backbone.``). Three readers:

``state_dict_from_flax(variables)`` takes the ``{"params", "batch_stats"}``
tree of ``dinounet_tpu.models.dinounet.DinoUNet``, or of the plans' networks
``plain_unet.PlainConvUNet`` and ``residual_unet.ResidualEncoderUNet`` in 2-D
or 3-D (numpy arrays, or anything ``np.asarray`` reads), and returns the
port's state_dict of the same network; BatchNorm running statistics come
from ``batch_stats``. The
backbone may come in either of the JAX package's block layouts: unrolled
(``block{i}/...``) or scanned (``blocks_scan/block/...``, every leaf with a
leading depth axis: the tree its ``nn.scan`` builds at depth >=
``vit_scan_threshold()``, which is the ViT-7B's), unstacked here into
``blocks.{i}.*``; the port itself loops over its blocks. Three layout
changes:

  Dense          kernel (in, out)          -> weight (out, in)
  Conv           kernel (k..., Ci, Co)     -> weight (Co, Ci, k...)
  ConvTranspose  kernel (k..., Ci, Co)     -> weight (Ci, Co, k...), taps
                 flipped in every spatial axis (flax's conv_transpose
                 correlates with the spatially flipped kernel)

``load_dinov3_backbone_(backbone, path, model_name)`` fills a ``DinoViT``
from a DINOv3 backbone file, the counterpart of the JAX package's
``convert_torch_checkpoint`` + ``load_dinov3_params_into``
(``dinounet_tpu/models/convert.py:222-261,324-356``): a published ``.pth``
(read mmapped: ``backbone_state_dict_from_dinov3`` keeps its names, folds
``bias_mask`` into the qkv bias, drops ``IGNORED_CHECKPOINT_KEYS``), checked
against ``checkpoint_manifest.json`` when the backbone has a published size;
or the JAX package's converted ``.msgpack`` (``load_backbone_params``: flax's
msgpack format, unrolled or scanned, arrays over 1 GiB chunked, read through
an ``mmap`` by ``compression/minimsgpack.py``). Every shape is checked
before anything is copied; then each tensor is copied on its own into the
module's parameter, on that parameter's device and in its dtype. No copy of
the whole backbone exists on the host: a bf16 file stays bf16 from the
page cache to the card.

``python -m dinounet_tpu_torch.models.convert <pth> <model_name>
--verify-only`` checks a downloaded ``.pth`` against the manifest, as the
JAX CLI's ``--verify-only`` does. The JAX CLI's conversion to ``.msgpack``
has no counterpart: the port reads the ``.pth`` itself.
"""

import dataclasses
import json
import math
import mmap
import os
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dinounet_tpu_torch.compression.minimsgpack import Ext, unpack_from
from dinounet_tpu_torch.models.vit import VIT_CONFIGS, ViTConfig
from dinounet_tpu_torch.parallel.sharding import shard_state_dict

# (flax module path pattern, torch module path), per top-level subtree
_RULES = {
    "backbone": ("encoder.dinov3_adapter.backbone", [
        (r"^block(\d+)", r"blocks.\1"),
        (r"^patch_embed$", "patch_embed.proj"),
    ]),
    "adapter": ("encoder.dinov3_adapter", [
        (r"^spm/stem1_conv$", "spm.stem.0"), (r"^spm/stem1_bn$", "spm.stem.1"),
        (r"^spm/stem2_conv$", "spm.stem.3"), (r"^spm/stem2_bn$", "spm.stem.4"),
        (r"^spm/stem3_conv$", "spm.stem.6"), (r"^spm/stem3_bn$", "spm.stem.7"),
        (r"^spm/conv(\d)_conv$", r"spm.conv\1.0"),
        (r"^spm/conv(\d)_bn$", r"spm.conv\1.1"),
        (r"^interaction(\d+)/extractor1", r"interactions.\1.extra_extractors.0"),
        (r"^interaction(\d+)/extractor2", r"interactions.\1.extra_extractors.1"),
        (r"^interaction(\d+)/extractor", r"interactions.\1.extractor"),
        (r"^up/transpconv$", "up"),
        (r"^out_norm(\d)$", r"norm\1"),
    ]),
    "encoder": ("encoder", [
        (r"^fapm/specific_basis(\d+)$", r"fapm.specific_bases.\1"),
        (r"^fapm/film(\d+)$", r"fapm.film_generators.\1"),
        (r"^fapm/reduce_norm(\d+)/norm$", r"fapm.refinement_blocks.\1.1"),
        (r"^fapm/reduce(\d+)$", r"fapm.refinement_blocks.\1.0"),
        (r"^fapm/dwsep(\d+)/norm/norm$", r"fapm.refinement_blocks.\1.3.bn"),
        (r"^fapm/dwsep(\d+)", r"fapm.refinement_blocks.\1.3"),
        (r"^fapm/refine(\d+)$", r"fapm.refinement_blocks.\1.4"),
        (r"^fapm/se(\d+)/fc1$", r"fapm.refinement_blocks.\1.5.fc.0"),
        (r"^fapm/se(\d+)/fc2$", r"fapm.refinement_blocks.\1.5.fc.2"),
        (r"^fapm/shortcut(\d+)$", r"fapm.shortcut_projections.\1"),
        (r"^up(\d+)/up2/transpconv$", r"ups.\1.up2"),
    ]),
    "decoder": ("decoder", [
        (r"^transpconv(\d+)/transpconv$", r"transpconvs.\1"),
        (r"^stage(\d+)/conv(\d+)/norm/norm$", r"stages.\1.convs.\2.norm"),
        (r"^stage(\d+)/conv(\d+)/conv$", r"stages.\1.convs.\2.conv"),
        (r"^seg(\d+)$", r"seg_layers.\1"),
    ]),
}
# the plans' networks (PlainConvUNet, ResidualEncoderUNet): one top-level
# subtree per encoder stage or block, named by its indices
_STAGE_TOPS = [
    (r"^enc(\d+)$", r"encoder.stages.\1.0", [
        (r"^conv(\d+)/norm/norm$", r"convs.\1.norm"),
        (r"^conv(\d+)/conv$", r"convs.\1.conv"),
    ]),
    (r"^enc(\d+)_block(\d+)$", r"encoder.stages.\1.blocks.\2", [
        (r"^conv(\d)$", r"conv\1.conv"), (r"^norm(\d)/norm$", r"conv\1.norm"),
        (r"^proj$", "skip.conv"), (r"^proj_norm/norm$", "skip.norm"),
    ]),
]
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "", cast: bool = True) -> Dict[str, np.ndarray]:
    """Leaves by their '/'-joined paths; fp32 numpy arrays with `cast`, else
    as they are."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path, cast))
        else:
            out[path] = np.asarray(v, np.float32) if cast else v
    return out


def _unstack_scan(tree: Mapping, cast: bool = True) -> Mapping:
    """A backbone tree in the scanned layout -> the unrolled one (the tree
    itself when it is unrolled already). Each block's leaf is `leaf[i]`: a
    view, for numpy arrays and tensors alike."""
    if "blocks_scan" not in tree:
        return tree
    stacked = _flatten(tree["blocks_scan"]["block"], cast=cast)
    depth = next(iter(stacked.values())).shape[0]
    out = {k: v for k, v in tree.items() if k != "blocks_scan"}
    for i in range(depth):
        out[f"block{i}"] = {path: leaf[i] for path, leaf in stacked.items()}
    return out


def _top_rules(top: str):
    """(torch prefix, module rules) of a top-level flax subtree."""
    if top in _RULES:
        return _RULES[top]
    for pattern, prefix, rules in _STAGE_TOPS:
        if re.match(pattern, top):
            return re.sub(pattern, prefix, top), rules
    raise KeyError(f"no torch names for the flax subtree {top!r}")


def _torch_name(top: str, path: str) -> str:
    """flax path below `top` (e.g. "block3/attn/qkv/kernel") -> torch name."""
    prefix, rules = _top_rules(top)
    module, _, leaf = path.rpartition("/")
    if leaf.endswith("_gamma"):  # LayerScale: block3/ls1_gamma -> blocks.3.ls1.gamma
        module, leaf = f"{module}/{leaf[:-len('_gamma')]}", "gamma"
    elif not module:  # cls_token, storage_tokens, level_embed
        return f"{prefix}.{leaf}"
    for pattern, repl in rules:
        module, n = re.subn(pattern, repl, module, count=1)
        if n:
            break
    name = _LEAF_NAMES.get(leaf, leaf)
    return f"{prefix}.{module.replace('/', '.')}.{name}"


def _permute(leaf, axes):
    return leaf.permute(*axes) if isinstance(leaf, torch.Tensor) else leaf.transpose(axes)


def _torch_layout(path: str, leaf):
    """A flax leaf (numpy array or tensor) -> the torch layout, as a view
    where the leaf allows one. Convs of 2 or 3 spatial dims alike."""
    if not path.endswith("/kernel"):
        return leaf
    if leaf.ndim == 2:
        return leaf.T
    spatial = tuple(range(leaf.ndim - 2))
    ci, co = leaf.ndim - 2, leaf.ndim - 1
    if "transpconv" in path:
        if isinstance(leaf, torch.Tensor):
            flipped = leaf.flip(spatial)
        else:
            flipped = leaf[(slice(None, None, -1),) * len(spatial)]
        return _permute(flipped, (ci, co) + spatial)
    return _permute(leaf, (co, ci) + spatial)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DinoUNet, PlainConvUNet or ResidualEncoderUNet variables -> the
    port's state_dict of the same network (fp32 tensors), 2-D or 3-D."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for top, tree in variables.get(collection, {}).items():
            if top == "backbone":
                tree = _unstack_scan(tree)
            for path, leaf in _flatten(tree).items():
                name = _torch_name(top, path)
                sd[name] = torch.from_numpy(
                    np.ascontiguousarray(_torch_layout(path, leaf)))
                if name.endswith(".running_mean"):
                    sd[name[:-len("running_mean")] + "num_batches_tracked"] = (
                        torch.tensor(0, dtype=torch.long))
    return sd


# ------------------------------------------------- published DINOv3 backbones

# State-dict keys that are legitimately NOT converted:
#   mask_token        — SSL masking only, never used on the DinoUNet path
#   rope_embed.periods — recomputed analytically (verified equal, test_vit_parity)
#   local_cls_norm.*  — untied local-crop cls norm (7B/SAT-L); the adapter path
#                       goes through get_intermediate_layers, which applies the
#                       global `norm` (ref vision_transformer.py:281-318)
IGNORED_CHECKPOINT_KEYS = ("mask_token", "rope_embed.periods",
                           "local_cls_norm.weight", "local_cls_norm.bias")

_MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "checkpoint_manifest.json")


def checkpoint_manifest(model_name: str) -> Dict[str, list]:
    """Golden key→shape map of the published checkpoint for `model_name`
    (a copy of the JAX package's file, generated from the reference model
    definitions; hyperparams from ref hub/backbones.py:201-237,279-317,
    318-373,452-494)."""
    with open(_MANIFEST_PATH) as f:
        manifest = json.load(f)
    if model_name not in manifest:
        raise KeyError(f"no manifest for {model_name}; have {sorted(manifest)}")
    return manifest[model_name]


def verify_state_dict_against_manifest(
        shapes: Mapping[str, Sequence[int]], model_name: str) -> None:
    """Validate a checkpoint's key/shape table against the golden manifest.

    `shapes`: key -> shape (e.g. {k: v.shape for k, v in state_dict.items()}).
    Raises ValueError listing missing / unexpected / mis-shaped keys, so a
    broken or truncated download is caught before conversion."""
    expected = checkpoint_manifest(model_name)
    missing = sorted(set(expected) - set(shapes))
    unexpected = sorted(set(shapes) - set(expected))
    mis_shaped = sorted(
        k for k in set(expected) & set(shapes)
        if list(shapes[k]) != list(expected[k]))
    if missing or unexpected or mis_shaped:
        msgs = []
        if missing:
            msgs.append(f"missing keys: {missing[:10]}{'...' if len(missing) > 10 else ''}")
        if unexpected:
            msgs.append(f"unexpected keys: {unexpected[:10]}{'...' if len(unexpected) > 10 else ''}")
        if mis_shaped:
            msgs.append("mis-shaped: " + ", ".join(
                f"{k} {list(shapes[k])}!={expected[k]}" for k in mis_shaped[:10]))
        raise ValueError(
            f"checkpoint does not match the published {model_name} layout: "
            + "; ".join(msgs))


def published_name(cfg: ViTConfig) -> Optional[str]:
    """The published checkpoint whose backbone `cfg` is (any compute dtype),
    or None."""
    return next((name for name, c in VIT_CONFIGS.items()
                 if dataclasses.replace(c, dtype=cfg.dtype) == cfg), None)


def backbone_state_dict_from_dinov3(sd: Mapping[str, torch.Tensor], cfg: ViTConfig,
                                   strict: bool = False) -> Dict[str, torch.Tensor]:
    """Published DINOv3 state dict -> the port's backbone state_dict, taking
    what ``convert_dinov3_state_dict`` (JAX ``models/convert.py:101-156``)
    takes. The names stay; each tensor is `sd`'s own (an mmapped one stays
    mapped), except the qkv bias, multiplied by ``attn.qkv.bias_mask``
    (the reference's ``mask_k_bias``: 0 over the k section) when the mask is
    all finite. A NaN mask (never initialised) leaves the bias as it is, as
    the JAX converter does. ``IGNORED_CHECKPOINT_KEYS`` are dropped; with
    `strict` any other key left over raises ValueError."""
    used, out = set(), {}

    def take(name: str) -> None:
        used.add(name)
        out[name] = sd[name]

    def dense(name: str, use_bias: bool = True) -> None:
        take(name + ".weight")
        if use_bias and name + ".bias" in sd:
            take(name + ".bias")

    take("patch_embed.proj.weight")
    take("patch_embed.proj.bias")
    take("cls_token")
    take("storage_tokens")
    ffn = ("mlp.fc1", "mlp.fc2") if cfg.ffn_layer == "mlp" else ("mlp.w1", "mlp.w2", "mlp.w3")
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        for name in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                     "ls1.gamma", "ls2.gamma"):
            take(p + name)
        dense(p + "attn.qkv", use_bias=cfg.qkv_bias)
        mask_name = p + "attn.qkv.bias_mask"
        if cfg.qkv_bias and mask_name in sd and p + "attn.qkv.bias" in out:
            used.add(mask_name)
            mask = sd[mask_name]
            if bool(torch.isfinite(mask).all()):
                out[p + "attn.qkv.bias"] = out[p + "attn.qkv.bias"] * mask
        for name in ("attn.proj",) + ffn:
            dense(p + name)
    take("norm.weight")
    take("norm.bias")

    unused = set(sd) - used - set(IGNORED_CHECKPOINT_KEYS)
    if unused and strict:
        raise ValueError(
            f"{len(unused)} checkpoint key(s) were not converted (key-map "
            f"drift would drop pretrained weights): {sorted(unused)[:10]}")
    return out


# flax's msgpack format (flax/serialization.py): an ndarray is ext 1 and a
# numpy scalar ext 3, each holding msgpack of (shape, dtype name, buffer);
# an array over MAX_CHUNK_SIZE = 2^30 bytes is a map of its flattened
# pieces.
_FLAX_NDARRAY, _FLAX_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _flax_array(payload) -> torch.Tensor:
    """Ext payload -> tensor over the payload's buffer (no copy). bfloat16,
    which numpy lacks, arrives by its name like any other dtype."""
    (shape, name, buf), _ = unpack_from(payload)
    if name not in _DTYPES:
        raise ValueError(f"flax array of dtype {name!r}: not a dtype the port reads")
    if len(buf) == 0:
        return torch.empty(tuple(shape), dtype=_DTYPES[name])
    return torch.frombuffer(buf, dtype=_DTYPES[name]).reshape(tuple(shape))


class _Chunked:
    """An array flax stored chunked: consecutive pieces of its flattened
    self. ``[i]`` (a scanned backbone's block i) is a view into one piece
    where the block lies in one, which it does for the ViT-7B's stacked
    SwiGLU matrices (16 blocks a bf16 piece, 8 an fp32 one)."""

    def __init__(self, shape, pieces):
        self.shape = tuple(shape)
        self.pieces = pieces

    def __getitem__(self, i: int) -> torch.Tensor:
        row = math.prod(self.shape[1:])
        lo, hi, start, parts = i * row, (i + 1) * row, 0, []
        for piece in self.pieces:
            end = start + piece.numel()
            if start < hi and lo < end:
                parts.append(piece[max(lo - start, 0):min(hi, end) - start])
            start = end
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        return flat.reshape(self.shape[1:])

    def whole(self) -> torch.Tensor:
        return torch.cat(self.pieces).reshape(self.shape)


def _flax_tree(value):
    if isinstance(value, Ext):
        if value.code not in (_FLAX_NDARRAY, _FLAX_NPSCALAR):
            raise ValueError(f"flax msgpack ext code {value.code}: not an array")
        arr = _flax_array(value.data)
        return arr.reshape(()) if value.code == _FLAX_NPSCALAR else arr
    if isinstance(value, dict):
        if value.get(_CHUNKED):
            shape = [value["shape"][str(i)] for i in range(len(value["shape"]))]
            pieces = [_flax_tree(value["chunks"][str(i)])
                      for i in range(len(value["chunks"]))]
            return _Chunked(shape, pieces)
        return {k: _flax_tree(v) for k, v in value.items()}
    return value


def read_flax_msgpack(path: str) -> dict:
    """``flax.serialization.msgpack_restore`` of a file, without msgpack or
    flax: the tree, its arrays tensors over a private (copy-on-write)
    ``mmap`` of the file, so only the pages a reader touches are read and
    none is copied into anonymous memory. Chunked arrays stay in pieces
    (``_Chunked``)."""
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    tree, end = unpack_from(memoryview(mapped))
    if end != len(mapped):
        raise ValueError(f"{path}: {len(mapped) - end} bytes after the msgpack value")
    return _flax_tree(tree)


def load_backbone_params(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's converted backbone (``convert_torch_checkpoint``'s
    ``.msgpack``: the unrolled ``block{i}`` tree or the scanned
    ``blocks_scan/block`` one) -> the port's backbone state_dict, each
    tensor a view of the file's bytes where its layout allows (a chunked
    array that is not a scanned block is joined)."""
    tree = _unstack_scan(read_flax_msgpack(path), cast=False)
    prefix = _RULES["backbone"][0] + "."
    out = {}
    for p, leaf in _flatten(tree, cast=False).items():
        if isinstance(leaf, _Chunked):
            leaf = leaf.whole()
        out[_torch_name("backbone", p)[len(prefix):]] = _torch_layout(p, leaf)
    return out


def load_dinov3_backbone_(backbone: nn.Module, path: str,
                          model_name: Optional[str] = None) -> int:
    """Fill `backbone` (a ``DinoViT``) from the DINOv3 backbone file at
    `path`: a published ``.pth`` or the JAX package's ``.msgpack``. A
    ``.pth`` is checked against the manifest of `model_name`
    (``dinov3_vits16`` ...) when one is given, and no key of it may be left
    over. Every parameter of the module must be in the file with its shape
    (KeyError, ValueError), which is checked before anything is copied.
    Then each tensor is copied on its own into its parameter, converted to
    that parameter's dtype on its device; a backbone built as a rank's
    shards of the model axis takes its shards of the file's tensors.
    Returns the number of tensors."""
    if path.endswith(".msgpack"):
        loaded = load_backbone_params(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if model_name is not None:
            verify_state_dict_against_manifest(
                {k: tuple(v.shape) for k, v in sd.items()}, model_name)
        loaded = backbone_state_dict_from_dinov3(sd, backbone.cfg, strict=True)
    shard = getattr(backbone, "shard", None)
    if shard is not None:  # a rank's shards of the model axis
        loaded = shard_state_dict(loaded, shard.rank, shard.size)
    state = backbone.state_dict(keep_vars=True)
    for name, t in state.items():
        if name not in loaded:
            raise KeyError(f"Missing backbone param {name} in checkpoint {path}")
        if tuple(loaded[name].shape) != tuple(t.shape):
            raise ValueError(f"Shape mismatch for {name}: ckpt {tuple(loaded[name].shape)} "
                             f"vs model {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(loaded[name].to(t.device))
    return len(state)


def main(argv=None) -> None:
    """CLI: python -m dinounet_tpu_torch.models.convert <pth> <model_name>
    --verify-only: validate a .pth against the golden manifest."""
    import argparse

    p = argparse.ArgumentParser(
        description="Check a published DINOv3 .pth checkpoint against the golden "
                    "manifest of its layout. There is no conversion step: the "
                    "port's trainers read the .pth itself (and the JAX package's "
                    "converted .msgpack).")
    p.add_argument("pth", help="path to the downloaded .pth checkpoint")
    p.add_argument("model_name",
                   choices=["dinov3_vits16", "dinov3_vitb16", "dinov3_vitl16",
                            "dinov3_vit7b16"])
    p.add_argument("--verify-only", action="store_true",
                   help="only check keys/shapes against the manifest (the one "
                        "thing this CLI does; kept for the JAX CLI's spelling)")
    args = p.parse_args(argv)
    # mmap: shapes only, no tensor data read
    state_dict = torch.load(args.pth, map_location="cpu", weights_only=True, mmap=True)
    verify_state_dict_against_manifest(
        {k: tuple(v.shape) for k, v in state_dict.items()}, args.model_name)
    print(f"{args.pth}: matches the published {args.model_name} layout "
          f"({len(state_dict)} keys)")


if __name__ == "__main__":
    main()
