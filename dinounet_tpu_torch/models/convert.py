"""Weight bridge: the JAX package's DinoUNet variables -> this port's state_dict.

``state_dict_from_flax(variables)`` takes the ``{"params", "batch_stats"}``
tree of ``dinounet_tpu.models.dinounet.DinoUNet`` (numpy arrays, or anything
``np.asarray`` reads) and returns the port's ``DinoUNet`` state_dict. The
port's names are the reference torch model's, the ones the JAX package's
torch -> flax converters read, so the same dict also stands for a published
checkpoint. Three layout changes:

  Dense          kernel (in, out)          -> weight (out, in)
  Conv           kernel (kh, kw, Ci, Co)   -> weight (Co, Ci, kh, kw)
  ConvTranspose  kernel (kh, kw, Ci, Co)   -> weight (Ci, Co, kh, kw), taps
                 flipped in both spatial axes (flax's conv_transpose correlates
                 with the spatially flipped kernel)
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

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
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _torch_name(top: str, path: str) -> str:
    """flax path below `top` (e.g. "block3/attn/qkv/kernel") -> torch name."""
    prefix, rules = _RULES[top]
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


def _torch_layout(path: str, leaf: np.ndarray) -> np.ndarray:
    if not path.endswith("/kernel"):
        return leaf
    if leaf.ndim == 2:
        return leaf.T
    if "transpconv" in path:
        return leaf[::-1, ::-1].transpose(2, 3, 0, 1)
    return leaf.transpose(3, 2, 0, 1)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DinoUNet variables -> port DinoUNet state_dict (fp32 tensors)."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for top, tree in variables.get(collection, {}).items():
            for path, leaf in _flatten(tree).items():
                name = _torch_name(top, path)
                sd[name] = torch.from_numpy(
                    np.ascontiguousarray(_torch_layout(path, leaf)))
                if name.endswith(".running_mean"):
                    sd[name[:-len("running_mean")] + "num_batches_tracked"] = (
                        torch.tensor(0, dtype=torch.long))
    return sd
