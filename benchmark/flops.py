"""Operations and bytes the model's work needs, from the configuration's
shapes alone, never from which kernel runs: so a roofline or a share of the
peak reads the same work whatever implements it.

A layer is a dense product (``Dense``: M rows of K inputs to N outputs, a
``Linear``), a convolution, attention's two products, or deformable
attention's sampling. FLOPs count a multiply-add as 2. A dense product's
bytes are its operands read once and its result written once, in the
compute type (bfloat16, 2 bytes). Backward: a trainable layer's weight
gradient and input gradient each cost its forward's FLOPs, except the input
gradient of a layer fed by the image; frozen layers (the backbone) have no
backward.
"""

from dataclasses import dataclass
from typing import List

BF16_BYTES = 2
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Dense:
    name: str
    M: int
    K: int
    N: int
    trainable: bool

    @property
    def flops(self) -> float:
        return 2.0 * self.M * self.K * self.N

    @property
    def bytes(self) -> float:
        return BF16_BYTES * (self.M * self.K + self.K * self.N + self.M * self.N)

    def backward(self) -> List["Dense"]:
        """The input gradient (M x N by N x K) and the weight gradient
        (K x M by M x N) of a trainable product."""
        return [Dense(self.name + ".dx", self.M, self.N, self.K, True),
                Dense(self.name + ".dw", self.K, self.M, self.N, True)]


@dataclass(frozen=True)
class Op:
    name: str
    flops: float
    trainable: bool
    input_grad: bool = True


def bound_s(dense: Dense) -> float:
    """The least time the card could take for one product."""
    return max(dense.flops / BF16_FLOP_S, dense.bytes / HBM_BYTES_S)


def conv(name, cin, cout, k, oh, ow, trainable, groups=1, input_grad=True) -> Op:
    return Op(name, 2.0 * oh * ow * cout * (cin // groups) * k * k, trainable, input_grad)


def layers(cfg: dict, H: int, W: int, B: int = 1):
    """(dense products, other ops) of one forward of B images of H x W."""
    vit, ad, dec = cfg["backbone"], cfg["adapter"], cfg["decoder"]
    E, p = vit["embed_dim"], vit["patch_size"]
    h, w = H // p, W // p
    Nt = h * w + 1 + vit["n_storage_tokens"]
    dense: List[Dense] = []
    ops: List[Op] = [conv("patch_embed", 3, E, p, h, w, False)]
    for i in range(vit["depth"]):
        pre = f"blocks.{i}."
        dense.append(Dense(pre + "qkv", B * Nt, E, 3 * E, False))
        dense.append(Dense(pre + "proj", B * Nt, E, E, False))
        if vit["ffn_layer"] == "mlp":
            dense += [Dense(pre + "fc1", B * Nt, E, vit["ffn_hidden"], False),
                      Dense(pre + "fc2", B * Nt, vit["ffn_hidden"], E, False)]
        else:
            dense += [Dense(pre + "w1", B * Nt, E, vit["ffn_hidden"], False),
                      Dense(pre + "w2", B * Nt, E, vit["ffn_hidden"], False),
                      Dense(pre + "w3", B * Nt, vit["ffn_hidden"], E, False)]
        ops.append(Op(pre + "attention", 4.0 * Nt * Nt * E, False))

    # adapter: spatial prior module, extractors, assembly
    ip = ad["conv_inplane"]
    ops += [conv("spm.stem.0", 3, ip, 3, H // 2, W // 2, True, input_grad=False),
            conv("spm.stem.3", ip, ip, 3, H // 2, W // 2, True),
            conv("spm.stem.6", ip, ip, 3, H // 2, W // 2, True),
            conv("spm.conv2", ip, 2 * ip, 3, H // 8, W // 8, True),
            conv("spm.conv3", 2 * ip, 4 * ip, 3, H // 16, W // 16, True),
            conv("spm.conv4", 4 * ip, 4 * ip, 3, H // 32, W // 32, True),
            conv("spm.fc1", ip, E, 1, H // 4, W // 4, True),
            conv("spm.fc2", 2 * ip, E, 1, H // 8, W // 8, True),
            conv("spm.fc3", 4 * ip, E, 1, H // 16, W // 16, True),
            conv("spm.fc4", 4 * ip, E, 1, H // 32, W // 32, True)]
    n = (H // 32) * (W // 32)
    Lq, S = 21 * n, h * w
    M, P = ad["deform_num_heads"], ad["n_points"]
    dv = int(E * ad["deform_ratio"])
    hid = int(E * ad["cffn_ratio"])
    n_ex = len(vit["interaction_indexes"]) + 2  # the last interaction has two more
    for j in range(n_ex):
        pre = f"extractor.{j}."
        dense += [Dense(pre + "value_proj", B * S, E, dv, True),
                  Dense(pre + "sampling_offsets", B * Lq, E, M * P * 2, True),
                  Dense(pre + "attention_weights", B * Lq, E, M * P, True),
                  Dense(pre + "output_proj", B * Lq, dv, E, True),
                  Dense(pre + "ffn.fc1", B * Lq, E, hid, True),
                  Dense(pre + "ffn.fc2", B * Lq, hid, E, True)]
        # four bilinear corners and the point weight, a channel a point
        ops.append(Op(pre + "msda_sampling", 2.0 * 5 * dv * P * Lq, True))
        ops.append(Op(pre + "ffn.dwconv", 2.0 * 9 * hid * Lq, True))
    ops.append(conv("up", E, E, 2, H // 8, W // 8, True))  # a 2x2 stride-2 transposed conv

    # FAPM and the learnable upsampling, per scale
    r, feats = dec["fapm_rank"], dec["features_per_stage"]
    for i, oc in enumerate(feats):
        s = 2 ** (i + 2)
        mh, mw = H // s, W // s
        pre = f"fapm.{i}."
        ops += [conv(pre + "shared", E, r, 1, mh, mw, True),
                conv(pre + "specific", E, r, 1, mh, mw, True),
                conv(pre + "film", r, 2 * r, 1, mh, mw, True),
                conv(pre + "reduce", r, oc, 1, mh, mw, True),
                conv(pre + "depthwise", oc, oc, 3, mh, mw, True, groups=oc),
                conv(pre + "pointwise", oc, oc, 1, mh, mw, True),
                conv(pre + "expand", oc, oc, 1, mh, mw, True)]
        if oc != r:
            ops.append(conv(pre + "shortcut", r, oc, 1, mh, mw, True))
        ops += [conv(pre + "up2.a", oc, oc, 2, mh, mw, True),
                conv(pre + "up2.b", oc, oc, 2, 2 * mh, 2 * mw, True)]

    # decoder: transposed conv, two 3x3 convs a stage, the head on top
    for s in range(len(feats) - 1):
        below, skip = feats[-1 - s], feats[-2 - s]
        div = 2 ** (len(feats) - 2 - s)
        oh, ow = H // div, W // div
        n_conv = dec["n_conv_per_stage_decoder"][s]
        ops.append(conv(f"decoder.{s}.transp", below, skip, 2, oh // 2, ow // 2, True))
        for c in range(n_conv):
            ops.append(conv(f"decoder.{s}.conv{c}", 2 * skip if c == 0 else skip, skip, 3,
                            oh, ow, True))
    ops.append(conv("decoder.seg", feats[0], cfg["assumed"]["num_classes"], 1, H, W, True))
    return dense, [Op(o.name, o.flops * B, o.trainable, o.input_grad) for o in ops]


def forward_flops(cfg: dict, H: int, W: int, B: int = 1) -> float:
    dense, ops = layers(cfg, H, W, B)
    return sum(d.flops for d in dense) + sum(o.flops for o in ops)


def train_step_flops(cfg: dict, H: int, W: int, B: int) -> float:
    """A step's forward of every layer plus the backward of the trainable
    ones (a recomputed forward is not work the step needs)."""
    dense, ops = layers(cfg, H, W, B)
    total = forward_flops(cfg, H, W, B)
    total += sum(2 * d.flops for d in dense if d.trainable)
    total += sum((2 if o.input_grad else 1) * o.flops for o in ops if o.trainable)
    return total


def dense_bound_s(cfg: dict, H: int, W: int, B: int, backward: bool) -> float:
    """The least time of the model's dense products in one call of B images
    (with `backward`, a train step's: the trainable products' two gradients
    too)."""
    dense, _ = layers(cfg, H, W, B)
    total = sum(bound_s(d) for d in dense)
    if backward:
        total += sum(bound_s(g) for d in dense if d.trainable for g in d.backward())
    return total
