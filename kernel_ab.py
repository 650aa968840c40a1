"""A/B timing of kernels of the port across checkouts, on one card.

    python3 kernel_ab.py <checkout> [row ...]

Times, with the `dinounet_tpu_torch` package of <checkout> (a directory
holding one, e.g. a `git archive` of another commit), at dinounet_b's shapes:
the MSDA forward #1 (16 heads of 24 channels over a 32 x 32 map, 5376
queries, tile batch 8), the Dh-major attention #2 (12 heads of 64, 1029
tokens, tile batch 8), the row-major attention #9 that shares #2's flash
loop (dinounet_7b's 32 heads of 128, tile batch 8), the MSDA backward #7 at
the train step's batch 2, and where the checkout has them the MSDA forward
with the prep done outside #5, the merged-projection MSDA forward #6 and the
(B, 3, M, N, Dh) attention #8 at dinounet_b's shapes; and the dense +
residual + statistics kernels #3 (channel-major) and #4 (row-major, GELU) at
the six shapes of the path (tile batch 8): the ViT attention projection and
fc2, the adapter's MSDA output projection and ConvFFN fc2 at D = 768, and
dinounet_7b's two junctions at D = 4096, each fed an fp32 `Linear.weight.t()`
as the models feed it; and the int8 serving mode's kernels at their path
shapes (tile batch 8), each fed an fp32 `Linear.weight.t()`: #10 the ViT
fc1, #11 (GELU) the ViT fc2 and the adapter's ConvFFN fc2, #12 the ViT
attention projection and the adapter's MSDA output projection, #13 the ViT
qkv; and the conv family at the serve routes' shapes (tile batch 8): the
3x3 conv + statistics #14 at serve_cm's seven (the decoder's conv0 and
conv1 at 512^2, 256^2 and 128^2, the SPM stem at 256^2), the same kernel as
#17 at serve_hwbc's four ((H, W, B, C) views of NCHW maps), and the k2s2
transposed conv #16 at its five. For each: the wrapper's event time
(median of 50 synchronised calls) and the device time of one launch (CUDA
events around 50 back-to-back calls). Prints one JSON line (null for a kernel the
checkout lacks). Compare two checkouts within one machine, in turns: A, B,
B, A. Row names after the checkout time those rows alone (the others print
null), so that a row can be timed without the rows before it.
"""
import json
import sys


def _time(fn) -> dict:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(50):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b))
    ev.sort()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(50):
        fn()
    b.record()
    b.synchronize()
    return {"event_median_ms": ev[25], "back_to_back_ms": a.elapsed_time(b) / 50}


def main(checkout: str, only=()) -> None:
    sys.path.insert(0, checkout)
    import torch

    from dinounet_tpu_torch.ops import _build
    from dinounet_tpu_torch.ops import attention, dense_q8, dense_stats, msda_kernel
    from dinounet_tpu_torch.ops.conv_hwbc import conv3x3_hwbc
    from dinounet_tpu_torch.ops.decoder_tail import conv3x3_cm, transpconv2x2_cm
    from dinounet_tpu_torch.ops.msda import premapped_fused_prep

    dev = torch.device("cuda", 0)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B, M, D, Hv, P, Lq = 8, 16, 24, 32, 4, 5376
    shapes = ((Hv, Hv),)
    v = torch.randn((B, M, D, Hv * Hv), generator=g, device=dev).to(bf)
    off = (torch.randn((B, M, 2 * P, Lq), generator=g, device=dev) * 2).to(bf)
    logits = torch.randn((B, M, P, Lq), generator=g, device=dev).to(bf)
    base = torch.rand((2 * P, Lq), generator=g, device=dev) * Hv - 0.5
    packed = torch.cat([off, logits], dim=2)
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(off, logits, base))
    qkv = torch.randn((8, 3, 12, 64, 1029), generator=g, device=dev).to(bf)
    qkv_ndh = qkv.transpose(3, 4).contiguous()
    ang = torch.rand((1029, 64), generator=g, device=dev) * 6
    sin, cos = torch.sin(ang), torch.cos(ang)
    qkv_rm = torch.randn((8, 1029, 3, 32, 128), generator=g, device=dev).to(bf)
    ang_rm = torch.rand((1029, 128), generator=g, device=dev) * 6
    sin_rm, cos_rm = torch.sin(ang_rm), torch.cos(ang_rm)
    Bt = 2  # the train step's batch
    cot = torch.randn((Bt, M, D, Lq), generator=g, device=dev)
    vt, xt, yt, at = (t[:Bt].contiguous() for t in (v, xs, ys, aw))
    calls = {
        "msda_fwd_d24": lambda: msda_kernel.ms_deform_attn_premapped_fused(
            v, shapes, off, logits, base),
        "rope_attention_dh64": lambda: attention.fused_rope_attention_premapped_dmaj(
            qkv, sin, cos),
        "msda_bwd_d24_train": lambda: msda_kernel.ms_deform_attn_premapped_backward(
            vt, shapes, xt, yt, at, cot),
        "rope_attention_rm_dh128": lambda: attention.fused_rope_attention(
            qkv_rm, sin_rm, cos_rm),
    }
    if hasattr(msda_kernel, "ms_deform_attn_premapped"):
        calls["msda_fwd_premapped_d24"] = lambda: msda_kernel.ms_deform_attn_premapped(
            v, shapes, xs, ys, aw)
    if hasattr(msda_kernel, "ms_deform_attn_premapped_fused_merged"):
        calls["msda_fwd_merged_d24"] = (
            lambda: msda_kernel.ms_deform_attn_premapped_fused_merged(v, shapes, packed, base))
    if hasattr(attention, "fused_rope_attention_premapped"):
        calls["rope_attention_ndh_dh64"] = lambda: attention.fused_rope_attention_premapped(
            qkv_ndh, sin, cos)
    # #3 / #4: (name, channel-major, K, N, D)
    for name, cm, K, N, D in (("dense_cm_vit_proj", True, 768, 1029, 768),
                              ("dense_cm_msda_proj", True, 384, 5376, 768),
                              ("dense_rm_vit_fc2", False, 3072, 1029, 768),
                              ("dense_rm_convffn_fc2", False, 192, 5376, 768),
                              ("dense_cm_7b_msda_proj", True, 2048, 5376, 4096),
                              ("dense_rm_7b_convffn_fc2", False, 1024, 5376, 4096)):
        h = torch.randn((8, K, N) if cm else (8, N, K), generator=g, device=dev).to(bf)
        lin_w = torch.randn((D, K), generator=g, device=dev) * K ** -0.5
        bias, gamma = (torch.randn((D,), generator=g, device=dev) * 0.1 for _ in range(2))
        res = torch.randn((8, N, D), generator=g, device=dev).to(bf)
        if cm:
            calls[name] = (lambda h=h, w=lin_w.t(), bias=bias, res=res, gamma=gamma:
                           dense_stats.dense_cm_residual_stats(h, w, bias, res, gamma))
        else:
            calls[name] = (lambda h=h, w=lin_w.t(), bias=bias, res=res, gamma=gamma:
                           dense_stats.dense_residual_stats(h, w, bias, res, gamma,
                                                            apply_gelu=True))
    # #10-#13: (name, op, K, N, D)
    for name, op, K, N, D in (("q8_vit_fc1", "dense_q8", 768, 1029, 3072),
                              ("q8_stats_vit_fc2", "dense_q8_stats", 3072, 1029, 768),
                              ("q8_stats_convffn_fc2", "dense_q8_stats", 192, 5376, 768),
                              ("q8_cm_vit_proj", "dense_cm_q8_stats", 768, 1029, 768),
                              ("q8_cm_msda_proj", "dense_cm_q8_stats", 384, 5376, 768),
                              ("q8_vit_qkv", "qkv_q8_dmaj", 768, 1029, 2304)):
        cm = op == "dense_cm_q8_stats"
        h = torch.randn((8, K, N) if cm else (8, N, K), generator=g, device=dev).to(bf)
        w = (torch.randn((D, K), generator=g, device=dev) * K ** -0.5).t()
        bias, gamma = (torch.randn((D,), generator=g, device=dev) * 0.1 for _ in range(2))
        res = torch.randn((8, N, D), generator=g, device=dev).to(bf)
        calls[name] = {
            "dense_q8": lambda h=h, w=w, b=bias: dense_q8.dense_q8(h, w, b),
            "dense_q8_stats": lambda h=h, w=w, b=bias, r=res, gm=gamma:
                dense_q8.dense_q8_residual_stats(h, w, b, r, gm, "gelu"),
            "dense_cm_q8_stats": lambda h=h, w=w, b=bias, r=res, gm=gamma:
                dense_q8.dense_cm_q8_residual_stats(h, w, b, r, gm),
            "qkv_q8_dmaj": lambda h=h, w=w, b=bias: dense_q8.qkv_q8_dmaj(h, w, b, 12, 64),
        }[op]
    # #14 / #17: (name, hwbc view, C1, C2, H = W, Cout, prologue, slope, stats)
    conv_names = []
    for name, hwbc, C1, C2, H, Cout, pro, slope, stats in (
            ("conv_cm_conv0_512", False, 32, 32, 512, 32, False, 0.01, True),
            ("conv_cm_conv1_512", False, 32, 0, 512, 32, True, 0.01, True),
            ("conv_cm_conv0_256", False, 64, 64, 256, 64, False, 0.01, True),
            ("conv_cm_conv1_256", False, 64, 0, 256, 64, True, 0.01, True),
            ("conv_cm_conv0_128", False, 128, 128, 128, 128, False, 0.01, True),
            ("conv_cm_conv1_128", False, 128, 0, 128, 128, True, 0.01, True),
            ("conv_cm_spm_256", False, 64, 0, 256, 64, True, 0.0, False),
            ("conv_hwbc_conv0_512", True, 32, 32, 512, 32, False, 0.01, True),
            ("conv_hwbc_conv1_512", True, 32, 0, 512, 32, True, 0.01, True),
            ("conv_hwbc_conv0_256", True, 64, 64, 256, 64, False, 0.01, True),
            ("conv_hwbc_conv1_256", True, 64, 0, 256, 64, True, 0.01, True)):
        x = torch.randn((8, C1, H, H), generator=g, device=dev).to(bf)
        x2 = torch.randn((8, C2, H, H), generator=g, device=dev).to(bf) if C2 else None
        w = torch.randn((Cout, C1 + C2, 3, 3), generator=g, device=dev) * (9 * (C1 + C2)) ** -0.5
        b = torch.randn((Cout,), generator=g, device=dev) * 0.1
        p = ((torch.rand((8, C1 + C2), generator=g, device=dev) + 0.5,
              torch.randn((8, C1 + C2), generator=g, device=dev) * 0.3) if pro else None)
        if hwbc:
            xv = x.permute(2, 3, 0, 1)
            x2v = None if x2 is None else x2.permute(2, 3, 0, 1)
            calls[name] = (lambda xv=xv, w=w, b=b, x2v=x2v, p=p, s=slope:
                           conv3x3_hwbc(xv, w, b, x2v, p, s))
        else:
            calls[name] = (lambda x=x, w=w, b=b, p=p, s=slope, st=stats, x2=x2:
                           conv3x3_cm(x, w, b, p, s, st, x2))
        conv_names.append(name)
    # #16: (name, Cin, Cout, H = W, prologue)
    for name, Cin, Cout, H, pro in (("transpconv_dec_256", 64, 32, 256, True),
                                    ("transpconv_dec_128", 128, 64, 128, True),
                                    ("transpconv_dec_64", 256, 128, 64, False),
                                    ("transpconv_up_256", 32, 32, 256, False),
                                    ("transpconv_up_32", 256, 256, 32, False)):
        x = torch.randn((8, Cin, H, H), generator=g, device=dev).to(bf)
        w = torch.randn((Cin, Cout, 2, 2), generator=g, device=dev) * Cin ** -0.5
        b = torch.randn((Cout,), generator=g, device=dev) * 0.1
        p = ((torch.rand((8, Cin), generator=g, device=dev) + 0.5,
              torch.randn((8, Cin), generator=g, device=dev) * 0.3) if pro else None)
        calls[name] = lambda x=x, w=w, b=b, p=p: transpconv2x2_cm(x, w, b, p)
        conv_names.append(name)
    out = {"checkout": checkout}
    # the MSDA kernels first: timed after a run of the attention kernels they
    # have read 2-3 % slower with their own code unchanged, a state the
    # attention leaves behind rather than the MSDA kernels' own time; the
    # dense and int8 kernels between the two
    for name in ("msda_fwd_d24", "msda_bwd_d24_train", "msda_fwd_premapped_d24",
                 "msda_fwd_merged_d24", "dense_cm_vit_proj", "dense_cm_msda_proj",
                 "dense_rm_vit_fc2", "dense_rm_convffn_fc2", "dense_cm_7b_msda_proj",
                 "dense_rm_7b_convffn_fc2", "q8_vit_fc1", "q8_stats_vit_fc2",
                 "q8_stats_convffn_fc2", "q8_cm_vit_proj", "q8_cm_msda_proj", "q8_vit_qkv",
                 "rope_attention_dh64", "rope_attention_ndh_dh64", "rope_attention_rm_dh128",
                 *conv_names):
        wanted = name in calls and (not only or name in only)
        out[name] = _time(calls[name]) if wanted else None
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
