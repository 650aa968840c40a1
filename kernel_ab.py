"""A/B timing of kernels of the port across checkouts, on one card.

    python3 kernel_ab.py <checkout>

Times, with the `dinounet_tpu_torch` package of <checkout> (a directory
holding one, e.g. a `git archive` of another commit), at dinounet_b's shapes:
the MSDA forward #1 (16 heads of 24 channels over a 32 x 32 map, 5376
queries, tile batch 8), the Dh-major attention #2 (12 heads of 64, 1029
tokens, tile batch 8), the row-major attention #9 that shares #2's flash
loop (dinounet_7b's 32 heads of 128, tile batch 8), the MSDA backward #7 at
the train step's batch 2, and where the checkout has them the MSDA forward
with the prep done outside #5, the merged-projection MSDA forward #6 and the
(B, 3, M, N, Dh) attention #8 at dinounet_b's shapes. For each: the wrapper's event time (median of 50
synchronised calls) and the device time of one launch (CUDA events around
50 back-to-back calls). Prints one JSON line (null for a kernel the
checkout lacks). Compare two checkouts within one machine, in turns: A, B,
B, A.
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


def main(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    from dinounet_tpu_torch.ops import _build
    from dinounet_tpu_torch.ops import attention, msda_kernel
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
    out = {"checkout": checkout}
    # the MSDA kernels first: timed after a run of the attention kernels they
    # have read 2-3 % slower with their own code unchanged, a state the
    # attention leaves behind rather than the MSDA kernels' own time
    for name in ("msda_fwd_d24", "msda_bwd_d24_train", "msda_fwd_premapped_d24",
                 "msda_fwd_merged_d24", "rope_attention_dh64", "rope_attention_ndh_dh64",
                 "rope_attention_rm_dh128"):
        out[name] = _time(calls[name]) if name in calls else None
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
