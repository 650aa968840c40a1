"""A/B timing of two kernels of the port across checkouts, on one card.

    python3 kernel_ab.py <checkout>

Times the MSDA forward (dinounet_b: 16 heads of 24 channels, 5376 queries)
and the Dh-major attention (12 heads of 64, 1029 tokens), at tile batch 8,
with the `dinounet_tpu_torch` package of <checkout> (a directory holding
one, e.g. a `git archive` of another commit): the wrapper's event time
(median of 50 synchronised calls) and the device time of one launch (CUDA
events around 50 back-to-back calls). Prints one JSON line. Compare two
checkouts within one machine, in turns: A, B, B, A.
"""
import json
import sys


def main(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    from dinounet_tpu_torch.ops import _build
    from dinounet_tpu_torch.ops.attention import fused_rope_attention_premapped_dmaj
    from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_fused

    dev = torch.device("cuda", 0)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B, M, D, Hv, P, Lq = 8, 16, 24, 32, 4, 5376
    v = torch.randn((B, M, D, Hv * Hv), generator=g, device=dev).to(bf)
    off = (torch.randn((B, M, 2 * P, Lq), generator=g, device=dev) * 2).to(bf)
    logits = torch.randn((B, M, P, Lq), generator=g, device=dev).to(bf)
    base = torch.rand((2 * P, Lq), generator=g, device=dev) * Hv - 0.5
    qkv = torch.randn((8, 3, 12, 64, 1029), generator=g, device=dev).to(bf)
    ang = torch.rand((1029, 64), generator=g, device=dev) * 6
    sin, cos = torch.sin(ang), torch.cos(ang)
    calls = {"msda_fwd_d24": lambda: ms_deform_attn_premapped_fused(
                 v, ((Hv, Hv),), off, logits, base),
             "rope_attention_dh64": lambda: fused_rope_attention_premapped_dmaj(
                 qkv, sin, cos)}
    out = {"checkout": checkout}
    for name, fn in calls.items():
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
        out[name] = {"event_median_ms": ev[25], "back_to_back_ms": a.elapsed_time(b) / 50}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
