"""The MSDA wrappers' shared-memory plans, on the CPU.

``ops/msda_kernel.py`` picks, in Python, what the kernels then check: the
backward's channel slices (``bwd_plan``: each slice's 16-byte map cells in
the shared memory of a block; whole heads up to 64 channels, wider ones in
slices of up to 32 channels, as the forwards cut them) and the
forwards' token-major scratch copy (``_fwd_scratch``, one rule for #1, #5
and #6). Held here at the shapes the serve and train paths give the
kernels: the plans stay within the 232,448 bytes a block may have, take the
device-memory instance nowhere on those paths, and #5 takes a token-major
copy exactly where #1 does.
"""

import pytest
import torch

from dinounet_tpu_torch.ops.msda_kernel import MAX_SMEM, _fwd_scratch, bwd_plan

# (what, D, S, value bytes, whole head expected)
PATH_SHAPES = [("dinounet_b train", 24, 1024, 2, True), ("dinounet_l train", 32, 1024, 2, True),
               ("dinounet_7b train", 128, 1024, 2, False),
               ("1024^2 patch", 24, 4096, 2, True), ("1024^2 patch, D 32", 32, 4096, 2, False),
               ("reference layout, fp32 map", 24, 1024, 4, True),
               ("reference layout, 4 levels", 32, 64 * 64 + 32 * 32 + 16 * 16 + 8 * 8, 4, False)]


@pytest.mark.parametrize("what,D,S,elem,whole", PATH_SHAPES)
def test_backward_plan_fits_shared_memory(what, D, S, elem, whole):
    plan = bwd_plan(D, S, elem)
    assert plan is not None, f"{what}: the device-memory instance"
    width, n_slices, smem = plan
    cc = 16 // elem
    assert smem <= MAX_SMEM and width % cc == 0
    assert (n_slices - 1) * width < D <= n_slices * width
    assert (n_slices == 1) == whole
    # whole heads up to 64 channels; else the fewest slices of at most 32
    # channels that fit: one fewer would need a wider slice
    per_cell = 16 * (-(-S // 8) * 8)
    assert smem == width // cc * per_cell
    if n_slices > 1:
        assert width <= 32
        widest = min(MAX_SMEM // per_cell, 32 // cc)
        assert -(-(-(-D // cc)) // (n_slices - 1)) > widest


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("S,staged", [(4096, True), (14528, True), (14529, False),
                                      (16384, False)])
def test_backward_plan_takes_device_memory_only_past_one_cell(elem, S, staged):
    """The device-memory instance only where not even one 16-byte cell a
    position fits a block."""
    plan = bwd_plan(24, S, elem)
    assert (plan is not None) == staged
    if plan is not None:
        assert plan[2] <= MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,copy", [(1024, False), (1280, False), (4096, False),
                                    (14528, False), (14536, True), (16384, True)])
def test_forward_copy_rule(dtype, S, copy):
    """#1, #5 and #6 stage slices as narrow as one 16-byte cell, in either
    dtype: the token-major copy only where 16 S bytes exceed a block's
    shared memory (no path shape of the repo: dinounet_b's S 1024, a 1024^2
    patch's 4096, #5's two-level 1280)."""
    v = torch.empty((2, 16, 24, S), dtype=dtype, device="meta")
    scratch = _fwd_scratch(v)
    assert (scratch is not None) == copy
    if copy:
        assert scratch.shape == (2, 16, S, 24) and scratch.dtype == dtype
