"""The reference against the program at a tiny size on the CPU: the same
parameter names and shapes, one weight draw for both, and the program in
float32 equal to the reference to rounding, in eval and in train mode (with
the same drop-path draws); the reference's augmentation equal to the
program's by the same draws, and a step off in bfloat16."""

import pytest
import torch

import weights
from conftest import tiny_config
from reference import augment as refaug
from reference import model as refmodel


def models(dtype="float32"):
    from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig

    cfg = tiny_config(patch=64)
    arch = cfg["plans_2d"]["architecture"]["arch_kwargs"]
    port = DinoUNet(DinoUNetConfig.from_plans_arch(arch, 3, model_name="dinounet_s",
                                                   dtype=dtype))
    ref = refmodel.build(cfg, "cpu", torch.float32)
    return cfg, port, ref


def test_same_names_shapes_and_draw():
    _, port, ref = models()
    shapes = {k: tuple(v.shape) for k, v in port.named_parameters()}
    assert shapes == {k: tuple(v.shape) for k, v in ref.named_parameters()}
    weights.fill(port.named_parameters(), 2**33 + 5, "cpu")
    weights.fill(ref.named_parameters(), 2**33 + 5, "cpu")
    for (k, a), (_, b) in zip(sorted(port.named_parameters()), sorted(ref.named_parameters())):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_program_in_float32_equals_reference(mode):
    cfg, port, ref = models()
    weights.fill(port.named_parameters(), 9, "cpu")
    weights.fill(ref.named_parameters(), 9, "cpu")
    x = torch.randn(2, 1, 64, 64, generator=torch.Generator().manual_seed(0))
    getattr(port, mode)()
    getattr(ref, mode)()
    keeps = None
    if mode == "train":
        port.encoder.dinov3_adapter.drop_path_generator = torch.Generator().manual_seed(3)
        gen = torch.Generator().manual_seed(3)
        keeps = [[torch.rand(2, generator=gen) < 0.7 for _ in range(n)]
                 for n in refmodel.n_extractors(cfg)]
    with torch.no_grad():
        got, want = port(x), ref(x, keeps)
    assert float((got - want).norm() / want.norm()) < 1e-4


ALWAYS = dict(p_rotation=1.0, p_scale=1.0, p_noise=1.0, p_blur=1.0, p_blur_per_channel=1.0,
              p_brightness=1.0, p_contrast=1.0, p_lowres=1.0, p_lowres_per_channel=1.0,
              p_gamma_invert=1.0, p_gamma=1.0)


@pytest.mark.parametrize("probabilities", [{}, ALWAYS], ids=["trainer", "every_transform"])
def test_augmentation_follows_the_programs_draws(probabilities):
    from dinounet_tpu_torch.training.augmentation import (AugmentConfig, apply_augment,
                                                          draw_augment)

    cfg = AugmentConfig(patch_size=(64, 48), **probabilities)
    gen = torch.Generator().manual_seed(2**31 + 9)
    for _ in range(4):
        data = torch.randn(2, 90, 70, generator=gen)
        seg = torch.randint(0, 3, (90, 70), generator=gen)
        d = draw_augment(gen, 2, cfg)
        x, y = apply_augment(data, seg, d, cfg)
        want_x, want_y = refaug.augment(data, seg, dict(vars(d)), (64, 48))
        assert float((x - want_x).norm() / want_x.norm()) < 1e-4
        assert float((y != want_y).float().mean()) < 1e-3
        low_x, _ = refaug.augment(data, seg, dict(vars(d)), (64, 48), dtype=torch.bfloat16)
        assert float((low_x.float() - want_x).norm() / want_x.norm()) > 1e-3
