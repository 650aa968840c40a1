"""The port's 3-D training and inference vs the JAX package's, on the CPU.

Inputs come from numpy seeds (the augmentation's random draws from a JAX
key, recomputed in ``augmentation.py``'s order). Tolerances:
- the deep-supervision targets and the enlarged 3-D patch: equal;
- the 3-D augmentation: 1e-4 absolute on O(1) volumes (trilinear taps, the
  blur's sums and the gamma's power in another order), labels exactly;
- the 3-D loader: equal batches under one numpy seed;
- one deep-supervision 3d_fullres train step of a small PlainConvUNet
  (fp32, augmentation off): the loss to 1e-5 relative, every gradient to
  2e-3 of its tensor's largest entry (floored at 1e-4 of the largest
  gradient: biases in front of a norm have a true gradient of 0);
- the sliding window of a 3-D network and its ``with_target`` form: 1e-4;
- accumulation on the host: equal to accumulation on the device for one
  fold, 1e-6 for a sum of two folds (added in another order).
The last test plans a raw 3-D NIfTI set, preprocesses it, trains
``3d_fullres`` for 2 steps with deep supervision, validates, predicts the
test case from its file and evaluates, all through the port's API, then
plans it with ``nnUNetPlannerResEncM`` and takes a step of its
ResidualEncoderUNet.
"""

import dataclasses
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.models.plain_unet import PlainConvUNet, PlainUNetConfig
from dinounet_tpu_torch.training import augmentation as taug
from tests.test_torch_planning import fast_fingerprints  # noqa: F401
from tests.test_torch_unet import plans_arch, seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

N_CLASSES = 3


def _ncdhw(y) -> np.ndarray:
    return np.moveaxis(np.asarray(y), -1, 1)


def _ndhwc(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _pair(ds: bool, dtype="float32", in_ch: int = 1, seed: int = 0):
    """A small 3-D PlainConvUNet in both packages on the same weights."""
    from dinounet_tpu.models import plain_unet

    arch = plans_arch(3)
    jcfg = plain_unet.PlainUNetConfig.from_plans_arch(arch, N_CLASSES, ds)
    jnet = plain_unet.PlainConvUNet(dataclasses.replace(jcfg, dtype="float32"))
    variables = seeded_variables(jnet, (1, 8, 16, 16, in_ch), seed)
    net = PlainConvUNet(dataclasses.replace(
        PlainUNetConfig.from_plans_arch(arch, N_CLASSES, ds), dtype=dtype), in_ch)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jnet, variables, net


# ------------------------------------------------------ augmentation helpers


def test_ds_targets_and_enlarged_patch_equal_jax():
    from dinounet_tpu.training import augmentation as jaug

    seg = np.random.default_rng(0).integers(-1, 3, (2, 10, 24, 20)).astype(np.int32)
    scales = [(1.0, 1.0, 1.0), (1.0, 0.5, 0.5), (0.5, 0.25, 0.25), (0.3, 1 / 3, 0.75)]
    got = taug.downsample_seg_for_ds(torch.from_numpy(seg), scales)
    want = jaug.downsample_seg_for_ds(jnp.asarray(seg), scales)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got2 = taug.downsample_seg_for_ds(torch.from_numpy(seg[:, 0]), [(0.5, 0.5)])
    np.testing.assert_array_equal(got2[0].numpy(), np.asarray(
        jaug.downsample_seg_for_ds(jnp.asarray(seg[:, 0]), [(0.5, 0.5)])[0]))
    for patch, rot in (((128, 128, 128), [0.5236] * 3), ((20, 192, 160), 0.5236),
                       ((40, 112, 96), [np.pi, 0.0, 0.0]), ((8, 12, 12), [1.7, 0.1, -0.2])):
        np.testing.assert_array_equal(taug.get_enlarged_patch_size_3d(patch, rot, (0.85, 1.25)),
                                      jaug.get_enlarged_patch_size_3d(patch, rot, (0.85, 1.25)))


def _draws_3d_from_jax_key(key, C, cfg):
    """The draws JAX's _augment_one_3d takes from `key`, in its order."""
    def u(k, shape=(), lo=0.0, hi=1.0):
        return np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    keys = jax.random.split(key, 16)
    k_prot, k_rot, k_pscale, k_scale = jax.random.split(keys[0], 4)
    d = taug.AugmentDraws3D()
    if u(k_prot) < cfg.p_rotation:
        lo = jnp.asarray([r[0] for r in cfg.rotation_ranges], jnp.float32)
        hi = jnp.asarray([r[1] for r in cfg.rotation_ranges], jnp.float32)
        d.angles = tuple(float(a) for a in np.asarray(
            jax.random.uniform(k_rot, (3,)) * (hi - lo) + lo))
    if u(k_pscale) < cfg.p_scale:
        d.scale = float(u(k_scale, lo=cfg.scale_range[0], hi=cfg.scale_range[1]))
    if u(keys[3]) < cfg.p_noise:
        std = u(keys[1], lo=cfg.noise_variance[0], hi=cfg.noise_variance[1])
        noise = np.asarray(jax.random.normal(keys[2], (*cfg.patch_size, C)) * std)
        d.noise = torch.from_numpy(np.moveaxis(noise, -1, 0).copy())
    do_blur = u(keys[4]) < cfg.p_blur
    on = u(keys[5], (C,)) < cfg.p_blur_per_channel
    sig = u(keys[6], (C,), *cfg.blur_sigma)
    d.blur_sigmas = tuple(float(s) if do_blur and o else None for s, o in zip(sig, on))
    mult = u(keys[7], (C,), *cfg.brightness_range)
    if u(keys[8]) < cfg.p_brightness:
        d.brightness = tuple(float(m) for m in mult)
    f = u(keys[9], (C,), *cfg.contrast_range)
    if u(keys[10]) < cfg.p_contrast:
        d.contrast = tuple(float(v) for v in f)
    for name, k, p in (("gamma_invert", keys[11], cfg.p_gamma_invert),
                       ("gamma", keys[12], cfg.p_gamma)):
        k_p, k_side, k_lo, k_hi = jax.random.split(k, 4)
        if u(k_p) < p:
            lo = u(k_lo, lo=cfg.gamma_range[0], hi=1.0)
            hi = u(k_hi, lo=1.0, hi=cfg.gamma_range[1])
            setattr(d, name, float(lo if u(k_side) < 0.5 else hi))
    d.flips = tuple(bool(a in cfg.mirror_axes and u(k) < 0.5)
                    for a, k in ((0, keys[13]), (1, keys[14]), (2, keys[15])))
    return d


@pytest.mark.parametrize("in_plane_only", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_one_3d_matches_jax_given_its_draws(seed, in_plane_only):
    from dinounet_tpu.training.augmentation import AugmentConfig3D as JaxCfg
    from dinounet_tpu.training.augmentation import _augment_one_3d

    rotation = (((-np.pi, np.pi), (0.0, 0.0), (0.0, 0.0)) if in_plane_only
                else ((-0.5236, 0.5236),) * 3)
    probs = dict(p_rotation=1.0, p_scale=1.0, p_noise=0.7, p_blur=0.7,
                 p_brightness=0.7, p_contrast=0.7, p_gamma_invert=0.5, p_gamma=0.7,
                 use_mask_for_norm=(True, False), patch_size=(8, 14, 12),
                 rotation_ranges=rotation, scale_in_plane_only=in_plane_only)
    cfg = taug.AugmentConfig3D(**probs)
    jcfg = JaxCfg(**probs)
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    rng = np.random.default_rng(40 + seed)
    data = rng.standard_normal((2, 11, 19, 17)).astype(np.float32)  # (C, D, H, W)
    seg = rng.integers(-1, 3, (11, 19, 17))
    key = jax.random.PRNGKey(seed)
    want_x, want_s = _augment_one_3d(key, jnp.asarray(np.moveaxis(data, 0, -1)),
                                     jnp.asarray(seg, jnp.int32), jcfg)
    draws = _draws_3d_from_jax_key(key, 2, cfg)
    got_x, got_s = taug.apply_augment_3d(torch.from_numpy(data), torch.from_numpy(seg),
                                         draws, cfg)
    assert got_x.shape == (2, 8, 14, 12) and got_s.shape == (8, 14, 12)
    np.testing.assert_allclose(got_x.numpy(), np.moveaxis(np.asarray(want_x), -1, 0),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_augment_batch_3d_shapes_identity_and_dummy_2d():
    """The JAX package's distribution checks (tests/test_training_e2e.py::
    TestAugment3D) on the port's augment_batch_3d."""
    final = (8, 12, 12)
    init = taug.get_enlarged_patch_size_3d(final, [0.5236] * 3, (0.85, 1.25))
    assert all(i >= f for i, f in zip(init, final))
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((2, 1, *init)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 3, (2, *init)))
    x, s = taug.augment_batch_3d(data, seg, taug.AugmentConfig3D(patch_size=final),
                                 torch.Generator().manual_seed(0))
    assert x.shape == (2, 1, *final) and s.shape == (2, *final)
    assert int(s.min()) >= 0 and bool(torch.isfinite(x).all())
    x2, s2 = taug.augment_batch_3d(data, seg, taug.AugmentConfig3D(patch_size=final),
                                   torch.Generator().manual_seed(0))
    assert torch.equal(x, x2) and torch.equal(s, s2)

    shape = (6, 10, 10)
    off = dict(p_rotation=0.0, p_scale=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
               p_contrast=0.0, p_gamma=0.0, p_gamma_invert=0.0, mirror_axes=())
    data = torch.from_numpy(rng.standard_normal((1, 2, *shape)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 2, (1, *shape)))
    x, s = taug.augment_batch_3d(data, seg, taug.AugmentConfig3D(patch_size=shape, **off),
                                 torch.Generator().manual_seed(3))
    np.testing.assert_allclose(x.numpy(), data.numpy(), atol=1e-5)
    assert torch.equal(s, seg)

    shape = (4, 16, 16)
    cfg = taug.AugmentConfig3D(patch_size=shape, **dict(
        off, p_rotation=1.0, rotation_ranges=((-np.pi, np.pi), (0.0, 0.0), (0.0, 0.0))))
    base = torch.arange(shape[0], dtype=torch.float32)[:, None, None].expand(shape)
    for seed in range(3):
        x, _ = taug.augment_batch_3d(base[None, None].clone(),
                                     torch.zeros((1, *shape), dtype=torch.long), cfg,
                                     torch.Generator().manual_seed(seed))
        for z in range(shape[0]):  # in-plane rotation keeps each slice constant
            np.testing.assert_allclose(x[0, 0, z, 4:-4, 4:-4].numpy(), float(z), atol=1e-4)


# ----------------------------------------------------------------- loader


def _write_preprocessed_3d(folder: str, n: int, shape, seed: int) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        seg = np.zeros((1, *shape), np.int8)
        seg[0, 2:5, 4:12, 6:14] = 1
        seg[0, -4:-1, -9:-3, 2:6] = 2
        data = rng.standard_normal((1, *shape)).astype(np.float32)
        name = os.path.join(folder, f"case_{i:03d}")
        np.savez_compressed(name + ".npz", data=data, seg=seg)
        props = {"class_locations": {c: np.argwhere(seg == c) for c in (1, 2)}}
        with open(name + ".pkl", "wb") as f:
            pickle.dump(props, f)


def test_data_loader_3d_matches_jax_under_one_seed(tmp_path):
    from dinounet_tpu.training import dataloading as jdl
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans
    from dinounet_tpu_torch.training import dataloading as tdl
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    folder = str(tmp_path / "nnUNetPlans_3d_fullres")
    _write_preprocessed_3d(folder, 4, (10, 20, 18), seed=1)
    plans = {"dataset_name": "Dataset993_Loader3d", "plans_name": "nnUNetPlans",
             "configurations": {}}
    dsj = {"labels": {"background": 0, "a": 1, "b": 2}}
    loaders = []
    for dl, pm in ((jdl, JaxPlans(plans)), (tdl, PlansManager(plans))):
        loaders.append(dl.nnUNetDataLoader3D(
            dl.nnUNetDataset(folder), 3, (12, 16, 16), (8, 12, 12),
            pm.get_label_manager(dsj), 0.33, rng=np.random.default_rng(9)))
    for _ in range(4):
        want, got = (ld.generate_train_batch() for ld in loaders)
        assert got["keys"] == want["keys"] and got["data"].shape == (3, 1, 12, 16, 16)
        np.testing.assert_array_equal(got["data"], want["data"])
        np.testing.assert_array_equal(got["seg"], want["seg"])


# ------------------------------------------------------ one train step


def test_ds_train_step_3d_matches_jax():
    """Loss and gradients of one deep-supervision train step (the trainer's
    ``_train_loss`` over the heads) against the JAX step's ``loss_of``
    (``trainer.py:449-468``), from the same weights and batch."""
    from dinounet_tpu.training import augmentation as jaug
    from dinounet_tpu.training import losses as jl
    from dinounet_tpu_torch.training.losses import dc_and_ce_loss
    from dinounet_tpu_torch.training.trainer import nnUNetTrainer

    rng = np.random.default_rng(11)
    image = rng.standard_normal((2, 1, 8, 16, 16)).astype(np.float32)
    target = rng.integers(0, N_CLASSES, (2, 8, 16, 16))
    kw = dict(batch_dice=True, smooth=1e-5, do_bg=False, ignore_label=None)
    jnet, variables, net = _pair(ds=True)

    def loss_of(params):
        out, _ = jnet.apply({**variables, "params": params}, _ndhwc(image), train=True,
                            mutable=["batch_stats"])
        scales = [tuple(o.shape[1 + i] / out[0].shape[1 + i] for i in range(3))
                  for o in out]
        targets = jaug.downsample_seg_for_ds(jnp.asarray(target, jnp.int32), scales)
        return jl.deep_supervision_loss(lambda o, t: jl.dc_and_ce_loss(o, t, **kw), out,
                                        targets, jl.deep_supervision_weights(len(out)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    fake = SimpleNamespace(_loss=lambda o, t: dc_and_ce_loss(o, t, **kw))
    net.train()
    out = net(torch.from_numpy(image))
    assert len(out) == 2
    loss = nnUNetTrainer._train_loss(fake, out, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)

    grads = state_dict_from_flax({"params": want_grads})
    floor = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    worst = {}
    for name, p in net.named_parameters():
        want = grads[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        worst[name] = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), floor)
    assert max(worst.values()) <= 2e-3, sorted(worst.items(), key=lambda kv: -kv[1])[:5]


# ---------------------------------------------------------- sliding window


class _WithTarget(torch.nn.Module):
    """A network of (image, mask): the two concatenated along channels."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, t):
        return self.net(torch.cat([x, t], dim=1))


@pytest.mark.parametrize("with_target", [False, True])
def test_sliding_window_3d_matches_jax(with_target):
    from dinounet_tpu.inference import sliding_window as jsw
    from dinounet_tpu_torch.inference import sliding_window as tsw

    jnet, variables, net = _pair(ds=False, in_ch=2 if with_target else 1, seed=4)
    net.eval()
    rng = np.random.default_rng(12)
    data = rng.standard_normal((1, 13, 30, 21)).astype(np.float32)
    mask = (rng.uniform(size=(1, 13, 30, 21)) < 0.3).astype(np.float32)
    kw = dict(tile_step_size=0.5, mirror_axes=(0, 1, 2), tile_batch=3)
    patch = (8, 16, 16)
    if with_target:
        want = jsw.predict_sliding_window_return_logits_with_target(
            lambda x, t: jnet.apply(variables, jnp.concatenate([x, t], -1)), data, mask,
            patch, N_CLASSES, **kw)
        got = tsw.predict_sliding_window_return_logits_with_target(
            _WithTarget(net), data, mask, patch, N_CLASSES, device="cpu", **kw)
    else:
        want = jsw.predict_sliding_window_return_logits(
            lambda x: jnet.apply(variables, x), data, patch, N_CLASSES, **kw)
        got = tsw.predict_sliding_window_return_logits(net, data, patch, N_CLASSES,
                                                       device="cpu", **kw)
    assert got.shape == np.asarray(want).shape == (N_CLASSES, 13, 30, 21)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_host_accumulation_equals_device_accumulation(dim, monkeypatch):
    """DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES=0: every tile batch added on the
    host, in the device's order; one fold equal, through the predictor's
    fold sum of two folds within 1e-6 (fp16 logits: equal or one ulp)."""
    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
    from dinounet_tpu_torch.inference.sliding_window import predict_sliding_window_return_logits
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    arch = plans_arch(dim)
    net = PlainConvUNet(PlainUNetConfig.from_plans_arch(arch, N_CLASSES, False), 1)
    net.init_weights(5).eval()
    patch = (16, 16) if dim == 2 else (8, 16, 16)
    data = np.random.default_rng(13).standard_normal((1, 9, 27, 22)).astype(np.float32)
    first = {k: v.clone() for k, v in net.state_dict().items()}
    second = {k: v + 0.01 for k, v in first.items()}
    runs = {}
    for budget in (None, "0"):
        if budget is None:
            monkeypatch.delenv("DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES", raising=False)
        else:
            monkeypatch.setenv("DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES", budget)
        net.load_state_dict(first)
        one = predict_sliding_window_return_logits(net, data, patch, N_CLASSES,
                                                   mirror_axes=(0, 1), tile_batch=3,
                                                   device="cpu")
        config = f"{dim}d" if dim == 2 else "3d_fullres"
        pm = PlansManager({"dataset_name": "Dataset994_Acc", "plans_name": "nnUNetPlans",
                           "configurations": {config: {"patch_size": list(patch)}}})
        p = nnUNetPredictor(device="cpu", tile_batch=4)
        p.manual_initialization(net, pm, pm.get_configuration(config), [first, second],
                                {"labels": {"background": 0, "a": 1, "b": 2}},
                                "nnUNetTrainer", (0, 1))
        runs[budget] = one, p.predict_logits_from_preprocessed_data(data)
    np.testing.assert_array_equal(runs["0"][0], runs[None][0])
    assert runs["0"][1].dtype == np.float16 and runs["0"][1].shape == (N_CLASSES, 9, 27, 22)
    np.testing.assert_allclose(runs["0"][1].astype(np.float32),
                               runs[None][1].astype(np.float32), rtol=1e-3, atol=1e-6)


# ------------------------------------------------------------- end to end


def test_3d_fullres_end_to_end_through_the_api(tmp_path, monkeypatch,
                                               fast_fingerprints):  # noqa: F811
    """Plan (default planner), preprocess, train 3d_fullres 2 steps with deep
    supervision, validate, predict the test case from its file and evaluate
    (as tests/test_training_e2e.py:395-430 does for the JAX trainer)."""
    from dinounet_tpu_torch.api import evaluate
    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
    from dinounet_tpu_torch.planning.plan_and_preprocess_api import (
        extract_fingerprints, plan_experiments, preprocess)
    from dinounet_tpu_torch.run import get_trainer_from_args
    from dinounet_tpu_torch.utilities.synthetic_dataset import write_sphere_shell_raw_dataset

    for sub in ("raw", "pre", "res"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("nnUNet_raw", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    raw = write_sphere_shell_raw_dataset(str(tmp_path / "raw"), "Dataset603_Spheres", 5, 1,
                                         (20, 24, 24), seed=0)
    extract_fingerprints([603], num_processes=1)
    pid = plan_experiments([603])
    preprocess([603], pid, ["3d_fullres"], [1])

    trainer = get_trainer_from_args(603, "3d_fullres", 0, "nnUNetTrainer", pid, device="cpu")
    trainer.seed = 0
    trainer.num_iterations_per_epoch = 2
    trainer.num_val_iterations_per_epoch = 1
    trainer.num_epochs = 1
    trainer.run_training()
    assert type(trainer.network).__name__ == "PlainConvUNet"
    assert len(trainer.configuration_manager.patch_size) == 3
    assert np.isfinite(trainer.logger.my_fantastic_logging["train_losses"][-1])
    assert trainer.inference_allowed_mirroring_axes == (0, 1, 2)

    metrics = trainer.perform_actual_validation()
    assert metrics is not None and np.isfinite(metrics["foreground_mean"]["Dice"])

    predictor = nnUNetPredictor(device="cpu")
    predictor.initialize_from_trained_model_folder(trainer.output_folder_base, (0,))
    out = str(tmp_path / "test_predictions")
    written = predictor.predict_from_files(os.path.join(raw, "imagesTs"), out)
    assert written == [os.path.join(out, "case_005")]
    from dinounet_tpu_torch.imageio.nifti import NiftiIO

    seg, props = NiftiIO().read_seg(written[0] + ".nii.gz")
    img, img_props = NiftiIO().read_images([os.path.join(raw, "imagesTs",
                                                         "case_005_0000.nii.gz")])
    assert seg.shape == img.shape and props["spacing"] == img_props["spacing"]
    summary = evaluate(603, trainer.output_folder, fold=0, num_processes=1)
    assert summary["foreground_mean"]["Dice"] == metrics["foreground_mean"]["Dice"]

    # nnUNetPlannerResEncM: its 3d_fullres reuses the preprocessed data and
    # trains a ResidualEncoderUNet
    from dinounet_tpu_torch.planning.resenc_planner import nnUNetPlannerResEncM

    res_id = plan_experiments([603], experiment_planner_class=nnUNetPlannerResEncM)
    assert res_id == "nnUNetResEncUNetMPlans"
    res = get_trainer_from_args(603, "3d_fullres", 0, "nnUNetTrainer", res_id, device="cpu")
    assert res.configuration_manager.data_identifier == "nnUNetPlans_3d_fullres"
    res.seed = 0
    res.on_train_start()
    assert type(res.network).__name__ == "ResidualEncoderUNet"
    assert np.isfinite(float(res.train_step_host(res.dataloader_train.generate_train_batch())))
