"""The port's training slice vs the JAX package's, on the CPU.

Every input comes from a numpy seed (random draws of the augmentation from a
JAX key, recomputed in ``augmentation.py``'s order) and goes through the JAX
function and its port. Tolerances, fp32 throughout:
- losses, BatchNorm, poly_lr, the optimizer: 1e-5 relative (the same fp32
  arithmetic in another order);
- the augmentation: 1e-4 absolute on O(1) images (bilinear taps, blur sums
  and the gamma's power in another order); labels exactly;
- one train step of the tiny DinoUNet of tests/test_torch_models.py (drop-path
  0, augmentation off): loss to 1e-5, the updated BatchNorm statistics to
  1e-4, every trainable gradient to 2e-3 of its tensor's largest entry,
  floored at 1e-4 of the model's largest gradient (about fifty fp32 layers of
  forward and backward, summed in another order; the floor covers biases in
  front of a norm, whose true gradient is 0; a wrong gradient is off by its
  own size).
The last test trains the port's DinoUNet trainer end to end on a synthetic
64 x 64 dataset, 1 epoch of 2 iterations, and resumes from its checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.layers import BatchNorm
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.training import augmentation as taug
from dinounet_tpu_torch.training.losses import dc_and_ce_loss
from dinounet_tpu_torch.training.lr_scheduler import poly_lr
from dinounet_tpu_torch.training.trainer import clip_and_step, sgd_nesterov
from dinounet_tpu_torch.utilities.synthetic_dataset import write_disk_ring_dataset
from tests.test_torch_models import CFG_KW, FEATURES, HW, N_CLASSES, VIT_KW, variables  # noqa: F401

ARCH = {"n_stages": 4, "features_per_stage": list(FEATURES), "kernel_sizes": [[3, 3]] * 4,
        "strides": [[1, 1], [2, 2], [2, 2], [2, 2]], "n_conv_per_stage": [2] * 4,
        "n_conv_per_stage_decoder": [2, 2, 2], "conv_bias": True,
        "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
        "norm_op_kwargs": {"eps": 1e-05, "affine": True}, "nonlin": "torch.nn.LeakyReLU",
        "nonlin_kwargs": {"inplace": True}}


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("ignore_label", [None, 3])
def test_dc_and_ce_loss_and_grad_match_jax(batch_dice, ignore_label):
    from dinounet_tpu.training.losses import dc_and_ce_loss as jax_loss

    rng = np.random.default_rng(20)
    logits = rng.standard_normal((2, 3, 9, 7)).astype(np.float32) * 2
    target = rng.integers(0, 3 if ignore_label is None else 4, (2, 9, 7))
    kw = dict(batch_dice=batch_dice, smooth=1e-5, do_bg=False, ignore_label=ignore_label)
    tl = torch.tensor(logits, requires_grad=True)
    got = dc_and_ce_loss(tl, torch.from_numpy(target), **kw)
    (g_got,) = torch.autograd.grad(got, tl)
    want, g_want = jax.value_and_grad(
        lambda x: jax_loss(x, jnp.asarray(target), **kw))(
        jnp.asarray(np.moveaxis(logits, 1, -1)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g_got.numpy(), np.moveaxis(np.asarray(g_want), -1, 1),
                               rtol=1e-5, atol=1e-8)


def test_other_losses_match_jax():
    """dc_and_bce (regions, with an ignore channel), dc_and_topk, the
    tp/fp/fn/tn counts and the deep-supervision weights and sum."""
    from dinounet_tpu.training import losses as jl
    from dinounet_tpu_torch.training import losses as tl

    rng = np.random.default_rng(25)
    logits = rng.standard_normal((2, 3, 8, 6)).astype(np.float32) * 2
    nhwc = jnp.asarray(np.moveaxis(logits, 1, -1))
    regions = (rng.uniform(size=(2, 3, 8, 6)) < 0.4).astype(np.float32)  # last = ignore
    target = rng.integers(0, 3, (2, 8, 6))
    tlog = torch.from_numpy(logits)
    cases = [
        (tl.dc_and_bce_loss(tlog[:, :2], torch.from_numpy(regions), use_ignore_label=True),
         jl.dc_and_bce_loss(nhwc[..., :2], jnp.asarray(np.moveaxis(regions, 1, -1)),
                            use_ignore_label=True)),
        (tl.dc_and_bce_loss(tlog, torch.from_numpy(regions)),
         jl.dc_and_bce_loss(nhwc, jnp.asarray(np.moveaxis(regions, 1, -1)))),
        (tl.dc_and_topk_loss(tlog, torch.from_numpy(target), k=20.0),
         jl.dc_and_topk_loss(nhwc, jnp.asarray(target), k=20.0)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    probs = torch.softmax(tlog, 1)
    got = tl.get_tp_fp_fn_tn(probs, torch.from_numpy(target))
    want = jl.get_tp_fp_fn_tn(jax.nn.softmax(nhwc, -1), jnp.asarray(target))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert tl.deep_supervision_weights(4) == jl.deep_supervision_weights(4)
    outs = [tlog, tlog[:, :, ::2, ::2]]
    tgts = [torch.from_numpy(target), torch.from_numpy(target[:, ::2, ::2])]
    got = tl.deep_supervision_loss(tl.dc_and_ce_loss, outs, tgts, [0.6, 0.4])
    want = jl.deep_supervision_loss(jl.dc_and_ce_loss, [nhwc, nhwc[:, ::2, ::2]],
                                    [jnp.asarray(t.numpy()) for t in tgts], [0.6, 0.4])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_poly_lr_matches_jax():
    from dinounet_tpu.training.lr_scheduler import poly_lr as jax_poly_lr

    for epoch in (0, 1, 17, 999):
        assert poly_lr(1e-2, epoch, 1000) == jax_poly_lr(1e-2, epoch, 1000)


# --------------------------------------------------------------- BatchNorm


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics with the biased variance, and ra = 0.9 ra + 0.1 stat
    for both running statistics (flax momentum 0.9)."""
    from flax import linen as nn

    rng = np.random.default_rng(21)
    x = (rng.standard_normal((3, 6, 5, 4)) * 2 + 0.5).astype(np.float32)  # NCHW
    scale, bias = rng.uniform(0.5, 1.5, 6), rng.standard_normal(6) * 0.1
    mean, var = rng.standard_normal(6) * 0.1, rng.uniform(0.5, 1.5, 6)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                            "bias": jnp.asarray(bias, jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                                 "var": jnp.asarray(var, jnp.float32)}}
    want, upd = bn.apply(variables, jnp.asarray(np.moveaxis(x, 1, -1)),
                         mutable=["batch_stats"])
    port = BatchNorm(6)
    port.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias),
                          "running_mean": torch.tensor(mean),
                          "running_var": torch.tensor(var),
                          "num_batches_tracked": torch.tensor(0)})
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), upd["batch_stats"]["mean"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), upd["batch_stats"]["var"],
                               rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ augmentation


def _draws_from_jax_key(key, C, cfg):
    """The draws JAX's _augment_one takes from `key`, in its order."""
    def u(k, shape=(), lo=0.0, hi=1.0):
        return np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    keys = jax.random.split(key, 18)
    k_prot, k_rot, k_pscale, k_scale = jax.random.split(keys[0], 4)
    d = taug.AugmentDraws()
    if u(k_prot) < cfg.p_rotation:
        d.angle = float(u(k_rot, lo=cfg.rotation_range[0], hi=cfg.rotation_range[1]))
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
    do_lr = u(keys[11]) < cfg.p_lowres
    on = u(keys[12], (C,)) < cfg.p_lowres_per_channel
    zooms = u(keys[13], (C,), *cfg.lowres_zoom)
    d.lowres_zooms = tuple(float(z) if do_lr and o else None for z, o in zip(zooms, on))
    for name, k, p in (("gamma_invert", keys[14], cfg.p_gamma_invert),
                       ("gamma", keys[15], cfg.p_gamma)):
        k_p, k_side, k_lo, k_hi = jax.random.split(k, 4)
        if u(k_p) < p:
            lo = u(k_lo, lo=cfg.gamma_range[0], hi=1.0)
            hi = u(k_hi, lo=1.0, hi=cfg.gamma_range[1])
            setattr(d, name, float(lo if u(k_side) < 0.5 else hi))
    d.flips = tuple(bool(a in cfg.mirror_axes and u(k) < 0.5)
                    for a, k in ((0, keys[16]), (1, keys[17])))
    return d


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_one_matches_jax_given_its_draws(seed, order):
    import dataclasses

    from dinounet_tpu.training.augmentation import AugmentConfig as JaxCfg
    from dinounet_tpu.training.augmentation import _augment_one

    probs = dict(p_rotation=1.0, p_scale=1.0, p_noise=0.7, p_blur=0.7,
                 p_brightness=0.7, p_contrast=0.7, p_lowres=0.7, p_gamma_invert=0.5,
                 p_gamma=0.7, use_mask_for_norm=(True, False), patch_size=(24, 20),
                 data_interp_order=order)
    cfg = taug.AugmentConfig(**probs)
    jcfg = JaxCfg(**probs)
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    rng = np.random.default_rng(30 + seed)
    data = rng.standard_normal((2, 31, 29)).astype(np.float32)  # (C, H, W)
    seg = rng.integers(-1, 3, (31, 29))
    key = jax.random.PRNGKey(seed)
    want_x, want_s = _augment_one(key, jnp.asarray(np.moveaxis(data, 0, -1)),
                                  jnp.asarray(seg, jnp.int32), jcfg)
    draws = _draws_from_jax_key(key, 2, cfg)
    got_x, got_s = taug.apply_augment(torch.from_numpy(data), torch.from_numpy(seg),
                                      draws, cfg)
    assert got_x.shape == (2, 24, 20) and got_s.shape == (24, 20)
    np.testing.assert_allclose(got_x.numpy(), np.moveaxis(np.asarray(want_x), -1, 0),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_augment_batch_draws_on_the_generator():
    cfg = taug.AugmentConfig(patch_size=(16, 16))
    init = taug.get_enlarged_patch_size((16, 16), np.pi, (0.85, 1.25))
    data = torch.randn((3, 1, *init), generator=torch.Generator().manual_seed(0))
    seg = torch.randint(-1, 3, (3, *init), generator=torch.Generator().manual_seed(1))
    x1, s1 = taug.augment_batch_2d(data, seg, cfg, torch.Generator().manual_seed(5))
    x2, s2 = taug.augment_batch_2d(data, seg, cfg, torch.Generator().manual_seed(5))
    assert x1.shape == (3, 1, 16, 16) and s1.shape == (3, 16, 16)
    assert torch.equal(x1, x2) and torch.equal(s1, s2) and int(s1.min()) >= 0
    assert np.array_equal(taug.get_enlarged_patch_size((512, 512), np.pi, (0.85, 1.25)),
                          __import__("dinounet_tpu.training.augmentation", fromlist=["x"])
                          .get_enlarged_patch_size((512, 512), np.pi, (0.85, 1.25)))


# --------------------------------------------------------------- data loader


def test_data_loader_2d_matches_jax_under_one_seed(tmp_path):
    from dinounet_tpu.training import dataloading as jdl
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans
    from dinounet_tpu_torch.training import dataloading as tdl
    from dinounet_tpu_torch.utilities.json_export import load_json
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    base = write_disk_ring_dataset(str(tmp_path), "Dataset991_Loader", 5, (40, 36),
                                   (24, 24), 3, ARCH, seed=4)
    plans = load_json(os.path.join(base, "nnUNetPlans.json"))
    dsj = load_json(os.path.join(base, "dataset.json"))
    folder = os.path.join(base, "nnUNetPlans_2d")
    loaders = []
    for dl, pm in ((jdl, JaxPlans(plans)), (tdl, PlansManager(plans))):
        loaders.append(dl.nnUNetDataLoader2D(
            dl.nnUNetDataset(folder), 3, (30, 30), (24, 24), pm.get_label_manager(dsj),
            0.33, rng=np.random.default_rng(9)))
    for _ in range(4):
        want, got = (ld.generate_train_batch() for ld in loaders)
        assert got["keys"] == want["keys"]
        np.testing.assert_array_equal(got["data"], want["data"])
        np.testing.assert_array_equal(got["seg"], want["seg"])


def test_crossval_split_matches_jax():
    from dinounet_tpu.utilities.misc import generate_crossval_split as jax_split
    from dinounet_tpu_torch.utilities.misc import generate_crossval_split

    for n in (5, 6, 13):
        ids = [f"case_{i:03d}" for i in range(n)]
        assert generate_crossval_split(ids) == jax_split(ids)


# --------------------------------------------------------------- optimizer


def test_optimizer_matches_optax_chain_over_three_steps():
    """clip_by_global_norm(12) -> add_decayed_weights(3e-5) ->
    trace(0.99, nesterov) -> scale by -lr (dinounet_tpu/training/trainer.py:
    230-242), against sgd_nesterov + clip_and_step."""
    import optax

    rng = np.random.default_rng(22)
    shapes = [(5, 4), (7,), (3, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    lr = 0.01
    tx = optax.chain(optax.clip_by_global_norm(12.0), optax.add_decayed_weights(3e-5),
                     optax.trace(decay=0.99, nesterov=True),
                     optax.scale_by_learning_rate(lr))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = sgd_nesterov(tp, lr, 3e-5)
    for step, scale in enumerate((20.0, 0.5, 8.0)):  # clipped, not clipped, clipped
        grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        clip_and_step(opt, 12.0)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step}")


# ---------------------------------------------------------- one train step


def test_train_step_matches_jax(variables):  # noqa: F811
    """Loss, every trainable gradient and the updated BatchNorm statistics of
    one train-mode step (drop-path 0, checkpointed adapter, augmentation
    off), fp32, from the same weights and batch."""
    from dinounet_tpu.models.dinounet import DinoUNet, DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig
    from dinounet_tpu.training.losses import dc_and_ce_loss as jax_loss

    rng = np.random.default_rng(23)
    image = rng.standard_normal((2, 1, HW, HW)).astype(np.float32)
    target = rng.integers(0, N_CLASSES, (2, HW, HW))
    kw = dict(batch_dice=True, smooth=1e-5, do_bg=False, ignore_label=None)

    jmodel = DinoUNet(DinoUNetConfig(vit=ViTConfig(**VIT_KW, dtype="float32"),
                                     dtype="float32", drop_path_rate=0.0, **CFG_KW))

    @jax.jit
    def step(params, batch_stats, x):
        def loss_of(p):
            out, mut = jmodel.apply({"params": p, "batch_stats": batch_stats}, x,
                                    train=True, mutable=["batch_stats"])
            return jax_loss(out, jnp.asarray(target), **kw), mut["batch_stats"]
        return jax.value_and_grad(loss_of, has_aux=True)(params)

    (want_loss, want_bs), want_grads = step(
        variables["params"], variables["batch_stats"],
        jnp.asarray(np.moveaxis(image, 1, -1)))

    cfg = TorchConfig(vit=TorchViTConfig(**VIT_KW, dtype="float32"), dtype="float32",
                      drop_path_rate=0.0, **CFG_KW)
    model = TorchDinoUNet(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.train()
    loss = dc_and_ce_loss(model(torch.from_numpy(image)), torch.from_numpy(target), **kw)
    loss.backward()

    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = state_dict_from_flax({"params": want_grads})
    stats = state_dict_from_flax({"batch_stats": want_bs})
    # a bias feeding a train-mode BatchNorm has a true gradient of 0 (the
    # norm removes it) and both sides return rounding noise there: floor the
    # per-tensor scale at 1e-4 of the largest gradient of the model
    floor = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    worst = {}
    for name, p in model.named_parameters():
        if name.startswith("encoder.dinov3_adapter.backbone."):
            assert not p.requires_grad and p.grad is None, name
            continue
        want = grads[name].numpy()
        # heads the forward does not use (the lower deep-supervision heads)
        # get no gradient here and a zero one in JAX
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(want).max()), floor)
        worst[name] = float(np.abs(got - want).max()) / scale
    assert len(worst) > 100
    assert max(worst.values()) <= 2e-3, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    buffers = dict(model.named_buffers())
    for name, want in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_drop_path_draws_survive_the_checkpoint_recompute():
    """With drop-path on, the checkpointed adapter gives the gradients of the
    same model run without the checkpoint under the same draws."""
    cfg = TorchConfig(vit=TorchViTConfig(**VIT_KW, dtype="float32"), dtype="float32",
                      drop_path_rate=0.5, **CFG_KW)
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (3, 1, HW, HW)).astype(np.float32))
    grads = []
    for remat in (True, False):
        model = TorchDinoUNet(cfg).init_weights(seed=1).train()
        adapter = model.encoder.dinov3_adapter
        adapter.remat = remat
        adapter.drop_path_generator = torch.Generator().manual_seed(3)
        model(x).square().mean().backward()
        grads.append([p.grad for p in model.parameters() if p.requires_grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b)


# ---------------------------------------------------------------- end to end


def test_dinounet_trainer_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """The port's DinoUNet trainer, with the tiny model, through
    get_trainer_from_args: 1 epoch x 2 iterations, checkpoint_final.pth,
    then a fresh trainer resumes from it with the same weights (as
    tests/test_training_e2e.py:29-92 does for the JAX trainer)."""
    from dinounet_tpu_torch.run import get_trainer_from_args, maybe_load_checkpoint
    from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer
    from dinounet_tpu_torch.utilities import registry

    for sub in ("pre", "res"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    write_disk_ring_dataset(str(tmp_path / "pre"), "Dataset992_Tiny", 6, (72, 72),
                            (HW, HW), 2, ARCH, seed=5)

    class TinyDinoUNetTrainer(DinoUNetTrainer):
        @classmethod
        def build_network_architecture(cls, *args, **kwargs):
            return TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**VIT_KW), **CFG_KW))

    registry.trainers.add("TinyDinoUNetTrainer", TinyDinoUNetTrainer)
    trainer = get_trainer_from_args(992, "2d", 0, "TinyDinoUNetTrainer", device="cpu")
    trainer.seed = 0
    trainer.num_epochs = 1
    trainer.num_iterations_per_epoch = 2
    trainer.num_val_iterations_per_epoch = 1
    trainer.run_training()

    final = os.path.join(trainer.output_folder, "checkpoint_final.pth")
    assert os.path.isfile(final)
    log = trainer.logger.my_fantastic_logging
    assert len(log["train_losses"]) == 1 and np.isfinite(log["train_losses"][0])
    assert np.isfinite(log["val_losses"][0])
    backbone = trainer.network.encoder.dinov3_adapter.backbone
    assert all(not p.requires_grad for p in backbone.parameters())

    resumed = get_trainer_from_args(992, "2d", 0, "TinyDinoUNetTrainer", device="cpu")
    maybe_load_checkpoint(resumed, continue_training=True, validation_only=False)
    assert resumed.current_epoch == 1
    for (name, a), b in zip(trainer.network.state_dict().items(),
                            resumed.network.state_dict().values()):
        assert torch.equal(a, b), name
    assert resumed.optimizer.state_dict()["state"].keys() == \
        trainer.optimizer.state_dict()["state"].keys()


def test_batch_prefetcher_orders_batches_and_surfaces_errors():
    from dinounet_tpu_torch.training.trainer import nnUNetTrainer

    class Loader:
        i = 0

        def generate_train_batch(self):
            self.i += 1
            if self.i > 3:
                raise ValueError("boom")
            return {"n": self.i}

    pf = nnUNetTrainer._BatchPrefetcher(Loader())
    assert [pf.next()["n"] for _ in range(3)] == [1, 2, 3]
    with pytest.raises(ValueError, match="boom"):
        pf.next()
    pf.close()


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """The cascade still raises; 3-D configurations and DinoUNet's
    deep-supervision outputs are ported (tests/test_torch_3d.py,
    tests/test_torch_unet.py) and build."""
    from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer_7b
    from dinounet_tpu_torch.training.trainer import nnUNetTrainer

    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path))
    monkeypatch.setenv("nnUNet_results", str(tmp_path))
    plans = {"dataset_name": "Dataset992_Tiny", "plans_name": "nnUNetPlans",
             "configurations": {
                 "3d_fullres": {"patch_size": [HW, HW, HW],
                                "data_identifier": "nnUNetPlans_3d_fullres"},
                 "3d_cascade_fullres": {"inherits_from": "3d_fullres",
                                        "previous_stage": "3d_lowres"}}}
    labels = {"labels": {"background": 0, "a": 1}}
    with pytest.raises(NotImplementedError):  # the cascade
        nnUNetTrainer(plans, "3d_cascade_fullres", 0, labels, device="cpu")
    trainer = DinoUNetTrainer_7b(plans, "3d_fullres", 0, labels, device="cpu")
    assert trainer.configuration_manager.patch_size == [HW, HW, HW]
    model = TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**VIT_KW), deep_supervision=True,
                                      **CFG_KW))
    assert model.cfg.deep_supervision
