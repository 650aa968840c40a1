"""The cascade (3d_lowres -> 3d_cascade_fullres) in the port vs the JAX
package, on the CPU.

The random draws come from JAX keys, recomputed in the JAX functions' order;
a removal's seed is the JAX argmax's voxel, given to the port as its rank
among the foreground voxels. Tolerances:
- ``component_of_seed``, ``remove_random_component`` (with and without
  marking another channel) and ``cascade_onehot_augment`` in 2-D and 3-D:
  equal (0/1 maps); the component also equals ``scipy.ndimage.label``'s;
- both loaders with a previous-stage folder: the map as the last label
  channel, batches equal to the JAX loaders' under one numpy seed;
- a cascade train step's network input (the 3-D augmentation's image
  channel 1e-4 absolute, as ``tests/test_torch_3d.py`` holds it; the one-hot
  channels and the labels equal) and a validation step's (equal);
- ``predict_single_npy_array`` with a previous-stage map on the same
  weights (a 3-input-channel PlainConvUNet bridged from the JAX tree):
  the network's input (the image and the map's one-hot channels) equal;
  segmentations equal on >= 99.9 % of the voxels (the rule of
  ``tests/test_torch_pipeline.py``); the fp16 logits within one fp16 ulp at
  their largest magnitude plus 1e-4 (the fp32 networks agree to ~3e-5, then
  both round to fp16), and the probabilities within 1e-4 plus half the
  largest logit difference (the softmax's steepest slope): the pipeline
  file's plain 1e-4 holds for small logits only, and these reach 4.5, where
  one ulp is 0.004;
- ``resample_and_save``'s next-stage segmentation: equal.
The last test runs the cascade end to end on the port (the counterpart of
``tests/test_training_e2e.py::test_cascade_end_to_end``, with the rest of
nnU-Net's workflow after it): a tiny raw NIfTI set whose plans are wired
into a lowres / cascade pair by hand, 3d_lowres on two folds exporting
``predicted_next_stage``, 3d_cascade_fullres on two folds, find_best_configuration,
the two-stage prediction, the ensemble and the postprocessing.
"""

import dataclasses
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from dinounet_tpu_torch.training import augmentation as taug
from tests.test_torch_3d import _draws_3d_from_jax_key
from tests.torch_threads import one_torch_thread  # noqa: F401

ID, DATASET = 604, "Dataset604_Cascade"
SIZE = (20, 24, 24)
CASES = [f"case_{i:03d}" for i in range(4)]
SPLITS = [{"train": CASES[2:], "val": CASES[:2]}, {"train": CASES[:2], "val": CASES[2:]}]
FG = (1, 2)
SEG_AGREEMENT, PROBABILITY_ATOL = 0.999, 1e-4


# ------------------------------------------------------------------- draws


# The JAX functions, jitted (as the JAX trainer's step runs them): one
# compile a shape and static option, where their eager calls compile each
# operation; the random bits and the 0/1 maps are the same either way.

@functools.lru_cache(maxsize=None)
def _jax_cascade(p_remove_component: float, labels=FG):
    from dinounet_tpu.training.augmentation import cascade_onehot_augment

    return jax.jit(lambda key, prev, p_binary_op: cascade_onehot_augment(
        key, prev, labels, p_binary_op=p_binary_op, p_remove_component=p_remove_component))


@functools.lru_cache(maxsize=None)
def _jax_remove(fill_p: float):
    from dinounet_tpu.training.augmentation import remove_random_component

    return jax.jit(lambda key, onehot, p: remove_random_component(
        key, onehot, p_per_sample=p, fill_with_other_class_p=fill_p))


@functools.lru_cache(maxsize=None)
def _jax_component(max_iters: int):
    from dinounet_tpu.training.augmentation import component_of_seed

    return jax.jit(lambda mask, seed: component_of_seed(mask, seed, max_iters))



def _u(key, shape=()):
    return np.asarray(jax.random.uniform(key, shape))


def _morph_draws(key, n, p_binary_op=0.4, radii=(1, 2, 3)):
    """Per channel (operator, radius) or None, as cascade_onehot_augment
    takes them from `key`."""
    keys = jax.random.split(key, 3 * n)
    keys = keys.reshape(n, 3, *keys.shape[1:])
    out = []
    for f in range(n):
        k_p, k_op, k_r = keys[f, 0], keys[f, 1], keys[f, 2]
        r_idx = int(jax.random.randint(k_r, (), 1, len(radii) + 1))
        op = int(jax.random.randint(k_op, (), 0, 4))
        out.append((op, radii[r_idx - 1]) if _u(k_p) < p_binary_op else None)
    return tuple(out)


def _remove_draws(key, onehot: np.ndarray, p_per_sample=0.2, fill_p=0.0,
                  max_covered_frac=0.15) -> taug.RemoveDraws:
    """The draws remove_random_component takes from `key` for onehot
    (F, *spatial); the channels as each one's turn finds them are followed
    with scipy's labelling (exact, as component_of_seed is)."""
    n = onehot.shape[0]
    k_sample, k_ch = jax.random.split(key)
    if not _u(k_sample) < p_per_sample:
        return taug.RemoveDraws()
    chans = [c.astype(np.float32) for c in onehot]
    seeds, fills, others = [], [], []
    for c in range(n):
        k_seed, k_fill, k_other = jax.random.split(jax.random.fold_in(k_ch, c), 3)
        mask = chans[c] > 0.5
        scores = np.where(mask, _u(k_seed, mask.shape), -1.0)
        flat = int(np.argmax(scores.reshape(-1)))
        count = int(mask.sum())
        seeds.append((int(mask.reshape(-1)[:flat].sum()) + 0.5) / count if count else 0.5)
        fill = n > 1 and fill_p > 0 and bool(_u(k_fill) < fill_p)
        other = 0
        if n > 1 and fill_p > 0:
            other = int(jax.random.randint(k_other, (), 0, n - 1))
            other = other + 1 if other >= c else other
        fills.append(fill)
        others.append(other)
        if count:
            lab, _ = ndi.label(mask)
            comp = (lab == lab.reshape(-1)[flat]).astype(np.float32)
            if comp.sum() < max_covered_frac * mask.size:
                chans[c] = chans[c] * (1 - comp)
                if fill:
                    chans[other] = np.maximum(chans[other], comp)
    return taug.RemoveDraws(True, tuple(seeds), tuple(fills), tuple(others))


def _cascade_draws(key, prev: np.ndarray, labels=FG, p_binary_op=0.4,
                   p_remove_component=0.2) -> taug.CascadeDraws:
    """The draws cascade_onehot_augment takes from `key` for the map prev."""
    morphed = np.moveaxis(np.asarray(_jax_cascade(0.0, tuple(labels))(
        key, jnp.asarray(prev), p_binary_op)), -1, 0)
    return taug.CascadeDraws(
        _morph_draws(key, len(labels), p_binary_op),
        _remove_draws(jax.random.fold_in(key, 0x5eed), morphed, p_remove_component))


def _blobs(rng, shape, n_blobs: int) -> np.ndarray:
    """A 0/1 map of small boxes, some touching diagonally only."""
    m = np.zeros(shape, np.float32)
    for _ in range(n_blobs):
        lo = [int(rng.integers(1, s - 4)) for s in shape]
        m[tuple(slice(a, a + int(rng.integers(2, 4))) for a in lo)] = 1.0
    return m


# ------------------------------------------------------------ augmentation


@pytest.mark.parametrize("shape", [(24, 24), (8, 10, 12)])
def test_component_of_seed_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(len(shape))
    for _ in range(3):
        m = (rng.uniform(size=shape) < 0.45).astype(np.float32)
        fg = np.argwhere(m > 0)
        seed = np.zeros_like(m)
        at = tuple(fg[rng.integers(len(fg))])
        seed[at] = 1.0
        lab, _ = ndi.label(m)
        for max_iters in (512, 3):  # to the fixpoint, and cut short
            got = taug.component_of_seed(torch.from_numpy(m)[None], torch.from_numpy(seed)[None],
                                         max_iters)[0].numpy()
            want = np.asarray(_jax_component(max_iters)(jnp.asarray(m), jnp.asarray(seed)))
            np.testing.assert_array_equal(got, want)
        full = taug.component_of_seed(torch.from_numpy(m)[None], torch.from_numpy(seed)[None])
        np.testing.assert_array_equal(full[0].numpy(), (lab == lab[at]).astype(np.float32))


@pytest.mark.parametrize("fill_p", [0.0, 1.0])
@pytest.mark.parametrize("shape", [(16, 16), (8, 10, 10)])
def test_remove_random_component_matches_jax(shape, fill_p):
    rng = np.random.default_rng(7)
    onehot = np.stack([_blobs(rng, shape, 4), _blobs(rng, shape, 3)])
    for seed, p in ((0, 1.0), (1, 1.0), (2, 1.0), (3, 0.0)):
        key = jax.random.PRNGKey(seed)
        want = np.moveaxis(np.asarray(_jax_remove(fill_p)(
            key, jnp.asarray(np.moveaxis(onehot, 0, -1)), p)), -1, 0)
        draws = _remove_draws(key, onehot, p, fill_p)
        assert draws.apply == (p == 1.0)
        got = taug.remove_random_component(torch.from_numpy(onehot), draws).numpy()
        np.testing.assert_array_equal(got, want)
        if p == 1.0 and fill_p == 0.0:
            assert (onehot - got).sum() > 0  # something was removed
        if p == 1.0 and fill_p == 1.0:  # conserved over the union
            np.testing.assert_array_equal(got.max(0), onehot.max(0))


@pytest.mark.parametrize("shape", [(20, 20), (10, 12, 12)])
def test_cascade_onehot_augment_matches_jax(shape):
    rng = np.random.default_rng(3)
    prev = (_blobs(rng, shape, 4) + 2 * _blobs(rng, shape, 3)).clip(0, 2).astype(np.int32)
    prev[tuple(slice(0, 2) for _ in shape)] = -1  # padding the loader leaves
    seen = set()
    for seed, p_op, p_rm in ((0, 1.0, 1.0), (1, 1.0, 1.0), (2, 0.4, 1.0), (3, 1.0, 0.0),
                             (4, 1.0, 1.0), (5, 1.0, 1.0)):
        key = jax.random.PRNGKey(seed)
        want = np.moveaxis(np.asarray(_jax_cascade(p_rm)(key, jnp.asarray(prev), p_op)), -1, 0)
        draws = _cascade_draws(key, prev, FG, p_op, p_rm)
        seen.update(m[0] for m in draws.morph if m is not None)
        got = taug.cascade_onehot_augment(torch.from_numpy(prev), FG, draws).numpy()
        assert got.shape == (2, *shape) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert seen == {0, 1, 2, 3}  # every operator was held


def test_draw_cascade_probabilities():
    """The host draws: the JAX function's coins, operators and radii."""
    gen = torch.Generator().manual_seed(0)
    draws = [taug.draw_cascade(gen, 2) for _ in range(2000)]
    morph = [m for d in draws for m in d.morph]
    assert abs(np.mean([m is not None for m in morph]) - 0.4) < 0.03
    assert {m for m in morph if m is not None} == {(op, r) for op in range(4) for r in (1, 2, 3)}
    assert abs(np.mean([d.remove.apply for d in draws]) - 0.2) < 0.03
    seeds = [u for d in draws for u in d.remove.seed_u]
    assert min(seeds) >= 0 and max(seeds) < 1 and not any(any(d.remove.fill) for d in draws)
    fill = [taug.draw_remove_component(gen, 3, 1.0, 1.0) for _ in range(200)]
    assert all(o != c for d in fill for c, o in enumerate(d.other))
    assert {o for d in fill for o in d.other} == {0, 1, 2}


# -------------------------------------------------------------- the trainer


def _env(monkeypatch, root) -> None:
    for sub in ("raw", "preprocessed", "results"):
        monkeypatch.setenv("nnUNet_" + sub, os.path.join(str(root), sub))


@pytest.fixture(scope="module")
def cascade_set(tmp_path_factory):
    """A raw NIfTI set of 4 labelled and 1 test volume of SIZE, planned by
    the port's default planner, its 3d_fullres wired by hand into a cascade
    pair (as the JAX package's cascade test does; the planner makes one only
    for volumes of about 256^3): 3d_lowres at 1.25x the spacing exporting to
    3d_cascade_fullres; both preprocessed; a two-fold split file. The
    networks keep the planned stages at a quarter of the planned widths, so
    that the CPU runs them quickly."""
    from dinounet_tpu_torch.planning import fingerprint
    from dinounet_tpu_torch.planning.plan_and_preprocess_api import (extract_fingerprints,
                                                                     plan_experiments,
                                                                     preprocess)
    from dinounet_tpu_torch.utilities.json_export import load_json, save_json
    from dinounet_tpu_torch.utilities.synthetic_dataset import write_sphere_shell_raw_dataset

    root = tmp_path_factory.mktemp("cascade")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, root)
        init = fingerprint.DatasetFingerprintExtractor.__init__

        def fast_init(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = 1e5

        mp.setattr(fingerprint.DatasetFingerprintExtractor, "__init__", fast_init)
        raw = write_sphere_shell_raw_dataset(os.path.join(str(root), "raw"), DATASET,
                                             len(CASES), 1, SIZE, seed=0)
        extract_fingerprints([ID], num_processes=1)
        pid = plan_experiments([ID])
        pre = os.path.join(str(root), "preprocessed", DATASET)
        plans = load_json(os.path.join(pre, pid + ".json"))
        full = plans["configurations"]["3d_fullres"]
        arch = full["architecture"]["arch_kwargs"]
        arch["features_per_stage"] = [f // 4 for f in arch["features_per_stage"]]
        plans["configurations"]["3d_lowres"] = dict(
            full, data_identifier=f"{pid}_3d_lowres", next_stage="3d_cascade_fullres",
            spacing=[s * 1.25 for s in full["spacing"]],
            median_image_size_in_voxels=[round(n / 1.25) for n in
                                         full["median_image_size_in_voxels"]])
        plans["configurations"]["3d_cascade_fullres"] = {"inherits_from": "3d_fullres",
                                                         "previous_stage": "3d_lowres"}
        save_json(plans, os.path.join(pre, pid + ".json"), sort_keys=False)
        preprocess([ID], pid, ["3d_fullres", "3d_lowres"], [1, 1])
        save_json(SPLITS, os.path.join(pre, "splits_final.json"))
    return str(root), raw, pid, plans


def _cascade_trainer(monkeypatch, cascade_set, fold=0):
    from dinounet_tpu_torch.run import get_trainer_from_args

    root, _, pid, _ = cascade_set
    _env(monkeypatch, root)
    return get_trainer_from_args(ID, "3d_cascade_fullres", fold, "nnUNetTrainer", pid,
                                 device="cpu")


def test_cascade_step_inputs_match_jax(cascade_set, monkeypatch):
    """The network input of a cascade train step (the JAX step's lines
    ``trainer.py:430-448``: augment data and both label channels, split the
    previous map off, augment it to one-hot channels with a key a sample,
    concatenate) and of a validation step (``:480-485``), for one batch."""
    from dinounet_tpu.training import augmentation as jaug
    from dinounet_tpu_torch.training import trainer as trainer_module

    trainer = _cascade_trainer(monkeypatch, cascade_set)
    assert trainer.is_cascaded
    patch = (8, 12, 12)
    probs = dict(p_rotation=1.0, p_scale=0.5, p_noise=0.5, p_gamma=0.5, patch_size=patch)
    cfg = taug.AugmentConfig3D(**probs)
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2, 1, 10, 15, 15)).astype(np.float32)
    seg = np.stack([_blobs(rng, (10, 15, 15), 5) for _ in range(2)])
    prev = np.stack([(_blobs(rng, (10, 15, 15), 8) + 2 * _blobs(rng, (10, 15, 15), 6)).clip(0, 2)
                     for _ in range(2)])
    prev[:, :1] = -1
    seg = np.stack([seg, prev], 1).astype(np.int16)  # (B, 2, D, H, W), the loader's

    key = jax.random.PRNGKey(9)
    aug_rng, casc_rng, _ = jax.random.split(key, 3)
    data_a, seg_a = jax.jit(lambda k, x, s: jaug.augment_batch_3d(
        k, x, s, jaug.AugmentConfig3D(**probs)))(
        aug_rng, jnp.asarray(np.moveaxis(data, 1, -1)),
        jnp.asarray(np.moveaxis(seg, 1, -1), jnp.int32))
    prev_a = np.asarray(seg_a[..., 1])
    casc_keys = jax.random.split(casc_rng, 2)
    onehot = jax.jit(jax.vmap(lambda k, p: jaug.cascade_onehot_augment(k, p, FG)))(
        casc_keys, jnp.asarray(prev_a))
    want_x = np.moveaxis(np.asarray(jnp.concatenate([data_a, onehot], -1)), -1, 1)
    want_seg = np.asarray(seg_a[..., 0])

    aug_draws = [_draws_3d_from_jax_key(k, 1, cfg) for k in jax.random.split(aug_rng, 2)]
    casc_draws = iter([_cascade_draws(k, prev_a[b], FG) for b, k in enumerate(casc_keys)])
    monkeypatch.setattr(trainer_module, "augment_batch_3d", lambda d, s, c, g: tuple(
        torch.stack(t) for t in zip(*[taug.apply_augment_3d(d[b], s[b], aug_draws[b], c)
                                      for b in range(d.shape[0])])))
    monkeypatch.setattr(taug, "draw_cascade", lambda gen, n: next(casc_draws))
    seen = {}
    trainer.network = torch.nn.Conv3d(3, 3, 1)
    trainer.network.register_forward_pre_hook(lambda m, args: seen.setdefault(
        "x" if m.training else "val_x", args[0].detach().clone()))
    trainer.optimizer = torch.optim.SGD(trainer.network.parameters(), lr=0.1)
    trainer.augment_cfg, trainer._aug_gen = cfg, torch.Generator()

    def train_loss(out, target):
        seen["seg"] = target
        return out.float().mean()

    trainer._train_loss = train_loss
    trainer.train_step_host({"data": data, "seg": seg})
    got = seen["x"].numpy()
    assert got.shape == (2, 3, *patch)
    np.testing.assert_allclose(got[:, :1], want_x[:, :1], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got[:, 1:], want_x[:, 1:])
    np.testing.assert_array_equal(seen["seg"].numpy(), want_seg)

    trainer.validation_step_host({"data": data, "seg": seg})
    val_prev = jnp.where(seg[:, 1] < 0, 0, seg[:, 1])
    want_val = np.concatenate([data, np.stack([np.asarray(val_prev == label, np.float32)
                                               for label in FG], 1)], 1)
    np.testing.assert_array_equal(seen["val_x"].numpy(), want_val)


@pytest.mark.parametrize("dim", [2, 3])
def test_loaders_stack_the_previous_stage_last_and_match_jax(cascade_set, tmp_path, dim):
    """Both loaders read the previous stage's segmentation (the .npz that
    the next-stage export writes) as the last label channel, -1 where they
    pad, and equal the JAX loaders' batches under one numpy seed."""
    from dinounet_tpu.training import dataloading as jdl
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans
    from dinounet_tpu_torch.training import dataloading as tdl
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    root, raw, pid, plans = cascade_set
    folder = os.path.join(root, "preprocessed", DATASET, f"{pid}_3d_fullres")
    prev_folder = str(tmp_path / "predicted_next_stage")
    os.makedirs(prev_folder)
    for i, c in enumerate(CASES):
        seg = np.load(os.path.join(folder, c + ".npz"))["seg"][0]
        np.savez_compressed(os.path.join(prev_folder, c + ".npz"),
                            seg=np.roll(seg, i + 1, axis=-1).astype(np.uint8))
    labels = {"labels": {"background": 0, "sphere": 1, "shell": 2}}
    patch = (14, 20, 20) if dim == 3 else (20, 20)
    batches = []
    for dl, pm in ((jdl, JaxPlans(plans)), (tdl, PlansManager(plans))):
        loader = dl.nnUNetDataLoader3D if dim == 3 else dl.nnUNetDataLoader2D
        ld = loader(dl.nnUNetDataset(folder, CASES,
                                     folder_with_segs_from_previous_stage=prev_folder),
                    2, (24, 28, 28) if dim == 3 else (28, 28), patch,
                    pm.get_label_manager(labels), 0.33, rng=np.random.default_rng(4))
        batches.append([ld.generate_train_batch() for _ in range(3)])
    for want, got in zip(*batches):
        assert got["keys"] == want["keys"] and got["seg"].shape[1] == 2
        np.testing.assert_array_equal(got["data"], want["data"])
        np.testing.assert_array_equal(got["seg"], want["seg"])
    segs = np.concatenate([b["seg"] for b in batches[1]])
    assert (segs[:, 1] == -1).any() and set(np.unique(segs[:, 1])) <= {-1, 0, 1, 2}
    assert not np.array_equal(segs[:, 0], segs[:, 1])  # the map, not the labels again


def _predictor_pair(plans, dataset_json, seed=0):
    """The cascade configuration's PlainConvUNet (1 + 2 input channels) in
    both packages' predictors, on the same weights, without mirroring (the
    input path is what differs from tests/test_torch_pipeline.py)."""
    from dinounet_tpu.inference.predictor import nnUNetPredictor as JaxPredictor
    from dinounet_tpu.models import plain_unet
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans
    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
    from dinounet_tpu_torch.models.convert import state_dict_from_flax
    from dinounet_tpu_torch.models.plain_unet import PlainConvUNet, PlainUNetConfig
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager
    from tests.test_torch_unet import seeded_variables

    pm, jpm = PlansManager(plans), JaxPlans(plans)
    cm = pm.get_configuration("3d_cascade_fullres")
    arch = cm.network_arch_init_kwargs
    jnet = plain_unet.PlainConvUNet(dataclasses.replace(
        plain_unet.PlainUNetConfig.from_plans_arch(arch, 3, False), dtype="float32"))
    variables = seeded_variables(jnet, (1, *cm.patch_size, 3), seed)
    net = PlainConvUNet(dataclasses.replace(PlainUNetConfig.from_plans_arch(arch, 3, False),
                                            dtype="float32"), 3)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    jp = JaxPredictor(tile_step_size=0.5, use_mirroring=False, tile_batch=4)
    jp.manual_initialization(jnet, jpm, jpm.get_configuration("3d_cascade_fullres"),
                             [variables], dataset_json, "nnUNetTrainer", (0, 1, 2))
    p = nnUNetPredictor(tile_step_size=0.5, use_mirroring=False, device="cpu", tile_batch=4)
    p.manual_initialization(net, pm, cm, None, dataset_json, "nnUNetTrainer", (0, 1, 2))
    return jp, p


def test_predictor_with_previous_stage_matches_jax(cascade_set):
    """predict_single_npy_array with a previous-stage map: the map is
    preprocessed as the case's segmentation and appended as one-hot
    channels in both packages."""
    from dinounet_tpu_torch.imageio.nifti import NiftiIO
    from dinounet_tpu_torch.utilities.json_export import load_json

    root, raw, _, plans = cascade_set
    dataset_json = load_json(os.path.join(raw, "dataset.json"))
    jp, p = _predictor_pair(plans, dataset_json)
    seen = {}
    for name, predictor in (("jax", jp), ("port", p)):
        def recorded(data, _name=name, _fn=predictor.predict_logits_from_preprocessed_data):
            out = _fn(data)
            seen[_name] = np.array(data), np.asarray(out).astype(np.float32)
            return out

        predictor.predict_logits_from_preprocessed_data = recorded
    image, props = NiftiIO().read_images([os.path.join(raw, "imagesTr", "case_000_0000.nii.gz")])
    prev = NiftiIO().read_seg(os.path.join(raw, "labelsTr", "case_001.nii.gz"))[0][0]
    want_seg, want_p = jp.predict_single_npy_array(image, dict(props), prev, None, True)
    got_seg, got_p = p.predict_single_npy_array(image, dict(props), prev, None, True)
    (want_x, want_z), (got_x, got_z) = seen["jax"], seen["port"]
    assert got_x.shape == (3, *SIZE)
    np.testing.assert_array_equal(got_x, want_x)
    assert got_seg.shape == np.asarray(want_seg).shape == SIZE
    assert float(np.mean(got_seg == np.asarray(want_seg))) >= SEG_AGREEMENT
    ulp = float(np.spacing(np.float16(np.abs(want_z).max())))
    assert float(np.abs(got_z - want_z).max()) <= ulp + PROBABILITY_ATOL
    bound = PROBABILITY_ATOL + 0.5 * float(np.abs(got_z - want_z).max())
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=0, atol=bound)
    # without the map the network refuses the image alone
    with pytest.raises(RuntimeError):
        p.predict_single_npy_array(image, dict(props), None, None, False)


def test_resample_and_save_equals_jax(cascade_set, tmp_path):
    from dinounet_tpu.inference.export import resample_and_save as jax_resample_and_save
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans
    from dinounet_tpu_torch.inference.export import resample_and_save
    from dinounet_tpu_torch.utilities.json_export import load_json
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    root, raw, pid, plans = cascade_set
    dataset_json = load_json(os.path.join(raw, "dataset.json"))
    pre = os.path.join(root, "preprocessed", DATASET)
    with open(os.path.join(pre, f"{pid}_3d_lowres", "case_000.pkl"), "rb") as f:
        props = pickle.load(f)
    shape = np.load(os.path.join(pre, f"{pid}_3d_lowres", "case_000.npz"))["data"].shape[1:]
    target = np.load(os.path.join(pre, f"{pid}_3d_fullres", "case_000.npz"))["data"].shape[1:]
    logits = np.random.default_rng(2).standard_normal((3, *shape)).astype(np.float16)
    for name, fn, plans_manager in (("port", resample_and_save, PlansManager(plans)),
                                    ("jax", jax_resample_and_save, JaxPlans(plans))):
        fn(logits, target, str(tmp_path / f"{name}.npz"), plans_manager,
           plans_manager.get_configuration("3d_lowres"), dict(props), dataset_json)
    got, want = (np.load(tmp_path / f"{n}.npz")["seg"] for n in ("port", "jax"))
    assert got.dtype == want.dtype == np.uint8 and got.shape == tuple(target)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 1, 2}


# ---------------------------------------------------------------- end to end


def test_cascade_end_to_end(cascade_set, monkeypatch, tmp_path):
    """3d_lowres on folds 0 and 1 (its validation exports the next stage's
    inputs), 3d_cascade_fullres on folds 0 and 1 on them (3 input
    channels), find_best_configuration over the two, then the held-out
    case predicted in two stages, ensembled where the ensemble won, and
    postprocessed."""
    from dinounet_tpu_torch.ensembling.ensemble import ensemble_folders
    from dinounet_tpu_torch.evaluation.find_best_configuration import find_best_configuration
    from dinounet_tpu_torch.imageio.nifti import NiftiIO
    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
    from dinounet_tpu_torch.postprocessing.remove_connected_components import (
        apply_postprocessing_to_folder)
    from dinounet_tpu_torch.run import get_trainer_from_args

    root, raw, pid, _ = cascade_set
    _env(monkeypatch, root)
    folders = {}
    for configuration in ("3d_lowres", "3d_cascade_fullres"):
        for fold in (0, 1):
            trainer = get_trainer_from_args(ID, configuration, fold, "nnUNetTrainer", pid,
                                            device="cpu")
            trainer.seed = fold
            trainer.num_iterations_per_epoch, trainer.num_val_iterations_per_epoch = 2, 1
            trainer.num_epochs = 1
            trainer.run_training()
            assert np.isfinite(trainer.logger.my_fantastic_logging["train_losses"][-1])
            metrics = trainer.perform_actual_validation(save_probabilities=True)
            assert np.isfinite(metrics["foreground_mean"]["Dice"])
            folders[configuration] = trainer.output_folder_base
            if configuration == "3d_cascade_fullres":
                assert trainer.network.input_channels == 3
        if configuration == "3d_lowres":
            nxt = os.path.join(trainer.output_folder_base, "predicted_next_stage",
                               "3d_cascade_fullres")
            assert sorted(os.listdir(nxt)) == [c + ".npz" for c in CASES]
            fullres = os.path.join(root, "preprocessed", DATASET, f"{pid}_3d_fullres")
            for c in CASES:
                assert np.load(os.path.join(nxt, c + ".npz"))["seg"].shape == np.load(
                    os.path.join(fullres, c + ".npz"))["data"].shape[1:]

    models = [{"plans": pid, "configuration": c, "trainer": "nnUNetTrainer"}
              for c in ("3d_lowres", "3d_cascade_fullres")]
    info = find_best_configuration(ID, models, num_processes=1, folds=(0, 1))
    ensemble = (f"ensemble___nnUNetTrainer__{pid}__3d_lowres___nnUNetTrainer__{pid}"
                "__3d_cascade_fullres___0_1")
    assert set(info["all_results"]) == {os.path.basename(f) for f in folders.values()} | {
        ensemble}
    best = info["best_model_or_ensemble"]
    assert os.path.isfile(best["postprocessing_file"])
    assert os.path.isfile(os.path.join(root, "results", DATASET, "inference_information.json"))

    case = [[os.path.join(raw, "imagesTs", "case_004_0000.nii.gz")]]
    outputs = {}
    for configuration, prev in (("3d_lowres", None), ("3d_cascade_fullres", "3d_lowres")):
        p = nnUNetPredictor(device="cpu")
        p.initialize_from_trained_model_folder(folders[configuration], (0, 1))
        outputs[configuration] = str(tmp_path / configuration)
        p.predict_from_files(case, outputs[configuration], save_probabilities=True,
                             folder_with_segs_from_prev_stage=outputs.get(prev))
    members = [m["configuration"] for m in best["selected_model_or_models"]]
    source = outputs[members[0]]
    if len(members) == 2:
        source = str(tmp_path / "ensemble")
        ensemble_folders([outputs[m] for m in members], source)
    with open(best["postprocessing_file"], "rb") as f:
        pp_fns, pp_kwargs = pickle.load(f)
    assert all(fn.__module__.startswith("dinounet_tpu_torch.") for fn in pp_fns)
    apply_postprocessing_to_folder(source, str(tmp_path / "final"), pp_fns, pp_kwargs,
                                   plans_file_or_dict=best["some_plans_file"], num_processes=1)
    seg, props = NiftiIO().read_seg(str(tmp_path / "final" / "case_004.nii.gz"))
    img, img_props = NiftiIO().read_images(case[0])
    assert seg.shape == img.shape and props["spacing"] == img_props["spacing"]
    assert set(np.unique(seg)) <= {0, 1, 2}
