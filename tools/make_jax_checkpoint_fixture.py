"""Write a small JAX-trained model folder for the port's checkpoint readers.

The machine with the GPU has no JAX, so the files that the port's readers
of the JAX formats are held to there are written here, by the JAX package,
and committed (``tests/fixtures/jax_checkpoint/``, under 4 MB). The folder is
a ``DinoUNetTrainer`` model folder, written by the JAX trainer's own
``save_checkpoint``:

  DinoUNetTrainer__nnUNetPlans__2d/
    fold_0/checkpoint_final.pth   the single pickled file (model axis 1)
    fold_1/checkpoint_final.pth   the orbax directory (model axis 2 on 2
                                  virtual CPU devices: the backbone's chunks
                                  follow the model split)
    plans.json, dataset.json
  network.json     the network configuration both packages inject
  tile.npy         one input tile (1, 1, 64, 64)
  logits_fold_<f>.npy   the JAX network's fp32 logits on it (1, 3, 64, 64)
  sha256.json      every array as the JAX ``load_checkpoint`` reads it
  case.b2nd, case.npy   an nnU-Net v2 ``.b2nd`` case with zstd chunks
                        (written by the port's writer) and its array
  weights_l1.zst   one zstd frame, level 1, of 256 KiB of fp32 weights
                   (the decoder's rate on a real-sized frame; sha256.json
                   holds its content's digest)

Both folds hold a few SGD steps of momentum (the trainer's own optax
chain, fed seeded gradients). The network is DinoUNetTrainer's with its
backbone cut to one head of 64 channels, width 64 and depth 4 (the
attention kernel takes head dims of 64 and 128), the adapter and FAPM
narrowed, and the frozen backbone held in bf16; ``network.json`` says so,
and ``network_spec_patches`` applies it to the JAX package as the port's
readers apply it to theirs (a model folder does not carry its network
configuration: both packages inject it at class level).

    python -m tools.make_jax_checkpoint_fixture [--out DIR]

runs JAX on 2 virtual CPU devices (a mesh of data 1 x model 2): on 8 the
orbax directory splits every replicated array 8 ways and the folder comes
to 4.6 MB. The tests write both forms again on the test mesh (8 devices).
"""

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import sys
import tempfile

if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "fixtures", "jax_checkpoint")
TRAINER = "DinoUNetTrainer"
CONFIGURATION = "2d"
PATCH = 64
N_CLASSES = 3
LABELS = {"background": 0, "a": 1, "b": 2}
FOLD_MODEL_AXIS = {0: 1, 1: 2}
SGD_STEPS = 3
_VARIABLE_SHAPES: dict = {}  # the network's repr -> its init's eval_shape

ARCHITECTURE = {
    "n_stages": 4, "features_per_stage": [4, 8, 16, 32],
    "kernel_sizes": [[3, 3]] * 4, "strides": [[1, 1], [2, 2], [2, 2], [2, 2]],
    "n_conv_per_stage_encoder": [2, 2, 2, 2], "n_conv_per_stage_decoder": [1, 1, 1],
    "conv_bias": True, "norm_op": "instancenorm", "norm_op_kwargs": {"eps": 1e-5, "affine": True},
    "nonlin": "leaky_relu", "nonlin_kwargs": {"negative_slope": 0.01, "inplace": True},
}
# the network configuration: a ViT registered under its own names, the
# interaction indexes for its depth, and the adapter's widths
FIXTURE_NETWORK = {
    "model_name": "dinounet_fixture", "vit_name": "dinov3_fixture",
    "vit": {"embed_dim": 64, "depth": 4, "num_heads": 1, "ffn_ratio": 2,
            "ffn_layer": "mlp", "qkv_bias": True, "n_storage_tokens": 4},
    "interaction_indexes": [0, 1, 2, 3],
    "overrides": {"conv_inplane": 8, "fapm_rank": 16, "deform_num_heads": 4},
    "architecture": ARCHITECTURE,
    "backbone_dtype": "bfloat16",
}


def plans_and_dataset(name: str = "Dataset990_JaxFixture"):
    dataset_json = {"labels": LABELS, "channel_names": {"0": "synthetic"},
                    "numTraining": 4, "file_ending": ".png"}
    plans = {
        "dataset_name": name, "plans_name": "nnUNetPlans",
        "original_median_spacing_after_transp": [999.0, 1.0, 1.0],
        "original_median_shape_after_transp": [1, PATCH, PATCH],
        "image_reader_writer": "NaturalImage2DIO", "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "configurations": {CONFIGURATION: {
            "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": 2, "patch_size": [PATCH, PATCH],
            "median_image_size_in_voxels": [PATCH, PATCH], "spacing": [1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, "order_z": 0,
                                          "force_separate_z": None},
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, "order_z": 0,
                                         "force_separate_z": None},
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1,
                                                   "order_z": 0, "force_separate_z": None},
            "batch_dice": True,
            "architecture": {"network_class_name": "DinoUNet",
                             "arch_kwargs": ARCHITECTURE, "_kw_requires_import": []},
        }},
        "experiment_planner_used": "ExperimentPlanner", "label_manager": "LabelManager",
        "foreground_intensity_properties_per_channel": {"0": {
            "max": 1.0, "mean": 0.5, "median": 0.5, "min": 0.0, "percentile_00_5": 0.0,
            "percentile_99_5": 1.0, "std": 0.25}},
    }
    return plans, dataset_json


@contextlib.contextmanager
def network_spec_patches(spec: dict):
    """Register the spec's ViT and interaction indexes with the JAX package,
    make DinoUNetTrainer build with them and with the spec's adapter widths
    (``set_network_config`` plus the overrides), and undo it all after."""
    from dinounet_tpu.models import dinounet as dn
    from dinounet_tpu.models.vit import VIT_CONFIGS, ViTConfig
    from dinounet_tpu.training import dinounet_trainer as dt

    base = dt.DinoUNetTrainer
    saved = (base._network_config, base._dinov3_model_name, base._dinov3_pretrained_path,
             dt.DinoUNetConfig)
    VIT_CONFIGS[spec["vit_name"]] = ViTConfig(**spec["vit"])
    dn.DINOV3_MODEL_NAMES[spec["model_name"]] = spec["vit_name"]
    dn.DINOV3_INTERACTION_INDEXES[spec["model_name"]] = tuple(spec["interaction_indexes"])
    original = dt.DinoUNetConfig

    class FixtureConfig(original):
        @classmethod
        def from_plans_arch(cls, arch, num_classes, **kwargs):
            return original.from_plans_arch(arch, num_classes,
                                            **{**spec["overrides"], **kwargs})

    dt.DinoUNetConfig = FixtureConfig
    base.set_network_config({"architecture": spec["architecture"]},
                            dinov3_model_name=spec["model_name"])
    base._dinov3_pretrained_path = None
    try:
        yield
    finally:
        (base._network_config, base._dinov3_model_name, base._dinov3_pretrained_path,
         dt.DinoUNetConfig) = saved
        VIT_CONFIGS.pop(spec["vit_name"], None)
        dn.DINOV3_MODEL_NAMES.pop(spec["model_name"], None)
        dn.DINOV3_INTERACTION_INDEXES.pop(spec["model_name"], None)


def seeded_leaf(path: str, shape, rng: np.random.Generator) -> np.ndarray:
    """A parameter of a trained-looking network: kernels N(0, 1/fan_in)
    (the MSDA sampling offsets' a tenth of that: a trained adapter's offsets
    stay near their init, and bf16 places a sampling point to 1/64 pixel),
    norm scales near 1, LayerScale near 0.1 (so the blocks count), every
    other leaf small noise."""
    shape = tuple(shape)
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel" and len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        scale = 0.1 if "sampling_offsets" in path else 1.0
        return (scale * rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    if leaf == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if leaf.endswith("gamma"):
        return (0.1 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    if leaf == "var":
        return (1.0 + 0.1 * rng.random(shape)).astype(np.float32)
    return (0.05 * rng.standard_normal(shape)).astype(np.float32)


def fill_trainer(trainer, seed: int, backbone_dtype=None, steps: int = 0,
                 head_scale: float = 1.0) -> None:
    """The JAX trainer's variables, optimizer and state without its jitted
    init: the shapes from ``jax.eval_shape`` of the network's init, the
    values from `seed`, then `steps` updates of the trainer's optax chain
    from seeded gradients (jitted, on one device; with none, the chain's
    state with seeded traces, without a compile), all placed on the
    trainer's mesh as ``_init_params_and_optimizer`` places them (the
    backbone's blocks split over 'model', the rest replicated).
    `head_scale` scales the segmentation heads (``decoder/seg*``)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dinounet_tpu.parallel import param_shardings, replicated

    trainer.num_input_channels = 1
    trainer.network = trainer.build_network_architecture(
        "DinoUNet", ARCHITECTURE, [], 1, trainer.label_manager.num_segmentation_heads,
        enable_deep_supervision=False)
    key = repr(trainer.network)  # the folds of one network trace its init once
    if key not in _VARIABLE_SHAPES:
        _VARIABLE_SHAPES[key] = jax.eval_shape(lambda: trainer.network.init(
            jax.random.PRNGKey(0), jnp.zeros((1, PATCH, PATCH, 1)), train=False))
    shapes = _VARIABLE_SHAPES[key]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        value = seeded_leaf(name, leaf.shape, rng)
        if "/decoder/seg" in f"/{name}":
            value = value * np.float32(head_scale)
        if backbone_dtype and "/backbone/" in f"/{name}/" and name.startswith("params"):
            return jnp.asarray(value, backbone_dtype)
        return jnp.asarray(value, leaf.dtype)

    variables = dict(jax.tree_util.tree_map_with_path(fill, shapes))
    variables.setdefault("batch_stats", {})
    trainer.variables = variables
    trainer.tx = trainer.configure_optimizers()
    params = variables["params"]
    grad_rng = np.random.default_rng(seed + 1000)
    if steps:
        opt_state = jax.jit(trainer.tx.init)(params)
        update = jax.jit(lambda g, o, p: (lambda u, o2: (optax.apply_updates(p, u), o2))(
            *trainer.tx.update(g, o, p)))
        for _ in range(steps):
            grads = jax.tree.map(
                lambda p: jnp.asarray(0.01 * grad_rng.standard_normal(p.shape), p.dtype),
                params)
            params, opt_state = update(grads, opt_state, params)
    else:  # the chain's state structure, traces from the seed, count SGD_STEPS
        opt_state = jax.tree.map(
            lambda a: jnp.asarray(
                np.full(a.shape, SGD_STEPS) if np.issubdtype(a.dtype, np.integer)
                else 0.01 * grad_rng.standard_normal(a.shape), a.dtype),
            jax.eval_shape(trainer.tx.init, params))
    mesh = trainer.mesh
    variables["params"] = jax.device_put(params, param_shardings(mesh, params))
    variables["batch_stats"] = jax.device_put(
        variables["batch_stats"],
        jax.tree_util.tree_map(lambda _: replicated(mesh), variables["batch_stats"]))
    # the traces are the trainable (replicated) params', the count a scalar
    trainer.opt_state = jax.device_put(opt_state, replicated(mesh))
    trainer.was_initialized = True


def make_trainer(plans: dict, dataset_json: dict, fold: int, model_axis: int,
                 devices: int = 0):
    """The JAX DinoUNetTrainer of `fold` on a model axis of `model_axis`
    (the mesh is made at construction from DINOUNET_TPU_MODEL_AXIS), over
    the first `devices` devices (0: all of them)."""
    import jax

    from dinounet_tpu.parallel import make_mesh
    from dinounet_tpu.training.dinounet_trainer import DinoUNetTrainer

    previous = os.environ.get("DINOUNET_TPU_MODEL_AXIS")
    os.environ["DINOUNET_TPU_MODEL_AXIS"] = str(model_axis)
    try:
        trainer = DinoUNetTrainer(plans, CONFIGURATION, fold, dataset_json)
    finally:
        if previous is None:
            os.environ.pop("DINOUNET_TPU_MODEL_AXIS")
        else:
            os.environ["DINOUNET_TPU_MODEL_AXIS"] = previous
    if devices:
        trainer.mesh = make_mesh(n_model=model_axis, devices=jax.devices()[:devices])
    return trainer


def write_fold(trainer, seed: int, backbone_dtype=None, steps: int = SGD_STEPS,
               epoch: int = 3, head_scale: float = 1.0) -> str:
    """Fill, step and save the trainer's checkpoint_final.pth (a file at
    model axis 1, an orbax directory above); returns its path."""
    fill_trainer(trainer, seed, backbone_dtype, steps, head_scale)
    trainer.current_epoch = epoch
    trainer._best_ema = 0.25 + 0.01 * seed
    trainer.inference_allowed_mirroring_axes = (0, 1)
    for e in range(epoch + 1):
        trainer.logger.log("mean_fg_dice", 0.1 * e, e)
        trainer.logger.log("ema_fg_dice", 0.05 * e, e)
        trainer.logger.log("train_losses", 1.0 - 0.1 * e, e)
        trainer.logger.log("val_losses", 1.1 - 0.1 * e, e)
        trainer.logger.log("lrs", 0.01, e)
        trainer.logger.log("epoch_start_timestamps", 100.0 + e, e)
        trainer.logger.log("epoch_end_timestamps", 110.0 + e, e)
        trainer.logger.log("dice_per_class_or_region", [0.1 * e, 0.2 * e], e)
    path = os.path.join(trainer.output_folder, "checkpoint_final.pth")
    trainer.save_checkpoint(path)
    return path


def jax_logits(trainer, tile: np.ndarray) -> np.ndarray:
    """The fold's network in fp32 on an NCHW tile -> NCHW fp32 logits."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dinounet_tpu.models.dinounet import DinoUNet

    cfg = trainer.network.cfg
    cfg = dataclasses.replace(cfg, dtype="float32",
                              vit=dataclasses.replace(cfg.vit, dtype="float32"))
    variables = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                             trainer.variables)
    out = jax.jit(lambda v, x: DinoUNet(cfg).apply(v, x, train=False))(
        variables, jnp.asarray(np.moveaxis(tile, 1, -1)))
    return np.ascontiguousarray(np.moveaxis(np.asarray(out, np.float32), -1, 1))


def _flat(tree, prefix: str = ""):
    """(path, array) of every leaf of a nested dict (optax states by
    ``jax.tree.leaves`` order under the 'optimizer_state' leaf list)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out += _flat(v, path)
        else:
            out.append((path, v))
    return out


def array_digests(checkpoint: dict) -> dict:
    """SHA-256 of every array of a checkpoint as the JAX ``load_checkpoint``
    returns it: the weights by their paths, the optimizer state's leaves in
    ``jax.tree.leaves`` order as opt/NNNN."""
    import jax

    def digest(a):
        a = np.array(a, order="C")  # 0-d stays 0-d (ascontiguousarray makes it 1-d)
        return (f"{a.dtype} {'x'.join(map(str, a.shape))} "
                f"{hashlib.sha256(a.tobytes()).hexdigest()}")

    out = {f"network_weights/{p}": digest(a)
           for p, a in _flat(checkpoint["network_weights"])}
    opt = checkpoint["optimizer_state"]
    if isinstance(opt, dict) and all(str(k).startswith("leaf_") for k in opt):
        leaves = [opt[k] for k in sorted(opt)]
    else:
        leaves = jax.tree.leaves(opt)
    out.update({f"optimizer_state/{i:04d}": digest(a) for i, a in enumerate(leaves)})
    return out


def write_b2nd_case(out: str, seed: int = 0) -> None:
    """A zstd-coded nnU-Net v2 case, written by the port's .b2nd writer."""
    sys.path.insert(0, REPO)
    from dinounet_tpu_torch.compression.b2nd import save_b2nd

    rng = np.random.default_rng(seed)
    case = (rng.standard_normal((1, 40, 48)) * 3).astype(np.float32)
    case[:, 10:30, 12:40] += 5.0
    np.save(os.path.join(out, "case.npy"), case)
    save_b2nd(case, os.path.join(out, "case.b2nd"), chunks=(1, 24, 32), blocks=(1, 12, 16),
              codec="zstd")


def write_weights_frame(out: str, seed: int = 0) -> str:
    """A level-1 zstd frame of seeded fp32 weights (N(0, 1/768)); returns
    the SHA-256 of its content."""
    import zstandard

    raw = (np.random.default_rng(seed).standard_normal(65536) / np.sqrt(768)).astype(
        np.float32).tobytes()
    with open(os.path.join(out, "weights_l1.zst"), "wb") as f:
        f.write(zstandard.ZstdCompressor(level=1).compress(raw))
    return hashlib.sha256(raw).hexdigest()


def write_fixture(out: str = DEFAULT_OUT, spec: dict = FIXTURE_NETWORK) -> dict:
    from dinounet_tpu.training.checkpointing import load_checkpoint

    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    plans, dataset_json = plans_and_dataset()
    tile = np.random.default_rng(7).standard_normal((1, 1, PATCH, PATCH)).astype(np.float32)
    np.save(os.path.join(out, "tile.npy"), tile)
    digests = {}
    with tempfile.TemporaryDirectory() as work, network_spec_patches(spec):
        os.environ["nnUNet_preprocessed"] = os.path.join(work, "pre")
        os.environ["nnUNet_results"] = os.path.join(work, "res")
        for fold, axis in FOLD_MODEL_AXIS.items():
            trainer = make_trainer(plans, dataset_json, fold, axis)
            path = write_fold(trainer, seed=fold, backbone_dtype=spec.get("backbone_dtype"))
            np.save(os.path.join(out, f"logits_fold_{fold}.npy"), jax_logits(trainer, tile))
            digests[f"fold_{fold}"] = array_digests(load_checkpoint(path))
        model = os.path.join(out, os.path.basename(trainer.output_folder_base))
        shutil.copytree(trainer.output_folder_base, model,
                        ignore=shutil.ignore_patterns("training_log_*"))
    with open(os.path.join(model, "plans.json"), "w") as f:
        json.dump(plans, f, indent=2)
    with open(os.path.join(model, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    with open(os.path.join(out, "network.json"), "w") as f:
        json.dump(spec, f, indent=2)
    digests["weights_l1"] = write_weights_frame(out)
    with open(os.path.join(out, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=0, sort_keys=True)
    write_b2nd_case(out)
    return digests


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args()
    write_fixture(args.out)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(args.out) for f in files)
    print(f"wrote {args.out}: {total / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
