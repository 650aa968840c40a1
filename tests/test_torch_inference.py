"""The port's sliding-window predictor vs the JAX package's, on the CPU.

The sliding window is held against ``predict_sliding_window_return_logits``
with a small conv net whose kernel is not mirror-symmetric (so mirror TTA
matters), on a volume that needs padding and a ragged tile grid; the
predictor's fold ensemble against ``nnUNetPredictor.
predict_logits_from_preprocessed_data`` (two folds, fp16 out); and the slice
as a whole -- the sliding window over the small DinoUNet of
tests/test_torch_models.py -- against the JAX sliding window over the JAX
model. fp32
throughout: 1e-5 for the conv net, the model's 1e-3 for the slice, and one
fp16 ulp (rtol 1e-3) for the fp16 outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.inference.sliding_window import (
    predict_sliding_window_return_logits)
from dinounet_tpu_torch.utilities.plans_handler import PlansManager
from tests.test_torch_models import (HW, N_CLASSES, _jax_config, _torch_model,  # noqa: F401
                                     variables)

PATCH = (64, 64)
PLANS = {"dataset_name": "Dataset999_Fake", "plans_name": "plans",
         "configurations": {"2d": {"patch_size": list(PATCH)}}}
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2},
                "channel_names": {"0": "img"}}


class JaxConvNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Conv(3, (3, 3), padding="SAME", name="conv")(x)


def _conv_weights(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 3, 1, 3)).astype(np.float32),
            rng.standard_normal((3,)).astype(np.float32))


def _jax_vars(k, b):
    return {"params": {"conv": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}}


def _torch_state(k, b):
    return {"weight": torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(b)}


def _torch_net(k, b):
    net = torch.nn.Conv2d(1, 3, 3, padding=1)
    net.load_state_dict(_torch_state(k, b))
    return net.eval()


@pytest.fixture(scope="module")
def volume():
    # 1 x 96 x 80: the 80 axis pads to 96, both axes take a 2-step grid
    return np.random.default_rng(3).standard_normal((1, 1, 96, 80)).astype(np.float32)


def test_sliding_window_matches_jax(volume):
    from dinounet_tpu.inference.sliding_window import (
        predict_sliding_window_return_logits as jax_predict)

    k, b = _conv_weights(0)
    want = jax_predict(lambda x: JaxConvNet().apply(_jax_vars(k, b), x), volume,
                       PATCH, 3, tile_step_size=0.5, mirror_axes=(0, 1),
                       tile_batch=3)
    got = predict_sliding_window_return_logits(
        _torch_net(k, b), volume, PATCH, 3, tile_step_size=0.5,
        mirror_axes=(0, 1), tile_batch=3, device="cpu")
    assert got.shape == want.shape == (3, 1, 96, 80) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_predictor_fold_ensemble_matches_jax(volume):
    from dinounet_tpu.inference.predictor import nnUNetPredictor as JaxPredictor
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans

    folds = [_conv_weights(1), _conv_weights(2)]
    jp = JaxPredictor(tile_batch=4)
    jpm = JaxPlans(PLANS)
    jp.manual_initialization(JaxConvNet(), jpm, jpm.get_configuration("2d"),
                             [_jax_vars(*f) for f in folds], DATASET_JSON,
                             "nnUNetTrainer", (0, 1))
    want = jp.predict_logits_from_preprocessed_data(volume)

    pm = PlansManager(PLANS)
    p = nnUNetPredictor(tile_batch=4, device="cpu")
    p.manual_initialization(_torch_net(*folds[0]), pm, pm.get_configuration("2d"),
                            [_torch_state(*f) for f in folds], DATASET_JSON,
                            "nnUNetTrainer", (0, 1))
    got = p.predict_logits_from_preprocessed_data(volume)
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (3, 1, 96, 80)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=1e-3, atol=1e-3)
    # one fold alone is that fold's sliding window
    one = p.predict_sliding_window_return_logits(volume, p.list_of_parameters[1])
    np.testing.assert_allclose(
        one, predict_sliding_window_return_logits(
            _torch_net(*folds[1]), volume, PATCH, 3, mirror_axes=(0, 1),
            tile_batch=4, device="cpu"), rtol=1e-6, atol=1e-6)


def test_over_budget_accumulator_raises(volume, monkeypatch):
    monkeypatch.setenv("DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES", "1024")
    with pytest.raises(NotImplementedError):
        predict_sliding_window_return_logits(_torch_net(*_conv_weights(0)), volume,
                                             PATCH, 3, device="cpu")


def test_slice_dinounet_sliding_window_matches_jax(variables):  # noqa: F811
    """The serving path end to end: sliding window + mirror TTA over DinoUNet."""
    from dinounet_tpu.inference.sliding_window import (
        predict_sliding_window_return_logits as jax_predict)
    from dinounet_tpu.models.dinounet import DinoUNet

    data = np.random.default_rng(4).standard_normal(
        (1, 1, HW + 16, HW)).astype(np.float32)
    model = DinoUNet(_jax_config())
    want = jax_predict(lambda x: model.apply(variables, x, train=False), data,
                       (HW, HW), N_CLASSES, tile_step_size=0.5,
                       mirror_axes=(1,), tile_batch=2)
    got = predict_sliding_window_return_logits(
        _torch_model(variables), data, (HW, HW), N_CLASSES, tile_step_size=0.5,
        mirror_axes=(1,), tile_batch=2, device="cpu")
    assert got.shape == want.shape == (N_CLASSES, 1, HW + 16, HW)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
