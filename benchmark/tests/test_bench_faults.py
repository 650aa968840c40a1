"""A run whose timed path is broken underneath comes out not correct. The
harness runs as on the card, less its look for a chip, at a size the CPU
holds, held to the real cells' limits: the served cell with an answer
altered where it is produced and with the mean over half of the mirror
variants; the train cell with a step that leaves its state unchanged and
with the loss over half of the batch, and with an augmented batch altered
where it is made. (A cell on one chip has no exchange between chips to
leave out.)"""

import json

import pytest
import torch

import harness
import run

SEED = 2**32 + 7


def result(root, workload):
    cell = harness.Cell(root, workload)
    harness.program_env(root, cell.cfg)
    out = run.run_cell(cell, SEED, 0.3, False, torch.device("cpu"))
    return json.loads(out["line"]({"platform": "cpu", "kind": "cpu", "count": 1}))


def test_sound_runs_are_correct(tiny_root):
    assert result(tiny_root, "t.predict")["correct"]
    assert result(tiny_root, "t.train")["correct"]


def test_an_altered_answer_is_caught(tiny_root, monkeypatch):
    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor

    predict = nnUNetPredictor.predict_logits_from_preprocessed_data

    def altered(self, data):
        out = predict(self, data)
        out[1] = out[2]  # one class's logits replaced by another's
        return out

    monkeypatch.setattr(nnUNetPredictor, "predict_logits_from_preprocessed_data", altered)
    line = result(tiny_root, "t.predict")
    assert not line["correct"] and line["failed"] == line["attempted"]


def test_half_of_the_mirror_variants_is_caught(tiny_root, monkeypatch):
    from dinounet_tpu_torch.inference import sliding_window

    variants = sliding_window.mirror_variants
    monkeypatch.setattr(sliding_window, "mirror_variants",
                        lambda axes: variants(axes)[:max(1, len(variants(axes)) // 2)])
    assert not result(tiny_root, "t.predict")["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny_root, monkeypatch):
    from dinounet_tpu_torch.training import trainer

    monkeypatch.setattr(trainer, "clip_and_step", lambda optimizer, max_norm=12.0: None)
    line = result(tiny_root, "t.train")
    assert not line["correct"] and line["checks"]["change_leaf_gap"]["value"] == pytest.approx(1)


def test_the_loss_over_half_of_the_batch_is_caught(tiny_root, monkeypatch):
    from dinounet_tpu_torch.training.trainer import nnUNetTrainer

    loss = nnUNetTrainer._train_loss

    def half(self, output, target):
        n = max(1, target.shape[0] // 2)
        return loss(self, output[:n], target[:n])

    monkeypatch.setattr(nnUNetTrainer, "_train_loss", half)
    assert not result(tiny_root, "t.train")["correct"]


def test_an_altered_augmentation_is_caught(tiny_root, monkeypatch):
    from dinounet_tpu_torch.training import augmentation

    apply = augmentation.apply_augment

    def unflipped(data, seg, d, cfg):
        d.flips = (False, False)  # the mirroring left out where the batch is made
        return apply(data, seg, d, cfg)

    monkeypatch.setattr(augmentation, "apply_augment", unflipped)
    line = result(tiny_root, "t.train")
    assert not line["correct"]
    assert line["checks"]["augment_rel_l2"]["value"] > line["checks"]["augment_rel_l2"]["limit"]


def test_a_run_without_a_card_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "b.predict", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
