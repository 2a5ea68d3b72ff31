"""The check against a broken timed path: with each fault a cell can have
planted underneath, a run drives on (on the CPU at small sizes, past the
harness's look for a card) and ``correct`` comes out false under the
cell's own limits; without a fault it comes out true. The cells run on one
chip, so the exchange between chips has no fault to plant."""

import chimera_st_tpu_torch.optim.optimizers as optim_mod
import chimera_st_tpu_torch.train.train_step as step_mod
import pytest
from tiny import run_cell

SEED = 2 ** 31 + 1234


def halve(prepare):
    """prepare_batch that keeps the first half of the rows, the mean then
    taken over them (their own target tokens)."""

    def broken(batch, device):
        b = dict(batch)
        n = max(len(b["id"]) // 2, 1)
        for k, v in batch.items():
            if hasattr(v, "shape") and v.shape and v.shape[0] == len(batch["id"]):
                b[k] = v[:n]
        b["ntokens"] = float(b["target_lengths"].sum())
        b["nsentences"] = n
        return prepare(b, device)

    return broken


def frozen_step(self, lr, g_norm, skip=None):
    """An optimizer step that returns the state unchanged."""


def test_sound_runs_are_correct():
    assert run_cell("chimera-st-train", seed=SEED).correct()


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch"])
def test_training_faults_fail(monkeypatch, fault):
    if fault == "state unchanged":
        monkeypatch.setattr(optim_mod.Optimizer, "step", frozen_step)
    else:
        monkeypatch.setattr(step_mod, "prepare_batch", halve(step_mod.prepare_batch))
    run = run_cell("chimera-st-train", seed=SEED)
    assert not run.correct(), run.checks
