"""The plain reference against the port at small sizes on the CPU, where
the port takes its plain kernel versions: in fp32 both compute the same
functions, so the check's numbers come out at rounding level."""

from tiny import run_cell

OPEN = {"loss_gap": 1.0, "grad_norm_gap": 1.0, "change_norm_gap": 1.0}


def values(run):
    return {k: v["value"] for k, v in run.checks.items()}


def test_training_reference_follows_the_port():
    got = values(run_cell("chimera-st-train", seed=2 ** 31 + 77, limits=OPEN))
    assert got["rows_unlike_the_data"] == 0
    # the three updates' losses, the first gradient and the change after
    # three Adam steps, worst leaf against the median leaf's norm
    assert got["loss_gap"] < 1e-6
    assert got["grad_norm_gap"] < 1e-5
    assert got["change_norm_gap"] < 1e-3
