"""The process groups of ``TorchTrainer``'s workers time out: a rank whose
peer stays away from a collective raises once ``GROUP_TIMEOUT_S`` has
passed, on the world group and on a group a mesh builds over it (torch
gives subgroups its backend's default, 30 minutes for gloo, not the
world group's timeout). chip_smoke.py's ``group_timeout_check`` (phase
20f) on the CPU: two gloo ranks in subprocesses, the timeout cut to a
few seconds in each; rank 1 joins, builds the mesh, then sleeps through
rank 0's collective. One group a run: after a timeout gloo closes the
pair, so a second collective would fail at once: the two groups' runs go side
by side."""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TIMEOUT_S = 3.0


def test_a_peer_that_stays_away_fails_the_collective_in_time():
    groups = ("world", "fsdp")
    with ThreadPoolExecutor(len(groups)) as pool:
        runs = list(pool.map(lambda g: chip_smoke.group_timeout_check(
            False, TIMEOUT_S, g), groups))
    for line, said in runs:
        assert said[0] == "raised", line
        assert TIMEOUT_S * 0.9 <= float(said[1]) <= TIMEOUT_S + 10, line
