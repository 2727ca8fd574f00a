"""Port parity: tensor parallelism over ``model`` in whisper-medium's
encoder and cross-attention (plain, and with the KAN drop-in) and in
paligemma-3b (its ``frontend_proj`` gathered), in the mesh train step
(both activation modes) and the serve steps, on 2x2 against one process
and the reference's 2x4 run; the tests and their bounds are
``tests/_tp_rec_common.py``'s."""
import pytest

pytest.importorskip("torch")

from _tp_rec_common import *  # noqa: E402,F401,F403
from _tp_rec_common import lanes_gathered_in_rank_order  # noqa: E402

ARCHS = ["whisper", "whisper-kan", "pali"]


def test_lane_gather_backward_summed_in_rank_order(runs):
    assert lanes_gathered_in_rank_order(runs)
