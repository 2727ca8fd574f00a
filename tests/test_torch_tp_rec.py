"""Port parity: tensor parallelism over ``model`` in the recurrent blocks
(recurrentgemma-9b's RG-LRU lanes, xlstm-125m's mLSTM heads) and in
llama4-scout's shared expert, in the mesh train step (both activation
modes) and the serve steps, on 2x2 against one process and the
reference's 2x4 run; the tests and their bounds are
``tests/_tp_rec_common.py``'s."""
import pytest

pytest.importorskip("torch")

from _tp_rec_common import *  # noqa: E402,F401,F403
from _tp_rec_common import lanes_gathered_in_rank_order  # noqa: E402

ARCHS = ["rgemma", "xlstm", "llama4"]


def test_lane_gather_backward_summed_in_rank_order(runs):
    assert lanes_gathered_in_rank_order(runs)
