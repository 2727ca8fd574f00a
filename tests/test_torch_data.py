"""Port parity: the Traffic surrogate and the stack tasks are byte-equal
to the JAX package's (both are numpy only; the port keeps its own copy)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.data import stack_task as jst  # noqa: E402
from repro.data import traffic as jtr  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.data import stack_task as tst  # noqa: E402
from repro_torch.data import traffic as ttr  # noqa: E402


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


SMALL = dict(n_sensors=12, n_hours=600)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_traffic_arrays_byte_equal(seed):
    jc, tc = jtr.TrafficConfig(seed=seed, **SMALL), ttr.TrafficConfig(
        seed=seed, **SMALL)
    _same(ttr.generate_series(tc), jtr.generate_series(jc))
    jd, td = jtr.load_traffic(jc), ttr.load_traffic(tc)
    assert sorted(td) == sorted(jd)
    for k in jd:
        _same(td[k], jd[k])
    jb = list(jtr.batches(jd["train_x"], jd["train_y"], 16, seed=seed))
    tb = list(ttr.batches(td["train_x"], td["train_y"], 16, seed=seed))
    assert len(tb) == len(jb) > 0
    for (a, b), (c, d) in zip(tb, jb):
        _same(a, c)
        _same(b, d)
    p = td["val_y"] + 0.01
    for m in ("mse", "mae", "rse"):
        assert getattr(ttr, m)(p, td["val_y"]) == getattr(jtr, m)(
            p, jd["val_y"])


def test_traffic_default_config_byte_equal():
    """The full default surrogate (96 sensors, 4096 hours) the 72->96
    archs train on."""
    jd, td = jtr.load_traffic(), ttr.load_traffic()
    for k in jd:
        _same(td[k], jd[k])
    assert dataclasses.asdict(ttr.TrafficConfig()) == dataclasses.asdict(
        jtr.TrafficConfig())


@pytest.mark.parametrize("classify", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("arch", ["vikin-small", "vikin-mixed",
                                  "vikin-kan3"])
def test_stack_task_byte_equal(arch, seed, classify):
    jd = jst.task_for_model(J_ARCHS[arch], n_train=256, n_val=64,
                            classify=classify, seed=seed)
    td = tst.task_for_model(VIKIN_ARCHS[arch], n_train=256, n_val=64,
                            classify=classify, seed=seed)
    assert sorted(td) == sorted(jd)
    assert td["task"] == jd["task"]
    for k in jd:
        if k != "task":
            _same(td[k], jd[k])


def test_stack_task_config_defaults_match():
    assert dataclasses.asdict(tst.StackTaskConfig(3, 5)) == \
        dataclasses.asdict(jst.StackTaskConfig(3, 5))
    assert tst.TRAFFIC_SHAPE == jst.TRAFFIC_SHAPE
