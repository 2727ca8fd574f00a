"""Port parity: Fig. 8 (grid-size scaling of KAN-3) against the JAX
package's, on the CPU.

The hardware half (dense ops and cycle-model latency at each G) is held
exactly equal to the reference's.  The algorithm half trains KAN-3 at
G = 2, 4, 8 and 16 (5 to 19 bases a feature) through the port's
``train_model`` from the reference's own ``init_model`` draw at each G,
carried across as numpy, on the reduced surrogate of
``tests/test_torch_paper.py`` (672 training windows, the reference's
batch of 512: one step an epoch): its test MSE within 1e-4 relative, as
Table I's (largest seen 1.1e-7).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's benchmarks/ scripts
    sys.path.insert(0, str(ROOT))

from benchmarks import fig8_grid_scaling as J8  # noqa: E402
from benchmarks import table1_models as J1  # noqa: E402
from repro.data.traffic import TrafficConfig as JTrafficConfig  # noqa: E402
from repro_torch.benchmarks import fig8_grid_scaling as T8  # noqa: E402
from repro_torch.benchmarks.table1_models import train_model  # noqa: E402
from repro_torch.configs.vikin_models import KAN3  # noqa: E402
from repro_torch.data.traffic import TrafficConfig, load_traffic  # noqa

DATA = dict(n_sensors=64, n_hours=512)
EPOCHS = 2
METRIC_RTOL = 1e-4
HW_FIELDS = ("dense_ops", "ops_ratio", "latency_cycles", "latency_ratio",
             "bound")


@pytest.fixture(scope="module")
def fig8(tmp_path_factory):
    root = tmp_path_factory.mktemp("fig8")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(J8, "TrafficConfig", lambda: JTrafficConfig(**DATA))
        ref = J8.run(epochs=EPOCHS)
    got = T8.run(EPOCHS, data_cfg=TrafficConfig(**DATA), device="cpu",
                 out_dir=root / "port")
    return ref, got


@pytest.mark.parametrize("g", J8.GRIDS)
def test_fig8_hardware_half_equals_reference(fig8, g):
    ref, got = fig8
    assert T8.GRIDS == J8.GRIDS
    for k in HW_FIELDS:
        assert got[str(g)][k] == ref[str(g)][k], k
    assert np.isfinite(got[str(g)]["mse"])


def test_fig8_summary_equals_reference(fig8):
    ref, got = fig8
    assert got["_summary"] == ref["_summary"]
    assert list(got) == list(ref)


def test_fig8_rows_record_their_run(fig8):
    """Each grid's row names the run that trained it, so the aggregator
    reuses fig8.json only for the same epochs, seed, data and device."""
    _, got = fig8
    record = T8.run_record(EPOCHS, 0, TrafficConfig(**DATA), "cpu")
    assert record["data"]["n_sensors"] == 64 and record["device"] == "cpu"
    for g in T8.GRIDS:
        assert {k: got[str(g)][k] for k in record} == record


@pytest.mark.parametrize("g", J8.GRIDS)
def test_fig8_mse_from_the_reference_draw_matches(fig8, g):
    ref, _ = fig8
    jcfg = dataclasses.replace(J1.PAPER_MODELS["kan-3layer"], grid=g)
    init = [{k: np.asarray(v) for k, v in p.items()}
            for p in J1.init_model(jax.random.key(0), jcfg)]
    assert init[1]["t"].shape == (32, g + 3, 96)
    _, m = train_model(dataclasses.replace(KAN3, grid=g),
                       load_traffic(TrafficConfig(**DATA)), EPOCHS,
                       device="cpu", params=init)
    r = ref[str(g)]["mse"]
    assert abs(m["mse"] - r) <= METRIC_RTOL * r, (m["mse"], r)


def test_kan_knobs_at_every_grid_and_cache_keys_apart(tmp_path,
                                                      monkeypatch):
    """At every Fig. 8 grid, KAN-3's layers at batch 512 and at the full
    default test split (1576 rows) get a default knob the f32 kernel
    takes (its shared memory checked at nbk = G + 3); a tuned entry at
    G = 4 (nbk 7) is read back at G = 4 and never at G = 16 (nbk 19):
    the cache key's shape bucket holds nbk."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.kan_fused import ops

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.reset_cache()
    try:
        for g in T8.GRIDS:
            for batch in (512, 1576):
                for n_in, n_out in ((72, 32), (32, 96)):
                    knob = ops.resolve_blocks(batch, n_in, n_out, g + 3,
                                              torch.float32, device="cpu")
                    assert knob == ops.default_blocks(
                        batch, n_in, n_out, g + 3, torch.float32)
        tuned = {"bm": 16, "bi": 64, "bn": 16}
        autotune.get_cache().store(autotune.cache_key(
            ops.KERNEL, (512, 72, 32, 7), torch.float32, "cpu"), tuned)
        assert ops.resolve_blocks(512, 72, 32, 7, torch.float32,
                                  device="cpu") == tuned
        assert ops.resolve_blocks(512, 72, 32, 19, torch.float32,
                                  device="cpu") == ops.default_blocks(
            512, 72, 32, 19, torch.float32)
    finally:
        autotune.reset_cache()


def test_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    """The port's quickstart end to end through the plain versions: the
    two trained models, then both deployed on the cycle model beside the
    edge-GPU model (KAN-2's columns do not depend on the data)."""
    from repro_torch.examples import quickstart

    monkeypatch.setattr(sys, "argv", ["quickstart", "--device", "cpu"])
    quickstart.main()
    out = capsys.readouterr().out
    assert "kan-2layer   params= 55296" in out
    assert "mlp-3layer   params= 51472" in out
    assert "KAN-2 (pipeline mode):   6.16us on VIKIN" in out
    assert "-> 1.61x speed, 6.31x energy" in out
    assert "MLP-3 (parallel mode)" in out
