"""Port parity: the paper's results scripts (Table I, Table II, Figs. 6-7)
against the JAX package's, on the CPU.

Both packages train from the reference's ``init_model(jax.random.key(0),
cfg)`` draw, carried across as numpy (torch cannot draw it), on a
reduced Traffic surrogate: 64 sensors x 512 hours give 672 training
windows, so Table I at batch 128 takes 5 steps an epoch and Table II's
fixed batch of 512 one step an epoch.  Tolerances, each measured with
margin:

* Table I: every step's loss within 1e-5 relative (largest seen
  3.6e-7); test MSE, RSE and MAE within 1e-4 relative (largest seen
  1.1e-7); each hidden layer's post-ReLU density within one element's
  flip (the means round apart below one); the trained params within
  ``1e-5 * (1 + max|ref|)`` a leaf (largest seen 9.6e-7).  The plain
  versions and XLA sum in different orders, and Adam's early steps of
  about ``lr * sign(g)`` turn that into ulps of the params.
* Table II: the masked fine-tune's bf16-cast test MSE and RSE within
  1e-4 relative (largest seen 1.2e-7), its cycle-model and ``EdgeGPU``
  fields exactly.
* Figs. 6-7: exactly, from a shared ``table1.json``: they are cycle-model
  sweeps of its nnz rates.
"""
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's benchmarks/ scripts
    sys.path.insert(0, str(ROOT))

from benchmarks import fig6_technique as J6  # noqa: E402
from benchmarks import fig7_sparsity as J7  # noqa: E402
from benchmarks import table1_models as J1  # noqa: E402
from benchmarks import table2_overall as J2  # noqa: E402
from repro.data.traffic import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.data.traffic import load_traffic as j_load  # noqa: E402
from repro_torch.benchmarks import fig6_technique as T6  # noqa: E402
from repro_torch.benchmarks import fig7_sparsity as T7  # noqa: E402
from repro_torch.benchmarks import table1_models as T1  # noqa: E402
from repro_torch.benchmarks import table2_overall as T2  # noqa: E402
from repro_torch.configs.vikin_models import PAPER_MODELS  # noqa: E402
from repro_torch.convert import paper_npz_entries  # noqa: E402
from repro_torch.data.traffic import TrafficConfig, load_traffic  # noqa

DATA = dict(n_sensors=64, n_hours=512)
EPOCHS = 2
BATCH = 128
LOSS_RTOL = 1e-5
METRIC_RTOL = 1e-4
PARAM_TOL = 1e-5
NAMES = list(J1.PAPER_MODELS)


def _record_losses(losses):
    """A ``jax.value_and_grad`` that also hands each loss its jitted step
    computes to ``losses`` (in step order), so the reference's own
    ``train_model`` reports its per-step losses."""
    orig = jax.value_and_grad

    def value_and_grad(fn, *a, **k):
        f = orig(fn, *a, **k)

        def g(*args):
            loss, grads = f(*args)
            jax.debug.callback(lambda v: losses.append(float(v)), loss,
                               ordered=True)
            return loss, grads
        return g
    return value_and_grad


@pytest.fixture(scope="module")
def data():
    ref = j_load(JTrafficConfig(**DATA))
    got = load_traffic(TrafficConfig(**DATA))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert ref["train_x"].shape[0] == 672
    return ref


@pytest.fixture(scope="module")
def table1(data):
    """Each model trained by both packages from the reference's draw."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, cfg in J1.PAPER_MODELS.items():
            init = [{k: np.asarray(v) for k, v in p.items()}
                    for p in J1.init_model(jax.random.key(0), cfg)]
            losses = []
            mp.setattr(jax, "value_and_grad", _record_losses(losses))
            j_params, j_metrics = J1.train_model(cfg, data, EPOCHS, 0,
                                                 batch_size=BATCH)
            jax.effects_barrier()
            mp.undo()
            t_params, t_metrics = T1.train_model(
                PAPER_MODELS[name], data, EPOCHS, 0, batch_size=BATCH,
                device="cpu", params=init)
            out[name] = {
                "ref": ([{k: np.asarray(v) for k, v in p.items()}
                         for p in j_params], j_metrics, losses),
                "port": (t_params, t_metrics)}
    return out


@pytest.mark.parametrize("name", NAMES)
def test_table1_losses_match_reference(table1, name):
    _, _, ref = table1[name]["ref"]
    got = table1[name]["port"][1]["losses"]
    assert len(ref) == len(got) == EPOCHS * (672 // BATCH)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_table1_metrics_match_reference(table1, data, name):
    _, ref, _ = table1[name]["ref"]
    got = table1[name]["port"][1]
    for k in ("mse", "rse", "mae"):
        assert np.isfinite(got[k])
        assert abs(got[k] - ref[k]) <= METRIC_RTOL * abs(ref[k]), k
    assert got["params"] == ref["params"]
    assert got["epochs"] == ref["epochs"] == EPOCHS
    assert got["device"] == "cpu"
    cfg = PAPER_MODELS[name]
    assert len(got["nnz_rates"]) == len(ref["nnz_rates"]) == (
        cfg.n_layers - 1 if cfg.kind == "mlp" else 0)
    n_test = data["test_x"].shape[0]
    for i, (g, r) in enumerate(zip(got["nnz_rates"], ref["nnz_rates"])):
        flip = 1.0 / (n_test * cfg.sizes[i + 1])
        assert abs(g - r) <= flip * 1.001, (i, g, r)


@pytest.mark.parametrize("name", NAMES)
def test_table1_params_match_reference(table1, name):
    ref = table1[name]["ref"][0]
    got = table1[name]["port"][0]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(r)
        for k in r:
            err = float(np.abs(g[k].numpy() - r[k]).max())
            assert err <= PARAM_TOL * (1 + float(np.abs(r[k]).max())), \
                (i, k, err)


def test_table1_run_writes_reference_layout(tmp_path):
    """The port's run trains all four models and writes table1.json and
    paper_models.npz in the reference's layout into --out-dir."""
    res = T1.run(epochs=1, data_cfg=TrafficConfig(**DATA), device="cpu",
                 out_dir=tmp_path)
    t1 = json.loads((tmp_path / "table1.json").read_text())
    assert list(t1) == list(res) == NAMES
    with np.load(tmp_path / "paper_models.npz") as z:
        keys = set(z.files)
    want = {f"{n}/{i}/{k}" for n, cfg in PAPER_MODELS.items()
            for i in range(cfg.n_layers)
            for k in (("w", "b") if cfg.kind == "mlp" else ("w_b", "t"))}
    assert keys == want
    for name, m in t1.items():
        assert all(np.isfinite(m[k]) for k in ("mse", "rse", "mae"))
        assert len(m["losses"]) == 672 // 512


@pytest.mark.parametrize("bad", ["experiments", str(ROOT / "experiments")])
def test_paper_scripts_refuse_the_reference_experiments_dir(bad,
                                                           monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(ValueError, match="experiments"):
        T1.out_path(bad)


def test_paper_npz_round_trips_between_packages(table1, tmp_path,
                                                monkeypatch):
    """The port's paper_models.npz loads in the reference, and the
    reference's in the port, bit for bit."""
    port_entries, ref_entries = {}, {}
    for name in NAMES:
        port_entries.update(paper_npz_entries(name, table1[name]["port"][0]))
        for i, layer in enumerate(table1[name]["ref"][0]):
            for k, v in layer.items():
                ref_entries[f"{name}/{i}/{k}"] = v
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    np.savez(tmp_path / "port" / "paper_models.npz", **port_entries)
    np.savez(tmp_path / "ref" / "paper_models.npz", **ref_entries)
    monkeypatch.setattr(J1, "EXP_DIR", str(tmp_path / "port"))
    for name in NAMES:
        _, j_loaded = J1.load_trained(name)
        for got, layer in zip(j_loaded, table1[name]["port"][0]):
            for k, v in layer.items():
                np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())
        cfg, t_loaded = T1.load_trained(name, tmp_path / "ref")
        assert cfg is PAPER_MODELS[name]
        for got, layer in zip(t_loaded, table1[name]["ref"][0]):
            assert got.keys() == layer.keys()
            for k, v in layer.items():
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.fixture(scope="module")
def shared(table1, tmp_path_factory):
    """One table1.json and paper_models.npz (the reference's run), in the
    reference's ``experiments/`` under one directory and in the port's
    --out-dir under another.  The port's copy carries the run record of
    the request the scripts below make (``EPOCHS`` epochs, seed 0, the
    reduced data, the CPU), so they read it rather than train anew."""
    root = tmp_path_factory.mktemp("paper")
    ref_dir, port_dir = root / "ref" / "experiments", root / "port"
    ref_dir.mkdir(parents=True)
    metrics = {n: table1[n]["ref"][1] for n in NAMES}
    (ref_dir / "table1.json").write_text(json.dumps(metrics, indent=1))
    np.savez(ref_dir / "paper_models.npz",
             **{f"{n}/{i}/{k}": v for n in NAMES
                for i, layer in enumerate(table1[n]["ref"][0])
                for k, v in layer.items()})
    shutil.copytree(ref_dir, port_dir)
    record = T1.run_record(EPOCHS, 0, TrafficConfig(**DATA), "cpu")
    (port_dir / "table1.json").write_text(json.dumps(
        {n: {**m, **record} for n, m in metrics.items()}, indent=1))
    return root / "ref", port_dir


@pytest.mark.parametrize("change", [
    {}, {"epochs": EPOCHS + 1}, {"seed": 1},
    {"data_cfg": TrafficConfig(n_sensors=8, n_hours=512)}, "no weights"],
    ids=["same", "epochs", "seed", "data", "no-weights"])
def test_ensure_trained_reuses_only_the_same_run(shared, tmp_path,
                                                 monkeypatch, change):
    """table1.json and the weights under --out-dir are reused only by a
    request of the epochs, seed, data config and device that made them
    (``run_record``, stored in each model's entry); any other request, or
    missing weights, trains anew through ``run``."""
    _, shared_dir = shared
    out = tmp_path / "paper"
    shutil.copytree(shared_dir, out)
    want = {"epochs": EPOCHS, "seed": 0, "data_cfg": TrafficConfig(**DATA)}
    if change == "no weights":
        (out / "paper_models.npz").unlink()
    else:
        want.update(change)
    calls = []
    monkeypatch.setattr(T1, "run", lambda *a, **k: calls.append((a, k)))
    t1 = T1.ensure_trained(want["epochs"], want["seed"], want["data_cfg"],
                           device="cpu", out_dir=out)
    assert t1 == json.loads((shared_dir / "table1.json").read_text())
    assert calls == ([] if change == {} else [(
        (want["epochs"], want["seed"], want["data_cfg"]),
        {"device": "cpu", "out_dir": out})])


@pytest.fixture(scope="module")
def table2(shared):
    ref_cwd, port_dir = shared
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ref_cwd)
        mp.setattr(J2, "TrafficConfig", lambda: JTrafficConfig(**DATA))
        ref = J2.run(EPOCHS)
    got = T2.run(EPOCHS, TrafficConfig(**DATA), device="cpu",
                 out_dir=port_dir)
    return ref, got, port_dir


HW_FIELDS = ("pattern_rate", "latency_us", "cycles", "gops", "gops_per_w",
             "gpu_latency_us", "speedup_vs_gpu", "energy_ratio_vs_gpu")


@pytest.mark.parametrize("name", list(J2.DEPLOY))
def test_table2_hardware_fields_equal_reference(table2, name):
    ref, got, _ = table2
    assert list(got) == list(ref)
    assert set(got[name]) == set(ref[name])
    for k in HW_FIELDS:
        assert got[name][k] == ref[name][k], k


@pytest.mark.parametrize("name", list(J2.DEPLOY))
def test_table2_masked_bf16_accuracy_matches_reference(table2, name):
    ref, got, port_dir = table2
    r, g = ref[name], got[name]
    for k in ("mse", "rse"):
        assert abs(g[k] - r[k]) <= METRIC_RTOL * abs(r[k]), k
    # the delta is 100 * (mse / base - 1) over one shared base
    base = r["mse"] / (1 + r["mse_delta_pct"] / 100)
    assert abs(g["mse_delta_pct"] - r["mse_delta_pct"]) <= \
        100 * METRIC_RTOL * r["mse"] / base
    assert json.loads((port_dir / "table2.json").read_text()) == got


def test_table2_fine_tune_keeps_masked_weights_zero(shared, data,
                                                   monkeypatch):
    """Every update of the masked fine-tune is projected back: the params
    each update and the bf16-cast evaluation start from hold every
    masked-out weight at exactly 0, while an update itself moves some of
    them (so the projection is what holds them)."""
    _, port_dir = shared
    step, apply = T2.train_step, T2.apply_model
    for name, rate in T2.DEPLOY.items():
        cfg, params = T1.load_trained(name, port_dir)
        masks = T2._build_masks(cfg, params, rate)
        keep = [float(m.mean()) for m in masks if m is not None]
        assert keep and all(abs(k - (1 - rate)) < 0.01 for k in keep)
        key = "t" if cfg.kind == "kan" else "w"
        starts, updated = [], []

        def train_step(p, *a):
            starts.append(p)
            out = step(p, *a)
            updated.append(out[0])
            return out

        def apply_model(p, *a, **k):
            starts.append(p)
            return apply(p, *a, **k)

        monkeypatch.setattr(T2, "train_step", train_step)
        monkeypatch.setattr(T2, "apply_model", apply_model)
        res = T2._masked_quantized_eval(name, rate, data, ft_epochs=3,
                                        device="cpu", out_dir=port_dir)
        assert set(res) == {"mse", "rse"} and np.isfinite(res["mse"])
        assert len(starts) == 3 + 1 and len(updated) == 3

        def masked_nonzero(p):
            return sum(int(torch.count_nonzero(layer[key] * (m == 0)))
                       for layer, m in zip(p, masks) if m is not None)
        assert [masked_nonzero(p) for p in starts] == [0] * 4
        assert all(masked_nonzero(p) > 0 for p in updated)


@pytest.mark.parametrize("fig", ["fig6", "fig7"])
def test_figs_6_7_equal_reference_from_a_shared_table1(shared, fig):
    ref_cwd, port_dir = shared
    jmod, tmod = {"fig6": (J6, T6), "fig7": (J7, T7)}[fig]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ref_cwd)
        ref = jmod.run(EPOCHS)
    got = tmod.run(EPOCHS, TrafficConfig(**DATA), device="cpu",
                   out_dir=port_dir)
    assert got == ref
    assert json.loads((port_dir / f"{fig}.json").read_text()) == \
        json.loads((ref_cwd / "experiments" / f"{fig}.json").read_text())
    assert os.path.exists(port_dir / "table1.json")


def test_run_aggregates_the_port_rows(table2, tmp_path, monkeypatch,
                                     capsys):
    """The port's aggregator: one CSV row per paper table and figure from
    its own scripts' results under --out-dir, then the kernel and serving
    bench rows; --fast passes the reference's epochs.  The table1.json
    there was made by a 2-epoch run, so Table I is trained once anew at
    the 30 --fast asks for and then reused.  Table I's training, the two
    benches and Table II (held against the reference above) are stubbed
    here."""
    from repro_torch.benchmarks import fig8_grid_scaling as T8
    from repro_torch.benchmarks import kernel_bench as TKB
    from repro_torch.benchmarks import run as TRUN
    from repro_torch.benchmarks import serving_bench as TSB

    _, t2, shared_dir = table2
    port_dir = tmp_path / "paper"
    shutil.copytree(shared_dir, port_dir)
    (port_dir / "fig8.json").unlink(missing_ok=True)
    seen = {"table1": []}

    def t1_run(epochs, seed, data_cfg, *, device, out_dir):
        seen["table1"].append((epochs, seed, data_cfg, device))
        rec = T1.run_record(epochs, seed, data_cfg, device)
        t1 = {n: {**m, **rec} for n, m in json.loads(
            (shared_dir / "table1.json").read_text()).items()}
        (Path(out_dir) / "table1.json").write_text(json.dumps(t1))
        return t1

    def fig8_run(epochs, **kw):
        seen["fig8"] = (epochs, kw)
        rows = {str(g): {"latency_cycles": T8.hardware(g).cycles}
                for g in T8.GRIDS}
        rows["_summary"] = {"ops_ratio_16": 3.35, "latency_ratio_16": 1.3}
        return rows

    def t2_run(epochs, **kw):
        seen["table2"] = (epochs, kw)
        return t2

    monkeypatch.setattr(T1, "run", t1_run)
    monkeypatch.setattr(T8, "run", fig8_run)
    monkeypatch.setattr(T2, "run", t2_run)
    monkeypatch.setattr(TKB, "run", lambda dev: {
        s: {"a": {"max_err": 1e-7}, "b": {"max_err": 3e-6}}
        for s in ("spline_basis", "kan_fused", "pattern_matmul")})
    sv_row = {"sim_latency_s": 2e-5, "requests": 16, "wall_rps": 100.0,
              "sim_cycles_per_req": 708.0, "mode_switches": 0}
    monkeypatch.setattr(TSB, "run", lambda dev, n_requests: {
        "vikin-kan2": sv_row, "vikin-mixed": sv_row,
        "sched:a+b": {"policies": {"fifo": {"reconfig_cycles": 120.0},
                                   "mode-affinity": {"reconfig_cycles": 8.0}},
                      "reconfig_reduction": 15.0,
                      "bitwise_identical": True}})
    monkeypatch.setattr(sys, "argv", ["run", "--fast", "--device", "cpu",
                                      "--out-dir", str(port_dir)])
    ref_files = sorted(ROOT.glob("BENCH_*.json")) + sorted(
        (ROOT / "experiments").rglob("*"))
    stamps = [(p, p.stat().st_mtime_ns) for p in ref_files]
    TRUN.main()
    assert [(p, p.stat().st_mtime_ns) for p in ref_files] == stamps
    assert sorted(ROOT.glob("BENCH_*.json")) + sorted(
        (ROOT / "experiments").rglob("*")) == ref_files
    out = capsys.readouterr().out
    csv = out[out.index("name,us_per_call,derived"):].splitlines()[1:]
    assert [r.split(",")[0] for r in csv] == [
        "table1_kan3_mse", "table1_mlp4_mse", "fig6_zero_skip",
        "fig6_spu_as_pe", "fig7_two_stage", "fig8_grid_scaling",
        "table2_kan_vs_gpu", "table2_mlp_vs_gpu", "kernels_vs_oracle",
        "serving_vikin_kan2", "serving_vikin_mixed",
        "sched_fifo_vs_affinity"]
    assert seen["table1"] == [(30, 0, TrafficConfig(), "cpu")]
    assert seen["fig8"][0] == 20 and seen["table2"][0] == 30
    assert seen["table2"][1] == {"device": "cpu", "out_dir": str(port_dir)}
    assert "worst_err=3.00e-06" in out
    k2 = t2["kan-2layer"]
    assert f"table2_kan_vs_gpu,{k2['latency_us']:.1f}," in out
