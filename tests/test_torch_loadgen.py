"""Port parity: open-loop traces and replay against the JAX package.

The port's ``runtime/loadgen`` is a host-side copy, so its traces are held
byte for byte (and by sha256, against the hashes committed in
``BENCH_serving.json``), its capacity estimates and sim-clock replay
reports EXACTLY equal to the reference's on the same weights, and the
served outputs within ``1e-5 * (1 + max|ref|)``.  The load bench's rows,
which live in the simulated domain, equal the committed ones on the CPU.
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime import backends as jback  # noqa: E402
from repro.runtime import loadgen as jload  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch.benchmarks import loadgen_bench  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import stack_params_from_jax  # noqa: E402
from repro_torch.models.ffn import vikin_stack_init  # noqa: E402
from repro_torch.runtime import backends as tback  # noqa: E402
from repro_torch.runtime import loadgen as tload  # noqa: E402
from repro_torch.runtime.server import Engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((ROOT / "BENCH_serving.json").read_text())
OUT_TOL = 1e-5

# (generator, positional args, keyword args) in both packages' terms
TRACES = {
    "poisson": ("poisson_trace", (1000.0, 50), {"seed": 3}),
    "poisson-mix": ("poisson_trace", (500.0, 40), {
        "seed": 1, "workloads": [("vikin-kan2", 2.0), ("vikin-mlp3", 1.0)],
        "priority_classes": [(0, 0.5, 0.01), (3, 0.5, None)]}),
    "bursty": ("bursty_trace", (100.0, 5000.0, 120), {
        "mean_calm_s": 0.1, "mean_burst_s": 0.05, "seed": 0}),
    "bursty-mix": ("bursty_trace", (2e4, 1e5, 200), {
        "mean_calm_s": 1e-3, "mean_burst_s": 3e-4, "seed": 7,
        "workloads": [("a", 1.0), ("b", 3.0), ("c", 0.5)],
        "priority_classes": [(0, 0.7, 5e-4), (2, 0.3, 2e-4)]}),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_are_byte_equal_to_the_reference(name):
    fn, args, kw = TRACES[name]
    got = getattr(tload, fn)(*args, **kw)
    ref = getattr(jload, fn)(*args, **kw)
    assert got.to_json() == ref.to_json()
    assert got.sha256() == ref.sha256()
    back = tload.Trace.from_json(ref.to_json())
    assert back.events == got.events and back.meta == got.meta


@pytest.mark.parametrize("i", range(len(loadgen_bench.LOAD_MULTS)))
def test_sweep_trace_hashes_match_the_committed_row(i):
    row = COMMITTED["openloop:sweep:vikin-mlp3"]
    point = row["points"][i]
    cap = tload.estimate_capacity_rps(VIKIN_ARCHS["vikin-mlp3"],
                                      n_slots=row["n_slots"])
    assert cap == row["capacity_rps_estimate"]
    assert loadgen_bench.LOAD_MULTS[i] == point["offered_mult"]
    trace = tload.poisson_trace(point["offered_mult"] * cap,
                                row["events_per_point"], seed=row["seed"])
    assert trace.sha256() == point["trace_sha256"]


def test_burst_trace_hash_matches_the_committed_row():
    row = COMMITTED["openloop:burst:vikin-mlp3"]
    trace, deadline, max_queue = loadgen_bench.burst_trace(
        "vikin-mlp3", n_slots=row["n_slots"], events=row["events"],
        seed=row["seed"])
    assert trace.sha256() == row["trace_sha256"]
    assert deadline == row["deadline_s"] and max_queue == row["max_queue"]


@pytest.mark.parametrize("arch", sorted(a for a in VIKIN_ARCHS
                                        if a.startswith("vikin-")))
@pytest.mark.parametrize("n_slots", [1, 2, 8])
def test_capacity_estimate_exactly_equal(arch, n_slots):
    assert (tload.estimate_capacity_rps(VIKIN_ARCHS[arch], n_slots=n_slots)
            == jload.estimate_capacity_rps(J_ARCHS[arch], n_slots=n_slots))


def _params(arch, seed=0):
    """JAX-drawn weights as numpy, and the port's copy of them."""
    jp = j_stack_init(jax.random.key(seed), J_ARCHS[arch])
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return np_params, stack_params_from_jax(np_params, VIKIN_ARCHS[arch])


def _engines(archs, n_slots=2, **overload):
    """(reference engine, port engine) over the same weights; several
    archs go behind a MultiWorkloadBackend in each package."""
    jb, tb = {}, {}
    for a in archs:
        np_params, tparams = _params(a)
        jb[a] = jback.VikinBackend(J_ARCHS[a], np_params, impl="jnp")
        tb[a] = tback.VikinBackend(VIKIN_ARCHS[a], tparams, device="cpu")
    if len(archs) > 1:
        jb = {"m": jback.MultiWorkloadBackend(jb)}
        tb = {"m": tback.MultiWorkloadBackend(tb)}
    (jbe,), (tbe,) = jb.values(), tb.values()
    return (jserver.Engine(jbe, n_slots=n_slots, **overload),
            Engine(tbe, n_slots=n_slots, **overload))


def _replay_both(archs, trace_json, **overload):
    jeng, teng = _engines(archs, **overload)
    jrep = jload.replay(jeng, jload.Trace.from_json(trace_json), mode="sim")
    trep = tload.replay(teng, tload.Trace.from_json(trace_json), mode="sim")
    assert trep == jrep
    assert sorted(teng._requests) == sorted(jeng._requests)
    n_done = 0
    for rid, jr in jeng._requests.items():
        tr = teng._requests[rid]
        assert (tr.done, tr.shed, tr.expired, tr.met_deadline) == (
            jr.done, jr.shed, jr.expired, jr.met_deadline)
        if jr.done:
            ref = np.asarray(jr.output)
            assert tr.output.shape == ref.shape
            assert (np.abs(tr.output - ref).max()
                    <= OUT_TOL * (1 + np.abs(ref).max()))
            n_done += 1
    assert n_done == trep["completed"] > 0
    return trep


@pytest.mark.parametrize("load", [0.5, 1.1, 2.0])
def test_sim_replay_poisson_equals_the_reference(load):
    cap = tload.estimate_capacity_rps(VIKIN_ARCHS["vikin-small"], n_slots=2)
    trace = tload.poisson_trace(load * cap, 24, seed=2)
    rep = _replay_both(["vikin-small"], trace.to_json())
    assert rep["completed"] == 24 and not rep["incomplete"]


def test_sim_replay_bursty_shed_equals_the_reference():
    cap = tload.estimate_capacity_rps(VIKIN_ARCHS["vikin-small"], n_slots=2)
    batch_s = 2 / cap
    trace = tload.bursty_trace(
        1.0 * cap, 6.0 * cap, 40, mean_calm_s=8 * batch_s,
        mean_burst_s=24 * batch_s, seed=0,
        priority_classes=[(0, 0.7, 4 * batch_s), (2, 0.3, 4 * batch_s)])
    rep = _replay_both(["vikin-small"], trace.to_json(), max_queue=4,
                       admission="shed", drop_expired=True)
    assert rep["shed"] > 0 and rep["bound_respected"]
    assert rep["queue_depth_hwm"] <= 4 and not rep["incomplete"]


def test_sim_replay_multi_workload_equals_the_reference():
    archs = ["vikin-small", "vikin-mixed"]
    cap = tload.estimate_capacity_rps(VIKIN_ARCHS["vikin-mixed"], n_slots=2)
    trace = tload.poisson_trace(0.8 * cap, 20, seed=1,
                                workloads=[(a, 1.0) for a in archs],
                                priority_classes=[(0, 0.5, None),
                                                  (1, 0.5, 1e-3)])
    rep = _replay_both(archs, trace.to_json())
    assert rep["completed"] == 20 and not rep["incomplete"]


@pytest.mark.parametrize("kind", ["sweep", "burst"])
def test_bench_rows_equal_the_committed_rows_on_cpu(kind):
    row = (loadgen_bench.sweep_row if kind == "sweep"
           else loadgen_bench.burst_row)("vikin-mlp3", device="cpu")
    assert json.loads(json.dumps(row)) == COMMITTED[f"openloop:{kind}:"
                                                    f"vikin-mlp3"]


def test_bench_run_merges_its_rows(tmp_path):
    out = tmp_path / "sub" / "serving_bench.json"
    out.parent.mkdir()
    out.write_text(json.dumps({"vikin-kan2": {"kept": True}}))
    rows = loadgen_bench.run("cpu", out, sweep_events=16, burst_events=24)
    got = json.loads(out.read_text())
    assert got["vikin-kan2"] == {"kept": True}
    for key, row in rows.items():
        assert got[key] == json.loads(json.dumps(row))
        assert row["device"] == "cpu"


def test_bench_smoke_on_cpu(capsys):
    assert loadgen_bench.smoke(device="cpu") == 0
    assert "PASS: nonzero sheds under overload" in capsys.readouterr().out


def _port_engine(arch="vikin-small", n_slots=2, **kw):
    model = VIKIN_ARCHS[arch]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    return Engine(tback.VikinBackend(model, params, device="cpu"),
                  n_slots=n_slots, **kw)


def test_wall_replay_smoke():
    trace = tload.poisson_trace(5000.0, 8, seed=0)
    rep = tload.replay(_port_engine(), trace, mode="wall")
    assert rep["mode"] == "wall" and rep["completed"] == 8
    assert not rep["incomplete"] and rep["bound_respected"]
    assert rep["makespan_s"] >= trace.horizon_s
    assert rep["p99_latency_s"] >= rep["p50_latency_s"] > 0.0


def test_replay_rejects_bad_mode():
    with pytest.raises(ValueError, match="mode"):
        tload.replay(_port_engine(), tload.poisson_trace(100.0, 2),
                     mode="warp")


def test_sim_clock_tracks_engine_and_jumps():
    eng = _port_engine()
    clk = tload.SimClock(eng)
    assert clk.now() == 0.0
    clk.jump_to(0.5)
    assert clk.now() == pytest.approx(0.5)
    clk.jump_to(0.25)                   # never rewinds
    assert clk.now() == pytest.approx(0.5)
    eng.stats["sim_latency_s"] = 0.1    # engine work advances the clock
    assert clk.now() == pytest.approx(0.6)


def test_trace_generators_validate_inputs():
    with pytest.raises(ValueError):
        tload.poisson_trace(0.0, 10)
    with pytest.raises(ValueError):
        tload.poisson_trace(100.0, 0)
    with pytest.raises(ValueError):
        tload.bursty_trace(100.0, -1.0, 10, mean_calm_s=1.0,
                           mean_burst_s=1.0)
    with pytest.raises(ValueError):
        tload.bursty_trace(100.0, 200.0, 10, mean_calm_s=0.0,
                           mean_burst_s=1.0)


def test_trace_save_load(tmp_path):
    tr = tload.bursty_trace(100.0, 800.0, 30, mean_calm_s=0.05,
                            mean_burst_s=0.02, seed=9)
    path = str(tmp_path / "trace.json")
    tr.save(path)
    assert tload.Trace.load(path).sha256() == tr.sha256()
    assert jload.Trace.load(path).to_json() == tr.to_json()


CLI_ARGS = {
    "rate": ["--rate", "2500", "--events", "40", "--seed", "4"],
    "arch-bursty": ["--kind", "bursty", "--arch", "vikin-mlp3", "--load",
                    "1.5", "--events", "64", "--deadline", "5e-4",
                    "--priorities", "0:0.8,2:0.2"],
    "workloads": ["--arch", "vikin-mixed", "--load", "0.7", "--slots", "4",
                  "--workloads", "vikin-kan2,vikin-mlp3", "--events", "32"],
}


@pytest.mark.parametrize("case", sorted(CLI_ARGS))
def test_both_clis_write_identical_trace_files(case, tmp_path, monkeypatch,
                                               capsys):
    outs = {}
    for pkg, mod in (("jax", jload), ("torch", tload)):
        outs[pkg] = tmp_path / f"{pkg}.json"
        monkeypatch.setattr(sys, "argv", ["loadgen", *CLI_ARGS[case],
                                          "--out", str(outs[pkg])])
        mod.main()
    assert outs["torch"].read_bytes() == outs["jax"].read_bytes()
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert [ln.replace(str(outs["jax"]), "T") for ln in printed[:half]] == [
        ln.replace(str(outs["torch"]), "T") for ln in printed[half:]]


def test_cli_needs_a_rate_or_a_known_arch(tmp_path, monkeypatch):
    for args in (["--events", "4"], ["--arch", "vikin-nope"]):
        monkeypatch.setattr(sys, "argv", ["loadgen", *args, "--out",
                                          str(tmp_path / "t.json")])
        with pytest.raises(SystemExit):
            tload.main()
