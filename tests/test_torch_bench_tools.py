"""Port parity: the bench tooling (repro_torch.benchmarks.check_regression,
roofline --engine, the serving bench's array and trained rows) and the
batched-serving example, against the JAX package, on the CPU.

The regression gate passes the JAX package's committed
``BENCH_serving.json`` against itself and fails a copy with one
simulated field moved by 1%; every row prefix the port's benches emit
dispatches to its own gate.  The engine roofline equals the reference's
``benchmarks.roofline.engine_rows`` field for field.  The new bench rows
emitted on the CPU (four logical chips) pass their gates against the
committed rows.
"""
import copy
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline as jroof  # noqa: E402
from repro_torch.benchmarks import check_regression as G  # noqa: E402
from repro_torch.benchmarks import roofline as troof  # noqa: E402
from repro_torch.benchmarks import serving_bench as SB  # noqa: E402

COMMITTED = json.loads(
    (Path(__file__).resolve().parents[1] / "BENCH_serving.json").read_text())


def _gate(base, fresh, rtol=G.RTOL):
    f = G.Findings()
    G.check_serving(base, fresh, f, rtol=rtol)
    return f


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("precision", ["f32", "f16", "bf16", "int8"])
def test_engine_roofline_equals_the_reference(batch, precision):
    assert troof.engine_rows(batch, precision) == jroof.engine_rows(
        batch, precision)


def test_roofline_cli_writes_and_prints(tmp_path, capsys):
    out = tmp_path / "r.json"
    rows = troof.main(["--engine", "--batch", "8", "--precision", "bf16",
                       "--out", str(out)])
    assert json.loads(out.read_text()) == rows
    assert "ridge point" in capsys.readouterr().out


def test_gate_passes_the_committed_rows_against_themselves():
    f = _gate(COMMITTED, copy.deepcopy(COMMITTED))
    assert not f.rows and f.checks


# one simulated field of each gated row kind, moved by 1%
MOVES = [
    ("vikin-mixed", ("sim_cycles_per_req",)),
    ("sched:vikin-kan2+vikin-mlp3",
     ("policies", "mode-affinity", "sim_cycles_per_req")),
    ("sharded:vikin-mixed", ("multi", "comm_cycles_per_req")),
    ("pipe:vikin-small", ("sweep", 3, "pipeline_cycles")),
    ("pipe:vikin-small", ("bubble_cycles",)),
    ("hetero:vikin-kan2+vikin-mlp3", ("reconfig_cycles_affinity",)),
    ("trained:vikin-mlp3", ("sparse", "sim_cycles_per_req")),
    ("quant:vikin-small", ("int8", "dma_bytes_per_req")),
    ("kanffn:kanffn-ci", ("kanffn", "dma_bytes_per_req")),
    ("openloop:sweep:vikin-mlp3", ("points", 2, "p95_latency_s")),
    ("openloop:burst:vikin-mlp3", ("shed", "goodput_rps")),
]


@pytest.mark.parametrize("row,path", MOVES)
def test_gate_fails_a_simulated_field_moved_by_one_percent(row, path,
                                                           tmp_path):
    fresh = copy.deepcopy(COMMITTED)
    node = fresh[row]
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] *= 1.01
    f = _gate(COMMITTED, fresh)
    assert f.rows and all(row in r for r in f.rows), f.rows
    p = tmp_path / "fresh.json"
    p.write_text(json.dumps(fresh))
    assert G.main(["--serving", "--fresh", str(p)]) == 1
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(COMMITTED))
    assert G.main(["--serving", "--fresh", str(ok)]) == 0


def test_gate_ignores_wall_fields_and_flags_missing_rows():
    fresh = copy.deepcopy(COMMITTED)
    fresh["vikin-mixed"]["wall_rps"] *= 3
    fresh["sharded:vikin-mlp3"]["multi"]["wall_rps"] *= 3
    fresh["trained:vikin-mlp3"]["dense"]["val_mse"] *= 3
    assert not _gate(COMMITTED, fresh).rows
    del fresh["hetero:vikin-kan2+vikin-mlp3"]
    assert any("row missing" in r for r in _gate(COMMITTED, fresh).rows)


def test_every_emitted_row_prefix_has_its_gate(capsys):
    keys = [*SB.ARCHS, f"sched:{'+'.join(SB.SCHED_ARCHS)}",
            f"kanffn:{SB.KANFFN_ARCH}",
            *(f"sharded:{a}" for a in SB.SHARDED_ARCHS),
            f"pipe:{SB.PIPE_ARCH}", f"hetero:{'+'.join(SB.SCHED_ARCHS)}",
            f"trained:{SB.TRAINED_ARCH}", f"quant:{SB.QUANT_ARCH}",
            "openloop:sweep:vikin-mlp3", "openloop:burst:vikin-mlp3"]
    assert sorted(keys) == sorted(COMMITTED)
    assert G.main(["--list-gates"]) == 0
    listed = json.loads(capsys.readouterr().out)[G.SERVING]
    prefixes = {g["prefix"] for g in listed["gates"]}
    for key in keys:
        spec = G.gate_for(key)
        want = "" if ":" not in key else key[:key.rindex(":") + 1]
        assert spec.prefix == want and want in prefixes, key
    assert listed["default_gated"]


def test_kernels_gate_needs_a_named_baseline(tmp_path):
    with pytest.raises(SystemExit, match="needs --baseline"):
        G.main(["--kernels"])
    base = {"device": "a", "rows": [{"launches": 3, "max_err": 1e-7,
                                     "device_ms": 0.1}]}
    fresh = copy.deepcopy(base)
    fresh["device"], fresh["rows"][0]["device_ms"] = "b", 9.0
    (tmp_path / "b.json").write_text(json.dumps(base))
    (tmp_path / "f.json").write_text(json.dumps(fresh))
    argv = ["--kernels", "--baseline", str(tmp_path / "b.json"), "--fresh",
            str(tmp_path / "f.json")]
    assert G.main(argv) == 0
    fresh["rows"][0]["launches"] = 4
    (tmp_path / "f.json").write_text(json.dumps(fresh))
    assert G.main(argv) == 1


def test_new_bench_rows_on_the_cpu_pass_their_gates(tmp_path):
    """The array rows on four logical CPU chips and the trained rows:
    bitwise flags set, every gated field equal to the committed row."""
    out = tmp_path / "sb.json"
    rows = json.loads(json.dumps(SB.run(
        "cpu", out, train_steps=30,
        families=("sharded", "pipe", "hetero", "trained", "quant"))))
    assert sorted(rows) == sorted(
        k for k in COMMITTED if k.startswith(
            ("sharded:", "pipe:", "hetero:", "trained:", "quant:")))
    for key, row in rows.items():
        f = G.Findings()
        G.gate_for(key).check(f, key, COMMITTED[key], row, rtol=G.RTOL)
        assert not f.rows, f.rows
        if "device_list" in row:
            assert row["device_list"] == ["cpu"] * SB.DEVICES


def test_serve_batch_example_on_the_cpu(monkeypatch, capsys):
    from repro_torch.examples import serve_batch

    monkeypatch.setattr("sys.argv", ["serve_batch", "--device", "cpu"])
    serve_batch.main()
    out = capsys.readouterr().out
    assert "6 requests over 4 slots" in out
    assert "vikin-mixed: 6 requests in 2 batches" in out
