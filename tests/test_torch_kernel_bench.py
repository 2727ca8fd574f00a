"""The port's kernel bench on the CPU: it passes its own asserts (the
plain versions against each other and the oracles, in f32 and in bf16,
the tuning round trip) and writes its JSON where it is told; nothing is
timed off the card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.splines import SplineSpec as JSpec  # noqa: E402
from repro.core.splines import dense_eval_op_count as jax_dense_ops  # noqa
from repro.core.splines import spu_op_count as jax_spu_ops  # noqa: E402
from repro_torch.benchmarks import kernel_bench  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_run_on_cpu_writes_its_json(tmp_path):
    out = tmp_path / "sub" / "kb.json"
    res = kernel_bench.run("cpu", out)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["device"] == "cpu"
    # the bf16 rows of the JAX bench (``kan_fused.*_bfloat16``) and of the
    # spline basis beside the f32 ones; no "not run" placeholder
    assert set(res["spline_basis"]) == {
        f"{gk}{d}" for gk in ("G4K3", "G16K3", "G8K2")
        for d in ("", "_bfloat16")}
    assert set(res["kan_fused"]) == {
        f"{shape}_{d}" for shape in ("72x96", "72x96_p50", "128x128_p75")
        for d in ("float32", "bfloat16")}
    assert set(res["pattern_matmul"]) == {"rate0.0", "rate0.5", "rate0.75"}
    assert "bf16" not in res
    for name, r in res["spline_basis"].items():
        gk, _, dtype = name.partition("_")
        g, k = int(gk[1:gk.index("K")]), int(gk[gk.index("K") + 1:])
        size = 2 if dtype == "bfloat16" else 4
        assert r["bitwise_plain"] and r["ms"] is None
        assert r["spu_ops_per_input"] == jax_spu_ops(JSpec(g, k))
        assert r["dense_ops_per_input"] == jax_dense_ops(JSpec(g, k))
        assert r["bytes_in"] == 4096 * size
        assert r["bytes_out"] == 4096 * (g + k) * size
        # the bench's bars against the dense f32 oracle
        assert r["max_err"] < (2e-2 if size == 2 else 1e-4)
    for name, r in res["kan_fused"].items():
        assert r["ms_v1"] is None and r["ms_v2"] is None
        assert r["bytes_weights_v1"] == r["bytes_weights_v2"]
        assert r["max_err_v1_v2"] <= 1e-4
        # the JAX bench's bars: the f32 accumulator within 1e-4 of the
        # plain version, within 5e-2 of the dense f32 oracle at bf16
        assert r["max_err_v2"] <= 1e-4 and r["max_err_v1"] <= 1e-4
        assert r["max_err_dense_ref"] <= (
            5e-2 if name.endswith("bfloat16") else 1e-4)
    for shape in ("72x96", "72x96_p50", "128x128_p75"):
        f32, bf16 = (res["kan_fused"][f"{shape}_{d}"]
                     for d in ("float32", "bfloat16"))
        assert bf16["bytes_weights_v2"] * 2 == f32["bytes_weights_v2"]
        assert bf16["contraction_kept"] == f32["contraction_kept"]
    # (1,0,0,0) on 7 bases keeps basis 0 and the partial trailing group
    assert res["kan_fused"]["128x128_p75_float32"]["contraction_kept"] \
        == 128 * 4
    assert res["pattern_matmul"]["rate0.75"]["k_dim"] == 128
    t = res["tuning"]
    assert t["cache_round_trip"] is True
    assert t["tuned_blocks"] in t["candidates"]
    assert t["cache_key"].endswith("|float32|cpu")
    tm = t["pattern_matmul"]
    assert tm["shape"] == [8192, 72, 304] and tm["act"] == "relu"
    assert tm["cache_round_trip"] is True
    assert tm["cache_key"] == "pattern_matmul|8192x128x512|float32|cpu"
    assert tm["ms_default"] is None and tm["ms_tuned"] is None
    tk = t["kan_fused"]
    assert tk["shape"] == [8, 304, 32] and tk["cache_round_trip"] is True
    assert tk["cache_key"] == "kan_fused_v2|8x512x32x8|float32|cpu"
    assert tk["ms_default"] is None and tk["ms_tuned"] is None
    t1 = t["kan_fused_v1"]
    assert t1["shape"] == [8, 304, 32] and t1["version"] == 1
    assert t1["cache_round_trip"] is True
    assert t1["cache_key"] == "kan_fused_v1|8x512x32x8|float32|cpu"
    assert t1["tuned_blocks"] in autotune.candidates_kan_fused(
        8, 304, 32, 5, torch.float32, 1)
    assert t1["ms_default"] is None and t1["ms_tuned"] is None


def test_cli_on_cpu(tmp_path):
    out = tmp_path / "kb.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.kernel_bench",
         "--device", "cpu", "--out", str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "round_trip=True" in proc.stdout
    assert "matmul [8192, 72, 304]" in proc.stdout
    assert json.loads(out.read_text())["device"] == "cpu"
    assert not (tmp_path / "chiprun_out").exists()


def test_run_refuses_the_card_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_bench.run("cuda", tmp_path / "kb.json")
    assert not (tmp_path / "kb.json").exists()
