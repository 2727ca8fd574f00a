"""Port parity: the dry run's tools (``repro_torch.benchmarks.roofline``'s
dry-run half, ``hillclimb``, ``report``, the ``launch/dryrun`` CLI)
against the JAX package, on the CPU.

* ``_param_counts`` (total and active, from ``param_shapes`` on meta)
  equals the reference's ``benchmarks.roofline._param_counts`` for all
  ten archs.
* The sLSTM's recurrent products, counted as the port's time loop runs
  them, equal the reference's ``slstm_scan_flops`` (which its roofline
  adds back to a scanned body).
* ``analyze`` on a hand-made record prices each term as its count over
  the NVIDIA H100 datasheet constant, and returns every field the
  reference's ``analyze`` returns.
* The CLIs on a tiny production cell (xlstm-125m long_500k, 3 s on
  meta) into ``tmp_path``: the dry run (a failing cell recorded with
  ``ok: false`` and exit 1; ``--recalib`` refused), ``hillclimb`` beside
  its baseline, ``roofline`` without ``--engine`` and ``report``, each
  carrying the cell's ``remat``.
* What ``hillclimb --set remat=...`` runs, on reduced archs at a small
  train shape: ``analyze_cell`` with ``remat`` parsed true and false,
  the checkpointed step counting more FLOPs (the recompute) and less
  temp.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline as jroof  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.models.xlstm import slstm_scan_flops  # noqa: E402
from repro_torch.benchmarks import hillclimb as HC  # noqa: E402
from repro_torch.benchmarks import report as RP  # noqa: E402
from repro_torch.benchmarks import roofline as RL  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402

ARCH, SHAPE = "xlstm-125m", "long_500k"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_the_reference(arch):
    assert RL._param_counts(arch) == jroof._param_counts(arch)


def test_slstm_recurrent_flops_equal_the_reference(monkeypatch):
    cfg = ARCHS[ARCH].reduce()
    B, S = 3, 7
    n_slstm = sum(k == "slstm" for k in cfg.pattern)
    counted = []
    cell = X._slstm_cell

    def counting(*args):
        with D.count() as c:
            out = cell(*args)
        counted.append(c.flops)
        return out

    monkeypatch.setattr(X, "_slstm_cell", counting)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    T.forward(T.param_shapes(cfg), cfg, tokens)
    assert n_slstm and len(counted) == n_slstm * S
    ref = J_ARCHS[ARCH].reduce().xlstm_cfg()
    assert sum(counted) == n_slstm * slstm_scan_flops(ref, B, S)


def _record():
    """A dry-run record of qwen2-0.5b train_4k on 16 x 16 by hand, its
    all-gathers along ``model`` and along ``data``."""
    return {
        "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
        "n_chips": 256, "kind": "train", "rank": 0, "ok": True,
        "n_units": 24, "n_extra": 0, "dtype": "bfloat16",
        "full": {"flops": 3.0e13, "bytes_accessed": 2.0e11,
                 "transcendentals": 0.0,
                 "memory": {"argument_size_in_bytes": 2.0 ** 30,
                            "temp_size_in_bytes": 3.0 * 2 ** 30},
                 "collectives": {"all-gather": {
                     "entry": 6.0e9, "body": 0.0, "count": 4,
                     "axes": {"model": {"count": 3, "bytes": 5.0e9,
                                        "group_size": 16},
                              "data": {"count": 1, "bytes": 1.0e9,
                                       "group_size": 16}}}}}}


def test_analyze_prices_each_term_at_the_h100_datasheet():
    rec = _record()
    got = RL.analyze(rec)
    assert got["compute_t"] == 3.0e13 / 989e12
    assert got["memory_t"] == 2.0e11 / 3.35e12
    assert got["collective_t"] == 6.0e9 / 50e9         # both cross nodes
    assert got["dominant"] == "collective"
    assert got["step_t"] == got["collective_t"]
    assert got["mem_gib"] == {"args": 1.0, "temp": 3.0}
    n = RL._param_counts("qwen2-0.5b")["active"]
    assert got["model_flops"] == 6.0 * n * 4096 * 256 / 256
    assert got["useful_ratio"] == got["model_flops"] / 3.0e13
    # every field of the reference's row, from the same figures
    ref = jroof.analyze({**rec, "full": {
        **rec["full"], "bytes accessed": 2.0e11, "collectives": {
            "all-gather": {"entry": 6.0e9, "body": 0.0, "count": 4}}}})
    assert set(ref) <= set(got)
    assert got["model_flops"] == ref["model_flops"]
    # a group inside one node of 8 cards takes NVLink
    rec["mesh"] = "2x2"
    for axes in ("model", "data"):
        assert not RL.crosses_nodes("2x2", axes)
        assert RL.crosses_nodes("16x16", axes)
    assert RL.analyze(rec)["collective_t"] == 6.0e9 / 450e9


def _dryrun(tmp_path, *extra):
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", ARCH, "--shape", SHAPE, "--mesh", "single",
                "--out", str(tmp_path / "dryrun"), *extra])
    return e.value.code


def test_dryrun_cli_records_cells_and_failures(tmp_path, capsys):
    assert _dryrun(tmp_path) == 0
    rec = json.loads((tmp_path / "dryrun" / f"{ARCH}__{SHAPE}__single.json")
                     .read_text())
    for k in ("arch", "shape", "mesh", "n_chips", "kind", "pattern",
              "n_units", "n_extra", "ok", "wall_s", "rank", "counted_by",
              "fits"):
        assert k in rec
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["n_chips"] == 256
    full = rec["full"]
    assert set(full["memory"]) >= {"argument_size_in_bytes",
                                   "output_size_in_bytes",
                                   "temp_size_in_bytes"}
    assert full["flops"] > 0 and full["compile_s"] >= 0
    assert all(set(d) >= {"entry", "body", "count", "axes", "group_size"}
               for d in full["collectives"].values())
    assert "[OK ]" in capsys.readouterr().out
    # --skip-existing reads the record back
    assert _dryrun(tmp_path, "--skip-existing") == 0
    assert "[SKIP]" in capsys.readouterr().out
    # a cell that fails is recorded, with its error, and the run exits 1
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "no-such-arch", "--shape", SHAPE, "--mesh",
                "single", "--out", str(tmp_path / "dryrun")])
    assert e.value.code == 1
    bad = json.loads((tmp_path / "dryrun" /
                      f"no-such-arch__{SHAPE}__single.json").read_text())
    assert not bad["ok"] and "KeyError" in bad["error"] and bad["traceback"]
    with pytest.raises(SystemExit, match="calibrate"):
        D.main(["--recalib"])


def test_hillclimb_roofline_and_report_clis(tmp_path, capsys):
    assert _dryrun(tmp_path) == 0
    res = HC.main(["--arch", ARCH, "--shape", SHAPE, "--opt",
                   "activation_mode=sp", "--tag", "sp", "--baseline-dir",
                   str(tmp_path / "dryrun"), "--out-dir",
                   str(tmp_path / "hc")])
    out = capsys.readouterr().out
    assert "baseline :" in out and "sp       :" in out
    saved = json.loads((tmp_path / "hc" / f"{ARCH}__{SHAPE}__sp.json")
                       .read_text())
    assert saved == json.loads(json.dumps(res))
    assert saved["overrides"] == {"cfg": {}, "opts": {
        "activation_mode": "sp"}}
    assert saved["remat"] is True and "remat True " in out
    rows = RL.main(["--dir", str(tmp_path / "dryrun"), "--out",
                    str(tmp_path / "roofline.json")])
    assert [r["arch"] for r in rows] == [ARCH]
    assert json.loads((tmp_path / "roofline.json").read_text()) == \
        json.loads(json.dumps(rows))
    assert "worst roofline fraction" in capsys.readouterr().out
    md = tmp_path / "DRYRUN.md"
    args = ["--dir", str(tmp_path / "dryrun"), "--roofline",
            str(tmp_path / "roofline.json"), "--out", str(md)]
    text = RP.main(args)
    assert text == md.read_text()
    for marker in ("<!-- DRYRUN_TABLE -->", "<!-- ROOFLINE_TABLE -->"):
        assert text.count(marker) == 1
    assert f"| {ARCH} | {SHAPE} | 16x16 | 0 | ok | True |" in text
    assert f"| {ARCH} | {SHAPE} | " in text.split("## Roofline")[1]
    assert RP.main(args) == text                    # idempotent
    with pytest.raises(SystemExit, match="EXPERIMENTS"):
        RP.main([*args[:4], "--out", str(tmp_path / "EXPERIMENTS.md")])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-medium"])
def test_analyze_cell_counts_remat_both_ways(arch):
    shape = ShapeSpec("train_small", 64, 4, "train")
    full = {}
    for flag in ("true", "false"):
        over = D.parse_kv([f"remat={flag}"])
        cfg = dataclasses.replace(ARCHS[arch].reduce(), **over)
        rec = D.analyze_cell(cfg, shape, mesh_shape=(1, 1))
        assert rec["ok"] and rec["remat"] is over["remat"]
        full[over["remat"]] = rec["full"]
    on, off = full[True], full[False]
    assert on["flops"] > off["flops"]
    assert on["memory"]["temp_size_in_bytes"] < \
        off["memory"]["temp_size_in_bytes"]
    assert on["memory"]["argument_size_in_bytes"] == \
        off["memory"]["argument_size_in_bytes"]
