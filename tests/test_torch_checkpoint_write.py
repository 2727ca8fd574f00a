"""Port parity: the checkpoint write half (``save_checkpoint``,
``AsyncCheckpointer``) against the JAX package's.

The reference restores what the port writes bitwise (params, masks,
scales); the manifest equals the reference's for the same tree, byte for
byte; retention, the ``.tmp.<step>`` commit and the async error path
behave as the reference's.
"""
import json
import os
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jck  # noqa: E402
from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    masks_from_keep,
    scales_from_jax,
    stack_params_from_jax,
)
from repro_torch.utils import leaf_paths  # noqa: E402

ARCHS = ("vikin-small", "vikin-mixed")


def _setup(arch, seed=0):
    jmodel = J_ARCHS[arch]
    jp = j_stack_init(jax.random.key(seed), jmodel)
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    calib_x = np.random.default_rng(seed).random(
        (64, jmodel.sizes[0])).astype(np.float32)
    jm = jcal.calibrate_stack(jp, jmodel, calib_x).masks
    js = jcal.calibrate_scales(jp, jmodel, calib_x)
    tp = stack_params_from_jax(np_params, VIKIN_ARCHS[arch])
    return jp, np_params, jm, js, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_restores_the_ports_checkpoint_bitwise(tmp_path, arch):
    jp, np_params, jm, js, tp = _setup(arch)
    extra = {"arch": arch, "val": {"mse": 0.125}, "rates": [None, 0.5]}
    path = tck.save_checkpoint(
        str(tmp_path), 7, tp, extra=extra,
        masks=masks_from_keep([None if m is None else m.keep for m in jm]),
        scales=scales_from_jax(js))
    assert path == os.path.join(str(tmp_path), "step_7")
    target = j_stack_init(jax.random.key(9), J_ARCHS[arch])
    got, step, got_extra = jck.restore_checkpoint(str(tmp_path), target)
    assert step == 7 and got_extra == extra
    for (k, a), (_, b) in zip(leaf_paths(got), leaf_paths(np_params)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    masks = jck.restore_masks(str(tmp_path))
    assert [None if m is None else m.keep.tolist() for m in masks] == \
        [None if m is None else m.keep.tolist() for m in jm]
    scales = jck.restore_scales(str(tmp_path))
    assert scales.summary() == js.summary()
    for a, b in zip(scales.scales, js.scales):
        assert a.kind == b.kind and a.x == b.x
        for f in ("w", "w_b", "t"):
            if getattr(b, f) is not None:
                assert np.array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f))), f


@pytest.mark.parametrize("with_extras", [False, True])
def test_manifest_and_arrays_equal_the_references(tmp_path, with_extras):
    jp, np_params, jm, js, tp = _setup("vikin-mixed")
    kw_t, kw_j = {}, {}
    if with_extras:
        kw_j = {"extra": {"a": 1}, "masks": list(jm), "scales": js}
        kw_t = {"extra": {"a": 1},
                "masks": masks_from_keep([None if m is None else m.keep
                                          for m in jm]),
                "scales": scales_from_jax(js)}
    jck.save_checkpoint(str(tmp_path / "ref"), 3, jp, **kw_j)
    tck.save_checkpoint(str(tmp_path / "port"), 3, tp, **kw_t)
    names = sorted(os.listdir(tmp_path / "ref" / "step_3"))
    assert sorted(os.listdir(tmp_path / "port" / "step_3")) == names
    ref_m = (tmp_path / "ref" / "step_3" / "manifest.json").read_bytes()
    assert (tmp_path / "port" / "step_3" / "manifest.json").read_bytes() \
        == ref_m
    assert json.loads(ref_m)["format"] == 1
    for name in names:
        if name.endswith(".npz"):
            with np.load(tmp_path / "ref" / "step_3" / name) as a, \
                    np.load(tmp_path / "port" / "step_3" / name) as b:
                assert a.files == b.files
                for k in a.files:
                    assert a[k].dtype == b[k].dtype
                    assert np.array_equal(a[k], b[k]), (name, k)


def test_keep_retention_and_latest(tmp_path):
    tree = [{"w": torch.arange(6.0).reshape(2, 3)}]
    for step in (1, 5, 3, 8):
        tck.save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert sorted(tck.all_steps(str(tmp_path))) == [5, 8]
    assert jck.latest_step(str(tmp_path)) == tck.latest_step(str(tmp_path))
    # an overwrite of a committed step replaces it
    tck.save_checkpoint(str(tmp_path), 8, [{"w": torch.ones(2, 3)}])
    got, step, _ = tck.restore_checkpoint(str(tmp_path), tree)
    assert step == 8 and torch.equal(got[0]["w"], torch.ones(2, 3))


def test_stale_tmp_directory_is_replaced_and_never_restored(tmp_path):
    tree = [{"w": torch.ones(3)}]
    stale = tmp_path / ".tmp.4"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"partial write of a dead worker")
    assert tck.all_steps(str(tmp_path)) == []
    tck.save_checkpoint(str(tmp_path), 4, tree)
    assert not stale.exists()
    assert sorted(os.listdir(tmp_path)) == ["step_4"]
    # a half-written step directory without its manifest is not a step
    (tmp_path / "step_9").mkdir()
    assert tck.latest_step(str(tmp_path)) == 4


def test_async_checkpointer_error_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the checkpoint directory should be")
    saver = tck.AsyncCheckpointer(str(blocker))
    saver.save(1, [{"w": torch.ones(2)}])
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                            # the error is raised once
    ok = tck.AsyncCheckpointer(str(tmp_path / "ok"))
    ok.save(2, [{"w": torch.ones(2)}], extra={"k": 1})
    ok.wait()
    assert tck.restore_checkpoint(str(tmp_path / "ok"),
                                  [{"w": torch.zeros(2)}])[2] == {"k": 1}


def test_async_checkpointer_snapshots_on_the_calling_thread(tmp_path,
                                                         monkeypatch):
    """The tree is copied to host numpy inside ``save``: in-place updates
    after it (training continuing) do not reach the file, and the writer
    thread touches no tensor."""
    w = torch.arange(12.0).reshape(3, 4)
    b = np.linspace(0, 1, 4).astype(np.float32)
    want_w, want_b = w.clone(), b.copy()
    gate = threading.Event()
    real = tck.checkpoint.save_checkpoint

    def slow_save(*args, **kw):
        gate.wait(timeout=30)
        tree = args[2]
        assert all(isinstance(v, np.ndarray) for _, v in leaf_paths(tree))
        return real(*args, **kw)

    monkeypatch.setattr(tck.checkpoint, "save_checkpoint", slow_save)
    saver = tck.AsyncCheckpointer(str(tmp_path), keep=None)
    saver.save(3, [{"w": w, "b": b}])
    w.add_(100.0)
    b += 100.0
    gate.set()
    saver.wait()
    got, _, _ = tck.restore_checkpoint(
        str(tmp_path), [{"w": torch.zeros(3, 4), "b": np.zeros(4,
                                                               np.float32)}])
    assert torch.equal(got[0]["w"], want_w)
    assert np.array_equal(got[0]["b"], want_b)
