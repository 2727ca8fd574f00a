"""Port parity: abstract shapes and the serve steps' plumbing against the
JAX package.

``param_shapes``, ``launch/specs.input_specs`` and ``frontend_specs`` at
every arch's registered (full) size: the same leaves, shapes and dtypes
as the reference's ``jax.eval_shape`` trees, as tensors on the meta
device (nothing allocated: qwen3-moe's 235 B params too).  Then every
arch of the registry, reduced, built and run end to end by the port
(``init_params``, ``forward``, ``lm_loss``, the serve steps and, for
whisper, ``encode``), and a decode step leaving its input caches as they
were.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import ARCHS as J_ZOO  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import ARCHS as T_ZOO  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

ARCHS = sorted(T_ZOO)


def shapes(tree):
    """[(path, shape, dtype name)] of a reference or port tree."""
    return [(p, tuple(a.shape), str(a.dtype).split(".")[-1])
            for p, a in leaf_paths(tree)]


def all_meta(tree):
    return all(a.device.type == "meta" for _, a in leaf_paths(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch):
    got = TT.param_shapes(T_ZOO[arch])
    assert all_meta(got)
    assert shapes(got) == shapes(JT.param_shapes(J_ZOO[arch]))


def test_param_shapes_allocate_nothing():
    """235 B params, as the reference's own test counts them."""
    got = TT.param_shapes(T_ZOO["qwen3-moe-235b-a22b"])
    assert all_meta(got)
    assert sum(a.numel() for _, a in leaf_paths(got)) > 200e9


@pytest.mark.parametrize("shape", sorted(tbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    got = TSP.input_specs(T_ZOO[arch], tbase.SHAPES[shape])
    want = JSP.input_specs(J_ZOO[arch], jbase.SHAPES[shape])
    assert sorted(got) == sorted(want)
    assert all_meta(got)
    assert shapes(got) == shapes(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_specs_equal_the_reference(arch):
    got = TSP.frontend_specs(T_ZOO[arch], 3)
    assert all_meta(got)
    assert shapes(got) == shapes(JSP.frontend_specs(J_ZOO[arch], 3))


def test_input_specs_refuse_a_bad_kind():
    bad = dataclasses.replace(tbase.SHAPES["train_4k"], kind="nope")
    with pytest.raises(ValueError, match="nope"):
        TSP.input_specs(T_ZOO["qwen2-0.5b"], bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_builds_and_runs(arch):
    """Reduced: init, forward, the loss, prefill and two decode steps
    (and the encoder), finite and of the reference's shapes."""
    cfg = T_ZOO[arch].reduce()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9))
                            .astype(np.int32))
    kw = {}
    if cfg.frontend is not None:
        x = torch.from_numpy(0.1 * rng.normal(size=(
            2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
        kw = {"frames" if cfg.frontend == "audio" else "patches": x}
    if cfg.enc_dec:
        mem = TT.encode(params, cfg, kw["frames"])
        assert mem.shape == kw["frames"].shape
        assert bool(torch.isfinite(mem).all())
    inputs, labels = toks[:, :-1], toks[:, 1:]
    h, aux = TT.forward(params, cfg, inputs, **kw)
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    assert h.shape == (2, 8 + extra, cfg.d_model)
    loss = TT.lm_loss(params, cfg, h[:, -labels.shape[1]:], labels)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(aux))
    tok, caches = TS.make_prefill_step(cfg)(params, {"tokens": inputs,
                                                     **kw})
    dec = TS.make_decode_step(cfg)
    for _ in range(2):
        tok, caches = dec(params, {"token": tok, "caches": caches})
        assert tok.shape == (2, 1) and tok.dtype == torch.int32
        assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch,over", [
    ("whisper-medium", {"ffn_kind": "kan", "pattern_rate": 0.5}),
    ("paligemma-3b", {})], ids=["whisper-kan", "paligemma"])
def test_decode_step_leaves_its_input_caches_as_they_were(arch, over):
    """The serve steps' contract: a decode step returns new caches and
    the ones it was given (``ck``/``cv`` too) keep their values."""
    cfg = dataclasses.replace(T_ZOO[arch].reduce(), **over)
    params = TT.init_params(cfg, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))}
    key = "frames" if cfg.enc_dec else "patches"
    batch[key] = torch.from_numpy(0.1 * rng.normal(size=(
        2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    ffns = TT.ffn_modules(params, cfg)
    tok, caches = TS.make_prefill_step(cfg, ffns=ffns)(params, batch)
    before = [a.clone() for _, a in leaf_paths(caches)]
    tok2, new = TS.make_decode_step(cfg, ffns=ffns)(
        params, {"token": tok, "caches": caches})
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(before, leaf_paths(caches)))
    assert [p for p, _ in leaf_paths(new)] == [p for p, _ in
                                               leaf_paths(caches)]
    assert not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(leaf_paths(new), leaf_paths(caches)))
