"""Port parity: Megatron tensor parallelism over ``model`` (the mesh
train step's compute, ``launch/sharding.tp_unit``, ``models/layers.
Shard``, the tensor-parallel attention, FFNs, vocab-parallel embedding
and cross-entropy, ``collectives.gather_seq`` / ``scatter_seq``) and the
xLSTM's deterministic scan, on the CPU.

* The unit rule at every zoo arch's full config (shapes on the meta
  device) on 2x2 and 1x4: which leaves are computed from their ``model``
  shard, pinned arch by arch.
* Two gloo ranks (one spawn, a 1x2 mesh), each layer from numpy draws of
  a seed against the same layer in one process, output and input
  gradient (and the rank's parameter gradients): attention (GQA, GQA
  with qk-norm, a single kv head, kv heads shared unevenly), swiglu
  (dense and masked), an mlp with biases, the KAN pair (f32, and bf16
  with the reference's f32 ``t``) and ``kanffn`` at f32.  f32 within
  ``1e-5 * (1 + max|ref|)``, bf16 within two bf16 ulps of ``1 +
  max|ref|``.  The vocab-parallel embedding bitwise the dense lookup
  (f32, bf16); ``lm_loss`` with z-loss (tied and untied heads) within
  1e-6 relative of the dense one, its gradients within ``1e-6 * (1 +
  max|g|)``; the sequence collectives on a sequence that does not split
  evenly, forward and backward, exactly.
* ``StepOptions.activation_mode``: the reference's default, ``"sp"``,
  and any other value refused.
* ``models/xlstm.inclusive_scan`` against the reference's ``jnp.cumsum``
  within the xLSTM tests' ``1e-5 * (1 + max|ref|)``.
"""
import json
import os
import re
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshContext,
    ProcessMesh,
    make_host_mesh,
    spawn_ranks,
)
from repro_torch.models.xlstm import inclusive_scan  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SPAWN_S = 120
TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -8
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-6

# the leaves computed from their model shard, by role (a decoder block's
# prefix taken off), at each zoo arch's full config
ATTN = {"attn.wq.kernel", "attn.wo.kernel"}
KV = {"attn.wk.kernel", "attn.wv.kernel"}
QKV_BIAS = {"attn.wq.bias", "attn.wk.bias", "attn.wv.bias"}
GLU = {"ffn.gate.kernel", "ffn.up.kernel", "ffn.down.kernel"}
REC = {"rec.in_x.kernel", "rec.in_gate.kernel", "rec.conv", "rec.lambda",
       "rec.wa.kernel", "rec.wa.bias", "rec.wx.kernel", "rec.wx.bias",
       "rec.out.kernel"}
MLP = {"ffn.up.kernel", "ffn.up.bias", "ffn.down.kernel"}
CROSS = {"cross." + r[len("attn."):] for r in ATTN | KV | QKV_BIAS}
ENC = {"encoder.units." + r for r in ATTN | KV | QKV_BIAS | MLP}
MLSTM = {"mlstm.wq.kernel", "mlstm.wk.kernel", "mlstm.wv.kernel",
         "mlstm.down.kernel"}
SHARED = {"moe.shared.up.kernel", "moe.shared.down.kernel"}
TP_ROLES = {
    ("qwen2-0.5b", "2x2"): ATTN | KV | QKV_BIAS | GLU | {"embed.table"},
    # 14 heads, 2 kv heads: no whole heads over 4 ranks
    ("qwen2-0.5b", "1x4"): GLU | {"embed.table"},
    ("qwen1.5-0.5b", "2x2"): ATTN | KV | QKV_BIAS | GLU | {"embed.table"},
    ("qwen1.5-0.5b", "1x4"): ATTN | KV | QKV_BIAS | GLU | {"embed.table"},
    ("mistral-nemo-12b", "2x2"): ATTN | KV | GLU | {"embed.table",
                                                    "lm_head.kernel"},
    ("mistral-nemo-12b", "1x4"): ATTN | KV | GLU | {"embed.table",
                                                    "lm_head.kernel"},
    # one kv head: wk/wv gathered
    ("granite-20b", "2x2"): ATTN | {"attn.wq.bias", "ffn.up.kernel",
                                    "ffn.up.bias", "ffn.down.kernel",
                                    "embed.table"},
    ("granite-20b", "1x4"): ATTN | {"attn.wq.bias", "ffn.up.kernel",
                                    "ffn.up.bias", "ffn.down.kernel",
                                    "embed.table"},
    ("recurrentgemma-9b", "2x2"): ATTN | GLU | REC | {"embed.table"},
    ("recurrentgemma-9b", "1x4"): ATTN | GLU | REC | {"embed.table"},
    ("paligemma-3b", "2x2"): ATTN | GLU | {"embed.table"},
    ("paligemma-3b", "1x4"): ATTN | GLU | {"embed.table"},
    # the experts are expert-parallel, not in this rule
    ("qwen3-moe-235b-a22b", "2x2"): ATTN | KV | {"embed.table",
                                                 "lm_head.kernel"},
    ("qwen3-moe-235b-a22b", "1x4"): ATTN | KV | {"embed.table",
                                                 "lm_head.kernel"},
    # the routed experts are expert-parallel; the shared one's lanes TP
    ("llama4-scout-17b-a16e", "2x2"): ATTN | KV | SHARED | {
        "embed.table", "lm_head.kernel"},
    ("llama4-scout-17b-a16e", "1x4"): ATTN | KV | SHARED | {
        "embed.table", "lm_head.kernel"},
    # the encoder and cross-attention too; frontend_proj is gathered;
    # vocab 51865 is odd
    ("whisper-medium", "2x2"): ATTN | KV | QKV_BIAS | MLP | CROSS | ENC,
    ("whisper-medium", "1x4"): ATTN | KV | QKV_BIAS | MLP | CROSS | ENC,
    # the mLSTM's heads; the sLSTM is gathered
    ("xlstm-125m", "2x2"): MLSTM | {"embed.table"},
    ("xlstm-125m", "1x4"): MLSTM | {"embed.table"},
}
BLOCK = re.compile(r"^(\['units'\]\['slot\d+'\]|\['extra'\]\[\d+\])")


def _role(path):
    return ".".join(re.findall(r"\['([^']+)'\]", BLOCK.sub("", path)))


def _tp_leaves(cfg, shape):
    mesh = ProcessMesh(("data", "model"), shape, abstract=True)
    specs = ST.train_state_shardings(cfg, mesh)["params"]
    return mesh, specs, ST._tp_paths(cfg, mesh, specs)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_unit_rule_at_full_config(arch, shape):
    cfg = ARCHS[arch]
    mesh, specs, tp = _tp_leaves(cfg, shape)
    tag = "x".join(map(str, shape))
    assert {_role(k) for k in tp} == TP_ROLES[(arch, tag)]
    m = shape[1]
    for k, spec in leaf_paths(specs):
        if k not in tp:
            continue
        assert "model" in spec.axes(), k
        if re.search(r"\['(wq|wo)'\]", k):
            assert cfg.n_heads % m == 0, k
        if re.search(r"\['(wk|wv)'\]", k):
            assert cfg.n_kv_heads % m == 0, k
        assert "['frontend_proj']" not in k and "['slstm']" not in k, k


def test_unit_rule_gathers_kv_heads_that_do_not_split():
    _, _, tp = _tp_leaves(ARCHS["qwen2-0.5b"], (1, 4))
    assert not any(re.search(r"\['(wq|wk|wv|wo)'\]", k) for k in tp)
    _, _, tp = _tp_leaves(ARCHS["recurrentgemma-9b"], (2, 2))
    roles = {_role(k) for k in tp}
    assert "attn.wq.kernel" in roles and not roles & KV
    _, _, tp = _tp_leaves(ARCHS["qwen2-0.5b"], (2, 2))
    assert KV <= {_role(k) for k in tp}


def test_unit_rule_is_none_on_one_model_rank():
    cfg = ARCHS["qwen2-0.5b"]
    for shape in ((1, 1), (4, 1)):
        assert not _tp_leaves(cfg, shape)[2]


def test_activation_mode_option():
    from repro.launch.steps import StepOptions as RefOptions

    assert ST.StepOptions().activation_mode == RefOptions().activation_mode
    assert ST.StepOptions(activation_mode="sp").activation_mode == "sp"
    with pytest.raises(ValueError, match="activation_mode"):
        ST.StepOptions(activation_mode="seq")
    with pytest.raises(ValueError, match="activation_mode"):
        MeshContext(make_host_mesh(), activation_mode="tp")
    assert not MeshContext(make_host_mesh(), activation_mode="sp").sp


@pytest.mark.parametrize("L", [1, 16, 128])
def test_xlstm_scan_matches_reference_cumsum(L):
    import jax.numpy as jnp

    rng = np.random.default_rng(L)
    lf = np.log(1 / (1 + np.exp(-rng.normal(2.0, 2.0, (2, 3, L))))
                ).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(lf), axis=-1))
    got = inclusive_scan(torch.from_numpy(lf)).numpy()
    assert got.dtype == np.float32
    err = float(np.abs(got - ref).max())
    assert err <= TOL * (1 + float(np.abs(ref).max())), err


# one rank of the layer checks on a 1x2 mesh
WORKER = textwrap.dedent("""
    import sys, json, dataclasses
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import collectives as COLL, mesh as M
    from repro_torch.models import attention as A, ffn as FF, \\
        transformer as T
    from repro_torch.models.layers import Shard, embed
    from repro_torch.utils import leaf_paths, tree_map

    out = sys.argv[1]
    mesh = M.init_from_env((1, 2), device="cpu")
    r, m = mesh.index_over("model"), 2
    sh = Shard(mesh)
    res = {}

    def draw(seed, *shape, scale=0.5, dtype=torch.float32):
        g = np.random.default_rng(seed)
        return torch.as_tensor((g.standard_normal(shape) * scale).astype(
            np.float32)).to(dtype)

    def cut(a, dim):
        n = a.shape[dim] // m
        return a.narrow(dim, r * n, n).contiguous()

    def leaves(tree):
        return [v for _, v in leaf_paths(tree)]

    def live(tree):
        return tree_map(lambda a: a.detach().clone().requires_grad_(True),
                        tree)

    def err(got, ref):
        got, ref = got.detach().double(), ref.detach().double()
        return [float((got - ref).abs().max()), float(ref.abs().max())]

    def layer(name, dense_fn, tp_fn, params, local_of, x):
        # output, x's gradient and the rank's parameter gradients
        ct = draw(99, *x.shape)
        pd, xd = live(params), x.detach().clone().requires_grad_(True)
        yd = dense_fn(pd, xd)
        (yd.float() * ct).sum().backward()
        pt, xt = live(local_of(params)), x.detach().clone().requires_grad_(
            True)
        yt = tp_fn(pt, COLL.enter(xt, mesh))
        (yt.float() * ct).sum().backward()
        e = {"y": err(yt, yd), "dx": err(xt.grad, xd.grad)}
        want = local_of(tree_map(lambda a: a.grad, pd))
        for (k, g), (_, w) in zip(leaf_paths(tree_map(lambda a: a.grad, pt)),
                                  leaf_paths(want)):
            e["d" + k] = err(g, w)
        res[name] = e

    # attention: GQA (+ qk-norm), one kv head, kv heads shared unevenly
    for name, H, KVH, extra in (
            ("attn_gqa", 4, 2, {"qkv_bias": True}),
            ("attn_gqa_qknorm", 4, 2, {"qk_norm": True}),
            ("attn_one_kv", 4, 1, {"qkv_bias": True}),
            ("attn_uneven_kv", 6, 3, {})):
        cfg = A.AttnConfig(d_model=48, n_heads=H, n_kv_heads=KVH,
                           head_dim=8, **extra)
        params = A.attn_init(torch.Generator().manual_seed(1), cfg)
        if cfg.qkv_bias:
            for k in ("wq", "wk", "wv"):
                params[k]["bias"] = draw(2, H * 8 if k == "wq" else KVH * 8)
        kv_split = KVH % m == 0

        def local_of(p, kv_split=kv_split):
            q = {"wq": tree_map(lambda a: cut(a, a.dim() - 1), p["wq"]),
                 "wo": {"kernel": cut(p["wo"]["kernel"], 0)}}
            for k in ("wk", "wv"):
                q[k] = (tree_map(lambda a: cut(a, a.dim() - 1), p[k])
                        if kv_split else p[k])
            return {**p, **q}

        layer(name, lambda p, x, cfg=cfg: A.attention(p, x, cfg),
              lambda p, x, cfg=cfg: A.attention(p, x, cfg, shard=sh),
              params, local_of, draw(3, 2, 10, 48))

    # FFNs
    def glu_local(p):
        # gate/up: their hidden columns (and bias); down: its rows
        q = {}
        for k, v in p.items():
            q[k] = {"kernel": cut(v["kernel"], 0 if k == "down" else 1)}
            if "bias" in v:
                q[k]["bias"] = v["bias"] if k == "down" else cut(v["bias"],
                                                                 0)
        return q

    def kan_local(p):
        return {"kan_up": tree_map(lambda a: cut(a, a.dim() - 1),
                                   p["kan_up"]),
                "kan_down": tree_map(lambda a: cut(a, 0), p["kan_down"])}

    def kanffn_local(p):
        return {"kan_up": tree_map(lambda a: cut(a, a.dim() - 1),
                                   p["kan_up"]), "w": p["w"], "b": p["b"]}

    for name, fcfg, dtype, local_of in (
            ("swiglu", FF.FFNConfig(32, 64, "swiglu"), torch.float32,
             glu_local),
            ("swiglu_masked", FF.FFNConfig(32, 64, "swiglu",
                                           pattern_rate=0.5),
             torch.float32, glu_local),
            ("mlp_bias", FF.FFNConfig(32, 64, "mlp", bias=True),
             torch.float32, glu_local),
            ("kan_f32", FF.FFNConfig(32, 64, "kan", pattern_rate=0.5),
             torch.float32, kan_local),
            ("kan_bf16", FF.FFNConfig(32, 64, "kan", pattern_rate=0.5),
             torch.bfloat16, kan_local),
            ("kanffn_f32", FF.FFNConfig(32, 64, "kanffn", pattern_rate=0.5,
                                        kan_hidden=16),
             torch.float32, kanffn_local)):
        params = FF.ffn_init(torch.Generator().manual_seed(4), fcfg, dtype)
        if fcfg.bias:
            params["up"]["bias"] = draw(5, 64)
            params["down"]["bias"] = draw(6, 32)
        if fcfg.kind == "kanffn":
            params["b"] = draw(7, 32)
        layer(name, lambda p, x, c=fcfg: FF.ffn_apply(p, x, c),
              lambda p, x, c=fcfg: FF.ffn_apply(p, x, c, sh),
              params, local_of, draw(8, 2, 6, 32, scale=0.8, dtype=dtype))
        res[name]["dtype"] = str(dtype)

    # the vocab-parallel embedding
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, 64, (3, 7)))
    for dtype in (torch.float32, torch.bfloat16):
        table = draw(10, 64, 16, dtype=dtype)
        res["embed_" + str(dtype)] = bool(torch.equal(
            embed({"table": cut(table, 0)}, tokens, sh),
            embed({"table": table}, tokens)))

    # the vocab-parallel cross-entropy with z-loss
    for arch in ("qwen2-0.5b", "qwen3-moe-235b-a22b"):
        cfg = get_config(arch).reduce(d_model=32, vocab_size=64,
                                      loss_chunks=2)
        key = ("['embed']['table']" if cfg.tied_embeddings
               else "['lm_head']['kernel']")
        head = ({"embed": {"table": draw(11, 64, 32)}} if cfg.tied_embeddings
                else {"lm_head": {"kernel": draw(11, 32, 64)}})
        local = tree_map(lambda a: cut(a, 0 if cfg.tied_embeddings else 1),
                         head)
        hidden = draw(12, 2, 8, 32)
        labels = torch.as_tensor(np.random.default_rng(13).integers(
            0, 64, (2, 8)))
        pd, hd = live(head), hidden.clone().requires_grad_(True)
        ld = T.lm_loss(pd, cfg, hd, labels)
        ld.backward()
        pt, ht = live(local), hidden.clone().requires_grad_(True)
        with M.set_mesh(mesh, tp={key}):
            lt = T.lm_loss(pt, cfg, ht, labels)
        lt.backward()
        gd = tree_map(lambda a: cut(a.grad, 0 if cfg.tied_embeddings
                                    else 1), pd)
        res["loss_" + arch] = {
            "loss": [float(lt), float(ld)], "dh": err(ht.grad, hd.grad),
            "dw": err(leaves(pt)[0].grad, leaves(gd)[0])}

    # the sequence collectives over 7 positions: chunks of 4 and 3
    n, lo, hi = 7, *COLL.seq_bounds(7, mesh)[:2]
    both = [draw(20 + j, 2, n, 3) for j in range(m)]
    cts = [draw(30 + j, 2, n, 3) for j in range(m)]
    for partial in (True, False):
        xc = both[0][:, lo:hi].clone().requires_grad_(True)
        y = COLL.gather_seq(xc, mesh, n, partial=partial)
        y.backward(cts[r])
        want = (cts[0] + cts[1]) if partial else cts[r]
        res[f"gather_seq_{partial}"] = bool(
            torch.equal(y, both[0]) and torch.equal(xc.grad,
                                                    want[:, lo:hi]))
    for reduce in (True, False):
        x = both[r].clone().requires_grad_(True)
        y = COLL.scatter_seq(x, mesh, reduce=reduce)
        y.backward(cts[0][:, lo:hi])
        want = (both[0] + both[1]) if reduce else both[r]
        res[f"scatter_seq_{reduce}"] = bool(
            torch.equal(y, want[:, lo:hi]) and torch.equal(x.grad, cts[0]))
    res["seq_bounds"] = [lo, hi]
    json.dump(res, open(out + f"/rank{r}.json", "w"))
    M.destroy_process_mesh(mesh)
""")


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_layers")
    env = {"PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    spawn_ranks(["-c", WORKER, str(tmp)], 2, str(tmp / "rv"),
                timeout_s=SPAWN_S, env=env)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in (0, 1)]


def _within(e, tol):
    err, scale = e
    return err <= tol * (1 + scale)


@pytest.mark.parametrize("name", ["attn_gqa", "attn_gqa_qknorm",
                                  "attn_one_kv", "attn_uneven_kv"])
def test_tp_attention_matches_one_process(layers, name):
    for res in layers:
        for what, e in res[name].items():
            assert _within(e, TOL), (what, e)


@pytest.mark.parametrize("name", ["swiglu", "swiglu_masked", "mlp_bias",
                                  "kan_f32", "kan_bf16", "kanffn_f32"])
def test_tp_ffn_matches_one_process(layers, name):
    for res in layers:
        r = dict(res[name])
        tol = BF16_TOL if r.pop("dtype") == "torch.bfloat16" else TOL
        for what, e in r.items():
            assert _within(e, tol), (what, e)


def test_vocab_parallel_embedding_is_bitwise(layers):
    for res in layers:
        assert res["embed_torch.float32"] and res["embed_torch.bfloat16"]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-235b-a22b"])
def test_vocab_parallel_loss_matches_dense(layers, arch):
    for res in layers:
        r = res["loss_" + arch]
        got, want = r["loss"]
        assert abs(got - want) <= LOSS_RTOL * abs(want)
        assert _within(r["dh"], GRAD_TOL) and _within(r["dw"], GRAD_TOL), r


def test_sequence_collectives_on_an_uneven_sequence(layers):
    assert [res["seq_bounds"] for res in layers] == [[0, 4], [4, 7]]
    for res in layers:
        for k in ("gather_seq_True", "gather_seq_False", "scatter_seq_True",
                  "scatter_seq_False"):
            assert res[k], k
