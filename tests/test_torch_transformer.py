"""Port parity: the transformer LM family (``repro_torch.models.transformer``,
the five LM configs and their glue) against the reference (JAX, CPU);
``test_torch_transformer_serve.py`` holds prefill, decode and the bound
train steps.

Weights come from the reference's ``init`` through
``convert.transformer_params_from_numpy``; tokens are numpy draws.
Tolerances, against each compared tensor's largest magnitude:
  * ``compute_dtype=float32``: 1e-5 for hidden states, logits, caches and
    losses, 1e-4 for every gradient leaf (f32 sums in another order, the
    online softmax's exp and the chunked log-sum-exp; measured worst 2.3e-5);
  * bf16: 3e-2 for values, 6e-2 for gradient leaves. The two frameworks
    round bf16 at other places (XLA's CPU dot emits bf16 from an f32 sum,
    as torch does, but their sum orders differ, and a rounding flip moves a
    value by a bf16 ulp, 2^-8, which the next layer carries on); the
    table's gradient also differs by design (gathered then cast: duplicate
    ids add in f32, not in bf16);
  * the attention against a float64 naive softmax: 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as jcb
from repro.models import nn as RN
from repro.models import transformer as T
from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import base as cb
from repro_torch.data.synthetic import token_batch
from repro_torch.models import nn
from repro_torch.models import transformer as tf
from repro_torch.train import value_and_grad

from _lm import PAIRS, TOL, _cfgs, _close, _np, _params, _tokens

torch.set_num_threads(1)

# ------------------------------------------------------------------ configs
def _same_cfg(jc, pc):
    for f in dataclasses.fields(jc):
        if f.name == "compute_dtype":
            assert str(pc.compute_dtype).split(".")[-1] == jnp.dtype(jc.compute_dtype).name
        elif f.name == "moe":
            assert (jc.moe is None) == (pc.moe is None)
            if jc.moe is not None:
                assert dataclasses.asdict(jc.moe) == dataclasses.asdict(pc.moe)
        else:
            assert getattr(jc, f.name) == getattr(pc, f.name), f.name
    assert jc.n_params == pc.n_params and jc.n_active_params == pc.n_active_params


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
def test_configs_tables_and_specs_match_reference(arch_id):
    jm, pm = PAIRS[arch_id]
    _same_cfg(jm.FULL, pm.FULL)
    _same_cfg(jm.SMOKE, pm.SMOKE)
    leaves = lambda t: [(s[0], s[-1]) for s in jax.tree.leaves(
        t, is_leaf=lambda v: isinstance(v, tuple) and isinstance(v[0], tuple))]
    assert leaves(T.param_table(jm.FULL)) == [v for _, v in tf._spec_items(
        tf.param_table(pm.FULL))]
    meta = tf.init(None, pm.FULL, device="meta")
    assert nn.count_params(meta) == pm.FULL.n_params
    arch, ref = configs.get(arch_id), rconfigs.get(arch_id)
    assert arch.family == ref.family == "lm"
    assert [(s.name, s.kind, s.dims) for s in arch.shapes] == \
        [(s.name, s.kind, s.dims) for s in jcb.LM_SHAPES]
    assert cb.LM_SMOKE == jcb.LM_SMOKE
    for shape in arch.shapes:
        for reduced in (False, True):
            want = jcb.lm_input_specs(ref.make_config(shape.name, reduced), shape, reduced)
            got = cb.lm_input_specs(arch.make_config(shape.name, reduced), shape, reduced)
            flat = lambda t: {k: (flat(v) if isinstance(v, dict) else tuple(v[0]))
                              for k, v in t.items()}
            jflat = lambda t: {k: (jflat(v) if isinstance(v, dict) else tuple(v.shape))
                               for k, v in t.items()}
            assert flat(got) == jflat(want)


def test_registry_holds_the_lm_family_in_the_reference_order():
    assert configs.ASSIGNED == rconfigs.ASSIGNED
    assert configs.all_cells() == rconfigs.all_cells()
    assert configs.NOT_PORTED == ()
    assert sorted(a for a in configs.ASSIGNED if configs.get(a).family == "lm") == sorted(PAIRS)


# --------------------------------------------------------- small pieces
def test_rope_and_rmsnorm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(9), (2, 1)).astype(np.int32) + 5
    for theta in (10_000.0, 500.0):
        _close(tf._rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               T._rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-6)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _close(tf._rope(torch.from_numpy(_np(xb)).bfloat16(), torch.from_numpy(pos), 1e4),
           T._rope(xb, jnp.asarray(pos), 1e4), 2**-7)
    scale = rng.standard_normal(16).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = nn.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(_np(jnp.asarray(x).astype(jdt))).to(dt))
        want = RN.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x).astype(jdt))
        assert got.dtype == dt
        _close(got, want, 1e-6 if dt == torch.float32 else 2**-8)


def _naive_attention(q, k, v, causal):
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    b, sq, h, dh = q.shape
    g = h // k.shape[2]
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    s = np.einsum("bqhd,bshd->bhqs", q, k) / np.sqrt(dh)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(k.shape[1])[None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqs,bshd->bqhd", p, v)


@pytest.mark.parametrize("seq", [16, 24, 64])       # q_chunk 16: divides, does not, four blocks
@pytest.mark.parametrize("causal", [True, False])
def test_attend_matches_naive_and_reference(seq, causal):
    jcfg, pcfg = _cfgs("yi-34b", "f32", remat=False)
    rng = np.random.default_rng(seq)
    q = rng.standard_normal((2, seq, 8, 8)).astype(np.float32)
    k = rng.standard_normal((2, seq, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, seq, 2, 8)).astype(np.float32)
    pos = np.tile(np.arange(seq), (2, 1)).astype(np.int32)
    got = tf._attend(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), pcfg, causal)
    want = T._attend_impl(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), cfg=jcfg, mesh=None,
                          causal=causal)
    _close(got, want, 1e-5, "reference")
    _close(got, _naive_attention(q, k, v, causal), 1e-6, "naive")


# ------------------------------------------------- the model against the reference
@pytest.mark.parametrize("arch_id", sorted(PAIRS))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_forward_loss_and_gradients_match_reference(arch_id, precision):
    jcfg, pcfg = _cfgs(arch_id, precision)
    params, tp = _params(jcfg, pcfg, 1)
    b, s = cb.LM_SMOKE["batch"], cb.LM_SMOKE["seq"]
    toks = _tokens(1, b, s + 1, jcfg.vocab)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    vtol, gtol = TOL[precision]
    # one compile of the reference for the hidden states, the loss and its gradients
    (jl, jg), (jx, jaux) = jax.jit(
        lambda p, bb: (jax.value_and_grad(T.loss_fn)(p, bb, jcfg),
                       T.forward(p, bb["tokens"], jcfg)))(jax.tree.map(jnp.asarray, params), jb)
    with torch.no_grad():
        tx, taux = tf.forward(tp, tb["tokens"], pcfg)
    assert tx.dtype == pcfg.compute_dtype
    _close(tx, jx, vtol, "hidden")
    assert float(taux) == pytest.approx(float(jaux), rel=vtol, abs=1e-6)
    tl, tg = value_and_grad(lambda p, bb: tf.loss_fn(p, bb, pcfg), tp, tb)
    assert float(tl) == pytest.approx(float(jl), rel=vtol)
    want = dict(zip([n for n, _ in flatten(tg)], jax.tree.leaves(jg)))
    for name, g in flatten(tg):
        assert g.dtype == torch.float32
        _close(g, want[name], gtol, name)


def test_remat_and_scan_groups_give_equal_losses_and_gradients():
    _, base = _cfgs("deepseek-moe-16b", "f32", n_layers=4)
    jcfg, _ = _cfgs("deepseek-moe-16b", "f32", n_layers=4)
    _, tp = _params(jcfg, base, 5)
    toks = torch.from_numpy(_tokens(5, 2, 33, base.vocab))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat, groups in ((True, 1), (False, 1), (True, 2), (False, 2), (True, 3)):
        cfg = dataclasses.replace(base, remat=remat, scan_groups=groups)
        out[(remat, groups)] = value_and_grad(lambda p, b: tf.loss_fn(p, b, cfg), tp, batch)
    l0, g0 = out[(False, 1)]
    for key, (loss, g) in out.items():
        assert torch.equal(loss, l0), key
        for (name, a), (_, b) in zip(flatten(g), flatten(g0)):
            assert torch.equal(a, b), (key, name)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])   # SMOKE's; one that drops tokens
@pytest.mark.parametrize("impl", ["dropping", "dense"])
def test_moe_ffn_matches_reference_with_the_same_routing(capacity_factor, impl):
    jcfg, pcfg = _cfgs("deepseek-moe-16b", "f32")
    moe_j = dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor, impl=impl)
    moe_p = dataclasses.replace(pcfg.moe, capacity_factor=capacity_factor, impl=impl)
    jcfg, pcfg = dataclasses.replace(jcfg, moe=moe_j), dataclasses.replace(pcfg, moe=moe_p)
    params, tp = _params(jcfg, pcfg, 6)
    lp_j = jax.tree.map(lambda w: jnp.asarray(w)[0], params["layers"])
    lp_t = {k: w[0] for k, w in tp["layers"].items()}
    y = np.random.default_rng(6).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    # routing: the same top-k experts and weights
    probs, top_p, top_e = tf._route(torch.from_numpy(y.reshape(64, -1)), lp_t["router"],
                                    moe_p.top_k)
    jp = jax.nn.softmax(jnp.asarray(y.reshape(64, -1)) @ lp_j["router"], axis=-1)
    jtop_p, jtop_e = jax.lax.top_k(jp, moe_j.top_k)
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    _close(probs, jp, 1e-6)
    if impl == "dropping":
        t, k, e = 64, moe_p.top_k, moe_p.n_experts
        cap = -(-max(int(-(-t * k // e) * capacity_factor), k) // 8) * 8
        per_expert = np.bincount(top_e.numpy().reshape(-1), minlength=e)
        assert (per_expert > cap).any() == (capacity_factor < 1)     # tokens dropped
    got, aux = tf._moe_ffn(lp_t, torch.from_numpy(y), pcfg)
    want, jaux = T._moe_ffn(lp_j, jnp.asarray(y), jcfg, None)
    _close(got, want, 1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


# ----------------------------------------------- the reference's own properties
def test_prefill_then_decode_matches_forward():
    cfg = tf.TransformerConfig(name="t", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                               d_ff=96, vocab=128, d_head=12, q_chunk=8, ce_chunk=8,
                               remat=False, compute_dtype=torch.float32)
    params = tf.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, 128, (2, 17), generator=torch.Generator().manual_seed(1))
    cache = tf.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    _, cache = tf.prefill(params, toks[:, :16], cache, cfg)
    dec, _ = tf.decode_step(params, toks[:, 16], cache, cfg)
    x, _ = tf.forward(params, toks, cfg)
    ref = nn.rmsnorm({"scale": params["ln_f"]}, x[:, -1:]) @ params["head"]["w"]
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=5e-3, atol=5e-4)


def test_moe_dropping_matches_dense_generous_capacity():
    moe_kw = dict(n_experts=4, top_k=2, n_shared=1, d_ff=32, capacity_factor=4.0)
    mk = lambda impl: tf.TransformerConfig(
        name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
        d_head=16, q_chunk=16, ce_chunk=16, compute_dtype=torch.float32,
        moe=tf.MoEConfig(impl=impl, **moe_kw))
    params = tf.init(torch.Generator().manual_seed(2), mk("dense"), "cpu")
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, 128, (2, 32), generator=gen),
             "labels": torch.randint(0, 128, (2, 32), generator=gen)}
    with torch.no_grad():
        l_dense = tf.loss_fn(params, batch, mk("dense"))
        l_drop = tf.loss_fn(params, batch, mk("dropping"))
    np.testing.assert_allclose(float(l_dense), float(l_drop), rtol=1e-4)


def test_token_batch_is_a_shifted_zipf_stream():
    out = token_batch(torch.Generator().manual_seed(0), 4, 256, 1000, device="cpu")
    assert out["tokens"].shape == out["labels"].shape == (4, 256)
    assert out["tokens"].dtype == torch.int32
    assert torch.equal(out["tokens"][:, 1:], out["labels"][:, :-1])
    t = out["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) <= 999
    assert float((t < 125).float().mean()) > 0.45     # P(u^3 < 1/8) = 1/2


def test_param_round_trip_init_helpers_and_shape_check():
    jcfg, pcfg = _cfgs("deepseek-moe-16b", "f32")
    params, tp = _params(jcfg, pcfg, 9)
    back = convert.transformer_params_from_numpy(convert.transformer_params_to_numpy(tp),
                                                 pcfg, "cpu")
    for (na, a), (nb, b) in zip(flatten(tp), flatten(back)):
        assert na == nb and torch.equal(a, b)
    bf = {k: (v.bfloat16() if k == "wq" else v) for k, v in tp["layers"].items()}
    low = convert.transformer_params_to_numpy(dict(tp, layers=bf))
    assert low["layers"]["wq"].dtype.kind == "V"            # bf16 crosses as its bits
    assert torch.equal(convert.transformer_params_from_numpy(low, pcfg, "cpu")["layers"]["wq"],
                       bf["wq"])
    params["layers"]["wq"] = params["layers"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        convert.transformer_params_from_numpy(params, pcfg, "cpu")
    assert nn.rmsnorm_init(5, "cpu")["scale"].tolist() == [1.0] * 5
    t = nn.embedding_init(torch.Generator().manual_seed(0), 50, 4, "cpu")["table"]
    assert t.shape == (50, 4) and float(t.std()) == pytest.approx(0.02, rel=0.3)
