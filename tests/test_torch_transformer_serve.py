"""Port parity: the transformer LM family's serving steps (``prefill``,
``decode_step``, with the cache written in place) and the bound LM train
steps (``launch.steps.bind``) against the reference (JAX, CPU).

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
  * a bound train step: see its docstring.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import transformer as T
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import base as cb
from repro_torch.launch import steps
from repro_torch.models import transformer as tf

from _lm import PAIRS, TOL, _cfgs, _close, _np, _params, _tokens

torch.set_num_threads(1)


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(arch_id, precision):
    jcfg, pcfg = _cfgs(arch_id, precision)
    params, tp = _params(jcfg, pcfg, 2)
    b, s, cache_len = cb.LM_SMOKE["batch"], cb.LM_SMOKE["seq"], cb.LM_SMOKE["cache"]
    toks = _tokens(2, b, s, jcfg.vocab)
    vtol, _ = TOL[precision]
    jlog, jcache = jax.jit(T.prefill, static_argnums=3)(params, jnp.asarray(toks),
                                                        T.init_cache(jcfg, b, cache_len), jcfg)
    tlog, tcache = tf.prefill(tp, torch.from_numpy(toks), tf.init_cache(pcfg, b, cache_len,
                                                                          device="cpu"), pcfg)
    assert tlog.shape == (b, 1, pcfg.vocab) and tlog.dtype == torch.float32
    _close(tlog, jlog, vtol, "prefill logits")
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], vtol, f"prefill cache {name}")
    assert torch.equal(tcache["pos"], torch.full((b,), s, dtype=torch.int32))
    # decode against a half-full random cache, then once more at the cache's end
    rng = np.random.default_rng(3)
    shape = (jcfg.n_layers, b, cache_len, jcfg.n_kv_heads, jcfg.d_head)
    ck, cv = (jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.02).astype(
        jcfg.compute_dtype) for _ in range(2))
    j_decode = jax.jit(T.decode_step, static_argnums=3)
    for pos in (cache_len // 2, cache_len):
        tok = _tokens(4 + pos, b, 1, jcfg.vocab)[:, 0]
        jc = {"k": ck, "v": cv, "pos": jnp.full((b,), pos, jnp.int32)}
        tc = {"k": torch.from_numpy(_np(ck)).to(pcfg.compute_dtype),
              "v": torch.from_numpy(_np(cv)).to(pcfg.compute_dtype),
              "pos": torch.full((b,), pos, dtype=torch.int32)}
        jlog, jout = j_decode(params, jnp.asarray(tok), jc, jcfg)
        k_before = tc["k"]
        tlog, tout = tf.decode_step(tp, torch.from_numpy(tok), tc, pcfg)
        assert tout["k"] is k_before                  # written in place
        _close(tlog, jlog, vtol, f"decode logits at {pos}")
        for name in ("k", "v"):
            _close(tout[name], jout[name], vtol, f"decode cache {name} at {pos}")
        assert torch.equal(tout["pos"], torch.from_numpy(np.asarray(jout["pos"])))


# -------------------------------------------------------------- the bound steps
@pytest.mark.parametrize("arch_id,precision", [("minitron-4b", "bf16"), ("granite-20b", "bf16"),
                                               ("dbrx-132b", "f32")])
def test_lm_train_step_through_bind_matches_reference(arch_id, precision):
    """One bound train step from the reference's init state, the same numpy
    batch: loss, lr, grad norm and every state leaf. The dense configs as
    bound (bf16 layers, f32 master); the MoE one at ``compute_dtype=float32``
    (``bind_with_cfg``): in bf16 a rounding can flip a token's top-k experts
    between the frameworks, which moves its gradients by O(1)."""
    jm, pm = PAIRS[arch_id]
    if precision == "bf16":
        jcfg, pcfg = jm.SMOKE, pm.SMOKE
        rb = rsteps.bind(rconfigs.get(arch_id), "train_4k", reduced=True)
        pb = steps.bind(arch_id, "train_4k", reduced=True, device="cpu")
    else:
        jcfg, pcfg = _cfgs(arch_id, "f32")
        rb = rsteps.bind_with_cfg(rconfigs.get(arch_id), "train_4k", jcfg)
        pb = steps.bind_with_cfg(arch_id, "train_4k", pcfg, device="cpu")
    assert pb.kind == rb.kind == "train"
    rstate = rb.init_fn(jax.random.PRNGKey(7))
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, rstate), pcfg, "cpu")
    assert state.params["layers"]["wq"].dtype == pcfg.compute_dtype
    assert state.opt.master["layers"]["wq"].dtype == torch.float32
    toks = _tokens(8, cb.LM_SMOKE["batch"], cb.LM_SMOKE["seq"] + 1, pcfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rstate, rm = jax.jit(rb.step_fn)(rstate, jax.tree.map(jnp.asarray, batch))
    state, m = pb.step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    vtol, gtol = TOL[precision]
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=vtol)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=gtol)
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    lr = float(rm["lr"])
    pairs = flatten(convert.train_state_to_numpy(state))
    want = jax.tree.leaves(rstate)
    assert len(pairs) == len(want)
    for (name, a), b in zip(pairs, want):
        a = np.asarray(a.view(jnp.bfloat16) if a.dtype.kind == "V" else a, np.float32)
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        if name.startswith(".params") or name.startswith(".opt.master"):
            # Adam's first step moves a weight by lr * (+-1 + decay): a gradient
            # that is rounding noise may flip its sign (2 lr, and the f32
            # rounding of the sum); the bf16 storage adds an ulp (<= 2^-7 |w|)
            low = name.startswith(".params") and precision == "bf16"
            lim = 2.05 * lr + 2**-22 * np.abs(b) + (2**-7 * np.abs(b) if low else 0)
            assert (np.abs(a - b) <= lim + 1e-12).all(), name
        elif name != ".opt.step":
            _close(a, b, gtol, name)
        else:
            assert int(a) == int(b) == 1
