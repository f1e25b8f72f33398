"""Port parity: DimeNet (``repro_torch.models.dimenet``), its config, the GNN
glue of ``configs.base`` and ``bind``'s four ``dimenet`` train cells,
against the reference (JAX, CPU).

Weights come from the reference's ``init`` through ``convert``; graphs are
numpy draws from a seed (distinct directed edges, every triplet (k -> j,
j -> i) enumerated, k == i included, as the reference's test). Tolerances:
  * the bases within 1e-6 of their largest magnitude;
  * ``forward`` at ``compute_dtype=float32``: rtol 1e-4, atol 1e-5 (f32
    sums in other orders: XLA's dot against torch's, the factorized
    contractions written as reductions);
  * ``forward`` at bf16: within 2e-2 of the largest output beyond the
    reference's own bf16 error against its f32 output. Both packages round
    each bf16 op, but not at the same places (XLA keeps some products in
    f32 where a convert pair cancels; torch's ``silu`` rounds once), and a
    rounding flip is carried through every block and the node sums: over
    six seeds the reference's bf16 output was up to 2.6e-2 of the largest
    output from its f32 one, and the port's from the reference's up to
    2.4e-2;
  * ``loss_fn`` in f32 within 1e-5 relative, every gradient leaf within
    1e-4 of that leaf's largest magnitude;
  * one bound train step (bf16, as bound): loss and grad norm within 2e-2
    relative, every weight within 2.05 lr of the reference's (Adam's first
    step moves a weight by +-lr; a gradient that is rounding noise may flip
    its sign), the moments m within 6e-2 and v within 1.2e-1 of their
    leaf's largest (v is the square: twice the relative error).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rcb
from repro.configs import dimenet as j_dimenet
from repro.launch import steps as rsteps
from repro.models import dimenet as J
from repro.train import step as rtstep
from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import base as cb
from repro_torch.configs import dimenet as p_dimenet
from repro_torch.launch import steps
from repro_torch.models import dimenet as dm
from repro_torch.train import value_and_grad

torch.set_num_threads(1)

SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
KW = dict(n_blocks=3, d_hidden=24, n_bilinear=4, n_spherical=6, n_radial=4, d_feat=8)
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(impl, task="graph_reg", precision="f32", **kw):
    jdt, pdt = _DT[precision]
    n_out = 1 if task == "graph_reg" else 3
    kw = {**KW, "n_out": n_out, "task": task, "triplet_impl": impl, **kw}
    return J.DimeNetConfig(compute_dtype=jdt, **kw), dm.DimeNetConfig(compute_dtype=pdt, **kw)


def _graph(seed, n_graphs=2, n=16, e=48, d_feat=8, chunks=1):
    """``n_graphs`` graphs of ``e`` distinct directed edges over ``n`` nodes
    side by side (no self loop, no repeated edge, so each edge has at most
    one reverse), with every triplet (k -> j, j -> i) enumerated (k == i
    included) and each edge's reverse id (-1 where the reverse edge does not
    exist). With ``chunks`` the edge arrays come pre-chunked (chunks, E /
    chunks)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for g in range(n_graphs):
        pick = rng.choice(n * (n - 1), e, replace=False)
        s = pick // (n - 1)
        src.append(s + g * n)
        dst.append((s + 1 + pick % (n - 1)) % n + g * n)
    src, dst = np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)
    n_e = src.shape[0]
    tk, tj = np.nonzero(dst[:, None] == src[None, :])      # (kj, ji): j shared
    key = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(src, dst))}
    rev = np.asarray([key.get((int(b), int(a)), -1) for a, b in zip(src, dst)], np.int32)
    ch = lambda a: a.reshape(chunks, n_e // chunks) if chunks > 1 else a
    nn_ = n_graphs * n
    return dict(
        node_feat=rng.standard_normal((nn_, d_feat)).astype(np.float32),
        pos=(rng.standard_normal((nn_, 3)) * 2).astype(np.float32),
        edge_src=ch(src), edge_dst=ch(dst), edge_mask=ch(np.ones(n_e, np.float32)),
        edge_reverse=ch(rev),
        triplet_kj=tk.astype(np.int32), triplet_ji=tj.astype(np.int32),
        triplet_mask=np.ones(tk.shape[0], np.float32),
        graph_ids=np.repeat(np.arange(n_graphs), n).astype(np.int32),
        labels=rng.standard_normal(n_graphs).astype(np.float32),
        node_mask=np.ones(nn_, np.float32),
        label_mask=(rng.random(nn_) < 0.8).astype(np.float32))


def _node_labels(batch, seed):
    out = dict(batch)
    out["labels"] = np.random.default_rng(seed).integers(0, 3, batch["node_feat"].shape[0]) \
        .astype(np.int32)
    return out


_forward = jax.jit(J.forward, static_argnums=2)
_loss_and_grad = jax.jit(jax.value_and_grad(J.loss_fn), static_argnums=2)


def _params(jcfg, pcfg, seed):
    params = jax.tree.map(np.asarray, J.init(jax.random.PRNGKey(seed), jcfg)[0])
    return params, convert.dimenet_params_from_numpy(params, pcfg, "cpu")


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ bases
def test_bases_match_reference():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((200, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    d = np.concatenate([rng.random(200) * 7, [0.0, 1e-7, 5.0, 5.0001]]).astype(np.float32)
    cos_t = np.clip(rng.standard_normal(200), -1, 1).astype(np.float32)

    def close(got, want):
        got, want = _f32(got), np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-6 * max(1.0, float(np.abs(want).max()))

    for p_max in (4, 7):
        close(dm.monomial_features(torch.from_numpy(u), p_max),
              jax.jit(J.monomial_features, static_argnums=1)(jnp.asarray(u), p_max))
        assert dm._monomial_block_slices(p_max) == J._monomial_block_slices(p_max)
        np.testing.assert_array_equal(dm._legendre_coeffs(p_max), J._legendre_coeffs(p_max))
        close(dm.legendre_angular(torch.from_numpy(cos_t), p_max),
              jax.jit(J.legendre_angular, static_argnums=1)(jnp.asarray(cos_t), p_max))
    for n_radial, cutoff in ((6, 5.0), (3, 5.0), (6, 3.0)):
        close(dm.bessel_rbf(torch.from_numpy(d), n_radial, cutoff),
              jax.jit(J.bessel_rbf, static_argnums=(1, 2))(jnp.asarray(d), n_radial, cutoff))


# ---------------------------------------------------------------- configs
def _same_cfg(jc, pc):
    for f in dataclasses.fields(jc):
        if f.name == "compute_dtype":
            assert str(pc.compute_dtype).split(".")[-1] == jnp.dtype(jc.compute_dtype).name
        else:
            assert getattr(jc, f.name) == getattr(pc, f.name), f.name


def test_configs_shapes_and_registry_match_reference():
    _same_cfg(j_dimenet.FULL, p_dimenet.FULL)
    _same_cfg(j_dimenet.SMOKE, p_dimenet.SMOKE)
    arch, ref = configs.get("dimenet"), rconfigs.get("dimenet")
    assert arch.family == ref.family == "gnn"
    assert [(s.name, s.kind, s.dims) for s in arch.shapes] == \
        [(s.name, s.kind, s.dims) for s in rcb.GNN_SHAPES]
    assert (cb.GNN_SMOKE_NODE_SCALE, cb.GNN_SMOKE_EDGE_SCALE) == \
        (rcb.GNN_SMOKE_NODE_SCALE, rcb.GNN_SMOKE_EDGE_SCALE)
    for shape in [None] + SHAPES:
        for reduced in (False, True):
            _same_cfg(ref.make_config(shape, reduced), arch.make_config(shape, reduced))
    assert dm.param_table(p_dimenet.FULL)["blocks"]["w_sbf"][0] == (6, 42, 8)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_gnn_input_specs_match_reference(shape, reduced):
    ref, arch = rconfigs.get("dimenet"), configs.get("dimenet")
    want = rcb.gnn_input_specs(ref.make_config(shape, reduced), ref.shape(shape), reduced)
    got = cb.gnn_input_specs(arch.make_config(shape, reduced), arch.shape(shape), reduced)
    dt = {jnp.float32: torch.float32, jnp.int32: torch.int32}
    assert got == {k: (tuple(v.shape), dt[v.dtype.type]) for k, v in want.items()}
    bound = steps.bind("dimenet", shape, reduced=reduced, device="cpu")
    assert bound.kind == "train" and bound.input_specs == got
    assert cb.pad_to(10556) == rcb.pad_to(10556) == 12288


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("case", ["gather", "factorized", "factorized-rev"])
@pytest.mark.parametrize("task", ["graph_reg", "node_class"])
def test_forward_matches_reference_f32(case, task):
    impl = case.split("-")[0]
    jc, pc = _cfgs(impl, task)
    params, tp = _params(jc, pc, 1)
    batch = _graph(2, chunks=2 if impl == "factorized" else 1)
    if "rev" not in case:
        del batch["edge_reverse"]
    if task == "node_class":
        batch = _node_labels(batch, 3)
    want = _f32(_forward(params, _jax(batch), jc))
    got = dm.forward(tp, _torch(batch), pc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["gather", "factorized", "factorized-rev"])
@pytest.mark.parametrize("task", ["graph_reg", "node_class"])
def test_forward_matches_reference_bf16(case, task):
    impl = case.split("-")[0]
    batch = _graph(4, chunks=2 if impl == "factorized" else 1)
    if "rev" not in case:
        del batch["edge_reverse"]
    if task == "node_class":
        batch = _node_labels(batch, 5)
    jc, pc = _cfgs(impl, task, "bf16")
    jc32 = dataclasses.replace(jc, compute_dtype=jnp.float32)
    params, tp = _params(jc, pc, 2)
    want = _f32(_forward(params, _jax(batch), jc))
    want32 = _f32(_forward(params, _jax(batch), jc32))
    got = _f32(dm.forward(tp, _torch(batch), pc))
    top = float(np.abs(want).max())
    ref_noise = float(np.abs(want - want32).max())
    assert float(np.abs(got - want).max()) <= 2e-2 * top + ref_noise


@pytest.mark.parametrize("impl", ["gather", "factorized"])
@pytest.mark.parametrize("task", ["graph_reg", "node_class"])
def test_loss_and_gradients_match_reference(impl, task):
    jc, pc = _cfgs(impl, task)
    params, tp = _params(jc, pc, 3)
    batch = _graph(6, chunks=2 if impl == "factorized" else 1)
    if task == "node_class":
        batch = _node_labels(batch, 7)
    jl, jg = _loss_and_grad(params, _jax(batch), jc)
    tl, tg = value_and_grad(lambda p, b: dm.loss_fn(p, b, pc), tp, _torch(batch))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    pairs, want = flatten(tg), jax.tree.leaves(jg)
    assert len(pairs) == len(want) == 11
    for (name, g), w in zip(pairs, want):
        w = np.asarray(w)
        assert float(np.abs(_f32(g) - w).max()) <= 1e-4 * float(np.abs(w).max()), name


def test_graph_reg_without_node_mask_and_node_class_without_label_mask():
    for task in ("graph_reg", "node_class"):
        jc, pc = _cfgs("gather", task)
        params, tp = _params(jc, pc, 4)
        batch = _graph(8)
        del batch["node_mask" if task == "graph_reg" else "label_mask"]
        if task == "node_class":
            batch = _node_labels(batch, 9)
        want = float(_loss_and_grad(params, _jax(batch), jc)[0])
        assert float(dm.loss_fn(tp, _torch(batch), pc)) == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------- the port's own paths
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_factorized_equals_gather(seed):
    """The monomial factorization is exact (the reference's
    ``test_dimenet_factorized_equals_gather`` on the port): same params, same
    graph, triplets enumerated with k == i included."""
    _, pg = _cfgs("gather")
    pf = dataclasses.replace(pg, triplet_impl="factorized")
    params = dm.init(torch.Generator().manual_seed(seed), pg, "cpu")
    batch = _torch(_graph(seed, n_graphs=1))
    del batch["edge_reverse"]
    np.testing.assert_allclose(_f32(dm.forward(params, batch, pg)),
                               _f32(dm.forward(params, batch, pf)), rtol=5e-4, atol=5e-5)


def test_edge_reverse_drops_exactly_the_backtracking_triplets():
    """Factorized with ``edge_reverse`` equals gather over the triplets
    with k != i."""
    _, pg = _cfgs("gather", "node_class")
    pf = dataclasses.replace(pg, triplet_impl="factorized")
    params = dm.init(torch.Generator().manual_seed(5), pg, "cpu")
    batch = _node_labels(_graph(10, chunks=3), 1)
    src = batch["edge_src"].reshape(-1)
    dst = batch["edge_dst"].reshape(-1)
    flat = {k: (v.reshape(-1) if k.startswith("edge_") else v) for k, v in batch.items()}
    keep = src[flat["triplet_kj"]] != dst[flat["triplet_ji"]]
    flat["triplet_mask"] = keep.astype(np.float32)
    got = _f32(dm.forward(params, _torch(batch), pf))
    want = _f32(dm.forward(params, _torch(flat), pg))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


def test_chunking_and_remat_change_no_value():
    """The factorized path's edges in 1 or 4 chunks, with and without remat.
    The loss is the same bit for bit on the CPU (the contractions are per
    edge; pass A adds the chunks in edge order); remat changes no gradient
    bit; chunking regroups the weight gradients' sums over edges (one sum
    a chunk), so they agree within 1e-5 of the leaf's largest."""
    _, pc = _cfgs("factorized", "node_class")
    params = dm.init(torch.Generator().manual_seed(6), pc, "cpu")
    base = _node_labels(_graph(11, chunks=1), 2)
    runs = []
    for chunks, remat in ((1, True), (4, True), (4, False)):
        b = {k: (v.reshape(chunks, -1) if k.startswith("edge_") else v) for k, v in base.items()}
        cfg = dataclasses.replace(pc, remat=remat, edge_chunks=chunks)
        runs.append(value_and_grad(lambda p, bb: dm.loss_fn(p, bb, cfg), params, _torch(b)))
    assert torch.equal(runs[1][0], runs[0][0]) and torch.equal(runs[2][0], runs[0][0])
    for (name, a), (_, b), (_, c) in zip(*(flatten(r[1]) for r in runs)):
        assert torch.equal(b, c), name
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), name


def test_init_shapes_scales_and_convert_round_trip():
    cfg = p_dimenet.FULL
    params = dm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    ref = jax.eval_shape(lambda k: J.init(k, j_dimenet.FULL)[0], jax.random.PRNGKey(0))
    assert [(n, tuple(p.shape)) for n, p in flatten(params)] == \
        [(n, a.shape) for (n, _), a in zip(flatten(params), jax.tree.leaves(ref))]
    def scales(t):
        for k in sorted(t):
            yield from scales(t[k]) if isinstance(t[k], dict) else [t[k][1]]

    for (name, p), scale in zip(flatten(params), scales(dm.param_table(cfg))):
        assert float(p.std()) == pytest.approx(scale, rel=0.2), name
    back = convert.dimenet_params_from_numpy(convert.dimenet_params_to_numpy(params), cfg, "cpu")
    for (_, a), (_, b) in zip(flatten(params), flatten(back)):
        assert torch.equal(a, b)
    bad = convert.dimenet_params_to_numpy(params)
    bad["blocks"]["w_sbf"] = bad["blocks"]["w_sbf"][:, :-1]
    with pytest.raises(ValueError, match="w_sbf"):
        convert.dimenet_params_from_numpy(bad, cfg, "cpu")


# ------------------------------------------------------- bound train cells
def _np_smoke_batch(specs, dims, seed, n_nodes=None, n_edges=None):
    """gnn_smoke_batch's distributions drawn with numpy at the specs' shapes
    (``n_nodes`` / ``n_edges`` replace the spec's counts, the chunking kept)."""
    rng = np.random.default_rng(seed)
    n = n_nodes or specs["node_feat"][0][0]
    eshape = specs["edge_src"][0]
    if n_edges:
        eshape = (eshape[0], n_edges // eshape[0]) if len(eshape) == 2 else (n_edges,)
    src = rng.integers(0, n, eshape).astype(np.int32)
    dst = rng.integers(0, n, eshape).astype(np.int32)
    batch = {"node_feat": rng.standard_normal((n, dims["d_feat"])).astype(np.float32),
             "pos": (rng.standard_normal((n, 3)) * 2).astype(np.float32),
             "edge_src": src, "edge_dst": np.where(dst == src, (dst + 1) % n, dst),
             "edge_mask": np.ones(eshape, np.float32)}
    if "graph_ids" in specs:
        ng = specs["labels"][0][0]
        batch["graph_ids"] = np.clip(np.arange(n) * ng // n, 0, ng - 1).astype(np.int32)
        batch["labels"] = rng.standard_normal(ng).astype(np.float32)
        batch["node_mask"] = np.ones(n, np.float32)
    else:
        batch["labels"] = rng.integers(0, dims["n_out"], n).astype(np.int32)
        batch["label_mask"] = np.ones(n, np.float32)
    if "triplet_kj" in specs:
        t, n_e = specs["triplet_kj"][0][0], int(np.prod(eshape))
        batch["triplet_kj"] = rng.integers(0, n_e, t).astype(np.int32)
        batch["triplet_ji"] = rng.integers(0, n_e, t).astype(np.int32)
        batch["triplet_mask"] = np.ones(t, np.float32)
    return batch


@pytest.mark.parametrize("shape", SHAPES)
def test_bound_train_step_matches_reference(shape):
    """One step of ``bind("dimenet", shape, reduced=True)`` (SMOKE, bf16)
    from the reference's own init state, on one numpy batch at the reduced
    specs; ``ogb_products``' batch keeps its 8 edge chunks but has an eighth
    of the reduced nodes and edges (38,266 and 241,648 take 10 s a step on
    one CPU thread; the config, not the batch, is what the cell binds)."""
    jcfg = rconfigs.get("dimenet").make_config(shape, True)
    pb = steps.bind("dimenet", shape, reduced=True, device="cpu")
    _same_cfg(jcfg, pb.cfg)
    # the reference's bind builds its gnn step from these (launch/steps.py:112-122);
    # its param_axes call, an eager init, is left out
    rstep = jax.jit(rtstep.make_train_step(lambda p, b: J.loss_fn(p, b, jcfg), rsteps.OPT_CFG))
    rstate = jax.jit(lambda k: rtstep.init_state(J.init(k, jcfg)[0]))(jax.random.PRNGKey(3))
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, rstate), pb.cfg, "cpu")
    small = {} if shape != "ogb_products" else dict(n_nodes=38266 // 8, n_edges=241648 // 8)
    batch = _np_smoke_batch(pb.input_specs, pb.shape.dims, 4, **small)
    rstate, rm = rstep(rstate, _jax(batch))
    state, m = pb.step_fn(state, _torch(batch))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=2e-2)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=2e-2)
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    lr = float(rm["lr"])
    pairs, want = flatten(convert.train_state_to_numpy(state)), jax.tree.leaves(rstate)
    assert len(pairs) == len(want)
    for (name, a), b in zip(pairs, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        if name.startswith(".params"):
            assert (np.abs(a - b) <= 2.05 * lr + 2**-22 * np.abs(b)).all(), name
        elif name == ".opt.step":
            assert int(a) == int(b) == 1
        else:
            tol = 6e-2 if name.startswith(".opt.m") else 1.2e-1
            assert float(np.abs(a - b).max()) <= tol * float(np.abs(b).max()) + 1e-30, name
