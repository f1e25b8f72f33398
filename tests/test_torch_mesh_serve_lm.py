"""Port parity: the LM serving cells on a mesh of gloo CPU ranks
(``bind(mesh=)`` for ``prefill_32k``, ``decode_32k`` and ``long_500k``:
context-parallel prefill into a (``cache_batch``, ``cache_seq``) cache,
flash-decoding over the split cache, ``cache_seq_flat`` at batch 1, the
vocab leaves kept as blocks) against the reference's mesh result.

The oracle is the reference's ``prefill`` and ``decode_step`` under jit on
a forged 2 x 2 host mesh with ``Auto`` axes (``tests/_mesh_oracle.py``, one
subprocess for every job of this file, running while the port's ranks
run), the params placed by ``param_axes`` and the cache by its cell's
axes. Params are the reference's ``init`` through ``convert``; tokens and
the batch-1 cache are numpy draws from a seed. Everything runs in f32
(``compute_dtype=float32``).

Tolerances: logits within 1e-5 of the largest |logit| of the compared
logits, each rank's cache block within 1e-5 of the block's largest
magnitude (sums in other orders; the cross-shard softmax's max and sum);
the MoE's routing exactly, its output within 1e-5. The dense model's mesh
decode is also held to the port's own single device within 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as T
from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import leaf_axes
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as tf

import _mesh_oracle as oracle
import _mesh_workers as workers

torch.set_num_threads(1)

F32 = {"compute_dtype": "f32"}
MESH = (2, 2)
JOBS = {
    # a cache longer than the prompt: its cache_seq blocks of 24 do not
    # line up with the prompt's seq blocks of 16
    "minitron_longer_cache": dict(arch="minitron-4b", prompt=(4, 32), cache_len=48, steps=3),
    # batch 1: the cache's 64 positions over the whole grid, 16 a rank;
    # pos 62, so the third step writes at the clamp
    "minitron_flat": dict(arch="minitron-4b", flat=(64, 62), steps=3),
    # 64 tokens a shard: the shard-mapped MoE in prefill (through the bound
    # step: a cache of the prompt's length); decode at batch 8 in 2 groups
    "deepseek_sm": dict(arch="deepseek-moe-16b", prompt=(8, 32), bound=True, steps=2,
                        moe=True),
    # 16 tokens a shard: the grouped MoE in prefill (4 groups)
    "deepseek_grouped": dict(arch="deepseek-moe-16b", prompt=(2, 32), cache_len=40, steps=2),
}
TOL = 1e-5


def _cfgs(arch_id):
    jcfg = oracle._cfg(rconfigs.get(arch_id), "prefill_32k", F32)
    pcfg = dataclasses.replace(configs.get(arch_id).make_config("prefill_32k", True),
                               compute_dtype=torch.float32)
    return jcfg, pcfg


def _inputs(name, job, seed):
    """The job's numpy inputs: params, prompt or batch-1 cache, decode
    tokens and the MoE's activations."""
    jcfg, pcfg = _cfgs(job["arch"])
    params = jax.tree.map(np.asarray, T.init(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(100 + seed)
    out = {"params": params}
    if "prompt" in job:
        b, s = job["prompt"]
        out["prompt"] = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
        out["cache_len"] = job.get("cache_len", s)
    else:
        b = 1
        n, pos = job["flat"]
        shape = (jcfg.n_layers, 1, n, jcfg.n_kv_heads, jcfg.d_head)
        out["k"], out["v"] = (rng.standard_normal(shape).astype(np.float32) * 0.02
                              for _ in range(2))
        out["pos"] = np.full((1,), pos, np.int32)
    out["decode"] = [rng.integers(0, jcfg.vocab, (b,)).astype(np.int32)
                     for _ in range(job["steps"])]
    if job.get("moe"):
        out["moe"] = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the oracle's results, every rank's results, the inputs) by job."""
    tmp = tmp_path_factory.mktemp("mesh_serve_lm")
    inputs, o_jobs, p_jobs = {}, [], {}
    for i, (name, job) in enumerate(JOBS.items()):
        x = inputs[name] = _inputs(name, job, i)
        serve = {"kind": "lm", "decode": x["decode"]}
        serve.update({k: x[k] for k in ("prompt", "cache_len", "k", "v", "pos", "moe") if k in x})
        o_jobs.append(dict(arch=job["arch"], shape="prefill_32k", cfg=F32, mesh=MESH,
                           params=x["params"], serve=serve))
        pcfg = _cfgs(job["arch"])[1]
        pj = dict(family="lm", arch=job["arch"], cfg=pcfg, mesh=MESH, bound=job.get("bound"),
                  params=convert.transformer_params_from_numpy(x["params"], pcfg, "cpu"),
                  decode=[torch.from_numpy(t) for t in x["decode"]])
        if "prompt" in x:
            pj.update(prompt=torch.from_numpy(x["prompt"]), cache_len=x["cache_len"])
        else:
            pj["cache"] = {k: torch.from_numpy(x[k]) for k in ("k", "v", "pos")}
        if "moe" in x:
            pj["moe"] = torch.from_numpy(x["moe"])
        p_jobs[name] = pj
    wait = oracle.start(o_jobs, str(tmp))
    M.spawn(workers.serve_jobs, MESH[0] * MESH[1], (p_jobs, str(tmp)), backend="gloo")
    ranks = {}
    for r in range(MESH[0] * MESH[1]):
        for name, res in torch.load(tmp / f"rank{r}.pt", weights_only=False).items():
            ranks.setdefault(name, {})[r] = res
    return dict(zip(JOBS, wait())), ranks, p_jobs


def _close(got, want, what):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    lim = TOL * float(np.abs(w).max()) + 1e-30
    err = float(np.abs(g - w).max())
    assert err <= lim, (what, err, lim)


def _mesh(rank):
    return M.Mesh(("data", "model"), dict(zip(("data", "model"), MESH)), "gloo",
                  torch.device("cpu"), rank, {})


def _blocks_match(ranks, want, flat, what):
    """Every rank's cache block against its slice of the reference's whole
    cache."""
    axes = tf.cache_axes(flat)
    for r, res in ranks.items():
        cache = res[what] if what == "cache" else res["prefill"]
        for name in ("k", "v"):
            block = sh.local_block(torch.from_numpy(want[name]), _mesh(r), axes[name])
            _close(cache[name], block, f"rank {r} {what} {name}")
        np.testing.assert_array_equal(
            cache["pos"].numpy(),
            sh.local_block(torch.from_numpy(want["pos"]), _mesh(r), axes["pos"]).numpy())


PREFILL = [n for n in JOBS if "prompt" in JOBS[n]]


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_matches_the_reference_mesh(runs, name):
    ref, ranks, _ = runs
    for r, res in ranks[name].items():
        _close(res["prefill"]["logits"], ref[name]["prefill"]["logits"], f"rank {r} logits")
    _blocks_match(ranks[name], ref[name]["prefill"], False, "prefill")


@pytest.mark.parametrize("name", list(JOBS))
def test_decode_matches_the_reference_mesh(runs, name):
    ref, ranks, _ = runs
    for r, res in ranks[name].items():
        assert len(res["decode"]) == JOBS[name]["steps"]
        for i, (got, want) in enumerate(zip(res["decode"], ref[name]["decode"])):
            _close(got, want, f"rank {r} decode step {i}")
    _blocks_match(ranks[name], ref[name]["cache"], "flat" in JOBS[name], "cache")


@pytest.mark.parametrize("name", ["minitron_longer_cache", "minitron_flat"])
def test_dense_mesh_decode_matches_one_device(runs, name):
    """The dense model has no mesh-dependent routing: its mesh steps are
    the port's single device's."""
    _, ranks, p_jobs = runs
    job = p_jobs[name]
    cfg, params = job["cfg"], job["params"]
    with torch.no_grad():
        if "prompt" in job:
            b = job["prompt"].shape[0]
            cache = tf.init_cache(cfg, b, job["cache_len"], device="cpu")
            logits, cache = tf.prefill(params, job["prompt"], cache, cfg)
            _close(ranks[name][0]["prefill"]["logits"], logits, "prefill logits")
        else:
            cache = {k: v.clone() for k, v in job["cache"].items()}
        for i, tok in enumerate(job["decode"]):
            logits, cache = tf.decode_step(params, tok, cache, cfg)
            _close(ranks[name][0]["decode"][i], logits, f"decode step {i}")


def test_decode_moe_groups_match_the_reference_mesh(runs):
    """Layer 0's MoE as the decode runs it at batch 8 on 2 x 2: the
    reference's two dispatch groups (``_moe_groups``), each with its own
    capacity; the routing exactly."""
    ref, ranks, _ = runs
    assert tf._moe_groups(8, tf._par(configs.get("deepseek-moe-16b").make_config(
        "prefill_32k", True), _mesh(0), None)) == 2
    for r, res in ranks["deepseek_sm"].items():
        _close(res["moe"]["y"], ref["deepseek_sm"]["moe"]["y"], f"rank {r} moe y")
        np.testing.assert_array_equal(res["moe"]["top_e"].reshape(-1, 2).numpy(),
                                      ref["deepseek_sm"]["moe"]["top_e"])


def test_no_rank_holds_the_whole_cache_or_vocab_leaves(runs):
    """Each rank holds exactly its blocks of the params (the vocab leaves a
    half: ``vocab``@model; the layers a quarter) and of the cache (a
    quarter under ``cache_seq`` at 2 x 2 and under ``cache_seq_flat``), and
    the serving steps' collectives are counted (prefill's embedding
    reduce-scatter, the decode softmax's pmax and psums)."""
    _, ranks, p_jobs = runs
    for name, job in p_jobs.items():
        flat = "cache" in job
        params = job["params"]
        whole = sum(t.numel() * t.element_size() for _, t in flatten(params))
        want = sum(int(np.prod(sh.block_shape(t.shape, _mesh(0), ax))) * t.element_size()
                   for (_, t), ax in zip(flatten(params), leaf_axes(tf.param_axes(job["cfg"]),
                                                                    params)))
        table = params["embed"]["table"]
        for r, res in ranks[name].items():
            assert res["param_bytes"] == want < whole, (name, r)
            k = res["cache"]["k"]
            n_cache = k.shape[2] * 4 if flat else k.shape[2] * 2
            assert k.shape[1] == (1 if flat else job["prompt"].shape[0] // 2)
            assert n_cache == (job["cache"]["k"].shape[2] if flat else job["cache_len"])
            assert res["cache_bytes"] == 2 * k.numel() * k.element_size() + \
                res["cache"]["pos"].numel() * 4
            stats = res["stats"]
            assert stats["pmax"]["calls"] > 0 and stats["psum"]["calls"] > 0, (name, r)
            if not flat:
                assert stats["reduce_scatter"]["calls"] > 0, (name, r)
        half = table.numel() * table.element_size() // 2
        assert want < whole - half, name       # the vocab leaves stay blocks
