"""The reference's mesh results for the port's mesh tests, computed in a
process of its own on forged host devices.

    python tests/_mesh_oracle.py JOBS.pkl OUT.pkl

``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set before
JAX starts, so the tests run this file as a subprocess (:func:`start`) and
go on with the port's ranks meanwhile. The mesh is built with ``Auto``
axes: jax 0.9's ``jax.make_mesh`` defaults to ``Explicit`` axes, under
which the reference's ``constrain`` raises ("can only refer to Auto
axes"); the reference's own ``launch/mesh.py`` does not ask for ``Auto``.

A job is a dict: ``arch``, ``shape`` (a cell), ``cfg`` (overrides of the
reduced config; ``"compute_dtype"`` as ``"f32"`` or ``"bf16"``), ``mesh``
((data, model) or None), ``seed`` (the params' key), ``batches`` (numpy
dicts, global). It gets back the metrics' ``losses`` and the ``state``
after one step per batch of the bound train step (the reference's
``make_train_step`` over its ``loss_fn``) under jit, with the state placed
by the cell's ``state_axes`` and the batches by its ``batch_axes``, all
leaves flattened by keystr; and the first batch's ``loss`` and ``grads``,
read from the first step: its loss, and AdamW's first moment undone (m =
(1 - b1) g, g clipped by min(1, clip / grad_norm)). ``remat`` is off here:
it changes no value of the reference and costs compile time. One thread:
the port's ranks run beside it. ``moe``: a dict with
``y3`` (B, S, d) runs layer 0's ``_moe_ffn`` on it and returns ``y``,
``aux`` and, where the shard-mapped path runs, its ``top_e``.

A serving job has ``serve`` (and ``params``, the reference's whole
params as numpy, placed by the cell's ``state_axes``; None for a cell
without params) instead of ``batches``. ``serve["kind"]``:
  * ``"step"``: the cell's bound step (``serve``, ``retrieval``) under jit
    on ``serve["batch"]``, placed by its ``batch_axes``; returns ``out``;
  * ``"retrieval"``: ``score_candidates(query, cand, k, mesh, n_valid)``
    with ``cand`` placed on ``candidates``; returns ``out``;
  * ``"lm"``: ``prefill`` of ``serve["prompt"]`` (B, S) into a zero cache
    of ``serve["cache_len"]`` positions placed by ``cache_axes`` (or, with
    no prompt, the cache ``serve["k"]``, ``["v"]``, ``["pos"]`` placed
    ``cache_seq_flat``), then one ``decode_step`` per token vector of
    ``serve["decode"]``; returns the prefill's logits and cache, every
    decode's logits and the last cache (f32). ``serve["moe"]`` (B, 1, d)
    runs layer 0's ``_moe_ffn`` on it as the decode does and returns ``y``
    and the tokens' top-k experts.
"""
import dataclasses
import os
import pickle
import subprocess
import sys


def start(jobs: list, tmp_path) -> "callable":
    """Run the oracle on ``jobs`` in a subprocess; returns a function that
    waits for it and returns its results (a list, one dict per job)."""
    jobs_path, out_path = os.path.join(tmp_path, "jobs.pkl"), os.path.join(tmp_path, "out.pkl")
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, __file__, jobs_path, out_path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the mesh oracle failed:\n{out[-4000:]}")
        with open(out_path, "rb") as f:
            return pickle.load(f)

    return wait


def initial_state(arch_id: str, shape: str, cfg_over: dict, seed: int):
    """The reference's initial train state of a reduced cell as numpy (the
    port converts it)."""
    import jax
    import numpy as np
    from repro import configs as rconfigs
    from repro.launch import steps as rsteps
    arch = rconfigs.get(arch_id)
    cfg = _cfg(arch, shape, cfg_over)
    bound = rsteps.bind(arch, shape, reduced=True, _cfg=cfg)
    state = jax.jit(bound.init_fn)(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, state)


def _cfg(arch, shape, over):
    import jax.numpy as jnp
    over = dict(over)
    if "compute_dtype" in over:
        over["compute_dtype"] = {"f32": jnp.float32, "bf16": jnp.bfloat16}[over["compute_dtype"]]
    cfg = dataclasses.replace(arch.make_config(shape, True), **over)
    return dataclasses.replace(cfg, remat=False) if hasattr(cfg, "remat") else cfg


def _flat(tree):
    import jax
    import numpy as np
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v).astype(np.float32)
            if v.dtype.name in ("bfloat16", "float64") else np.asarray(v) for k, v in leaves}


def _mesh(job, devices):
    import jax
    from jax.sharding import AxisType
    d, m = job["mesh"]
    return jax.make_mesh((d, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=devices[:d * m])


def _serve(job, devices):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import configs as rconfigs
    from repro.distributed import sharding as rsh
    from repro.launch import steps as rsteps
    from repro.models import transformer as T

    arch = rconfigs.get(job["arch"])
    cfg = _cfg(arch, job["shape"], job["cfg"])
    mesh = _mesh(job, devices)
    bound = rsteps.bind(arch, job["shape"], reduced=True, mesh=mesh, _cfg=cfg)
    params = {}
    if job["params"] is not None:
        params = jax.device_put(jax.tree.map(jnp.asarray, job["params"]),
                                rsh.tree_shardings(mesh, bound.state_axes))
    sv = job["serve"]

    def place(a, axes, dtype=None):
        a = jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)
        return jax.device_put(a, rsh.sharding(mesh, *axes))

    if sv["kind"] == "step":
        batch = {k: place(v, bound.batch_axes[k]) for k, v in sv["batch"].items()}
        return {"out": jax.tree.map(np.asarray, jax.jit(bound.step_fn)(params, batch))}
    if sv["kind"] == "retrieval":
        from repro.models import recsys as R
        fn = jax.jit(lambda q, c: R.score_candidates(q, c, sv["k"], mesh, sv["n_valid"]))
        return {"out": jax.tree.map(np.asarray, fn(jnp.asarray(sv["query"]),
                                                   place(sv["cand"], ("candidates", None))))}
    f32 = lambda c: {k: np.asarray(c[k]).astype(np.float32) for k in ("k", "v")} | \
        {"pos": np.asarray(c["pos"])}
    res = {"decode": []}
    if "prompt" in sv:
        cax = T.cache_axes()
        cache = {k: place(v, cax[k]) for k, v in
                 T.init_cache(cfg, sv["prompt"].shape[0], sv["cache_len"]).items()}
        logits, cache = jax.jit(lambda p, t, c: T.prefill(p, t, c, cfg, mesh))(
            params, place(sv["prompt"], ("batch", None)), cache)
        res["prefill"] = {"logits": np.asarray(logits), **f32(cache)}
        tok_axes = ("cache_batch",)
    else:
        ax = ("layers", None, "cache_seq_flat", "kv_heads", "d_head")
        cache = {"k": place(sv["k"], ax, cfg.compute_dtype),
                 "v": place(sv["v"], ax, cfg.compute_dtype), "pos": place(sv["pos"], (None,))}
        tok_axes = (None,)
    step = jax.jit(lambda p, t, c: T.decode_step(p, t, c, cfg, mesh))
    for tok in sv["decode"]:
        logits, cache = step(params, place(tok, tok_axes), cache)
        res["decode"].append(np.asarray(logits))
    res["cache"] = f32(cache)
    if "moe" in sv:
        p0 = jax.tree.map(lambda w: w[0], params["layers"])
        y3 = jnp.asarray(sv["moe"])
        y, _ = jax.jit(lambda p, y3: T._moe_ffn(p, y3, cfg, mesh))(p0, y3)
        probs = jax.nn.softmax(y3.reshape(-1, y3.shape[-1]).astype(jnp.float32)
                               @ p0["router"].astype(jnp.float32), axis=-1)
        res["moe"] = {"y": np.asarray(y),
                      "top_e": np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])}
    return res


def _run(job, devices):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import configs as rconfigs
    from repro.distributed import sharding as rsh
    from repro.launch import steps as rsteps
    from repro.models import dimenet as J
    from repro.models import recsys as R
    from repro.models import transformer as T

    if "serve" in job:
        return _serve(job, devices)
    arch = rconfigs.get(job["arch"])
    cfg = _cfg(arch, job["shape"], job["cfg"])
    mesh = None if job["mesh"] is None else _mesh(job, devices)
    bound = rsteps.bind(arch, job["shape"], reduced=True, mesh=mesh, _cfg=cfg)
    state = bound.init_fn(jax.random.PRNGKey(job["seed"]))
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in job["batches"]]
    if mesh is not None:
        state = jax.device_put(state, rsh.tree_shardings(mesh, bound.state_axes))
        axes = bound.batch_axes
        batches = [{k: jax.device_put(v, rsh.sharding(mesh, *axes.get(k, (None,) * v.ndim)))
                    for k, v in b.items()} for b in batches]
    step = jax.jit(bound.step_fn)
    losses = []
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        if i == 0:
            opt = rsteps.OPT_CFG
            scale = min(1.0, opt.clip_norm / max(float(metrics["grad_norm"]), 1e-9))
            grads = jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - opt.b1) / scale,
                                 state.opt.m)
            out = {"loss": losses[0], "grads": _flat(grads)}
    out["losses"], out["state"] = losses, _flat(state)
    if "moe" in job:
        p = jax.tree.map(lambda w: w[0], bound.init_fn(jax.random.PRNGKey(job["seed"])).params[
            "layers"])
        y3 = jnp.asarray(job["moe"]["y3"])
        y, aux = jax.jit(lambda p, y3: T._moe_ffn(p, y3, cfg, mesh))(p, y3)
        out["moe"] = {"y": np.asarray(y), "aux": float(aux)}
        b, s, _ = y3.shape
        dp, ml = job["mesh"] or (1, 1)
        if mesh is not None and (b // dp) * (s // ml) >= 64:
            _, _, top_e = jax.jit(lambda p, y3: T._moe_shardmapped(p, y3, cfg, mesh))(p, y3)
            out["moe"]["top_e"] = np.asarray(top_e)
    return out


def main(jobs_path, out_path):
    import jax
    jax.config.update("jax_platform_name", "cpu")
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    devices = jax.devices()
    results = [_run(job, devices) for job in jobs]
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    main(sys.argv[1], sys.argv[2])
