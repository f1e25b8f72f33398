"""Port parity: recsys training (the ``fm_interact`` gradient, ``loss_fn``
and its gradients, the bound ``train_batch`` step, ``python -m
repro_torch.launch.train``) against the reference (JAX, CPU).

Weights come from the reference's ``init`` through ``convert``; batches
are numpy draws from a seed. Tolerances:
  * the FM gradient: the closed form ``g (sum_f e - e)`` against
    ``jax.grad`` of the reference's oracle, f32 within 1e-6 of the row's
    scale, bf16 within one bf16 ulp (the same f32 value, rounded once);
  * the loss within 1e-6 relative;
  * gradients, each leaf against its largest magnitude: at
    ``compute_dtype=float32`` within 2e-6 (f32 sums in another order; the
    deep tower is bf16 in both packages whatever ``compute_dtype`` says,
    and its weight gradients come out equal); the MLP biases within 2e-2 at
    either precision (the reference sums a bf16 bias cotangent over the
    batch in bf16, the port in f32); at bf16 the rest within 1e-2 (the
    reference casts the table before the gather, so its transpose adds
    duplicate ids in bf16; the port gathers, then casts, and adds them in
    f32: a deliberate difference). Measured worst cases over three seeds:
    7.1e-7, 1.5e-2 and 4.2e-3;
  * three bound steps: the leaves whose gradients carry those bf16
    differences (table, CIN, MLP biases) within 2 x the summed learning
    rate of the reference's parameters (Adam normalises a gradient that is
    rounding noise to an update of up to lr a step) and their moments
    within 2e-2 of the leaf's largest; every other leaf within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import deepfm as j_deepfm
from repro.configs import fm as j_fm
from repro.configs import wide_deep as j_wide_deep
from repro.configs import xdeepfm as j_xdeepfm
from repro.kernels.fm_interact.ref import fm_interact_ref as j_fm_ref
from repro.launch import steps as rsteps
from repro.models import recsys as R
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import deepfm, fm, wide_deep, xdeepfm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fm_interact import ops as FM
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys as rs
from repro_torch.train import value_and_grad

torch.set_num_threads(1)

PAIRS = {"fm": (j_fm, fm), "deepfm": (j_deepfm, deepfm), "wide-deep": (j_wide_deep, wide_deep),
         "xdeepfm": (j_xdeepfm, xdeepfm)}
B = 32


# --------------------------------------------------------- fm_interact grad
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 6, 8), (33, 39, 10)])
def test_fm_gradient_matches_jax_grad(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    e = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[0]).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    je = jnp.asarray(e).astype(jdt)
    want = jax.grad(lambda x: jnp.sum(j_fm_ref(x) * jnp.asarray(g)))(je)
    te = torch.from_numpy(np.asarray(je.astype(jnp.float32))).to(tdt).requires_grad_(True)
    before = dict(LAUNCHES)
    out = FM.fm_interact(te)
    (got,) = torch.autograd.grad(out, te, torch.from_numpy(g))
    assert LAUNCHES == before and got.dtype == tdt
    # through the plain version's autograd
    te2 = te.detach().requires_grad_(True)
    (plain,) = torch.autograd.grad(FM.fm_interact_ref(te2), te2, torch.from_numpy(g))
    scale = np.abs(g)[:, None, None] * np.abs(e).sum(1, keepdims=True) + 1e-30
    w = np.asarray(want.astype(jnp.float32))
    for x in (got, plain):
        err = np.abs(x.float().numpy() - w)
        if dtype == "f32":
            assert float((err / scale).max()) <= 1e-6
        else:    # one bf16 rounding of values equal to f32 precision
            assert float((err / (np.abs(w) + 1e-30)).max()) <= 2**-8


def test_fm_interact_without_grad_is_the_plain_route():
    e = torch.randn(5, 4, 3)
    assert FM.fm_interact(e).grad_fn is None
    with torch.no_grad():
        assert FM.fm_interact(e.requires_grad_(True)).grad_fn is None


# ------------------------------------------------------------ loss and grads
def _inputs(jcfg, seed):
    params = jax.tree.map(np.asarray, R.init(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, min(jcfg.vocab_sizes), (B, jcfg.multi_hot))
                    for _ in range(jcfg.n_fields)], axis=1).astype(np.int32)
    batch = {"sparse_ids": ids,
             "dense": rng.standard_normal((B, jcfg.n_dense)).astype(np.float32),
             "labels": (rng.random(B) < 0.3).astype(np.float32)}
    return params, batch


def _grad_leaves(tree) -> list:
    return [np.asarray(v, np.float32) for v in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(arch_id, precision):
    jm, pm = PAIRS[arch_id]
    jcfg, pcfg = jm.SMOKE, pm.SMOKE
    if precision == "f32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        pcfg = dataclasses.replace(pcfg, compute_dtype=torch.float32)
    params, batch = _inputs(jcfg, 5)
    jl, jg = jax.value_and_grad(R.loss_fn)(jax.tree.map(jnp.asarray, params),
                                           jax.tree.map(jnp.asarray, batch), jcfg)
    tp = convert.recsys_params_from_numpy(params, pcfg, "cpu")
    tl, tg = value_and_grad(lambda p, b: rs.loss_fn(p, b, pcfg), tp,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    names = [n for n, _ in flatten(tg)]
    got = [g.float().numpy() for _, g in flatten(tg)]
    want = _grad_leaves(jg)
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        gtol = 2e-2 if "['mlp']['b" in name else 2e-6 if precision == "f32" else 1e-2
        lim = gtol * float(np.abs(b).max()) + 1e-12
        assert float(np.abs(a - b).max()) <= lim, (name, float(np.abs(a - b).max()), lim)
    if arch_id == "fm":       # computed and thrown away by the reference, skipped by the port
        assert float(tg["dense_proj"]["w"].abs().max()) == 0.0
        assert float(np.abs(np.asarray(jg["dense_proj"]["w"])).max()) == 0.0


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
def test_bound_train_step_matches_reference(arch_id):
    """Three steps of ``bind(arch, "train_batch", reduced=True)`` from the
    reference's own init state, each step's batch the same numpy draw."""
    jm, pm = PAIRS[arch_id]
    rb = rsteps.bind(rconfigs.get(arch_id), "train_batch", reduced=True)
    pb = steps.bind(arch_id, "train_batch", reduced=True, device="cpu")
    assert pb.kind == rb.kind == "train"
    rstate = rb.init_fn(jax.random.PRNGKey(3))
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, rstate), pm.SMOKE, "cpu")
    sum_lr = 0.0
    for i in range(3):
        _, batch = _inputs(jm.SMOKE, 10 + i)
        rstate, rm = rb.step_fn(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = pb.step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-2)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        sum_lr += float(rm["lr"])
    pairs = flatten(convert.train_state_to_numpy(state))
    want = _grad_leaves(rstate)
    assert len(pairs) == len(want)
    for (name, a), b in zip(pairs, want):
        a, top = np.asarray(a, np.float32), float(np.abs(b).max()) + 1e-30
        err = float(np.abs(a - b).max())
        noisy = any(k in name for k in ("['table']", "['cin']", "['mlp']['b"))
        if not noisy:
            assert err <= 1e-6 * top, (name, err, top)
        elif name.startswith(".params"):
            assert err <= 2 * sum_lr, (name, err, sum_lr)
        else:
            assert err <= 2e-2 * top, (name, err, top)


def test_train_state_round_trip_and_shape_check():
    st = steps.bind("deepfm", "train_batch", reduced=True, device="cpu").init_fn(
        torch.Generator().manual_seed(0))
    back = convert.train_state_from_numpy(convert.train_state_to_numpy(st), deepfm.SMOKE, "cpu")
    for (na, a), (nb, b) in zip(flatten(st), flatten(back)):
        assert na == nb and torch.equal(a, b)
    bad = convert.train_state_to_numpy(st)
    bad.opt.m["table"] = bad.opt.m["table"][:-1]
    with pytest.raises(ValueError, match="table"):
        convert.train_state_from_numpy(bad, deepfm.SMOKE, "cpu")


# ------------------------------------------------------------- entry point
def test_launch_train_main_returns_zero_on_the_cpu(capsys):
    assert launch_train.main(["--arch", "deepfm", "--shape", "train_batch", "--steps", "20",
                              "--reduced", "--device", "cpu", "--log-every", "5"]) == 0
    assert "done: 20 steps" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not a training shape"):
        launch_train.run(["--arch", "deepfm", "--shape", "serve_p99", "--steps", "1",
                          "--reduced", "--device", "cpu"])


def test_launch_train_restart_ends_equal_to_an_uninterrupted_run(tmp_path, monkeypatch):
    """A failure at step 13 restores the step-9 commit and replays the
    stream from step 10: the final state and loss are the uninterrupted
    run's, bit for bit."""
    argv = ["--arch", "wide-deep", "--shape", "train_batch", "--steps", "20", "--reduced",
            "--device", "cpu", "--log-every", "100"]
    clean = launch_train.run(argv)
    orig_bind = steps.bind
    calls = {"n": 0}

    def failing_bind(*a, **kw):
        bound = orig_bind(*a, **kw)
        inner = bound.step_fn

        def step_fn(state, batch):
            calls["n"] += 1
            if calls["n"] == 14:
                raise RuntimeError("injected failure")
            return inner(state, batch)
        return dataclasses.replace(bound, step_fn=step_fn)

    monkeypatch.setattr(steps, "bind", failing_bind)
    out = launch_train.run(argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    assert calls["n"] == 20 + 1 + 3            # the failed call, then steps 10-12 again
    assert out["losses"][-1] == clean["losses"][-1]
    for (_, a), (_, b) in zip(flatten(out["state"]), flatten(clean["state"])):
        assert torch.equal(a, b)
    # a rerun resumes at the last commit (step 19): nothing left to run
    again = launch_train.run(argv + ["--ckpt-dir", str(tmp_path)])
    assert again["losses"] == [] and again["first_step"] == 20


def test_training_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.run(["--arch", "fm", "--shape", "train_batch", "--steps", "1", "--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        steps.bind("minitron-4b", "train_4k", reduced=True)
