"""Port parity: the training substrate's optimizer (``repro_torch.optim``:
AdamW, schedules, clipping, int8 compression with error feedback), the
data pipeline and the train step's accumulation, against the reference
(JAX, CPU) on the same numpy trees.

Tolerances: schedules and norms are f32 scalars computed in another order
of the same operations (rtol 1e-6); an AdamW step is elementwise f32 with
the same operation order, so the updated leaves agree within a few ulp
(rtol 1e-6, atol 1e-9; the global norm's sum runs in another order, which
moves the clip scale by an ulp); ``quantize_int8`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.data import pipeline
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.train import init_state, make_train_step

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-9


def _tree(seed, bf16=False):
    rng = np.random.default_rng(seed)
    t = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": {"c": rng.standard_normal((3, 4, 6)).astype(np.float32),
               "d": rng.standard_normal((9,)).astype(np.float32)}}
    return t


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None and t.dim() >= 3 else t


def _to_jax(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_jax(v, dtype) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return a.astype(dtype) if dtype is not None and a.ndim >= 3 else a


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    cfg = A.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000, schedule=schedule)
    rcfg = RA.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000, schedule=schedule)
    for step in (0, 1, 50, 100, 101, 5_050, 9_999, 10_000, 12_000):
        got = float(A.schedule_lr(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(RA.schedule_lr(rcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), (step, got, want)


def test_schedule_lr_reference_properties():
    cfg = A.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(A.schedule_lr(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(A.schedule_lr(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(A.schedule_lr(cfg, torch.tensor(100))) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1)
    got, norm = A.clip_by_global_norm(_to_torch(g), max_norm)
    want, rnorm = RA.clip_by_global_norm(_to_jax(g), max_norm)
    assert float(norm) == pytest.approx(float(rnorm), rel=RTOL)
    _close(got, want)
    # the reference's own property
    clipped, n = A.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(n) == pytest.approx(20.0)
    assert float(A.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_apply_three_steps_matches_reference(master, clip):
    """Three steps from the same params, moments and grads (bf16 ndim >= 3
    leaves with an f32 master when ``master``)."""
    cfg = A.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    rcfg = RA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    params = _tree(0)
    low_t, low_j = (torch.bfloat16, jnp.bfloat16) if master else (None, None)
    p = _to_torch(params, low_t)
    rp = _to_jax(params, low_j)
    st, rst = A.init(p, keep_master=master), RA.init(rp, keep_master=master)
    for i in range(3):
        g = _tree(10 + i)
        p, st, met = A.apply(cfg, p, _to_torch(g, low_t), st)
        rp, rst, rmet = RA.apply(rcfg, rp, _to_jax(g, low_j), rst)
        assert int(st.step) == int(rst.step) == i + 1
        assert float(met["lr"]) == pytest.approx(float(rmet["lr"]), rel=RTOL)
        if clip is not None:
            assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=RTOL)
        _close(st.m, rst.m)
        _close(st.v, rst.v)
        if master:
            _close(st.master, rst.master)
            # the bf16 leaves: the master rounded, at most one ulp of bf16 apart
            _close(p, jax.tree.map(lambda a: a.astype(jnp.float32), rp), rtol=2**-8, atol=0)
        else:
            _close(p, rp)


def test_adamw_master_is_its_own_storage():
    p = {"w": torch.ones(3)}
    st = A.init(p, keep_master=True)
    assert st.master["w"].data_ptr() != p["w"].data_ptr()


def test_quantize_int8_bit_for_bit():
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal((257,)).astype(np.float32) * 3.7,
              np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32),
              np.zeros((8,), np.float32),
              (rng.integers(-300, 300, (64,)) / 2.0).astype(np.float32)):
        q, s = C.quantize_int8(torch.from_numpy(x))
        rq, rs = RC.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert q.dtype == torch.int8 and float(s) == float(rs)
        np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                      np.asarray(RC.dequantize_int8(rq, rs)))


def test_compress_tree_residual_matches_reference():
    g = _tree(4)
    q, s, res = C.compress_tree(_to_torch(g), None)
    rq, rs, rres = RC.compress_tree(_to_jax(g), None)
    for _ in range(3):     # error feedback carried over three more steps
        g = _tree(5 + _)
        q, s, res = C.compress_tree(_to_torch(g), res)
        rq, rs, rres = RC.compress_tree(_to_jax(g), rres)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 {k: q[k] for k in q}, rq)
    _close(res, rres, rtol=0, atol=0)
    _close(C.decompress_tree(q, s), RC.decompress_tree(rq, rs), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_compression_error_feedback_unbiased(seed, scale):
    """The reference's property: over 20 steps the cumulative dequantized
    sum stays within a few quantization steps of the true sum."""
    g = {"w": torch.from_numpy(np.random.default_rng(seed).standard_normal(64).astype(
        np.float32) * scale)}
    residual, total_q = None, torch.zeros(64)
    for _ in range(20):
        q, s, residual = C.compress_tree(g, residual)
        total_q = total_q + C.decompress_tree(q, s)["w"]
    tol = float(g["w"].abs().max()) / 127 * 3 + 1e-6
    assert float((total_q - g["w"] * 20).abs().max()) < tol * 20


def test_adamw_converges_quadratic():
    cfg = A.AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=0, total_steps=300)
    step = make_train_step(lambda p, b: torch.sum((p["w"] - b["target"]) ** 2), cfg)
    state = init_state({"w": torch.ones(8) * 5.0})
    for _ in range(300):
        state, m = step(state, {"target": torch.zeros(8)})
    assert float(m["loss"]) < 1e-3


def _lin_loss_t(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _lin_loss_j(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)


@pytest.mark.parametrize("compression", [None, "int8_ef"])
def test_train_step_accumulation_matches_reference(compression):
    """accum_steps = 4 == one full batch (the reference's property), and
    each against the reference's step (with int8 error feedback too)."""
    cfg = A.AdamWConfig(lr=0.1, weight_decay=0.01, warmup_steps=0, schedule="constant")
    rcfg = RA.AdamWConfig(lr=0.1, weight_decay=0.01, warmup_steps=0, schedule="constant")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.standard_normal(16).astype(np.float32)
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    use_c = compression is not None
    out = {}
    for accum in (1, 4):
        st = init_state({"w": torch.ones(4)}, use_compression=use_c)
        rst = r_init_state({"w": jnp.ones(4)}, use_compression=use_c)
        step = make_train_step(_lin_loss_t, cfg, compression, accum)
        rstep = r_make_train_step(_lin_loss_j, rcfg, compression, accum)
        for _ in range(3):
            st, m = step(st, tb)
            rst, rm = rstep(rst, jb)
            assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        _close(st.params, rst.params, rtol=1e-5, atol=1e-7)
        if use_c:
            _close(st.residual, rst.residual, rtol=1e-4, atol=1e-6)
        out[accum] = st.params["w"]
    np.testing.assert_allclose(out[1].numpy(), out[4].numpy(), rtol=1e-5)


def test_unused_leaf_gets_zero_gradient_and_decays():
    """A leaf the loss never reads: zero gradient, weight decay moves it."""
    cfg = A.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, schedule="constant")
    rcfg = RA.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, schedule="constant")
    st = init_state({"w": torch.ones(3), "unused": torch.full((2,), 2.0)})
    rst = r_init_state({"w": jnp.ones(3), "unused": jnp.full((2,), 2.0)})
    st, _ = make_train_step(lambda p, b: torch.sum(p["w"] ** 2), cfg)(st, {})
    rst, _ = r_make_train_step(lambda p, b: jnp.sum(p["w"] ** 2), rcfg)(rst, {})
    _close(st.params, rst.params)
    assert float(st.params["unused"][0]) == pytest.approx(2.0 - 0.1 * 0.5 * 2.0)


def test_pipeline_determinism_and_prefetch():
    def batch_fn(gen):
        return {"x": torch.randn(4, generator=gen)}

    a = [b for _, b in zip(range(5), pipeline.seeded_stream(batch_fn, seed=3))]
    b = [b for _, b in zip(range(5), pipeline.seeded_stream(batch_fn, seed=3))]
    c = [b for _, b in zip(range(3), pipeline.seeded_stream(batch_fn, seed=3, start_step=2))]
    for ba, bb in zip(a, b):
        assert torch.equal(ba["x"], bb["x"])
    for ba, bc in zip(a[2:], c):      # a batch is a function of (seed, step)
        assert torch.equal(ba["x"], bc["x"])
    assert not torch.equal(a[0]["x"], a[1]["x"])
    pf = pipeline.prefetch(pipeline.seeded_stream(batch_fn, seed=3), size=2, device="cpu")
    for ba, bp in zip(a, pf):
        assert torch.equal(ba["x"], bp["x"])
    with pytest.raises(ValueError):
        pipeline.step_generator(2**31, 0)
