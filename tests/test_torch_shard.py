"""Port parity of the sharded layer's rank-local pieces, in one process (no
process group), against the reference (JAX, CPU): ``shard.pad_rows``, the
destination-bucketed exchange simulated with D ranks' candidate lists,
``shard._exchange_attrs``, the logical-axis rules, and fault tolerance
(``StepWatchdog``, ``run_with_restarts``).

The simulated exchange: each of D ranks scatters its share of one
candidate list into every destination block (``shard.block_scatter``, the
function the ring calls), the blocks fold pairwise in ring order
(``graph.combine_bucket_tables_pair``), and the result must equal the
reference's full-height ``bucket_scatter_tables`` of the whole list, bit
for bit, at D = 1, 2, 4, 8 over n = 701 rows (divisible by none of them).
Meshes are duck-typed (``axis_names``, ``shape``), which both packages'
rule functions read.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.core import shard as RSH
from repro.distributed import fault as RF
from repro.distributed import sharding as RSHD
from repro_torch import convert
from repro_torch.core import graph as G
from repro_torch.core import shard
from repro_torch.distributed import fault as F
from repro_torch.distributed import sharding as SHD

torch.set_num_threads(1)

N = 701


def _mesh(**shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.mark.parametrize("n_pad", [12, 13, 16])
def test_pad_rows_matches_reference(n_pad):
    rng = np.random.default_rng(n_pad)
    ids = rng.integers(-1, 12, (12, 5)).astype(np.int32)
    dists = rng.random((12, 5)).astype(np.float32)
    flags = rng.integers(0, 2, (12, 5)).astype(np.uint8)
    ref = RSH.pad_rows(RG.Graph(jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(flags)),
                       n_pad)
    got = shard.pad_rows(convert.graph_from_numpy(ids, dists, flags, device="cpu"), n_pad)
    for a, b in zip(got, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _candidates(seed, m=8000):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, N, m).astype(np.int32), rng.integers(-1, N, m).astype(np.int32),
            rng.integers(0, 40, m).astype(np.float32), rng.integers(0, 2, m).astype(np.uint8),
            rng.integers(0, 2, m).astype(np.int32))


@pytest.mark.parametrize("prio", [False, True], ids=["sweep", "reverse"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_simulated_ring_exchange_matches_full_scatter(d, prio):
    src, dst, dist, flag, pr = _candidates(d)
    b = 128
    ref = RG.bucket_scatter_tables(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(dist),
                                   jnp.asarray(flag), N, b,
                                   prio=jnp.asarray(pr) if prio else None)
    t = [torch.from_numpy(a) for a in (src, dst, dist, flag, pr)]
    n_pad = shard._padded(N, d)
    n_blk = n_pad // d
    # rank s holds every d-th candidate; its block scatters of every destination
    scatters = [shard.block_scatter(t[0][s::d], t[1][s::d], t[2][s::d], t[3][s::d], b,
                                    prio=t[4][s::d] if prio else None) for s in range(d)]
    blocks = []
    for me in range(d):          # the ring as rank ``me`` sees it: hop j from me - j
        acc = scatters[me](me * n_blk, n_blk)
        for j in range(1, d):
            acc = G.combine_bucket_tables_pair(acc, scatters[(me - j) % d](me * n_blk, n_blk))
        blocks.append(acc)
    p, k, i, f = (None if blocks[0][c] is None else torch.cat([bl[c] for bl in blocks])
                  for c in range(4))
    # the padded rows stay empty
    assert (k[N:] == G.KEY_SENTINEL).all() and (i[N:] == G.INT32_MAX).all()
    rp, rk, ri, rf = ref
    assert (p is None) == (rp is None)
    if p is not None:
        np.testing.assert_array_equal(p[:N].numpy(), np.asarray(rp))
    np.testing.assert_array_equal(convert.key_to_reference(k[:N]), np.asarray(rk))
    np.testing.assert_array_equal(i[:N].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(f[:N].numpy(), np.asarray(rf))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_exchange_attrs_match_reference(d):
    mesh = _mesh(data=d)
    for n, buckets, slot in ((N, 256, 9), (1_000_000, 256, 22), (20_000, 512, 8)):
        assert shard._exchange_attrs(n, mesh, buckets, slot) == \
            RSH._exchange_attrs(n, mesh, buckets, slot)
    # the 1M sweep of a D = 2 mesh: 9 x 256 x n_pad / 2
    assert shard._exchange_attrs(1_000_000, _mesh(data=2), 256, 9)[
        "exchange_bytes_per_device"] == 9 * 256 * 500_000


@pytest.mark.parametrize("shape", [dict(data=4), dict(data=2, model=4),
                                   dict(pod=2, data=2, model=2), dict(model=8)],
                         ids=["data", "data_model", "pod_data_model", "model"])
def test_sharding_rules_match_reference(shape):
    mesh = _mesh(**shape)
    assert SHD.RULES == RSHD.RULES
    for logical in list(RSHD.RULES) + ["unknown"]:
        assert SHD.physical_axes(mesh, logical) == RSHD.physical_axes(mesh, logical)
        assert SHD.mesh_axes(mesh, logical) == RSHD.mesh_axes(mesh, logical)
        assert SHD.axis_count(mesh, logical) == RSHD.axis_count(mesh, logical)
    assert shard.row_axes(mesh) == RSH.row_axes(mesh)
    assert shard.n_shards(mesh) == RSH.n_shards(mesh)


def test_check_mesh_matches_reference():
    for mesh, merge in ((_mesh(data=2), "sort"), (_mesh(model=2), "bucketed")):
        with pytest.raises(ValueError):
            RSH._check_mesh(mesh, merge)
        with pytest.raises(ValueError):
            shard._check_mesh(mesh, merge)
    shard._check_mesh(_mesh(data=2), "bucketed")


def test_step_watchdog_matches_reference():
    times = [1.0] * 12 + [1.2, 2.0, 0.9, 3.5] + [1.0] * 5
    ours, ref = F.StepWatchdog(window=12), RF.StepWatchdog(window=12)
    for t in times:
        assert ours.record(t) == ref.record(t)
    assert ours.record(10.0)["straggler"]


def _counter_state():
    return {"w": np.zeros(4, np.float32), "seen": np.zeros(1, np.int64)}


def _step(fail_at):
    failed = set()

    def step_fn(state, step):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"injected fault at step {step}")
        w = np.asarray(state["w"]) + np.float32(step)
        seen = np.asarray(state["seen"]) + 1
        return {"w": w, "seen": seen}, {"step": step}
    return step_fn


@pytest.mark.parametrize("fail_at", [(), (7,), (3, 12)], ids=["none", "one", "two"])
def test_run_with_restarts_matches_reference(tmp_path, fail_at):
    """Same steps, checkpoints and recovery: a fault restores the latest
    commit and replays from it, so the final state and the history of
    completed steps equal the reference driver's."""
    ours, h = F.run_with_restarts(_counter_state, _step(set(fail_at)), 16,
                                  str(tmp_path / "port"), ckpt_every=5)
    ref, rh = RF.run_with_restarts(_counter_state, _step(set(fail_at)), 16,
                                   str(tmp_path / "ref"), ckpt_every=5)
    np.testing.assert_array_equal(np.asarray(ours["w"]), np.asarray(ref["w"]))
    np.testing.assert_array_equal(np.asarray(ours["seen"]), np.asarray(ref["seen"]))
    assert [m["step"] for m in h] == [m["step"] for m in rh]
    # the two packages restore each other's checkpoints
    from repro_torch import checkpoint
    assert checkpoint.latest_step(str(tmp_path / "ref")) == 15
    back = checkpoint.restore(str(tmp_path / "ref"), 15, _counter_state(), device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(ref["w"]))


def test_run_with_restarts_gives_up_after_max_restarts(tmp_path):
    def always(state, step):
        raise RuntimeError("broken step")
    with pytest.raises(RuntimeError, match="broken step"):
        F.run_with_restarts(_counter_state, always, 4, str(tmp_path), max_restarts=2)
