"""The dry run (``python -m repro_torch.launch.dryrun``): a cell built and
stepped on the meta device counts the same bytes and FLOPs as the same step
run for real on the CPU, for every DimeNet cell and the minitron-4b cells
at their SMOKE configs; the ANN cells are not stepped, FM and DeepFM are
(``fm_interact``'s meta path); the live bytes' peak of a step, on one
device and on rank 0 of a forged mesh; the CLI. Also ``run_with_restarts``'
default device (``distributed/fault.py``)."""
import json

import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.distributed import fault
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fm_interact import ops as fm_ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as M

torch.set_num_threads(1)

CELLS = [("dimenet", s) for s in ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")] + \
    [("minitron-4b", s) for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_meta_counts_equal_a_real_cpu_step(arch_id, shape):
    meta = dryrun.run_cell(arch_id, shape, reduced=True)
    bound = steps.bind(arch_id, shape, reduced=True, device="cpu")
    state = bound.init_fn(torch.Generator().manual_seed(0))
    family = "gnn" if arch_id == "dimenet" else "lm"
    batch = cb.smoke_batch(family)(torch.Generator().manual_seed(1), bound.cfg, bound.shape,
                                   "cpu")
    real = dryrun.measure_step(bound, state, batch)
    assert meta["hand_kernels"] == []
    assert meta["flops"] == real["flops"] > 0
    assert meta["saved_bytes"] == real["saved_bytes"]
    assert (meta["saved_bytes"] > 0) == (bound.kind == "train")
    assert meta["batch_bytes"] == dryrun._nbytes(batch)
    assert meta["state_bytes"] == dryrun._nbytes(state)
    assert meta["total_bytes"] == meta["state_bytes"] + meta["batch_bytes"] + meta["saved_bytes"]


def test_full_cells_on_meta_and_hand_kernel_cells():
    mol = dryrun.run_cell("dimenet", "molecule")
    ogb = dryrun.run_cell("dimenet", "ogb_products")
    assert mol["fits_one_card"] and mol["params"] == 365_920
    # 61.9M edges: one (E, 128) bf16 edge state a block is 15.8 GB
    assert not ogb["fits_one_card"] and ogb["saved_bytes"] > 6 * 61_861_888 * 128 * 2
    assert ogb["flops"] > 100 * mol["flops"]
    for arch_id, shape, kernels in (("deepfm", "train_batch", ["fm_interact"]),
                                    ("fm", "serve_bulk", ["fm_interact"]),
                                    ("rnnd-ann", "build_1m",
                                     ["rng_prune", "bucket_scatter", "bucket_row_merge"]),
                                    ("rnnd-ann", "build_gist_sq8",
                                     ["rng_prune_int8", "bucket_scatter", "bucket_row_merge"]),
                                    ("rnnd-ann", "search_1m", ["beam_score"])):
        r = dryrun.run_cell(arch_id, shape)
        assert r["hand_kernels"] == kernels
        if kernels == ["fm_interact"]:       # it has a meta path: the cell is stepped
            assert r["flops"] is not None and r["saved_bytes"] is not None
            assert r["peak_bytes"] > r["state_bytes"] + r["batch_bytes"]
            continue
        assert r["flops"] is None and r["saved_bytes"] is None and r["peak_bytes"] is None
        assert r["total_bytes"] == r["state_bytes"] + r["batch_bytes"]
        if shape.startswith("build"):    # the f32 corpus, coded builds too
            d = next(s for s in cb.ANN_SHAPES if s.name == shape).dims["d"]
            assert r["batch_bytes"] == 1_000_000 * d * 4 and r["fits_one_card"]
    assert dryrun.run_cell("wide-deep", "serve_p99")["hand_kernels"] == []
    assert dryrun.card_bytes() == (torch.cuda.get_device_properties(0).total_memory
                                   if torch.cuda.is_available() else 80 * 2**30)


def test_cli_json_and_out(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "dimenet", "--shape", "molecule", "--json",
                        "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads(out.read_text())
    assert list(saved) == ["dimenet/molecule"]
    assert saved["dimenet/molecule"]["flops"] == line["flops"] > 0
    assert dryrun.main(["--arch", "fm", "--shape", "serve_p99"]) == 0
    assert "hand kernel: fm_interact" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "dimenet"])


class _Step:
    """A hand-made bound step."""
    kind = "serve"

    def __init__(self, fn):
        self.step_fn = fn


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_peak_bytes_of_a_known_live_curve(device):
    """Live bytes over a step: the state and the batch (600 B), then +4,000,
    a view (nothing), +2,000, an in-place op (nothing), -4,000, +8,000 (the
    peak: 10,000 over the base), -8,000."""
    state = {"w": torch.empty(100, device=device)}
    batch = {"x": torch.empty(50, device=device)}

    def step(st, b):
        a = torch.empty(1000, device=device)
        v = a.view(10, 100)
        c = torch.empty(500, device=device)
        c.add_(1)
        del a, v
        d = torch.empty(2000, device=device)
        del d
        return c + st["w"][:1]

    got = dryrun.measure_step(_Step(step), state, batch)
    assert got["peak_bytes"] == 600 + 10_000
    assert got["temp_bytes"] == 10_000
    assert got["saved_bytes"] == 0


@pytest.mark.parametrize("arch_id,shape", [("minitron-4b", "train_4k"), ("dimenet", "molecule")])
def test_temp_bytes_cover_the_saved_bytes_and_equal_a_real_cpu_step(arch_id, shape):
    meta = dryrun.run_cell(arch_id, shape, reduced=True)
    bound = steps.bind(arch_id, shape, reduced=True, device="cpu")
    state = bound.init_fn(torch.Generator().manual_seed(0))
    family = "gnn" if arch_id == "dimenet" else "lm"
    batch = cb.smoke_batch(family)(torch.Generator().manual_seed(1), bound.cfg, bound.shape,
                                   "cpu")
    real = dryrun.measure_step(bound, state, batch)
    assert meta["temp_bytes"] >= meta["saved_bytes"] > 0
    assert meta["peak_bytes"] == real["peak_bytes"] == \
        meta["state_bytes"] + meta["batch_bytes"] + meta["temp_bytes"]
    assert meta["fits_one_card"]


@pytest.mark.parametrize("arch_id,shape", [
    ("minitron-4b", "train_4k"), ("minitron-4b", "prefill_32k"), ("minitron-4b", "decode_32k"),
    ("minitron-4b", "long_500k"), ("deepseek-moe-16b", "decode_32k"), ("deepfm", "serve_p99"),
    ("deepfm", "train_batch"), ("deepfm", "retrieval_cand")])
def test_rank_peak_on_a_forged_mesh(arch_id, shape):
    """Rank 0 of a 2 x 2 meta mesh (no process group: every collective
    gives a meta output of its shape) peaks at no more than the one
    device's step and at no less than its own blocks of the state and the
    batch."""
    mesh = M.Mesh(("data", "model"), {"data": 2, "model": 2}, "none", torch.device("meta"), 0,
                  {})
    one = dryrun.run_cell(arch_id, shape, reduced=True)
    rank = dryrun.rank_step(arch_id, shape, mesh, reduced=True)
    bound = steps.bind(arch_id, shape, reduced=True, device="meta", mesh=mesh)
    own = dryrun._nbytes(bound.init_fn(None)) + \
        dryrun.per_rank_bytes(dryrun._meta_batch(bound.input_specs, torch.device("meta")),
                              bound.batch_axes, mesh)[0]
    assert own < rank["peak_bytes"] <= one["peak_bytes"]
    assert rank["temp_bytes"] == rank["peak_bytes"] - own


@pytest.mark.parametrize("arch_id,shape", [("fm", "serve_bulk"), ("deepfm", "train_batch")])
def test_fm_cells_are_stepped_on_meta(arch_id, shape):
    """``fm_interact`` gives a meta input a (B,) meta output and launches
    nothing, so FM and DeepFM are stepped, on one device and on rank 0 of
    the production meshes."""
    before = dict(LAUNCHES)
    out = fm_ops.fm_interact(torch.empty(8, 3, 4, device="meta"))
    assert out.is_meta and out.shape == (8,) and out.dtype == torch.float32
    assert LAUNCHES == before
    r = dryrun.run_cell(arch_id, shape)
    assert r["hand_kernels"] == ["fm_interact"]
    assert (r["flops"] > 0) == (arch_id == "deepfm")         # FM has no deep tower
    assert (r["saved_bytes"] > 0) == (r["kind"] == "train")
    assert r["temp_bytes"] >= r["saved_bytes"]
    for name in ("16x16", "2x16x16"):
        pr = r["per_rank"][name]
        assert pr["not_stepped"] is None
        assert pr["peak_bytes"] == pr["state_bytes"] + pr["batch_bytes"] + pr["temp_bytes"]
        assert pr["temp_bytes"] > 0


@pytest.mark.parametrize("device", [None, "cpu"])
def test_restarts_restore_onto_the_states_own_device(tmp_path, monkeypatch, device):
    """``run_with_restarts`` without ``device=`` restores onto the device
    of ``make_state()``'s leaves (here meta); an explicit ``device=`` wins."""
    seen, saved = [], []
    monkeypatch.setattr(fault.ckpt, "save", lambda d, step, st, **kw: saved.append(step))
    monkeypatch.setattr(fault.ckpt, "latest_step", lambda d: saved[-1] if saved else None)

    def restore(d, step, like, device, **kw):
        seen.append(torch.device(device))
        return like

    monkeypatch.setattr(fault.ckpt, "restore", restore)
    failed = []

    def step_fn(state, step):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("injected")
        return state, {"step": step}

    kw = {} if device is None else {"device": device}
    fault.run_with_restarts(lambda: {"w": torch.empty(4, device="meta")}, step_fn, 6,
                            str(tmp_path), ckpt_every=2, **kw)
    assert failed == [3] and seen == [torch.device(device or "meta")]

