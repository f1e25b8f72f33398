"""The dry run (``python -m repro_torch.launch.dryrun``): a cell built and
stepped on the meta device counts the same bytes and FLOPs as the same step
run for real on the CPU, for every DimeNet cell and the minitron-4b cells
at their SMOKE configs; hand-kernel cells are not stepped; the CLI."""
import json

import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.launch import dryrun, steps

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
    for arch_id, shape, kernel in (("deepfm", "train_batch", "fm_interact"),
                                   ("fm", "serve_bulk", "fm_interact"),
                                   ("rnnd-ann", "build_1m", "rng_prune"),
                                   ("rnnd-ann", "search_1m", "beam_score")):
        r = dryrun.run_cell(arch_id, shape)
        assert r["hand_kernels"] == [kernel]
        assert r["flops"] is None and r["saved_bytes"] is None
        assert r["total_bytes"] == r["state_bytes"] + r["batch_bytes"]
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
