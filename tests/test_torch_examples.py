"""The port's examples (``examples/torch_*.py``) run in-process on the CPU at
a small size, and refuse to run without a card unless asked for the CPU.
The quickstart also runs its sharded search over two gloo ranks."""
import importlib
import pathlib
import sys

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_build_and_search", "torch_recsys_retrieval",
         "torch_train_lm")


def _load(name):
    """The example as a module importable by name (spawned ranks unpickle
    its rank function by module path)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart_on_the_cpu(capfd):
    out = _load("torch_quickstart").main(["--device", "cpu", "--n", "600", "--queries", "32",
                                           "--ranks", "2"])
    assert out["device"] == "cpu" and min(out["recall_at_1"].values()) >= 0.9
    text = capfd.readouterr().out          # the ranks print from their own processes
    assert "0 beam_score launches" in text and "equal to unsharded" in text
    assert "quantized[pq  ]" in text


def test_build_and_search_on_the_cpu(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    out = _load("torch_build_and_search").main(["--device", "cpu", "--n", "480", "--queries",
                                                 "16", "--trace", str(trace)])
    assert set(out["recall_at_1"]) == {"rnn-descent", "rnn-descent[sort-oracle]", "nn-descent",
                                       "nsg-style"}
    assert out["recall_at_1"]["rnn-descent"] >= 0.9 and trace.exists()
    text = capsys.readouterr().out
    assert "rnn_descent/sweep" in text and "serving session" in text


def test_recsys_retrieval_on_the_cpu():
    out = _load("torch_recsys_retrieval").main(["--device", "cpu", "--candidates", "1500",
                                                 "--queries", "16"])
    assert out["recall_at_1_in_top10"] >= 0.9


def test_train_lm_on_the_cpu(tmp_path):
    from repro_torch import checkpoint as ckpt
    out = _load("torch_train_lm").main(["--device", "cpu", "--tiny", "--steps", "100",
                                        "--ckpt-dir", str(tmp_path)])
    assert out["losses"][-1] < out["losses"][0]
    assert ckpt.committed_steps(str(tmp_path)) == [99]


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        _load(name).main([])
