"""The paper's own configuration: RNN-Descent index construction + search.

Paper §5.1 settings: S=20, R=96, T1=4, T2=15; query-time K sweep 16..inf;
corpora SIFT1M (128d) / GIST1M (960d) / Deep1M (96d).
"""
from repro_torch.configs.base import ANN_SHAPES, Arch
from repro_torch.core.rnn_descent import RNNDescentConfig
from repro_torch.core.search import SearchConfig

FULL = RNNDescentConfig(s=20, r=96, t1=4, t2=15, capacity=128)
SEARCH = SearchConfig(l=64, k=64, max_iters=256)

SMOKE = RNNDescentConfig(s=8, r=24, t1=2, t2=3, capacity=32, chunk=256)
SEARCH_SMOKE = SearchConfig(l=16, k=16, max_iters=64)


def _make_config(shape_name, reduced):
    return SMOKE if reduced else FULL


ARCH = Arch("rnnd-ann", "ann", ANN_SHAPES, _make_config)
