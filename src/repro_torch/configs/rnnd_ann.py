"""The paper's own configuration: RNN-Descent index construction + search.

Paper §5.1 settings: S=20, R=96, T1=4, T2=15; query-time K sweep 16..inf;
corpora SIFT1M (128d) / GIST1M (960d) / Deep1M (96d).

``build_gist_sq8`` stores GIST1M as an SQ8 index (per-dimension int8 codes,
Faiss's ``ScalarQuantizer`` ``QT_8bit``): the same build over the codes
(``rng_prune_int8``), whose searches rerank the best 64 over the f32 rows.
"""
import dataclasses

from repro_torch.configs.base import ANN_SHAPES, Arch
from repro_torch.core.rnn_descent import RNNDescentConfig
from repro_torch.core.search import SearchConfig
from repro_torch.quant import Quantization

FULL = RNNDescentConfig(s=20, r=96, t1=4, t2=15, capacity=128)
SEARCH = SearchConfig(l=64, k=64, max_iters=256)

SMOKE = RNNDescentConfig(s=8, r=24, t1=2, t2=3, capacity=32, chunk=256)
SEARCH_SMOKE = SearchConfig(l=16, k=16, max_iters=64)

SQ8 = Quantization("int8", rerank_k=64)


def _make_config(shape_name, reduced):
    cfg = SMOKE if reduced else FULL
    return dataclasses.replace(cfg, quant=SQ8) if shape_name == "build_gist_sq8" else cfg


ARCH = Arch("rnnd-ann", "ann", ANN_SHAPES, _make_config)
