"""minitron-4b [arXiv:2407.14679]: 32L d_model=3072 24H (GQA kv=8)
d_ff=9216 vocab=256000 — pruned nemotron."""
from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="minitron-4b", n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256000, d_head=128,
)

SMOKE = TransformerConfig(
    name="minitron-smoke", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=96, vocab=512, d_head=8, q_chunk=16, ce_chunk=16,
)

ARCH = make_lm_arch("minitron-4b", FULL, SMOKE)
