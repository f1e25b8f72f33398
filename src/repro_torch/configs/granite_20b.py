"""granite-20b [arXiv:2405.04324]: 52L d_model=6144 48H (MQA kv=1)
d_ff=24576 vocab=49152 — gpt-bigcode-style 2-matrix GELU FFN."""
from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-20b", n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, d_head=128, ffn_type="gelu",
)

SMOKE = TransformerConfig(
    name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, d_head=16, ffn_type="gelu", q_chunk=16, ce_chunk=16,
)

ARCH = make_lm_arch("granite-20b", FULL, SMOKE)
