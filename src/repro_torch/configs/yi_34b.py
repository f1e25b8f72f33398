"""yi-34b [arXiv:2403.04652]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — llama-arch GQA."""
from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, d_head=128,
)

SMOKE = TransformerConfig(
    name="yi-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=512, d_head=8, q_chunk=16, ce_chunk=16,
)

ARCH = make_lm_arch("yi-34b", FULL, SMOKE)
