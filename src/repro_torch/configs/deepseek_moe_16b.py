"""deepseek-moe-16b [arXiv:2401.06066]: 28L d_model=2048 16H (MHA kv=16)
d_ff=1408/expert, vocab=102400, 2 shared + 64 routed top-6 (fine-grained)."""
from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=102400, d_head=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff=1408),
)

SMOKE = TransformerConfig(
    name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512, d_head=16, q_chunk=16, ce_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff=16, capacity_factor=2.0),
)

ARCH = make_lm_arch("deepseek-moe-16b", FULL, SMOKE)
