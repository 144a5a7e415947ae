"""qwen3-1.7b [hf:Qwen/Qwen3 family]: 28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, qk-norm."""
from repro_torch.configs.registry import ArchSpec, _lm_cells, register
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-1.7b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE = TransformerConfig(
    name="qwen3-1.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, qk_norm=True,
    q_chunk=16, kv_chunk=16, loss_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="qwen3-1.7b", family="lm", config=FULL, smoke=SMOKE,
    cells=_lm_cells(),
))
