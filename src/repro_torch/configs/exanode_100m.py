"""exanode-100m: the ~100M-param llama-style demo workload (12 layers x 768,
12 heads / 4 KV heads, d_ff 2048, vocab 32000, tied embeddings, silu)."""
from repro_torch.models.common import LayerGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="exanode-100m", family="dense",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=2048, vocab_size=32000,
        groups=(LayerGroup(("attn",), 12),),
        mlp_act="silu", rope_theta=10000.0,
        tie_embeddings=True,
        attn_mode="sequence",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, groups=(LayerGroup(("attn",), 2),))
