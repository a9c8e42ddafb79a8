"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-3B]."""
from repro_torch.models.common import LayerGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        groups=(LayerGroup(("attn",), 28),),
        mlp_act="silu", rope_theta=500000.0,
        tie_embeddings=True,
        attn_mode="sequence",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, groups=(LayerGroup(("attn",), 2),))
