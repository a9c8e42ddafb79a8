"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk-norm, head_dim=128, tied embeddings, silu
[hf:Qwen/Qwen3-4B]."""
from repro_torch.models.common import LayerGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=9728, vocab_size=151936,
        groups=(LayerGroup(("attn",), 36),),
        mlp_act="silu", rope_theta=1000000.0, qk_norm=True,
        tie_embeddings=True,
        attn_mode="heads",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, groups=(LayerGroup(("attn",), 2),))
