"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256, embeddings scaled by sqrt(d_model),
tied [arXiv:2403.08295]."""
from repro_torch.models.common import LayerGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=256000,
        groups=(LayerGroup(("attn",), 18),),
        mlp_act="gelu", rope_theta=10000.0,
        tie_embeddings=True, scale_embeddings=True,
        attn_mode="sequence",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, groups=(LayerGroup(("attn",), 2),))
