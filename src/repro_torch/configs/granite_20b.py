"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1: 48 q heads a kv
head) d_ff=24576 vocab=49152, GeGLU, head_dim 6144 / 48 = 128, untied;
a llama-architecture code model [arXiv:2405.04324]."""
from repro_torch.models.common import LayerGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        groups=(LayerGroup(("attn",), 52),),
        mlp_act="gelu", rope_theta=10000.0,
        tie_embeddings=False,
        attn_mode="heads",
    )


def cut(num_layers: int = 8) -> ModelConfig:
    """The full-width model cut to ``num_layers`` layers: 8 of 52 are
    about 4.8 B parameters, 9.7 GB in bf16, what one 80 GB card builds
    and serves beside its caches (the 52-layer model's 56 GB of bf16
    weights leave no room for the f32 draw of its largest leaf)."""
    return config().scaled(num_layers=num_layers,
                           groups=(LayerGroup(("attn",), num_layers),))


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, groups=(LayerGroup(("attn",), 2),))
