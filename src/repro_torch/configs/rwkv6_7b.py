"""RWKV-6 (Finch) 7B. [arXiv:2404.05892]

Attention-free SSM: 32L, d_model=4096, 64 WKV heads of 64, d_ff=14336
(channel-mix), vocab=65536, data-dependent decay, token-shift; a
constant-size recurrent decode state. 7,576,621,056 parameters.
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family=SSM,
    num_layers=32,
    d_model=4096,
    num_heads=64,      # WKV head count (head_dim=64); attention-free
    num_kv_heads=0,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    max_context=1 << 20,   # unbounded in principle (recurrent)
    citation="arXiv:2404.05892",
)
