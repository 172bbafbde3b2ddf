"""SmolLM-135M. [hf:HuggingFaceTB/SmolLM-135M]

Llama-arch small dense decoder: 30L, d_model=576, 9 heads (GQA kv=3),
d_ff=1536, vocab=49152, tied embeddings: 134,515,008 parameters.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family=DENSE,
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    max_context=2048,
    tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
)
