"""How close K3's backward kernels come to a float64 gradient, and how their
time at the training length grows with the batch, on the card:

    PYTHONPATH=src python scripts/attention_bwd_error.py

Prints one JSON line with:
  * ``error``: for each shape (B, S, Hq, Hkv, D; causal, from 64 to 2048
    tokens), the largest error of dq, dk and dv relative to max(1, the
    float64 gradient's largest entry), for the kernels and for the plain f32
    backward (``attention_bwd_ref``) on the same inputs. A sum whose error
    grows with S shows here first: dK and dV sum over every query of a
    kv head's group;
  * ``graph_ms_by_batch``: each kernel's device time in a CUDA graph at
    S 64, 9/3 heads, D 64 for B 4 to 192 (the sync training shape is B 48),
    which tells a time bound by one block's latency (flat in B) from one
    bound by the card's throughput (growing with B).
Needs a CUDA device.
"""
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.swa_attention import kernel as AK  # noqa: E402
from repro_torch.kernels.swa_attention import ref as AR  # noqa: E402

SHAPES = [(48, 64, 9, 3, 64), (8, 1024, 9, 3, 64), (2, 2048, 9, 3, 64),
          (2, 1000, 4, 2, 128)]
BATCHES = [4, 12, 48, 96, 192]


def grad64(q, k, v, do):
    """The causal attention gradient in float64, by the formulas."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    dog = do.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, -math.inf), -1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    delta = (dog * o).sum(-1).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k) / math.sqrt(D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) / math.sqrt(D)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq.reshape(q.shape), dk, dv


def rel(got, want):
    return float((got.double() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all([s for s in _build.sources()
                      if s.stem.startswith("swa_attention")])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(C.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    error = []
    for B, S, Hq, Hkv, D in SHAPES:
        q, k, v, do = (randn(B, S, Hq, D), randn(B, S, Hkv, D),
                       randn(B, S, Hkv, D), randn(B, S, Hq, D))
        o, lse = AR.attention_fwd_ref(q, k, v)
        want = grad64(q, k, v, do)
        kernel = AK.attention_bwd(q, k, v, o, lse, do)
        plain = AR.attention_bwd_ref(q, k, v, o, lse, do)
        error.append({"shape": [B, S, Hq, Hkv, D],
                      "kernels": dict(zip(("dq", "dk", "dv"), map(
                          rel, kernel, want))),
                      "plain_f32": dict(zip(("dq", "dk", "dv"), map(
                          rel, plain, want)))})
        del want, kernel, plain
    by_batch = []
    for B in BATCHES:
        q, k, v, do = (randn(B, 64, 9, 64), randn(B, 64, 3, 64),
                       randn(B, 64, 3, 64), randn(B, 64, 9, 64))
        o, lse = AK.attention_fwd(q, k, v)
        _, delta = AK.attention_bwd_dq(q, k, v, o, lse, do)
        by_batch.append({
            "B": B,
            "swa_attention_bwd_dq": C.graph_time_ms(
                lambda: AK.attention_bwd_dq(q, k, v, o, lse, do), 20),
            "swa_attention_bwd_dkdv": C.graph_time_ms(
                lambda: AK.attention_bwd_dkdv(q, k, v, lse, do, delta), 20)})
    print(json.dumps({"card": C.card_line(), "error": error,
                      "graph_ms_by_batch": by_batch}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
