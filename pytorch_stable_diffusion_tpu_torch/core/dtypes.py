"""Dtype policy (port of ``pytorch_stable_diffusion_tpu/core/dtypes.py``).

bf16 weights and matmuls/convs; GroupNorm/LayerNorm statistics, attention
logits and softmax, the DDPM schedule math and the latents stay float32.
Parity tests pin FP32 everywhere.  ``MIXED`` keeps float32 weights and casts
each one to bf16 where a matmul, conv or kernel takes it, as the JAX
package's ``MIXED`` does: no bf16 copy of the weights is kept.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Per-role dtypes.

    param_dtype:   storage dtype of weights.
    compute_dtype: dtype fed to matmuls/convs.
    norm_dtype:    dtype of GroupNorm/LayerNorm statistics.
    softmax_dtype: dtype of attention logits/softmax.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32
    softmax_dtype: torch.dtype = torch.float32


#: fp32 everywhere — the parity path.
FP32 = Policy()

#: Production policy: bf16 weights and tensor-core matmuls, fp32 norms/softmax.
BF16 = Policy(
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    norm_dtype=torch.float32,
    softmax_dtype=torch.float32,
)

#: bf16 compute over fp32 master weights (cast at use).
MIXED = Policy(
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
    norm_dtype=torch.float32,
    softmax_dtype=torch.float32,
)
