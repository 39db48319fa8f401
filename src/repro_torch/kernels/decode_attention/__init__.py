from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_bshd,
    paged_decode_attention_bshd,
    quant_paged_decode_attention_bshd,
)
from repro_torch.kernels.decode_attention.paged import paged_decode_attention
from repro_torch.kernels.decode_attention.paged_quant import (
    quant_paged_decode_attention,
)
from repro_torch.kernels.decode_attention.quant import (
    dequantize_pages,
    quantize_pages,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    quant_paged_decode_attention_ref,
)

__all__ = [
    "decode_attention",
    "decode_attention_bshd",
    "decode_attention_ref",
    "dequantize_pages",
    "paged_decode_attention",
    "paged_decode_attention_bshd",
    "paged_decode_attention_ref",
    "quant_paged_decode_attention",
    "quant_paged_decode_attention_bshd",
    "quant_paged_decode_attention_ref",
    "quantize_pages",
]
