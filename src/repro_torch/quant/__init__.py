"""Grouped weight quantization for the rotating slot link (Q4_K_M analog).

The counterpart of ``repro/quant``: every rotation ships expert weights
host -> card, so every byte saved is a byte the link does not carry. Experts
pack as grouped 4-bit integers, two nibbles per byte, with a per-group f16
scale and min over the reduction axis.

Bytes per weight element (what one expert costs on the link):

  ============  =====================  ==========  ============
  format        layout                 bytes/elem  vs bf16
  ============  =====================  ==========  ============
  bf16          dense                  2.0         1.00x
  int8          + f32 scale [F]        ~1.0        ~0.50x
  int4 grouped  2 nibbles/byte + f16   0.5 + 4/G   0.281x (G=64)
                scale+min per group
  ============  =====================  ==========  ============
"""
from repro_torch.quant.int4 import (  # noqa: F401
    GROUP_SIZE_DEFAULT,
    bytes_per_element,
    dequantize_int4,
    effective_group,
    int4_tensor_bytes,
    quantize_int4,
    quantize_int4_batch,
    unpack_int4,
)
