"""Architecture configs the port runs. Importing this package populates the
registry: the paper's own model (``qwen36-35b-a3b``), the reference's two
other KV-cache MoE archs (``qwen2-moe-a2.7b``, ``dbrx-132b``) and its six
dense ``attn_mlp`` stacks, two of them with a stubbed modality frontend
(``pixtral-12b``, ``musicgen-large``), and its two recurrent archs
(``recurrentgemma-2b``: RG-LRU + local attention; ``xlstm-350m``: mLSTM /
sLSTM, no attention)."""
from repro_torch.configs import (  # noqa: F401
    dbrx_132b,
    musicgen_large,
    phi3_mini_3_8b,
    pixtral_12b,
    qwen2_moe_a2_7b,
    qwen3_4b,
    qwen36_35b_a3b,
    recurrentgemma_2b,
    starcoder2_3b,
    starcoder2_7b,
    xlstm_350m,
)
from repro_torch.configs.reduced import reduce_for_smoke  # noqa: F401

PAPER_ARCH = "qwen36-35b-a3b"
DENSE_ARCHS = ("qwen3-4b", "phi3-mini-3.8b", "starcoder2-3b", "starcoder2-7b", "pixtral-12b",
               "musicgen-large")
MOE_ARCHS = ("qwen36-35b-a3b", "qwen2-moe-a2.7b", "dbrx-132b")
RECURRENT_ARCHS = ("recurrentgemma-2b", "xlstm-350m")
ALL_ARCHS = MOE_ARCHS + DENSE_ARCHS + RECURRENT_ARCHS
