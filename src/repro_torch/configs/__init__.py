"""Architecture configs the port runs. Importing this package populates the
registry: the paper's own model (``qwen36-35b-a3b``) and the shared-expert
MoE the reference tests pair it with (``qwen2-moe-a2.7b``)."""
from repro_torch.configs import qwen2_moe_a2_7b, qwen36_35b_a3b  # noqa: F401
from repro_torch.configs.reduced import reduce_for_smoke  # noqa: F401

PAPER_ARCH = "qwen36-35b-a3b"
