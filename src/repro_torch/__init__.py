"""PyTorch / CUDA port of the rotary expert-residency system.

A second package beside the JAX reference (``src/repro``), written for an
NVIDIA H100. It imports ``torch`` and numpy and nothing of the JAX package;
its layout mirrors the reference module by module (``config``, ``configs``,
``models``, ``kernels``, ``core``, ``obs``, ``launch``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the four Pallas kernels
of the reference are hand-written CUDA kernels for ``sm_90a`` under
``kernels/csrc``, each beside its plain PyTorch version.
"""
