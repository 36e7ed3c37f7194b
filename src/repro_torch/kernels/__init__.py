"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built for sm_90a) that
replace the reference's four Pallas kernels, each beside its plain PyTorch
version (``ref.py``); ``ops.py`` dispatches by device. Importing this package
builds nothing: a kernel's library is compiled at its first launch."""
