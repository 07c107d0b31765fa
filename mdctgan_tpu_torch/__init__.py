"""mdctgan_tpu_torch — the PyTorch/CUDA port of the mdctGAN serving chain.

The JAX package ``mdctgan_tpu`` is the reference; this package mirrors its
layout module for module (``ops/``, ``models/``, ``train/``, ``data/``,
``api.py``) in PyTorch idiom: NCHW ``nn.Module``s, plain functions on
tensors, an explicit ``device`` argument and explicit ``torch.Generator``s.

The two Pallas kernels of the reference (``mdctgan_tpu/ops/pallas_mdct.py``)
are hand-written CUDA C++ kernels for Hopper (``csrc/``), built with ``nvcc``
at first use (``ops/_build.py``) and launched through ``ops/mdct_kernels.py``.
Entry points default to ``device="cuda"`` and raise when CUDA is absent; only
an explicit ``device="cpu"`` runs on the CPU, through each kernel's plain
PyTorch version.

Importing this package builds nothing and imports neither ``jax`` nor the
reference package.
"""

__version__ = "0.1.0"
