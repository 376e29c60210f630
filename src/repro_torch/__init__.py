"""PyTorch/CUDA port of the CHIMERA serving reproduction (``repro``).

Same layout as the JAX package (``configs/``, ``core/``, ``data/``,
``kernels/``, ``launch/``, ``models/``, ``optim/``, ``serve/``,
``train/``) so every module has an obvious counterpart; the
JAX package stays the reference and this package never imports it (nor
``jax``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written Hopper kernel.

Serving: ``serve.LLMEngine`` on the paged, arena and slot backends for
every family. Training on one device: ``train.trainer.Trainer``.
"""
