"""PyTorch/CUDA port of the CORE storage reproduction (the JAX package
``repro`` is the reference). Subpackages mirror ``repro`` module for
module; entry points run on the card unless the caller passes
``device="cpu"``."""
