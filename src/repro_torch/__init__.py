"""PyTorch/CUDA port of the ``repro`` gradient-compression system.

The JAX package ``repro`` is the reference; this package mirrors its
module names and layout so each counterpart is easy to find.  It imports
``torch`` and ``numpy`` only.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise instead of
falling back.
"""
