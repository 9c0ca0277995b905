"""The benchmark of ``r2dm_tpu_torch``, the PyTorch and CUDA port of R2DM, on
an NVIDIA H100: ``python3 -m benchmark.run`` (see ``run.py``). It imports
nothing of JAX or of the JAX package, and its reference (``reference/``)
nothing of the port."""
