"""Dream Lab on PyTorch and CUDA: the port of ``dreamlab_tpu`` to one NVIDIA H100.

Module names mirror the JAX package (``models``, ``ops``, ``scheduler``,
``utils``, ``engine``, ``pipeline``), so each counterpart is easy to find.
The port imports ``torch`` and numpy and nothing of JAX or ``dreamlab_tpu``:
it keeps its own copies of the pure-Python pieces it needs.

The kernels the JAX package wrote in Pallas for the TPU are hand-written CUDA
here (``csrc/``, built by ``ops/_build.py``). Entry points run on the card
unless the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead.
"""
