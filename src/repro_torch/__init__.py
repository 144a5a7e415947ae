"""PyTorch/CUDA port of the sketch-based LPA reproduction (``repro``).

The package runs on an NVIDIA H100 through kernels written by hand in
CUDA (``csrc/``), and on the CPU through their plain-torch versions when
a caller asks for ``device="cpu"``. It imports torch and numpy only:
nothing of JAX and nothing of the ``repro`` package.
"""
