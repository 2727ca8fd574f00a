"""PyTorch/CUDA port of the VIKIN reproduction (``src/repro``).

The layout mirrors the JAX package module for module, so each file here
has one counterpart there.  The JAX package stays the reference: the
port imports nothing of it (not even its JAX-free modules) and is held
against it by the ``tests/test_torch_*.py`` parity tests.

Kernels dispatch on the device of their input: a CPU tensor runs the
plain PyTorch version (``kernels/*/ref.py``), a CUDA tensor launches the
hand-written ``sm_90a`` kernel (``kernels/*/csrc/*.cu``) or raises.  The
entry points (``runtime.backends.VikinBackend``, ``launch.serve``)
default to ``device="cuda"`` and refuse to run when CUDA is missing
unless the caller asks for ``"cpu"``.
"""
