"""PyTorch / CUDA port of the ``repro`` serving path for NVIDIA Hopper.

The package mirrors ``repro``'s module names (``configs``, ``models``,
``kernels``, ``serve``, ``train``, ``obs``, ``ft``, ``checkpoint``,
``launch``, ``runtime``) so each module has an obvious counterpart.  It imports ``torch`` only: never ``jax`` and nothing of
``repro``.  The kernels under ``csrc/`` are CUDA C++ for ``sm_90a``,
built with ``nvcc`` at their first launch (``kernels/_build.py``); on a CPU
tensor every kernel wrapper runs its plain PyTorch version instead.

    from repro_torch.runtime import Runtime
    rt = Runtime.create("exanode-100m", capacity=2048)     # device="cuda"
    eng = rt.engine(num_slots=16)
"""
