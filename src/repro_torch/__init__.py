"""repro_torch — the PyTorch and CUDA port of the ``repro`` package.

A package of its own beside the JAX reference: it imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.  The host logic that
the JAX package keeps free of JAX (configs, telemetry, the AMU runtime,
paging, the serving policy) is copied here; the tensor code is rewritten
on PyTorch, and the TPU kernels on the serving path are hand-written
CUDA for Hopper (``kernels/csrc``).

It serves the dense ``phi4-mini-3.8b`` and the MoE ``olmoe-1b-7b``
decoders through the paged, chunked-prefill engine
(:mod:`repro_torch.serve`).  Entry points place their tensors on
``cuda`` unless the caller passes ``device="cpu"``.
"""
