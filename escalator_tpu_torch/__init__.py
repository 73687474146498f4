"""escalator-tpu on PyTorch and CUDA: the batched scale decision on an NVIDIA GPU.

A port of ``escalator_tpu`` (the JAX package, which stays the reference). It
imports ``torch`` and ``numpy`` and nothing of the JAX package: what it needs
from there is copied here, under the same relative paths.

- ``escalator_tpu_torch.device``     — the one place that picks the device and
  states the dtype policy
- ``escalator_tpu_torch.k8s``        — the slice of the k8s object model the
  packer reads
- ``escalator_tpu_torch.core``       — decision types and the numpy packer
- ``escalator_tpu_torch.ops``        — the decide on tensors, and the CUDA
  segment-sum kernel it runs on the card (``ops/csrc/segsum.cu``)
- ``escalator_tpu_torch.controller`` — ``TorchBackend``, the ``ComputeBackend``
  the controller calls once per tick
- ``escalator_tpu_torch.interop``    — carries packed arrays and decisions
  across from and to numpy
"""
