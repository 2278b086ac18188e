"""tpu3dlm_torch — the PyTorch/CUDA port of tpu3dlm for NVIDIA Hopper.

Module paths mirror the JAX package (``tpu3dlm/``), which stays the
reference: ``tpu3dlm_torch/mapper/nms3d.py`` ports ``tpu3dlm/mapper/nms3d.py``
and so on. The port imports torch and numpy only — never jax, flax or
anything under ``tpu3dlm`` — so it runs on a GPU host that has neither.

Hand-written kernels live in ``csrc/`` (CUDA C++ for ``sm_90a``), are built
at first use by ``kernels/build.py`` and are called through wrappers in
``ops/kernels/``. Every wrapper launches its kernel for CUDA tensors and
runs its plain PyTorch twin only for CPU tensors. Host C++ is built the same
way by the system C++ compiler: the image codecs (``csrc/host/codecs.cpp``
and ``containers.cpp``, behind ``data/codecs.py`` and
``data/containers.py``), because the GPU host has no cv2, and the map
stage's DBSCAN and meshing legs (``csrc/host/dbscan.cpp`` and
``meshing.cpp``, copies of the JAX package's, behind ``native.py``).

Entry points (``python -m tpu3dlm_torch.cli``, ``pipeline.task.Pipeline``,
``pipeline.fused.FusedScanRunner``, ``parallel.inference.full_scan_step``,
``mapper.nms3d.suppress_bboxes``, ``alignment.align.Alignment``,
``alignment.comparison.BBoxComparison``, ``mapper.mapping.Mapping``,
``mapper.meshing.mesh_scan``, ``mapper.poisson.mesh_poisson``) run on
``device="cuda"`` unless the caller asks for ``device="cpu"``; see
``device.resolve_device``.
"""

from tpu3dlm_torch.device import resolve_device

__all__ = ["resolve_device"]
