"""kueue_oss_tpu_torch — the PyTorch/CUDA port of kueue_oss_tpu.

The port runs the solver drain of the job-queueing and admission
controller on an NVIDIA GPU: the pending backlog is exported to dense
int32 tensors, every admission round of the whole backlog runs on the
device, and admitted topology-aware (TAS) workloads are placed by the
sequential device placer, one CUDA kernel launch for the whole batch
(``solver/cuda_tas.py``, ``csrc/tas_place.cu``; the standalone leaf-pass
kernel ``csrc/leaf_states.cu`` shares its row arithmetic).

The package keeps its own copies of the host layer it needs (API types,
store, queue manager, quota forest, TAS domain tree) and mirrors the
JAX package's layout (``api/``, ``core/``, ``tas/``, ``solver/``).
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
