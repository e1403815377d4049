"""kueue_oss_tpu_torch — the PyTorch/CUDA port of kueue_oss_tpu.

The port runs the solver drain of the job-queueing and admission
controller on an NVIDIA GPU: the pending backlog is exported to dense
int32 tensors, every admission round of the whole backlog runs on the
device, and admitted topology-aware (TAS) workloads are placed by the
sequential device placer, one CUDA kernel launch for the whole batch
(``solver/cuda_tas.py``, ``csrc/tas_place.cu``; the leaf-pass kernel
``csrc/leaf_states.cu`` shares its row arithmetic and runs the host
TAS placement's fill-in counts under the TASDeviceFillCounts gate).

The system's entry point is the host scheduler (``scheduler/``):
``Scheduler(solver="auto")`` drains a flood on the device, re-checks
every plan entry with the C++ verify oracle (``native/``) and admits the
rest in host cycles; with ``streaming`` it admits arrivals between full
drains (``micro_drain``, ``serve``; a large burst as one lean drain on
the device). The package keeps its own copies of the host layer it
needs (API types, store, queue manager, quota forest, TAS domain tree
and placement, scheduler, streaming admitter) and mirrors the JAX
package's layout (``api/``, ``config/``, ``core/``, ``tas/``,
``solver/``, ``scheduler/``, ``native/``, ``util/``).
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
