"""Profiling and tracing for the port (``debugger/profiling.py``: the
``Tracer``, ``Profiler``, ``SamplingProfiler``, ``DebugServer`` and
``attach_to_scheduler``). The JAX package's cache and queue ``Dumper``
(``kueue_oss_tpu/debugger/__init__.py``) is not ported: no path of the
port reads it."""
