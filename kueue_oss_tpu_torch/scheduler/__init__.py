"""The host scheduler cycle of the port (copies of
``kueue_oss_tpu/scheduler``: the cycle, flavor assignment, preemption
and the streaming admitter)."""
