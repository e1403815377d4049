"""Host utilities of the port (copies of ``kueue_oss_tpu/util``)."""
