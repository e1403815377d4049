"""Framework configuration of the port (a copy of part of
``kueue_oss_tpu/config``)."""

from kueue_oss_tpu_torch.config.configuration import StreamingConfig

__all__ = ["StreamingConfig"]
