"""API object model of the port (see ``api/types.py``)."""

from kueue_oss_tpu_torch.api.types import *  # noqa: F401,F403
