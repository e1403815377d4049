"""Federation layer of the port: the multi-tenant solver farm and the
fleet helpers (a copy of ``kueue_oss_tpu/federation``).

- ``federation.farm`` — the weighted deficit-round-robin request
  scheduler a shared ("farm") solver sidecar runs, arbitrating solver
  wall-time across N tenant control planes (attach with
  ``attach_farm(server)``); per-tenant session namespacing itself
  lives in solver/service.py (sessions keyed ``(tenant, sid)``);
- ``federation.fleet`` — helpers building N complete control planes
  against one farm socket, plus the ``plan_fingerprint`` bit-identity
  surface the parity tests assert;
- the what-if-scored dispatcher lives with its siblings in
  ``multikueue/dispatcher.py``.
"""

from kueue_oss_tpu_torch.federation.farm import FarmScheduler, attach_farm
from kueue_oss_tpu_torch.federation.fleet import (
    FederationMember,
    build_fleet,
    build_member,
    plan_fingerprint,
)

__all__ = [
    "FarmScheduler",
    "attach_farm",
    "FederationMember",
    "build_fleet",
    "build_member",
    "plan_fingerprint",
]
