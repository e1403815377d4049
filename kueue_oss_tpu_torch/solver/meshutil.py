"""Mesh arithmetic the single-device port already needs.

A copy of ``align_pad_target`` from ``kueue_oss_tpu/solver/meshutil.py``
(:251-265): pure arithmetic, which the engine uses to align its padded
workload axis to a remote sidecar's advertised mesh width. The rest of
the module (mesh detection, the sharded arms, the distributed bootstrap)
is the multi-device port, ROADMAP Queue A item 9.
"""

from __future__ import annotations

import math


def align_pad_target(target_w: int, mesh_devices: int = 0,
                     extra_width: int = 0) -> int:
    """Grow a pad target so the padded axis (``target_w`` + the null
    row) splits evenly over a mesh of ``mesh_devices`` devices, and over
    ``extra_width`` when given (a remote sidecar's advertised mesh; lcm
    covers both). The same widths always give the same alignment, so
    session slot coordinates stay stable across drains."""
    widths = [w for w in (int(mesh_devices), int(extra_width)) if w > 1]
    if not widths:
        return target_w
    m = math.lcm(*widths)
    return target_w + (-(target_w + 1)) % m
