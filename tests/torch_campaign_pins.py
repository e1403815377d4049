"""The JAX package's pins of chip_smoke.py's phase 24 (a): the four
chaos campaigns at ``seed=42`` (bench.py's ``chaoscampaign`` seed) at
the campaign's own shape.

For each profile: its ``CampaignResult.to_dict()`` without
``unavailable_wall_ms``, and the ``solver_fallback_total`` deltas by
reason and the ``solver_relax_drains_total`` deltas by outcome the run
left in the metrics registry. Run ``JAX_PLATFORMS=cpu python
tests/torch_campaign_pins.py`` to print them as JSON (a few seconds on
the CPU). tests/test_torch_campaign.py holds the port to the JAX package
at seeds 0 and 42 on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 42


def _deltas(counter, before: dict) -> dict:
    after = counter.collect()
    return {"/".join(k): after[k] - before.get(k, 0.0) for k in sorted(after)
            if after[k] != before.get(k, 0.0)}


def campaign_pins(seed: int = SEED) -> dict:
    from kueue_oss_tpu import metrics
    from kueue_oss_tpu.chaos import campaign

    out = {}
    for profile in campaign.PROFILES:
        fb = metrics.solver_fallback_total.collect()
        rx = metrics.solver_relax_drains_total.collect()
        with tempfile.TemporaryDirectory() as d:
            res = campaign.run_campaign(
                profile, seed=seed,
                persistence_dir=(d if profile == campaign.KILL_STORM
                                 else None))
        rec = res.to_dict()
        rec.pop("unavailable_wall_ms")
        out[profile] = {
            "record": rec,
            "fallback": _deltas(metrics.solver_fallback_total, fb),
            "relax_drains": _deltas(metrics.solver_relax_drains_total, rx)}
    return out


if __name__ == "__main__":
    print(json.dumps(campaign_pins(), sort_keys=True))
