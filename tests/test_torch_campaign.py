"""The port's chaos campaigns (kueue_oss_tpu_torch/chaos/campaign.py)
against the JAX package's.

Each of the four profiles (solver-storm, pod-loss, fed-partition,
kill-storm) runs at seeds 0 and 42 in both packages, at the campaign's
own shape (``CampaignSpec`` defaults, the kill-storm directory under
``tmp_path``): the ``CampaignResult.to_dict()`` records must be equal
apart from ``unavailable_wall_ms`` (the one host-clock reading), and so
must the ``solver_fallback_total`` deltas by reason the campaign left in
each package's registry. The port's planes drain on the CPU here
(``device="cpu"``). The tolerance is exact equality.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)

import pytest

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu import obs as jax_obs
from kueue_oss_tpu import resilience as jax_res
from kueue_oss_tpu.chaos import campaign as jax_campaign
from kueue_oss_tpu_torch import metrics as port_metrics
from kueue_oss_tpu_torch import obs as port_obs
from kueue_oss_tpu_torch import resilience as port_res
from kueue_oss_tpu_torch.chaos import campaign as port_campaign


@pytest.fixture(autouse=True)
def _fresh_slo_engines():
    """The drains here feed each package's process-wide SLO engine with
    their waits; reset both after each test, so no burn-rate alert they
    raised reaches a later test's health rollup on the same worker."""
    yield
    jax_obs.slo_engine.reset()
    port_obs.slo_engine.reset()


def _fallbacks(metrics) -> dict:
    return {k: v for k, v in metrics.solver_fallback_total.collect().items()}


def _run(campaign, metrics, profile, seed, tmp_path, **kw):
    before = _fallbacks(metrics)
    d = tmp_path / "durable" if profile == campaign.KILL_STORM else None
    res = campaign.run_campaign(
        profile, seed=seed, persistence_dir=str(d) if d else None, **kw)
    after = _fallbacks(metrics)
    delta = {k: after[k] - before.get(k, 0.0) for k in after
             if after[k] != before.get(k, 0.0)}
    rec = res.to_dict()
    rec.pop("unavailable_wall_ms")
    return rec, delta, res.ok


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("profile", list(jax_campaign.PROFILES))
def test_campaign_records_equal(profile, seed, tmp_path):
    jax = _run(jax_campaign, jax_metrics, profile, seed, tmp_path / "j")
    port = _run(port_campaign, port_metrics, profile, seed, tmp_path / "p",
                device="cpu")
    assert port[2], port  # the full oracle holds
    assert port[0]["transitions"].get(
        port_campaign.PROFILE_SUBSYSTEM[profile], 0) > 0
    assert port == jax


def test_campaign_vocabulary_and_spec_checks():
    assert port_campaign.PROFILES == jax_campaign.PROFILES
    assert port_campaign.PROFILE_SUBSYSTEM == jax_campaign.PROFILE_SUBSYSTEM
    assert port_res.SUBSYSTEMS == jax_res.SUBSYSTEMS
    for bad in ({"profile": "nope"},
                {"profile": "solver-storm", "n_workloads": 1000},
                {"profile": "kill-storm"}):
        with pytest.raises(ValueError) as jerr:
            jax_campaign.CampaignSpec(**bad)
        with pytest.raises(ValueError) as perr:
            port_campaign.CampaignSpec(**bad)
        assert str(perr.value) == str(jerr.value)
    # the lazy campaign names resolve through the chaos package
    from kueue_oss_tpu_torch import chaos

    assert chaos.run_campaign is port_campaign.run_campaign
    assert chaos.PROFILES == jax_campaign.PROFILES


def test_chip_smoke_campaign_pins_are_the_jax_records():
    """chip_smoke.py's phase 24 (a) holds the card to CAMPAIGN_REFERENCE,
    a copy of what tests/torch_campaign_pins.py prints: the JAX
    package's records and counter deltas at bench.py's seed 42 must be
    that copy, exactly."""
    import chip_smoke
    import torch_campaign_pins

    assert torch_campaign_pins.SEED == 42
    assert torch_campaign_pins.campaign_pins() == chip_smoke.CAMPAIGN_REFERENCE
