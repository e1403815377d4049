"""The port's Configuration loader (kueue_oss_tpu_torch/config) against
the JAX package's.

For documents covering every section, camelCase keys, unknown keys and
every invalid value ``validate`` checks, ``load`` must give a
``dataclasses.asdict`` equal to JAX's and ``validate`` the same messages
in the same order; ``apply_feature_gates`` must set the same gates and
``apply_resource_transformations`` give the same map on seeded
requests. The tolerance is exact equality throughout. ``solver.mesh``
and ``simulator.mesh`` load and validate as in JAX; the pod-scale
coordinator's fields raise in the port away from their defaults (ROADMAP
Queue A item 9b): their messages are held by tests of the raise. The
persistence switch loads in both, and ``PersistenceManager.from_config``
builds the same manager in both. Device telemetry, its capture and the SLO
alert webhook load in both. No test compiles anything in JAX.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import copy
import dataclasses

import numpy as np
import pytest

from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu.config import configuration as jax_cfg
from kueue_oss_tpu_torch import features as port_features
from kueue_oss_tpu_torch.config import configuration as port_cfg

FULL = {
    "namespace": "kueue-prod",
    "manageJobsWithoutQueueName": True,
    "managedJobsNamespaceSelector": {"team": "ml"},
    "waitForPodsReady": {
        "enable": True, "timeout": 120, "recoveryTimeout": 30,
        "blockAdmission": True,
        "requeuingStrategy": {"timestamp": "Creation",
                              "backoffLimitCount": 4,
                              "backoffBaseSeconds": 10,
                              "backoffMaxSeconds": 600,
                              "unknownKnob": 1}},
    "integrations": {"frameworks": ["batch/job", "jobset.x-k8s.io/jobset"],
                     "externalFrameworks": ["Foo.v1.example.com"]},
    "fairSharing": {"enable": True,
                    "preemptionStrategies": ["LessThanInitialShare"]},
    "admissionFairSharing": {"usageHalfLifeTime": 600,
                             "usageSamplingInterval": 5,
                             "resourceWeights": {"cpu": 1.0, "gpu": 4.0}},
    "resources": {
        "excludeResourcePrefixes": ["ephemeral-", "hugepages-"],
        "transformations": [
            {"input": "nvidia.com/mig-1g", "strategy": "Replace",
             "outputs": {"example.com/gpu-mem": 5.0}},
            {"input": "cpu", "outputs": {"example.com/credits": 0.5}}],
        "deviceClassMappings": {"gpu.nvidia.com": "nvidia.com/gpu"},
        "quotaCheckStrategy": "IgnoreUndeclared"},
    "objectRetentionPolicies": {"finishedWorkloadRetention": 3600,
                                "deactivatedWorkloadRetention": 7200},
    "multiKueue": {"gcInterval": 30, "origin": "hub-1",
                   "workerLostTimeout": 600, "dispatcherName": "WhatIf"},
    "solver": {"socketPath": "/run/kueue/solver.sock", "tenant": "cp-a",
               "maxSessions": 16, "timeout": 30, "maxRetries": 1,
               "retryBackoffBase": 0.1, "retryBackoffMax": 1,
               "maxFrameBytes": 1 << 20, "breakerFailureThreshold": 2,
               "breakerCooldown": 5, "sessionsEnabled": False,
               "mesh": "off", "relaxEnabled": False,
               "relaxMinWorkloads": 128, "relaxAuditEvery": 2,
               "relaxIters": 16, "relaxSupportThreshold": 0.25,
               "relaxRetryCooldown": 60},
    "federation": {"tenantWeights": {"cp-a": 2, "cp-b": 0.5},
                   "defaultWeight": 1.5, "quantum": 0.004, "maxQueued": 3,
                   "maxCreditQuanta": 2.5},
    "resilience": {"enabled": False, "historyLimit": 64,
                   "walRestoreCooldown": 12},
    "streaming": {"enabled": True, "maxBatch": 64, "maxCycleGap": 0.5,
                  "watchDriven": False},
    "simulator": {"maxScenarios": 64, "parityScenarios": 1,
                  "padPow2": False, "mesh": "off", "minBatchForMesh": 4,
                  "roundBucketing": False, "minBatchForBucketing": 2,
                  "fullKernel": True, "laneBudgetMB": 32,
                  "fullSweepMax": 8, "relaxIters": 12},
    "persistence": {"enabled": False, "dir": "/var/lib/kueue",
                    "fsync": "always", "batchRecords": 8,
                    "checkpointIntervalRecords": 100,
                    "checkpointInterval": 30, "keepCheckpoints": 3,
                    "auditInterval": 10, "auditAutoHeal": True,
                    "incrementalCheckpoints": True,
                    "fullCheckpointEvery": 4, "shipTo": "/mnt/standby",
                    "shipCompact": False},
    "observability": {
        "recorderEnabled": False, "ledgerEnabled": True,
        "ledgerMaxCycles": 128, "exemplars": False, "sloEnabled": True,
        "slo": {"queueWaitTarget": 0.95, "queueWaitThreshold": 60,
                "fastWindow": 120, "slowWindow": 1200,
                "burnRateThreshold": 3, "starvationThreshold": 900,
                "alertWebhookTimeout": 1},
        "devtel": {"enabled": False, "compileAccounting": False,
                   "transferLedger": True, "hbmWatermarks": False,
                   "captureEnabled": False, "captureDir": "/tmp/cap",
                   "captureMaxSeconds": 2, "captureCooldownSeconds": 30,
                   "captureUseProfiler": False}},
    "featureGates": {"TASDeviceFillCounts": True},
    "tls": {"minVersion": "VersionTLS13", "certFile": "/etc/tls/crt",
            "keyFile": "/etc/tls/key"},
    "someFutureField": {"ignored": True},
}

#: every invalid value validate checks that the port can load, each
#: away from its bound on the wrong side
INVALID = {
    "waitForPodsReady": {
        "enable": True, "timeout": 0,
        "requeuingStrategy": {"timestamp": "Whenever",
                              "backoffLimitCount": -1,
                              "backoffBaseSeconds": -5}},
    "resources": {"transformations": [
        {"input": "cpu", "strategy": "Merge"},
        {"input": "cpu", "strategy": "Retain"}]},
    "fairSharing": {"preemptionStrategies": ["LessThanInitialShare",
                                             "Greedy"]},
    "multiKueue": {"dispatcherName": "RoundRobin"},
    "solver": {"timeout": 0, "maxRetries": -1, "retryBackoffBase": -1,
               "retryBackoffMax": -1, "maxFrameBytes": 0,
               "breakerFailureThreshold": 0, "breakerCooldown": -1,
               "relaxMinWorkloads": -1, "relaxAuditEvery": -1,
               "relaxIters": 0, "relaxSupportThreshold": 1.0,
               "relaxRetryCooldown": -1, "maxSessions": 0,
               "mesh": "bogus"},
    "federation": {"defaultWeight": 0, "tenantWeights": {"cp-z": -1,
                                                         "cp-y": 1},
                   "quantum": 0, "maxQueued": 0, "maxCreditQuanta": 0},
    "resilience": {"historyLimit": 0, "walRestoreCooldown": -1},
    "simulator": {"maxScenarios": 0, "parityScenarios": -1,
                  "mesh": "bogus",
                  "minBatchForMesh": 0, "minBatchForBucketing": 0,
                  "laneBudgetMB": 0, "fullSweepMax": 0, "relaxIters": 0},
    "streaming": {"maxBatch": 0, "maxCycleGap": 0},
    "persistence": {"fullCheckpointEvery": 0,
                    "fsync": "sometimes", "batchRecords": 0,
                    "checkpointIntervalRecords": 0,
                    "checkpointInterval": -1, "keepCheckpoints": 0,
                    "auditInterval": -1},
    "observability": {
        "ledgerMaxCycles": 0,
        "slo": {"queueWaitTarget": 1.5, "queueWaitThreshold": 0,
                "fastWindow": 0, "slowWindow": -1, "burnRateThreshold": 0,
                "starvationThreshold": -1, "alertWebhookTimeout": 0},
        "devtel": {"captureMaxSeconds": 0, "captureCooldownSeconds": -1}},
    "admissionFairSharing": {"usageHalfLifeTime": -1,
                             "resourceWeights": {"cpu": -0.5}},
    "tls": {"minVersion": "VersionTLS10",
            "cipherSuites": ["TLS_NOT_A_REAL_SUITE"]},
}

DOCUMENTS = {
    "empty": {},
    "none": None,
    "full": FULL,
    "invalid": INVALID,
    "wfpr_disabled_not_checked": {"waitForPodsReady": {"timeout": -1}},
    "integrations_without_frameworks": {"integrations": {}},
    "tls_bad_version": {"tls": {"minVersion": "VersionTLS14"}},
    "tls_iana_suite": {"tls": {"cipherSuites": [
        "TLS_ECDHE_RSA_WITH_AES_128_GCM_SHA256", "TLS_AES_128_GCM_SHA256"]}},
    "slo_windows": {"observability": {"slo": {"fastWindow": 600,
                                              "slowWindow": 300}}},
    "relax_threshold_zero": {"solver": {"relaxSupportThreshold": 0.0}},
    "layers_switched_off": {"resilience": {"enabled": False},
                            "observability": {"recorderEnabled": False,
                                              "ledgerEnabled": False,
                                              "sloEnabled": False,
                                              "exemplars": False}},
    "unknown_keys_only": {"notAField": 1, "solver": {"notAKnob": 2},
                          "observability": {"slo": {"nope": 3}}},
}


def _both(doc):
    return (jax_cfg.load(copy.deepcopy(doc)),
            port_cfg.load(copy.deepcopy(doc)))


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_load_matches_jax(name):
    want, got = _both(DOCUMENTS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_validate_matches_jax(name):
    want, got = _both(DOCUMENTS[name])
    assert port_cfg.validate(got) == jax_cfg.validate(want)


def test_validate_sees_every_invalid_value():
    """The invalid document trips every check the port can load: one
    message per bad value, the JAX package's words. ``validate`` has 63
    checks; the three of the pod-scale coordinator and persistence's dir
    check (it needs persistence.enabled) cannot be loaded in the port."""
    errs = port_cfg.validate(port_cfg.load(copy.deepcopy(INVALID)))
    assert len(errs) == 63 - 3 - 1, errs
    assert errs[0] == "waitForPodsReady.timeout must be > 0"
    assert "federation.tenantWeights['cp-z'] must be > 0" in errs
    assert errs[-1].startswith("tls: invalid minVersion")
    assert port_cfg.validate(port_cfg.load(copy.deepcopy(FULL))) == []


def test_validate_skips_tls_with_the_gate_off():
    cfgs = _both({"tls": {"minVersion": "VersionTLS10"}})
    for features in (jax_features, port_features):
        features.set_gates({"TLSOptions": False})
    try:
        assert jax_cfg.validate(cfgs[0]) == port_cfg.validate(cfgs[1]) == []
    finally:
        jax_features.reset()
        port_features.reset()


@pytest.mark.parametrize("doc", [
    {"solver": {"mesh": "auto"}},
    {"solver": {"mesh": "4"}},
    {"solver": {"mesh": "bogus"}},
    {"solver": {"coordinatorAddress": "host:1234"}},
    {"solver": {"coordinatorProcesses": 0}},
    {"solver": {"coordinatorProcesses": 2}},
    {"solver": {"coordinatorProcessId": 3}},
    {"simulator": {"mesh": "auto"}},
    {"simulator": {"mesh": "8"}},
], ids=["solver_auto", "solver_count", "solver_bogus", "coord_addr",
        "coord_zero", "coord_two", "coord_id", "sim_auto", "sim_count"])
def test_multi_device_fields_raise_in_the_port(doc):
    """The JAX package loads these (and validates the bad ones). The
    port loads the mesh modes as JAX does (the single-process mesh arms,
    same ``asdict`` and messages) and refuses the pod-scale coordinator
    at load: the multi-process mesh is item 9b."""
    want = jax_cfg.load(copy.deepcopy(doc))
    if "mesh" in next(iter(doc.values())):
        got = port_cfg.load(copy.deepcopy(doc))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert port_cfg.validate(got) == jax_cfg.validate(want)
        return
    jax_cfg.validate(want)
    with pytest.raises(NotImplementedError, match="item 9b"):
        port_cfg.load(copy.deepcopy(doc))


@pytest.mark.parametrize("doc", [
    {"persistence": {"enabled": True, "dir": "/var/lib/kueue",
                     "fsync": "always"}},
    {"persistence": {"enabled": True}},
], ids=["persistence", "persistence_no_dir"])
def test_switches_the_port_cannot_honour_raise(doc, tmp_path):
    """The persistence switch loads in both packages with the same
    validation (a persistence without a dir is the one message), and on a
    copy whose dir is ``tmp_path`` ``PersistenceManager.from_config``
    gives a manager with the same settings in both. (The name is the
    test's from before the port had a persistence layer, when the port
    refused the switch.)"""
    from kueue_oss_tpu.persist import PersistenceManager as JaxManager
    from kueue_oss_tpu_torch.persist import PersistenceManager as PortManager

    want = jax_cfg.validate(jax_cfg.load(copy.deepcopy(doc)))
    if doc.get("persistence") == {"enabled": True}:
        assert want == ["persistence.dir is required when persistence "
                        "is enabled"]
    else:
        assert want == []
    port = port_cfg.load(copy.deepcopy(doc))
    assert port_cfg.validate(port) == want
    assert (dataclasses.asdict(port.persistence)
            == dataclasses.asdict(jax_cfg.load(copy.deepcopy(doc))
                                  .persistence))
    settings = ("fsync", "batch_records", "checkpoint_interval_records",
                "checkpoint_interval_seconds", "keep_checkpoints",
                "audit_interval_seconds", "audit_auto_heal", "incremental",
                "full_checkpoint_every", "persist_obs")
    got = {}
    for name, (cfg_mod, manager) in {"jax": (jax_cfg, JaxManager),
                                     "port": (port_cfg, PortManager)}.items():
        d = copy.deepcopy(doc)
        d["persistence"]["dir"] = str(tmp_path / name)
        m = manager.from_config(cfg_mod.load(d).persistence)
        got[name] = ({k: getattr(m, k) for k in settings},
                     m.wal.fsync, m.wal.batch_records, m.shipper is None)
        m.close()
    assert got["port"] == got["jax"]
    assert got["port"][0]["fsync"] == doc["persistence"].get(
        "fsync", "batch")


@pytest.mark.parametrize("doc", [
    {"observability": {"devtel": {"enabled": True}}},
    {"observability": {"devtel": {"captureEnabled": True}}},
    {"observability": {"slo": {
        "alertWebhookUrl": "https://alerts.example.com/hook"}}},
], ids=["devtel", "devtel_capture", "slo_webhook"])
def test_observability_switches_load_in_both(doc):
    """Device telemetry, its capture and the SLO alert webhook load in
    the port as in the JAX package (the port has the observability
    layer that honours them: ``obs.configure``)."""
    want, got = _both(doc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_cfg.validate(got) == jax_cfg.validate(want) == []


def test_solver_mesh_off_loads_in_both():
    want, got = _both({"solver": {"mesh": "off"},
                       "simulator": {"mesh": "off"}})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_cfg.validate(got) == jax_cfg.validate(want) == []


GATES = {"TASDeviceFillCounts": True, "PriorityBoost": True,
         "QuotaCheckStrategy": False, "TLSOptions": False,
         "PartialAdmission": False}


def test_apply_feature_gates_sets_the_same_gates():
    want, got = _both({"featureGates": GATES})
    try:
        jax_cfg.apply_feature_gates(want)
        port_cfg.apply_feature_gates(got)
        for name in GATES:
            assert port_features.enabled(name) == jax_features.enabled(name)
            assert port_features.enabled(name) == GATES[name]
        assert set(port_features.all_gates()) <= set(
            jax_features.all_gates())
    finally:
        jax_features.reset()
        port_features.reset()


def test_apply_feature_gates_without_gates_changes_nothing():
    want, got = _both({})
    before = port_features.all_gates()
    jax_cfg.apply_feature_gates(want)
    port_cfg.apply_feature_gates(got)
    assert port_features.all_gates() == before


def test_unknown_gate_raises_in_both():
    want, got = _both({"featureGates": {"NoSuchGate": True}})
    with pytest.raises(KeyError):
        jax_cfg.apply_feature_gates(want)
    with pytest.raises(port_features.UnknownFeatureGate):
        port_cfg.apply_feature_gates(got)


RESOURCES = ["cpu", "memory", "nvidia.com/gpu", "nvidia.com/mig-1g",
             "ephemeral-storage", "hugepages-2Mi", "example.com/credits",
             "example.com/gpu-mem"]


def _random_resources_doc(rng) -> dict:
    inputs = rng.choice(RESOURCES, size=int(rng.integers(0, 4)),
                        replace=False)
    return {"resources": {
        "excludeResourcePrefixes": [p for p in ("ephemeral-", "hugepages-",
                                                "nvidia.com/mig")
                                    if rng.random() < 0.4],
        "transformations": [
            {"input": str(r),
             "strategy": ["Retain", "Replace"][int(rng.integers(0, 2))],
             "outputs": {str(o): float(rng.choice([0.5, 1.0, 2.5, 1 / 3]))
                         for o in rng.choice(RESOURCES, size=int(
                             rng.integers(0, 3)), replace=False)}}
            for r in inputs]}}


@pytest.mark.parametrize("seed", range(6))
def test_apply_resource_transformations_matches_jax(seed):
    rng = np.random.default_rng(seed)
    want, got = _both(_random_resources_doc(rng))
    for _ in range(40):
        names = rng.choice(RESOURCES, size=int(rng.integers(0, 6)),
                           replace=False)
        requests = {str(r): int(rng.integers(0, 100_000)) for r in names}
        out = port_cfg.apply_resource_transformations(dict(requests),
                                                      got.resources)
        assert out == jax_cfg.apply_resource_transformations(
            dict(requests), want.resources)
        assert list(out) == list(jax_cfg.apply_resource_transformations(
            dict(requests), want.resources))
