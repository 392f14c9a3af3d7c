"""The port's ``obs/provenance.py`` against the reference's
``repro.obs.provenance``: the config hash, the payload checks, the
lineage diff and the CLI's exit codes are the reference's on the same
payloads, and a payload the port stamps passes the reference's check.
What a stamp records is the port's: torch and CUDA versions, no jax."""

import json

import pytest
import torch

from repro.obs import provenance as jprov
from repro_torch.obs import provenance as tprov

CONFIGS = [
    {},
    {"n": 1, "p": [0.5, 0.9]},
    {"p": [0.5, 0.9], "n": 1},
    {"n": 2, "p": [0.5, 0.9]},
    {"net": "lru", "disk_us": 100.0, "seeds": (0, 1, 2), "obj": object},
    [1, "two", None, 3.5],
]


def _payloads():
    """Payloads the checks see: stamped by the port, stamped by the
    reference, and broken in each way the checks look for."""
    good = tprov.stamp({"replay": {"x": 1.0}, "failures": {}},
                       config={"n": 16_000}, seeds=(0, 1, 2), device="cpu")
    ref = jprov.stamp({"replay": {"x": 1.0}, "failures": {}},
                      config={"n": 16_000}, seeds=(0, 1, 2))
    bad_list = dict(good, failures=["fig3_lru"])
    bad_tb = dict(good, failures={"fig3_lru": ""})
    no_prov = {"replay": {}}
    empty = tprov.stamp({"failures": {}}, config={}, device="cpu")
    wrong = dict(good, provenance=dict(good["provenance"], schema="v0"))
    short = dict(good, provenance={"schema": tprov.SCHEMA_VERSION})
    return [good, ref, bad_list, bad_tb, no_prov, empty, wrong, short]


def test_schema_and_keys_are_the_references():
    assert tprov.SCHEMA_VERSION == jprov.SCHEMA_VERSION
    assert tprov.META_KEYS == jprov.META_KEYS
    assert tprov.REQUIRED_PROVENANCE_KEYS == jprov.REQUIRED_PROVENANCE_KEYS


@pytest.mark.parametrize("config", CONFIGS)
def test_config_hash_is_the_references(config):
    assert tprov.config_hash(config) == jprov.config_hash(config)


def test_payload_checks_are_the_references():
    for payload in _payloads():
        assert tprov.validate_payload(payload) == jprov.validate_payload(
            payload)
        assert tprov.series_keys(payload) == jprov.series_keys(payload)
    assert tprov.validate_payload(_payloads()[0]) == []


def test_a_port_stamp_passes_the_reference_check():
    payload = tprov.stamp({"latency": {"p99_us": 12.5}}, config={"n": 1},
                          seeds=(0,), timings={"wall_s": 1.5}, device="cpu")
    assert jprov.validate_payload(payload) == []
    json.dumps(payload)  # a stamp is plain JSON


def test_lineage_diff_is_the_references():
    ps = _payloads()
    for old in ps:
        for new in ps:
            assert tprov.lineage_diff(old, new) == jprov.lineage_diff(old,
                                                                      new)


def test_cli_exit_codes_are_the_references(tmp_path):
    ok = tmp_path / "BENCH_a.json"
    ok.write_text(json.dumps(_payloads()[0]))
    guard = tmp_path / "expected.json"
    guard.write_text(json.dumps({"*": ["replay", "latency"]}))
    lost = tmp_path / "BENCH_b.json"
    lost.write_text(json.dumps(tprov.stamp({"failures": {}, "latency": {}},
                                           device="cpu")))
    bad = tmp_path / "BENCH_c.json"
    bad.write_text(json.dumps({"replay": {}}))
    for argv in (["check", str(ok)], ["check", str(ok), "--expect", str(guard)],
                 ["check", str(bad)], ["diff", str(ok), str(lost)],
                 ["diff", str(ok), str(ok)], ["diff", str(lost), str(ok)]):
        assert tprov.main(argv) == jprov.main(argv), argv
    assert tprov.main(["check", str(ok)]) == 0
    assert tprov.main(["diff", str(ok), str(lost)]) == 1


def test_collect_records_the_port():
    prov = tprov.collect(config={"n": 1}, seeds=(3,), device="cpu")
    assert not any("jax" in k for k in prov)
    assert not any("jax" in k for k in prov["versions"])
    assert prov["backend"] == "cpu" and "device" not in prov
    assert prov["versions"]["torch"] == torch.__version__
    assert prov["versions"]["cuda"] == torch.version.cuda
    assert prov["seeds"] == [3]
    assert prov["config_sha256"] == jprov.config_hash({"n": 1})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprov.collect()


def test_card_reads_nvidia_smi(monkeypatch):
    monkeypatch.setattr(tprov, "_run", lambda cmd, cwd=None:
                        "NVIDIA H100 80GB HBM3, 700.00 W\nsecond card, 1 W")
    assert tprov.card() == {"name": "NVIDIA H100 80GB HBM3",
                            "power_limit": "700.00 W"}
    monkeypatch.setattr(tprov, "_run", lambda cmd, cwd=None: None)
    assert tprov.card() == {"name": "unknown", "power_limit": "unknown"}
