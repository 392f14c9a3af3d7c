"""The port's LRU-like / FIFO-like classification against ``repro.core``.

``repro_torch.core.classify`` is a numpy copy of the reference module, so
on every network of ``POLICY_BUILDERS`` (and Prob-LRU at both of Table 1's q,
LRU at the paper's fast disk and with a bounded I/O depth) the two rules must give the reference's answer, and the paper's tables
must be the reference's tables.
"""

import pytest

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core import classify as tclassify

NETWORKS = [(policy, {}) for policy in sorted(tcore.POLICY_BUILDERS)]
NETWORKS += [("prob_lru", dict(q=1 - 1 / 72)), ("lru", dict(disk_us=5.0)),
             ("lru", dict(disk_us=500.0, disk_servers=8))]


@pytest.mark.parametrize("policy,kw", NETWORKS,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(NETWORKS)])
def test_rules_equal_the_reference(policy, kw):
    t_net, j_net = tcore.build(policy, **kw), jcore.build(policy, **kw)
    assert tcore.classify_structural(t_net) == \
        jcore.classify_structural(j_net)
    assert tcore.classify_by_throughput(t_net) == \
        jcore.classify_by_throughput(j_net)


def test_table1_is_reproduced():
    nets = {"lru": tcore.build("lru"), "fifo": tcore.build("fifo"),
            "prob_lru(q=0.5)": tcore.prob_lru_network(q=0.5),
            "prob_lru(q=0.986)": tcore.prob_lru_network(q=1 - 1 / 72),
            "clock": tcore.build("clock"), "slru": tcore.build("slru"),
            "s3fifo": tcore.build("s3fifo")}
    for name, net in nets.items():
        assert tcore.classify_by_throughput(net) == tcore.TABLE1[name][1]


def test_tables_equal_the_reference():
    from repro.core import classify as jclassify

    assert tclassify.TABLE1 == jclassify.TABLE1
    assert tclassify.TABLE2_CONJECTURE == jclassify.TABLE2_CONJECTURE
    assert tclassify.REASONS == jclassify.REASONS
    assert (tclassify.LRU_LIKE, tclassify.FIFO_LIKE) == \
        (jclassify.LRU_LIKE, jclassify.FIFO_LIKE)
    assert set(tcore.__all__) == set(jcore.__all__)
