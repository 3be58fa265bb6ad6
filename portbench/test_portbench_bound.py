"""The frozen bound model (CPU only)."""

import pytest

from portbench import bound

B = 262_144


@pytest.mark.parametrize("ops, want_ms", [
    (bound.ladder_ops(), 1.808),            # create_shared_key, PERF.md
    (bound.basemult_ops(8), 0.510),         # fold-8 base multiply
    (bound.verify_ops(0), 2.447),           # one-shot verify's field work
])
def test_bound_matches_measured_rates(ops, want_ms):
    """At the frozen rates the model gives the bounds that the measured
    rates gave at B = 262,144, within 1%."""
    got = 1e3 * bound.seconds([(ops, B, 0)])
    assert abs(got - want_ms) <= 0.01 * want_ms, got


def test_bound_pipes_and_bytes():
    """More work never lowers the bound; bytes bound an empty call; SHA-512
    blocks count on the ALU pipe."""
    one = bound.seconds([(bound.ladder_ops(), B, 0)])
    assert bound.seconds([(bound.ladder_ops(), 2 * B, 0)]) > one
    assert bound.seconds([((bound.Counter(), 0), 0, 3.35e9)]) == \
        pytest.approx(1e-3)
    assert bound.seconds([((bound.Counter(), bound.SHA_BLOCK_ALU), B, 0)]) \
        == pytest.approx(B * bound.SHA_BLOCK_ALU / bound.ALU_PER_S)
    assert [bound.sha_blocks(n) for n in (0, 111, 112, 239, 240)] == \
        [1, 1, 2, 2, 3]
