"""The plain reference of a Solana vote batch's signature verification:
RFC 8032 under each vote's own key, on Python integers and hashlib
(reference/curve.py). Whether the key is staked changes nothing here: the
cache of staked keys is the program's, and a vote's verdict is a packet's
(reference/solana_sigverify.judge)."""

from portbench.reference import solana_sigverify


def judge(config, made, lanes, outputs):
    """{"verdict_mismatch": (lanes whose verdict differs from RFC 8032
    verification, 0)} over the sampled canonical `lanes`."""
    return solana_sigverify.judge(config, made, lanes, outputs)
