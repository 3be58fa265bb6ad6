"""The plain reference of an EdDSA JWT gateway's token check: RFC 8032
5.1.7 verification of the signing input under the issuer key, S < L
enforced, on Python integers and hashlib (reference/curve.py)."""

from portbench.reference import curve


def judge(config, made, lanes, outputs):
    """{"verdict_mismatch": (lanes whose verdict differs from strict RFC 8032
    verification, 0)} over the sampled canonical `lanes`."""
    pk = made["fixed"]["pk"]
    inputs = made["lanes"]
    bad = 0
    for row, lane in enumerate(lanes):
        want = curve.verify(inputs["sig"][lane].tobytes(), pk,
                            inputs["msg"][lane, :inputs["msg_len"][lane]]
                            .tobytes(), strict=True)
        bad += bool(outputs["verdict"][row]) != want
    return {"verdict_mismatch": (bad, 0)}
