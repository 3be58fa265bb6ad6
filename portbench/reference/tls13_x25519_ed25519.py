"""The plain reference of a TLS 1.3 handshake batch: RFC 7748 X25519 and
RFC 8032 Ed25519 on Python integers (reference/curve.py)."""

from portbench.reference import curve


def judge(config, made, lanes, outputs):
    """{check: (mismatched lanes, limit)} over the sampled canonical
    `lanes`, whose outputs are `outputs` (share, secret and sig rows)."""
    priv = made["fixed"]["server_priv"]
    a, prefix = curve.secret_scalar(priv[:32])
    pk = curve.encode(curve.base_mult(a))
    inputs = made["lanes"]
    bad = {"share_mismatch": 0, "secret_mismatch": 0, "sig_mismatch": 0}
    for row, lane in enumerate(lanes):
        sk = inputs["eph_sk"][lane].tobytes()
        bad["share_mismatch"] += (outputs["share"][row].tobytes()
                                  != curve.x25519_base(sk))
        bad["secret_mismatch"] += (outputs["secret"][row].tobytes()
                                   != curve.x25519(sk, inputs["client_share"]
                                                   [lane].tobytes()))
        bad["sig_mismatch"] += (outputs["sig"][row].tobytes()
                                != curve.sign_with(a, prefix, pk, inputs[
                                    "content"][lane].tobytes()))
    return {k: (v, 0) for k, v in bad.items()}
