"""An API gateway's EdDSA bearer-token check (RFC 8037) through the port's
public API: the issuer key's verify context made once at set-up
(ed25519.verify_init), then one ed25519.verify_check(ctx, sig, msg,
msg_len, strict=True) call per batch of tokens. The JWS signing inputs
(RFC 7515 5.2) come in a padded [B, 1000] uint8 host array with a length
each, the 64-byte signatures beside them, already split off and decoded by
the JOSE layer on the host; the verdicts come back to host memory. The
host buffers are page-locked, as in the other cells.
"""

import numpy as np
import torch

from portbench import bound, harness
from portbench.reference import curve
from portbench.reference import solana_sigverify as signer

B64URL = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                       b"0123456789-_", np.uint8)
# where the '.' between header and payload may fall: after 36 characters
# (the base64url of {"alg":"EdDSA","typ":"JWT"}) to 100 (a header with a kid)
HEADER_CHARS = (36, 100)
QT_BYTES = 16 * 160                     # the context's q_table, int8 planes

# The API calls a batch makes, as (module, function): where the tests plant
# their faults.
API = (("curve25519_tpu_torch.models.ed25519", "verify_check"),)


def make(config, traffic, seed):
    """`traffic["pool"]` distinct batches of `traffic["batch"]` tokens signed
    by one issuer key from the seed, batch after batch. Every batch of every
    seed holds the same set of signing-input lengths and, where its size is a
    multiple of 64, the same number of invalid tokens of each kind, in
    another order and with other bytes."""
    n, pool = traffic["batch"], traffic["pool"]
    total = n * pool
    rng = np.random.default_rng([seed % 2**63, 0])
    width = config["max_message_bytes"]
    lo = config["min_message_bytes"]
    lengths = (lo + np.arange(n) * (width - lo + 1) // n).astype(np.int32)
    msg_len = np.concatenate([lengths[rng.permutation(n)]
                              for _ in range(pool)])
    msg = B64URL[rng.integers(0, len(B64URL), (total, width), np.uint8)]
    msg[np.arange(total), rng.integers(HEADER_CHARS[0], HEADER_CHARS[1] + 1,
                                       total)] = ord(".")
    keys = signer.keys([rng.bytes(32)])
    r0 = int.from_bytes(rng.bytes(32), "little") % (curve.L - total)
    sig = signer.sign_packets(keys, np.zeros(total, np.int64), msg, msg_len,
                              r0)

    per_batch = n // config["invalid_one_in"]
    bad = [p * n + np.sort(rng.permutation(n)[:per_batch])
           for p in range(pool)]
    for lanes in bad:
        _corrupt(rng, sig, msg, msg_len, lanes)
    return {"lanes": {"sig": sig, "msg": msg, "msg_len": msg_len},
            "batch": n, "fixed": {"pk": keys[0][1]},
            "strata": {"all": None, "invalid": np.concatenate(bad),
                       "malleated": np.concatenate([b[3::4] for b in bad])}}


def _corrupt(rng, sig, msg, msg_len, lanes):
    """Make the tokens of `lanes` invalid in turn, four kinds in equal
    shares: a flipped bit of R, of S or of the signing input, and S
    replaced by S + L (lanes[3::4])."""
    for j, lane in enumerate(lanes):
        kind = j % 4
        if kind == 3:                         # S + L: the malleated S
            s = int.from_bytes(sig[lane, 32:].tobytes(), "little") + curve.L
            sig[lane, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
        elif kind == 2:                       # a bit of the signing input
            pos = rng.integers(0, msg_len[lane])
            msg[lane, pos] ^= np.uint8(1 << rng.integers(0, 8))
        else:                                 # a bit of R or of S
            bit = rng.integers(0, 256)
            sig[lane, 32 * kind + bit // 8] ^= np.uint8(1 << (bit % 8))


def setup(config, made, device):
    """The issuer key's verify context, made once on the device, and the
    page-locked verdict buffer."""
    from curve25519_tpu_torch.models import ed25519
    pk = torch.frombuffer(bytearray(made["fixed"]["pk"]),
                          dtype=torch.uint8).to(device)
    out = harness.host_buffers({"verdict": ((), torch.bool)},
                               made["batch"], device)
    return {"device": device, "ctx": ed25519.verify_init(pk),
            "strict": config["strict"], "out": out, "ed25519": ed25519}


def run_batch(state, lanes, span):
    dev = state["device"]
    with span("h2d"):
        sig = lanes["sig"].to(dev, non_blocking=True)
        msg = lanes["msg"].to(dev, non_blocking=True)
        msg_len = lanes["msg_len"].to(dev, non_blocking=True)
    with span("api:verify_check"):
        verdict = state["ed25519"].verify_check(state["ctx"], sig, msg,
                                                msg_len,
                                                strict=state["strict"])
    with span("d2h"):
        return harness.fetch(state["out"], {"verdict": verdict})


def work(config, made):
    """The frozen work of the verify_check call of a batch (every batch
    holds the same lengths): per SHA-512 block count of R || A || M, the
    double-scalar multiply and the hash's blocks over the lanes that need
    them; the bytes are the signatures, live message bytes and lengths read,
    the verdicts written, and the q_table read once."""
    msg_len = made["lanes"]["msg_len"][:made["batch"]]
    blocks = bound.sha_blocks(64 + msg_len.astype(np.int64))
    field, _ = bound.poly_ops()
    nbytes = int(msg_len.sum()) + len(msg_len) * (64 + 4 + 1) + QT_BYTES
    return {"verify_check": [((field, int(b) * bound.SHA_BLOCK_ALU), int(c),
                              0)
                             for b, c in enumerate(np.bincount(blocks)) if c]
            + [((bound.Counter(), 0), 0, nbytes)]}
