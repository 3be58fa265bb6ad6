"""A Solana validator's sigverify stage through the port's public API: one
ed25519.verify call per packet batch, the packets' messages in a padded
[B, 1167] uint8 host array with a length each, their signatures and their
signers' public keys beside them; the verdicts come back to host memory.
The host buffers are page-locked, as Agave keeps its packet batches
(perf's PinnedVec, registered with the CUDA runtime for its GPU sigverify).
"""

import numpy as np
import torch

from portbench import bound, harness
from portbench.reference import solana_sigverify as ref


# The API calls a batch makes, as (module, function): where the tests plant
# their faults.
API = (("curve25519_tpu_torch.models.ed25519", "verify"),)


def make(config, traffic, seed):
    """`traffic["pool"]` distinct batches of `traffic["batch"]` signed
    packets from the seed, batch after batch. Every batch of every seed
    holds the same set of message lengths and the same number of corrupted
    packets, in another order and with other bytes; the keys of the pool
    sign in turn, in a seeded order."""
    n, pool = traffic["batch"], traffic["pool"]
    total = n * pool
    rng = np.random.default_rng([seed % 2**63, 0])
    width = config["max_message_bytes"]
    lo = config["min_message_bytes"]
    lengths = (lo + np.arange(n) * (width - lo + 1) // n).astype(np.int32)
    msg_len = np.concatenate([lengths[rng.permutation(n)]
                              for _ in range(pool)])
    msg = np.frombuffer(rng.bytes(total * width), np.uint8) \
        .reshape(total, width).copy()
    keys = ref.keys([rng.bytes(32) for _ in range(config["key_pool"])])
    signer = (np.arange(total) % len(keys))[rng.permutation(total)]
    r0 = int.from_bytes(rng.bytes(32), "little") % (ref.curve.L - total)
    sig = ref.sign_packets(keys, signer, msg, msg_len, r0)
    pk = np.stack([np.frombuffer(key, np.uint8) for _, key in keys])[signer]

    bad = np.concatenate([
        p * n + np.sort(rng.permutation(n)[:n // config["invalid_one_in"]])
        for p in range(pool)])
    for j, lane in enumerate(bad):
        kind = j % 3
        if kind == 2:                         # a bit of the message
            pos = rng.integers(0, msg_len[lane])
            msg[lane, pos] ^= np.uint8(1 << rng.integers(0, 8))
        else:                                 # a bit of R or of S
            bit = rng.integers(0, 256)
            sig[lane, 32 * kind + bit // 8] ^= np.uint8(1 << (bit % 8))
    return {"lanes": {"sig": sig, "pk": pk, "msg": msg, "msg_len": msg_len},
            "batch": n, "fixed": {}, "strata": {"all": None, "invalid": bad}}


def setup(config, made, device):
    from curve25519_tpu_torch.models import ed25519
    out = harness.host_buffers({"verdict": ((), torch.bool)},
                               made["batch"], device)
    return {"device": device, "strict": config["strict"], "out": out,
            "ed25519": ed25519}


def run_batch(state, lanes, span):
    dev = state["device"]
    with span("h2d"):
        sig = lanes["sig"].to(dev, non_blocking=True)
        pk = lanes["pk"].to(dev, non_blocking=True)
        msg = lanes["msg"].to(dev, non_blocking=True)
        msg_len = lanes["msg_len"].to(dev, non_blocking=True)
    with span("api:verify"):
        verdict = state["ed25519"].verify(sig, pk, msg, msg_len,
                                          strict=state["strict"])
    with span("d2h"):
        return harness.fetch(state["out"], {"verdict": verdict})


def work(config, made):
    """The frozen work of the verify call of a batch (every batch holds the
    same lengths): per SHA-512 block count of R || A || M, the lanes that
    need it; the bytes are the
    signatures, keys, live message bytes and lengths read and the verdicts
    written."""
    msg_len = made["lanes"]["msg_len"][:made["batch"]]
    blocks = bound.sha_blocks(64 + msg_len.astype(np.int64))
    counts = np.bincount(blocks)
    nbytes = int(msg_len.sum()) + len(msg_len) * (64 + 32 + 4 + 1)
    return {"verify": [(bound.verify_ops(int(b)), int(c), 0)
                       for b, c in enumerate(counts) if c]
            + [((bound.Counter(), 0), 0, nbytes)]}
