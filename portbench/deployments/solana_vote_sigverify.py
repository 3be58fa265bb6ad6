"""A Solana validator's vote sigverify stage through the port's public API:
the staked identities' verify context made once at set-up
(ed25519.verify_init of the epoch's staked keys), then one
ed25519.verify_cached(ctx, sig, pk, msg, msg_len) call per batch of votes.
The votes' messages come in a padded [B, 330] uint8 host array with a
length each, their signatures and their signers' public keys beside them,
handed to the call in host memory, as a sigverify stage hands its packet
buffers to the library, which copies them in; the verdicts come back to
host memory. The host buffers are page-locked, as in the other cells.
"""

import importlib

import numpy as np
import torch

from portbench import bound, harness
from portbench.reference import solana_sigverify as ref

QT_BYTES = 16 * 160                     # a key's q_table, int8 planes

# The API calls a batch makes, as (module, function): where the tests plant
# their faults.
API = (("curve25519_tpu_torch.models.ed25519", "verify_cached"),)


def make(config, traffic, seed):
    """`traffic["pool"]` distinct batches of `traffic["batch"]` signed votes
    from the seed, batch after batch, and the staked keys (`fixed`). In
    every batch of every seed the same set of message lengths, n //
    miss_one_in votes signed by keys outside the staked set (in turn) and n
    // invalid_one_in corrupted votes, in another order and with other
    bytes; the staked keys sign the other votes in turn, in a seeded order.
    The program's call is looked up first, so a program without it fails
    before any input is made."""
    for module, name in API:
        getattr(importlib.import_module(module), name)
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
    staked = ref.keys([rng.bytes(32) for _ in range(config["staked_keys"])])
    outside = ref.keys([rng.bytes(32)
                        for _ in range(config["unstaked_keys"])])
    signer = np.empty(total, np.int64)
    miss = []
    for p in range(pool):
        lanes = rng.permutation(n)
        cut = n // config["miss_one_in"]
        miss.append(p * n + np.sort(lanes[:cut]))
        hit = p * n + lanes[cut:]
        signer[hit] = (np.arange(len(hit)) % len(staked))[
            rng.permutation(len(hit))]
        signer[miss[-1]] = len(staked) + np.arange(cut) % len(outside)
    miss = np.concatenate(miss)
    r0 = int.from_bytes(rng.bytes(32), "little") % (ref.curve.L - total)
    sig = ref.sign_packets(staked + outside, signer, msg, msg_len, r0)
    keys = np.stack([np.frombuffer(key, np.uint8)
                     for _, key in staked + outside])
    pk = keys[signer]

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
            "batch": n, "fixed": {"staked": keys[:len(staked)]},
            "strata": {"all": None, "invalid": bad, "miss": miss}}


def setup(config, made, device):
    """The staked keys' verify context, made once on the device, and the
    page-locked verdict buffer."""
    from curve25519_tpu_torch.models import ed25519
    staked = torch.from_numpy(made["fixed"]["staked"]).to(device)
    out = harness.host_buffers({"verdict": ((), torch.bool)},
                               made["batch"], device)
    return {"ctx": ed25519.verify_init(staked),
            "strict": config["strict"], "out": out, "ed25519": ed25519}


def run_batch(state, lanes, span):
    """One verify_cached call on the batch's page-locked host lanes, which
    the call copies in (in two parts, the second part's copy under the
    first part's kernels), and the verdicts fetched."""
    with span("api:verify_cached"):
        verdict = state["ed25519"].verify_cached(
            state["ctx"], lanes["sig"], lanes["pk"], lanes["msg"],
            lanes["msg_len"], strict=state["strict"])
    with span("d2h"):
        return harness.fetch(state["out"], {"verdict": verdict})


def work(config, made):
    """The frozen work of the verify_cached call of a batch (every batch
    holds the same lengths; the misses are the first batch's): per SHA-512
    block count of R || A || M, the double-scalar multiply and the hash's
    blocks over the lanes of staked signers, and one-shot verification over
    the others; the bytes are the signatures, keys, live message bytes and
    lengths read, the verdicts written, and the staked keys' q_tables read
    once."""
    n = made["batch"]
    msg_len = made["lanes"]["msg_len"][:n]
    blocks = bound.sha_blocks(64 + msg_len.astype(np.int64))
    miss = np.zeros(n, bool)
    miss[made["strata"]["miss"][made["strata"]["miss"] < n]] = True
    field, _ = bound.poly_ops()
    nbytes = int(msg_len.sum()) + n * (64 + 32 + 4 + 1) \
        + len(made["fixed"]["staked"]) * QT_BYTES
    hits = np.bincount(blocks[~miss])
    misses = np.bincount(blocks[miss])
    return {"verify_cached": [((field, int(b) * bound.SHA_BLOCK_ALU), int(c),
                               0) for b, c in enumerate(hits) if c]
            + [(bound.verify_ops(int(b)), int(c), 0)
               for b, c in enumerate(misses) if c]
            + [((bound.Counter(), 0), 0, nbytes)]}
