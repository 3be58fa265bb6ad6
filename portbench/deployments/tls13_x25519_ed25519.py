"""A TLS 1.3 server's handshake batch through the port's public API.

Per handshake the inputs in host memory are the client's key share, the
server's ephemeral secret and the 130-byte CertificateVerify content (64 x
0x20, the context string, 0x00, the transcript hash); the outputs back in
host memory are the server's key share, the shared secret and the
signature. Host buffers are page-locked, as an offloading server registers
its handshake buffers. One server key serves every lane; its private key
stays on the card from set-up.
"""

import numpy as np
import torch

from portbench import bound, harness
from portbench.reference import curve


def content(config, transcript_hash):
    """[B, 130] CertificateVerify inputs (RFC 8446 4.4.3) around the
    transcript hashes [B, 32]."""
    context = config["certificate_verify_context"].encode()
    head = b"\x20" * config["certificate_verify_pad"] + context + b"\x00"
    out = np.empty((len(transcript_hash), config["content_bytes"]), np.uint8)
    out[:, :len(head)] = np.frombuffer(head, np.uint8)
    out[:, len(head):] = transcript_hash
    return out


# The API calls a batch makes, as (module, function): where the tests plant
# their faults.
API = (("curve25519_tpu_torch.models.x25519", "calculate_public_key_fast"),
       ("curve25519_tpu_torch.models.x25519", "create_shared_key"),
       ("curve25519_tpu_torch.models.ed25519", "sign"))


def make(config, traffic, seed):
    """The host-side inputs of `traffic["pool"]` distinct batches of
    `traffic["batch"]` handshakes from the seed, batch after batch, each
    lane drawn on its own."""
    n = traffic["batch"] * traffic["pool"]
    rng = np.random.default_rng([seed % 2**63, 0])

    def rows(width):
        return np.frombuffer(bytearray(rng.bytes(n * width)),
                             np.uint8).reshape(n, width)

    server_seed = rng.bytes(32)
    priv = server_seed + curve.public_key(server_seed)
    return {"lanes": {"client_share": rows(config["share_bytes"]),
                      "eph_sk": rows(32),
                      "content": content(config, rows(
                          config["transcript_hash_bytes"]))},
            "batch": traffic["batch"], "fixed": {"server_priv": priv},
            "strata": {"all": None}}


def setup(config, made, device):
    from curve25519_tpu_torch.models import ed25519, x25519
    priv = torch.frombuffer(bytearray(made["fixed"]["server_priv"]),
                            dtype=torch.uint8).to(device)
    n = made["batch"]
    out = harness.host_buffers({"share": ((32,), torch.uint8),
                                "secret": ((32,), torch.uint8),
                                "sig": ((64,), torch.uint8)}, n, device)
    return {"device": device, "priv": priv, "out": out,
            "ed25519": ed25519, "x25519": x25519}


def run_batch(state, lanes, span):
    dev = state["device"]
    with span("h2d"):
        client_share = lanes["client_share"].to(dev, non_blocking=True)
        eph_sk = lanes["eph_sk"].to(dev, non_blocking=True)
        msg = lanes["content"].to(dev, non_blocking=True)
    with span("api:calculate_public_key_fast"):
        share = state["x25519"].calculate_public_key_fast(eph_sk)
    with span("api:create_shared_key"):
        secret = state["x25519"].create_shared_key(client_share, eph_sk)
    with span("api:sign"):
        sig = state["ed25519"].sign(state["priv"], msg)
    with span("d2h"):
        return harness.fetch(state["out"], {"share": share, "secret": secret,
                                            "sig": sig})


def work(config, made):
    """The frozen work of each API call of a batch: [(ops a lane, lanes,
    bytes read and written)]."""
    n = made["batch"]
    m = config["content_bytes"]
    blocks = bound.sha_blocks(32 + m) + bound.sha_blocks(64 + m)
    return {"calculate_public_key_fast": [(bound.basemult_ops(8), n,
                                           n * (32 + 32))],
            "create_shared_key": [(bound.ladder_ops(), n, n * 96)],
            "sign": [(bound.sign_ops(blocks), n, 64 + n * (m + 64))]}
