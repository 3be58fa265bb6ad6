"""Ed25519 keygen and sign, batched (counterpart of
curve25519_tpu/models/ed25519.py; verify comes with a later slice).

Keys, messages and signatures carry leading batch axes; messages are
fixed-shape padded byte tensors with per-message lengths. The device rule
of ops/cuda applies: a tensor keeps its device, anything else goes to
`device=` or to the card.

On a CUDA device, `create_keypair` is one launch of the fused keygen kernel
and `sign` one launch of the fused sign kernel for messages within
max_fused_msg_len (943 bytes); longer messages take the composition of the
SHA-512 and base-multiply kernels. On the CPU all of them run their plain
versions. A blinding context (models/blinding.py) changes no output byte.
"""

import torch

from curve25519_tpu_torch.models.blinding import default_zr
from curve25519_tpu_torch.ops.cuda import as_bytes, pick_device, sign_kernel

__all__ = ["create_keypair", "sign"]


def _blinding_args(blinding, device):
    """(zr, bl, bp) for the kernels: the static zr without a context."""
    if blinding is None:
        return default_zr(device=device), None, None
    tensors = [blinding["zr"], blinding["bl"], *blinding["bp"].values()]
    if any(t.device != device for t in tensors):
        raise ValueError("the blinding context is on %s, the keys on %s"
                         % (tensors[0].device, device))
    return blinding["zr"], blinding["bl"], blinding["bp"]


def create_keypair(sk, blinding=None, device=None):
    """(pubkey [..., 32], privkey [..., 64] = sk || pk) from 32-byte secret
    seeds."""
    sk = as_bytes(sk, "sk", 32, pick_device(sk, device=device))
    zr, bl, bp = _blinding_args(blinding, sk.device)
    pk = sign_kernel.keygen(sk, zr=zr, bl=bl, bp=bp)
    return pk, torch.cat([sk, pk], -1)


def sign(priv, msg, msg_len=None, blinding=None, device=None):
    """64-byte signatures (R, S): priv [..., 64] (sk || pk), msg [..., L]
    uint8, msg_len [...] int32 live bytes (default L)."""
    dev = pick_device(priv, msg, msg_len, device=device)
    priv = as_bytes(priv, "priv", 64, dev)
    msg = as_bytes(msg, "msg", None, dev)
    dev = priv.device
    L = msg.shape[-1]
    if msg_len is None:
        msg_len = torch.full(msg.shape[:-1], L, dtype=torch.int32, device=dev)
    elif isinstance(msg_len, torch.Tensor) and msg_len.device != dev:
        raise ValueError("msg_len is on %s, the keys on %s"
                         % (msg_len.device, dev))
    msg_len = torch.as_tensor(msg_len, dtype=torch.int32, device=dev)
    zr, bl, bp = _blinding_args(blinding, dev)
    route = (sign_kernel.sign_fused if sign_kernel.max_fused_msg_len(L)
             else sign_kernel.sign_composed)
    return route(priv, msg, msg_len, zr=zr, bl=bl, bp=bp)
