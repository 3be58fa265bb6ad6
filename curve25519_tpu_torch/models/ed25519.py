"""Ed25519 keygen, sign and verify, batched (counterpart of
curve25519_tpu/models/ed25519.py).

Keys, messages and signatures carry leading batch axes; messages are
fixed-shape padded byte tensors with per-message lengths. The device rule
of ops/cuda applies: a tensor keeps its device, anything else goes to
`device=` or to the card.

On a CUDA device, `create_keypair` is one launch of the fused keygen kernel
and `sign` one launch of the fused sign kernel for messages within
max_fused_msg_len (943 bytes); longer messages take the composition of the
SHA-512 and base-multiply kernels. `verify_init` is one launch of the
Verify_Init kernel, `verify_check` two (SHA-512 for h, then the poly kernel
with a q_table per lane, or the shared one for an unbatched context) and
`verify` two (SHA-512, then the one-shot kernel). `sign_ragged` and
`verify_ragged` take a list of messages of any lengths and make one such
call per SHA-512 block count (utils/bucketing.py); `verify_ragged` runs
`verify_init` once for the whole batch, or not at all given a context. On
the CPU all of them run their plain versions. A blinding context
(models/blinding.py) changes no output byte.

Verification semantics (those of the JAX package, frozen by
tests/test_edge_encodings.py): a y >= p decodes as y - p; x = 0 with the
sign bit set is accepted; small-order and identity keys are accepted; S >= l
is accepted unless strict=True; R' is compared with R as encodings.
"""

import torch

from curve25519_tpu_torch.config import ED_2D, ED_BX, ED_BY, P
from curve25519_tpu_torch.models import edwards
from curve25519_tpu_torch.models.blinding import default_zr
from curve25519_tpu_torch.models.edwards import calculate_x, unpack_point
from curve25519_tpu_torch.ops import codec, fe, fold, sc, sha512
from curve25519_tpu_torch.ops.cuda import (
    as_bytes, pick_device, sign_kernel, verify_kernel,
)
from curve25519_tpu_torch.utils import bucketing

__all__ = ["create_keypair", "sign", "verify", "verify_init", "verify_check",
           "verify_tablefree", "verify_finish", "sign_ragged", "verify_ragged",
           "calculate_x", "unpack_point"]


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


def _msg_len(msg_len, msg, dev):
    """msg_len as an int32 tensor on dev (default: every message whole)."""
    if msg_len is None:
        return torch.full(msg.shape[:-1], msg.shape[-1], dtype=torch.int32,
                          device=dev)
    if isinstance(msg_len, torch.Tensor) and msg_len.device != dev:
        raise ValueError("msg_len is on %s, the keys on %s"
                         % (msg_len.device, dev))
    return torch.as_tensor(msg_len, dtype=torch.int32, device=dev)


def sign(priv, msg, msg_len=None, blinding=None, device=None):
    """64-byte signatures (R, S): priv [..., 64] (sk || pk), msg [..., L]
    uint8, msg_len [...] int32 live bytes (default L)."""
    dev = pick_device(priv, msg, msg_len, device=device)
    priv = as_bytes(priv, "priv", 64, dev)
    msg = as_bytes(msg, "msg", None, dev)
    dev = priv.device
    L = msg.shape[-1]
    msg_len = _msg_len(msg_len, msg, dev)
    zr, bl, bp = _blinding_args(blinding, dev)
    route = (sign_kernel.sign_fused if sign_kernel.max_fused_msg_len(L)
             else sign_kernel.sign_composed)
    return route(priv, msg, msg_len, zr=zr, bl=bl, bp=bp)


# ---------------------------------------------------------------------------
# Verify: a per-key context (Verify_Init) and the per-message check
# ---------------------------------------------------------------------------
def verify_init(pk, device=None):
    """The per-key context {pk, planes, ok} of public keys pk [..., 32]:
    the q_table of -Q as int8 planes [..., 16, 160] (the JAX package's,
    byte for byte) and whether each key decoded (reference
    ed25519_Verify_Init)."""
    pk = as_bytes(pk, "pk", 32, pick_device(pk, device=device))
    planes, ok = verify_kernel.verify_init(pk)
    return {"pk": pk, "planes": planes, "ok": ok}


def _inputs(pk, sig, msg, msg_len):
    """(sig, msg, msg_len, batch) on pk's device, msg broadcast to the
    batch of the three."""
    sig = as_bytes(sig, "sig", 64, pk.device)
    msg = as_bytes(msg, "msg", None, pk.device)
    batch = torch.broadcast_shapes(msg.shape[:-1], sig.shape[:-1],
                                   pk.shape[:-1])
    msg = msg.expand(batch + msg.shape[-1:])
    return sig, msg, _msg_len(msg_len, msg, pk.device), batch


def _digits(sig, pk, msg, msg_len, batch):
    """The fold digits (u of S, v of h = SHA512(R || pk || m) mod l)."""
    prefix = torch.cat([sig[..., :32].expand(batch + (32,)),
                        pk.expand(batch + (32,))], -1)
    h = sc.from_digest(sha512.sha512(msg, msg_len, prefix=prefix))
    return (fold.cut8_bytes(sig[..., 32:]).expand(batch + (32,)),
            fold.cut4_limbs(h))


def _verdict(r_bytes, ok, sig, strict):
    """R' == R as encodings, the key decoded, and with strict S < l."""
    result = (r_bytes == sig[..., :32]).all(-1) & ok
    if strict:
        s = sig[..., 32:]
        result = result & (sc.to_bytes(sc.from_bytes(s)) == s).all(-1)
    return result


def verify_check(ctx, sig, msg, msg_len=None, strict=False):
    """Per-message phase against a context from verify_init: [...] bool
    (reference ed25519_Verify_Check). An unbatched context (one key) serves
    every message through one shared q_table."""
    pk = ctx["pk"]
    sig, msg, msg_len, batch = _inputs(pk, sig, msg, msg_len)
    u, v = _digits(sig, pk, msg, msg_len, batch)
    planes = ctx["planes"]
    if planes.ndim != 2:
        planes = planes.expand(batch + planes.shape[-2:])
    return _verdict(verify_kernel.poly_mult(u, v, planes), ctx["ok"], sig,
                    strict)


def verify(sig, pk, msg, msg_len=None, strict=False, device=None):
    """One-shot verify: [...] bool (reference ed25519_VerifySignature). On
    a card, SHA-512 and the one-shot kernel; on the CPU the two plain
    phases. One key over many messages is cheaper as verify_init once and
    verify_check."""
    pk = as_bytes(pk, "pk", 32, pick_device(pk, sig, msg, msg_len,
                                            device=device))
    sig, msg, msg_len, batch = _inputs(pk, sig, msg, msg_len)
    u, v = _digits(sig, pk, msg, msg_len, batch)
    r_bytes, ok = verify_kernel.verify_oneshot(pk.expand(batch + (32,)), u, v)
    return _verdict(r_bytes, ok, sig, strict)


def verify_tablefree(sig, pk, msg, msg_len=None, strict=False, device=None):
    """Table-free verification oracle in plain PyTorch on every device: R' by
    MSB-first double-and-add over the bits of S and h, with G built from the
    curve constants and no folding table or q_table (reference
    alt_ed25519_VerifySignature). strict as in verify_check."""
    pk = as_bytes(pk, "pk", 32, pick_device(pk, sig, msg, msg_len,
                                            device=device))
    sig, msg, msg_len, batch = _inputs(pk, sig, msg, msg_len)
    dev = pk.device
    hmsg = torch.cat([sig[..., :32].expand(batch + (32,)),
                      pk.expand(batch + (32,)), msg], -1)
    h = sc.from_digest(sha512.sha512_plain(hmsg, 64 + msg_len))
    q, ok = unpack_point(pk.expand(batch + (32,)), negate=True)
    q_pe = edwards.to_pe(q)
    g_pa = {"ypx": fe.from_int((ED_BY + ED_BX) % P, batch, dev),
            "ymx": fe.from_int((ED_BY - ED_BX) % P, batch, dev),
            "t2d": fe.from_int(ED_2D * ED_BX * ED_BY % P, batch, dev)}
    s_bits = codec.scalar_bits(sig[..., 32:]).expand(batch + (256,))
    h_bits = codec.scalar_bits(sc.to_bytes(h))
    st = edwards.identity_ext(batch, dev)
    for i in range(255, -1, -1):
        st = edwards.double(st)
        st = _select_point(s_bits[..., i], edwards.add_pa(st, g_pa), st)
        st = _select_point(h_bits[..., i], edwards.add_pe(st, q_pe), st)
    r_bytes = edwards.pack(*edwards.to_affine(st))
    return _verdict(r_bytes, ok, sig, strict)


def _select_point(mask, a, b):
    return {k: fe.select(mask, a[k], b[k]) for k in a}


# ---------------------------------------------------------------------------
# Ragged batches: one fixed-shape call per SHA-512 block count
# ---------------------------------------------------------------------------
def sign_ragged(priv, msgs, blinding=None, device=None):
    """Signatures [N, 64] of a list of N messages of any lengths, in input
    order: priv [N, 64] or one [64] key for all."""
    priv = as_bytes(priv, "priv", 64, pick_device(priv, device=device))
    return bucketing.apply_bucketed(
        lambda m, l, p: sign(p, m, l, blinding=blinding), msgs,
        priv.expand(len(msgs), 64))


def verify_ragged(sig, pk, msgs, strict=False, ctx=None, device=None):
    """Verdicts [N] of signatures sig [N, 64] over a list of N messages of
    any lengths, in input order: pk [N, 32], or one [32] key for all.
    verify_init runs exactly once for the whole batch, or not at all when
    `ctx` (from verify_init; pk is then not read) is given. A rank-1 pk or
    an unbatched ctx serves every bucket through one shared q_table."""
    if ctx is None:
        ctx = verify_init(pk, device=device)
    sig = as_bytes(sig, "sig", 64, ctx["pk"].device).expand(len(msgs), 64)
    if ctx["planes"].ndim == 2:
        return bucketing.apply_bucketed(
            lambda m, l, s: verify_check(ctx, s, m, l, strict=strict), msgs,
            sig)
    return bucketing.apply_bucketed(
        lambda m, l, s, pk, planes, ok: verify_check(
            {"pk": pk, "planes": planes, "ok": ok}, s, m, l, strict=strict),
        msgs, sig, ctx["pk"], ctx["planes"], ctx["ok"])


def verify_finish(ctx):
    """Release a verify context (reference ed25519_Verify_Finish): drops its
    tensors, so their device memory goes back to the allocator once no one
    else holds them. The caller's pk stays the caller's."""
    for k in [k for k in ctx if k != "pk"]:
        del ctx[k]
