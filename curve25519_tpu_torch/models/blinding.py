"""Scalar blinding (counterpart of curve25519_tpu/models/blinding.py).

Instead of a*G the blinded routes compute (a + bl)*G + BP with bl = l - b,
BP = b*G, plus a randomized projective Z (zr). A context is a dict of
tensors on one device: "bl", "zr" ([20] int32 limbs), "zr_bytes" ([32]
uint8) and "bp" (PE point dict), plus the host-side ints "_b", "_zr_bytes"
and "_bp_point" that chain new contexts.

The static context is the port's copy of the build-time constants
(_custom_blind.py). Fresh contexts are derived from a seed, chained through
a parent context exactly like the JAX package's: digest = SHA512(parent.zr
|| seed), b = digest[:32] mod l, bl = l - b, zr = digest[32:], and BP = b*G
computed the protected way, (b + parent.bl)*G + parent.BP.

Contexts follow the device rule of ops/cuda: `device`, else the parent's,
else the card.
"""

import functools
import hashlib

import torch

from curve25519_tpu_torch import refmodel
from curve25519_tpu_torch.config import ED_2D, ELL, NLIMBS, P, int_to_limbs
from curve25519_tpu_torch.models import edwards
from curve25519_tpu_torch.ops import fe, fold, sc, sha512
from curve25519_tpu_torch.ops.cuda import as_bytes, pick_device
from curve25519_tpu_torch.utils import profiling

__all__ = ["blinding_init", "blinding_init_device", "blinding_finish",
           "static_blinding", "default_zr", "fresh_zr", "as_batch"]


def _limbs(v, device):
    return torch.as_tensor(int_to_limbs(v), device=device)


def _ctx_from_ints(bl_int, zr_bytes, bp_point, device):
    x, y = bp_point
    return {
        "bl": _limbs(bl_int, device),
        "zr": _limbs(int.from_bytes(zr_bytes, "little") % 2**255, device),
        "zr_bytes": torch.tensor(list(zr_bytes), dtype=torch.uint8,
                                 device=device),
        "bp": {"ypx": _limbs((y + x) % P, device),
               "ymx": _limbs((y - x) % P, device),
               "t2d": _limbs(ED_2D * x * y % P, device),
               "z2": _limbs(2, device)},
        # host-side values kept for chaining new contexts
        "_b": (ELL - bl_int) % ELL,
        "_zr_bytes": bytes(zr_bytes),
        "_bp_point": bp_point,
    }


def _ctx_device(parent, device):
    return pick_device(None if parent is None else parent["bl"],
                       device=device)


def static_blinding(device=None):
    """The build-time static blinding context."""
    from curve25519_tpu_torch import _custom_blind as cb
    return _ctx_from_ints(cb.BL, bytes(cb.ZR_BYTES), (cb.BP_X, cb.BP_Y),
                          pick_device(device=device))


def _bootstrap(device=None):
    """The bootstrap context that the custom tool chains the static context
    through: b = 0, zr_bytes = 0x42 x 32, BP = the identity."""
    return _ctx_from_ints(0, b"\x42" * 32, refmodel.IDENTITY,
                          pick_device(device=device))


def blinding_init(seed: bytes, parent=None, device=None):
    """Derive a fresh blinding context from a seed, chained through
    `parent` (default: the static context). Host-side big-int arithmetic;
    the tensors broadcast against any batch."""
    device = _ctx_device(parent, device)
    if parent is None:
        parent = static_blinding(device)
    digest = hashlib.sha512(parent["_zr_bytes"] + seed).digest()
    b = int.from_bytes(digest[:32], "little") % ELL
    # BP = b*G, computed via the protected path (b + parent.bl)*G + parent.BP
    t = (b + (ELL - parent["_b"])) % ELL
    bp_point = refmodel.ed_add(refmodel.base_mult(t), parent["_bp_point"])
    assert bp_point == refmodel.base_mult(b)
    return _ctx_from_ints((ELL - b) % ELL, digest[32:], bp_point, device)


def blinding_init_device(seed, parent=None, device=None):
    """The same derivation as plain torch ops on the device (SHA-512, mod-l
    arithmetic and the protected base multiply), so the fresh secrets never
    exist as Python ints. Returns a context of tensors (without the
    host-side chaining values)."""
    device = _ctx_device(parent, device)
    if parent is None:
        parent = static_blinding(device)
    seed = as_bytes(seed, "seed", None, device)
    msg = torch.cat([parent["zr_bytes"], seed], -1)[None, :]
    digest = sha512.sha512_plain(msg)[0]                      # [64] uint8
    b = sc.from_bytes(digest[:32])
    bl = sc.sub_from_ell(b)
    zr_bytes = digest[32:]
    zr = fe.from_bytes(torch.cat([zr_bytes[:31], zr_bytes[31:] & 0x7F]))

    t = sc.add(b, sc.mod(parent["bl"]))
    s = edwards.base_point_mult(fold.cut8_limbs(t)[None, :],
                                zr=parent["zr"][None, :])
    s = edwards.add_pe(s, {k: v[None, :] for k, v in parent["bp"].items()})
    x, y = edwards.to_affine(s)
    x, y = fe.canon(x[0]), fe.canon(y[0])
    bp = {"ypx": fe.canon(fe.add(y, x)),
          "ymx": fe.canon(fe.sub(y, x)),
          "t2d": fe.canon(fe.mul(fe.mul(x, y),
                                 fe.from_int(ED_2D, device=device))),
          "z2": fe.from_int(2, device=device).clone()}
    return {"bl": bl, "zr": zr, "zr_bytes": zr_bytes, "bp": bp}


def blinding_finish(ctx):
    """Destroy a context: zero its tensors in place and empty the dict, so
    stale references fail loudly instead of reusing a retired blinder."""
    for v in ctx.values():
        for t in (v.values() if isinstance(v, dict) else (v,)):
            if isinstance(t, torch.Tensor):
                t.zero_()
    ctx.clear()


@functools.lru_cache(maxsize=None)
@profiling.spanned("blinding.static_zr")
def _static_zr(device):
    return static_blinding(device)["zr"]


def default_zr(batch_shape=(), device=None):
    """The static context's Z-randomizer, broadcast to a batch: used when
    no blinding context is given (one public constant shared by every lane,
    as in the reference)."""
    zr = _static_zr(pick_device(device=device))
    return zr.expand(tuple(batch_shape) + (NLIMBS,))


def fresh_zr(generator, batch_shape=()):
    """Per-lane Z-randomizers [..., 20] from a torch.Generator, on the
    generator's device: independent 255-bit values with the low bit set
    (so never the all-zero encoding). Any nonzero zr leaves every output
    unchanged."""
    by = torch.randint(0, 256, tuple(batch_shape) + (32,), generator=generator,
                       device=generator.device, dtype=torch.int32)
    by[..., 31] &= 0x7F
    by[..., 0] |= 1
    return fe.from_bytes(by)


def as_batch(ctx, batch_shape):
    """A context's device tensors broadcast to a batch shape."""
    shape = tuple(batch_shape) + (NLIMBS,)
    return {"bl": ctx["bl"].expand(shape), "zr": ctx["zr"].expand(shape),
            "bp": {k: v.expand(shape) for k, v in ctx["bp"].items()}}
