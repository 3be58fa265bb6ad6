"""Build-time customization CLI of the port (counterpart of
curve25519_tpu/tools/custom_tool.py; the reference's custom_tool).

Subcommands:
    b             regenerate the port's static blinding context
                  (curve25519_tpu_torch/_custom_blind.py).
                  tests/test_torch_ed25519.py holds it equal to the JAX
                  package's copy, so regenerate both from one seed.
    r NAME [N]    print N hardened random bytes as a Python constant
    t [SEED] MSG  make an Ed25519 keygen/sign/verify test vector and check
                  it on every route: the Python-integer model, the port on
                  its device and the port's host core

The port's routes run on the card (a failed build or launch raises).

Usage: python -m curve25519_tpu_torch.tools.custom_tool {b|r|t} [...]
"""

import hashlib
import sys
from pathlib import Path

from curve25519_tpu_torch.config import ELL
from curve25519_tpu_torch.utils.rng import get_random_bytes

_BLIND_PATH = Path(__file__).resolve().parent.parent / "_custom_blind.py"


def create_blinding_source(seed: bytes, device=None) -> str:
    """The static-blinder module text of a seed, chained through the
    bootstrap context (reference CreateBlindingContext)."""
    from curve25519_tpu_torch.models import blinding
    ctx = blinding.blinding_init(seed, parent=blinding._bootstrap(device))
    x, y = ctx["_bp_point"]
    return (
        '"""Static build-time blinding context. GENERATED - do not edit.\n\n'
        "Regenerate with: python -m curve25519_tpu_torch.tools.custom_tool b\n"
        '(reference analogue: source/custom_blind.h, rebuilt every make)"""\n\n'
        f"BL = {(ELL - ctx['_b']) % ELL}\n"
        f"ZR_BYTES = {list(ctx['_zr_bytes'])}\n"
        f"BP_X = {x}\n"
        f"BP_Y = {y}\n"
    )


def cmd_blind(device=None):
    _BLIND_PATH.write_text(create_blinding_source(get_random_bytes(64),
                                                  device))
    print(f"wrote {_BLIND_PATH}")


def cmd_random(name, n=32):
    print(f"{name} = {list(get_random_bytes(n))}")


def cmd_testvector(seed: bytes, msg: bytes, device=None):
    """Make a sign test vector with the Python-integer model and check it
    on the port's device route (keygen and sign give the same bytes, verify
    accepts) and on the host core. Returns 1 if any route disagrees."""
    import torch

    from curve25519_tpu_torch import refmodel
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.native import bindings
    from curve25519_tpu_torch.ops.cuda import pick_device

    sk = hashlib.sha512(seed).digest()[:32]
    pk, priv = refmodel.ed_keypair(sk)
    sig = refmodel.ed_sign(priv, msg)
    checks = {"refmodel": refmodel.ed_verify(sig, pk, msg)}

    dev = pick_device(device=device)

    def t(b):
        return torch.tensor(list(b), dtype=torch.uint8, device=dev)

    def b(x):
        return bytes(x.reshape(-1).cpu().tolist())

    pk_t, priv_t = ed25519.create_keypair(t(sk))
    checks["torch-keygen"] = b(pk_t) == pk and b(priv_t) == priv
    checks["torch-sign"] = b(ed25519.sign(priv_t, t(msg))) == sig
    checks["torch-verify"] = bool(ed25519.verify(t(sig), pk_t, t(msg)).item())

    checks["native-keygen"] = bindings.ed25519_keypair(sk) == (pk, priv)
    checks["native-sign"] = bindings.ed25519_sign(priv, msg) == sig
    checks["native-verify"] = bindings.ed25519_verify(sig, pk, msg)

    print(f"device = {dev}")
    print(f"sk  = {sk.hex()}")
    print(f"pk  = {pk.hex()}")
    print(f"msg = {msg.hex()}")
    print(f"sig = {sig.hex()}")
    for name, ok in checks.items():
        print(f"verified[{name}] = {bool(ok)}")
    return 0 if all(checks.values()) else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    cmd = argv[0]
    if cmd == "b":
        cmd_blind()
        return 0
    if cmd == "r":
        cmd_random(argv[1] if len(argv) > 1 else "random_bytes",
                   int(argv[2]) if len(argv) > 2 else 32)
        return 0
    if cmd == "t" and len(argv) >= 2:
        if len(argv) >= 3:
            return cmd_testvector(argv[1].encode(), argv[2].encode())
        return cmd_testvector(get_random_bytes(32), argv[1].encode())
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
