"""Key/point byte codecs and scalar bit utilities on ``[..., 32]`` uint8
tensors (counterpart of curve25519_tpu/ops/codec.py). Inputs are never
modified in place."""

import torch

__all__ = ["clamp", "scalar_bits", "pack_point", "unpack_parity"]


def clamp(sk):
    """Clamp a secret scalar: sk[0] &= 0xf8; sk[31] = (sk[31]|0x40) & 0x7f."""
    sk = sk.clone()
    sk[..., 0] &= 0xF8
    sk[..., 31] = (sk[..., 31] | 0x40) & 0x7F
    return sk


def scalar_bits(sk):
    """[..., 32] uint8 -> [..., 256] int32 little-endian bit expansion."""
    sk = sk.to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=sk.device)
    bits = (sk[..., :, None] >> shifts) & 1
    return bits.flatten(-2)


def pack_point(y_bytes, x_parity):
    """Ed25519 point compression: y with the x-parity bit in bit 255."""
    out = y_bytes.clone()
    out[..., 31] = (y_bytes[..., 31] & 0x7F) | (x_parity.to(torch.uint8) << 7)
    return out


def unpack_parity(p_bytes):
    """Split a compressed point into (y bytes with the top bit cleared,
    parity as int32)."""
    parity = (p_bytes[..., 31] >> 7) & 1
    y = p_bytes.clone()
    y[..., 31] &= 0x7F
    return y, parity.to(torch.int32)
