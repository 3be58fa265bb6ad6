// edwards25519_wide.cuh -- twisted-Edwards point arithmetic for one lane on
// the wide field core (fe25519_wide.cuh: ten 32-bit limbs, radix 2^25.5).
//
// The point code of the verify kernels (csrc/verify.cu, poly.cu and
// oneshot.cu, through verify_lane.cuh) and of the base multiply's byte
// modes, keygen and sign (csrc/basemult.cu, sign.cu, through
// fold_wide.cuh). Each function
// computes, coordinate by coordinate, the same field element as its
// counterpart in edwards25519.cuh and models/edwards.py: the same formulas,
// which scale (X : Y : Z : T) alike, so the q_table's canonical limbs come
// out byte for byte. Only the limbs differ: the wide core's unsigned limbs
// need weak_carry where a difference would leave limbs above LOOSE on the
// way into a multiply (dbl's H and F, add_pa's D). The interval proof of
// every op below is `_check_wide_core_bounds` in
// tests/test_torch_ladder_host.py; it also shows that dbl's F = G - 2Z^2
// cannot wrap although 2Z^2 is LOOSE: every digit of G = 2p - A + B is at
// least 2^width(i) - 192, and 2Z^2 exceeds 2p by at most 382 in any digit.
//
// Its names live in namespace ed_wide and take fe_wide's by using-
// declarations: a translation unit that also includes verify_lane.cuh or
// edwards25519.cuh sees the 13-bit core's Fe, one, mul, ... at global
// scope, and an unqualified call here must not bind to those.

#pragma once

#include "fe25519_wide.cuh"

namespace ed_wide {

using fe_wide::add;
using fe_wide::canon;
using fe_wide::Fe;
using fe_wide::fe_const;
using fe_wide::mul;
using fe_wide::neg;
using fe_wide::NLIMBS;
using fe_wide::select;
using fe_wide::sqr;
using fe_wide::sqrt_ratio;
using fe_wide::sub;
using fe_wide::weak_carry;

// Extended homogeneous point (X : Y : Z : T), T = XY/Z.
struct Ext {
  Fe x, y, z, t;
};

// PE point (Y+X, Y-X, 2dT, 2Z).
struct Pe {
  Fe ypx, ymx, t2d, z2;
};

// d, 2d and 1/d mod p (config.ED_D, config.ED_2D, config.ED_DI), canonical.
FE_HD Fe ed_d() {
  constexpr uint32_t t[NLIMBS] = {56195235, 13857412, 51736253, 6949390,  114729,
                                  24766616, 60832955, 30306712, 48412415, 21499315};
  return fe_const(t);
}

FE_HD Fe ed_2d() {
  constexpr uint32_t t[NLIMBS] = {45281625, 27714825, 36363642, 13898781, 229458,
                                  15978800, 54557047, 27058993, 29715967, 9444199};
  return fe_const(t);
}

FE_HD Fe ed_di() {
  constexpr uint32_t t[NLIMBS] = {30013507, 3972531,  42321084, 12719050, 2979674,
                                  28954470, 51415654, 29910370, 18959708, 16925179};
  return fe_const(t);
}

// 2P, 4M + 4S (models/edwards.double): A = X^2, B = Y^2, C = 2Z^2, D = -A,
// H = D - B, G = D + B, F = G - C, E = (X+Y)^2 + H; (EF, HG, GF, EH).
// Takes X below 2p digit by digit (neg's) and Y, Z, T TIGHT; returns TIGHT.
FE_HD Ext dbl(const Ext& p) {
  const Fe a = sqr(p.x);
  const Fe b = sqr(p.y);
  Fe c = sqr(p.z);
  c = add(c, c);
  const Fe d = neg(a);
  const Fe h = weak_carry(sub(d, b));
  const Fe g = add(d, b);
  const Fe f = weak_carry(sub(g, c));
  const Fe e = add(sqr(add(p.x, p.y)), h);
  return {mul(e, f), mul(h, g), mul(g, f), mul(e, h)};
}

// 1/2 and 1/(2d) mod p, canonical: Z and T of a point from its stored 2Z
// and 2dT (verify.cu's subset-sum adds).
FE_HD Fe inv_2() {
  constexpr uint32_t t[NLIMBS] = {67108855, 33554431, 67108863, 33554431, 67108863,
                                  33554431, 67108863, 33554431, 67108863, 16777215};
  return fe_const(t);
}

FE_HD Fe inv_2d() {
  constexpr uint32_t t[NLIMBS] = {48561176, 1986265,  21160542, 6359525,  1489837,
                                  14477235, 25707827, 14955185, 43034286, 25239805};
  return fe_const(t);
}

// P + Q, 8M (models/edwards.add_pe), for P given as (Y+X, Y-X, T, Z) and Q
// in PE form, (Y+X, Y-X, 2dT, 2Z), each as a reader: coord<C>() for
// C = 0..3. A = (Y-X) ymx, B = (Y+X) ypx, C = T t2d, D = Z z2 are the
// plain version's products. Each coordinate is read just before the
// multiply that takes it, so a reader of a stored entry keeps no more than
// one coordinate live. Coordinates TIGHT; returns TIGHT.
template <class P, class Q>
FE_HD Ext add_pe(const P& p, const Q& q) {
  const Fe a = mul(p.template coord<1>(), q.template coord<1>());
  const Fe b = mul(p.template coord<0>(), q.template coord<0>());
  const Fe c = mul(p.template coord<2>(), q.template coord<2>());
  const Fe d = mul(p.template coord<3>(), q.template coord<3>());
  const Fe e = sub(b, a);
  const Fe h = add(b, a);
  const Fe f = sub(d, c);
  const Fe g = add(d, c);
  return {mul(e, f), mul(h, g), mul(g, f), mul(e, h)};
}

// P + Q for Q in affine precomputed form (Y+X, Y-X, 2dXY), 7M
// (models/edwards.add_pa): A = (Y-X) ymx, B = (Y+X) ypx, C = T t2d,
// D = 2Z. D is a sum, not a product as in add_pe, so F = D - C and
// G = D + C would start from LOOSE limbs, and 19 F, a multiply's pre-scaled
// operand, could pass 32 bits: D is carried to TIGHT first. Takes P and Q
// TIGHT; returns TIGHT.
FE_HD Ext add_pa(const Ext& p, const Fe& ypx, const Fe& ymx, const Fe& t2d) {
  const Fe a = mul(sub(p.y, p.x), ymx);
  const Fe b = mul(add(p.y, p.x), ypx);
  const Fe c = mul(p.t, t2d);
  const Fe d = weak_carry(add(p.z, p.z));
  const Fe e = sub(b, a);
  const Fe h = add(b, a);
  const Fe f = sub(d, c);
  const Fe g = add(d, c);
  return {mul(e, f), mul(h, g), mul(g, f), mul(e, h)};
}

// P as add_pe's P: (Y+X, Y-X, T, Z), from TIGHT coordinates.
struct ExtReader {
  const Ext& s;

  template <int C>
  FE_HD Fe coord() const {
    if constexpr (C == 0) return add(s.y, s.x);
    if constexpr (C == 1) return sub(s.y, s.x);
    if constexpr (C == 2) return s.t;
    return s.z;
  }
};

// The compressed encoding of P's affine point (models/edwards.pack): y/z's
// canonical bytes with the parity of x/z in bit 255, one inversion.
FE_HD void pack(uint8_t* out, const Ext& p) {
  const Fe zi = fe_wide::inv(p.z);
  fe_wide::to_bytes(out, mul(p.y, zi));
  out[31] |= (uint8_t)((canon(mul(p.x, zi)).v[0] & 1) << 7);
}

// Ext -> PE form (models/edwards.to_pe); LOOSE coordinates.
FE_HD Pe to_pe(const Ext& p) {
  return {add(p.y, p.x), sub(p.y, p.x), mul(p.t, ed_2d()), add(p.z, p.z)};
}

// x from y with the given parity, and ok = 1 where (y^2 - 1)/(d y^2 + 1) is
// a square (models/edwards.calculate_x): the canonical root, or its
// negation (below 2p digit by digit) where its parity is not `parity`.
FE_HD Fe calculate_x(const Fe& y, uint32_t parity, uint32_t& ok) {
  const Fe y2 = sqr(y);
  const Fe u = sub(y2, fe_wide::one());
  const Fe v = add(mul(y2, ed_d()), fe_wide::one());
  const Fe xc = canon(sqrt_ratio(u, v, ok));
  return select((xc.v[0] ^ parity) & 1, neg(xc), xc);
}

}  // namespace ed_wide
